"""Brute-force oracles for the eBWT machinery, used to validate the device ops.

These resurrect the reference's debug-only self-checks as real tests
(SURVEY.md §4): check_rank (dna_string.hpp:464-516), the commented-out LCP
minima oracle (ebwt2InDel.cpp:1348-1366), and full SA/LCP construction on small
inputs.
"""

from __future__ import annotations

import numpy as np

from ebwt2indel.utils import dna

# ---------------------------------------------------------------------------
# string-level oracles
# ---------------------------------------------------------------------------


def rank_oracle(codes: np.ndarray, i: int) -> np.ndarray:
    """Counts of A,C,G,T in codes[:i]."""
    pre = codes[:i]
    return np.array([(pre == c).sum() for c in range(4)], dtype=np.int64)


def select_oracle(codes: np.ndarray, r: int, c: int) -> int:
    """Position of the (r+1)-th occurrence of c."""
    return int(np.flatnonzero(codes == c)[r])


# ---------------------------------------------------------------------------
# eBWT construction for test fixtures.
#
# The reference consumes BWTs produced by external tools (README.md:38). For
# tests we build the multi-string BWT directly: concatenate reads each followed
# by a terminator and take the BWT of the concatenation via a full suffix sort,
# with the convention that TERM sorts before A..T. Distinct terminator
# occurrences tie-break by what follows them in the concatenation, which yields
# a valid eBWT for both our framework and the reference binary (both simply
# read the ASCII BWT file).
# ---------------------------------------------------------------------------


def ebwt_from_reads(reads: list[str], term: str = "#") -> str:
    text = term.join(reads) + term
    n = len(text)
    # map characters to sortable keys with TERM smallest; make terminators
    # distinct (ranked by position) so every rotation/suffix is unique.
    order = {term: 0, "A": 1, "C": 2, "G": 3, "T": 4}
    keys = np.array([order[ch] for ch in text], dtype=np.int64)
    sa = sorted(range(n), key=lambda i: keys_tuple(keys, i))
    bwt = "".join(text[(i - 1) % n] for i in sa)
    return bwt


def keys_tuple(keys: np.ndarray, i: int):
    return tuple(keys[i:])


def sa_of_bwt(bwt_codes: np.ndarray) -> tuple[np.ndarray, np.ndarray, list[str]]:
    """Invert a (multi-string) BWT back to its suffixes via repeated LF steps is
    overkill for tests; instead reconstruct suffix strings directly by forward
    FL walks.  Returns (lcp, da_placeholder, suffix_strings) where
    suffix_strings[i] is the string of the i-th smallest suffix, TERM included,
    truncated at the first terminator (eBWT leaf semantics)."""
    n = len(bwt_codes)
    counts = np.bincount(bwt_codes, minlength=5)
    # F-column boundaries: TERM first, then A..T
    F = np.zeros(5, dtype=np.int64)
    F[0] = 0
    F[1] = counts[4]
    F[2] = F[1] + counts[0]
    F[3] = F[2] + counts[1]
    F[4] = F[3] + counts[2]
    first_char = np.zeros(n, dtype=np.uint8)
    first_char[: F[1]] = 4
    first_char[F[1] : F[2]] = 0
    first_char[F[2] : F[3]] = 1
    first_char[F[3] : F[4]] = 2
    first_char[F[4] :] = 3
    # FL (psi): F position -> L position of same character occurrence
    occ_positions = [np.flatnonzero(bwt_codes == c) for c in range(5)]
    fl = np.zeros(n, dtype=np.int64)
    offsets = {4: 0, 0: F[1], 1: F[2], 2: F[3], 3: F[4]}
    for c in range(5):
        base = offsets[c]
        fl[base : base + counts[c]] = occ_positions[c]
    suffixes = []
    for i in range(n):
        s = []
        j = i
        while True:
            c = first_char[j]
            if c == 4:
                s.append("#")
                break
            s.append("ACGT"[c])
            j = fl[j]
        suffixes.append("".join(s))
    lcp = np.zeros(n, dtype=np.int64)
    for i in range(1, n):
        a, b = suffixes[i - 1], suffixes[i]
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k] and a[k] != "#":
            k += 1
        lcp[i] = k
    return lcp, first_char, suffixes


def lcp_threshold_oracle(lcp: np.ndarray, K: int, k_right: int):
    """LCP_threshold semantics (ebwt2InDel.cpp:567-570)."""
    return (lcp >= K).astype(np.uint8), (lcp >= k_right).astype(np.uint8)


def lcp_minima_oracle(lcp: np.ndarray) -> np.ndarray:
    """The commented-out oracle of ebwt2InDel.cpp:1348-1366:
    minima[i] = LCP[i-1] > LCP[i] and LCP[i+1] >= LCP[i], for 0 < i < n-1."""
    n = len(lcp)
    out = np.zeros(n, dtype=np.uint8)
    for i in range(1, n - 1):
        out[i] = lcp[i - 1] > lcp[i] and lcp[i + 1] >= lcp[i]
    return out


def random_reads(rng, n_reads: int, length: int, mutate_from: str | None = None):
    if mutate_from is None:
        return [
            "".join(rng.choice(list("ACGT"), size=length)) for _ in range(n_reads)
        ]
    base = list(mutate_from)
    reads = []
    for _ in range(n_reads):
        start = int(rng.integers(0, max(1, len(base) - length)))
        r = base[start : start + length]
        # sprinkle an error
        if rng.random() < 0.3 and r:
            p = int(rng.integers(0, len(r)))
            r[p] = "ACGT"[int(rng.integers(0, 4))]
        reads.append("".join(r))
    return reads
