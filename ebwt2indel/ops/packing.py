"""Host-side packing of a BWT (or any {A,C,G,T,TERM} string) into the device rank layout.

Batched re-design of the reference's cache-aligned block layout
(reference: internal/dna_string.hpp:19-41, 320-369, 554-585):

* block = 128 characters = one 64-byte row of 16 uint32 words:
    - words  0.. 3 : bitplane 0 (LSB of the 3-bit code), LSB-first within each word
    - words  4.. 7 : bitplane 1
    - words  8..11 : bitplane 2 (the TERM flag plane)
    - words 12..15 : ABSOLUTE cumulative counts of A,C,G,T *before* the block.
* One batched rank query = one 64-byte row gather + popcounts — the device
  equivalent of the reference's "1 cache miss per parallel_rank"
  (reference: internal/dna_string.hpp:13-17, 140-152).

Differences from the reference layout (intentional):
* bit order within a block is LSB-first per 32-bit word (32-bit lanes),
  not MSB-first per 128-bit plane (reference: dna_string.hpp:125-127);
* block counters are absolute 32-bit counts, so there is no superblock level.
  Positions and counts are *unsigned* 32-bit bit patterns on device
  (ops/coords.py), so a single run carries to ~2^32 characters (CAP below —
  covers BASELINE config 5's ~3 GB BWT); larger inputs are position-sharded
  across devices/hosts (see parallel/), which is also how the reference's
  own pipeline scales (reference: pebwt2InDel.sh:49-83).

Space: 64 B / 128 chars = 4 bits/char, matching the reference
(dna_string.hpp:21), plus a separate (n_blocks,4) copy of the counters used for
the hierarchical select descent (reference uses binary search over rank instead,
dna_string.hpp:254-272).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..utils import dna

BLOCK = 128  # characters per block
WPB = 4  # 32-bit words per plane per block


@dataclass
class PackedBwt:
    """Host (numpy) packed representation. Device mirror is models.fm_index.FMIndex."""

    blocks: np.ndarray  # (n_blocks, 16) uint32
    block_counts: np.ndarray  # (n_blocks, 4) int32 — copy of words 12..15
    F: np.ndarray  # (4,) int64: [F_A, F_C, F_G, F_T] as in dna_bwt.hpp:47-61
    counts: np.ndarray  # (5,) int64 total counts of A,C,G,T,TERM
    n: int
    term: int = dna.DEFAULT_TERM


# one run's coordinate space is 32-bit unsigned (positions and counts are
# uint32 bit patterns on device, ops/coords.py); the margin keeps the
# padded delta vector (traverse._lean_pad) addressable as (rows, 2^24)
CAP = 2**32 - 2**25

CAP_MESSAGE = (
    f"input exceeds {CAP} characters — the uint32 device coordinate "
    "space of one run; process the input as independent context-sorted "
    "pieces (ebwt2indel.tools.pebwt2indel, the reference's own "
    "scaling story, pebwt2InDel.sh:49-83)"
)


def pack_codes(codes: np.ndarray, term: int = dna.DEFAULT_TERM,
               check_cap: bool = True) -> PackedBwt:
    """Pack an array of 3-bit codes (A=0..T=3, TERM=4) into block rows."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = int(codes.shape[0])
    if check_cap and n >= CAP:
        raise ValueError(CAP_MESSAGE)
    # one extra block guarantees rank(n) addresses a valid row, mirroring the
    # reference's (n+1)-based block count (dna_string.hpp:61-62)
    n_blocks = n // BLOCK + 1
    padded = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
    padded[:n] = codes

    bits = padded.reshape(n_blocks, WPB, 32)
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    planes = np.empty((n_blocks, 3 * WPB), dtype=np.uint32)
    for p in range(3):
        plane_bits = ((bits >> p) & 1).astype(np.uint32)
        planes[:, p * WPB : (p + 1) * WPB] = (plane_bits * weights).sum(
            axis=2, dtype=np.uint32
        )

    # absolute counts of each base before each block
    per_block = np.empty((n_blocks, 4), dtype=np.int64)
    blk = padded.reshape(n_blocks, BLOCK)
    for c in range(4):
        per_block[:, c] = (blk == c).sum(axis=1)
    # the padding is code 0 ('A'); remove its contribution from the final block
    pad_len = n_blocks * BLOCK - n
    per_block[-1, 0] -= pad_len
    cum = np.zeros((n_blocks, 4), dtype=np.int64)
    np.cumsum(per_block[:-1], axis=0, out=cum[1:])

    blocks = np.empty((n_blocks, 16), dtype=np.uint32)
    blocks[:, :12] = planes
    blocks[:, 12:16] = cum.astype(np.uint32)

    totals = np.zeros(5, dtype=np.int64)
    totals[:4] = cum[-1] + per_block[-1]
    totals[4] = n - totals[:4].sum()

    # F column with TERM lexicographically smallest (dna_bwt.hpp:47-61):
    # F_A = #TERM, F_C = F_A + #A, F_G = F_C + #C, F_T = F_G + #G
    F = np.empty(4, dtype=np.int64)
    F[0] = totals[4]
    F[1] = F[0] + totals[0]
    F[2] = F[1] + totals[1]
    F[3] = F[2] + totals[2]

    return PackedBwt(
        blocks=blocks,
        block_counts=cum.astype(np.int32),
        F=F,
        counts=totals,
        n=n,
        term=term,
    )


def read_ebwt_codes(path: str, term: int = dna.DEFAULT_TERM) -> np.ndarray:
    """Read an ASCII eBWT file and convert to codes, validating the alphabet
    (reference: internal/dna_string.hpp:76-105)."""
    raw = np.fromfile(path, dtype=np.uint8)
    tbl = dna.code_table(term)
    codes = tbl[raw]
    bad = codes == 255
    if bad.any():
        ch = int(raw[bad.argmax()])
        raise ValueError(
            f"Error while reading file: read forbidden character "
            f"'{chr(ch)}' (ASCII code {ch}). Only A,C,G,T, and {chr(term)} are "
            f"admitted in the input BWT! If the unknown character is the "
            f'terminator, you can solve the problem by adding option "-t {ch}".'
        )
    return codes


def ascii_to_codes(raw: np.ndarray, term: int = dna.DEFAULT_TERM) -> np.ndarray:
    """ASCII bytes -> codes, validating the alphabet with the reference's
    message (internal/dna_string.hpp:76-105)."""
    tbl = dna.code_table(term)
    codes = tbl[raw]
    bad = codes == 255
    if bad.any():
        ch = int(raw[bad.argmax()])
        raise ValueError(
            f"Error while reading file: read forbidden character "
            f"'{chr(ch)}' (ASCII code {ch}). Only A,C,G,T, and {chr(term)} are "
            f"admitted in the input BWT! If the unknown character is the "
            f"terminator, you can solve the problem by adding option "
            f'"-t {ch}".'
        )
    return codes


def pack_bytes(raw: np.ndarray, term: int = dna.DEFAULT_TERM) -> PackedBwt:
    """Pack raw ASCII bytes (native multithreaded C++ fast path; numpy
    fallback when the toolchain is unavailable). Forbidden-character
    errors propagate with the reference's message either way."""
    try:
        from . import native

        return native.pack_bytes(raw, term)
    except ValueError:
        raise
    except Exception:
        return pack_codes(ascii_to_codes(raw, term), term)


def pack_file(path: str, term: int = dna.DEFAULT_TERM) -> PackedBwt:
    try:
        from . import native  # optional C++ fast path

        return native.pack_file(path, term)
    except ValueError:
        raise
    except Exception:
        return pack_codes(read_ebwt_codes(path, term), term)


def save_packed(pb: PackedBwt, path: str) -> None:
    """Persist a packed index — the cacheable/checkpointable artifact
    (the reference has serialize/load for this but never wires it to the CLI:
    dna_string.hpp:205-243, dna_bwt.hpp:238-289 incl. the latent load bug at
    263-266; here it is a first-class capability)."""
    np.savez(
        path, blocks=pb.blocks, block_counts=pb.block_counts, F=pb.F,
        counts=pb.counts, n=np.int64(pb.n), term=np.int64(pb.term),
    )


def load_packed(path: str) -> PackedBwt:
    z = np.load(path if path.endswith(".npz") else path + ".npz")
    return PackedBwt(
        blocks=z["blocks"], block_counts=z["block_counts"], F=z["F"],
        counts=z["counts"], n=int(z["n"]), term=int(z["term"]),
    )


def pack_file_cached(path: str, term: int = dna.DEFAULT_TERM,
                     cache: bool = True) -> PackedBwt:
    """pack_file with an .ebwt.idx.npz sidecar cache keyed by mtime."""
    idx = path + ".idx.npz"
    if cache and os.path.isfile(idx) and \
            os.path.getmtime(idx) >= os.path.getmtime(path):
        try:
            return load_packed(idx)
        except Exception:
            pass
    pb = pack_file(path, term)
    if cache:
        try:
            save_packed(pb, idx[:-4])
        except Exception:
            pass
    return pb


# ---------------------------------------------------------------------------
# sharded loader: block-row-aligned range packing for per-host input sharding
# ---------------------------------------------------------------------------


@dataclass
class ShardPack:
    """One block-row range of a packed BWT, counters LOCAL to the range.

    Produced by pack_file_range; assembled into globally-consistent shards
    by adding the exclusive scan of per-shard totals (absolute counters are
    uint32, valid for n < 2^32). This is the "sharded loader" of SURVEY.md
    §2.5: each host packs only its own byte range of the input (the
    reference's analogue is process-level input sharding,
    pebwt2InDel.sh:49-83)."""

    rows: np.ndarray  # (rows, 16) uint32; words 12..15 = in-range counters
    row_counts: np.ndarray  # (rows, 4) int64 in-range exclusive counts
    totals: np.ndarray  # (5,) int64 — A,C,G,T,TERM counts in the range
    row_lo: int  # first global block row of this range
    n_rows: int


def shard_row_ranges(n: int, n_shards: int) -> list[tuple[int, int]]:
    """Block-row ranges per shard, matching parallel.shard.shard_fm's split:
    rows = ceil(n_blocks / n_shards) rows per shard over the global
    n_blocks = n // BLOCK + 1 (the +1 row mirrors the reference's
    (n+1)-based block count, dna_string.hpp:61-62). Returns [lo_row,
    hi_row) per shard; trailing shards may be empty."""
    n_blocks = n // BLOCK + 1
    rows = -(-n_blocks // n_shards)
    return [
        (min(s * rows, n_blocks), min((s + 1) * rows, n_blocks))
        for s in range(n_shards)
    ]


def pack_file_range(path: str, row_lo: int, row_hi: int, n: int,
                    term: int = dna.DEFAULT_TERM) -> ShardPack:
    """Pack global block rows [row_lo, row_hi) of an ASCII eBWT file —
    characters [row_lo*BLOCK, min(row_hi*BLOCK, n)) — reading ONLY that
    byte range (memmap; the OS pages in just the slice). Counters are
    local to the range; alphabet errors carry the reference's message
    with GLOBAL character positions."""
    n_rows = row_hi - row_lo
    if n_rows <= 0:
        return ShardPack(
            rows=np.zeros((0, 16), np.uint32),
            row_counts=np.zeros((0, 4), np.int64),
            totals=np.zeros(5, np.int64), row_lo=row_lo, n_rows=0,
        )
    lo_char = row_lo * BLOCK
    hi_char = min(row_hi * BLOCK, n)
    data = np.memmap(path, dtype=np.uint8, mode="r")[lo_char:hi_char]
    return pack_bytes_range(data, row_lo, n_rows, term)


def pack_bytes_range(data: np.ndarray, row_lo: int, n_rows: int,
                     term: int = dna.DEFAULT_TERM) -> ShardPack:
    """Pack a char range into exactly n_rows block rows (the final global
    row is the reference's extra padding row — zero planes, counters =
    totals — when the range ends at n)."""
    try:
        from . import native

        pb = native.pack_bytes(np.asarray(data), term, check_cap=False)
    except ValueError:
        raise
    except Exception:
        pb = pack_codes(ascii_to_codes(np.asarray(data), term), term,
                        check_cap=False)
    # packing L chars yields L//BLOCK + 1 rows: exactly n_rows for the
    # final shard (whose last row is the reference's (n+1)-padding row,
    # dna_string.hpp:61-62), n_rows + 1 for interior block-aligned shards
    # (drop the extra row — it belongs to the next shard)
    assert pb.blocks.shape[0] >= n_rows
    rows = pb.blocks[:n_rows]
    row_counts = pb.block_counts[:n_rows].astype(np.int64)
    return ShardPack(rows=np.ascontiguousarray(rows),
                     row_counts=np.ascontiguousarray(row_counts),
                     totals=pb.counts.astype(np.int64),
                     row_lo=row_lo, n_rows=n_rows)


def apply_shard_base(sp: ShardPack, base: np.ndarray) -> None:
    """Make a ShardPack's counters absolute by adding ``base`` — the
    exclusive scan of per-shard totals (int64 (4,)). In-place. Absolute
    counters are stored as uint32 (exact for n < 2^32)."""
    if sp.n_rows == 0:
        return
    sp.row_counts += base[None, :]
    sp.rows[:, 12:16] = (sp.row_counts & 0xFFFFFFFF).astype(np.uint32)


def f_from_totals(totals: np.ndarray) -> np.ndarray:
    """F column boundaries from global (5,) char totals (dna_bwt.hpp:47-61):
    TERM smallest, then A<C<G<T."""
    F = np.empty(4, dtype=np.int64)
    F[0] = totals[4]
    F[1] = F[0] + totals[0]
    F[2] = F[1] + totals[1]
    F[3] = F[2] + totals[2]
    return F


def term_positions(pb: PackedBwt) -> np.ndarray:
    """Positions of the TERM characters, extracted from bitplane 2.

    TERM is the only code with plane-2 set (code 4 = 0b100), so plane 2
    IS the terminator bitmap. Terminators are ~1% of a read collection's
    eBWT (one per read), so shipping them as sparse int32 positions and
    rebuilding the plane on device beats uploading the dense plane over
    the host link (models/fm_index.from_packed, EBWT_LEAN_UPLOAD=2).
    Extraction touches only the nonzero plane words."""
    p2 = pb.blocks[:, 8:12].reshape(-1)  # flat uint32 words, LSB-first
    nz = np.flatnonzero(p2)
    if nz.size == 0:
        return np.zeros(0, dtype=np.int32)
    bitmat = (p2[nz][:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    r, c = np.nonzero(bitmat)
    return (nz[r].astype(np.int64) * 32 + c).astype(np.int32)


def pack_bitvector(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Pack a 0/1 array into (n_blocks*4,) uint32 FLAT words + (n_blocks,)
    int32 absolute cumulative popcounts — the rank-1 structure for the
    document array (reference mode 3 stores DA as vector<bool>,
    ebwt2InDel.cpp:1495-1508; we rank it with the same block machinery).
    Flat layout (ops.bits.bv_build)."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    n = int(bits.shape[0])
    n_blocks = n // BLOCK + 1
    padded = np.zeros(n_blocks * BLOCK, dtype=np.uint8)
    padded[:n] = bits
    weights = (np.uint32(1) << np.arange(32, dtype=np.uint32))[None, None, :]
    words = (padded.reshape(n_blocks, WPB, 32).astype(np.uint32) * weights).sum(
        axis=2, dtype=np.uint32
    )
    per_block = padded.reshape(n_blocks, BLOCK).sum(axis=1, dtype=np.int64)
    cum = np.zeros(n_blocks, dtype=np.int64)
    np.cumsum(per_block[:-1], out=cum[1:])
    return words.reshape(-1), cum.astype(np.int32)


def read_da_file(path: str, n: int) -> np.ndarray:
    """Read an ASCII '0'/'1' document-array file
    (reference: ebwt2InDel.cpp:1495-1508 — one byte per BWT position)."""
    raw = np.fromfile(path, dtype=np.uint8, count=n)
    return (raw == ord("1")).astype(np.uint8)
