#!/usr/bin/env python3
"""Generate a huge (multi-billion-position) mode-1 eBWT dataset.

Same statistical shape as bench.py's E. coli config (two haplotypes at half
coverage each, substitution errors), but fully vectorized: bench.py's
simulate.sample_reads loops per read in Python, which is fine at 1.1M reads
(116M positions) and not at 25M reads (2.6G positions).

Peak memory is bounded by generating the read gathers and error plants in
~1M-read chunks; the chunking preserves the RNG draw order (one stream of
uniforms, then one stream of substitution offsets), so outputs are
byte-identical to the original whole-matrix formulation — pinned by
tests/test_tools.py against tools/ebwt.py's reference-shaped builder.

Usage: python tools/genhuge.py GENOME_LEN OUT.ebwt [COVERAGE] [READ_LEN]
Positions written = GENOME_LEN*COVERAGE*(READ_LEN+1)/READ_LEN (approx).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
CHUNK_READS = 1 << 20  # ~100 MB of uniforms per chunk at read_len 100


def vector_reads(rng, genome_u8: np.ndarray, coverage: float, read_len: int,
                 error_rate: float = 0.001) -> np.ndarray:
    """(n_reads, read_len) ASCII read matrix, vectorized error planting.

    Chunked to bound peak memory (the error-uniform matrix alone is ~10 GB
    float64 at 2.6G-position scale); the RNG stream order matches the
    whole-matrix formulation exactly (uniforms are drawn row-major either
    way; the substitution offsets are drawn in one batch afterwards)."""
    n = len(genome_u8)
    n_reads = int(n * coverage / read_len)
    starts = rng.integers(0, n - read_len + 1, size=n_reads)
    reads = np.empty((n_reads, read_len), dtype=np.uint8)
    offs = np.arange(read_len)
    err_chunks = []
    for lo in range(0, n_reads, CHUNK_READS):
        hi = min(lo + CHUNK_READS, n_reads)
        reads[lo:hi] = genome_u8[starts[lo:hi, None] + offs]
        e = np.argwhere(rng.random((hi - lo, read_len)) < error_rate)
        e[:, 0] += lo
        err_chunks.append(e)
    err = np.concatenate(err_chunks) if err_chunks else \
        np.zeros((0, 2), np.int64)
    if len(err):
        code = np.zeros(256, dtype=np.uint8)
        code[BASES] = np.arange(4)
        cur = code[reads[err[:, 0], err[:, 1]]]
        new = (cur + rng.integers(1, 4, size=len(err))) % 4
        reads[err[:, 0], err[:, 1]] = BASES[new]
    return reads


def ebwt_of_read_matrix(text: np.ndarray) -> np.ndarray:
    """eBWT bytes of a (n_reads, read_len+1) ASCII matrix whose last
    column is the '#' terminator — the vectorized twin of
    tools/ebwt.ebwt_of_reads (same suffix order: terminators distinct by
    read index, below all bases; byte-parity pinned in
    tests/test_tools.py)."""
    from ebwt2indel.tools.ebwt import suffix_array_sentinel

    n_reads, row = text.shape
    read_len = row - 1
    raw = text.reshape(-1)
    n = len(raw)

    codes = np.empty(n + 1, dtype=np.int32)
    lut = np.zeros(256, dtype=np.int32)
    for i, b in enumerate(BASES):
        lut[b] = n_reads + 1 + i
    codes[:n] = lut[raw]
    term_pos = np.arange(n_reads, dtype=np.int64) * (read_len + 1) + read_len
    codes[term_pos] = np.arange(1, n_reads + 1, dtype=np.int32)
    codes[n] = 0

    sa = suffix_array_sentinel(codes)
    del codes
    assert sa[0] == n
    sa = sa[1:]
    np.subtract(sa, 1, out=sa)
    sa[sa < 0] = n - 1
    return raw[sa]


def main() -> None:
    genome_len = int(sys.argv[1])
    out = sys.argv[2]
    coverage = float(sys.argv[3]) if len(sys.argv) > 3 else 25.0
    read_len = int(sys.argv[4]) if len(sys.argv) > 4 else 100

    from ebwt2indel.tools import simulate

    t0 = time.time()
    rng = np.random.default_rng(0xB16B16)
    genome = simulate.random_genome(rng, genome_len)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.001,
                                      indel_rate=0.0002)
    g1 = np.frombuffer(genome.encode(), dtype=np.uint8)
    g2 = np.frombuffer(hap2.encode(), dtype=np.uint8)
    del genome, hap2
    print(f"[genhuge] genomes ready {time.time()-t0:.0f}s", flush=True)

    r1 = vector_reads(rng, g1, coverage / 2, read_len)
    r2 = vector_reads(rng, g2, coverage / 2, read_len)
    del g1, g2
    n_reads = len(r1) + len(r2)
    print(f"[genhuge] {n_reads} reads {time.time()-t0:.0f}s", flush=True)

    # terminator-joined text: each read followed by '#'
    text = np.empty((n_reads, read_len + 1), dtype=np.uint8)
    text[: len(r1), :read_len] = r1
    text[len(r1):, :read_len] = r2
    del r1, r2
    text[:, read_len] = ord("#")
    print(f"[genhuge] text {text.size} positions {time.time()-t0:.0f}s; "
          "SA-IS...", flush=True)

    bwt = ebwt_of_read_matrix(text)
    del text
    print(f"[genhuge] SA done {time.time()-t0:.0f}s", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    bwt.tofile(out)
    print(f"[genhuge] wrote {out}: {len(bwt)} positions "
          f"{time.time()-t0:.0f}s", flush=True)


if __name__ == "__main__":
    main()
