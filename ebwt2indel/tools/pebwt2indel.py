"""pebwt2indel — process-parallel sharded pipeline over a read collection.

Equivalent of the reference's only parallel path (pebwt2InDel.sh): break reads
into fixed-length pieces, context-sort so similar reads land in the same
piece, shard into p pieces, run the mode-1 pipeline per piece concurrently,
and concatenate the per-piece .snp outputs.

Differences from the shell script (native, no external deps):
* HARC compress/decompress context sorting is replaced by sorting reads by a
  central-context key (reads sharing long substrings cluster together, same
  intent as HARC's reordering);
* BCR_LCP_GSA is replaced by the built-in suffix-array eBWT builder;
* pieces run as a process pool instead of background shell jobs.

Same correctness contract as the reference (README.md:104-124): variants
supported by reads split across different pieces may be missed; remainder
reads shorter than read_len are dropped.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
from concurrent.futures import ProcessPoolExecutor

from ..models import pipeline
from ..utils.config import Config
from . import ebwt


def _chop_reads(reads: list[str], read_len: int) -> list[str]:
    """fold -w read_len + drop remainders + N->A (pebwt2InDel.sh:32)."""
    out = []
    for r in reads:
        r = r.replace("N", "A")
        for i in range(0, len(r) - read_len + 1, read_len):
            out.append(r[i : i + read_len])
    return out


def _context_key(read: str, k: int = 16) -> str:
    """Sort key approximating HARC's context reordering: the read's central
    k-mer, then the read itself."""
    mid = max(0, (len(read) - k) // 2)
    return read[mid : mid + k] + read


def _worker_init():
    """Workers run the host-CPU JAX backend: piece-level parallelism is a
    multi-core CPU strategy (the reference's pebwt2InDel.sh model); the
    accelerator path is the in-process batched pipeline."""
    import jax

    jax.config.update("jax_platforms", "cpu")


def _run_piece(args) -> str:
    piece_reads, outdir, idx, mcov = args
    bwt = ebwt.ebwt_of_reads(piece_reads)
    bwt_path = os.path.join(outdir, f"piece{idx}.ebwt")
    snp_path = os.path.join(outdir, f"piece{idx}.snp")
    with open(bwt_path, "w") as f:
        f.write(bwt)
    cfg = Config(input1=bwt_path, output=snp_path, mcov_out=mcov)
    pipeline.run_one_dataset(cfg, log=lambda *a, **k: None)
    return snp_path


def run(input_fasta: str, threads: int, read_len: int, outdir: str,
        mcov: int = 3, log=print) -> str:
    os.makedirs(outdir, exist_ok=True)
    reads = ebwt.read_fasta(input_fasta)
    log(f"Read {len(reads)} sequences")
    reads = _chop_reads(reads, read_len)
    log(f"{len(reads)} pieces of length {read_len} after chopping")
    reads.sort(key=_context_key)

    p = max(threads, 2)
    per = (len(reads) + p - 2) // (p - 1)  # p-1 pieces like `split` (sh:49)
    pieces = [reads[i : i + per] for i in range(0, len(reads), per)]
    log(f"Processing {len(pieces)} pieces on {threads} workers")

    jobs = [(piece, outdir, i, mcov) for i, piece in enumerate(pieces)]
    # spawn (not fork): forking after XLA initializes deadlocks
    os.environ["JAX_PLATFORMS"] = "cpu"
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=threads, mp_context=ctx,
                             initializer=_worker_init) as ex:
        outputs = list(ex.map(_run_piece, jobs))

    final = os.path.join(outdir, "variants.snp")
    with open(final, "w") as out:
        for path in outputs:
            with open(path) as f:
                out.write(f.read())
            os.remove(path)
            os.remove(path.replace(".snp", ".ebwt"))
    log(f"Done. Output: {final}")
    return final


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 4:
        print("usage: pebwt2indel input_fasta threads read_len output_dir "
              "[mcov]")
        return 1
    run(argv[0], int(argv[1]), int(argv[2]), argv[3],
        int(argv[4]) if len(argv) > 4 else 3)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
