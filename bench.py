"""Benchmark: end-to-end calling throughput (BWT positions/sec) vs the
compiled reference, with byte-parity verification, for all three modes.

Mode 1 — the headline a last-line parser records — runs FIRST and its
JSON line is printed (and flushed) the moment it is measured; modes 2 and
3 follow, each likewise printing their line immediately. After all
modes, the mode-1 line is re-printed so the LAST stdout line is always
the headline metric. If a timeout kills the process mid-mode, every
already-measured mode has already been emitted.

Runs on the GPU only: with no GPU it exits non-zero and prints no
result. The first pipeline run per mode warms the compilation cache;
the reported value is the steady-state second run.
vs_baseline is the speedup over the reference binary's wall time on the
same input (reference is single-threaded CPU — its only parallel story is
process sharding, pebwt2InDel.sh).

Env knobs: BENCH_MODES (default "1,2,3"), BENCH_GENOME_LEN, BENCH_COVERAGE,
BENCH_READ_LEN, BENCH_REPEATS, BENCH_REF_REPEATS.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(REPO, "data", "bench")
REF_BIN = os.path.join(REPO, ".ref_build", "ebwt2InDel")

# E. coli scale by default — BASELINE.json config 1 (simulated 25x reads)
GENOME_LEN = int(os.environ.get("BENCH_GENOME_LEN", 4_600_000))
COVERAGE = float(os.environ.get("BENCH_COVERAGE", 25))
READ_LEN = int(os.environ.get("BENCH_READ_LEN", 100))
MODES = [int(m) for m in os.environ.get("BENCH_MODES", "1,2,3").split(",")]


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def _tag() -> str:
    return f"g{GENOME_LEN}_c{COVERAGE:g}_l{READ_LEN}"


def _make_reads():
    """The two haplotype read sets (each at half coverage)."""
    from ebwt2indel.tools import simulate

    rng = np.random.default_rng(0xBE7C)
    genome = simulate.random_genome(rng, GENOME_LEN)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.001,
                                      indel_rate=0.0002)
    reads1 = simulate.sample_reads(rng, genome, COVERAGE / 2, READ_LEN)
    reads2 = simulate.sample_reads(rng, hap2, COVERAGE / 2, READ_LEN)
    return reads1, reads2


def ensure_dataset_mode1() -> str:
    os.makedirs(DATA, exist_ok=True)
    path = os.path.join(DATA, f"reads_{_tag()}.ebwt")
    if os.path.isfile(path):
        return path
    log(f"[bench] building mode-1 dataset {_tag()} ...")
    from ebwt2indel.tools import ebwt

    reads1, reads2 = _make_reads()
    bwt = ebwt.ebwt_of_reads(reads1 + reads2)
    with open(path, "w") as f:
        f.write(bwt)
    log(f"[bench] dataset ready: {len(bwt)} positions")
    return path


def ensure_dataset_pair() -> tuple[str, str, str, str]:
    """Datasets for modes 2 (two BWTs) and 3 (merged BWT + DA).

    Reference comparison points: run_two_datasets (ebwt2InDel.cpp:1344),
    run_two_datasets_da (ebwt2InDel.cpp:1471).
    """
    os.makedirs(DATA, exist_ok=True)
    pa = os.path.join(DATA, f"a_{_tag()}.ebwt")
    pb = os.path.join(DATA, f"b_{_tag()}.ebwt")
    pm = os.path.join(DATA, f"merged_{_tag()}.ebwt")
    pd = os.path.join(DATA, f"merged_{_tag()}.da")
    if all(os.path.isfile(p) for p in (pa, pb, pm, pd)):
        return pa, pb, pm, pd
    log(f"[bench] building pair datasets {_tag()} ...")
    from ebwt2indel.tools import ebwt

    reads1, reads2 = _make_reads()
    with open(pa, "w") as f:
        f.write(ebwt.ebwt_of_reads(reads1))
    with open(pb, "w") as f:
        f.write(ebwt.ebwt_of_reads(reads2))
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    with open(pm, "w") as f:
        f.write(bwt)
    with open(pd, "w") as f:
        f.write(da)
    log(f"[bench] pair datasets ready: {len(bwt)} merged positions")
    return pa, pb, pm, pd


def ensure_reference() -> str | None:
    if os.path.isfile(REF_BIN):
        return REF_BIN
    build = os.path.join(REPO, ".ref_build")
    os.makedirs(build, exist_ok=True)
    try:
        subprocess.run(["cmake", "/root/reference"], cwd=build, check=True,
                       capture_output=True)
        subprocess.run(["make", "-j4", "ebwt2InDel"], cwd=build, check=True,
                       capture_output=True)
        return REF_BIN
    except Exception as e:  # pragma: no cover
        log(f"[bench] could not build reference: {e}")
        return None


def run_ours(mode: int, paths, out_path: str) -> float:
    from ebwt2indel.models import pipeline
    from ebwt2indel.utils.config import Config

    if mode == 1:
        cfg = Config(input1=paths[0], output=out_path)
        fn = pipeline.run_one_dataset
    elif mode == 2:
        cfg = Config(input1=paths[0], input2=paths[1], output=out_path)
        fn = pipeline.run_two_datasets
    else:
        cfg = Config(input1=paths[0], input_da=paths[1], output=out_path)
        fn = pipeline.run_two_datasets_da
    t0 = time.perf_counter()
    fn(cfg, log=lambda *a, **k: None)
    return time.perf_counter() - t0


def ref_args(mode: int, paths, out_path: str) -> list[str]:
    if mode == 1:
        return ["-1", paths[0], "-o", out_path]
    if mode == 2:
        return ["-1", paths[0], "-2", paths[1], "-o", out_path]
    return ["-1", paths[0], "-d", paths[1], "-o", out_path]


def bench_mode(mode: int, paths, n_positions: int, ref: str | None) -> dict:
    # min-of-N on BOTH sides so the reported ratio survives re-measurement
    # on a shared host (observed run-to-run spread is ~±20%); the spread
    # is logged next to each min. Reference repeats default lower for the
    # pair modes, whose single-thread runs take ~6 min each at 116M.
    repeats = int(os.environ.get("BENCH_REPEATS", 3))
    ref_repeats = int(os.environ.get(
        "BENCH_REF_REPEATS", 2 if mode == 1 else 1))

    ours_out = os.path.join(DATA, f"ours_m{mode}.snp")
    log(f"[bench] mode {mode}: warmup run (compilation) ...")
    t_warm = run_ours(mode, paths, ours_out)
    log(f"[bench] mode {mode}: warmup {t_warm:.2f}s; "
        f"{repeats} timed runs ...")
    ours_times = [run_ours(mode, paths, ours_out) for _ in range(repeats)]
    t_ours = min(ours_times)
    log(f"[bench] mode {mode}: ours min {t_ours:.2f}s of "
        f"{[round(t, 2) for t in ours_times]} "
        f"({n_positions / t_ours / 1e6:.2f} Mpos/s)")

    vs_baseline = None
    if ref:
        ref_out = os.path.join(DATA, f"ref_m{mode}.snp")
        # The reference binary and the (seeded, deterministic) dataset are
        # identical across bench invocations, so its output + min wall time
        # are cached on disk keyed by the dataset tag — re-measuring the
        # single-threaded reference costs ~390 s per invocation for mode 2
        # alone, which is budget the driver timeout does not have.
        memo = os.path.join(DATA, f"ref_m{mode}_{_tag()}.json")
        t_ref = None
        if os.path.isfile(memo) and os.path.isfile(ref_out):
            try:
                saved = json.load(open(memo))
                if saved.get("n") == n_positions:
                    t_ref = saved["t_ref"]
                    log(f"[bench] mode {mode}: reference memoized "
                        f"{t_ref:.2f}s ({memo})")
            except Exception:
                t_ref = None
        if t_ref is None:
            ref_times = []
            for _ in range(ref_repeats):
                t0 = time.perf_counter()
                subprocess.run([ref] + ref_args(mode, paths, ref_out),
                               check=True, capture_output=True)
                ref_times.append(time.perf_counter() - t0)
            t_ref = min(ref_times)
            log(f"[bench] mode {mode}: reference min {t_ref:.2f}s of "
                f"{[round(t, 2) for t in ref_times]} "
                f"({n_positions / t_ref / 1e6:.2f} Mpos/s)")
            with open(memo, "w") as f:
                json.dump({"n": n_positions, "t_ref": t_ref}, f)
        parity = open(ours_out, "rb").read() == open(ref_out, "rb").read()
        log(f"[bench] mode {mode}: parity "
            f"{'BYTE-IDENTICAL' if parity else 'MISMATCH'}")
        if not parity:
            return {
                "metric": f"mode{mode} positions/sec (PARITY FAILURE)",
                "value": 0.0, "unit": "pos/s", "vs_baseline": 0.0,
            }
        vs_baseline = t_ref / t_ours

    return {
        "metric": f"mode{mode} end-to-end BWT positions/sec/chip",
        "value": round(n_positions / t_ours, 1),
        "unit": "pos/s",
        "vs_baseline": round(vs_baseline, 3) if vs_baseline else None,
    }


def main() -> int:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"[bench] no GPU found (platform {dev.platform!r}); "
            "this benchmark measures the GPU only")
        return 1

    log(f"[bench] jax backend: {jax.default_backend()} "
        f"devices: {jax.devices()}")
    ref = ensure_reference()

    rc = 0
    headline: dict | None = None
    # mode 1 FIRST: its JSON line is the headline a last-line parser
    # records; each mode's line is flushed the moment it is measured.
    ordered = ([1] if 1 in MODES else []) + [m for m in MODES if m != 1]
    for mode in ordered:
        if mode == 1:
            p1 = ensure_dataset_mode1()
            paths = (p1,)
            n = os.path.getsize(p1)
        else:
            pa, pb, pm, pd = ensure_dataset_pair()
            paths = (pa, pb) if mode == 2 else (pm, pd)
            n = os.path.getsize(pm)
        res = bench_mode(mode, paths, n, ref)
        if res["value"] == 0.0:
            rc = 1
        print(json.dumps(res), flush=True)
        if mode == 1:
            headline = res
    # re-print the headline so the LAST line is always the mode-1 metric
    if headline is not None and ordered[-1] != 1:
        print(json.dumps(headline), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
