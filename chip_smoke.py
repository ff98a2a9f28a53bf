#!/usr/bin/env python3
"""On-card smoke test: the three calling modes on one NVIDIA GPU.

Usage (from the repository root, on a machine with a GPU):

    python chip_smoke.py          # one card, every phase below
    python chip_smoke.py --four   # four cards: the sharded path only

Phases, in order; any failure exits non-zero and prints no ``ok`` line:

1. device gate — the first JAX device must be a GPU (no CPU fallback);
   prints the card's name and power limit (nvidia-smi), the JAX version,
   device kind and count, and the compile-cache directory in use;
2. small-size correctness on the card, all byte-exact:
   a. traversal flags (thr_K, thr_R, minima) of a few thousand positions
      against the brute-force oracle of tests/oracle.py;
   b. ``.snp`` output of modes 1-3 under every flag set of
      tests/test_parity.py against the same tree run on the CPU backend
      (one child process with JAX_PLATFORMS=cpu that never opens the card);
   c. the memory-lean and >2^31-split regimes forced at small n against
      the eager output on the card;
3. BASELINE config 1 (4.6 Mbp genome, 25x, 100-bp reads, ~116M positions,
   bench.py's seeded recipe) in all three modes through ``cli.main``, each
   run cold then warm: wall, EBWT_TIMING phase walls, peak device memory,
   output size and SHA-256; cold and warm outputs must be identical;
4. rank decode rate of the plain ``ops.rank.parallel_rank`` on the
   config-1 index at 786,432 queries per call.

``--four`` runs modes 1-3 at config-1 scale through ``cli.main`` with
EBWT_MESH=4 (parallel/pipeline.py, frontier-sharded traversal) and the
one-card runs they must match byte for byte, and nothing else.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Long logs (the CLI's own output) go to chiprun_out/chip_smoke_cli.log.
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, "data", "chip_smoke")
LOG_PATH = os.path.join(REPO, "chiprun_out", "chip_smoke_cli.log")
RANK_QUERIES = 786_432
_T0 = time.time()
CARD = "unknown card"


def say(msg: str) -> None:
    print(msg, flush=True)


def phase(name: str) -> None:
    say(f"\n[{time.strftime('%H:%M:%S')} +{time.time() - _T0:.1f}s] "
        f"== {name}")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def repo_tests(name: str):
    """tests/<name>.py loaded by path: a ``tests`` package installed in
    site-packages would shadow the repo's (namespace) tests directory."""
    import importlib.util

    key = f"_chip_smoke_tests_{name}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            key, os.path.join(REPO, "tests", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        sys.modules[key] = mod
        spec.loader.exec_module(mod)
    return sys.modules[key]


def digest(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


# ---------------------------------------------------------------------------
# device gate
# ---------------------------------------------------------------------------


def device_gate(n_cards: int):
    """Fail unless JAX's first device is a GPU and at least n_cards exist;
    returns the devices and sets CARD to nvidia-smi's name + power limit."""
    global CARD
    import jax

    devs = jax.devices()
    check(devs[0].platform == "gpu",
          f"no GPU: JAX's first device is on platform {devs[0].platform!r}")
    check(len(devs) >= n_cards,
          f"{n_cards} GPU(s) needed, {len(devs)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    say(smi)
    CARD = smi.splitlines()[0].strip()
    say(f"jax {jax.__version__}; device_kind {devs[0].device_kind!r}; "
        f"{len(devs)} device(s)")
    return devs


def cache_report(when: str) -> None:
    from ebwt2indel.utils import compile_cache

    d = compile_cache.enable()
    n = len(os.listdir(d)) if d and os.path.isdir(d) else 0
    say(f"compile cache {when}: dir={d} entries={n}")


# ---------------------------------------------------------------------------
# small-size correctness (also called directly by tests/test_chip_smoke.py)
# ---------------------------------------------------------------------------


def oracle_check(seed: int = 7, n_reads: int = 80, read_len: int = 40,
                 genome_len: int = 1000,
                 params=((5, 8), (16, 30))) -> dict:
    """Traversal flags of a seeded read set against tests/oracle.py's
    brute-force SA/LCP: thr_K and thr_R equal the LCP thresholds, and every
    marked minimum is a true LCP minimum. Returns counts per (K, k_right)."""
    import numpy as np

    from ebwt2indel.models import fm_index, traverse
    from ebwt2indel.ops import packing
    from ebwt2indel.utils import dna

    oracle = repo_tests("oracle")

    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=genome_len))
    reads = oracle.random_reads(rng, n_reads, read_len, mutate_from=genome)
    codes = dna.str_to_codes(oracle.ebwt_from_reads(reads))
    lcp, _, _ = oracle.sa_of_bwt(codes)
    true_min = oracle.lcp_minima_oracle(lcp)
    fm = fm_index.FMIndex.from_packed(packing.pack_codes(codes))
    out = {}
    for K, k_right in params:
        res = traverse.navigate_one_bwt(fm, K, k_right)
        exp_K, exp_R = oracle.lcp_threshold_oracle(lcp, K, k_right)
        # LCP[0] is undefined; neither side writes position 0 (cpp:571)
        exp_K[0] = exp_R[0] = 0
        minima = np.asarray(res.minima)
        check(np.array_equal(np.asarray(res.thr_K), exp_K),
              f"thr_K differs from the oracle (K={K})")
        check(np.array_equal(np.asarray(res.thr_R), exp_R),
              f"thr_R differs from the oracle (k_right={k_right})")
        check(bool(np.all(true_min[minima == 1] == 1)),
              "a marked minimum is not an LCP minimum")
        out[(K, k_right)] = (int(exp_K.sum()), int(exp_R.sum()),
                             int(minima.sum()))
    return {"n": int(fm.n), "counts": out}


def small_inputs(workdir: str) -> dict:
    """The tests/test_parity.py dataset recipes (make_dataset,
    _make_pair_inputs) under its rng seed, written to workdir. Returns
    {mode: CLI input arguments}."""
    import numpy as np

    from ebwt2indel.tools import ebwt

    test_parity = repo_tests("test_parity")

    os.makedirs(workdir, exist_ok=True)
    rng = np.random.default_rng(0xEB37)
    path, _ = test_parity.make_dataset(workdir, rng)
    reads1, reads2 = test_parity._make_pair_inputs(workdir, rng)
    files = {"a.ebwt": ebwt.ebwt_of_reads(reads1),
             "b.ebwt": ebwt.ebwt_of_reads(reads2)}
    files["m.ebwt"], files["m.da"] = ebwt.ebwt_and_da_of_two(reads1, reads2)
    for name, text in files.items():
        with open(os.path.join(workdir, name), "w") as f:
            f.write(text)
    j = lambda name: os.path.join(workdir, name)  # noqa: E731
    return {1: ["-1", path],
            2: ["-1", j("a.ebwt"), "-2", j("b.ebwt")],
            3: ["-1", j("m.ebwt"), "-d", j("m.da")]}


def run_cli(args: list[str], log) -> str:
    """cli.main on args with its stdout and stderr sent to ``log``; returns
    those lines. Raises if the CLI fails."""
    from ebwt2indel import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(buf):
        rc = cli.main(args)
    text = buf.getvalue()
    log.write(f"$ ebwt2indel {' '.join(args)}\n{text}\n")
    log.flush()
    if "donated buffers were not usable" in text:
        out = os.path.basename(args[args.index("-o") + 1])
        say(f"note: XLA could not use some donated buffers ({out})")
    check(rc == 0, f"cli.main({args}) returned {rc}")
    return text


def run_flag_matrix(inputs: dict, outdir: str, log) -> dict:
    """Every mode x every test_parity FLAG_SET through cli.main; returns
    {name: output path}."""
    FLAG_SETS = repo_tests("test_parity").FLAG_SETS
    os.makedirs(outdir, exist_ok=True)
    outs = {}
    for mode, args in inputs.items():
        for k, extra in enumerate(FLAG_SETS):
            name = f"m{mode}_f{k}"
            outs[name] = os.path.join(outdir, name + ".snp")
            run_cli(args + ["-o", outs[name]] + list(extra), log)
    return outs


@contextlib.contextmanager
def forced_regime(huge: bool):
    """The memory-lean post-passes (and, with huge, the >2^31 split delta
    vectors) forced at small n, as tests/test_parity.py does."""
    from ebwt2indel.models import traverse

    saved = traverse._LEAN_N, traverse._LOG_FLAGS_MIN
    traverse._LEAN_N, traverse._LOG_FLAGS_MIN = 1000, 0
    if huge:
        os.environ["EBWT_FORCE_HUGE_DIF"] = "1"
    try:
        yield
    finally:
        traverse._LEAN_N, traverse._LOG_FLAGS_MIN = saved
        os.environ.pop("EBWT_FORCE_HUGE_DIF", None)


def forced_regime_check(inputs: dict, eager: dict, outdir: str, log) -> list:
    """Modes 1-3 at default flags under each forced regime must write the
    eager output (eager: run_flag_matrix's result) byte for byte."""
    os.makedirs(outdir, exist_ok=True)
    done = []
    for regime, huge in (("lean", False), ("huge", True)):
        with forced_regime(huge):
            for mode, args in inputs.items():
                out = os.path.join(outdir, f"{regime}_m{mode}.snp")
                run_cli(args + ["-o", out], log)
                with open(out, "rb") as a, open(eager[f"m{mode}_f0"],
                                                "rb") as b:
                    check(a.read() == b.read(),
                          f"{regime} regime, mode {mode}: output differs "
                          f"from the eager output")
                done.append(f"{regime}/m{mode}")
    return done


def cpu_child(workdir: str) -> int:
    """Child-process body: the flag matrix on the CPU backend. Started with
    JAX_PLATFORMS=cpu set before JAX is imported."""
    check(os.environ.get("JAX_PLATFORMS") == "cpu", "child must be CPU-only")
    import jax

    check(jax.devices()[0].platform == "cpu", "child opened a non-CPU device")
    with open(os.path.join(workdir, "inputs.json")) as f:
        inputs = {int(k): v for k, v in json.load(f).items()}
    with open(os.path.join(workdir, "cpu_cli.log"), "w") as log:
        run_flag_matrix(inputs, os.path.join(workdir, "cpu"), log)
    return 0


# ---------------------------------------------------------------------------
# config-1 scale
# ---------------------------------------------------------------------------


def config1_inputs() -> dict:
    """BASELINE config 1 datasets from bench.py's seeded recipe (the two
    builds overlap: the suffix sorts run in native code)."""
    from concurrent.futures import ThreadPoolExecutor

    import bench

    phase("config 1: building datasets (bench.py recipe)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as ex:
        f1 = ex.submit(bench.ensure_dataset_mode1)
        pa, pb, pm, pd = bench.ensure_dataset_pair()
        p1 = f1.result()
    say(f"datasets ready in {time.perf_counter() - t0:.1f} s (host) "
        f"[{CARD}]")
    return {1: ["-1", p1], 2: ["-1", pa, "-2", pb], 3: ["-1", pm, "-d", pd]}


def positions(args: list[str]) -> int:
    """BWT positions a run covers (mode 2: both inputs)."""
    return sum(os.path.getsize(a) for f, a in zip(args, args[1:])
               if f in ("-1", "-2"))


def peak_bytes() -> int:
    """Largest peak_bytes_in_use over this process's devices so far."""
    import jax

    return max(d.memory_stats()["peak_bytes_in_use"]
               for d in jax.local_devices())


def timed_run(label: str, args: list[str], out: str, log) -> str:
    """One config-1 run through cli.main with EBWT_TIMING on; prints wall,
    phase walls, peak device memory, output size and digest."""
    os.environ["EBWT_TIMING"] = "1"
    try:
        t0 = time.perf_counter()
        text = run_cli(args + ["-o", out], log)
        wall = time.perf_counter() - t0
    finally:
        os.environ.pop("EBWT_TIMING", None)
    n = positions(args)
    peak = peak_bytes()
    sha = digest(out)
    say(f"{label}: {n} positions, wall {wall:.3f} s "
        f"({n / wall:.0f} pos/s), peak device memory {peak} B, "
        f"output {os.path.getsize(out)} B sha256 {sha} [{CARD}]")
    for line in text.splitlines():
        if line.startswith("[timing]"):
            say(f"    {line} [{CARD}]")
    return sha


def rank_rate(index_path: str) -> None:
    """Median queries/s of plain ops.rank.parallel_rank on the index."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ebwt2indel.models.fm_index import FMIndex
    from ebwt2indel.ops import rank

    fm = FMIndex.from_file(index_path)
    rng = np.random.default_rng(0x4A4B)
    q = jnp.asarray(rng.integers(0, fm.n + 1, RANK_QUERIES, dtype=np.int64)
                    .astype(np.int32))
    fn = jax.jit(rank.parallel_rank)
    jax.block_until_ready(fn(fm.blocks, q))
    ts = []
    for _ in range(21):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(fm.blocks, q))
        ts.append(time.perf_counter() - t0)
    med = float(np.median(ts))
    say(f"rank decode: parallel_rank over {fm.n} positions, "
        f"{RANK_QUERIES} queries per call: median {med * 1e3:.4f} ms "
        f"(min {min(ts) * 1e3:.4f}, max {max(ts) * 1e3:.4f}) = "
        f"{RANK_QUERIES / med:.4e} queries/s [{CARD}]")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def one_card(log) -> None:
    phase("small-size correctness: traversal flags vs brute-force oracle")
    r = oracle_check()
    say(f"oracle: {r['n']} positions, (K, k_right) -> (#thr_K, #thr_R, "
        f"#minima) {r['counts']}: byte-identical")

    phase("small-size correctness: modes 1-3 x flag sets, GPU vs CPU backend")
    small = os.path.join(WORK, "small")
    inputs = small_inputs(small)
    with open(os.path.join(small, "inputs.json"), "w") as f:
        json.dump(inputs, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu", CUDA_VISIBLE_DEVICES="")
    # no persistent cache in the child: XLA:CPU executables cached on
    # another host may use instructions this host lacks
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    child = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--cpu-child", small],
        env=env, cwd=REPO)
    try:
        gpu = run_flag_matrix(inputs, os.path.join(small, "gpu"), log)
        phase("small-size correctness: forced memory regimes vs eager")
        done = forced_regime_check(inputs, gpu, os.path.join(small, "forced"),
                                   log)
        say(f"forced regimes {done}: byte-identical to the eager output")
        phase("small-size correctness: waiting for the CPU-backend child")
        check(child.wait() == 0, "CPU-backend child failed")
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    for name, path in gpu.items():
        cpu_path = os.path.join(small, "cpu", name + ".snp")
        with open(path, "rb") as a, open(cpu_path, "rb") as b:
            check(a.read() == b.read(),
                  f"{name}: GPU output differs from the CPU backend")
    say(f"GPU vs CPU backend: {len(gpu)} outputs byte-identical "
        f"({sum(os.path.getsize(p) > 0 for p in gpu.values())} non-empty)")

    big = config1_inputs()
    out_dir = os.path.join(WORK, "config1")
    os.makedirs(out_dir, exist_ok=True)
    for mode, args in big.items():
        phase(f"config 1: mode {mode} through cli.main, cold then warm")
        shas = [timed_run(f"mode {mode} {kind}", args,
                          os.path.join(out_dir, f"m{mode}_{kind}.snp"), log)
                for kind in ("cold", "warm")]
        check(shas[0] == shas[1], f"mode {mode}: cold and warm outputs differ")
        say(f"mode {mode}: cold and warm outputs identical")

    phase("rank decode rate (plain parallel_rank)")
    rank_rate(big[1][1])


def four_cards(log) -> None:
    big = config1_inputs()
    out_dir = os.path.join(WORK, "four")
    os.makedirs(out_dir, exist_ok=True)
    for mode, args in big.items():
        phase(f"mode {mode}: one card, then EBWT_MESH=4")
        one = timed_run(f"mode {mode} 1 card", args,
                        os.path.join(out_dir, f"m{mode}_1.snp"), log)
        os.environ["EBWT_MESH"] = "4"
        try:
            four = timed_run(f"mode {mode} 4 cards", args,
                             os.path.join(out_dir, f"m{mode}_4.snp"), log)
        finally:
            os.environ.pop("EBWT_MESH", None)
        check(one == four, f"mode {mode}: 4-card output differs from 1-card")
        say(f"mode {mode}: 4-card output byte-identical to 1-card")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the 4-card sharded path and its "
                         "1-card comparison")
    ap.add_argument("--cpu-child", metavar="DIR", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.cpu_child:
        return cpu_child(a.cpu_child)

    phase("device gate")
    devs = device_gate(4 if a.four else 1)
    cache_report("before")
    os.makedirs(os.path.dirname(LOG_PATH), exist_ok=True)
    with open(LOG_PATH, "w") as log:
        if a.four:
            four_cards(log)
        else:
            one_card(log)
    cache_report("after")
    phase("done")
    say(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
