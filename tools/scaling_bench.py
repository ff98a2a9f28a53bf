#!/usr/bin/env python3
"""Virtual-mesh scaling measurement: frontier-phase wall time at
n_dev ∈ {1,2,4,8} on the CPU backend (fixed input), next to the
work-count balance test (tests/test_parallel.py).

This is the closest measurable proxy for the ≥80% 1→N scaling north star
available without multi-chip hardware (BASELINE.md): the frontier-sharded
queue machinery (sorts, compaction gathers, appends, flag routing) is
per-shard O(frontier/n_dev), so its wall time should trend down with
n_dev until the host's physical cores saturate. NOTE the box caveat: with
only 4 physical cores, the 8-virtual-device point time-shares cores and
the XLA CPU backend already multithreads single-device ops — treat the
1→2→4 trend plus the per-shard work counts as the signal, not absolute
speedups.

Usage: python tools/scaling_bench.py [genome_len] [reps]
Writes one JSON line per (n_dev, phase) with the min-of-reps wall time.
"""

from __future__ import annotations

import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def ensure_dataset(genome_len: int) -> str:
    from ebwt2indel.tools import ebwt, simulate

    path = os.path.join(REPO, "data", f"scaling_g{genome_len}.ebwt")
    if os.path.isfile(path):
        return path
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rng = np.random.default_rng(0x5CA1E)
    genome = simulate.random_genome(rng, genome_len)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.001,
                                      indel_rate=0.0002)
    reads = simulate.sample_reads(rng, genome, 12.5, 100) + \
        simulate.sample_reads(rng, hap2, 12.5, 100)
    with open(path, "w") as f:
        f.write(ebwt.ebwt_of_reads(reads))
    return path


def main() -> int:
    from ebwt2indel.parallel import frontier, shard
    from ebwt2indel.utils import compile_cache

    compile_cache.enable()
    genome_len = int(sys.argv[1]) if len(sys.argv) > 1 else 40_000
    reps = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    path = ensure_dataset(genome_len)
    n = os.path.getsize(path)
    print(f"[scaling] {n} positions, reps={reps}", file=sys.stderr)

    K, k_right, chunk = 16, 30, 4096
    for n_dev in (1, 2, 4, 8):
        mesh = shard.make_mesh(n_dev)
        sfm = shard.shard_fm_from_file(path, mesh)
        F6 = jnp.concatenate([sfm.F, jnp.asarray([sfm.n], jnp.int32)])
        queue_cap = max(1 << 16, sfm.n // (16 * n_dev))
        kw = dict(rows=sfm.rows, queue_cap=queue_cap, chunk=chunk,
                  wbudget=512, fbudget=2048, seg=2 * chunk, K=K,
                  k_right=k_right)

        # settle budgets first with the production doubling-retry policy
        # (small meshes route all children to one bucket, overflowing the
        # starting seg), then time only the settled configuration
        for _ in range(6):
            _, _, ovf = frontier._frontier_leaf_phase(
                mesh, sfm.blocks, F6, **kw)
            _, _, ovf2, _ = frontier._frontier_node_phase(
                mesh, sfm.blocks, F6, **kw)
            if int(ovf) == 0 and int(ovf2) == 0:
                break
            for k in ("queue_cap", "wbudget", "fbudget", "seg"):
                kw[k] *= 2

        def leaf():
            dif, st, ovf = frontier._frontier_leaf_phase(
                mesh, sfm.blocks, F6, **kw)
            jax.block_until_ready(dif)
            assert int(ovf) == 0
            return st

        def node():
            nf, st, ovf, work = frontier._frontier_node_phase(
                mesh, sfm.blocks, F6, **kw)
            jax.block_until_ready(nf)
            assert int(ovf) == 0
            return st, np.asarray(work)

        leaf()  # compile/warm
        node()
        t_leaf = min(_timed(leaf) for _ in range(reps))
        best = [_timed_ret(node) for _ in range(reps)]
        t_node = min(t for t, _ in best)
        work = best[0][1][1]
        print(json.dumps({
            "n_dev": n_dev, "phase": "leaf", "seconds": round(t_leaf, 3),
        }))
        print(json.dumps({
            "n_dev": n_dev, "phase": "node", "seconds": round(t_node, 3),
            "per_shard_nodes": [int(x) for x in work],
        }))
    return 0


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _timed_ret(fn):
    t0 = time.perf_counter()
    r = fn()
    return time.perf_counter() - t0, r


if __name__ == "__main__":
    raise SystemExit(main())
