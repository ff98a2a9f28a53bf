"""Multi-host (multi-process) execution wiring.

The reference's only scaling story is process-level input sharding
(pebwt2InDel.sh:49-83 — N independent jobs on N read subsets). Here a
single SPMD program spans hosts: `jax.distributed.initialize` joins each
process to a coordinator, the position mesh is built over the *global*
device set, and the same shard_map pipeline (parallel/pipeline.py) runs
unchanged — XLA's collectives (psum/ppermute/all_gather) ride the
device interconnect between the cards of a host and the network between
hosts.

Environment contract (set on every process):
    EBWT_COORD   coordinator address, e.g. "10.0.0.1:8476"
    EBWT_NPROCS  total number of processes
    EBWT_PROCID  this process's id in [0, EBWT_NPROCS)

With EBWT_COORD="auto", `jax.distributed.initialize()` is called without
arguments and auto-detects all three from a cluster environment it knows
(e.g. SLURM, Open MPI). Host-side work
(cluster selection, emission formatting) is replicated on every process —
identical inputs produce identical decisions, which is what keeps the SPMD
program in lockstep — but only process 0 writes the output file.
"""

from __future__ import annotations

import os

import jax


def distributed_requested() -> bool:
    return bool(os.environ.get("EBWT_COORD"))


def init_from_env() -> int:
    """Join the distributed runtime per the EBWT_* env contract; returns
    this process's index. Safe to call when EBWT_COORD is unset (no-op,
    returns 0)."""
    coord = os.environ.get("EBWT_COORD")
    if not coord:
        return 0
    if coord == "auto":
        # coordinator/count/id from jax's cluster auto-detection
        jax.distributed.initialize()
    else:
        nprocs = int(os.environ["EBWT_NPROCS"])
        procid = int(os.environ["EBWT_PROCID"])
        # cross-process collectives on the CPU backend go through gloo.
        # NOTE: probe the env, not jax.default_backend() — the latter would
        # initialize the backend before jax.distributed.initialize runs.
        if os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
            try:
                jax.config.update(
                    "jax_cpu_collectives_implementation", "gloo")
            except Exception:
                pass
        jax.distributed.initialize(coord, num_processes=nprocs,
                                   process_id=procid)
    return jax.process_index()


def is_primary() -> bool:
    return jax.process_index() == 0


def redirect_output(cfg):
    """Non-primary processes compute the same replicated emission but must
    not race on the output file: point them at a scratch path."""
    import dataclasses

    if not is_primary():
        cfg = dataclasses.replace(
            cfg, output=cfg.output + f".proc{jax.process_index()}")
    return cfg
