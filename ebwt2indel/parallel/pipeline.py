"""End-to-end SHARDED mode-1 pipeline: every O(n) structure — packed index
rows, LCP flag vectors, the right-context anchor table — lives sharded over
the 'pos' mesh axis; cluster lists and per-cluster walk state are replicated
O(#clusters); emission is host-side and byte-identical to the reference
(run_one_dataset, ebwt2InDel.cpp:1584-1674).

Select with EBWT_MESH=<n_devices> on the CLI, or call directly with a Mesh.
Collectives per queue chunk / walk step: one psum (rank/select
answers), plus O(n_dev)-scalar all_gathers in the scan-style phases.
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..models import emit, emit_vec
from ..models import pipeline as mpipe
from ..ops import bits, packing
from ..ops.coords import unpat
from ..utils import compile_cache
from ..utils.config import Config
from . import calling, shard
from . import traverse as ptraverse


def _log(msg: str, file=None):
    print(msg, file=file or sys.stdout, flush=True)


def _nav_one(sfm, K, k_right):
    """Single-BWT sharded navigation: frontier-sharded queues by default
    (parallel/frontier.py — queue machinery scales ~1/n_dev);
    EBWT_FRONTIER=0 selects the replicated-queue phases for A/B."""
    import os

    if os.environ.get("EBWT_FRONTIER", "1") != "0":
        from . import frontier

        return frontier.navigate_one_bwt_frontier_device(sfm, K, k_right)
    return ptraverse.navigate_one_bwt_sharded_device(sfm, K, k_right)


def run_one_dataset_sharded(cfg: Config, mesh, log=_log) -> dict:
    compile_cache.enable()
    cfg = cfg.resolved()
    t0 = time.perf_counter()
    log("Phase 1/4: loading and indexing eBWT ... ")
    # sharded loader: this process packs only the byte ranges its devices
    # own (per-host input sharding — no O(n) pack per process)
    sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
    jax.block_until_ready(sfm.blocks)
    t1 = time.perf_counter()
    log(f"done. [{t1 - t0:.2f}s]")
    log(f"[loader] process {jax.process_index()} packed "
        f"{sfm.local_bytes}/{sfm.n} input bytes")

    log(f"\nPhase 2-3/4: suffix-tree wavefront navigation "
        f"({mesh.devices.size}-device mesh).")
    thr_K, thr_R, minima, (local_n, (st_l, st_n)) = \
        _nav_one(sfm, cfg.K, cfg.k_right)
    jax.block_until_ready(thr_K)
    t2 = time.perf_counter()
    st_l = np.asarray(st_l)
    st_n = np.asarray(st_n)
    # device counters wrap mod 2^32; every true count is <= n < 2^32
    lcp_values = 1 + unpat(st_l[1]) + unpat(st_n[1])
    log(f"Computed {lcp_values}/{sfm.n} LCP values.")
    log(f"Found {unpat(st_n[2])} LCP minima.")
    log(f"Processed {unpat(st_l[0])} suffix-tree leaves and "
        f"{unpat(st_n[0])} nodes. [{t2 - t1:.2f}s]\n")

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")

    next_thr = calling.next_set_table_sharded(
        mesh, thr_R, local_n=local_n, n=sfm.n
    )
    cl = calling.find_clusters_sharded(
        mesh, thr_K, minima, local_n=local_n, n=sfm.n, mcov_out=cfg.mcov_out
    )
    t4 = time.perf_counter()
    log(f"[timing] cluster detect (sharded) {t4 - t2:.2f}s")

    stats = _call_and_emit_single_sharded(sfm, cl, next_thr, local_n, cfg)
    log(f"[timing] call+emit {time.perf_counter() - t4:.2f}s")
    stats["lcp_values"] = lcp_values
    stats["n_min"] = unpat(st_n[2])
    stats["leaves"] = unpat(st_l[0])
    stats["nodes"] = unpat(st_n[0])
    stats["n_clusters"] = cl.n_clusters

    avg = cl.clust_size_sum / cl.n_clusters if cl.n_clusters else float("nan")
    log(f"\nDone.\nAnalyzed {cl.n_clusters} clusters.")
    log(f"Average cluster length: {avg}.\n")
    log(
        f"Stored to file {stats['events']} events clustered in "
        f"{stats['cluster_nr'] - 1} clusters.\n"
    )
    log(
        "Distribution of bases inside clusters "
        "(cluster length / number of bases inside clusters of that length): "
    )
    mpipe.print_histogram(cl.hist, log)
    return stats


def _call_and_emit_single_sharded(sfm: shard.ShardedFM, cl, next_thr,
                                  local_n: int, cfg: Config) -> dict:
    mesh = sfm.mesh
    B = len(cl.begins)
    with open(cfg.output, "w") as out_f:
        writer = emit.SnpWriter(
            out_f, complexity=cfg.complexity, max_snvs=cfg.max_snvs,
            mcov_out=cfg.mcov_out, max_gap=cfg.max_gap,
        )
        if B == 0:
            return {"events": 0, "cluster_nr": writer.cluster_nr}

        begins = jnp.asarray(cl.begins, dtype=jnp.int32)
        ends = jnp.asarray(cl.ends, dtype=jnp.int32)

        # device-side frequent-chars filter first (find_variants,
        # ebwt2InDel.cpp:947-966) — survivors only get the walks
        quirk_d, _pure = calling.range_counts_sharded(
            mesh, sfm.blocks, sfm.F, begins, ends, rows=sfm.rows
        )
        freq_d = quirk_d >= cfg.mcov_out
        nfreq_d = freq_d.sum(axis=1)
        passes_d = nfreq_d >= 2
        if cfg.max_variants_per_position > 0:
            passes_d &= nfreq_d <= cfg.max_variants_per_position
        passes = bits.host_unpackbits(
            np.asarray(bits.device_packbits(passes_d)), B
        ).astype(bool)
        sel = np.flatnonzero(passes)
        if len(sel) == 0:
            return {"events": 0, "cluster_nr": 1}

        sel_d = jnp.asarray(sel, dtype=jnp.int32)
        sb = begins[sel_d]
        se = ends[sel_d]
        freq = np.asarray(freq_d[sel_d])
        ctx, support, full = calling.extract_consensus_sharded(
            mesh, sfm.blocks, sfm.F, sb, se,
            rows=sfm.rows, k_left=cfg.k_left,
        )
        pos_d, found_d = calling.first_thr_position_sharded(
            mesh, next_thr, sb, se, local_n=local_n
        )
        seq, seqlen = calling.extract_dna_sharded(
            mesh, sfm.blocks, sfm.block_counts, sfm.F, sfm.bounds,
            pos_d, found_d, rows=sfm.rows, k_right=cfg.k_right,
        )

        found = np.asarray(found_d)
        support = np.asarray(support)
        full = np.asarray(full)
        ctx_ascii = mpipe._decode_rows(np.asarray(ctx), cfg.term)
        seq_ascii = mpipe._decode_rows(np.asarray(seq), cfg.term)
        seqlen = np.asarray(seqlen)

        return emit_vec.emit_single(
            out_f, cfg, found, passes[sel], freq, full, support,
            ctx_ascii, seq_ascii, seqlen,
        )


# ---------------------------------------------------------------------------
# mode 2 — two collections, implicit merge (sharded)
# ---------------------------------------------------------------------------


def run_two_datasets_sharded(cfg: Config, mesh, log=_log) -> dict:
    compile_cache.enable()
    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWTs ... ")
    # overlapped pack+shard-upload of the two indexes (cf. the
    # single-device pipeline; packer and device dispatch are thread-safe)
    from concurrent.futures import ThreadPoolExecutor

    # each process packs only its own byte ranges (sharded loader)
    if jax.process_count() > 1:
        # the loader's totals-allgather is a collective — two concurrent
        # threads could order the two collectives differently across
        # processes, so multi-process builds run sequentially
        sfm1 = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
        sfm2 = shard.shard_fm_from_file(cfg.input2, mesh, cfg.term)
    else:
        with ThreadPoolExecutor(2) as ex:
            f2 = ex.submit(shard.shard_fm_from_file, cfg.input2, mesh,
                           cfg.term)
            sfm1 = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
            sfm2 = f2.result()
    log("done.")

    log(f"\nPhase 2-3/4: merged suffix-tree wavefront navigation "
        f"({mesh.devices.size}-device mesh).")
    import os

    if os.environ.get("EBWT_FRONTIER", "1") != "0":
        from . import frontier

        nav_pair = frontier.navigate_two_bwts_frontier_device
    else:
        nav_pair = ptraverse.navigate_two_bwts_sharded_device
    thr_K, thr_R, minima, da, (local_n, (st_l, st_n)) = \
        nav_pair(sfm1, sfm2, cfg.K, cfg.k_right)
    st_l = np.asarray(st_l)
    st_n = np.asarray(st_n)
    n = sfm1.n + sfm2.n
    # device counters wrap mod 2^32; every true count is <= n < 2^32
    log(f"Computed {unpat(st_l[3]) + unpat(st_n[3])}/{n} DA values.")
    log(f"Computed {1 + unpat(st_l[1]) + unpat(st_n[1])}/{n} LCP values.")
    log(f"Found {unpat(st_n[2])} LCP minima.")
    log(f"Processed {unpat(st_l[0])} suffix-tree leaves and "
        f"{unpat(st_n[0])} nodes.\n")

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")

    next_thr = calling.next_set_table_sharded(mesh, thr_R,
                                              local_n=local_n, n=n)
    cl = calling.find_clusters_sharded(
        mesh, thr_K, minima, local_n=local_n, n=n, mcov_out=cfg.mcov_out
    )
    da_cs, da_tot = calling.bv_build_sharded(mesh, da)

    stats = _call_and_emit_pair_mode2_sharded(
        sfm1, sfm2, cl, next_thr, (da_cs, da_tot, da), local_n, cfg
    )
    stats["lcp_values"] = 1 + unpat(st_l[1]) + unpat(st_n[1])
    stats["da_values"] = unpat(st_l[3]) + unpat(st_n[3])
    stats["n_min"] = unpat(st_n[2])
    stats["leaves"] = unpat(st_l[0])
    stats["nodes"] = unpat(st_n[0])
    stats["n_clusters"] = cl.n_clusters

    avg = cl.clust_size_sum / cl.n_clusters if cl.n_clusters else float("nan")
    log(f"\nDone.\nAnalyzed {cl.n_clusters} clusters.")
    log(f"Average cluster length: {avg}.\n")
    log(
        "Distribution of bases inside clusters "
        "(cluster length / number of bases inside clusters of that length): \n"
    )
    mpipe.print_histogram(cl.hist, log)
    return stats


def _call_and_emit_pair_mode2_sharded(sfm1, sfm2, cl, next_thr, da_pack,
                                      local_n, cfg) -> dict:
    mesh = sfm1.mesh
    da_cs, da_tot, da = da_pack
    B = len(cl.begins)
    with open(cfg.output, "w") as out_f:
        writer = emit.SnpWriter(
            out_f, complexity=cfg.complexity, max_snvs=cfg.max_snvs,
            mcov_out=cfg.mcov_out, max_gap=cfg.max_gap,
        )
        if B == 0:
            return {"events": writer.events, "cluster_nr": writer.cluster_nr}

        begins = jnp.asarray(cl.begins, jnp.int32)
        ends = jnp.asarray(cl.ends, jnp.int32)
        b1 = calling.bv_rank1_sharded(mesh, da_cs, da_tot, begins,
                                      local_n=local_n)
        e1 = calling.bv_rank1_sharded(mesh, da_cs, da_tot, ends,
                                      local_n=local_n)
        b0 = begins - b1
        e0 = ends - e1

        quirk0_d, _ = calling.range_counts_sharded(
            mesh, sfm1.blocks, sfm1.F, b0, e0, rows=sfm1.rows)
        quirk1_d, _ = calling.range_counts_sharded(
            mesh, sfm2.blocks, sfm2.F, b1, e1, rows=sfm2.rows)
        passes_d = mpipe._pair_passes(quirk0_d, quirk1_d, cfg)
        passes = bits.host_unpackbits(
            np.asarray(bits.device_packbits(passes_d)), B
        ).astype(bool)
        sel = np.flatnonzero(passes)
        if len(sel) == 0:
            return {"events": writer.events, "cluster_nr": writer.cluster_nr}

        sel_d = jnp.asarray(sel, jnp.int32)
        ctx0, support0, full0 = calling.extract_consensus_sharded(
            mesh, sfm1.blocks, sfm1.F, b0[sel_d], e0[sel_d],
            rows=sfm1.rows, k_left=cfg.k_left)
        ctx1, support1, full1 = calling.extract_consensus_sharded(
            mesh, sfm2.blocks, sfm2.F, b1[sel_d], e1[sel_d],
            rows=sfm2.rows, k_left=cfg.k_left)

        pos_d, found_d = calling.first_thr_position_sharded(
            mesh, next_thr, begins[sel_d], ends[sel_d], local_n=local_n
        )
        hit1 = calling.bv_rank1_sharded(mesh, da_cs, da_tot, pos_d,
                                        local_n=local_n)
        hit0 = pos_d - hit1
        da_at_d = calling.bv_get_sharded(mesh, da, pos_d, local_n=local_n)
        seq_a, len_a = calling.extract_dna_sharded(
            mesh, sfm1.blocks, sfm1.block_counts, sfm1.F, sfm1.bounds,
            hit0, found_d & ~da_at_d, rows=sfm1.rows, k_right=cfg.k_right)
        seq_b, len_b = calling.extract_dna_sharded(
            mesh, sfm2.blocks, sfm2.block_counts, sfm2.F, sfm2.bounds,
            hit1, found_d & da_at_d, rows=sfm2.rows, k_right=cfg.k_right)
        da_at = np.asarray(da_at_d)
        found = np.asarray(found_d)
        seq = np.where(da_at[:, None], np.asarray(seq_b), np.asarray(seq_a))
        seqlen = np.where(da_at, np.asarray(len_b), np.asarray(len_a))

        mpipe._emit_pair_clusters(
            writer, cfg, len(sel), found,
            np.asarray(quirk0_d[sel_d]), np.asarray(quirk1_d[sel_d]),
            np.asarray(support0), np.asarray(support1),
            np.asarray(full0), np.asarray(full1),
            mpipe._decode_rows(np.asarray(ctx0), cfg.term),
            mpipe._decode_rows(np.asarray(ctx1), cfg.term),
            mpipe._decode_rows(seq, cfg.term), seqlen,
        )
        return {"events": writer.events, "cluster_nr": writer.cluster_nr}


# ---------------------------------------------------------------------------
# mode 3 — merged BWT + document array (sharded)
# ---------------------------------------------------------------------------


def run_two_datasets_da_sharded(cfg: Config, mesh, log=_log) -> dict:
    compile_cache.enable()
    from ..utils import dna

    cfg = cfg.resolved()
    log("Phase 1/4: loading and indexing eBWT ... ")
    # sharded loader: this process packs only the byte ranges its devices
    # own, for BOTH indexes — the DA-masked second index reads the two
    # memmaps per range and masks on the fly (DA=0 characters replaced by
    # TERM, SURVEY.md §7 layer 5), so no process materializes any O(n)
    # derived string
    import os as _osm

    n_file = _osm.path.getsize(cfg.input1)
    raw_mm = np.memmap(cfg.input1, dtype=np.uint8, mode="r")
    da_mm = np.memmap(cfg.input_da, dtype=np.uint8, mode="r")

    def _masked(lo, hi):
        return np.where(da_mm[lo:hi] == ord("1"), raw_mm[lo:hi],
                        np.uint8(cfg.term))

    def _build_da1():
        return shard.shard_fm_from_loader(_masked, n_file, mesh, cfg.term)

    if jax.process_count() > 1:
        # the loader's totals-allgather is a collective — serialize the
        # two index builds across processes (cf. run_two_datasets_sharded)
        sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
        sfm_da1_now = _build_da1()
        da_fut = None
    else:
        # single process: hide the DA-side build behind navigation
        from concurrent.futures import ThreadPoolExecutor

        _ex = ThreadPoolExecutor(1)
        da_fut = _ex.submit(_build_da1)
        sfm_da1_now = None
        sfm = shard.shard_fm_from_file(cfg.input1, mesh, cfg.term)
    log("done.")
    log(f"[loader] process {jax.process_index()} packed "
        f"{sfm.local_bytes}/{sfm.n} input bytes")

    log(f"\nPhase 2-3/4: suffix-tree wavefront navigation "
        f"({mesh.devices.size}-device mesh).")
    thr_K, thr_R, minima, (local_n, (st_l, st_n)) = \
        _nav_one(sfm, cfg.K, cfg.k_right)
    st_l = np.asarray(st_l)
    st_n = np.asarray(st_n)
    log(f"Computed {1 + unpat(st_l[1]) + unpat(st_n[1])}/{sfm.n} "
        "LCP values.")
    log(f"Found {unpat(st_n[2])} LCP minima.\n")

    log("Phase 4/4: detecting SNPs and indels.")
    log(f"Output events will be stored in {cfg.output}")

    sfm_da1 = sfm_da1_now if da_fut is None else da_fut.result()

    # DA bits, local_n-partitioned: each process builds only the slices
    # its devices own (read straight off the DA memmap)
    n_dev = mesh.devices.size
    pad_n = local_n * n_dev
    sharding = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(shard.AXIS))
    devs = list(mesh.devices.flat)
    my_proc = jax.process_index()
    local_ids = [s for s, d in enumerate(devs)
                 if d.process_index == my_proc]
    local_da = np.zeros(len(local_ids) * local_n, bool)
    for k, s in enumerate(local_ids):
        lo = min(s * local_n, n_file)
        hi = min((s + 1) * local_n, n_file)
        local_da[k * local_n: k * local_n + (hi - lo)] = \
            da_mm[lo:hi] == ord("1")
    if jax.process_count() > 1:
        da = jax.make_array_from_process_local_data(sharding, local_da,
                                                    (pad_n,))
    else:
        da = jax.device_put(local_da, sharding)
    da_cs, da_tot = calling.bv_build_sharded(mesh, da)

    next_thr = calling.next_set_table_sharded(mesh, thr_R,
                                              local_n=local_n, n=sfm.n)
    cl = calling.find_clusters_sharded(
        mesh, thr_K, minima, local_n=local_n, n=sfm.n, mcov_out=cfg.mcov_out
    )

    stats = _call_and_emit_pair_mode3_sharded(
        sfm, sfm_da1, cl, next_thr, (da_cs, da_tot), local_n, cfg
    )
    stats["lcp_values"] = 1 + unpat(st_l[1]) + unpat(st_n[1])
    stats["n_min"] = unpat(st_n[2])
    stats["leaves"] = unpat(st_l[0])
    stats["nodes"] = unpat(st_n[0])
    stats["n_clusters"] = cl.n_clusters

    avg = cl.clust_size_sum / cl.n_clusters if cl.n_clusters else float("nan")
    log(f"\nDone.\nAnalyzed {cl.n_clusters} clusters.")
    log(f"Average cluster length: {avg}.\n")
    log(
        "Distribution of bases inside clusters "
        "(cluster length / number of bases inside clusters of that length): \n"
    )
    mpipe.print_histogram(cl.hist, log)
    # mode-3 quirk: the reference prints the (never-incremented) `events`
    # counter here — always 0 (ebwt2InDel.cpp:1577)
    log(
        f"\nStored to file 0 sequences clustered in "
        f"{stats['cluster_nr'] - 1} clusters."
    )
    return stats


def _call_and_emit_pair_mode3_sharded(sfm, sfm_da1, cl, next_thr, da_pack,
                                      local_n, cfg) -> dict:
    mesh = sfm.mesh
    da_cs, da_tot = da_pack
    B = len(cl.begins)
    with open(cfg.output, "w") as out_f:
        writer = emit.SnpWriter(
            out_f, complexity=cfg.complexity, max_snvs=cfg.max_snvs,
            mcov_out=cfg.mcov_out, max_gap=cfg.max_gap,
        )
        if B == 0:
            return {"events": writer.events, "cluster_nr": writer.cluster_nr}

        begins = jnp.asarray(cl.begins, jnp.int32)
        ends = jnp.asarray(cl.ends, jnp.int32)

        _, pure_all = calling.range_counts_sharded(
            mesh, sfm.blocks, sfm.F, begins, ends, rows=sfm.rows)
        _, pure_1 = calling.range_counts_sharded(
            mesh, sfm_da1.blocks, sfm_da1.F, begins, ends, rows=sfm_da1.rows)
        len1 = (calling.bv_rank1_sharded(mesh, da_cs, da_tot, ends,
                                         local_n=local_n)
                - calling.bv_rank1_sharded(mesh, da_cs, da_tot, begins,
                                           local_n=local_n))
        len_all = ends - begins
        pure_0 = pure_all - pure_1
        quirk1_d = pure_1.at[:, 0].add(len1 - pure_1.sum(axis=1))
        quirk0_d = pure_0.at[:, 0].add((len_all - len1) - pure_0.sum(axis=1))

        passes_d = mpipe._pair_passes(quirk0_d, quirk1_d, cfg)
        passes = bits.host_unpackbits(
            np.asarray(bits.device_packbits(passes_d)), B
        ).astype(bool)
        sel = np.flatnonzero(passes)
        if len(sel) == 0:
            return {"events": writer.events, "cluster_nr": writer.cluster_nr}

        sel_d = jnp.asarray(sel, jnp.int32)
        sb = begins[sel_d]
        se = ends[sel_d]
        ctx, support, full = calling.extract_consensus_sharded(
            mesh, sfm.blocks, sfm.F, sb, se, rows=sfm.rows,
            k_left=cfg.k_left)
        pos_d, found_d = calling.first_thr_position_sharded(
            mesh, next_thr, sb, se, local_n=local_n
        )
        found = np.asarray(found_d)
        seq, seqlen = calling.extract_dna_sharded(
            mesh, sfm.blocks, sfm.block_counts, sfm.F, sfm.bounds,
            pos_d, found_d, rows=sfm.rows, k_right=cfg.k_right)

        ctx_ascii = mpipe._decode_rows(np.asarray(ctx), cfg.term)
        mpipe._emit_pair_clusters(
            writer, cfg, len(sel), found,
            np.asarray(quirk0_d[sel_d]), np.asarray(quirk1_d[sel_d]),
            np.asarray(support), np.asarray(support),
            np.asarray(full), np.asarray(full),
            ctx_ascii, ctx_ascii,
            mpipe._decode_rows(np.asarray(seq), cfg.term),
            np.asarray(seqlen),
        )
        return {"events": writer.events, "cluster_nr": writer.cluster_nr}
