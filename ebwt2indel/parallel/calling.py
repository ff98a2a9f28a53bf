"""Sharded phase-4+ primitives: per-cluster counting, consensus and
right-context walks, and the right-context anchor table, over a
position-sharded index (SURVEY.md §2.5 end-to-end mesh pipeline).

Cluster state (begins/ends, walk intervals) is replicated — it is O(#clusters),
tiny next to the index — while every rank/select touches only the owning
shard's device memory and combines with one psum over the interconnect. The walk bodies are shared
with the single-device path (models/call.py: consensus_core,
extract_dna_core, range_counts_core — device reformulations of
extract_consensus ebwt2InDel.cpp:243-319 and extract_dna 325-342).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..models import call
from ..ops.coords import asu32, pat32, ult, umin
from . import shard
from .shard import AXIS


@partial(jax.jit, static_argnames=("mesh", "rows"))
def range_counts_sharded(mesh, blocks, F, begins, ends, *, rows):
    """Sharded models.call.range_counts: begins/ends replicated (B,)."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def run(blocks_l, F_rep, b, e):
        def prank(i):
            return jax.lax.psum(
                shard.local_parallel_rank(blocks_l, rows, i), AXIS
            )

        return call.range_counts_core(prank, b, e)

    return run(blocks, F, begins, ends)


@partial(jax.jit, static_argnames=("mesh", "rows", "k_left"))
def extract_consensus_sharded(mesh, blocks, F, begins, ends, *, rows,
                              k_left):
    """Sharded models.call.extract_consensus_batch (same consensus_core
    body; lf_range answered by psum-combined local rank)."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(), P(), P()),
             out_specs=(P(), P(), P()), check_vma=False)
    def run(blocks_l, F_rep, b, e):
        def lf_range(lo, hi):
            lo4 = jax.lax.psum(
                shard.local_parallel_rank(blocks_l, rows, lo), AXIS)
            hi4 = jax.lax.psum(
                shard.local_parallel_rank(blocks_l, rows, hi), AXIS)
            return F_rep + lo4, F_rep + hi4

        return call.consensus_core(lf_range, b, e, k_left)

    return run(blocks, F, begins, ends)


@partial(jax.jit, static_argnames=("mesh", "rows", "k_right"))
def extract_dna_sharded(mesh, blocks, block_counts, F, bounds, starts,
                        active, *, rows, k_right):
    """Sharded models.call.extract_dna_batch: the FL step's select runs on
    the shard owning the target rank (replicated per-shard count bounds
    route it); one psum combines positions per step."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(), P(), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def run(blocks_l, counts_l, F_rep, bounds_rep, st, act):
        def f_char(i):
            # F and i are uint32 bit patterns: broadcast unsigned compare
            # (models/fm_index.f_char; dna_bwt.hpp:100-110)
            r = jnp.sum((asu32(F_rep) <= asu32(i)[..., None])
                        .astype(jnp.int32), axis=-1)
            return jnp.where(r == 0, jnp.int32(4), r - 1)

        def fl(i):
            c = f_char(i)
            cc = jnp.clip(c, 0, 3)
            r = i - F_rep[cc]
            return jax.lax.psum(
                shard.local_select(blocks_l, counts_l, bounds_rep, rows,
                                   r, cc), AXIS)

        return call.extract_dna_core(f_char, fl, st, act, k_right)

    return run(blocks, block_counts, F, bounds, starts, active)


@partial(jax.jit, static_argnames=("mesh", "local_n", "n"))
def next_set_table_sharded(mesh, thr_R, *, local_n, n):
    """Sharded models.call.next_set_table: next_set[i] = smallest j >= i
    with thr_R[j] set (n if none). Local reverse cummin + the cross-shard
    suffix min of per-shard minima (one all_gather of n_dev scalars)."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS),),
             out_specs=P(AXIS), check_vma=False)
    def run(thr_l):
        # positions are uint32 bit patterns: the no-set sentinel is the
        # pattern of n (unsigned-greater than every real position) and
        # every min/scan runs on the unsigned view (ops.coords)
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        n_pat = jnp.int32(pat32(n))
        gpos = sid * local_n + jnp.arange(local_n, dtype=jnp.int32)
        idx = jnp.where(thr_l & ult(gpos, n_pat), gpos, n_pat)
        loc = jax.lax.cummin(asu32(idx), reverse=True).astype(jnp.int32)
        mins = jax.lax.all_gather(loc[0], AXIS)  # (n_dev,)
        after = jnp.arange(n_dev, dtype=jnp.int32) > sid
        right = jnp.min(jnp.where(after, asu32(mins),
                                  asu32(n_pat))).astype(jnp.int32)
        return umin(loc, right)

    return run(thr_R)


# ---------------------------------------------------------------------------
# sharded document-array rank (modes 2/3: per-BWT sub-ranges of clusters —
# the reference scans its vector<bool> DA sequentially, ebwt2InDel.cpp:1431)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh",))
def bv_build_sharded(mesh, da):
    """Rank acceleration over a sharded boolean vector: per-shard inclusive
    cumsum (stays sharded) + replicated per-shard totals."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS),),
             out_specs=(P(AXIS), P()), check_vma=False)
    def run(da_l):
        cs = jnp.cumsum(da_l.astype(jnp.int32))
        return cs, jax.lax.all_gather(cs[-1], AXIS)

    return run(da)


@partial(jax.jit, static_argnames=("mesh", "local_n"))
def bv_rank1_sharded(mesh, cs, totals, i, *, local_n):
    """Number of ones before position i (replicated queries, sharded
    cumsum): owning shard answers local prefix + cross-shard prefix of
    totals; psum combines."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS), P(), P()),
             out_specs=P(), check_vma=False)
    def run(cs_l, tot, q):
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        local = q - sid * local_n
        mine = (local >= 0) & (local < local_n)
        before = jnp.sum(jnp.where(
            jnp.arange(n_dev, dtype=jnp.int32) < sid, tot, 0))
        v = jnp.where(local > 0,
                      cs_l[jnp.clip(local - 1, 0, local_n - 1)], 0) + before
        return jax.lax.psum(jnp.where(mine, v, 0), AXIS)

    return run(cs, totals, i)


@partial(jax.jit, static_argnames=("mesh", "local_n"))
def bv_get_sharded(mesh, da, i, *, local_n):
    """Gather a sharded boolean vector at replicated positions."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS), P()),
             out_specs=P(), check_vma=False)
    def run(da_l, q):
        sid = jax.lax.axis_index(AXIS)
        local = q - sid * local_n
        mine = (local >= 0) & (local < local_n)
        v = da_l[jnp.clip(local, 0, local_n - 1)]
        return jax.lax.psum(
            jnp.where(mine, v, False).astype(jnp.int32), AXIS) != 0

    return run(da, i)


# ---------------------------------------------------------------------------
# phase 4: sharded cluster enumeration
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh", "local_n", "n"))
def _cluster_marks(mesh, thr_K, minima, *, local_n, n):
    """Per-shard run-start / run-end marks with 1-element ppermute halos
    (cluster-open predicate: thr_K and not minima — ebwt2InDel.cpp:1609-1655;
    a run still open at global position n-1 never closes)."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
             out_specs=(P(AXIS), P(AXIS), P(), P()), check_vma=False)
    def run(thr_l, min_l):
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        gpos = sid * local_n + jnp.arange(local_n, dtype=jnp.int32)
        mask = thr_l & ~min_l & ult(gpos, jnp.int32(pat32(n)))
        # halos: non-receiving edge shards get ppermute's zero fill (False)
        left_last = jax.lax.ppermute(
            mask[-1], AXIS, [(i, i + 1) for i in range(n_dev - 1)]
        )
        right_first = jax.lax.ppermute(
            mask[0], AXIS, [(i + 1, i) for i in range(n_dev - 1)]
        )
        prev = jnp.concatenate([left_last[None], mask[:-1]])
        nxt = jnp.concatenate([mask[1:], right_first[None]])
        is_start = mask & ~prev
        end_at = mask & ~nxt & (gpos != jnp.int32(pat32(n - 1)))
        return (is_start, end_at,
                jax.lax.psum(is_start.sum(dtype=jnp.int32), AXIS),
                jax.lax.psum(end_at.sum(dtype=jnp.int32), AXIS))

    return run(thr_K, minima)


@partial(jax.jit, static_argnames=("mesh", "local_n", "cap"))
def _compact_marks(mesh, is_start, end_at, *, local_n, cap):
    """Compact the sharded run marks into replicated position-sorted
    (starts, ends) lists: each shard scatters its marks at its global
    offset (exclusive prefix of per-shard counts via one all_gather);
    a psum merges the disjoint scatters."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS), P(AXIS)),
             out_specs=(P(), P()), check_vma=False)
    def run(is_start, end_at):
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        gpos = sid * local_n + jnp.arange(local_n, dtype=jnp.int32)
        before = jnp.arange(n_dev, dtype=jnp.int32) < sid

        def compact(m, val):
            cnt = m.sum(dtype=jnp.int32)
            counts = jax.lax.all_gather(cnt, AXIS)
            off = jnp.sum(jnp.where(before, counts, 0))
            idx = jnp.cumsum(m.astype(jnp.int32)) - 1
            tgt = jnp.where(m, off + idx, cap)
            buf = jnp.zeros(cap, jnp.int32).at[tgt].set(val, mode="drop")
            return jax.lax.psum(buf, AXIS)

        return compact(is_start, gpos), compact(end_at, gpos + 1)

    return run(is_start, end_at)


def find_clusters_sharded(mesh, thr_K, minima, *, local_n, n,
                          mcov_out: int):
    """Sharded models.cluster.find_clusters_device: flags stay sharded;
    only O(#runs) positions are materialized (replicated). Returns a
    Clusters with replicated device begins/ends."""
    import numpy as np

    from ..models import cluster as mcluster

    is_start, end_at, n_starts, n_ends = _cluster_marks(
        mesh, thr_K, minima, local_n=local_n, n=n
    )
    cap = mcluster._cap(max(int(n_starts), 1))
    starts, ends = _compact_marks(mesh, is_start, end_at,
                                  local_n=local_n, cap=cap)
    a_begins, a_ends, n_analyzed, hist, size_sum = jax.jit(
        mcluster.runs_to_clusters, static_argnames=("cap", "mcov_out")
    )(starts, ends, n_ends, cap=cap, mcov_out=mcov_out)
    n_analyzed_i = int(n_analyzed)
    return mcluster.Clusters(
        begins=a_begins[:n_analyzed_i],
        ends=a_ends[:n_analyzed_i],
        n_clusters=n_analyzed_i,
        clust_size_sum=int(size_sum),
        n_closed=int(n_ends),
        hist=np.asarray(hist),
    )


@partial(jax.jit, static_argnames=("mesh", "local_n"))
def first_thr_position_sharded(mesh, next_set, begins, ends, *, local_n):
    """Sharded models.call.first_thr_position_device: gather the sharded
    anchor table at replicated cluster begins (owning shard answers, psum
    combines); returns replicated (pos, found)."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS), P(), P()),
             out_specs=(P(), P()), check_vma=False)
    def run(ns_l, b, e):
        sid = jax.lax.axis_index(AXIS)
        base = sid * local_n
        local = b - base
        mine = (local >= 0) & (local < local_n)
        safe = jnp.clip(local, 0, local_n - 1)
        pos = jax.lax.psum(jnp.where(mine, ns_l[safe], 0), AXIS)
        found = ult(pos, e)  # unsigned: positions past 2^31
        return jnp.where(found, pos, 0), found

    return run(next_set, begins, ends)
