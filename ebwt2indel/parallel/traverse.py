"""Position-sharded wavefront traversal over a device mesh — all three run
modes (single-BWT and the lockstep two-BWT merge).

The packed index rows and the flag vectors are sharded over a 1-D 'pos'
mesh; the work queue is replicated (it is tiny relative to the index) and
every device runs the same deterministic queue schedule, so the only
communication is one psum per chunk combining the per-shard rank answers.
Rank decode uses owned-query compaction (shard.local_parallel_rank): each
shard decodes only its owned ~B/n_dev queries, so both HBM gather traffic
and VPU decode work scale down with mesh size.

The wave bodies here mirror models/traverse.py's single-device bodies
(_leaf_body/_node_body/_leaf_pair_body/_node_pair_body — reference
navigate_one_bwt ebwt2InDel.cpp:555-676, navigate_two_bwts 679-831) with
local flag scatters; exact flag-parity tests against the single-device
traversal (tests/test_parallel.py) pin the two implementations together.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P

from ..models import traverse as t1
from ..ops import rank
from ..ops.coords import pat32, uge, ugt, ult
from ..ops.packing import PackedBwt
from . import shard

AXIS = shard.AXIS


@partial(jax.jit,
         static_argnames=("mesh", "rows_per_shard", "local_n", "queue_cap",
                          "chunk", "K", "k_right"))
def _sharded_node_phase(mesh, blocks, F, init, nf, *, rows_per_shard,
                        local_n, queue_cap, chunk, K, k_right):
    """Internal-node phase with sharded index + flags, replicated queue."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(), P(), P(AXIS)),
             out_specs=(P(AXIS), P(), P()),
             check_vma=False)
    def run(blocks_l, F_rep, init_rep, nf_l):
        sid = jax.lax.axis_index(AXIS)
        pos_base = sid * local_n
        w = 7
        q = jnp.zeros((queue_cap + 4 * chunk, w), dtype=jnp.int32)
        q = jax.lax.dynamic_update_slice(q, init_rep, (0, 0))

        def extend(nodes):
            coords = nodes[:, :6]
            ranks = jax.lax.psum(
                shard.local_parallel_rank_sorted(
                    blocks_l, rows_per_shard, coords,
                    budget=max(128, chunk // 8),
                ), AXIS
            )
            ext = F_rep[:, None] + jnp.swapaxes(ranks, -1, -2)
            depth = jnp.broadcast_to(nodes[:, 6:7, None] + 1,
                                     ext.shape[:-1] + (1,))
            return jnp.concatenate([ext, depth], axis=-1)

        def cond(state):
            _, head, tail, _, _ = state
            return head < tail

        def step(state):
            q, head, tail, nf_l, stats = state
            need = (tail + 4 * chunk) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)), (chunk, w))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count

            depth = block[:, 6]
            last = block[:, 5]
            # positions are uint32 bit patterns (ops.coords): ordered
            # compares use the unsigned view; dead entries carry v == 0
            # (a zero add is a no-op, so no position sentinel is needed)
            idxs, vals = [], []
            lcp_values = jnp.int32(0)
            n_min = jnp.int32(0)
            for j in range(1, 5):
                border = block[:, j]
                has_prev = ugt(border, block[:, j - 1])
                condb = valid & has_prev & (border != last)
                lcp_values = lcp_values + condb.sum(dtype=jnp.int32)
                v = ((condb & (depth >= K)) * 1
                     + (condb & (depth >= k_right)) * 2)
                if j >= 2:
                    prev_size = border - block[:, j - 1]
                    cond_m = valid & uge(prev_size, 2) & \
                        ult(border, last - 1)
                    n_min = n_min + cond_m.sum(dtype=jnp.int32)
                    v = v + cond_m * 4
                idxs.append(border)
                vals.append(v)
            # local scatter of globally-indexed writes
            gi = jnp.concatenate(idxs) - pos_base
            gv = jnp.concatenate(vals)
            safe = jnp.where(ult(gi, local_n), gi, local_n)
            nf_l = nf_l.at[safe].add(gv, mode="drop")

            ext = extend(block)
            nch = jnp.sum(
                ugt(ext[..., 1:6], ext[..., 0:5]).astype(jnp.int32), axis=-1
            )
            keep = (valid[:, None] & (nch >= 2)).reshape(-1)
            out, n_out = t1._compact(ext.reshape(-1, w), keep, budget=chunk)
            q = jax.lax.dynamic_update_slice(q, out, (tail, jnp.int32(0)))
            head = head + count
            tail = tail + n_out
            stats = (stats[0] + count, stats[1] + lcp_values,
                     stats[2] + n_min)
            return q, head, tail, nf_l, stats

        stats0 = (jnp.int32(0),) * 3
        state = (q, jnp.int32(0), jnp.int32(init_rep.shape[0]), nf_l, stats0)
        q, head, tail, nf_l, stats = jax.lax.while_loop(cond, step, state)
        return nf_l, jnp.stack(stats), tail

    return run(blocks, F, init, nf)


def navigate_nodes_sharded(pb: PackedBwt, mesh, K: int, k_right: int):
    """Run the sharded internal-node phase; returns (thr_K, thr_R, minima)
    as host arrays plus stats. Flags are reassembled from the sharded
    bit-flag vector."""
    n_dev = mesh.devices.size
    blocks, block_counts, F, rows = shard.shard_packed(pb, mesh)
    local_n = -(-pb.n // n_dev)
    pad_n = local_n * n_dev
    nf = jax.device_put(np.zeros(pad_n, np.int32),
                        NamedSharding(mesh, P(AXIS)))
    Fh = pb.F.astype(np.int32)
    init = np.array([[0, Fh[0], Fh[1], Fh[2], Fh[3],
                  pat32(pb.n), 0]], np.int32)
    nf, stats, total = _sharded_node_phase(
        mesh, blocks, jnp.asarray(F), jnp.asarray(init), nf,
        rows_per_shard=rows, local_n=local_n,
        queue_cap=max(1 << 18, pb.n // 32), chunk=4096, K=K, k_right=k_right,
    )
    nf_h = np.asarray(nf)[: pb.n]
    return ((nf_h & 1) != 0).astype(np.uint8), \
        ((nf_h & 2) != 0).astype(np.uint8), \
        ((nf_h & 4) != 0).astype(np.uint8), np.asarray(stats)


@partial(jax.jit,
         static_argnames=("mesh", "rows_per_shard", "local_n", "queue_cap",
                          "chunk", "K", "k_right"))
def _sharded_leaf_phase(mesh, blocks, F, init, dif, *, rows_per_shard,
                        local_n, queue_cap, chunk, K, k_right):
    """Leaf phase with sharded index + diff fields, replicated queue.

    dif is a (2, local_n*n_dev)-sharded int32 buffer: field 0 = K-diff,
    field 1 = k_right-diff boundary deltas (models/traverse._leaf_body).
    """

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(), P(), P(None, AXIS)),
             out_specs=(P(None, AXIS), P(), P()),
             check_vma=False)
    def run(blocks_l, F_rep, init_rep, dif_l):
        sid = jax.lax.axis_index(AXIS)
        pos_base = sid * local_n
        w = 3
        q = jnp.zeros((queue_cap + 4 * chunk, w), dtype=jnp.int32)
        q = jax.lax.dynamic_update_slice(q, init_rep, (0, 0))

        def cond(state):
            _, head, tail, _, _ = state
            return head < tail

        def step(state):
            q, head, tail, dif_l, stats = state
            need = (tail + 4 * chunk) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)), (chunk, w))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            first, second, depth = block[:, 0], block[:, 1], block[:, 2]

            condK = (valid & (depth >= K)).astype(jnp.int32)
            condR = (valid & (depth >= k_right)).astype(jnp.int32)
            fields = jnp.concatenate([
                jnp.zeros(2 * chunk, jnp.int32),
                jnp.ones(2 * chunk, jnp.int32),
            ])
            # dead entries carry value 0 (a zero add is a no-op); local
            # membership is the unsigned wrapped-offset check
            gi = jnp.concatenate([
                first + 1, second, first + 1, second,
            ]) - pos_base
            gv = jnp.concatenate([condK, -condK, condR, -condR])
            mine = ult(gi, local_n)
            safe_pos = jnp.where(mine, gi, local_n)
            flat_idx = fields * (local_n + 1) + safe_pos
            dif_flat = jnp.concatenate(
                [dif_l[0], jnp.zeros(1, jnp.int32),
                 dif_l[1], jnp.zeros(1, jnp.int32)]
            )
            dif_flat = dif_flat.at[flat_idx].add(gv, mode="drop")
            dif_l = jnp.stack([dif_flat[: local_n],
                               dif_flat[local_n + 1: 2 * local_n + 1]])

            ranks = jax.lax.psum(
                shard.local_parallel_rank(blocks_l, rows_per_shard,
                                     jnp.stack([first, second], -1)), AXIS
            )  # (chunk, 2, 4)
            lo4 = F_rep + ranks[:, 0]
            hi4 = F_rep + ranks[:, 1]
            child_depth = jnp.broadcast_to((depth + 1)[:, None], lo4.shape)
            children = jnp.stack([lo4, hi4, child_depth], axis=-1)
            keep = valid[:, None] & uge(hi4 - lo4, 2)
            out, n_out = t1._compact_cm(children.reshape(chunk * 4, w),
                                        keep, budget=chunk)
            q = jax.lax.dynamic_update_slice(q, out, (tail, jnp.int32(0)))
            head = head + count
            tail = tail + n_out
            stats = (stats[0] + count,
                     stats[1] + jnp.sum(jnp.where(valid, second - first - 1,
                                                  0)),
                     stats[2])
            return q, head, tail, dif_l, stats

        stats0 = (jnp.int32(0),) * 3
        state = (q, jnp.int32(0), jnp.int32(init_rep.shape[0]), dif_l, stats0)
        q, head, tail, dif_l, stats = jax.lax.while_loop(cond, step, state)
        return dif_l, jnp.stack(stats), tail

    return run(blocks, F, init, dif)


@partial(jax.jit, static_argnames=("mesh",))
def _combine_flags(mesh, nf, dif):
    """Merge the node-phase bit flags with the leaf-phase boundary deltas
    into the final sharded flag vectors.

    The range fill is a global inclusive prefix sum of the sharded deltas:
    local cumsum + the exclusive cross-shard prefix of per-shard totals
    (one all_gather of n_dev scalars).
    """

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(None, AXIS)),
             out_specs=(P(AXIS),) * 3)
    def run(nf_l, dif_l):
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        cs = jnp.cumsum(dif_l, axis=1)  # (2, local_n)
        totals = jax.lax.all_gather(cs[:, -1], AXIS)  # (n_dev, 2)
        before = jnp.arange(n_dev, dtype=jnp.int32) < sid
        prefix = jnp.sum(jnp.where(before[:, None], totals, 0), axis=0)
        fill = (cs + prefix[:, None]) > 0
        thr_K = ((nf_l & 1) != 0) | fill[0]
        thr_R = ((nf_l & 2) != 0) | fill[1]
        minima = (nf_l & 4) != 0
        return thr_K, thr_R, minima

    return run(nf, dif)


def navigate_one_bwt_sharded_device(sfm: shard.ShardedFM, K: int,
                                    k_right: int):
    """Full sharded mode-1 navigation; flags STAY on device.

    Returns (thr_K, thr_R, minima) — bool jax.Arrays of padded length
    local_n * n_dev sharded P('pos') — plus (local_n, stats). Positions
    >= sfm.n are padding (their flags are always False: no traversal
    write targets them).
    """
    mesh = sfm.mesh
    n_dev = mesh.devices.size
    local_n = -(-(sfm.n + 2) // n_dev)  # room for deltas at n and n+1
    pad_n = local_n * n_dev
    queue_cap = max(1 << 18, sfm.n // 32)

    Fh = np.asarray(sfm.F)
    dif = jax.device_put(np.zeros((2, pad_n), np.int32),
                         NamedSharding(mesh, P(None, AXIS)))
    init_l = np.array([[0, Fh[0], 0]], np.int32)
    dif, st_l, _ = _sharded_leaf_phase(
        mesh, sfm.blocks, sfm.F, jnp.asarray(init_l), dif,
        rows_per_shard=sfm.rows, local_n=local_n,
        queue_cap=queue_cap, chunk=4096, K=K, k_right=k_right,
    )

    nf = jax.device_put(np.zeros(pad_n, np.int32),
                        NamedSharding(mesh, P(AXIS)))
    init_n = np.array([[0, Fh[0], Fh[1], Fh[2], Fh[3],
                        pat32(sfm.n), 0]], np.int32)
    nf, st_n, _ = _sharded_node_phase(
        mesh, sfm.blocks, sfm.F, jnp.asarray(init_n), nf,
        rows_per_shard=sfm.rows, local_n=local_n,
        queue_cap=queue_cap, chunk=4096, K=K, k_right=k_right,
    )

    thr_K, thr_R, minima = _combine_flags(mesh, nf, dif)
    return thr_K, thr_R, minima, (local_n, (st_l, st_n))


def navigate_one_bwt_sharded(pb: PackedBwt, mesh, K: int, k_right: int):
    """Host-array wrapper over navigate_one_bwt_sharded_device, equivalent
    to models.traverse.navigate_one_bwt (parity-tested)."""
    sfm = shard.shard_fm(pb, mesh)
    thr_K, thr_R, minima, (_, stats) = navigate_one_bwt_sharded_device(
        sfm, K, k_right
    )
    return (np.asarray(thr_K)[: pb.n].astype(np.uint8),
            np.asarray(thr_R)[: pb.n].astype(np.uint8),
            np.asarray(minima)[: pb.n].astype(np.uint8), stats)


# ---------------------------------------------------------------------------
# lockstep two-BWT (pair) phases — sharded modes 2/3 navigation
# ---------------------------------------------------------------------------


@partial(jax.jit,
         static_argnames=("mesh", "rows1", "rows2", "local_n", "queue_cap",
                          "chunk", "K", "k_right"))
def _sharded_leaf_pair_phase(mesh, blocks1, blocks2, F1, F2, init, dif, *,
                             rows1, rows2, local_n, queue_cap, chunk, K,
                             k_right):
    """Lockstep leaf-pair phase (models/traverse._leaf_pair_body; reference
    update_DA ebwt2InDel.cpp:394-425). dif: (3, local_n*n_dev) sharded int32
    boundary deltas — fields K-diff, R-diff, DA-diff over merged positions.
    """

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(), P(), P(),
                       P(None, AXIS)),
             out_specs=(P(None, AXIS), P(), P()),
             check_vma=False)
    def run(b1_l, b2_l, F1r, F2r, init_rep, dif_l):
        sid = jax.lax.axis_index(AXIS)
        pos_base = sid * local_n
        w = 5
        q = jnp.zeros((queue_cap + 4 * chunk, w), dtype=jnp.int32)
        q = jax.lax.dynamic_update_slice(q, init_rep, (0, 0))

        def cond(state):
            _, head, tail, _, _ = state
            return head < tail

        def step(state):
            q, head, tail, dif_l, stats = state
            need = (tail + 4 * chunk) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)), (chunk, w))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            f1, s1, f2, s2, depth = (block[:, i] for i in range(5))
            start1 = f1 + f2
            start2 = f2 + s1
            end = s1 + s2

            condK = (valid & (depth >= K)).astype(jnp.int32)
            condR = (valid & (depth >= k_right)).astype(jnp.int32)
            vv = valid.astype(jnp.int32)
            fields = jnp.concatenate([
                jnp.zeros(2 * chunk, jnp.int32),
                jnp.ones(2 * chunk, jnp.int32),
                jnp.full(2 * chunk, 2, jnp.int32),
            ])
            # dead entries carry value 0; unsigned local membership
            gi = jnp.concatenate([
                start1 + 1, end, start1 + 1, end, start2, end,
            ]) - pos_base
            gv = jnp.concatenate([condK, -condK, condR, -condR, vv, -vv])
            mine = ult(gi, local_n)
            safe_pos = jnp.where(mine, gi, local_n)
            flat_idx = fields * (local_n + 1) + safe_pos
            z1 = jnp.zeros(1, jnp.int32)
            dif_flat = jnp.concatenate(
                [dif_l[0], z1, dif_l[1], z1, dif_l[2], z1]
            )
            dif_flat = dif_flat.at[flat_idx].add(gv, mode="drop")
            s0 = local_n + 1
            dif_l = jnp.stack([dif_flat[:local_n],
                               dif_flat[s0: s0 + local_n],
                               dif_flat[2 * s0: 2 * s0 + local_n]])

            r1, r2 = jax.lax.psum(
                (shard.local_parallel_rank(b1_l, rows1,
                                           jnp.stack([f1, s1], -1)),
                 shard.local_parallel_rank(b2_l, rows2,
                                           jnp.stack([f2, s2], -1))),
                AXIS,
            )  # each (chunk, 2, 4)
            lo1 = F1r + r1[:, 0]
            hi1 = F1r + r1[:, 1]
            lo2 = F2r + r2[:, 0]
            hi2 = F2r + r2[:, 1]
            child_depth = jnp.broadcast_to((depth + 1)[:, None], lo1.shape)
            children = jnp.stack([lo1, hi1, lo2, hi2, child_depth], axis=-1)
            combined = (hi1 - lo1) + (hi2 - lo2)
            keep = (valid[:, None] & uge(combined, 2)).reshape(chunk * 4)
            out, n_out = t1._compact(children.reshape(chunk * 4, w), keep,
                                     budget=chunk)
            q = jax.lax.dynamic_update_slice(q, out, (tail, jnp.int32(0)))
            head = head + count
            tail = tail + n_out
            stats = (
                stats[0] + count,
                stats[1] + jnp.sum(jnp.where(valid, end - start1 - 1, 0)),
                stats[2],
                stats[3] + jnp.sum(jnp.where(valid, end - start1, 0)),
            )
            return q, head, tail, dif_l, stats

        stats0 = (jnp.int32(0),) * 4
        state = (q, jnp.int32(0), jnp.int32(init_rep.shape[0]), dif_l, stats0)
        q, head, tail, dif_l, stats = jax.lax.while_loop(cond, step, state)
        return dif_l, jnp.stack(stats), tail

    return run(blocks1, blocks2, F1, F2, init, dif)


@partial(jax.jit,
         static_argnames=("mesh", "rows1", "rows2", "local_n", "queue_cap",
                          "chunk", "K", "k_right"))
def _sharded_node_pair_phase(mesh, blocks1, blocks2, F1, F2, init, nf, *,
                             rows1, rows2, local_n, queue_cap, chunk, K,
                             k_right):
    """Lockstep node-pair phase (models/traverse._node_pair_body; reference
    find_leaves ebwt2InDel.cpp:474-527 + merged-node updates 792-802).
    nf: sharded int32 bit flags — 1=thr_K, 2=thr_R, 4=minima, 8=DA one.
    """

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(), P(), P(),
                       P(AXIS)),
             out_specs=(P(AXIS), P(), P()),
             check_vma=False)
    def run(b1_l, b2_l, F1r, F2r, init_rep, nf_l):
        sid = jax.lax.axis_index(AXIS)
        pos_base = sid * local_n
        w = 13

        def extend(nodes):
            bud = max(128, chunk // 8)
            r1, r2 = jax.lax.psum(
                (shard.local_parallel_rank_sorted(b1_l, rows1,
                                                  nodes[:, 0:6], budget=bud),
                 shard.local_parallel_rank_sorted(b2_l, rows2,
                                                  nodes[:, 6:12], budget=bud)),
                AXIS,
            )  # each (C, 6, 4)
            ext1 = F1r[:, None] + jnp.swapaxes(r1, -1, -2)  # (C, 4, 6)
            ext2 = F2r[:, None] + jnp.swapaxes(r2, -1, -2)
            return ext1, ext2

        q = jnp.zeros((queue_cap + 4 * chunk, w), dtype=jnp.int32)
        q = jax.lax.dynamic_update_slice(q, init_rep, (0, 0))

        def cond(state):
            _, head, tail, _, _ = state
            return head < tail

        def step(state):
            q, head, tail, nf_l, stats = state
            need = (tail + 4 * chunk) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)), (chunk, w))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            c1 = block[:, 0:6]
            c2 = block[:, 6:12]
            depth = block[:, 12]
            merged = c1 + c2
            last = merged[:, 5]
            # uint32 bit-pattern coordinates; dead entries carry value 0

            idxs, vals = [], []
            da_values = jnp.int32(0)
            for j in range(5):
                l1 = c1[:, j + 1] - c1[:, j]
                l2 = c2[:, j + 1] - c2[:, j]
                condl = valid & ((l1 + l2) == 1)
                pos = c1[:, j] + c2[:, j]
                da_values = da_values + jnp.sum(condl.astype(jnp.int32))
                cond_da = condl & (l2 == 1)
                idxs.append(pos)
                vals.append(cond_da * 8)

            lcp_values = jnp.int32(0)
            n_min = jnp.int32(0)
            for j in range(1, 5):
                border = merged[:, j]
                has_prev = ugt(border, merged[:, j - 1])
                condb = valid & has_prev & (border != last)
                lcp_values = lcp_values + condb.sum(dtype=jnp.int32)
                v = ((condb & (depth >= K)) * 1
                     + (condb & (depth >= k_right)) * 2)
                if j >= 2:
                    prev_size = border - merged[:, j - 1]
                    cond_m = valid & uge(prev_size, 2) & \
                        ult(border, last - 1)
                    n_min = n_min + cond_m.sum(dtype=jnp.int32)
                    v = v + cond_m * 4
                idxs.append(border)
                vals.append(v)
            gi = jnp.concatenate(idxs) - pos_base
            gv = jnp.concatenate(vals)
            safe = jnp.where(ult(gi, local_n), gi, local_n)
            nf_l = nf_l.at[safe].add(gv, mode="drop")

            ext1, ext2 = extend(block)
            u1 = ugt(ext1[..., 1:6], ext1[..., 0:5])
            u2 = ugt(ext2[..., 1:6], ext2[..., 0:5])
            n_union = jnp.sum((u1 | u2).astype(jnp.int32), axis=-1)
            child_depth = jnp.broadcast_to((depth + 1)[:, None, None],
                                           ext1[..., :1].shape)
            children = jnp.concatenate([ext1, ext2, child_depth], axis=-1)
            keep = (valid[:, None] & (n_union >= 2)).reshape(chunk * 4)
            out, n_out = t1._compact(children.reshape(chunk * 4, w), keep,
                                     budget=chunk)
            q = jax.lax.dynamic_update_slice(q, out, (tail, jnp.int32(0)))
            head = head + count
            tail = tail + n_out
            stats = (stats[0] + count, stats[1] + lcp_values,
                     stats[2] + n_min, stats[3] + da_values)
            return q, head, tail, nf_l, stats

        stats0 = (jnp.int32(0),) * 4
        state = (q, jnp.int32(0), jnp.int32(init_rep.shape[0]), nf_l, stats0)
        q, head, tail, nf_l, stats = jax.lax.while_loop(cond, step, state)
        return nf_l, jnp.stack(stats), tail

    return run(blocks1, blocks2, F1, F2, init, nf)


@partial(jax.jit, static_argnames=("mesh",))
def _combine_flags_pair(mesh, nf, dif):
    """Pair-mode flag combine: bit flags + 3-field boundary-delta fills
    (K, R, DA) via local cumsum + cross-shard exclusive prefix."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(None, AXIS)),
             out_specs=(P(AXIS),) * 4)
    def run(nf_l, dif_l):
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        cs = jnp.cumsum(dif_l, axis=1)  # (3, local_n)
        totals = jax.lax.all_gather(cs[:, -1], AXIS)  # (n_dev, 3)
        before = jnp.arange(n_dev, dtype=jnp.int32) < sid
        prefix = jnp.sum(jnp.where(before[:, None], totals, 0), axis=0)
        fill = (cs + prefix[:, None]) > 0
        thr_K = ((nf_l & 1) != 0) | fill[0]
        thr_R = ((nf_l & 2) != 0) | fill[1]
        minima = (nf_l & 4) != 0
        da = ((nf_l & 8) != 0) | fill[2]
        return thr_K, thr_R, minima, da

    return run(nf, dif)


def navigate_two_bwts_sharded_device(sfm1: shard.ShardedFM,
                                     sfm2: shard.ShardedFM,
                                     K: int, k_right: int):
    """Full sharded lockstep navigation (modes 2/3 merge); flags STAY on
    device. Returns (thr_K, thr_R, minima, da) sharded bool arrays of
    padded length local_n * n_dev plus (local_n, stats)."""
    mesh = sfm1.mesh
    n_dev = mesh.devices.size
    n = sfm1.n + sfm2.n
    local_n = -(-(n + 2) // n_dev)
    pad_n = local_n * n_dev
    queue_cap = max(1 << 18, n // 32)

    F1h = np.asarray(sfm1.F)
    F2h = np.asarray(sfm2.F)
    dif = jax.device_put(np.zeros((3, pad_n), np.int32),
                         NamedSharding(mesh, P(None, AXIS)))
    init_l = np.array([[0, F1h[0], 0, F2h[0], 0]], np.int32)
    dif, st_l, _ = _sharded_leaf_pair_phase(
        mesh, sfm1.blocks, sfm2.blocks, sfm1.F, sfm2.F,
        jnp.asarray(init_l), dif,
        rows1=sfm1.rows, rows2=sfm2.rows, local_n=local_n,
        queue_cap=queue_cap, chunk=4096, K=K, k_right=k_right,
    )

    nf = jax.device_put(np.zeros(pad_n, np.int32),
                        NamedSharding(mesh, P(AXIS)))
    init_n = np.array([[0, F1h[0], F1h[1], F1h[2], F1h[3], pat32(sfm1.n),
                        0, F2h[0], F2h[1], F2h[2], F2h[3], pat32(sfm2.n),
                        0]], np.int32)
    nf, st_n, _ = _sharded_node_pair_phase(
        mesh, sfm1.blocks, sfm2.blocks, sfm1.F, sfm2.F,
        jnp.asarray(init_n), nf,
        rows1=sfm1.rows, rows2=sfm2.rows, local_n=local_n,
        queue_cap=queue_cap, chunk=4096, K=K, k_right=k_right,
    )

    thr_K, thr_R, minima, da = _combine_flags_pair(mesh, nf, dif)
    return thr_K, thr_R, minima, da, (local_n, (st_l, st_n))


def navigate_two_bwts_sharded(pb1: PackedBwt, pb2: PackedBwt, mesh,
                              K: int, k_right: int):
    """Host-array wrapper over navigate_two_bwts_sharded_device, equivalent
    to models.traverse.navigate_two_bwts (parity-tested)."""
    sfm1 = shard.shard_fm(pb1, mesh)
    sfm2 = shard.shard_fm(pb2, mesh)
    thr_K, thr_R, minima, da, (_, stats) = navigate_two_bwts_sharded_device(
        sfm1, sfm2, K, k_right
    )
    n = pb1.n + pb2.n
    return (np.asarray(thr_K)[:n].astype(np.uint8),
            np.asarray(thr_R)[:n].astype(np.uint8),
            np.asarray(minima)[:n].astype(np.uint8),
            np.asarray(da)[:n].astype(np.uint8), stats)
