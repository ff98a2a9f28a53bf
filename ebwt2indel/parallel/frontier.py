"""Frontier-sharded traversal: per-shard work queues, psum-free narrow rank.

The position-sharded traversal in parallel/traverse.py replicates the work
queue on every shard — index rows, rank decode, and flag storage shard, but
the queue machinery (children compaction, row gather, append, flag-entry
sort) repeats per device, which caps node-phase scaling. This module
shards the FRONTIER itself:

* A node lives on the shard that owns the block row of its first
  coordinate. Narrow nodes (span <= 2 rank blocks — almost all of them)
  read both anchor rows locally thanks to a one-row right halo, so their
  Weiner extension needs NO collective at all.
* Children are routed to their owner with one fixed-shape `all_to_all`
  per step (dest-sorted buckets; per-bucket counts ride an all_gather).
* Wide nodes (>= 3 blocks; the first ~log4 n levels) are all_gathered
  under a small budget; every shard decodes its local contribution to
  their ranks, one psum combines, and each shard pushes only the wide
  children it owns — exactly-once without routing.
* Flag writes land in per-shard packed nibble words; the rare entries
  that spill past the shard's right edge (nodes straddling the boundary
  row) ride a ppermute to the right neighbor.
* The loop condition reads carried global scalars (pending, overflow)
  psum'd once per body, so every shard runs the same iteration count —
  all collectives sit at fixed points of the program.

Queue machinery therefore scales ~1/n_dev with the frontier, and the only
per-step communication is O(children) rows between devices. Exact flag parity
with the single-device traversal is pinned by tests/test_parallel.py.

Reference semantics: navigate_one_bwt's node loop (ebwt2InDel.cpp:555-676,
update_lcp_threshold include.hpp:826-860, update_lcp_minima
ebwt2InDel.cpp:357-391); cf. models/traverse._node_body.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..models import traverse as t1
from ..ops.coords import pat32, udiv, uge, ugt, ult
from ..ops.packing import PackedBwt
from . import shard

AXIS = shard.AXIS


# pair-phase side-2 rank transport: 1 = all_to_all query routing (per-step
# communication O(chunk) per shard, independent of mesh size), 0 = the
# round-2 full-chunk all_gather + psum formulation (O(n_dev*chunk) — kept
# for A/B; see comm_bytes_per_step)
import os as _os

_PAIR_ROUTE = _os.environ.get("EBWT_PAIR_ROUTE", "1") != "0"


def comm_bytes_per_step(n_dev: int, chunk: int, k: int, w: int,
                        qseg: int, routed: bool) -> int:
    """Per-shard, per-step communication bytes of the pair phases'
    side-2 rank transport (asserted by tests/test_parallel.py): routed =
    query rows out + answer rows back (fixed n_dev*qseg buffers, qseg ~
    2*chunk/n_dev); all_gather = the full (n_dev, chunk, w) chunk gather
    plus two psum'd (n_dev*chunk, k, 4) rank tensors."""
    if routed:
        q_row = (k + 1) * 4          # k coords + slot
        a_row = (4 * k + 1) * 4      # 4 ranks per coord + slot
        return n_dev * qseg * (q_row + a_row)
    return (n_dev * chunk * w * 4          # all_gather of the chunks
            + 2 * n_dev * chunk * k * 4 * 4)  # two psum'd rank tensors


def _routed_pair_rank(b_h, rows_b, coords, valid, *, n_dev, sid, qseg):
    """parallel_rank at per-row sorted k-coordinate tuples answered by
    the OWNING shard via fixed-shape all_to_all query routing.

    coords: (C, k) int32, rows non-decreasing; only rows whose anchor
    block rows span <= 2 (narrow on the queried side) get exact answers —
    the owner of row(coords[:,0]) decodes both anchors through its 1-row
    right halo (b_h = local blocks + halo). Queries carry their source
    chunk slot; answers return through the reverse all_to_all and scatter
    back by slot. Per-shard traffic is O(n_dev*qseg) rows with
    qseg ~ 2*chunk/n_dev — O(chunk), independent of mesh size — versus
    the all_gather formulation's O(n_dev*chunk) (comm_bytes_per_step).

    Returns (ranks (C, k, 4) — garbage on rows not answered, callers mask
    by their own narrow classification — and an overflow flag set when a
    (src, dst) bucket exceeds qseg; the host doubles qseg and retries)."""
    C, k = coords.shape
    rb0 = jax.lax.shift_right_logical(coords[:, 0], 7)
    rbk = jax.lax.shift_right_logical(coords[:, k - 1], 7)
    narrow = valid & ((rbk - rb0) <= 1)
    dest = jnp.clip(rb0 // rows_b, 0, n_dev - 1)
    slot = jnp.arange(C, dtype=jnp.int32)
    flat = jnp.concatenate([coords, slot[:, None]], axis=1)  # (C, k+1)

    # dest-sorted buckets (cf. _route), fixed segment qseg per (src, dst)
    sp = jax.lax.sort(jnp.where(narrow, dest * C + slot, n_dev * C + slot), is_stable=False)
    rows_sorted = flat[jnp.minimum(sp % C, C - 1)]
    sdest = jnp.minimum(sp // C, n_dev - 1)
    n_q = jnp.sum(narrow.astype(jnp.int32))
    cnt = jnp.zeros(n_dev, jnp.int32).at[
        jnp.where(slot < n_q, sdest, n_dev)
    ].add(1, mode="drop")
    ovf = jnp.any(cnt > qseg).astype(jnp.int32)
    off = jnp.cumsum(cnt) - cnt
    R = n_dev * qseg
    slot_d = jnp.arange(R, dtype=jnp.int32) // qseg
    slot_s = jnp.arange(R, dtype=jnp.int32) % qseg
    src = jnp.where(slot_s < cnt[slot_d], off[slot_d] + slot_s, 0)
    send = rows_sorted[jnp.minimum(src, C - 1)]
    send = jnp.where((slot_s < cnt[slot_d])[:, None], send, -1)
    recv = jax.lax.all_to_all(send, AXIS, 0, 0, tiled=True)  # (R, k+1)

    # decode every recv slot against the owner-local haloed rows (invalid
    # slots carry coords -1 -> clipped rows, garbage; their slot is -1 so
    # the answer scatter drops them)
    qc = recv[:, :k]
    o = qc & jnp.int32(127)
    base_row = sid * rows_b
    a0 = jnp.clip(
        jax.lax.shift_right_logical(qc[:, 0], 7) - base_row, 0, rows_b)
    ak = jnp.clip(
        jax.lax.shift_right_logical(qc[:, k - 1], 7) - base_row, 0, rows_b)
    dec_lo = shard._local_decode_multi(b_h[a0], o)
    dec_hi = shard._local_decode_multi(b_h[ak], o)
    b_rows = jax.lax.shift_right_logical(qc, 7)
    use_hi = b_rows == b_rows[:, k - 1][:, None]
    dec = jnp.where(use_hi[:, :, None], dec_hi, dec_lo)  # (R, k, 4)

    ans = jnp.concatenate([recv[:, k:], dec.reshape(R, 4 * k)], axis=1)
    back = jax.lax.all_to_all(ans, AXIS, 0, 0, tiled=True)  # (R, 4k+1)
    aslot = back[:, 0]
    ranks = jnp.zeros((C, k, 4), jnp.int32).at[
        jnp.where(aslot >= 0, aslot, C)
    ].set(back[:, 1:].reshape(R, k, 4), mode="drop")
    return ranks, ovf


def _route(flat, keep, dest, segN, *, n_dev, sid):
    """Fixed-shape all_to_all routing of kept rows to dest shards
    (dest-sorted buckets; per-bucket counts ride an all_gather). Must run
    in lockstep on every shard (call only from shard_map bodies at fixed
    program points). Returns (received compacted rows, their count, an
    overflow flag set when any bucket exceeds segN)."""
    m = flat.shape[0]
    iota = jnp.arange(m, dtype=jnp.int32)
    sp = jax.lax.sort(jnp.where(keep, dest * m + iota,
                                n_dev * m + iota), is_stable=False)
    rows_sorted = flat[jnp.minimum(sp % m, m - 1)]
    sdest = jnp.minimum(sp // m, n_dev - 1)
    n_keep = jnp.sum(keep.astype(jnp.int32))
    cnt = jnp.zeros(n_dev, jnp.int32).at[
        jnp.where(iota < n_keep, sdest, n_dev)
    ].add(1, mode="drop")
    ovf = jnp.any(cnt > segN).astype(jnp.int32)
    off = jnp.cumsum(cnt) - cnt
    slot_d = jnp.arange(n_dev * segN, dtype=jnp.int32) // segN
    slot_s = jnp.arange(n_dev * segN, dtype=jnp.int32) % segN
    src = jnp.where(slot_s < cnt[slot_d], off[slot_d] + slot_s, 0)
    send = rows_sorted[jnp.minimum(src, m - 1)]
    recv = jax.lax.all_to_all(send, AXIS, 0, 0, tiled=True)
    cnt_all = jax.lax.all_gather(cnt, AXIS)
    rq, n_rq = t1._compact(recv, slot_s < cnt_all[:, sid][slot_d])
    return rq, n_rq, ovf


# ---------------------------------------------------------------------------
# bounded dispatches + checkpoint/resume (SURVEY §5: "phases 2/3 wavefronts
# can checkpoint their frontier + bitvectors"; the single-chip analogue is
# models/traverse._run_phase). Each frontier phase runs at most `max_iters`
# queue steps per device dispatch and carries its full per-shard state
# (queue, head/tail, flag buffer, stats, pending, overflow) across
# dispatches; the host driver persists that state to EBWT_CKPT_DIR every
# EBWT_CKPT_EVERY dispatches and resumes from it after a kill.
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("mesh", "caprows", "w", "flag_len"))
def _frontier_state_init(mesh, seed, *, caprows, w, flag_len):
    """Initial per-shard phase state: the seed row on shard 0's queue, a
    pristine flag buffer per shard, zero stats. Returns the cross-dispatch
    state tuple (q (n_dev,caprows,w), head/tail (n_dev,), flag
    (n_dev,flag_len), stats (n_dev,4), pending (), govf ())."""

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(),),
             out_specs=(P(AXIS, None, None), P(AXIS), P(AXIS),
                        P(AXIS, None), P(AXIS, None), P(), P()),
             check_vma=False)
    def run(seed_rep):
        sid = jax.lax.axis_index(AXIS)
        q = jnp.zeros((caprows, w), jnp.int32)
        q = q.at[0].set(jnp.where(sid == 0, seed_rep, 0))
        tail0 = jnp.where(sid == 0, jnp.int32(1), jnp.int32(0))
        flag = jnp.zeros(flag_len, jnp.int32)
        return (q[None], jnp.zeros(1, jnp.int32), tail0[None], flag[None],
                jnp.zeros((1, 4), jnp.int32), jax.lax.psum(tail0, AXIS),
                jnp.int32(0))

    return run(seed)


def _ckpt_file(tag: str):
    d = _os.environ.get("EBWT_CKPT_DIR")
    return _os.path.join(d, f"frontier_{tag}.npz") if d else None


def _drive_phase(dispatch, state, mesh, *, tag: str, caprows: int):
    """Host dispatch loop: run bounded dispatches until the frontier
    drains or a budget overflows, checkpointing the carried state every
    EBWT_CKPT_EVERY dispatches (resume handled by _maybe_resume)."""
    path = _ckpt_file(tag)
    every = int(_os.environ.get("EBWT_CKPT_EVERY", 0))
    d = 0
    while True:
        out = dispatch(state)
        state, stats, govf = out[0], out[1], out[2]
        extra = out[3] if len(out) > 3 else None
        d += 1
        pending = int(state[5])
        if int(govf) or pending == 0:
            break
        if path and every and d % every == 0:
            _os.makedirs(_os.path.dirname(path), exist_ok=True)
            np.savez(path, caprows=caprows,
                     **{f"s{i}": np.asarray(s) for i, s in enumerate(state)})
    if path and int(govf) == 0 and _os.path.isfile(path):
        _os.remove(path)
    return state, stats, govf, extra


def _maybe_resume(state, mesh, *, tag: str, caprows: int):
    """Replace the freshly-initialized state with the checkpointed one
    when a compatible checkpoint exists (same queue capacity)."""
    path = _ckpt_file(tag)
    if not path or not _os.path.isfile(path):
        return state
    z = np.load(path)
    if int(z["caprows"]) != caprows:
        return state
    from jax.sharding import NamedSharding

    specs = (P(AXIS, None, None), P(AXIS), P(AXIS), P(AXIS, None),
             P(AXIS, None), P(), P())
    return tuple(
        jax.device_put(z[f"s{i}"], NamedSharding(mesh, sp))
        for i, sp in enumerate(specs)
    )


@partial(jax.jit,
         static_argnames=("mesh", "rows", "queue_cap", "chunk", "wbudget",
                          "fbudget", "seg", "K", "k_right", "max_iters"))
def _frontier_node_phase(mesh, blocks, F6, state, *, rows, queue_cap, chunk,
                         wbudget, fbudget, seg, K, k_right,
                         max_iters=1 << 30):
    """One frontier-sharded internal-node phase dispatch (at most
    max_iters queue steps). F6 = (F_A,F_C,F_G,F_T,n). Takes and returns
    the cross-dispatch state of _frontier_state_init (flag buffer =
    per-shard packed nibble words, rows*16 each); also returns psum'd
    stats(4,), a global overflow count (host retries bigger), and the
    per-shard processed-node counts (n_dev,) — the load-balance evidence
    for the ~1/n_dev queue-machinery scaling claim."""
    n_dev = mesh.devices.size
    M = 4 * chunk  # children slots per chunk; chunk is a power of two
    # budgets are clamped to their entry-vector lengths: n_wide <= chunk
    # and spills <= 4*chunk per step, and an unclamped budget past those
    # bounds silently truncates the [:budget] slice into a shape mismatch
    # (the host doubling-retry can otherwise grow them past the bound)
    wbudget = min(wbudget, chunk)
    fbudget = min(fbudget, 4 * chunk)
    NW = n_dev * wbudget
    MAXAPP = n_dev * seg + 4 * NW  # rows appended per step, worst case

    _state_specs = (P(AXIS, None, None), P(AXIS), P(AXIS), P(AXIS, None),
                    P(AXIS, None), P(), P())

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(), _state_specs),
             out_specs=(_state_specs, P(), P(), P()),
             check_vma=False)
    def run(blocks_l, F6_rep, state_l):
        sid = jax.lax.axis_index(AXIS)
        F4 = F6_rep[:4]
        base_row = sid * rows
        base_pos = base_row * 128
        local_pos = rows * 128
        # one-row right halo: every narrow node's second anchor is local
        halo = jax.lax.ppermute(
            blocks_l[0], AXIS,
            [(i, (i - 1) % n_dev) for i in range(n_dev)]
        )
        blocks_h = jnp.concatenate([blocks_l, halo[None]], axis=0)

        def flag_entries(rows7, vmask):
            # positions/sizes are uint32 bit patterns (ops.coords):
            # ordered compares use the unsigned view
            c = rows7[:, :6]
            depth = rows7[:, 6]
            last = c[:, 5]
            lcp = jnp.int32(0)
            nmin = jnp.int32(0)
            idxs, vals = [], []
            for j in range(1, 5):
                border = c[:, j]
                has_prev = ugt(border, c[:, j - 1])
                cond = vmask & has_prev & (border != last)
                lcp = lcp + jnp.sum(cond.astype(jnp.int32))
                v = ((cond & (depth >= K)) * 1
                     + (cond & (depth >= k_right)) * 2)
                if j >= 2:
                    prev_size = border - c[:, j - 1]
                    cond_m = vmask & uge(prev_size, 2) & \
                        ult(border, last - 1)
                    nmin = nmin + jnp.sum(cond_m.astype(jnp.int32))
                    v = v + cond_m * 4
                idxs.append(border)
                vals.append(v)
            return (jnp.concatenate(idxs), jnp.concatenate(vals), lcp, nmin)

        def body(state):
            (q, head, tail, nf_l, stats, pending, govf, it) = state
            need = (tail + MAXAPP) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            ovf = ((tail + MAXAPP) > q.shape[0]).astype(jnp.int32)

            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)),
                                          (chunk, 7))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            b = jax.lax.shift_right_logical(block[:, :6], 7)
            narrow = valid & ((b[:, 5] - b[:, 0]) <= 1)
            wide = valid & ~narrow

            # ---- narrow extension: fully local (halo'd anchors) --------
            o = block[:, :6] & jnp.int32(127)
            a0 = jnp.clip(b[:, 0] - base_row, 0, rows)
            a5 = jnp.clip(b[:, 5] - base_row, 0, rows)
            dec_lo = shard._local_decode_multi(blocks_h[a0], o)
            dec_hi = shard._local_decode_multi(blocks_h[a5], o)
            use_hi = b == b[:, 5][:, None]
            ranks = jnp.where(use_hi[:, :, None], dec_hi, dec_lo)
            ext = F4[:, None] + jnp.swapaxes(ranks, -1, -2)  # (C,4,6)
            depth4 = jnp.broadcast_to(block[:, None, 6:7] + 1,
                                      (chunk, 4, 1))
            ext = jnp.concatenate([ext, depth4], axis=-1)  # (C,4,7)

            # ---- wide nodes: all_gather + local rank + psum ------------
            n_wide = jnp.sum(wide.astype(jnp.int32))
            ovf = ovf + (n_wide > wbudget)
            iota_c = jnp.arange(chunk, dtype=jnp.int32)
            wperm = jax.lax.sort(jnp.where(wide, iota_c, chunk + iota_c), is_stable=False)
            wrows = block[jnp.minimum(wperm[:wbudget], chunk - 1)]
            wvalid_l = jnp.arange(wbudget, dtype=jnp.int32) < n_wide
            wrows = jnp.where(wvalid_l[:, None], wrows, 0)
            wall = jax.lax.all_gather(wrows, AXIS)  # (n_dev, wb, 7)
            wcnt = jax.lax.all_gather(n_wide, AXIS)  # (n_dev,)
            wflat = wall.reshape(NW, 7)
            wsrc = jnp.arange(NW, dtype=jnp.int32) // wbudget
            wvalid = (jnp.arange(NW, dtype=jnp.int32) % wbudget) < \
                wcnt[wsrc]
            wranks = jax.lax.psum(
                shard.local_parallel_rank(blocks_l, rows, wflat[:, :6]),
                AXIS,
            )  # (NW, 6, 4)
            wext = F4[:, None] + jnp.swapaxes(wranks, -1, -2)
            wdepth = jnp.broadcast_to(wflat[:, None, 6:7] + 1, (NW, 4, 1))
            wext = jnp.concatenate([wext, wdepth], axis=-1)

            # ---- flag writes -------------------------------------------
            # a narrow node's borders sit within 256 positions of its
            # owner shard's range, so the wrapped local offset of a
            # live (nval > 0) entry is exactly ult-classifiable: mine
            # in [0, local_pos), spill in [local_pos, local_pos + 256)
            nidx, nval, lcp_n, min_n = flag_entries(block, narrow)
            lpos = nidx - base_pos
            mine = (nval > 0) & ult(lpos, local_pos)
            nf_l = t1._flag_scatter(nf_l, jnp.where(mine, lpos, -1), nval)
            spill = (nval > 0) & ~ult(lpos, local_pos)
            n_sp = jnp.sum(spill.astype(jnp.int32))
            ovf = ovf + (n_sp > fbudget)
            m4 = nidx.shape[0]
            iota4 = jnp.arange(m4, dtype=jnp.int32)
            sperm = jax.lax.sort(jnp.where(spill, iota4, m4 + iota4), is_stable=False)
            sp_sel = jnp.minimum(sperm[:fbudget], m4 - 1)
            sp_ok = jnp.arange(fbudget, dtype=jnp.int32) < n_sp
            fwd = jnp.stack(
                [jnp.where(sp_ok, nidx[sp_sel] - (base_pos + local_pos),
                           -1),
                 jnp.where(sp_ok, nval[sp_sel], 0)], axis=-1,
            )
            fwd = jax.lax.ppermute(
                fwd, AXIS, [(i, (i + 1) % n_dev) for i in range(n_dev)]
            )
            nf_l = t1._flag_scatter(
                nf_l,
                jnp.where((fwd[:, 0] >= 0) & (sid > 0), fwd[:, 0], -1),
                fwd[:, 1],
            )

            # wide nodes: every shard sees them all; scatter the borders
            # that land locally; count stats only for own contributions
            widx, wval, _, _ = flag_entries(wflat, wvalid)
            wlpos = widx - base_pos
            wmine = (wval > 0) & ult(wlpos, local_pos)
            nf_l = t1._flag_scatter(nf_l, jnp.where(wmine, wlpos, -1),
                                    wval)
            _, _, lcp_w, min_w = flag_entries(wflat, wvalid & (wsrc == sid))

            # ---- narrow children: dest-sorted buckets + all_to_all -----
            nch = jnp.sum(ugt(ext[..., 1:6],
                              ext[..., 0:5]).astype(jnp.int32), axis=-1)
            flat_n = ext.reshape(M, 7)
            keep_flat = (narrow[:, None] & (nch >= 2)).reshape(M)
            dest = jnp.clip(
                jax.lax.shift_right_logical(flat_n[:, 0], 7) // rows,
                0, n_dev - 1,
            )
            iota_m = jnp.arange(M, dtype=jnp.int32)
            sp = jax.lax.sort(jnp.where(keep_flat, dest * M + iota_m,
                                        n_dev * M + iota_m), is_stable=False)
            rows_sorted = flat_n[sp & jnp.int32(M - 1)]  # M power of two
            sdest = jnp.minimum(sp // M, n_dev - 1)
            n_keep = jnp.sum(keep_flat.astype(jnp.int32))
            cnt = jnp.zeros(n_dev, jnp.int32).at[
                jnp.where(iota_m < n_keep, sdest, n_dev)
            ].add(1, mode="drop")
            ovf = ovf + jnp.any(cnt > seg).astype(jnp.int32)
            off = jnp.cumsum(cnt) - cnt
            slot_d = jnp.arange(n_dev * seg, dtype=jnp.int32) // seg
            slot_s = jnp.arange(n_dev * seg, dtype=jnp.int32) % seg
            src = jnp.where(slot_s < cnt[slot_d], off[slot_d] + slot_s, 0)
            send = rows_sorted[jnp.minimum(src, M - 1)]
            recv = jax.lax.all_to_all(
                send.reshape(n_dev * seg, 7), AXIS, 0, 0, tiled=True
            )  # (n_dev*seg, 7); segment j comes from shard j
            cnt_all = jax.lax.all_gather(cnt, AXIS)  # (src, dst)
            rcnt = cnt_all[:, sid]
            rq, n_rq = t1._compact(recv, slot_s < rcnt[slot_d])

            # wide children: everyone has wext; push only the owned ones
            wch = jnp.sum(ugt(wext[..., 1:6], wext[..., 0:5]).astype(
                jnp.int32), axis=-1)
            wflat_c = wext.reshape(NW * 4, 7)
            wdest = jnp.clip(
                jax.lax.shift_right_logical(wflat_c[:, 0], 7) // rows,
                0, n_dev - 1,
            )
            wq, n_wq = t1._compact(
                wflat_c,
                (wvalid[:, None] & (wch >= 2)).reshape(-1) & (wdest == sid),
            )

            q = jax.lax.dynamic_update_slice(q, rq, (tail, jnp.int32(0)))
            tail = tail + n_rq
            q = jax.lax.dynamic_update_slice(q, wq, (tail, jnp.int32(0)))
            tail = tail + n_wq
            head = head + count

            stats = (stats[0] + count,
                     stats[1] + lcp_n + lcp_w,
                     stats[2] + min_n + min_w,
                     jnp.maximum(stats[3], tail - head))
            glob = jax.lax.psum(
                jnp.stack([tail - head, ovf]), AXIS
            )
            return (q, head, tail, nf_l, stats, glob[0], govf + glob[1],
                    it + 1)

        def cond(state):
            return (state[5] > 0) & (state[6] == 0) & \
                (state[7] < max_iters)

        q3, head1, tail1, nf2, stats2, pending, govf = state_l
        state = (q3[0], head1[0], tail1[0], nf2[0], tuple(stats2[0]),
                 pending, govf, jnp.int32(0))
        state = jax.lax.while_loop(cond, body, state)
        q, head, tail, nf_l, stats, pending, govf, _ = state
        # per-shard processed counts (replicated): the load-balance
        # evidence for the ~1/n_dev queue-machinery scaling claim
        work = jax.lax.all_gather(stats[0], AXIS)
        state_out = (q[None], head[None], tail[None], nf_l[None],
                     jnp.stack(stats)[None], pending, govf)
        return (state_out, jax.lax.psum(jnp.stack(stats), AXIS), govf,
                work)

    return run(blocks, F6, state)


@partial(jax.jit,
         static_argnames=("mesh", "rows", "queue_cap", "chunk", "wbudget",
                          "fbudget", "seg", "K", "k_right", "max_iters"))
def _frontier_leaf_phase(mesh, blocks, F6, state, *, rows, queue_cap, chunk,
                         wbudget, fbudget, seg, K, k_right,
                         max_iters=1 << 30):
    """Frontier-sharded leaf phase dispatch (update_LCP_leaf,
    ebwt2InDel.cpp:344-355; next_leaves dna_bwt.hpp:358-379). Same
    machinery as the node phase with 3-wide rows [first, second, depth],
    a 2-anchor lf_range, and dual-lane packed boundary deltas
    (models/traverse._leaf_body) written to a per-shard (rows*128,) delta
    vector (the state's flag buffer). Returns (state, stats(4,) psum'd
    [leaves, lcp, max_depth, maxp], overflow count, 0)."""
    n_dev = mesh.devices.size
    M = 4 * chunk
    # clamp budgets to their entry-vector bounds (see _frontier_node_phase)
    wbudget = min(wbudget, chunk)
    fbudget = min(fbudget, 2 * chunk)
    NW = n_dev * wbudget
    MAXAPP = n_dev * seg + 4 * NW

    _state_specs = (P(AXIS, None, None), P(AXIS), P(AXIS), P(AXIS, None),
                    P(AXIS, None), P(), P())

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(), _state_specs),
             out_specs=(_state_specs, P(), P(), P()),
             check_vma=False)
    def run(blocks_l, F6_rep, state_l):
        sid = jax.lax.axis_index(AXIS)
        F4 = F6_rep[:4]
        base_row = sid * rows
        base_pos = base_row * 128
        local_pos = rows * 128
        halo = jax.lax.ppermute(
            blocks_l[0], AXIS,
            [(i, (i - 1) % n_dev) for i in range(n_dev)]
        )
        blocks_h = jnp.concatenate([blocks_l, halo[None]], axis=0)

        def delta_entries(rows3, vmask):
            """(positions, dual-lane values, live mask, lcp sum) of the
            given leaf rows. Positions are uint32 bit patterns; liveness
            rides the explicit keep mask (a -1 sentinel would collide
            with the sign bit of positions past 2^31)."""
            first, second, depth = rows3[:, 0], rows3[:, 1], rows3[:, 2]
            condK = vmask & (depth >= K)
            condR = vmask & (depth >= k_right)
            v = condK * 1 + condR * 65536
            idx = jnp.concatenate([first + 1, second])
            val = jnp.concatenate([v, -v])
            keep = jnp.concatenate([v != 0, v != 0])
            lcp = jnp.sum(jnp.where(vmask, second - first - 1, 0))
            return idx, val, keep, lcp

        def scatter_local(dif_l, idx, val, keep):
            # live entries of a narrow leaf sit within 256 positions of
            # the owner's range: wrapped local offsets are ult-exact
            lpos = idx - base_pos
            ok = keep & ult(lpos, local_pos)
            return dif_l.at[jnp.where(ok, lpos, local_pos)].add(
                val, mode="drop")

        def body(state):
            (q, head, tail, dif_l, stats, pending, govf, it) = state
            need = (tail + MAXAPP) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            ovf = ((tail + MAXAPP) > q.shape[0]).astype(jnp.int32)

            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)),
                                          (chunk, 3))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            bf = jax.lax.shift_right_logical(block[:, 0], 7)
            bs = jax.lax.shift_right_logical(block[:, 1], 7)
            narrow = valid & ((bs - bf) <= 1)
            wide = valid & ~narrow

            # narrow lf_range: both anchor rows local via the halo
            o2 = jnp.stack([block[:, 0], block[:, 1]], -1) & jnp.int32(127)
            af = jnp.clip(bf - base_row, 0, rows)
            asx = jnp.clip(bs - base_row, 0, rows)
            dec_f = shard._local_decode_multi(blocks_h[af], o2)[:, 0]
            dec_s = shard._local_decode_multi(blocks_h[asx], o2)[:, 1]
            lo4 = F4 + dec_f  # (C, 4)
            hi4 = F4 + dec_s

            # wide leaves: all_gather + psum'd rank
            n_wide = jnp.sum(wide.astype(jnp.int32))
            ovf = ovf + (n_wide > wbudget)
            iota_c = jnp.arange(chunk, dtype=jnp.int32)
            wperm = jax.lax.sort(jnp.where(wide, iota_c, chunk + iota_c), is_stable=False)
            wrows = block[jnp.minimum(wperm[:wbudget], chunk - 1)]
            wvalid_l = jnp.arange(wbudget, dtype=jnp.int32) < n_wide
            wrows = jnp.where(wvalid_l[:, None], wrows, 0)
            wall = jax.lax.all_gather(wrows, AXIS)
            wcnt = jax.lax.all_gather(n_wide, AXIS)
            wflat = wall.reshape(NW, 3)
            wsrc = jnp.arange(NW, dtype=jnp.int32) // wbudget
            wvalid = (jnp.arange(NW, dtype=jnp.int32) % wbudget) < \
                wcnt[wsrc]
            wranks = jax.lax.psum(
                shard.local_parallel_rank(
                    blocks_l, rows, wflat[:, :2]
                ), AXIS,
            )  # (NW, 2, 4)
            wlo = F4 + wranks[:, 0]
            whi = F4 + wranks[:, 1]

            # boundary deltas: local scatter + right-neighbor spill
            nidx, nval, nkeep, lcp_n = delta_entries(block, narrow)
            dif_l = scatter_local(dif_l, nidx, nval, nkeep)
            lpos = nidx - base_pos
            spill = nkeep & ~ult(lpos, local_pos)
            n_sp = jnp.sum(spill.astype(jnp.int32))
            ovf = ovf + (n_sp > fbudget)
            m2 = nidx.shape[0]
            iota2 = jnp.arange(m2, dtype=jnp.int32)
            sperm = jax.lax.sort(jnp.where(spill, iota2, m2 + iota2), is_stable=False)
            sp_sel = jnp.minimum(sperm[:fbudget], m2 - 1)
            sp_ok = jnp.arange(fbudget, dtype=jnp.int32) < n_sp
            fwd = jnp.stack(
                [jnp.where(sp_ok, nidx[sp_sel] - (base_pos + local_pos),
                           -1),
                 jnp.where(sp_ok, nval[sp_sel], 0)], axis=-1,
            )
            fwd = jax.lax.ppermute(
                fwd, AXIS, [(i, (i + 1) % n_dev) for i in range(n_dev)]
            )
            dif_l = dif_l.at[jnp.where(
                (fwd[:, 0] >= 0) & (sid > 0), fwd[:, 0], local_pos
            )].add(fwd[:, 1], mode="drop")

            widx, wval, wkeep_d, _ = delta_entries(wflat, wvalid)
            dif_l = scatter_local(dif_l, widx, wval, wkeep_d)
            _, _, _, lcp_w = delta_entries(wflat, wvalid & (wsrc == sid))

            # children (next_leaves): W# extensions with size >= 2, routed
            child_depth = jnp.broadcast_to((block[:, 2] + 1)[:, None],
                                           lo4.shape)
            children = jnp.stack([lo4, hi4, child_depth], -1)  # (C,4,3)
            keep = narrow[:, None] & uge(hi4 - lo4, 2)
            flat_n = jnp.swapaxes(children, 0, 1).reshape(M, 3)
            keep_flat = jnp.swapaxes(keep, 0, 1).reshape(M)
            dest = jnp.clip(
                jax.lax.shift_right_logical(flat_n[:, 0], 7) // rows,
                0, n_dev - 1,
            )
            iota_m = jnp.arange(M, dtype=jnp.int32)
            sp = jax.lax.sort(jnp.where(keep_flat, dest * M + iota_m,
                                        n_dev * M + iota_m), is_stable=False)
            rows_sorted = flat_n[sp & jnp.int32(M - 1)]
            sdest = jnp.minimum(sp // M, n_dev - 1)
            n_keep = jnp.sum(keep_flat.astype(jnp.int32))
            cnt = jnp.zeros(n_dev, jnp.int32).at[
                jnp.where(iota_m < n_keep, sdest, n_dev)
            ].add(1, mode="drop")
            ovf = ovf + jnp.any(cnt > seg).astype(jnp.int32)
            off = jnp.cumsum(cnt) - cnt
            slot_d = jnp.arange(n_dev * seg, dtype=jnp.int32) // seg
            slot_s = jnp.arange(n_dev * seg, dtype=jnp.int32) % seg
            src = jnp.where(slot_s < cnt[slot_d], off[slot_d] + slot_s, 0)
            send = rows_sorted[jnp.minimum(src, M - 1)]
            recv = jax.lax.all_to_all(
                send.reshape(n_dev * seg, 3), AXIS, 0, 0, tiled=True
            )
            cnt_all = jax.lax.all_gather(cnt, AXIS)
            rq, n_rq = t1._compact(recv, slot_s < cnt_all[:, sid][slot_d])

            wchildren = jnp.stack(
                [wlo, whi,
                 jnp.broadcast_to((wflat[:, 2] + 1)[:, None], wlo.shape)],
                -1,
            ).reshape(NW * 4, 3)
            wkeep = (wvalid[:, None] &
                     uge(whi - wlo, 2)).reshape(-1)
            wdest = jnp.clip(
                jax.lax.shift_right_logical(wchildren[:, 0], 7) // rows,
                0, n_dev - 1,
            )
            wq, n_wq = t1._compact(wchildren, wkeep & (wdest == sid))

            q = jax.lax.dynamic_update_slice(q, rq, (tail, jnp.int32(0)))
            tail = tail + n_rq
            q = jax.lax.dynamic_update_slice(q, wq, (tail, jnp.int32(0)))
            tail = tail + n_wq
            head = head + count

            maxd = jnp.max(jnp.where(valid, block[:, 2], 0))
            stats = (stats[0] + count,
                     stats[1] + lcp_n + lcp_w,
                     jnp.maximum(stats[2], maxd),
                     jnp.maximum(stats[3], tail - head))
            glob = jax.lax.psum(jnp.stack([tail - head, ovf]), AXIS)
            return (q, head, tail, dif_l, stats, glob[0], govf + glob[1],
                    it + 1)

        def cond(state):
            return (state[5] > 0) & (state[6] == 0) & \
                (state[7] < max_iters)

        q3, head1, tail1, dif2, stats2, pending, govf = state_l
        state = (q3[0], head1[0], tail1[0], dif2[0], tuple(stats2[0]),
                 pending, govf, jnp.int32(0))
        state = jax.lax.while_loop(cond, body, state)
        q, head, tail, dif_l, stats, pending, govf, _ = state
        smax = jax.lax.pmax(jnp.stack([stats[2], stats[3]]), AXIS)
        ssum = jax.lax.psum(jnp.stack([stats[0], stats[1]]), AXIS)
        state_out = (q[None], head[None], tail[None], dif_l[None],
                     jnp.stack(stats)[None], pending, govf)
        return (state_out, jnp.concatenate([ssum, smax]), govf,
                jnp.int32(0))

    return run(blocks, F6, state)


@partial(jax.jit, static_argnames=("mesh", "rows"))
def _combine_frontier(mesh, nf, dif, *, rows):
    """Merge node-phase packed nibbles with leaf-phase dual-lane deltas:
    local packed cumsum + exclusive cross-shard prefix of packed totals
    (exact while per-position nesting counts stay under 2^15 — the same
    lane bound as the scatter), then carry-aware lane decode."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None)),
             out_specs=(P(AXIS),) * 3)
    def run(nf_l, dif_l):
        nf_l = nf_l[0]
        dif_l = dif_l[0]
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        cs = jnp.cumsum(dif_l)  # packed dual-lane prefix (bounded lanes)
        totals = jax.lax.all_gather(cs[-1], AXIS)
        before = jnp.arange(n_dev, dtype=jnp.int32) < sid
        prefix = jnp.sum(jnp.where(before, totals, 0))
        netK, netR = t1._split_lanes(cs + prefix)
        pf = t1._unpack_flags(nf_l, nf_l.shape[0] * 8)
        thr_K = ((pf & 1) != 0) | (netK > 0)
        thr_R = ((pf & 2) != 0) | (netR > 0)
        minima = (pf & 4) != 0
        return thr_K, thr_R, minima

    return run(nf, dif)


def navigate_one_bwt_frontier_device(sfm: shard.ShardedFM, K: int,
                                     k_right: int, *, chunk: int = 4096,
                                     wbudget: int = 512,
                                     fbudget: int = 2048,
                                     seg: int | None = None):
    """Frontier-sharded mode-1 navigation; interface-compatible with
    parallel.traverse.navigate_one_bwt_sharded_device (flags stay on
    device, local_n-partitioned). Falls back to the replicated-queue
    phases on pathologically deep inputs (leaf depth >= 2^15 — the
    dual-lane bound). Budget kwargs exist for tests that force the
    overflow-retry doublings."""
    from . import traverse as ptraverse

    mesh = sfm.mesh
    n_dev = mesh.devices.size
    rows = sfm.rows
    if seg is None:
        seg = 2 * chunk
    queue_cap = max(1 << 16, sfm.n // (16 * n_dev))
    F6 = jnp.concatenate(
        [sfm.F, jnp.asarray([pat32(sfm.n)], jnp.int32)]
    )

    F_host = np.asarray(sfm.F, dtype=np.int32)
    it_bound = t1._DISPATCH_ITERS

    wb, fb, sg, qc = wbudget, fbudget, seg, queue_cap
    while True:
        caprows = qc + n_dev * sg + 4 * n_dev * min(wb, chunk)
        seed = jnp.asarray([0, int(F_host[0]), 0], jnp.int32)
        state = _frontier_state_init(mesh, seed, caprows=caprows, w=3,
                                     flag_len=rows * 128)
        state = _maybe_resume(state, mesh, tag="m1leaf", caprows=caprows)
        state, st_l, ovf, _ = _drive_phase(
            lambda st: _frontier_leaf_phase(
                mesh, sfm.blocks, F6, st, rows=rows, queue_cap=qc,
                chunk=chunk, wbudget=wb, fbudget=fb, seg=sg, K=K,
                k_right=k_right, max_iters=it_bound,
            ),
            state, mesh, tag="m1leaf", caprows=caprows,
        )
        if int(ovf) == 0:
            dif = state[3]  # (n_dev, rows*128) P(AXIS, None)
            break
        qc *= 2
        wb *= 2
        fb *= 2
        sg *= 2
    if int(st_l[2]) >= t1._LANE_SAFE_DEPTH:
        import sys as _sys

        print(f"[ebwt2indel] warning: leaf depth {int(st_l[2])} >= "
              f"{t1._LANE_SAFE_DEPTH}: falling back to the "
              "replicated-queue sharded navigation (exact at any depth, "
              "but queue machinery no longer scales ~1/n_dev)",
              file=_sys.stderr)
        return ptraverse.navigate_one_bwt_sharded_device(sfm, K, k_right)

    wb, fb, sg, qc = wbudget, fbudget, seg, queue_cap
    while True:
        caprows = qc + n_dev * sg + 4 * n_dev * min(wb, chunk)
        seed = jnp.asarray(
            [0, *(int(x) for x in F_host), pat32(sfm.n), 0], jnp.int32)
        state = _frontier_state_init(mesh, seed, caprows=caprows, w=7,
                                     flag_len=rows * 16)
        state = _maybe_resume(state, mesh, tag="m1node", caprows=caprows)
        state, st_n, ovf, _ = _drive_phase(
            lambda st: _frontier_node_phase(
                mesh, sfm.blocks, F6, st, rows=rows, queue_cap=qc,
                chunk=chunk, wbudget=wb, fbudget=fb, seg=sg, K=K,
                k_right=k_right, max_iters=it_bound,
            ),
            state, mesh, tag="m1node", caprows=caprows,
        )
        if int(ovf) == 0:
            nf = state[3]  # (n_dev, rows*16) P(AXIS, None)
            break
        qc *= 2
        wb *= 2
        fb *= 2
        sg *= 2

    thr_K, thr_R, minima = _combine_frontier(mesh, nf, dif, rows=rows)

    # reshard from the block-aligned partition to the pipeline's local_n
    # position partition (XLA inserts the cross-device shuffle)
    from jax.sharding import NamedSharding

    local_n = -(-(sfm.n + 2) // n_dev)
    pad_n = local_n * n_dev
    spec = NamedSharding(mesh, P(AXIS))

    @partial(jax.jit, out_shardings=(spec,) * 3)
    def reshard(a, b, c):
        def fix(x):
            return jnp.pad(x[: sfm.n], (0, pad_n - sfm.n))

        return fix(a), fix(b), fix(c)

    thr_K, thr_R, minima = reshard(thr_K, thr_R, minima)
    st_l_out = np.asarray(
        [int(st_l[0]), int(st_l[1]), 0], dtype=np.int64
    )
    st_n_out = np.asarray(st_n, dtype=np.int64)[:3]
    return thr_K, thr_R, minima, (local_n, (st_l_out, st_n_out))


@partial(jax.jit,
         static_argnames=("mesh", "rows1", "rows2", "local_n", "queue_cap",
                          "chunk", "seg", "fseg", "qseg", "wbudget", "K",
                          "k_right", "max_iters"))
def _frontier_leaf_pair_phase(mesh, blocks1, blocks2, meta, state, *,
                              rows1, rows2, local_n, queue_cap, chunk, seg,
                              fseg, qseg, wbudget, K, k_right,
                              max_iters=1 << 30):
    """Frontier-sharded lockstep leaf-pair phase (modes 2/3 merge;
    reference update_DA ebwt2InDel.cpp:394-425 + next_leaves
    dna_bwt.hpp:358-379; cf. models/traverse._leaf_pair_body3).

    A leaf pair lives on the shard owning the block row of its side-1
    ``first`` coordinate; the side-1 lf_range is halo-local for the
    (nearly universal) pairs whose side-1 interval spans <= 2 rank
    blocks. Side-2 lf_ranges and wide side-1 rows are answered over an
    all_gather of the step's chunks by owned-anchor compaction + one
    psum. Boundary deltas ride the TRI-LANE packed word of the
    single-chip path (K bits 0-10, R 11-21, DA 22-31 — exact while
    per-position nesting < 2^9, which the caller verifies from the
    max-depth stat and falls back to the replicated dense-plane phase):
    (position, word) entries route to the owner of the merged position
    (local_n partition) with the same fixed-shape all_to_all as the
    children. Returns (dif_l sharded (local_n,) int32, stats(4,)
    [leaves, lcp, max_depth, da_sum], overflow count).

    meta = concat(F1(4), F2(4)); takes/returns the cross-dispatch state
    of _frontier_state_init (flag buffer = the (local_n,) tri-lane delta
    vector), running at most max_iters queue steps per dispatch."""
    n_dev = mesh.devices.size
    M = 4 * chunk
    G = n_dev * chunk
    wbudget = min(wbudget, chunk)
    NW = n_dev * wbudget
    MAXAPP = n_dev * seg + (4 * NW if _PAIR_ROUTE else 0)

    _state_specs = (P(AXIS, None, None), P(AXIS), P(AXIS), P(AXIS, None),
                    P(AXIS, None), P(), P())

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(), _state_specs),
             out_specs=(_state_specs, P(), P()),
             check_vma=False)
    def run(b1_l, b2_l, meta_rep, state_l):
        sid = jax.lax.axis_index(AXIS)
        F1 = meta_rep[:4]
        F2 = meta_rep[4:8]
        base_row = sid * rows1
        base_pos = sid * local_n
        halo = jax.lax.ppermute(
            b1_l[0], AXIS, [(i, (i - 1) % n_dev) for i in range(n_dev)]
        )
        b1_h = jnp.concatenate([b1_l, halo[None]], axis=0)
        if _PAIR_ROUTE:
            halo2 = jax.lax.ppermute(
                b2_l[0], AXIS, [(i, (i - 1) % n_dev) for i in range(n_dev)]
            )
            b2_h = jnp.concatenate([b2_l, halo2[None]], axis=0)

        def delta_entries(rows5, vmask):
            """Tri-lane (position, word) boundary-delta entries of the
            given leaf-pair rows (update_DA, ebwt2InDel.cpp:394-425) plus
            the per-call lcp/da stat sums."""
            g1, t1_, g2, t2_, dep = (rows5[:, i] for i in range(5))
            st1 = g1 + g2
            st2 = g2 + t1_
            en = t1_ + t2_
            cK = vmask & (dep >= K)
            cR = vmask & (dep >= k_right)
            vv = cK * 1 + cR * (1 << 11)
            dd = vmask * (1 << 22)
            didx = jnp.concatenate([st1 + 1, st2, en])
            dval = jnp.concatenate([vv, dd, -(vv + dd)])
            dkeep = jnp.concatenate([vv > 0, vmask, vmask])
            lcp = jnp.sum(jnp.where(vmask, en - st1 - 1, 0))
            dav = jnp.sum(jnp.where(vmask, en - st1, 0))
            return didx, dval, dkeep, lcp, dav

        def body(state):
            (q, head, tail, dif_l, stats, pending, govf, it) = state
            need = (tail + MAXAPP) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            ovf = ((tail + MAXAPP) > q.shape[0]).astype(jnp.int32)

            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)),
                                          (chunk, 5))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            f1, s1, f2, s2, depth = (block[:, i] for i in range(5))
            bf = jax.lax.shift_right_logical(f1, 7)
            bs = jax.lax.shift_right_logical(s1, 7)
            narrow1 = valid & ((bs - bf) <= 1)

            # side-1 narrow lf_range: both anchor rows local via the halo
            o2 = jnp.stack([f1, s1], -1) & jnp.int32(127)
            af = jnp.clip(bf - base_row, 0, rows1)
            asx = jnp.clip(bs - base_row, 0, rows1)
            dec_f = shard._local_decode_multi(b1_h[af], o2)[:, 0]
            dec_s = shard._local_decode_multi(b1_h[asx], o2)[:, 1]
            r1 = jnp.stack([dec_f, dec_s], axis=1)  # (C, 2, 4)

            if _PAIR_ROUTE:
                # ---- routed: side-2 narrow lf_ranges by query routing;
                # pairs wide on either side take the wbudget all_gather +
                # psum dense path (cf. node-pair phase) -----------------
                b2f = jax.lax.shift_right_logical(f2, 7)
                b2s = jax.lax.shift_right_logical(s2, 7)
                narrow2 = valid & ((b2s - b2f) <= 1)
                nrw = narrow1 & narrow2
                wide = valid & ~nrw

                r2, ovf_q = _routed_pair_rank(
                    b2_h, rows2, block[:, 2:4], nrw,
                    n_dev=n_dev, sid=sid, qseg=qseg,
                )
                ovf = ovf + ovf_q

                n_wide = jnp.sum(wide.astype(jnp.int32))
                ovf = ovf + (n_wide > wbudget)
                iota_c = jnp.arange(chunk, dtype=jnp.int32)
                wperm = jax.lax.sort(
                    jnp.where(wide, iota_c, chunk + iota_c), is_stable=False)
                wrows = block[jnp.minimum(wperm[:wbudget], chunk - 1)]
                wvalid_l = jnp.arange(wbudget, dtype=jnp.int32) < n_wide
                wrows = jnp.where(wvalid_l[:, None], wrows, 0)
                wall = jax.lax.all_gather(wrows, AXIS)  # (n_dev, wb, 5)
                wcnt = jax.lax.all_gather(n_wide, AXIS)
                wflat = wall.reshape(NW, 5)
                wsrc = jnp.arange(NW, dtype=jnp.int32) // wbudget
                wvalid = (jnp.arange(NW, dtype=jnp.int32) % wbudget) < \
                    wcnt[wsrc]
                wr1, wr2 = jax.lax.psum(
                    (shard.local_parallel_rank(b1_l, rows1,
                                               wflat[:, 0:2]),
                     shard.local_parallel_rank(b2_l, rows2,
                                               wflat[:, 2:4])),
                    AXIS,
                )  # each (NW, 2, 4)

                lo1 = F1 + r1[:, 0]  # (C, 4)
                hi1 = F1 + r1[:, 1]
                lo2 = F2 + r2[:, 0]
                hi2 = F2 + r2[:, 1]

                # narrow boundary deltas -> routed to merged-pos owners
                didx, dval, dkeep, lcp_n, da_n = delta_entries(block, nrw)
                fr, n_fr, ovf_f = _route(
                    jnp.stack([didx, dval], axis=-1), dkeep,
                    jnp.minimum(udiv(didx, local_n), n_dev - 1), fseg,
                    n_dev=n_dev, sid=sid,
                )
                flive = jnp.arange(fr.shape[0], dtype=jnp.int32) < n_fr
                dif_l = dif_l.at[
                    jnp.where(flive, fr[:, 0] - base_pos, local_n)
                ].add(fr[:, 1], mode="drop")
                ovf = ovf + ovf_f

                # wide-row deltas: every shard applies the ones landing
                # locally; stats counted once (own rows only)
                widx, wval, wdkeep, _, _ = delta_entries(wflat, wvalid)
                wlp = widx - base_pos
                wok = wdkeep & ult(wlp, local_n)
                dif_l = dif_l.at[
                    jnp.where(wok, wlp, local_n)
                ].add(jnp.where(wdkeep, wval, 0), mode="drop")
                _, _, _, lcp_w, da_w = delta_entries(
                    wflat, wvalid & (wsrc == sid))

                # narrow children routed by side-1 owner
                child_depth = jnp.broadcast_to((depth + 1)[:, None],
                                               lo1.shape)
                children = jnp.stack([lo1, hi1, lo2, hi2, child_depth],
                                     -1)
                combined = (hi1 - lo1) + (hi2 - lo2)
                keep = (nrw[:, None] & uge(combined, 2)).reshape(M)
                flat_c = children.reshape(M, 5)
                rq, n_rq, ovf_c = _route(
                    flat_c, keep,
                    jnp.clip(
                        jax.lax.shift_right_logical(flat_c[:, 0], 7)
                        // rows1, 0, n_dev - 1,
                    ), seg, n_dev=n_dev, sid=sid,
                )
                ovf = ovf + ovf_c
                q = jax.lax.dynamic_update_slice(q, rq,
                                                 (tail, jnp.int32(0)))
                tail = tail + n_rq

                # wide children: replicated — each shard pushes owned ones
                wlo1 = F1 + wr1[:, 0]
                whi1 = F1 + wr1[:, 1]
                wlo2 = F2 + wr2[:, 0]
                whi2 = F2 + wr2[:, 1]
                wchild_depth = jnp.broadcast_to(
                    (wflat[:, 4] + 1)[:, None], wlo1.shape)
                wchildren = jnp.stack(
                    [wlo1, whi1, wlo2, whi2, wchild_depth], -1)
                wcombined = (whi1 - wlo1) + (whi2 - wlo2)
                wflat_c = wchildren.reshape(NW * 4, 5)
                wdest = jnp.clip(
                    jax.lax.shift_right_logical(wflat_c[:, 0], 7) // rows1,
                    0, n_dev - 1,
                )
                wq, n_wq = t1._compact(
                    wflat_c,
                    (wvalid[:, None] & uge(wcombined, 2)).reshape(-1)
                    & (wdest == sid),
                )
                q = jax.lax.dynamic_update_slice(q, wq,
                                                 (tail, jnp.int32(0)))
                tail = tail + n_wq
                head = head + count

                stats = (
                    stats[0] + count,
                    stats[1] + lcp_n + lcp_w,
                    jnp.maximum(stats[2],
                                jnp.max(jnp.where(valid, depth, 0))),
                    stats[3] + da_n + da_w,
                )
            else:
                # ---- round-2 A/B formulation: full-chunk all_gather ----
                gall = jax.lax.all_gather(block, AXIS)  # (n_dev, C, 5)
                gflat = gall.reshape(G, 5)
                bud = max(128, G // 8)
                r2_all, r1w_all = jax.lax.psum(
                    (shard.local_parallel_rank_sorted(
                        b2_l, rows2, gflat[:, 2:4], budget=bud),
                     shard.local_parallel_rank_sorted(
                         b1_l, rows1, gflat[:, 0:2], budget=bud)),
                    AXIS,
                )  # each (G, 2, 4)
                r2 = jax.lax.dynamic_slice(
                    r2_all.reshape(n_dev, chunk, 2, 4),
                    (sid, 0, 0, 0), (1, chunk, 2, 4),
                )[0]
                r1w = jax.lax.dynamic_slice(
                    r1w_all.reshape(n_dev, chunk, 2, 4),
                    (sid, 0, 0, 0), (1, chunk, 2, 4),
                )[0]
                wide1 = valid & ~narrow1
                r1 = jnp.where(wide1[:, None, None], r1w, r1)

                lo1 = F1 + r1[:, 0]  # (C, 4)
                hi1 = F1 + r1[:, 1]
                lo2 = F2 + r2[:, 0]
                hi2 = F2 + r2[:, 1]

                # tri-lane boundary deltas, routed to merged-pos owners
                didx, dval, dkeep, lcp_v, da_v = delta_entries(block,
                                                               valid)
                fr, n_fr, ovf_f = _route(
                    jnp.stack([didx, dval], axis=-1), dkeep,
                    jnp.minimum(udiv(didx, local_n), n_dev - 1), fseg,
                    n_dev=n_dev, sid=sid,
                )
                flive = jnp.arange(fr.shape[0], dtype=jnp.int32) < n_fr
                dif_l = dif_l.at[
                    jnp.where(flive, fr[:, 0] - base_pos, local_n)
                ].add(fr[:, 1], mode="drop")
                ovf = ovf + ovf_f

                # children (next_leaves): combined size >= 2, routed by
                # the owner of the child's side-1 first coordinate
                child_depth = jnp.broadcast_to((depth + 1)[:, None],
                                               lo1.shape)
                children = jnp.stack([lo1, hi1, lo2, hi2, child_depth],
                                     -1)
                combined = (hi1 - lo1) + (hi2 - lo2)
                keep = (valid[:, None] & uge(combined, 2)).reshape(M)
                flat_c = children.reshape(M, 5)
                rq, n_rq, ovf_c = _route(
                    flat_c, keep,
                    jnp.clip(
                        jax.lax.shift_right_logical(flat_c[:, 0], 7)
                        // rows1, 0, n_dev - 1,
                    ), seg, n_dev=n_dev, sid=sid,
                )
                ovf = ovf + ovf_c

                q = jax.lax.dynamic_update_slice(q, rq,
                                                 (tail, jnp.int32(0)))
                tail = tail + n_rq
                head = head + count

                stats = (
                    stats[0] + count,
                    stats[1] + lcp_v,
                    jnp.maximum(stats[2],
                                jnp.max(jnp.where(valid, depth, 0))),
                    stats[3] + da_v,
                )
            glob = jax.lax.psum(jnp.stack([tail - head, ovf]), AXIS)
            return (q, head, tail, dif_l, stats, glob[0], govf + glob[1],
                    it + 1)

        def cond(state):
            return (state[5] > 0) & (state[6] == 0) & \
                (state[7] < max_iters)

        q3, head1, tail1, dif2, stats2, pending, govf = state_l
        state = (q3[0], head1[0], tail1[0], dif2[0], tuple(stats2[0]),
                 pending, govf, jnp.int32(0))
        state = jax.lax.while_loop(cond, body, state)
        q, head, tail, dif_l, stats, pending, govf, _ = state
        smax = jax.lax.pmax(stats[2], AXIS)
        ssum = jax.lax.psum(
            jnp.stack([stats[0], stats[1], stats[3]]), AXIS
        )
        state_out = (q[None], head[None], tail[None], dif_l[None],
                     jnp.stack(stats)[None], pending, govf)
        return state_out, jnp.stack(
            [ssum[0], ssum[1], smax, ssum[2]]
        ), govf

    return run(blocks1, blocks2, meta, state)


@partial(jax.jit, static_argnames=("mesh",))
def _combine_frontier_pair(mesh, nf, dif):
    """Pair-mode frontier combine: per-position bit flags (node-pair
    phase) + tri-lane packed boundary deltas (leaf-pair phase), via one
    local packed cumsum + an exclusive cross-shard prefix of packed
    totals, then the carry-aware 3-lane decode (exact while running
    per-position nesting counts respect the lane bounds — the same
    max-depth guard as the scatter packing). Both inputs are partitioned
    by local_n merged positions."""

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS), P(AXIS, None)),
             out_specs=(P(AXIS),) * 4)
    def run(nf_l, dif_l):
        dif_l = dif_l[0]
        sid = jax.lax.axis_index(AXIS)
        n_dev = jax.lax.axis_size(AXIS)
        cs = jnp.cumsum(dif_l)
        totals = jax.lax.all_gather(cs[-1], AXIS)
        before = jnp.arange(n_dev, dtype=jnp.int32) < sid
        prefix = jnp.sum(jnp.where(before, totals, 0))
        netK, netR, netD = t1._split_lanes3(cs + prefix)
        thr_K = ((nf_l & 1) != 0) | (netK > 0)
        thr_R = ((nf_l & 2) != 0) | (netR > 0)
        minima = (nf_l & 4) != 0
        da = ((nf_l & 8) != 0) | (netD > 0)
        return thr_K, thr_R, minima, da

    return run(nf, dif)


@partial(jax.jit,
         static_argnames=("mesh", "rows1", "rows2", "local_n", "queue_cap",
                          "chunk", "seg", "fseg", "qseg", "wbudget", "K",
                          "k_right", "max_iters"))
def _frontier_node_pair_phase(mesh, blocks1, blocks2, meta, state, *,
                              rows1, rows2, local_n, queue_cap, chunk, seg,
                              fseg, qseg, wbudget, K, k_right,
                              max_iters=1 << 30):
    """Frontier-sharded lockstep node-pair phase (modes 2/3 merge;
    reference find_leaves ebwt2InDel.cpp:474-527 + merged-node updates
    792-802; cf. models/traverse._node_pair_body).

    A pair node lives on the shard owning the block row of its side-1
    first coordinate (rows1 space); its side-1 narrow rank is halo-local.
    Side-2 narrow ranks are answered by their OWNING shard via
    fixed-shape all_to_all query routing (_routed_pair_rank, per-step
    traffic O(chunk)/shard independent of mesh size); pairs wide on
    either side take a small-budget all_gather + psum'd dense rank
    (cf. the mode-1 node phase's wide path). EBWT_PAIR_ROUTE=0 selects
    the round-2 full-chunk all_gather formulation for A/B
    (comm_bytes_per_step quantifies the difference). Flag writes target
    the MERGED position space (partitioned by local_n, no block
    alignment, hence no halo shortcut): narrow entries route to their
    owner with the same fixed-shape all_to_all as the children; wide-row
    entries are seen by every shard and scatter locally. nf: per-shard
    packed nibble words over local_n merged positions.

    meta = concat(F1(4), F2(4), root_row(13)). Returns (nf_l sharded,
    psum'd stats(4,) [pairs, lcp, minima, da], overflow count)."""
    n_dev = mesh.devices.size
    M = 4 * chunk
    G = n_dev * chunk
    wbudget = min(wbudget, chunk)
    NW = n_dev * wbudget
    MAXAPP = n_dev * seg + (4 * NW if _PAIR_ROUTE else 0)
    nw_l = (local_n + 7) // 8

    _state_specs = (P(AXIS, None, None), P(AXIS), P(AXIS), P(AXIS, None),
                    P(AXIS, None), P(), P())

    @partial(jax.shard_map, mesh=mesh,
             in_specs=(P(AXIS, None), P(AXIS, None), P(), _state_specs),
             out_specs=(_state_specs, P(), P()),
             check_vma=False)
    def run(b1_l, b2_l, meta_rep, state_l):
        sid = jax.lax.axis_index(AXIS)
        F1 = meta_rep[:4]
        F2 = meta_rep[4:8]
        base_row = sid * rows1
        base_pos = sid * local_n
        halo = jax.lax.ppermute(
            b1_l[0], AXIS, [(i, (i - 1) % n_dev) for i in range(n_dev)]
        )
        b1_h = jnp.concatenate([b1_l, halo[None]], axis=0)
        if _PAIR_ROUTE:
            halo2 = jax.lax.ppermute(
                b2_l[0], AXIS, [(i, (i - 1) % n_dev) for i in range(n_dev)]
            )
            b2_h = jnp.concatenate([b2_l, halo2[None]], axis=0)

        def route(flat, keep, dest, segN):
            return _route(flat, keep, dest, segN, n_dev=n_dev, sid=sid)

        def pair_flag_entries(rows13, vmask):
            c1 = rows13[:, 0:6]
            c2 = rows13[:, 6:12]
            depth = rows13[:, 12]
            merged = c1 + c2
            last = merged[:, 5]
            idxs, vals = [], []
            da_values = jnp.int32(0)
            for j in range(5):
                l1 = c1[:, j + 1] - c1[:, j]
                l2 = c2[:, j + 1] - c2[:, j]
                cond = vmask & ((l1 + l2) == 1)
                da_values = da_values + jnp.sum(cond.astype(jnp.int32))
                cond_da = cond & (l2 == 1)
                idxs.append(c1[:, j] + c2[:, j])
                vals.append(cond_da * 8)
            lcp = jnp.int32(0)
            nmin = jnp.int32(0)
            for j in range(1, 5):
                border = merged[:, j]
                has_prev = ugt(border, merged[:, j - 1])
                cond = vmask & has_prev & (border != last)
                lcp = lcp + jnp.sum(cond.astype(jnp.int32))
                v = ((cond & (depth >= K)) * 1
                     + (cond & (depth >= k_right)) * 2)
                if j >= 2:
                    prev_size = border - merged[:, j - 1]
                    cond_m = vmask & uge(prev_size, 2) & \
                        ult(border, last - 1)
                    nmin = nmin + jnp.sum(cond_m.astype(jnp.int32))
                    v = v + cond_m * 4
                idxs.append(border)
                vals.append(v)
            return (jnp.concatenate(idxs), jnp.concatenate(vals),
                    lcp, nmin, da_values)

        def body(state):
            (q, head, tail, nf_l, stats, pending, govf, it) = state
            need = (tail + MAXAPP) > q.shape[0]
            q = jax.lax.cond(need, lambda a, h: jnp.roll(a, -h, axis=0),
                             lambda a, h: a, q, head)
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            ovf = ((tail + MAXAPP) > q.shape[0]).astype(jnp.int32)

            count = jnp.minimum(tail - head, chunk)
            block = jax.lax.dynamic_slice(q, (head, jnp.int32(0)),
                                          (chunk, 13))
            valid = jnp.arange(chunk, dtype=jnp.int32) < count
            b1c = jax.lax.shift_right_logical(block[:, 0:6], 7)
            narrow1 = valid & ((b1c[:, 5] - b1c[:, 0]) <= 1)

            # side-1 narrow rank: halo-local, no collective
            o1 = block[:, 0:6] & jnp.int32(127)
            a0 = jnp.clip(b1c[:, 0] - base_row, 0, rows1)
            a5 = jnp.clip(b1c[:, 5] - base_row, 0, rows1)
            dec_lo = shard._local_decode_multi(b1_h[a0], o1)
            dec_hi = shard._local_decode_multi(b1_h[a5], o1)
            use_hi = b1c == b1c[:, 5][:, None]
            r1 = jnp.where(use_hi[:, :, None], dec_hi, dec_lo)

            if _PAIR_ROUTE:
                # ---- routed formulation: side-2 narrow ranks by query
                # routing; pairs wide on EITHER side take the budgeted
                # all_gather + psum dense path -------------------------
                b2c = jax.lax.shift_right_logical(block[:, 6:12], 7)
                narrow2 = valid & ((b2c[:, 5] - b2c[:, 0]) <= 1)
                nrw = narrow1 & narrow2
                wide = valid & ~nrw

                r2, ovf_q = _routed_pair_rank(
                    b2_h, rows2, block[:, 6:12], nrw,
                    n_dev=n_dev, sid=sid, qseg=qseg,
                )
                ovf = ovf + ovf_q

                # wide pairs: all_gather under wbudget; every shard
                # decodes its local contribution to BOTH sides' dense
                # ranks, one psum combines (cf. mode-1 wide path)
                n_wide = jnp.sum(wide.astype(jnp.int32))
                ovf = ovf + (n_wide > wbudget)
                iota_c = jnp.arange(chunk, dtype=jnp.int32)
                wperm = jax.lax.sort(
                    jnp.where(wide, iota_c, chunk + iota_c), is_stable=False)
                wrows = block[jnp.minimum(wperm[:wbudget], chunk - 1)]
                wvalid_l = jnp.arange(wbudget, dtype=jnp.int32) < n_wide
                wrows = jnp.where(wvalid_l[:, None], wrows, 0)
                wall = jax.lax.all_gather(wrows, AXIS)  # (n_dev, wb, 13)
                wcnt = jax.lax.all_gather(n_wide, AXIS)
                wflat = wall.reshape(NW, 13)
                wsrc = jnp.arange(NW, dtype=jnp.int32) // wbudget
                wvalid = (jnp.arange(NW, dtype=jnp.int32) % wbudget) < \
                    wcnt[wsrc]
                wr1, wr2 = jax.lax.psum(
                    (shard.local_parallel_rank(b1_l, rows1,
                                               wflat[:, 0:6]),
                     shard.local_parallel_rank(b2_l, rows2,
                                               wflat[:, 6:12])),
                    AXIS,
                )  # each (NW, 6, 4)

                ext1 = F1[:, None] + jnp.swapaxes(r1, -1, -2)  # (C,4,6)
                ext2 = F2[:, None] + jnp.swapaxes(r2, -1, -2)
                depth4 = jnp.broadcast_to(block[:, None, 12:13] + 1,
                                          (chunk, 4, 1))
                children = jnp.concatenate([ext1, ext2, depth4], axis=-1)

                # narrow flag entries -> all_to_all to owners
                fidx, fval, lcp_v, min_v, da_v = pair_flag_entries(
                    block, nrw)
                fr, n_fr, ovf_f = route(
                    jnp.stack([fidx, fval], axis=-1), fval > 0,
                    jnp.minimum(udiv(fidx, local_n), n_dev - 1), fseg,
                )
                ovf = ovf + ovf_f
                flive = jnp.arange(fr.shape[0], dtype=jnp.int32) < n_fr
                nf_l = t1._flag_scatter(
                    nf_l, jnp.where(flive, fr[:, 0] - base_pos, -1),
                    fr[:, 1],
                )

                # wide-row flag entries: every shard sees them all —
                # scatter the locally-landing ones; stats counted once
                # (own contributions only)
                widx, wval, _, _, _ = pair_flag_entries(wflat, wvalid)
                wlp = widx - base_pos
                wmine = (wval > 0) & ult(wlp, local_n)
                nf_l = t1._flag_scatter(
                    nf_l, jnp.where(wmine, wlp, -1), wval)
                _, _, lcp_w, min_w, da_w = pair_flag_entries(
                    wflat, wvalid & (wsrc == sid))
                lcp_v = lcp_v + lcp_w
                min_v = min_v + min_w
                da_v = da_v + da_w

                # narrow children routed by side-1 owner
                u1 = ugt(ext1[..., 1:6], ext1[..., 0:5])
                u2 = ugt(ext2[..., 1:6], ext2[..., 0:5])
                n_union = jnp.sum((u1 | u2).astype(jnp.int32), axis=-1)
                flat_c = children.reshape(M, 13)
                rq, n_rq, ovf_c = route(
                    flat_c, (nrw[:, None] & (n_union >= 2)).reshape(M),
                    jnp.clip(
                        jax.lax.shift_right_logical(flat_c[:, 0], 7)
                        // rows1, 0, n_dev - 1,
                    ), seg,
                )
                ovf = ovf + ovf_c
                q = jax.lax.dynamic_update_slice(q, rq,
                                                 (tail, jnp.int32(0)))
                tail = tail + n_rq

                # wide children: replicated — each shard pushes the ones
                # it owns
                wext1 = F1[:, None] + jnp.swapaxes(wr1, -1, -2)
                wext2 = F2[:, None] + jnp.swapaxes(wr2, -1, -2)
                wdepth = jnp.broadcast_to(wflat[:, None, 12:13] + 1,
                                          (NW, 4, 1))
                wchildren = jnp.concatenate([wext1, wext2, wdepth], -1)
                wu1 = ugt(wext1[..., 1:6], wext1[..., 0:5])
                wu2 = ugt(wext2[..., 1:6], wext2[..., 0:5])
                wch = jnp.sum((wu1 | wu2).astype(jnp.int32), axis=-1)
                wflat_c = wchildren.reshape(NW * 4, 13)
                wdest = jnp.clip(
                    jax.lax.shift_right_logical(wflat_c[:, 0], 7) // rows1,
                    0, n_dev - 1,
                )
                wq, n_wq = t1._compact(
                    wflat_c,
                    (wvalid[:, None] & (wch >= 2)).reshape(-1)
                    & (wdest == sid),
                )
                q = jax.lax.dynamic_update_slice(q, wq,
                                                 (tail, jnp.int32(0)))
                tail = tail + n_wq
                head = head + count
            else:
                # ---- round-2 A/B formulation: full-chunk all_gather;
                # side-2 ranks for everything, side-1 for the wide rows;
                # owned-anchor compaction + one psum ------------------
                gall = jax.lax.all_gather(block, AXIS)  # (n_dev, C, 13)
                gflat = gall.reshape(G, 13)
                r2_all, r1w_all = jax.lax.psum(
                    (shard.local_parallel_rank_sorted(
                        b2_l, rows2, gflat[:, 6:12],
                        budget=max(128, G // 8)),
                     shard.local_parallel_rank_sorted(
                         b1_l, rows1, gflat[:, 0:6],
                         budget=max(128, G // 8))),
                    AXIS,
                )  # each (G, 6, 4)
                r2 = jax.lax.dynamic_slice(
                    r2_all.reshape(n_dev, chunk, 6, 4),
                    (sid, 0, 0, 0), (1, chunk, 6, 4),
                )[0]
                r1w = jax.lax.dynamic_slice(
                    r1w_all.reshape(n_dev, chunk, 6, 4),
                    (sid, 0, 0, 0), (1, chunk, 6, 4),
                )[0]
                wide1 = valid & ~narrow1
                r1 = jnp.where(wide1[:, None, None], r1w, r1)

                ext1 = F1[:, None] + jnp.swapaxes(r1, -1, -2)  # (C,4,6)
                ext2 = F2[:, None] + jnp.swapaxes(r2, -1, -2)
                depth4 = jnp.broadcast_to(block[:, None, 12:13] + 1,
                                          (chunk, 4, 1))
                children = jnp.concatenate([ext1, ext2, depth4], axis=-1)

                # flag entries in merged space -> all_to_all to owners
                fidx, fval, lcp_v, min_v, da_v = pair_flag_entries(block,
                                                                   valid)
                fr, n_fr, ovf_f = route(
                    jnp.stack([fidx, fval], axis=-1), fval > 0,
                    jnp.minimum(udiv(fidx, local_n), n_dev - 1), fseg,
                )
                ovf = ovf + ovf_f
                flive = jnp.arange(fr.shape[0], dtype=jnp.int32) < n_fr
                nf_l = t1._flag_scatter(
                    nf_l, jnp.where(flive, fr[:, 0] - base_pos, -1),
                    fr[:, 1],
                )

                # children kept iff >= 2 union children; routed by side-1
                u1 = ugt(ext1[..., 1:6], ext1[..., 0:5])
                u2 = ugt(ext2[..., 1:6], ext2[..., 0:5])
                n_union = jnp.sum((u1 | u2).astype(jnp.int32), axis=-1)
                flat_c = children.reshape(M, 13)
                rq, n_rq, ovf_c = route(
                    flat_c, (valid[:, None] & (n_union >= 2)).reshape(M),
                    jnp.clip(
                        jax.lax.shift_right_logical(flat_c[:, 0], 7)
                        // rows1, 0, n_dev - 1,
                    ), seg,
                )
                ovf = ovf + ovf_c
                q = jax.lax.dynamic_update_slice(q, rq,
                                                 (tail, jnp.int32(0)))
                tail = tail + n_rq
                head = head + count

            stats = (stats[0] + count, stats[1] + lcp_v, stats[2] + min_v,
                     stats[3] + da_v)
            glob = jax.lax.psum(jnp.stack([tail - head, ovf]), AXIS)
            return (q, head, tail, nf_l, stats, glob[0], govf + glob[1],
                    it + 1)

        def cond(state):
            return (state[5] > 0) & (state[6] == 0) & \
                (state[7] < max_iters)

        q3, head1, tail1, nf2, stats2, pending, govf = state_l
        state = (q3[0], head1[0], tail1[0], nf2[0], tuple(stats2[0]),
                 pending, govf, jnp.int32(0))
        state = jax.lax.while_loop(cond, body, state)
        q, head, tail, nf_l, stats, pending, govf, _ = state
        state_out = (q[None], head[None], tail[None], nf_l[None],
                     jnp.stack(stats)[None], pending, govf)
        return state_out, jax.lax.psum(jnp.stack(stats), AXIS), govf

    return run(blocks1, blocks2, meta, state)


def navigate_two_bwts_frontier_device(sfm1: shard.ShardedFM,
                                      sfm2: shard.ShardedFM,
                                      K: int, k_right: int, *,
                                      chunk: int = 4096,
                                      seg: int | None = None,
                                      fseg: int | None = None):
    """Frontier-sharded lockstep navigation for modes 2/3: frontier
    leaf-pair phase (tri-lane packed routed deltas) + frontier node-pair
    phase, combined with the packed-cumsum pair combine. Pathologically
    deep inputs (leaf depth >= 2^9, the tri-lane bound) fall back to the
    replicated-queue navigation, which is exact at any depth.
    Interface-compatible with
    parallel.traverse.navigate_two_bwts_sharded_device."""
    from . import traverse as ptraverse

    mesh = sfm1.mesh
    n_dev = mesh.devices.size
    n = sfm1.n + sfm2.n
    local_n = -(-(n + 2) // n_dev)
    # the MERGED coordinate space must fit the uint32 bit patterns and
    # per-shard int32 offsets even when each input does on its own
    shard._check_mesh_cap(n, n_dev, -(-local_n // 128))
    if seg is None:
        seg = 2 * chunk
    if fseg is None:
        fseg = 4 * chunk

    F1h = np.asarray(sfm1.F)
    F2h = np.asarray(sfm2.F)
    meta_l = jnp.asarray(np.concatenate(
        [F1h, F2h, [0, F1h[0], 0, F2h[0], 0]]
    ).astype(np.int32))
    qc = max(1 << 16, n // (16 * n_dev))
    sg, fg = seg, fseg
    qg = max(256, 2 * chunk // n_dev)
    wb = 512
    it_bound = t1._DISPATCH_ITERS
    while True:
        caprows = qc + n_dev * sg + (
            4 * n_dev * min(wb, chunk) if _PAIR_ROUTE else 0)
        seed = jnp.asarray([0, int(F1h[0]), 0, int(F2h[0]), 0], jnp.int32)
        state = _frontier_state_init(mesh, seed, caprows=caprows, w=5,
                                     flag_len=local_n)
        state = _maybe_resume(state, mesh, tag="pleaf", caprows=caprows)
        state, st_l, ovf, _ = _drive_phase(
            lambda st: _frontier_leaf_pair_phase(
                mesh, sfm1.blocks, sfm2.blocks, meta_l, st,
                rows1=sfm1.rows, rows2=sfm2.rows, local_n=local_n,
                queue_cap=qc, chunk=chunk, seg=sg, fseg=fg, qseg=qg,
                wbudget=wb, K=K, k_right=k_right, max_iters=it_bound,
            ),
            state, mesh, tag="pleaf", caprows=caprows,
        )
        if int(ovf) == 0:
            dif = state[3]  # (n_dev, local_n) P(AXIS, None)
            break
        qc *= 2
        sg *= 2
        fg *= 2
        qg = min(2 * qg, chunk)
        wb = min(2 * wb, chunk)
    if int(st_l[2]) >= t1._LANE3_SAFE_DEPTH:
        import sys as _sys

        print(f"[ebwt2indel] warning: pair leaf depth {int(st_l[2])} >= "
              f"{t1._LANE3_SAFE_DEPTH}: falling back to the "
              "replicated-queue sharded pair navigation (exact at any "
              "depth, but queue machinery no longer scales ~1/n_dev)",
              file=_sys.stderr)
        return ptraverse.navigate_two_bwts_sharded_device(sfm1, sfm2,
                                                          K, k_right)

    root = np.concatenate([
        [0], F1h, [pat32(sfm1.n)], [0], F2h, [pat32(sfm2.n)], [0]
    ]).astype(np.int32)
    meta = jnp.asarray(np.concatenate([F1h, F2h, root]).astype(np.int32))
    qc = max(1 << 16, n // (16 * n_dev))
    sg, fg = seg, fseg
    qg = max(256, 2 * chunk // n_dev)
    wb = 512
    while True:
        caprows = qc + n_dev * sg + (
            4 * n_dev * min(wb, chunk) if _PAIR_ROUTE else 0)
        state = _frontier_state_init(mesh, jnp.asarray(root),
                                     caprows=caprows, w=13,
                                     flag_len=(local_n + 7) // 8)
        state = _maybe_resume(state, mesh, tag="pnode", caprows=caprows)
        state, st_n, ovf, _ = _drive_phase(
            lambda st: _frontier_node_pair_phase(
                mesh, sfm1.blocks, sfm2.blocks, meta, st,
                rows1=sfm1.rows, rows2=sfm2.rows, local_n=local_n,
                queue_cap=qc, chunk=chunk, seg=sg, fseg=fg, qseg=qg,
                wbudget=wb, K=K, k_right=k_right, max_iters=it_bound,
            ),
            state, mesh, tag="pnode", caprows=caprows,
        )
        if int(ovf) == 0:
            nf_l = state[3]  # (n_dev, nw_l) P(AXIS, None)
            break
        qc *= 2
        sg *= 2
        fg *= 2
        qg = min(2 * qg, chunk)
        wb = min(2 * wb, chunk)

    # unpack the per-shard nibble words to the per-position int32 bit
    # layout the existing pair combine consumes
    @partial(jax.shard_map, mesh=mesh, in_specs=(P(AXIS, None),),
             out_specs=P(AXIS))
    def unpack(nf_loc):
        nf_loc = nf_loc[0]
        return t1._unpack_flags(nf_loc, nf_loc.shape[0] * 8)[:local_n]

    nf_pos = unpack(nf_l)
    thr_K, thr_R, minima, da = _combine_frontier_pair(mesh, nf_pos, dif)
    return thr_K, thr_R, minima, da, (local_n, (st_l, st_n))


def navigate_nodes_frontier(pb: PackedBwt, mesh, K: int, k_right: int):
    """Frontier-sharded internal-node phase; returns (thr_K, thr_R, minima)
    host arrays + stats(4,) + per-shard processed-node counts (n_dev,),
    flag-equivalent to the replicated-queue phase and the single-device
    traversal (parity-tested). The per-shard counts are the load-balance
    evidence behind the ~1/n_dev queue-machinery scaling claim."""
    n_dev = mesh.devices.size
    blocks, _, F, rows = shard.shard_packed(pb, mesh)
    F6 = jnp.concatenate([jnp.asarray(F),
                          jnp.asarray([pat32(pb.n)], jnp.int32)])
    chunk = 4096
    wbudget, fbudget, seg = 512, 2048, 2 * chunk
    queue_cap = max(1 << 16, pb.n // (16 * n_dev))
    F_host = np.asarray(F, dtype=np.int32)
    while True:
        caprows = queue_cap + n_dev * seg + 4 * n_dev * min(wbudget, chunk)
        seed = jnp.asarray(
            [0, *(int(x) for x in F_host), pat32(pb.n), 0], jnp.int32)
        state = _frontier_state_init(mesh, seed, caprows=caprows, w=7,
                                     flag_len=rows * 16)
        state = _maybe_resume(state, mesh, tag="m1node", caprows=caprows)
        state, stats, ovf, work = _drive_phase(
            lambda st: _frontier_node_phase(
                mesh, blocks, F6, st, rows=rows, queue_cap=queue_cap,
                chunk=chunk, wbudget=wbudget, fbudget=fbudget, seg=seg,
                K=K, k_right=k_right, max_iters=t1._DISPATCH_ITERS,
            ),
            state, mesh, tag="m1node", caprows=caprows,
        )
        if int(ovf) == 0:
            nf_l = state[3]
            break
        queue_cap *= 2
        wbudget *= 2
        fbudget *= 2
        seg *= 2
    nf = np.asarray(nf_l).reshape(-1).view(np.uint32)
    pf = np.zeros(len(nf) * 8, np.uint8)
    for i in range(8):
        pf[i::8] = (nf >> np.uint32(4 * i)) & np.uint32(15)
    pf = pf[: pb.n]
    return ((pf & 1) != 0).astype(np.uint8), \
        ((pf & 2) != 0).astype(np.uint8), \
        ((pf & 4) != 0).astype(np.uint8), np.asarray(stats), \
        np.asarray(work)
