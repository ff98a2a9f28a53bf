"""Wavefront traversal of the implicit suffix tree via a device-resident
work queue.

Accelerator re-architecture of the reference's two stack-DFS loops
(reference: ebwt2InDel.cpp:555-676 for one BWT, 679-831 for the lockstep
two-BWT merge). The key observation (SURVEY.md §2.5): every write performed
during the traversal — LCP_threshold bits, LCP_minima bits, document-array
bits — targets a position determined solely by the visited node, independent
of visit order. The traversal is therefore order-free: nodes are processed in
fixed-size chunks popped from a FIFO queue that lives entirely in HBM, inside
a single jitted ``lax.while_loop`` per phase — zero host round-trips and
exactly one compiled program per phase, regardless of frontier shape.

Per chunk of C nodes the body performs one batched 6-coordinate parallel rank
(the Weiner-link extension of dna_bwt.hpp:323-356 across all 4 nucleotides),
masked scatters of the LCP/DA flags, and a compaction of surviving children
back into the queue.

Range fills (leaf-interior LCP flags, ebwt2InDel.cpp:344-355; DA intervals,
ebwt2InDel.cpp:394-449) use a scatter of +/-1 boundary deltas plus one final
cumsum instead of per-position writes.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.coords import pat32, uge, ugt, ult, unpat
from . import fm_index as fm_ops
from .fm_index import FMIndex

import os as _os

CHUNK = int(_os.environ.get("EBWT_CHUNK", 256 * 1024))
# nodes popped per queue step: large chunks amortize per-op fixed costs
# (scatter/compaction launches)

# distinct-coordinate rank budget as a fraction of the dense query count
# (the reference skips rank at equal node boundaries, dna_bwt.hpp:334-347;
# ~58% of boundaries are distinct in practice). 0 (the default) disables
# dedup: the dedup adds a gather-back of per-query results on top of the
# rank gathers it saves. The path stays for A/B testing.
_DEDUP_FRAC = float(_os.environ.get("EBWT_DEDUP_FRAC", "0"))

# 2-anchor narrow-node rank for the Weiner extension (the production
# default): gather 2 block rows per node instead of 6 — node sizes are
# ~read coverage, so the sorted 6-boundary tuple nearly always spans <= 2
# of the 128-char blocks. Block-straddling nodes (the first ~log4 n
# traversal levels) are answered exactly by a budget-sliced bv_select side
# loop inside rank.parallel_rank_sorted — gather-only compaction, no
# lax.cond dense fallback (cond flattens inside the phase while_loop so
# both branches would pay). EBWT_NARROW=0
# restores the dense 6-row gather for A/B runs.
_NARROW = _os.environ.get("EBWT_NARROW", "1") != "0"

# EBWT_PROGRESS=1: stream per-chunk progress lines from inside the phase
# while_loop (the device analogue of the reference's per-percent prints,
# ebwt2InDel.cpp:603-612) — an async debug.print tap, off by default so the
# hot loop stays print-free
_PROGRESS = _os.environ.get("EBWT_PROGRESS", "0") != "0"

# budget-sliced compaction gather (see _sliced_prefix_gather): gather only
# the kept prefix of child slots instead of all 4C. EBWT_COMPACT_SLICED=0
# restores the gather-all formulation for A/B runs.
_SLICED = _os.environ.get("EBWT_COMPACT_SLICED", "1") != "0"


def _compact_budget(C: int) -> int | None:
    return C if _SLICED else None


# wavefront ramp: the first ~10 traversal levels have tiny frontiers but a
# fixed-shape chunk pays full per-iteration cost regardless of count. A
# prelude while_loop with a small chunk (same compiled program, same queue
# buffer) processes the ramp, handing off to the big-chunk loop once the
# pending frontier is large enough to utilize it (or after a bounded amount
# of work, so mid-size phases don't crawl at ramp granularity). 0 disables.
_RAMP = int(_os.environ.get("EBWT_RAMP", 4096))


def _dedup_budget(n_queries: int) -> int:
    return max(8, int(n_queries * _DEDUP_FRAC))


def _narrow_budget(chunk_rows: int) -> int:
    # wide rows per side-loop slice: large enough that the first (all-wide)
    # traversal levels take few slices, small enough that the per-slice
    # select+rank is cheap next to the 2-anchor main pass
    return max(512, chunk_rows // 64)


# ---------------------------------------------------------------------------
# boundary-delta vector addressing: one 1-D array below 2^31 entries, a
# (lo, hi) PAIR of 1-D arrays split at 2^31 above (s32 scatter indices
# cannot address arrays past 2^31 elements). Positions are unsigned bit
# patterns (ops/coords.py): the lo scatter sees patterns >= 2^31 as
# negative (mode="drop" drops them); flipping the sign bit maps
# [2^31, 2^32) onto [0, 2^31) for the hi scatter and maps [0, 2^31) to
# negative (dropped). The arrays stay 1-D so donation aliases them in
# place.
# ---------------------------------------------------------------------------

# the lo piece covers [0, _SPLIT), the hi piece [_SPLIT, dif_n). The
# split sits one slice below 2^31 because jnp indexing materializes the
# array SIZE as an int32 constant — a piece of exactly 2^31 elements is
# unindexable.
_SPLIT = (1 << 31) - (1 << 24)


def _dif_size(flags) -> int:
    """Total entries across the 1- or 2-piece delta vector."""
    return int(sum(np.prod(f.shape) for f in flags))


def _dif_dummy(flags):
    """An index pattern guaranteed out-of-bounds (dropped) in every piece."""
    return jnp.int32(pat32(_dif_size(flags)))


def _dif_scatter(flags, idx, val):
    """Scatter-add boundary deltas at position patterns ``idx`` into the
    1- or 2-piece delta vector; returns the updated piece tuple.

    NOTE mode="drop" only drops indices past the END — a NEGATIVE index
    wraps Python-style and would corrupt the tail, so each piece zeroes
    the values of entries belonging to the other half instead of relying
    on the sign to drop them."""
    if len(flags) == 1:
        return (flags[0].at[idx].add(val, mode="drop"),)
    lo, hi = flags
    ok_lo = idx >= 0  # patterns < 2^31; >= _SPLIT then drop out of range
    lo = lo.at[jnp.where(ok_lo, idx, 0)].add(
        jnp.where(ok_lo, val, 0), mode="drop")
    # hi index = unsigned idx - _SPLIT (wrapping subtract): negative for
    # patterns below the split, in [0, 2^31) for every pattern above it
    idxh = idx - jnp.int32(_SPLIT)
    ok_hi = idxh >= 0
    hi = hi.at[jnp.where(ok_hi, idxh, 0)].add(
        jnp.where(ok_hi, val, 0), mode="drop")
    return lo, hi


@dataclasses.dataclass
class TraversalResult:
    """Device flag vectors + diagnostics (the reference's globals
    LCP_threshold / LCP_minima / DA, ebwt2InDel.cpp:56-58)."""

    thr_K: jax.Array  # (n,) uint8 — LCP_threshold[2i]   (LCP[i] >= K)
    thr_R: jax.Array  # (n,) uint8 — LCP_threshold[2i+1] (LCP[i] >= k_right)
    minima: jax.Array  # (n,) uint8
    da: jax.Array | None  # (n,) uint8 (modes 2/3)
    stats: dict
    # above 2^31 positions the flag fields are BIT-PACKED uint32 word
    # arrays ((4*ceil(n/128),) each, the ops.bits.bv_build layout) — the
    # uint8 form alone would not fit HBM; consumers branch on this flag
    packed: bool = False


def _sliced_prefix_gather(flat, idx, n_keep, budget: int):
    """Gather flat rows at idx[:n_keep] into a fresh buffer via
    budget-sized slices of a data-dependent inner while_loop.

    Typically only a
    fraction of child slots survive compaction, so gathering just the
    kept prefix (rounded up to `budget`) instead of all m slots saves
    most of the compaction gather. Rows past n_keep are garbage (zeros /
    stale), which the queue contract tolerates: appended pad rows are
    overwritten by later appends before `head` can reach them, and
    callers slice by the returned count."""
    m = flat.shape[0]
    budget = min(budget, m)
    out = jnp.zeros_like(flat)

    def wcond(state):
        return state[0] * budget < n_keep

    def wstep(state):
        it, out = state
        sel = jax.lax.dynamic_slice(idx, (it * budget,), (budget,))
        rows = flat[jnp.minimum(sel, m - 1)]
        return it + 1, jax.lax.dynamic_update_slice(
            out, rows, (it * budget, jnp.int32(0))
        )

    return jax.lax.while_loop(wcond, wstep, (jnp.int32(0), out))[1]


def _compact(flat, keep, budget: int | None = None):
    """Dense-prefix compaction of kept rows; returns (buffer, count).

    The permutation comes from ONE s32 sort of keep-tagged iotas (kept
    rows keep their index, dropped rows sort after them at m+i), followed
    by a row gather, in place of a cumsum + index-scatter formulation
    or a direct row scatter. Rows at positions >= count
    are garbage, which is safe for the queue (see _sliced_prefix_gather).

    budget: when set, only the kept prefix is gathered, in budget-sized
    slices (the traversal bodies pass chunk-sized budgets; the small
    fixed-shape frontier compactions gather everything).
    """
    m = flat.shape[0]
    iota = jnp.arange(m, dtype=jnp.int32)
    perm = jax.lax.sort(jnp.where(keep, iota, m + iota), is_stable=False)
    n_keep = keep.sum(dtype=jnp.int32)
    if budget is None:
        return flat[jnp.minimum(perm, m - 1)], n_keep
    return _sliced_prefix_gather(flat, perm, n_keep, budget), n_keep


def _compact_cm(flat_rm, keep_cm, budget: int | None = None):
    """Char-major compaction reading row-major child storage.

    The extension tensors are built row-major ((C, k, w) — node-major),
    but the queue wants char-major order (children extending by the same
    character live in the same F-region, so consecutive queue entries
    gather from nearby block rows). Instead of materializing a
    transposed (k*C, w) copy (a minor-dim shuffle XLA lowers to a real
    pass over the array), sort char-major SLOT IDS (char j of node i is
    j*C + i) and remap the winning slots to row-major indices inside the
    gather — the transpose becomes index arithmetic."""
    C, k = keep_cm.shape
    m = C * k
    slot = (jnp.arange(k, dtype=jnp.int32)[None, :] * C
            + jnp.arange(C, dtype=jnp.int32)[:, None])  # (C, k) char-major
    perm = jax.lax.sort(jnp.where(keep_cm, slot, m + slot).reshape(m), is_stable=False)
    cm = jnp.minimum(perm, m - 1)
    rm = (cm % C) * k + cm // C
    n_keep = keep_cm.sum(dtype=jnp.int32)
    if budget is None:
        return flat_rm[rm], n_keep
    return _sliced_prefix_gather(flat_rm, rm, n_keep, budget), n_keep


# ---------------------------------------------------------------------------
# packed traversal flags: 8 positions per int32 word, 4 bits each
# (1=thr_K, 2=thr_R, 4=minima, 8=DA). Bit-disjoint adds never carry — each
# position's nibble is written by exactly one (node, border) across the
# whole traversal — and the scatter target shrinks 8x (58 MB instead of
# 464 MB at n=116M), which is what the per-entry random-update cost tracks.
# ---------------------------------------------------------------------------


def _flag_words(n: int) -> int:
    return (n + 7) // 8


def _flag_scatter(nf, borders, vals):
    """Scatter-add 4-bit flag values at position indices into the packed
    word array. Dummy entries use border >= 8*nf.size (dropped)."""
    w = jax.lax.shift_right_logical(borders, 3)
    sh = (borders & 7) * 4
    return nf.at[w].add(vals << sh, mode="drop")


def _unpack_flags(nf, n: int):
    """(nw,) packed flag words -> (n,) int32 per-position 4-bit flags."""
    sh = (jnp.arange(8, dtype=jnp.int32) * 4)[None, :]
    return (jax.lax.shift_right_logical(nf[:, None], sh) & 15).reshape(-1)[:n]





# ---------------------------------------------------------------------------
# chunk bodies — pure functions (chunk, count, flags, stats) -> updated
# ---------------------------------------------------------------------------


def _leaf_children(fm, first, second, depth, valid, append):
    """Shared leaf-extension tail: W# left-extensions with size >= 2
    (next_leaves, dna_bwt.hpp:358-379)."""
    C = first.shape[0]
    if _DEDUP_FRAC > 0:
        lo4, hi4 = fm_ops.lf_range_dedup(
            fm, first, second, budget=_dedup_budget(2 * C)
        )
    elif _NARROW:
        lo4, hi4 = fm_ops.lf_range_narrow(
            fm, first, second, budget=_narrow_budget(C), valid=valid
        )
    else:
        lo4, hi4 = fm_ops.lf_range(fm, first, second)
    child_depth = jnp.broadcast_to((depth + 1)[:, None], lo4.shape)
    children = jnp.stack([lo4, hi4, child_depth], axis=-1)  # (C, 4, 3)
    keep = valid[:, None] & uge(hi4 - lo4, 2)
    return append(children.reshape(C * 4, 3), keep, True)


def _leaf_body(fm: FMIndex, chunk, count, flags, stats, *, K, k_right, append, log_mode=True):
    """Suffix-tree leaf step (phase 2), dual-lane packed deltas.
    chunk: (C,3) [first, second, depth].

    Interior LCP-threshold fills as boundary deltas (reference:
    update_LCP_leaf, ebwt2InDel.cpp:344-355). The K- and R-deltas of a
    leaf target the SAME two indices (first+1, second), so both ride one
    int32 word — K in the low 16 bits, R in the high 16 — halving scatter
    entries (2 per leaf) and the (n+1,) target. Integer addition makes
    the final word exactly netK + 65536*netR; the carry-aware decode in
    navigate_one_bwt is exact while every per-position net count stays
    below 2^15, which stats[2] (max leaf depth, an upper bound on the
    boundary nesting count) verifies after the phase — the wide int32
    formulation (_leaf_body_wide) reruns the phase in the pathological
    case and only compiles then.
    """
    # flags is layout-only here (shapes for the dummy pattern): the body
    # RETURNS its (idx, val) entries and the dispatch applies them to the
    # delta vector OUTSIDE the while loop — a scatter on a while-loop
    # carry can copy the whole target every iteration, while
    # dynamic_update_slice carries alias in place.
    C = chunk.shape[0]
    valid = jnp.arange(C, dtype=jnp.int32) < count
    first, second, depth = chunk[:, 0], chunk[:, 1], chunk[:, 2]
    dummy = _dif_dummy(flags)

    condK = valid & (depth >= K)
    condR = valid & (depth >= k_right)
    v = condK * 1 + condR * 65536
    idx = jnp.concatenate([
        jnp.where(v > 0, first + 1, dummy),
        jnp.where(v > 0, second, dummy),
    ])
    val = jnp.concatenate([v, -v])

    out, n_out = _leaf_children(fm, first, second, depth, valid, append)
    stats = (
        stats[0] + count,  # leaves visited
        stats[1] + jnp.sum(jnp.where(valid, second - first - 1, 0)),  # lcp
        jnp.maximum(stats[2], jnp.max(jnp.where(valid, depth, 0))),
        stats[3],
    )
    if not log_mode:
        return out, n_out, _dif_scatter(flags, idx, val), stats
    return out, n_out, (idx, val), stats


def _leaf_body_wide(fm: FMIndex, chunk, count, flags, stats, *, K, k_right, append, log_mode=True):
    """Int32-per-field leaf step — the exact-for-any-depth fallback of
    _leaf_body (compiled lazily, only when max leaf depth >= 2^15 - 2)."""
    (dif,) = flags  # layout only: (2*(n+1),) — field 0 K-diff, 1 R-diff
    C = chunk.shape[0]
    stride = dif.shape[0] // 2
    valid = jnp.arange(C, dtype=jnp.int32) < count
    first, second, depth = chunk[:, 0], chunk[:, 1], chunk[:, 2]
    dummy = jnp.int32(dif.shape[0])

    condK = valid & (depth >= K)
    condR = valid & (depth >= k_right)
    idx = jnp.concatenate([
        jnp.where(condK, first + 1, dummy),
        jnp.where(condK, second, dummy),
        jnp.where(condR, first + 1 + stride, dummy),
        jnp.where(condR, second + stride, dummy),
    ])
    val = jnp.concatenate([
        jnp.ones(C, jnp.int32), jnp.full(C, -1, jnp.int32),
        jnp.ones(C, jnp.int32), jnp.full(C, -1, jnp.int32),
    ])

    out, n_out = _leaf_children(fm, first, second, depth, valid, append)
    stats = (
        stats[0] + count,
        stats[1] + jnp.sum(jnp.where(valid, second - first - 1, 0)),
        stats[2],
        stats[3],
    )
    if not log_mode:
        return out, n_out, _dif_scatter(flags, idx, val), stats
    return out, n_out, (idx, val), stats


# packed dual-lane leaf deltas stay exact while every per-position net
# boundary count < 2^15; max leaf depth bounds that count (a leaf chain
# sharing a boundary has distinct depths), with margin for safety
_LANE_SAFE_DEPTH = 32000


def _split_lanes(dif):
    """Carry-aware dual-lane decode: word == netK + 65536*netR exactly
    (integer addition is order-free), so sign-extending the low half and
    subtracting recovers both lanes while |netK| < 2^15."""
    netK = (dif << 16) >> 16  # arithmetic: sign-extend low 16 bits
    netR = (dif - netK) >> 16  # exact multiple of 2^16
    return netK, netR


# tri-lane packed pair deltas (K bits 0-10, R bits 11-21, DA bits 22-31)
# stay exact while every per-position net boundary count < 2^9 (the top
# lane's signed range); max leaf depth bounds that count, with margin
_LANE3_SAFE_DEPTH = 480


def _split_lanes3(dif):
    """Carry-aware tri-lane decode: word == netK + 2^11*netR + 2^22*netDA
    exactly, recovered lane by lane by sign-extension + subtraction while
    |netK|, |netR| < 2^10 and |netDA| < 2^9."""
    netK = (dif << 21) >> 21  # sign-extend low 11 bits
    rem = (dif - netK) >> 11  # exact multiple of 2^11
    netR = (rem << 21) >> 21
    netD = (rem - netR) >> 11
    return netK, netR, netD


def _node_body(fm: FMIndex, chunk, count, flags, stats, *, K, k_right, append, log_mode=True):
    """Internal-node step (phase 3): border LCP writes, minima marks, and
    Weiner-link extension (update_lcp_threshold include.hpp:826-860;
    update_lcp_minima ebwt2InDel.cpp:357-391; next_nodes dna_bwt.hpp:381-404).
    chunk: (C,7).
    """
    (nf,) = flags  # packed flag words (see _flag_scatter)
    # (int32 words, not uint8 flags: word-sized scatter updates)
    C = chunk.shape[0]
    valid = jnp.arange(C, dtype=jnp.int32) < count
    depth = chunk[:, 6]
    last = chunk[:, 5]
    dummy = jnp.int32(pat32(nf.shape[0] * 8))
    lcp_values = jnp.int32(0)
    n_min = jnp.int32(0)

    # one nibble-packed add-scatter for all border writes: every flagged
    # position is written by exactly one (node, border) across the whole
    # traversal (the border's LCP value is that unique node's depth), so
    # add never collides on a bit. Border comparisons are unsigned
    # (positions are uint32 bit patterns, ops/coords.py).
    idxs = []
    vals = []
    for j in range(1, 5):
        border = chunk[:, j]
        has_prev = ugt(border, chunk[:, j - 1])
        cond = valid & has_prev & (border != last)
        lcp_values = lcp_values + jnp.sum(cond.astype(jnp.int32))
        v = ((cond & (depth >= K)) * 1 + (cond & (depth >= k_right)) * 2)
        if j >= 2:
            prev_size = border - chunk[:, j - 1]
            cond_m = valid & uge(prev_size, 2) & ult(border, last - 1)
            n_min = n_min + jnp.sum(cond_m.astype(jnp.int32))
            v = v + cond_m * 4
        idxs.append(jnp.where(v > 0, border, dummy))
        vals.append(v)
    # entries are applied to nf OUTSIDE the while loop (see _leaf_body)

    if _DEDUP_FRAC > 0:
        ext = fm_ops.extend_node_dedup(fm, chunk, budget=_dedup_budget(6 * C))
    elif _NARROW:
        ext = fm_ops.extend_node_narrow(fm, chunk, budget=_narrow_budget(C),
                                        valid=valid)
    else:
        ext = fm_ops.extend_node(fm, chunk)  # (C, 4, 7)
    nch = fm_ops.node_num_children(ext)
    keep = valid[:, None] & (nch >= 2)
    # char-major compaction: children extending by the same character live in
    # the same F-region, so consecutive queue entries gather from nearby
    # block rows (better HBM locality); ordering is free (writes order-free)
    out, n_out = append(ext.reshape(C * 4, 7), keep, True)

    stats = (stats[0] + count, stats[1] + lcp_values, stats[2] + n_min,
             stats[3])
    if not log_mode:
        nf = _flag_scatter_compact(nf, jnp.concatenate(idxs),
                                   jnp.concatenate(vals), vals_bits=3)
        return out, n_out, (nf,), stats
    return out, n_out, (jnp.concatenate(idxs), jnp.concatenate(vals)), stats


def _leaf_pair_children(fm1, fm2, f1, s1, f2, s2, depth, valid,
                        append):
    """Shared leaf-pair extension tail: children kept iff combined size
    >= 2 (ebwt2InDel.cpp:452-472) — size-1 leaves recover in the node
    phase."""
    C = f1.shape[0]
    if _DEDUP_FRAC > 0:
        b = _dedup_budget(2 * C)
        lo1, hi1 = fm_ops.lf_range_dedup(fm1, f1, s1, budget=b)
        lo2, hi2 = fm_ops.lf_range_dedup(fm2, f2, s2, budget=b)
    elif _NARROW:
        b = _narrow_budget(C)
        lo1, hi1 = fm_ops.lf_range_narrow(fm1, f1, s1, budget=b, valid=valid)
        lo2, hi2 = fm_ops.lf_range_narrow(fm2, f2, s2, budget=b, valid=valid)
    else:
        lo1, hi1 = fm_ops.lf_range(fm1, f1, s1)
        lo2, hi2 = fm_ops.lf_range(fm2, f2, s2)
    child_depth = jnp.broadcast_to((depth + 1)[:, None], lo1.shape)
    children = jnp.stack([lo1, hi1, lo2, hi2, child_depth], axis=-1)
    combined = (hi1 - lo1) + (hi2 - lo2)
    keep = valid[:, None] & uge(combined, 2)
    return append(children.reshape(C * 4, 5), keep, False)


def _leaf_pair_body(fm1, fm2, chunk, count, flags, stats, *, K, k_right, append, log_mode=True):
    """Leaf-pair step for the lockstep two-BWT merge, dual-lane packed
    deltas (see _leaf_body). chunk: (C,5) [f1, s1, f2, s2, depth]. DA +
    merged LCP fills (update_DA, ebwt2InDel.cpp:394-425). dif layout
    (2*(n+1),): area 0 = dual-lane K/R word, area 1 = DA-diff int32.
    """
    (dif,) = flags
    C = chunk.shape[0]
    stride = dif.shape[0] // 2
    valid = jnp.arange(C, dtype=jnp.int32) < count
    f1, s1, f2, s2, depth = (chunk[:, i] for i in range(5))
    start1 = f1 + f2
    start2 = f2 + s1
    end = s1 + s2
    dummy = jnp.int32(dif.shape[0])

    condK = valid & (depth >= K)
    condR = valid & (depth >= k_right)
    v = condK * 1 + condR * 65536
    one = jnp.ones(C, jnp.int32)
    idx = jnp.concatenate([
        jnp.where(v > 0, start1 + 1, dummy),
        jnp.where(v > 0, end, dummy),
        jnp.where(valid, start2 + stride, dummy),
        jnp.where(valid, end + stride, dummy),
    ])
    val = jnp.concatenate([v, -v, one, -one])

    out, n_out = _leaf_pair_children(fm1, fm2, f1, s1, f2, s2, depth,
                                     valid, append)
    stats = (
        stats[0] + count,
        stats[1] + jnp.sum(jnp.where(valid, end - start1 - 1, 0)),
        jnp.maximum(stats[2], jnp.max(jnp.where(valid, depth, 0))),
        stats[3] + jnp.sum(jnp.where(valid, end - start1, 0)),  # da_values
    )
    if not log_mode:
        return out, n_out, ((flags[0]).at[idx].add(val, mode="drop"),), \
            stats
    return out, n_out, (idx, val), stats


def _leaf_pair_body3(fm1, fm2, chunk, count, flags, stats, *, K, k_right, append, log_mode=True):
    """Tri-lane packed leaf-pair step — the production formulation.

    To keep the scatter TARGET small, the K/R/DA boundary deltas of a
    leaf pair all ride
    ONE (n+1,) int32 vector (lanes: K bits 0-10, R 11-21, DA 22-31)
    instead of the (2*(n+1),) dual-area layout — half the target, and the
    `end` index carries its K/R and DA deltas in a single entry (3
    entries per leaf instead of 4). Exact while per-position nesting
    counts stay under 2^9 (_LANE3_SAFE_DEPTH, verified from the max-depth
    stat after the phase; navigate_two_bwts reruns with _leaf_pair_body /
    _leaf_pair_body_wide in the pathological case). chunk: (C,5)."""
    # flags: 1- or 2-piece tri-lane delta vector ((lo, hi) above 2^31
    # entries — see _dif_scatter)
    C = chunk.shape[0]
    valid = jnp.arange(C, dtype=jnp.int32) < count
    f1, s1, f2, s2, depth = (chunk[:, i] for i in range(5))
    start1 = f1 + f2
    start2 = f2 + s1
    end = s1 + s2
    dummy = _dif_dummy(flags)

    condK = valid & (depth >= K)
    condR = valid & (depth >= k_right)
    v = condK * 1 + condR * (1 << 11)
    d = valid * (1 << 22)
    idx = jnp.concatenate([
        jnp.where(v > 0, start1 + 1, dummy),
        jnp.where(valid, start2, dummy),
        jnp.where(valid, end, dummy),
    ])
    val = jnp.concatenate([v, d, -(v + d)])

    out, n_out = _leaf_pair_children(fm1, fm2, f1, s1, f2, s2, depth,
                                     valid, append)
    stats = (
        stats[0] + count,
        stats[1] + jnp.sum(jnp.where(valid, end - start1 - 1, 0)),
        jnp.maximum(stats[2], jnp.max(jnp.where(valid, depth, 0))),
        stats[3] + jnp.sum(jnp.where(valid, end - start1, 0)),  # da_values
    )
    if not log_mode:
        return out, n_out, _dif_scatter(flags, idx, val), stats
    return out, n_out, (idx, val), stats


def _leaf_pair_body_wide(fm1, fm2, chunk, count, flags, stats, *, K,
                         k_right, append, log_mode=True):
    """Int32-per-field leaf-pair step — the any-depth fallback of
    _leaf_pair_body (compiled lazily). dif: (3*(n+1),) fields K, R, DA."""
    (dif,) = flags
    C = chunk.shape[0]
    stride = dif.shape[0] // 3
    valid = jnp.arange(C, dtype=jnp.int32) < count
    f1, s1, f2, s2, depth = (chunk[:, i] for i in range(5))
    start1 = f1 + f2
    start2 = f2 + s1
    end = s1 + s2
    dummy = jnp.int32(dif.shape[0])

    condK = valid & (depth >= K)
    condR = valid & (depth >= k_right)
    one = jnp.ones(C, jnp.int32)
    idx = jnp.concatenate([
        jnp.where(condK, start1 + 1, dummy),
        jnp.where(condK, end, dummy),
        jnp.where(condR, start1 + 1 + stride, dummy),
        jnp.where(condR, end + stride, dummy),
        jnp.where(valid, start2 + 2 * stride, dummy),
        jnp.where(valid, end + 2 * stride, dummy),
    ])
    val = jnp.concatenate([one, -one, one, -one, one, -one])

    out, n_out = _leaf_pair_children(fm1, fm2, f1, s1, f2, s2, depth,
                                     valid, append)
    stats = (
        stats[0] + count,
        stats[1] + jnp.sum(jnp.where(valid, end - start1 - 1, 0)),
        stats[2],
        stats[3] + jnp.sum(jnp.where(valid, end - start1, 0)),
    )
    if not log_mode:
        return out, n_out, _dif_scatter(flags, idx, val), stats
    return out, n_out, (idx, val), stats


def _node_pair_body(fm1, fm2, chunk, count, flags, stats, *, K, k_right, append, log_mode=True):
    """Node-pair step: size-1 leaf recovery (find_leaves,
    ebwt2InDel.cpp:474-527), merged-node LCP/minima updates
    (ebwt2InDel.cpp:792-802), pairwise Weiner extension keeping pairs with
    >= 2 union children (ebwt2InDel.cpp:529-553). chunk: (C,13).
    """
    (nf,) = flags  # packed flag words (see _flag_scatter)
    C = chunk.shape[0]
    valid = jnp.arange(C, dtype=jnp.int32) < count
    c1 = chunk[:, 0:6]
    c2 = chunk[:, 6:12]
    depth = chunk[:, 12]
    merged = c1 + c2
    last = merged[:, 5]
    dummy = jnp.int32(pat32(nf.shape[0] * 8))

    idxs = []
    vals = []
    # find_leaves: a singleton merged position gets its DA bit from exactly
    # one visited node pair (a deeper pair over the same singleton interval
    # cannot have >= 2 union children), so the add never collides
    da_values = jnp.int32(0)
    for j in range(5):
        l1 = c1[:, j + 1] - c1[:, j]
        l2 = c2[:, j + 1] - c2[:, j]
        cond = valid & ((l1 + l2) == 1)
        pos = c1[:, j] + c2[:, j]
        da_values = da_values + jnp.sum(cond.astype(jnp.int32))
        cond_da = cond & (l2 == 1)
        idxs.append(jnp.where(cond_da, pos, dummy))
        vals.append(cond_da * 8)

    lcp_values = jnp.int32(0)
    n_min = jnp.int32(0)
    for j in range(1, 5):
        border = merged[:, j]
        has_prev = ugt(border, merged[:, j - 1])  # unsigned: patterns
        cond = valid & has_prev & (border != last)
        lcp_values = lcp_values + jnp.sum(cond.astype(jnp.int32))
        v = ((cond & (depth >= K)) * 1 + (cond & (depth >= k_right)) * 2)
        if j >= 2:
            prev_size = border - merged[:, j - 1]
            cond_m = valid & uge(prev_size, 2) & ult(border, last - 1)
            n_min = n_min + jnp.sum(cond_m.astype(jnp.int32))
            v = v + cond_m * 4
        idxs.append(jnp.where(v > 0, border, dummy))
        vals.append(v)
    # entries are applied to nf OUTSIDE the while loop (see _leaf_body)

    if _DEDUP_FRAC > 0:
        # pair chunks are especially run-heavy: a string present in only
        # one BWT makes the other side's node empty (all 6 coords equal)
        b = _dedup_budget(6 * C)
        ext1 = fm_ops.extend_node_dedup(fm1, chunk[:, [0, 1, 2, 3, 4, 5, 12]],
                                        budget=b)
        ext2 = fm_ops.extend_node_dedup(fm2, chunk[:, [6, 7, 8, 9, 10, 11, 12]],
                                        budget=b)
    elif _NARROW:
        b = _narrow_budget(C)
        ext1 = fm_ops.extend_node_narrow(fm1, chunk[:, [0, 1, 2, 3, 4, 5, 12]],
                                         budget=b, valid=valid)
        ext2 = fm_ops.extend_node_narrow(fm2, chunk[:, [6, 7, 8, 9, 10, 11, 12]],
                                         budget=b, valid=valid)
    else:
        ext1 = fm_ops.extend_node(fm1, chunk[:, [0, 1, 2, 3, 4, 5, 12]])
        ext2 = fm_ops.extend_node(fm2, chunk[:, [6, 7, 8, 9, 10, 11, 12]])
    u1 = ugt(ext1[..., 1:6], ext1[..., 0:5])
    u2 = ugt(ext2[..., 1:6], ext2[..., 0:5])
    n_union = jnp.sum((u1 | u2).astype(jnp.int32), axis=-1)
    children = jnp.concatenate(
        [ext1[..., :6], ext2[..., :6], ext1[..., 6:7]], axis=-1
    )
    keep = valid[:, None] & (n_union >= 2)
    out, n_out = append(children.reshape(C * 4, 13), keep, False)

    stats = (stats[0] + count, stats[1] + lcp_values, stats[2] + n_min,
             stats[3] + da_values)
    if not log_mode:
        nf = _flag_scatter_compact(nf, jnp.concatenate(idxs),
                                   jnp.concatenate(vals))
        return out, n_out, (nf,), stats
    return out, n_out, (jnp.concatenate(idxs), jnp.concatenate(vals)), stats


# ---------------------------------------------------------------------------
# single-chunk jitted steps — the exposed 'forward step' building blocks
# (used by __graft_entry__ and the sharded layer's tests)
# ---------------------------------------------------------------------------


@partial(jax.jit, static_argnames=("K", "k_right"), donate_argnums=(3,))
def _node_wave(fm: FMIndex, nodes, count, node_flags, *, K, k_right):
    """One internal-node chunk step over the packed flag words (8 positions
    x 4 bits per int32; 1=thr_K, 2=thr_R, 4=minima). The exposed
    single-dispatch 'forward step' of the flagship compute path (used by
    __graft_entry__)."""
    def append(flat, keep, char_major):
        if char_major:
            return _compact_cm(flat, keep, budget=_compact_budget(
                nodes.shape[0]))
        return _compact(flat, keep.reshape(-1),
                        budget=_compact_budget(nodes.shape[0]))

    out, n_out, (nf,), st = _node_body(
        fm, nodes, count, (node_flags,),
        (jnp.int32(0),) * 4, K=K, k_right=k_right, append=append,
        log_mode=False,
    )
    return out, n_out, nf, st[1], st[2]


# positions above this can't ride the (pos << vals_bits | val) packed
# sort key; module-level so tests can force the other paths at small scale
_FLAG_PACK_LIMIT = (1 << 28) - 8
_FLAG_PACK3_LIMIT = (1 << 29) - 8


def _flag_scatter_compact(nf, borders, vals, vals_bits: int = 4):
    """_flag_scatter fed by sort-compacted slices.

    Only ~4% of node-border slots carry a nonzero flag value at genome
    scale, while the scatter pays per SLOT whether or not it drops the
    entry. One 1-operand uint32 sort over packed (position <<
    vals_bits | value) keys (real entries ascend, zero-value slots become
    0xFFFFFFFF and sink) compacts them; budget-sized slices of the real
    prefix then feed the scatter through a data-dependent inner loop —
    one iteration for typical chunks. The packing needs position <
    2^(32-vals_bits): mode 1's node values fit 3 bits (1|2|4 combos,
    <= 7), carrying the zero-gather path to n < 2^29; the pair bodies add
    the DA bit (8) and need 4. Larger inputs (up to the 2^31 single-run
    limit) sort (iota << 4 | val) instead — iota fits easily (m <= 9
    chunks) — so only the POSITION needs a per-slice gather at the kept
    prefix; the value unpacks from the key (one gather instead of two).
    Multi-operand payload sorts and a phase-long entry log are the
    alternatives not taken (the log is a non-aliased while-carry)."""
    m = borders.shape[0]
    n_real = jnp.sum((vals > 0).astype(jnp.int32))
    dummy = jnp.int32(pat32(nf.shape[0] * 8))
    budget = max(256, m // 8)
    ar = jnp.arange(budget, dtype=jnp.int32)
    n_cap = nf.shape[0] * 8
    if vals_bits == 3 and n_cap < _FLAG_PACK3_LIMIT:
        vb = 3
    elif n_cap < _FLAG_PACK_LIMIT:
        vb = 4
    else:
        vb = 0  # any-n path: (iota << 4 | val) key + per-slice pos gather
    vmask = jnp.uint32((1 << vb) - 1 if vb else 15)

    if vb:
        key = jnp.where(
            vals > 0,
            (borders.astype(jnp.uint32) << vb) | vals.astype(jnp.uint32),
            jnp.uint32(0xFFFFFFFF),
        )
    else:
        iota = jnp.arange(m, dtype=jnp.uint32)
        key = jnp.where(
            vals > 0, (iota << 4) | vals.astype(jnp.uint32),
            jnp.uint32(0xFFFFFFFF),
        )
    skey = jax.lax.sort(key, is_stable=False)
    pad = (-m) % budget
    if pad:
        skey = jnp.concatenate([skey, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)])

    def wcond(state):
        return state[0] * budget < n_real

    def wstep(state):
        it, nf = state
        live = it * budget + ar < n_real
        sl = jax.lax.dynamic_slice(skey, (it * budget,), (budget,))
        up = jax.lax.shift_right_logical(
            sl, jnp.uint32(vb if vb else 4)).astype(jnp.int32)
        if vb:
            pos = jnp.where(live, up, dummy)
        else:
            pos = jnp.where(live, borders[jnp.minimum(up, m - 1)], dummy)
        val = (sl & vmask).astype(jnp.int32)
        return it + 1, _flag_scatter(nf, pos, val)

    _, nf = jax.lax.while_loop(wcond, wstep, (jnp.int32(0), nf))
    return nf


# flag buffers at or above this many BYTES take the entry-log path in
# the dispatch (in-loop scatters copy the whole while carry per step);
# smaller buffers keep the direct in-loop scatter
_LOG_FLAGS_MIN = int(_os.environ.get("EBWT_LOG_FLAGS_MIN", 1 << 27))

# flag entries emitted per queue row, by body — sizes the dispatch log
_ENTRY_FACTOR = {
    "_leaf_body": 2,
    "_leaf_body_wide": 4,
    "_leaf_pair_body3": 3,
    "_leaf_pair_body": 4,
    "_leaf_pair_body_wide": 6,
    "_node_body": 4,
    "_node_pair_body": 9,
}


# ---------------------------------------------------------------------------
# device-resident queue driver
# ---------------------------------------------------------------------------


@partial(jax.jit, donate_argnums=(1, 2),
         static_argnames=("body", "w", "chunk", "K", "k_right",
                          "max_iters", "with_ramp"))
def _queue_phase_dispatch(fms, q, flags, head, tail, stats, maxp, *, body,
                          w, chunk, K, k_right, max_iters, with_ramp):
    """Run up to ``max_iters`` chunk steps of a traversal phase in ONE
    device dispatch, returning the resumable state.

    Bounded dispatches serve two purposes: (a) the state at a dispatch
    boundary IS the traversal checkpoint (queue rows + flags + counters —
    EBWT_CKPT in _run_phase), and (b) progress is observable between
    dispatches. q and flags are
    donated — the state updates in place across dispatches.

    fms: tuple of FMIndex; q: flattened row-major queue; flags: tuple of
    flag arrays threaded through the body. ``body`` must be a
    module-level function (stable jit cache key). Returns
    (q, head, tail, overflow, flags, stats(4,), max_pending).
    """

    f = _ENTRY_FACTOR[body.__name__]
    # regime choice by flag-buffer size: a scatter on a while-loop carry
    # can copy the WHOLE carry every iteration (ROADMAP A3 asks whether
    # XLA:GPU does), so
    # large flag buffers use the entry-log path (dus-aliased log in the
    # loop, scatters applied after it); small buffers keep the direct
    # in-loop scatter, whose copy is cheap and avoids the log machinery.
    flag_bytes = sum(int(np.prod(fl.shape)) * 4 for fl in flags)
    log_mode = flag_bytes >= _LOG_FLAGS_MIN
    # node-family bodies emit ~96% dummy entries (only flagged borders
    # carry a value): sort-compact each step's entries before logging so
    # the apply pass only pays for real ones. Leaf-family entries are
    # nearly all real — logged raw.
    compact = log_mode and body.__name__ in ("_node_body",
                                             "_node_pair_body")
    # clamp iterations so the entry log stays <= ~0.5 GB (1 GB for
    # compacted logs, whose reserved-but-unfilled slack costs nothing —
    # only the filled prefix is ever applied); compacted logs still
    # reserve f*chunk space per step (worst case) plus write slack
    cap_entries = (1 << 27) if compact else (1 << 26)
    iters_eff = max_iters if not log_mode else \
        min(max_iters, max(16, cap_entries // (f * chunk)))
    ramp_on = with_ramp and _RAMP and chunk > 4 * _RAMP
    log_len = (f * chunk * (iters_eff + 1)
               + (f * _RAMP * 64 if ramp_on else 0)) if log_mode else 1

    def cond(state):
        it = state[-1]
        _, head, tail, overflow = state[:4]
        return (head < tail) & ~overflow & (it < iters_eff)

    def make_step(C: int):
        def step(state):
            (q, head, tail, overflow, flags, log_i, log_v, eoff, stats,
             maxp, it) = state
            # reclaim consumed queue space: when the next append could
            # overrun the buffer, shift the pending region [head, tail)
            # back to offset 0 (amortized O(C) per step)
            q_rows = q.shape[0] // w
            need = (tail + 4 * C) > q_rows
            q = jax.lax.cond(
                need, lambda a, h: jnp.roll(a, -h * w, axis=0),
                lambda a, h: a, q, head
            )
            tail = jnp.where(need, tail - head, tail)
            head = jnp.where(need, 0, head)
            # true overflow: pending alone can't fit — restart bigger
            overflow = (tail + 4 * C) > q_rows

            count = jnp.minimum(tail - head, C)
            block = jax.lax.dynamic_slice(
                q, (head * w,), (C * w,)).reshape(C, w)

            def append(flat, keep, char_major):
                # fused compact+append: the sort-compaction's kept-prefix
                # gather writes its budget slices DIRECTLY into the queue
                # at `tail` — no (4C, w) children buffer is materialized
                # and no second full-width block copy happens (the old
                # formulation wrote all 4C rows per step, 3/4 of them
                # pad). Slice writes
                # beyond n_keep leave garbage rows in
                # [tail+n_keep, tail+slices*budget) — never read: the next
                # append rewrites from its own tail, and head never
                # crosses tail. Queue headroom stays 4C (slices*budget
                # <= 4C with budget = C).
                m = flat.shape[0]
                if char_major:
                    Cc, k = keep.shape
                    slot = (jnp.arange(k, dtype=jnp.int32)[None, :] * Cc
                            + jnp.arange(Cc, dtype=jnp.int32)[:, None])
                    perm = jax.lax.sort(
                        jnp.where(keep, slot, m + slot).reshape(m), is_stable=False)
                    cm = jnp.minimum(perm, m - 1)
                    idx = (cm % Cc) * k + cm // Cc
                else:
                    iota = jnp.arange(m, dtype=jnp.int32)
                    perm = jax.lax.sort(
                        jnp.where(keep.reshape(m), iota, m + iota), is_stable=False)
                    idx = jnp.minimum(perm, m - 1)
                n_keep = keep.sum(dtype=jnp.int32)
                if not _SLICED:
                    qq = jax.lax.dynamic_update_slice(
                        q, flat[idx].reshape(-1), (tail * w,))
                    return qq, n_keep
                budget = min(C, m)

                def wcond(st):
                    return st[0] * budget < n_keep

                def wstep(st):
                    it, qq = st
                    sel = jax.lax.dynamic_slice(idx, (it * budget,),
                                                (budget,))
                    rows = flat[jnp.minimum(sel, m - 1)]
                    qq = jax.lax.dynamic_update_slice(
                        qq, rows.reshape(-1), ((tail + it * budget) * w,))
                    return it + 1, qq

                qq = jax.lax.while_loop(wcond, wstep, (jnp.int32(0), q))[1]
                return qq, n_keep

            q, n_out, body_out, stats = body(
                *fms, block, count, flags, stats, K=K, k_right=k_right,
                append=append, log_mode=log_mode,
            )
            if not log_mode:
                # small flag buffers: the body scattered directly (the
                # per-iteration carry copy is cheap at this size)
                flags = body_out
                head = head + count
                tail = tail + n_out
                maxp = jnp.maximum(maxp, tail - head)
                if _PROGRESS:
                    jax.debug.print(
                        "[progress] processed {p} items, {w} pending",
                        p=stats[0], w=tail - head, ordered=False,
                    )
                return (q, head, tail, overflow, flags, log_i, log_v,
                        eoff, stats, maxp, it + 1)
            eidx, eval_ = body_out
            # log the flag entries (dynamic_update_slice aliases the log
            # in place across iterations); the host applies the filled
            # log prefix to the flag buffers AFTER the dispatch — an
            # in-loop scatter copies the whole multi-GB flag carry every
            # iteration
            if not compact:
                log_i = jax.lax.dynamic_update_slice(log_i, eidx, (eoff,))
                log_v = jax.lax.dynamic_update_slice(log_v, eval_, (eoff,))
                eoff = eoff + eidx.shape[0]
            else:
                # sort-compact the ~4% real entries; budget slices write
                # the kept prefix at the running offset (pad entries get
                # the dummy index and are overwritten by the next step)
                m = eidx.shape[0]
                n_real = jnp.sum((eval_ > 0).astype(jnp.int32))
                iota = jnp.arange(m, dtype=jnp.uint32)
                key = jnp.where(
                    eval_ > 0,
                    (iota << 4) | eval_.astype(jnp.uint32),
                    jnp.uint32(0xFFFFFFFF),
                )
                skey = jax.lax.sort(key, is_stable=False)
                budget = max(256, m // 8)
                pad = (-m) % budget
                if pad:
                    skey = jnp.concatenate(
                        [skey, jnp.full(pad, 0xFFFFFFFF, jnp.uint32)])
                ar = jnp.arange(budget, dtype=jnp.int32)
                dummy_e = jnp.int32(pat32(flags[0].shape[0] * 8))

                def wcond(st):
                    return st[0] * budget < n_real

                def wstep(st):
                    it2, li, lv = st
                    live = it2 * budget + ar < n_real
                    sl = jax.lax.dynamic_slice(skey, (it2 * budget,),
                                               (budget,))
                    up = jax.lax.shift_right_logical(
                        sl, jnp.uint32(4)).astype(jnp.int32)
                    pos = jnp.where(
                        live, eidx[jnp.minimum(up, m - 1)], dummy_e)
                    v = (sl & jnp.uint32(15)).astype(jnp.int32)
                    li = jax.lax.dynamic_update_slice(
                        li, pos, (eoff + it2 * budget,))
                    lv = jax.lax.dynamic_update_slice(
                        lv, v, (eoff + it2 * budget,))
                    return it2 + 1, li, lv

                _, log_i, log_v = jax.lax.while_loop(
                    wcond, wstep, (jnp.int32(0), log_i, log_v))
                eoff = eoff + n_real
            head = head + count
            tail = tail + n_out
            maxp = jnp.maximum(maxp, tail - head)
            if _PROGRESS:
                jax.debug.print(
                    "[progress] processed {p} items, {w} pending",
                    p=stats[0], w=tail - head, ordered=False,
                )
            return (q, head, tail, overflow, flags, log_i, log_v, eoff,
                    stats, maxp, it + 1)

        return step

    stats_t = tuple(stats[i] for i in range(4))
    log_i = jnp.zeros(log_len, jnp.int32)
    log_v = jnp.zeros(log_len, jnp.int32)
    state = (q, head, tail, jnp.bool_(False), flags, log_i, log_v,
             jnp.int32(0), stats_t, maxp, jnp.int32(0))

    if ramp_on:
        # ramp loop (same program, same queue; first dispatch only): hand
        # off to the big-chunk loop once the frontier can utilize it, or
        # after a bounded amount of work so mid-size phases don't crawl
        # at ramp granularity
        ramp_limit = min(chunk, 16 * _RAMP)
        ramp_work = 32 * _RAMP

        def rcond(state):
            _, head, tail, overflow = state[:4]
            stats = state[8]
            it = state[-1]
            return ((head < tail) & ~overflow
                    & ((tail - head) <= ramp_limit)
                    & (stats[0] < ramp_work) & (it < 64))

        state = jax.lax.while_loop(rcond, make_step(_RAMP), state)
        # reset the iteration counter so the main loop gets its full
        # budget (the log offset keeps advancing)
        state = state[:10] + (jnp.int32(0),)

    (q, head, tail, overflow, flags, log_i, log_v, eoff, stats, maxp,
     _) = jax.lax.while_loop(cond, make_step(chunk), state)

    if not log_mode:
        return (q, head, tail, overflow, flags, None, None, eoff,
                jnp.stack(stats), maxp)
    if not compact:
        # leaf-family logs are nearly full: apply them here, inside the
        # dispatch (top-level scatters alias the donated flag buffers in
        # place; no extra host round-trip). Unfilled tail slots hold
        # zeros — a no-op add at index 0.
        for a in range(0, log_len, _APPLY_SLICE):
            b = min(a + _APPLY_SLICE, log_len)
            ei = jax.lax.slice(log_i, (a,), (b,))
            ev = jax.lax.slice(log_v, (a,), (b,))
            flags = _dif_scatter(flags, ei, ev)
        return (q, head, tail, overflow, flags, None, None, eoff,
                jnp.stack(stats), maxp)
    # compacted (node-family) logs are ~96% reserved slack: the scatter
    # pays ~9 ns per SLOT filled or not, so the host applies just the
    # filled prefix via _apply_log (the eoff sync piggybacks on the
    # existing per-dispatch head/tail sync)
    return (q, head, tail, overflow, flags, log_i, log_v, eoff,
            jnp.stack(stats), maxp)


_APPLY_SLICE = 1 << 24


@partial(jax.jit, donate_argnums=(0, 1, 2))
def _apply_log(flags, log_i, log_v):
    """Apply a compacted dispatch log (trimmed by the host to the filled
    prefix, rounded up to _APPLY_SLICE) to the packed nibble words with
    top-level scatters — in place via donation. Pad entries carry the
    dummy index (dropped) or zero values (no-op)."""
    L = log_i.shape[0]
    for a in range(0, L, _APPLY_SLICE):
        b = min(a + _APPLY_SLICE, L)
        ei = jax.lax.slice(log_i, (a,), (b,))
        ev = jax.lax.slice(log_v, (a,), (b,))
        flags = (_flag_scatter(flags[0], ei, ev),)
    return flags


# chunk steps per device dispatch: large enough that dispatch overhead
# is small, small enough that checkpoints (EBWT_CKPT_EVERY) stay
# frequent
_DISPATCH_ITERS = int(_os.environ.get("EBWT_DISPATCH_ITERS", 256))


def _ckpt_path(ckpt_dir: str, body) -> str:
    return _os.path.join(ckpt_dir, f"phase_{body.__name__}.npz")


def _run_phase(fms, init_np, flags_factory, body, n_hint, K, k_right):
    """Host wrapper: run a queue phase as a sequence of bounded device
    dispatches, doubling the queue on overflow.

    The queue bound is conservative (#pending nodes stays far below n in
    practice: 1.69M at n=116M). Flag updates are not idempotent across a
    partial run (the diff arrays use +/-1 adds), so flags enter as a
    FACTORY producing pristine zeros: the dispatch donates its queue and
    flag buffers (the largest arrays of the program — not donating
    doubles the 4.2 GB dif at n=1G) and an
    overflow retry simply makes fresh ones.

    Checkpoint/resume (SURVEY.md §5): the dispatch-boundary state (queue
    + flags + counters) is saved to EBWT_CKPT_DIR every EBWT_CKPT_EVERY
    dispatches and resumed from on the next run — the traversal-phase
    resume unit for multi-hour pod runs.
    """
    queue_cap = max(1 << 21, n_hint // 32)  # bounds *pending* nodes only —
    # consumed queue space is reclaimed in-loop; doubles on real overflow
    init = np.asarray(init_np.astype(np.int32))
    w = init.shape[1]
    ckpt_dir = _os.environ.get("EBWT_CKPT_DIR")
    ckpt_every = int(_os.environ.get("EBWT_CKPT_EVERY", 0))

    while True:
        head = jnp.int32(0)
        tail = jnp.int32(init.shape[0])
        stats = jnp.zeros(4, jnp.int32)
        maxp = jnp.int32(init.shape[0])
        q = jnp.zeros((queue_cap + 4 * CHUNK) * w, dtype=jnp.int32)
        q = q.at[: init.size].set(init.reshape(-1))
        flags = flags_factory()
        first = True

        if ckpt_dir and _os.path.isfile(_ckpt_path(ckpt_dir, body)):
            z = np.load(_ckpt_path(ckpt_dir, body))
            if int(z["queue_rows"]) * w == int(q.shape[0]):
                head = jnp.int32(int(z["head"]))
                tail = jnp.int32(int(z["tail"]))
                stats = jnp.asarray(z["stats"])
                maxp = jnp.int32(int(z["maxp"]))
                q = jnp.asarray(z["q"])
                flags = tuple(
                    jnp.asarray(z[f"flag{i}"]) for i in range(len(flags))
                )
                first = False

        d = 0
        while True:
            (q, head, tail, overflow, flags, log_i, log_v, eoff, stats,
             maxp) = _queue_phase_dispatch(
                fms, q, flags, head, tail, stats, maxp, body=body,
                w=w, chunk=CHUNK, K=K, k_right=k_right,
                max_iters=_DISPATCH_ITERS, with_ramp=first,
            )
            if log_i is not None:  # compacted log: host applies the
                m_fill = -(-max(int(eoff), 1) // _APPLY_SLICE) * \
                    _APPLY_SLICE  # filled prefix only
                m_fill = min(m_fill, log_i.shape[0])
                flags = _apply_log(flags, log_i[:m_fill], log_v[:m_fill])
                del log_i, log_v
            first = False
            d += 1
            if bool(overflow) or int(head) >= int(tail):
                break
            if ckpt_dir and ckpt_every and d % ckpt_every == 0:
                _os.makedirs(ckpt_dir, exist_ok=True)
                np.savez(
                    _ckpt_path(ckpt_dir, body),
                    q=np.asarray(q), head=int(head), tail=int(tail),
                    stats=np.asarray(stats), maxp=int(maxp),
                    queue_rows=q.shape[0] // w,
                    **{f"flag{i}": np.asarray(f)
                       for i, f in enumerate(flags)},
                )
        if not bool(overflow):
            if ckpt_dir and _os.path.isfile(_ckpt_path(ckpt_dir, body)):
                _os.remove(_ckpt_path(ckpt_dir, body))
            return flags, np.asarray(stats), int(maxp)
        import sys as _sys

        print(f"[ebwt2indel] queue overflow in {body.__name__} "
              f"(pending > {queue_cap} rows after {int(stats[0])} items): "
              f"doubling the queue and re-running the phase",
              file=_sys.stderr)
        queue_cap *= 2


# memory-lean post-passes engage above this n: the eager formulations
# hold dif + its cumsum + both lane arrays at once, the scan-chunked ones
# a slice at a time. Below it the eager single-fusion forms are kept.
# EBWT_LEAN_N overrides for tests.
_LEAN_N = int(_os.environ.get("EBWT_LEAN_N", 1 << 27))
_LEAN_SLICE = 1 << 24


def _lean_pad(n_items: int) -> int:
    return -(-n_items // _LEAN_SLICE) * _LEAN_SLICE


def _pack_bits_u32(bits_u8):
    """(L,) 0/1 uint8 -> (L//32,) uint32 little-endian words (flat bit p =
    word p>>5, bit p&31); strided 1-D adds (see ops.bits.bv_build)."""
    w = bits_u8[0::32].astype(jnp.uint32)
    for j in range(1, 32):
        w = w + (bits_u8[j::32].astype(jnp.uint32) << jnp.uint32(j))
    return w


def _unpack_bits_u32(words, L: int):
    """Inverse of _pack_bits_u32: (L//32,) uint32 -> (L,) uint8."""
    rep = jnp.repeat(words, 32)
    sh = jnp.tile(jnp.arange(32, dtype=jnp.uint32), L // 32)
    return (jax.lax.shift_right_logical(rep, sh) & jnp.uint32(1)).astype(
        jnp.uint8)


@partial(jax.jit, donate_argnums=(0,))
def _fills_from_dif(dif):
    """Bit-packed (fill_K, fill_R) uint32 words from the dual-lane
    boundary-delta vector — the scan-chunked, donating equivalent of
    ``_split_lanes(jnp.cumsum(dif[:n]))``: the running packed sum rides a
    scalar carry across 16M-element slices, and the fills come out as
    n/32 uint32 words per lane, so peak memory is the input (donated)
    plus n/4 bytes, where the uint8 form would be 2n bytes. Pad bits (>= n)
    are 0: every boundary pair's running net returns to 0 at its end
    position <= n. Slices come via dynamic_slice on the flat dif, with no
    reshaped copy of it."""
    S = dif.shape[0] // _LEAN_SLICE

    def step(carry, i):
        sl = jax.lax.dynamic_slice(dif, (i * _LEAN_SLICE,), (_LEAN_SLICE,))
        cs = jnp.cumsum(sl) + carry
        netK, netR = _split_lanes(cs)
        return cs[-1], (_pack_bits_u32((netK > 0).astype(jnp.uint8)),
                        _pack_bits_u32((netR > 0).astype(jnp.uint8)))

    _, (fK, fR) = jax.lax.scan(step, jnp.int32(0),
                               jnp.arange(S, dtype=jnp.int32))
    return fK.reshape(-1), fR.reshape(-1)


@partial(jax.jit, donate_argnums=(0, 1))
def _fills_from_dif_split(lo, hi):
    """_fills_from_dif over the (lo, hi) split delta vector (above 2^31
    entries): two scans share the running carry; fills concatenate.

    The slices come out of the FLAT pieces via dynamic_slice, with no
    reshaped copy of a piece."""

    def step_over(dif):
        def step(carry, i):
            sl = jax.lax.dynamic_slice(dif, (i * _LEAN_SLICE,),
                                       (_LEAN_SLICE,))
            cs = jnp.cumsum(sl) + carry[0]
            netK, netR = _split_lanes(cs)
            return (cs[-1],), (_pack_bits_u32((netK > 0).astype(jnp.uint8)),
                               _pack_bits_u32((netR > 0).astype(jnp.uint8)))
        return step

    Sl = lo.shape[0] // _LEAN_SLICE
    Sh = hi.shape[0] // _LEAN_SLICE
    (c,), (fKl, fRl) = jax.lax.scan(
        step_over(lo), (jnp.int32(0),), jnp.arange(Sl, dtype=jnp.int32))
    _, (fKh, fRh) = jax.lax.scan(
        step_over(hi), (c,), jnp.arange(Sh, dtype=jnp.int32))
    return (jnp.concatenate([fKl.reshape(-1), fKh.reshape(-1)]),
            jnp.concatenate([fRl.reshape(-1), fRh.reshape(-1)]))


@partial(jax.jit, donate_argnums=(0,))
def _fills_from_dif3(dif):
    """Tri-lane variant of _fills_from_dif (pair modes): K/R/DA fills."""
    S = dif.shape[0] // _LEAN_SLICE

    def step(carry, i):
        sl = jax.lax.dynamic_slice(dif, (i * _LEAN_SLICE,), (_LEAN_SLICE,))
        cs = jnp.cumsum(sl) + carry
        netK, netR, netD = _split_lanes3(cs)
        return cs[-1], (_pack_bits_u32((netK > 0).astype(jnp.uint8)),
                        _pack_bits_u32((netR > 0).astype(jnp.uint8)),
                        _pack_bits_u32((netD > 0).astype(jnp.uint8)))

    _, (fK, fR, fD) = jax.lax.scan(step, jnp.int32(0),
                                   jnp.arange(S, dtype=jnp.int32))
    return fK.reshape(-1), fR.reshape(-1), fD.reshape(-1)


@partial(jax.jit, donate_argnums=(0, 1))
def _fills_from_dif3_split(lo, hi):
    """Tri-lane fills over the (lo, hi) split delta vector (dynamic_slice
    over the flat pieces — see _fills_from_dif_split)."""

    def step_over(dif):
        def step(carry, i):
            sl = jax.lax.dynamic_slice(dif, (i * _LEAN_SLICE,),
                                       (_LEAN_SLICE,))
            cs = jnp.cumsum(sl) + carry[0]
            netK, netR, netD = _split_lanes3(cs)
            return (cs[-1],), (
                _pack_bits_u32((netK > 0).astype(jnp.uint8)),
                _pack_bits_u32((netR > 0).astype(jnp.uint8)),
                _pack_bits_u32((netD > 0).astype(jnp.uint8)))
        return step

    Sl = lo.shape[0] // _LEAN_SLICE
    Sh = hi.shape[0] // _LEAN_SLICE
    (c,), (fKl, fRl, fDl) = jax.lax.scan(
        step_over(lo), (jnp.int32(0),), jnp.arange(Sl, dtype=jnp.int32))
    _, (fKh, fRh, fDh) = jax.lax.scan(
        step_over(hi), (c,), jnp.arange(Sh, dtype=jnp.int32))
    return (jnp.concatenate([fKl.reshape(-1), fKh.reshape(-1)]),
            jnp.concatenate([fRl.reshape(-1), fRh.reshape(-1)]),
            jnp.concatenate([fDl.reshape(-1), fDh.reshape(-1)]))


def _fill_rows(fw, S: int):
    """Trim a packed fill vector to S slice-rows of Lp//32 words (the
    fills cover _lean_pad(n+1) bits, one slice more than _lean_pad(n)
    exactly when n is a slice multiple; bits >= n are 0 either way)."""
    W = S * (_LEAN_SLICE // 32)
    return (fw[:W] if fw.shape[0] != W else fw).reshape(
        S, _LEAN_SLICE // 32)


@partial(jax.jit, donate_argnums=(0, 1, 2), static_argnames=("n",))
def _combine_flags_lean(nf, fKw, fRw, *, n: int):
    """thr_K/thr_R/minima uint8 from packed nibble words + bit-packed
    leaf fills (_fills_from_dif), scan-chunked and donating (the eager
    unpack materializes an (n,) int32 — 4 GB at n=1G — before the ors)."""
    Lp = _LEAN_SLICE
    S = _lean_pad(n) // Lp
    words = jnp.zeros(S * Lp // 8, jnp.int32).at[: nf.shape[0]].set(nf)
    sh = (jnp.arange(8, dtype=jnp.int32) * 4)[None, :]

    def step(_, xs):
        w, fk, fr = xs
        pf = (jax.lax.shift_right_logical(w[:, None], sh) & 15).reshape(-1)
        thr_K = (((pf & 1) != 0) | (_unpack_bits_u32(fk, Lp) != 0)).astype(
            jnp.uint8)
        thr_R = (((pf & 2) != 0) | (_unpack_bits_u32(fr, Lp) != 0)).astype(
            jnp.uint8)
        minima = ((pf & 4) != 0).astype(jnp.uint8)
        return 0, (thr_K, thr_R, minima)

    _, (tK, tR, mi) = jax.lax.scan(
        step, 0,
        (words.reshape(S, Lp // 8), _fill_rows(fKw, S), _fill_rows(fRw, S)),
    )
    return tK.reshape(-1)[:n], tR.reshape(-1)[:n], mi.reshape(-1)[:n]


@partial(jax.jit, donate_argnums=(0, 1, 2, 3), static_argnames=("n",))
def _combine_flags_da_lean(nf, fKw, fRw, fDw, *, n: int):
    """Pair-mode variant of _combine_flags_lean: adds the DA lane."""
    Lp = _LEAN_SLICE
    S = _lean_pad(n) // Lp
    words = jnp.zeros(S * Lp // 8, jnp.int32).at[: nf.shape[0]].set(nf)
    sh = (jnp.arange(8, dtype=jnp.int32) * 4)[None, :]

    def step(_, xs):
        w, fk, fr, fd = xs
        pf = (jax.lax.shift_right_logical(w[:, None], sh) & 15).reshape(-1)
        return 0, (
            (((pf & 1) != 0) | (_unpack_bits_u32(fk, Lp) != 0)).astype(
                jnp.uint8),
            (((pf & 2) != 0) | (_unpack_bits_u32(fr, Lp) != 0)).astype(
                jnp.uint8),
            ((pf & 4) != 0).astype(jnp.uint8),
            (((pf & 8) != 0) | (_unpack_bits_u32(fd, Lp) != 0)).astype(
                jnp.uint8),
        )

    _, (tK, tR, mi, da) = jax.lax.scan(
        step, 0,
        (words.reshape(S, Lp // 8), _fill_rows(fKw, S), _fill_rows(fRw, S),
         _fill_rows(fDw, S)),
    )
    return (tK.reshape(-1)[:n], tR.reshape(-1)[:n], mi.reshape(-1)[:n],
            da.reshape(-1)[:n])


@partial(jax.jit, donate_argnums=(0,), static_argnames=("n",))
def _pad_nibble_words(nf, *, n: int):
    """Zero-pad the packed nibble words to whole lean slices."""
    S = _lean_pad(n) // _LEAN_SLICE
    return jnp.zeros(S * _LEAN_SLICE // 8, jnp.int32).at[: nf.shape[0]].set(
        nf)


@partial(jax.jit, donate_argnums=(1,), static_argnames=("bit", "n"))
def _combine_lane_packed(words, fw, *, bit: int, n: int):
    """One flag lane of the huge-n combine: BIT-PACKED output words
    ((4*ceil(n/128),) uint32, the ops.bits.bv_build layout) from the
    padded nibble words OR'd with a bit-packed fill vector. One scan per
    lane: a fused 3-lane formulation faulted a device at ~2.6G positions
    on an earlier backend, and per-lane scans also shrink the live set."""
    Lp = _LEAN_SLICE
    S = _lean_pad(n) // Lp
    WFS = S * Lp // 32
    f = jnp.zeros(WFS, jnp.uint32).at[: min(fw.shape[0], WFS)].set(
        fw[:WFS] if fw.shape[0] > WFS else fw)
    sh = (jnp.arange(8, dtype=jnp.int32) * 4)[None, :]

    def step(_, i):
        w = jax.lax.dynamic_slice(words, (i * (Lp // 8),), (Lp // 8,))
        fx = jax.lax.dynamic_slice(f, (i * (Lp // 32),), (Lp // 32,))
        pf = (jax.lax.shift_right_logical(w[:, None], sh) & 15).reshape(-1)
        b = ((pf & bit) != 0) | (_unpack_bits_u32(fx, Lp) != 0)
        return 0, _pack_bits_u32(b.astype(jnp.uint8))

    _, out = jax.lax.scan(step, 0, jnp.arange(S, dtype=jnp.int32))
    W = 4 * (-(-n // 128))
    return out.reshape(-1)[:W]


@partial(jax.jit, static_argnames=("bit", "n"))
def _extract_lane_packed(words, *, bit: int, n: int):
    """_combine_lane_packed without a fill vector (the minima lane)."""
    Lp = _LEAN_SLICE
    S = _lean_pad(n) // Lp
    sh = (jnp.arange(8, dtype=jnp.int32) * 4)[None, :]

    def step(_, i):
        w = jax.lax.dynamic_slice(words, (i * (Lp // 8),), (Lp // 8,))
        pf = (jax.lax.shift_right_logical(w[:, None], sh) & 15).reshape(-1)
        return 0, _pack_bits_u32(((pf & bit) != 0).astype(jnp.uint8))

    _, out = jax.lax.scan(step, 0, jnp.arange(S, dtype=jnp.int32))
    W = 4 * (-(-n // 128))
    return out.reshape(-1)[:W]


def _combine_flags_lean_packed(nf, fKw, fRw, *, n: int):
    """Huge-n combine: emits BIT-PACKED thr_K/thr_R/minima words
    ((4*ceil(n/128),) uint32 each — the ops.bits.bv_build layout, so the
    right-anchor table and the cluster extractor consume them directly)
    instead of (n,) uint8 vectors: the uint8 outputs alone are 3n
    bytes (7.9 GB at ~2.6G positions), packed they are 3n/8 (1.0 GB). Pad bits (>= n) are 0
    (nf pad nibbles and fill pad bits are never written). Runs as one
    scan per lane — see _combine_lane_packed."""
    words = _pad_nibble_words(nf, n=n)
    thr_K = _combine_lane_packed(words, fKw, bit=1, n=n)
    thr_R = _combine_lane_packed(words, fRw, bit=2, n=n)
    minima = _extract_lane_packed(words, bit=4, n=n)
    return thr_K, thr_R, minima


def _combine_flags_da_lean_packed(nf, fKw, fRw, fDw, *, n: int):
    """Pair-mode variant of _combine_flags_lean_packed: adds the DA lane."""
    words = _pad_nibble_words(nf, n=n)
    thr_K = _combine_lane_packed(words, fKw, bit=1, n=n)
    thr_R = _combine_lane_packed(words, fRw, bit=2, n=n)
    minima = _extract_lane_packed(words, bit=4, n=n)
    da = _combine_lane_packed(words, fDw, bit=8, n=n)
    return thr_K, thr_R, minima, da


def navigate_one_bwt(fm: FMIndex, K: int, k_right: int) -> TraversalResult:
    """Full single-BWT navigation (reference: navigate_one_bwt,
    ebwt2InDel.cpp:555-676): leaf phase then node phase, each a single
    compiled device program."""
    n = fm.n

    import os
    import time as _time

    timing = os.environ.get("EBWT_TIMING")
    lean = n >= _LEAN_N
    t0 = _time.perf_counter()
    dif_n = _lean_pad(n + 1) if lean else n + 1
    # above 2^31 entries the delta vector splits into a (lo, hi) pair of
    # 1-D arrays (s32 scatter indices cannot address a longer axis;
    # ops/coords.py — reference coordinates are uint64 end-to-end,
    # include.hpp:25). EBWT_FORCE_HUGE_DIF=1 forces the split (and the
    # packed-flag combine) at small n for tests.
    huge = dif_n >= 2**31 or (
        lean and os.environ.get("EBWT_FORCE_HUGE_DIF") == "1")
    if huge:
        lo_n = min(dif_n, _SPLIT)
        hi_n = max(dif_n - _SPLIT, _LEAN_SLICE)  # >= one slice for tests
        dif_factory = lambda: (jnp.zeros(lo_n, dtype=jnp.int32),  # noqa: E731
                               jnp.zeros(hi_n, dtype=jnp.int32))
    else:
        dif_factory = lambda: (jnp.zeros(dif_n, dtype=jnp.int32),)  # noqa: E731
    difs, st_l, maxp_l = _run_phase(
        (fm,), fm.first_leaf()[None, :], dif_factory, _leaf_body, n, K,
        k_right,
    )
    dif = difs[0] if len(difs) == 1 else None
    if int(st_l[2]) >= _LANE_SAFE_DEPTH:
        if n >= 2**30 - 8:
            raise RuntimeError(
                "input has suffix-tree leaves deeper than "
                f"{_LANE_SAFE_DEPTH} at n >= 2^30: the int32-per-field "
                "delta layout cannot address 2*(n+1) entries; split the "
                "input (tools.pebwt2indel)"
            )
        # per-position net counts may exceed the 16-bit lane: rerun with
        # the int32-per-field program (first compile happens only here)
        (dif,), st_l, maxp_l = _run_phase(
            (fm,), fm.first_leaf()[None, :],
            lambda: (jnp.zeros(2 * (n + 1), dtype=jnp.int32),),
            _leaf_body_wide, n, K, k_right,
        )
        fill_K = jnp.cumsum(dif[:n]) > 0
        fill_R = jnp.cumsum(dif[n + 1: n + 1 + n]) > 0
    elif huge:
        fill_K, fill_R = _fills_from_dif_split(*difs)
        del difs, dif
    elif lean:
        # scan-chunked, dif-donating, bit-packed fills: the eager form
        # holds dif + cumsum + both lanes at once
        fill_K, fill_R = _fills_from_dif(dif)
        del dif
    else:
        # one packed cumsum then the carry-aware lane split (exact under
        # the same running-net bound that guards the scatter packing)
        netK, netR = _split_lanes(jnp.cumsum(dif[:n]))
        fill_K, fill_R = netK > 0, netR > 0
    if timing:
        np.asarray(fill_K[:1])
        print(f"[timing] leaf phase: {_time.perf_counter() - t0:.2f}s",
              flush=True)
        t0 = _time.perf_counter()
    (nf,), st_n, maxp_n = _run_phase(
        (fm,), fm.root()[None, :],
        lambda: (jnp.zeros(_flag_words(n), dtype=jnp.int32),), _node_body,
        n, K, k_right,
    )
    if timing:
        np.asarray(nf[:1])
        print(f"[timing] node phase: {_time.perf_counter() - t0:.2f}s",
              flush=True)

    stats = {
        # device counters wrap mod 2^32; every true count is <= n < 2^32
        "leaves": unpat(st_l[0]), "nodes": unpat(st_n[0]),
        "lcp_values": 1 + unpat(st_l[1]) + unpat(st_n[1]),
        "n_min": unpat(st_n[2]),
        "max_pending": max(maxp_l, maxp_n),
    }
    if huge and int(st_l[2]) < _LANE_SAFE_DEPTH:
        thr_K, thr_R, minima = _combine_flags_lean_packed(
            nf, fill_K, fill_R, n=n)
        return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                               da=None, stats=stats, packed=True)
    if lean and int(st_l[2]) < _LANE_SAFE_DEPTH:
        thr_K, thr_R, minima = _combine_flags_lean(nf, fill_K, fill_R, n=n)
        return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                               da=None, stats=stats)
    pf = _unpack_flags(nf, n)
    thr_K = ((pf & 1) != 0) | fill_K
    thr_R = ((pf & 2) != 0) | fill_R
    minima = ((pf & 4) != 0).astype(jnp.uint8)
    return TraversalResult(thr_K=thr_K.astype(jnp.uint8),
                           thr_R=thr_R.astype(jnp.uint8), minima=minima,
                           da=None, stats=stats)


def navigate_two_bwts(fm1: FMIndex, fm2: FMIndex, K: int,
                      k_right: int) -> TraversalResult:
    """Lockstep navigation of two suffix trees simulating the merged
    collection (reference: navigate_two_bwts, ebwt2InDel.cpp:679-831)."""
    n = fm1.n + fm2.n

    import os
    import time as _time

    timing = os.environ.get("EBWT_TIMING")
    t0 = _time.perf_counter()
    l1 = fm1.first_leaf()
    l2 = fm2.first_leaf()
    lean = n >= _LEAN_N
    start = np.array([[l1[0], l1[1], l2[0], l2[1], 0]], dtype=np.int32)
    dif_n = _lean_pad(n + 1) if lean else n + 1
    huge = dif_n >= 2**31 or (  # see navigate_one_bwt / _dif_scatter
        lean and os.environ.get("EBWT_FORCE_HUGE_DIF") == "1")
    if huge:
        lo_n = min(dif_n, _SPLIT)
        hi_n = max(dif_n - _SPLIT, _LEAN_SLICE)
        dif_factory = lambda: (jnp.zeros(lo_n, dtype=jnp.int32),  # noqa: E731
                               jnp.zeros(hi_n, dtype=jnp.int32))
    else:
        dif_factory = lambda: (jnp.zeros(dif_n, dtype=jnp.int32),)  # noqa: E731
    difs, st_l, maxp_l = _run_phase(
        (fm1, fm2), start, dif_factory, _leaf_pair_body3, n, K, k_right,
    )
    dif = difs[0] if len(difs) == 1 else None
    if huge and int(st_l[2]) >= _LANE3_SAFE_DEPTH:
        raise RuntimeError(
            "input has suffix-tree leaves deeper than "
            f"{_LANE3_SAFE_DEPTH} at n >= 2^31: the multi-area delta "
            "layouts cannot address k*(n+1) entries; split the input "
            "(tools.pebwt2indel)"
        )
    # one packed cumsum then a carry-aware lane split: exact while the
    # RUNNING per-position net counts respect the lane bounds — the same
    # max-depth bound that guards the scatter packing itself
    if huge:
        fill_K, fill_R, fill_D = _fills_from_dif3_split(*difs)
        del difs, dif
    elif lean and int(st_l[2]) < _LANE3_SAFE_DEPTH:
        fill_K, fill_R, fill_D = _fills_from_dif3(dif)
        del dif
    elif int(st_l[2]) < _LANE3_SAFE_DEPTH:
        netK, netR, netD = _split_lanes3(jnp.cumsum(dif[:n]))
        fill_K, fill_R, fill_D = netK > 0, netR > 0, netD > 0
    elif int(st_l[2]) < _LANE_SAFE_DEPTH:
        # deep input: rerun with the dual-lane + DA-area layout
        (dif,), st_l, maxp_l = _run_phase(
            (fm1, fm2), start,
            lambda: (jnp.zeros(2 * (n + 1), dtype=jnp.int32),),
            _leaf_pair_body, n, K, k_right,
        )
        netK, netR = _split_lanes(jnp.cumsum(dif[:n]))
        fill_K, fill_R = netK > 0, netR > 0
        fill_D = jnp.cumsum(dif[n + 1: n + 1 + n]) > 0
    else:
        # pathological depth: int32-per-field layout
        (dif,), st_l, maxp_l = _run_phase(
            (fm1, fm2), start,
            lambda: (jnp.zeros(3 * (n + 1), dtype=jnp.int32),),
            _leaf_pair_body_wide, n, K, k_right,
        )
        fill_K = jnp.cumsum(dif[:n]) > 0
        fill_R = jnp.cumsum(dif[n + 1: n + 1 + n]) > 0
        fill_D = jnp.cumsum(dif[2 * (n + 1): 2 * (n + 1) + n]) > 0
    if timing:
        np.asarray(fill_K[:1])
        print(f"[timing] leaf-pair phase: {_time.perf_counter() - t0:.2f}s",
              flush=True)
        t0 = _time.perf_counter()

    r1 = fm1.root()
    r2 = fm2.root()
    start = np.concatenate([r1[:6], r2[:6], [0]]).astype(np.int32)[None, :]
    (nf,), st_n, maxp_n = _run_phase(
        (fm1, fm2), start,
        lambda: (jnp.zeros(_flag_words(n), dtype=jnp.int32),),
        _node_pair_body, n, K, k_right,
    )
    if timing:
        np.asarray(nf[:1])
        print(f"[timing] node-pair phase: {_time.perf_counter() - t0:.2f}s",
              flush=True)

    stats = {
        # device counters wrap mod 2^32; every true count is <= n < 2^32
        "leaves": unpat(st_l[0]), "nodes": unpat(st_n[0]),
        "lcp_values": 1 + unpat(st_l[1]) + unpat(st_n[1]),
        "n_min": unpat(st_n[2]),
        "da_values": unpat(st_l[3]) + unpat(st_n[3]),
        "max_pending": max(maxp_l, maxp_n),
    }
    if huge and int(st_l[2]) < _LANE3_SAFE_DEPTH:
        thr_K, thr_R, minima, da = _combine_flags_da_lean_packed(
            nf, fill_K, fill_R, fill_D, n=n
        )
        return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                               da=da, stats=stats, packed=True)
    if lean and int(st_l[2]) < _LANE3_SAFE_DEPTH:
        thr_K, thr_R, minima, da = _combine_flags_da_lean(
            nf, fill_K, fill_R, fill_D, n=n
        )
        return TraversalResult(thr_K=thr_K, thr_R=thr_R, minima=minima,
                               da=da, stats=stats)
    pf = _unpack_flags(nf, n)
    thr_K = ((pf & 1) != 0) | fill_K
    thr_R = ((pf & 2) != 0) | fill_R
    minima = ((pf & 4) != 0).astype(jnp.uint8)
    da = ((pf & 8) != 0) | fill_D
    return TraversalResult(thr_K=thr_K.astype(jnp.uint8),
                           thr_R=thr_R.astype(jnp.uint8), minima=minima,
                           da=da.astype(jnp.uint8), stats=stats)
