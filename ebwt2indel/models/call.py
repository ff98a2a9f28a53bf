"""Batched per-cluster variant analysis: base counts, consensus left-context
extraction, and right-context extraction.

Device reformulation of the reference's per-cluster routines
(find_variants ×3, ebwt2InDel.cpp:840-1096; extract_consensus, 243-319;
extract_dna, 325-342): all clusters (and all 4 candidate characters) advance
their backward/forward walks in lockstep — fixed trip counts k_left / k_right
with masked early exit, so the whole calling phase is a handful of jitted
dispatches regardless of cluster count.

Parity quirks preserved:
* base counts use base_to_int, which maps TERM to 'A' (include.hpp:275-289's
  default case), so terminators inside a cluster inflate the A count;
* consensus tie-breaks prefer A<C<G<T on equal counts (the reference's
  4-element std::sort is an insertion sort, hence stable; cpp:252-255) —
  argmax picks the first maximum, matching;
* a left context shorter than k_left is discarded (cpp:317);
* support = number of occurrences of the starting character in the cluster
  range (cpp:310), excluding TERM.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.coords import ult
from . import fm_index as fm_ops
from .fm_index import FMIndex


def range_counts_core(parallel_rank, begins, ends):
    """Body of range_counts, parametrized by the rank primitive so the
    single-device and sharded (psum-combined) paths share it."""
    pure = parallel_rank(ends) - parallel_rank(begins)  # (B, 4)
    n_term = (ends - begins) - pure.sum(axis=-1)
    quirk = pure.at[..., 0].add(n_term)
    return quirk, pure


@partial(jax.jit, static_argnames=())
def range_counts(fm: FMIndex, begins, ends):
    """Counts of A,C,G,T in BWT[begin:end) with the TERM->A quirk.

    Also returns the pure (quirk-free) ACGT counts used as supports.
    """
    return range_counts_core(
        lambda i: fm_ops.parallel_rank(fm, i), begins, ends
    )


def consensus_core(lf_range, begins, ends, k_left: int):
    """Body of extract_consensus_batch, parametrized by the range-extension
    primitive so the single-device (fm_ops.lf_range) and sharded
    (psum-combined) paths share one implementation.
    Mirrors extract_consensus (ebwt2InDel.cpp:243-319).
    """
    B = begins.shape[0]
    # start: R = LF(range, c) for each c — one parallel rank pair
    lo4, hi4 = lf_range(begins, ends)  # (B,4)
    support = hi4 - lo4

    ctx = jnp.zeros((B, 4, k_left), dtype=jnp.int8)
    ctx = ctx.at[:, :, 0].set(jnp.arange(4, dtype=jnp.int8)[None, :])
    alive = support > 0  # empty start range -> consensus stops after char 0
    length = jnp.ones((B, 4), dtype=jnp.int32)  # start char always present

    lo = lo4.reshape(B * 4)
    hi = hi4.reshape(B * 4)
    alive = alive.reshape(B * 4)
    length = length.reshape(B * 4)
    ctx = ctx.reshape(B * 4, k_left)

    def body(step, state):
        lo, hi, alive, length, ctx = state
        l4, h4 = lf_range(lo, hi)
        cnt = h4 - l4  # (B4, 4)
        best = jnp.argmax(cnt, axis=-1)  # first max -> A<C<G<T tie-break
        bc = jnp.take_along_axis(cnt, best[:, None], axis=-1)[:, 0]
        step_alive = alive & (bc > 0)
        nlo = jnp.take_along_axis(l4, best[:, None], axis=-1)[:, 0]
        nhi = jnp.take_along_axis(h4, best[:, None], axis=-1)[:, 0]
        lo = jnp.where(step_alive, nlo, lo)
        hi = jnp.where(step_alive, nhi, hi)
        ctx = ctx.at[jnp.arange(ctx.shape[0]), step].set(
            jnp.where(step_alive, best.astype(jnp.int8), ctx[:, step])
        )
        length = jnp.where(step_alive, length + 1, length)
        return lo, hi, step_alive, length, ctx

    lo, hi, alive, length, ctx = jax.lax.fori_loop(
        1, k_left, body, (lo, hi, alive, length, ctx)
    )
    # context was built variant-first; reverse to genomic order
    ctx = ctx[:, ::-1]
    full = length == k_left
    return (ctx.reshape(B, 4, k_left), support,
            full.reshape(B, 4))


@partial(jax.jit, static_argnames=("k_left",))
def extract_consensus_batch(fm: FMIndex, begins, ends, *, k_left: int):
    """For every cluster and every c in {A,C,G,T}: the consensus left context
    of length k_left ending with c, its support, and a validity flag.

    Returns (ctx (B,4,k_left) int8 codes, support (B,4) int32,
    full (B,4) bool — context reached full length).
    Mirrors extract_consensus (ebwt2InDel.cpp:243-319); body in
    consensus_core, shared with the sharded path.
    """
    return consensus_core(
        lambda lo, hi: fm_ops.lf_range(fm, lo, hi), begins, ends, k_left
    )


def extract_dna_core(f_char_fn, fl_fn, starts, active, k_right: int):
    """Body of extract_dna_batch, parametrized by the F-access and FL
    primitives so the single-device and sharded (psum-combined select)
    paths share it."""
    B = starts.shape[0]
    seq = jnp.zeros((B, k_right), dtype=jnp.int8)
    length = jnp.zeros(B, dtype=jnp.int32)

    def body(step, state):
        i, alive, length, seq = state
        c = f_char_fn(i)
        step_alive = alive & (c != 4)
        seq = seq.at[:, step].set(
            jnp.where(step_alive, c.astype(jnp.int8), seq[:, step])
        )
        length = jnp.where(step_alive, length + 1, length)
        nxt = fl_fn(jnp.where(step_alive, i, 0))
        i = jnp.where(step_alive, nxt, i)
        return i, step_alive, length, seq

    _, _, length, seq = jax.lax.fori_loop(
        0, k_right, body, (starts, active, length, seq)
    )
    return seq, length


@partial(jax.jit, static_argnames=("k_right",))
def extract_dna_batch(fm: FMIndex, starts, active, *, k_right: int):
    """Forward extraction of up to k_right characters starting at F position
    ``starts``; stops at TERM (extract_dna, ebwt2InDel.cpp:325-342).

    Returns (seq (B, k_right) int8 codes, length (B,) int32).
    """
    return extract_dna_core(
        lambda i: fm_ops.f_char(fm, i), lambda i: fm_ops.fl(fm, i),
        starts, active, k_right,
    )


@jax.jit
def next_set_table(thr_R_dev):
    """next_set[i] = smallest j >= i with thr_R[j] set (n if none) — one
    reverse cumulative-min scan on device. Replaces the host-side
    flatnonzero+searchsorted for the right-context anchor search."""
    n = thr_R_dev.shape[0]
    idx = jnp.where(thr_R_dev != 0, jnp.arange(n, dtype=jnp.int32),
                    jnp.int32(n))
    return jax.lax.cummin(idx, reverse=True)


def right_anchor_table(thr_R_dev):
    """Right-context anchor structure, size-dispatched: the (n,) int32
    cummin table below the lean threshold (one fused scan, fastest), or
    the packed-bitvector + per-block next-set table above it — O(n/8 +
    n/32) bytes instead of 4n (the cummin table alone is 4 GB at
    n=1G)."""
    from . import traverse

    if thr_R_dev.shape[0] < traverse._LEAN_N:
        return next_set_table(thr_R_dev)
    from ..ops import bits

    words, _ = bits.bv_build(thr_R_dev)
    return _anchor_from_words(words, n=thr_R_dev.shape[0])


@partial(jax.jit, static_argnames=("n",))
def _anchor_from_words(words, *, n: int):
    """(words, T): per-block next-set table T[b] = smallest set position
    >= 128*b (n if none), T has nb+1 entries (T[nb] = n). words is the
    FLAT (nb*4,) layout of ops.bits.bv_build; all intermediates stay 1-D
    (see ops.bits.bv_build)."""
    from ..ops.coords import pat32, ucummin_rev, umin

    nb = words.shape[0] // 4
    low = words & (~words + jnp.uint32(1))  # lowest set bit per word
    bitidx = jax.lax.population_count(low - jnp.uint32(1)).astype(jnp.int32)
    fiw = jnp.where(words != 0, bitidx, jnp.int32(1) << 30)
    # min over each block's 4 words, offsetting word slot w by 32*w
    first = jnp.minimum(
        jnp.minimum(fiw[0::4], fiw[1::4] + 32),
        jnp.minimum(fiw[2::4] + 64, fiw[3::4] + 96),
    )  # (nb,) 0..127 or >= 2^30
    # positions are unsigned bit patterns: the no-set sentinel is the
    # pattern of n (> every real position) and the scans are unsigned
    n_pat = jnp.int32(pat32(n))
    blk_first = jnp.where(
        first < (1 << 30),
        jnp.arange(nb, dtype=jnp.int32) * 128 + first, n_pat,
    )
    T = umin(ucummin_rev(blk_first), n_pat)
    return words, jnp.concatenate([T, jnp.full(1, pat32(n), jnp.int32)])


def right_anchor_table_packed(thr_R_words, *, n: int):
    """Anchor structure straight from bit-packed thr_R words (the huge-n
    TraversalResult.packed layout) — no bv_build pass, no (n,) uint8
    vector ever materializes."""
    W = 4 * (-(-n // 128))
    w = thr_R_words[:W] if thr_R_words.shape[0] != W else thr_R_words
    return _anchor_from_words(w, n=n)


def first_thr_position_device(next_set, begins_dev, ends_dev):
    """Device variant of first_thr_position: returns (pos, found) device
    arrays for the given cluster ranges. Accepts either anchor structure
    from right_anchor_table (the dense cummin table, or the packed
    (words, T) pair — one word-row gather + in-block lowest-set-bit per
    query, falling to T[b+1] when the rest of the block is empty)."""
    if isinstance(next_set, tuple):
        from ..ops.rank import _bv_row

        words, T = next_set
        b = jax.lax.shift_right_logical(begins_dev, 7)
        o = begins_dev & jnp.int32(127)
        row = _bv_row(words, b)  # (B, 4)
        w4 = jnp.arange(4, dtype=jnp.int32)[None, :]
        start = jnp.clip(o[:, None] - w4 * 32, 0, 32)
        sh = jnp.minimum(start, 31).astype(jnp.uint32)
        below = jnp.where(start == 32, jnp.uint32(0xFFFFFFFF),
                          (jnp.uint32(1) << sh) - jnp.uint32(1))
        m = row & ~below
        low = m & (~m + jnp.uint32(1))
        bitidx = jax.lax.population_count(
            low - jnp.uint32(1)).astype(jnp.int32)
        fiw = jnp.where(m != 0, bitidx + w4 * 32, jnp.int32(1) << 30)
        off = jnp.min(fiw, axis=1)
        pos = jnp.where(off < (1 << 30), b * 128 + off, T[b + 1])
        found = ult(pos, ends_dev)  # unsigned: positions past 2^31
        return jnp.where(found, pos, 0), found
    pos = next_set[begins_dev]
    found = ult(pos, ends_dev)
    return jnp.where(found, pos, 0), found


def first_thr_position(thr_R: np.ndarray, begins: np.ndarray,
                       ends: np.ndarray):
    """For each cluster the first position i in [begin, end) with
    LCP_threshold[2i+1] set (the right-context anchor; cpp:979-985).

    Returns (pos (B,) int64, found (B,) bool). Host-side: one sorted-search
    over the set positions.
    """
    set_pos = np.flatnonzero(thr_R)
    k = np.searchsorted(set_pos, begins, side="left")
    k = np.minimum(k, max(len(set_pos) - 1, 0))
    if len(set_pos) == 0:
        return np.zeros_like(begins), np.zeros(len(begins), dtype=bool)
    cand = set_pos[k]
    found = (cand >= begins) & (cand < ends)
    return np.where(found, cand, 0), found
