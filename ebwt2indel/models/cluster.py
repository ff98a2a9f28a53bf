"""Phase 4 — positional clustering over the LCP flag vectors.

The reference scans positions sequentially, opening a cluster while
``LCP_threshold[2i] and not LCP_minima[i]`` holds and closing it at the first
position where it fails (reference: run_one_dataset, ebwt2InDel.cpp:1609-1655;
run_two_datasets, 1395-1429; run_two_datasets_da, 1510-1560). We compute the
mask on device and extract maximal runs vectorized.

Parity notes (quirks preserved):
* a run still open at the last position i = n-1 is never closed, hence never
  analyzed nor histogrammed (the loop ends without a close, cpp:1609-1655);
* the histogram records clusters of *any* closed length (CLUST_SIZES[len] +=
  len for len <= 200), while only clusters with len >= 2*mcov_out are analyzed.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

MAX_CLUST_LEN = 200  # histogram cap (ebwt2InDel.cpp:1388)


@dataclasses.dataclass
class Clusters:
    begins: np.ndarray | jax.Array  # (B,) — cluster start (inclusive)
    ends: np.ndarray | jax.Array  # (B,) — cluster end (exclusive)
    n_clusters: int  # number of analyzed clusters (len >= 2*mcov_out)
    clust_size_sum: int  # cumulative length over *all closed* clusters
    n_closed: int  # number of closed clusters (for average length: ref divides
    # clust_size by n_clusters — see pipeline)
    hist: np.ndarray  # (201,) int64 — CLUST_SIZES


def cluster_mask(thr_K: np.ndarray, minima: np.ndarray) -> np.ndarray:
    return (thr_K != 0) & (minima == 0)


def find_clusters(thr_K: np.ndarray, minima: np.ndarray, mcov_out: int) -> Clusters:
    return find_clusters_from_mask(cluster_mask(thr_K, minima), mcov_out)


def find_clusters_from_mask(mask: np.ndarray, mcov_out: int) -> Clusters:
    n = mask.shape[0]
    if n == 0:
        return Clusters(
            begins=np.zeros(0, np.int64), ends=np.zeros(0, np.int64),
            n_clusters=0, clust_size_sum=0, n_closed=0,
            hist=np.zeros(MAX_CLUST_LEN + 1, np.int64),
        )
    m = mask.astype(bool)
    edges = np.flatnonzero(m[1:] != m[:-1]) + 1
    if m[0]:
        starts = np.concatenate([[0], edges[1::2]])
        stops = edges[0::2]
    else:
        starts = edges[0::2]
        stops = edges[1::2]
    # a run reaching the end is never closed by the reference scan — drop it
    starts = starts[: len(stops)]
    lens = stops - starts

    small = lens[lens <= MAX_CLUST_LEN]
    hist = np.bincount(small, weights=small,
                       minlength=MAX_CLUST_LEN + 1).astype(np.int64)
    hist = hist[: MAX_CLUST_LEN + 1]

    analyzed = lens >= 2 * mcov_out
    return Clusters(
        begins=starts[analyzed].astype(np.int64),
        ends=stops[analyzed].astype(np.int64),
        n_clusters=int(analyzed.sum()),
        clust_size_sum=int(lens.sum()),
        n_closed=int(len(lens)),
        hist=hist,
    )


# ---------------------------------------------------------------------------
# device-side cluster detection — keeps begins/ends on device (no O(n) flag
# transfer, no host scan); used by the mode-1 hot path
# ---------------------------------------------------------------------------


@jax.jit
def _run_marks(thr_K_dev, minima_dev):
    mask = (thr_K_dev != 0) & (minima_dev == 0)
    prev = jnp.concatenate([jnp.zeros(1, bool), mask[:-1]])
    nxt = jnp.concatenate([mask[1:], jnp.zeros(1, bool)])
    is_start = mask & ~prev
    end_at = (mask & ~nxt).at[-1].set(False)  # a run reaching n-1 never
    # closes (reference scan quirk, ebwt2InDel.cpp:1609-1655)
    return is_start, end_at, is_start.sum(dtype=jnp.int32), \
        end_at.sum(dtype=jnp.int32)


def _cap(n: int) -> int:
    c = 1 << 12
    while c < n:
        c *= 2
    return c


def runs_to_clusters(starts, ends, n_ends, *, cap, mcov_out):
    """Pair the k-th run start with the k-th run end (runs are disjoint, so
    sorted starts/ends alternate), histogram closed runs, and compact the
    analyzed (len >= 2*mcov_out) subset. starts/ends: (cap,) int32 sorted
    by position; reused by the sharded cluster enumeration."""
    k = jnp.arange(cap, dtype=jnp.int32)
    closed = k < n_ends  # drops the unclosed trailing start, if any
    lens = jnp.where(closed, ends - starts, 0)

    small = closed & (lens <= MAX_CLUST_LEN)
    hist = jnp.zeros(MAX_CLUST_LEN + 1, jnp.int32).at[
        jnp.where(small, lens, 0)
    ].add(jnp.where(small, lens, 0))
    clust_size_sum = lens.sum(dtype=jnp.int32)

    analyzed = closed & (lens >= 2 * mcov_out)
    # multi-operand sort compaction: analyzed rows keep their rank-order
    # key, dropped rows sort after them; begins/ends ride along as payload
    key = jnp.where(analyzed, k, cap + k)
    _, a_begins, a_ends = jax.lax.sort((key, starts, ends), num_keys=1)
    return (a_begins, a_ends, analyzed.sum(dtype=jnp.int32), hist,
            clust_size_sum)


@partial(jax.jit, static_argnames=("cap", "mcov_out"))
def _extract_runs(is_start, end_at, n_ends, *, cap, mcov_out):
    """Positions of the run-start/run-end marks via sort compaction:
    marked positions keep their own value as key, unmarked become
    n + pos and sort after every mark; the first `cap` sorted entries are
    the mark positions in order: one sort in place of a cumsum+scatter
    compaction or bv_select's per-output binary search.
    EBWT_CLUSTER_EXTRACT=select keeps the select formulation for A/B."""
    n = is_start.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)

    def compact(m):
        key = jax.lax.sort(jnp.where(m, pos, n + pos), is_stable=False)
        if cap <= n:
            return key[:cap]
        return jnp.concatenate(
            [key, jnp.full(cap - n, 2 * n, jnp.int32)]
        )  # pad rows are garbage; masked by closed = k < n_ends

    starts = compact(is_start)
    ends = compact(end_at) + 1
    return runs_to_clusters(starts, ends, n_ends, cap=cap, mcov_out=mcov_out)


@partial(jax.jit, static_argnames=("cap", "mcov_out"))
def _extract_runs_select(is_start, end_at, n_ends, *, cap, mcov_out):
    """bv_select formulation of _extract_runs (A/B knob): gather-only,
    O(cap * log2(n_blocks)); loses at genome scale because cap is a large
    fraction of n. Entries beyond the mark counts are garbage and are
    masked by runs_to_clusters (closed = k < n_ends)."""
    from ..ops import bits as bits_ops
    from ..ops import rank as rank_ops

    sw, sc = bits_ops.bv_build(is_start.astype(jnp.uint8))
    ew, ec = bits_ops.bv_build(end_at.astype(jnp.uint8))
    k = jnp.arange(cap, dtype=jnp.int32)
    starts = rank_ops.bv_select(sw, sc, k)
    ends = rank_ops.bv_select(ew, ec, k) + 1
    return runs_to_clusters(starts, ends, n_ends, cap=cap, mcov_out=mcov_out)


@partial(jax.jit, donate_argnums=(0, 1))
def _run_marks_lean(thr_K_dev, minima_dev):
    """Memory-lean _run_marks: one (n,) uint8 cluster mask plus the
    start/end counts — no is_start/end_at vectors (2 x n bool extra next
    to the flag vectors; the marks are
    recomputed slice-wise inside _extract_runs_masked). Inputs donated:
    thr_K/minima have no consumer after cluster detection."""
    mask = ((thr_K_dev != 0) & (minima_dev == 0)).astype(jnp.uint8)
    prev = jnp.concatenate([jnp.zeros(1, jnp.uint8), mask[:-1]])
    n_starts = jnp.sum((mask & (1 - prev)).astype(jnp.int32))
    # a run reaching n-1 never closes (reference scan quirk,
    # ebwt2InDel.cpp:1609-1655): count ends over i <= n-2 only
    n_ends = jnp.sum((mask[:-1] & (1 - mask[1:])).astype(jnp.int32))
    return mask, n_starts, n_ends


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("cap", "mcov_out", "n"))
def _extract_runs_masked(mask, n_ends, *, cap, mcov_out, n):
    """Run extraction straight from the cluster mask: per-slice start/end
    marks are derived with a one-bit carry (prev slice's last mask bit),
    then sort-compacted into the cap buffers at running offsets — the
    only O(n) allocation is the padded mask copy (donated input freed).
    Emitted values: starts = first run position, ends = one past the
    last (the begin/end+1 convention of runs_to_clusters)."""
    from ..ops.coords import pat32
    from .traverse import _LEAN_SLICE

    L = _LEAN_SLICE
    S = -(-n // L)
    B = L // 16
    # every real mark value is <= n-1; S*L >= n sorts after all of them
    INF = jnp.int32(pat32(S * L))
    n_pat = jnp.int32(pat32(n))
    mp = jnp.zeros(S * L, jnp.uint8).at[:n].set(mask)
    sbuf = jnp.zeros(cap + L, jnp.int32)
    ebuf = jnp.zeros(cap + L, jnp.int32)

    def write(buf, keys, cnt, m):
        def wcond(st):
            return st[0] * B < m

        def wstep(st):
            it, bf = st
            sl = jax.lax.dynamic_slice(keys, (it * B,), (B,))
            bf = jax.lax.dynamic_update_slice(bf, sl, (cnt + it * B,))
            return it + 1, bf

        return jax.lax.while_loop(wcond, wstep, (jnp.int32(0), buf))[1]

    def upsort(m, p):
        # positions are unsigned bit patterns (ops.coords): sort the
        # uint32 view so slices past 2^31 keep position order and the
        # INF sentinel (> every real position) sinks last
        key = jnp.where(m, p, INF).astype(jnp.uint32)
        return jax.lax.sort(key, is_stable=False).astype(jnp.int32)

    def step(carry, xs):
        prev_bit, cnt_s, cnt_e, sbuf, ebuf = carry
        m, base = xs
        pos = base + jnp.arange(L, dtype=jnp.int32)
        prev = jnp.concatenate([prev_bit[None], m[:-1]])
        m_s = (m != 0) & (prev == 0)
        # an end mark at position p means the run's last position is
        # p-1; p == n is the run reaching n-1, which never closes
        m_e = (m == 0) & (prev != 0) & (pos != n_pat)
        key_s = upsort(m_s, pos)
        key_e = upsort(m_e, pos)
        c_s = jnp.sum(m_s.astype(jnp.int32))
        c_e = jnp.sum(m_e.astype(jnp.int32))
        sbuf = write(sbuf, key_s, cnt_s, c_s)
        ebuf = write(ebuf, key_e, cnt_e, c_e)
        return (m[-1], cnt_s + c_s, cnt_e + c_e, sbuf, ebuf), 0

    (_, n_s, _, sbuf, ebuf), _ = jax.lax.scan(
        step,
        (jnp.uint8(0), jnp.int32(0), jnp.int32(0), sbuf, ebuf),
        (mp.reshape(S, L), jnp.arange(S, dtype=jnp.int32) * L),
    )
    return runs_to_clusters(sbuf[:cap], ebuf[:cap], n_ends, cap=cap,
                            mcov_out=mcov_out)


@partial(jax.jit, donate_argnums=(0, 1), static_argnames=("n",))
def _mask_and_counts_packed(thrK_w, min_w, *, n: int):
    """Cluster mask words (thr_K & ~minima, bit-packed) + run start/end
    counts from word-level bit tricks — the huge-n (TraversalResult.packed)
    formulation: no O(n) byte vector at any point."""
    mw = thrK_w & ~min_w
    carry = jnp.concatenate([jnp.zeros(1, jnp.uint32), mw[:-1]])
    shifted = (mw << jnp.uint32(1)) | \
        jax.lax.shift_right_logical(carry, jnp.uint32(31))
    start_bits = mw & ~shifted  # bit p: mask[p] & ~mask[p-1]
    end_bits = ~mw & shifted    # bit p: mask[p-1] & ~mask[p] (end = p)
    W = mw.shape[0]
    if n < W * 32:
        # a run reaching n-1 never closes (reference scan quirk): clear
        # the would-be end bit at position n (pad bits are otherwise 0)
        wi = n >> 5
        end_bits = end_bits.at[wi].set(
            end_bits[wi] & jnp.uint32((~(1 << (n & 31))) & 0xFFFFFFFF))
    n_starts = jnp.sum(jax.lax.population_count(start_bits)
                       .astype(jnp.int32))
    n_ends = jnp.sum(jax.lax.population_count(end_bits).astype(jnp.int32))
    return mw, n_starts, n_ends


@partial(jax.jit, donate_argnums=(0,),
         static_argnames=("cap", "mcov_out", "n"))
def _extract_runs_masked_packed(mw, n_ends, *, cap, mcov_out, n):
    """_extract_runs_masked over bit-packed mask words: each scan slice
    unpacks L bits from L/32 words, so the only O(n)-scale allocation is
    the n/8-byte padded word copy."""
    from ..ops.coords import pat32
    from .traverse import _LEAN_SLICE, _unpack_bits_u32

    L = _LEAN_SLICE
    S = -(-n // L)
    B = L // 16
    INF = jnp.int32(pat32(S * L))
    n_pat = jnp.int32(pat32(n))
    WS = S * L // 32
    mwp = jnp.zeros(WS, jnp.uint32).at[: mw.shape[0]].set(mw)
    sbuf = jnp.zeros(cap + L, jnp.int32)
    ebuf = jnp.zeros(cap + L, jnp.int32)

    def write(buf, keys, cnt, m):
        def wcond(st):
            return st[0] * B < m

        def wstep(st):
            it, bf = st
            sl = jax.lax.dynamic_slice(keys, (it * B,), (B,))
            bf = jax.lax.dynamic_update_slice(bf, sl, (cnt + it * B,))
            return it + 1, bf

        return jax.lax.while_loop(wcond, wstep, (jnp.int32(0), buf))[1]

    def upsort(m, p):
        key = jnp.where(m, p, INF).astype(jnp.uint32)
        return jax.lax.sort(key, is_stable=False).astype(jnp.int32)

    def step(carry, xs):
        prev_bit, cnt_s, cnt_e, sbuf, ebuf = carry
        wrow, base = xs
        m = _unpack_bits_u32(wrow, L)
        pos = base + jnp.arange(L, dtype=jnp.int32)
        prev = jnp.concatenate([prev_bit[None], m[:-1]])
        m_s = (m != 0) & (prev == 0)
        m_e = (m == 0) & (prev != 0) & (pos != n_pat)
        key_s = upsort(m_s, pos)
        key_e = upsort(m_e, pos)
        c_s = jnp.sum(m_s.astype(jnp.int32))
        c_e = jnp.sum(m_e.astype(jnp.int32))
        sbuf = write(sbuf, key_s, cnt_s, c_s)
        ebuf = write(ebuf, key_e, cnt_e, c_e)
        return (m[-1], cnt_s + c_s, cnt_e + c_e, sbuf, ebuf), 0

    (_, n_s, _, sbuf, ebuf), _ = jax.lax.scan(
        step,
        (jnp.uint8(0), jnp.int32(0), jnp.int32(0), sbuf, ebuf),
        (mwp.reshape(S, L // 32), jnp.arange(S, dtype=jnp.int32) * L),
    )
    return runs_to_clusters(sbuf[:cap], ebuf[:cap], n_ends, cap=cap,
                            mcov_out=mcov_out)


def find_clusters_device_packed(thrK_w, min_w, *, n: int,
                                mcov_out: int) -> Clusters:
    """find_clusters_device over bit-packed flag words (huge-n path)."""
    from ..ops.coords import unpat

    mw, n_starts, n_ends = _mask_and_counts_packed(thrK_w, min_w, n=n)
    n_ends_i = unpat(n_ends)
    cap = _cap(max(unpat(n_starts), 1))
    a_begins, a_ends, n_analyzed, hist, size_sum = \
        _extract_runs_masked_packed(mw, n_ends, cap=cap, mcov_out=mcov_out,
                                    n=n)
    n_analyzed_i = int(n_analyzed)
    return Clusters(
        begins=a_begins[:n_analyzed_i],
        ends=a_ends[:n_analyzed_i],
        n_clusters=n_analyzed_i,
        clust_size_sum=unpat(size_sum),
        n_closed=n_ends_i,
        hist=np.asarray(hist),
    )


def find_clusters_device(thr_K_dev, minima_dev, mcov_out: int) -> Clusters:
    """Device-side equivalent of find_clusters: begins/ends stay on device
    (trimmed to the analyzed count); only scalar stats and the histogram are
    downloaded."""
    import os

    from ..ops.coords import unpat
    from .traverse import _LEAN_N

    n = thr_K_dev.shape[0]
    if n >= _LEAN_N and os.environ.get("EBWT_CLUSTER_EXTRACT") != "select":
        # memory-lean route: one mask vector + slice-wise marks with a
        # carry bit; thr_K/minima are donated (no consumer afterwards)
        mask, n_starts, n_ends = _run_marks_lean(thr_K_dev, minima_dev)
        n_ends_i = unpat(n_ends)
        cap = _cap(max(unpat(n_starts), 1))
        a_begins, a_ends, n_analyzed, hist, size_sum = _extract_runs_masked(
            mask, n_ends, cap=cap, mcov_out=mcov_out, n=n
        )
        n_analyzed_i = int(n_analyzed)
        return Clusters(
            begins=a_begins[:n_analyzed_i],
            ends=a_ends[:n_analyzed_i],
            n_clusters=n_analyzed_i,
            # the device sum wraps mod 2^32; the true value is < n < 2^32
            clust_size_sum=unpat(size_sum),
            n_closed=n_ends_i,
            hist=np.asarray(hist),
        )
    is_start, end_at, n_starts, n_ends = _run_marks(thr_K_dev, minima_dev)
    n_ends_i = int(n_ends)
    cap = _cap(max(int(n_starts), 1))
    if os.environ.get("EBWT_CLUSTER_EXTRACT") == "select":
        extract = _extract_runs_select
    else:
        extract = _extract_runs
    a_begins, a_ends, n_analyzed, hist, size_sum = extract(
        is_start, end_at, n_ends, cap=cap, mcov_out=mcov_out
    )
    n_analyzed_i = int(n_analyzed)
    return Clusters(
        begins=a_begins[:n_analyzed_i],
        ends=a_ends[:n_analyzed_i],
        n_clusters=n_analyzed_i,
        # the device sum wraps mod 2^32; the true value is < n < 2^32
        clust_size_sum=int(np.uint32(np.int64(int(size_sum)) & 0xFFFFFFFF)),
        n_closed=n_ends_i,
        hist=np.asarray(hist),
    )
