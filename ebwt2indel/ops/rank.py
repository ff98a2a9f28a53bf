"""Batched rank / access / select over the packed block layout (device, jnp).

These are the batched device equivalents of the reference's per-query primitives:

* ``parallel_rank``  <- dna_string.hpp:140-152 (superblock+block counter + in-block
  popcount; here: one row gather + masked ``lax.population_count`` per plane)
* ``access``         <- dna_string.hpp:113-135
* ``select``         <- dna_string.hpp:182-272. The reference does a global binary
  search with O(log n) rank calls per query; we do a hierarchical counter descent:
  searchsorted over per-block counters, then an in-block word/bit descent —
  O(log n_blocks) cheap int32 gathers + O(1) popcounts per query, fully batched.
  select is the hot primitive of right-context extraction (FL, dna_bwt.hpp:115-133).

All functions are batched: position/rank arguments are int32 arrays of any shape.
Everything is jittable with static shapes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from . import bits

BLOCK = 128
WPB = 4

import numpy as _np

# numpy scalars, NOT jnp: a module-level jnp constant would initialize the
# XLA backend at import time, which breaks jax.distributed.initialize
# (must run before any backend touch — parallel/launch.py)
_U1 = _np.uint32(1)
_ALL1 = _np.uint32(0xFFFFFFFF)


def _prefix_masks(o):
    """Per-word uint32 masks selecting the first ``o`` bits of a 128-bit block.

    o: int32 [...]; returns uint32 [..., 4].
    """
    w = jnp.arange(WPB, dtype=jnp.int32)
    take = jnp.clip(o[..., None] - w * 32, 0, 32)  # [..., 4]
    sh = jnp.minimum(take, 31).astype(jnp.uint32)
    partial = (_U1 << sh) - _U1
    return jnp.where(take == 32, _ALL1, partial)


def _char_plane_words(row):
    """row: uint32 [..., 16] -> uint32 [..., 4(char), 4(word)] with the bit set
    where the character at that offset equals the char (A,C,G,T)."""
    p0 = row[..., 0:4]
    p1 = row[..., 4:8]
    p2 = row[..., 8:12]
    np2 = ~p2
    a = np2 & ~p1 & ~p0
    c = np2 & ~p1 & p0
    g = np2 & p1 & ~p0
    t = np2 & p1 & p0
    return jnp.stack([a, c, g, t], axis=-2)


def _decode_rank_T(rowT, o):
    """In-block rank decode on pre-gathered rows, transposed layout.

    rowT: uint32 (16, B) — gathered block rows with the batch in the dense
    minor (lane) dimension (a (B, 16) layout wastes 7/8 of the VPU lanes);
    o: int32 (B,) in-block offsets. Returns int32 (B, 4). Per-word counts
    use 4 popcounts and the linear combination A = S-x-y+z, C = x-z,
    G = y-z, T = z where S = #non-TERM, x = #bit0, y = #bit1,
    z = #(bit0&bit1).
    """
    p0 = rowT[0:4]
    p1 = rowT[4:8]
    p2 = rowT[8:12]
    cnt = rowT[12:16].astype(jnp.int32)  # (4, B) counters A,C,G,T

    w = jnp.arange(WPB, dtype=jnp.int32)[:, None]
    take = jnp.clip(o[None, :] - w * 32, 0, 32)  # (4, B)
    sh = jnp.minimum(take, 31).astype(jnp.uint32)
    mask = jnp.where(take == 32, _ALL1, (_U1 << sh) - _U1)

    np2m = ~p2 & mask
    t0 = p0 & np2m
    t1 = p1 & np2m
    t2 = p0 & t1
    pc = jax.lax.population_count
    S = pc(np2m).sum(axis=0, dtype=jnp.int32)
    x = pc(t0).sum(axis=0, dtype=jnp.int32)
    y = pc(t1).sum(axis=0, dtype=jnp.int32)
    z = pc(t2).sum(axis=0, dtype=jnp.int32)
    return jnp.stack(
        [cnt[0] + (S - x - y + z), cnt[1] + (x - z), cnt[2] + (y - z),
         cnt[3] + z],
        axis=-1,
    )


def parallel_rank(blocks, i):
    """Counts of (A,C,G,T) in the prefix of length ``i``.

    blocks: uint32 (n_blocks, 16); i: int32 [...]; returns int32 [..., 4].
    Mirrors dna_string.hpp:140-152: one row gather + in-block decode.
    """
    shape = i.shape
    i = i.reshape(-1)
    b = jax.lax.shift_right_logical(i, 7)
    o = i & jnp.int32(BLOCK - 1)
    out = _decode_rank_T(blocks[b].T, o)
    return out.reshape(shape + (4,))


def _decode_rank_T_multi(rowT, o):
    """Rank decode of ``k`` offsets per row against one anchor row each.

    rowT: uint32 (16, C) anchor rows (transposed); o: int32 (C, k)
    in-block offsets, all decoded against that row. Returns int32
    (C, k, 4). Same popcount formulation as `_decode_rank_T`, with the
    k offsets broadcast over a middle axis — the anchor planes are read
    once per row, not once per offset, so nothing of size (C, k, 16) is
    ever materialized.
    """
    k = o.shape[1]
    p0 = rowT[0:4][:, None, :]  # (4, 1, C)
    p1 = rowT[4:8][:, None, :]
    p2 = rowT[8:12][:, None, :]
    cnt = rowT[12:16].astype(jnp.int32)  # (4, C)

    w = jnp.arange(WPB, dtype=jnp.int32)[:, None, None]  # (4, 1, 1)
    oT = o.T[None, :, :]  # (1, k, C)
    take = jnp.clip(oT - w * 32, 0, 32)  # (4, k, C)
    sh = jnp.minimum(take, 31).astype(jnp.uint32)
    mask = jnp.where(take == 32, _ALL1, (_U1 << sh) - _U1)

    np2m = ~p2 & mask
    t0 = p0 & np2m
    t1 = p1 & np2m
    t2 = p0 & t1
    pc = jax.lax.population_count
    S = pc(np2m).sum(axis=0, dtype=jnp.int32)  # (k, C)
    x = pc(t0).sum(axis=0, dtype=jnp.int32)
    y = pc(t1).sum(axis=0, dtype=jnp.int32)
    z = pc(t2).sum(axis=0, dtype=jnp.int32)
    out = jnp.stack(
        [cnt[0] + (S - x - y + z), cnt[1] + (x - z), cnt[2] + (y - z),
         cnt[3] + z],
        axis=-1,
    )  # (k, C, 4)
    return jnp.swapaxes(out, 0, 1)  # (C, k, 4)


def parallel_rank_sorted(blocks, coords, budget: int, valid=None):
    """p_rank at per-row *sorted* coordinate tuples with a 2-anchor gather.

    coords: int32 (C, k), non-decreasing along axis 1 (a suffix-tree node's
    child boundaries, include.hpp:394-413). Returns int32 (C, k, 4).

    Narrow-node formulation: nearly all suffix-tree nodes are
    narrower than one 128-char block (size ≈ read coverage), so the k
    coordinates of a row almost always fall in at most the two blocks
    containing coords[:, 0] and coords[:, -1]. Gather those 2 rows per
    node (2C rows instead of kC) and decode every coordinate against both
    anchors, selecting the (C, k, 4) results (the 2x popcounts are
    cheap; nothing of size (C, k, 16) materializes).

    Rows that straddle >= 3 blocks are resolved *exactly* by a
    budget-sliced side loop: bv_select extracts up to ``budget`` wide-row
    indices per slice (gather-only, O(budget * log C) — not the O(C*k)
    cumsum+scatter compaction that sank the earlier variants), a dense
    per-coordinate rank answers those rows, and a row scatter overwrites
    their anchor decodes. The loop runs ceil(n_wide/budget) data-dependent
    iterations — zero for all-narrow chunks, and wide-heavy chunks (the
    first ~log4 n traversal levels) just iterate more. No lax.cond dense
    fallback: cond flattens inside the caller's traversal while_loop, so
    both branches would pay.

    valid: optional (C,) bool — rows to answer. Invalid rows are excluded
    from the wide side pass and may decode to garbage (callers mask).
    budget must be static.
    """
    C, k = coords.shape
    b = jax.lax.shift_right_logical(coords, 7)  # (C, k)
    o = coords & jnp.int32(BLOCK - 1)
    rows_lo = blocks[b[:, 0]]  # (C, 16)
    rows_hi = blocks[b[:, k - 1]]
    use_hi = b == b[:, k - 1][:, None]
    dec_lo = _decode_rank_T_multi(rows_lo.T, o)
    dec_hi = _decode_rank_T_multi(rows_hi.T, o)
    dec = jnp.where(use_hi[:, :, None], dec_hi, dec_lo)  # (C, k, 4)

    wide = ~jnp.all(use_hi | (b == b[:, :1]), axis=1)
    if valid is not None:
        wide = wide & valid
    return _wide_fixup(blocks, coords, dec, wide, budget)


def _wide_fixup(blocks, coords, dec, wide, budget: int):
    """Overwrite anchor decodes of ``wide`` rows with exact dense ranks.

    Budget-sliced data-dependent inner while_loop: bv_select extracts up
    to ``budget`` wide-row indices per slice (gather-only — not the
    O(C*k) cumsum+scatter compaction that sank earlier variants), a dense
    per-coordinate rank answers them, and a row scatter overwrites their
    entries in ``dec``. Zero iterations for all-narrow chunks."""
    C = coords.shape[0]
    n_wide = jnp.sum(wide.astype(jnp.int32))
    words, counts = bits.bv_build(wide.astype(jnp.uint8))
    ar = jnp.arange(budget, dtype=jnp.int32)

    def wcond(state):
        return state[0] * budget < n_wide

    def wstep(state):
        it, dec = state
        r = it * budget + ar
        ok = r < n_wide
        sel = bv_select(words, counts, jnp.where(ok, r, 0))
        sel = jnp.clip(sel, 0, C - 1)
        wdec = parallel_rank(blocks, coords[sel])  # (budget, k, 4)
        dec = dec.at[jnp.where(ok, sel, C)].set(wdec, mode="drop")
        return it + 1, dec

    return jax.lax.while_loop(wcond, wstep, (jnp.int32(0), dec))[1]


def parallel_rank_pair1(blocks, first, second, budget: int, valid=None):
    """parallel_rank at interval endpoints (first, second) with ONE anchor
    row gather per pair.

    Suffix-tree leaf intervals are ~read-coverage wide, so both endpoints
    nearly always live in the same 128-char rank block — gather the block
    row of ``first`` only (C rows instead of 2C) and decode both offsets
    against it. Pairs straddling a
    block boundary are answered exactly by the budget-sliced dense side
    loop (`_wide_fixup`). valid: optional (C,) bool mask of real rows —
    invalid rows skip the side loop and may decode to garbage (callers
    mask). Returns int32 (C, 2, 4)."""
    coords = jnp.stack([first, second], axis=-1)  # (C, 2)
    b = jax.lax.shift_right_logical(coords, 7)
    o = coords & jnp.int32(BLOCK - 1)
    dec = _decode_rank_T_multi(blocks[b[:, 0]].T, o)  # (C, 2, 4)
    wide = b[:, 0] != b[:, 1]
    if valid is not None:
        wide = wide & valid
    return _wide_fixup(blocks, coords, dec, wide, budget)


def parallel_rank_dedup(blocks, i, budget: int):
    """parallel_rank over a 1-D query vector whose adjacent entries are
    frequently equal — rank once per *distinct* coordinate.

    The reference skips rank calls at equal node boundaries
    (dna_bwt.hpp:334-347: ``if(N.first_A == N.first_TERM) before_A =
    before_TERM``). The batched equivalent: compact the run-heads of ``i``
    into a ``budget``-sized buffer (index scatter), rank the buffer, and
    gather each query's governing result back via the inclusive prefix
    count of run-heads. Equal coordinates have equal ranks, so this is
    exact; adjacent *cross-node* duplicates (sibling intervals sharing a
    boundary after char-major queue compaction) dedup for free too.

    Falls back to the dense rank when the distinct count exceeds
    ``budget`` (lax.cond — one branch executes). budget must be static.

    i: int32 (B,); returns int32 (B, 4).
    """
    head = jnp.concatenate(
        [jnp.ones(1, dtype=bool), i[1:] != i[:-1]]
    )
    gov = jnp.cumsum(head.astype(jnp.int32)) - 1  # governing slot per query
    count = gov[-1] + 1

    def dedup_path(_):
        pos = jnp.where(head, gov, jnp.int32(budget))
        buf = jnp.zeros(budget, jnp.int32).at[pos].set(i, mode="drop")
        rc = parallel_rank(blocks, buf)  # (budget, 4)
        return rc[jnp.minimum(gov, budget - 1)]

    def dense_path(_):
        return parallel_rank(blocks, i)

    return jax.lax.cond(count <= budget, dedup_path, dense_path, None)


def rank_non_dna(blocks, i):
    """Number of TERM characters before position i (dna_string.hpp:194-203)."""
    return i - parallel_rank(blocks, i).sum(axis=-1, dtype=jnp.int32)


def rank_char(blocks, i, c):
    """rank of character code c (0..3) at i; TERM handled by rank_non_dna
    (dna_string.hpp:157-174)."""
    pr = parallel_rank(blocks, i)
    dna_r = jnp.take_along_axis(
        pr, jnp.clip(c, 0, 3)[..., None].astype(jnp.int32), axis=-1
    )[..., 0]
    return jnp.where(c == 4, rank_non_dna(blocks, i), dna_r)


def access(blocks, i):
    """Character code (0..4) at position i (dna_string.hpp:113-135)."""
    b = jax.lax.shift_right_logical(i, 7)
    o = i & jnp.int32(BLOCK - 1)
    row = blocks[b]
    widx = jax.lax.shift_right_logical(o, 5)
    bit = (o & 31).astype(jnp.uint32)
    code = jnp.zeros(i.shape, dtype=jnp.int32)
    for p in range(3):
        word = jnp.take_along_axis(row[..., p * WPB : (p + 1) * WPB],
                                   widx[..., None], axis=-1)[..., 0]
        code = code | (((word >> bit) & _U1).astype(jnp.int32) << p)
    return code


def _select_in_word(word, t):
    """Position (0..31) of the (t+1)-th set bit of ``word`` (uint32), batched.

    5-step binary descent on prefix popcounts.
    """
    lo = jnp.zeros(t.shape, dtype=jnp.int32)
    for k in (16, 8, 4, 2, 1):
        m = jnp.minimum(lo + k, 31).astype(jnp.uint32)
        pref = (_U1 << m) - _U1
        pref = jnp.where(lo + k >= 32, _ALL1, pref)
        cnt = jax.lax.population_count(word & pref).astype(jnp.int32)
        lo = jnp.where(cnt <= t, lo + k, lo)
    return lo


def select_block(block_counts, r, c):
    """Phase A of select: the block containing the (r+1)-th occurrence of
    char c — binary search over the absolute per-block counters.

    Counters and ranks are unsigned bit patterns (ops.coords): the
    comparison is done on the uint32 view so inputs past 2^31 order
    correctly."""
    nb = block_counts.shape[0]
    lo = jnp.zeros(r.shape, dtype=jnp.int32)
    hi = jnp.full(r.shape, nb, dtype=jnp.int32)  # exclusive
    ru = r.astype(jnp.uint32)
    # invariant: counts[lo] <= r < counts[hi] (counts[nb] == total > r)
    steps = max(1, (nb - 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) >> 1
        use = mid > lo
        cm = jnp.take_along_axis(block_counts[mid], c[..., None], axis=-1)[..., 0]
        gt = cm.astype(jnp.uint32) > ru
        lo = jnp.where(use & ~gt, mid, lo)
        hi = jnp.where(use & gt, mid, hi)
    return lo


def select_in_block(row, r, c):
    """Phase B of select: offset (0..127) of the (t+1)-th occurrence of char
    c inside a gathered block row, t = r minus the block's counter."""
    t = r - jnp.take_along_axis(row[..., 12:16].astype(jnp.int32),
                                c[..., None], axis=-1)[..., 0]
    chars = _char_plane_words(row)  # [..., 4, 4]
    words = jnp.take_along_axis(
        chars, c[..., None, None].astype(jnp.int32), axis=-2
    )[..., 0, :]  # [..., 4]
    wc = jax.lax.population_count(words).astype(jnp.int32)
    cum = jnp.cumsum(wc, axis=-1)
    prev = cum - wc
    widx = jnp.sum((cum <= t[..., None]).astype(jnp.int32), axis=-1)
    widx = jnp.clip(widx, 0, WPB - 1)
    t2 = t - jnp.take_along_axis(prev, widx[..., None], axis=-1)[..., 0]
    word = jnp.take_along_axis(words, widx[..., None], axis=-1)[..., 0]
    bit = _select_in_word(word, t2)
    return widx * 32 + bit


def select(blocks, block_counts, r, c):
    """Position of the (r+1)-th occurrence of char code c (0..3), batched.

    blocks: uint32 (n_blocks, 16); block_counts: int32 (n_blocks, 4);
    r, c: int32 [...]. Assumes r < total count of c (dna_string.hpp:182-188).
    """
    b = select_block(block_counts, r, c)
    return b * BLOCK + select_in_block(blocks[b], r, c)


# ---------------------------------------------------------------------------
# rank-1 over a packed bitvector (document array / LCP flag vectors)
# ---------------------------------------------------------------------------


def _bv_row(words, b):
    """(..., 4) word row of block b from the FLAT (nb*4,) word array
    (ops.bits.bv_build layout)."""
    idx = 4 * b[..., None] + jnp.arange(4, dtype=b.dtype)
    return words[idx]


def bv_rank1(words, counts, i):
    """Number of 1-bits before position i.

    words: uint32 (nb*4,) flat; counts: int32 (n_blocks,); i: int32 [...].
    Device-side rank over the document array (the reference keeps DA as
    vector<bool> and scans it sequentially, ebwt2InDel.cpp:1431-1432).
    """
    b = jax.lax.shift_right_logical(i, 7)
    o = i & jnp.int32(BLOCK - 1)
    row = _bv_row(words, b)  # [..., 4]
    masks = _prefix_masks(o)
    inblock = jax.lax.population_count(row & masks).sum(axis=-1, dtype=jnp.int32)
    return counts[b] + inblock


def bv_select(words, counts, r):
    """Position of the (r+1)-th set bit of a packed bitvector, batched.

    words: uint32 (nb*4,) flat; counts: int32 (nb,) exclusive per-block
    prefix counts (ops.bits.bv_build layout); r: int32 [...]. Assumes r < total
    set bits; out-of-range r returns garbage (callers mask).

    The gather-only dual of the compaction scatter: extracting the
    positions of B set bits costs ~log2(nb) cheap int32 gathers + O(1)
    popcounts per output, while a scatter formulation touches every
    INPUT element. Used by the device cluster extraction.
    """
    nb = counts.shape[0]
    lo = jnp.zeros(r.shape, dtype=jnp.int32)
    hi = jnp.full(r.shape, nb, dtype=jnp.int32)
    ru = r.astype(jnp.uint32)  # counts/ranks are unsigned bit patterns
    steps = max(1, (nb - 1).bit_length())
    for _ in range(steps):
        mid = (lo + hi) >> 1
        use = mid > lo
        gt = counts[mid].astype(jnp.uint32) > ru
        lo = jnp.where(use & ~gt, mid, lo)
        hi = jnp.where(use & gt, mid, hi)
    row = _bv_row(words, lo)  # [..., 4]
    t = r - counts[lo]
    wc = jax.lax.population_count(row).astype(jnp.int32)
    cum = jnp.cumsum(wc, axis=-1)
    prev = cum - wc
    widx = jnp.clip(
        jnp.sum((cum <= t[..., None]).astype(jnp.int32), axis=-1), 0, 3
    )
    t2 = t - jnp.take_along_axis(prev, widx[..., None], axis=-1)[..., 0]
    word = jnp.take_along_axis(row, widx[..., None], axis=-1)[..., 0]
    return lo * BLOCK + widx * 32 + _select_in_word(word, t2)


def bv_get(words, i):
    """Bit at position i (flat (nb*4,) word array)."""
    o = i & jnp.int32(BLOCK - 1)
    bit = (o & 31).astype(jnp.uint32)
    word = words[jax.lax.shift_right_logical(i, 5)]
    return ((word >> bit) & _U1).astype(jnp.int32)
