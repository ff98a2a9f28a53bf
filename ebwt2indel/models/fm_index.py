"""FM-index over the packed rank backend — batched LF / F / FL / node extension.

Batched re-design of the reference's dna_bwt<dna_string> façade
(reference: internal/dna_bwt.hpp:24-420). Every operation is batched over
arrays of positions / ranges / suffix-tree nodes, so thousands of backward
steps or Weiner-link extensions advance per device dispatch.

Suffix-tree node representation (reference: include.hpp:394-413): an int32
array [..., 7] holding (first_TERM, first_A, first_C, first_G, first_T, last,
depth). A leaf is an int32 array [..., 3]: (first, second, depth)
(reference: include.hpp:513-527).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import packing, rank


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["blocks", "block_counts", "F"],
    meta_fields=["n", "term"],
)
@dataclasses.dataclass(frozen=True)
class FMIndex:
    """Device mirror of ops.packing.PackedBwt.

    F holds the 4 cumulative boundaries (F_A, F_C, F_G, F_T) with TERM
    lexicographically smallest (dna_bwt.hpp:47-61): F_A = #TERM,
    F_C = F_A + #A, F_G = F_C + #C, F_T = F_G + #G.
    """

    blocks: jax.Array  # (n_blocks, 16) uint32
    block_counts: jax.Array  # (n_blocks, 4) int32
    F: jax.Array  # (4,) int32
    n: int
    term: int

    @staticmethod
    def from_packed(pb: packing.PackedBwt) -> "FMIndex":
        import os

        lean = os.environ.get("EBWT_LEAN_UPLOAD", "2")
        # level 2 (default): upload 2 bitplanes (32 B / 128 chars) plus
        # the TERM positions as sparse int32 — TERM is the only code with
        # plane 2 set and terminators are ~1% of a read eBWT, so the
        # dense plane rebuilds on device from a bit scatter. Falls back
        # to the 3-plane upload when terminators are dense (> 1/32 of
        # positions — e.g. mode 3's TERM-masked second index).
        if lean == "2" and int(pb.counts[4]) * 4 < pb.blocks.shape[0] * 16:
            planes01 = jnp.asarray(np.ascontiguousarray(pb.blocks[:, :8]))
            tpos = jnp.asarray(packing.term_positions(pb))
            blocks, cum = _build_blocks_sparse_term(planes01, tpos, n=pb.n)
            return FMIndex(
                blocks=blocks,
                block_counts=cum,
                F=jnp.asarray(pb.F.astype(np.int32)),
                n=pb.n,
                term=pb.term,
            )
        if lean != "0":
            # upload only the 3 bitplanes (48 B / 128 chars) and rebuild
            # the cumulative-count words + select table on device — 40%
            # less host->device traffic (the pipeline's largest transfer;
            # host links are the one bandwidth XLA can't hide)
            planes = jnp.asarray(np.ascontiguousarray(pb.blocks[:, :12]))
            blocks, cum = _build_blocks_from_planes(planes, n=pb.n)
            return FMIndex(
                blocks=blocks,
                block_counts=cum,
                F=jnp.asarray(pb.F.astype(np.int32)),
                n=pb.n,
                term=pb.term,
            )
        return FMIndex(
            blocks=jnp.asarray(pb.blocks),
            block_counts=jnp.asarray(pb.block_counts),
            F=jnp.asarray(pb.F.astype(np.int32)),
            n=pb.n,
            term=pb.term,
        )

    @staticmethod
    def from_file(path: str, term: int = ord("#")) -> "FMIndex":
        import os

        if os.environ.get("EBWT_INDEX_CACHE"):
            # persist the packed index next to the input (mtime-keyed) —
            # the checkpointable-artifact capability the reference has but
            # never wires up (dna_bwt.hpp:238-289)
            return FMIndex.from_packed(packing.pack_file_cached(path, term))
        return FMIndex.from_packed(packing.pack_file(path, term))

    # host-side constants -------------------------------------------------
    def root(self) -> np.ndarray:
        """Root suffix-tree node (dna_bwt.hpp:296-308). Coordinates are
        unsigned int32 bit patterns (ops.coords) so n past 2^31 encodes."""
        F = np.asarray(self.F, dtype=np.int64)
        return (np.array([0, F[0], F[1], F[2], F[3], self.n, 0],
                         dtype=np.int64).astype(np.uint32).view(np.int32))

    def first_leaf(self) -> np.ndarray:
        """Leaf of the empty string: range of all terminator-first suffixes
        (dna_bwt.hpp:313-317)."""
        F = np.asarray(self.F, dtype=np.int64)
        return (np.array([0, F[0], 0], dtype=np.int64)
                .astype(np.uint32).view(np.int32))


@partial(jax.jit, static_argnames=("n",))
def _build_blocks_from_planes(planes, *, n: int):
    """Rebuild the (nb, 16) rank blocks + (nb, 4) cumulative counts from the
    3 uploaded bitplanes (ops/packing.py layout: words 0-3 plane 0, 4-7
    plane 1, 8-11 plane 2/TERM; codes A=000, C=001, G=010, T=011, TERM=100).
    Equivalent to the host packer's count words (packing.pack_codes:77-90),
    computed with VPU popcounts + one cumsum instead of being shipped."""
    nb = planes.shape[0]
    p0 = planes[:, 0:4]
    p1 = planes[:, 4:8]
    p2 = planes[:, 8:12]
    pc = jax.lax.population_count
    cT = pc(p0 & p1).sum(-1, dtype=jnp.int32)
    cC = pc(p0 & ~p1).sum(-1, dtype=jnp.int32)
    cG = pc(p1 & ~p0).sum(-1, dtype=jnp.int32)
    cA = pc(~p0 & ~p1 & ~p2).sum(-1, dtype=jnp.int32)
    per = jnp.stack([cA, cC, cG, cT], axis=-1)  # (nb, 4)
    # packer pads the final block with code 0 ('A') up to nb*128
    per = per.at[nb - 1, 0].add(jnp.int32(n - nb * packing.BLOCK))
    cum = jnp.cumsum(per, axis=0) - per  # exclusive: counts BEFORE block
    blocks = jnp.concatenate([planes, cum.astype(jnp.uint32)], axis=1)
    return blocks, cum


@partial(jax.jit, static_argnames=("n",))
def _build_blocks_sparse_term(planes01, term_pos, *, n: int):
    """_build_blocks_from_planes fed by 2 uploaded bitplanes + sparse TERM
    positions: plane 2 (the terminator bitmap — TERM is the only code with
    that plane set) rebuilds with one bit scatter. Every position sets a
    distinct bit, so the add never carries even when two terminators share
    a word."""
    nb = planes01.shape[0]
    one = jnp.uint32(1)
    p2 = jnp.zeros(nb * 4, dtype=jnp.uint32).at[
        jax.lax.shift_right_logical(term_pos, 5)
    ].add(one << (term_pos & 31).astype(jnp.uint32), mode="drop")
    planes = jnp.concatenate([planes01, p2.reshape(nb, 4)], axis=1)
    return _build_blocks_from_planes(planes, n=n)


# ---------------------------------------------------------------------------
# batched FM operations
# ---------------------------------------------------------------------------


def parallel_rank(fm: FMIndex, i):
    return rank.parallel_rank(fm.blocks, i)


def access(fm: FMIndex, i):
    return rank.access(fm.blocks, i)


def f_char(fm: FMIndex, i):
    """Character code of the F column at position i (dna_bwt.hpp:100-110):
    TERM(4) below F_A, else A..T by boundary comparison. F and i are
    unsigned bit patterns; with only 4 boundaries the searchsorted is a
    broadcast unsigned compare + sum."""
    Fu = fm.F.astype(jnp.uint32)
    iu = i.astype(jnp.uint32)
    r = jnp.sum((Fu <= iu[..., None]).astype(jnp.int32), axis=-1)
    return jnp.where(r == 0, jnp.int32(4), r - 1)


def lf(fm: FMIndex, i):
    """LF for a single position; undefined on terminators
    (dna_bwt.hpp:77-97 asserts c != TERM)."""
    c = access(fm, i)
    cc = jnp.clip(c, 0, 3)
    r = jnp.take_along_axis(
        parallel_rank(fm, i), cc[..., None], axis=-1
    )[..., 0]
    return fm.F[cc] + r


def fl(fm: FMIndex, i):
    """FL (psi): F position -> L position of the same character occurrence
    (dna_bwt.hpp:115-133). Caller must guarantee F(i) != TERM."""
    c = f_char(fm, i)
    cc = jnp.clip(c, 0, 3)
    # the region of character c starts at F[c] (F[0] == F_A == #TERM)
    r = i - fm.F[cc]
    return rank.select(fm.blocks, fm.block_counts, r, cc)


def lf_range(fm: FMIndex, first, second):
    """Left-extend a right-exclusive range by all 4 nucleotides at once
    (dna_bwt.hpp:138-166). Returns (lo[..., 4], hi[..., 4])."""
    lo = fm.F + parallel_rank(fm, first)
    hi = fm.F + parallel_rank(fm, second)
    return lo, hi


def lf_range_narrow(fm: FMIndex, first, second, budget: int, valid=None):
    """lf_range via the 1-anchor pair rank (rank.parallel_rank_pair1):
    one block-row gather per leaf instead of two — leaf intervals are
    ~read-coverage wide so both endpoints nearly always share a rank
    block; block-straddling pairs take the exact budget-sliced side
    loop. first, second: int32 (C,); returns (lo (C,4), hi (C,4))."""
    dec = rank.parallel_rank_pair1(fm.blocks, first, second, budget,
                                   valid=valid)
    return fm.F + dec[:, 0], fm.F + dec[:, 1]


def lf_range_char(fm: FMIndex, first, second, c):
    """Left-extend a range by one character (dna_bwt.hpp:168-192)."""
    cc = jnp.clip(c, 0, 3)[..., None]
    s = jnp.take_along_axis(parallel_rank(fm, first), cc, axis=-1)[..., 0]
    e = jnp.take_along_axis(parallel_rank(fm, second), cc, axis=-1)[..., 0]
    base = fm.F[cc[..., 0]]
    return base + s, base + e


def extend_node(fm: FMIndex, nodes):
    """Weiner-link extension of suffix-tree nodes by all 4 nucleotides
    (dna_bwt.hpp:323-356). nodes: int32 [..., 7] -> int32 [..., 4, 7]."""
    coords = nodes[..., :6]  # [..., 6]
    ranks = parallel_rank(fm, coords)  # [..., 6, 4]
    # out coords for char c at coord j: F[c] + ranks[..., j, c]
    ext = fm.F[:, None] + jnp.swapaxes(ranks, -1, -2)  # [..., 4, 6]
    depth = nodes[..., 6:7] + 1  # [..., 1]
    depth4 = jnp.broadcast_to(depth[..., None, :], ext.shape[:-1] + (1,))
    return jnp.concatenate([ext, depth4], axis=-1)


def extend_node_narrow(fm: FMIndex, nodes, budget: int, valid=None):
    """extend_node via the 2-anchor sorted rank (rank.parallel_rank_sorted).

    A node's 6 child boundaries are sorted and span exactly the node's
    interval; node sizes are ~read coverage, so the whole tuple almost
    always fits in <= 2 of the 128-char rank blocks — 2 row gathers per
    node instead of 6.
    Block-straddling nodes are answered exactly by the budget-sliced
    dense side loop inside parallel_rank_sorted. valid: (C,) bool mask of
    real rows (pad rows skip the side loop and may extend to garbage).
    nodes: int32 (C, 7) -> int32 (C, 4, 7).
    """
    C = nodes.shape[0]
    ranks = rank.parallel_rank_sorted(fm.blocks, nodes[:, :6], budget,
                                      valid=valid)
    ext = fm.F[:, None] + jnp.swapaxes(ranks, -1, -2)  # (C, 4, 6)
    depth4 = jnp.broadcast_to(nodes[:, None, 6:7] + 1, (C, 4, 1))
    return jnp.concatenate([ext, depth4], axis=-1)


def extend_node_dedup(fm: FMIndex, nodes, budget: int):
    """extend_node with boundary-rank dedup (dna_bwt.hpp:334-347).

    A node's 6 boundaries are non-decreasing and frequently equal (a node
    with c children has c+1 distinct boundaries), so the flattened chunk
    coordinate vector is run-heavy; rank.parallel_rank_dedup ranks each
    run once. nodes: int32 (C, 7) -> int32 (C, 4, 7).
    """
    C = nodes.shape[0]
    flat = nodes[:, :6].reshape(-1)
    ranks = rank.parallel_rank_dedup(fm.blocks, flat, budget)
    ext = fm.F[:, None] + jnp.swapaxes(ranks.reshape(C, 6, 4), -1, -2)
    depth4 = jnp.broadcast_to(nodes[:, None, 6:7] + 1, (C, 4, 1))
    return jnp.concatenate([ext, depth4], axis=-1)


def lf_range_dedup(fm: FMIndex, first, second, budget: int):
    """lf_range with cross-leaf boundary dedup. After char-major queue
    compaction consecutive leaves are often adjacent intervals
    (prev.second == next.first), so the interleaved [f0,s0,f1,s1,...]
    vector is run-heavy. first, second: int32 (C,)."""
    C = first.shape[0]
    flat = jnp.stack([first, second], axis=-1).reshape(-1)
    ranks = rank.parallel_rank_dedup(fm.blocks, flat, budget)
    ranks = ranks.reshape(C, 2, 4)
    return fm.F + ranks[:, 0], fm.F + ranks[:, 1]


def node_num_children(nodes):
    """Number of non-empty children of each node (include.hpp:760-768).
    Boundary comparison is unsigned (positions are uint32 bit patterns)."""
    c = nodes[..., :6].astype(jnp.uint32)
    return jnp.sum((c[..., 1:] > c[..., :-1]).astype(jnp.int32), axis=-1)


def node_size(nodes):
    return nodes[..., 5] - nodes[..., 0]


def merge_nodes(a, b):
    """Coordinate-wise sum of two same-depth nodes — the implicit merged-BWT
    node (include.hpp:476-490). Depth taken from a."""
    merged = a[..., :6] + b[..., :6]
    return jnp.concatenate([merged, a[..., 6:7]], axis=-1)


def find(fm: FMIndex, pattern: str) -> tuple[int, int]:
    """Backward search of an ASCII pattern (dna_bwt.hpp:195-203).

    Host convenience API; not used by the calling pipeline (the reference's
    find() is likewise unused by the main tool)."""
    from ..utils import dna

    from ..ops.coords import pat32, unpat

    codes = dna.str_to_codes(pattern, fm.term)
    first = jnp.asarray([0], dtype=jnp.int32)
    second = jnp.asarray([pat32(fm.n)], dtype=jnp.int32)
    for c in codes[::-1]:
        first, second = lf_range_char(
            fm, first, second, jnp.asarray([int(c)], dtype=jnp.int32)
        )
    return unpat(first[0]), unpat(second[0])
