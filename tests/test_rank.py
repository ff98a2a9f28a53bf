"""Property tests of the rank backend against numpy oracles — the test-form of
the reference's debug self-checks check_rank / check_content
(dna_string.hpp:464-549)."""

import numpy as np
import pytest

import jax.numpy as jnp

from ebwt2indel.ops import packing, rank
from tests import oracle


def random_codes(rng, n, p_term=0.05):
    codes = rng.integers(0, 4, size=n).astype(np.uint8)
    term_mask = rng.random(n) < p_term
    codes[term_mask] = 4
    return codes


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 1000, 4096, 10000])
def test_parallel_rank_matches_oracle(rng, n):
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    qs = np.unique(
        np.concatenate(
            [rng.integers(0, n + 1, size=min(200, n + 1)), [0, n, n // 2]]
        )
    ).astype(np.int32)
    got = np.asarray(rank.parallel_rank(blocks, jnp.asarray(qs)))
    for q, row in zip(qs, got):
        np.testing.assert_array_equal(row, oracle.rank_oracle(codes, int(q)),
                                      err_msg=f"rank at {q}")


def test_access_and_rank_non_dna(rng):
    n = 3000
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    idx = jnp.arange(n, dtype=jnp.int32)
    got = np.asarray(rank.access(blocks, idx))
    np.testing.assert_array_equal(got, codes)
    q = np.array([0, 1, n // 3, n], dtype=np.int32)
    got_nd = np.asarray(rank.rank_non_dna(blocks, jnp.asarray(q)))
    for qq, g in zip(q, got_nd):
        assert g == (codes[:qq] == 4).sum()


def test_rank_char_includes_term(rng):
    n = 2000
    codes = random_codes(rng, n, p_term=0.2)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    i = jnp.asarray(np.full(5, n // 2, dtype=np.int32))
    c = jnp.asarray(np.arange(5, dtype=np.int32))
    got = np.asarray(rank.rank_char(blocks, i, c))
    for cc in range(5):
        assert got[cc] == (codes[: n // 2] == cc).sum()


@pytest.mark.parametrize("n", [130, 1000, 8192])
def test_select_matches_oracle(rng, n):
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    bcounts = jnp.asarray(pb.block_counts)
    rs, cs, expect = [], [], []
    for c in range(4):
        total = int((codes == c).sum())
        if total == 0:
            continue
        picks = np.unique(rng.integers(0, total, size=min(50, total)))
        for r in picks:
            rs.append(r)
            cs.append(c)
            expect.append(oracle.select_oracle(codes, int(r), c))
    got = np.asarray(
        rank.select(
            blocks, bcounts, jnp.asarray(rs, dtype=jnp.int32),
            jnp.asarray(cs, dtype=jnp.int32)
        )
    )
    np.testing.assert_array_equal(got, np.asarray(expect))


def test_bitvector_rank(rng):
    n = 5000
    bits = (rng.random(n) < 0.3).astype(np.uint8)
    words, counts = packing.pack_bitvector(bits)
    w = jnp.asarray(words)
    cnt = jnp.asarray(counts)
    qs = np.unique(np.concatenate([rng.integers(0, n + 1, 100), [0, n]]))
    got = np.asarray(rank.bv_rank1(w, cnt, jnp.asarray(qs, dtype=jnp.int32)))
    for q, g in zip(qs, got):
        assert g == bits[:q].sum(), q
    gotbits = np.asarray(rank.bv_get(w, jnp.arange(n, dtype=jnp.int32)))
    np.testing.assert_array_equal(gotbits, bits)


def test_bv_select_matches_oracle(rng):
    from ebwt2indel.ops import bits as bits_ops

    n = 40000
    bits = (rng.random(n) < 0.07).astype(np.uint8)
    words, counts = bits_ops.bv_build(jnp.asarray(bits))
    positions = np.flatnonzero(bits)
    r = jnp.arange(len(positions), dtype=jnp.int32)
    got = np.asarray(rank.bv_select(words, counts, r))
    np.testing.assert_array_equal(got, positions)


@pytest.mark.parametrize("extract", ["scatter", "select"])
def test_device_clusters_match_host(rng, extract, monkeypatch):
    from ebwt2indel.models import cluster

    if extract == "select":
        monkeypatch.setenv("EBWT_CLUSTER_EXTRACT", "select")
    n = 30000
    thr = (rng.random(n) < 0.5).astype(np.uint8)
    mini = (rng.random(n) < 0.05).astype(np.uint8)
    host = cluster.find_clusters(thr, mini, mcov_out=3)
    dev = cluster.find_clusters_device(jnp.asarray(thr), jnp.asarray(mini),
                                       mcov_out=3)
    np.testing.assert_array_equal(np.asarray(dev.begins), host.begins)
    np.testing.assert_array_equal(np.asarray(dev.ends), host.ends)
    assert dev.n_clusters == host.n_clusters
    assert dev.n_closed == host.n_closed
    assert dev.clust_size_sum == host.clust_size_sum
    np.testing.assert_array_equal(dev.hist, host.hist)


@pytest.mark.parametrize("n", [127, 128, 129, 50000])
def test_lean_upload_blocks_match_host(rng, n):
    """Device-rebuilt count words (lean upload) equal the host packer's."""
    from ebwt2indel.models import fm_index

    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    planes = jnp.asarray(np.ascontiguousarray(pb.blocks[:, :12]))
    blocks, cum = fm_index._build_blocks_from_planes(planes, n=pb.n)
    np.testing.assert_array_equal(np.asarray(blocks), pb.blocks)
    np.testing.assert_array_equal(np.asarray(cum), pb.block_counts)


def test_save_load_packed(tmp_path, rng):
    codes = random_codes(rng, 5000)
    pb = packing.pack_codes(codes)
    p = str(tmp_path / "idx")
    packing.save_packed(pb, p)
    pb2 = packing.load_packed(p + ".npz")
    np.testing.assert_array_equal(pb.blocks, pb2.blocks)
    np.testing.assert_array_equal(pb.F, pb2.F)
    assert pb.n == pb2.n and pb.term == pb2.term


def test_index_cache_roundtrip(tmp_path, rng, monkeypatch):
    from ebwt2indel.models.fm_index import FMIndex
    from ebwt2indel.utils import dna

    codes = random_codes(rng, 3000)
    path = str(tmp_path / "x.ebwt")
    with open(path, "wb") as f:
        f.write(dna.decode_table()[codes].tobytes())
    monkeypatch.setenv("EBWT_INDEX_CACHE", "1")
    fm1 = FMIndex.from_file(path)
    assert (tmp_path / "x.ebwt.idx.npz").exists()
    fm2 = FMIndex.from_file(path)  # loads from cache
    np.testing.assert_array_equal(np.asarray(fm1.blocks),
                                  np.asarray(fm2.blocks))
    assert fm1.n == fm2.n


def test_bv_build_device_matches_host(rng):
    from ebwt2indel.ops import bits as bits_ops

    n = 5000
    b = (rng.random(n) < 0.3).astype(np.uint8)
    words_h, counts_h = packing.pack_bitvector(b)
    words_d, counts_d = bits_ops.bv_build(jnp.asarray(b))
    nw = min(len(words_h), len(words_d))  # host pads one extra block
    nc = min(len(counts_h), len(counts_d))
    np.testing.assert_array_equal(np.asarray(words_d)[:nw], words_h[:nw])
    np.testing.assert_array_equal(np.asarray(counts_d)[:nc], counts_h[:nc])


@pytest.mark.parametrize("use_valid", [False, True])
@pytest.mark.parametrize("wide_frac,budget", [(0.02, 256), (0.5, 4096), (0.5, 4)])
def test_parallel_rank_sorted_matches_dense(rng, wide_frac, budget, use_valid):
    """2-anchor sorted rank equals dense rank: mostly-narrow rows (the
    production regime), many wide rows in one side-loop slice, and many
    wide rows with a tiny budget (forces multiple side-loop iterations).
    With use_valid, masked rows must not disturb valid answers."""
    n = 64 * 128
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    C, k = 500, 6
    start = rng.integers(0, n - 1200, size=C)
    width = np.where(rng.random(C) < wide_frac,
                     rng.integers(300, 1200, size=C),
                     rng.integers(0, 40, size=C))
    offs = np.sort(rng.integers(0, width[:, None] + 1, size=(C, k)), axis=1)
    coords = (start[:, None] + offs).astype(np.int32)
    valid = None
    check = np.ones(C, bool)
    if use_valid:
        check = rng.random(C) < 0.7
        valid = jnp.asarray(check)
    got = np.asarray(rank.parallel_rank_sorted(blocks, jnp.asarray(coords),
                                               budget, valid=valid))
    want = np.asarray(rank.parallel_rank(blocks, jnp.asarray(coords)))
    np.testing.assert_array_equal(got[check], want[check])


@pytest.mark.parametrize("budget_frac", [0.6, 1.2, 0.05])
def test_parallel_rank_dedup_matches_dense(rng, budget_frac):
    """Dedup rank equals dense rank on a run-heavy query vector, for a
    comfortable budget, an over-budget (always-fits) case, and a tiny
    budget that forces the dense fallback branch."""
    n = 6000
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    # run-heavy vector: sorted positions with repeats, like node boundaries
    base = np.sort(rng.integers(0, n + 1, size=300)).astype(np.int32)
    qs = np.repeat(base, rng.integers(1, 5, size=len(base)))
    budget = max(8, int(len(qs) * budget_frac))
    got = np.asarray(
        rank.parallel_rank_dedup(blocks, jnp.asarray(qs), budget)
    )
    want = np.asarray(rank.parallel_rank(blocks, jnp.asarray(qs)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("budget", [8, 64])
def test_parallel_rank_pair1_matches_dense(rng, budget):
    """1-anchor pair rank (leaf lf_range fast path) == dense rank at both
    endpoints, including block-straddling pairs fixed by the side loop."""
    n = 5000
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    C = 300
    first = rng.integers(0, n, size=C).astype(np.int32)
    # mix of same-block (narrow) and straddling (wide) intervals
    width = np.where(rng.random(C) < 0.5,
                     rng.integers(0, 20, size=C),
                     rng.integers(100, 800, size=C)).astype(np.int32)
    second = np.minimum(first + width, n).astype(np.int32)
    got = np.asarray(rank.parallel_rank_pair1(
        blocks, jnp.asarray(first), jnp.asarray(second), budget
    ))
    want = np.asarray(rank.parallel_rank(
        blocks, jnp.asarray(np.stack([first, second], axis=-1))
    ))
    np.testing.assert_array_equal(got, want)


def test_parallel_rank_pair1_valid_mask(rng):
    """Invalid rows are excluded from the wide side pass; valid rows stay
    exact even when every invalid row straddles blocks."""
    n = 4000
    codes = random_codes(rng, n)
    pb = packing.pack_codes(codes)
    blocks = jnp.asarray(pb.blocks)
    C = 64
    first = rng.integers(0, n - 1000, size=C).astype(np.int32)
    second = (first + 900).astype(np.int32)  # all wide
    valid = (np.arange(C) % 2 == 0)
    got = np.asarray(rank.parallel_rank_pair1(
        blocks, jnp.asarray(first), jnp.asarray(second), 16,
        valid=jnp.asarray(valid)
    ))
    want = np.asarray(rank.parallel_rank(
        blocks, jnp.asarray(np.stack([first, second], axis=-1))
    ))
    np.testing.assert_array_equal(got[valid], want[valid])


def test_sparse_term_upload_matches_dense_blocks(rng):
    """EBWT_LEAN_UPLOAD=2 device rebuild (2 planes + sparse TERM scatter)
    is bit-identical to the host packer's full block layout."""
    from ebwt2indel.models import fm_index

    n = 10000
    codes = random_codes(rng, n, p_term=0.01)
    pb = packing.pack_codes(codes)
    tpos = packing.term_positions(pb)
    np.testing.assert_array_equal(np.sort(tpos),
                                  np.flatnonzero(codes == 4))
    blocks, cum = fm_index._build_blocks_sparse_term(
        jnp.asarray(np.ascontiguousarray(pb.blocks[:, :8])),
        jnp.asarray(tpos), n=pb.n,
    )
    np.testing.assert_array_equal(np.asarray(blocks), pb.blocks)
    np.testing.assert_array_equal(np.asarray(cum), pb.block_counts)


def test_lean_upload_levels_identical(rng, monkeypatch):
    """EBWT_LEAN_UPLOAD 0 (full blocks) / 1 (3 planes) / 2 (2 planes +
    sparse TERM) must produce bit-identical device indexes."""
    from ebwt2indel.models import fm_index

    codes = random_codes(rng, 30000, p_term=0.01)
    pb = packing.pack_codes(codes)
    got = {}
    for level in ("0", "1", "2"):
        monkeypatch.setenv("EBWT_LEAN_UPLOAD", level)
        fm = fm_index.FMIndex.from_packed(pb)
        got[level] = (np.asarray(fm.blocks), np.asarray(fm.block_counts))
    for level in ("1", "2"):
        np.testing.assert_array_equal(got[level][0], got["0"][0])
        np.testing.assert_array_equal(got[level][1], got["0"][1])
