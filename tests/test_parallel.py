"""Sharded-execution tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ebwt2indel.ops import packing
from ebwt2indel.parallel import shard
from tests import oracle
from tests.test_rank import random_codes


def test_sharded_rank_matches_local(rng):
    assert jax.device_count() >= 8
    mesh = shard.make_mesh(8)
    codes = random_codes(rng, 50000)
    pb = packing.pack_codes(codes)
    blocks, bcounts, F, rows = shard.shard_packed(pb, mesh)
    ranker = shard.sharded_parallel_rank(mesh, rows)
    qs = rng.integers(0, pb.n + 1, size=256).astype(np.int32)
    got = np.asarray(jax.jit(ranker)(blocks, jnp.asarray(qs)))
    for q, row in zip(qs, got):
        np.testing.assert_array_equal(row, oracle.rank_oracle(codes, int(q)))


def test_sharded_rank_skewed_queries_fallback(rng):
    """All queries landing on ONE shard overflows the 2B/n_dev compaction
    buffer and must take the dense-decode fallback — answers still exact."""
    mesh = shard.make_mesh(8)
    codes = random_codes(rng, 50000)
    pb = packing.pack_codes(codes)
    blocks, bcounts, F, rows = shard.shard_packed(pb, mesh)
    ranker = shard.sharded_parallel_rank(mesh, rows)
    # every query inside shard 0's position range [0, rows*128)
    qs = rng.integers(0, min(rows * 128, pb.n), size=512).astype(np.int32)
    got = np.asarray(jax.jit(ranker)(blocks, jnp.asarray(qs)))
    for q, row in zip(qs[:64], got[:64]):
        np.testing.assert_array_equal(row, oracle.rank_oracle(codes, int(q)))


def test_sharded_sorted_rank_matches_dense(rng):
    """Owned-anchor narrow rank on the mesh equals the dense sharded rank
    on sorted coordinate tuples with narrow, wide, and skewed rows."""
    from functools import partial
    from jax.sharding import PartitionSpec as P

    mesh = shard.make_mesh(8)
    codes = random_codes(rng, 60000)
    pb = packing.pack_codes(codes)
    blocks, bcounts, F, rows = shard.shard_packed(pb, mesh)
    C, k = 300, 6
    start = rng.integers(0, pb.n - 1500, size=C)
    width = np.where(rng.random(C) < 0.3,
                     rng.integers(300, 1500, size=C),
                     rng.integers(0, 50, size=C))
    offs = np.sort(rng.integers(0, width[:, None] + 1, size=(C, k)), axis=1)
    coords = (start[:, None] + offs).astype(np.int32)

    @partial(jax.shard_map, mesh=mesh, in_specs=(P(shard.AXIS, None), P()),
             out_specs=P(), check_vma=False)
    def run(blocks_l, q):
        return jax.lax.psum(
            shard.local_parallel_rank_sorted(blocks_l, rows, q, budget=64),
            shard.AXIS,
        )

    got = np.asarray(jax.jit(run)(blocks, jnp.asarray(coords)))
    from ebwt2indel.ops import rank as rank_ops

    want = np.asarray(rank_ops.parallel_rank(jnp.asarray(pb.blocks),
                                             jnp.asarray(coords)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,p_term,K,k_right", [
    (60000, 0.02, 5, 8),
    (4097, 0.05, 3, 6),    # barely more than one block row per shard
    (900, 0.06, 2, 4),     # ONE block row per shard: spill-heavy borders
    (130000, 0.008, 8, 12),  # long reads -> deep, narrow nodes
])
def test_frontier_node_phase_matches_replicated(rng, n, p_term, K, k_right):
    """The frontier-sharded node phase (per-shard queues, all_to_all child
    routing, halo'd local narrow rank) must produce the exact flags and
    visit/LCP/minima counts of the replicated-queue sharded phase."""
    from ebwt2indel.parallel import frontier
    from ebwt2indel.parallel import traverse as ptraverse

    mesh = shard.make_mesh(8)
    codes = random_codes(rng, n, p_term=p_term)
    pb = packing.pack_codes(codes)
    fK, fR, fM, fstats, _ = frontier.navigate_nodes_frontier(pb, mesh, K,
                                                          k_right)
    eK, eR, eM, estats = ptraverse.navigate_nodes_sharded(pb, mesh, K,
                                                          k_right)
    np.testing.assert_array_equal(fK, eK)
    np.testing.assert_array_equal(fR, eR)
    np.testing.assert_array_equal(fM, eM)
    assert fstats[0] == estats[0]  # nodes visited
    assert fstats[1] == estats[1]  # lcp values
    assert fstats[2] == estats[2]  # minima


def test_frontier_overflow_retry_paths(rng):
    """Starved budgets (wide buffer, spill buffer, all_to_all segments)
    must trigger the overflow-retry doublings and still converge to the
    exact replicated-phase flags."""
    from ebwt2indel.parallel import frontier
    from ebwt2indel.parallel import traverse as ptraverse

    mesh = shard.make_mesh(8)
    codes = random_codes(rng, 30000, p_term=0.04)
    pb = packing.pack_codes(codes)
    sfm = shard.shard_fm(pb, mesh)
    K, k_right = 4, 7
    fK, fR, fM, _ = frontier.navigate_one_bwt_frontier_device(
        sfm, K, k_right, chunk=256, wbudget=2, fbudget=4, seg=8)
    eK, eR, eM, _ = ptraverse.navigate_one_bwt_sharded_device(
        sfm, K, k_right)
    n = pb.n
    np.testing.assert_array_equal(np.asarray(fK)[:n], np.asarray(eK)[:n])
    np.testing.assert_array_equal(np.asarray(fR)[:n], np.asarray(eR)[:n])
    np.testing.assert_array_equal(np.asarray(fM)[:n], np.asarray(eM)[:n])


def test_frontier_full_navigation_matches_replicated(rng):
    """navigate_one_bwt_frontier_device (leaf + node frontier phases +
    packed-lane combine + reshard) must equal the replicated-queue
    navigate_one_bwt_sharded_device bit for bit."""
    from ebwt2indel.parallel import frontier
    from ebwt2indel.parallel import traverse as ptraverse

    mesh = shard.make_mesh(8)
    codes = random_codes(rng, 50000, p_term=0.03)
    pb = packing.pack_codes(codes)
    sfm = shard.shard_fm(pb, mesh)
    K, k_right = 5, 8
    fK, fR, fM, (ln_f, _) = frontier.navigate_one_bwt_frontier_device(
        sfm, K, k_right)
    eK, eR, eM, (ln_e, _) = ptraverse.navigate_one_bwt_sharded_device(
        sfm, K, k_right)
    assert ln_f == ln_e
    n = pb.n
    np.testing.assert_array_equal(np.asarray(fK)[:n], np.asarray(eK)[:n])
    np.testing.assert_array_equal(np.asarray(fR)[:n], np.asarray(eR)[:n])
    np.testing.assert_array_equal(np.asarray(fM)[:n], np.asarray(eM)[:n])


def test_frontier_pair_navigation_matches_replicated(rng):
    """Frontier-sharded lockstep navigation (modes 2/3) must equal the
    replicated-queue pair navigation bit for bit, including the DA."""
    from ebwt2indel.parallel import frontier
    from ebwt2indel.parallel import traverse as ptraverse

    mesh = shard.make_mesh(8)
    codes1 = random_codes(rng, 30000, p_term=0.03)
    codes2 = random_codes(rng, 26000, p_term=0.03)
    pb1 = packing.pack_codes(codes1)
    pb2 = packing.pack_codes(codes2)
    sfm1 = shard.shard_fm(pb1, mesh)
    sfm2 = shard.shard_fm(pb2, mesh)
    K, k_right = 4, 7
    fK, fR, fM, fD, _ = frontier.navigate_two_bwts_frontier_device(
        sfm1, sfm2, K, k_right)
    eK, eR, eM, eD, _ = ptraverse.navigate_two_bwts_sharded_device(
        sfm1, sfm2, K, k_right)
    n = pb1.n + pb2.n
    np.testing.assert_array_equal(np.asarray(fK)[:n], np.asarray(eK)[:n])
    np.testing.assert_array_equal(np.asarray(fR)[:n], np.asarray(eR)[:n])
    np.testing.assert_array_equal(np.asarray(fM)[:n], np.asarray(eM)[:n])
    np.testing.assert_array_equal(np.asarray(fD)[:n], np.asarray(eD)[:n])


def test_sharded_cluster_scan(rng):
    mesh = shard.make_mesh(8)
    n = 8 * 1000
    thr = (rng.random(n) < 0.4).astype(np.uint8)
    minima = (rng.random(n) < 0.2).astype(np.uint8)
    from jax.sharding import NamedSharding, PartitionSpec as P

    thr_d = jax.device_put(thr, NamedSharding(mesh, P(shard.AXIS)))
    min_d = jax.device_put(minima, NamedSharding(mesh, P(shard.AXIS)))
    scan = shard.sharded_cluster_scan(mesh)
    starts, n_starts, n_in = jax.jit(scan)(thr_d, min_d)

    mask = (thr != 0) & (minima == 0)
    exp_starts = mask & ~np.concatenate([[False], mask[:-1]])
    np.testing.assert_array_equal(np.asarray(starts), exp_starts.astype(np.uint8))
    assert int(n_starts) == int(exp_starts.sum())
    assert int(n_in) == int(mask.sum())


def test_sharded_node_phase_matches_single_device(rng):
    """The full sharded internal-node traversal must produce the same
    LCP-threshold and minima flags as the single-device queue traversal."""
    import jax.numpy as jnp

    from ebwt2indel.models import fm_index, traverse
    from ebwt2indel.parallel import traverse as ptrav
    from ebwt2indel.tools import ebwt as ebwt_tool
    from ebwt2indel.utils import dna

    genome = "".join(rng.choice(list("ACGT"), size=400))
    reads = [genome[i:i + 50] for i in range(0, 340, 3)]
    bwt = ebwt_tool.ebwt_of_reads(reads)
    codes = dna.str_to_codes(bwt)
    from ebwt2indel.ops import packing

    pb = packing.pack_codes(codes)
    K, k_right = 6, 9

    mesh = shard.make_mesh(8)
    thr_K, thr_R, minima, stats = ptrav.navigate_nodes_sharded(
        pb, mesh, K, k_right
    )

    fm = fm_index.FMIndex.from_packed(pb)
    res = traverse.navigate_one_bwt(fm, K, k_right)
    # single-device thr includes the leaf-phase fills; compare the node-phase
    # flags only: minima is written exclusively by the node phase
    np.testing.assert_array_equal(minima, np.asarray(res.minima))
    # node-phase thr bits must be a subset of the full thr, and must cover
    # every position the full traversal marked outside leaf-interior fills
    full_K = np.asarray(res.thr_K)
    assert np.all(full_K[thr_K == 1] == 1)
    assert stats[0] > 0


def test_sharded_pair_navigation_matches_single_device(rng):
    """Sharded lockstep (two-BWT) navigation must reproduce the
    single-device navigate_two_bwts flags — incl. the DA — exactly."""
    from ebwt2indel.models import fm_index, traverse
    from ebwt2indel.ops import packing
    from ebwt2indel.parallel import traverse as ptrav
    from ebwt2indel.tools import ebwt as ebwt_tool
    from ebwt2indel.utils import dna

    genome = "".join(rng.choice(list("ACGT"), size=450))
    reads1 = [genome[i:i + 55] for i in range(0, 390, 5)]
    genome2 = list(genome)
    for p in rng.integers(0, len(genome2), size=6):
        genome2[p] = "ACGT"[rng.integers(0, 4)]
    genome2 = "".join(genome2)
    reads2 = [genome2[i:i + 55] for i in range(2, 390, 5)]
    pb1 = packing.pack_codes(dna.str_to_codes(ebwt_tool.ebwt_of_reads(reads1)))
    pb2 = packing.pack_codes(dna.str_to_codes(ebwt_tool.ebwt_of_reads(reads2)))
    K, k_right = 7, 11

    mesh = shard.make_mesh(8)
    thr_K, thr_R, minima, da, _ = ptrav.navigate_two_bwts_sharded(
        pb1, pb2, mesh, K, k_right
    )

    fm1 = fm_index.FMIndex.from_packed(pb1)
    fm2 = fm_index.FMIndex.from_packed(pb2)
    res = traverse.navigate_two_bwts(fm1, fm2, K, k_right)
    np.testing.assert_array_equal(thr_K, np.asarray(res.thr_K))
    np.testing.assert_array_equal(thr_R, np.asarray(res.thr_R))
    np.testing.assert_array_equal(minima, np.asarray(res.minima))
    np.testing.assert_array_equal(da, np.asarray(res.da))


def test_sharded_full_navigation_matches_single_device(rng):
    """Sharded leaf+node phases must reproduce the single-device
    navigate_one_bwt flags exactly."""
    from ebwt2indel.models import fm_index, traverse
    from ebwt2indel.ops import packing
    from ebwt2indel.parallel import traverse as ptrav
    from ebwt2indel.tools import ebwt as ebwt_tool
    from ebwt2indel.utils import dna

    genome = "".join(rng.choice(list("ACGT"), size=500))
    reads = [genome[i:i + 60] for i in range(0, 430, 4)]
    bwt = ebwt_tool.ebwt_of_reads(reads)
    pb = packing.pack_codes(dna.str_to_codes(bwt))
    K, k_right = 7, 11

    mesh = shard.make_mesh(8)
    thr_K, thr_R, minima, _ = ptrav.navigate_one_bwt_sharded(
        pb, mesh, K, k_right
    )

    fm = fm_index.FMIndex.from_packed(pb)
    res = traverse.navigate_one_bwt(fm, K, k_right)
    np.testing.assert_array_equal(thr_K, np.asarray(res.thr_K))
    np.testing.assert_array_equal(thr_R, np.asarray(res.thr_R))
    np.testing.assert_array_equal(minima, np.asarray(res.minima))


def test_frontier_pair_overflow_retry_and_depth_fallback(rng, monkeypatch):
    """Starved leaf-pair budgets must trigger the overflow-retry doublings;
    a forced tri-lane depth violation must fall back to the replicated
    dense-plane navigation — both byte-identical to the replicated path."""
    from ebwt2indel.models import traverse as T
    from ebwt2indel.parallel import frontier
    from ebwt2indel.parallel import traverse as ptraverse

    mesh = shard.make_mesh(8)
    codes1 = random_codes(rng, 12000, p_term=0.04)
    codes2 = random_codes(rng, 9000, p_term=0.04)
    pb1 = packing.pack_codes(codes1)
    pb2 = packing.pack_codes(codes2)
    sfm1 = shard.shard_fm(pb1, mesh)
    sfm2 = shard.shard_fm(pb2, mesh)
    K, k_right = 4, 7
    eK, eR, eM, eD, _ = ptraverse.navigate_two_bwts_sharded_device(
        sfm1, sfm2, K, k_right)
    n = pb1.n + pb2.n

    fK, fR, fM, fD, _ = frontier.navigate_two_bwts_frontier_device(
        sfm1, sfm2, K, k_right, chunk=128, seg=16, fseg=16)
    for f, e in ((fK, eK), (fR, eR), (fM, eM), (fD, eD)):
        np.testing.assert_array_equal(np.asarray(f)[:n], np.asarray(e)[:n])

    monkeypatch.setattr(T, "_LANE3_SAFE_DEPTH", 0)
    gK, gR, gM, gD, _ = frontier.navigate_two_bwts_frontier_device(
        sfm1, sfm2, K, k_right)
    for f, e in ((gK, eK), (gR, eR), (gM, eM), (gD, eD)):
        np.testing.assert_array_equal(np.asarray(f)[:n], np.asarray(e)[:n])


def test_frontier_work_distribution_scales(rng):
    """The frontier queue machinery's load-balance claim: total processed
    nodes are split across shards (not replicated), the split covers the
    whole tree exactly once, and no shard is pathologically hot on a
    random read-scale input — the measurable half of the ~1/n_dev
    scaling model."""
    from ebwt2indel.parallel import frontier

    codes = random_codes(rng, 120000, p_term=0.01)
    pb = packing.pack_codes(codes)
    K, k_right = 5, 8
    totals = {}
    for n_dev in (2, 8):
        mesh = shard.make_mesh(n_dev)
        *_, stats, work = frontier.navigate_nodes_frontier(pb, mesh, K,
                                                           k_right)
        assert work.shape == (n_dev,)
        assert int(work.sum()) == int(stats[0])  # exact cover, no overlap
        totals[n_dev] = int(stats[0])
        # processed counts include chunk padding rounding; allow slack
        assert int(work.max()) <= max(
            2 * int(stats[0]) // n_dev, int(stats[0]) // n_dev + 8192
        ), f"hot shard at n_dev={n_dev}: {work.tolist()}"
    # total tree work is independent of mesh size (no replication)
    assert totals[2] == totals[8]


def test_pair_route_ab_leg_matches_replicated(rng, monkeypatch):
    """The EBWT_PAIR_ROUTE=0 (round-2 full-chunk all_gather) formulation
    must also stay flag-identical — keeps the A/B leg a real test."""
    from ebwt2indel.parallel import frontier
    from ebwt2indel.parallel import traverse as ptraverse

    monkeypatch.setattr(frontier, "_PAIR_ROUTE", False)
    mesh = shard.make_mesh(8)
    pb1 = packing.pack_codes(random_codes(rng, 12000, p_term=0.03))
    pb2 = packing.pack_codes(random_codes(rng, 11000, p_term=0.03))
    sfm1 = shard.shard_fm(pb1, mesh)
    sfm2 = shard.shard_fm(pb2, mesh)
    fK, fR, fM, fD, _ = frontier.navigate_two_bwts_frontier_device(
        sfm1, sfm2, 4, 7)
    eK, eR, eM, eD, _ = ptraverse.navigate_two_bwts_sharded_device(
        sfm1, sfm2, 4, 7)
    n = pb1.n + pb2.n
    for f, e in ((fK, eK), (fR, eR), (fM, eM), (fD, eD)):
        np.testing.assert_array_equal(np.asarray(f)[:n], np.asarray(e)[:n])


def test_pair_route_comm_volume_accounting():
    """The routed side-2 rank transport's per-step communication is
    O(chunk) per shard — independent of mesh size — while the all_gather
    formulation grows linearly with n_dev (VERDICT r2 #4 'Done'
    criterion). Uses the same byte model the phases implement
    (frontier.comm_bytes_per_step)."""
    from ebwt2indel.parallel import frontier

    chunk = 4096
    for k, w in ((6, 13), (2, 5)):  # node-pair, leaf-pair row shapes
        prev_routed = None
        for n_dev in (2, 4, 8, 16, 64):
            qseg = max(256, 2 * chunk // n_dev)
            routed = frontier.comm_bytes_per_step(
                n_dev, chunk, k, w, qseg, routed=True)
            gathered = frontier.comm_bytes_per_step(
                n_dev, chunk, k, w, qseg, routed=False)
            assert routed < gathered
            # routed volume is flat in n_dev (qseg shrinks as mesh grows)
            if prev_routed is not None and n_dev <= 32:
                assert routed <= prev_routed * 1.01
            prev_routed = routed
        # at pod scale the gap is an order of magnitude+
        assert gathered > 10 * routed


def test_frontier_checkpoint_resume_kill_restart(rng, tmp_path, monkeypatch):
    """Frontier-phase checkpoint/resume (SURVEY §5): a run killed mid-phase
    and restarted from EBWT_CKPT_DIR must produce byte-identical flags to
    an uninterrupted run — for the mode-1 phases and the pair phases."""
    from ebwt2indel.models import traverse as t1
    from ebwt2indel.parallel import frontier

    mesh = shard.make_mesh(8)
    codes1 = random_codes(rng, 40000, p_term=0.03)
    codes2 = random_codes(rng, 30000, p_term=0.03)
    pb1 = packing.pack_codes(codes1)
    pb2 = packing.pack_codes(codes2)
    sfm1 = shard.shard_fm(pb1, mesh)
    sfm2 = shard.shard_fm(pb2, mesh)
    K, k_right = 5, 8

    base1 = frontier.navigate_one_bwt_frontier_device(sfm1, K, k_right)
    base2 = frontier.navigate_two_bwts_frontier_device(sfm1, sfm2, K,
                                                       k_right)

    # small dispatch bound -> several dispatches per phase; checkpoint
    # after every dispatch; crash injection on a chosen dispatch
    monkeypatch.setattr(t1, "_DISPATCH_ITERS", 2)
    monkeypatch.setenv("EBWT_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("EBWT_CKPT_EVERY", "1")

    class Boom(RuntimeError):
        pass

    def crash_after(fn, k):
        calls = {"n": 0}

        def wrapped(*a, **kw):
            calls["n"] += 1
            if calls["n"] == k:
                raise Boom()
            return fn(*a, **kw)

        return wrapped

    # mode 1: kill during the leaf phase, then during the node phase
    orig_leaf = frontier._frontier_leaf_phase
    monkeypatch.setattr(frontier, "_frontier_leaf_phase",
                        crash_after(orig_leaf, 3))
    with pytest.raises(Boom):
        frontier.navigate_one_bwt_frontier_device(sfm1, K, k_right)
    assert (tmp_path / "frontier_m1leaf.npz").is_file()
    monkeypatch.setattr(frontier, "_frontier_leaf_phase", orig_leaf)

    orig_node = frontier._frontier_node_phase
    monkeypatch.setattr(frontier, "_frontier_node_phase",
                        crash_after(orig_node, 3))
    with pytest.raises(Boom):
        frontier.navigate_one_bwt_frontier_device(sfm1, K, k_right)
    assert (tmp_path / "frontier_m1node.npz").is_file()
    monkeypatch.setattr(frontier, "_frontier_node_phase", orig_node)

    got1 = frontier.navigate_one_bwt_frontier_device(sfm1, K, k_right)
    for b, g in zip(base1[:3], got1[:3]):
        np.testing.assert_array_equal(np.asarray(b)[: pb1.n],
                                      np.asarray(g)[: pb1.n])
    # phase completion removes the checkpoints
    assert not (tmp_path / "frontier_m1leaf.npz").is_file()
    assert not (tmp_path / "frontier_m1node.npz").is_file()

    # pair phases: kill during the leaf-pair phase
    orig_pleaf = frontier._frontier_leaf_pair_phase
    monkeypatch.setattr(frontier, "_frontier_leaf_pair_phase",
                        crash_after(orig_pleaf, 3))
    with pytest.raises(Boom):
        frontier.navigate_two_bwts_frontier_device(sfm1, sfm2, K, k_right)
    assert (tmp_path / "frontier_pleaf.npz").is_file()
    monkeypatch.setattr(frontier, "_frontier_leaf_pair_phase", orig_pleaf)

    got2 = frontier.navigate_two_bwts_frontier_device(sfm1, sfm2, K,
                                                      k_right)
    n = pb1.n + pb2.n
    for b, g in zip(base2[:4], got2[:4]):
        np.testing.assert_array_equal(np.asarray(b)[:n], np.asarray(g)[:n])
    assert not (tmp_path / "frontier_pleaf.npz").is_file()
    assert not (tmp_path / "frontier_pnode.npz").is_file()
