"""Traversal oracle tests: the wavefront traversal must reproduce the exact
LCP_threshold / LCP_minima / DA semantics of the reference's DFS, validated
against brute-force SA/LCP on small random read sets (the resurrected oracle
of ebwt2InDel.cpp:1348-1366)."""

import numpy as np
import pytest

from ebwt2indel.models import fm_index, traverse
from ebwt2indel.ops import packing
from ebwt2indel.utils import dna
from tests import oracle


def build_fm(reads):
    bwt = oracle.ebwt_from_reads(reads)
    codes = dna.str_to_codes(bwt)
    fm = fm_index.FMIndex.from_packed(packing.pack_codes(codes))
    return fm, codes


def minima_expected(lcp, n):
    """What the reference actually marks (ebwt2InDel.cpp:357-391) — a subset
    of true LCP minima: only at borders first_C/first_G/first_T of some node,
    with a preceding non-TERM child of size >= 2 and border < last-1.
    For the purpose of this test we check against the mathematical minima
    property only where the tool marks them: every marked position must be a
    real LCP minimum (LCP[i-1] > LCP[i] and LCP[i+1] >= LCP[i])."""
    return oracle.lcp_minima_oracle(lcp)


@pytest.mark.parametrize("seed,n_reads,length", [
    (1, 8, 20), (2, 20, 15), (3, 40, 30), (4, 5, 50),
])
def test_navigate_one_bwt_lcp_threshold(seed, n_reads, length):
    rng = np.random.default_rng(seed)
    genome = "".join(rng.choice(list("ACGT"), size=200))
    reads = oracle.random_reads(rng, n_reads, length, mutate_from=genome)
    fm, codes = build_fm(reads)
    lcp, _, _ = oracle.sa_of_bwt(codes)

    K, k_right = 5, 8
    res = traverse.navigate_one_bwt(fm, K, k_right)
    thr_K = np.asarray(res.thr_K)
    thr_R = np.asarray(res.thr_R)
    minima = np.asarray(res.minima)

    exp_K, exp_R = oracle.lcp_threshold_oracle(lcp, K, k_right)
    # position 0 is never written by the traversal (LCP[0] undefined);
    # the reference leaves LCP_threshold[0]=0 too (vector init, cpp:571)
    exp_K[0] = exp_R[0] = 0
    np.testing.assert_array_equal(thr_K, exp_K)
    np.testing.assert_array_equal(thr_R, exp_R)

    # every marked minimum must be a true LCP minimum
    true_min = minima_expected(lcp, fm.n)
    assert np.all(true_min[minima == 1] == 1)


def test_leaf_wide_fallback_matches_packed(rng, monkeypatch):
    """Forcing the int32-per-field leaf programs (as on pathological
    >=2^15-depth inputs) must give identical flags to the packed dual-lane
    default, in both single and pair navigation."""
    from ebwt2indel.models import traverse as T

    genome = "".join(rng.choice(list("ACGT"), size=200))
    reads = oracle.random_reads(rng, 20, 25, mutate_from=genome)
    reads2 = oracle.random_reads(rng, 15, 25, mutate_from=genome)
    fm, _ = build_fm(reads)
    fm2, _ = build_fm(reads2)

    packed1 = traverse.navigate_one_bwt(fm, 5, 8)
    packed2 = traverse.navigate_two_bwts(fm, fm2, 4, 6)
    # force the mid cascade branch (dual-lane + DA-area pair layout)
    monkeypatch.setattr(T, "_LANE3_SAFE_DEPTH", 0)
    dual2 = traverse.navigate_two_bwts(fm, fm2, 4, 6)
    # force the int32-per-field programs (single + pair)
    monkeypatch.setattr(T, "_LANE_SAFE_DEPTH", 0)
    wide1 = traverse.navigate_one_bwt(fm, 5, 8)
    wide2 = traverse.navigate_two_bwts(fm, fm2, 4, 6)
    for a, b in ((packed1, wide1), (packed2, dual2), (packed2, wide2)):
        np.testing.assert_array_equal(np.asarray(a.thr_K),
                                      np.asarray(b.thr_K))
        np.testing.assert_array_equal(np.asarray(a.thr_R),
                                      np.asarray(b.thr_R))
        np.testing.assert_array_equal(np.asarray(a.minima),
                                      np.asarray(b.minima))
    for b in (dual2, wide2):
        np.testing.assert_array_equal(np.asarray(packed2.da),
                                      np.asarray(b.da))


def test_navigate_two_bwts_matches_merged(rng):
    genome = "".join(rng.choice(list("ACGT"), size=150))
    reads1 = oracle.random_reads(rng, 12, 25, mutate_from=genome)
    reads2 = oracle.random_reads(rng, 10, 25, mutate_from=genome)
    fm1, codes1 = build_fm(reads1)
    fm2, codes2 = build_fm(reads2)

    K, k_right = 4, 6
    res = traverse.navigate_two_bwts(fm1, fm2, K, k_right)

    # oracle: merged collection = all suffixes of both collections sorted;
    # DA[i] = which collection the i-th smallest suffix comes from, with
    # collection-1 suffixes preceding collection-2 suffixes on ties
    # (update_DA semantics, ebwt2InDel.cpp:394-449)
    _, _, suf1 = oracle.sa_of_bwt(codes1)
    _, _, suf2 = oracle.sa_of_bwt(codes2)
    tagged = [(s, 0, i) for i, s in enumerate(suf1)] + [
        (s, 1, i) for i, s in enumerate(suf2)
    ]

    def skey(item):
        s = item[0]
        # '#' smallest; ties between equal strings: collection 0 first
        return ([{"#": 0, "A": 1, "C": 2, "G": 3, "T": 4}[ch] for ch in s],
                item[1])

    tagged.sort(key=skey)
    da_exp = np.array([t[1] for t in tagged], dtype=np.uint8)
    np.testing.assert_array_equal(np.asarray(res.da), da_exp)

    # merged LCP
    n = fm1.n + fm2.n
    lcp = np.zeros(n, dtype=np.int64)
    for i in range(1, n):
        a, b = tagged[i - 1][0], tagged[i][0]
        k = 0
        while k < min(len(a), len(b)) and a[k] == b[k] and a[k] != "#":
            k += 1
        lcp[i] = k
    exp_K, exp_R = oracle.lcp_threshold_oracle(lcp, K, k_right)
    exp_K[0] = exp_R[0] = 0
    np.testing.assert_array_equal(np.asarray(res.thr_K), exp_K)
    np.testing.assert_array_equal(np.asarray(res.thr_R), exp_R)

    true_min = oracle.lcp_minima_oracle(lcp)
    got_min = np.asarray(res.minima)
    assert np.all(true_min[got_min == 1] == 1)

    assert res.stats["da_values"] == n


def test_queue_roll_reclaim_matches_large_queue(rng):
    """Force the in-loop queue-space reclamation (roll) path with a tiny
    queue capacity and verify flags match a roomy-queue run."""
    import jax.numpy as jnp

    from ebwt2indel.models import traverse as T

    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = oracle.random_reads(rng, 30, 40, mutate_from=genome)
    fm, codes = build_fm(reads)
    n = fm.n
    init = jnp.asarray(fm.root()[None, :].astype(np.int32))

    def run(cap):
        q = jnp.zeros((cap + 4 * T.CHUNK) * 7, jnp.int32)
        q = q.at[:7].set(init.reshape(-1))
        flags = (jnp.zeros(T._flag_words(n), jnp.int32),)
        head, tail = jnp.int32(0), jnp.int32(1)
        stats, maxp = jnp.zeros(4, jnp.int32), jnp.int32(1)
        first = True
        while True:
            (q, head, tail, overflow, flags, log_i, log_v, eoff, stats,
             maxp) = T._queue_phase_dispatch(
                (fm,), q, flags, head, tail, stats, maxp,
                body=T._node_body, w=7, chunk=T.CHUNK,
                K=5, k_right=8, max_iters=1 << 30, with_ramp=first,
            )
            if log_i is not None:
                m_fill = -(-max(int(eoff), 1) // T._APPLY_SLICE) * \
                    T._APPLY_SLICE
                m_fill = min(m_fill, log_i.shape[0])
                flags = T._apply_log(flags, log_i[:m_fill],
                                     log_v[:m_fill])
            first = False
            assert not bool(overflow), cap
            if int(head) >= int(tail):
                break
        return np.asarray(flags[0]), np.asarray(stats)

    big_nf, big_stats = run(1 << 21)
    # tiny capacity: total nodes far exceed it, so rolls must trigger
    small_nf, small_stats = run(256)
    np.testing.assert_array_equal(small_nf, big_nf)
    np.testing.assert_array_equal(small_stats, big_stats)


def test_split_lanes3_roundtrip():
    """Tri-lane packed word decode is exact across the full lane ranges
    (|netK|, |netR| < 2^10; |netDA| < 2^9)."""
    import itertools

    import jax.numpy as jnp

    vals = [-511, -480, -17, -1, 0, 1, 29, 480, 511]
    ks, rs, ds = zip(*itertools.product(vals, vals, vals))
    ks, rs, ds = (np.asarray(x, np.int32) for x in (ks, rs, ds))
    word = ks + (rs << 11) + (ds << 22)
    gk, gr, gd = traverse._split_lanes3(jnp.asarray(word))
    np.testing.assert_array_equal(np.asarray(gk), ks)
    np.testing.assert_array_equal(np.asarray(gr), rs)
    np.testing.assert_array_equal(np.asarray(gd), ds)


@pytest.mark.parametrize("budget", [None, 7, 64])
def test_compact_cm_matches_transposed_compact(budget):
    """Fused char-major compaction == transpose + row-major compaction,
    on the kept prefix (rows past the count are unspecified)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(7)
    C, k, w = 50, 4, 7
    flat_rm = rng.integers(0, 1000, size=(C * k, w)).astype(np.int32)
    keep = rng.random((C, k)) < 0.3
    got, n_got = traverse._compact_cm(jnp.asarray(flat_rm),
                                      jnp.asarray(keep), budget=budget)
    want, n_want = traverse._compact(
        jnp.asarray(np.swapaxes(flat_rm.reshape(C, k, w), 0, 1)
                    .reshape(k * C, w)),
        jnp.asarray(np.swapaxes(keep, 0, 1).reshape(k * C)),
    )
    assert int(n_got) == int(n_want)
    m = int(n_got)
    np.testing.assert_array_equal(np.asarray(got)[:m], np.asarray(want)[:m])


@pytest.mark.parametrize("budget", [3, 16, 200])
def test_compact_sliced_prefix(budget):
    """Budget-sliced row-major compaction matches gather-all on the kept
    prefix across slice counts (0, several, partial-final)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    m, w = 120, 5
    flat = rng.integers(0, 99, size=(m, w)).astype(np.int32)
    for frac in (0.0, 0.2, 1.0):
        keep = rng.random(m) < frac
        got, n_got = traverse._compact(jnp.asarray(flat), jnp.asarray(keep),
                                       budget=budget)
        want, n_want = traverse._compact(jnp.asarray(flat),
                                         jnp.asarray(keep))
        assert int(n_got) == int(n_want) == int(keep.sum())
        c = int(n_got)
        np.testing.assert_array_equal(np.asarray(got)[:c],
                                      np.asarray(want)[:c])


def test_ramp_loop_equivalence(rng, monkeypatch):
    """The small-chunk ramp prelude must not change any flag or count
    (writes are order-free; chunking is an execution detail)."""
    from ebwt2indel.models import traverse as T

    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = oracle.random_reads(rng, 25, 30, mutate_from=genome)
    reads2 = oracle.random_reads(rng, 20, 30, mutate_from=genome)
    fm, _ = build_fm(reads)
    fm2, _ = build_fm(reads2)

    on1 = traverse.navigate_one_bwt(fm, 5, 8)
    on2 = traverse.navigate_two_bwts(fm, fm2, 4, 6)
    monkeypatch.setattr(T, "_RAMP", 0)
    T._queue_phase_dispatch.clear_cache()  # _RAMP is baked in at trace time
    off1 = traverse.navigate_one_bwt(fm, 5, 8)
    off2 = traverse.navigate_two_bwts(fm, fm2, 4, 6)
    T._queue_phase_dispatch.clear_cache()
    for a, b in ((on1, off1), (on2, off2)):
        np.testing.assert_array_equal(np.asarray(a.thr_K),
                                      np.asarray(b.thr_K))
        np.testing.assert_array_equal(np.asarray(a.thr_R),
                                      np.asarray(b.thr_R))
        np.testing.assert_array_equal(np.asarray(a.minima),
                                      np.asarray(b.minima))
        assert a.stats["leaves"] == b.stats["leaves"]
        assert a.stats["nodes"] == b.stats["nodes"]
        assert a.stats["lcp_values"] == b.stats["lcp_values"]
    np.testing.assert_array_equal(np.asarray(on2.da), np.asarray(off2.da))



def test_bounded_dispatch_and_checkpoint_resume(tmp_path, rng, monkeypatch):
    """Multi-dispatch execution (tiny EBWT_DISPATCH_ITERS) must produce
    identical flags to a single-dispatch run, and a phase interrupted at
    a checkpoint must resume to the same result (SURVEY.md §5 traversal
    checkpoint)."""
    from ebwt2indel.models import traverse as T

    genome = "".join(rng.choice(list("ACGT"), size=400))
    reads = oracle.random_reads(rng, 40, 40, mutate_from=genome)
    fm, codes = build_fm(reads)

    want = T.navigate_one_bwt(fm, 5, 8)

    # small chunks + no ramp so the tiny input spans many dispatches
    monkeypatch.setattr(T, "_DISPATCH_ITERS", 2)
    monkeypatch.setattr(T, "CHUNK", 64)
    monkeypatch.setattr(T, "_RAMP", 0)
    got = T.navigate_one_bwt(fm, 5, 8)
    np.testing.assert_array_equal(np.asarray(got.thr_K),
                                  np.asarray(want.thr_K))
    np.testing.assert_array_equal(np.asarray(got.minima),
                                  np.asarray(want.minima))
    assert got.stats == want.stats

    # checkpoint every dispatch; interrupt by raising inside the body via
    # a dispatch-count trip wire, then resume from the saved state
    monkeypatch.setenv("EBWT_CKPT_DIR", str(tmp_path))
    monkeypatch.setenv("EBWT_CKPT_EVERY", "1")
    real_dispatch = T._queue_phase_dispatch
    calls = {"n": 0}

    def tripwire(*a, **k):
        calls["n"] += 1
        if calls["n"] == 3:
            raise KeyboardInterrupt("simulated preemption")
        return real_dispatch(*a, **k)

    monkeypatch.setattr(T, "_queue_phase_dispatch", tripwire)
    try:
        T.navigate_one_bwt(fm, 5, 8)
        raise AssertionError("tripwire did not fire")
    except KeyboardInterrupt:
        pass
    import os as _o

    assert any(f.startswith("phase_") for f in _o.listdir(tmp_path))
    monkeypatch.setattr(T, "_queue_phase_dispatch", real_dispatch)
    resumed = T.navigate_one_bwt(fm, 5, 8)
    np.testing.assert_array_equal(np.asarray(resumed.thr_K),
                                  np.asarray(want.thr_K))
    np.testing.assert_array_equal(np.asarray(resumed.thr_R),
                                  np.asarray(want.thr_R))
    np.testing.assert_array_equal(np.asarray(resumed.minima),
                                  np.asarray(want.minima))
    assert not any(f.startswith("phase_") for f in _o.listdir(tmp_path))
