"""Unit tests for the unsigned 32-bit coordinate machinery (ops/coords.py).

Positions and counts past 2^31 live in int32 arrays as uint32 bit
patterns (the reference is uint64 end-to-end, include.hpp:25; one run
must carry to BASELINE config 5's ~3 GB BWT). These tests pin the
helpers against numpy uint32 oracles and exercise the 2-D delta-vector
scatter layout used above 2^31 entries.
"""

import numpy as np
import jax  # noqa: F401
import jax.numpy as jnp
import pytest

from ebwt2indel.ops import coords


RNG = np.random.default_rng(7)


def _patterns(k=257):
    """int32 patterns spanning the full uint32 range incl. boundaries."""
    u = np.concatenate([
        RNG.integers(0, 2**32, size=k, dtype=np.uint64).astype(np.uint32),
        np.array([0, 1, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2, 2**32 - 1],
                 dtype=np.uint32),
    ])
    return u.view(np.int32)


def test_pat32_unpat_roundtrip():
    for v in (0, 1, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1, 3_000_000_000):
        p = coords.pat32(v)
        assert -(2**31) <= p < 2**31
        assert np.int32(p) == np.uint32(v).view(np.int32)
        assert coords.unpat(np.int32(p)) == v % 2**32


def test_unsigned_compares_match_numpy():
    a = _patterns()
    b = _patterns()[::-1].copy()
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    au, bu = a.view(np.uint32), b.view(np.uint32)
    np.testing.assert_array_equal(np.asarray(coords.ult(aj, bj)), au < bu)
    np.testing.assert_array_equal(np.asarray(coords.ule(aj, bj)), au <= bu)
    np.testing.assert_array_equal(np.asarray(coords.ugt(aj, bj)), au > bu)
    np.testing.assert_array_equal(np.asarray(coords.uge(aj, bj)), au >= bu)
    np.testing.assert_array_equal(
        np.asarray(coords.umin(aj, bj)).view(np.uint32), np.minimum(au, bu))


def test_unsigned_cummin_and_sort_match_numpy():
    a = _patterns()
    aj = jnp.asarray(a)
    au = a.view(np.uint32)
    want = np.minimum.accumulate(au[::-1])[::-1]
    np.testing.assert_array_equal(
        np.asarray(coords.ucummin_rev(aj)).view(np.uint32), want)
    np.testing.assert_array_equal(
        np.asarray(coords.usort(aj)).view(np.uint32), np.sort(au))


def test_arithmetic_wraps_like_unsigned():
    # the core assumption: +/- on int32 patterns == uint32 modular math
    a = _patterns()
    b = _patterns()[::-1].copy()
    s = np.asarray(jnp.asarray(a) + jnp.asarray(b)).view(np.uint32)
    np.testing.assert_array_equal(s, a.view(np.uint32) + b.view(np.uint32))
    d = np.asarray(jnp.asarray(a) - jnp.asarray(b)).view(np.uint32)
    np.testing.assert_array_equal(s - d, 2 * b.view(np.uint32))


def test_f_char_unsigned_boundaries():
    """f_char's boundary compare must order F values past 2^31."""
    from ebwt2indel.models import fm_index as fm_ops

    class FakeFM:
        F = jnp.asarray(np.array(
            [10, 2**31 - 5, 2**31 + 100, 3_000_000_000],
            dtype=np.uint64).astype(np.uint32).view(np.int32))

    queries = np.array([0, 9, 10, 2**31 - 6, 2**31 - 5, 2**31 + 99,
                        2**31 + 100, 2_999_999_999, 3_000_000_000,
                        2**32 - 1], dtype=np.uint64)
    got = np.asarray(fm_ops.f_char(FakeFM(),
                                   jnp.asarray(queries.astype(np.uint32)
                                               .view(np.int32))))
    bounds = np.array([10, 2**31 - 5, 2**31 + 100, 3_000_000_000],
                      dtype=np.uint64)
    want = np.searchsorted(bounds, queries, side="right").astype(np.int32)
    want = np.where(want == 0, 4, want - 1)
    np.testing.assert_array_equal(got, want)


def test_select_block_unsigned_counters():
    """select_block orders per-block counters as unsigned past 2^31."""
    from ebwt2indel.ops import rank

    # synthetic absolute counters for one char crossing 2^31
    counts_u = np.array([0, 100, 2**31 - 1, 2**31 + 50, 3_000_000_000,
                         2**32 - 10], dtype=np.uint64)
    bc = np.zeros((len(counts_u), 4), dtype=np.uint32)
    bc[:, 2] = counts_u.astype(np.uint32)
    block_counts = jnp.asarray(bc.view(np.int32))
    # r-th occurrence (0-based) -> containing block b satisfies
    # counts[b] <= r < counts[b+1]
    r_u = np.array([0, 99, 100, 2**31 - 2, 2**31 - 1, 2**31 + 49,
                    2**31 + 50, 2_999_999_999, 3_000_000_000], np.uint64)
    want = np.searchsorted(counts_u, r_u, side="right") - 1
    got = np.asarray(rank.select_block(
        block_counts,
        jnp.asarray(r_u.astype(np.uint32).view(np.int32)),
        jnp.full(len(r_u), 2, jnp.int32)))
    np.testing.assert_array_equal(got, want)


def test_dif_scatter_split_addressing():
    """The (lo, hi) split delta scatter: position patterns below _SPLIT
    land in lo (signed index), patterns at/above it land in hi via a
    wrapping subtract, and out-of-range patterns (incl. the dummy) drop
    in both pieces — negative indices must never reach a scatter (JAX
    wraps them Python-style instead of dropping). Tested with small
    pieces: lo covers [0, 64), hi covers [_SPLIT, _SPLIT+64) — the
    production mapping with lo_size shrunk (production lo = _SPLIT
    entries, gap-free)."""
    from ebwt2indel.models import traverse

    sz = 64
    SP = traverse._SPLIT
    idx_u = np.array([0, 5, sz - 1, sz,        # lo hits + one OOB
                      SP, SP + 5, SP + sz,     # hi hits + one OOB
                      SP - 1, 2**31, 3_000_000_000, 2**32 - 1,  # gap/far
                      2 * sz], dtype=np.uint64)
    idx = jnp.asarray(idx_u.astype(np.uint32).view(np.int32))
    val = jnp.asarray(np.arange(1, len(idx_u) + 1, dtype=np.int32))

    lo, hi = traverse._dif_scatter(
        (jnp.zeros(sz, jnp.int32), jnp.zeros(sz, jnp.int32)), idx, val)

    want_lo = np.zeros(sz, np.int32)
    want_hi = np.zeros(sz, np.int32)
    for u, v in zip(idx_u, np.asarray(val)):
        if u < sz:
            want_lo[u] += v
        elif SP <= u < SP + sz:
            want_hi[u - SP] += v
    np.testing.assert_array_equal(np.asarray(lo), want_lo)
    np.testing.assert_array_equal(np.asarray(hi), want_hi)
    assert traverse._dif_size((lo, hi)) == 2 * sz
    assert int(traverse._dif_dummy((lo, hi))) == coords.pat32(2 * sz)


@pytest.mark.parametrize("body", ["single", "pair"])
def test_traversal_parity_1d_vs_2d_dif(body, tmp_path, monkeypatch):
    """Forcing the huge (2-D dif + lean) layout on a small input must
    reproduce the default result bit-for-bit: same traversal, different
    delta addressing (the layout used for real above 2^31 entries)."""
    from ebwt2indel.models import traverse
    from ebwt2indel.models.fm_index import FMIndex
    from ebwt2indel.tools import ebwt as ebwt_tool

    reads = ["ACGTACGGTTACA", "ACGTACCGTTACA", "TTACGGAACCGTA",
             "GGACGTACGGTTA", "CATTACGGAACCG"]
    e1 = ebwt_tool.ebwt_of_reads(reads)
    e2 = ebwt_tool.ebwt_of_reads([r[::-1] for r in reads])
    p1, p2 = tmp_path / "a.ebwt", tmp_path / "b.ebwt"
    p1.write_text(e1)
    p2.write_text(e2)
    fm1 = FMIndex.from_file(str(p1))
    fm2 = FMIndex.from_file(str(p2))

    if body == "single":
        run = lambda: traverse.navigate_one_bwt(fm1, 2, 3)  # noqa: E731
    else:
        run = lambda: traverse.navigate_two_bwts(  # noqa: E731
            fm1, fm2, 2, 3)

    base = run()
    monkeypatch.setenv("EBWT_FORCE_HUGE_DIF", "1")
    monkeypatch.setattr(traverse, "_LEAN_N", 0)
    alt = run()

    # the huge path emits bit-packed flag words (TraversalResult.packed)
    assert alt.packed and not base.packed
    n = fm1.n if body == "single" else fm1.n + fm2.n
    for attr in ("thr_K", "thr_R", "minima", "da"):
        b, a = getattr(base, attr), getattr(alt, attr)
        if b is None:
            assert a is None
            continue
        bits = np.unpackbits(
            np.asarray(a).view(np.uint8), bitorder="little")[:n]
        np.testing.assert_array_equal(np.asarray(b), bits, err_msg=attr)


def test_udiv_umax_uclip_match_numpy():
    """Round-5 helpers backing the sharded mesh path: unsigned owner
    routing (udiv), select clamp (umax/uclip)."""
    a = _patterns()
    au = a.view(np.uint32)
    aj = jnp.asarray(a)
    for d in (1, 7, 97, 2**20 + 3):
        np.testing.assert_array_equal(
            np.asarray(coords.udiv(aj, d)).view(np.uint32), au // d)
    b = _patterns()[::-1].copy()
    np.testing.assert_array_equal(
        np.asarray(coords.umax(aj, jnp.asarray(b))).view(np.uint32),
        np.maximum(au, b.view(np.uint32)))
    lo = _patterns()
    hi_u = np.maximum(lo.view(np.uint32), _patterns().view(np.uint32))
    got = coords.uclip(aj, jnp.asarray(lo), jnp.asarray(hi_u.view(np.int32)))
    np.testing.assert_array_equal(
        np.asarray(got).view(np.uint32),
        np.clip(au, lo.view(np.uint32), hi_u))
