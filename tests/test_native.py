"""Native C++ packer must agree exactly with the numpy packer."""

import numpy as np
import pytest

from ebwt2indel.ops import packing
from ebwt2indel.utils import dna
from tests.test_rank import random_codes

native = pytest.importorskip("ebwt2indel.ops.native")


def test_native_pack_matches_numpy(rng):
    codes = random_codes(rng, 100000, p_term=0.03)
    ascii_data = dna.decode_table()[codes]
    pb_np = packing.pack_codes(codes)
    pb_nat = native.pack_bytes(ascii_data)
    np.testing.assert_array_equal(pb_nat.blocks, pb_np.blocks)
    np.testing.assert_array_equal(pb_nat.block_counts, pb_np.block_counts)
    np.testing.assert_array_equal(pb_nat.F, pb_np.F)
    np.testing.assert_array_equal(pb_nat.counts, pb_np.counts)
    assert pb_nat.n == pb_np.n


def test_native_rejects_forbidden(rng):
    data = np.frombuffer(b"ACGTX#", dtype=np.uint8)
    with pytest.raises(ValueError, match="forbidden character 'X'"):
        native.pack_bytes(data)


def test_native_pack_da(tmp_path, rng):
    n = 33000
    bits = (rng.random(n) < 0.4).astype(np.uint8)
    path = tmp_path / "da.txt"
    path.write_bytes(bytes((b"01"[b] for b in bits)))
    got_bits, words, counts = native.pack_da_file(str(path), n)
    np.testing.assert_array_equal(got_bits, bits)
    exp_words, exp_counts = packing.pack_bitvector(bits)
    np.testing.assert_array_equal(words, exp_words)
    np.testing.assert_array_equal(counts, exp_counts)


def test_range_packing_assembles_to_full_pack(tmp_path, rng):
    """pack_file_range over any shard split + exscanned bases reproduces
    pack_file's blocks/counters bit-for-bit (the sharded loader's
    correctness contract)."""
    from ebwt2indel.ops import packing

    for n in (5000, 128 * 7, 128 * 7 + 1, 300):
        raw = rng.choice(
            np.frombuffer(b"ACGT#", dtype=np.uint8), size=n
        ).astype(np.uint8)
        path = str(tmp_path / f"r{n}.ebwt")
        raw.tofile(path)
        full = packing.pack_file(path)
        for n_shards in (1, 3, 8):
            ranges = packing.shard_row_ranges(n, n_shards)
            assert ranges[-1][1] == n // 128 + 1
            base = np.zeros(4, np.int64)
            rows_all, counts_all = [], []
            for lo, hi in ranges:
                sp = packing.pack_file_range(path, lo, hi, n)
                tot = sp.totals[:4].copy()
                packing.apply_shard_base(sp, base)
                base += tot
                rows_all.append(sp.rows)
                counts_all.append(sp.row_counts)
            rows = np.concatenate(rows_all)
            counts = np.concatenate(counts_all)
            np.testing.assert_array_equal(rows, full.blocks)
            np.testing.assert_array_equal(counts, full.block_counts)
            np.testing.assert_array_equal(base, full.counts[:4])


def test_shard_fm_from_file_matches_shard_fm(tmp_path, rng):
    """The per-range sharded loader builds device arrays identical to the
    full-pack shard_fm path on the 8-device virtual mesh."""
    from ebwt2indel.ops import packing
    from ebwt2indel.parallel import shard

    raw = rng.choice(
        np.frombuffer(b"ACGT#", dtype=np.uint8), size=40_000
    ).astype(np.uint8)
    path = str(tmp_path / "r.ebwt")
    raw.tofile(path)

    mesh = shard.make_mesh(8)
    ref = shard.shard_fm(packing.pack_file(path), mesh)
    got = shard.shard_fm_from_file(path, mesh)
    np.testing.assert_array_equal(np.asarray(got.blocks),
                                  np.asarray(ref.blocks))
    np.testing.assert_array_equal(np.asarray(got.block_counts),
                                  np.asarray(ref.block_counts))
    np.testing.assert_array_equal(np.asarray(got.F), np.asarray(ref.F))
    np.testing.assert_array_equal(np.asarray(got.bounds),
                                  np.asarray(ref.bounds))
    assert got.rows == ref.rows and got.n == ref.n
    assert got.local_bytes == 40_000  # single process packs everything
