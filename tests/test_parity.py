"""Golden byte-parity tests: our pipeline vs the compiled reference binary on
simulated datasets (SURVEY.md §4 implication (c); BASELINE.json configs).

The reference is built into .ref_build/ (gitignored) by `cmake && make`; tests
skip gracefully if the binary is missing.
"""

import os
import subprocess

import numpy as np
import pytest

from ebwt2indel.models import pipeline
from ebwt2indel.tools import ebwt, simulate
from ebwt2indel.utils.config import Config

REF_BIN = os.path.join(os.path.dirname(__file__), "..", ".ref_build",
                       "ebwt2InDel")

needs_ref = pytest.mark.skipif(
    not os.path.isfile(REF_BIN), reason="reference binary not built"
)


def make_dataset(tmp, rng, genome_len=6000, coverage=12, read_len=80):
    genome = simulate.random_genome(rng, genome_len)
    hap2, truth = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                          indel_rate=0.001)
    reads = simulate.sample_reads(rng, genome, coverage / 2, read_len) + \
        simulate.sample_reads(rng, hap2, coverage / 2, read_len)
    bwt = ebwt.ebwt_of_reads(reads)
    path = os.path.join(tmp, "reads.ebwt")
    with open(path, "w") as f:
        f.write(bwt)
    return path, truth


def run_reference(args):
    subprocess.run([REF_BIN] + args, check=True, capture_output=True)


_FLAG_ATTR = {
    "-m": "mcov_out", "-k": "K", "-g": "max_gap", "-v": "max_snvs",
    "-c": "complexity", "-q": "max_variants_per_position",
    "-L": "k_left", "-R": "k_right",
}


def apply_flags(cfg, extra):
    """Mirror the CLI's getopt mapping (cli.py) onto a Config."""
    it = iter(extra)
    for flag, val in zip(it, it):
        setattr(cfg, _FLAG_ATTR[flag], int(val))
    return cfg


# Flag matrix (reference handling: ebwt2InDel.cpp:961-966 for -q in mode 1,
# 872-873/1044-1045 for the pair modes, 1159/1282 for -c).
FLAG_SETS = [
    [],                       # defaults
    ["-m", "2", "-k", "12"],  # lower coverage/LCP thresholds
    ["-g", "3", "-v", "1"],   # smaller gap, stricter SNV filter
    ["-c", "2"],              # aggressive low-complexity context filter
    ["-q", "1"],              # max one variant per position per sample
]

# -q 1 legitimately empties mode-1 output (every event needs two alleles
# from the one sample, ebwt2InDel.cpp:962) — parity is still asserted, but
# skip the "produced events" check. test_mode1_q_filter_triallelic covers
# the discriminating case.
_MAY_EMPTY = {("-q", "1")}


def _may_empty(extra):
    return tuple(extra) in _MAY_EMPTY


@needs_ref
@pytest.mark.parametrize("extra", FLAG_SETS)
def test_mode1_byte_parity(tmp_path, rng, extra):
    path, _ = make_dataset(str(tmp_path), rng)
    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", path, "-o", ref_out] + extra)

    cfg = apply_flags(Config(input1=path, output=got_out), extra)
    pipeline.run_one_dataset(cfg, log=lambda *a, **k: None)

    ref_bytes = open(ref_out, "rb").read()
    got_bytes = open(got_out, "rb").read()
    assert got_bytes == ref_bytes
    assert _may_empty(extra) or len(ref_bytes) > 0


def _make_pair_inputs(tmp_path, rng):
    genome = simulate.random_genome(rng, 5000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads1 = simulate.sample_reads(rng, genome, 8, 80)
    reads2 = simulate.sample_reads(rng, hap2, 8, 80)
    return reads1, reads2


@needs_ref
@pytest.mark.parametrize("extra", FLAG_SETS)
def test_mode2_byte_parity(tmp_path, rng, extra):
    reads1, reads2 = _make_pair_inputs(tmp_path, rng)
    p1 = str(tmp_path / "a.ebwt")
    p2 = str(tmp_path / "b.ebwt")
    open(p1, "w").write(ebwt.ebwt_of_reads(reads1))
    open(p2, "w").write(ebwt.ebwt_of_reads(reads2))

    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", p1, "-2", p2, "-o", ref_out] + extra)
    cfg = apply_flags(Config(input1=p1, input2=p2, output=got_out), extra)
    pipeline.run_two_datasets(cfg, log=lambda *a, **k: None)

    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert _may_empty(extra) or os.path.getsize(ref_out) > 0


@needs_ref
@pytest.mark.parametrize("extra", FLAG_SETS)
def test_mode3_byte_parity(tmp_path, rng, extra):
    reads1, reads2 = _make_pair_inputs(tmp_path, rng)
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    p = str(tmp_path / "merged.ebwt")
    pda = str(tmp_path / "merged.da")
    open(p, "w").write(bwt)
    open(pda, "w").write(da)

    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", p, "-d", pda, "-o", ref_out] + extra)
    cfg = apply_flags(Config(input1=p, input_da=pda, output=got_out), extra)
    pipeline.run_two_datasets_da(cfg, log=lambda *a, **k: None)

    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert _may_empty(extra) or os.path.getsize(ref_out) > 0


@needs_ref
def test_mode1_q_filter_triallelic(tmp_path, rng):
    """-q 2 must discard exactly the tri-allelic clusters (mode-1 filter at
    ebwt2InDel.cpp:962) — build a dataset with deliberate 3-allele sites so
    the filter discriminates (non-empty output that differs from default)."""
    genome = simulate.random_genome(rng, 6000)
    g = np.array(list(genome))
    sites = rng.choice(len(g) - 200, size=12, replace=False) + 100
    h2, h3 = g.copy(), g.copy()
    for p in sites:
        alts = [b for b in "ACGT" if b != g[p]]
        h2[p], h3[p] = alts[0], alts[1]  # three alleles at p across samples
    reads = (simulate.sample_reads(rng, genome, 6, 80)
             + simulate.sample_reads(rng, "".join(h2), 6, 80)
             + simulate.sample_reads(rng, "".join(h3), 6, 80))
    path = str(tmp_path / "tri.ebwt")
    open(path, "w").write(ebwt.ebwt_of_reads(reads))

    outs = {}
    for name, extra in [("def", []), ("q2", ["-q", "2"])]:
        ref_out = str(tmp_path / f"ref_{name}.snp")
        got_out = str(tmp_path / f"got_{name}.snp")
        run_reference(["-1", path, "-o", ref_out, "-m", "2"] + extra)
        cfg = apply_flags(Config(input1=path, output=got_out, mcov_out=2),
                          extra)
        pipeline.run_one_dataset(cfg, log=lambda *a, **k: None)
        outs[name] = open(ref_out, "rb").read()
        assert open(got_out, "rb").read() == outs[name]
    assert len(outs["q2"]) > 0
    assert outs["q2"] != outs["def"]  # the filter actually discriminated


@needs_ref
@pytest.mark.slow
@pytest.mark.parametrize("seed,extra", [
    (11, []),
    (23, ["-m", "3", "-q", "2"]),
])
def test_mode1_randomized_differential_mid_scale(tmp_path, seed, extra):
    """Mid-size (~1.2 Mb BWT) randomized differential run: catches
    cluster-boundary / queue-overflow edge cases the 5 kb fixtures can't
    reach. Runs by default (marked slow; deselect with -m 'not slow')."""
    rng = np.random.default_rng(seed)
    path, _ = make_dataset(str(tmp_path), rng, genome_len=100_000,
                           coverage=12, read_len=100)
    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", path, "-o", ref_out] + extra)
    cfg = apply_flags(Config(input1=path, output=got_out), extra)
    pipeline.run_one_dataset(cfg, log=lambda *a, **k: None)
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert os.path.getsize(ref_out) > 0


def _make_pair_inputs_mid(tmp_path, seed, genome_len=60_000):
    rng = np.random.default_rng(seed)
    genome = simulate.random_genome(rng, genome_len)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.002,
                                      indel_rate=0.0005)
    reads1 = simulate.sample_reads(rng, genome, 8, 100)
    reads2 = simulate.sample_reads(rng, hap2, 8, 100)
    return reads1, reads2


@needs_ref
@pytest.mark.slow
@pytest.mark.parametrize("seed,extra", [(37, []), (41, ["-m", "2"])])
def test_mode2_randomized_differential_mid_scale(tmp_path, seed, extra):
    """Mid-size (~1 Mb merged) mode-2 differential: exercises the lockstep
    pair queues / size-1 leaf recovery / tri-lane deltas at depths and
    frontier sizes the 5 kb fixtures can't reach."""
    reads1, reads2 = _make_pair_inputs_mid(tmp_path, seed)
    p1 = str(tmp_path / "a.ebwt")
    p2 = str(tmp_path / "b.ebwt")
    open(p1, "w").write(ebwt.ebwt_of_reads(reads1))
    open(p2, "w").write(ebwt.ebwt_of_reads(reads2))
    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", p1, "-2", p2, "-o", ref_out] + extra)
    cfg = apply_flags(Config(input1=p1, input2=p2, output=got_out), extra)
    pipeline.run_two_datasets(cfg, log=lambda *a, **k: None)
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert os.path.getsize(ref_out) > 0


@needs_ref
@pytest.mark.slow
def test_mode3_randomized_differential_mid_scale(tmp_path):
    """Mid-size mode-3 differential (merged BWT + DA)."""
    reads1, reads2 = _make_pair_inputs_mid(tmp_path, 53)
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    p = str(tmp_path / "merged.ebwt")
    pda = str(tmp_path / "merged.da")
    open(p, "w").write(bwt)
    open(pda, "w").write(da)
    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", p, "-d", pda, "-o", ref_out])
    cfg = Config(input1=p, input_da=pda, output=got_out)
    pipeline.run_two_datasets_da(cfg, log=lambda *a, **k: None)
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert os.path.getsize(ref_out) > 0


@needs_ref
def test_mode1_fifty_x_with_rc_and_filter(tmp_path, rng):
    """BASELINE config 2: mode 1 on 50x reads incl. reverse complements,
    then filter_snp m=5 — both stages byte-identical to the reference."""
    import io

    from ebwt2indel.tools import filter_snp

    genome = simulate.random_genome(rng, 4000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.004,
                                      indel_rate=0.001)
    reads = simulate.sample_reads(rng, genome, 25, 80, revcomp=True) + \
        simulate.sample_reads(rng, hap2, 25, 80, revcomp=True)
    path = str(tmp_path / "reads50.ebwt")
    open(path, "w").write(ebwt.ebwt_of_reads(reads))

    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", path, "-o", ref_out, "-m", "5"])
    cfg = Config(input1=path, output=got_out, mcov_out=5)
    pipeline.run_one_dataset(cfg, log=lambda *a, **k: None)
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert os.path.getsize(ref_out) > 0

    # filter stage parity
    ref_filtered = subprocess.run(
        [os.path.join(os.path.dirname(REF_BIN), "filter_snp"), ref_out, "5"],
        capture_output=True, text=True,
    ).stdout
    buf = io.StringIO()
    with open(got_out) as f:
        filter_snp.filter_stream(f, 5, 0, buf)
    assert buf.getvalue() == ref_filtered


@needs_ref
def test_memory_lean_paths_byte_parity(tmp_path, rng, monkeypatch):
    """The >=1G memory-envelope code paths (scan-chunked dif fills, packed
    flag combine, packed right-anchor table, sliced cluster-run
    extraction) forced at small n via the lean threshold: outputs must
    stay byte-identical to the reference for modes 1 and 2."""
    from ebwt2indel.models import traverse

    monkeypatch.setattr(traverse, "_LEAN_N", 1000)
    monkeypatch.setattr(traverse, "_LOG_FLAGS_MIN", 0)

    path, _ = make_dataset(str(tmp_path), rng)
    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", path, "-o", ref_out])
    pipeline.run_one_dataset(Config(input1=path, output=got_out),
                             log=lambda *a, **k: None)
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert os.path.getsize(ref_out) > 0

    reads1, reads2 = _make_pair_inputs(tmp_path, rng)
    p1 = str(tmp_path / "a.ebwt")
    p2 = str(tmp_path / "b.ebwt")
    open(p1, "w").write(ebwt.ebwt_of_reads(reads1))
    open(p2, "w").write(ebwt.ebwt_of_reads(reads2))
    ref2 = str(tmp_path / "ref2.snp")
    got2 = str(tmp_path / "got2.snp")
    run_reference(["-1", p1, "-2", p2, "-o", ref2])
    pipeline.run_two_datasets(Config(input1=p1, input2=p2, output=got2),
                              log=lambda *a, **k: None)
    assert open(got2, "rb").read() == open(ref2, "rb").read()
    assert os.path.getsize(ref2) > 0


@needs_ref
def test_huge_packed_paths_byte_parity(tmp_path, rng, monkeypatch):
    """The > 2^31-position code paths — (lo, hi) split delta vectors,
    bit-packed flag combine, packed right-anchor table, packed cluster
    extraction (TraversalResult.packed) — forced at small n via
    EBWT_FORCE_HUGE_DIF: mode-1, mode-2, and mode-3 outputs must stay
    byte-identical to the reference."""
    from ebwt2indel.models import traverse

    monkeypatch.setattr(traverse, "_LEAN_N", 1000)
    monkeypatch.setattr(traverse, "_LOG_FLAGS_MIN", 0)
    monkeypatch.setenv("EBWT_FORCE_HUGE_DIF", "1")

    path, _ = make_dataset(str(tmp_path), rng)
    ref_out = str(tmp_path / "ref.snp")
    got_out = str(tmp_path / "got.snp")
    run_reference(["-1", path, "-o", ref_out])
    pipeline.run_one_dataset(Config(input1=path, output=got_out),
                             log=lambda *a, **k: None)
    assert open(got_out, "rb").read() == open(ref_out, "rb").read()
    assert os.path.getsize(ref_out) > 0

    reads1, reads2 = _make_pair_inputs(tmp_path, rng)
    p1 = str(tmp_path / "a.ebwt")
    p2 = str(tmp_path / "b.ebwt")
    open(p1, "w").write(ebwt.ebwt_of_reads(reads1))
    open(p2, "w").write(ebwt.ebwt_of_reads(reads2))
    ref2 = str(tmp_path / "ref2.snp")
    got2 = str(tmp_path / "got2.snp")
    run_reference(["-1", p1, "-2", p2, "-o", ref2])
    pipeline.run_two_datasets(Config(input1=p1, input2=p2, output=got2),
                              log=lambda *a, **k: None)
    assert open(got2, "rb").read() == open(ref2, "rb").read()
    assert os.path.getsize(ref2) > 0

    # mode 3 on the merged pair + DA
    pm = str(tmp_path / "m.ebwt")
    pd = str(tmp_path / "m.da")
    bwt, da = ebwt.ebwt_and_da_of_two(reads1, reads2)
    open(pm, "w").write(bwt)
    open(pd, "w").write(da)
    ref3 = str(tmp_path / "ref3.snp")
    got3 = str(tmp_path / "got3.snp")
    run_reference(["-1", pm, "-d", pd, "-o", ref3])
    pipeline.run_two_datasets_da(
        Config(input1=pm, input_da=pd, output=got3),
        log=lambda *a, **k: None)
    assert open(got3, "rb").read() == open(ref3, "rb").read()
