"""Parity tests for the post-processing toolchain against the compiled
reference binaries (filter_snp, sam2vcf, vcf_vs_vcf, snp_vs_vcf)."""

import io
import os
import subprocess

import numpy as np
import pytest

from ebwt2indel.tools import (filter_snp, sam2vcf, simulate, snp_vs_vcf,
                                  sort_vcf, vcf_vs_vcf)

REF_DIR = os.path.join(os.path.dirname(__file__), "..", ".ref_build")


def ref_bin(name):
    p = os.path.join(REF_DIR, name)
    return p if os.path.isfile(p) else None


def make_snp_file(tmp_path, rng, n=30):
    """A synthetic .snp file in the emitted format."""
    lines = []
    for i in range(n):
        cov = int(rng.integers(1, 12))
        seq = "".join(rng.choice(list("ACGT"), size=60))
        lines.append(
            f">cluster:{i+1}_id:1_right:30_cov:{cov}_type:_SNP_event:A/C"
        )
        lines.append(seq)
    path = tmp_path / "calls.snp"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("m,M", [(3, 0), (5, 8), (1, 2)])
def test_filter_snp_parity(tmp_path, rng, m, M):
    bin_ = ref_bin("filter_snp")
    if bin_ is None:
        pytest.skip("reference not built")
    path = make_snp_file(tmp_path, rng)
    args = [path, str(m)] + ([str(M)] if M else [])
    ref = subprocess.run([bin_] + args, capture_output=True,
                         text=True).stdout
    out = io.StringIO()
    with open(path) as f:
        filter_snp.filter_stream(f, m, M, out)
    assert out.getvalue() == ref


def make_sam_dataset(tmp_path, rng):
    genome = simulate.random_genome(rng, 2000)
    fasta = tmp_path / "ref.fasta"
    fasta.write_text(">chr1\n" + genome + "\n")
    # synthetic SAM lines with supported cigar shapes
    rows = []
    for i, (cig, nm) in enumerate([
        ("60M", 2), ("5S55M", 1), ("30M2I28M", 3), ("30M2D28M", 3),
        ("60M", 0), ("20M1I39M", 6), ("60M", 1),
    ]):
        pos = int(rng.integers(100, 1500))
        ln = 60 + (2 if "I" in cig else 0)
        seq = list(genome[pos - 1 : pos - 1 + ln])
        # plant mismatches so NM is meaningful
        for _ in range(2):
            p = int(rng.integers(0, len(seq)))
            seq[p] = "ACGT"[int(rng.integers(0, 4))]
        rows.append(
            f"r{i}\t0\tchr1\t{pos}\t60\t{cig}\t*\t0\t0\t{''.join(seq)}\t*"
            f"\tNM:i:{nm}"
        )
    sam = tmp_path / "in.sam"
    sam.write_text("@HD\tVN:1.6\n" + "\n".join(rows) + "\n")
    return str(fasta), str(sam)


def test_sam2vcf_parity(tmp_path, rng):
    bin_ = ref_bin("sam2vcf")
    if bin_ is None:
        pytest.skip("reference not built")
    fasta, sam = make_sam_dataset(tmp_path, rng)
    ref_out = str(tmp_path / "ref.vcf")
    got_out = str(tmp_path / "got.vcf")
    subprocess.run([bin_, "-f", fasta, "-s", sam, "-v", ref_out],
                   check=True, capture_output=True)
    sam2vcf.convert(fasta, sam, got_out, log=lambda *a: None)
    assert open(got_out).read() == open(ref_out).read()


def make_vcf(path, rng, n=40, chrom="chr1"):
    rows = []
    for _ in range(n):
        pos = int(rng.integers(1, 5000))
        if rng.random() < 0.3:
            ref = "".join(rng.choice(list("ACGT"), size=3))
            alt = ref[0]
        else:
            ref = str(rng.choice(list("ACGT")))
            alt = str(rng.choice(list("ACGT")))
        rows.append(f"{chrom}\t{pos}\t.\t{ref}\t{alt}\t100\tPASS\tVT=X")
    with open(path, "w") as f:
        f.write("##fileformat=VCFv4.1\n#CHROM\tPOS\tID\tREF\tALT\n")
        f.write("\n".join(rows) + "\n")


def test_vcf_vs_vcf_parity(tmp_path, rng):
    bin_ = ref_bin("vcf_vs_vcf")
    if bin_ is None:
        pytest.skip("reference not built")
    p1 = str(tmp_path / "a.vcf")
    p2 = str(tmp_path / "b.vcf")
    make_vcf(p1, rng)
    make_vcf(p2, rng)
    ref = subprocess.run([bin_, "-1", p1, "-2", p2], capture_output=True,
                         text=True).stdout
    s = vcf_vs_vcf.score(vcf_vs_vcf.read_vcf(p1), vcf_vs_vcf.read_vcf(p2), 10)
    # compare the TP/FP/FN counters embedded in the reference stdout
    for label, val in [("TP (SNP)", s["TP_s"]), ("FP (SNP)", s["FP_s"]),
                       ("FN (SNP)", s["FN_s"]), ("TP (INDEL)", s["TP_i"]),
                       ("FP (INDEL)", s["FP_i"]), ("FN (INDEL)", s["FN_i"])]:
        assert f"{label} = {val}\n" in ref, (label, val, ref)


def test_snp_vs_vcf_parity(tmp_path, rng):
    bin_ = ref_bin("snp_vs_vcf")
    if bin_ is None:
        pytest.skip("reference snp_vs_vcf not built")
    genome = simulate.random_genome(rng, 4000)
    hap2, truth = simulate.plant_variants(rng, genome, snp_rate=0.005,
                                          indel_rate=0.0)
    fasta = tmp_path / "ref.fasta"
    fasta.write_text(">chr1\n" + genome + "\n")
    vcf = tmp_path / "truth.vcf"
    simulate.write_vcf(str(vcf), truth)

    # KisSNP2-style calls: read pairs around each SNP
    lines = []
    for i, (pos, ref, alt) in enumerate(truth.snps):
        p = pos - 1
        if p < 40 or p + 31 >= len(genome):
            continue
        left = genome[p - 40 : p]
        right = genome[p + 1 : p + 31]
        lines.append(f">SNP_higher_path_{i}|P_1:30_{ref}/{alt}|high|nb_pol_1")
        lines.append(left + ref + right)
        lines.append(f">SNP_lower_path_{i}|P_1:30_{ref}/{alt}|low|nb_pol_1")
        lines.append(left + alt + right)
    calls = tmp_path / "calls.snp"
    calls.write_text("\n".join(lines) + "\n")

    ref_out = subprocess.run(
        [bin_, "-v", str(vcf), "-c", str(calls), "-f", str(fasta)],
        capture_output=True, text=True,
    ).stdout

    refd, contigs = sam2vcf.load_fasta(str(fasta))
    N = sum(len(refd[c]) for c in contigs)
    snp_vs_vcf.load_vcf_calls.k_nonis = 31
    calls_vcf, n_snps, _ = snp_vs_vcf.load_vcf_calls(
        str(vcf), refd, 100, log=lambda *a: None
    )
    s = snp_vs_vcf.validate(str(calls), calls_vcf, n_snps, N,
                            log=lambda *a: None)
    for label, val in [("TP", s["TP"]), ("TN", s["TN"]), ("FP", s["FP"]),
                       ("FN", s["FN"])]:
        assert f"{label} = {val}\n" in ref_out, (label, val, ref_out)


def test_sort_vcf(rng, tmp_path):
    lines = ["##header", "#CHROM\tPOS", "chr2\t5\tx", "chr1\t100\tx",
             "chr1\t20\tx"]
    out = sort_vcf.sort_vcf_lines(lines)
    assert out == ["##header", "#CHROM\tPOS", "chr1\t20\tx", "chr1\t100\tx",
                   "chr2\t5\tx"]


def test_sais_matches_prefix_doubling(rng):
    from ebwt2indel.tools import ebwt as E

    for trial in range(10):
        n = int(rng.integers(2, 2000))
        codes = rng.integers(1, int(rng.integers(2, 6)) + 1,
                             size=n).astype(np.int32)
        codes = np.concatenate([codes, [0]]).astype(np.int32)
        lib = E._native_sais()
        sa = np.empty(len(codes), dtype=np.int32)
        rc = lib.sais_int32(codes.ctypes.data, sa.ctypes.data, len(codes),
                            int(codes.max()) + 1)
        assert rc == 0
        exp = E.suffix_array(codes.astype(np.int64))
        np.testing.assert_array_equal(sa, exp, err_msg=f"trial {trial} n={n}")


def test_ebwt_builders_agree(rng):
    from ebwt2indel.tools import ebwt as E

    genome = "".join(rng.choice(list("ACGT"), size=300))
    reads = [genome[i:i+40] for i in range(0, 250, 7)]
    bwt = E.ebwt_of_reads(reads)
    # invertibility sanity: same multiset of characters
    assert sorted(bwt) == sorted("#".join(reads) + "#")
    bwt2, da = E.ebwt_and_da_of_two(reads[:5], reads[5:])
    assert len(bwt2) == len(da) == len(bwt)
    assert da.count("0") == sum(len(r) + 1 for r in reads[:5])


def test_batch_distance_matches_reference(rng):
    from ebwt2indel.models import emit, emit_vec

    for max_gap in (0, 3, 10):
        P, L = 200, 31
        a = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(P, L))
        b = a.copy()
        # random perturbations incl. shifts (indel-like)
        for i in range(P):
            for _ in range(int(rng.integers(0, 4))):
                b[i, int(rng.integers(0, L))] = rng.choice(
                    np.frombuffer(b"ACGT", np.uint8))
            if rng.random() < 0.4:
                g = int(rng.integers(1, max_gap + 1)) if max_gap else 0
                if g:
                    b[i] = np.concatenate([b[i, g:], b[i, :g]])
        D, G = emit_vec.batch_distance(a, b, max_gap)
        for i in range(P):
            sa = a[i].tobytes().decode()
            sb = b[i].tobytes().decode()
            d = emit.distance(sa, sb, max_gap)
            assert (int(D[i]), int(G[i])) == d, (i, sa, sb, max_gap)


def test_snp_to_fastq(tmp_path):
    from ebwt2indel.tools import snp2vcf

    snp = tmp_path / "c.snp"
    snp.write_text(">cluster:1_id:1_right:3_cov:5_type:_SNP_event:A/C\n"
                   "ACGTACG\n>h2\nTTTT\n")
    fq = tmp_path / "c.fastq"
    snp2vcf.snp_to_fastq(str(snp), str(fq))
    lines = fq.read_text().splitlines()
    assert lines[0] == "@cluster:1_id:1_right:3_cov:5_type:_SNP_event:A/C"
    assert lines[1] == "ACGTACG"
    assert lines[2] == "+"
    assert lines[3] == "h" * 7
    assert lines[4] == "@h2"


def test_pebwt2indel_driver(tmp_path, rng):
    """Process-parallel sharded pipeline runs end to end and emits output."""
    import subprocess
    import sys

    from ebwt2indel.tools import ebwt as E

    genome = simulate.random_genome(rng, 8000)
    hap2, _ = simulate.plant_variants(rng, genome, snp_rate=0.005,
                                      indel_rate=0.0)
    reads = simulate.sample_reads(rng, genome, 10, 80) + \
        simulate.sample_reads(rng, hap2, 10, 80)
    fa = tmp_path / "reads.fa"
    E.write_fasta_reads(str(fa), reads)

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run(
        [sys.executable, "-m", "ebwt2indel.tools.pebwt2indel",
         str(fa), "2", "80", str(tmp_path / "out")],
        capture_output=True, text=True, timeout=600, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    out = tmp_path / "out" / "variants.snp"
    assert out.exists()


def test_genhuge_matrix_builder_matches_ebwt(rng):
    """tools/genhuge.py's vectorized eBWT builder is byte-identical to
    tools/ebwt.ebwt_of_reads on the same read set (pins the multi-G
    dataset generator to the reference-shaped builder at small n)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "genhuge", os.path.join(os.path.dirname(__file__), "..", "tools",
                                "genhuge.py"))
    gh = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gh)
    from ebwt2indel.tools import ebwt as ebwt_mod

    g = rng.integers(0, 4, size=20000)
    genome_u8 = np.frombuffer(b"ACGT", np.uint8)[g].copy()
    gh.CHUNK_READS = 64  # force the chunked paths
    reads = gh.vector_reads(np.random.default_rng(5), genome_u8, 3.0, 50)
    text = np.empty((len(reads), 51), np.uint8)
    text[:, :50] = reads
    text[:, 50] = ord("#")
    got = gh.ebwt_of_read_matrix(text).tobytes().decode()
    want = ebwt_mod.ebwt_of_reads(
        ["".join(map(chr, r)) for r in reads])
    assert got == want


def test_run_huge_report_schema(tmp_path, rng):
    """tools/run_huge.py emits a schema-complete report with parity and
    vs_baseline filled from the reference binary (small-n dry run of the
    REPORT_2G5 capture path)."""
    import json as _json
    import subprocess as _sp
    import sys as _sys

    from ebwt2indel.tools import ebwt as ebwt_mod
    from ebwt2indel.tools import simulate as sim

    g = sim.random_genome(np.random.default_rng(11), 4000)
    reads = sim.sample_reads(np.random.default_rng(12), g, 5, 60)
    inp = tmp_path / "r.ebwt"
    inp.write_text(ebwt_mod.ebwt_of_reads(reads))
    rep = tmp_path / "rep.json"
    repo = os.path.join(os.path.dirname(__file__), "..")
    r = _sp.run(
        [_sys.executable, os.path.join(repo, "tools", "run_huge.py"),
         str(inp), str(tmp_path / "out.snp"), str(rep)],
        capture_output=True, text=True, env={**os.environ},
        timeout=900,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    d = _json.loads(rep.read_text())
    assert d["parity"] is True
    assert d["vs_baseline"] is not None and d["vs_baseline"] > 0
    assert d["warm_seconds"] and d["cold_seconds"] and d["ref_seconds"]
    assert d["positions"] == os.path.getsize(inp)
    assert abs(d["value"] - d["positions"] / d["warm_seconds"]) \
        <= 0.01 * d["value"]


def test_tracetop_keeps_only_gpu_device_tracks(tmp_path, capsys):
    """tools/tracetop.py reduces a trace to the /device:GPU: planes: host
    threads are left out, and a trace with no GPU plane is refused."""
    import gzip
    import importlib.util
    import json as _json
    import sys as _sys

    path = os.path.join(os.path.dirname(__file__), "..", "tools",
                        "tracetop.py")
    spec = importlib.util.spec_from_file_location("tracetop", path)
    tt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tt)

    def meta(pid, name):
        return {"ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": name}}

    events = [meta(1, "/device:GPU:0"), meta(2, "/host:CPU"),
              meta(3, "/device:GPU:1"),
              {"ph": "X", "pid": 1, "name": "fusion.1", "dur": 300.0},
              {"ph": "X", "pid": 3, "name": "fusion.1", "dur": 100.0},
              {"ph": "X", "pid": 2, "name": "PjitFunction", "dur": 9000.0}]
    assert tt.gpu_pids(events) == {1, 3}
    trace = tmp_path / "t.trace.json.gz"
    with gzip.open(trace, "wt") as f:
        _json.dump({"traceEvents": events}, f)
    monkey_argv = ["tracetop.py", str(trace)]
    saved = _sys.argv
    _sys.argv = monkey_argv
    try:
        assert tt.main() == 0
        out = capsys.readouterr().out
        assert "fusion.1" in out and "PjitFunction" not in out
        assert "0.00 s over 2 events" in out
        with gzip.open(trace, "wt") as f:
            _json.dump({"traceEvents": events[1:2] + events[-1:]}, f)
        assert tt.main() == 1
    finally:
        _sys.argv = saved
