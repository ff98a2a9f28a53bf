"""Full validation loop: simulate -> call -> place contexts -> score vs
truth VCF (the reference's documented evaluation workflow, SURVEY.md §4,
with exact-match placement replacing BWA)."""

import os

import numpy as np

from ebwt2indel.models import pipeline
from ebwt2indel.tools import context2vcf, ebwt, simulate, vcf_vs_vcf
from ebwt2indel.utils.config import Config


def test_simulate_call_score(tmp_path, rng):
    genome = simulate.random_genome(rng, 30000)
    hap2, truth = simulate.plant_variants(rng, genome, snp_rate=0.003,
                                          indel_rate=0.0005)
    reads = simulate.sample_reads(rng, genome, 10, 100) + \
        simulate.sample_reads(rng, hap2, 10, 100)
    bwt_path = str(tmp_path / "r.ebwt")
    open(bwt_path, "w").write(ebwt.ebwt_of_reads(reads))

    snp_path = str(tmp_path / "calls.snp")
    cfg = Config(input1=bwt_path, output=snp_path)
    pipeline.run_one_dataset(cfg, log=lambda *a, **k: None)

    fasta = str(tmp_path / "ref.fasta")
    open(fasta, "w").write(">chr1\n" + genome + "\n")
    vcf_truth = str(tmp_path / "truth.vcf")
    simulate.write_vcf(vcf_truth, truth, chrom="chr1")

    vcf_out = str(tmp_path / "calls.vcf")
    stats = context2vcf.convert(snp_path, fasta, vcf_out,
                                log=lambda *a: None)
    assert stats["placed"] > 0

    s = vcf_vs_vcf.score(
        vcf_vs_vcf.read_vcf(vcf_out), vcf_vs_vcf.read_vcf(vcf_truth), 10
    )
    tp, fn, fp = s["TP_s"], s["FN_s"], s["FP_s"]
    sens = tp / max(tp + fn, 1)
    prec = tp / max(tp + fp, 1)
    # at 20x with isolated planted SNPs the caller should find most of them
    # with high precision (generous thresholds to avoid flakiness)
    assert sens >= 0.5, (tp, fn, fp)
    assert prec >= 0.7, (tp, fn, fp)


def test_pebwt2indel_recall_vs_inprocess(tmp_path, rng):
    """Quantify the pebwt2indel recall contract (VERDICT r3 weak #6): the
    reference documents that piece-sharding loses variants whose
    supporting reads land in different pieces (README.md:104-124); our
    central-k-mer context sort stands in for HARC's reordering. Run the
    SAME simulated dataset through the in-process pipeline and through
    pebwt2indel with 4 pieces and report the SNP-sensitivity delta."""
    import subprocess
    import sys

    from ebwt2indel.models import pipeline
    from ebwt2indel.tools import (context2vcf, ebwt, simulate,
                                      sort_vcf, vcf_vs_vcf)
    from ebwt2indel.utils.config import Config

    genome = simulate.random_genome(rng, 60_000)
    hap2, truth = simulate.plant_variants(rng, genome, snp_rate=0.003,
                                          indel_rate=0.0)
    reads = simulate.sample_reads(rng, genome, 10, 80) + \
        simulate.sample_reads(rng, hap2, 10, 80)

    fasta = tmp_path / "ref.fasta"
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i: i + 80] + "\n")
    vcf_truth = tmp_path / "truth.vcf"
    simulate.write_vcf(str(vcf_truth), truth, chrom="chr1")

    def sensitivity(snp_path) -> float:
        vcf_out = str(snp_path) + ".vcf"
        context2vcf.convert(str(snp_path), str(fasta), vcf_out,
                            log=lambda *a: None)
        with open(vcf_out) as f:
            lines = sort_vcf.sort_vcf_lines(f)
        srt = vcf_out + ".sorted"
        with open(srt, "w") as f:
            f.write("\n".join(lines) + "\n")
        s = vcf_vs_vcf.score(vcf_vs_vcf.read_vcf(srt),
                             vcf_vs_vcf.read_vcf(str(vcf_truth)), 10)
        return s["TP_s"] / max(s["TP_s"] + s["FN_s"], 1)

    # in-process (full eBWT)
    full_bwt = tmp_path / "reads.ebwt"
    full_bwt.write_text(ebwt.ebwt_of_reads(reads))
    full_snp = tmp_path / "full.snp"
    pipeline.run_one_dataset(Config(input1=str(full_bwt),
                                    output=str(full_snp)),
                             log=lambda *a, **k: None)
    sens_full = sensitivity(full_snp)

    # pebwt2indel, 4 pieces (driver splits into threads+1... = p-1 pieces)
    reads_fa = tmp_path / "reads.fa"
    ebwt.write_fasta_reads(str(reads_fa), reads)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..")
    r = subprocess.run(
        [sys.executable, "-m", "ebwt2indel.tools.pebwt2indel",
         str(reads_fa), "2", "80", str(tmp_path / "out"), "3"],
        capture_output=True, text=True, timeout=900, env=env,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    sens_sharded = sensitivity(tmp_path / "out" / "variants.snp")

    print(f"\n[pebwt2indel-recall] in-process SNP sensitivity "
          f"{sens_full:.3f}, 4-piece sharded {sens_sharded:.3f}, "
          f"delta {sens_full - sens_sharded:+.3f}")
    # the full pipeline must find most planted isolated SNPs, and the
    # sharded driver must retain the bulk of that recall (the documented
    # loss is real but bounded by the context sort)
    assert sens_full >= 0.8
    assert sens_sharded >= 0.6 * sens_full
