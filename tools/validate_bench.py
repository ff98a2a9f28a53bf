#!/usr/bin/env python3
"""Bench-scale validation loop: simulate -> call -> filter_snp ->
context2vcf -> sort_vcf -> vcf_vs_vcf sensitivity/precision (the
reference's documented evaluation workflow, README.md:38-51, with the
alignment-free context placer standing in for BWA; scoring rules are
vcf_vs_vcf.cpp:268-288 parity-tested in tests/test_tools.py).

Reuses bench.py's dataset recipe (same RNG seed), so the mode-1 bench
input IS the validation fixture: genome + planted truth regenerate
deterministically. Writes one JSON report (default VALIDATION_r03.json).

Usage:
    BENCH_GENOME_LEN=20000000 python tools/validate_bench.py [out.json]

Runs the caller on whatever JAX backend is available (the GPU when
present; set JAX_PLATFORMS=cpu to force host).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import bench  # noqa: E402  (dataset recipe: seed, rates, coverage)


def main() -> int:
    out_json = sys.argv[1] if len(sys.argv) > 1 else \
        os.path.join(REPO, "VALIDATION_r03.json")
    from ebwt2indel.models import pipeline
    from ebwt2indel.tools import (context2vcf, filter_snp, simulate,
                                      sort_vcf, vcf_vs_vcf)
    from ebwt2indel.utils.config import Config

    t0 = time.time()
    path = bench.ensure_dataset_mode1()
    work = os.path.join(bench.DATA, "validate")
    os.makedirs(work, exist_ok=True)

    # regenerate the genome + planted truth with bench's exact recipe
    rng = np.random.default_rng(0xBE7C)
    genome = simulate.random_genome(rng, bench.GENOME_LEN)
    _, truth = simulate.plant_variants(rng, genome, snp_rate=0.001,
                                       indel_rate=0.0002)
    fasta = os.path.join(work, "ref.fasta")
    with open(fasta, "w") as f:
        f.write(">chr1\n")
        for i in range(0, len(genome), 80):
            f.write(genome[i: i + 80] + "\n")
    vcf_truth = os.path.join(work, "truth.vcf")
    simulate.write_vcf(vcf_truth, truth, chrom="chr1")

    # 1) call
    snp_path = os.path.join(work, "calls.snp")
    t = time.time()
    pipeline.run_one_dataset(Config(input1=path, output=snp_path),
                             log=lambda *a, **k: None)
    t_call = time.time() - t

    # 2) filter_snp m=5 (the reference's suggested filter for >=25x,
    #    README.md:40)
    filt_path = os.path.join(work, "calls_m5.snp")
    with open(snp_path) as f, open(filt_path, "w") as out:
        filter_snp.filter_stream(f, 5, 0, out)

    # 3) place contexts -> VCF (BWA-free snp2vcf), 4) sort
    vcf_out = os.path.join(work, "calls.vcf")
    t = time.time()
    place = context2vcf.convert(filt_path, fasta, vcf_out,
                                log=lambda *a: None)
    t_place = time.time() - t
    vcf_sorted = os.path.join(work, "calls.sorted.vcf")
    with open(vcf_out) as f:
        lines = sort_vcf.sort_vcf_lines(f)
    with open(vcf_sorted, "w") as f:
        f.write("\n".join(lines) + "\n")

    # 5) score
    s = vcf_vs_vcf.score(vcf_vs_vcf.read_vcf(vcf_sorted),
                         vcf_vs_vcf.read_vcf(vcf_truth), 10)
    rep = {
        "genome_len": bench.GENOME_LEN,
        "coverage": bench.COVERAGE,
        "read_len": bench.READ_LEN,
        "positions": os.path.getsize(path),
        "truth_snps": len(truth.snps),
        "truth_indels": len(truth.indels),
        "placed": place["placed"],
        "unique_variants": place["unique"],
        "dropped": place["dropped"],
        "snp": {
            "TP": s["TP_s"], "FP": s["FP_s"], "FN": s["FN_s"],
            "sensitivity": round(s["TP_s"] / max(s["TP_s"] + s["FN_s"], 1),
                                 4),
            "precision": round(s["TP_s"] / max(s["TP_s"] + s["FP_s"], 1),
                               4),
        },
        "indel": {
            "TP": s["TP_i"], "FP": s["FP_i"], "FN": s["FN_i"],
            "sensitivity": round(s["TP_i"] / max(s["TP_i"] + s["FN_i"], 1),
                                 4),
            "precision": round(s["TP_i"] / max(s["TP_i"] + s["FP_i"], 1),
                               4),
        },
        "call_seconds": round(t_call, 2),
        "place_seconds": round(t_place, 2),
        "total_seconds": round(time.time() - t0, 2),
    }
    with open(out_json, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
