#!/usr/bin/env python3
"""Config-5-scale validation loop: the genhuge two-haplotype simulation at
multi-billion positions scored through the reference's documented
evaluation workflow (README.md:38-51): mode-1 call -> filter_snp m=5 ->
context placement -> sort -> vcf_vs_vcf (scoring rules
vcf_vs_vcf.cpp:268-288, parity-tested in tests/test_tools.py).

Usage:
    python tools/validate_huge.py GENOME_LEN IN.ebwt [CALLS.snp] [OUT.json]

GENOME_LEN must match the genhuge invocation that produced IN.ebwt (the
genome + planted truth regenerate deterministically from genhuge's seed).
If CALLS.snp exists it is reused (e.g. the run_huge.py output on the same
input — saves a second multi-minute run); otherwise mode 1 runs
here. Writes OUT.json (default VALIDATION_r05.json).
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main() -> int:
    genome_len = int(sys.argv[1])
    ebwt_path = sys.argv[2]
    snp_path = sys.argv[3] if len(sys.argv) > 3 else \
        os.path.join(os.path.dirname(ebwt_path), "validate_calls.snp")
    out_json = sys.argv[4] if len(sys.argv) > 4 else \
        os.path.join(REPO, "VALIDATION_r05.json")

    from ebwt2indel.tools import (context2vcf, filter_snp, simulate,
                                      sort_vcf, vcf_vs_vcf)

    t0 = time.time()
    work = os.path.join(os.path.dirname(os.path.abspath(ebwt_path)),
                        "validate")
    os.makedirs(work, exist_ok=True)

    # regenerate genome + planted truth with genhuge's exact recipe
    # (tools/genhuge.py: seed, rates; reads consume later RNG draws)
    rng = np.random.default_rng(0xB16B16)
    genome = simulate.random_genome(rng, genome_len)
    _, truth = simulate.plant_variants(rng, genome, snp_rate=0.001,
                                       indel_rate=0.0002)
    fasta = os.path.join(work, "ref.fasta")
    if not os.path.isfile(fasta):
        with open(fasta, "w") as f:
            f.write(">chr1\n")
            for i in range(0, len(genome), 80):
                f.write(genome[i: i + 80] + "\n")
    vcf_truth = os.path.join(work, "truth.vcf")
    simulate.write_vcf(vcf_truth, truth, chrom="chr1")
    print(f"[validate_huge] truth ready: {len(truth.snps)} SNPs, "
          f"{len(truth.indels)} indels {time.time()-t0:.0f}s", flush=True)

    # 1) call (reuse an existing .snp if provided)
    t_call = None
    if not os.path.isfile(snp_path):
        from ebwt2indel.models import pipeline
        from ebwt2indel.utils.config import Config

        t = time.time()
        pipeline.run_one_dataset(Config(input1=ebwt_path, output=snp_path),
                                 log=lambda *a, **k: None)
        t_call = round(time.time() - t, 2)
        print(f"[validate_huge] called {t_call}s", flush=True)
    else:
        print(f"[validate_huge] reusing calls {snp_path}", flush=True)

    # 2) filter_snp m=5 (the reference's suggested filter for >=25x
    #    coverage, README.md:40)
    filt_path = os.path.join(work, "calls_m5.snp")
    with open(snp_path) as f, open(filt_path, "w") as out:
        filter_snp.filter_stream(f, 5, 0, out)

    # 3) place contexts -> VCF (alignment-free snp2vcf), 4) sort
    vcf_out = os.path.join(work, "calls.vcf")
    t = time.time()
    place = context2vcf.convert(filt_path, fasta, vcf_out,
                                log=lambda *a: None)
    t_place = round(time.time() - t, 2)
    print(f"[validate_huge] placed {place['placed']} in {t_place}s",
          flush=True)
    vcf_sorted = os.path.join(work, "calls.sorted.vcf")
    with open(vcf_out) as f:
        lines = sort_vcf.sort_vcf_lines(f)
    with open(vcf_sorted, "w") as f:
        f.write("\n".join(lines) + "\n")

    # 5) score (vcf_vs_vcf.cpp:268-288 rules)
    s = vcf_vs_vcf.score(vcf_vs_vcf.read_vcf(vcf_sorted),
                         vcf_vs_vcf.read_vcf(vcf_truth), 10)
    rep = {
        "genome_len": genome_len,
        "positions": os.path.getsize(ebwt_path),
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
        "call_seconds": t_call,
        "place_seconds": t_place,
        "total_seconds": round(time.time() - t0, 2),
    }
    with open(out_json, "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps(rep))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
