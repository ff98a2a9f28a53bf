#!/usr/bin/env python3
"""Mode-1 run at multi-billion positions (BASELINE config-5 scale) with a
cold + warm in-process measurement, BYTE-PARITY against the compiled
reference binary, and the reference's wall time as vs_baseline — the
REPORT_2G5 capture (oracle: ebwt2InDel.cpp:1254-1330 output on the same
input).

Usage: python tools/run_huge.py IN.ebwt OUT.snp [REPORT.json]

Runs the full mode-1 pipeline twice in one process: run 1 absorbs every
compile (the cold wall is reported separately), run 2 is the steady-state
number. Then runs `.ref_build/ebwt2InDel -1 IN -o ref.snp` (single-thread
CPU, the reference's only mode at this scale short of pebwt2InDel.sh
process sharding), byte-compares, and fills parity/vs_baseline. Set
RUN_HUGE_SKIP_REF=1 to skip the reference leg (e.g. timing-only runs).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF_BIN = os.path.join(REPO, ".ref_build", "ebwt2InDel")


def main() -> int:
    inp, out = sys.argv[1], sys.argv[2]
    report = sys.argv[3] if len(sys.argv) > 3 else None

    from ebwt2indel.models import pipeline
    from ebwt2indel.utils.config import Config

    n = os.path.getsize(inp)
    cfg = Config(input1=inp, output=out)
    state = {
        "metric": "mode1 end-to-end BWT positions/sec/chip",
        "value": None,
        "unit": "pos/s",
        "positions": n,
        "warm_seconds": None,
        "cold_seconds": None,
        "ref_seconds": None,
        "parity": None,
        "vs_baseline": None,
    }

    def emit():
        if not report:
            return
        best = state["warm_seconds"] or state["cold_seconds"]
        if best:
            state["value"] = round(n / best, 1)
        if state["ref_seconds"] is not None and best and state["parity"]:
            state["vs_baseline"] = round(state["ref_seconds"] / best, 3)
        out_state = {k: (round(v, 3) if isinstance(v, float) else v)
                     for k, v in state.items()}
        with open(report, "w") as f:
            json.dump(out_state, f)
            f.write("\n")

    t0 = time.perf_counter()
    pipeline.run_one_dataset(cfg)
    state["cold_seconds"] = time.perf_counter() - t0
    print(f"[run_huge] cold end-to-end {state['cold_seconds']:.1f}s "
          f"({n / state['cold_seconds'] / 1e6:.2f} Mpos/s)", flush=True)
    emit()

    t0 = time.perf_counter()
    pipeline.run_one_dataset(cfg)
    state["warm_seconds"] = time.perf_counter() - t0
    print(f"[run_huge] warm end-to-end {state['warm_seconds']:.1f}s "
          f"({n / state['warm_seconds'] / 1e6:.2f} Mpos/s)", flush=True)
    emit()

    if os.environ.get("RUN_HUGE_SKIP_REF") == "1":
        print("[run_huge] reference leg skipped (RUN_HUGE_SKIP_REF=1)")
        return 0
    if not os.path.isfile(REF_BIN):
        print(f"[run_huge] reference binary missing at {REF_BIN}; "
              "build with: mkdir -p .ref_build && cd .ref_build && "
              "cmake /root/reference && make -j4 ebwt2InDel")
        return 1
    ref_out = out + ".ref"
    t0 = time.perf_counter()
    subprocess.run([REF_BIN, "-1", inp, "-o", ref_out], check=True,
                   stdout=subprocess.DEVNULL)
    state["ref_seconds"] = time.perf_counter() - t0
    print(f"[run_huge] reference end-to-end {state['ref_seconds']:.1f}s "
          f"({n / max(state['ref_seconds'], 1e-9) / 1e6:.2f} Mpos/s)",
          flush=True)

    # byte parity (chunked compare: the .snp files are ~GB-scale)
    same = os.path.getsize(out) == os.path.getsize(ref_out)
    if same:
        with open(out, "rb") as fa, open(ref_out, "rb") as fb:
            while True:
                a = fa.read(1 << 24)
                b = fb.read(1 << 24)
                if a != b:
                    same = False
                    break
                if not a:
                    break
    state["parity"] = bool(same)
    print(f"[run_huge] parity "
          f"{'BYTE-IDENTICAL' if same else 'MISMATCH'}", flush=True)
    emit()
    return 0 if same else 1


if __name__ == "__main__":
    raise SystemExit(main())
