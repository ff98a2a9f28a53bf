#!/usr/bin/env python3
"""Summarize a jax.profiler Chrome trace: top ops by total device time.

Usage: python tools/tracetop.py <trace.json.gz | trace.json> [top_n]

Reads the trace written under EBWT_PROFILE=<dir> (jax.profiler writes
plugins/profile/<run>/*.trace.json.gz) and prints the top-N event names by
summed duration on the GPU device tracks (process names starting with
``/device:GPU:``) — host threads are left out. A trace with no GPU track
is an error."""

from __future__ import annotations

import gzip
import json
import sys
from collections import defaultdict


def load_events(path: str):
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def gpu_pids(events) -> set:
    """pids of the trace's GPU device planes (``/device:GPU:<i>``)."""
    return {e.get("pid") for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"
            and e.get("args", {}).get("name", "").startswith("/device:GPU:")}


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    path = sys.argv[1]
    top_n = int(sys.argv[2]) if len(sys.argv) > 2 else 25
    events = load_events(path)

    device_pids = gpu_pids(events)
    if not device_pids:
        print("no /device:GPU: track in this trace", file=sys.stderr)
        return 1

    tot = defaultdict(float)
    cnt = defaultdict(int)
    wall = 0.0
    for e in events:
        if e.get("ph") != "X":
            continue
        if e.get("pid") not in device_pids:
            continue
        d = float(e.get("dur", 0.0))
        name = e.get("name", "?")
        tot[name] += d
        cnt[name] += 1
        wall += d
    rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top_n]
    print(f"{'total_ms':>10}  {'count':>7}  {'avg_us':>8}  name")
    for name, d in rows:
        print(f"{d / 1e3:10.1f}  {cnt[name]:7d}  {d / cnt[name]:8.1f}  "
              f"{name[:110]}")
    print(f"[sum of device event time: {wall / 1e6:.2f} s over "
          f"{sum(cnt.values())} events]")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
