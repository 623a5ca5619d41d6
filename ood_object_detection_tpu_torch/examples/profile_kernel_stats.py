"""Summarise a torch.profiler chrome trace: the card's top kernels by self
time (the port's counterpart of the JAX package's
``examples/profile_hlo_stats.py``, which reads an XLA profile's HLO ops).

Companion to ``examples.train_roofline --profile-dir``: the roofline gives
a call's aggregate FLOPs and bytes; this attributes the card's time in the
traced calls to its kernels, copies and sets (a device event has no
children, so its duration is its self time), with each one's count and
share of the device time.

Usage:
    python -m ood_object_detection_tpu_torch.examples.profile_kernel_stats \\
        TRACE_DIR_OR_FILE [--top 30] [--calls 3] [--json-out F]
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
from typing import Dict, List, Optional

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    """``path`` itself, or the newest ``*.json`` under the directory."""
    if os.path.isfile(path):
        return path
    hits = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                            recursive=True), key=os.path.getmtime)
    if not hits:
        raise SystemExit(f"no chrome trace (*.json) under {path}")
    return hits[-1]


def device_events(trace: Dict) -> List[Dict]:
    """The complete ('X') device events of a chrome trace."""
    return [e for e in trace.get("traceEvents", [])
            if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES]


def busy_us(events: List[Dict]) -> float:
    """Length of the union of the events' intervals, in µs."""
    total, end = 0.0, float("-inf")
    for start, stop in sorted((e["ts"], e["ts"] + e["dur"]) for e in events):
        if stop > end:
            total += stop - max(start, end)
            end = stop
    return total


def kernel_table(events: List[Dict], calls: int = 1) -> Dict:
    """Per name: device µs a call, launches a call and share of all device
    time, heaviest first; with the totals."""
    time_us, count = collections.Counter(), collections.Counter()
    for e in events:
        time_us[e["name"]] += float(e["dur"])
        count[e["name"]] += 1
    total = sum(time_us.values())
    rows = [{"name": name, "category": "", "us_per_call": t / calls,
             "count_per_call": count[name] / calls,
             "share": t / total if total else 0.0}
            for name, t in time_us.most_common()]
    cats = {e["name"]: e["cat"] for e in events}
    for r in rows:
        r["category"] = cats[r["name"]]
    span = (max(e["ts"] + e["dur"] for e in events)
            - min(e["ts"] for e in events)) if events else 0.0
    return {"rows": rows, "device_us_per_call": total / calls,
            "busy_us_per_call": busy_us(events) / calls,
            "span_us_per_call": span / calls, "calls": calls}


def main(argv: Optional[list] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace", help="a chrome trace, or a directory holding "
                                  "one (train_roofline --profile-dir)")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--calls", type=int, default=1,
                    help="calls the trace holds (train_roofline traces 3); "
                         "times and counts are given a call")
    ap.add_argument("--json-out", default="",
                    help="also write the whole table as JSON")
    args = ap.parse_args(argv)

    path = find_trace(args.trace)
    with open(path) as f:
        events = device_events(json.load(f))
    if not events:
        raise SystemExit(f"{path}: no device events (a trace of the CPU "
                         "alone)")
    table = kernel_table(events, args.calls)
    print(f"# {path}")
    print(f"# a call: device time {table['device_us_per_call']:.1f} us, "
          f"busy {table['busy_us_per_call']:.1f} us, span "
          f"{table['span_us_per_call']:.1f} us; {len(table['rows'])} "
          f"distinct device ops, top {args.top}:")
    for r in table["rows"][:args.top]:
        print(f"{r['us_per_call']:>12.1f}  {100 * r['share']:5.1f}%  "
              f"n={r['count_per_call']:<8g} {r['category']:<10} "
              f"{r['name'][:110]}")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(table, f, indent=1)
        print(f"# wrote {args.json_out}")
    return table


if __name__ == "__main__":
    main()
