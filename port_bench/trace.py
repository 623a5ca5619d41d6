"""Profiled windows and their reduction: ``torch.profiler`` (CPU and CUDA
activity) over a fixed count of calls, its Chrome trace read back into
device time by span, time by kernel name, the device's busy time (the
union of its kernel, copy and set intervals), and the longest idle gaps
with what the host was doing in them.

Spans are ``record_function`` ranges opened from the benchmark around the
calls it makes (``pb.*``). A device operation belongs to the innermost
span open on the host when it was launched (matched by the trace's
correlation ids).
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def record(fn: Callable[[int], None], count: int) -> List[Dict]:
    """Profile ``fn(i)`` for i in range(count), the device synchronised at
    both ends; returns the trace's events."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(count):
            fn(i)
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def reduce(events: List[Dict], outer: str) -> Dict:
    """What a profiled window read: ``window_s`` (from the first span
    ``outer`` open to the last one closed), ``busy_s``, ``span_s`` (device
    seconds by innermost span), ``kernel_s`` (device seconds by kernel
    name), ``device_ops`` and ``idle_gaps`` (the breakdown's two lists)."""
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("ph") == "X"]
    outers = [e for e in marks if e["name"] == outer]
    if not outers:
        raise RuntimeError(f"the trace holds no {outer!r} span")
    t0 = min(e["ts"] for e in outers)
    t1 = max(e["ts"] + e["dur"] for e in outers)
    launch = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and \
                "correlation" in e.get("args", {}):
            launch[e["args"]["correlation"]] = e["ts"]
    spans = sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in marks
                    if e["name"].startswith("pb.")), key=lambda s: s[0])
    starts = [s[0] for s in spans]

    def innermost(ts: float) -> str:
        best, width = "other", float("inf")
        for a, b, name in spans[:bisect.bisect_right(starts, ts)]:
            if a <= ts <= b and b - a < width:
                best, width = name, b - a
        return best

    span_s: Dict[str, float] = defaultdict(float)
    kernel_s: Dict[str, float] = defaultdict(float)
    busy = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
        if b <= a:
            continue
        busy.append((a, b))
        corr = e.get("args", {}).get("correlation")
        span_s[innermost(launch.get(corr, e["ts"]))] += (b - a) / 1e6
        kernel_s[e["name"]] += (b - a) / 1e6
    merged = _union(busy)
    gaps = [(merged[i][1], merged[i + 1][0]) for i in range(len(merged) - 1)]
    if merged:
        gaps = [(t0, merged[0][0])] + gaps + [(merged[-1][1], t1)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:10]
    return dict(
        window_s=(t1 - t0) / 1e6,
        busy_s=sum(b - a for a, b in merged) / 1e6,
        span_s=dict(span_s), kernel_s=dict(kernel_s),
        device_ops=[[n, s] for n, s in sorted(kernel_s.items(),
                                              key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[innermost((a + b) / 2), (b - a) / 1e6] for a, b in gaps])


def kernel_seconds(reduced: Dict, fragment: str) -> float:
    """Device seconds of the kernels whose name holds ``fragment``."""
    return sum(s for n, s in reduced["kernel_s"].items() if fragment in n)
