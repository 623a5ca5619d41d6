"""A profiled window read by the program's own spans: the ``odt.*``
ranges that the port opens at its layers (``utils.profiling.span``) while
a profiler records, as ``trace.record``'s does.

``trace.reduce`` attributes device time by the benchmark's ``pb.*``
spans; ``by_program_span`` reads the same events by the program's spans:
each span's device time and launches (by the innermost program span open
on the host when the operation was launched, matched by correlation id),
and the card's idle time in the window split instant by instant to the
innermost program span open on the host. A program without such spans
reads as one ``outside`` part.
"""
from __future__ import annotations

import bisect
from typing import Callable, Dict, List, Tuple

from .trace import DEVICE_CATS, _union


def _marks(events: List[Dict], prefix: str) -> List[Tuple]:
    """(start, end, name) of the host ranges whose name starts with
    ``prefix``, by start."""
    return sorted(((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation" and e.get("ph") == "X"
                   and e["name"].startswith(prefix)), key=lambda s: s[0])


def _innermost(spans: List[Tuple], default: str) -> Callable[[float], str]:
    """ts -> the narrowest of ``spans`` open at ts, or ``default``."""
    starts = [s[0] for s in spans]

    def at(ts: float) -> str:
        best, width = default, float("inf")
        for a, b, name in spans[:bisect.bisect_right(starts, ts)]:
            if a <= ts <= b and b - a < width:
                best, width = name, b - a
        return best
    return at


def by_program_span(events: List[Dict], outer: str, prefix: str = "odt."
                    ) -> Dict:
    """The window of ``trace.reduce`` (from the first ``outer`` span's start
    to the last one's end) by the program's spans (names starting with
    ``prefix``), each a call's mean over the ``outer`` spans. ``spans``
    maps each program span's name, and ``"outside"`` for what no program
    span holds, to ``device_s`` (device seconds of the kernels, copies
    and sets launched with it innermost), ``launches`` (their count) and
    ``idle_s`` (the card's idle seconds while it was the innermost span
    open on the host). ``idle_s`` and ``device_s`` at the top are the
    window's idle seconds and all its device operations' seconds, which
    the parts sum to; ``calls`` is the count of ``outer`` spans."""
    outers = [s for s in _marks(events, outer) if s[2] == outer]
    if not outers:
        raise RuntimeError(f"the trace holds no {outer!r} span")
    t0, t1 = min(s[0] for s in outers), max(s[1] for s in outers)
    calls = len(outers)
    launch = {e["args"]["correlation"]: e["ts"] for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in e.get("args", {})}
    marks = _marks(events, prefix)
    at = _innermost(marks, "outside")
    parts = {name: {"device_s": 0.0, "idle_s": 0.0, "launches": 0.0}
             for name in [m[2] for m in marks] + ["outside"]}
    busy, device = [], 0.0
    for e in events:
        if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
            continue
        a, b = max(e["ts"], t0), min(e["ts"] + e.get("dur", 0), t1)
        if b <= a:
            continue
        busy.append((a, b))
        device += b - a
        part = parts[at(launch.get(e.get("args", {}).get("correlation"),
                                   e["ts"]))]
        part["device_s"] += (b - a) / 1e6 / calls
        part["launches"] += 1.0 / calls
    merged = _union(busy)
    edges = [t0] + [t for ab in merged for t in ab] + [t1]
    # between two consecutive span boundaries one span is innermost
    bounds = sorted({t for a, b, _ in marks for t in (a, b)})
    idle = 0.0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        cuts = bounds[bisect.bisect_right(bounds, a):
                      bisect.bisect_left(bounds, b)]
        for p, q in zip([a] + cuts, cuts + [b]):
            parts[at((p + q) / 2)]["idle_s"] += (q - p) / 1e6 / calls
        idle += b - a
    return dict(calls=calls, idle_s=idle / 1e6 / calls,
                device_s=device / 1e6 / calls, spans=parts)
