"""The program's spans read from a hand-made trace: device time and
launches go to the innermost ``odt.*`` span open when the operation was
launched, the card's idle time is split at the spans' boundaries, what no
program span holds is ``outside``, and the parts sum to the window's. The
benchmark's own reduction reads the same trace as it reads one without
the program's spans."""
import pytest

from port_bench import program_trace, trace
from port_bench.tests.test_pb_trace import EVENTS, _x

PROGRAM = [
    _x("user_annotation", "odt.step", 10, 80),
    _x("user_annotation", "odt.forward", 14, 27),
    _x("user_annotation", "odt.nms", 48, 17),
]


def _shifted(events, by, corr):
    out = []
    for e in events:
        e = dict(e, ts=e["ts"] + by, args=dict(e["args"]))
        if "correlation" in e["args"]:
            e["args"]["correlation"] += corr
        out.append(e)
    return out


def test_by_program_span_splits_device_idle_and_launches():
    """Two calls alike, each: busy [20, 55] and [80, 85] of [0, 100]; the
    kernel launched at 15 in odt.forward, the one at 50 in odt.nms, the
    copy (no launch in the trace) at 80 in odt.step. Idle [0, 20] is 10
    outside, 4 odt.step, 6 odt.forward; [55, 80] 10 odt.nms, 15 odt.step;
    [85, 100] 5 odt.step, 10 outside."""
    call = EVENTS + PROGRAM
    r = program_trace.by_program_span(call + _shifted(call, 100, 10),
                                      "pb.request")
    assert r["calls"] == 2
    want = {"odt.forward": (30, 6, 1), "odt.nms": (10, 10, 1),
            "odt.step": (5, 24, 1), "outside": (0, 20, 0)}
    assert set(r["spans"]) == set(want)
    for name, (device, idle, launches) in want.items():
        part = r["spans"][name]
        assert part["device_s"] == pytest.approx(device * 1e-6), name
        assert part["idle_s"] == pytest.approx(idle * 1e-6), name
        assert part["launches"] == launches, name
    assert r["idle_s"] == pytest.approx(60e-6)
    assert r["device_s"] == pytest.approx(45e-6)
    for key in ("idle_s", "device_s"):
        assert sum(p[key] for p in r["spans"].values()) == \
            pytest.approx(r[key])


def test_a_window_without_program_spans_is_all_outside():
    r = program_trace.by_program_span(EVENTS, "pb.request")
    assert list(r["spans"]) == ["outside"]
    assert r["spans"]["outside"]["idle_s"] == pytest.approx(60e-6)
    assert r["spans"]["outside"]["launches"] == 3
    with pytest.raises(RuntimeError):
        program_trace.by_program_span(EVENTS, "pb.step")


def test_reduce_reads_the_same_with_the_program_spans():
    assert trace.reduce(EVENTS + PROGRAM, "pb.request") == \
        trace.reduce(EVENTS, "pb.request")

