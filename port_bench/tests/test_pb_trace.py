"""The reduction of a profiler trace, on a hand-made one: device time goes
to the innermost span open when it was launched, busy time is the union
of device intervals, idle gaps are named by the span around them."""
import pytest

from port_bench import trace


def _x(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": args}


EVENTS = [
    _x("user_annotation", "pb.request", 0, 100),
    _x("user_annotation", "pb.postprocess", 10, 60),
    _x("user_annotation", "pb.forward", 12, 30),
    _x("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
    _x("kernel", "conv_kernel", 20, 30, correlation=1),
    _x("kernel", "nms_kernel(float const*)", 45, 10, correlation=2),
    _x("gpu_memcpy", "Memcpy DtoH", 80, 5),
]


def test_reduce_attributes_and_unions():
    r = trace.reduce(EVENTS, "pb.request")
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["busy_s"] == pytest.approx(40e-6)      # [20, 55] and [80, 85]
    assert r["span_s"]["pb.forward"] == pytest.approx(30e-6)
    assert r["span_s"]["pb.postprocess"] == pytest.approx(10e-6)
    # a copy with no launch in the trace goes by its own time
    assert r["span_s"]["pb.request"] == pytest.approx(5e-6)
    assert trace.kernel_seconds(r, "nms_kernel") == pytest.approx(10e-6)
    assert r["device_ops"][0] == ["conv_kernel", pytest.approx(30e-6)]
    # gaps [0, 20], [55, 80], [85, 100], longest first
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx(
        [25e-6, 20e-6, 15e-6])
    assert [g[0] for g in r["idle_gaps"]] == [
        "pb.postprocess", "pb.postprocess", "pb.request"]


def test_reduce_needs_its_outer_span():
    with pytest.raises(RuntimeError):
        trace.reduce(EVENTS[1:], "pb.request")


@pytest.mark.parametrize("name,count", [("device_idle_share.predict",
                                         "requests"),
                                        ("device_idle_share.train", "steps")])
def test_the_idle_share_holds_traced_busy_time_to_the_untraced_window(
        name, count):
    """4 traced calls busy 0.3 s, under a profiler that stretched them to
    0.6 s; the untimed window ran 100 calls in 10 s: idle 25 %, not 50."""
    from port_bench import run as bench_run
    layer = {count: 4, f"window_{count}": 100, "window_s": 10.0,
             "reduced": {"busy_s": 0.3, "window_s": 0.6}}
    assert bench_run.reader(name)(layer) == pytest.approx(25.0)
