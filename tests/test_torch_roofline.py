"""The port's roofline tools on the CPU: ``examples.train_roofline``'s
counts against closed forms and on a 128 px D0 (``--skip-measure``),
``examples.run_roofline_sweep``'s parsing of a child's stdout and its
resumable output file, and ``examples.profile_kernel_stats`` on a
hand-built chrome trace."""
import json

import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu_torch.examples import (profile_kernel_stats,
                                                     run_roofline_sweep,
                                                     train_roofline)


def test_conv_counts_equal_their_closed_form():
    conv = torch.nn.Conv2d(3, 8, 3, padding=1)
    x = torch.randn(2, 3, 16, 16)
    with torch.no_grad():
        c = train_roofline.count_call(conv, (x,))
    assert c["matmul_flops"] == 2 * (2 * 8 * 16 * 16) * (3 * 3 * 3)
    assert c["pointwise_flops"] == 0
    assert c["bytes"] == 4 * (x.numel() + conv.weight.numel()
                              + conv.bias.numel() + 2 * 8 * 16 * 16)


def test_elementwise_counts_equal_their_closed_form():
    a, b = torch.randn(1000), torch.randn(1000)
    c = train_roofline.count_call(torch.add, (a, b))
    assert c["flops"] == c["pointwise_flops"] == 1000
    assert c["matmul_flops"] == 0
    assert c["bytes"] == 3 * 1000 * 4
    bf = torch.randn(64, 32).bfloat16()
    c = train_roofline.count_call(lambda t: t.t().contiguous() * 2, (bf,))
    # the transpose is a view (free); the copy and the product move
    # 2 bytes an element in and out each
    assert c["bytes"] == 2 * (2 * 2 * bf.numel())
    assert c["pointwise_flops"] == bf.numel()


@pytest.mark.parametrize("groups", [1, 8])
def test_conv_backward_counts_both_gradients_with_groups(groups):
    conv = torch.nn.Conv2d(8, 8, 3, padding=1, groups=groups, bias=False)
    x = torch.randn(2, 8, 16, 16, requires_grad=True)
    c = train_roofline.count_call(lambda: conv(x).sum().backward(), ())
    forward = 2 * (2 * 8 * 16 * 16) * (8 // groups * 9)
    assert c["matmul_flops"] == 3 * forward    # forward, d input, d weight


def test_peaks_follow_dtype_and_environment(monkeypatch):
    monkeypatch.delenv("ROOFLINE_PEAK_TFLOPS", raising=False)
    monkeypatch.delenv("ROOFLINE_PEAK_GBS", raising=False)
    assert train_roofline.peaks("bfloat16") == (989.0, 3350.0)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    assert train_roofline.peaks("float32")[0] == 67.0
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    assert train_roofline.peaks("float32")[0] == 495.0
    monkeypatch.setenv("ROOFLINE_PEAK_TFLOPS", "197")
    monkeypatch.setenv("ROOFLINE_PEAK_GBS", "819")
    assert train_roofline.peaks("bfloat16") == (197.0, 819.0)


@pytest.mark.parametrize("task", ["train", "predict"])
def test_train_roofline_skip_measure_on_the_cpu(task, capsys, tmp_path):
    argv = ["--device", "cpu", "--image-size", "128", "--batch", "1",
            "--task", task, "--skip-measure"]
    if task == "predict":
        argv += ["--profile-dir", str(tmp_path)]
    out = train_roofline.main(argv)
    printed = run_roofline_sweep.parse_result(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert out["task"] == task and out["card"] == "cpu"
    assert out["flops_per_step"] > out["matmul_flops_per_step"] > 1e8
    assert out["hbm_bytes_per_step"] > 1e7
    assert out["t_hbm_bound_ms"] == pytest.approx(
        out["hbm_bytes_per_step"] / 3350e9 * 1e3)
    assert "t_measured_ms" not in out and "hbm_bw_utilization" not in out
    if task == "predict":
        assert (tmp_path / "trace.json").exists()
        assert out["profile_calls"] == 3


def test_sweep_parses_a_childs_stdout_past_braces():
    result = {"model": "efficientdet_d0", "hbm_bytes_per_step": 1.5e9,
              "images_per_sec": 10.0}
    text = ("UserWarning: {'weird': dict} in a warning {\n"
            "running {not json}\n"
            + json.dumps(result, indent=2) + "\n"
            + json.dumps({"bytes_accessed_detail": {"mul": 3}}, indent=2))
    assert run_roofline_sweep.parse_result(text) == result
    assert run_roofline_sweep.parse_result("no dict {here}") is None
    assert run_roofline_sweep.parse_result(
        json.dumps({"bytes_accessed_detail": {"a": 1}})) is None


def test_sweep_configs_and_commands():
    assert len(run_roofline_sweep.configs()) == 16
    only = run_roofline_sweep.configs("predict")
    assert only == [dict(model="efficientdet_d4", batch=16, freeze_bn="none",
                         remat=0, task="predict")]
    cmd = run_roofline_sweep.command(run_roofline_sweep.D4_CONFIGS[3], 5,
                                     "cpu")
    assert cmd[1:3] == ["-m", run_roofline_sweep.MODULE]
    assert "--remat-fpn-heads" in cmd and cmd[-2:] == ["--device", "cpu"]
    assert cmd[cmd.index("--task") + 1] == "train"


def test_sweep_writes_and_resumes(monkeypatch, tmp_path):
    ran = []

    def fake(cfg, iters, device=None):
        ran.append(cfg)
        status = "OOM" if cfg["batch"] == 24 else "ok"
        return {**cfg, "status": status, "wall_s": 1.0}
    monkeypatch.setattr(run_roofline_sweep, "run_one", fake)
    out = tmp_path / "r.json"
    rows = run_roofline_sweep.main(["--out", str(out), "--only", "d4",
                                    "--device", "cpu"])
    assert len(ran) == len(rows) == 5
    saved = json.loads(out.read_text())
    assert saved["card"] == "cpu" and len(saved["results"]) == 5
    ran.clear()
    run_roofline_sweep.main(["--out", str(out), "--only", "d4",
                             "--device", "cpu"])
    assert ran == []
    run_roofline_sweep.main(["--out", str(out), "--only", "d4",
                             "--device", "cpu", "--rerun-failed"])
    assert [c["batch"] for c in ran] == [24]


def _trace(path):
    def ev(name, cat, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "pid": 0, "tid": 7}
    events = [ev("aten::conv", "cpu_op", 0, 500),
              ev("conv_kernel", "kernel", 10, 40),
              ev("conv_kernel", "kernel", 60, 40),
              ev("swish_kernel", "kernel", 100, 10),
              ev("Memcpy HtoD", "gpu_memcpy", 120, 5),
              ev("conv_kernel", "kernel", 200, 40),
              ev("swish_kernel", "kernel", 240, 10),
              ev("Memset", "gpu_memset", 245, 5),    # overlaps the last
              {"ph": "i", "cat": "kernel", "name": "instant", "ts": 1}]
    path.write_text(json.dumps({"traceEvents": events}))


def test_profile_kernel_stats_on_a_fixture(tmp_path, capsys):
    _trace(tmp_path / "trace.json")
    table = profile_kernel_stats.main([str(tmp_path), "--calls", "2",
                                       "--json-out",
                                       str(tmp_path / "t.out")])
    rows = table["rows"]
    assert [r["name"] for r in rows] == ["conv_kernel", "swish_kernel",
                                         "Memcpy HtoD", "Memset"]
    assert rows[0]["us_per_call"] == 60 and rows[0]["count_per_call"] == 1.5
    assert rows[0]["share"] == pytest.approx(120 / 150)
    assert rows[2]["category"] == "gpu_memcpy"
    assert table["device_us_per_call"] == 75
    assert table["busy_us_per_call"] == 145 / 2      # the memset overlaps
    assert table["span_us_per_call"] == 240 / 2
    text = capsys.readouterr().out
    assert "conv_kernel" in text and "80.0%" in text
    assert json.loads((tmp_path / "t.out").read_text())["calls"] == 2


def test_profile_kernel_stats_needs_device_events(tmp_path):
    (tmp_path / "cpu.json").write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0,
         "dur": 3}]}))
    with pytest.raises(SystemExit, match="no device events"):
        profile_kernel_stats.main([str(tmp_path / "cpu.json")])
    with pytest.raises(SystemExit, match="no chrome trace"):
        profile_kernel_stats.main([str(tmp_path / "empty_dir_missing")])
