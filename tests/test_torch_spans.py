"""The port's spans (``utils.profiling.span``): with no profiler recording
they cost no ``record_function``; while one records (``start_trace`` /
``trace``, or a caller's own ``torch.profiler.profile``) each layer of the
predict path and of the train step is one ``odt.*`` range of its trace,
nested as the layers are.

A CPU trace holds the host ranges alone; the spans' device time and the
card's idle time between them are read on the card (the benchmark's
``port_bench/program_trace.py``).
"""
import json

import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu_torch import utils
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config)
from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize)
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step, pretrain)
from ood_object_detection_tpu_torch.utils import profiling

IMG = 128
NUM_CLASSES = 4
PREDICT = ("odt.letterbox", "odt.forward", "odt.select", "odt.nms")
TRAIN = ("odt.label", "odt.forward", "odt.loss", "odt.backward",
         "odt.update")


def _raise(*_, **__):
    raise AssertionError("record_function opened with spans off")


def _spans(path):
    """(name, start, end) of the trace's odt.* ranges, by start."""
    events = json.load(open(path))["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("odt.")), key=lambda s: s[1])


def _one(spans, name):
    found = [s for s in spans if s[0] == name]
    assert len(found) == 1, (name, spans)
    return found[0]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.fixture(scope="module")
def predict_bench():
    bench = create_model("efficientdet_d0", bench_task="predict",
                         num_classes=NUM_CLASSES, image_size=(IMG, IMG),
                         fpn_cell_repeats=1, box_class_repeats=1,
                         compute_dtype="bfloat16", soft_nms=True,
                         ood_method="energy", device="cpu")
    bench.eval()
    return bench


def _predict(bench):
    g = torch.Generator().manual_seed(0)
    canvases = torch.randint(0, 256, (2, IMG, IMG, 3), generator=g,
                             dtype=torch.uint8)
    true_hw = torch.tensor([[IMG, 96], [80, IMG]], dtype=torch.int32)
    with torch.no_grad():
        pre = batched_letterbox_normalize(canvases, true_hw, (IMG, IMG),
                                          out_dtype="bfloat16")
        return bench.forward_with_ood(pre["image"], pre)


def test_predict_spans_nest_as_the_layers(predict_bench, tmp_path):
    """A request under ``trace``: the letterbox, then the forward, then the
    selection and the NMS, each once, the forward inside neither."""
    with profiling.trace(str(tmp_path)):
        _predict(predict_bench)
    spans = _spans(tmp_path / "trace.json")
    assert sorted({s[0] for s in spans}) == sorted(PREDICT)
    letterbox, forward, select, nms = (_one(spans, n) for n in PREDICT)
    assert letterbox[2] <= forward[1] <= forward[2] <= select[1]
    assert select[2] <= nms[1]
    assert not _inside(forward, select) and not _inside(forward, nms)


def test_spans_off_open_no_record_function(predict_bench, monkeypatch):
    """With no profiler recording, a whole request opens no
    ``record_function``, and every span is the one shared no-op."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    first, second = profiling.span("odt.a"), profiling.span("odt.b")
    assert first is second
    assert utils.span is profiling.span and utils.annotate is profiling.span
    _predict(predict_bench)


def test_spans_are_on_while_a_profiler_records(tmp_path):
    """On inside a caller's own ``profile`` and between ``start_trace``
    and ``stop_trace``; off again once each has stopped."""
    off = profiling.span("odt.a")
    cpu = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=cpu):
        assert profiling.span("odt.a") is not off
    assert profiling.span("odt.a") is off
    prof = profiling.start_trace()
    assert profiling.span("odt.a") is not off
    profiling.stop_trace(prof, str(tmp_path))
    assert profiling.span("odt.a") is off


def test_a_callers_own_profiler_records_the_spans(predict_bench):
    """A plain ``torch.profiler.profile`` around a request, as the
    benchmark's traced window is, holds the four predict spans."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        _predict(predict_bench)
    names = [e.name for e in prof.events() if e.name.startswith("odt.")]
    assert sorted(names) == sorted(PREDICT)


def _train_batch():
    g = torch.Generator().manual_seed(1)
    corner = torch.rand((2, 3, 2), generator=g) * 64
    return {"image": torch.randn((2, IMG, IMG, 3), generator=g),
            "bbox": torch.cat([corner, corner + 32], -1),
            "cls": torch.tensor([[1, 2, -1], [3, -1, -1]])}


def test_train_step_spans_follow_the_step(tmp_path):
    """One train step under ``trace``: label, forward, loss, backward,
    update, each once and in that order, none inside another."""
    bench = create_model("efficientdet_d0", bench_task="train",
                         num_classes=NUM_CLASSES, image_size=(IMG, IMG),
                         fpn_cell_repeats=1, box_class_repeats=1,
                         device="cpu")
    tcfg = default_detection_train_config()
    state, tx = create_train_state(bench, tcfg)
    step = make_train_step(bench, tx, bench.anchors, tcfg,
                           freeze_bn="backbone")
    with profiling.trace(str(tmp_path)), torch.enable_grad():
        step(state, _train_batch())
    spans = _spans(tmp_path / "trace.json")
    assert [s[0] for s in spans] == list(TRAIN)
    for a, b in zip(spans, spans[1:]):
        assert a[2] <= b[1], (a, b)


def test_pretrain_profile_dir_holds_the_step_and_its_spans(tmp_path, capsys):
    """``pretrain --profile-dir`` traces from step 10: each traced step is
    an ``odt.step`` range holding the train step's spans."""
    pretrain.main(["--num-classes", "4", "--image-size", "128",
                   "--fpn-repeats", "1", "--head-repeats", "1",
                   "--batch-size", "1", "--warmup-steps", "2", "--mesh", "1",
                   "--workers", "0", "--device", "cpu", "--steps", "11",
                   "--val-freq", "100", "--log-freq", "100",
                   "--checkpoint-dir", str(tmp_path / "ck"),
                   "--per-cat-dir", str(tmp_path / "pc"),
                   "--profile-dir", str(tmp_path / "prof")])
    capsys.readouterr()
    spans = _spans(tmp_path / "prof" / "trace.json")
    step = _one(spans, "odt.step")
    inner = [s for s in spans if s[0] != "odt.step"]
    assert [s[0] for s in inner] == list(TRAIN)
    assert all(_inside(s, step) for s in inner)
    assert profiling.span("odt.a") is profiling.span("odt.b")
