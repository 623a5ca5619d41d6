"""The plain reference against the program's own plain path (its CPU
kernel versions, in float32) at 128 px: the same weights give the same
forward, letterbox, detections and train steps."""
import numpy as np
import pytest
import torch

from port_bench.drivers import predict, train
from port_bench.program import build
from port_bench.reference import detect
from port_bench.reference.model import EfficientDet
from port_bench.tests.small import make_run
from port_bench.weights import make_state


@pytest.mark.parametrize("cell", ["d0_predict_b128", "d4_predict_b16"])
def test_reference_forward_equals_the_program(cell):
    run = make_run(cell)
    cfg = run.config["model"]
    with torch.device("meta"):
        ref = EfficientDet(cfg)
    images = torch.randn(2, 128, 128, 3, generator=torch.Generator()
                         .manual_seed(3))
    state = make_state(ref, cfg, 5, images)
    bench = build(run.config, "predict", state, "cpu")
    with torch.no_grad():
        got = bench.model(images)
        want = ref(images)
    for g, w in zip(got[0] + got[1], want[0] + want[1]):
        assert torch.allclose(g, w, atol=1e-4, rtol=1e-4)


def test_reference_letterbox_equals_the_program():
    from ood_object_detection_tpu_torch.data.device_preproc import \
        batched_letterbox_normalize
    run = make_run("d0_predict_b128")
    sizes = predict.true_sizes(run.traffic, 7)[0]
    canv = predict.canvases(run.traffic, run.config["model"], 7, "cpu")[0]
    got = batched_letterbox_normalize(
        canv, torch.from_numpy(sizes.astype(np.int32)), (128, 128))
    want, scale = detect.letterbox(canv, sizes.tolist(), (128, 128))
    assert torch.allclose(got["image"], want, atol=1e-4)
    assert torch.allclose(got["img_scale"][:, 0], scale)


def test_served_detections_replay_without_a_gap():
    s = predict.Setup(make_run("d0_predict_b128"))
    dets, ood = s.request(1)
    c = predict.reference_candidates(s, 1, 0, 4)
    r = detect.replay(c, dets, ood)
    assert r["empty_rows"].tolist() == [0] * 4
    assert r["picks"].tolist() == [100] * 4
    assert len(r["image"]) == 400 and r["class_err"].sum() == 0
    for k in ("box_err", "pick_gap", "score_err", "ood_err"):
        assert r[k].max() < 1e-4, k
    # the reference's own soft-NMS serves the same rows
    own, own_ood = detect.soft_nms(c)
    assert torch.allclose(own, dets, atol=1e-3)


def test_reference_train_steps_equal_the_program():
    s = train.Setup(make_run("d0_train_b128"))
    got = s.first_steps(3)
    ref = train.reference_steps(s.ref, s.cfg, s.tcfg, s.state, s.pool, 3,
                                s.device)
    gaps = train.compare(got, ref)
    assert gaps["loss_gap"] < 1e-5
    assert max(gaps.values()) < 1e-4
