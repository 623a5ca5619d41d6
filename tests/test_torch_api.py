"""The port's public API beside the JAX package's, on the same numpy
inputs through both packages (the port on the CPU, its plain path).

- ``ops.post_process`` (the reference's 4-tuple top-k contract) under
  ``exact``, ``approx`` and ``per_anchor`` on f32 head outputs: anchor
  indices and classes bit-equal to JAX's ``post_process``, the selected
  logits and box regressions equal; and the JAX package's own cases
  (tests/test_post_process.py:43, :70, :351) on the port.
- ``ops.batched_nms`` / ``ops.batched_soft_nms`` (single image, per
  class) and ``class_offset_boxes``: keep ids bit-equal to JAX's, kept
  scores to rtol 1e-6; tests/test_nms.py's class-separation cases.
- The box helpers and ``decode_box_outputs`` to rtol 0 / atol 1e-6.
- ``TrainConfig``: every field and default equal to JAX's.
- ``DetectionDataset``: equal pixels through the native decoder and PIL
  on the five deploy-fixture JPEGs, and equal to the JAX dataset's
  (skipped where the native data core does not load).
- The names exported by ``ops`` and ``models`` cover the JAX package's
  (but ``pallas_batched_nms``: the kernels are reached as ``ops.cuda_*``).
"""
import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ood_object_detection_tpu.models as jax_models
import ood_object_detection_tpu.ops as jax_ops
import ood_object_detection_tpu_torch.models as models
import ood_object_detection_tpu_torch.ops as ops
from ood_object_detection_tpu.config import get_efficientdet_config
from ood_object_detection_tpu.config.train_config import \
    TrainConfig as JaxTrainConfig
from ood_object_detection_tpu.data.dataset import \
    DetectionDataset as JaxDetectionDataset
from ood_object_detection_tpu_torch.config.train_config import TrainConfig
from ood_object_detection_tpu_torch.data import native_decode
from ood_object_detection_tpu_torch.data.dataset import DetectionDataset
from ood_object_detection_tpu_torch.ops.anchors import Anchors

C = 6
METHODS = ("exact", "approx", "per_anchor")
FIXTURE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "data", "deploy_fixture")


@pytest.fixture(scope="module")
def anchors():
    cfg = get_efficientdet_config("efficientdet_d0", num_classes=C).replace(
        image_size=(128, 128))
    return Anchors.from_config(cfg)


def _head_outputs(anchors, rng, batch=2, bias=-6.0):
    """tests/test_post_process.py's per-level f32 head outputs."""
    cls_out, box_out = [], []
    for lvl in range(anchors.min_level, anchors.max_level + 1):
        h, w = anchors.feat_sizes[lvl]
        cls_out.append(rng.normal(bias, 1, (batch, h, w, 9 * C))
                       .astype(np.float32))
        box_out.append(rng.normal(0, 0.1, (batch, h, w, 36))
                       .astype(np.float32))
    return cls_out, box_out


def _both(cls_out, box_out, k, method):
    ours = ops.post_process([torch.from_numpy(c) for c in cls_out],
                            [torch.from_numpy(b) for b in box_out], C,
                            max_detection_points=k, topk_method=method)
    want = jax_ops.post_process([jnp.asarray(c) for c in cls_out],
                                [jnp.asarray(b) for b in box_out], C,
                                max_detection_points=k, topk_method=method)
    return [t.numpy() for t in ours], [np.asarray(t) for t in want]


@pytest.mark.parametrize("k", [50, 200])
@pytest.mark.parametrize("method", METHODS)
def test_post_process_matches_jax(anchors, rng, method, k):
    ours, want = _both(*_head_outputs(anchors, rng), k, method)
    assert [t.shape for t in ours] == [t.shape for t in want]
    assert ours[0].shape == (2, k, 1) and ours[1].shape == (2, k, 4)
    for got, ref in zip(ours, want):
        np.testing.assert_array_equal(got, ref)


def test_post_process_topk_matches_numpy(anchors, rng):
    """tests/test_post_process.py:43 on the port."""
    cls_out, box_out = _head_outputs(anchors, rng)
    k = 50
    cls_topk, box_topk, indices, classes = [t.numpy() for t in (
        ops.post_process([torch.from_numpy(c) for c in cls_out],
                         [torch.from_numpy(b) for b in box_out],
                         num_classes=C, max_detection_points=k,
                         topk_method="exact"))]
    b_ = 2
    cls_all = np.concatenate([c.reshape(b_, -1, C) for c in cls_out], 1)
    box_all = np.concatenate([b.reshape(b_, -1, 4) for b in box_out], 1)
    flat = cls_all.reshape(b_, -1)
    for b in range(b_):
        ref_idx = np.argsort(-flat[b], kind="stable")[:k]
        got_vals = flat[b][indices[b] * C + classes[b]]
        np.testing.assert_array_equal(got_vals, flat[b][ref_idx])
        np.testing.assert_array_equal(cls_topk[b, :, 0], got_vals)
        np.testing.assert_array_equal(box_topk[b], box_all[b][indices[b]])


def test_approx_topk_recall(anchors, rng):
    """tests/test_post_process.py:70 on the port: its ``approx`` is the
    exact flat top-k (one stable sort), so it finds every pair of
    ``exact``, the top 20 among them."""
    cls_out, box_out = _head_outputs(anchors, rng)
    k = 200
    pairs = {}
    for method in ("exact", "approx"):
        _, _, idx, cls = ops.post_process(
            [torch.from_numpy(c) for c in cls_out],
            [torch.from_numpy(b) for b in box_out], num_classes=C,
            max_detection_points=k, topk_method=method, topk_recall=0.95)
        pairs[method] = [(int(a), int(c)) for a, c in
                         zip(idx[0].tolist(), cls[0].tolist())]
    exact, approx = set(pairs["exact"]), set(pairs["approx"])
    assert len(exact & approx) / len(exact) > 0.9
    assert len(set(pairs["exact"][:20]) & approx) >= 18
    assert pairs["approx"] == pairs["exact"]


def test_exact_topk_keeps_dense_anchor(anchors, rng):
    """tests/test_post_process.py:351 on the port, and equal to JAX."""
    cls_out, box_out = _head_outputs(anchors, rng, batch=1, bias=-8.0)
    for c_ in range(C):
        cls_out[0][0, 2, 2, c_] = 9.0 - 0.1 * c_
    cls_out[1][0, 1, 1, 2] = 8.85
    ours, want = _both(cls_out, box_out, C + 1, "exact")
    for got, ref in zip(ours, want):
        np.testing.assert_array_equal(got, ref)
    cls_topk, _, indices, classes = ours
    got = sorted(cls_topk[0, :, 0], reverse=True)
    np.testing.assert_allclose(
        got, sorted([9.0 - 0.1 * c_ for c_ in range(C)] + [8.85],
                    reverse=True), rtol=1e-6)
    dense = {int(c_) for a, c_ in zip(indices[0], classes[0])
             if int(a) == int(indices[0][0])}
    assert dense == set(range(C))
    np.testing.assert_array_equal(
        cls_topk[0, :, 0],
        cls_topk[0, :, 0][np.argsort(-cls_topk[0, :, 0], kind="stable")])


def _boxes_scores_classes(rng, n=60, coord_range=200):
    x1 = rng.uniform(0, coord_range, n)
    y1 = rng.uniform(0, coord_range, n)
    w = rng.uniform(5, 80, n)
    h = rng.uniform(5, 80, n)
    boxes = np.stack([x1, y1, x1 + w, y1 + h], 1).astype(np.float32)
    scores = rng.uniform(0.01, 1.0, n).astype(np.float32)
    classes = rng.integers(0, 4, n).astype(np.int32)
    return boxes, scores, classes


NMS_CASES = {
    "hard": ("batched_nms", dict(iou_threshold=0.5, max_out=40)),
    "soft_gaussian": ("batched_soft_nms", dict(max_out=40)),
    "soft_linear": ("batched_soft_nms", dict(
        method_gaussian=False, iou_threshold=0.3, max_out=40)),
}


@pytest.mark.parametrize("case", sorted(NMS_CASES))
def test_single_image_nms_matches_jax(rng, case):
    name, kw = NMS_CASES[case]
    for _ in range(3):
        boxes, scores, classes = _boxes_scores_classes(rng)
        idx, kept = getattr(ops, name)(
            torch.from_numpy(boxes), torch.from_numpy(scores),
            torch.from_numpy(classes), **kw)
        jidx, jkept = getattr(jax_ops, name)(boxes, scores, classes, **kw)
        assert idx.dtype == torch.int32 and idx.shape == (40,)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(kept.numpy(), np.asarray(jkept),
                                   rtol=1e-6, atol=0)
        assert (idx.numpy() >= 0).sum() > 10


def test_class_offset_boxes_match_jax(rng):
    boxes, _, classes = _boxes_scores_classes(rng)
    np.testing.assert_array_equal(
        ops.class_offset_boxes(torch.from_numpy(boxes),
                               torch.from_numpy(classes)).numpy(),
        np.asarray(jax_ops.nms.class_offset_boxes(boxes, classes)))


def test_batched_nms_classes_do_not_suppress():
    """tests/test_nms.py's case on the port: identical boxes of two
    classes are both kept."""
    boxes = torch.tensor([[0, 0, 50, 50], [0, 0, 50, 50]], dtype=torch.float32)
    keep, _ = ops.batched_nms(boxes, torch.tensor([0.9, 0.8]),
                              torch.tensor([0, 1], dtype=torch.int32), 0.5, 2)
    assert set(keep.tolist()) == {0, 1}


def test_batched_soft_nms_class_separation():
    """tests/test_nms.py:120 on the port: no decay across classes."""
    boxes = torch.tensor([[0, 0, 50, 50], [0, 0, 50, 50]], dtype=torch.float32)
    _, kept = ops.batched_soft_nms(boxes, torch.tensor([0.9, 0.8]),
                                   torch.tensor([0, 3], dtype=torch.int32),
                                   max_out=2)
    np.testing.assert_allclose(sorted(kept.tolist(), reverse=True),
                               [0.9, 0.8], rtol=1e-6)


def _boxes(rng, n):
    lo = rng.uniform(-20, 200, (n, 2))
    hi = lo + rng.uniform(0, 80, (n, 2))
    return np.concatenate([lo, hi], 1).astype(np.float32)


def test_box_helpers_match_jax(rng):
    a, b = _boxes(rng, 40), _boxes(rng, 30)
    size_hw = np.array([150.0, 120.0], np.float32)
    pairs = [
        (ops.pairwise_iou_xyxy(torch.from_numpy(a), torch.from_numpy(b)),
         jax_ops.pairwise_iou_xyxy(a, b)),
        (ops.clip_boxes_yxyx(torch.from_numpy(a), torch.from_numpy(size_hw)),
         jax_ops.clip_boxes_yxyx(a, size_hw)),
        (ops.yxyx_to_xyxy(torch.from_numpy(a)), jax_ops.yxyx_to_xyxy(a)),
        (ops.xyxy_to_yxyx(torch.from_numpy(a)), jax_ops.xyxy_to_yxyx(a)),
    ]
    for got, want in pairs:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6)
    assert float(ops.pairwise_iou_xyxy(torch.from_numpy(a),
                                       torch.from_numpy(b)).max()) > 0.1


def test_decode_box_outputs_matches_jax(rng):
    codes = rng.normal(0, 0.3, (50, 4)).astype(np.float32)
    anchors = _boxes(rng, 50) + np.float32(30)
    for xyxy in (False, True):
        got = ops.decode_box_outputs(torch.from_numpy(codes),
                                     torch.from_numpy(anchors),
                                     output_xyxy=xyxy)
        want = jax_ops.decode_box_outputs(codes, anchors, output_xyxy=xyxy)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-6 * max(1.0, float(
                                       np.abs(np.asarray(want)).max())))
    assert ops.decode_box_outputs is ops.decode_boxes


def test_train_config_fields_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    want = {f.name: f.default for f in dataclasses.fields(JaxTrainConfig)}
    assert ours == want
    for name in ("mesh_shape", "mesh_axis_names", "checkpoint_dir",
                 "checkpoint_every_steps", "keep_checkpoints",
                 "async_checkpoint", "eval_every_steps", "eval_metric"):
        assert getattr(TrainConfig(), name) == getattr(JaxTrainConfig(), name)


class _FixtureParser:
    """The five deploy-fixture JPEGs as a parser (no annotations)."""

    def __init__(self):
        self.files = sorted(f for f in os.listdir(FIXTURE_DIR)
                            if f.endswith(".jpg"))

    def __len__(self):
        return len(self.files)

    def get_img_info(self, idx):
        return {"id": idx, "file_name": self.files[idx], "width": 0,
                "height": 0}

    def get_ann(self, idx):
        return {"bbox": np.zeros((0, 4), np.float32),
                "cls": np.zeros((0,), np.int32)}


def test_detection_dataset_native_decode_equals_pil(monkeypatch):
    if not native_decode.available():
        pytest.skip("the native data core does not load here (libjpeg)")
    parser = _FixtureParser()
    calls = []
    decode = native_decode.decode_jpeg
    monkeypatch.setattr(native_decode, "decode_jpeg",
                        lambda data: calls.append(1) or decode(data))
    native = [np.asarray(DetectionDataset(FIXTURE_DIR, parser)[i][0])
              for i in range(len(parser))]
    assert len(calls) == len(parser) == 5
    jax_side = [np.asarray(JaxDetectionDataset(FIXTURE_DIR, parser)[i][0])
                for i in range(len(parser))]
    monkeypatch.setattr(native_decode, "available", lambda: False)
    pil = [np.asarray(DetectionDataset(FIXTURE_DIR, parser)[i][0])
           for i in range(len(parser))]
    assert len(calls) == 5                     # PIL alone the second time
    for a, b, c in zip(native, pil, jax_side):
        assert a.dtype == np.uint8 and a.ndim == 3 and a.shape[2] == 3
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_exports_cover_the_jax_package():
    jax_names = {n for n in dir(jax_ops) if not n.startswith("_")
                 and not isinstance(getattr(jax_ops, n), type(os))}
    missing = jax_names - set(ops.__all__) - {"pallas_batched_nms"}
    assert not missing
    assert not [n for n in ops.__all__ if n.startswith("pallas")]
    jax_model_names = {n for n in dir(jax_models) if not n.startswith("_")
                       and not isinstance(getattr(jax_models, n), type(os))}
    assert not jax_model_names - set(models.__all__)
    for name in ops.__all__ + models.__all__:
        assert hasattr(ops, name) or hasattr(models, name), name
    # the package-level name is the single-image function; K1 is cuda_nms's
    from ood_object_detection_tpu_torch.ops import cuda_nms, nms
    assert ops.batched_nms is nms.batched_nms
    assert cuda_nms.batched_nms is not ops.batched_nms
