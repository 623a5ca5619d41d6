"""The port's post-process (CPU: the kernels' plain versions) vs the JAX
package's ``generate_detections`` / ``batch_detection`` on identical
synthetic head outputs, C = 90, at D0@128 level shapes.

Selections are bit-exact: top-k order, NMS keep indices and classes.
Boxes and scores go through exp / sigmoid, which torch and XLA round
differently in the last bit: boxes to rtol 1e-5 / atol 1e-4, scores to
rtol 1e-4, OOD scores to rtol 1e-5.

Every case keeps fewer candidates than the 3069 anchors of D0@128. With
k equal to the row length, jax's CPU top-k (``approx_max_k``) sorts
unstably and returns tied keys in no fixed order, while for k below it
(as at D0@512: 5000 of 49,104) it returns them lowest index first, the
order the port reproduces."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import head_outputs, to_torch

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.ops.post_process import (
    batch_detection as jax_batch_detection,
    generate_detections as jax_generate_detections,
)
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu_torch.ops.anchors import Anchors

# the module (the package's ``post_process`` is the function)
pp = importlib.import_module(
    "ood_object_detection_tpu_torch.ops.post_process")

C = 90
IMG = 128


@pytest.fixture(scope="module")
def anchors():
    cfg = jax_cfg("efficientdet_d0", num_classes=C)
    return (Anchors.from_config(cfg, img_size=IMG),
            JaxAnchors.from_config(cfg, img_size=IMG))


def _outputs(anchors, seed, dtype):
    ours, _ = anchors
    rng = np.random.default_rng(seed)
    cls, box = head_outputs(ours.feat_sizes, 3, 7, C, rng, batch=2,
                            cls_mean=-3.5, ties=True)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ((to_torch(cls, dtype), to_torch(box, dtype)),
            ([jnp.asarray(c).astype(jdt) for c in cls],
             [jnp.asarray(b).astype(jdt) for b in box]))


IMG_INFO = dict(img_scale=np.array([[1.5], [0.75]], np.float32),
                img_size=np.array([[150.0, 180.0], [90.0, 60.0]], np.float32))


def _compare(anchors, dtype, ood_method, soft_nms, img_info, points=3000,
             seed=0):
    ours_a, ref_a = anchors
    (cls, box), (jcls, jbox) = _outputs(anchors, seed, dtype)
    info = IMG_INFO if img_info else {}
    dets, ood = pp.generate_detections(
        cls, box, ours_a, C, max_detection_points=points,
        max_det_per_image=100, soft_nms=soft_nms, ood_method=ood_method,
        **{k: torch.from_numpy(v) for k, v in info.items()})
    jdets, jood = jax_generate_detections(
        jcls, jbox, jnp.asarray(ref_a.boxes), C, max_detection_points=points,
        max_det_per_image=100, soft_nms=soft_nms, ood_method=ood_method,
        nms_impl="xla", anchors=ref_a,
        **{k: jnp.asarray(v) for k, v in info.items()})
    dets, jdets = dets.numpy(), np.asarray(jdets)
    assert (dets[..., 4] > 0).sum() > 20           # real detections
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_array_equal(dets[..., 4] > 0, jdets[..., 4] > 0)
    np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
    if ood_method is None:
        assert ood is None and jood is None
    else:
        np.testing.assert_allclose(ood.numpy(), np.asarray(jood), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("img_info", [False, True])
@pytest.mark.parametrize("soft_nms", [False, True])
@pytest.mark.parametrize("ood_method", ["energy", "max_logit", "msp", None])
def test_bf16_packed_key_path(anchors, ood_method, soft_nms, img_info):
    _compare(anchors, torch.bfloat16, ood_method, soft_nms, img_info)


@pytest.mark.parametrize("ood_method,soft_nms", [("energy", True),
                                                 ("msp", False)])
def test_f32_two_reduce_path(anchors, ood_method, soft_nms):
    _compare(anchors, torch.float32, ood_method, soft_nms, img_info=True,
             seed=1)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_truncated_candidates(anchors, dtype):
    """max_detection_points below A_tot = 3069: top-k truncates."""
    assert anchors[0].total_anchors > 1000
    _compare(anchors, dtype, "energy", True, img_info=False, points=1000,
             seed=2)


def test_topk_tie_order_matches_jax():
    """jax's top-k returns equal values lowest index first; so does the
    port's stable sort (torch.topk does not promise it)."""
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 40, (2, 8 * 8 * 9)).astype(np.float32)
    vals, idx = pp._topk(torch.from_numpy(keys), 200)
    jvals, jidx = jax.lax.approx_max_k(jnp.asarray(keys), 200,
                                       recall_target=0.95,
                                       aggregate_to_topk=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("soft_nms", [False, True])
def test_batch_detection_keep_idx_bit_exact(anchors, soft_nms):
    rng = np.random.default_rng(4)
    k = 400
    logits = np.round(rng.normal(-2.0, 1.5, (2, k, 1)) * 8) / 8 + 0.0
    codes = rng.normal(0, 0.3, (2, k, 4))
    sel = anchors[0].boxes[rng.integers(0, 3069, (2, k))]
    classes = rng.integers(0, 4, (2, k)).astype(np.int32)
    args = [a.astype(np.float32) for a in (logits, codes, sel)]
    dets, keep = pp.batch_detection(
        *[torch.from_numpy(a) for a in args], torch.from_numpy(classes),
        soft_nms=soft_nms)
    jdets, jkeep = jax_batch_detection(
        jnp.asarray(args[0]), jnp.asarray(args[1]), None,
        jnp.zeros((2, k), jnp.int32), jnp.asarray(classes),
        soft_nms=soft_nms, nms_impl="xla", anchors_sel=jnp.asarray(args[2]))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    assert (keep.numpy() >= 0).sum() > 50
    np.testing.assert_allclose(dets.numpy(), np.asarray(jdets), rtol=1e-4,
                               atol=1e-4)


def _planted(k=8):
    """Two identical high-score class-0 boxes (one must survive) and one
    whose height regression overflows exp() to inf."""
    codes = np.zeros((1, k, 4), np.float32)
    codes[0, 2, 2] = 200.0
    logits = np.full((1, k, 1), -8.0, np.float32)
    logits[0, :3, 0] = [3.0, 2.9, 2.0]
    sel = np.tile(np.array([[10.0, 10.0, 40.0, 40.0]], np.float32), (1, k, 1))
    return logits, codes, sel


def test_inf_coordinate_does_not_poison_class0_nms():
    logits, codes, sel = _planted()
    dets, _ = pp.batch_detection(
        torch.from_numpy(logits), torch.from_numpy(codes),
        torch.from_numpy(sel), torch.zeros((1, 8), dtype=torch.int32),
        max_det_per_image=5)
    scores = dets.numpy()[0, :, 4]
    assert np.isfinite(scores).all()
    assert (np.abs(scores - 1 / (1 + np.exp(-3.0))) < 1e-3).sum() == 1
    assert (np.abs(scores - 1 / (1 + np.exp(-2.9))) < 1e-3).sum() == 0


def test_min_score_filter_is_strict():
    below = float(np.log(0.0099 / 0.9901))           # sigmoid 0.0099
    logits = np.full((1, 6, 1), below, np.float32)
    logits[0, 0, 0] = -4.5                           # sigmoid 0.0110
    sel = np.tile(np.array([[10.0, 10.0, 40.0, 40.0]], np.float32), (1, 6, 1))
    dets, _ = pp.batch_detection(
        torch.from_numpy(logits), torch.zeros((1, 6, 4)),
        torch.from_numpy(sel), torch.arange(6, dtype=torch.int32)[None],
        max_det_per_image=5)
    scores = dets.numpy()[0, :, 4]
    assert (scores > 0).sum() == 1
    np.testing.assert_allclose(scores.max(), 1 / (1 + np.exp(4.5)), rtol=1e-6)


def test_unknown_ood_method_raises(anchors):
    (cls, box), _ = _outputs(anchors, 0, torch.bfloat16)
    for levels in (cls, [c.float() for c in cls]):
        with pytest.raises(ValueError, match="unknown ood_method"):
            pp.generate_detections(levels, box, anchors[0], C,
                                   ood_method="maxlogit")
