"""Anchors, index-arithmetic anchor rebuild and the box decode: port vs
the JAX package."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.ops import box_coder as jax_coder
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.ops import box_coder
from ood_object_detection_tpu_torch.ops.anchors import Anchors


def _pair(img):
    return (Anchors.from_config(get_efficientdet_config("efficientdet_d0"),
                                img_size=img),
            JaxAnchors.from_config(jax_cfg("efficientdet_d0"), img_size=img))


@pytest.mark.parametrize("img", [512, 128])
def test_anchor_table_bit_equal(img):
    ours, ref = _pair(img)
    np.testing.assert_array_equal(ours.boxes, ref.boxes)
    assert ours.level_sizes == ref.level_sizes
    assert ours.level_meta == ref.level_meta


@pytest.mark.parametrize("img", [512, 128])
def test_boxes_for_indices_bit_equal(img):
    ours, ref = _pair(img)
    rng = np.random.default_rng(img)
    ids = rng.integers(0, ours.total_anchors, (3, 700)).astype(np.int32)
    ids[0, :5] = [0, ours.total_anchors - 1] + [off for off, *_ in
                                                ours.level_meta[1:4]]
    got = ours.boxes_for_indices(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        ref.boxes_for_indices(jnp.asarray(ids))))


def test_decode_and_encode_match():
    ours, _ = _pair(128)
    rng = np.random.default_rng(0)
    anchors = ours.boxes[rng.integers(0, ours.total_anchors, 500)]
    codes = rng.normal(0, 0.5, (500, 4)).astype(np.float32)
    for xyxy in (False, True):
        got = box_coder.decode_boxes(torch.from_numpy(codes),
                                     torch.from_numpy(anchors),
                                     output_xyxy=xyxy).numpy()
        want = np.asarray(jax_coder.decode_boxes(
            jnp.asarray(codes), jnp.asarray(anchors), output_xyxy=xyxy))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-5)
    boxes = np.array(jax_coder.decode_boxes(jnp.asarray(codes),
                                            jnp.asarray(anchors)))
    got = box_coder.encode_boxes(torch.from_numpy(boxes),
                                 torch.from_numpy(anchors)).numpy()
    want = np.asarray(jax_coder.encode_boxes(jnp.asarray(boxes),
                                             jnp.asarray(anchors)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
