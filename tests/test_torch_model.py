"""EfficientDet-D0 at 128 px: the JAX model's variables load into the port
(``load_jax_variables``) and both run the same images.

f32: backbone P3-P5, FPN P3-P7 and head outputs per level agree to rtol
1e-4 / atol 1e-4 (as tests/test_full_network_parity.py holds the JAX
model to a torch recomputation), and the whole slice (letterbox ->
forward -> post-process with soft-NMS and energy) agrees to the
tolerances of tests/test_torch_post_process.py.

bf16: the two frameworks round at different places (jax's silu rounds
sigmoid(x) before the product, convolutions sum in other orders), so bf16
head outputs can differ by a few bf16 steps (2^-8 relative). Measured on
these inputs: at most one step (0.03125 on class logits near -4.5, 0.0024
on box outputs near 0.1); held to two steps, rtol = atol = 2^-7. The
bf16 post-process is then held bit-exact on the port's own head outputs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables, to_numpy

from ood_object_detection_tpu.bench import DetBenchPredict as JaxBench
from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data.device_preproc import (
    batched_letterbox_normalize as jax_letterbox,
)
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.ops.post_process import (
    generate_detections as jax_generate_detections,
)
from ood_object_detection_tpu_torch.bench import DetBenchPredict
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.data.device_preproc import (
    batched_letterbox_normalize,
)
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.ops.post_process import (
    generate_detections,
)
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

IMG = 128
C = 90
# below the 3069 anchors of D0@128, so jax's top-k orders ties by index
POINTS = 3000
OVERRIDES = dict(num_classes=C, image_size=(IMG, IMG), soft_nms=True,
                 max_detection_points=POINTS)


def _random_variables(seed):
    """The JAX model's variable tree filled from numpy, with the class
    biases at the focal prior and classes 0-2 raised so detections pass
    the strict 0.01 score filter."""
    cfg = jax_cfg("efficientdet_d0", **OVERRIDES)
    variables = random_variables(
        lambda k: JaxDet(cfg).init(k, jnp.zeros((1, IMG, IMG, 3)), False),
        seed)
    predict = variables["params"]["class_net"]["predict"]["conv_pw"]
    bias = predict["bias"] - np.float32(4.6)
    bias.reshape(9, C)[:, :3] += np.float32(2.0)
    predict["bias"] = bias
    return variables


@pytest.fixture(scope="module")
def setup():
    variables = _random_variables(seed=0)
    models = {}
    for dtype in ("float32", "bfloat16"):
        cfg = get_efficientdet_config("efficientdet_d0", **OVERRIDES).replace(
            compute_dtype=dtype)
        model = EfficientDet(cfg)
        load_jax_variables(model, variables)
        models[dtype] = model.to(memory_format=torch.channels_last).eval()
    rng = np.random.default_rng(1)
    images = rng.uniform(-2, 2, (2, IMG, IMG, 3)).astype(np.float32)
    return variables, models, images


def _jax_apply(dtype, method=None):
    model = JaxDet(jax_cfg("efficientdet_d0", compute_dtype=dtype,
                           **OVERRIDES))
    return jax.jit(lambda v, x: model.apply(v, x, False, method=method))


def _close(ours, ref, rtol, atol, what):
    for lvl, (o, r) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(to_numpy(o), np.asarray(r, np.float32),
                                   rtol=rtol, atol=atol,
                                   err_msg=f"{what} level {lvl}")


def test_f32_stages_match(setup):
    variables, models, images = setup
    model, x = models["float32"], torch.from_numpy(images)
    with torch.no_grad():
        feats = model.backbone_features(x)
        fpn = model.fpn_features(feats)
        cls, box = model.heads(fpn)
    _close(feats, _jax_apply("float32", "backbone_features")(variables, images),
           1e-4, 1e-4, "backbone")
    _close(fpn, _jax_apply("float32", "image_to_fpn")(variables, images),
           1e-4, 1e-4, "fpn")
    jcls, jbox = _jax_apply("float32")(variables, images)
    _close(cls, jcls, 1e-4, 1e-4, "class head")
    _close(box, jbox, 1e-4, 1e-4, "box head")
    assert [tuple(c.shape) for c in cls] == [tuple(c.shape) for c in jcls]
    assert all(c.is_contiguous() for c in cls)       # channels_last -> NHWC


def test_bf16_heads_match(setup):
    variables, models, images = setup
    with torch.no_grad():
        cls, box = models["bfloat16"](torch.from_numpy(images))
    assert all(c.dtype == torch.bfloat16 for c in cls + box)
    jcls, jbox = _jax_apply("bfloat16")(variables, images)
    _close(cls, jcls, 2 ** -7, 2 ** -7, "bf16 class head")
    _close(box, jbox, 2 ** -7, 2 ** -7, "bf16 box head")


def _canvases():
    rng = np.random.default_rng(2)
    canvases = rng.integers(0, 256, (2, 160, 140, 3), dtype=np.uint8)
    true_hw = np.array([[160, 140], [97, 123]], np.int32)
    return canvases, true_hw


def test_f32_slice_end_to_end(setup):
    variables, models, _ = setup
    canvases, true_hw = _canvases()
    pre = batched_letterbox_normalize(
        torch.from_numpy(canvases), torch.from_numpy(true_hw), (IMG, IMG))
    bench = DetBenchPredict(models["float32"], ood_method="energy")
    dets, ood = bench.forward_with_ood(pre["image"], pre)

    jpre = jax_letterbox(jnp.asarray(canvases), jnp.asarray(true_hw),
                         target_hw=(IMG, IMG))
    jbench = JaxBench(JaxDet(jax_cfg("efficientdet_d0", **OVERRIDES)),
                      ood_method="energy")
    jdets, jood = jax.jit(jbench.forward_with_ood)(variables, jpre["image"],
                                                   jpre)
    dets, jdets = dets.numpy(), np.asarray(jdets)
    assert (dets[..., 4] > 0).sum() > 20
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
    np.testing.assert_allclose(ood.numpy(), np.asarray(jood), rtol=1e-5,
                               atol=1e-6)


def test_bf16_post_process_on_port_heads(setup):
    """The port's bf16 head outputs through the JAX post-process and the
    port's: the packed-key selection, keep indices and classes agree bit
    for bit."""
    _, models, images = setup
    from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
    from ood_object_detection_tpu_torch.ops.anchors import Anchors
    with torch.no_grad():
        cls, box = models["bfloat16"](torch.from_numpy(images))
    cfg = jax_cfg("efficientdet_d0", **OVERRIDES)
    kwargs = dict(max_detection_points=POINTS, soft_nms=True,
                  ood_method="energy")
    dets, ood = generate_detections(cls, box, Anchors.from_config(cfg), C,
                                    **kwargs)
    jax_levels = [jnp.asarray(to_numpy(t)).astype(jnp.bfloat16)
                  for t in cls + box]
    janchors = JaxAnchors.from_config(cfg)
    jdets, jood = jax_generate_detections(
        jax_levels[:5], jax_levels[5:], jnp.asarray(janchors.boxes), C,
        nms_impl="xla", anchors=janchors, **kwargs)
    dets, jdets = dets.numpy(), np.asarray(jdets)
    assert (dets[..., 4] > 0).sum() > 20
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
    np.testing.assert_allclose(ood.numpy(), np.asarray(jood), rtol=1e-5,
                               atol=1e-6)
