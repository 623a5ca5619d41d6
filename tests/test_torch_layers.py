"""The port's building blocks under both padding conventions, TF SAME
(asymmetric for stride 2) and symmetric, against the JAX package's flax
modules with the same random variables, in f32: each module alone, then
the whole ``tf_efficientdet_d0`` (SAME padding, redundant biases) at
128 px. Held to rtol / atol 1e-5 for a block and 1e-4 for the model, as
tests/test_full_network_parity.py holds the JAX model."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables, to_numpy

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.models import layers as jax_layers
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.models import layers
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables


def _run_both(jax_module, port_module, x_nhwc, seed=0):
    """Same numpy variables into both modules, same input; NHWC outputs."""
    variables = random_variables(
        lambda k: jax_module.init(k, jnp.asarray(x_nhwc)), seed)
    want = jax_module.apply(variables, jnp.asarray(x_nhwc))
    load_jax_variables(port_module, variables)
    port_module = port_module.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = port_module(torch.from_numpy(x_nhwc).permute(0, 3, 1, 2))
    return to_numpy(got.permute(0, 2, 3, 1)), np.asarray(want)


def _input(shape, seed=1):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("pad_type", ["same", ""])
@pytest.mark.parametrize("stride,size", [(1, 9), (2, 9), (2, 10)])
def test_conv_bn_act(pad_type, stride, size):
    got, want = _run_both(
        jax_layers.ConvBnAct(8, kernel_size=3, stride=stride,
                             pad_type=pad_type, bias=True),
        layers.ConvBnAct(5, 8, kernel_size=3, stride=stride,
                         pad_type=pad_type, bias=True),
        _input((2, size, size + 2, 5)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_type", ["same", ""])
def test_separable_conv_stride2(pad_type):
    got, want = _run_both(
        jax_layers.SeparableConv(6, kernel_size=5, stride=2,
                                 pad_type=pad_type),
        layers.SeparableConv(4, 6, kernel_size=5, stride=2,
                             pad_type=pad_type),
        _input((2, 11, 12, 4)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("pad_type", ["same", ""])
@pytest.mark.parametrize("ratio,apply_bn", [(2.0, True), (2.0, False),
                                            (0.5, False)])
def test_resample_feature_map(pad_type, ratio, apply_bn):
    """Downsampling max-pools with kernel = stride + 1 (SAME pads with
    -inf); upsampling repeats each pixel."""
    kw = dict(reduction_ratio=ratio, pad_type=pad_type, apply_bn=apply_bn)
    got, want = _run_both(jax_layers.ResampleFeatureMap(3, 7, **kw),
                          layers.ResampleFeatureMap(3, 7, **kw),
                          _input((2, 10, 10, 3)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_squeeze_excite():
    got, want = _run_both(jax_layers.SqueezeExcite(3),
                          layers.SqueezeExcite(12, 3),
                          _input((2, 6, 6, 12)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fpn_name", ["bifpn_sum", "bifpn_attn", "bifpn_fa",
                                      "pan_fa", "qufpn_fa"])
def test_fpn_weight_methods_and_graphs(fpn_name):
    """Every combine (sum / softmax / fast attention) and every node graph
    the zoo uses, on small D0-width backbone features."""
    from ood_object_detection_tpu.models.bifpn import BiFpn as JaxBiFpn
    from ood_object_detection_tpu_torch.models.bifpn import BiFpn

    info = (dict(num_chs=40, reduction=8), dict(num_chs=112, reduction=16),
            dict(num_chs=320, reduction=32))
    feats = [_input((1, 32 // r * 4, 32 // r * 4, i["num_chs"]), seed=r)
             for r, i in zip((8, 16, 32), info)]
    jfpn = JaxBiFpn(jax_cfg("efficientdet_d0", fpn_name=fpn_name), info)
    variables = random_variables(
        lambda k: jfpn.init(k, [jnp.asarray(f) for f in feats]), seed=4)
    want = jfpn.apply(variables, [jnp.asarray(f) for f in feats])

    port = torch.nn.Module()          # `fpn.` prefixes the reference names
    port.fpn = BiFpn(get_efficientdet_config("efficientdet_d0",
                                             fpn_name=fpn_name), info)
    load_jax_variables(port, {c: {"fpn": t} for c, t in variables.items()})
    port = port.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = port.fpn([torch.from_numpy(f).permute(0, 3, 1, 2)
                        for f in feats])
    assert len(got) == len(want) == 5
    for ours, ref in zip(got, want):
        np.testing.assert_allclose(to_numpy(ours.permute(0, 2, 3, 1)),
                                   np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_tf_efficientdet_d0_heads():
    """SAME padding and redundant biases through the whole model."""
    overrides = dict(num_classes=20, image_size=(128, 128))
    jmodel = JaxDet(jax_cfg("tf_efficientdet_d0", **overrides))
    images = _input((1, 128, 128, 3), seed=2)
    variables = random_variables(
        lambda k: jmodel.init(k, jnp.asarray(images), False), seed=3)
    jcls, jbox = jax.jit(lambda v, x: jmodel.apply(v, x, False))(
        variables, images)
    model = EfficientDet(get_efficientdet_config("tf_efficientdet_d0",
                                                 **overrides))
    load_jax_variables(model, variables)
    model = model.to(memory_format=torch.channels_last).eval()
    with torch.no_grad():
        cls, box = model(torch.from_numpy(images))
    for ours, ref in zip(cls + box, list(jcls) + list(jbox)):
        np.testing.assert_allclose(to_numpy(ours), np.asarray(ref),
                                   rtol=1e-4, atol=1e-4)
