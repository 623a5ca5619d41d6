"""The port's AnchorNet against the JAX package's (mirrors
tests/test_models.py::test_anchor_net_forward_shapes_and_stop_gradient):
D0's config at 128 px, 2 layers of 16 channels over 8-channel pyramid
levels P3-P7.

- The JAX variables (filled from numpy) load strictly through
  ``utils/from_jax`` with the flax names (``conv_rep_0``,
  ``bn_rep_0_{level}``, ``anchor_out``); the per-anchor logits of every
  level agree in f32 to rtol = atol = 1e-5, of shape [B, H, W, 9];
- the input is detached: no gradient reaches the activations (and the
  parameters get one);
- in train mode each (repeat, level) HeadBatchNorm writes its running
  statistics as the JAX module does with ``mutable=["batch_stats"]``
  (rtol 1e-5 / atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_helpers import random_variables

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.models.anchor_net import (
    AnchorNet as JaxAnchorNet)
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.models import AnchorNet
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

IMG, IN_CH, CH = 128, 8, 16


def _levels(seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (2, IMG >> lv, IMG >> lv, IN_CH))
            .astype(np.float32) for lv in range(3, 8)]


def _config():
    return get_efficientdet_config("efficientdet_d0", num_classes=4).replace(
        image_size=(IMG, IMG))


def _setup():
    jnet = JaxAnchorNet(jax_cfg("efficientdet_d0", num_classes=4).replace(
        image_size=(IMG, IMG)), num_layers=2, num_channels=CH)
    variables = random_variables(
        lambda k: jnet.init(k, [jnp.asarray(x) for x in _levels(0)], False),
        seed=1)
    net = AnchorNet(_config(), num_layers=2, num_channels=CH,
                    in_channels=IN_CH)
    report = load_jax_variables(net, variables)
    assert not report["missing"] and not report["unexpected"]
    return jnet, variables, net


def test_anchor_net_matches_jax_and_detaches_its_input():
    jnet, variables, net = _setup()
    feats = _levels(2)
    want = jnet.apply(variables, [jnp.asarray(x) for x in feats], False)
    inputs = [torch.from_numpy(x).requires_grad_() for x in feats]
    outs = net.eval()(inputs)
    assert len(outs) == 5
    for lv, (o, w) in enumerate(zip(outs, want)):
        s = IMG >> (lv + 3)
        assert tuple(o.shape) == (2, s, s, 9)
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5)
    sum(o.sum() for o in outs).backward()
    assert all(x.grad is None for x in inputs)
    assert net.anchor_out.conv_pw.weight.grad is not None


def test_anchor_net_train_mode_statistics_match_jax():
    jnet, variables, net = _setup()
    feats = _levels(3)
    _, new = jnet.apply(variables, [jnp.asarray(x) for x in feats], True,
                        mutable=["batch_stats"])
    with torch.no_grad():
        net.train()([torch.from_numpy(x) for x in feats])
    ref = AnchorNet(_config(), num_layers=2, num_channels=CH,
                    in_channels=IN_CH)
    load_jax_variables(ref, {"params": variables["params"],
                             "batch_stats": jax.device_get(
                                 new["batch_stats"])})
    want = dict(ref.named_buffers())
    moved = 0
    for name, buf in net.named_buffers():
        np.testing.assert_allclose(buf.numpy(), want[name].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
        moved += int(not np.allclose(buf.numpy(), np.asarray(
            variables["batch_stats"][name.split(".")[0]][
                "mean" if name.endswith("mean") else "var"])))
    assert moved == 2 * 5
