"""Stochastic depth and rematerialisation in the port (mirrors
tests/test_models.py:225-330).

Stochastic depth (``drop_path_rate``): each residual block with a skip
drops its branch per sample with a rate that grows linearly with the
block's index, drawing from an explicit ``torch.Generator``.
- rate 0, or no generator, gives bit-identical features (not gated on
  train mode, as the JAX package's ``_maybe_drop_path``);
- two generators give different features, both finite;
- a mask keeps a share within 3 sigma of ``1 - rate``;
- the per-block rate schedule equals the JAX package's (its blocks'
  ``drop_path_rate`` as ``GenericBackbone`` builds them, read through
  ``flax.linen.intercept_methods`` under ``jax.eval_shape``), for
  EfficientNet-B0, lite0 (fixed first / last stage depth) and the edge
  es (``er`` blocks);
- the variable tree does not change with ``drop_path_rate`` or
  ``remat_stages``;
- the train step draws from a generator seeded from (seed, step): the
  same masks at the same step, other masks at the next.

Rematerialisation (``remat_stages``, ``remat_fpn``, ``remat_heads``,
``layers.remat``): one forward and backward with and without it, from
the same weights, batch and generator, give the same loss, the same
gradient of every parameter and the same running statistics, bit for
bit on the CPU; the FPN and heads with train-mode BatchNorm (whose
statistics a recompute would write twice), and the backbone stages with
stochastic depth (whose masks a recompute would draw again).
"""
import copy

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.models.backbone import (
    BACKBONE_DEFS as JAX_DEFS, GenericBackbone as JaxBackbone)
from ood_object_detection_tpu_torch.factory import create_model
from ood_object_detection_tpu_torch.models import layers
from ood_object_detection_tpu_torch.models.backbone import (BACKBONE_DEFS,
                                                            GenericBackbone)
from ood_object_detection_tpu_torch.train.train_state import (
    drop_path_generator)

IMG = 64


def _images(seed=0, batch=2, img=IMG):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        0, 1, (batch, 3, img, img)).astype(np.float32))


def _backbones(*kws, name="efficientnet_b0"):
    """B0 backbones built with each of ``kws``, all with the first one's
    weights, in eval mode."""
    models = [GenericBackbone(BACKBONE_DEFS[name], **kw).eval()
              for kw in kws]
    for model in models[1:]:
        model.load_state_dict(models[0].state_dict())
    return models


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_no_generator_or_rate_zero_is_bit_identical():
    plain, dropping = _backbones({}, dict(drop_path_rate=0.5))
    x = _images()
    with torch.no_grad():
        base = plain(x)
        for out in (dropping(x), plain(x, _gen(1))):
            for a, b in zip(base, out):
                assert torch.equal(a, b)


def test_two_generators_differ():
    dropping, = _backbones(dict(drop_path_rate=0.5))
    x = _images()
    with torch.no_grad():
        one, two = dropping(x, _gen(1)), dropping(x, _gen(2))
        again = dropping(x, _gen(1))
    assert max(float((a - b).abs().max()) for a, b in zip(one, two)) > 0
    assert all(torch.equal(a, b) for a, b in zip(one, again))
    assert all(bool(torch.isfinite(f).all()) for f in one + two)


@pytest.mark.parametrize("rate", [0.1, 0.3, 0.7])
def test_keep_share_within_three_sigma(rate):
    n = 200_000
    mask = layers.drop_mask(n, _gen(3), rate)
    assert tuple(mask.shape) == (n, 1, 1, 1)
    assert set(torch.unique(mask).tolist()) == {0.0, 1.0}
    keep = 1.0 - rate
    sigma = (keep * rate / n) ** 0.5
    assert abs(float(mask.mean()) - keep) < 3 * sigma
    x = torch.ones(n, 1, 1, 1)
    dropped = layers.drop_path(x, _gen(3), rate)
    assert torch.equal(dropped, mask / keep)
    assert torch.equal(layers.drop_path(x, None, rate), x)


def _jax_block_rates(name, rate):
    """Each block's drop_path_rate as the JAX GenericBackbone builds it:
    {block name: rate}."""
    rates = {}

    def record(next_fun, args, kwargs, context):
        module = context.module
        if hasattr(module, "drop_path_rate") and module.name and \
                module.name.startswith("blocks_"):
            rates[module.name] = float(module.drop_path_rate)
        return next_fun(*args, **kwargs)

    module = JaxBackbone(JAX_DEFS[name], drop_path_rate=rate)
    with flax_nn.intercept_methods(record):
        jax.eval_shape(lambda: module.init(
            jax.random.key(0), jnp.zeros((1, IMG, IMG, 3)), False))
    return rates


@pytest.mark.parametrize("name", ["efficientnet_b0", "efficientnet_lite0",
                                  "efficientnet_es"])
def test_block_rate_schedule_matches_jax(name):
    rate = 0.2
    want = _jax_block_rates(name, rate)
    port = GenericBackbone(BACKBONE_DEFS[name], drop_path_rate=rate)
    got = {f"blocks_{i}_{r}": block.drop_path_rate
           for i, stage in enumerate(port.blocks)
           for r, block in enumerate(stage)}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key
    assert max(got.values()) < rate and got["blocks_0_0"] == 0.0


def test_variable_tree_unchanged():
    shapes = [{k: tuple(v.shape) for k, v in GenericBackbone(
        BACKBONE_DEFS["efficientnet_b0"], **kw).state_dict().items()}
        for kw in ({}, dict(drop_path_rate=0.5),
                   dict(drop_path_rate=0.5, remat_stages=3))]
    assert shapes[0] == shapes[1] == shapes[2]


def test_train_step_generator_follows_the_step():
    model = create_model("efficientdet_d0", device="cpu", num_classes=4,
                         image_size=(128, 128),
                         backbone_args={"drop_path_rate": 0.3})
    assert drop_path_generator(model, 0, torch.device("cpu")) is not None
    draws = [torch.rand(8, generator=drop_path_generator(
        model, step, torch.device("cpu"))) for step in (5, 5, 6)]
    assert torch.equal(draws[0], draws[1])
    assert not torch.equal(draws[0], draws[2])
    plain = create_model("efficientdet_d0", device="cpu", num_classes=4,
                         image_size=(128, 128))
    assert drop_path_generator(plain, 5, torch.device("cpu")) is None


def _grads_and_stats(model, fn):
    model.zero_grad()
    loss = fn(model)
    loss.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()
             if p.grad is not None}
    stats = {n: b.clone() for n, b in model.named_buffers()
             if "running" in n}
    return float(loss), grads, stats


def _assert_same(a, b):
    assert a[0] == b[0]
    for part in (1, 2):
        assert a[part].keys() == b[part].keys() and a[part]
        for n in a[part]:
            assert torch.equal(a[part][n], b[part][n]), n


def test_remat_fpn_and_heads_equal_loss_grads_and_statistics():
    """The whole model in train mode (every BatchNorm writing), plain and
    with remat_fpn + remat_heads + remat_stages 7."""
    kw = dict(device="cpu", num_classes=4, image_size=(128, 128),
              fpn_cell_repeats=2, box_class_repeats=2)
    plain = create_model("efficientdet_d0", **kw)
    rematted = create_model(
        "efficientdet_d0", remat_fpn=True, remat_heads=True,
        backbone_args={"remat_stages": 7}, **kw)
    rematted.load_state_dict(plain.state_dict())
    x = _images(5, img=128).permute(0, 2, 3, 1)

    def loss(model):
        cls, box = model.train()(x)
        return sum((c.float() ** 2).mean() for c in cls) + \
            sum(b.float().abs().mean() for b in box)

    before = {n: b.clone() for n, b in plain.named_buffers()}
    ref = _grads_and_stats(plain, loss)
    _assert_same(ref, _grads_and_stats(rematted, loss))
    # the statistics moved once: a second write would move them again
    assert any(not torch.equal(before[n], ref[2][n]) for n in ref[2])


def test_remat_stages_with_drop_path_equal_grads():
    """Backbone stages rematerialised with stochastic depth on, from the
    same generator seed: the masks are drawn before each region, so the
    recompute reuses them."""
    plain, rematted = _backbones(dict(drop_path_rate=0.5),
                                 dict(drop_path_rate=0.5, remat_stages=7))
    x = _images(6)

    def loss(model):
        return sum((f ** 2).mean() for f in model.train()(x, _gen(9)))

    _assert_same(_grads_and_stats(plain, loss),
                 _grads_and_stats(rematted, loss))
    with_drop = _grads_and_stats(copy.deepcopy(plain), loss)
    no_drop = _grads_and_stats(
        copy.deepcopy(plain),
        lambda m: sum((f ** 2).mean() for f in m.train()(x)))
    assert with_drop[0] != no_drop[0]
