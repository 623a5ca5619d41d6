"""The class and box heads of the episodic harness against the JAX
package's ``EfficientDet.class_head`` / ``box_head``: ``ret_activs``,
``level_offset``, ``force_batch_stats`` and ``heads="both"`` with
``separate_head`` (the second pointwise predict conv ``predict_sep``),
on random NHWC pyramids [2, g, g, 64] (g = 16 .. 1) and random variables
carried across by ``utils.from_jax``. f32 outputs to 1e-5.

Also: no pass of the meta path writes a BatchNorm running statistic
(``force_batch_stats`` in eval mode, ``layers.batch_stats_mode``), and
``predict_sep`` loads from the JAX tree.
"""
import jax
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import configs, jax_model

from ood_object_detection_tpu.models import EfficientDet as JaxDet
from ood_object_detection_tpu_torch.meta import episode as tep
from ood_object_detection_tpu_torch.meta.inner_loop import class_head
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.models.layers import batch_stats_mode
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

GRIDS = (16, 8, 4, 2, 1)


@pytest.fixture(scope="module")
def heads():
    _, jmc, tmeta, tmc = configs(separate_head=True)
    jmodel, variables = jax_model(jmc, seed=3)
    model = EfficientDet(tmc)
    load_jax_variables(model, variables)
    rng = np.random.default_rng(5)
    pyramid = [rng.normal(0, 1, (2, g, g, 64)).astype(np.float32)
               for g in GRIDS]
    return jmodel, variables, model.eval(), pyramid, tmeta


def _close(got, want, atol=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=atol)


CASES = [
    dict(),
    dict(ret_activs=True, level_offset=2, force_batch_stats=True),
    dict(ret_activs=True, level_offset=2, force_batch_stats=True,
         heads="both"),
    dict(level_offset=1, heads="both"),
]


@pytest.mark.parametrize("kw", CASES, ids=lambda kw: ",".join(kw) or "main")
def test_class_head_matches_jax(heads, kw):
    jmodel, variables, model, pyramid, _ = heads
    want = jmodel.apply(variables, [jax.numpy.asarray(p) for p in pyramid],
                        training=False, method=JaxDet.class_head, **kw)
    got = class_head(model, [torch.from_numpy(p) for p in pyramid], None,
                     **kw)
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(w) == len(GRIDS) - kw.get("level_offset", 0)
        _close(g, w)


def test_box_head_matches_jax(heads):
    jmodel, variables, model, pyramid, _ = heads
    for train in (False, True):
        want = jmodel.apply(variables, [jax.numpy.asarray(p) for p in pyramid],
                            train, method=JaxDet.box_head,
                            mutable=["batch_stats"] if train else False)
        if train:
            want = want[0]
        with batch_stats_mode(model.box_net, train):
            got = model.box_head([torch.from_numpy(p) for p in pyramid])
        _close(got, want)


def test_predict_sep_loads_from_jax(heads):
    _, variables, model, _, _ = heads
    want = np.asarray(variables["params"]["class_net"]["predict_sep"]["kernel"])
    np.testing.assert_array_equal(
        model.class_net.predict_sep.weight.detach().numpy(),
        want.transpose(3, 2, 0, 1))


def test_separate_head_needs_separable_convs():
    _, _, _, tmc = configs(separate_head=True)
    with pytest.raises(ValueError, match="separable"):
        EfficientDet(tmc.replace(separable_conv=False))


def test_meta_forwards_write_no_running_statistics(heads):
    """Every BatchNorm running statistic is bit-unchanged after the meta
    path's forwards in every BN mode, with the model in eval or train
    mode, and each BatchNorm's mode is restored after."""
    _, _, model, pyramid, tmeta = heads
    meta = tmeta.replace(freeze_bb_bn=False, freeze_fpn_bn=False,
                         freeze_box_bn=False)
    before = {n: b.clone() for n, b in model.named_buffers()}
    images = torch.randn(2, 128, 128, 3)
    acts = [torch.from_numpy(p) for p in pyramid]
    for train in (False, True):
        model.train(train)
        modes = [m.training for m in model.modules()]
        with torch.enable_grad():
            tep._image_features(model, images, meta, grad_bb=True,
                                grad_fpn=True)
            tep._box_head(model, acts, meta)
            class_head(model, acts, None, ret_activs=True, level_offset=2,
                       force_batch_stats=True, heads="both")
            class_head(model, acts, None)
        assert modes == [m.training for m in model.modules()]
    model.eval()
    for name, value in model.named_buffers():
        assert torch.equal(value, before[name]), name
