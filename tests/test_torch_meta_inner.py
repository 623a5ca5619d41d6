"""meta/inner_loop.py against the JAX package's.

- The adapted class-head leaves and the LR each one gets (the port's
  parameter names mapped onto the flax paths) equal JAX's
  ``sgd_fast_update`` for only_final x separate_head, with per-layer and
  shared LRs; a freeze rule that adapts nothing raises on both sides.
- ``support_pseudo_loss`` (loss and metrics) to rtol 1e-5, and
  ``inner_adapt``'s fast weights after 1 and 2 steps to rtol 1e-4 /
  atol 1e-6, with and without ``separate_head``.

As in the JAX package's own inner-loop test, the support activations are
random pyramids (at a 256 px support's grids, so the top level keeps its
top 12.5 % and the other two keep all): the untrained trunk's maps are
nearly constant.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import (assert_meta_close, configs, jax_model,
                                jax_projection, port_leaf_to_jax, port_model)

from ood_object_detection_tpu.meta import inner_loop as jil
from ood_object_detection_tpu_torch.meta import inner_loop as til
from ood_object_detection_tpu_torch.utils.from_jax import inner_lrs_from_jax

GRIDS = (32, 16, 8, 4, 2)


@pytest.fixture(scope="module", params=[False, True],
                ids=["main_head", "separate_head"])
def side(request):
    jmeta, jmc, tmeta, tmc = configs(separate_head=request.param)
    jmodel, variables = jax_model(jmc, seed=7)
    jproj, proj_params = jax_projection(jmeta)
    model, proj = port_model(tmc, variables, proj_params, tmeta)
    rng = np.random.default_rng(8)
    activs = [rng.normal(0, 1, (2, g, g, 64)).astype(np.float32)
              for g in GRIDS]
    jlrs = {"conv": jnp.asarray([0.11], jnp.float32),
            "predict_dw": jnp.float32(0.13), "predict_pw": jnp.float32(0.17)}
    return dict(jmeta=jmeta, tmeta=tmeta, jmodel=jmodel, variables=variables,
                jproj=jproj, proj_params=proj_params, model=model, proj=proj,
                activs=activs, jlrs=jlrs)


@pytest.mark.parametrize("only_final", [False, True])
@pytest.mark.parametrize("multi_inner", [True, False])
def test_adapted_leaves_and_lrs_match_jax(side, only_final, multi_inner):
    sep = side["tmeta"].separate_head
    jlrs = side["jlrs"] if multi_inner else {"shared": jnp.float32(0.19)}
    zeros = jax.tree.map(jnp.zeros_like, side["variables"]["params"]
                         ["class_net"])
    new = jil.sgd_fast_update(zeros, jax.tree.map(jnp.ones_like, zeros),
                              jlrs, only_final=only_final, separate_head=sep)
    names = [n for n, _ in side["model"].class_net.named_parameters()]
    rates = til.adapted_lrs(names, inner_lrs_from_jax(jlrs), only_final, sep)
    adapted = set()
    for name in names:
        step = -port_leaf_to_jax({"class_net": new}, "class_net", name)
        if np.any(step != 0):
            adapted.add(name)
            np.testing.assert_array_equal(
                np.full_like(step, float(rates[name])), step, err_msg=name)
    assert adapted == set(rates)
    if sep:
        assert "predict.conv_pw.weight" not in adapted
        assert "predict_sep.weight" in adapted


def test_no_adapted_leaf_raises(side):
    bn = {k: v for k, v in side["variables"]["params"]["class_net"].items()
          if k.startswith("bn_rep")}
    with pytest.raises(ValueError, match="adapts no class_net leaves"):
        jil.sgd_fast_update(bn, bn, side["jlrs"])
    port_bn = {n: p for n, p in side["model"].class_net.named_parameters()
               if n.startswith("bn_rep")}
    with pytest.raises(ValueError, match="adapts no class_net leaves"):
        til.sgd_fast_update(port_bn, port_bn,
                            inner_lrs_from_jax(side["jlrs"]))


def _port_args(side):
    class_params = {n: p.detach().clone().requires_grad_()
                    for n, p in side["model"].class_net.named_parameters()}
    proj_params = dict(side["proj"].named_parameters())
    return class_params, proj_params, [torch.from_numpy(a)
                                       for a in side["activs"]]


def test_support_pseudo_loss_matches_jax(side):
    variables = side["variables"]
    loss, metrics = jax.jit(lambda v, cp, pp, a: jil.support_pseudo_loss(
        side["jmodel"], side["jproj"], v, cp, pp, a, side["jmeta"]))(
        variables, variables["params"]["class_net"], side["proj_params"],
        [jnp.asarray(a) for a in side["activs"]])
    class_params, proj_params, activs = _port_args(side)
    t_loss, t_metrics = til.support_pseudo_loss(
        side["model"], side["proj"], class_params, proj_params, activs,
        side["tmeta"])
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    assert set(t_metrics) == set(metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(t_metrics[k].item(), float(v), rtol=1e-5,
                                   err_msg=k)
    assert float(metrics["supp_valid_champions"]) > 0


@pytest.mark.parametrize("steps", [1, 2])
def test_inner_adapt_matches_jax(side, steps):
    jmeta = side["jmeta"].replace(steps=steps)
    fast, metrics = jax.jit(lambda v, pp, a: jil.inner_adapt(
        side["jmodel"], side["jproj"], v, pp, side["jlrs"], a, jmeta))(
        side["variables"], side["proj_params"],
        [jnp.asarray(a) for a in side["activs"]])
    class_params, proj_params, activs = _port_args(side)
    t_fast, t_metrics = til.inner_adapt(
        side["model"], side["proj"], class_params, proj_params,
        inner_lrs_from_jax(side["jlrs"]), activs,
        side["tmeta"].replace(steps=steps))
    assert_meta_close({"class_net": t_fast}, {"class_net": fast}, rtol=1e-4,
                      atol=1e-6, what=f"{steps} steps")
    moved = [n for n, p in t_fast.items()
             if not torch.equal(p.detach(), class_params[n].detach())]
    assert moved
    np.testing.assert_allclose(t_metrics["supp_class_loss"].item(),
                               float(metrics["supp_class_loss"]), rtol=1e-5)
