"""The episode losses against ``jax.value_and_grad`` of the JAX package's:
``projection_phase_loss`` (phase A) and ``maml_episode_loss`` (phase B),
value and gradient of every meta parameter (``class_net``, ``proj``,
``inner_lrs``), on the tiny set-up of tests/torch_meta_helpers.py.

The second-order part of the meta-gradient — the ``class_net`` gradient
minus that of a first-order inner loop, whose inner gradients are
constants (``create_graph=False`` in the port; in the JAX package the
inner gradients pass through ``jax.lax.stop_gradient``, patched into
``sgd_fast_update`` for this test only) — is not zero and equals JAX's.

Tolerances: losses and metrics to rtol 1e-5; gradients elementwise to
rtol 1e-3 / atol 1e-5. Reached on this set-up: phase A 5.4e-6 at most
(absolute), phase B 3.3e-5 (5.0e-5 of the leaf's largest magnitude), the
second-order part 4.8e-7 (its norm 0.38 against 51.8 for the whole
class-head gradient). An atol of 1e-6 does not hold end to end: the two
trunks' f32 pyramids differ by up to 5e-6 (convolution summation order),
and the query loss's gradients carry that; given the same pyramid, the
phase-A gradients agree to 1.1e-6.
"""
import jax
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import (assert_meta_close, jax_arrays,
                                leaf_meta_params, setup)

from ood_object_detection_tpu.meta import episode as jep
from ood_object_detection_tpu.meta import inner_loop as jil
from ood_object_detection_tpu_torch.meta import episode as tep

LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5


@pytest.fixture(scope="module")
def s():
    return setup()


def _jax_meta_params(s):
    return {"class_net": s.variables["params"]["class_net"],
            "proj": s.proj_params,
            "inner_lrs": jil.init_inner_lrs(1, s.jmeta.inner_lr)}


def _port_grads(loss, meta_params):
    leaves = [(t, n, v) for t, d in meta_params.items() for n, v in d.items()]
    grads = torch.autograd.grad(loss, [v for *_, v in leaves],
                                allow_unused=True, materialize_grads=True)
    out = {}
    for (t, n, _), g in zip(leaves, grads):
        out.setdefault(t, {})[n] = g
    return out


def _check_metrics(t_metrics, j_metrics):
    assert set(t_metrics) == set(j_metrics)
    for k, v in j_metrics.items():
        np.testing.assert_allclose(t_metrics[k].item(), float(v),
                                   rtol=LOSS_RTOL, err_msg=k)


def test_projection_phase_loss_value_and_grads(s):
    def loss_fn(mp, variables, batch):
        merged = dict(variables)
        merged["params"] = {**variables["params"],
                            "class_net": mp["class_net"]}
        return jep.projection_phase_loss(s.jmodel, s.jproj, merged,
                                         mp["proj"], batch, s.jmeta, s.lsz)
    (j_loss, j_metrics), j_grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        _jax_meta_params(s), s.variables, jax_arrays(s.ep))

    mp = leaf_meta_params(s.model, s.proj, _jax_meta_params(s)["inner_lrs"])
    t_loss, t_metrics = tep.projection_phase_loss(
        s.model, s.proj, mp["class_net"], mp["proj"], s.batch, s.tmeta,
        s.lsz)
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=LOSS_RTOL)
    _check_metrics(t_metrics, j_metrics)
    assert float(j_metrics["valid_champions"]) > 0
    grads = _port_grads(t_loss, mp)
    assert not any(bool(g.any()) for g in grads["inner_lrs"].values())
    assert_meta_close(grads, j_grads, GRAD_RTOL, GRAD_ATOL, "phase A grad")


@pytest.fixture(scope="module")
def phase_b(s):
    """JAX and port phase-B (value, metrics, gradients), second order and
    first order."""
    def run(first_order):
        def loss_fn(mp, variables, batch):
            return jep.maml_episode_loss(s.jmodel, s.jproj, variables, mp,
                                         batch, s.jmeta, s.jmc, s.lsz)
        patch = pytest.MonkeyPatch()
        if first_order:
            update = jil.sgd_fast_update
            patch.setattr(jil, "sgd_fast_update",
                          lambda p, g, *a, **k: update(
                              p, jax.lax.stop_gradient(g), *a, **k))
        try:
            (j_loss, j_metrics), j_grads = jax.jit(
                jax.value_and_grad(loss_fn, has_aux=True))(
                _jax_meta_params(s), s.variables, jax_arrays(s.ep))
        finally:
            patch.undo()
        mp = leaf_meta_params(s.model, s.proj,
                              _jax_meta_params(s)["inner_lrs"])
        t_loss, t_metrics = tep.maml_episode_loss(
            s.model, s.proj, mp, s.batch, s.tmeta, s.tmc, s.lsz,
            create_graph=not first_order)
        return (j_loss, j_metrics, j_grads), (t_loss, t_metrics,
                                              _port_grads(t_loss, mp))
    return {"second": run(False), "first": run(True)}


@pytest.mark.parametrize("order", ["second", "first"])
def test_maml_episode_loss_value_and_grads(phase_b, order):
    (j_loss, j_metrics, j_grads), (t_loss, t_metrics, grads) = phase_b[order]
    np.testing.assert_allclose(t_loss.item(), float(j_loss), rtol=LOSS_RTOL)
    _check_metrics(t_metrics, j_metrics)
    assert float(j_metrics["supp_valid_champions"]) > 0
    assert any(bool(g.any()) for g in grads["inner_lrs"].values())
    assert_meta_close(grads, j_grads, GRAD_RTOL, GRAD_ATOL,
                      f"phase B {order}-order grad")


def test_second_order_part_is_live_and_matches_jax(phase_b):
    j_full, t_full = phase_b["second"][0][2], phase_b["second"][1][2]
    j_first, t_first = phase_b["first"][0][2], phase_b["first"][1][2]
    j_part = jax.tree.map(lambda a, b: a - b, j_full["class_net"],
                          j_first["class_net"])
    t_part = {n: t_full["class_net"][n] - t_first["class_net"][n]
              for n in t_full["class_net"]}
    norm = float(torch.sqrt(sum(torch.sum(p * p) for p in t_part.values())))
    full = float(torch.sqrt(sum(torch.sum(p * p)
                                for p in t_full["class_net"].values())))
    assert norm > 1e-4 * full, (norm, full)
    assert_meta_close({"class_net": t_part}, {"class_net": j_part},
                      GRAD_RTOL, GRAD_ATOL, "second-order part")
