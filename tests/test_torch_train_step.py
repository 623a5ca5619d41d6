"""One and two f32 train steps of the port from one JAX train state, against
the JAX package's ``create_train_state`` + ``make_train_step``, on the tiny
D0 of tests/test_models.py (128 px, 8 classes, one FPN cell and one head
repeat), batch 2, a few ground-truth rows plus -1 padding.

Both sides start from the same variables (random, so that frozen
BatchNorm is not the identity) and the same EMA tree
(``utils.from_jax.load_jax_variables`` / ``load_jax_ema``); the optimizer
state starts at zero on both. After each step are compared: loss,
class_loss, box_loss, num_positives, grad_norm, every updated parameter,
every BatchNorm running mean and variance, and the EMA copy, for
``freeze_bn`` 'none' and 'backbone'.

Tolerances (f32): losses and grad_norm to rtol 1e-4 (measured at most
2.3e-5, grad_norm at step 2 with nothing frozen); parameters, running
statistics and EMA to rtol 1e-4 / atol 2e-5 (measured at most 1.2e-5
absolute on a parameter, 1.8e-6 on a running statistic: the two
frameworks sum convolutions and BatchNorm statistics in other orders, and
a step of lr 0.09 carries the gradient's rounding into the parameters);
num_positives exactly.
"""
import copy


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import random_variables

from ood_object_detection_tpu.config import (
    default_detection_train_config as jax_train_config,
)
from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.train import create_train_state as jax_create
from ood_object_detection_tpu.train import make_optimizer as jax_optimizer
from ood_object_detection_tpu.train import make_train_step as jax_make_step
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config,
    get_efficientdet_config,
)
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (
    create_train_state,
    make_train_step,
)
from ood_object_detection_tpu_torch.utils.from_jax import (
    load_jax_ema,
    load_jax_variables,
)

IMG = 128
TINY = dict(num_classes=8, image_size=(IMG, IMG), fpn_cell_repeats=1,
            box_class_repeats=1)
METRICS = ("loss", "class_loss", "box_loss", "grad_norm")


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(2):
        boxes = np.zeros((2, 8, 4), np.float32)
        cls = np.full((2, 8), -1, np.int32)
        for i, n in enumerate((5, 2)):
            yx = rng.uniform(0, IMG - 48, (n, 2))
            hw = rng.uniform(12, 48, (n, 2))
            boxes[i, :n] = np.concatenate([yx, yx + hw], -1)
            cls[i, :n] = rng.integers(1, 8, n)
        out.append({"image": rng.normal(0, 1, (2, IMG, IMG, 3))
                    .astype(np.float32), "bbox": boxes, "cls": cls})
    return out


def _jax_start():
    """The JAX model, optimizer and train state at step 0:
    ``create_train_state``'s, with random variables and EMA tree."""
    cfg = jax_cfg("efficientdet_d0", **TINY)
    model = JaxDet(cfg)
    tcfg = jax_train_config()
    state = jax.jit(lambda k: jax_create(model, tcfg, k)[0])(
        jax.random.key(0))
    init = lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 3)), False)  # noqa
    variables = random_variables(init, seed=0)
    tx = jax_optimizer(tcfg)
    state = state.replace(params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          ema_params=random_variables(init, seed=1)["params"],
                          opt_state=tx.init(variables["params"]))
    return model, tx, tcfg, state


def _jax_steps(start, freeze_bn, batches):
    """JAX states and metrics after each batch."""
    model, tx, tcfg, state = start
    step = jax_make_step(model, tx, JaxAnchors.from_config(model.config),
                         tcfg, donate=False, freeze_bn=freeze_bn)
    states, metrics = [], []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        states.append(state)
        metrics.append({k: float(v) for k, v in m.items()})
    return states, metrics


@pytest.fixture(scope="module")
def jax_start():
    return _jax_start()


@pytest.fixture(scope="module", params=["none", "backbone"])
def runs(request, jax_start):
    """(freeze_bn, JAX start state, JAX states and metrics after steps 1
    and 2, the batches)."""
    batches = _batches()
    states, metrics = _jax_steps(jax_start, request.param, batches)
    return request.param, jax_start[3], states, metrics, batches


def _port_model(variables):
    cfg = get_efficientdet_config("efficientdet_d0", **TINY)
    model = EfficientDet(cfg)
    load_jax_variables(model, variables)
    return model.to(memory_format=torch.channels_last)


def test_two_f32_steps_match_jax(runs):
    freeze_bn, start, jax_states, jax_metrics, batches = runs
    model = _port_model({"params": start.params,
                         "batch_stats": start.batch_stats})
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    load_jax_ema(state.ema_params, model, start.ema_params)
    step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                           freeze_bn=freeze_bn)
    frozen = {n: b.clone() for n, b in model.named_buffers()
              if n.startswith("backbone.")}
    for i, batch in enumerate(batches):
        state, metrics = step(state, {k: torch.from_numpy(v)
                                      for k, v in batch.items()})
        ref = jax_metrics[i]
        for k in METRICS:
            np.testing.assert_allclose(float(metrics[k]), ref[k], rtol=1e-4,
                                       err_msg=f"step {i + 1} {k}")
        assert float(metrics["num_positives"]) == ref["num_positives"] > 0

        expected = _port_model(jax_states[i].variables())
        want = expected.state_dict()
        for name, value in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                       rtol=1e-4, atol=2e-5,
                                       err_msg=f"step {i + 1} {name}")
        ema = {n: torch.zeros_like(p) for n, p in state.ema_params.items()}
        load_jax_ema(ema, expected, jax_states[i].ema_params)
        for name, value in state.ema_params.items():
            np.testing.assert_allclose(value.numpy(), ema[name].numpy(),
                                       rtol=1e-4, atol=2e-5,
                                       err_msg=f"step {i + 1} EMA {name}")
    assert state.step == 2
    for name, value in model.named_buffers():
        if name in frozen and name.endswith(("running_mean", "running_var")):
            assert torch.equal(value, frozen[name]) == (freeze_bn != "none")


def test_train_mode_running_variance_is_biased():
    """A train-mode BatchNorm step updates the running variance with the
    biased batch variance, as flax does (torch's own BatchNorm would use
    N / (N - 1) of it)."""
    from ood_object_detection_tpu_torch.models.heads import HeadBatchNorm
    from ood_object_detection_tpu_torch.models.layers import BatchNorm2d
    x = torch.randn(2, 3, 3, 3, generator=torch.Generator().manual_seed(0))
    biased = x.permute(1, 0, 2, 3).reshape(3, -1).var(dim=1, unbiased=False)
    for norm in (BatchNorm2d(3), HeadBatchNorm(3)):
        norm.train()
        norm(x)
        torch.testing.assert_close(norm.running_var, 0.99 + 0.01 * biased,
                                   rtol=1e-5, atol=1e-6)
    model = copy.deepcopy(norm).eval()
    before = model.running_var.clone()
    model(x)
    assert torch.equal(model.running_var, before)


def _optax_filled(opt_state, tree, count=5):
    """``opt_state`` with every momentum trace and adam moment replaced by
    ``tree`` (|tree| for the second moment; optax's masked leaves kept) and
    every adam count by ``count``."""
    import optax

    def masked(node, values):
        return jax.tree.map(
            lambda m, r: m if isinstance(m, optax.MaskedNode) else r,
            node, values, is_leaf=lambda x: isinstance(x, optax.MaskedNode))

    def fill(node):
        if hasattr(node, "trace"):
            return node._replace(trace=masked(node.trace, tree))
        if hasattr(node, "mu") and hasattr(node, "nu"):
            return node._replace(
                mu=masked(node.mu, tree),
                nu=masked(node.nu, jax.tree.map(np.abs, tree)),
                count=jnp.asarray(count, jnp.int32))
        if isinstance(node, dict):
            return {k: fill(v) for k, v in node.items()}
        if isinstance(node, tuple):
            children = [fill(c) for c in node]
            return type(node)(*children) if hasattr(node, "_replace") \
                else tuple(children)
        return node
    return fill(opt_state)


def _expected_params(variables, tree):
    """{port parameter name: tensor} of a params-shaped JAX ``tree``,
    through ``load_jax_variables`` (held by tests/test_torch_from_jax.py)."""
    model = _port_model({"params": tree,
                         "batch_stats": variables["batch_stats"]})
    return dict(model.named_parameters())


def test_carried_train_state_continues_like_jax(jax_start):
    """``utils.from_jax.load_jax_train_state``: a JAX train state at step 7
    with a non-zero momentum trace becomes the port's (parameters,
    statistics, EMA, trace as momentum buffers bit-equal, step 7), and one
    more step on each side agrees to the tolerances above."""
    from ood_object_detection_tpu_torch.utils.from_jax import (
        load_jax_train_state)
    model_j, tx_j, tcfg_j, start = jax_start
    rng = np.random.default_rng(3)
    trace = jax.tree.map(
        lambda p: rng.normal(0, 0.01, p.shape).astype(np.float32),
        start.params)
    jstate = start.replace(opt_state=_optax_filled(start.opt_state, trace),
                           step=jnp.asarray(7, jnp.int32))
    batch = _batches()[0]
    jstates, jmetrics = _jax_steps((model_j, tx_j, tcfg_j, jstate),
                                   "backbone", [batch])

    model = _port_model(start.variables())
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    load_jax_train_state(state, jstate)
    assert state.step == 7
    want = _expected_params(start.variables(), trace)
    for name, p in model.named_parameters():
        assert torch.equal(tx.state[p]["momentum_buffer"], want[name]), name
    step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                           freeze_bn="backbone")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    assert state.step == 8
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), jmetrics[0][k],
                                   rtol=1e-4, err_msg=k)
    expected = _port_model(jstates[0].variables()).state_dict()
    for name, value in model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), expected[name].numpy(),
                                       rtol=1e-4, atol=2e-5, err_msg=name)
    trace_after = _expected_params(
        start.variables(),
        _optax_states_trace(jstates[0].opt_state))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(
            tx.state[p]["momentum_buffer"].numpy(),
            trace_after[name].detach().numpy(), rtol=1e-4, atol=2e-5,
            err_msg=f"trace {name}")


def _optax_states_trace(opt_state):
    """The momentum trace of an ungrouped optax SGD state."""
    for node in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(
            x, "trace")):
        if hasattr(node, "trace"):
            return node.trace
    raise AssertionError("no trace in the optax state")


@pytest.mark.parametrize("kind", ["adam", "grouped_momentum"])
def test_carried_optimizer_state_is_exact(kind):
    """adam's moments and count, and the per-group momentum traces of a
    ``make_grouped_optimizer`` state (optax ``multi_transform``, whose
    groups mask each other's leaves), carried into torch Adam / SGD state
    bit for bit."""
    from ood_object_detection_tpu.train import (
        make_grouped_optimizer as jax_grouped)
    from ood_object_detection_tpu_torch.train import make_grouped_optimizer
    from ood_object_detection_tpu_torch.utils.from_jax import (
        load_jax_train_state)
    cfg = jax_cfg("efficientdet_d0", **TINY)
    init = lambda k: JaxDet(cfg).init(k, jnp.zeros((1, IMG, IMG, 3)),  # noqa
                                      False)
    variables = random_variables(init, seed=0)
    tree = random_variables(init, seed=2)["params"]
    groups = {"backbone": 0.1, "fpn": 0.05, "heads": 0.01}
    if kind == "adam":
        tcfg_j = jax_train_config()
        tcfg_j.opt = "adam"
        tx_j = jax_optimizer(tcfg_j)
    else:
        tx_j = jax_grouped(jax_train_config(), groups)
    opt_state = _optax_filled(tx_j.init(variables["params"]), tree)
    jstate = {"params": variables["params"],
              "batch_stats": variables["batch_stats"],
              "ema_params": variables["params"], "opt_state": opt_state,
              "step": 5}

    model = _port_model(variables)
    tcfg = default_detection_train_config()
    tx = None
    if kind == "adam":
        tcfg.opt = "adam"
    else:
        tx = make_grouped_optimizer(tcfg, groups, model)
    state, tx = create_train_state(model, tcfg, tx=tx)
    load_jax_train_state(state, jstate)
    assert state.step == 5
    want = _expected_params(variables, tree)
    for name, p in model.named_parameters():
        st = tx.state[p]
        if kind == "adam":
            assert torch.equal(st["exp_avg"], want[name]), name
            assert torch.equal(st["exp_avg_sq"], want[name].abs()), name
            assert float(st["step"]) == 5.0
        else:
            assert torch.equal(st["momentum_buffer"], want[name]), name
