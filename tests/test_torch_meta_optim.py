"""``make_meta_optimizer`` against the JAX package's optax chain
(clip_by_global_norm, then multi_transform over the 'predict' / 'main' /
'staged' / 'lrs' groups), mirroring tests/test_separate_head.py:69-140 on
a miniature meta-parameter tree with one leaf of every group: adam and
nesterov SGD, with and without ``separate_head``, with the inner LRs
staged (``learn_inner``), frozen (``learn_inner=False``) or at a constant
``lr_lr``; 70 updates of random gradients (some above the clip norm),
across ``lr_stage_step`` 61.

After every update the parameters equal optax's to rtol 1e-5 / atol
1e-6, the staged groups are bit-unchanged before step 61 and move after,
and at the end the adam moments / SGD traces equal optax's to rtol 1e-5 /
atol 1e-7. The two differ in the last bits: the global norm of the clip
sums in another order, and optax's f32 bias correction ``1 - b**t`` is
not numpy's f32 power; over 70 steps at LR 0.5 (``lr_lr``) that reaches
5e-7 on a parameter of 0.04.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import optax_moments, port_leaf_to_jax

from ood_object_detection_tpu.meta.config import MetaConfig as JaxMeta
from ood_object_detection_tpu.meta.episode import (
    make_meta_optimizer as jax_optimizer)
from ood_object_detection_tpu_torch.meta import MetaConfig
from ood_object_detection_tpu_torch.meta.episode import make_meta_optimizer

STEPS = 70
PORT_NAMES = {
    "class_net": ["conv_rep.0.conv_pw.weight", "conv_rep.0.conv_pw.bias",
                  "predict.conv_dw.weight", "predict.conv_pw.weight",
                  "predict.conv_pw.bias", "predict_sep.weight",
                  "predict_sep.bias", "bn_rep.0.0.bn.weight"],
    "proj": ["dense.0.weight", "dot_mult"],
    "inner_lrs": ["conv", "predict_dw", "predict_pw"],
}


def _jax_tree(rng):
    def r(*shape):
        return jnp.asarray(rng.normal(0, 1, shape).astype(np.float32))
    return {
        "class_net": {
            "conv_rep_0": {"conv_pw": {"kernel": r(1, 1, 4, 4),
                                       "bias": r(4)}},
            "predict": {"conv_dw": {"kernel": r(3, 3, 1, 4)},
                        "conv_pw": {"kernel": r(1, 1, 4, 9), "bias": r(9)}},
            "predict_sep": {"kernel": r(1, 1, 4, 9), "bias": r(9)},
            "bn_rep_0_0": {"scale": r(4)},
        },
        "proj": {"dense_0": {"kernel": r(4, 4)}, "dot_mult": r()},
        "inner_lrs": {"conv": r(1), "predict_dw": r(), "predict_pw": r()},
    }


def _port(tree):
    return {t: {n: torch.from_numpy(port_leaf_to_jax(tree, t, n).copy())
                for n in names} for t, names in PORT_NAMES.items()}


CASES = [(optim, sep, lrs) for optim in ("adam", "nesterov")
         for sep in (False, True) for lrs in ("staged", "frozen", "lr_lr")]


@pytest.mark.parametrize("optim,separate_head,lrs", CASES,
                         ids=["-".join(map(str, c)) for c in CASES])
def test_meta_optimizer_matches_optax(optim, separate_head, lrs):
    kw = dict(optim=optim, separate_head=separate_head,
              learn_inner=lrs != "frozen")
    lr_lr = 0.5 if lrs == "lr_lr" else None
    rng = np.random.default_rng(len(optim) + 2 * separate_head)
    params = _jax_tree(rng)
    tx = jax_optimizer(JaxMeta(**kw), lr_lr=lr_lr)
    opt_state = tx.init(params)
    update = jax.jit(lambda g, s, p: tx.update(g, s, p))

    port = _port(params)
    opt = make_meta_optimizer(MetaConfig(**kw), lr_lr=lr_lr)
    opt.init(port)
    start = {t: {n: v.clone() for n, v in d.items()} for t, d in port.items()}
    staged = [(t, n) for t, names in PORT_NAMES.items() for n in names
              if opt.label(t, n) == "staged"
              or (opt.label(t, n) == "lrs" and lrs == "staged")]
    for step in range(STEPS):
        scale = rng.uniform(0.1, 1.5)
        grads = jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, scale, x.shape)
                                  .astype(np.float32)), params)
        updates, opt_state = update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step(_port(grads))
        for t, names in PORT_NAMES.items():
            for n in names:
                np.testing.assert_allclose(
                    port[t][n].numpy(), port_leaf_to_jax(params, t, n),
                    rtol=1e-5, atol=1e-6, err_msg=f"step {step} {t} {n}")
        for t, n in staged:
            unchanged = torch.equal(port[t][n], start[t][n])
            assert unchanged == (step < 61), (step, t, n)
    if lrs == "frozen":
        for n in PORT_NAMES["inner_lrs"]:
            assert torch.equal(port["inner_lrs"][n], start["inner_lrs"][n])
    want = optax_moments(opt_state, PORT_NAMES)
    assert want
    for (moment, t, n), value in want.items():
        np.testing.assert_allclose(opt.state[t, n][moment].numpy(), value,
                                   rtol=1e-5, atol=1e-7,
                                   err_msg=f"{moment} {t} {n}")
