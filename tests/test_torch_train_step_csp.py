"""One f32 train step of CSPResDet-50 (the CSP backbone, leaky-ReLU, SiLU
plain-conv heads, bilinear upsampling, three aspect ratios) against the
JAX package's ``make_train_step``, at tests/test_torch_train_step.py's
size (128 px, 8 classes, one BiFPN cell and one head repeat, batch 2)
and tolerances (metrics to rtol 1e-4; every parameter, running statistic
and the EMA to rtol 1e-4 / atol 2e-5), with the backbone's BatchNorm
frozen (``freeze_bn="backbone"``, the train path's setting). Both sides
start from the same random variables and EMA tree and a zero optimizer
state (the JAX state is made from them directly, with no compiled
``create_train_state``).
"""
import jax.numpy as jnp
import numpy as np
import torch
from torch_parity_helpers import random_variables
from test_torch_train_step import (IMG, METRICS, TINY, _batches, _jax_steps,
                                   _port_model)

from ood_object_detection_tpu.config import (
    default_detection_train_config as jax_train_config,
)
from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.train import make_optimizer as jax_optimizer
from ood_object_detection_tpu.train.train_state import TrainState
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config)
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_ema

NAME = "cspresdet50"


def _jax_start():
    model = JaxDet(jax_cfg(NAME, **TINY))
    tcfg = jax_train_config()
    init = lambda k: model.init(k, jnp.zeros((1, IMG, IMG, 3)), False)  # noqa
    variables = random_variables(init, seed=0)
    tx = jax_optimizer(tcfg)
    state = TrainState(step=jnp.zeros((), jnp.int32),
                       params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]),
                       ema_params=random_variables(init, seed=1)["params"])
    return model, tx, tcfg, state


def test_cspresdet50_f32_step_matches_jax():
    start = _jax_start()
    batch = _batches()[:1]
    jax_states, jax_metrics = _jax_steps(start, "backbone", batch)
    jstate = start[3]
    model = _port_model({"params": jstate.params,
                         "batch_stats": jstate.batch_stats}, NAME)
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    load_jax_ema(state.ema_params, model, jstate.ema_params)
    step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                           freeze_bn="backbone")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch[0].items()})
    for k in METRICS:
        np.testing.assert_allclose(float(metrics[k]), jax_metrics[0][k],
                                   rtol=1e-4, err_msg=k)
    assert float(metrics["num_positives"]) == \
        jax_metrics[0]["num_positives"] > 0
    expected = _port_model(jax_states[0].variables(), NAME)
    want = expected.state_dict()
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                       rtol=1e-4, atol=2e-5, err_msg=key)
    ema = {n: torch.zeros_like(p) for n, p in state.ema_params.items()}
    load_jax_ema(ema, expected, jax_states[0].ema_params)
    for key, value in state.ema_params.items():
        np.testing.assert_allclose(value.numpy(), ema[key].numpy(),
                                   rtol=1e-4, atol=2e-5, err_msg=key)
