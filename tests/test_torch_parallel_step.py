"""The port's data-parallel train step on two ``gloo`` ranks against the
port's one-process step on the global batch and against the JAX
package's mesh step (``make_train_step(mesh=create_mesh((2,),
("data",)))`` on the 2-device slice of the 8-device virtual mesh).

The tiny D0 of tests/test_torch_train_step.py (128 px, 8 classes, one
FPN cell and one head repeat, random variables and EMA tree carried from
JAX by ``utils.from_jax``), ``freeze_bn='none'`` so that every BatchNorm
takes the global batch's moments, and a global batch of 4 with rank r's
2 rows the r-th block. After one step: loss, class_loss, box_loss and
grad_norm to rtol 2e-4, num_positives exactly, every parameter to rtol
5e-4 / atol 1e-5 (tests/test_parallel.py:73-83's tolerances, which hold
the JAX mesh step to its one-device step); the two ranks' states equal
to the bit, and every BatchNorm statistic and the EMA copy to the
one-process step's (the same tolerances).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from test_torch_train_step import TINY, _jax_start, _port_model
from torch_dist_helpers import Ranks

from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.parallel import create_mesh as jax_create_mesh
from ood_object_detection_tpu.train import make_train_step as jax_make_step
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config)
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_ema

IMG = TINY["image_size"][0]
METRICS = ("loss", "class_loss", "box_loss", "grad_norm")

_RANK = r"""
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.parallel import create_mesh, shard_batch
from ood_object_detection_tpu_torch.parallel.mesh import all_reduce_sum
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)

start = torch.load("start.pt")
mesh = create_mesh((2,), ("data",), device="cpu")
model = EfficientDet(get_efficientdet_config("efficientdet_d0").replace(
    **start["tiny"])).to(memory_format=torch.channels_last)
model.load_state_dict(start["model"])
tcfg = default_detection_train_config()
state, tx = create_train_state(model, tcfg)
for name, value in start["ema"].items():
    state.ema_params[name].copy_(value)
step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                       mesh=mesh, freeze_bn="none")
state, metrics = step(state, shard_batch(mesh, start["batch"]))
torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
            "model": model.state_dict(), "ema": state.ema_params,
            "collectives": all_reduce_sum.calls}, f"rank{mesh.rank}.pt")
mesh.close()
"""


def _batch():
    rng = np.random.default_rng(11)
    boxes = np.zeros((4, 8, 4), np.float32)
    cls = np.full((4, 8), -1, np.int32)
    for i, n in enumerate((5, 2, 3, 1)):
        yx = rng.uniform(0, IMG - 48, (n, 2))
        hw = rng.uniform(12, 48, (n, 2))
        boxes[i, :n] = np.concatenate([yx, yx + hw], -1)
        cls[i, :n] = rng.integers(1, 8, n)
    return {"image": rng.normal(0, 1, (4, IMG, IMG, 3)).astype(np.float32),
            "bbox": boxes, "cls": cls}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX mesh step's metrics and state, the port's one-process step's
    metrics / state_dict / EMA, each rank's saved step)."""
    tmp = tmp_path_factory.mktemp("dp_step")
    model_j, tx_j, tcfg_j, start = _jax_start()
    batch = _batch()

    model = _port_model({"params": start.params,
                         "batch_stats": start.batch_stats})
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    load_jax_ema(state.ema_params, model, start.ema_params)
    torch_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    torch.save({"tiny": TINY, "model": model.state_dict(),
                "ema": state.ema_params, "batch": torch_batch},
               tmp / "start.pt")
    launch = Ranks(_RANK, 2, tmp)      # the ranks run beside the JAX compile

    step = make_train_step(model, tx, Anchors.from_config(model.config),
                           tcfg, freeze_bn="none")
    state, metrics = step(state, torch_batch)
    one = ({k: float(v) for k, v in metrics.items()}, model.state_dict(),
           state.ema_params)

    mesh = jax_create_mesh((2,), ("data",), devices=jax.devices()[:2])
    jstep = jax_make_step(model_j, tx_j, JaxAnchors.from_config(
        model_j.config), tcfg_j, mesh=mesh, donate=False, freeze_bn="none")
    jstate, jm = jstep(start, {k: jnp.asarray(v) for k, v in batch.items()})
    jax_run = ({k: float(v) for k, v in jm.items()}, jstate)
    launch.join()
    ranks = [torch.load(tmp / f"rank{r}.pt") for r in range(2)]
    return jax_run, one, ranks


def _assert_step(metrics, ref):
    for k in METRICS:
        np.testing.assert_allclose(metrics[k], ref[k], rtol=2e-4, err_msg=k)
    assert metrics["num_positives"] == ref["num_positives"] > 0


def _assert_state(got, want, what):
    for name, value in got.items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(value.numpy(), want[name].numpy(),
                                   rtol=5e-4, atol=1e-5,
                                   err_msg=f"{what} {name}")


def test_ranks_end_in_the_same_state(runs):
    _, _, ranks = runs
    a, b = ranks
    assert a["metrics"] == b["metrics"]
    for name, value in a["model"].items():
        assert torch.equal(value, b["model"][name]), name
    for name, value in a["ema"].items():
        assert torch.equal(value, b["ema"][name]), name
    # every norm's moments, forward and backward, and the gradient and
    # positives and losses: the step's collectives are counted
    assert a["collectives"] == b["collectives"] > 100


def test_two_ranks_equal_the_one_process_step(runs):
    _, (metrics, state_dict, ema), ranks = runs
    for r in ranks:
        _assert_step(r["metrics"], metrics)
        _assert_state(r["model"], state_dict, "state")
        _assert_state(r["ema"], ema, "EMA")


def test_two_ranks_equal_the_jax_mesh_step(runs):
    (jm, jstate), _, ranks = runs
    want = _port_model(jstate.variables()).state_dict()
    params = {n for n, _ in _port_model(jstate.variables())
              .named_parameters()}
    for r in ranks:
        _assert_step(r["metrics"], jm)
        _assert_state({n: v for n, v in r["model"].items() if n in params},
                      want, "JAX params")


def test_the_one_process_step_equals_the_jax_mesh_step(runs):
    """The reference the ranks are held to is itself JAX's: the port's
    one-process step on the global batch against the JAX mesh step."""
    (jm, _), (metrics, _, _), _ = runs
    _assert_step(metrics, jm)
