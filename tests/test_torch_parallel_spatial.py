"""The port's image-H train step (``make_train_step(mesh=create_mesh((D,
S), ("data", "spatial")), spatial_axis="spatial")``) on ``gloo`` ranks,
against the port's one-process step on the global batch and against the
JAX package's (data, spatial) mesh step.

(2, 2): the tiny D0 of tests/test_torch_train_step.py (128 px, 8
classes, one FPN cell and one head repeat, random variables and EMA tree
carried from JAX by ``utils.from_jax``), ``freeze_bn='none'``, a global
batch of 4 on four ranks: data block b holds images 2b, 2b + 1 and its
two ranks split their rows. At 128 px P6 has one row a rank and P7 one
row in all, so P7 is computed whole (the map too short to split). After
one step, against (a) the port's one-process step and (b) the JAX
package's ``make_train_step(mesh=create_mesh((2, 2), ("data",
"spatial"), devices=jax.devices()[:4]), spatial_axis="spatial")`` on the
virtual CPU mesh of tests/conftest.py: loss, class_loss, box_loss and
grad_norm to rtol 2e-4, num_positives exactly, parameters to rtol 5e-4 /
atol 1e-5 (tests/test_parallel.py:73-83's tolerances); every norm
statistic and the EMA copy against (a) to the same tolerances; the four
ranks' states equal to the bit.

``create_mesh((-1, 2), ...)`` in a launch of 4 infers (2, 2)
(tests/test_parallel.py:91-94); (4, 2) is refused, naming torchrun. The
(1, 2) step of a tiny ``tf_efficientdet_d0`` (TF SAME pads, remat and
stochastic depth) against one process is
tests/test_torch_parallel_spatial_tf.py, a file of its own to keep each
file's wall time near a minute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_parallel_step import _assert_state, _assert_step, _batch
from test_torch_train_step import TINY, _port_model
from torch_dist_helpers import Ranks
from torch_parity_helpers import random_variables

from ood_object_detection_tpu.config import (
    default_detection_train_config as jax_train_config)
from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.parallel import create_mesh as jax_create_mesh
from ood_object_detection_tpu.train import make_optimizer as jax_optimizer
from ood_object_detection_tpu.train import make_train_step as jax_make_step
from ood_object_detection_tpu.train.train_state import (
    TrainState as JaxTrainState)
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.factory import create_model_from_config
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_ema

# JAX's (2, 2) step on the XLA CPU backend moves the class head's predict
# depthwise kernel, and with it grad_norm, off JAX's own one-device step
# beyond these bars, where its (4,), (1, 4) and (4, 1) steps stay within
# them (tests/jax_mesh_step_witness.py prints the distances)
JAX_2X2_MOVES = ("class_net.predict.conv_dw.weight",)
_RANK = r"""
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.parallel import create_mesh, shard_batch
from ood_object_detection_tpu_torch.parallel import spatial
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)

start = torch.load("start.pt")
out = {}
mesh = create_mesh((2, 2), ("data", "spatial"), device="cpu")
out["inferred"] = create_mesh((-1, 2), ("data", "spatial"),
                              device="cpu").shape
try:
    create_mesh((4, 2), ("data", "spatial"), device="cpu")
except ValueError as e:
    out["refused"] = str(e)
model = EfficientDet(get_efficientdet_config("efficientdet_d0").replace(
    **start["tiny"])).to(memory_format=torch.channels_last)
model.load_state_dict(start["model"])
tcfg = default_detection_train_config()
state, tx = create_train_state(model, tcfg)
for name, value in start["ema"].items():
    state.ema_params[name].copy_(value)
step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                       mesh=mesh, freeze_bn="none", spatial_axis="spatial")
spatial.reset_exchanges()
state, metrics = step(state, shard_batch(mesh, start["batch"]))
out.update(metrics={k: float(v) for k, v in metrics.items()},
           model=model.state_dict(), ema=state.ema_params,
           exchanges=dict(spatial.EXCHANGES), shape=mesh.shape)
torch.save(out, f"rank{mesh.rank}.pt")
mesh.close()
"""


def _one_process(model, batch, ema=None):
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    if ema is not None:
        load_jax_ema(state.ema_params, model, ema)
    step = make_train_step(model, tx, Anchors.from_config(model.config),
                           tcfg, freeze_bn="none")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    return ({k: float(v) for k, v in metrics.items()}, model.state_dict(),
            state.ema_params)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX mesh step's metrics and state, the one-process step, the four
    ranks' saved steps); the ranks start as soon as the start variables
    are drawn and run beside the JAX compile."""
    # tests/test_torch_train_step.py's _jax_start state, made without
    # compiling create_train_state
    model_j = JaxDet(jax_cfg("efficientdet_d0", **TINY))
    init = lambda k: model_j.init(  # noqa: E731
        k, jnp.zeros((1,) + TINY["image_size"] + (3,)), False)
    variables = random_variables(init, seed=0)
    jax_ema = random_variables(init, seed=1)["params"]
    batch = _batch()
    model = _port_model(variables)
    tmp_d0 = tmp_path_factory.mktemp("spatial_d0")
    ema = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    load_jax_ema(ema, model, jax_ema)
    torch.save({"tiny": TINY, "model": model.state_dict(), "ema": ema,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp_d0 / "start.pt")
    launch = Ranks(_RANK, 4, tmp_d0)

    tcfg_j = jax_train_config()
    tx_j = jax_optimizer(tcfg_j)
    start = JaxTrainState(step=jnp.zeros((), jnp.int32),
                          params=variables["params"],
                          batch_stats=variables["batch_stats"],
                          opt_state=tx_j.init(variables["params"]),
                          ema_params=jax_ema)
    one = _one_process(model, batch, jax_ema)

    mesh = jax_create_mesh((2, 2), ("data", "spatial"),
                           devices=jax.devices()[:4])
    jstep = jax_make_step(model_j, tx_j, JaxAnchors.from_config(
        model_j.config), tcfg_j, mesh=mesh, donate=False, freeze_bn="none",
        spatial_axis="spatial")
    jstate, jm = jstep(start, {k: jnp.asarray(v) for k, v in batch.items()})
    jax_run = ({k: float(v) for k, v in jm.items()}, jstate)
    launch.join()
    return jax_run, one, [torch.load(tmp_d0 / f"rank{r}.pt")
                          for r in range(4)]


def _equal_states(ranks):
    a = ranks[0]
    for b in ranks[1:]:
        assert a["metrics"] == b["metrics"]
        for key in ("model", "ema"):
            for name, value in a[key].items():
                assert torch.equal(value, b[key][name]), (key, name)


def test_2x2_mesh_is_made_and_inferred(runs):
    _, _, ranks = runs
    for r in ranks:
        assert r["shape"] == r["inferred"] == {"data": 2, "spatial": 2}
        assert "torchrun" in r["refused"]
        # halos both ways, P7's gathers, the squeeze-excite sums
        assert all(n > 0 for n in r["exchanges"].values()), r["exchanges"]


def test_2x2_ranks_end_in_the_same_state(runs):
    _equal_states(runs[2])


def test_2x2_ranks_equal_the_one_process_step(runs):
    _, (metrics, state_dict, ema), ranks = runs
    for r in ranks:
        _assert_step(r["metrics"], metrics)
        _assert_state(r["model"], state_dict, "state")
        _assert_state(r["ema"], ema, "EMA")


def test_2x2_ranks_equal_the_jax_spatial_step(runs):
    """Against the JAX (2, 2) step everywhere but where that step leaves
    JAX's own one-device step (JAX_2X2_MOVES): there the ranks are held to
    the port's one-process step, which tests/test_torch_train_step.py
    holds to JAX's one-device step. There the JAX (2, 2) step must be
    beyond the bars of the ranks (its distance printed with ``-s``), so
    the exemption lapses, and this test fails, if JAX's step comes to
    agree."""
    (jm, jstate), (metrics, state_dict, _), ranks = runs
    ported = _port_model(jstate.variables())
    params = {n for n, _ in ported.named_parameters()}
    want = ported.state_dict()
    for r in ranks:
        for k in ("loss", "class_loss", "box_loss"):
            np.testing.assert_allclose(r["metrics"][k], jm[k], rtol=2e-4,
                                       err_msg=k)
        assert r["metrics"]["num_positives"] == jm["num_positives"] > 0
        np.testing.assert_allclose(r["metrics"]["grad_norm"],
                                   metrics["grad_norm"], rtol=2e-4)
        _assert_state({n: v for n, v in r["model"].items()
                       if n in params and n not in JAX_2X2_MOVES},
                      want, "JAX params")
        _assert_state({n: r["model"][n] for n in JAX_2X2_MOVES},
                      state_dict, "one-process params")
    # the exemption holds itself up: on each leaf it names, JAX's (2, 2)
    # step is beyond the bars of the ranks, which are within them of the
    # one-process step (above), and so is its grad_norm
    for name in JAX_2X2_MOVES:
        got, jax_22 = ranks[0]["model"][name], want[name]
        excess = ((got - jax_22).abs() - 1e-5 - 5e-4 * jax_22.abs())
        print(f"JAX (2, 2) {name}: {int((excess > 0).sum())} of "
              f"{got.numel()} elements beyond rtol 5e-4 / atol 1e-5 of the "
              f"ranks; grad_norm {jm['grad_norm']} vs the ranks' "
              f"{ranks[0]['metrics']['grad_norm']}")
        assert bool((excess > 0).any()), name
    rel = abs(jm["grad_norm"] - ranks[0]["metrics"]["grad_norm"]) \
        / ranks[0]["metrics"]["grad_norm"]
    assert rel > 2e-4, rel


def test_spatial_axis_needs_a_2d_mesh():
    from ood_object_detection_tpu_torch.parallel import create_mesh
    model = _port_model_fresh()
    tcfg = default_detection_train_config()
    _, tx = create_train_state(model, tcfg)
    anchors = Anchors.from_config(model.config)
    mesh = create_mesh((-1,), ("data",), device="cpu")
    with pytest.raises(ValueError, match="spatial_axis"):
        make_train_step(model, tx, anchors, tcfg, mesh=mesh,
                        spatial_axis="spatial")
    mesh2 = create_mesh((1, 1), ("data", "spatial"), device="cpu")
    assert mesh2.shape == {"data": 1, "spatial": 1}
    with pytest.raises(ValueError, match="spatial_axis"):
        make_train_step(model, tx, anchors, tcfg, mesh=mesh2)
    mesh.close()
    mesh2.close()


def _port_model_fresh():
    return create_model_from_config(get_efficientdet_config(
        "efficientdet_d0").replace(**TINY), seed=0, device="cpu")

