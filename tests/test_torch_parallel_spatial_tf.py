"""The port's image-H train step on a (1, 2) mesh of two ``gloo`` ranks
against one process: a tiny ``tf_efficientdet_d0`` (TF SAME pads
everywhere, whose pads the split takes from the global height) with
stochastic depth (rate 0.2) and remat of the first two backbone stages,
the FPN cells and the heads (the halo exchanges of a rematerialised block
run again in the backward), seeded weights (``create_model_from_config``,
seed 0), 128 px, 8 classes, one FPN cell and one head repeat, a batch of
2, ``freeze_bn='none'``.

After one step of ``make_train_step(..., spatial_axis="spatial")``: loss,
class_loss, box_loss and grad_norm to rtol 2e-4, num_positives exactly,
every parameter, BatchNorm statistic and the EMA copy to rtol 5e-4 /
atol 1e-5 of the one-process step's (tests/test_parallel.py:73-83's
tolerances); the two ranks' states equal to the bit, and the drop masks
of the step (``drop_path_generator``: seeded by the step, drawn for the
local batch) equal on the two ranks that hold rows of the same images.
The (2, 2) D0 against JAX is tests/test_torch_parallel_spatial.py.
"""
import numpy as np
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
import pytest
from test_torch_parallel_step import _assert_state, _assert_step, _batch
from test_torch_train_step import TINY
from torch_dist_helpers import Ranks

from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.factory import create_model_from_config
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)

# TF SAME pads, stochastic depth and every remat scope
OVERRIDES = dict(TINY, backbone_args={"drop_path_rate": 0.2,
                                      "remat_stages": 2},
                 remat_fpn=True, remat_heads=True)

_RANK = r"""
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.factory import create_model_from_config
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.parallel import create_mesh, shard_batch
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)
from ood_object_detection_tpu_torch.train.train_state import (
    drop_path_generator)

start = torch.load("start.pt")
mesh = create_mesh((1, 2), ("data", "spatial"), device="cpu")
model = create_model_from_config(get_efficientdet_config(
    "tf_efficientdet_d0").replace(**start["overrides"]), seed=0, device="cpu")
masks = model.backbone.drop_masks(2, drop_path_generator(
    model, 0, torch.device("cpu")))
tcfg = default_detection_train_config()
state, tx = create_train_state(model, tcfg)
step = make_train_step(model, tx, Anchors.from_config(model.config), tcfg,
                       mesh=mesh, freeze_bn="none", spatial_axis="spatial")
state, metrics = step(state, shard_batch(mesh, start["batch"]))
torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
            "model": model.state_dict(), "ema": state.ema_params,
            "masks": [m for stage in masks for m in stage if m is not None],
            "shape": mesh.shape}, f"rank{mesh.rank}.pt")
mesh.close()
"""


def _tf_batch():
    rng = np.random.default_rng(12)
    b = _batch()
    return {"image": rng.normal(0, 1, (2, 128, 128, 3)).astype(np.float32),
            "bbox": b["bbox"][:2], "cls": b["cls"][:2]}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the one-process step's metrics, state_dict and EMA; the two ranks'
    saved steps)."""
    batch = _tf_batch()
    tmp = tmp_path_factory.mktemp("spatial_tf")
    torch.save({"overrides": OVERRIDES,
                "batch": {k: torch.from_numpy(v) for k, v in batch.items()}},
               tmp / "start.pt")
    launch = Ranks(_RANK, 2, tmp)
    model = create_model_from_config(get_efficientdet_config(
        "tf_efficientdet_d0").replace(**OVERRIDES), seed=0, device="cpu")
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    step = make_train_step(model, tx, Anchors.from_config(model.config),
                           tcfg, freeze_bn="none")
    state, metrics = step(state, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    one = ({k: float(v) for k, v in metrics.items()}, model.state_dict(),
           state.ema_params)
    launch.join()
    return one, [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


def test_ranks_end_in_the_same_state(runs):
    _, (a, b) = runs
    assert a["metrics"] == b["metrics"]
    for key in ("model", "ema"):
        for name, value in a[key].items():
            assert torch.equal(value, b[key][name]), (key, name)


def test_drop_masks_are_equal_on_the_ranks_of_a_block(runs):
    _, (a, b) = runs
    assert len(a["masks"]) > 0
    assert all(torch.equal(x, y) for x, y in zip(a["masks"], b["masks"]))


def test_same_pads_remat_drop_path_equal_one_process(runs):
    (metrics, state_dict, ema), ranks = runs
    for r in ranks:
        assert r["shape"] == {"data": 1, "spatial": 2}
        _assert_step(r["metrics"], metrics)
        _assert_state(r["model"], state_dict, "state")
        _assert_state(r["ema"], ema, "EMA")
