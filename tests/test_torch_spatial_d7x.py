"""The port's image-H train step on a (1, 4) mesh of four ``gloo`` ranks
against one process, on the structure of ``tf_efficientdet_d7x``, the
configuration the leg exists for: its max_level 8 (six levels, P8 made by
two strided pools past the backbone), TF SAME pads, the ``bifpn_sum``
FPN and its anchor scale, narrowed to run on the CPU (a
``tf_efficientnet_b0`` backbone for its b7, which has the same kinds of
block, 64 FPN channels for 384, one FPN cell and one head repeat, 8
classes, seeded weights, a batch of 2, ``freeze_bn='none'``).

At 1536 px on four ranks D7x's P7 has 12 rows, 3 a rank, and its P8 6
rows, which do not divide over 4: P8 is made from the gathered P7 and
computed whole. Two image sizes take the two short-map cases here:
256 x 256 (P6 one row a rank; P7 of 2 rows and P8 of 1 both whole, the
pool from P6 gathered) and 512 x 256 (P7 one row a rank, as at 1536;
P8 of 2 rows whole).

After one step of ``make_train_step(..., spatial_axis="spatial")``: loss,
class_loss, box_loss and grad_norm to rtol 2e-4, num_positives exactly,
every parameter and BatchNorm statistic to rtol 5e-4 / atol 1e-5 of the
one-process step's (tests/test_parallel.py:73-83's tolerances); the four
ranks' states equal to the bit; each whole level's gathers counted.
"""
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from test_torch_parallel_step import _assert_state, _assert_step
from torch_dist_helpers import Ranks

from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.factory import create_model_from_config
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)

SIZES = ((256, 256), (512, 256))
NARROW = dict(backbone_name="tf_efficientnet_b0", fpn_channels=64,
              fpn_cell_repeats=1, box_class_repeats=1, num_classes=8)

_RANK = r"""
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.config import (
    default_detection_train_config, get_efficientdet_config)
from ood_object_detection_tpu_torch.factory import create_model_from_config
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.parallel import (create_mesh,
                                                     shard_batch, spatial)
from ood_object_detection_tpu_torch.train import (create_train_state,
                                                  make_train_step)

start = torch.load("start.pt")
mesh = create_mesh((1, 4), ("data", "spatial"), device="cpu")
out = {"shape": mesh.shape}
for size, batch in start["batches"].items():
    model = create_model_from_config(get_efficientdet_config(
        "tf_efficientdet_d7x").replace(image_size=size, **start["narrow"]),
        seed=0, device="cpu")
    tcfg = default_detection_train_config()
    state, tx = create_train_state(model, tcfg)
    step = make_train_step(model, tx, Anchors.from_config(model.config),
                           tcfg, mesh=mesh, freeze_bn="none",
                           spatial_axis="spatial")
    spatial.reset_exchanges()
    state, metrics = step(state, shard_batch(mesh, batch))
    out[size] = {"metrics": {k: float(v) for k, v in metrics.items()},
                 "model": model.state_dict(),
                 "exchanges": dict(spatial.EXCHANGES)}
torch.save(out, f"rank{mesh.rank}.pt")
mesh.close()
"""


def _batch(size):
    h, w = size
    rng = np.random.default_rng(h + w)
    boxes = np.zeros((2, 4, 4), np.float32)
    cls = np.full((2, 4), -1, np.int32)
    for i, n in enumerate((3, 2)):
        yx = rng.uniform(0, 1, (n, 2)) * (h - 96, w - 96)
        hw = rng.uniform(16, 96, (n, 2))
        boxes[i, :n] = np.concatenate([yx, yx + hw], -1)
        cls[i, :n] = rng.integers(1, 8, n)
    return {"image": torch.from_numpy(rng.normal(0, 1, (2, h, w, 3))
                                      .astype(np.float32)),
            "bbox": torch.from_numpy(boxes), "cls": torch.from_numpy(cls)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """({size: the one-process step's metrics and state_dict}, the four
    ranks' saved steps)."""
    batches = {size: _batch(size) for size in SIZES}
    tmp = tmp_path_factory.mktemp("spatial_d7x")
    torch.save({"narrow": NARROW, "batches": batches}, tmp / "start.pt")
    launch = Ranks(_RANK, 4, tmp)
    one = {}
    for size, batch in batches.items():
        model = create_model_from_config(get_efficientdet_config(
            "tf_efficientdet_d7x").replace(image_size=size, **NARROW),
            seed=0, device="cpu")
        assert model.config.max_level == 8
        tcfg = default_detection_train_config()
        state, tx = create_train_state(model, tcfg)
        step = make_train_step(model, tx, Anchors.from_config(model.config),
                               tcfg, freeze_bn="none")
        state, metrics = step(state, batch)
        one[size] = ({k: float(v) for k, v in metrics.items()},
                     model.state_dict())
    launch.join()
    return one, [torch.load(tmp / f"rank{r}.pt") for r in range(4)]


@pytest.mark.parametrize("size", SIZES)
def test_d7x_ranks_end_in_the_same_state(runs, size):
    _, ranks = runs
    a = ranks[0][size]
    for r in ranks[1:]:
        b = r[size]
        assert a["metrics"] == b["metrics"]
        assert a["exchanges"] == b["exchanges"]
        for name, value in a["model"].items():
            assert torch.equal(value, b["model"][name]), name


@pytest.mark.parametrize("size", SIZES)
def test_d7x_split_over_four_equals_one_process(runs, size):
    one, ranks = runs
    metrics, state_dict = one[size]
    for r in ranks:
        assert r["shape"] == {"data": 1, "spatial": 4}
        # the whole levels' maps are gathered, forward and backward
        assert r[size]["exchanges"]["gather"] > 0, r[size]["exchanges"]
        _assert_step(r[size]["metrics"], metrics)
        _assert_state(r[size]["model"], state_dict, "state")
