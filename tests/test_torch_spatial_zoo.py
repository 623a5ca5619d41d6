"""The image-H split across the model zoo's other structures: each entry
below runs a forward and backward on two ``gloo`` ranks of a (1, 2) mesh
(``parallel.spatially_sharded``, each rank its half of the image's rows)
and in one process on the whole image, from the same seeded weights
(``create_model_from_config``, seed 0), at full width, 128 px, 3 classes,
one BiFPN cell and one head repeat, one image.

The entries cover what D0 (tests/test_torch_parallel_spatial.py) and
tf_efficientdet_d0 (``..._tf.py``) do not: CSP's and ResNet's stem pools
and 7 x 7 / strided 1 x 1 convs, grouped ResNeXt convs, a bilinear
upsampling FPN (cspresdet50, gathered and split again), the PAN and
quad FPN graphs, MixNet's mixed depthwise kernels up to 9 (their halo
past a neighbour's two rows: gathered, rows kept), edge blocks,
MobileNetV3's hard-swish squeeze-excite, and the lite models' TF SAME
pads without squeeze-excite. At 128 px P7 has one row and is computed
whole.

The models run in eval mode: BatchNorm with running statistics, so the
comparison sees the rows each op reads. (Train-mode moments of 4 x 4
maps of one image turn the f32 rounding of the split's sums into
differences of 1e-2 here; the train-mode norms' sync is held in
tests/test_torch_spatial.py and the step tests.) The loss is the sum of
the head outputs times seeded weights, counted once for the whole P7.

Compared: the head outputs (the ranks' halves in rank order, or P7 whole
on each rank) to rtol 1e-4 / atol 1e-5 (measured at most 2.4e-6 apart),
and each parameter's gradient summed over the ranks through a seeded
projection ``sum(g * r)``: within ``1e-5 |r| (|g| + 1e-3 max |g|)``, the
largest gradient's norm over all parameters setting a floor for the
scalar BiFPN edge weights, whose gradients (a whole map's sum, down to
2.5e-7) cancel to a relative rounding of 7e-4 (measured at most 0.15 of
the bound; ``-s`` prints each entry's largest difference as a share of
it).
"""
import pathlib

import numpy as np
import pytest
import torch
from torch_dist_helpers import Ranks
from torch_parity_helpers import zoo_size

from ood_object_detection_tpu_torch import parallel as par
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.factory import create_model_from_config

ENTRIES = ("cspresdet50", "resdet50", "cspresdext50pan", "mixdet_m",
           "efficientdet_q0", "efficientdet_es", "mobiledetv3_large",
           "tf_efficientdet_lite0")
TESTS = pathlib.Path(__file__).resolve().parent


def run(name, mesh):
    """Entry ``name``'s head outputs and, per parameter, [sum(g * r),
    sum(g * g), r's element count] of its gradient (on ``mesh``: this
    rank's outputs and gradients)."""
    size = zoo_size(name)
    cfg = get_efficientdet_config(name, num_classes=3).replace(
        image_size=(size, size), fpn_cell_repeats=1, box_class_repeats=1)
    model = create_model_from_config(cfg, seed=0, device="cpu").eval()
    x = torch.from_numpy(np.random.default_rng(5).normal(
        0, 1, (1, size, size, 3)).astype(np.float32))
    shards = None
    if mesh is not None:
        shards = par.spatial.mesh_shards(mesh, (size, size))
        x = shards.own_rows(x, dim=1)
    with par.spatially_sharded(model, mesh, (size, size)):
        cls, box = model(x)
        loss, outs = 0.0, []
        for lvl, o in enumerate(list(cls) + list(box)):
            rows = size >> (cfg.min_level + lvl % cfg.num_levels)
            w = torch.from_numpy(np.random.default_rng(lvl).normal(
                0, 1, (1, rows) + tuple(o.shape[2:])).astype(np.float32))
            if shards is not None and o.shape[1] < rows:
                w = shards.own_rows(w, dim=1)
            elif shards is not None and shards.index:
                w = w * 0       # a whole level counts on index 0 alone
            loss = loss + (o * w).sum()
            outs.append(o.detach())
        loss.backward()
    proj = []
    for i, p in enumerate(model.parameters()):
        r = torch.from_numpy(np.random.default_rng(100 + i).normal(
            0, 1, tuple(p.shape)).astype(np.float32))
        g = p.grad if p.grad is not None else torch.zeros_like(p)
        proj.append([float((g * r).sum()), float((g * g).sum()),
                     float(r.numel())])
    return outs, torch.tensor(proj, dtype=torch.float64)


_RANK = r"""
import sys
import torch
torch.set_num_threads(1)
sys.path.insert(0, __TESTS__)
from test_torch_spatial_zoo import ENTRIES, run
from ood_object_detection_tpu_torch import parallel as par

mesh = par.create_mesh((1, 2), ("data", "spatial"), device="cpu")
torch.save({name: run(name, mesh) for name in ENTRIES},
           f"rank{mesh.rank}.pt")
mesh.close()
""".replace("__TESTS__", repr(str(TESTS)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spatial_zoo")
    launch = Ranks(_RANK, 2, tmp)
    torch.set_num_threads(2)
    one = {name: run(name, None) for name in ENTRIES}
    launch.join()
    return one, [torch.load(tmp / f"rank{r}.pt") for r in range(2)]


@pytest.mark.parametrize("name", ENTRIES)
def test_split_outputs_equal_one_process(ranks, name):
    one, (r0, r1) = ranks
    for lvl, (want, a, b) in enumerate(zip(one[name][0], r0[name][0],
                                           r1[name][0])):
        got = torch.cat([a, b], dim=1) if a.shape[1] < want.shape[1] else a
        if a.shape[1] == want.shape[1]:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=f"{name} output {lvl}")


@pytest.mark.parametrize("name", ENTRIES)
def test_split_gradients_equal_one_process(ranks, name):
    one, (r0, r1) = ranks
    want = one[name][1]
    got = r0[name][1][:, 0] + r1[name][1][:, 0]
    norms = torch.sqrt(want[:, 1])
    bound = 1e-5 * torch.sqrt(want[:, 2]) * (norms + 1e-3 * norms.max())
    ratio = (got - want[:, 0]).abs() / bound
    print(f"{name}: the largest difference {float(ratio.max()):.3g} of "
          "its bound")
    assert bool((ratio <= 1).all()), (name, float(ratio.max()))
