"""The H-sharded primitives of the port's image-H leg
(``parallel/spatial.py`` and the ``spatial`` paths of ``models/layers.py``)
on 2 and 4 ``gloo`` ranks of one data block, and the norms on a (2, 2)
mesh, against the unsharded op on the whole tensor in this process.

Each case runs its op on every rank's block of rows of a seeded input
(under the rank's ``Shards``) and backpropagates a seeded output gradient:
the rank's block of it where the output stays split; where the output
comes out whole (a map too short to split), the whole gradient on spatial
index 0 and zeros on the others, the rule by which the train step counts
a whole map's loss once. Compared: the output (the ranks' blocks in rank
order, or each rank's whole map), the input's gradient (the ranks' blocks
in order) and each weight's gradient (summed over the ranks, as the train
step sums gradients).

Cases: ``Conv2d`` at kernel 1, 3, 5, stride 1, 2, dense and depthwise,
'' and 'same' pads, and depthwise at kernel 9 and 11 (at S = 4 the
halo of 11 reaches past a neighbour's rows: the map is gathered and the
rank keeps its output rows); max / avg pooling at kernel 3 stride 2 under both
pads; nearest upsampling by a repeat and a bilinear resize (gathered);
``SqueezeExcite``; a conv and both pools on a map of one row a rank
(its output too short to split); and on a (2, 2) mesh ``BatchNorm2d`` and
``HeadBatchNorm`` in train mode on blocks of rows and on a whole map,
their moments summed over the mesh (output, input gradient, running
statistics, affine gradients).

Tolerance: rtol 1e-5 / atol 1e-6. The ops cases run in f64, so that
the comparison sees the rows each rank reads and not the CPU conv's
summation order, which differs between a block and the whole map (in f32
the same sums in another order differ by up to 1.4e-6 here); the norms
compute their moments in f32 whatever their input, and run in f32.
"""
import pathlib

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_dist_helpers import Ranks

from ood_object_detection_tpu_torch.models.heads import HeadBatchNorm
from ood_object_detection_tpu_torch.models.layers import (
    BatchNorm2d, Conv2d, SqueezeExcite, avg_pool2d, interpolate, max_pool2d)

RTOL, ATOL = 1e-5, 1e-6
HW = (16, 12)          # the input map (rows, columns); the "image" size
CHANNELS = 4
TESTS = pathlib.Path(__file__).resolve().parent

CONV_CASES = [f"conv_k{k}_s{s}_{kind}_{pad or 'sym'}"
              for k in (1, 3, 5) for s in (1, 2)
              for kind in ("dense", "dw") for pad in ("", "same")] + [
    # MixNet's widest depthwise kernels: at S = 4 (4 rows a rank) k11's
    # halo of 5 rows reaches past a neighbour and the map is gathered
    "conv_k9_s1_dw_sym", "conv_k11_s1_dw_same"]
OTHER_CASES = [f"{p}pool_{pad or 'sym'}" for p in ("max", "avg")
               for pad in ("", "same")] + [
    "upsample_nearest", "resize_bilinear", "squeeze_excite",
    "short_conv", "short_maxpool", "short_avgpool"]
# a short case's map: one row a rank, twice as wide
CASES = CONV_CASES + OTHER_CASES
NORM_CASES = ["bn", "head_bn", "bn_whole", "head_bn_whole"]
NORM_SHAPE = (4, CHANNELS, 8, 6)     # the (2, 2) mesh's global batch


def make_case(name, spatial_count):
    """(op(x, shards) -> y, its f64 parameters, the f64 input as numpy)
    for case ``name``, the same in every process (seeded). A short case's
    input has one row a rank of ``spatial_count``."""
    torch.manual_seed(sum(map(ord, name)))
    rng = np.random.default_rng(sum(map(ord, name)))
    shape = (2, CHANNELS) + HW
    if name.startswith("short"):
        shape = (2, CHANNELS, spatial_count, 2 * spatial_count)
    x = rng.normal(0.0, 1.0, shape)
    if name.startswith("conv") or name == "short_conv":
        if name == "short_conv":
            k, s, dw, pad = 3, 2, False, ""
        else:
            _, k, s, kind, pad = name.split("_")
            k, s, dw, pad = int(k[1:]), int(s[1:]), kind == "dw", \
                pad.replace("sym", "")
        conv = Conv2d(CHANNELS, CHANNELS, k, s, groups=CHANNELS if dw else 1,
                      bias=True, pad_type=pad).double()
        torch.nn.init.normal_(conv.bias)

        def op(t, shards):
            conv.spatial = shards
            try:
                return conv(t)
            finally:
                conv.spatial = None
        return op, list(conv.parameters()), x
    if "pool" in name:
        pool = max_pool2d if "max" in name else avg_pool2d
        pad = "same" if name.endswith("same") else ""
        return (lambda t, shards: pool(t, 3, 2, pad, shards)), [], x
    if name == "upsample_nearest":
        def op(t, shards):
            h = t.shape[2] if shards is None else shards.global_height(t)
            return interpolate(t, (2 * h, 2 * t.shape[3]), "nearest", shards)
        return op, [], x
    if name == "resize_bilinear":
        def op(t, shards):
            h = t.shape[2] if shards is None else shards.global_height(t)
            return interpolate(t, (h // 2, t.shape[3] // 2), "bilinear",
                               shards)
        return op, [], x
    se = SqueezeExcite(CHANNELS, 2).double()

    def op(t, shards):
        se.spatial = shards
        try:
            return se(t)
        finally:
            se.spatial = None
    return op, list(se.parameters()), x


def output_grad(name, shape):
    rng = np.random.default_rng(1000 + sum(map(ord, name)))
    return rng.normal(0.0, 1.0, shape)


_RANK = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, __TESTS__)
from test_torch_spatial import (CASES, NORM_CASES, NORM_SHAPE, make_case,
                                output_grad)
from ood_object_detection_tpu_torch import parallel as par
from ood_object_detection_tpu_torch.parallel.spatial import mesh_shards

kind = sys.argv[1]
if kind == "ops":
    mesh = par.create_mesh((1, -1), ("data", "spatial"), device="cpu")
    saved = {}
    for name in CASES:
        op, params, x = make_case(name, mesh.spatial_size)
        shards = mesh_shards(mesh, x.shape[2:])
        xw = torch.from_numpy(x)
        xl = shards.own_rows(xw).clone().requires_grad_()
        y = op(xl, shards)
        full = op(xw, None)
        g = torch.from_numpy(output_grad(name, tuple(full.shape)))
        split = y.shape[2] < full.shape[2]
        if split:
            g = shards.own_rows(g)
        elif mesh.spatial_index:
            g = torch.zeros_like(g)
        (y * g).sum().backward()
        saved[name] = {"y": y.detach(), "split": split, "x_grad": xl.grad,
                       "params": [p.grad for p in params]}
else:
    from ood_object_detection_tpu_torch.models.heads import HeadBatchNorm
    from ood_object_detection_tpu_torch.models.layers import BatchNorm2d
    mesh = par.create_mesh((2, 2), ("data", "spatial"), device="cpu")
    rng = np.random.default_rng(3)
    xg = torch.from_numpy(rng.normal(0.5, 2.0, NORM_SHAPE).astype(np.float32))
    gg = torch.from_numpy(rng.normal(0.0, 0.1, NORM_SHAPE).astype(np.float32))
    shards = mesh_shards(mesh, NORM_SHAPE[2:])
    saved = {}
    for name in NORM_CASES:
        norm = (HeadBatchNorm if name.startswith("head") else BatchNorm2d)(
            NORM_SHAPE[1]).train()
        xb, gb = (par.shard_batch(mesh, t) for t in (xg, gg))
        whole = name.endswith("whole")
        if whole:
            gb = gb if mesh.spatial_index == 0 else torch.zeros_like(gb)
        else:
            xb, gb = shards.own_rows(xb), shards.own_rows(gb)
        xl = xb.clone().requires_grad_()
        with par.synced_batch_norms(norm, mesh):
            y = norm(xl)
        (y * gb).sum().backward()
        saved[name] = {"y": y.detach(), "x_grad": xl.grad,
                       "w_grad": norm.weight.grad, "b_grad": norm.bias.grad,
                       "running_mean": norm.running_mean,
                       "running_var": norm.running_var}
torch.save(saved, f"{kind}{mesh.rank}.pt")
mesh.close()
""".replace("__TESTS__", repr(str(TESTS)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{S: each rank's saved cases} for S = 2, 4 (one data block), and
    'norms': the (2, 2) mesh's; the three launches run at once."""
    launches = {}
    for key, world, kind in ((2, 2, "ops"), (4, 4, "ops"),
                             ("norms", 4, "norms")):
        tmp = tmp_path_factory.mktemp(f"spatial_{key}")
        launches[key] = (tmp, world, kind, Ranks(_RANK, world, tmp, (kind,)))
    out = {}
    for key, (tmp, world, kind, launch) in launches.items():
        launch.join()
        out[key] = [torch.load(tmp / f"{kind}{r}.pt") for r in range(world)]
    return out


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=RTOL, atol=ATOL, err_msg=what)


def _whole(name, count):
    op, params, x = make_case(name, count)
    xw = torch.from_numpy(x).requires_grad_()
    y = op(xw, None)
    (y * torch.from_numpy(output_grad(name, tuple(y.shape)))).sum().backward()
    return y, xw.grad, [p.grad for p in params]


@pytest.mark.parametrize("count", [2, 4])
@pytest.mark.parametrize("name", CASES)
def test_sharded_op_equals_the_whole_op(ranks, name, count):
    saved = [r[name] for r in ranks[count]]
    y, x_grad, param_grads = _whole(name, count)
    if name.startswith("short"):
        assert not saved[0]["split"]      # one row a rank: gathered whole
    if saved[0]["split"]:
        _close(torch.cat([s["y"] for s in saved], dim=2), y, "output")
    else:
        for s in saved:
            _close(s["y"], y, "whole output")
    _close(torch.cat([s["x_grad"] for s in saved], dim=2), x_grad,
           "input gradient")
    for i, want in enumerate(param_grads):
        _close(sum(s["params"][i] for s in saved), want,
               f"parameter {i} gradient")


def test_primitives_split_where_they_can(ranks):
    """The ops whose outputs divide over the ranks keep them split."""
    for count in (2, 4):
        for name in CONV_CASES + ["maxpool_sym", "avgpool_same",
                                  "upsample_nearest", "resize_bilinear",
                                  "squeeze_excite"]:
            assert ranks[count][0][name]["split"], (count, name)


@pytest.mark.parametrize("name", NORM_CASES)
def test_norm_moments_over_the_2x2_mesh(ranks, name):
    saved = ranks["norms"]            # rank r: data block r // 2, rows r % 2
    rng = np.random.default_rng(3)
    xg = torch.from_numpy(rng.normal(0.5, 2.0, NORM_SHAPE)
                          .astype(np.float32)).requires_grad_()
    gg = torch.from_numpy(rng.normal(0.0, 0.1, NORM_SHAPE).astype(np.float32))
    norm = (HeadBatchNorm if name.startswith("head") else BatchNorm2d)(
        NORM_SHAPE[1]).train()
    y = norm(xg)
    (y * gg).sum().backward()
    s = [r[name] for r in saved]
    if name.endswith("whole"):
        # each spatial rank holds the whole map; its gradients are partial
        # sums, whose sum over the spatial group is the gradient
        _close(torch.cat([s[0]["y"], s[2]["y"]]), y, "output")
        _close(torch.cat([s[1]["y"], s[3]["y"]]), y, "output (index 1)")
        _close(torch.cat([s[0]["x_grad"] + s[1]["x_grad"],
                          s[2]["x_grad"] + s[3]["x_grad"]]), xg.grad,
               "input gradient")
    else:
        def blocks(key):
            return torch.cat([torch.cat([s[b * 2][key], s[b * 2 + 1][key]],
                                        dim=2) for b in range(2)])
        _close(blocks("y"), y, "output")
        _close(blocks("x_grad"), xg.grad, "input gradient")
    for r in s:
        _close(r["running_mean"], norm.running_mean, "running mean")
        _close(r["running_var"], norm.running_var, "running var")
    _close(sum(r["w_grad"] for r in s), norm.weight.grad, "scale gradient")
    _close(sum(r["b_grad"] for r in s), norm.bias.grad, "bias gradient")
    assert all(torch.equal(r["running_var"], s[0]["running_var"]) for r in s)


def test_window_halo_rows():
    """The halo rule's arithmetic: symmetric k3 s2 reads one row above and
    none below, k5 s2 two above and one below; TF SAME k3 s2 on an even
    map none above and one below; a 1x1 stride-2 conv leaves its last row
    unread; an output that does not divide, or a misaligned share, is
    gathered (None)."""
    from ood_object_detection_tpu_torch.parallel.spatial import window_halo
    assert window_halo(16, 2, 3, 2, 1, (1, 1)) == (1, 0)
    assert window_halo(16, 2, 5, 2, 1, (2, 2)) == (2, 1)
    assert window_halo(16, 2, 3, 2, 1, (0, 1)) == (0, 1)
    assert window_halo(16, 2, 3, 1, 1, (1, 1)) == (1, 1)
    assert window_halo(16, 4, 1, 2, 1, (0, 0)) == (0, -1)
    assert window_halo(2, 2, 3, 2, 1, (1, 1)) is None     # 1 output row
    assert window_halo(12, 4, 3, 2, 1, (1, 1)) is None    # 3 rows a rank
    # past a neighbour's block: the caller gathers and keeps its rows
    assert window_halo(16, 4, 11, 1, 1, (5, 5)) == (5, 5)
