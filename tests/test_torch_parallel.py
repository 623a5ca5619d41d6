"""The port's process-group helpers (``parallel/mesh.py``) and the synced
BatchNorm, on two ``gloo`` ranks started from the test.

The helpers mirror the JAX package's tests/test_parallel.py:91-156 and
tests/test_multiprocess.py cases; each result is also held against the
JAX helper on the 2-device slice of the 8-device virtual mesh that
tests/conftest.py forces (JAX in this process, the port in the ranks).

The synced norms: every rank normalises its half of a global batch with
the global moments. Its outputs, input gradient and running statistics
must equal one process's on the whole batch, and the sum of the ranks'
affine gradients that process's affine gradient, to 1e-6 of each
tensor's largest magnitude. The same halves without the sync do not,
which shows that the check can fail. ``all_reduce_sum``'s own gradient
(the sum of the ranks' gradients) is held on its own.
"""
import json

import jax
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from jax.sharding import PartitionSpec as P
from torch_dist_helpers import run_ranks

from ood_object_detection_tpu.parallel import (
    all_gather_detections as jax_all_gather,
    create_mesh as jax_create_mesh,
    data_sharding as jax_data_sharding,
    reduce_dict as jax_reduce_dict,
    shard_batch as jax_shard_batch,
)
from ood_object_detection_tpu_torch.models.heads import HeadBatchNorm
from ood_object_detection_tpu_torch.models.layers import BatchNorm2d

NORM_SHAPE = (4, 8, 5, 5)       # the global batch of the norm checks

_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch import parallel as par
from ood_object_detection_tpu_torch.data.dataset import (
    PrefetchLoader, SyntheticDetectionDataset, create_loader)
from ood_object_detection_tpu_torch.evaluation import PascalEvaluator
from ood_object_detection_tpu_torch.models.heads import HeadBatchNorm
from ood_object_detection_tpu_torch.models.layers import BatchNorm2d

mesh = par.create_mesh((-1,), ("data",), device="cpu")
r = mesh.rank
out = {"rank": r, "size": mesh.size, "shape": mesh.shape,
       "main": par.is_main_process(), "distributed": mesh.distributed}
for bad in ((3,), (2, 2)):
    try:
        par.create_mesh(bad, ("data", "spatial")[:len(bad)], device="cpu")
    except ValueError as e:
        out[f"refused_{len(bad)}d"] = f"{type(e).__name__}: {e}"
out["shape_2x1"] = par.create_mesh((2, 1), ("data", "spatial"),
                                   device="cpu").shape

g = np.arange(16 * 4 * 4 * 3, dtype=np.float32).reshape(16, 4, 4, 3)
placed = par.shard_batch(mesh, {"image": torch.from_numpy(g),
                                "cls": torch.zeros(16, 5, dtype=torch.int32)})
out["shard"] = placed["image"].numpy().tolist()
out["local_shard_equal"] = bool(torch.equal(
    par.local_shard(torch.from_numpy(g), mesh), placed["image"]))
out["shard_cls_rows"] = int(placed["cls"].shape[0])
dets = np.arange(2 * 2 * 3 * 6, dtype=np.float32).reshape(4, 3, 6)
local = par.shard_batch(mesh, torch.from_numpy(dets))
out["gathered"] = par.all_gather_detections(local, mesh).numpy().tolist()
v = torch.tensor(float(r))
out["mean"] = float(par.reduce_dict({"m": v}, mesh)["m"])
out["sum"] = float(par.reduce_dict({"m": v}, mesh, average=False)["m"])
out["seed"] = par.shared_random_seed(1234 + r)
out["fresh_seed"] = par.shared_random_seed()
merged = par.process_merge({"x": np.full((1, 3), r, np.float32)})
out["merged"] = merged["x"].tolist()

# all_reduce_sum's gradient: the sum of the ranks' gradients
x = torch.full((3,), 1.0, requires_grad=True)
y = par.all_reduce_sum(x * (r + 1), mesh.group)
(y * torch.tensor([1.0, 2.0, 3.0]) * (r + 1)).sum().backward()
out["reduced"] = y.tolist()
out["reduced_grad"] = x.grad.tolist()

# the distributed evaluator: each rank adds another image, every rank
# evaluates both; a rank with nothing takes part with None
ev = PascalEvaluator(num_classes=2, distributed=True)
det = np.zeros((1, 5, 6), np.float32)
det[0, 0] = [10, 10, 30, 30, 0.9, 1]
bbox = np.zeros((1, 4, 4), np.float32)
bbox[0, 0] = [10, 10, 30, 30]
cls = np.zeros((1, 4), np.int32)
cls[0, 0] = 1
ev.add_predictions(det, {"bbox": bbox, "cls": cls,
                         "img_id": np.asarray([100 + r])})
ev.add_predictions_async(None if r else det,
                         None if r else {"bbox": bbox, "cls": cls,
                                         "img_id": np.asarray([200])})
ev.drain()
out["eval_images"] = sorted(int(k) for k in ev._eval._gt)
out["map"] = float(ev.evaluate()["mAP@0.5IOU"])

# the per-process loader split: disjoint halves covering the split
ds = SyntheticDetectionDataset(num_images=10, image_size=(32, 32),
                               num_classes=2, max_boxes=2)
for shuffle in (False, True):
    loader = PrefetchLoader(ds, batch_size=2, shuffle=shuffle, workers=1,
                            drop_last=False, device="cpu",
                            process_index=r, process_count=mesh.size)
    out[f"ids_{shuffle}"] = [int(i) for b in loader for i in b["img_id"]]
    out[f"len_{shuffle}"] = len(loader)
out["create_loader_ids"] = [int(i) for b in create_loader(
    ds, (32, 32), 2, workers=1, distributed=True, device="cpu")
    for i in b["img_id"]]

# the synced norms on this rank's half of the global batch
rng = np.random.default_rng(3)
xg = rng.normal(0.5, 2.0, __SHAPE__).astype(np.float32)
wg = rng.normal(0.0, 1.0, __SHAPE__).astype(np.float32)
half = slice(r * 2, r * 2 + 2)
saved = {}
for name, norm in (("bn", BatchNorm2d(8)), ("head", HeadBatchNorm(8))):
    norm.train()
    xl = torch.from_numpy(xg[half]).requires_grad_()
    with par.synced_batch_norms(norm, mesh):
        yl = norm(xl)
    (yl * torch.from_numpy(wg[half])).sum().backward()
    saved[name] = {"y": yl.detach(), "x_grad": xl.grad,
                   "w_grad": norm.weight.grad, "b_grad": norm.bias.grad,
                   "running_mean": norm.running_mean,
                   "running_var": norm.running_var}
torch.save(saved, f"norm{r}.pt")
out["collectives"] = par.all_reduce_sum.calls
json.dump(out, open(f"rank{r}.json", "w"))
mesh.close()
""".replace("__SHAPE__", repr(NORM_SHAPE))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh")
    run_ranks(_RANK, 2, tmp)
    return ([json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(2)],
            [torch.load(tmp / f"norm{r}.pt") for r in range(2)])


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_create_mesh((2,), ("data",), devices=jax.devices()[:2])


def test_create_mesh(ranks):
    out, _ = ranks
    assert [o["rank"] for o in out] == [0, 1]
    assert all(o["size"] == 2 and o["shape"] == {"data": 2}
               and o["distributed"] for o in out)
    assert [o["main"] for o in out] == [True, False]
    for o in out:
        assert o["refused_1d"].startswith("ValueError") \
            and "torchrun" in o["refused_1d"]
        # a 2-D (data, spatial) mesh is made when its shape fits the launch
        assert o["shape_2x1"] == {"data": 2, "spatial": 1}
        assert o["refused_2d"].startswith("ValueError") \
            and "torchrun" in o["refused_2d"]


def test_create_mesh_outside_a_launch():
    from ood_object_detection_tpu_torch.parallel import create_mesh
    mesh = create_mesh((-1,), ("data",), device="cpu")
    assert (mesh.size, mesh.rank, mesh.distributed) == (1, 0, False)
    with pytest.raises(ValueError, match="torchrun"):
        create_mesh((2,), ("data",), device="cpu")
    mesh.close()


def test_shard_batch_places_rank_rows_as_jax(ranks, jax_mesh):
    out, _ = ranks
    g = np.arange(16 * 4 * 4 * 3, dtype=np.float32).reshape(16, 4, 4, 3)
    placed = jax_shard_batch(jax_mesh, {"image": g})["image"]
    assert placed.sharding == jax_data_sharding(jax_mesh)
    shards = sorted(placed.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    for o, shard in zip(out, shards):
        np.testing.assert_array_equal(np.asarray(o["shard"]),
                                      np.asarray(shard.data))
        assert o["shard_cls_rows"] == 8
        assert o["local_shard_equal"]


def test_all_gather_detections_merges_shards(ranks, jax_mesh):
    out, _ = ranks
    dets = np.arange(2 * 2 * 3 * 6, dtype=np.float32).reshape(4, 3, 6)

    @jax.jit
    def gather(d):
        return jax.shard_map(
            lambda x: jax_all_gather(x, "data"), mesh=jax_mesh,
            in_specs=P("data"), out_specs=P(), check_vma=False)(d)
    want = np.asarray(gather(jax.device_put(
        dets, jax_data_sharding(jax_mesh))))
    np.testing.assert_array_equal(want, dets)
    for o in out:
        np.testing.assert_array_equal(np.asarray(o["gathered"]), want)


def test_reduce_dict_averages_and_sums_across_ranks(ranks, jax_mesh):
    out, _ = ranks
    per_shard = np.arange(2, dtype=np.float32)     # shard i holds value i

    def reduce(average):
        return jax.jit(lambda x: jax.shard_map(
            lambda v: jax_reduce_dict({"m": v[0]}, "data", average=average),
            mesh=jax_mesh, in_specs=P("data"), out_specs=P())(x))(
            jax.device_put(per_shard, jax_data_sharding(jax_mesh)))["m"]
    for o in out:
        assert o["mean"] == pytest.approx(float(reduce(True)), rel=1e-6)
        assert o["sum"] == pytest.approx(float(reduce(False)), rel=1e-6)


def test_shared_random_seed_is_rank_zeros(ranks):
    out, _ = ranks
    assert [o["seed"] for o in out] == [1234, 1234]
    assert out[0]["fresh_seed"] == out[1]["fresh_seed"]


def test_process_merge_stacks_every_rank(ranks):
    out, _ = ranks
    for o in out:
        assert np.asarray(o["merged"]).shape == (2, 1, 3)
        assert np.asarray(o["merged"])[:, 0, 0].tolist() == [0.0, 1.0]


def test_all_reduce_sum_gradient_is_the_ranks_sum(ranks):
    out, _ = ranks
    for r, o in enumerate(out):
        assert o["reduced"] == [3.0, 3.0, 3.0]      # 1 * 1 + 1 * 2
        # d/dx_r of sum_q c_q * (q + 1) * y, y = sum_r (r + 1) x_r
        assert o["reduced_grad"] == pytest.approx(
            [(r + 1) * 3.0 * c for c in (1.0, 2.0, 3.0)])


def test_distributed_evaluator_merges_every_rank(ranks):
    out, _ = ranks
    for o in out:
        assert o["eval_images"] == [100, 101, 200]
        assert o["map"] == pytest.approx(1.0)


def test_loader_shards_are_disjoint_and_cover_the_split(ranks):
    from ood_object_detection_tpu.data import dataset as jdata
    out, _ = ranks
    jds = jdata.SyntheticDetectionDataset(num_images=10, image_size=(32, 32),
                                          num_classes=2, max_boxes=2)
    for shuffle in (False, True):
        ids = [o[f"ids_{shuffle}"] for o in out]
        assert set(ids[0]).isdisjoint(ids[1])
        assert sorted(ids[0] + ids[1]) == list(range(10))
        for r, o in enumerate(out):
            want = [int(i) for b in jdata.PrefetchLoader(
                jds, batch_size=2, shuffle=shuffle, workers=1,
                drop_last=False, device_put=False, process_index=r,
                process_count=2) for i in b["img_id"]]
            assert o[f"ids_{shuffle}"] == want
            assert o[f"len_{shuffle}"] == 3
    # create_loader(distributed=True) takes the launched group's split
    assert [o["create_loader_ids"] for o in out] == [o["ids_False"]
                                                     for o in out]


def _whole_batch(cls):
    rng = np.random.default_rng(3)
    xg = torch.from_numpy(rng.normal(0.5, 2.0, NORM_SHAPE)
                          .astype(np.float32)).requires_grad_()
    wg = torch.from_numpy(rng.normal(0.0, 1.0, NORM_SHAPE).astype(np.float32))
    norm = cls(8).train()
    y = norm(xg)
    (y * wg).sum().backward()
    return norm, xg, wg, y


def _close(got, want, what):
    scale = float(want.detach().abs().max())
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=0,
                               atol=1e-6 * scale, err_msg=what)


@pytest.mark.parametrize("name, cls", [("bn", BatchNorm2d),
                                       ("head", HeadBatchNorm)])
def test_synced_norm_equals_the_whole_batch(ranks, name, cls):
    _, saved = ranks
    norm, xg, _, y = _whole_batch(cls)
    halves = [s[name] for s in saved]
    _close(torch.cat([h["y"] for h in halves]), y, "output")
    _close(torch.cat([h["x_grad"] for h in halves]), xg.grad, "input grad")
    for h in halves:
        _close(h["running_mean"], norm.running_mean, "running mean")
        _close(h["running_var"], norm.running_var, "running var")
    _close(halves[0]["w_grad"] + halves[1]["w_grad"], norm.weight.grad,
           "scale grad")
    _close(halves[0]["b_grad"] + halves[1]["b_grad"], norm.bias.grad,
           "bias grad")
    assert torch.equal(halves[0]["running_var"], halves[1]["running_var"])


@pytest.mark.parametrize("cls", [BatchNorm2d, HeadBatchNorm])
def test_unsynced_halves_differ_from_the_whole_batch(cls):
    """Without the sync each half normalises by its own moments: the
    output misses the whole batch's by far more than the tolerance."""
    norm, xg, wg, y = _whole_batch(cls)
    halves = []
    for r in range(2):
        xl = xg.detach()[2 * r:2 * r + 2]
        halves.append(cls(8).train()(xl).detach())
    with pytest.raises(AssertionError):
        _close(torch.cat(halves), y, "output")


def test_per_process_stream_seeds_match_jax():
    """PretrainEpisodeStream and EpisodicDataset seed each process's
    stream with seed * process_count + process_index, as the JAX sources
    do: the same draws on both sides, other draws on the other rank."""
    import random

    from ood_object_detection_tpu.data import pretrain_stream as jps
    from ood_object_detection_tpu_torch.data import pretrain_stream as tps
    from ood_object_detection_tpu_torch.data.episodic import SyntheticEpisodeSource
    src = SyntheticEpisodeSource(num_cats=3, img_hw=(32, 32))
    draws = []
    for rank in range(2):
        kw = dict(num_qry=2, seed=5, process_index=rank, process_count=2)
        ours = tps.PretrainEpisodeStream(src, (32, 32), [1, 2], [3], **kw)
        theirs = jps.PretrainEpisodeStream(src, (32, 32), [1, 2], [3], **kw)
        a = [ours.rng.random() for _ in range(4)]
        assert a == [theirs.rng.random() for _ in range(4)]
        ref = random.Random(5 * 2 + rank)
        assert a == [ref.random() for _ in range(4)]
        draws.append(a)
    assert draws[0] != draws[1]
    with pytest.raises(ValueError, match="process_index"):
        tps.PretrainEpisodeStream(src, (32, 32), [1], [2], process_index=2,
                                  process_count=2)


def test_episodic_dataset_process_seeds_match_jax():
    import random

    from ood_object_detection_tpu.config import (
        get_efficientdet_config as jax_cfg)
    from ood_object_detection_tpu.data.episodic import (
        EpisodicDataset as JaxEpisodic)
    from ood_object_detection_tpu.meta import MetaConfig as JaxMetaConfig
    from ood_object_detection_tpu_torch.config import get_efficientdet_config
    from ood_object_detection_tpu_torch.data.episodic import (
        EpisodicDataset, SyntheticEpisodeSource)
    from ood_object_detection_tpu_torch.meta import MetaConfig
    src = SyntheticEpisodeSource(num_cats=4, img_hw=(128, 128))
    kw = dict(num_sup=2, num_qry=2, img_size=128, qry_img_size=128)
    for rank in range(2):
        ours = EpisodicDataset(
            src.support_source([1, 2, 3, 4]), src,
            get_efficientdet_config("efficientdet_d0").replace(
                image_size=(128, 128)), MetaConfig(**kw), [1, 2, 3], [4],
            seed=7, device="cpu", process_index=rank, process_count=2)
        theirs = JaxEpisodic(
            src.support_source([1, 2, 3, 4]), src,
            jax_cfg("efficientdet_d0").replace(image_size=(128, 128)),
            JaxMetaConfig(**kw), [1, 2, 3], [4], seed=7,
            process_index=rank, process_count=2)
        seed = 7 * 2 + rank
        for rng in (ours.rng, theirs.rng):
            assert rng.random() == random.Random(seed).random()
        for rng in (ours._eval_rng, theirs._eval_rng):
            assert rng.random() == random.Random(seed + 0x5EED).random()
