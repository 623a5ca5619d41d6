"""Traffic is made from the seed alone: the same seed gives the same
inputs, another seed other inputs over the same multiset of sizes."""
import numpy as np
import torch

from port_bench.drivers import predict, train
from port_bench.tests.small import make_run

SEEDS = (2147483999, 3000000019)


def test_predict_traffic_follows_the_seed():
    run = make_run("d0_predict_b128")
    cfg, t = run.config["model"], run.traffic
    a, b = (predict.true_sizes(t, s) for s in SEEDS)
    assert (predict.true_sizes(t, SEEDS[0]) == a).all()
    assert not (a == b).all()
    assert sorted(map(tuple, a.reshape(-1, 2))) == \
        sorted(map(tuple, b.reshape(-1, 2)))
    lo, hi = t["true_side"]
    assert a.min() >= lo and a.max() <= hi
    ca, cb = (predict.canvases(t, cfg, s, "cpu") for s in SEEDS)
    assert torch.equal(ca, predict.canvases(t, cfg, SEEDS[0], "cpu"))
    assert not torch.equal(ca, cb)
    assert ca.dtype == torch.uint8 and ca.shape == (2, 4, 128, 128, 3)


def test_train_traffic_follows_the_seed():
    run = make_run("d0_train_b128")
    cfg, t = run.config["model"], run.traffic
    a, b = (train.batches(t, cfg, s, "cpu") for s in SEEDS)
    again = train.batches(t, cfg, SEEDS[0], "cpu")
    for x, y, z in zip(a, again, b):
        for k in x:
            assert torch.equal(x[k], y[k])
        assert not torch.equal(x["image"], z["image"])
    counts = [train.box_counts(t, s) for s in SEEDS]
    assert sorted(counts[0].ravel()) == sorted(counts[1].ravel())
    for batch, n in zip(a, counts[0]):
        valid = batch["cls"] > -1
        assert (valid.sum(1).numpy() == n).all()
        boxes = batch["bbox"][valid]
        assert (boxes[:, 2:] > boxes[:, :2]).all()
        assert boxes.min() >= 0 and boxes.max() <= 128


def test_the_full_train_mix_has_coco_like_box_counts():
    t = make_run("d0_train_b128").traffic | {"batch": 128, "pool": 4}
    n = train.box_counts(t, 1)
    assert n.min() >= 1 and n.max() <= 100
    assert 6.0 < n.mean() < 8.5
