"""The port's entry points data-parallel on two ``gloo`` ranks: the
pretrain CLI with the JAX package's tests/test_multiprocess_pretrain.py
assertions, and ``validate --mesh 2`` against ``--mesh 1``.

Pretrain (both ranks with the same argv, as torchrun gives them: the tiny
D0 at 128 px, batch 2 a rank, 4 steps, validation with --eval-map every
2): each rank's log holds the same merged val loss, val mAP and
``saved_best`` decisions; the checkpoints are complete; the ranks' loader
shards are disjoint and cover the split; and step 1's losses equal those
of one process at batch 4 from the same seed (the same four images).

Validate (15 synthetic images, batch 3 a rank, energy OOD, three class
biases raised so that there are detections): global batches of 6, the
last of 3 run whole by rank 0 (JAX's rule for a batch that does not
divide the mesh); the metrics and each image's detections equal the
one-process run's.
"""
import json
import os

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_dist_helpers import Ranks

from ood_object_detection_tpu_torch import factory, validate
from ood_object_detection_tpu_torch.evaluation import evaluators
from ood_object_detection_tpu_torch.train import pretrain

TINY = ["--model", "efficientdet_d0", "--num-classes", "4",
        "--image-size", "128", "--fpn-repeats", "1", "--head-repeats", "1",
        "--workers", "1", "--lr", "0.01", "--warmup-steps", "2",
        "--data", "synthetic", "--device", "cpu"]
PRETRAIN = TINY + ["--batch-size", "2", "--steps", "4", "--val-freq", "2",
                   "--val-steps", "2", "--log-freq", "1", "--eval-map",
                   "--mesh", "2", "--checkpoint-dir", "ck",
                   "--per-cat-dir", "pc", "--log-file", "metrics.jsonl"]
VALIDATE = ["--device", "cpu", "--data", "synthetic", "--num-classes", "4",
            "--image-size", "128", "--batch-size", "3", "--max-batches",
            "5", "--workers", "1", "--ood-method", "energy"]

_PRETRAIN_RANK = r"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.data.dataset import (
    PrefetchLoader, SyntheticDetectionDataset)
from ood_object_detection_tpu_torch.train import pretrain

pretrain.main(json.loads(sys.argv[1]))
rank = int(__import__("os").environ["RANK"])
# the val loader the driver built: disjoint halves of the split
val_ds = SyntheticDetectionDataset(num_images=4, image_size=(128, 128),
                                   num_classes=4, seed=1)
loader = PrefetchLoader(val_ds, batch_size=2, shuffle=False, workers=1,
                        drop_last=False, device="cpu", process_index=rank,
                        process_count=2)
json.dump({"shard_ids": [int(i) for b in loader for i in b["img_id"]]},
          open(f"done{rank}.json", "w"))
"""

_BOOST = r"""
import torch
from ood_object_detection_tpu_torch import factory
from ood_object_detection_tpu_torch.evaluation import evaluators


def boost(fn):
    def create_model(*args, **kwargs):
        bench = fn(*args, **kwargs)
        with torch.no_grad():     # a few classes above the score floor
            bench.model.class_net.predict_bias().view(9, -1)[:, :3] += 3.0
        return bench
    return create_model


def recorder(record):
    merge = evaluators.Evaluator._maybe_merge

    def recorded(self, det, target):
        det, target = merge(self, det, target)
        if det is not None:
            for i, img in enumerate(target["img_id"]):
                record[int(img)] = det[i]
        return det, target
    return recorded
"""

_VALIDATE_RANK = _BOOST + r"""
import json, os, sys
import numpy as np
torch.set_num_threads(1)
from ood_object_detection_tpu_torch import validate

factory.create_model = boost(factory.create_model)
record = {}
evaluators.Evaluator._maybe_merge = recorder(record)
metrics = validate.main(json.loads(sys.argv[1]))
rank = int(os.environ["RANK"])
np.savez(f"dets{rank}.npz", **{str(k): v for k, v in record.items()})
json.dump(metrics, open(f"metrics{rank}.json", "w"))
"""


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def pretrain_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_pretrain")
    launch = Ranks(_PRETRAIN_RANK, 2, tmp, [json.dumps(PRETRAIN)])
    # one process at batch 4 from the same seed, beside the ranks
    one = tmp_path_factory.mktemp("one_pretrain")
    pretrain.main(TINY + [
        "--batch-size", "4", "--steps", "1", "--val-freq", "100",
        "--log-freq", "1", "--checkpoint-dir", str(one / "ck"),
        "--per-cat-dir", str(one / "pc"),
        "--log-file", str(one / "metrics.jsonl")])
    launch.join()
    return (tmp, [_log(tmp / "metrics.jsonl"),
                  _log(tmp / "metrics.jsonl.rank1")],
            _log(one / "metrics.jsonl"))


def test_pretrain_ranks_merge_val_loss_and_best_checkpoint(pretrain_run):
    _, logs, _ = pretrain_run

    def rows(log, *keys):
        return [tuple(m[k] for k in keys) for m in log if keys[-1] in m]
    val = [rows(log, "step", "val_loss") for log in logs]
    assert val[0] and val[0] == val[1]
    assert [s for s, _ in val[0]] == [2, 4]
    assert rows(logs[0], "step", "val_mAP") == rows(logs[1], "step",
                                                    "val_mAP")
    best = [rows(log, "step", "saved_best") for log in logs]
    assert best[0] and best[0] == best[1]
    # the train metrics are the global batch's: equal on both ranks
    assert rows(logs[0], "step", "loss") == rows(logs[1], "step", "loss")
    assert logs[0][-1]["final_step"] == logs[1][-1]["final_step"] == 4


def test_pretrain_checkpoint_is_complete(pretrain_run):
    from ood_object_detection_tpu_torch.train import CheckpointManager
    tmp, _, _ = pretrain_run
    steps = CheckpointManager(str(tmp / "ck")).all_steps()
    assert steps and steps[-1] == 4
    assert not [f for f in os.listdir(tmp / "ck") if ".tmp" in f]
    state = torch.load(tmp / "ck" / "step_4.pt", weights_only=True)
    assert state["state"]["step"] == 4
    assert sorted(os.listdir(tmp / "pc"))      # rank 0's per-class dumps


def test_pretrain_loader_shards_are_disjoint_and_cover(pretrain_run):
    tmp, _, _ = pretrain_run
    ids = [json.loads((tmp / f"done{r}.json").read_text())["shard_ids"]
           for r in range(2)]
    assert set(ids[0]).isdisjoint(ids[1])
    assert len(set(ids[0]) | set(ids[1])) == 4


def test_pretrain_step_one_equals_one_process(pretrain_run):
    """Rank r's rows of step 1 are samples r and 2 + r of the shared
    shuffle: the global batch is the one process's first batch of 4."""
    _, logs, one = pretrain_run
    first = next(m for m in logs[0] if m.get("step") == 1 and "loss" in m)
    want = next(m for m in one if m.get("step") == 1 and "loss" in m)
    for k in ("loss", "class_loss", "box_loss", "grad_norm"):
        np.testing.assert_allclose(first[k], want[k], rtol=2e-4, err_msg=k)
    assert first["num_positives"] == want["num_positives"]


@pytest.fixture(scope="module")
def validate_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_validate")
    launch = Ranks(_VALIDATE_RANK, 2, tmp,
                   [json.dumps(VALIDATE + ["--mesh", "2"])])
    hooks = {}
    exec(_BOOST, hooks)
    record = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(factory, "create_model",
                   hooks["boost"](factory.create_model))
        mp.setattr(evaluators.Evaluator, "_maybe_merge",
                   hooks["recorder"](record))
        one = validate.main(VALIDATE + ["--mesh", "1"])
    launch.join()
    ranks = [(json.loads((tmp / f"metrics{r}.json").read_text()),
              dict(np.load(tmp / f"dets{r}.npz"))) for r in range(2)]
    return one, record, ranks


def test_validate_mesh_2_gives_the_one_process_metrics(validate_runs):
    one, _, ranks = validate_runs
    assert one["images"] == 15
    for metrics, _ in ranks:
        assert {k: v for k, v in metrics.items() if k != "img_per_sec"} \
            == {k: v for k, v in one.items() if k != "img_per_sec"}
    assert one["mAP@0.5IOU"] > 0


def test_validate_mesh_2_gives_the_same_detections(validate_runs):
    _, record, ranks = validate_runs
    assert len(record) == 15
    n_det = 0
    for _, dets in ranks:           # every rank evaluated every image
        assert sorted(map(int, dets)) == sorted(record)
        for img, want in record.items():
            np.testing.assert_allclose(dets[str(img)], want, rtol=1e-5,
                                       atol=1e-4, err_msg=f"image {img}")
            n_det += int((want[:, 4] > 0).sum())
    assert n_det > 0
