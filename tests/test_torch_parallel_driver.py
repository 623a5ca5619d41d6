"""``meta.train_driver --episode-mesh 2`` on two ``gloo`` ranks (the JAX
package's tests/test_meta_sharded.py::test_meta_cli_episode_mesh_smoke,
launched): 128 px, one BiFPN cell, one head repeat, a 2-way meta batch
of 2 (one episode a rank), 2 phase-A and 2 phase-B training iterations,
then validation episodes (iterations 5 and 6).

Each rank builds its own episodes (seed * 2 + rank), so the ranks
validate on different episodes; the driver averages the val loss over
them. Held: both phases logged with finite metrics; the logged training
metrics (meta-batch means over both ranks) and the merged val losses
equal on the two ranks; the meta parameters moved and are equal to the
bit on the two ranks at the end; the checkpoints, written by rank 0,
hold the last iteration and restore into a rank's meta parameters.
"""
import json

import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_dist_helpers import Ranks

MODEL = ["--img-size", "128", "--qry-img-size", "128", "--fpn-repeats", "1",
         "--head-repeats", "1", "--device", "cpu", "--n-way", "2",
         "--num-sup", "2", "--num-qry", "2", "--num-zero-images", "1",
         "--meta-batch-size", "2", "--synthetic-cats", "4"]
ARGV = MODEL + ["--episode-mesh", "2", "--proj-iters", "2",
                "--total-iters", "6", "--val-freq", "5", "--log-freq", "1",
                "--checkpoint-dir", "ck", "--per-cat-dir", "pc",
                "--prefetch-episodes", "0"]

_RANK = r"""
import json, os, sys
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.meta import train_driver

trainer = train_driver.main(json.loads(sys.argv[1]))
torch.save({t: {n: v.detach() for n, v in d.items()}
            for t, d in trainer.meta_params.items()},
           f"meta{os.environ['RANK']}.pt")
"""


def _json_lines(text):
    out = []
    for line in text.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    from ood_object_detection_tpu_torch.meta import train_driver
    tmp = tmp_path_factory.mktemp("episode_mesh")
    launch = Ranks(_RANK, 2, tmp, [json.dumps(ARGV)], timeout=300)
    # the meta parameters before any update: one process, no iteration
    idle = tmp_path_factory.mktemp("idle")
    start = train_driver.main(
        MODEL + ["--total-iters", "0", "--checkpoint-dir", str(idle / "ck"),
           "--per-cat-dir", str(idle / "pc")])
    outs = launch.join()
    return tmp, [_json_lines(o) for o in outs], \
        [torch.load(tmp / f"meta{r}.pt") for r in range(2)], \
        start.meta_params


def test_both_phases_run_on_both_ranks(run):
    _, logs, _, _ = run
    for log in logs:
        assert log[-1]["final_iter"] == 6
        assert {e.get("phase") for e in log if "phase" in e} == \
            {"proj", "maml"}
        train = [e for e in log if "final_loss" in e]
        assert train and all(np.isfinite(e["final_loss"]) for e in train)


def test_ranks_log_the_same_meta_batch_means_and_val_loss(run):
    _, logs, _, _ = run

    def metrics(log):
        return [{k: v for k, v in e.items() if k != "eps_per_sec"}
                for e in log if "iter" in e]
    assert metrics(logs[0]) == metrics(logs[1])
    val = [e["val_loss"] for e in logs[0] if "val_loss" in e]
    assert len(val) == 2
    assert logs[0][-1]["best_val"] == logs[1][-1]["best_val"]


def test_ranks_end_with_the_same_meta_parameters(run):
    from ood_object_detection_tpu_torch.train import CheckpointManager
    tmp, _, metas, start = run
    for tree, leaves in metas[0].items():
        for name, value in leaves.items():
            assert torch.equal(metas[1][tree][name], value), (tree, name)
    ckpt = CheckpointManager(str(tmp / "ck"))
    assert ckpt.latest_step() == 6
    restored = {t: {n: torch.zeros_like(v) for n, v in d.items()}
                for t, d in metas[0].items()}
    ckpt.restore(restored)
    for tree, leaves in metas[0].items():
        for name, value in leaves.items():
            assert torch.equal(restored[tree][name], value), (tree, name)
    assert any(not torch.equal(start[t][n].detach(), v)
               for t, d in metas[0].items() for n, v in d.items()), \
        "no meta update"
