"""The episode-parallel meta step (``MetaTrainer.train_meta_batch_sharded``
over ``make_sharded_meta_step``) on ``gloo`` ranks, on the tiny set-up of
tests/torch_meta_helpers.py with a meta batch of 4 episodes and nesterov
SGD (tests/test_torch_meta_trainer.py says why not adam):

- tests/test_meta_sharded.py's two cases: 4 ranks of one episode each
  (the parallel form of sequential accumulation) and 2 ranks of two
  (each rank loops its local chunk); each rank's meta parameters after
  the update equal the port's ``train_episode`` over the 4 episodes to
  rtol 1e-5, as do the mean metrics, and the ranks agree to the bit;
- the JAX package's ``make_sharded_meta_step`` on a 2-device mesh of the
  same 4 episodes: the meta parameters to rtol 1e-4 / atol 1e-6 and the
  optimizer's traces (the clipped mean meta-gradient) to 3.3e-5, the
  meta tolerance of ROADMAP's known deviations, and the metrics to 1e-5.
"""
import jax
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_dist_helpers import Ranks
from torch_meta_helpers import (assert_meta_close, optax_moments, port_model,
                                setup)

from ood_object_detection_tpu.meta import MetaTrainer as JaxTrainer
from ood_object_detection_tpu.parallel import create_mesh as jax_create_mesh
from ood_object_detection_tpu_torch.meta import MetaTrainer

EPISODES = 4

_RANK = r"""
import sys
import torch
torch.set_num_threads(1)
from ood_object_detection_tpu_torch.meta import MetaTrainer, ProjectionNet
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.parallel import create_mesh

start = torch.load(sys.argv[1], weights_only=False)
mesh = create_mesh((-1,), ("episode",), device="cpu")
model = EfficientDet(start["tmc"])
model.load_state_dict(start["model"])
proj = ProjectionNet(64, start["tmeta"].proj_size, start["tmeta"].proj_depth)
proj.load_state_dict(start["proj"])
trainer = MetaTrainer(model.eval(), proj, start["tmeta"], start["tmc"],
                      start["lsz"], device="cpu")
per = len(start["batches"]) // mesh.size
share = start["batches"][mesh.rank * per:(mesh.rank + 1) * per]
metrics = trainer.train_meta_batch_sharded(share, mesh)
torch.save({"metrics": {k: float(v) for k, v in metrics.items()},
            "meta_params": {t: {n: v.detach() for n, v in d.items()}
                            for t, d in trainer.meta_params.items()},
            "traces": {k: st["trace"] for k, st in trainer.tx.state.items()}},
           f"rank{mesh.rank}_of_{mesh.size}.pt")
mesh.close()
"""


@pytest.fixture(scope="module")
def s():
    return setup(count=EPISODES, meta_batch_size=EPISODES, optim="nesterov")


@pytest.fixture(scope="module")
def runs(s, tmp_path_factory):
    """(the port's sequential trainer and its metrics, the ranks' saved
    states by world size, the JAX sharded trainer and its metrics)."""
    tmp = tmp_path_factory.mktemp("meta_dp")
    start = tmp / "start.pt"
    torch.save({"tmc": s.tmc, "tmeta": s.tmeta, "lsz": s.lsz,
                "model": s.model.state_dict(), "proj": s.proj.state_dict(),
                "batches": s.batches}, start)
    launches = {}
    for world in (4, 2):            # the ranks run beside the JAX compile
        (tmp / f"w{world}").mkdir()
        launches[world] = Ranks(_RANK, world, tmp / f"w{world}", [start],
                                timeout=300)

    model, proj = port_model(s.tmc, s.variables, s.proj_params, s.tmeta)
    seq = MetaTrainer(model, proj, s.tmeta, s.tmc, s.lsz, device="cpu")
    init = {t: {n: v.detach().clone() for n, v in d.items()}
            for t, d in seq.meta_params.items()}
    seq_metrics = [seq.train_episode(b, phase_a=False) for b in s.batches]
    assert seq_metrics[-1].get("meta_step")

    jt = JaxTrainer(s.jmodel, s.jproj, s.variables, s.jmeta, s.jmc, s.lsz,
                    proj_params=s.proj_params)
    jax_metrics = jt.train_meta_batch_sharded(
        s.episodes, jax_create_mesh((2,), ("episode",),
                                    devices=jax.devices()[:2]),
        axis="episode")

    for launch in launches.values():
        launch.join()
    ranks = {world: [torch.load(tmp / f"w{world}" / f"rank{r}_of_{world}.pt")
                     for r in range(world)] for world in launches}
    return seq, init, seq_metrics, ranks, jt, jax_metrics


def _update_error(init, got, want):
    """The relative L2 difference of two updates (params - init)."""
    da = torch.cat([(got[t][n].detach() - v).reshape(-1)
                    for t, d in init.items() for n, v in d.items()])
    db = torch.cat([(want[t][n].detach() - v).reshape(-1)
                    for t, d in init.items() for n, v in d.items()])
    assert float(db.norm()) > 0, "no update applied"
    return float((da - db).norm() / db.norm())


@pytest.mark.parametrize("world", [4, 2],
                         ids=["one_episode_a_rank", "local_chunks"])
def test_sharded_meta_step_matches_sequential_accumulation(runs, world):
    seq, init, seq_metrics, ranks, _, _ = runs
    for r in ranks[world]:
        for t, d in seq.meta_params.items():
            for n, v in d.items():
                np.testing.assert_allclose(
                    r["meta_params"][t][n].numpy(), v.detach().numpy(),
                    rtol=1e-5, atol=1e-8, err_msg=f"{world} ranks {t} {n}")
        assert _update_error(init, r["meta_params"], seq.meta_params) < 1e-5
        for k, v in r["metrics"].items():
            want = np.mean([float(m[k]) for m in seq_metrics])
            np.testing.assert_allclose(v, want, rtol=1e-5, err_msg=k)
    first = ranks[world][0]
    for r in ranks[world][1:]:
        assert r["metrics"] == first["metrics"]
        for t, d in first["meta_params"].items():
            for n, v in d.items():
                assert torch.equal(r["meta_params"][t][n], v), (t, n)


def test_sharded_meta_step_matches_jax(runs):
    _, _, _, ranks, jt, jax_metrics = runs
    names = {t: list(d) for t, d in ranks[2][0]["meta_params"].items()}
    j_traces = optax_moments(jt.opt_state, names)
    assert j_traces
    for r in ranks[2]:
        assert_meta_close(r["meta_params"], jt.meta_params, rtol=1e-4,
                          atol=1e-6, what="sharded meta step")
        for (moment, t, n), value in j_traces.items():
            np.testing.assert_allclose(r["traces"][t, n].numpy(), value,
                                       rtol=0, atol=3.3e-5,
                                       err_msg=f"{moment} {t} {n}")
        for k, v in jax_metrics.items():
            np.testing.assert_allclose(r["metrics"][k], float(v), rtol=1e-5,
                                       err_msg=k)
