"""``MetaTrainer`` against the JAX package's, on the tiny set-up of
tests/torch_meta_helpers.py with ``meta_batch_size`` 2 and three episodes:

- the sequence A(e0), A(e1) (a phase-A meta step), A(e2) (left partial),
  B(e0) (the phase boundary drops the partial batch), B(e1) (a phase-B
  meta step): each episode's metrics to rtol 1e-5, ``meta_step`` on the
  same episodes, and after each meta step the meta parameters to rtol
  1e-4 / atol 1e-6 and the optimizer's traces (the accumulated, clipped
  meta-gradients) to rtol 1e-3 / atol 5e-6 (reached: 1.7e-6);
- ``eval_episode`` in both phases;
- the ``ref_stale_proj_activs`` compat mode, mirroring
  tests/test_ref_compat_modes.py:179-240: phase B before any phase A
  raises; the phase-B regularizer ignores the current projection crops
  and follows the latest phase-A episode's; its metrics equal JAX's.
The model's trunk parameters and every BatchNorm statistic stay
bit-unchanged through all of it.

The trainers run nesterov SGD: adam turns a gradient element at the
level of the two frameworks' rounding (1e-8) into a step of +-meta_lr
whose sign is that rounding's (after one step, up to 2e-3 apart on one
or two of a ProjectionNet kernel's 54,272 elements), so its parameters
say nothing about the plumbing held here; adam's arithmetic is held against optax in
tests/test_torch_meta_optim.py.
"""
import jax
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import (assert_meta_close, optax_moments,
                                port_model, setup)

from ood_object_detection_tpu.meta import MetaTrainer as JaxTrainer
from ood_object_detection_tpu_torch.meta import MetaTrainer

SEQUENCE = [(True, 0), (True, 1), (True, 2), (False, 0), (False, 1)]


@pytest.fixture(scope="module")
def s():
    return setup(count=3)


def _trainers(s, **meta_kw):
    meta_kw = {"optim": "nesterov", **meta_kw}
    jmeta, tmeta = s.jmeta.replace(**meta_kw), s.tmeta.replace(**meta_kw)
    jt = JaxTrainer(s.jmodel, s.jproj, s.variables, jmeta, s.jmc, s.lsz,
                    proj_params=s.proj_params)
    model, proj = port_model(s.tmc, s.variables, s.proj_params, tmeta)
    tt = MetaTrainer(model, proj, tmeta, s.tmc, s.lsz, device="cpu")
    return jt, tt


def _metrics_close(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "meta_step":
            assert got[k] is True
        else:
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5,
                                       err_msg=k)


@pytest.fixture(scope="module")
def trained(s):
    jt, tt = _trainers(s)
    frozen = {n: t.detach().clone()
              for n, t in list(tt.model.named_parameters())
              + list(tt.model.named_buffers())
              if not n.startswith("class_net.") or "running_" in n}
    records = []
    for phase_a, i in SEQUENCE:
        jm = jt.train_episode(s.episodes[i], phase_a=phase_a)
        tm = tt.train_episode(s.batches[i], phase_a=phase_a)
        snap = None
        if "meta_step" in jm:
            snap = (jax.tree.map(np.asarray, jt.meta_params),
                    optax_moments(jt.opt_state,
                                  {t: list(d) for t, d in
                                   tt.meta_params.items()}),
                    {t: {n: v.detach().clone() for n, v in d.items()}
                     for t, d in tt.meta_params.items()},
                    {k: {m: v.clone() for m, v in st.items()}
                     for k, st in tt.tx.state.items()})
        records.append((jm, tm, snap))
    return jt, tt, records, frozen


def test_train_episodes_match_jax(trained):
    _, _, records, _ = trained
    steps = [i for i, (jm, _, _) in enumerate(records) if "meta_step" in jm]
    assert steps == [1, 4]          # A(e2) left partial, dropped at B(e0)
    for jm, tm, _ in records:
        _metrics_close(tm, jm)


@pytest.mark.parametrize("step", [0, 1], ids=["phase_a", "phase_b"])
def test_meta_step_params_and_moments_match_jax(trained, step):
    _, _, records, _ = trained
    j_params, j_moments, t_params, t_state = \
        [r[2] for r in records if r[2] is not None][step]
    assert_meta_close(t_params, j_params, rtol=1e-4, atol=1e-6,
                      what=f"meta step {step + 1}")
    assert j_moments
    for (moment, t, n), value in j_moments.items():
        np.testing.assert_allclose(t_state[t, n][moment].numpy(), value,
                                   rtol=1e-3, atol=5e-6,
                                   err_msg=f"{moment} {t} {n}")


def test_trunk_and_statistics_unchanged(trained):
    _, tt, _, frozen = trained
    now = dict(list(tt.model.named_parameters())
               + list(tt.model.named_buffers()))
    for name, value in frozen.items():
        assert torch.equal(now[name], value), name
    assert not any(p.requires_grad for n, p in tt.model.named_parameters()
                   if not n.startswith("class_net."))


@pytest.mark.parametrize("phase_a", [True, False], ids=["phase_a", "phase_b"])
def test_eval_episode_matches_jax(trained, s, phase_a):
    jt, tt, _, _ = trained
    _metrics_close(tt.eval_episode(s.batches[2], phase_a=phase_a),
                   jt.eval_episode(s.episodes[2], phase_a=phase_a))


@pytest.fixture(scope="module")
def stale(s):
    return _trainers(s, ref_stale_proj_activs=True, proj_reg=0.03)


def test_stale_mode_matches_jax_and_ignores_current_crops(s, stale):
    jt, tt = stale
    with pytest.raises(ValueError, match="phase-A"):
        tt.eval_episode(s.batches[0], phase_a=False)
    _metrics_close(tt.eval_episode(s.batches[1], phase_a=True),
                   jt.eval_episode(s.episodes[1], phase_a=True))
    m1 = tt.eval_episode(s.batches[0], phase_a=False)
    _metrics_close(m1, jt.eval_episode(s.episodes[0], phase_a=False))
    b2 = dict(s.batches[0], proj_images=s.batches[0]["proj_images"] * 0.5
              + 0.1)
    m2 = tt.eval_episode(b2, phase_a=False)
    assert m1["proj_loss"].item() == pytest.approx(m2["proj_loss"].item(),
                                                   rel=1e-6)
    b3 = dict(s.batches[0], qry_images=torch.from_numpy(
        np.random.default_rng(11).normal(0, 2, s.batches[0]["qry_images"]
                                         .shape).astype(np.float32)))
    m3 = tt.eval_episode(b3, phase_a=False)
    assert abs(m1["qry_loss"].item() - m3["qry_loss"].item()) > 1e-6
    # a later phase-A episode replaces the cache
    tt.eval_episode(b2, phase_a=True)
    m4 = tt.eval_episode(s.batches[0], phase_a=False)
    assert not np.isclose(m1["proj_loss"].item(), m4["proj_loss"].item())


def test_default_mode_phase_b_uses_current_crops(s, trained):
    _, tt, _, _ = trained
    m1 = tt.eval_episode(s.batches[0], phase_a=False)
    b2 = dict(s.batches[0], proj_images=s.batches[0]["proj_images"] * 0.5
              + 0.1)
    m2 = tt.eval_episode(b2, phase_a=False)
    assert not np.isclose(m1["proj_loss"].item(), m2["proj_loss"].item())


def test_sharded_meta_step_is_left_for_the_data_parallel_slice(trained):
    """The episode-parallel step needs a launched mesh of its size: a mesh
    of two outside torchrun raises and names it; the step itself is held
    in tests/test_torch_parallel_meta.py."""
    from ood_object_detection_tpu_torch.parallel import create_mesh
    _, tt, _, _ = trained
    with pytest.raises(ValueError, match="torchrun"):
        tt.train_meta_batch_sharded(
            [], mesh=create_mesh((2,), ("episode",), device="cpu"))
