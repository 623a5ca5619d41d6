"""The meta episode in bf16 (``compute_dtype="bfloat16"``, the meta bench's
default) against the JAX package's, on the tiny set-up of
tests/torch_meta_helpers.py.

jax promotes a bf16 array combined with a non-weak f32 array to f32: the
class head's bf16 confidences meet the ProjectionNet's f32 gate scalars
(``dot_mult``, ``dot_add``) and f32 embeddings in the clustering and in
the phase-A objectness logits. torch keeps a tensor's dtype against a 0-d
tensor and ``matmul`` promotes nothing, so without explicit casts the
port's bf16 episode stopped at ``embds.T @ soft_thresh`` (a bf16 / f32
matmul).

Held here:
- ``cluster_pseudo_targets`` on bf16 confidences and f32 embeddings: every
  output's dtype equal to JAX's, the values to the zoo's bf16 bars (rtol
  2^-7, atol 2^-6; the inputs are cast exactly, so this is f32 rounding);
- ``MetaTrainer.episode_grads(batch, phase_a=False)`` against JAX
  ``_episode_grads``: every metric to the zoo's bf16 bars; every
  meta-gradient leaf f32 and finite.

The meta-gradient leaves are not held to those bars elementwise: that is
not well posed. JAX's own bf16 meta-gradient differs from the f32 one by
16 % of the whole gradient's L2 norm (up to 2.2 times a leaf's norm: the
conv inner LRs), because the second-order path through five pyramid
levels of bf16 activations amplifies each rounding, and the two
frameworks round at different places (tests/test_torch_train_bench.py).
So the whole meta-gradient (every leaf, concatenated) is held by relative
L2, with the port's f32 gradient standing for the f32 one (the f32
parity tests hold it to JAX's to rtol 1e-4):
- the port's bf16 gradient within twice JAX's own bf16-vs-f32 spread of
  JAX's bf16 gradient, plus 2^-7 (measured 0.180 against a spread of
  0.164);
- the port's bf16 gradient no farther from the f32 one than JAX's bf16
  gradient is (measured 0.047 against 0.164);
- the predict depthwise inner LR, which the gate and the clustering set,
  at most half as far from JAX's bf16 gradient as from the f32 one
  (measured 0.0034 against 0.032): a port that ran the episode in f32
  fails this.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import jax_arrays, port_leaf_to_jax, port_model, setup

from ood_object_detection_tpu.meta import MetaTrainer as JaxTrainer
from ood_object_detection_tpu.meta.clustering import (
    cluster_pseudo_targets as jax_cluster)
from ood_object_detection_tpu_torch.meta import MetaTrainer
from ood_object_detection_tpu_torch.meta.clustering import (
    cluster_pseudo_targets)
from ood_object_detection_tpu_torch.meta.episode import _flat

RTOL, ATOL = 2 ** -7, 2 ** -6          # the zoo's bf16 bars
FOLLOWS_BF16 = ("inner_lrs", "predict_dw")


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("sim_thresh,reduce", [(None, "mean"), (0.1, "sum")],
                         ids=["phase_a", "inner"])
def test_clustering_promotes_bf16_confidences_as_jax(sim_thresh, reduce):
    rng = np.random.default_rng(3)
    embeddings = rng.normal(0, 1, (3, 40, 16)).astype(np.float32)
    conf = jnp.asarray(rng.normal(-2, 1, (3, 40)), jnp.bfloat16)
    mult, add = np.float32(3.0), np.float32(3.0)
    want = jax_cluster(jnp.asarray(embeddings), conf, jnp.float32(mult),
                       jnp.float32(add), sim_thresh=sim_thresh,
                       refine_reduce=reduce)
    got = cluster_pseudo_targets(
        torch.from_numpy(embeddings),
        torch.from_numpy(np.array(conf.astype(jnp.float32))).bfloat16(),
        torch.tensor(mult), torch.tensor(add), sim_thresh=sim_thresh,
        refine_reduce=reduce)
    for field in ("target", "soft_thresh", "champion_idx",
                  "champion_coherence", "valid_count", "champ_sims",
                  "target_clust", "champion_target_clust"):
        w, g = getattr(want, field), getattr(got, field)
        if field != "champion_idx":         # indices: int32 / int64
            assert str(g.dtype).split(".")[-1] == str(w.dtype), field
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w, np.float32), rtol=RTOL,
                                   atol=ATOL, err_msg=field)


@pytest.fixture(scope="module")
def episode():
    s = setup(model_kw={"compute_dtype": "bfloat16"})
    jt = JaxTrainer(s.jmodel, s.jproj, s.variables, s.jmeta, s.jmc, s.lsz,
                    proj_params=s.proj_params)
    _, jm, jg = jt._episode_grads(jt.meta_params, jax_arrays(s.ep))
    out = {}
    for dtype in ("bfloat16", "float32"):
        tmc = s.tmc.replace(compute_dtype=dtype)
        model, proj = port_model(tmc, s.variables, s.proj_params, s.tmeta)
        tt = MetaTrainer(model, proj, s.tmeta, tmc, s.lsz, device="cpu")
        _, tm, grads = tt.episode_grads(s.batch, phase_a=False)
        out[dtype] = (tm, {(t, n): g for (t, n, _), g in
                           zip(_flat(tt.meta_params), grads)})
    return jm, jg, out


def test_bf16_episode_metrics_match_jax(episode):
    jm, _, out = episode
    tm, _ = out["bfloat16"]
    assert set(tm) == set(jm)
    for k, v in jm.items():
        assert tm[k].dtype == torch.float32, k
        np.testing.assert_allclose(tm[k].item(), float(v), rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_bf16_meta_gradients_match_jax(episode):
    _, jg, out = episode
    grads16, grads32 = out["bfloat16"][1], out["float32"][1]
    got, want, f32 = [], [], []
    for (tree, name), g in grads16.items():
        what = f"{tree} {name}"
        assert g.dtype == torch.float32, what
        got.append(g.detach().numpy().ravel())
        assert np.isfinite(got[-1]).all(), what
        want.append(port_leaf_to_jax(jg, tree, name).ravel())
        f32.append(grads32[tree, name].detach().numpy().ravel())
        if (tree, name) == FOLLOWS_BF16:
            assert _rel_l2(got[-1], want[-1]) <= 0.5 * _rel_l2(
                got[-1], f32[-1]), what
    got, want, f32 = (np.concatenate(v) for v in (got, want, f32))
    spread = _rel_l2(want, f32)
    assert _rel_l2(got, want) <= 2 * spread + RTOL, (_rel_l2(got, want),
                                                     spread)
    assert _rel_l2(got, f32) <= spread, (_rel_l2(got, f32), spread)
