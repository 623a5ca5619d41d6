"""meta/projection.py and meta/clustering.py against the JAX package's.

- The sinusoid tables and ``build_anchor_features`` (both layouts) are
  bit-equal (they only copy and concatenate).
- ``confidence_topk`` indices equal ``jax.lax.top_k``'s, ties included
  (lowest index first) where k is below the row length; at keep-all
  levels (k = row length, where jax's CPU order is not fixed for ties)
  the rows hold the same index sets and the port's order is checked
  explicitly: descending, equal values lowest index first.
- ``select_confident_anchors``, ``ProjectionNet`` (flax init, carried by
  ``utils.from_jax.load_jax_projection``) to 1e-5.
- ``cluster_pseudo_targets`` for ``sim_thresh`` None ('mean' refinement,
  phase A) and 0.2 ('sum', inner loop) x ``sim_target`` max / avg x
  ``loss_mode`` separate / same / no_conf: ``champion_idx`` equal, every
  ``ClusterResult`` field and ``projection_losses`` to rtol 1e-5 / atol
  1e-6; ``weighted_median`` and ``cosine_hinge_loss`` too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)

from ood_object_detection_tpu.meta import clustering as jcl
from ood_object_detection_tpu.meta import projection as jpr
from ood_object_detection_tpu.meta.config import MetaConfig as JaxMeta
from ood_object_detection_tpu_torch.meta import MetaConfig
from ood_object_detection_tpu_torch.meta import clustering as tcl
from ood_object_detection_tpu_torch.meta import projection as tpr
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_projection


def _t(a):
    return torch.from_numpy(np.array(a))


def test_tables_are_bit_equal():
    for name in ("ANCHOR_ENC", "CELL_ENC", "LEVEL_ENC"):
        np.testing.assert_array_equal(getattr(tpr, name), getattr(jpr, name))
    assert tpr.POS_DIM == jpr.POS_DIM == 42


@pytest.mark.parametrize("ref_pos_enc", [False, True])
def test_build_anchor_features_bit_equal(ref_pos_enc):
    rng = np.random.default_rng(3)
    levels = [rng.normal(0, 1, (2, g, g, 5)).astype(np.float32)
              for g in (8, 5, 4, 1)]
    for offset in (0, 1, 2):
        want = jpr.build_anchor_features([jnp.asarray(x) for x in levels],
                                         level_offset=offset,
                                         ref_pos_enc=ref_pos_enc)
        got = tpr.build_anchor_features([_t(x) for x in levels],
                                        level_offset=offset,
                                        ref_pos_enc=ref_pos_enc)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_ref_pos_enc_requires_square_maps():
    with pytest.raises(ValueError, match="square"):
        tpr.build_anchor_features([torch.zeros(1, 4, 6, 3)], ref_pos_enc=True)


def _check_topk_order(idx, vals, conf):
    """Descending values, equal values in rising index order."""
    assert torch.equal(vals, torch.gather(conf, 1, idx))
    assert bool((vals[:, 1:] <= vals[:, :-1]).all())
    tied = vals[:, 1:] == vals[:, :-1]
    assert bool((idx[:, 1:] > idx[:, :-1])[tied].all())


def test_confidence_topk_matches_jax_with_ties():
    rng = np.random.default_rng(0)
    conf = (np.round(rng.normal(0, 1, (3, 640)) * 2) / 2).astype(np.float32)
    j_idx, j_vals = jpr.confidence_topk(jnp.asarray(conf), 0.125)
    t_idx, t_vals = tpr.confidence_topk(_t(conf), 0.125)
    assert t_idx.shape == (3, 80)
    np.testing.assert_array_equal(t_idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(t_vals.numpy(), np.asarray(j_vals))
    _check_topk_order(t_idx, t_vals, _t(conf))
    # keep-all (k = row length): the same sets; the port's order explicit
    j_idx, _ = jpr.confidence_topk(jnp.asarray(conf[:, :36]), 0.125,
                                   min_keep_all=36)
    t_idx, t_vals = tpr.confidence_topk(_t(conf[:, :36]), 0.125,
                                        min_keep_all=36)
    for got, want in zip(t_idx.numpy(), np.asarray(j_idx)):
        assert sorted(got) == sorted(want)
    _check_topk_order(t_idx, t_vals, _t(conf[:, :36]))


def test_select_confident_anchors_matches_jax():
    rng = np.random.default_rng(1)
    grids = (8, 4, 2)           # the offset projection levels of a 256 crop
    feats = [rng.normal(0, 1, (3, g * g * 9, 7)).astype(np.float32)
             for g in grids]
    cls = [rng.normal(0, 1, (3, g, g, 9)).astype(np.float32) for g in grids]
    sep = [rng.normal(0, 1, (3, g, g, 9)).astype(np.float32) for g in grids]
    sizes = [g * g * 9 for g in grids]
    labels = rng.integers(-1, 5, (3, sum(sizes))).astype(np.int32)
    want = jpr.select_confident_anchors(
        [jnp.asarray(x) for x in feats], [jnp.asarray(x) for x in cls],
        JaxMeta(), labels_flat=jnp.asarray(labels), level_sizes=sizes,
        sep_out=[jnp.asarray(x) for x in sep])
    got = tpr.select_confident_anchors(
        [_t(x) for x in feats], [_t(x) for x in cls], MetaConfig(),
        labels_flat=_t(labels), level_sizes=sizes,
        sep_out=[_t(x) for x in sep])
    assert got[0].shape == (3, 72 + 144 + 36, 7)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    with pytest.raises(ValueError, match="level mismatch"):
        tpr.select_confident_anchors([_t(x) for x in feats[:2]],
                                     [_t(x) for x in cls], MetaConfig(),
                                     labels_flat=_t(labels), level_sizes=sizes)
    with pytest.raises(ValueError, match="misaligned"):
        tpr.select_confident_anchors([_t(x) for x in feats],
                                     [_t(x) for x in cls], MetaConfig(),
                                     labels_flat=_t(labels),
                                     level_sizes=sizes[::-1])


def test_projection_net_matches_jax():
    net = jpr.ProjectionNet(fpn_channels=64, width=512, depth=2)
    x = np.random.default_rng(2).normal(0, 1, (50, 64 + 42)).astype(np.float32)
    params = dict(net.init(jax.random.key(1), jnp.asarray(x[:1]))["params"])
    want = net.apply({"params": params}, jnp.asarray(x))
    params.update(dot_mult=jnp.float32(2.5), dot_add=jnp.float32(1.5))
    port = tpr.ProjectionNet(64, 512, 2)
    load_jax_projection(port, params)
    got = port(_t(x))
    assert got.shape == (50, 256)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)
    assert port.dot_mult.item() == 2.5 and port.dot_add.item() == 1.5
    gate = jpr.ProjectionGate(2.5, 1.5)
    conf = jnp.asarray(x[:, 0])
    want = gate.apply(gate.init(jax.random.key(0), conf), conf)
    np.testing.assert_allclose(tpr.ProjectionGate(2.5, 1.5)(_t(x[:, 0]))
                               .detach().numpy(), np.asarray(want), rtol=1e-6)


def _cluster_inputs(seed=0, s=4, k=16, d=8):
    """Embeddings with a task cluster (the first 3 anchors of each image
    share a direction) and labels: task class 2 there, other classes or
    background elsewhere."""
    rng = np.random.default_rng(seed)
    embds = rng.normal(0, 1, (s, k, d)).astype(np.float32)
    base = rng.normal(0, 1, d)
    embds[:, :3] = base + rng.normal(0, 0.3, (s, 3, d))
    confs = rng.normal(0, 2, (s, k)).astype(np.float32)
    confs[:, :3] += 2.0
    labels = rng.integers(-1, 4, (s, k)).astype(np.int32)
    labels[:, :3] = 2
    return embds, confs, labels.reshape(-1)


@pytest.mark.parametrize("loss_mode", ["separate", "same", "no_conf"])
@pytest.mark.parametrize("sim_target", ["max", "avg"])
@pytest.mark.parametrize("sim_thresh,refine", [(None, "mean"), (0.2, "sum")])
def test_clustering_matches_jax(sim_thresh, refine, sim_target, loss_mode):
    embds, confs, labels = _cluster_inputs(seed=len(loss_mode))
    dm, da = np.float32(2.0), np.float32(0.5)
    kw = dict(sim_thresh=sim_thresh, refine_reduce=refine,
              sim_target=sim_target)
    want = jcl.cluster_pseudo_targets(jnp.asarray(embds), jnp.asarray(confs),
                                      jnp.float32(dm), jnp.float32(da), **kw)
    got = tcl.cluster_pseudo_targets(_t(embds), _t(confs), _t(dm), _t(da),
                                     **kw)
    np.testing.assert_array_equal(got.champion_idx.numpy(),
                                  np.asarray(want.champion_idx))
    assert float(got.valid_count) > 0
    for f in dataclasses.fields(tcl.ClusterResult):
        np.testing.assert_allclose(getattr(got, f.name).numpy(),
                                   np.asarray(getattr(want, f.name)),
                                   rtol=1e-5, atol=1e-6, err_msg=f.name)
    soft = dm * (confs.reshape(-1) + da)
    lkw = dict(loss_mode=loss_mode, sim_target=sim_target, margin=0.1)
    w_losses = jcl.projection_losses(want, jnp.asarray(labels),
                                     jnp.int32(2), jnp.asarray(soft), **lkw)
    g_losses = tcl.projection_losses(got, _t(labels), torch.tensor(2),
                                     _t(soft), **lkw)
    for g, w in zip(g_losses, w_losses):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5, atol=1e-6)


def test_weighted_median_and_hinge_match_jax():
    rng = np.random.default_rng(4)
    embds = np.round(rng.normal(0, 1, (33, 6)) * 4).astype(np.float32) / 4
    confs = rng.uniform(0, 1, 33).astype(np.float32)
    w_med, w_sum = jcl.weighted_median(jnp.asarray(embds), jnp.asarray(confs))
    g_med, g_sum = tcl.weighted_median(_t(embds), _t(confs))
    np.testing.assert_array_equal(g_med.numpy(), np.asarray(w_med))
    np.testing.assert_allclose(float(g_sum), float(w_sum), rtol=1e-6)
    x = rng.uniform(-1, 1, 40).astype(np.float32)
    t = np.where(rng.uniform(size=40) > 0.5, 1.0, -1.0).astype(np.float32)
    for margin in (0.0, 0.2):
        np.testing.assert_allclose(
            float(tcl.cosine_hinge_loss(_t(x), _t(t), margin)),
            float(jcl.cosine_hinge_loss(jnp.asarray(x), jnp.asarray(t),
                                        margin)), rtol=1e-6)
