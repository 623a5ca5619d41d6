"""The adapted head's outputs and the per-subnet BatchNorm flags against the
JAX package, on the tiny set-up of tests/torch_meta_helpers.py:

- ``maml_episode_loss`` with the default flags and with each
  ``freeze_*_bn`` flag off equals JAX's (rtol 1e-5 frozen; 1e-4 with a
  subnet in batch-statistic mode, whose statistics over the episode's few
  images carry the two trunks' rounding further), and each flag changes
  the loss;
- ``MetaTrainer.episode_detections`` and the detections of
  ``episode_ood_scores`` keep the JAX path's detections (hard NMS at 0.3,
  30 an image): the same rows kept, boxes to 1e-5 of the largest
  coordinate (the random box head decodes boxes of up to 1.8e4 px, and a
  corner of a few px is the difference of two such numbers; reached 0.05
  px against 0.18),
  scores to rtol 1e-5, classes equal; ``det_ood`` and ``gt_ood`` (energy)
  to rtol 1e-4 (the query pyramids differ by 1e-5 relative, and the
  logits with them; reached 1.4e-5), ``gt_valid`` equal;
- ``adapted_variables`` holds JAX's fast class head to rtol 1e-4.
"""
import jax
import numpy as np
import pytest
import torch
import torch_parity_helpers  # noqa: F401  (caps torch threads)
from torch_meta_helpers import (assert_meta_close, jax_arrays,
                                leaf_meta_params, port_model, setup)

from ood_object_detection_tpu.meta import MetaTrainer as JaxTrainer
from ood_object_detection_tpu.meta import episode as jep
from ood_object_detection_tpu.meta import inner_loop as jil
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu_torch.meta import MetaTrainer
from ood_object_detection_tpu_torch.meta import episode as tep

FLAGS = (None, "freeze_bb_bn", "freeze_fpn_bn", "freeze_box_bn")


@pytest.fixture(scope="module")
def s():
    return setup()


def _jax_meta_params(s):
    return {"class_net": s.variables["params"]["class_net"],
            "proj": s.proj_params,
            "inner_lrs": jil.init_inner_lrs(1, s.jmeta.inner_lr)}


@pytest.fixture(scope="module")
def losses(s):
    out = {}
    for flag in FLAGS:
        kw = {} if flag is None else {flag: False}
        jmeta, tmeta = s.jmeta.replace(**kw), s.tmeta.replace(**kw)
        j_loss = jax.jit(lambda mp, v, b: jep.maml_episode_loss(
            s.jmodel, s.jproj, v, mp, b, jmeta, s.jmc, s.lsz)[0])(
            _jax_meta_params(s), s.variables, jax_arrays(s.ep))
        mp = leaf_meta_params(s.model, s.proj, _jax_meta_params(s)
                              ["inner_lrs"])
        with torch.no_grad():
            t_loss, _ = tep.maml_episode_loss(
                s.model, s.proj, mp, s.batch, tmeta, s.tmc, s.lsz,
                create_graph=False)
        out[flag] = (float(j_loss), t_loss.item())
    return out


@pytest.mark.parametrize("flag", FLAGS, ids=lambda f: f or "defaults")
def test_freeze_bn_flags_match_jax(losses, flag):
    j_loss, t_loss = losses[flag]
    np.testing.assert_allclose(t_loss, j_loss,
                               rtol=1e-5 if flag is None else 1e-4)
    if flag is not None:
        assert t_loss != losses[None][1], f"{flag} is a silent no-op"


@pytest.fixture(scope="module")
def adapted(s):
    jt = JaxTrainer(s.jmodel, s.jproj, s.variables, s.jmeta, s.jmc, s.lsz,
                    proj_params=s.proj_params)
    anchors = JaxAnchors.from_config(s.jmc, img_size=s.jmeta.qry_img_size)
    j_ood = jax.jit(lambda mp, v, b: jep.maml_episode_ood_scores(
        s.jmodel, s.jproj, v, mp, b, s.jmeta, s.jmc, anchors))(
        jt.meta_params, s.variables, jax_arrays(s.ep))
    j_fast = jax.jit(jt.adapted_variables)(s.ep["supp_images"])
    model, proj = port_model(s.tmc, s.variables, s.proj_params, s.tmeta)
    tt = MetaTrainer(model, proj, s.tmeta, s.tmc, s.lsz, device="cpu")
    return (j_ood, j_fast, tt.episode_detections(s.batch),
            tt.episode_ood_scores(s.batch),
            tt.adapted_variables(s.batch["supp_images"]))


def _same_detections(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape == (4, 30, 6)
    kept = want[..., 4] > 0
    np.testing.assert_array_equal(got[..., 4] > 0, kept)
    assert kept.sum() > 0
    np.testing.assert_allclose(got[..., :4], want[..., :4], rtol=0,
                               atol=1e-5 * np.abs(want[..., :4]).max())
    np.testing.assert_allclose(got[..., 4], want[..., 4], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_array_equal(got[..., 5], want[..., 5])


def test_episode_detections_match_jax(adapted):
    j_ood, _, dets, (ood_dets, *_), _ = adapted
    _same_detections(dets, j_ood[0])
    _same_detections(ood_dets, j_ood[0])


def test_episode_ood_scores_match_jax(adapted):
    j_ood, _, _, (_, det_ood, gt_ood, gt_valid), _ = adapted
    assert tuple(det_ood.shape) == (4, 30)
    assert tuple(gt_ood.shape) == (4, 100)
    np.testing.assert_allclose(det_ood.numpy(), np.asarray(j_ood[1]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gt_ood.numpy(), np.asarray(j_ood[2]),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_array_equal(gt_valid.numpy(), np.asarray(j_ood[3]))
    assert gt_valid.any() and not gt_valid[-1].any()   # the zero image


def test_adapted_variables_match_jax(adapted):
    _, j_fast, _, _, t_vars = adapted
    fast = {n[len("class_net."):]: v for n, v in t_vars.items()
            if n.startswith("class_net.") and "running_" not in n}
    assert_meta_close({"class_net": fast},
                      {"class_net": j_fast["params"]["class_net"]},
                      rtol=1e-4, atol=1e-6, what="adapted class head")
