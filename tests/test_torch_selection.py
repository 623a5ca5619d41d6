"""The port's ``exact`` and ``approx`` top-k selections (CPU: the kernels'
plain versions) vs the JAX package's on identical synthetic head outputs.

Candidate anchor ids, classes and logits are bit-equal to JAX's
``post_process`` (the selection inside ``generate_detections``), tied
logits included; the final detections to the tolerances of
tests/test_torch_post_process.py: classes and the kept set bit-equal,
boxes to rtol 1e-5 / atol 1e-4, scores to rtol 1e-4, OOD scores to rtol
1e-5 / atol 1e-6.

Every case keeps fewer candidates than the selection's rows hold (jax's
CPU top-k orders tied values lowest index first only for k below the row
length): 1000 of 3069 anchors at D0@128, so stage 1 of ``exact`` and the
flat ``approx`` sort both truncate.

One exception: jax's CPU ``approx_max_k`` on bf16 (not f32) returns tied
values in no fixed order (an unstable sort), and bf16 logits tie often.
There the port's ``approx`` ids are held bit-equal to ``lax.top_k`` over
the same flat bf16 pairs, the exact top-k that ``approx_max_k`` stands
for, and to JAX's ``approx`` in their values and in every pair above the
last tied value; its detections are held against JAX's ``batch_detection``
on the ``lax.top_k`` candidates.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity_helpers import head_outputs, to_torch

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.ops.post_process import (
    _anchor_ood_reduce as jax_anchor_ood_reduce,
    _gather_survivor_scores as jax_gather_survivor_scores,
    batch_detection as jax_batch_detection,
    generate_detections as jax_generate_detections,
    post_process as jax_post_process,
)
from ood_object_detection_tpu_torch.ops import post_process as pp
from ood_object_detection_tpu_torch.ops.anchors import Anchors

C = 90
IMG = 128
POINTS = 1000


@pytest.fixture(scope="module")
def anchors():
    cfg = jax_cfg("efficientdet_d0", num_classes=C)
    return (Anchors.from_config(cfg, img_size=IMG),
            JaxAnchors.from_config(cfg, img_size=IMG))


def _outputs(anchors, seed, dtype, ties):
    rng = np.random.default_rng(seed)
    cls, box = head_outputs(anchors[0].feat_sizes, 3, 7, C, rng, batch=2,
                            cls_mean=-3.5, ties=ties)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    return ((to_torch(cls, dtype), to_torch(box, dtype)),
            ([jnp.asarray(c).astype(jdt) for c in cls],
             [jnp.asarray(b).astype(jdt) for b in box]))


CASES = [(dtype, ties) for dtype in (torch.bfloat16, torch.float32)
         for ties in (True, False)]
IDS = [f"{'bf16' if d == torch.bfloat16 else 'f32'}-"
       f"{'tied' if t else 'random'}" for d, t in CASES]


def _flat_topk(jcls, k=POINTS):
    """(ids, values) of the flat [B, A*C] top-k by ``lax.top_k``: lowest
    index first on ties."""
    flat = jnp.concatenate([c.reshape(c.shape[0], -1) for c in jcls], axis=1)
    vals, ids = jax.lax.top_k(flat, k)
    return np.asarray(ids), np.asarray(vals.astype(jnp.float32))


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("dtype,ties", CASES, ids=IDS)
def test_candidates_bit_equal(anchors, method, dtype, ties):
    (cls, box), (jcls, jbox) = _outputs(anchors, 0, dtype, ties)
    cand = pp.select_candidates(cls, box, anchors[0], C, POINTS,
                                topk_method=method)
    jlogits, jbox_sel, jidx, jclasses = jax_post_process(
        jcls, jbox, C, max_detection_points=POINTS, topk_method=method)
    ids = cand.indices.numpy() * C + cand.classes.numpy()
    jids = np.asarray(jidx) * C + np.asarray(jclasses)
    logits = cand.logits[..., 0].to(torch.float32).numpy()
    jlogits = np.asarray(jlogits[..., 0].astype(jnp.float32))
    if ties:      # the cases really tie: equal logits among the candidates
        assert int((logits[:, 1:] == logits[:, :-1]).sum()) > 100
    np.testing.assert_array_equal(logits, jlogits)
    if method == "approx" and dtype == torch.bfloat16:
        flat_ids, flat_vals = _flat_topk(jcls)
        np.testing.assert_array_equal(ids, flat_ids)
        np.testing.assert_array_equal(logits, flat_vals)
        for row in range(ids.shape[0]):          # above the last tie
            above = logits[row] > logits[row, -1]
            assert set(ids[row][above]) == set(jids[row][above])
        return
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(cand.box_codes.to(torch.float32).numpy(),
                                  np.asarray(jbox_sel.astype(jnp.float32)))


def _detect(anchors, method, dtype, ties, ood_method, soft_nms, img_info,
            seed=1):
    (cls, box), (jcls, jbox) = _outputs(anchors, seed, dtype, ties)
    info = dict(img_scale=np.array([[1.5], [0.75]], np.float32),
                img_size=np.array([[150.0, 180.0], [90.0, 60.0]],
                                  np.float32)) if img_info else {}
    dets, ood = pp.generate_detections(
        cls, box, anchors[0], C, max_detection_points=POINTS,
        soft_nms=soft_nms, ood_method=ood_method, topk_method=method,
        **{k: torch.from_numpy(v) for k, v in info.items()})
    jinfo = {k: jnp.asarray(v) for k, v in info.items()}
    if method == "approx" and dtype == torch.bfloat16:
        # JAX's pipeline on the lax.top_k candidates (see the docstring)
        ids, _ = _flat_topk(jcls)
        idx, classes = jnp.asarray(ids // C), jnp.asarray(ids % C)
        cls_all = jnp.concatenate([c.reshape(2, -1) for c in jcls], axis=1)
        box_all = jnp.concatenate([b.reshape(2, -1, 4) for b in jbox], axis=1)
        jdets, keep = jax_batch_detection(
            jnp.take_along_axis(cls_all, jnp.asarray(ids), axis=1)[..., None],
            jnp.take_along_axis(box_all, idx[..., None], axis=1), None, idx,
            classes, soft_nms=soft_nms, has_img_info=bool(info),
            nms_impl="xla", anchors_sel=anchors[1].boxes_for_indices(idx),
            **jinfo)
        jood = None
        if ood_method is not None:
            ood_all = jax_anchor_ood_reduce(jcls, C, ood_method)
            jood = jax_gather_survivor_scores(ood_all, keep, idx)
    else:
        jdets, jood = jax_generate_detections(
            jcls, jbox, jnp.asarray(anchors[1].boxes), C,
            max_detection_points=POINTS, soft_nms=soft_nms,
            ood_method=ood_method, topk_method=method, nms_impl="xla",
            anchors=anchors[1], **jinfo)
    return dets.numpy(), ood, np.asarray(jdets), jood


@pytest.mark.parametrize("method", ["exact", "approx"])
@pytest.mark.parametrize("ood_method,soft_nms,img_info", [
    ("energy", False, True), ("max_logit", True, False),
    ("msp", False, False), (None, True, True)])
@pytest.mark.parametrize("dtype,ties", CASES[:2] + CASES[3:], ids=[
    IDS[0], IDS[1], IDS[3]])
def test_detections_match_jax(anchors, method, dtype, ties, ood_method,
                              soft_nms, img_info):
    dets, ood, jdets, jood = _detect(anchors, method, dtype, ties,
                                     ood_method, soft_nms, img_info)
    assert (dets[..., 4] > 0).sum() > 20           # real detections
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_array_equal(dets[..., 4] > 0, jdets[..., 4] > 0)
    np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-4)
    if ood_method is None:
        assert ood is None and jood is None
    else:
        np.testing.assert_allclose(ood.numpy(), np.asarray(jood), rtol=1e-5,
                                   atol=1e-6)


def test_exact_keeps_every_class_of_a_hot_anchor(anchors):
    """One anchor with every class hot: stage 2 keeps all its pairs
    (the JAX package's test_exact_topk_two_stage_dense_anchor), on both
    sides."""
    (cls, box), (jcls, jbox) = _outputs(anchors, 2, torch.float32, False)
    cls[0][0, 2, 2, :C] = torch.linspace(20.0, 11.1, C)
    cls[1][0, 1, 1, 2] = 19.95
    jcls[0] = jnp.asarray(cls[0].numpy())
    jcls[1] = jnp.asarray(cls[1].numpy())
    cand = pp.select_candidates(cls, box, anchors[0], C, C + 1,
                                topk_method="exact")
    _, _, jidx, jclasses = jax_post_process(
        jcls, jbox, C, max_detection_points=C + 1, topk_method="exact")
    np.testing.assert_array_equal(cand.indices.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(cand.classes.numpy(), np.asarray(jclasses))
    hot = cand.indices[0] == int(cand.indices[0, 0])
    assert set(cand.classes[0][hot].tolist()) == set(range(C))


def test_exact_k_beyond_the_anchors(anchors):
    """k above the anchor count: stage 1 keeps every anchor and the values
    are the flat top-k's (values only: jax's top-k at k = row length
    orders ties in no fixed order)."""
    (cls, box), (jcls, jbox) = _outputs(anchors, 3, torch.float32, False)
    k = anchors[0].total_anchors + 50
    cand = pp.select_candidates(cls, box, anchors[0], C, k,
                                topk_method="exact")
    flat = torch.cat([c.reshape(2, -1) for c in cls], dim=1)
    want = torch.sort(flat, dim=1, descending=True).values[:, :k]
    np.testing.assert_array_equal(cand.logits[..., 0].numpy(), want.numpy())


def test_the_selections_agree_on_unambiguous_objects(anchors):
    """Objects whose second class lies under the score floor: exact, approx
    and per_anchor give the same detections, on both sides (the JAX
    package's test_unambiguous_objects_all_methods_identical)."""
    rng = np.random.default_rng(4)
    prior = float(np.log(0.01 / 0.99))
    cls = [(prior - 1.0 + 0.15 * rng.standard_normal((1, h, w, 9 * C)))
           .astype(np.float32) for h, w in anchors[0].feat_sizes[3:8]]
    box = [(0.02 * rng.standard_normal((1, h, w, 36))).astype(np.float32)
           for h, w in anchors[0].feat_sizes[3:8]]
    for i, (y, x) in enumerate([(1, 1), (1, 6), (6, 1), (6, 6)]):
        cls[1][0, y, x, 4 * C + 7 * i] = 2.0 + 0.1 * i
    rows = {}
    for method in ("exact", "approx", "per_anchor"):
        dets, _ = pp.generate_detections(to_torch(cls), to_torch(box),
                                         anchors[0], C, topk_method=method)
        jdets, _ = jax_generate_detections(
            [jnp.asarray(c) for c in cls], [jnp.asarray(b) for b in box],
            jnp.asarray(anchors[1].boxes), C, topk_method=method,
            nms_impl="xla", anchors=anchors[1])
        d = dets.numpy()[0]
        kept = d[d[:, 4] > 0.01]
        np.testing.assert_allclose(d, np.asarray(jdets)[0], rtol=1e-4,
                                   atol=1e-4)
        rows[method] = {tuple(np.round(r, 3)) for r in kept}
    assert len(rows["exact"]) == 4
    assert rows["exact"] == rows["approx"] == rows["per_anchor"]


def test_unknown_topk_method_raises(anchors):
    (cls, box), _ = _outputs(anchors, 0, torch.float32, False)
    with pytest.raises(ValueError, match="unknown topk_method"):
        pp.generate_detections(cls, box, anchors[0], C, topk_method="flat")
