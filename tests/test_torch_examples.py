"""The port's two examples, ``examples/open_set_demo.py`` and
``examples/selection_quality.py``, on the CPU at 128 px with D0's full
width.

- A 2-step smoke of each with ``--device cpu``: the JSON lines parse, the
  AUROC / FPR95 and mAPs are finite (the detection-level AUROC may be the
  JAX script's ``None`` with its note), ``--out`` holds the result line,
  ``--save-outs`` then ``--load-outs`` give the same result.
- The inputs both scripts build: the synthetic datasets give the JAX
  package's images and boxes for the same seed, and the training batches
  with the unknown classes dropped collate to the JAX package's (emptied
  rows padded with class -1).
- ``selection_quality``'s three selections on one set of weights: JAX
  variables filled from numpy (tests/torch_parity_helpers.py, running
  statistics calibrated on 8 training images as in
  tests/torch_meta_helpers.py) carried into the port by
  ``utils/from_jax.load_jax_variables``, one val batch of the script's
  held-out set. Each package's own forward gives head outputs within rtol
  1e-4 / atol 5e-4 (measured up to 1.1e-4 apart: f32 rounding through the
  calibrated trunk), which reorders about 200 of the 12,000 candidates
  whose logits lie that close, so the selections are held on the port's
  head outputs given to both packages: the candidates' (anchor, class)
  ids bit-equal to JAX's ``post_process``, and the detections' classes
  bit-equal, scores to rtol 1e-5 and boxes to rtol 1e-5 / atol 1e-4
  (tests/test_torch_post_process.py's tolerances) against JAX's
  ``generate_detections`` with each ``topk_method``. In f32 jax's CPU
  ``approx_max_k`` is exact with ties lowest index first, so the port's
  ``approx`` is held to it directly (on bf16 it is held to ``lax.top_k``,
  tests/test_torch_selection.py). ``max_detection_points`` is 3000 of the
  3069 anchors at 128 px: jax's CPU top-k is unstable at k = row length.
- ``open_set_demo``'s GT-region energies (each ground-truth row's
  best-IoU anchor's energy) against the JAX script's computation: on the
  port's class logits to rtol 1e-5 / atol 1e-5 with the valid rows
  equal, and from each package's own forward within the heads' gap.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_meta_helpers import calibrate_batch_stats
from torch_parity_helpers import random_variables

from ood_object_detection_tpu.config import get_efficientdet_config as jax_cfg
from ood_object_detection_tpu.data import (
    SyntheticDetectionDataset as JaxSynthetic,
    collate_batch as jax_collate,
    normalize_uint8 as jax_normalize,
)
from ood_object_detection_tpu.models.efficientdet import EfficientDet as JaxDet
from ood_object_detection_tpu.ops.anchors import Anchors as JaxAnchors
from ood_object_detection_tpu.ops.boxes import \
    pairwise_iou_yxyx as jax_pairwise_iou
from ood_object_detection_tpu.ops.post_process import (
    _per_anchor_reduce as jax_per_anchor_reduce,
    generate_detections as jax_generate_detections,
    post_process as jax_post_process,
)
from ood_object_detection_tpu_torch.config import get_efficientdet_config
from ood_object_detection_tpu_torch.data import (SyntheticDetectionDataset,
                                                 collate_batch,
                                                 normalize_uint8)
from ood_object_detection_tpu_torch.examples import (open_set_demo,
                                                     selection_quality)
from ood_object_detection_tpu_torch.models.efficientdet import EfficientDet
from ood_object_detection_tpu_torch.ops.anchors import Anchors
from ood_object_detection_tpu_torch.utils.from_jax import load_jax_variables

# the module (the package's ``post_process`` is the function)
pp = importlib.import_module(
    "ood_object_detection_tpu_torch.ops.post_process")

IMG = 128
SMOKE = ["--device", "cpu", "--steps", "2", "--image-size", str(IMG)]
BATCH = 4           # val images of the shared-weights comparison


def _json_lines(text):
    return [json.loads(line) for line in text.strip().splitlines()]


def test_open_set_demo_smoke(capsys):
    result = open_set_demo.main(SMOKE)
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"phase": "train", "steps": 2}
    assert [line["set"] for line in lines[1:3]] == ["known", "unknown"]
    for line in lines[1:3]:
        assert line["gt_instances"] > 0
        assert np.isfinite(line["mean_gt_energy"])
    assert lines[-1] == result
    assert np.isfinite(result["auroc_gt_regions"])
    assert np.isfinite(result["fpr95_gt_regions"])
    if result["auroc_detections"] is None:
        assert "no detections" in result["note"]
    else:
        assert np.isfinite(result["auroc_detections"])


def test_selection_quality_smoke(capsys, tmp_path):
    out, outs = tmp_path / "result.json", tmp_path / "outs.npz"
    argv = SMOKE + ["--val-images", "32", "--out", str(out)]
    result = selection_quality.main(argv + ["--save-outs", str(outs)])
    lines = _json_lines(capsys.readouterr().out)
    assert [line.get("phase") for line in lines[:4]] == [
        "train", "train_done", "forward_done", "outs_saved"]
    assert [line["method"] for line in lines if line.get("phase") == "eval"
            ] == ["exact", "approx", "per_anchor"]
    assert lines[-1] == {"selection_quality": result, "val_images": 32,
                         "steps": 2}
    assert _json_lines(out.read_text()) == [lines[-1]]
    for method, metrics in result.items():
        for key in ("pascal_map50", "coco_map", "coco_map50"):
            assert np.isfinite(metrics[key]), (method, key)
    for method in ("approx", "per_anchor"):
        assert 0.0 <= result[method]["overlap_vs_exact"] <= 1.0
    assert result["exact"]["delta_coco_map_vs_exact"] == 0.0

    loaded = selection_quality.main(
        ["--device", "cpu", "--image-size", str(IMG), "--val-images", "32",
         "--load-outs", str(outs)])
    lines = _json_lines(capsys.readouterr().out)
    assert lines[0] == {"phase": "eval", "method": "exact"}
    assert loaded == result


@pytest.mark.parametrize("seed", [0, 7, 101])
def test_synthetic_dataset_equals_jax(seed):
    ours = SyntheticDetectionDataset(num_images=8, image_size=(IMG, IMG),
                                     num_classes=6, seed=seed)
    want = JaxSynthetic(num_images=8, image_size=(IMG, IMG), num_classes=6,
                        seed=seed)
    for i in range(8):
        (img, anno), (jimg, janno) = ours[i], want[i]
        np.testing.assert_array_equal(img, jimg)
        for key in ("bbox", "cls"):
            np.testing.assert_array_equal(anno[key], janno[key])


def test_known_class_batches_collate_as_jax():
    """open_set_demo's training batches: unknown-class rows dropped, then
    collated; an image left with no rows pads to class -1 throughout."""
    total, known = 6, [1, 2, 3, 4]
    ours = SyntheticDetectionDataset(num_images=64, image_size=(IMG, IMG),
                                     num_classes=total, seed=0)
    want = JaxSynthetic(num_images=64, image_size=(IMG, IMG),
                        num_classes=total, seed=0)
    idx = list(range(64))
    batch = collate_batch(open_set_demo._known_only(
        [ours[i] for i in idx], known))
    samples = [want[i] for i in idx]
    for _, anno in samples:                  # the JAX script's loop
        keep = np.isin(anno["cls"], known)
        anno["bbox"], anno["cls"] = anno["bbox"][keep], anno["cls"][keep]
    jbatch = jax_collate(samples)
    for key in ("image", "bbox", "cls"):
        np.testing.assert_array_equal(batch[key], jbatch[key])
    assert (batch["cls"] <= 4).all()
    emptied = (batch["cls"] == -1).all(axis=1)
    assert emptied.any()                     # the case the padding is for
    assert (batch["bbox"][emptied] == -1).all()


@pytest.fixture(scope="module")
def shared():
    """D0 at 128 px, 6 classes, f32 (the scripts' dtype): JAX variables
    from numpy, a port model carrying them, one val batch of
    selection_quality's held-out set (seed 101), and both packages'
    head outputs on it."""
    overrides = dict(num_classes=6, image_size=(IMG, IMG),
                     max_detection_points=3000)
    cfg = get_efficientdet_config("efficientdet_d0", **overrides)
    jcfg = jax_cfg("efficientdet_d0", **overrides)
    variables = random_variables(
        lambda k: JaxDet(jcfg).init(k, jnp.zeros((1, IMG, IMG, 3)), False),
        0)
    # running statistics of training images: with random ones the trunk
    # barely depends on the image (tests/torch_meta_helpers.py)
    calib = JaxSynthetic(num_images=8, image_size=(IMG, IMG), num_classes=6,
                         seed=0)
    variables = calibrate_batch_stats(JaxDet(jcfg), variables, jax_normalize(
        jax_collate([calib[i] for i in range(8)])["image"]))
    model = EfficientDet(cfg)
    load_jax_variables(model, variables)
    model = model.to(memory_format=torch.channels_last).eval()
    val = SyntheticDetectionDataset(num_images=BATCH, image_size=(IMG, IMG),
                                    num_classes=6, seed=101)
    batch = collate_batch([val[i] for i in range(BATCH)])
    x = normalize_uint8(torch.from_numpy(batch["image"]))
    jx = jax_normalize(batch["image"])
    with torch.no_grad():
        cls_out, box_out = model(x)
    jheads = jax.jit(lambda v, im: JaxDet(jcfg).apply(v, im, False))
    jcls, jbox = jheads(variables, jx)
    return dict(cfg=cfg, jcfg=jcfg, variables=variables, model=model,
                batch=batch, x=x, jx=jx, cls=cls_out, box=box_out,
                jcls=list(jcls), jbox=list(jbox),
                anchors=Anchors.from_config(cfg),
                janchors=JaxAnchors.from_config(jcfg))


def test_heads_match_jax_on_shared_weights(shared):
    """Each package's own forward on the shared weights and val batch."""
    for got, want in zip(shared["cls"] + shared["box"],
                         shared["jcls"] + shared["jbox"]):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=5e-4)


@pytest.mark.parametrize("method", selection_quality.METHODS)
def test_selections_match_jax_on_shared_weights(shared, method):
    """The port's head outputs through both packages' selections."""
    cfg, jcfg = shared["cfg"], shared["jcfg"]
    c = cfg.num_classes
    jcls_in = [jnp.asarray(t.numpy()) for t in shared["cls"]]
    jbox_in = [jnp.asarray(t.numpy()) for t in shared["box"]]
    _, _, idx, cls = pp.post_process(shared["cls"], shared["box"], c,
                                     cfg.max_detection_points,
                                     topk_method=method)
    _, _, jidx, jcls = jax_post_process(jcls_in, jbox_in, c,
                                        jcfg.max_detection_points,
                                        topk_method=method)
    np.testing.assert_array_equal(idx.numpy() * c + cls.numpy(),
                                  np.asarray(jidx) * c + np.asarray(jcls))

    dets = selection_quality.detect(shared["cls"], shared["box"], cfg,
                                    shared["anchors"], method).numpy()
    janchors = shared["janchors"]
    jdets, _ = jax.jit(lambda cl, bx: jax_generate_detections(
        cl, bx, jnp.asarray(janchors.boxes), num_classes=c,
        max_detection_points=jcfg.max_detection_points,
        max_det_per_image=jcfg.max_det_per_image, soft_nms=jcfg.soft_nms,
        topk_method=method, topk_recall=jcfg.topk_recall,
        anchors=janchors))(jcls_in, jbox_in)
    jdets = np.asarray(jdets)
    assert (dets[..., 4] > 0).sum() > 20 * BATCH        # real detections
    np.testing.assert_array_equal(dets[..., 5], jdets[..., 5])
    np.testing.assert_array_equal(dets[..., 4] > 0, jdets[..., 4] > 0)
    np.testing.assert_allclose(dets[..., 4], jdets[..., 4], rtol=1e-5)
    np.testing.assert_allclose(dets[..., :4], jdets[..., :4], rtol=1e-5,
                               atol=1e-4)


def _jax_gt_region_energies(jcfg, anchor_boxes):
    """The JAX script's GT-region energies, from the class logits on."""

    @jax.jit
    def run(cls_out, bbox, cls):
        _, _, ood_all = jax_per_anchor_reduce(cls_out, jcfg.num_classes,
                                              ood_method="energy")

        def one(ood_row, boxes, classes):
            iou = jax_pairwise_iou(boxes, anchor_boxes)
            return ood_row[jnp.argmax(iou, axis=1)], classes > 0

        return jax.vmap(one)(ood_all, bbox, cls)
    return run


def test_gt_region_energies_match_jax(shared):
    """On the port's class logits: rtol 1e-5 / atol 1e-5, the valid rows
    and the anchors picked equal; from each package's own forward, the
    energies within the heads' gap (rtol 1e-4 / atol 5e-4)."""
    cfg, batch = shared["cfg"], shared["batch"]
    energy, valid = open_set_demo.gt_region_energies(
        shared["cls"], torch.from_numpy(batch["bbox"]),
        torch.from_numpy(batch["cls"]),
        torch.from_numpy(shared["anchors"].boxes), cfg.num_classes)
    run = _jax_gt_region_energies(shared["jcfg"],
                                  jnp.asarray(shared["janchors"].boxes))
    bbox, cls = jnp.asarray(batch["bbox"]), jnp.asarray(batch["cls"])
    je, jvalid = run([jnp.asarray(t.numpy()) for t in shared["cls"]], bbox,
                     cls)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert valid.sum() >= BATCH
    np.testing.assert_allclose(energy.numpy(), np.asarray(je), rtol=1e-5,
                               atol=1e-5)
    own, _ = run(shared["jcls"], bbox, cls)
    np.testing.assert_allclose(energy.numpy(), np.asarray(own), rtol=1e-4,
                               atol=5e-4)
