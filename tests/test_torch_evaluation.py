"""The port's evaluation package (host numpy, copied) vs the JAX package's
on the same detections: every evaluator's metrics equal to 1e-12, the
metric functions and mask ops equal, COCO AP against the pycocotools
transcription ``tests/cocoeval_oracle.py`` to 1e-9 on both the native
core and the numpy path. The port's evaluators also take torch tensors,
never build the native core, and refuse a merge across processes."""
import ast
import os
import pathlib

import numpy as np
import pytest
import torch

from cocoeval_oracle import cocoeval_stats
from ood_object_detection_tpu import evaluation as jev
from ood_object_detection_tpu.evaluation import masks as jmasks
from ood_object_detection_tpu_torch import evaluation as ev
from ood_object_detection_tpu_torch.evaluation import coco_eval, masks, native

TOL = 1e-12


def _assert_metrics_equal(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k], float),
                                   np.asarray(want[k], float), rtol=0,
                                   atol=tol, err_msg=k)


def _scenes(seed, n_images=8, num_classes=4, p_difficult=0.0, p_group=0.0,
            max_det=12):
    """Per image: [max_det, 6] xyxy + score + 1-based class detections
    (padding rows score 0) and yxyx ground truth padded to 10 rows, with
    difficult / group-of flags."""
    rng = np.random.default_rng(seed)
    dets = np.zeros((n_images, max_det, 6), np.float32)
    bbox = np.full((n_images, 10, 4), -1.0, np.float32)
    cls = np.full((n_images, 10), -1, np.int32)
    diff = np.zeros((n_images, 10), np.int32)
    group = np.zeros((n_images, 10), np.int32)
    for i in range(n_images):
        ng = int(rng.integers(1, 7))
        yx = rng.uniform(0, 80, (ng, 2))
        gt = np.concatenate([yx, yx + rng.uniform(5, 40, (ng, 2))], 1)
        bbox[i, :ng] = gt
        cls[i, :ng] = rng.integers(1, num_classes + 1, ng)
        diff[i, :ng] = rng.uniform(size=ng) < p_difficult
        group[i, :ng] = (rng.uniform(size=ng) < p_group) & ~diff[i, :ng]
        nd = int(rng.integers(0, max_det + 1))
        base = gt[rng.integers(0, ng, nd)][:, [1, 0, 3, 2]]
        box = np.where(rng.uniform(size=(nd, 1)) < 0.6,
                       base + rng.normal(0, 6, (nd, 4)),
                       rng.uniform(0, 120, (nd, 4)))
        box[:, 2:] = np.maximum(box[:, 2:], box[:, :2] + 1)
        dets[i, :nd, :4] = box
        dets[i, :nd, 4] = rng.uniform(0.05, 1.0, nd)
        dets[i, :nd, 5] = rng.integers(1, num_classes + 1, nd)
    target = dict(bbox=bbox, cls=cls, img_id=np.arange(n_images),
                  difficult=diff, group_of=group)
    return dets, target


EVALUATORS = [
    ("pascal", {}, {}), ("weighted_pascal", {}, {}),
    ("precision_at_recall", dict(recall_lower_bound=0.2,
                                 recall_upper_bound=0.8), {}),
    ("openimages", {}, dict(p_group=0.5)),
    ("openimages", dict(group_of_weight=0.3), dict(p_group=0.5)),
    ("pascal", {}, dict(p_difficult=0.4)),
    ("coco", {}, {}), ("coco", dict(max_dets=3), {}),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name,kwargs,scene", EVALUATORS,
                         ids=[f"{n}-{i}" for i, (n, _, _) in
                              enumerate(EVALUATORS)])
def test_evaluators_match_jax(name, kwargs, scene, seed):
    """The same batches through the JAX evaluator (numpy) and the port's
    (torch tensors, through the async thread), two batches of 4."""
    dets, target = _scenes(seed, **scene)
    ours = ev.create_evaluator(name, 4, **kwargs)
    ref = jev.create_evaluator(name, 4, **kwargs)
    for sl in (slice(0, 4), slice(4, 8)):
        tgt = {k: v[sl] for k, v in target.items()}
        ours.add_predictions_async(torch.from_numpy(dets[sl]),
                                   {k: torch.from_numpy(np.asarray(v))
                                    for k, v in tgt.items()})
        ref.add_predictions(dets[sl], tgt)
    ours.drain()
    got, want = ours.evaluate(), ref.evaluate()
    _assert_metrics_equal(got, want)
    if name.endswith("pascal"):     # the episodic class filter
        _assert_metrics_equal(ours.evaluate(task_categories=[1, 3]),
                              ref.evaluate(task_categories=[1, 3]))


@pytest.mark.parametrize("kwargs", [
    {}, dict(use_weighted_mean_ap=True), dict(group_of_weight=0.3),
    dict(recall_lower_bound=0.1, recall_upper_bound=0.7)])
def test_object_detection_evaluation_matches_jax(kwargs):
    dets, target = _scenes(5, p_difficult=0.2, p_group=0.3)
    ours = ev.ObjectDetectionEvaluation(4, label_id_offset=1, **kwargs)
    ref = jev.ObjectDetectionEvaluation(4, label_id_offset=1, **kwargs)
    for core in (ours, ref):
        for i in range(len(dets)):
            valid = target["cls"][i] > 0
            core.add_single_ground_truth_image_info(
                i, target["bbox"][i][valid], target["cls"][i][valid],
                gt_is_difficult=target["difficult"][i][valid].astype(bool),
                gt_is_group_of=target["group_of"][i][valid].astype(bool))
            d = dets[i][dets[i][:, 4] > 0]
            core.add_single_detected_image_info(
                i, d[:, [1, 0, 3, 2]], d[:, 4], d[:, 5].astype(int))
    got, want = ours.evaluate(), ref.evaluate()
    _assert_metrics_equal({k: got[k] for k in ("mean_ap", "mean_corloc")},
                          {k: want[k] for k in ("mean_ap", "mean_corloc")})
    for k in ("per_class_ap", "per_class_corloc"):
        np.testing.assert_array_equal(np.nan_to_num(got[k]),
                                      np.nan_to_num(want[k]))


def test_metric_functions_match_jax():
    rng = np.random.default_rng(7)
    scores = np.round(rng.uniform(size=200), 2)      # tied scores too
    labels = (rng.uniform(size=200) < 0.4).astype(float)
    p, r = ev.compute_precision_recall(scores, labels, num_gt=90)
    jp, jr = jev.compute_precision_recall(scores, labels, num_gt=90)
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(r, jr)
    assert ev.compute_average_precision(p, r) == \
        jev.compute_average_precision(jp, jr)
    np.testing.assert_array_equal(
        ev.compute_cor_loc(np.array([3, 0, 5]), np.array([2, 0, 5])),
        jev.compute_cor_loc(np.array([3, 0, 5]), np.array([2, 0, 5])))
    known, unknown = rng.normal(1, 1, 300), rng.normal(0, 1, 200)
    assert ev.auroc(known, unknown) == jev.auroc(known, unknown)
    assert ev.fpr_at_tpr(known, unknown, 0.95) == \
        jev.fpr_at_tpr(known, unknown, 0.95)


def test_ood_evaluator_matches_jax():
    rng = np.random.default_rng(8)
    ours, ref = ev.OodEvaluator(), jev.OodEvaluator()
    for _ in range(3):
        s = rng.normal(size=50)
        known = rng.uniform(size=50) < 0.5
        ours.add_predictions(torch.from_numpy(s),
                             {"is_known": torch.from_numpy(known)})
        ref.add_predictions(s, {"is_known": known})
    _assert_metrics_equal(ours.evaluate(), ref.evaluate())


def _coco_images(rng, n_images, n_classes, crowd_prob=0.3):
    images = []
    for _ in range(n_images):
        n_gt, n_dt = int(rng.integers(0, 8)), int(rng.integers(0, 14))
        gxy, gwh = rng.uniform(0, 400, (n_gt, 2)), rng.uniform(4, 180, (n_gt, 2))
        dxy, dwh = rng.uniform(0, 400, (n_dt, 2)), rng.uniform(4, 180, (n_dt, 2))
        for i in range(min(n_dt, n_gt)):
            if rng.uniform() < 0.6:
                dxy[i] = gxy[i] + rng.normal(0, 6, 2)
                dwh[i] = gwh[i] * rng.uniform(0.75, 1.3, 2)
        images.append(dict(
            det_boxes=np.concatenate([dxy, dxy + dwh], 1),
            det_scores=rng.uniform(0.05, 1.0, n_dt),
            det_classes=rng.integers(1, n_classes + 1, n_dt),
            gt_boxes=np.concatenate([gxy, gxy + gwh], 1),
            gt_classes=rng.integers(1, n_classes + 1, n_gt),
            gt_crowd=rng.uniform(size=n_gt) < crowd_prob))
    return images


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "numpy"])
@pytest.mark.parametrize("seed", [0, 1])
def test_coco_mean_ap_matches_oracle_and_jax(use_native, seed, monkeypatch):
    """CocoMeanAP == the image-major COCOeval transcription to 1e-9, and
    == the JAX package's CocoMeanAP to 1e-12, on crowd-heavy random
    fixtures, on the native matcher and the numpy one."""
    if use_native:
        assert native.available(), "the committed libevalcore.so loads"
    else:
        monkeypatch.setattr(native, "available", lambda: False)
        monkeypatch.setattr(jev.native, "available", lambda: False)
    images = _coco_images(np.random.default_rng(seed), 6, 3)
    ours = ev.CocoMeanAP(num_classes=3)
    ref = jev.CocoMeanAP(num_classes=3)
    for key, im in enumerate(images):
        args = [np.asarray(im[k], dt) for k, dt in (
            ("det_boxes", np.float32), ("det_scores", np.float32),
            ("det_classes", np.int32), ("gt_boxes", np.float32),
            ("gt_classes", np.int32), ("gt_crowd", bool))]
        ours.add_image(key, *args)
        ref.add_image(key, *args)
    got = ours.stats()
    _assert_metrics_equal(got, ref.stats())
    oracle = cocoeval_stats(images, num_classes=3)
    for k, v in oracle.items():
        assert got[k] == pytest.approx(v, abs=1e-9), k


def test_native_core_matches_jax():
    rng = np.random.default_rng(9)
    a = rng.uniform(0, 50, (20, 4)).astype(np.float32)
    a[:, 2:] += a[:, :2] + 1
    b = a[:7] + rng.normal(0, 2, (7, 4)).astype(np.float32)
    np.testing.assert_array_equal(native.iou_matrix(a, b),
                                  jev.native.iou_matrix(a, b))
    s = rng.uniform(size=20).astype(np.float32)
    np.testing.assert_array_equal(native.hard_nms(a, s, 0.5, 10),
                                  jev.native.hard_nms(a, s, 0.5, 10))


def test_native_never_builds(tmp_path, monkeypatch):
    """A missing library makes the core unavailable: nothing runs make or
    writes next to the library, and COCO AP takes the numpy path."""
    import subprocess

    missing = tmp_path / "csrc" / "libevalcore.so"
    missing.parent.mkdir()
    monkeypatch.setattr(native, "_LIB_PATH", str(missing))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)

    def refuse(*args, **kwargs):
        raise AssertionError(f"a process was started: {args}")

    for name in ("run", "Popen", "call", "check_call"):
        monkeypatch.setattr(subprocess, name, refuse)
    monkeypatch.setattr(os, "system", refuse)
    assert not native.available()
    assert list(tmp_path.rglob("*")) == [missing.parent]
    stats = coco_eval.CocoMeanAP(num_classes=1)
    stats.add_image(0, np.array([[0, 0, 10, 10]], np.float32),
                    np.array([0.9], np.float32), np.array([1], np.int32),
                    np.array([[0, 0, 10, 10]], np.float32),
                    np.array([1], np.int32))
    assert stats.stats()["map"] == pytest.approx(1.0)
    # and the module has no way to start one
    tree = ast.parse(pathlib.Path(native.__file__).read_text())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom)}
    assert not imported & {"subprocess", "os.system", "shutil"}


def test_merge_across_processes_is_refused(monkeypatch):
    """distributed=True at world size 1 merges nothing; in a group of more
    than one process the merge raises (not ported yet)."""
    import torch.distributed as dist

    dets, target = _scenes(3, n_images=2)
    one = ev.PascalEvaluator(4, distributed=True)
    one.add_predictions(dets, target)
    ref = jev.PascalEvaluator(4)
    ref.add_predictions(dets, target)
    _assert_metrics_equal(one.evaluate(), ref.evaluate())
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    with pytest.raises(RuntimeError, match="torchrun"):
        ev.PascalEvaluator(4, distributed=True).add_predictions(dets, target)


def _random_masks(n, seed, h=24, w=32):
    rng = np.random.default_rng(seed)
    out = np.zeros((n, h, w), np.uint8)
    for i in range(n):
        y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
        y1, x1 = rng.integers(y0 + 2, h), rng.integers(x0 + 2, w)
        out[i, y0:y1, x0:x1] = 1
        if rng.random() < 0.5:
            out[i, (y0 + y1) // 2, x0:x1] = 0
    return out


def test_masks_match_jax():
    m1, m2 = _random_masks(6, 0), _random_masks(4, 1)
    for fn in ("mask_area",):
        np.testing.assert_array_equal(getattr(masks, fn)(m1),
                                      getattr(jmasks, fn)(m1))
    for fn in ("mask_intersection", "mask_iou", "mask_ioa"):
        np.testing.assert_array_equal(getattr(masks, fn)(m1, m2),
                                      getattr(jmasks, fn)(m1, m2))
    scores = np.random.default_rng(2).uniform(size=(6, 3)).astype(np.float32)
    np.testing.assert_array_equal(masks.mask_nms(m1, scores[:, 0], 0.3, 4),
                                  jmasks.mask_nms(m1, scores[:, 0], 0.3, 4))
    for got, want in zip(masks.multiclass_mask_nms(m1, scores, 0.2, 0.3, 4),
                         jmasks.multiclass_mask_nms(m1, scores, 0.2, 0.3, 4)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(masks.prune_non_overlapping_masks(m1, m2, 0.5),
                         jmasks.prune_non_overlapping_masks(m1, m2, 0.5)):
        np.testing.assert_array_equal(got, want)
    boxes = np.array([[2.0, 3.0, 10.0, 20.0], [0.0, 0.0, 5.5, 4.2]])
    np.testing.assert_array_equal(masks.boxes_to_masks(boxes, 24, 32),
                                  jmasks.boxes_to_masks(boxes, 24, 32))
