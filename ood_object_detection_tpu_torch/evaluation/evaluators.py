"""Copy of ``ood_object_detection_tpu.evaluation.evaluators``, taking torch
tensors as well as numpy arrays; the cross-process merge waits for the
port's data parallelism (ROADMAP Queue 1 item 7) and raises.

User-facing evaluators binding predictions to the metric cores.

Equivalents of the reference evaluator wrappers (effdet/evaluator.py:32-184):
accept fixed-shape [B, max_det, 6] detection tensors ([xmin, ymin, xmax,
ymax, score, class], padding score 0), accumulate on host, and compute
PASCAL AP/CorLoc (with the custom per-episode ``evaluate(task_categories,
batch_cats)`` filter, detection_evaluator.py:268-305) or COCO mAP. Eval
can run on a background thread so the device never waits (the reference
runs its numpy evaluator synchronously every step, pretrain.py:244-251 —
a known throughput sink).
"""
from __future__ import annotations

import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, List, Optional, Sequence

import numpy as np

from .coco_eval import CocoMeanAP
from .metrics import auroc, fpr_at_tpr
from .object_detection_evaluation import ObjectDetectionEvaluation


def _to_numpy(x):
    if hasattr(x, "detach"):                 # a torch tensor, on any device
        return x.detach().cpu().numpy()
    return np.asarray(x)


class Evaluator:
    """Base: accumulate (detections, targets); evaluate() -> metrics dict.

    With ``distributed=True`` and a ``torch.distributed`` group of more
    than one process, ``add_predictions`` raises: the merge across
    processes (the reference's all_gather_container,
    effdet/evaluator.py:36-39) is not ported yet. Single-process runs merge
    nothing."""

    def __init__(self, distributed: bool = False):
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._tls = threading.local()
        self.distributed = distributed

    def _maybe_merge(self, detections, target: Dict):
        if getattr(self._tls, "pre_merged", False):
            # already merged on the submitting thread (see
            # add_predictions_async) — merging again would duplicate rows
            return detections, target
        if not self.distributed:
            return detections, target
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()
                and dist.get_world_size() > 1):
            return detections, target
        raise NotImplementedError(
            "merging detections across processes is not ported yet "
            "(ROADMAP Queue 1 item 7, data parallelism)")

    def add_predictions(self, detections, target: Dict):
        raise NotImplementedError

    def evaluate(self, **kwargs) -> Dict:
        raise NotImplementedError

    def add_predictions_async(self, detections, target: Dict) -> Future:
        """Accumulate off-thread so the train loop never blocks on numpy.

        Multihost: the cross-process merge is a host COLLECTIVE, and every
        rank must run its collectives in identical program order — so
        the merge runs here, on the submitting (main) thread, and only
        the collective-free numpy accumulation goes to the pool. (Merging
        on the pool thread raced the pretrain CLI's val-loss process_merge:
        gloo pairs rank A's detection allgather with rank B's loss merge
        and dies with a payload-size mismatch.)"""
        if self._pool is None:
            self._pool = ThreadPoolExecutor(max_workers=1)
        det_np = _to_numpy(detections)
        tgt_np = {k: _to_numpy(v) for k, v in target.items()}
        det_np, tgt_np = self._maybe_merge(det_np, tgt_np)

        def run(det, tgt):
            self._tls.pre_merged = True   # pool-thread-local: the sync
            try:                          # path on other threads still
                self.add_predictions(det, tgt)  # merges normally
            finally:
                self._tls.pre_merged = False

        return self._pool.submit(run, det_np, tgt_np)

    def drain(self):
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None


class PascalEvaluator(Evaluator):
    """PASCAL-style per-class AP@0.5 + CorLoc (reference TfmEvaluator/
    PascalEvaluator, evaluator.py:121-174), with episodic class filtering."""

    # extra kwargs forwarded to the ObjectDetectionEvaluation core by the
    # metric variants below
    _core_kwargs: Dict = {}

    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5,
                 distributed: bool = False):
        super().__init__(distributed=distributed)
        self.num_classes = num_classes
        self.matching_iou_threshold = matching_iou_threshold
        self._eval = self._make_core()
        self._img_counter = 0

    def _make_core(self) -> ObjectDetectionEvaluation:
        return ObjectDetectionEvaluation(
            self.num_classes,
            matching_iou_threshold=self.matching_iou_threshold,
            label_id_offset=1,     # external labels are 1-based
            **self._core_kwargs)

    def reset(self):
        self._eval = self._make_core()
        self._img_counter = 0

    def add_predictions(self, detections, target: Dict):
        """detections: [B, max_det, 6] xyxy+score+class(1-based).
        target: {'bbox': [B, M, 4] yxyx (pad cls <= 0), 'cls': [B, M],
                 optional 'img_id': [B], optional 'difficult'/'group_of'
                 [B, M] bool}."""
        detections, target = self._maybe_merge(detections, target)
        detections = _to_numpy(detections)
        bboxes = _to_numpy(target["bbox"])
        classes = _to_numpy(target["cls"])
        img_ids = _to_numpy(target["img_id"]) if "img_id" in target else None
        difficult = _to_numpy(target["difficult"]).astype(bool) \
            if "difficult" in target else None
        group_of = _to_numpy(target["group_of"]).astype(bool) \
            if "group_of" in target else None

        for i in range(detections.shape[0]):
            key = int(img_ids[i]) if img_ids is not None else self._img_counter
            self._img_counter += 1
            valid_gt = classes[i] > 0
            gt_yxyx = bboxes[i][valid_gt]
            self._eval.add_single_ground_truth_image_info(
                key, gt_yxyx, classes[i][valid_gt],
                gt_is_difficult=difficult[i][valid_gt]
                if difficult is not None else None,
                gt_is_group_of=group_of[i][valid_gt]
                if group_of is not None else None)

            det = detections[i]
            valid_det = det[:, 4] > 0
            det = det[valid_det]
            # detections are xyxy; the matcher wants yxyx
            det_yxyx = det[:, [1, 0, 3, 2]]
            self._eval.add_single_detected_image_info(
                key, det_yxyx, det[:, 4], det[:, 5].astype(int))

    def evaluate(self, task_categories: Optional[Sequence[int]] = None,
                 batch_cats: Optional[Sequence[int]] = None) -> Dict:
        """Per-episode evaluation: restrict mean AP/CorLoc to the episode's
        categories (1-based), the custom reference signature."""
        subset = None
        cats = task_categories if task_categories is not None else batch_cats
        if cats is not None:
            subset = np.asarray(list(cats), int) - 1    # to 0-based
        res = self._eval.evaluate(class_subset=subset)
        return {
            "mAP@0.5IOU": res["mean_ap"],
            "meanCorLoc@0.5IOU": res["mean_corloc"],
            "per_class_ap": res["per_class_ap"],
            "per_class_corloc": res["per_class_corloc"],
        }


class WeightedPascalEvaluator(PascalEvaluator):
    """Weighted PASCAL: one AP over all classes' pooled detections
    (reference WeightedPascalDetectionEvaluator,
    detection_evaluator.py:329-347)."""
    _core_kwargs = dict(use_weighted_mean_ap=True)


class PrecisionAtRecallEvaluator(PascalEvaluator):
    """AP within a recall operating band (reference
    PrecisionAtRecallDetectionEvaluator, detection_evaluator.py:350-366)."""

    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5,
                 recall_lower_bound: float = 0.0,
                 recall_upper_bound: float = 1.0,
                 distributed: bool = False):
        self._core_kwargs = dict(recall_lower_bound=recall_lower_bound,
                                 recall_upper_bound=recall_upper_bound)
        super().__init__(num_classes, matching_iou_threshold,
                         distributed=distributed)


class OpenImagesEvaluator(PascalEvaluator):
    """OpenImages V2+ protocol: group-of boxes ignore matching detections
    (group_of_weight=0) or weight them (reference
    OpenImagesDetectionEvaluator, detection_evaluator.py:369-441). Pass
    per-GT flags via target['group_of']."""

    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5,
                 group_of_weight: float = 0.0, distributed: bool = False):
        self._core_kwargs = dict(group_of_weight=group_of_weight)
        super().__init__(num_classes, matching_iou_threshold,
                         distributed=distributed)


class CocoEvaluator(Evaluator):
    """COCO AP@[.5:.95] (reference CocoEvaluator, evaluator.py:88-118),
    without pycocotools."""

    def __init__(self, num_classes: int, max_dets: int = 100,
                 distributed: bool = False):
        super().__init__(distributed=distributed)
        self._eval = CocoMeanAP(num_classes, max_dets=max_dets)
        self._img_counter = 0

    def add_predictions(self, detections, target: Dict):
        detections, target = self._maybe_merge(detections, target)
        detections = _to_numpy(detections)
        bboxes = _to_numpy(target["bbox"])
        classes = _to_numpy(target["cls"])
        img_ids = _to_numpy(target["img_id"]) if "img_id" in target else None
        for i in range(detections.shape[0]):
            key = int(img_ids[i]) if img_ids is not None else self._img_counter
            self._img_counter += 1
            det = detections[i]
            valid = det[:, 4] > 0
            det = det[valid]
            gt_valid = classes[i] > 0
            gt_yxyx = bboxes[i][gt_valid]
            gt_xyxy = gt_yxyx[:, [1, 0, 3, 2]]
            self._eval.add_image(
                key, det[:, :4], det[:, 4], det[:, 5].astype(int),
                gt_xyxy, classes[i][gt_valid])

    def evaluate(self, area_breakdown: bool = True) -> Dict:
        """COCO stats: AP@[.5:.95]/.5/.75 plus the small/medium/large area
        splits (pycocotools stats[0:6] minus the recall rows)."""
        res = self._eval.evaluate()
        out = {"map": res["map"], "map50": res["map50"],
               "map75": res["map75"]}
        if area_breakdown:
            for area in ("small", "medium", "large"):
                out[f"map_{area}"] = self._eval.evaluate(area=area)["map"]
        return out


class OodEvaluator(Evaluator):
    """Open-set AUROC / FPR95 over per-detection OOD scores."""

    def __init__(self):
        super().__init__()
        self.known_scores: List[np.ndarray] = []
        self.unknown_scores: List[np.ndarray] = []

    def reset(self):
        self.known_scores = []
        self.unknown_scores = []

    def add_predictions(self, scores, target: Dict):
        """scores: [N] OOD scores; target['is_known']: [N] bool."""
        scores = _to_numpy(scores).ravel()
        is_known = _to_numpy(target["is_known"]).ravel().astype(bool)
        self.known_scores.append(scores[is_known])
        self.unknown_scores.append(scores[~is_known])

    def evaluate(self) -> Dict:
        known = np.concatenate(self.known_scores) if self.known_scores \
            else np.zeros(0)
        unknown = np.concatenate(self.unknown_scores) if self.unknown_scores \
            else np.zeros(0)
        return {
            "auroc": auroc(known, unknown),
            "fpr95": fpr_at_tpr(known, unknown, 0.95),
        }


def create_evaluator(name: str, num_classes: int, **kwargs) -> Evaluator:
    """Factory (reference create_evaluator, evaluator.py:177-184)."""
    if name in ("pascal", "pascal_voc", "tfm"):
        return PascalEvaluator(num_classes, **kwargs)
    if name in ("weighted_pascal",):
        return WeightedPascalEvaluator(num_classes, **kwargs)
    if name in ("precision_at_recall", "p@r"):
        return PrecisionAtRecallEvaluator(num_classes, **kwargs)
    if name in ("openimages", "open_images"):
        return OpenImagesEvaluator(num_classes, **kwargs)
    if name == "coco":
        return CocoEvaluator(num_classes, **kwargs)
    if name == "ood":
        return OodEvaluator()
    raise ValueError(f"unknown evaluator {name}")


def default_evaluator_name(dataset_name: str) -> str:
    """Dataset-appropriate default metric family, shared by the pretrain
    and validate CLIs so their reported metrics agree: openimages ->
    OpenImages challenge protocol, coco* -> COCO AP@[.5:.95], else PASCAL
    mAP@0.5. (The reference's in-train eval used the PASCAL/TFM evaluator
    regardless of dataset — pass --evaluator pascal to reproduce that.)"""
    if dataset_name.startswith("openimages"):
        return "openimages"
    if dataset_name.startswith("coco"):
        return "coco"
    return "pascal"
