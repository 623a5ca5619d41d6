"""Copy of ``ood_object_detection_tpu.evaluation.object_detection_evaluation``.

Core per-class detection evaluation accumulators (numpy, host).

From-scratch equivalent of the reference TF-models port
(effdet/evaluation/object_detection_evaluation.py:9-273 and
per_image_evaluation.py:5-538): greedy IoU matching of detections to GT per
image/class (difficult boxes ignored, one GT matches at most once), per-class
PR curves -> AP, and CorLoc. Supports the full variant surface:

* group-of boxes (OpenImages): detections matching a group-of box by
  IoA >= threshold are ignored when ``group_of_weight == 0``; with weight
  > 0 each matched group box contributes one pseudo-detection of that
  weight (per_image_evaluation.py:409-441);
* ``use_weighted_mean_ap``: one AP over all classes' pooled scores
  (object_detection_evaluation.py:221-259);
* recall operating bounds for precision@recall metrics
  (object_detection_evaluation.py:239-246).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .metrics import (
    compute_average_precision,
    compute_cor_loc,
    compute_precision_recall,
)


def _iou_matrix(boxes1: np.ndarray, boxes2: np.ndarray) -> np.ndarray:
    """Pairwise IoU of yxyx boxes, [N, M]."""
    if boxes1.size == 0 or boxes2.size == 0:
        return np.zeros((boxes1.shape[0], boxes2.shape[0]), np.float64)
    ymin1, xmin1, ymax1, xmax1 = np.split(boxes1, 4, axis=1)
    ymin2, xmin2, ymax2, xmax2 = np.split(boxes2, 4, axis=1)
    ih = np.clip(np.minimum(ymax1, ymax2.T) - np.maximum(ymin1, ymin2.T), 0, None)
    iw = np.clip(np.minimum(xmax1, xmax2.T) - np.maximum(xmin1, xmin2.T), 0, None)
    inter = ih * iw
    a1 = (ymax1 - ymin1) * (xmax1 - xmin1)
    a2 = (ymax2 - ymin2) * (xmax2 - xmin2)
    union = a1 + a2.T - inter
    return np.where(inter == 0, 0.0, inter / np.maximum(union, 1e-12))


def _ioa_matrix(det_boxes: np.ndarray, gt_boxes: np.ndarray) -> np.ndarray:
    """Intersection over DETECTION area, [N_det, M_gt] (the group-of
    overlap measure: reference ioa transposed,
    per_image_evaluation.py:299-300)."""
    if det_boxes.size == 0 or gt_boxes.size == 0:
        return np.zeros((det_boxes.shape[0], gt_boxes.shape[0]), np.float64)
    ymin1, xmin1, ymax1, xmax1 = np.split(det_boxes, 4, axis=1)
    ymin2, xmin2, ymax2, xmax2 = np.split(gt_boxes, 4, axis=1)
    ih = np.clip(np.minimum(ymax1, ymax2.T) - np.maximum(ymin1, ymin2.T), 0, None)
    iw = np.clip(np.minimum(xmax1, xmax2.T) - np.maximum(xmin1, xmin2.T), 0, None)
    inter = ih * iw
    det_area = np.maximum((ymax1 - ymin1) * (xmax1 - xmin1), 1e-12)
    return inter / det_area


class PerImageEvaluation:
    """Per-image TP/FP labeling (reference per_image_evaluation.py:5-538)."""

    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5,
                 group_of_weight: float = 0.0):
        self.num_classes = num_classes
        self.iou_threshold = matching_iou_threshold
        self.group_of_weight = group_of_weight

    def _tp_fp_single_class(self, d_boxes, d_scores, g_boxes, g_diff,
                            g_group):
        """Greedy score-ordered matching for one class. Returns (scores,
        float tp/fp labels) with ignored detections dropped and group-of
        pseudo-detections appended (per_image_evaluation.py:306-470)."""
        order = np.argsort(-d_scores, kind="stable")
        d_boxes = d_boxes[order]
        d_scores = d_scores[order]
        n_det = len(d_scores)

        ng_boxes = g_boxes[~g_group]
        ng_diff = g_diff[~g_group]
        go_boxes = g_boxes[g_group]

        tp_fp = np.zeros(n_det, dtype=float)
        matched_difficult = np.zeros(n_det, dtype=bool)
        matched_group = np.zeros(n_det, dtype=bool)

        # stage 1: IoU match against non-group-of GT
        if n_det and len(ng_boxes):
            iou = _iou_matrix(d_boxes, ng_boxes)
            gt_detected = np.zeros(len(ng_boxes), dtype=bool)
            gt_ids = np.argmax(iou, axis=1)
            for i in range(n_det):
                j = gt_ids[i]
                if iou[i, j] >= self.iou_threshold:
                    if ng_diff[j]:
                        matched_difficult[i] = True
                    elif not gt_detected[j]:
                        gt_detected[j] = True
                        tp_fp[i] = 1.0

        # stage 2: IoA match of the rest against group-of GT
        go_scores = np.zeros(len(go_boxes), dtype=float)
        if n_det and len(go_boxes):
            ioa = _ioa_matrix(d_boxes, go_boxes)
            gt_ids = np.argmax(ioa, axis=1)
            for i in range(n_det):
                if tp_fp[i] or matched_difficult[i] or matched_group[i]:
                    continue
                j = gt_ids[i]
                if ioa[i, j] >= self.iou_threshold:
                    matched_group[i] = True
                    go_scores[j] = max(go_scores[j], d_scores[i])

        keep = ~matched_difficult & ~matched_group
        scores = d_scores[keep]
        labels = tp_fp[keep]
        if self.group_of_weight > 0:
            sel = go_scores > 0
            scores = np.concatenate([scores, go_scores[sel]])
            labels = np.concatenate(
                [labels, np.full(int(sel.sum()), self.group_of_weight)])
        return scores, labels

    def compute_tp_fp(self, det_boxes, det_scores, det_classes,
                      gt_boxes, gt_classes, gt_difficult=None,
                      gt_group_of=None):
        """Returns (scores per class, tp/fp labels per class,
        is_class_correctly_detected [num_classes])."""
        if gt_difficult is None:
            gt_difficult = np.zeros(len(gt_classes), bool)
        if gt_group_of is None:
            gt_group_of = np.zeros(len(gt_classes), bool)
        scores_out: List[np.ndarray] = []
        labels_out: List[np.ndarray] = []
        correctly_detected = np.zeros(self.num_classes, dtype=int)

        for c in range(self.num_classes):
            d_mask = det_classes == c
            g_mask = gt_classes == c
            d_boxes = det_boxes[d_mask]
            d_scores = det_scores[d_mask]
            g_boxes = gt_boxes[g_mask]
            g_diff = gt_difficult[g_mask]
            g_group = gt_group_of[g_mask]

            scores, labels = self._tp_fp_single_class(
                d_boxes, d_scores, g_boxes, g_diff, g_group)
            scores_out.append(scores)
            labels_out.append(labels)

            # CorLoc: top-scoring detection of class c localizes some
            # plain (non-difficult, non-group) GT
            plain = g_boxes[~g_diff & ~g_group]
            if len(plain) and len(d_scores):
                top = d_boxes[np.argmax(d_scores)][None, :]
                iou_top = _iou_matrix(top, plain)
                if iou_top.size and iou_top.max() >= self.iou_threshold:
                    correctly_detected[c] = 1
        return scores_out, labels_out, correctly_detected


class ObjectDetectionEvaluation:
    """Cross-image accumulators -> AP/mAP/CorLoc (reference
    object_detection_evaluation.py:9-273)."""

    def __init__(self, num_gt_classes: int, matching_iou_threshold: float = 0.5,
                 label_id_offset: int = 0, group_of_weight: float = 0.0,
                 use_weighted_mean_ap: bool = False,
                 recall_lower_bound: float = 0.0,
                 recall_upper_bound: float = 1.0):
        self.num_classes = num_gt_classes
        self.label_id_offset = label_id_offset
        self.group_of_weight = group_of_weight
        self.use_weighted_mean_ap = use_weighted_mean_ap
        self.recall_lower_bound = recall_lower_bound
        self.recall_upper_bound = recall_upper_bound
        self.per_image = PerImageEvaluation(
            num_gt_classes, matching_iou_threshold,
            group_of_weight=group_of_weight)
        self.scores_per_class: List[List[np.ndarray]] = [
            [] for _ in range(num_gt_classes)]
        self.tp_fp_per_class: List[List[np.ndarray]] = [
            [] for _ in range(num_gt_classes)]
        self.num_gt_instances_per_class = np.zeros(num_gt_classes, float)
        self.num_gt_imgs_per_class = np.zeros(num_gt_classes, int)
        self.num_images_correctly_detected_per_class = np.zeros(
            num_gt_classes, int)
        self._gt: Dict = {}

    def add_single_ground_truth_image_info(
            self, image_key, gt_boxes: np.ndarray, gt_class_labels: np.ndarray,
            gt_is_difficult: Optional[np.ndarray] = None,
            gt_is_group_of: Optional[np.ndarray] = None):
        if image_key in self._gt:
            return
        gt_class_labels = gt_class_labels - self.label_id_offset
        if gt_is_difficult is None:
            gt_is_difficult = np.zeros(len(gt_class_labels), bool)
        if gt_is_group_of is None:
            gt_is_group_of = np.zeros(len(gt_class_labels), bool)
        self._gt[image_key] = (gt_boxes, gt_class_labels, gt_is_difficult,
                               gt_is_group_of)
        for c in range(self.num_classes):
            is_c = gt_class_labels == c
            plain = is_c & ~gt_is_difficult & ~gt_is_group_of
            grouped = is_c & ~gt_is_difficult & gt_is_group_of
            # group-of boxes count group_of_weight instances each
            # (object_detection_evaluation.py:133-137)
            self.num_gt_instances_per_class[c] += (
                int(plain.sum()) + self.group_of_weight * int(grouped.sum()))
            if is_c.any():
                self.num_gt_imgs_per_class[c] += 1

    def add_single_detected_image_info(
            self, image_key, det_boxes: np.ndarray, det_scores: np.ndarray,
            det_class_labels: np.ndarray):
        det_class_labels = det_class_labels - self.label_id_offset
        gt_boxes, gt_classes, gt_diff, gt_group = self._gt.get(
            image_key,
            (np.zeros((0, 4), np.float32), np.zeros(0, int),
             np.zeros(0, bool), np.zeros(0, bool)))
        scores, tp_fp, correctly = self.per_image.compute_tp_fp(
            det_boxes, det_scores, det_class_labels,
            gt_boxes, gt_classes, gt_diff, gt_group)
        for c in range(self.num_classes):
            if len(scores[c]):
                self.scores_per_class[c].append(scores[c])
                self.tp_fp_per_class[c].append(tp_fp[c])
        self.num_images_correctly_detected_per_class += correctly

    def _bounded(self, precision, recall):
        sel = (recall >= self.recall_lower_bound) & \
            (recall <= self.recall_upper_bound)
        return precision[sel], recall[sel]

    def evaluate(self, class_subset: Optional[np.ndarray] = None) -> Dict:
        """AP per class + mAP + CorLoc; optionally restricted to a subset of
        (0-based) class indices — the per-episode filter capability
        (reference detection_evaluator.py:268-305)."""
        per_class_ap = np.zeros(self.num_classes)
        valid = self.num_gt_instances_per_class > 0
        all_scores: List[np.ndarray] = []
        all_tp_fp: List[np.ndarray] = []
        for c in range(self.num_classes):
            if not valid[c]:
                continue
            if self.scores_per_class[c]:
                scores = np.concatenate(self.scores_per_class[c])
                tp_fp = np.concatenate(self.tp_fp_per_class[c])
            else:
                scores = np.array([], np.float64)
                tp_fp = np.array([], np.float64)
            all_scores.append(scores)
            all_tp_fp.append(tp_fp)
            precision, recall = compute_precision_recall(
                scores, tp_fp, self.num_gt_instances_per_class[c])
            precision, recall = self._bounded(
                np.asarray(precision, float), np.asarray(recall, float))
            per_class_ap[c] = compute_average_precision(precision, recall)

        per_class_corloc = compute_cor_loc(
            self.num_gt_imgs_per_class,
            self.num_images_correctly_detected_per_class)

        if class_subset is not None:
            sel = np.zeros(self.num_classes, bool)
            sel[np.asarray(class_subset, int)] = True
            valid = valid & sel
            corloc_valid = (self.num_gt_imgs_per_class > 0) & sel
        else:
            corloc_valid = self.num_gt_imgs_per_class > 0

        if self.use_weighted_mean_ap and class_subset is None:
            # one AP over all classes' pooled detections
            # (object_detection_evaluation.py:221-259)
            scores = np.concatenate(all_scores) if all_scores else \
                np.array([], np.float64)
            tp_fp = np.concatenate(all_tp_fp) if all_tp_fp else \
                np.array([], np.float64)
            precision, recall = compute_precision_recall(
                scores, tp_fp, float(self.num_gt_instances_per_class.sum()))
            precision, recall = self._bounded(
                np.asarray(precision, float), np.asarray(recall, float))
            mean_ap = float(compute_average_precision(precision, recall))
        else:
            mean_ap = float(per_class_ap[valid].mean()) if valid.any() else 0.0
        corlocs = per_class_corloc[corloc_valid]
        mean_corloc = float(np.nanmean(corlocs)) if corlocs.size else 0.0
        return dict(
            per_class_ap=per_class_ap,
            mean_ap=mean_ap,
            per_class_corloc=per_class_corloc,
            mean_corloc=mean_corloc,
        )
