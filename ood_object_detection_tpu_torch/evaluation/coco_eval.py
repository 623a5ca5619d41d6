"""Copy of ``ood_object_detection_tpu.evaluation.coco_eval``.

COCO-style mAP (AP@[.5:.95]) evaluator, pure numpy, no pycocotools.

Replaces the reference's pycocotools dependency (effdet/evaluator.py:88-118):
the 101-point interpolated AP averaged over IoU 0.50:0.05:0.95, area ranges
and maxDets=100, following the published COCO evaluation protocol.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from . import native

IOU_THRESHOLDS = np.arange(0.5, 1.0, 0.05).astype(np.float32)
RECALL_POINTS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0 ** 2),
    "medium": (32.0 ** 2, 96.0 ** 2),
    "large": (96.0 ** 2, 1e10),
}


def _iou_matrix_xyxy(d: np.ndarray, g: np.ndarray,
                     g_crowd: Optional[np.ndarray] = None) -> np.ndarray:
    """Pairwise det-vs-GT overlap. Crowd GT columns use intersection over
    the DETECTION's area (pycocotools maskUtils.iou iscrowd semantics);
    the rest use standard IoU."""
    if d.size == 0 or g.size == 0:
        return np.zeros((d.shape[0], g.shape[0]))
    xmin1, ymin1, xmax1, ymax1 = np.split(d, 4, axis=1)
    xmin2, ymin2, xmax2, ymax2 = np.split(g, 4, axis=1)
    iw = np.clip(np.minimum(xmax1, xmax2.T) - np.maximum(xmin1, xmin2.T), 0, None)
    ih = np.clip(np.minimum(ymax1, ymax2.T) - np.maximum(ymin1, ymin2.T), 0, None)
    inter = iw * ih
    a1 = (xmax1 - xmin1) * (ymax1 - ymin1)
    a2 = (xmax2 - xmin2) * (ymax2 - ymin2)
    union = a1 + a2.T - inter
    if g_crowd is not None and g_crowd.any():
        union = np.where(g_crowd[None, :], np.broadcast_to(a1, inter.shape),
                         union)
    return np.where(inter == 0, 0.0, inter / np.maximum(union, 1e-12))


def _match_image(iou: np.ndarray, g_ignore: np.ndarray, g_crowd: np.ndarray,
                 d_out_of_range: np.ndarray, thresholds: np.ndarray):
    """COCOeval evaluateImg matching (numpy twin of the native core).

    dets are score-sorted rows of ``iou``; GT columns are sorted
    ignored-last. Returns (tp [T, D], ignore [T, D] bool)."""
    n_det, n_gt = iou.shape
    T = len(thresholds)
    tp = np.zeros((T, n_det))
    ign = np.zeros((T, n_det), bool)
    for t, thr in enumerate(thresholds):
        thr = min(thr, 1 - 1e-10)
        matched = np.zeros(n_gt, bool)
        for i in range(n_det):
            m, best = -1, thr
            for j in range(n_gt):
                # an already-matched non-crowd GT is consumed
                if matched[j] and not g_crowd[j]:
                    continue
                # matched to a real GT and reached the ignored tail: stop
                if m > -1 and not g_ignore[m] and g_ignore[j]:
                    break
                if iou[i, j] < best:
                    continue
                best = iou[i, j]      # ties replace: later GT wins
                m = j
            if m > -1:
                matched[m] = True
                ign[t, i] = g_ignore[m]
                tp[t, i] = 0.0 if g_ignore[m] else 1.0
            else:
                ign[t, i] = d_out_of_range[i]
    return tp, ign


class CocoMeanAP:
    """Accumulate per-image detections/GT (xyxy), evaluate COCO mAP."""

    def __init__(self, num_classes: int, max_dets: int = 100):
        self.num_classes = num_classes
        self.max_dets = max_dets
        self._dets: Dict = {}
        self._gts: Dict = {}
        self._img_keys: List = []

    def add_image(self, image_key, det_boxes: np.ndarray, det_scores: np.ndarray,
                  det_classes: np.ndarray, gt_boxes: np.ndarray,
                  gt_classes: np.ndarray,
                  gt_crowd: Optional[np.ndarray] = None):
        """Classes are 1-based; boxes xyxy in original-image coordinates.

        maxDets truncation happens per (image, class) at evaluate time —
        COCOeval keys detections by (imgId, catId) and truncates each list
        to maxDet in evaluateImg, NOT per image across classes."""
        if gt_crowd is None:
            gt_crowd = np.zeros(len(gt_classes), bool)
        order = np.argsort(-det_scores, kind="stable")
        self._dets[image_key] = (det_boxes[order], det_scores[order],
                                 det_classes[order])
        self._gts[image_key] = (gt_boxes, gt_classes, gt_crowd)
        self._img_keys.append(image_key)

    def _evaluate_class(self, c: int, area_rng) -> tuple:
        """Match detections of class c over all images at all IoU thresholds.

        Returns (scores [D], tp [T, D], num_gt) with T IoU thresholds.
        """
        all_scores = []
        all_tp = []
        num_gt = 0
        lo, hi = area_rng
        T = len(IOU_THRESHOLDS)
        for key in self._img_keys:
            d_boxes, d_scores, d_classes = self._dets[key]
            g_boxes, g_classes, g_crowd = self._gts[key]
            dm = d_classes == c
            gm = g_classes == c
            # dets are stored score-sorted; per-(image, class) maxDets
            # truncation (COCOeval keys _dts by (imgId, catId))
            db, ds = d_boxes[dm][:self.max_dets], d_scores[dm][:self.max_dets]
            gb, gc = g_boxes[gm], g_crowd[gm]

            g_area = (gb[:, 2] - gb[:, 0]) * (gb[:, 3] - gb[:, 1]) \
                if len(gb) else np.zeros(0)
            g_ignore = gc | (g_area < lo) | (g_area > hi)
            num_gt += int((~g_ignore).sum())

            if not len(ds):
                continue
            # GT scan order: ignored-last (COCOeval's gtind sort)
            g_order = np.argsort(g_ignore, kind="stable")
            gb, gc, g_ignore = gb[g_order], gc[g_order], g_ignore[g_order]
            d_area = (db[:, 2] - db[:, 0]) * (db[:, 3] - db[:, 1])
            d_out_of_range = (d_area < lo) | (d_area > hi)

            if native.available():
                tp, ignore_det = native.match_detections(
                    db, gb, g_ignore, gc, d_out_of_range, IOU_THRESHOLDS)
                ignore_det = ignore_det.astype(bool)
            else:
                iou = _iou_matrix_xyxy(db, gb, gc)
                tp, ignore_det = _match_image(
                    iou, g_ignore, gc, d_out_of_range, IOU_THRESHOLDS)
            all_scores.append(ds)
            all_tp.append((tp, ignore_det))
        return all_scores, all_tp, num_gt

    def evaluate(self, area: str = "all") -> Dict[str, float]:
        """Returns {'map': AP@[.5:.95], 'map50': AP@0.5, 'map75': AP@0.75}."""
        T = len(IOU_THRESHOLDS)
        ap_per_class = []
        ap50_per_class = []
        ap75_per_class = []
        area_rng = AREA_RANGES[area]
        for c in range(1, self.num_classes + 1):
            scores_list, tp_list, num_gt = self._evaluate_class(c, area_rng)
            if num_gt == 0:
                continue
            if scores_list:
                scores = np.concatenate(scores_list)
                order = np.argsort(-scores, kind="stable")
                aps = []
                for t in range(T):
                    tp = np.concatenate([x[0][t] for x in tp_list])[order]
                    ig = np.concatenate([x[1][t] for x in tp_list])[order]
                    # f64 accumulation: the native matcher returns f32 tp,
                    # and the 101-point interpolation is pinned to 1e-9
                    # against the COCOeval oracle
                    tp = tp[~ig].astype(np.float64)
                    tps = np.cumsum(tp)
                    fps = np.cumsum(1 - tp)
                    recall = tps / num_gt
                    precision = tps / np.maximum(tps + fps, 1e-12)
                    # monotone precision envelope + 101-point sampling
                    for i in range(len(precision) - 2, -1, -1):
                        precision[i] = max(precision[i], precision[i + 1])
                    if len(precision) == 0:
                        aps.append(0.0)
                        continue
                    idx = np.searchsorted(recall, RECALL_POINTS, side="left")
                    prec_at = np.where(
                        idx < len(precision),
                        precision[np.minimum(idx, len(precision) - 1)], 0.0)
                    aps.append(float(np.mean(prec_at)))
            else:
                aps = [0.0] * T
            ap_per_class.append(np.mean(aps))
            ap50_per_class.append(aps[0])
            ap75_per_class.append(aps[5])
        if not ap_per_class:
            return dict(map=0.0, map50=0.0, map75=0.0)
        return dict(
            map=float(np.mean(ap_per_class)),
            map50=float(np.mean(ap50_per_class)),
            map75=float(np.mean(ap75_per_class)),
        )

    def stats(self) -> Dict[str, float]:
        """pycocotools-style summary incl. the per-area breakdown
        (COCOeval stats[0:2] + stats[3:6]): map / map50 / map75 plus
        map_small / map_medium / map_large."""
        out = self.evaluate("all")
        for area in ("small", "medium", "large"):
            out[f"map_{area}"] = self.evaluate(area)["map"]
        return out
