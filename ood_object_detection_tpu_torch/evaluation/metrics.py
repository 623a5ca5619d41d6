"""Copy of ``ood_object_detection_tpu.evaluation.metrics``.

Numpy metric primitives: precision/recall, AP, CorLoc, AUROC, FPR@95.

Host-side equivalents of the reference TF-models metrics port
(effdet/evaluation/metrics.py:4-148) plus the open-set OOD metrics the
deployment path needs (AUROC / FPR95 over per-detection OOD scores).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def compute_precision_recall(scores: np.ndarray, labels: np.ndarray,
                             num_gt: int) -> Tuple[np.ndarray, np.ndarray]:
    """PR curve from per-detection scores and TP(1)/FP(0) labels
    (reference metrics.py:4-45)."""
    if num_gt == 0 or scores.size == 0:
        return np.array([], np.float64), np.array([], np.float64)
    order = np.argsort(-scores, kind="stable")
    labels = labels[order].astype(np.float64)
    tp = np.cumsum(labels)
    # a detection is a false positive only when its label is <= 0: weighted
    # (fractional) true positives contribute no FP mass (reference
    # metrics.py:39)
    fp = np.cumsum((labels <= 0).astype(np.float64))
    precision = tp / np.maximum(tp + fp, 1e-12)
    recall = tp / num_gt
    return precision, recall


def compute_average_precision(precision: np.ndarray,
                              recall: np.ndarray) -> float:
    """Interpolated AP: area under the monotonized PR curve
    (reference metrics.py:47-90)."""
    if precision.size == 0:
        return 0.0
    precision = np.concatenate([[0.0], precision, [0.0]])
    recall = np.concatenate([[0.0], recall, [1.0]])
    for i in range(precision.size - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
    idx = np.where(recall[1:] != recall[:-1])[0] + 1
    return float(np.sum((recall[idx] - recall[idx - 1]) * precision[idx]))


def compute_cor_loc(num_gt_imgs_per_class: np.ndarray,
                    num_correctly_detected_per_class: np.ndarray) -> np.ndarray:
    """CorLoc = fraction of images with >=1 correct top detection
    (reference metrics.py:92-148)."""
    return np.where(
        num_gt_imgs_per_class == 0, np.nan,
        num_correctly_detected_per_class / np.maximum(num_gt_imgs_per_class, 1))


def auroc(known_scores: np.ndarray, unknown_scores: np.ndarray) -> float:
    """AUROC with known (in-distribution) as the positive class; higher
    scores = more in-distribution."""
    if len(known_scores) == 0 or len(unknown_scores) == 0:
        return float("nan")      # ROC undefined with an empty side
    scores = np.concatenate([known_scores, unknown_scores])
    labels = np.concatenate([np.ones_like(known_scores),
                             np.zeros_like(unknown_scores)])
    order = np.argsort(-scores, kind="stable")
    labels = labels[order]
    tps = np.cumsum(labels)
    fps = np.cumsum(1 - labels)
    n_pos = tps[-1]
    n_neg = fps[-1]
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    tpr = np.concatenate([[0.0], tps / n_pos])
    fpr = np.concatenate([[0.0], fps / n_neg])
    return float(np.trapezoid(tpr, fpr))


def fpr_at_tpr(known_scores: np.ndarray, unknown_scores: np.ndarray,
               tpr_target: float = 0.95) -> float:
    """FPR when TPR (recall of known) reaches tpr_target (FPR95)."""
    if len(known_scores) == 0 or len(unknown_scores) == 0:
        return float("nan")
    thresh = np.quantile(known_scores, 1.0 - tpr_target)
    return float(np.mean(unknown_scores >= thresh))
