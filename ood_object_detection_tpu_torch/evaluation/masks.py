"""Copy of ``ood_object_detection_tpu.evaluation.masks``.

Instance-mask metric ops for the evaluation port.

Functional equivalent of the reference's mask containers
(effdet/evaluation/np_mask_list.py:7-478 — a BoxList subclass carrying
[N, H, W] uint8 masks with loop-based pairwise area/IoU/IoA and greedy
mask NMS). The reference's active detection path never exercises masks,
so this is the completeness port: same math and selection semantics, but
as pure vectorized numpy functions over [N, H, W] {0,1} mask stacks —
pairwise intersections are one [N, HW] @ [HW, M] matmul instead of an
N*M Python loop, and callers carry fields (scores/classes) as parallel
arrays rather than container attributes.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

EPSILON = 1e-7


def _check_masks(masks: np.ndarray, name: str = "masks"):
    if masks.dtype != np.uint8:
        raise ValueError(f"{name} must be np.uint8 in {{0,1}}")
    if masks.ndim != 3:
        raise ValueError(f"{name} must be [N, height, width]")


def mask_area(masks: np.ndarray) -> np.ndarray:
    """[N] float32 pixel areas (reference area_mask, np_mask_list.py:72)."""
    _check_masks(masks)
    return np.sum(masks, axis=(1, 2), dtype=np.float32)


def mask_intersection(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """[N, M] pairwise intersection areas (reference intersection_mask,
    np_mask_list.py:90 — min() over {0,1} masks == logical AND, so the
    pairwise sum is a single flat matmul)."""
    _check_masks(masks1, "masks1")
    _check_masks(masks2, "masks2")
    a = masks1.reshape(masks1.shape[0], -1).astype(np.float32)
    b = masks2.reshape(masks2.shape[0], -1).astype(np.float32)
    return a @ b.T


def mask_iou(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """[N, M] pairwise IoU (reference iou_mask, np_mask_list.py:116)."""
    inter = mask_intersection(masks1, masks2)
    union = mask_area(masks1)[:, None] + mask_area(masks2)[None, :] - inter
    return inter / np.maximum(union, EPSILON)


def mask_ioa(masks1: np.ndarray, masks2: np.ndarray) -> np.ndarray:
    """[N, M] intersection over masks2's area — asymmetric (reference
    ioa_mask, np_mask_list.py:140)."""
    inter = mask_intersection(masks1, masks2)
    return inter / (mask_area(masks2)[None, :] + EPSILON)


def mask_nms(masks: np.ndarray, scores: np.ndarray,
             iou_threshold: float = 1.0,
             max_output_size: int = 10000,
             score_threshold: float = -10.0) -> np.ndarray:
    """Greedy single-class mask NMS; returns kept indices into the INPUT
    arrays, score-descending (reference non_max_suppression_mask,
    np_mask_list.py:263: filter by score, sort, greedily keep while
    suppressing IoU > threshold; iou_threshold=1.0 short-circuits to
    top-max_output_size)."""
    _check_masks(masks)
    if not 0.0 <= iou_threshold <= 1.0:
        raise ValueError("iou_threshold must be in [0, 1]")
    if max_output_size < 0:
        raise ValueError("max_output_size must be >= 0")
    scores = np.asarray(scores, np.float32)
    keep = np.where(scores > score_threshold)[0]
    if keep.size == 0:
        return keep
    keep = keep[np.argsort(-scores[keep], kind="stable")]
    if iou_threshold == 1.0:
        return keep[:max_output_size]

    iou = mask_iou(masks[keep], masks[keep])
    valid = np.ones(keep.size, bool)
    selected = []
    for i in range(keep.size):
        if len(selected) >= max_output_size:
            break
        if not valid[i]:
            continue
        selected.append(i)
        valid &= iou[i] <= iou_threshold
        valid[i] = False
    return keep[np.asarray(selected, int)]


def multiclass_mask_nms(masks: np.ndarray, scores: np.ndarray,
                        score_thresh: float, iou_thresh: float,
                        max_output_size: int,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class greedy mask NMS over a [N, num_classes] score matrix.
    Returns (kept row indices, kept class labels), both flat across
    classes (reference multi_class_non_max_suppression_mask,
    np_mask_list.py:335: each class' column is filtered + suppressed
    independently, results concatenated)."""
    _check_masks(masks)
    scores = np.asarray(scores, np.float32)
    if scores.ndim != 2 or scores.shape[0] != masks.shape[0]:
        raise ValueError("scores must be [num_masks, num_classes]")
    idx_out, cls_out = [], []
    for c in range(scores.shape[1]):
        kept = mask_nms(masks, scores[:, c], iou_threshold=iou_thresh,
                        max_output_size=max_output_size,
                        score_threshold=score_thresh)
        idx_out.append(kept)
        cls_out.append(np.full(kept.size, c, np.int32))
    return (np.concatenate(idx_out) if idx_out else np.zeros(0, int),
            np.concatenate(cls_out) if cls_out else np.zeros(0, np.int32))


def prune_non_overlapping_masks(masks1: np.ndarray, masks2: np.ndarray,
                                min_overlap: float = 0.0) -> np.ndarray:
    """Indices of masks1 whose best IoA against any masks2 entry is
    >= min_overlap (reference prune_non_overlapping_masklist,
    np_mask_list.py:403: keep masks1 rows that sufficiently cover some
    masks2 mask)."""
    ioa = mask_ioa(masks2, masks1)                 # [M2, N1]
    best = ioa.max(axis=0) if ioa.size else np.zeros(masks1.shape[0])
    return np.where(best >= min_overlap)[0]


def boxes_to_masks(boxes: np.ndarray, height: int, width: int) -> np.ndarray:
    """Rasterize [N, 4] yxyx boxes to [N, H, W] uint8 masks (reference
    boxlist_to_masklist bridge, np_mask_list.py:50 — enables reusing every
    mask metric on box inputs)."""
    boxes = np.asarray(boxes)
    ys = np.arange(height)[None, :, None]
    xs = np.arange(width)[None, None, :]
    y0, x0, y1, x1 = (boxes[:, i].reshape(-1, 1, 1) for i in range(4))
    inside = (ys >= y0) & (ys < y1) & (xs >= x0) & (xs < x1)
    return inside.astype(np.uint8)
