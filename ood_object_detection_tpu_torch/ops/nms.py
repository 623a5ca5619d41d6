"""Fixed-iteration greedy NMS (hard and soft), batched over images.

Port of ``ood_object_detection_tpu.ops.nms`` (``nms_fixed``,
``soft_nms_fixed``), written over a batch dimension: boxes ``[B, N, 4]``
xyxy (already class-offset), scores ``[B, N]``. Each of the ``max_out``
iterations takes the row argmax (lowest index on ties), records it when
its score is positive, suppresses or decays the others by their IoU with
it, and zeroes it. These are the plain versions of kernel K1
(``ops/cuda_nms.py``); the same f32 operations in the same order as the
JAX functions.

``batched_nms`` / ``batched_soft_nms`` are the JAX package's single-image
per-class functions (torchvision's ``batched_nms`` contract): boxes
``[N, 4]``, scores ``[N]`` and classes ``[N]``, kept apart by
``class_offset_boxes``. The batched K1 wrapper of the same name is
``ops.cuda_nms.batched_nms``.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch


def _iou_one_vs_many(box: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """IoU of [B, 4] xyxy boxes against [B, N, 4] -> [B, N]; pairs that do
    not intersect get exactly 0."""
    lt = torch.maximum(box[:, None, :2], boxes[..., :2])
    rb = torch.minimum(box[:, None, 2:], boxes[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area1 = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    area2 = ((boxes[..., 2] - boxes[..., 0])
             * (boxes[..., 3] - boxes[..., 1]))
    union = area1[:, None] + area2 - inter
    return torch.where(inter > 0.0, inter / union, torch.zeros_like(inter))


def _greedy(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
            update: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    b = scores.shape[0]
    rows = torch.arange(b, device=scores.device)
    out_idx = torch.full((b, max_out), -1, dtype=torch.int32,
                         device=scores.device)
    out_scores = torch.zeros((b, max_out), dtype=scores.dtype,
                             device=scores.device)
    zero = torch.zeros((), dtype=scores.dtype, device=scores.device)
    for i in range(max_out):
        top = torch.argmax(scores, dim=1)            # first of equal maxima
        top_score = scores[rows, top]
        alive = top_score > 0.0
        out_idx[:, i] = torch.where(alive, top.to(torch.int32), -1)
        out_scores[:, i] = torch.where(alive, top_score, zero)
        scores = update(scores, _iou_one_vs_many(boxes[rows, top], boxes))
        scores[rows, top] = 0.0
    return out_idx, out_scores


def nms_fixed(boxes: torch.Tensor, scores: torch.Tensor,
              iou_threshold: float, max_out: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy hard NMS, ``max_out`` iterations. Returns (keep_idx
    [B, max_out] int32, -1 where fewer survive; kept scores [B, max_out])."""
    return _greedy(boxes, scores, max_out,
                   lambda s, iou: torch.where(iou > iou_threshold,
                                              torch.zeros_like(s), s))


def soft_nms_fixed(boxes: torch.Tensor, scores: torch.Tensor, max_out: int,
                   method_gaussian: bool = True, sigma: float = 0.5,
                   iou_threshold: float = 0.3, score_threshold: float = 0.001
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-NMS, gaussian ``exp(-iou^2 / sigma)`` or linear ``1 - iou``
    above ``iou_threshold``; scores that decay to ``score_threshold`` or
    below are pruned. Returns the pre-decay score of each pick."""
    def update(s, iou):
        if method_gaussian:
            decay = torch.exp(-(iou * iou) / sigma)
        else:
            decay = torch.where(iou > iou_threshold, 1.0 - iou,
                                torch.ones_like(iou))
        s = s * decay
        return torch.where(s > score_threshold, s, torch.zeros_like(s))
    return _greedy(boxes, scores, max_out, update)


def batched_nms_plain(boxes: torch.Tensor, scores: torch.Tensor,
                      max_out: int = 100, iou_threshold: float = 0.5,
                      soft: bool = False, sigma: float = 0.5,
                      score_threshold: float = 0.001
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The function K1 computes (``pallas_batched_nms``'s contract): hard
    NMS, or gaussian soft-NMS with ``soft``."""
    if soft:
        return soft_nms_fixed(boxes, scores, max_out, method_gaussian=True,
                              sigma=sigma, score_threshold=score_threshold)
    return nms_fixed(boxes, scores, iou_threshold, max_out)


def class_offset_boxes(boxes: torch.Tensor, classes: torch.Tensor
                       ) -> torch.Tensor:
    """Shift each class's [N, 4] boxes into a coordinate range of its own,
    ``classes * (max(boxes) + 1)``, so one class-agnostic NMS never
    suppresses across classes."""
    offsets = classes.to(boxes.dtype) * (torch.amax(boxes) + 1.0)
    return boxes + offsets[:, None]


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                classes: torch.Tensor, iou_threshold: float = 0.5,
                max_out: int = 100) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class hard NMS of one image (torchvision ``batched_nms``):
    (keep_idx [max_out] int32, -1 where fewer survive; kept scores)."""
    idx, kept = nms_fixed(class_offset_boxes(boxes, classes)[None],
                          scores[None], iou_threshold, max_out)
    return idx[0], kept[0]


def batched_soft_nms(boxes: torch.Tensor, scores: torch.Tensor,
                     classes: torch.Tensor, method_gaussian: bool = True,
                     sigma: float = 0.5, iou_threshold: float = 0.5,
                     score_threshold: float = 0.001, max_out: int = 100
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-class soft-NMS of one image (the reference's
    ``batched_soft_nms``, effdet/soft_nms.py:115-169)."""
    idx, kept = soft_nms_fixed(
        class_offset_boxes(boxes, classes)[None], scores[None], max_out,
        method_gaussian=method_gaussian, sigma=sigma,
        iou_threshold=iou_threshold, score_threshold=score_threshold)
    return idx[0], kept[0]
