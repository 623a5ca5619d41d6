"""Box geometry: areas, pairwise IoU and clipping (port of
``ood_object_detection_tpu.ops.boxes``).

Box layouts: ``yxyx`` = [ymin, xmin, ymax, xmax] (anchors, ground truth),
``xyxy`` = [xmin, ymin, xmax, ymax] (detections).
"""
from __future__ import annotations

import torch


def area_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    """Area of [..., 4] yxyx boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def pairwise_iou_yxyx(boxes1: torch.Tensor, boxes2: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise IoU of [..., N, 4] and [..., M, 4] yxyx boxes -> [..., N, M].

    Pairs that do not intersect get exactly 0 (no 0/0). The operations and
    their order are those of the JAX function, ``(area1 + area2) - inter``
    included, so the hand-written match kernel (csrc/label_match.cu) can
    reproduce every value bit for bit.
    """
    ymin1, xmin1, ymax1, xmax1 = (t.unsqueeze(-1) for t in boxes1.unbind(-1))
    ymin2, xmin2, ymax2, xmax2 = (t.unsqueeze(-2) for t in boxes2.unbind(-1))
    inter_h = torch.clamp(torch.minimum(ymax1, ymax2)
                          - torch.maximum(ymin1, ymin2), min=0.0)
    inter_w = torch.clamp(torch.minimum(xmax1, xmax2)
                          - torch.maximum(xmin1, xmin2), min=0.0)
    inter = inter_h * inter_w
    union = area_yxyx(boxes1).unsqueeze(-1) + area_yxyx(boxes2).unsqueeze(-2) \
        - inter
    return torch.where(inter == 0.0, torch.zeros_like(inter), inter / union)


def clip_boxes_xyxy(boxes: torch.Tensor, size_hw: torch.Tensor) -> torch.Tensor:
    """Clip [..., 4] xyxy boxes to [0, size], size_hw = (height, width)
    broadcastable against the boxes' leading dims: clamp at 0, then an
    elementwise min against [w, h, w, h]."""
    boxes = torch.clamp(boxes, min=0.0)
    wh = torch.stack([size_hw[..., 1], size_hw[..., 0]], dim=-1)
    return torch.minimum(boxes, torch.cat([wh, wh], dim=-1))


def pairwise_iou_xyxy(boxes1: torch.Tensor, boxes2: torch.Tensor
                      ) -> torch.Tensor:
    """Pairwise IoU of xyxy boxes: ``pairwise_iou_yxyx`` with both inputs'
    coordinates swapped to yxyx (the same operations, axes swapped)."""
    return pairwise_iou_yxyx(xyxy_to_yxyx(boxes1), xyxy_to_yxyx(boxes2))


def clip_boxes_yxyx(boxes: torch.Tensor, size_hw: torch.Tensor
                    ) -> torch.Tensor:
    """Clip [..., 4] yxyx boxes to [0, size], size_hw = (height, width):
    clamp at 0, then an elementwise min against [h, w, h, w]."""
    boxes = torch.clamp(boxes, min=0.0)
    return torch.minimum(boxes, torch.cat([size_hw, size_hw], dim=-1))


def yxyx_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., [1, 0, 3, 2]]


def xyxy_to_yxyx(boxes: torch.Tensor) -> torch.Tensor:
    return boxes[..., [1, 0, 3, 2]]
