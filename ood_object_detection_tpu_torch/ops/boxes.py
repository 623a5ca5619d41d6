"""Box clipping (port of ``ood_object_detection_tpu.ops.boxes``, the part
the predict path uses).

Box layouts: ``yxyx`` = [ymin, xmin, ymax, xmax] (anchors), ``xyxy`` =
[xmin, ymin, xmax, ymax] (detections).
"""
from __future__ import annotations

import torch


def clip_boxes_xyxy(boxes: torch.Tensor, size_hw: torch.Tensor) -> torch.Tensor:
    """Clip [..., 4] xyxy boxes to [0, size], size_hw = (height, width)
    broadcastable against the boxes' leading dims: clamp at 0, then an
    elementwise min against [w, h, w, h]."""
    boxes = torch.clamp(boxes, min=0.0)
    wh = torch.stack([size_hw[..., 1], size_hw[..., 0]], dim=-1)
    return torch.minimum(boxes, torch.cat([wh, wh], dim=-1))
