"""Faster-RCNN box encode/decode (yxyx <-> ty,tx,th,tw).

Port of ``ood_object_detection_tpu.ops.box_coder``: the same f32
operations in the same order, so results differ from XLA's only where
``exp``/``log`` round differently (within 1e-6 relative).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

EPS = 1e-8


def _center_size(boxes_yxyx: torch.Tensor):
    """yxyx -> (ycenter, xcenter, h, w), each [...]."""
    ymin, xmin, ymax, xmax = boxes_yxyx.unbind(-1)
    h = ymax - ymin
    w = xmax - xmin
    return ymin + 0.5 * h, xmin + 0.5 * w, h, w


def encode_boxes(boxes: torch.Tensor, anchors: torch.Tensor,
                 scale_factors: Optional[Sequence[float]] = None,
                 eps: float = EPS) -> torch.Tensor:
    """Encode [*, 4] yxyx boxes against same-shape anchors -> tytxthtw."""
    ycenter_a, xcenter_a, ha, wa = _center_size(anchors)
    ycenter, xcenter, h, w = _center_size(boxes)
    ha = ha + eps
    wa = wa + eps
    h = h + eps
    w = w + eps
    ty = (ycenter - ycenter_a) / ha
    tx = (xcenter - xcenter_a) / wa
    th = torch.log(h / ha)
    tw = torch.log(w / wa)
    if scale_factors is not None:
        ty = ty * scale_factors[0]
        tx = tx * scale_factors[1]
        th = th * scale_factors[2]
        tw = tw * scale_factors[3]
    return torch.stack([ty, tx, th, tw], dim=-1)


def decode_boxes(rel_codes: torch.Tensor, anchors: torch.Tensor,
                 scale_factors: Optional[Sequence[float]] = None,
                 output_xyxy: bool = False) -> torch.Tensor:
    """Decode [*, 4] tytxthtw regressions against yxyx anchors; yxyx out
    (or xyxy with ``output_xyxy``, the NMS layout)."""
    ycenter_a, xcenter_a, ha, wa = _center_size(anchors)
    ty, tx, th, tw = rel_codes.unbind(-1)
    if scale_factors is not None:
        ty = ty / scale_factors[0]
        tx = tx / scale_factors[1]
        th = th / scale_factors[2]
        tw = tw / scale_factors[3]
    w = torch.exp(tw) * wa
    h = torch.exp(th) * ha
    ycenter = ty * ha + ycenter_a
    xcenter = tx * wa + xcenter_a
    ymin = ycenter - h / 2.0
    xmin = xcenter - w / 2.0
    ymax = ycenter + h / 2.0
    xmax = xcenter + w / 2.0
    if output_xyxy:
        return torch.stack([xmin, ymin, xmax, ymax], dim=-1)
    return torch.stack([ymin, xmin, ymax, xmax], dim=-1)


# the reference's public name (effdet/anchors.py:51), as the JAX package
decode_box_outputs = decode_boxes
