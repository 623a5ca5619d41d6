"""Prediction bench: EfficientDet + anchors + post-process as one module.

Port of ``ood_object_detection_tpu.bench.DetBenchPredict``. The train
bench is a later slice.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .models.efficientdet import EfficientDet
from .ops.anchors import Anchors
from .ops.post_process import generate_detections


class DetBenchPredict(nn.Module):
    """Images [B, H, W, 3] -> [B, max_det, 6] detections (+ OOD scores).

    Rows are [xmin, ymin, xmax, ymax, score, class] with background class
    0; padding rows have score 0.
    """

    def __init__(self, model: EfficientDet, ood_method: Optional[str] = None):
        super().__init__()
        self.model = model
        self.config = model.config
        self.anchors = Anchors.from_config(model.config)
        self.ood_method = ood_method

    def forward(self, x: torch.Tensor,
                img_info: Optional[Dict[str, torch.Tensor]] = None):
        dets, ood = self.forward_with_ood(x, img_info)
        return dets if self.ood_method is None else (dets, ood)

    @torch.no_grad()
    def forward_with_ood(self, x: torch.Tensor,
                         img_info: Optional[Dict[str, torch.Tensor]] = None
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(detections [B, max_det, 6], OOD [B, max_det] or None)."""
        cfg = self.config
        cls_out, box_out = self.model(x)
        img_scale = img_size = None
        if img_info is not None:
            img_scale = img_info["img_scale"]
            img_size = img_info["img_size"]
        return generate_detections(
            cls_out, box_out, self.anchors, num_classes=cfg.num_classes,
            img_scale=img_scale, img_size=img_size,
            max_detection_points=cfg.max_detection_points,
            max_det_per_image=cfg.max_det_per_image, soft_nms=cfg.soft_nms,
            ood_method=self.ood_method, topk_method=cfg.topk_method)
