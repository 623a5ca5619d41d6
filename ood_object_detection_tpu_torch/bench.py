"""Task benches: EfficientDet + anchors + post-process (predict) or
labeler + loss (train) as one module.

Port of ``ood_object_detection_tpu.bench``: ``DetBenchPredict``,
``DetBenchTrain`` and ``unwrap_bench``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from .models.efficientdet import EfficientDet
from .ops.anchors import Anchors
from .ops.losses import detection_loss_flat, levels_to_flat
from .ops.post_process import generate_detections
from .ops.target_assigner import batch_label_anchors


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

    def sharded(self, mesh):
        """The data-parallel predict step over ``mesh`` (JAX's
        ``shard_map`` predict): each process holds its rows of the global
        batch (``parallel.shard_batch`` or a per-process loader) and runs
        the whole predict on them, K2 -> top-k -> K1 on its own card,
        with no collective inside the step (images are independent).
        Returns ``step(x_local) -> this rank's outputs``;
        ``parallel.all_gather_detections`` reassembles the global batch."""
        if next(self.parameters()).device != mesh.device:
            raise ValueError(f"the bench is on {next(self.parameters()).device}"
                             f", the mesh's rank on {mesh.device}")

        def step(x, img_info=None):
            return self(x, img_info)
        return step


class DetBenchTrain(nn.Module):
    """(images, padded ground truth) -> loss dict, labeling the anchors on
    the images' device (K3 / K4 on the card).

    ``target`` holds 'bbox' [B, M, 4] yxyx and 'cls' [B, M] (1-based, -1
    padding); with ``create_labeler=False`` and 'label_num_positives' in
    it, the precomputed flat labels 'label_cls' [B, A] / 'label_bbox'
    [B, A, 4] / 'label_num_positives' [B] are used instead. The module's
    train / eval mode selects batch or running BatchNorm statistics; in
    train mode the running statistics update in place. Returns {'loss',
    'class_loss', 'box_loss'}, plus 'detections' [B, max_det, 6] with
    ``eval_detections`` (then 'img_scale' / 'img_size' in ``target`` are
    used where present).
    """

    def __init__(self, model: EfficientDet, create_labeler: bool = True):
        super().__init__()
        self.model = model
        self.config = model.config
        self.anchors = Anchors.from_config(model.config)
        self.create_labeler = create_labeler
        self.register_buffer("anchor_boxes",
                             torch.from_numpy(self.anchors.boxes),
                             persistent=False)

    def forward(self, x: torch.Tensor, target: Dict[str, torch.Tensor],
                eval_detections: bool = False) -> Dict[str, torch.Tensor]:
        cfg = self.config
        cls_out, box_out = self.model(x)
        if not self.create_labeler and "label_num_positives" in target:
            cls_targets = target["label_cls"]
            box_targets = target["label_bbox"]
            num_positives = target["label_num_positives"]
        else:
            labels = batch_label_anchors(self.anchor_boxes, target["bbox"],
                                         target["cls"])
            cls_targets = labels.cls_targets
            box_targets = labels.box_targets
            num_positives = labels.num_positives
        total, cls_loss, box_loss = detection_loss_flat(
            levels_to_flat(cls_out, cfg.num_classes),
            levels_to_flat(box_out, 4),
            cls_targets, box_targets, num_positives,
            num_classes=cfg.num_classes, alpha=cfg.alpha, gamma=cfg.gamma,
            delta=cfg.delta, box_loss_weight=cfg.box_loss_weight,
            label_smoothing=cfg.label_smoothing,
            legacy_focal=cfg.legacy_focal,
            focal_modulation=cfg.focal_modulation)
        output = {"loss": total, "class_loss": cls_loss, "box_loss": box_loss}
        if eval_detections:
            with torch.no_grad():
                output["detections"], _ = generate_detections(
                    [c.detach() for c in cls_out],
                    [b.detach() for b in box_out], self.anchors,
                    num_classes=cfg.num_classes,
                    img_scale=target.get("img_scale"),
                    img_size=target.get("img_size"),
                    max_detection_points=cfg.max_detection_points,
                    max_det_per_image=cfg.max_det_per_image,
                    soft_nms=cfg.soft_nms, topk_method=cfg.topk_method)
        return output


def unwrap_bench(bench: nn.Module) -> nn.Module:
    """The model inside a bench (the bench itself if it has none)."""
    return getattr(bench, "model", bench)
