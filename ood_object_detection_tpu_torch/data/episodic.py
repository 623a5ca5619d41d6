"""Episode assembly for meta-training (port of ``EpisodeBuilder`` and
``_normalize`` of ``ood_object_detection_tpu.data.episodic``).

An episode is its uint8 images (supports, queries, projection crops)
normalised on the device and its anchor labels: queries at the query
resolution through ``batch_label_anchors`` (K3 -> K4 on the card, their
plain versions on the CPU: the function the JAX builder's vmapped
``label_anchors`` computes), projection crops at the support resolution
with the min-level offset through the per-image ``label_anchors`` with
the task-class merge, as the JAX builder does. The episode sources
(``EpisodicDataset``, ``SyntheticEpisodeSource``, the prefetcher) wait
for the host-data slice.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..config.model_config import ModelConfig
from ..factory import resolve_device
from ..meta.config import MetaConfig
from ..ops.anchors import Anchors
from ..ops.target_assigner import batch_label_anchors, label_anchors
from .dataset import pad_annotations
from .device_preproc import IMAGENET_DEFAULT_MEAN, IMAGENET_DEFAULT_STD


def _normalize(img_u8: torch.Tensor) -> torch.Tensor:
    """[..., 3] uint8 -> f32 ``(x - mean * 255) / (std * 255)``, the JAX
    builder's f32 operations in its order."""
    mean = torch.tensor(IMAGENET_DEFAULT_MEAN, dtype=torch.float32) * 255.0
    std = torch.tensor(IMAGENET_DEFAULT_STD, dtype=torch.float32) * 255.0
    return (img_u8.to(torch.float32) - mean.to(img_u8.device)) / \
        std.to(img_u8.device)


class EpisodeBuilder:
    """Assembles episode batches and labels them on ``device`` (the CUDA
    card when None; raises without one). ``kernels=False`` labels the
    queries with the plain versions of K3 / K4 on any device."""

    def __init__(self, model_cfg: ModelConfig, meta_cfg: MetaConfig,
                 device=None, kernels: bool = True):
        self.model_cfg = model_cfg
        self.meta_cfg = meta_cfg
        self.device = resolve_device(device)
        self.kernels = kernels
        self.qry_anchors = Anchors.from_config(
            model_cfg, img_size=meta_cfg.qry_img_size)
        self.proj_anchors = Anchors.from_config(
            model_cfg, img_size=meta_cfg.img_size,
            min_level_offset=meta_cfg.supp_level_offset)
        self._qry_boxes = torch.from_numpy(self.qry_anchors.boxes).to(
            self.device)
        self._proj_boxes = torch.from_numpy(self.proj_anchors.boxes).to(
            self.device)

    @property
    def proj_level_sizes(self) -> List[int]:
        return self.proj_anchors.level_sizes

    def _images(self, imgs) -> torch.Tensor:
        """A [N, H, W, 3] uint8 tensor, or a sequence of [H, W, 3] uint8
        arrays / tensors, normalised on the device."""
        if not isinstance(imgs, torch.Tensor):
            imgs = torch.stack([torch.as_tensor(np.asarray(i)) for i in imgs])
        return _normalize(imgs.to(self.device))

    def _gt(self, annos) -> Dict[str, torch.Tensor]:
        padded = [pad_annotations(a) for a in annos]
        return {k: torch.from_numpy(np.stack([a[k] for a in padded])).to(
            self.device) for k in ("bbox", "cls")}

    def build(self, supp_imgs, supp_cls_lab, qry_imgs, qry_annos,
              proj_imgs, proj_annos, task_cls: int, task_cats,
              val_iter: bool) -> Dict:
        """task_cls: the 1-based category id driving the projection targets
        and the >0.9-IoU task merge (the reference uses the LAST task
        category's id here — its loop variable leaks,
        dataloader.py:126,211)."""
        qry = self._gt(qry_annos)
        q_labels = batch_label_anchors(self._qry_boxes, qry["bbox"],
                                       qry["cls"], kernels=self.kernels)
        proj = self._gt(proj_annos)
        # the labeler merge runs in 1-based GT space (labels shift to
        # 0-based afterwards)
        p_cls = torch.stack([
            label_anchors(self._proj_boxes, b, c, task_cls=task_cls
                          ).cls_targets
            for b, c in zip(proj["bbox"], proj["cls"])])
        return {
            "supp_images": self._images(supp_imgs),
            "supp_cls_lab": torch.as_tensor(np.stack(supp_cls_lab)).to(
                self.device),
            "qry_images": self._images(qry_imgs),
            "qry_cls": q_labels.cls_targets,
            "qry_box": q_labels.box_targets,
            "qry_num_positives": q_labels.num_positives,
            "qry_gt_bbox": qry["bbox"],
            "qry_gt_cls": qry["cls"],
            "proj_images": self._images(proj_imgs),
            "proj_cls": p_cls,
            # anchor-label space is 0-based (background -1): the projection
            # losses compare this against proj_cls
            "task_cls": torch.tensor(task_cls - 1, dtype=torch.int32,
                                     device=self.device),
            "task_cats": task_cats,
            "val_iter": val_iter,
        }
