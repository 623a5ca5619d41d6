"""Anchor labeling: IoU -> argmax match -> targets (port of
``ood_object_detection_tpu.ops.target_assigner``).

Ground truth is padded to a fixed number of rows; rows with class <= -1
are padding. Match codes: ``>= 0`` the matched row, ``-1`` unmatched,
``-2`` ignored (IoU between the two thresholds). Class targets are the
1-based labels shifted down by one: ``>= 0`` a class, ``-1`` background,
``-2`` ignored (masked out of the class loss).

``batch_label_anchors`` is the train step's labeler: K3 (the match
kernel) -> K4 (thresholds, force-match and targets in one kernel), with
the kernels' plain versions for CPU tensors (``ops/cuda_labeler.py``).
``label_anchors`` labels one image through the [M, A] similarity and
``argmax_match``, the JAX package's vmapped path; it serves
``AnchorLabeler.label_anchors`` and the episodic ``task_cls`` merge.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch

from . import cuda_labeler
from .anchors import Anchors
from .boxes import pairwise_iou_yxyx
from ..utils.profiling import span


@dataclasses.dataclass(frozen=True)
class LabelResult:
    """Flat per-anchor targets of one image ([A] ...) or a batch ([B, A])."""
    cls_targets: torch.Tensor     # int32
    box_targets: torch.Tensor     # [..., 4] float32
    matches: torch.Tensor         # int32 match codes
    num_positives: torch.Tensor   # [] or [B] float32


def argmax_match(sim: torch.Tensor, valid_rows: torch.Tensor,
                 matched_threshold: float, unmatched_threshold: float,
                 negatives_lower_than_unmatched: bool = True,
                 force_match_for_each_row: bool = True) -> torch.Tensor:
    """Thresholded argmax matching of an [M, A] similarity -> [A] codes.

    Padded rows (``valid_rows`` False) score -1 and never win. Ties go to
    the lowest row per anchor and the lowest anchor per row; force-match
    gives a contested anchor to the lowest row.
    """
    num_gt = sim.shape[0]
    sim_masked = torch.where(valid_rows[:, None], sim,
                             torch.full_like(sim, -1.0))
    matched_vals, matches = cuda_labeler._first_index_of_max(sim_masked, 0)

    below = matched_vals < unmatched_threshold
    between = (matched_vals >= unmatched_threshold) & \
        (matched_vals < matched_threshold)
    low, mid = (-1, -2) if negatives_lower_than_unmatched else (-2, -1)
    matches = torch.where(below, torch.full_like(matches, low), matches)
    matches = torch.where(between, torch.full_like(matches, mid), matches)

    if force_match_for_each_row:
        best_anchor = cuda_labeler._first_index_of_max(sim_masked, 1)[1]
        claims = best_anchor[:, None] == torch.arange(
            sim.shape[1], dtype=best_anchor.dtype, device=sim.device)
        claims = claims & valid_rows[:, None]
        row_ids = torch.arange(num_gt, dtype=torch.int32, device=sim.device)
        cand = torch.where(claims, row_ids[:, None],
                           torch.full_like(row_ids, num_gt)[:, None])
        force_row = torch.amin(cand, dim=0)
        matches = torch.where(force_row < num_gt, force_row, matches)
    return matches


def _merge_task_class_overlaps(gt_boxes: torch.Tensor,
                               gt_classes: torch.Tensor, valid: torch.Tensor,
                               task_cls) -> torch.Tensor:
    """Relabel valid GT boxes overlapping a task-class box above 0.9 IoU as
    the task class (the reference's episodic merge, effdet/anchors.py:396-403)."""
    is_task = (gt_classes == task_cls) & valid
    sims = pairwise_iou_yxyx(gt_boxes, gt_boxes)
    sims = torch.where(is_task[:, None] & valid[None, :], sims,
                       torch.zeros_like(sims))
    overlapping = torch.amax(sims, dim=0) > 0.9
    task = torch.full_like(gt_classes, int(task_cls))
    return torch.where(overlapping & valid, task, gt_classes)


def _targets_from_matches(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_classes: torch.Tensor, matches: torch.Tensor
                          ) -> LabelResult:
    """Batched targets from match codes, the plain version of K4."""
    cls_targets, box_targets = cuda_labeler.batch_targets_plain(
        anchor_boxes, gt_boxes, gt_classes, matches)
    return LabelResult(cls_targets, box_targets, matches,
                       (matches >= 0).to(torch.float32).sum(dim=-1))


def label_anchors(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, match_threshold: float = 0.5,
                  unmatched_threshold: Optional[float] = None,
                  task_cls=None) -> LabelResult:
    """Label the anchors [A, 4] of one image against padded GT [M, 4] /
    [M] (1-based classes, <= -1 padding). ``task_cls`` enables the
    episodic overlap merge. Returns flat [A] targets."""
    gt_classes = gt_classes.to(torch.int32)
    gt_boxes = gt_boxes.to(torch.float32)
    if unmatched_threshold is None:
        unmatched_threshold = match_threshold
    valid = gt_classes > -1
    if task_cls is not None:
        gt_classes = _merge_task_class_overlaps(gt_boxes, gt_classes, valid,
                                                task_cls)
    sim = pairwise_iou_yxyx(gt_boxes, anchor_boxes)
    matches = argmax_match(sim, valid, match_threshold, unmatched_threshold)
    res = _targets_from_matches(anchor_boxes, gt_boxes[None],
                                gt_classes[None], matches[None])
    return LabelResult(res.cls_targets[0], res.box_targets[0], matches,
                       res.num_positives[0])


def batch_label_anchors(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_classes: torch.Tensor, match_threshold: float = 0.5,
                        unmatched_threshold: Optional[float] = None,
                        kernels: bool = True) -> LabelResult:
    """Label a batch: GT [B, M, 4] / [B, M] -> flat [B, A] targets.

    K3 (``cuda_labeler.batch_match``) -> K4 (``cuda_labeler.
    batch_codes_targets``: thresholds, force-match and targets), two
    launches. The kernels launch for CUDA tensors, their plain versions
    (``batch_match_plain``, ``batch_codes_targets_plain``) run for CPU
    tensors;
    ``kernels=False`` runs the plain versions on any device (for holding
    the kernels against them). ``unmatched_threshold`` below
    ``match_threshold`` opens the ignore band (code and class target -2).
    """
    with span("odt.label"):
        if unmatched_threshold is None:
            unmatched_threshold = match_threshold
        gt_classes = gt_classes.to(torch.int32).contiguous()
        gt_boxes = gt_boxes.to(torch.float32).contiguous()
        anchor_boxes = anchor_boxes.to(device=gt_boxes.device,
                                       dtype=torch.float32).contiguous()
        valid = gt_classes > -1
        match = cuda_labeler.batch_match if kernels else \
            cuda_labeler.batch_match_plain
        targets = cuda_labeler.batch_codes_targets if kernels else \
            cuda_labeler.batch_codes_targets_plain
        vals, rows, best = match(anchor_boxes, gt_boxes, valid)
        matches, cls_targets, box_targets, num_positives = targets(
            anchor_boxes, gt_boxes, gt_classes, valid, vals, rows, best,
            match_threshold, unmatched_threshold)
        return LabelResult(cls_targets, box_targets, matches, num_positives)


class AnchorLabeler:
    """The reference AnchorLabeler API (effdet/anchors.py:305-438) over the
    functions above. The anchor table moves to the ground truth's device."""

    def __init__(self, anchors: Anchors, num_classes: int,
                 match_threshold: float = 0.5):
        self.anchors = anchors
        self.num_classes = num_classes
        self.match_threshold = match_threshold
        self._anchor_boxes = torch.from_numpy(anchors.boxes)

    def _boxes_on(self, device: torch.device) -> torch.Tensor:
        if self._anchor_boxes.device != device:
            self._anchor_boxes = self._anchor_boxes.to(device)
        return self._anchor_boxes

    def label_anchors(self, gt_boxes, gt_classes, task_cls=None):
        """One image -> (per-level cls targets [H, W, A], per-level box
        targets [H, W, A*4], num_positives)."""
        gt_boxes = torch.as_tensor(gt_boxes)
        res = label_anchors(self._boxes_on(gt_boxes.device), gt_boxes,
                            torch.as_tensor(gt_classes),
                            match_threshold=self.match_threshold,
                            task_cls=task_cls)
        cls_levels = [t[0] for t in _unpack_batched(self.anchors,
                                                    res.cls_targets[None])]
        box_levels = [t[0] for t in _unpack_batched(self.anchors,
                                                    res.box_targets[None])]
        return cls_levels, box_levels, res.num_positives

    def batch_label_anchors(self, gt_boxes, gt_classes, task_cls=None):
        """Batch -> (per-level [B, H, W, A] cls, per-level [B, H, W, A*4]
        box, [B] num_positives)."""
        gt_boxes = torch.as_tensor(gt_boxes)
        gt_classes = torch.as_tensor(gt_classes)
        anchor_boxes = self._boxes_on(gt_boxes.device)
        if task_cls is None:
            res = batch_label_anchors(anchor_boxes, gt_boxes, gt_classes,
                                      match_threshold=self.match_threshold)
        else:
            per_image = [label_anchors(anchor_boxes, b, c,
                                       match_threshold=self.match_threshold,
                                       task_cls=task_cls)
                         for b, c in zip(gt_boxes, gt_classes)]
            res = LabelResult(*(torch.stack([getattr(r, f.name)
                                             for r in per_image])
                                for f in dataclasses.fields(LabelResult)))
        return (_unpack_batched(self.anchors, res.cls_targets),
                _unpack_batched(self.anchors, res.box_targets),
                res.num_positives)

    def flat_label_anchors(self, gt_boxes, gt_classes) -> LabelResult:
        """Batch -> flat LabelResult (what the train step uses)."""
        gt_boxes = torch.as_tensor(gt_boxes)
        return batch_label_anchors(self._boxes_on(gt_boxes.device), gt_boxes,
                                   torch.as_tensor(gt_classes),
                                   match_threshold=self.match_threshold)


def _unpack_batched(anchors: Anchors, flat: torch.Tensor
                    ) -> List[torch.Tensor]:
    """[B, A_total, ...] -> per level [B, H_l, W_l, A*k]."""
    out = []
    offset = 0
    fs = anchors.feat_sizes
    batch = flat.shape[0]
    for level in range(anchors.min_level, anchors.max_level + 1):
        h, w = fs[level]
        steps = h * w * anchors.anchors_per_location
        out.append(flat[:, offset:offset + steps].reshape(batch, h, w, -1))
        offset += steps
    return out
