"""K3 (anchor match) and K4 (target encode) of the train-step labeler, as
hand-written CUDA kernels (csrc/label_match.cu, csrc/label_targets.cu),
with the plain torch step between them.

Replaces the Pallas TPU kernels of ``ood_object_detection_tpu.ops.
pallas_labeler``: ``pallas_batch_match`` (:146) and ``pallas_batch_targets``
(:201); ``label_match`` is the port of the thresholds and force-match of
``pallas_label_match`` (:249-280), plain torch.

``batch_match_plain`` and ``batch_targets_plain`` are the kernels' plain
versions. For tensors on the CPU the wrappers run them; for CUDA tensors
they launch the kernel or raise. Ties are resolved explicitly, as in the
JAX package: per anchor the lowest row with the max IoU, per row the
lowest anchor with the row's max, and force-match gives a contested
anchor to the lowest row.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .box_coder import encode_boxes
from .boxes import pairwise_iou_yxyx

MATCH_SOURCE = "label_match.cu"
TARGETS_SOURCE = "label_targets.cu"
# rows a match block stages in its shared memory (32 B a row, 48 KB)
MAX_ROWS = 1536


def _first_index_of_max(x: torch.Tensor, dim: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(max, the lowest index reaching it) along ``dim``, tie order made
    explicit rather than left to ``argmax``."""
    best = torch.amax(x, dim=dim, keepdim=True)
    n = x.shape[dim]
    shape = [1] * x.dim()
    shape[dim] = n
    iota = torch.arange(n, dtype=torch.int32, device=x.device).view(shape)
    idx = torch.amin(torch.where(x == best, iota, n), dim=dim)
    return best.squeeze(dim), idx.to(torch.int32)


def batch_match_plain(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                      valid: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """anchors [A, 4], gt [B, M, 4] yxyx f32, valid [B, M] bool ->
    (matched_vals [B, A] f32, matched rows [B, A] i32, best anchor of each
    row [B, M] i32). Invalid rows score -1. One image at a time, so the
    [M, A] IoU of one image is the largest temporary."""
    vals, rows, best = [], [], []
    for boxes, ok in zip(gt_boxes, valid):
        iou = pairwise_iou_yxyx(boxes, anchor_boxes)               # [M, A]
        masked = torch.where(ok[:, None], iou, torch.full_like(iou, -1.0))
        v, r = _first_index_of_max(masked, 0)
        vals.append(v)
        rows.append(r)
        best.append(_first_index_of_max(masked, 1)[1])
    return torch.stack(vals), torch.stack(rows), torch.stack(best)


def label_match(matched_vals: torch.Tensor, matches: torch.Tensor,
                best_anchor: torch.Tensor, valid: torch.Tensor,
                matched_threshold: float, unmatched_threshold: float
                ) -> torch.Tensor:
    """Final match codes [B, A] (>= 0 row, -1 unmatched, -2 ignored) from
    K3's outputs: the thresholds, then force-match, where every valid row
    claims its best anchor and the lowest row wins a contested anchor
    (scatter-min)."""
    below = matched_vals < unmatched_threshold
    between = (matched_vals >= unmatched_threshold) & \
        (matched_vals < matched_threshold)
    minus = torch.full_like(matches, -1)
    matches = torch.where(below, minus, matches)
    matches = torch.where(between, minus - 1, matches)

    b, m = valid.shape
    a = matches.shape[1]
    rows = torch.arange(m, dtype=torch.int32, device=matches.device)
    force = torch.full((b, a + 1), m, dtype=torch.int32, device=matches.device)
    # invalid rows claim the extra column a, which is dropped
    idx = torch.where(valid, best_anchor.long(), a)
    force.scatter_reduce_(1, idx, rows.expand(b, m), reduce="amin")
    force = force[:, :a]
    return torch.where(force < m, force, matches)


def batch_targets_plain(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                        gt_classes: torch.Tensor, matches: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """anchors [A, 4], gt [B, M, 4] f32, classes [B, M] i32, codes [B, A]
    i32 -> (class targets [B, A] i32 shifted by -1 with -1 background and
    -2 ignored, box targets [B, A, 4] f32, zero where unmatched)."""
    positive = matches >= 0
    safe = torch.clamp(matches, min=0).long()
    gathered = torch.where(positive, torch.gather(gt_classes, 1, safe),
                           torch.zeros_like(matches))
    cls_targets = torch.where(matches == -2, torch.full_like(matches, -2),
                              gathered - 1)
    matched_gt = torch.gather(gt_boxes, 1, safe.unsqueeze(-1).expand(-1, -1, 4))
    matched_gt = torch.where(positive.unsqueeze(-1), matched_gt,
                             torch.zeros_like(matched_gt))
    box_targets = encode_boxes(matched_gt, anchor_boxes.unsqueeze(0))
    box_targets = torch.where(positive.unsqueeze(-1), box_targets,
                              torch.zeros_like(box_targets))
    return cls_targets.to(torch.int32), box_targets.to(torch.float32)


def _check(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
           **others: torch.Tensor) -> Tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks shared by both kernels;
    returns (B, M, A)."""
    tensors = dict(anchor_boxes=anchor_boxes, gt_boxes=gt_boxes, **others)
    device = anchor_boxes.device
    for name, t in tensors.items():
        if t.device != device or device.type != "cuda":
            raise ValueError(f"{name} on {t.device}, anchors on {device}: "
                             "all must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name in ("anchor_boxes", "gt_boxes"):
        if tensors[name].dtype != torch.float32:
            raise TypeError(f"{name} is {tensors[name].dtype}; the kernel "
                            "takes float32")
        if tensors[name].data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (the kernels "
                             "read a box as one float4)")
    if anchor_boxes.dim() != 2 or anchor_boxes.shape[1] != 4 or \
            gt_boxes.dim() != 3 or gt_boxes.shape[2] != 4:
        raise ValueError(f"anchors {tuple(anchor_boxes.shape)} and gt "
                         f"{tuple(gt_boxes.shape)} must be [A, 4] and "
                         "[B, M, 4]")
    b, m, _ = gt_boxes.shape
    a = anchor_boxes.shape[0]
    if min(b, m, a) < 1 or m > MAX_ROWS or a >= 2 ** 31 // max(b, 1):
        raise ValueError(f"B={b}, M={m}, A={a}: the kernels take 1 <= M <= "
                         f"{MAX_ROWS} and B * A < 2^31")
    return b, m, a


def _match_launcher():
    fn = cuda_build.load(MATCH_SOURCE).match_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, i, i, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def batch_match(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: as ``batch_match_plain``; one launch for the batch on CUDA."""
    if all(t.device.type == "cpu" for t in (anchor_boxes, gt_boxes, valid)):
        return batch_match_plain(anchor_boxes, gt_boxes, valid)
    b, m, a = _check(anchor_boxes, gt_boxes, valid=valid)
    if valid.dtype != torch.bool or tuple(valid.shape) != (b, m):
        raise ValueError(f"valid {valid.dtype} {tuple(valid.shape)} must be "
                         f"bool [{b}, {m}]")
    dev = anchor_boxes.device
    vals = torch.empty((b, a), dtype=torch.float32, device=dev)
    rows = torch.empty((b, a), dtype=torch.int32, device=dev)
    best = torch.empty((b, m), dtype=torch.int32, device=dev)
    row_keys = torch.zeros((b, m), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        err = _match_launcher()(
            anchor_boxes.data_ptr(), a, gt_boxes.data_ptr(), valid.data_ptr(),
            b, m, vals.data_ptr(), rows.data_ptr(), row_keys.data_ptr(),
            best.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"label match kernel launch failed: CUDA error {err}")
    batch_match.launches += 1
    return vals, rows, best


batch_match.launches = 0


def _targets_launcher():
    fn = cuda_build.load(TARGETS_SOURCE).targets_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def batch_targets(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                  gt_classes: torch.Tensor, matches: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: as ``batch_targets_plain``; one launch for the batch on CUDA.
    Every code must be below M (``label_match``'s codes are)."""
    if all(t.device.type == "cpu"
           for t in (anchor_boxes, gt_boxes, gt_classes, matches)):
        return batch_targets_plain(anchor_boxes, gt_boxes, gt_classes, matches)
    b, m, a = _check(anchor_boxes, gt_boxes, gt_classes=gt_classes,
                     matches=matches)
    for name, t, shape in (("gt_classes", gt_classes, (b, m)),
                           ("matches", matches, (b, a))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} must be "
                             f"int32 {list(shape)}")
    dev = anchor_boxes.device
    cls_targets = torch.empty((b, a), dtype=torch.int32, device=dev)
    box_targets = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _targets_launcher()(
            anchor_boxes.data_ptr(), a, gt_boxes.data_ptr(),
            gt_classes.data_ptr(), matches.data_ptr(), b, m,
            cls_targets.data_ptr(), box_targets.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"label targets kernel launch failed: CUDA error "
                           f"{err}")
    batch_targets.launches += 1
    return cls_targets, box_targets


batch_targets.launches = 0
