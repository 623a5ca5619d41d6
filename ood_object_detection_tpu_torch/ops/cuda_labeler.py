"""K3 (anchor match) and K4 (match codes and targets) of the train-step
labeler, as hand-written CUDA kernels (csrc/label_match.cu,
csrc/label_targets.cu): two launches label a batch.

Replaces the Pallas TPU kernels of ``ood_object_detection_tpu.ops.
pallas_labeler``: ``pallas_batch_match`` (:146) and ``pallas_batch_targets``
(:201), with the XLA step between them, the thresholds and force-match of
``pallas_label_match`` (:249-280), inside K4; ``label_match`` is that
step's plain torch port.

``batch_match_plain`` and ``batch_codes_targets_plain`` (``label_match``,
then ``batch_targets_plain``) are the kernels' plain versions. For tensors
on the CPU the wrappers run them; for CUDA tensors they launch the kernel
or raise. Ties are resolved explicitly, as in the JAX package: per anchor
the lowest row with the max IoU, per row the lowest anchor with the row's
max, and force-match gives a contested anchor to the lowest row.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from . import cuda_build
from .box_coder import encode_boxes
from .boxes import pairwise_iou_yxyx

MATCH_SOURCE = "label_match.cu"
TARGETS_SOURCE = "label_targets.cu"
# K3 keeps each of an image's rows in a CTA's shared memory (box, area, row
# index, u64 key: 32 B a row, 48 KB at this limit, above the 48 KB a launch
# takes without opting in); K4 keeps box, class and best anchor (24 B a
# row, 36 KB) beside 8 KB of claims
MAX_ROWS = 1536
# CTAs of K3's thread block cluster an image (the portable cluster size)
MATCH_CLUSTER = 8


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


def batch_codes_targets_plain(
        anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
        gt_classes: torch.Tensor, valid: torch.Tensor,
        matched_vals: torch.Tensor, matches: torch.Tensor,
        best_anchor: torch.Tensor, matched_threshold: float,
        unmatched_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3's outputs -> (match codes [B, A] i32, class targets [B, A] i32,
    box targets [B, A, 4] f32, positives of each image [B] f32):
    ``label_match``, then ``batch_targets_plain``."""
    codes = label_match(matched_vals, matches, best_anchor, valid,
                        matched_threshold, unmatched_threshold)
    cls_targets, box_targets = batch_targets_plain(anchor_boxes, gt_boxes,
                                                   gt_classes, codes)
    return (codes, cls_targets, box_targets,
            (codes >= 0).to(torch.float32).sum(dim=1))


# dtype and shape ("m": [B, M], "a": [B, A]) of each tensor a kernel takes
# beside the anchors and the ground-truth boxes
_TAKES = {"valid": (torch.bool, "m"), "gt_classes": (torch.int32, "m"),
          "best_anchor": (torch.int32, "m"),
          "matched_vals": (torch.float32, "a"), "matches": (torch.int32, "a")}


def _check(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
           **others: torch.Tensor) -> Tuple[int, int, int]:
    """Device, dtype, shape and contiguity checks shared by both kernels;
    returns (B, M, A)."""
    device = anchor_boxes.device
    if device.type != "cuda":
        raise ValueError(f"anchors on {device}: the kernels take CUDA "
                         "tensors")
    for name, t in (("anchor_boxes", anchor_boxes), ("gt_boxes", gt_boxes),
                    *others.items()):
        if t.device != device:
            raise ValueError(f"{name} on {t.device}, anchors on {device}: "
                             "all must be on one CUDA device")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    for name, t in (("anchor_boxes", anchor_boxes), ("gt_boxes", gt_boxes)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if t.data_ptr() % 16:
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
    for name, t in others.items():
        dtype, cols = _TAKES[name]
        shape = (b, m if cols == "m" else a)
        if t.dtype != dtype or t.shape != shape:
            raise ValueError(f"{name} {t.dtype} {tuple(t.shape)} must be "
                             f"{dtype} {list(shape)}")
    return b, m, a


def match_share(num_anchors: int) -> int:
    """Anchors of each CTA of K3's cluster: CTA r takes [r * share,
    (r + 1) * share) of the image's anchors, the last one what is left."""
    return -(-num_anchors // MATCH_CLUSTER)


def match_shares(num_anchors: int) -> List[Tuple[int, int]]:
    """The [lo, hi) anchor range of each CTA of K3's cluster, in rank
    order (an empty range where the anchors run out)."""
    share = match_share(num_anchors)
    return [(min(num_anchors, r * share), min(num_anchors, (r + 1) * share))
            for r in range(MATCH_CLUSTER)]


def _match_launcher():
    fn = cuda_build.load(MATCH_SOURCE).match_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, p, i, i, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def batch_match(anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
                valid: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3: as ``batch_match_plain``; on CUDA one launch for the batch, a
    cluster of MATCH_CLUSTER CTAs an image, nothing allocated but the
    outputs."""
    if all(t.device.type == "cpu" for t in (anchor_boxes, gt_boxes, valid)):
        return batch_match_plain(anchor_boxes, gt_boxes, valid)
    b, m, a = _check(anchor_boxes, gt_boxes, valid=valid)
    dev = anchor_boxes.device
    vals = torch.empty((b, a), dtype=torch.float32, device=dev)
    rows = torch.empty((b, a), dtype=torch.int32, device=dev)
    best = torch.empty((b, m), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _match_launcher()(
            anchor_boxes.data_ptr(), a, match_share(a), gt_boxes.data_ptr(),
            valid.data_ptr(), b, m, vals.data_ptr(), rows.data_ptr(),
            best.data_ptr(), cuda_build.stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"label match kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(batch_match)
    return vals, rows, best


batch_match.launches = 0


def _targets_launcher():
    fn = cuda_build.load(TARGETS_SOURCE).codes_targets_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, i, p, p, p, p, p, p, i, i, f, f, p, p, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def batch_codes_targets(
        anchor_boxes: torch.Tensor, gt_boxes: torch.Tensor,
        gt_classes: torch.Tensor, valid: torch.Tensor,
        matched_vals: torch.Tensor, matches: torch.Tensor,
        best_anchor: torch.Tensor, matched_threshold: float,
        unmatched_threshold: float
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """K4: as ``batch_codes_targets_plain``, from K3's outputs (matched
    values, rows, best anchors); on CUDA one kernel launch for the batch
    (after a memset of the positive counts), nothing allocated but the
    outputs. The thresholds are compared in f32, as the plain version
    compares an f32 tensor with them."""
    tensors = (gt_boxes, gt_classes, valid, matched_vals, matches,
               best_anchor)
    if anchor_boxes.device.type == "cpu" and \
            all(t.device.type == "cpu" for t in tensors):
        return batch_codes_targets_plain(anchor_boxes, *tensors,
                                         matched_threshold,
                                         unmatched_threshold)
    b, m, a = _check(anchor_boxes, gt_boxes, gt_classes=gt_classes,
                     valid=valid, matched_vals=matched_vals, matches=matches,
                     best_anchor=best_anchor)
    if b > 65535:
        raise ValueError(f"B={b}: the kernel takes at most 65535 images")
    dev = anchor_boxes.device
    codes = torch.empty((b, a), dtype=torch.int32, device=dev)
    cls_targets = torch.empty((b, a), dtype=torch.int32, device=dev)
    box_targets = torch.empty((b, a, 4), dtype=torch.float32, device=dev)
    num_positives = torch.empty((b,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = _targets_launcher()(
            anchor_boxes.data_ptr(), a, *(t.data_ptr() for t in tensors), b,
            m, matched_threshold, unmatched_threshold, codes.data_ptr(),
            cls_targets.data_ptr(), box_targets.data_ptr(),
            num_positives.data_ptr(), cuda_build.stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"label codes / targets kernel launch failed: CUDA "
                           f"error {err}")
    cuda_build.count_launch(batch_codes_targets)
    return codes, cls_targets, box_targets, num_positives


batch_codes_targets.launches = 0
