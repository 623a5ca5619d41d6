"""The benchmark's yardstick: the card's published peaks, the least time
each hand-written kernel could take on its inputs, and the FLOPs of a
model call counted on the reference.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 989e12
bf16 tensor FLOP/s, 3.35e12 bytes/s of device memory, and 67e12 f32
FLOP/s outside the tensor cores, which counts a fused multiply-add as two
operations; the kernels run compares, min / max, adds and multiplies, one
operation an instruction, so half of it.

A kernel's bound is the larger of its bytes over the memory rate and its
operations over the f32 rate, the work counted from its inputs and from
the reference's answers, never from the program's: each input byte read
once, each output byte written once.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch.utils.flop_counter import FlopCounterMode

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
MATCH_OPS_PER_PAIR = 10      # K3: each valid (row, anchor) pair
MATCH_OPS_PER_MEET = 7       # K3: more for each pair whose boxes meet


def _bound(nbytes: float, ops: float) -> float:
    """Least seconds of a kernel that moves ``nbytes`` and computes
    ``ops`` f32 operations."""
    return max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S)


def k2_bound_s(batch: int, anchors: int, classes: int) -> float:
    """K2, the per-anchor key + energy reduce: every bf16 logit read once,
    a key and an energy (f32) written per anchor; about 9 operations a
    logit (key 5, energy 4)."""
    logits = batch * anchors * classes
    return _bound(logits * 2 + batch * anchors * 8, logits * 9)


def k1_bound_s(iterations: int, batch: int, candidates: int,
               max_out: int) -> float:
    """K1, soft-NMS: boxes and scores in (20 B a candidate), picks out
    (8 B a row); each iteration that runs (a pick, and the one that finds
    nothing left) scans and decays every candidate, 20 operations each.
    ``iterations`` counts them over the batch from the reference's picks."""
    return _bound(batch * candidates * 20 + batch * max_out * 8,
                  iterations * candidates * 20)


def k1_iterations(picks_per_image, max_out: int) -> int:
    """Iterations K1 runs: each image's picks, plus one that finds nothing
    where it ran out before ``max_out``."""
    return sum(min(int(p) + 1, max_out) for p in picks_per_image)


def meeting_pairs(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                  valid: torch.Tensor) -> int:
    """Valid (row, anchor) pairs whose yxyx boxes meet, image by image."""
    total = 0
    for boxes, ok in zip(gt_boxes, valid):
        g = boxes[ok][:, None]
        ih = (torch.minimum(g[..., 2], anchors[:, 2])
              - torch.maximum(g[..., 0], anchors[:, 0])).clamp(min=0)
        iw = (torch.minimum(g[..., 3], anchors[:, 3])
              - torch.maximum(g[..., 1], anchors[:, 1])).clamp(min=0)
        total += int((ih * iw != 0).sum())
    return total


def k3_bound_s(anchors: int, batch: int, rows: int, valid_rows: int,
               meets: int) -> float:
    """K3, the anchor match: anchors and rows in, each anchor's best IoU and
    row and each row's best anchor out; 10 operations a valid (row,
    anchor) pair and 7 more where the boxes meet."""
    nbytes = anchors * 16 + batch * rows * 17 + batch * anchors * 8 \
        + batch * rows * 4
    ops = valid_rows * anchors * MATCH_OPS_PER_PAIR + meets * MATCH_OPS_PER_MEET
    return _bound(nbytes, ops)


def k4_bound_s(anchors: int, batch: int, rows: int, positives: int) -> float:
    """K4, match codes and targets: each anchor's IoU and row read (8 B) and
    its code, class and box written (24 B), anchors and rows read once;
    4 operations an anchor and 20 a positive (the box encode)."""
    nbytes = batch * anchors * 32 + anchors * 16 + batch * rows * 25
    return _bound(nbytes, batch * anchors * 4 + positives * 20)


def conv_backward_flop(grad_out_shape, x_shape, w_shape, _bias, _stride,
                       _padding, _dilation, transposed, _output_padding,
                       _groups, output_mask, out_shape=None, **_) -> int:
    """``aten.convolution_backward``: each gradient asked for (input,
    weight) costs the forward's multiply-adds. FlopCounterMode's own
    formula leaves the groups out of the weight gradient and so counts a
    depthwise convolution's C times over."""
    forward_out = x_shape if transposed else grad_out_shape
    macs = math.prod(forward_out) * math.prod(w_shape[1:])
    return 2 * macs * (int(output_mask[0]) + int(output_mask[1]))


def count_flops(fn: Callable[[], None]) -> float:
    """Matrix and convolution FLOPs of ``fn()``, forward and any backward
    it runs (two a multiply-add)."""
    with FlopCounterMode(display=False, custom_mapping={
            torch.ops.aten.convolution_backward: conv_backward_flop}) as f:
        fn()
    return float(f.get_total_flops())


def model_flops(model_cls, cfg: Dict, batch: int, train: bool) -> float:
    """FLOPs of the reference model at ``cfg``'s image size on ``batch``
    images, built on the ``meta`` device: the forward, and with ``train``
    the backward of every parameter's gradient too."""
    h, w = cfg["image_size"]
    with torch.device("meta"):
        model = model_cls(cfg)
        images = torch.empty((batch, h, w, 3))

    def call():
        cls_out, box_out = model(images)
        if train:
            sum(o.sum() for o in cls_out + box_out).backward()
    if not train:
        with torch.no_grad():
            return count_flops(call)
    return count_flops(call)


def share(bound_s: float, measured_s: float) -> Optional[float]:
    """A roofline share in %, or None where nothing was measured."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * bound_s / measured_s
