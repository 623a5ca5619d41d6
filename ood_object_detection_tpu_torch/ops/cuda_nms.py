"""K1: batched (soft-)NMS as a hand-written CUDA kernel (csrc/nms.cu).

Replaces the Pallas TPU kernel ``pallas_batched_nms``
(ood_object_detection_tpu/ops/pallas_nms.py:77). For tensors on the CPU
the wrapper runs the plain version, ``ops.nms.batched_nms_plain``; for
CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build
from .nms import batched_nms_plain

SOURCE = "nms.cu"
# shared memory one block may use on sm_90 (227 KB), less 1 KB for the
# kernel's static shared memory
_MAX_DYNAMIC_SMEM = 232448 - 1024


def _launcher():
    fn = cuda_build.load(SOURCE).nms_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, i, i, f, i, f, f, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                max_out: int = 100, iou_threshold: float = 0.5,
                soft: bool = False, sigma: float = 0.5,
                score_threshold: float = 0.001
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [B, N, 4] f32 xyxy (class-offset), scores [B, N] f32 ->
    (keep_idx [B, max_out] int32 with -1 padding, kept scores
    [B, max_out] f32). Hard NMS, or gaussian soft-NMS with ``soft``."""
    if boxes.device.type == "cpu" and scores.device.type == "cpu":
        return batched_nms_plain(boxes, scores, max_out, iou_threshold, soft,
                                 sigma, score_threshold)
    if boxes.device.type != "cuda" or scores.device != boxes.device:
        raise ValueError(f"boxes on {boxes.device}, scores on "
                         f"{scores.device}: both must be on one CUDA device")
    if boxes.dtype != torch.float32 or scores.dtype != torch.float32:
        raise TypeError(f"boxes {boxes.dtype}, scores {scores.dtype}: "
                        "the kernel takes float32")
    if boxes.dim() != 3 or boxes.shape[2] != 4 or \
            scores.shape != boxes.shape[:2]:
        raise ValueError(f"boxes {tuple(boxes.shape)} and scores "
                         f"{tuple(scores.shape)} must be [B, N, 4] and [B, N]")
    b, n = scores.shape
    if b < 1 or n < 1 or max_out < 1:
        raise ValueError(f"empty input: B={b}, N={n}, max_out={max_out}")
    if 6 * n * 4 > _MAX_DYNAMIC_SMEM:
        raise ValueError(f"N={n} candidates do not fit one block's shared "
                         f"memory (at most {_MAX_DYNAMIC_SMEM // 24})")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    keep_idx = torch.empty((b, max_out), dtype=torch.int32,
                           device=boxes.device)
    keep_scores = torch.empty((b, max_out), dtype=torch.float32,
                              device=boxes.device)
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _launcher()(
            boxes.data_ptr(), scores.data_ptr(), b, n, max_out,
            float(iou_threshold), int(bool(soft)), float(sigma),
            float(score_threshold), keep_idx.data_ptr(),
            keep_scores.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed: CUDA error {err}")
    batched_nms.launches += 1
    return keep_idx, keep_scores


batched_nms.launches = 0
