"""K1: batched (soft-)NMS as a hand-written CUDA kernel (csrc/nms.cu).

Replaces the Pallas TPU kernel ``pallas_batched_nms``
(ood_object_detection_tpu/ops/pallas_nms.py:77). For tensors on the CPU
the wrapper runs the plain version, ``ops.nms.batched_nms_plain``; for
CUDA tensors it launches the kernel or raises.

The kernel spreads an image over one block, or over a thread block
cluster of 2, 4 or 8 blocks on neighbouring SMs when the batch would leave
SMs idle and the clusters are all resident at once (``cluster_size``);
each block holds its slice of the candidates in registers, one a thread up
to 1024 threads.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, Optional, Tuple

import torch

from . import cuda_build
from .nms import batched_nms_plain

SOURCE = "nms.cu"
CLUSTER_SIZES = (1, 2, 4, 8)      # the portable cluster sizes
MAX_PER_THREAD = 16               # candidates a thread holds in registers
# shared memory one block may use on sm_90 (227 KB), less 1 KB for the
# kernel's static shared memory; every block holds all N boxes, 16 B each
_MAX_DYNAMIC_SMEM = 232448 - 1024
MAX_CANDIDATES = min(_MAX_DYNAMIC_SMEM // 16, 1024 * MAX_PER_THREAD)


def cluster_size(batch: int, sms: int,
                 resident: Optional[Callable[[int], int]] = None) -> int:
    """CTAs an image: the largest of 1, 2, 4, 8 with batch * C <= sms and,
    where ``resident(C)`` says how many images the card holds at once at C
    CTAs an image, with all ``batch`` images resident at once (a second
    wave of clusters would double the time)."""
    return max(c for c in CLUSTER_SIZES if c == 1 or (
        batch * c <= sms and (resident is None or resident(c) >= batch)))


def check_cluster(cluster: int) -> None:
    """A forced cluster size must be a portable size, a power of two up to
    8; the grid is B * C blocks, so it divides the grid."""
    if cluster not in CLUSTER_SIZES:
        raise ValueError(f"cluster size {cluster} is not a power of two up "
                         f"to the portable 8: use one of {CLUSTER_SIZES}")


def _launcher():
    fn = cuda_build.load(SOURCE).nms_launch
    if fn.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, i, i, i, f, i, f, f, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=64)
def resident_images(device: int, n: int, cluster: int) -> int:
    """Images of n candidates that CUDA device ``device`` holds at once at
    ``cluster`` CTAs an image (the kernel's occupancy query)."""
    fn = cuda_build.load(SOURCE).nms_resident_images
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fit = ctypes.c_int(0)
    with torch.cuda.device(device):
        err = fn(n, cluster, ctypes.byref(fit))
    if err != 0:
        raise RuntimeError(f"nms occupancy query failed (cluster {cluster}): "
                           f"CUDA error {err}")
    return fit.value


def device_cluster_size(device: int, batch: int, n: int) -> int:
    """The CTAs an image ``batched_nms`` takes for [batch, n] candidates on
    CUDA device ``device``: ``cluster_size`` with the card's SMs and the
    kernel's occupancy query."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return cluster_size(batch, sms, lambda c: resident_images(device, n, c))


def batched_nms(boxes: torch.Tensor, scores: torch.Tensor,
                max_out: int = 100, iou_threshold: float = 0.5,
                soft: bool = False, sigma: float = 0.5,
                score_threshold: float = 0.001,
                cluster: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """boxes [B, N, 4] f32 xyxy (class-offset), scores [B, N] f32 ->
    (keep_idx [B, max_out] int32 with -1 padding, kept scores
    [B, max_out] f32). Hard NMS, or gaussian soft-NMS with ``soft``.
    ``cluster`` forces the CTAs an image (for holding every size against
    the plain version); by default ``device_cluster_size`` picks it."""
    if cluster is not None:
        check_cluster(cluster)
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
    if n > MAX_CANDIDATES:
        raise ValueError(f"N={n} candidates do not fit a block's shared "
                         f"memory (at most {MAX_CANDIDATES})")
    if not (boxes.is_contiguous() and scores.is_contiguous()):
        raise ValueError("boxes and scores must be contiguous")
    if cluster is None:
        dev = boxes.device.index if boxes.device.index is not None else \
            torch.cuda.current_device()
        cluster = device_cluster_size(dev, b, n)
    keep_idx = torch.empty((b, max_out), dtype=torch.int32,
                           device=boxes.device)
    keep_scores = torch.empty((b, max_out), dtype=torch.float32,
                              device=boxes.device)
    with torch.cuda.device(boxes.device):
        err = _launcher()(
            boxes.data_ptr(), scores.data_ptr(), b, n, max_out,
            float(iou_threshold), int(bool(soft)), float(sigma),
            float(score_threshold), cluster, keep_idx.data_ptr(),
            keep_scores.data_ptr(), cuda_build.stream_handle(boxes.device))
    if err != 0:
        raise RuntimeError(f"nms kernel launch failed (cluster {cluster}): "
                           f"CUDA error {err}")
    cuda_build.count_launch(batched_nms)
    return keep_idx, keep_scores


batched_nms.launches = 0
