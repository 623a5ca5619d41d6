"""K2: per-anchor packed (logit, class) key + energy over bf16 class
logits, as a hand-written CUDA kernel (csrc/key_reduce.cu).

Replaces the Pallas TPU kernel ``fused_key_ood_reduce``
(ood_object_detection_tpu/ops/pallas_reduce.py:118), which the JAX
package leaves unwired because XLA fuses ``_packed_f32_key_reduce``
(post_process.py:95-148) into one pass on the TPU. PyTorch eager has no
such fusion, so in the port this kernel is that pass.

``key_energy_reduce_plain`` is the plain version: the torch translation of
``_packed_f32_key_reduce`` with the energy of ``_anchor_ood_reduce``. For
tensors on the CPU the wrapper runs it; for CUDA tensors it launches the
kernel, once per pyramid level, or raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import torch

from . import cuda_build
from .ood import energy_score

SOURCE = "key_reduce.cu"


def _split(lvl: torch.Tensor, num_classes: int) -> Tuple[int, int]:
    """(batch, anchors per image) of a [B, H, W, A*C] level."""
    if lvl.dim() != 4 or lvl.shape[3] % num_classes:
        raise ValueError(f"level {tuple(lvl.shape)} is not [B, H, W, A*C] "
                         f"with C={num_classes}")
    b, h, w, ac = lvl.shape
    return b, h * w * (ac // num_classes)


def _check(cls_outputs: List[torch.Tensor], num_classes: int) -> None:
    if not 0 < num_classes <= 256:
        raise ValueError(f"the packed key holds at most 256 classes, "
                         f"not {num_classes}")
    for lvl in cls_outputs:
        if lvl.dtype != torch.bfloat16:
            raise TypeError(f"the packed key reads bf16 logits, not "
                            f"{lvl.dtype}")


def key_energy_reduce_plain(cls_outputs: List[torch.Tensor],
                            num_classes: int, energy: bool
                            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Per-level [B, H, W, A*C] bf16 logits -> (key_all [B, A_tot] f32,
    energy_all [B, A_tot] f32 or None).

    key = max_c(mono16(bits) * 256 + (255 - c)), where mono16 is the
    order-preserving u16 transform of the bf16 bits: logit-major, ties to
    the lowest class, exact in f32 (< 2^24).
    """
    _check(cls_outputs, num_classes)
    keys, energies = [], []
    for lvl in cls_outputs:
        b, _ = _split(lvl, num_classes)
        r = lvl.reshape(*lvl.shape[:3], -1, num_classes)
        bits = r.view(torch.int16).to(torch.int32) & 0xFFFF
        mono = torch.where(bits >= 0x8000, 0xFFFF - bits, bits | 0x8000)
        cls_ids = torch.arange(num_classes, dtype=torch.int32,
                               device=lvl.device)
        key = mono * 256 + (255 - cls_ids)
        keys.append(torch.amax(key, dim=-1).to(torch.float32).reshape(b, -1))
        if energy:
            energies.append(energy_score(r.to(torch.float32)).reshape(b, -1))
    key_all = torch.cat(keys, dim=1)
    return key_all, (torch.cat(energies, dim=1) if energy else None)


def _launcher():
    fn = cuda_build.load(SOURCE).key_energy_launch
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, ctypes.c_longlong, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def key_energy_reduce(cls_outputs: List[torch.Tensor], num_classes: int,
                      energy: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """As ``key_energy_reduce_plain``; on CUDA one kernel launch per level.

    Each level must be the NHWC view of a channels_last head output,
    contiguous in that view: the kernel reads it in place, and a quiet
    copy of the logits (over 1 GB at D0@512, batch 128) is refused.
    """
    if all(lvl.device.type == "cpu" for lvl in cls_outputs):
        return key_energy_reduce_plain(cls_outputs, num_classes, energy)
    _check(cls_outputs, num_classes)
    device = cls_outputs[0].device
    shapes = [_split(lvl, num_classes) for lvl in cls_outputs]
    batch = shapes[0][0]
    for lvl, (b, _) in zip(cls_outputs, shapes):
        if lvl.device != device or device.type != "cuda":
            raise ValueError(f"levels on {lvl.device} and {device}: all must "
                             "be on one CUDA device")
        if b != batch:
            raise ValueError(f"levels disagree on the batch: {b} vs {batch}")
        if not lvl.is_contiguous():
            raise ValueError(
                f"level {tuple(lvl.shape)} is not contiguous as NHWC; pass "
                "the permute(0, 2, 3, 1) view of a channels_last output")
    a_total = sum(n for _, n in shapes)
    key_all = torch.empty((batch, a_total), dtype=torch.float32, device=device)
    energy_all = (torch.empty((batch, a_total), dtype=torch.float32,
                              device=device) if energy else None)
    launch = _launcher()
    offset = 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        for lvl, (b, n) in zip(cls_outputs, shapes):
            err = launch(lvl.data_ptr(), b * n, n, num_classes, a_total,
                         offset, key_all.data_ptr(),
                         energy_all.data_ptr() if energy else None, stream)
            if err != 0:
                raise RuntimeError(
                    f"key/energy kernel launch failed: CUDA error {err}")
            key_energy_reduce.launches += 1
            offset += n
    return key_all, energy_all


key_energy_reduce.launches = 0
