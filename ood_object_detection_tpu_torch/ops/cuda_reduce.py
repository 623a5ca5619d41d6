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
kernel, once for all pyramid levels, or raises. ``tile_plan`` cuts the
levels into the tiles the kernel's persistent grid walks.
"""
from __future__ import annotations

import ctypes
from typing import Iterator, List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import cuda_build
from .ood import energy_score

SOURCE = "key_reduce.cu"
MAX_LEVELS = 8
TILE_ROWS = 32            # rows a tile: one a lane of the warp reducing it


class TilePlan(NamedTuple):
    """How the kernel walks the levels: level l has ``rows[l]`` anchor rows
    of ``row_bytes`` (B*H*W*A rows, ``rows_per_image[l]`` an image) written
    to columns ``col_offsets[l]`` + j of the [B, ``a_total``] outputs, cut
    into tiles of ``tile_rows``; its tiles are numbered from
    ``first_tile[l]``, and ``first_tile[-1]`` counts them all."""
    rows: Tuple[int, ...]
    rows_per_image: Tuple[int, ...]
    col_offsets: Tuple[int, ...]
    first_tile: Tuple[int, ...]
    tile_rows: int
    row_bytes: int
    a_total: int

    @property
    def total_tiles(self) -> int:
        return self.first_tile[-1]


def tile_plan(shapes: Sequence[Sequence[int]], num_classes: int
              ) -> TilePlan:
    """The tile plan of levels of shapes [B, H, W, A*C] (C = num_classes).
    A tile holds TILE_ROWS rows of 2*C bytes (a multiple of 8 rows, so each
    starts at a multiple of 16 bytes from its level's base)."""
    if not 1 <= len(shapes) <= MAX_LEVELS:
        raise ValueError(f"{len(shapes)} levels: the kernel takes 1 to "
                         f"{MAX_LEVELS}")
    row_bytes = 2 * num_classes
    tile_rows = TILE_ROWS
    batch = shapes[0][0]
    rows, per_image, offsets, first = [], [], [], [0]
    a_total = 0
    for shape in shapes:
        b, per = _split_shape(tuple(shape), num_classes)
        if b != batch:
            raise ValueError(f"levels disagree on the batch: {b} vs {batch}")
        if b * per >= 2 ** 31:
            raise ValueError(f"level {tuple(shape)} has {b * per} anchor "
                             "rows; the kernel indexes fewer than 2^31")
        rows.append(b * per)
        per_image.append(per)
        offsets.append(a_total)
        first.append(first[-1] + -(-b * per // tile_rows))
        a_total += per
    return TilePlan(tuple(rows), tuple(per_image), tuple(offsets),
                    tuple(first), tile_rows, row_bytes, a_total)


def plan_tiles(plan: TilePlan) -> Iterator[Tuple[int, int, int, int, bool]]:
    """(level, first row, rows, byte offset in the level, bulk-copied) of
    every tile, as the kernel's ``locate`` computes them: a tile whose size
    is not a multiple of 16 bytes (a level's ragged last tile) is read in
    place, not copied."""
    for t in range(plan.total_tiles):
        level = max(l for l in range(len(plan.rows))
                    if plan.first_tile[l] <= t)
        row0 = (t - plan.first_tile[level]) * plan.tile_rows
        rows = min(plan.tile_rows, plan.rows[level] - row0)
        yield (level, row0, rows, row0 * plan.row_bytes,
               rows * plan.row_bytes % 16 == 0)


def _split_shape(shape: Tuple[int, ...], num_classes: int) -> Tuple[int, int]:
    """(batch, anchors per image) of a [B, H, W, A*C] level."""
    if len(shape) != 4 or shape[3] % num_classes:
        raise ValueError(f"level {shape} is not [B, H, W, A*C] with "
                         f"C={num_classes}")
    b, h, w, ac = shape
    return b, h * w * (ac // num_classes)


def _check(cls_outputs: List[torch.Tensor], num_classes: int) -> None:
    """What the kernel takes, held on every device: bf16, at most 256
    classes, and each level 16-byte aligned (the bulk copies' rule)."""
    if not 0 < num_classes <= 256:
        raise ValueError(f"the packed key holds at most 256 classes, "
                         f"not {num_classes}")
    for lvl in cls_outputs:
        if lvl.dtype != torch.bfloat16:
            raise TypeError(f"the packed key reads bf16 logits, not "
                            f"{lvl.dtype}")
        if lvl.data_ptr() % 16:
            raise ValueError(f"level {tuple(lvl.shape)} starts at "
                             f"{lvl.data_ptr():#x}, not 16-byte aligned")


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
        b, _ = _split_shape(tuple(lvl.shape), num_classes)
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
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, p, p, p]
        fn.restype = ctypes.c_int
    return fn


def key_energy_reduce(cls_outputs: List[torch.Tensor], num_classes: int,
                      energy: bool
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """As ``key_energy_reduce_plain``; on CUDA one kernel launch for all
    levels.

    Each level must be the NHWC view of a channels_last head output,
    contiguous in that view and 16-byte aligned: the kernel copies it in
    place, and a quiet copy of the logits (over 1 GB at D0@512, batch 128)
    is refused.
    """
    _check(cls_outputs, num_classes)
    if all(lvl.device.type == "cpu" for lvl in cls_outputs):
        return key_energy_reduce_plain(cls_outputs, num_classes, energy)
    device = cls_outputs[0].device
    for lvl in cls_outputs:
        if lvl.device != device or device.type != "cuda":
            raise ValueError(f"levels on {lvl.device} and {device}: all must "
                             "be on one CUDA device")
        if not lvl.is_contiguous():
            raise ValueError(
                f"level {tuple(lvl.shape)} is not contiguous as NHWC; pass "
                "the permute(0, 2, 3, 1) view of a channels_last output")
    plan = tile_plan([tuple(lvl.shape) for lvl in cls_outputs], num_classes)
    batch = cls_outputs[0].shape[0]
    key_all = torch.empty((batch, plan.a_total), dtype=torch.float32,
                          device=device)
    energy_all = (torch.empty((batch, plan.a_total), dtype=torch.float32,
                              device=device) if energy else None)
    if plan.total_tiles == 0:               # no anchors: nothing to launch
        return key_all, energy_all
    n = len(cls_outputs)
    ptrs = (ctypes.c_void_p * n)(*[lvl.data_ptr() for lvl in cls_outputs])
    rows = (ctypes.c_longlong * n)(*plan.rows)
    per_image = (ctypes.c_int * n)(*plan.rows_per_image)
    offsets = (ctypes.c_int * n)(*plan.col_offsets)
    first = (ctypes.c_int * (n + 1))(*plan.first_tile)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    with torch.cuda.device(device):
        err = _launcher()(ptrs, rows, per_image, offsets, first, n,
                          num_classes, plan.tile_rows, sms, plan.a_total,
                          key_all.data_ptr(),
                          energy_all.data_ptr() if energy else None,
                          cuda_build.stream_handle(device))
    if err != 0:
        raise RuntimeError(f"key/energy kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(key_energy_reduce)
    return key_all, energy_all


key_energy_reduce.launches = 0
