"""The optimizer update's global-norm clip and EMA over every parameter
tensor at once, as hand-written multi-tensor CUDA kernels
(csrc/multi_tensor.cu): a launch walks up to 239 tensors (159 pairs for
the EMA), where the plain loops launch 7 kernels a tensor for the clip and
4 for the EMA.

Replaces no Pallas kernel: the JAX package's update (optax's
``clip_by_global_norm`` and the EMA's ``tree_map`` in
``ood_object_detection_tpu.train.train_state``) is part of one jitted XLA
program, which fuses it.

``global_norm_clip_`` and ``ema_update_`` run the plain versions, the
train step's per-tensor loops, when no tensor is on the card, which is
every CPU caller. On the card they launch the kernels, or raise: a
TypeError for a dtype other than float32, a ValueError for tensors on
more than one device, not dense in memory (contiguous or channels_last
are: the kernels walk memory, not indices) or, for the EMA, not of its
parameter's size and layout. Each function counts its calls that
launched the kernels (``launches``).

The clip and the EMA round like the plain versions (the kernels are built
with -fmad=false). The norm's sum runs in another order than the plain
path's ``torch.sum`` calls, so the two norms may differ by a few ulps, and
with them the clipped tensors; the kernels' sum is deterministic.
"""
from __future__ import annotations

import array
import ctypes
import operator
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cuda_build

SOURCE = "multi_tensor.cu"
# the kernels' tables keep a tensor's size as an int32
MAX_NUMEL = 2 ** 31 - 1
_F32 = torch.float32
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {
    "multi_tensor_chunk": [],
    "global_norm_launch": [_p, _p, _i, _p, _i, _p, _p],
    "clip_scale_launch": [_p, _p, _i, _p, _f, _p],
    "ema_launch": [_p, _p, _p, _i, _f, _f, _p],
}


def global_norm_plain(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """The global norm of ``tensors``, a 0-d tensor (no sync)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in tensors))


def clip_scale_plain_(tensors: Sequence[torch.Tensor], norm: torch.Tensor,
                      max_norm: float) -> None:
    """``g / norm * max_norm`` in place on each tensor, only when ``norm >=
    max_norm`` (decided on the device)."""
    keep = norm < max_norm
    for g in tensors:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def global_norm_clip_plain_(tensors: Sequence[torch.Tensor],
                            max_norm: float) -> torch.Tensor:
    """``global_norm_clip_``'s plain version, one tensor at a time."""
    norm = global_norm_plain(tensors)
    if max_norm:
        clip_scale_plain_(tensors, norm, max_norm)
    return norm


def ema_update_plain_(ema: Sequence[torch.Tensor],
                      params: Sequence[torch.Tensor], decay) -> None:
    """``ema_update_``'s plain version, one pair at a time."""
    d = np.float32(decay)
    one_minus = np.float32(1.0) - d
    for e, p in zip(ema, params):
        e.copy_(e * float(d) + p * float(one_minus))


def _launcher(name: str):
    fn = getattr(cuda_build.load(SOURCE), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _dense(t: torch.Tensor) -> bool:
    return t.is_contiguous() or t.is_contiguous(
        memory_format=torch.channels_last)


# per-tensor reads mapped over a list: a D0 train step's 424 tensors take
# 0.2-0.3 ms of host time a list, a quarter less than one loop over them
_DTYPE = operator.attrgetter("dtype")
_DEVICE = torch.Tensor.get_device
_CONTIGUOUS = torch.Tensor.is_contiguous
_NUMEL = torch.Tensor.numel
_DATA_PTR = torch.Tensor.data_ptr


def _on_card(*lists: Sequence[torch.Tensor]) -> bool:
    """False when no tensor of ``lists`` is on the card (the plain path),
    True when all are on one CUDA device; raises a ValueError when they
    are spread over devices."""
    devices = set()
    for tensors in lists:
        devices.update(map(_DEVICE, tensors))
    if not devices or devices == {-1}:
        return False
    if len(devices) != 1:
        raise ValueError(f"the update kernels take tensors on one CUDA "
                         f"device; got device indices {sorted(devices)} "
                         f"(-1: off the card)")
    return True


def _layout(tensors: Sequence[torch.Tensor]) -> Tuple[list, list, list]:
    """(addresses, sizes, whether each is contiguous) of CUDA tensors;
    raises a TypeError for a dtype other than float32 and a ValueError for
    a tensor that is not dense in memory or holds more than MAX_NUMEL
    values."""
    dtypes = set(map(_DTYPE, tensors))
    if dtypes != {_F32}:
        raise TypeError(f"the update kernels take float32 tensors; got "
                        f"{sorted(map(str, dtypes))}")
    contiguous = list(map(_CONTIGUOUS, tensors))
    for i, (c, t) in enumerate(zip(contiguous, tensors)):
        if not (c or _dense(t)):
            raise ValueError(f"the update kernels take tensors dense in "
                             f"memory; tensor {i} of shape "
                             f"{tuple(t.shape)} has strides {t.stride()}")
    sizes = list(map(_NUMEL, tensors))
    if max(sizes) > MAX_NUMEL:
        raise ValueError(f"the update kernels take tensors of at most "
                         f"{MAX_NUMEL} values; got {max(sizes)}")
    return list(map(_DATA_PTR, tensors)), sizes, contiguous


def _table(tensors: Sequence[torch.Tensor]
           ) -> Tuple[array.array, array.array]:
    """(addresses, sizes) of ``tensors`` as int64 arrays."""
    ptrs, sizes, _ = _layout(tensors)
    return array.array("q", ptrs), array.array("q", sizes)


def _pair_table(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor]
                ) -> Tuple[array.array, array.array, array.array]:
    """(EMA addresses, parameter addresses, sizes) as int64 arrays; raises
    a ValueError unless the two tensors of each pair are of one size and
    both contiguous or of the same strides."""
    if len(ema) != len(params):
        raise ValueError(f"{len(ema)} EMA tensors for {len(params)} "
                         f"parameters")
    mine, theirs = _layout(ema), _layout(params)
    for i, (a, b, c, d) in enumerate(zip(mine[1], theirs[1], mine[2],
                                         theirs[2])):
        if a != b or not (c and d) and ema[i].stride() != params[i].stride():
            raise ValueError(
                f"EMA tensor {i} (shape {tuple(ema[i].shape)}, strides "
                f"{ema[i].stride()}) is not laid out as its parameter "
                f"(shape {tuple(params[i].shape)}, strides "
                f"{params[i].stride()})")
    return (array.array("q", mine[0]), array.array("q", theirs[0]),
            array.array("q", theirs[1]))


def _address(a: array.array) -> int:
    return a.buffer_info()[0]


def global_norm_clip_(tensors: Sequence[torch.Tensor],
                      max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on ``tensors``: each becomes
    ``g / norm * max_norm`` when the global norm reaches ``max_norm`` (no
    clip when ``max_norm`` is 0). Returns the global norm of the unclipped
    tensors, a 0-d tensor on their device (no sync). On the card, one
    launch of the sum of squares and one of the clip for every 239
    tensors, and one launch of the norm."""
    if not _on_card(tensors):
        return global_norm_clip_plain_(tensors, max_norm)
    ptrs, sizes = _table(tensors)
    n = len(sizes)
    dev = tensors[0].device
    capacity = sum(sizes) // _launcher("multi_tensor_chunk")() + n
    partials = torch.empty((capacity,), dtype=_F32, device=dev)
    norm = torch.empty((), dtype=_F32, device=dev)
    stream = cuda_build.stream_handle(dev)
    with torch.cuda.device(dev):
        err = _launcher("global_norm_launch")(
            _address(ptrs), _address(sizes), n, partials.data_ptr(),
            capacity, norm.data_ptr(), stream)
        if err == 0 and max_norm:
            err = _launcher("clip_scale_launch")(
                _address(ptrs), _address(sizes), n, norm.data_ptr(),
                max_norm, stream)
    if err != 0:
        raise RuntimeError(f"global-norm clip kernel launch failed: CUDA "
                           f"error {err}")
    cuda_build.count_launch(global_norm_clip_)
    return norm


global_norm_clip_.launches = 0


@torch.no_grad()
def ema_update_(ema: Sequence[torch.Tensor], params: Sequence[torch.Tensor],
                decay) -> None:
    """``e = e * d + p * (1 - d)`` in place on each EMA tensor ``e`` with
    its parameter ``p``, ``d`` = ``decay`` as a float32 and ``1 - d``
    computed in float32. On the card, one launch for every 159 pairs."""
    d = np.float32(decay)
    one_minus = np.float32(1.0) - d
    if not _on_card(ema, params):
        ema_update_plain_(ema, params, d)
        return
    eptrs, pptrs, sizes = _pair_table(ema, params)
    dev = params[0].device
    with torch.cuda.device(dev):
        err = _launcher("ema_launch")(
            _address(eptrs), _address(pptrs), _address(sizes), len(sizes),
            float(d), float(one_minus), cuda_build.stream_handle(dev))
    if err != 0:
        raise RuntimeError(f"EMA kernel launch failed: CUDA error {err}")
    cuda_build.count_launch(ema_update_)


ema_update_.launches = 0
