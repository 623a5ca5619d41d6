"""Device time of a callable (port of
``ood_object_detection_tpu.utils.benchmark``).

The JAX harness runs its iterations inside one jitted ``fori_loop`` and
perturbs a carry into every argument, so that XLA can neither hoist a
stage out of the loop nor fold two iterations into one. Eager PyTorch
compiles nothing across calls: every call issues all of its work again,
so no carry is needed. On a CUDA device ``iters`` back-to-back calls run
between two CUDA events recorded on the current stream; their elapsed
time is the card's from the first call's start to the last call's end,
the host's gaps between launches included, not the host's enqueue time.
The median of ``repeats`` such runs is returned, in seconds a call. On
the CPU, only when the caller names it, the host clock times the same
runs. Asked for the card without one, it raises.
"""
from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable, Optional, Tuple, Union

import torch

from ..factory import resolve_device


def device_time(fn: Callable, args: Tuple, iters: int = 20,
                warmup: int = 1, repeats: int = 3,
                device: Optional[Union[str, torch.device]] = None) -> float:
    """Median seconds a call of ``fn(*args)`` over ``repeats`` runs of
    ``iters`` calls, after ``warmup`` calls; ``fn`` is called ``warmup +
    repeats * iters`` times. ``device``: the CUDA card when None (raises
    without one), or the device named; a CUDA device times by CUDA events,
    the CPU by the host clock."""
    device = resolve_device(device)
    cuda = device.type == "cuda"
    if cuda and not torch.cuda.is_available():
        raise RuntimeError(f"device_time on {device}: no CUDA device")
    if iters < 1 or repeats < 1:
        raise ValueError(f"iters {iters} and repeats {repeats} must be >= 1")
    for _ in range(warmup):
        fn(*args)
    times = []
    with torch.cuda.device(device) if cuda else contextlib.nullcontext():
        if cuda:
            torch.cuda.synchronize()
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(iters):
                    fn(*args)
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3 / iters)
            else:
                t0 = time.perf_counter()
                for _ in range(iters):
                    fn(*args)
                times.append((time.perf_counter() - t0) / iters)
    return statistics.median(times)


def throughput(fn: Callable, args: Tuple, batch_size: int, iters: int = 20,
               device: Optional[Union[str, torch.device]] = None) -> float:
    """Images a second of a batched callable."""
    return batch_size / device_time(fn, args, iters=iters, device=device)
