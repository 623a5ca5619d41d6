"""Tracing and timing helpers of the training drivers (port of
``ood_object_detection_tpu.utils.profiling``).

``trace`` captures a ``torch.profiler`` trace (CPU, and the card's kernels
and copies where there is one) and writes it as a Chrome trace;
``span`` labels a region inside it (``record_function``; ``annotate`` is
its JAX-package name);
``StepTimer`` keeps per-step times, from CUDA events on the card and the
host clock on the CPU; ``MetricLogger`` writes JSON lines, a copy of the
JAX package's. The JAX package's ``enable_xla_dump`` has no counterpart:
PyTorch eager compiles nothing through XLA.

The program's spans (``odt.<layer>``: ``odt.letterbox``, ``odt.forward``,
``odt.select``, ``odt.nms``, ``odt.label``, ``odt.loss``, ``odt.backward``,
``odt.update``, ``odt.step``, ``odt.mesh.*``, ``odt.spatial.*``) are on
exactly while a profiler records, whoever started it (``start_trace`` /
``trace``, or a caller's own ``torch.profiler.profile``): each is then a
``record_function`` range in the profiler's own trace, on the clock of the
card's kernels and copies and linked to their launches by correlation ids.
With no profiler recording, the default, ``span`` returns one shared no-op
context manager: a global read, no dispatcher call.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Dict, Iterator, List, Optional, Union

import torch
from torch.autograd import profiler as _autograd_profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A labelled region of the trace (``record_function(name)``) while a
    profiler records; the shared no-op context manager otherwise."""
    return (torch.profiler.record_function(name)
            if _autograd_profiler._is_profiler_enabled else _OFF)


annotate = span            # the JAX package's name for it


def start_trace() -> torch.profiler.profile:
    """A started ``torch.profiler`` capture of the host and, when CUDA is
    available, the card (stop it with ``stop_trace``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, log_dir: str) -> str:
    """Stop ``prof`` and write its Chrome trace into ``log_dir``; returns
    the file's path."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    return path


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace") -> Iterator[torch.profiler.profile]:
    """Capture a ``torch.profiler`` trace of the block into
    ``log_dir/trace.json`` (open it with Perfetto or chrome://tracing)."""
    prof = start_trace()
    try:
        yield prof
    finally:
        stop_trace(prof, log_dir)


class StepTimer:
    """Rolling per-step times in seconds: CUDA events on ``device`` when it
    is a CUDA device (the time the card's stream takes from ``tic`` to
    ``toc``, host gaps included), the host clock otherwise. ``toc``
    waits for the step's end event."""

    def __init__(self, window: int = 50,
                 device: Optional[Union[str, torch.device]] = None):
        self.window = window
        self.cuda = device is not None and torch.device(device).type == "cuda"
        self._start = None
        self.times: List[float] = []

    def tic(self):
        if self.cuda:
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record()
        else:
            self._start = time.perf_counter()

    def toc(self) -> float:
        if self.cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            end.synchronize()
            dt = self._start.elapsed_time(end) / 1e3
        else:
            dt = time.perf_counter() - self._start
        self.times.append(dt)
        if len(self.times) > self.window:
            self.times.pop(0)
        return dt

    @property
    def mean(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def median(self) -> float:
        ordered = sorted(self.times)
        return ordered[len(ordered) // 2] if ordered else 0.0

    def rate(self, batch_size: int) -> float:
        return batch_size / self.mean if self.times else 0.0


class MetricLogger:
    """JSON-lines metric logging with optional wandb mirroring.

    The reference logs to wandb + .npy dumps (pretrain.py:283-318,
    infer.py:821-865); here stdout JSON lines are the source of truth and
    wandb attaches when available + requested.
    """

    def __init__(self, use_wandb: bool = False, project: str = "",
                 run_name: str = "", config: Optional[Dict] = None,
                 out_file: Optional[str] = None):
        self._wandb = None
        self._file = open(out_file, "a") if out_file else None
        if use_wandb:
            try:
                import wandb
                wandb.init(project=project or "ood-detection-tpu",
                           name=run_name or None, config=config or {})
                self._wandb = wandb
            except ImportError:
                pass

    def log(self, metrics: Dict, step: Optional[int] = None):
        payload = dict(metrics)
        if step is not None:
            payload["step"] = step

        def clean(v):
            if hasattr(v, "item"):
                v = float(v)
            if isinstance(v, float) and not math.isfinite(v):
                return None      # json.dumps would emit bare Infinity/NaN
            return v
        line = json.dumps({k: clean(v) for k, v in payload.items()})
        print(line, flush=True)
        if self._file:
            self._file.write(line + "\n")
            self._file.flush()
        if self._wandb:
            self._wandb.log(metrics, step=step)

    def close(self):
        if self._file:
            self._file.close()
        if self._wandb:
            self._wandb.finish()
