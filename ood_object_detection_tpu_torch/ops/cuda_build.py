"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each source under ``ood_object_detection_tpu_torch/csrc/`` compiles on its
own into a shared library with a plain C interface (no PyTorch headers, so
a build takes seconds), for ``sm_90a``, into ``csrc/build/``. The library
is named by a hash of its source and flags: an edited source is rebuilt, a
finished build is reused, and two processes building at once do not clash
(each compiles to its own temporary file and renames it into place).

Nothing is built at import. The first call that needs a kernel builds its
library; ``build_all`` starts every build at once, one nvcc each.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

BASE_FLAGS: Tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# no FMA contraction where a kernel must round like its plain version:
# the IoU of nms.cu and label_match.cu, the box encode of label_targets.cu
SOURCES: Dict[str, Tuple[str, ...]] = {
    "nms.cu": ("-fmad=false",),
    "key_reduce.cu": (),
    "label_match.cu": ("-fmad=false",),
    "label_targets.cu": ("-fmad=false",),
}

_loaded: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in $CUDA_HOME/bin)"
                       "; the port's CUDA kernels need the CUDA toolkit")


def _target(source: str) -> Tuple[Path, Tuple[str, ...]]:
    flags = BASE_FLAGS + SOURCES[source]
    digest = hashlib.sha256(
        (CSRC / source).read_bytes() + " ".join(flags).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"{Path(source).stem}-{digest}.so", flags


def build_all(sources: Iterable[str] = tuple(SOURCES)) -> Dict[str, str]:
    """Compile every listed source that is not built yet, all nvcc
    processes running at once. Returns {source: nvcc output} for the
    sources compiled by this call (register and shared-memory use from
    ``-Xptxas -v``); raises with nvcc's output if any build fails."""
    started = []
    try:
        for source in sources:
            so, flags = _target(source)
            if so.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
            proc = subprocess.Popen(
                [nvcc_path(), *flags, "-o", str(tmp), str(CSRC / source)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            started.append((source, so, tmp, proc))
        logs = {}
        for source, so, tmp, proc in started:
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {source}:\n{out}")
            os.replace(tmp, so)
            logs[source] = out
        return logs
    finally:
        for *_, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def load(source: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built first if needed."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            build_all((source,))
            lib = ctypes.CDLL(str(_target(source)[0]))
            _loaded[source] = lib
        return lib


def stream_handle(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream, which a kernel's
    launch function takes: what ``torch.cuda.current_stream(device)
    .cuda_stream`` gives, without building the Stream object (a launch's
    host cost is of the order of the labeler kernels' time)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``. Episodes may be labelled on a
    prefetch thread while the main thread labels or detects, so the
    increment holds a lock."""
    with _count_lock:
        wrapper.launches += 1
