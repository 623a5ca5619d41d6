"""ctypes binding to the repo's committed native evaluation core
(``csrc/libevalcore.so``, built from ``csrc/eval_core.cpp``).

Port of ``ood_object_detection_tpu.evaluation.native`` with one change: the
library is loaded as committed and never built. A missing library, or one
that does not load, makes ``available()`` False and every caller takes the
numpy path, as in the JAX package; nothing is written into ``csrc/``. The
library needs only libstdc++, libm and libc.
"""
from __future__ import annotations

import ctypes
import os
from typing import Optional, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "libevalcore.so")
_lib = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    f32p = ctypes.POINTER(ctypes.c_float)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)

    lib.match_detections.argtypes = [
        f32p, ctypes.c_int, f32p, u8p, u8p, ctypes.c_int, u8p,
        f32p, ctypes.c_int, f32p, u8p]
    lib.match_detections.restype = None

    lib.hard_nms.argtypes = [f32p, f32p, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int, i32p]
    lib.hard_nms.restype = ctypes.c_int

    lib.iou_matrix.argtypes = [f32p, ctypes.c_int, f32p, ctypes.c_int, f32p]
    lib.iou_matrix.restype = None

    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def match_detections(det_boxes: np.ndarray, gt_boxes: np.ndarray,
                     gt_ignore: np.ndarray, gt_crowd: np.ndarray,
                     det_ignore: np.ndarray,
                     thresholds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """COCOeval evaluateImg matching. det_boxes must be score-sorted
    descending; gt_boxes must be sorted ignored-last (stable).

    Returns (tp [T, D] float32, ignore [T, D] uint8)."""
    lib = _load()
    assert lib is not None
    d = np.ascontiguousarray(det_boxes, np.float32)
    g = np.ascontiguousarray(gt_boxes, np.float32)
    gi = np.ascontiguousarray(gt_ignore, np.uint8)
    gc = np.ascontiguousarray(gt_crowd, np.uint8)
    di = np.ascontiguousarray(det_ignore, np.uint8)
    th = np.ascontiguousarray(thresholds, np.float32)
    n_det, n_gt, n_thr = len(d), len(g), len(th)
    tp = np.zeros((n_thr, n_det), np.float32)
    ig = np.zeros((n_thr, n_det), np.uint8)
    lib.match_detections(
        _fp(d), n_det, _fp(g), _u8(gi), _u8(gc), n_gt, _u8(di),
        _fp(th), n_thr, _fp(tp), _u8(ig))
    return tp, ig


def hard_nms(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
             max_out: int) -> np.ndarray:
    """Host-side greedy NMS; returns kept indices (original order)."""
    lib = _load()
    assert lib is not None
    b = np.ascontiguousarray(boxes, np.float32)
    s = np.ascontiguousarray(scores, np.float32)
    keep = np.zeros(min(max_out, len(s)), np.int32)
    n = lib.hard_nms(_fp(b), _fp(s), len(s), ctypes.c_float(iou_threshold),
                     len(keep), keep.ctypes.data_as(
                         ctypes.POINTER(ctypes.c_int)))
    return keep[:n]


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lib = _load()
    assert lib is not None
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    out = np.zeros((len(a), len(b)), np.float32)
    lib.iou_matrix(_fp(a), len(a), _fp(b), len(b), _fp(out))
    return out
