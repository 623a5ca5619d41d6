"""ctypes bindings to the native data-loading core (``csrc/libdatacore.so``,
built from ``csrc/data_core.cpp``).

Port of ``ood_object_detection_tpu.data.native_decode``: libjpeg decode +
PIL-BILINEAR-compatible letterbox resize + a C++ thread pool that fills a
fixed [B, TH, TW, 3] uint8 canvas batch without the interpreter lock,
ready for ``normalize_uint8`` on the card.

The port loads the committed ``.so`` as it is and never runs ``make``: where
it does not load (it needs ``libjpeg.so.62``), ``available()`` is False.
The native core is an accelerator, never a requirement: ``PilEvalLoader``
gives the same batches with every image through PIL, the per-item path
``NativeEvalLoader`` itself falls back to for a file the core cannot
decode.
"""
from __future__ import annotations

import ctypes
import os
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "csrc", "libdatacore.so")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    """The loaded core, or None where the committed library does not load;
    tried once a process."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError:
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_long)

    lib.dc_jpeg_dims.argtypes = [u8p, ctypes.c_long, i32p, i32p]
    lib.dc_jpeg_dims.restype = ctypes.c_int
    lib.dc_jpeg_decode.argtypes = [u8p, ctypes.c_long, u8p,
                                   ctypes.c_int, ctypes.c_int]
    lib.dc_jpeg_decode.restype = ctypes.c_int
    lib.dc_resize_bilinear.argtypes = [u8p, ctypes.c_int, ctypes.c_int,
                                       u8p, ctypes.c_int, ctypes.c_int]
    lib.dc_resize_bilinear.restype = None
    lib.dc_decode_letterbox.argtypes = [u8p, ctypes.c_long, u8p,
                                        ctypes.c_int, ctypes.c_int,
                                        f32p, i32p, i32p]
    lib.dc_decode_letterbox.restype = ctypes.c_int
    lib.dc_load_letterbox_batch.argtypes = [
        ctypes.c_char_p, i64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, f32p, i32p, i32p, ctypes.c_int]
    lib.dc_load_letterbox_batch.restype = ctypes.c_int

    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _core() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native data core {_LIB_PATH} does not load "
                           "here (it needs libjpeg.so.62); use the PIL path")
    return lib


def _u8(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _bytes_ptr(b: bytes):
    return ctypes.cast(ctypes.c_char_p(b), ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """Decode JPEG bytes to an RGB uint8 [H, W, 3] array (None on failure)."""
    lib = _core()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.dc_jpeg_dims(_bytes_ptr(data), len(data),
                        ctypes.byref(h), ctypes.byref(w)):
        return None
    out = np.empty((h.value, w.value, 3), np.uint8)
    if lib.dc_jpeg_decode(_bytes_ptr(data), len(data), _u8(out),
                          h.value, w.value):
        return None
    return out


def resize_bilinear(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """PIL-BILINEAR-compatible resize of an RGB uint8 image."""
    lib = _core()
    img = np.ascontiguousarray(img, np.uint8)
    dh, dw = out_hw
    out = np.empty((dh, dw, 3), np.uint8)
    lib.dc_resize_bilinear(_u8(img), img.shape[0], img.shape[1],
                           _u8(out), dh, dw)
    return out


def decode_letterbox(data: bytes, target_hw: Tuple[int, int]
                     ) -> Optional[Tuple[np.ndarray, float, Tuple[int, int]]]:
    """JPEG bytes -> (letterboxed uint8 [TH, TW, 3], scale original/target,
    original (h, w)), None on failure. Top-left placement, zero fill: the
    reference ResizePad semantics."""
    lib = _core()
    th, tw = target_hw
    out = np.empty((th, tw, 3), np.uint8)
    scale = ctypes.c_float()
    oh = ctypes.c_int()
    ow = ctypes.c_int()
    if lib.dc_decode_letterbox(_bytes_ptr(data), len(data), _u8(out), th, tw,
                               ctypes.byref(scale), ctypes.byref(oh),
                               ctypes.byref(ow)):
        return None
    return out, scale.value, (oh.value, ow.value)


def load_letterbox_batch(
        paths: Sequence[str], target_hw: Tuple[int, int],
        n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Threaded native batch load: decode + letterbox every path.

    Returns (images [N, TH, TW, 3] uint8, scales [N] f32 original/target,
    sizes [N, 2] int32 original (h, w), rc [N] int32: nonzero marks a
    failed item whose canvas is zeroed, which callers may decode with PIL).
    """
    lib = _core()
    th, tw = target_hw
    n = len(paths)
    encoded = [p.encode() for p in paths]
    offsets = np.zeros(n, np.int64)
    if n:
        offsets[1:] = np.cumsum([len(e) + 1 for e in encoded])[:-1]
    out = np.zeros((n, th, tw, 3), np.uint8)
    scales = np.ones(n, np.float32)
    sizes = np.zeros((n, 2), np.int32)
    rc = np.zeros(n, np.int32)
    lib.dc_load_letterbox_batch(
        b"".join(e + b"\0" for e in encoded),
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n, th, tw, _u8(out),
        scales.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        rc.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_threads)
    return out, scales, sizes, rc


def pil_letterbox(path: str, target_hw: Tuple[int, int]
                  ) -> Tuple[np.ndarray, float, Tuple[int, int]]:
    """One image through PIL: (letterboxed uint8 [TH, TW, 3], scale
    original/target, original (h, w)), by ``transforms.ResizePad``."""
    from PIL import Image

    from .transforms import ResizePad
    with Image.open(path) as img:
        rgb = img.convert("RGB")
    w, h = rgb.size
    out, anno = ResizePad(target_hw)(rgb, {})
    return np.asarray(out, np.uint8), float(anno["img_scale"]), (h, w)


class NativeEvalLoader:
    """Deployment / eval loader over image files: the C++ core decodes and
    letterboxes each batch in a thread pool.

    Yields {'image' uint8 [B, TH, TW, 3], 'img_scale' f32 [B],
    'img_size' f32 [B, 2] (w, h), 'path': list[str]}, the last batch padded
    to the batch size; a non-JPEG or corrupt item falls back to PIL, and
    one PIL cannot read either keeps a zeroed canvas.
    """

    decoder = "native"

    def __init__(self, paths: Sequence[str], target_hw: Tuple[int, int],
                 batch_size: int, n_threads: int = 0,
                 drop_last: bool = False):
        if not available():
            raise RuntimeError("native data core unavailable; use "
                               "PilEvalLoader (data.create_loader for "
                               "training)")
        self.paths = list(paths)
        self.target_hw = target_hw
        self.batch_size = batch_size
        self.n_threads = n_threads
        self.drop_last = drop_last

    def __len__(self) -> int:
        n = len(self.paths)
        b = self.batch_size
        return n // b if self.drop_last else (n + b - 1) // b

    def _pil_into(self, chunk: List[str], items, imgs, scales, sizes):
        for i in items:
            try:
                imgs[i], scales[i], sizes[i] = pil_letterbox(chunk[i],
                                                             self.target_hw)
            except OSError:
                pass  # keep the zeroed canvas

    def _decode(self, chunk: List[str]):
        imgs, scales, sizes, rc = load_letterbox_batch(
            chunk, self.target_hw, self.n_threads)
        self._pil_into(chunk, np.nonzero(rc)[0], imgs, scales, sizes)
        return imgs, scales, sizes

    def __iter__(self) -> Iterator[dict]:
        b = self.batch_size
        for start in range(0, len(self.paths), b):
            chunk = self.paths[start:start + b]
            if self.drop_last and len(chunk) < b:
                return
            imgs, scales, sizes = self._decode(chunk)
            if len(chunk) < b:  # pad the tail batch to the fixed size
                pad = b - len(chunk)
                imgs = np.concatenate(
                    [imgs, np.zeros((pad,) + imgs.shape[1:], np.uint8)])
                scales = np.concatenate([scales, np.ones(pad, np.float32)])
                sizes = np.concatenate([sizes, np.zeros((pad, 2), np.int32)])
            yield {
                "image": imgs,
                "img_scale": scales,
                # (w, h) in original coordinates, the reference img_info
                "img_size": sizes[:, ::-1].astype(np.float32),
                "path": list(chunk),
            }


class PilEvalLoader(NativeEvalLoader):
    """``NativeEvalLoader``'s batches with every image through PIL
    (``pil_letterbox``), where the native core does not load."""

    decoder = "pil"

    def __init__(self, paths: Sequence[str], target_hw: Tuple[int, int],
                 batch_size: int, drop_last: bool = False):
        self.paths = list(paths)
        self.target_hw = target_hw
        self.batch_size = batch_size
        self.drop_last = drop_last

    def _decode(self, chunk: List[str]):
        th, tw = self.target_hw
        imgs = np.zeros((len(chunk), th, tw, 3), np.uint8)
        scales = np.ones(len(chunk), np.float32)
        sizes = np.zeros((len(chunk), 2), np.int32)
        self._pil_into(chunk, range(len(chunk)), imgs, scales, sizes)
        return imgs, scales, sizes
