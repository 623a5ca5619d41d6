"""Copy of ``ood_object_detection_tpu.data.transforms``.

Host-side image/box transforms (decode-adjacent, cold path).

Capability parity with the reference transform set
(effdet/data/transforms.py:17-368): letterbox ResizePad, scale-jittered
RandomResizePad, task-object-centered ProjResizePad, RandomFlip, uint8
HWC numpy conversion, Compose and the three factory pipelines. Boxes are
yxyx float32 throughout (the reference convention).

These run in host workers on PIL images; the hot normalize/letterbox math
also exists as a fused on-device graph in data/device_preproc.py — use that
for deployment throughput.
"""
from __future__ import annotations

import random
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)

_PIL_INTERP = {}


def _pil():
    from PIL import Image
    if not _PIL_INTERP:
        _PIL_INTERP.update({
            "nearest": Image.NEAREST,
            "bilinear": Image.BILINEAR,
            "bicubic": Image.BICUBIC,
            "lanczos": Image.LANCZOS,
        })
    return Image


def _interp(name: str):
    _pil()
    if name == "random":
        return random.choice([_PIL_INTERP["bilinear"], _PIL_INTERP["bicubic"]])
    return _PIL_INTERP[name]


def clip_boxes_(boxes: np.ndarray, img_size_hw: Tuple[float, float]):
    """In-place clip of yxyx boxes to [0, size] (transforms.py:55-58)."""
    height, width = img_size_hw
    np.clip(boxes[:, 0::2], 0, height, out=boxes[:, 0::2])
    np.clip(boxes[:, 1::2], 0, width, out=boxes[:, 1::2])


_PER_INSTANCE_KEYS = ("cls", "difficult", "group_of")


def _filter_instances(anno: Dict, bbox: np.ndarray, valid: np.ndarray):
    """Subset bbox + every aligned per-instance array (cls and the
    evaluator flags the parsers emit: VOC 'difficult', OpenImages
    'group_of') by the same validity mask, keeping them aligned."""
    anno["bbox"] = bbox[valid]
    for k in _PER_INSTANCE_KEYS:
        if k in anno:
            anno[k] = anno[k][valid]


def _valid_boxes(boxes: np.ndarray) -> np.ndarray:
    return (boxes[:, 2] > boxes[:, 0]) & (boxes[:, 3] > boxes[:, 1])


class ImageToNumpy:
    """PIL -> HWC uint8 numpy (NHWC is the TPU-native layout; the reference
    emits CHW for torch, transforms.py:17-24)."""

    def __call__(self, pil_img, annotations: Dict):
        np_img = np.asarray(pil_img, dtype=np.uint8)
        if np_img.ndim < 3:
            np_img = np.expand_dims(np_img, axis=-1)
            np_img = np.repeat(np_img, 3, axis=-1)
        return np_img, annotations


class ResizePad:
    """Aspect-preserving resize to fit target, pad bottom/right (letterbox).

    Records img_scale = original/target ratio so detections can be mapped
    back (reference ResizePad, transforms.py:75-107).
    """

    def __init__(self, target_size: Tuple[int, int], interpolation: str = "bilinear",
                 fill_color: Tuple[int, int, int] = (0, 0, 0)):
        self.target_size = target_size
        self.interpolation = interpolation
        self.fill_color = fill_color

    def __call__(self, img, anno: Dict):
        Image = _pil()
        width, height = img.size
        img_scale_y = self.target_size[0] / height
        img_scale_x = self.target_size[1] / width
        img_scale = min(img_scale_y, img_scale_x)
        scaled_h = int(height * img_scale)
        scaled_w = int(width * img_scale)

        new_img = Image.new("RGB", (self.target_size[1], self.target_size[0]),
                            color=self.fill_color)
        img = img.resize((scaled_w, scaled_h), _interp(self.interpolation))
        new_img.paste(img)

        if "bbox" in anno:
            bbox = anno["bbox"]
            bbox[:, :4] *= img_scale
            clip_boxes_(bbox, (scaled_h, scaled_w))
            valid = _valid_boxes(bbox)
            _filter_instances(anno, bbox, valid)

        anno["img_scale"] = 1.0 / img_scale   # back to original
        return new_img, anno


class RandomResizePad:
    """Scale-jittered resize + random crop/pad to target
    (reference RandomResizePad, transforms.py:170-231)."""

    def __init__(self, target_size: Tuple[int, int], scale=(0.1, 2.0),
                 interpolation: str = "random",
                 fill_color: Tuple[int, int, int] = (0, 0, 0)):
        self.target_size = target_size
        self.scale = scale
        self.interpolation = interpolation
        self.fill_color = fill_color

    def _get_params(self, img):
        img_scale_factor = random.uniform(*self.scale)
        width, height = img.size
        img_scale_y = self.target_size[0] / height
        img_scale_x = self.target_size[1] / width
        img_scale = min(img_scale_y, img_scale_x) * img_scale_factor

        scaled_h = int(height * img_scale)
        scaled_w = int(width * img_scale)
        offset_y = scaled_h - self.target_size[0]
        offset_x = scaled_w - self.target_size[1]
        offset_y = int(max(0.0, float(offset_y)) * random.uniform(0, 1))
        offset_x = int(max(0.0, float(offset_x)) * random.uniform(0, 1))
        return scaled_h, scaled_w, offset_y, offset_x, img_scale

    def __call__(self, img, anno: Dict):
        Image = _pil()
        scaled_h, scaled_w, offset_y, offset_x, img_scale = self._get_params(img)

        img = img.resize((scaled_w, scaled_h), _interp(self.interpolation))
        right, lower = min(scaled_w, offset_x + self.target_size[1]), \
            min(scaled_h, offset_y + self.target_size[0])
        img = img.crop((offset_x, offset_y, right, lower))
        new_img = Image.new("RGB", (self.target_size[1], self.target_size[0]),
                            color=self.fill_color)
        new_img.paste(img)

        if "bbox" in anno:
            bbox = anno["bbox"]
            bbox[:, :4] *= img_scale
            box_offset = np.stack([offset_y, offset_x] * 2)
            bbox -= box_offset
            clip_boxes_(bbox, (scaled_h - offset_y, scaled_w - offset_x))
            valid = _valid_boxes(bbox)
            _filter_instances(anno, bbox, valid)

        anno["img_scale"] = 1.0 / img_scale
        return new_img, anno


class ProjResizePad:
    """Random crop centered (jittered) on a random task-class object, then
    resize-pad — the episodic 'projection image' transform
    (reference ProjResizePad, transforms.py:109-167)."""

    def __init__(self, target_size: Tuple[int, int], crop_frac=(0.3, 1.0),
                 interpolation: str = "bilinear",
                 fill_color: Tuple[int, int, int] = (0, 0, 0)):
        self.target_size = target_size
        self.crop_frac = crop_frac
        self.interpolation = interpolation
        self.fill_color = fill_color

    def __call__(self, img, anno: Dict):
        Image = _pil()
        width, height = img.size
        bbox = anno["bbox"]
        # pick an object to center the crop on
        obj_idx = random.randrange(len(bbox)) if len(bbox) else None

        crop_w = int(width * random.uniform(*self.crop_frac))
        crop_h = int(height * random.uniform(*self.crop_frac))
        if obj_idx is not None:
            cy = (bbox[obj_idx, 0] + bbox[obj_idx, 2]) / 2
            cx = (bbox[obj_idx, 1] + bbox[obj_idx, 3]) / 2
            cy += random.uniform(-0.2, 0.2) * crop_h
            cx += random.uniform(-0.2, 0.2) * crop_w
        else:
            cy, cx = height / 2, width / 2
        y0 = int(np.clip(cy - crop_h / 2, 0, max(height - crop_h, 0)))
        x0 = int(np.clip(cx - crop_w / 2, 0, max(width - crop_w, 0)))
        img = img.crop((x0, y0, min(x0 + crop_w, width), min(y0 + crop_h, height)))

        if "bbox" in anno and len(bbox):
            bbox = bbox - np.array([y0, x0, y0, x0], np.float32)
            clip_boxes_(bbox, (crop_h, crop_w))
            valid = _valid_boxes(bbox)
            _filter_instances(anno, bbox, valid)

        return ResizePad(self.target_size, self.interpolation,
                         self.fill_color)(img, anno)


class RandomFlip:
    """Horizontal/vertical flip with box remap (transforms.py:234-276)."""

    def __init__(self, horizontal: bool = True, vertical: bool = False,
                 prob: float = 0.5):
        self.horizontal = horizontal
        self.vertical = vertical
        self.prob = prob

    def __call__(self, img, annotations: Dict):
        Image = _pil()
        do_h = self.horizontal and random.random() < self.prob
        do_v = self.vertical and random.random() < self.prob
        width, height = img.size

        if do_h:
            img = img.transpose(Image.FLIP_LEFT_RIGHT)
            if "bbox" in annotations and len(annotations["bbox"]):
                bbox = annotations["bbox"]
                xmax = width - bbox[:, 1]
                xmin = width - bbox[:, 3]
                bbox[:, 1] = xmin
                bbox[:, 3] = xmax
        if do_v:
            img = img.transpose(Image.FLIP_TOP_BOTTOM)
            if "bbox" in annotations and len(annotations["bbox"]):
                bbox = annotations["bbox"]
                ymax = height - bbox[:, 0]
                ymin = height - bbox[:, 2]
                bbox[:, 0] = ymin
                bbox[:, 2] = ymax
        return img, annotations


class Compose:
    def __init__(self, transforms: Sequence):
        self.transforms = list(transforms)

    def __call__(self, img, annotations: Dict):
        for t in self.transforms:
            img, annotations = t(img, annotations)
        return img, annotations


def transforms_coco_eval(img_size: Tuple[int, int],
                         interpolation: str = "bilinear",
                         fill_color: Tuple[int, int, int] = (124, 116, 104)):
    """Eval pipeline: letterbox only (transforms_coco_eval, :326-345)."""
    return Compose([
        ResizePad(img_size, interpolation=interpolation, fill_color=fill_color),
        ImageToNumpy(),
    ])


def transforms_coco_train(img_size: Tuple[int, int],
                          interpolation: str = "random",
                          fill_color: Tuple[int, int, int] = (124, 116, 104),
                          scale: Tuple[float, float] = (0.1, 2.0)):
    """Train pipeline: flip + jittered resize (transforms_coco_train, :348-368).

    ``scale``: resize-jitter range — the episodic support augmentation
    passes (0.8, 1.5) (reference dataloader.py:114-115)."""
    return Compose([
        RandomFlip(horizontal=True, prob=0.5),
        RandomResizePad(img_size, interpolation=interpolation,
                        fill_color=fill_color, scale=scale),
        ImageToNumpy(),
    ])


def transforms_projection(img_size: Tuple[int, int],
                          interpolation: str = "bilinear",
                          fill_color: Tuple[int, int, int] = (124, 116, 104)):
    """Episodic projection-crop pipeline (transforms_projection, :304-324)."""
    return Compose([
        RandomFlip(horizontal=True, prob=0.5),
        ProjResizePad(img_size, interpolation=interpolation,
                      fill_color=fill_color),
        ImageToNumpy(),
    ])
