"""Multiscale RetinaNet/EfficientDet anchor generation.

Port of ``ood_object_detection_tpu.ops.anchors``. The table is generated
once on the host with numpy (the same code as the JAX package, so it is
bit-equal); ``boxes_for_indices`` rebuilds the anchors of selected ids by
index arithmetic in torch, on the ids' device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple, Union

import numpy as np
import torch

from ..config.model_config import ModelConfig


def get_feat_sizes(image_size: Tuple[int, int],
                   max_level: int) -> List[Tuple[int, int]]:
    """(H, W) of every feature level 0..max_level (ceil-div-by-2 chain)."""
    feat_size = tuple(image_size)
    feat_sizes = [feat_size]
    for _ in range(1, max_level + 1):
        feat_size = ((feat_size[0] - 1) // 2 + 1, (feat_size[1] - 1) // 2 + 1)
        feat_sizes.append(feat_size)
    return feat_sizes


def _half_extents(stride: Tuple[float, float], octave_scale: float,
                  aspect: Union[float, Tuple[float, float]],
                  anchor_scale: float) -> Tuple[float, float]:
    """(half_y, half_x) of one (level, octave, aspect) anchor config."""
    base_x = anchor_scale * stride[1] * 2.0 ** octave_scale
    base_y = anchor_scale * stride[0] * 2.0 ** octave_scale
    if isinstance(aspect, (tuple, list)):
        aspect_x, aspect_y = aspect[0], aspect[1]
    else:
        aspect_x = float(np.sqrt(aspect))
        aspect_y = 1.0 / aspect_x
    return base_y * aspect_y / 2.0, base_x * aspect_x / 2.0


def _level_boxes(image_size: Tuple[int, int], stride: Tuple[int, int],
                 octave_scale: float,
                 aspect: Union[float, Tuple[float, float]],
                 anchor_scale: float) -> np.ndarray:
    """All anchors of one (level, octave, aspect) config: [H*W, 4] yxyx."""
    half_y, half_x = _half_extents(stride, octave_scale, aspect, anchor_scale)
    x = np.arange(stride[1] / 2.0, image_size[1], stride[1])
    y = np.arange(stride[0] / 2.0, image_size[0], stride[0])
    xv, yv = np.meshgrid(x, y)
    xv = xv.reshape(-1)
    yv = yv.reshape(-1)
    return np.stack([yv - half_y, xv - half_x, yv + half_y, xv + half_x],
                    axis=1)


def _anchor_scales(anchor_scale, num_levels: int) -> List[float]:
    if isinstance(anchor_scale, (tuple, list)):
        assert len(anchor_scale) == num_levels
        return list(anchor_scale)
    return [anchor_scale] * num_levels


def generate_anchor_boxes(min_level: int, max_level: int, num_scales: int,
                          aspect_ratios: Sequence,
                          anchor_scale: Union[float, Sequence[float]],
                          image_size: Tuple[int, int]) -> np.ndarray:
    """All anchors over all levels: [A_total, 4] float32 yxyx, cell-major
    then config-minor within a level (the heads' [B, H, W, A*K] order)."""
    anchor_scales = _anchor_scales(anchor_scale, max_level - min_level + 1)
    feat_sizes = get_feat_sizes(image_size, max_level)
    boxes_all = []
    for level in range(min_level, max_level + 1):
        stride = (feat_sizes[0][0] // feat_sizes[level][0],
                  feat_sizes[0][1] // feat_sizes[level][1])
        boxes_level = [
            _level_boxes(image_size, stride, octave / float(num_scales),
                         aspect, anchor_scales[level - min_level])
            for octave in range(num_scales) for aspect in aspect_ratios]
        boxes_all.append(np.stack(boxes_level, axis=1).reshape(-1, 4))
    return np.vstack(boxes_all).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class Anchors:
    """Immutable anchor set + pyramid metadata."""
    min_level: int
    max_level: int
    num_scales: int
    aspect_ratios: tuple
    anchor_scale: Union[float, tuple]
    image_size: Tuple[int, int]

    def __post_init__(self):
        for dim in self.image_size:
            if dim % 2 ** self.max_level:
                raise ValueError(
                    f"image size {self.image_size} must be divisible by "
                    f"2**max_level = {2 ** self.max_level}")

    @classmethod
    def from_config(cls, config: ModelConfig, img_size: int | None = None,
                    min_level_offset: int = 0) -> "Anchors":
        """Anchors for a model config; ``img_size`` (square) and
        ``min_level_offset`` override the image size and raise the lowest
        level, as the episodic pipeline does for its support crops."""
        image_size = ((img_size, img_size) if img_size is not None
                      else tuple(config.image_size))
        return cls(min_level=config.min_level + min_level_offset,
                   max_level=config.max_level,
                   num_scales=config.num_scales,
                   aspect_ratios=tuple(config.aspect_ratios),
                   anchor_scale=config.anchor_scale,
                   image_size=image_size)

    @property
    def feat_sizes(self) -> List[Tuple[int, int]]:
        return get_feat_sizes(self.image_size, self.max_level)

    @property
    def num_levels(self) -> int:
        return self.max_level - self.min_level + 1

    @property
    def anchors_per_location(self) -> int:
        return self.num_scales * len(self.aspect_ratios)

    @functools.cached_property
    def boxes(self) -> np.ndarray:
        """[A_total, 4] float32 yxyx anchor table."""
        return generate_anchor_boxes(
            self.min_level, self.max_level, self.num_scales,
            self.aspect_ratios, self.anchor_scale, self.image_size)

    @property
    def level_sizes(self) -> List[int]:
        fs = self.feat_sizes
        return [fs[l][0] * fs[l][1] * self.anchors_per_location
                for l in range(self.min_level, self.max_level + 1)]

    @property
    def total_anchors(self) -> int:
        return sum(self.level_sizes)

    @functools.cached_property
    def level_meta(self) -> Tuple[tuple, ...]:
        """Per level: (offset, size, grid_w, stride_y, stride_x, half_ys,
        half_xs), the half-extents of the ``anchors_per_location``
        configs as Python floats (rounded to f32 where they are used,
        exactly like the generated table)."""
        fs = self.feat_sizes
        anchor_scales = _anchor_scales(self.anchor_scale, self.num_levels)
        meta = []
        offset = 0
        for level in range(self.min_level, self.max_level + 1):
            h, w = fs[level]
            sy = fs[0][0] // h
            sx = fs[0][1] // w
            halves = [_half_extents((sy, sx), octave / self.num_scales, aspect,
                                    anchor_scales[level - self.min_level])
                      for octave in range(self.num_scales)
                      for aspect in self.aspect_ratios]
            size = h * w * self.anchors_per_location
            meta.append((offset, size, w, float(sy), float(sx),
                         tuple(float(hy) for hy, _ in halves),
                         tuple(float(hx) for _, hx in halves)))
            offset += size
        return tuple(meta)

    @functools.cached_property
    def _half_extents(self) -> np.ndarray:
        """[num_levels, 2, anchors_per_location] f32 (half_y, half_x)."""
        return np.array([[hy, hx] for *_, hy, hx in self.level_meta],
                        dtype=np.float32)

    def boxes_for_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Anchor yxyx boxes for global anchor ids, by index arithmetic.

        indices: [...] integer global anchor ids. Returns [..., 4] f32 on
        the ids' device, bit-equal to the JAX package's
        ``Anchors.boxes_for_indices`` (same f32 operations in the same
        order; the half-extents come from a per-level f32 table).
        """
        a = self.anchors_per_location
        dev = indices.device
        halves = torch.from_numpy(self._half_extents).to(dev)
        zeros = torch.zeros(indices.shape, dtype=torch.float32, device=dev)
        y1, x1, y2, x2 = zeros, zeros, zeros, zeros
        for level, (off, size, w, sy, sx, _, _) in enumerate(self.level_meta):
            local = torch.clamp(indices - off, 0, size - 1)
            cell = local // a
            k = local % a
            r = (cell // w).to(torch.float32)
            c = (cell % w).to(torch.float32)
            cy = (r + 0.5) * sy
            cx = (c + 0.5) * sx
            hy = halves[level, 0][k]
            hx = halves[level, 1][k]
            in_level = (indices >= off) & (indices < off + size)
            y1 = torch.where(in_level, cy - hy, y1)
            x1 = torch.where(in_level, cx - hx, x1)
            y2 = torch.where(in_level, cy + hy, y2)
            x2 = torch.where(in_level, cx + hx, x2)
        return torch.stack([y1, x1, y2, x2], dim=-1)
