"""On-device letterbox resize + ImageNet normalisation.

Port of ``ood_object_detection_tpu.data.device_preproc``
(``batched_letterbox_normalize`` and ``normalize_uint8``). Host workers
only decode into fixed-size uint8 canvases; the card resamples each canvas
by its own scale, fills beyond the scaled image, and normalises.

Each image's canvas is resampled as ``jax.image.scale_and_translate``
does: bilinear with antialiasing (a triangle kernel widened by 1/scale
when downscaling), output pixel ``i`` centred on source ``(i + 0.5) /
scale - 0.5``. The resampled block is exactly the valid region, ``floor
(side * scale)`` in f32 as the JAX fill boundary is;
``aten._upsample_bilinear2d_aa`` with that output size and the scale both
given computes it. (``F.interpolate`` with a scale factor sizes its output
by the same floor in double, one row or column short where the f32 scale
rounds below ``target / side``.) The scale differs per image, so it is a
host number and each image is one call. The loop sits behind the custom
operator ``ood_detection::letterbox_normalize`` so that ``torch.export``
can take the letterbox into a serving artifact (``export.py``); it is
stock PyTorch inside, not a kernel of the port.
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

# ImageNet statistics (ood_object_detection_tpu/data/transforms.py:20-21)
IMAGENET_DEFAULT_MEAN = (0.485, 0.456, 0.406)
IMAGENET_DEFAULT_STD = (0.229, 0.224, 0.225)


def batched_letterbox_normalize(
        canvases: torch.Tensor,
        true_hw: torch.Tensor,
        target_hw: Tuple[int, int] = (512, 512),
        mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
        std: Sequence[float] = IMAGENET_DEFAULT_STD,
        fill_color: Sequence[float] = (124.0, 116.0, 104.0),
        out_dtype: str = "float32",
) -> Dict[str, torch.Tensor]:
    """canvases [B, Hc, Wc, 3] uint8, true_hw [B, 2] int (h, w) of each
    valid top-left region -> {'image': [B, H, W, 3] normalised, in
    ``out_dtype``; 'img_scale': [B, 1] f32 original / target;
    'img_size': [B, 2] f32 (w, h) original}, all on the canvases' device.

    The resample runs in f32 for either ``out_dtype``; the fill and the
    normalisation run in ``out_dtype``, as in the JAX function. Runs the
    operator ``ood_detection::letterbox_normalize``.
    """
    if canvases.dim() != 4 or canvases.shape[3] != 3 or \
            canvases.dtype != torch.uint8:
        raise ValueError(f"canvases must be [B, H, W, 3] uint8, not "
                         f"{tuple(canvases.shape)} {canvases.dtype}")
    th, tw = target_hw
    image, img_scale, img_size = _letterbox_op(
        canvases, torch.as_tensor(true_hw), int(th), int(tw),
        [float(v) for v in mean], [float(v) for v in std],
        [float(v) for v in fill_color], out_dtype)
    return {"image": image, "img_scale": img_scale, "img_size": img_size}


# The per-image loop reads each image's scaled size as a host number, a
# data-dependent shape that ``torch.export`` cannot trace; behind a custom
# operator (stock PyTorch ops inside, on every device) the exported program
# keeps one opaque call, and its fake implementation gives the shapes.
@torch.library.custom_op("ood_detection::letterbox_normalize",
                         mutates_args=())
def _letterbox_op(canvases: torch.Tensor, true_hw: torch.Tensor,
                  target_h: int, target_w: int, mean: List[float],
                  std: List[float], fill_color: List[float], out_dtype: str
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    th, tw = target_h, target_w
    dtype = getattr(torch, out_dtype)
    device = canvases.device
    hw = true_hw.to("cpu", torch.float32)
    # tensor over tensor: a Python number over a tensor is computed as a
    # multiply by the reciprocal, one f32 step away from the quotient
    scale = torch.minimum(torch.full_like(hw[:, 0], th) / hw[:, 0],
                          torch.full_like(hw[:, 1], tw) / hw[:, 1])
    scaled_h = torch.floor(hw[:, 0] * scale)
    scaled_w = torch.floor(hw[:, 1] * scale)

    fill = torch.tensor(fill_color, dtype=torch.float32).to(dtype)
    images = fill.to(device).expand(canvases.shape[0], th, tw, 3).clone()
    for i in range(canvases.shape[0]):
        # only the scaled image's rows and columns are resampled (every
        # source centre then lies inside the canvas); the rest keeps the fill
        sh, sw = int(scaled_h[i]), int(scaled_w[i])
        if sh == 0 or sw == 0:
            continue
        img = canvases[i].permute(2, 0, 1)[None].to(torch.float32)
        s = float(scale[i])
        # an axis whose output size equals its input size is copied, not
        # resampled, whatever the scale: resample one more row or column
        # there and drop it (the kept ones depend on the scale alone)
        oh = sh + 1 if sh == img.shape[2] else sh
        ow = sw + 1 if sw == img.shape[3] else sw
        out = torch.ops.aten._upsample_bilinear2d_aa(img, [oh, ow], False,
                                                     s, s)[0, :, :sh, :sw]
        images[i, :sh, :sw] = out.to(dtype).permute(1, 2, 0)

    mean_t = (torch.tensor(mean, dtype=torch.float32) * 255.0).to(dtype)
    std_inv = (1.0 / (torch.tensor(std, dtype=torch.float32) * 255.0)
               ).to(dtype)
    images = (images - mean_t.to(device)) * std_inv.to(device)
    return images, (1.0 / scale)[:, None].to(device), hw.flip(-1).to(device)


@_letterbox_op.register_fake
def _letterbox_fake(canvases, true_hw, target_h, target_w, mean, std,
                    fill_color, out_dtype):
    b = canvases.shape[0]
    return (canvases.new_empty((b, target_h, target_w, 3),
                               dtype=getattr(torch, out_dtype)),
            canvases.new_empty((b, 1), dtype=torch.float32),
            canvases.new_empty((b, 2), dtype=torch.float32))


def normalize_uint8(images: torch.Tensor,
                    mean: Sequence[float] = IMAGENET_DEFAULT_MEAN,
                    std: Sequence[float] = IMAGENET_DEFAULT_STD
                    ) -> torch.Tensor:
    """uint8 NHWC -> normalised f32 on the images' device."""
    mean_t = torch.tensor(mean, dtype=torch.float32) * 255.0
    std_t = torch.tensor(std, dtype=torch.float32) * 255.0
    return (images.to(torch.float32) - mean_t.to(images.device)) \
        / std_t.to(images.device)
