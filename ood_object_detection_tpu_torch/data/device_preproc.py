"""On-device letterbox resize + ImageNet normalisation.

Port of ``ood_object_detection_tpu.data.device_preproc
.batched_letterbox_normalize``. Host workers only decode into fixed-size
uint8 canvases; the card resamples each canvas by its own scale, fills
beyond the scaled image, and normalises.

Each image's whole canvas is resampled, as ``jax.image.scale_and_translate``
does: bilinear with antialiasing (a triangle kernel widened by 1/scale when
downscaling), output pixel ``i`` centred on source ``(i + 0.5) / scale -
0.5``. ``F.interpolate(..., antialias=True, recompute_scale_factor=False)``
computes that; its output is then cropped or padded to the target size.
The scale differs per image, so it is a host number and each image is one
call.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

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
    normalisation run in ``out_dtype``, as in the JAX function.
    """
    if canvases.dim() != 4 or canvases.shape[3] != 3 or \
            canvases.dtype != torch.uint8:
        raise ValueError(f"canvases must be [B, H, W, 3] uint8, not "
                         f"{tuple(canvases.shape)} {canvases.dtype}")
    th, tw = target_hw
    dtype = getattr(torch, out_dtype)
    device = canvases.device
    hw = torch.as_tensor(true_hw).to("cpu", torch.float32)
    scale = torch.minimum(th / hw[:, 0], tw / hw[:, 1])
    scaled_h = torch.floor(hw[:, 0] * scale)
    scaled_w = torch.floor(hw[:, 1] * scale)

    fill = torch.tensor(fill_color, dtype=torch.float32,
                        device=device).to(dtype)[:, None, None]
    rows = torch.arange(th, dtype=torch.float32, device=device)[:, None]
    cols = torch.arange(tw, dtype=torch.float32, device=device)[None, :]
    images = torch.empty((canvases.shape[0], th, tw, 3), dtype=dtype,
                         device=device)
    for i in range(canvases.shape[0]):
        img = canvases[i].permute(2, 0, 1)[None].to(torch.float32)
        out = F.interpolate(img, scale_factor=float(scale[i]),
                            mode="bilinear", align_corners=False,
                            antialias=True, recompute_scale_factor=False)[0]
        out = out[:, :th, :tw]
        out = F.pad(out, (0, tw - out.shape[2], 0, th - out.shape[1]))
        valid = (rows < float(scaled_h[i])) & (cols < float(scaled_w[i]))
        images[i] = torch.where(valid, out.to(dtype), fill).permute(1, 2, 0)

    mean_t = (torch.tensor(mean, dtype=torch.float32) * 255.0).to(dtype)
    std_inv = (1.0 / (torch.tensor(std, dtype=torch.float32) * 255.0)
               ).to(dtype)
    images = (images - mean_t.to(device)) * std_inv.to(device)
    return {
        "image": images,
        "img_scale": (1.0 / scale)[:, None].to(device),
        "img_size": hw.flip(-1).to(device),
    }
