"""RandomErasing for detection batches, on the batch's device (port of
``ood_object_detection_tpu.data.random_erasing``).

The reference effdet/data/random_erasing.py:22-94: up to ``max_count``
rectangles an image, each drawn with ``probability``, of ``min_area`` to
``max_area`` of the image and a log-uniform aspect ratio, filled with 0
(``const``, the mean after normalisation), one normal value a channel
(``rand``) or a normal value a pixel (``pixel``); applied after
normalisation. The draws come from an explicit ``torch.Generator`` on
the batch's device, so they are not the JAX package's PRNG bits: the
port holds the same distribution, not the same rectangles. Plain torch
elementwise operations (no kernel of the JAX package runs here).
"""
from __future__ import annotations

import math

import torch


def random_erasing(images: torch.Tensor, generator: torch.Generator,
                   probability: float = 0.5, min_area: float = 0.02,
                   max_area: float = 1 / 3, min_aspect: float = 0.3,
                   max_count: int = 1, mode: str = "const") -> torch.Tensor:
    """Erase up to ``max_count`` random rectangles in each image of the
    normalised float batch ``images`` [B, H, W, C] (the loader's layout);
    returns a new tensor. ``generator`` lives on the batch's device."""
    if mode not in ("const", "rand", "pixel"):
        raise ValueError(f"mode {mode!r} is not one of const, rand, pixel")
    b, h, w, c = images.shape
    dev = images.device
    log_lo, log_hi = math.log(min_aspect), math.log(1.0 / min_aspect)
    yy = torch.arange(h, device=dev).view(1, h, 1)
    xx = torch.arange(w, device=dev).view(1, 1, w)

    def uniform(lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand((b,), generator=generator,
                                           device=dev)

    out = images
    for _ in range(max_count):
        do = uniform() < probability
        area = h * w * uniform(min_area, max_area)
        aspect = torch.exp(uniform(log_lo, log_hi))
        eh = torch.clamp(torch.sqrt(area * aspect), 1, h - 1).long()
        ew = torch.clamp(torch.sqrt(area / aspect), 1, w - 1).long()
        top = (uniform() * torch.clamp(h - eh, min=1)).long()
        left = (uniform() * torch.clamp(w - ew, min=1)).long()
        inside = ((yy >= top.view(b, 1, 1)) & (yy < (top + eh).view(b, 1, 1))
                  & (xx >= left.view(b, 1, 1))
                  & (xx < (left + ew).view(b, 1, 1)) & do.view(b, 1, 1))
        if mode == "pixel":
            fill = torch.randn(out.shape, generator=generator, device=dev,
                               dtype=out.dtype)
        elif mode == "rand":
            fill = torch.randn((b, 1, 1, c), generator=generator, device=dev,
                               dtype=out.dtype).expand_as(out)
        else:
            fill = torch.zeros((), device=dev, dtype=out.dtype)
        out = torch.where(inside[..., None], fill, out)
    return out
