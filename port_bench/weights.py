"""Seeded weights for both sides: drawn once on the device in one call,
laid out by the reference model's parameter names, and loaded into the
reference and into the program alike.

Every convolution weight is normal with variance 1 / fan_in (LeCun), every
bias 0, every BiFPN edge weight 1. Random weights with identity batch
norms shrink the signal block by block until every anchor scores the same,
so the running statistics are set as a trained model's are: to the
statistics of one batch of the cell's own inputs, layer by layer, in one
forward of the reference (``calibrate``). Every batch norm's scale is 0.1
and its shift 0. At scale 1 the normalised random network is chaotic: a
1e-4 change of the input moves the logits 15 times as much, and bfloat16's
rounding moves them by a fifth of their spread. At 0.3 an image with more
letterbox fill than the batch it was calibrated on still grows cell by
cell through the BiFPN to logits in the hundreds. At 0.1 the swish units
work near their linear range and a new image's logits stay within the
calibration batch's. The class
predict bias starts at the focal prior, -log((1 - 0.01) / 0.01), and three
classes drawn from the seed get +2 at every anchor: that stands for
trained weights that find objects, so that soft-NMS has real work.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch

PRIOR_BIAS = -math.log((1 - 0.01) / 0.01)
RAISED_CLASSES = 3
RAISE = 2.0
BN_SCALE = 0.1
VAR_FLOOR = 0.1


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def raised_classes(seed: int, num_classes: int) -> List[int]:
    """The classes whose bias is raised: three, drawn from the seed."""
    g = torch.Generator().manual_seed(int(seed) ^ 0x5EED)
    return sorted(torch.randperm(num_classes, generator=g)[:RAISED_CLASSES]
                  .tolist())


def make_state(model: torch.nn.Module, cfg: Dict, seed: int,
               images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The seeded state dict of ``model`` (the reference model), float32 on
    the device of ``images`` (a batch of the cell's own inputs, [N, H, W,
    3] normalised, that sets the running statistics); ``model`` is left
    there holding it."""
    device = images.device
    shapes = {k: v.shape for k, v in model.state_dict().items()}
    convs = [k for k, s in shapes.items() if len(s) == 4]
    total = sum(math.prod(shapes[k]) for k in convs)
    flat = torch.randn(total, generator=generator(seed, device),
                       device=device)
    state, offset = {}, 0
    for k in convs:
        n = math.prod(shapes[k])
        fan_in = shapes[k][1] * shapes[k][2] * shapes[k][3]
        state[k] = flat[offset:offset + n].view(shapes[k]) \
            * (1.0 / math.sqrt(fan_in))
        offset += n
    for k, s in shapes.items():
        if k in state:
            continue
        if k.endswith("num_batches_tracked"):
            state[k] = torch.zeros((), dtype=torch.long, device=device)
        elif k.endswith(("running_var", "edge_weights")):
            state[k] = torch.ones(s, device=device)
        elif k.endswith(".weight") and len(s) == 1:
            state[k] = torch.full(s, BN_SCALE, device=device)
        else:
            state[k] = torch.zeros(s, device=device)
    model.to_empty(device=device).load_state_dict(state)
    calibrate(model, images)
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    bias = state["class_net.predict.conv_pw.bias"]
    c = cfg["num_classes"]
    bias.fill_(PRIOR_BIAS)
    bias.view(-1, c)[:, raised_classes(seed, c)] += RAISE
    model.load_state_dict(state)
    return state


@torch.no_grad()
def calibrate(model: torch.nn.Module, images: torch.Tensor) -> None:
    """Set every batch norm's running statistics to those of ``images``:
    a train-mode forward in which each norm takes its batch's statistics
    whole. A channel all but constant over the batch would then divide
    any other input's departure by nearly nothing, and a few such in a row
    blow a new image's logits up by orders of magnitude, so no running
    variance is left under a tenth of its layer's mean."""
    norms = [m for m in model.modules() if hasattr(m, "running_var")]
    saved = [m.momentum for m in norms]
    for m in norms:
        m.momentum = 1.0
    model.train()
    try:
        model(images)
    finally:
        for m, momentum in zip(norms, saved):
            m.momentum = momentum
        model.eval()
    for m in norms:
        m.running_var.clamp_(min=VAR_FLOOR * float(m.running_var.mean()))
