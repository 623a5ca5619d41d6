"""AnchorNet: a per-anchor multiplier head (port of
``ood_object_detection_tpu.models.anchor_net``).

A small separable-conv stack over detached FPN activations that predicts
one logit per anchor of each cell, with the head's per-(repeat, level)
``HeadBatchNorm``. Submodules carry the flax names (``conv_rep_{i}``,
``bn_rep_{r}_{l}``, ``anchor_out``), so ``utils/from_jax.py`` loads a
JAX AnchorNet's variables as they are. Inputs and outputs are per-level
NHWC, as the JAX module's.
"""
from __future__ import annotations

from typing import List, Optional

import torch
from torch import nn

from ..config.model_config import ModelConfig
from .heads import HeadBatchNorm
from .layers import SeparableConv, get_act


class AnchorNet(nn.Module):
    """``num_layers - 1`` separable convs (-> HeadBatchNorm -> act per
    level) then ``anchor_out``, a separable conv to
    ``num_anchors_per_location`` channels. ``in_channels``: the FPN
    activations' width (the JAX module infers it; default
    ``config.fpn_channels``). ``detach_input`` stops the gradient into the
    activations."""

    def __init__(self, config: ModelConfig, num_layers: int = 2,
                 num_channels: int = 88, detach_input: bool = True,
                 in_channels: Optional[int] = None):
        super().__init__()
        cfg = config
        self.detach_input = detach_input
        self.act = get_act(cfg.act_type)
        self.num_convs = max(num_layers - 1, 0)
        ch = in_channels or cfg.fpn_channels
        for i in range(self.num_convs):
            self.add_module(f"conv_rep_{i}", SeparableConv(
                ch, num_channels, kernel_size=3, pad_type=cfg.pad_type,
                bias=True if i == 0 else cfg.redundant_bias, norm=False,
                act_type=None))
            for level in range(cfg.num_levels):
                self.add_module(f"bn_rep_{i}_{level}", HeadBatchNorm(
                    num_channels, cfg.norm_eps, cfg.norm_momentum))
            ch = num_channels
        self.anchor_out = SeparableConv(
            ch, cfg.num_anchors_per_location, kernel_size=3,
            pad_type=cfg.pad_type, bias=True, norm=False, act_type=None)

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        outputs = []
        for level, x_level in enumerate(x):
            if self.detach_input:
                x_level = x_level.detach()
            x_level = x_level.permute(0, 3, 1, 2)
            for r in range(self.num_convs):
                x_level = getattr(self, f"conv_rep_{r}")(x_level)
                x_level = self.act(getattr(self, f"bn_rep_{r}_{level}")(
                    x_level))
            outputs.append(self.anchor_out(x_level).permute(0, 2, 3, 1))
        return outputs
