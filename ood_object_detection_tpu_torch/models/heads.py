"""Class / box prediction heads (port of the main head of
``ood_object_detection_tpu.models.heads``).

Convs are shared across pyramid levels; every (repeat, level) pair has its
own ``HeadBatchNorm``. The ``separate_head`` second predict conv of the
episodic harness waits for a later slice.
"""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from ..config.model_config import ModelConfig
from .layers import ConvBnAct, SeparableConv, get_act, update_running_stats

# focal-loss prior: the class predict bias starts at -log((1 - p) / p)
PRIOR_PROB = 0.01
PRIOR_BIAS = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)


class HeadBatchNorm(nn.Module):
    """BatchNorm that normalises in the input's dtype.

    The JAX ``HeadBatchNorm`` casts its f32 statistics and affine to the
    compute dtype and does every operation there (``heads.py:69-71``);
    this module does the same, so a bf16 head rounds where the JAX one
    does. Parameter / buffer names are those of ``nn.BatchNorm2d``.

    Train mode (``module.train()``) normalises with the batch statistics,
    computed in f32 as ``jnp.mean`` / ``jnp.var`` do (two passes: the mean,
    then the mean squared deviation), and updates the running statistics
    in place with the biased variance, ``ra = (1 - m) * ra + m * batch``.
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        if self.training:
            x32 = x.float()
            mean = x32.mean(dim=(0, 2, 3))
            centred = x32 - mean.view(1, -1, 1, 1)
            var = (centred * centred).mean(dim=(0, 2, 3))
            update_running_stats(self, mean, var, 1 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var

        def vec(t):
            return t.to(dt).view(1, -1, 1, 1)

        eps = torch.tensor(self.eps, dtype=dt).item()   # rounded to dt
        y = (x - vec(mean)) * torch.rsqrt(vec(var) + eps)
        return y * vec(self.weight) + vec(self.bias)


class HeadNet(nn.Module):
    """Shared-conv head with per-(repeat, level) BatchNorm."""

    def __init__(self, cfg: ModelConfig, num_outputs: int):
        super().__init__()
        ch = cfg.fpn_channels
        conv_cls = SeparableConv if cfg.separable_conv else ConvBnAct
        init_kind = "fan_in_normal"
        self.act = get_act(cfg.head_act_type or cfg.act_type)
        self.conv_rep = nn.ModuleList([
            conv_cls(ch, ch, kernel_size=3, pad_type=cfg.pad_type,
                     bias=cfg.redundant_bias, norm=False, act_type=None,
                     init_kind=init_kind)
            for _ in range(cfg.box_class_repeats)])
        self.bn_rep = nn.ModuleList([
            nn.ModuleList([
                nn.ModuleDict({"bn": HeadBatchNorm(ch, cfg.norm_eps,
                                                   cfg.norm_momentum)})
                for _ in range(cfg.num_levels)])
            for _ in range(cfg.box_class_repeats)])
        self.predict = conv_cls(
            ch, num_outputs * cfg.num_anchors_per_location, kernel_size=3,
            pad_type=cfg.pad_type, bias=True, norm=False, act_type=None,
            init_kind=init_kind)

    def predict_bias(self) -> torch.Tensor:
        """The predict conv's output bias (the pointwise conv's for a
        separable head)."""
        conv = self.predict.conv_pw if hasattr(self.predict, "conv_pw") \
            else self.predict.conv
        return conv.bias

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        outputs = []
        for level, x_level in enumerate(x):
            for conv, bns in zip(self.conv_rep, self.bn_rep):
                x_level = self.act(bns[level]["bn"](conv(x_level)))
            outputs.append(self.predict(x_level))
        return outputs
