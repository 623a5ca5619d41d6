"""Class / box prediction heads (port of
``ood_object_detection_tpu.models.heads``).

Convs are shared across pyramid levels; every (repeat, level) pair has its
own ``HeadBatchNorm``. The episodic harness calls the class head with
``force_batch_stats`` (batch-statistic normalisation that writes nothing),
``ret_activs`` (the predict conv's depthwise output per level),
``level_offset`` (start at pyramid level ``level_offset``) and, with
``separate_head``, ``heads="both"`` (the second pointwise predict conv
``predict_sep`` on the same depthwise output).
"""
from __future__ import annotations

import math
from typing import List

import torch
from torch import nn

from ..config.model_config import ModelConfig
from ..parallel.mesh import all_reduce_sum
from .layers import (Conv2d, ConvBnAct, SeparableConv, get_act,
                     recomputing, update_running_stats)

# focal-loss prior: the class predict bias starts at -log((1 - p) / p)
PRIOR_PROB = 0.01
PRIOR_BIAS = -math.log((1 - PRIOR_PROB) / PRIOR_PROB)


class HeadBatchNorm(nn.Module):
    """BatchNorm that normalises in the input's dtype.

    The JAX ``HeadBatchNorm`` casts its f32 statistics and affine to the
    compute dtype and does every operation there (``heads.py:69-71``);
    this module does the same, so a bf16 head rounds where the JAX one
    does. Parameter / buffer names are those of ``nn.BatchNorm2d``.

    Train mode (``module.train()``) and ``force_batch_stats`` normalise
    with the batch statistics, computed in f32 as ``jnp.mean`` /
    ``jnp.var`` do (two passes: the mean, then the mean squared
    deviation). Train mode also updates the running statistics in place
    with the biased variance, ``ra = (1 - m) * ra + m * batch``, unless
    ``write_stats`` is False or the forward is ``layers.remat``'s
    recompute; ``force_batch_stats`` in eval mode writes
    nothing, as the JAX head does outside a mutable apply.

    With a ``sync_group`` (``parallel.synced_batch_norms``) train mode
    takes the global batch's moments in the same two passes: [sum x,
    count] summed over the group's ranks, then the summed squared
    deviations, each a differentiable all-reduce.
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.write_stats = True
        self.sync_group = None
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor,
                force_batch_stats: bool = False) -> torch.Tensor:
        dt = x.dtype
        if self.training or force_batch_stats:
            x32 = x.float()
            group = self.sync_group if self.training else None
            if group is None:
                mean = x32.mean(dim=(0, 2, 3))
                centred = x32 - mean.view(1, -1, 1, 1)
                var = (centred * centred).mean(dim=(0, 2, 3))
            else:
                c = x32.shape[1]
                sums = all_reduce_sum(torch.cat([
                    x32.sum(dim=(0, 2, 3)),
                    x32.new_full((1,), x32.numel() // c)]), group)
                mean = sums[:c] / sums[c]
                centred = x32 - mean.view(1, -1, 1, 1)
                var = all_reduce_sum((centred * centred).sum(dim=(0, 2, 3)),
                                     group) / sums[c]
            if self.training and self.write_stats and not recomputing():
                update_running_stats(self, mean, var, 1 - self.momentum)
        else:
            mean, var = self.running_mean, self.running_var

        def vec(t):
            return t.to(dt).view(1, -1, 1, 1)

        eps = torch.tensor(self.eps, dtype=dt).item()   # rounded to dt
        y = (x - vec(mean)) * torch.rsqrt(vec(var) + eps)
        return y * vec(self.weight) + vec(self.bias)


class HeadNet(nn.Module):
    """Shared-conv head with per-(repeat, level) BatchNorm.

    ``separate_head`` adds ``predict_sep``, a second pointwise predict conv
    on the predict conv's depthwise output (the reference MetaHead's
    ``add_head``); it needs a separable head.
    """

    def __init__(self, cfg: ModelConfig, num_outputs: int,
                 separate_head: bool = False):
        super().__init__()
        ch = cfg.fpn_channels
        conv_cls = SeparableConv if cfg.separable_conv else ConvBnAct
        init_kind = "fan_in_normal"
        self.separable = cfg.separable_conv
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
        num_out = num_outputs * cfg.num_anchors_per_location
        self.predict = conv_cls(
            ch, num_out, kernel_size=3, pad_type=cfg.pad_type, bias=True,
            norm=False, act_type=None, init_kind=init_kind)
        self.predict_sep = None
        if separate_head:
            if not cfg.separable_conv:
                raise ValueError("separate_head requires separable_conv heads "
                                 "(the reference MetaHead is separable-only)")
            self.predict_sep = Conv2d(ch, num_out, 1, bias=True,
                                      init_kind=init_kind)

    def predict_bias(self) -> torch.Tensor:
        """The predict conv's output bias (the pointwise conv's for a
        separable head)."""
        conv = self.predict.conv_pw if self.separable else self.predict.conv
        return conv.bias

    def forward(self, x: List[torch.Tensor], ret_activs: bool = False,
                level_offset: int = 0, force_batch_stats: bool = False,
                heads: str = "main"):
        """Per-level NCHW features -> per-level outputs of the levels from
        ``level_offset`` on. With ``ret_activs`` also the activations the
        predict conv's pointwise stage reads (the depthwise output of a
        separable head). With ``separate_head`` and ``heads="both"``:
        (sep outputs, outputs[, activs]), the JAX head's order."""
        both = self.predict_sep is not None and heads == "both"
        outputs, sep_outputs, activs = [], [], []
        for level in range(level_offset, len(x)):
            x_level = x[level]
            for conv, bns in zip(self.conv_rep, self.bn_rep):
                x_level = self.act(bns[level]["bn"](conv(x_level),
                                                    force_batch_stats))
            if self.separable:
                x_pred = self.predict.conv_dw(x_level)
                outputs.append(self.predict.conv_pw(x_pred))
            else:
                x_pred = x_level
                outputs.append(self.predict(x_level))
            if ret_activs:
                activs.append(x_pred)
            if both:
                sep_outputs.append(self.predict_sep(x_pred))
        if both:
            return (sep_outputs, outputs, activs) if ret_activs else \
                (sep_outputs, outputs)
        return (outputs, activs) if ret_activs else outputs
