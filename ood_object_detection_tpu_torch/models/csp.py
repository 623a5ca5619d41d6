"""Cross-Stage-Partial backbones: CSP-ResNet50, CSP-ResNeXt50,
CSP-Darknet53.

Port of ``ood_object_detection_tpu.models.csp`` (the published CSPNet
design, arXiv:1911.11929): each stage (optionally) downsamples, expands,
splits its channels into a cross half and a block half, runs residual
blocks on the block half and merges the two through transition convs.
Submodules carry the flax names (``stem_conv``, ``stage_{i}.down_conv``,
``stage_{i}.block_{j}.c2_bn`` ...), so ``utils/from_jax.py`` maps them
as they are.

As in the JAX package, these backbones take no stochastic depth and no
rematerialisation.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, get_act, max_pool2d


def _conv_bn(parent: nn.Module, name: str, in_ch: int, out_ch: int, k: int,
             stride: int = 1, groups: int = 1) -> None:
    """The JAX ``_conv_bn_act``'s modules on ``parent``: ``{name}_conv``
    ('' padding) and ``{name}_bn``."""
    parent.add_module(f"{name}_conv", Conv2d(in_ch, out_ch, k, stride,
                                             groups=groups))
    parent.add_module(f"{name}_bn", BatchNorm2d(out_ch))


def _run(parent: nn.Module, name: str, x: torch.Tensor, act=None):
    """``{name}_conv`` -> ``{name}_bn`` (-> ``act``) of ``parent``."""
    x = getattr(parent, f"{name}_bn")(getattr(parent, f"{name}_conv")(x))
    return x if act is None else act(x)


class _ResBottleneckBlock(nn.Module):
    """1x1 -> 3x3 (grouped for ResNeXt) -> 1x1 + residual, act after."""

    def __init__(self, channels: int, bottle_ratio: float = 0.25,
                 groups: int = 1, act: str = "leaky_relu"):
        super().__init__()
        hidden = max(int(channels * bottle_ratio), groups)
        hidden = (hidden // groups) * groups
        self.act = get_act(act)
        _conv_bn(self, "c1", channels, hidden, 1)
        _conv_bn(self, "c2", hidden, hidden, 3, groups=groups)
        _conv_bn(self, "c3", hidden, channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _run(self, "c1", x, self.act)
        y = _run(self, "c2", y, self.act)
        return self.act(_run(self, "c3", y) + x)


class _DarkBlock(nn.Module):
    """1x1 -> 3x3 + residual (Darknet style), no act after the sum."""

    def __init__(self, channels: int, bottle_ratio: float = 0.5,
                 act: str = "leaky_relu"):
        super().__init__()
        hidden = int(channels * bottle_ratio)
        self.act = get_act(act)
        _conv_bn(self, "c1", channels, hidden, 1)
        _conv_bn(self, "c2", hidden, channels, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _run(self, "c1", x, self.act)
        return _run(self, "c2", y, self.act) + x


class _CrossStage(nn.Module):
    """One CSP stage: (downsample) -> expand -> split -> blocks on the
    second half -> transition -> concat -> transition."""

    def __init__(self, in_ch: int, out_channels: int, depth: int,
                 stride: int, block_type: str, bottle_ratio: float,
                 expand_ratio: float = 2.0, groups: int = 1,
                 act: str = "leaky_relu"):
        super().__init__()
        exp_chs = int(out_channels * expand_ratio)
        self.half = exp_chs // 2
        self.stride = stride
        self.depth = depth
        self.act = get_act(act)
        if stride > 1:
            _conv_bn(self, "down", in_ch, in_ch, 3, stride)
        _conv_bn(self, "exp", in_ch, exp_chs, 1)
        for i in range(depth):
            block = (_DarkBlock(self.half, bottle_ratio, act)
                     if block_type == "dark" else
                     _ResBottleneckBlock(self.half, bottle_ratio, groups, act))
            self.add_module(f"block_{i}", block)
        _conv_bn(self, "trans_b", self.half, self.half, 1)
        _conv_bn(self, "trans", 2 * self.half, out_channels, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.stride > 1:
            x = _run(self, "down", x, self.act)
        x = _run(self, "exp", x, self.act)
        xs, xb = x[:, :self.half], x[:, self.half:]
        for i in range(self.depth):
            xb = getattr(self, f"block_{i}")(xb)
        xb = _run(self, "trans_b", xb, self.act)
        return _run(self, "trans", torch.cat([xs, xb], dim=1), self.act)


@dataclasses.dataclass(frozen=True)
class CspDef:
    stem_channels: int
    stem_kernel: int
    stem_pool: bool
    depths: Tuple[int, ...]
    filters: Tuple[int, ...]
    strides: Tuple[int, ...]
    block_type: str
    bottle_ratio: float
    expand_ratio: float
    stem_stride: int = 2
    groups: int = 1
    act: str = "leaky_relu"


CSP_DEFS = {
    "cspresnet50": CspDef(64, 7, True, (3, 3, 5, 2), (128, 256, 512, 1024),
                          (1, 2, 2, 2), "bottleneck", 0.5, 2.0),
    "cspresnext50": CspDef(64, 7, True, (3, 3, 5, 2), (256, 512, 1024, 2048),
                           (1, 2, 2, 2), "bottleneck", 0.25, 1.0, groups=32),
    "cspdarknet53": CspDef(32, 3, False, (1, 2, 8, 8, 4),
                           (64, 128, 256, 512, 1024), (2, 2, 2, 2, 2),
                           "dark", 0.5, 2.0, stem_stride=1),
}


class CspBackbone(nn.Module):
    """CSP backbone emitting the three deepest features (strides 8 / 16 /
    32); ``feature_info`` lists their channels. ``spatial``: the stem
    pool's shards (``layers.max_pool2d``)."""
    spatial = None

    def __init__(self, definition: CspDef):
        super().__init__()
        d = definition
        self.stem_pool = d.stem_pool
        self.act = get_act(d.act)
        _conv_bn(self, "stem", 3, d.stem_channels, d.stem_kernel,
                 d.stem_stride)
        stride = d.stem_stride * (2 if d.stem_pool else 1)
        in_ch = d.stem_channels
        self.reductions: List[int] = []
        for i, (depth, filters, s) in enumerate(
                zip(d.depths, d.filters, d.strides)):
            stride *= s
            self.add_module(f"stage_{i}", _CrossStage(
                in_ch, filters, depth, s, d.block_type, d.bottle_ratio,
                d.expand_ratio, d.groups, d.act))
            self.reductions.append(stride)
            in_ch = filters
        chans = dict(zip(self.reductions, d.filters))
        self.feature_info = [dict(num_chs=chans[r], reduction=r)
                             for r in (8, 16, 32)]

    def forward(self, x: torch.Tensor, generator=None) -> List[torch.Tensor]:
        x = _run(self, "stem", x, self.act)
        if self.stem_pool:
            x = max_pool2d(x, 3, 2, "", self.spatial)
        features = {}
        for i, r in enumerate(self.reductions):
            x = getattr(self, f"stage_{i}")(x)
            features[r] = x
        return [features[r] for r in (8, 16, 32)]
