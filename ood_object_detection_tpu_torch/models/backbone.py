"""Feature-pyramid backbones: EfficientNet, lite / edge, MobileNetV2 / V3,
MixNet, ResNet and (``models/csp.py``) CSP.

Port of ``ood_object_detection_tpu.models.backbone``: ``round_channels``,
the stage-spec system (``BlockSpec``, ``BackboneDef``, ``BACKBONE_DEFS``),
the blocks (``_DsBlock``, ``_IrBlock`` with MixNet's mixed depthwise and
grouped pointwise convs, ``_ErBlock``, ``_ConvBnActBlock``),
``GenericBackbone``, ``ResNetBackbone`` and ``create_backbone``.

Submodules carry the names that ``utils/from_jax.py`` maps to the JAX
tree: the EfficientNet family's timm / effdet names (``conv_stem``,
``bn1``, ``blocks.S.B.conv_dw`` ...), the flax names below a block
(``conv_dw.conv_dw_{i}`` of a mixed depthwise conv, ``conv_exp``,
``conv_pwl``) and ResNet's (``bn_stem``, ``layer{i}_{b}``). Every
BatchNorm follows the module's train / eval mode.

Stochastic depth: each ``ds`` / ``ir`` / ``er`` block with a skip drops
its residual branch at ``drop_path_rate * block_idx / total_blocks`` (the
JAX linear schedule) when ``forward`` is given a ``torch.Generator``, not
gated on train mode, as the JAX package's ``_maybe_drop_path`` is active
whenever a 'drop_path' rng is passed. The masks of a forward are drawn
before any block runs, so that ``remat_stages`` (the first N stages'
blocks recomputed in the backward, ``layers.remat``) sees the same masks
on its recompute.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (BatchNorm2d, Conv2d, SqueezeExcite, apply_drop,
                     drop_mask, get_act, remat)


def round_channels(channels: float, multiplier: float = 1.0,
                   divisor: int = 8, min_value: Optional[int] = None) -> int:
    """TF/timm channel rounding: scale, snap to divisor, never drop >10%."""
    if not multiplier:
        return int(channels)
    channels *= multiplier
    min_value = min_value or divisor
    new_ch = max(min_value, int(channels + divisor / 2) // divisor * divisor)
    if new_ch < 0.9 * channels:
        new_ch += divisor
    return int(new_ch)


def scale_repeats(repeats: int, depth_multiplier: float) -> int:
    return int(math.ceil(repeats * depth_multiplier))


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One stage of identical blocks.

    block: 'ds' depthwise-separable | 'ir' inverted residual |
           'er' edge (fused) residual | 'cn' plain conv
    """
    block: str
    repeats: int
    kernel: int
    stride: int
    expand: float
    channels: int
    se_ratio: float = 0.0
    act_type: Optional[str] = None       # None = model default
    fused_channels: int = 0              # 'er': force expanded width
    no_skip: bool = False
    kernels: Tuple[int, ...] = ()        # mixed-kernel depthwise (MixNet)
    exp_groups: int = 1                  # 'ir': groups of the pw expand
    pwl_groups: int = 1                  # 'ir': groups of the pw project


@dataclasses.dataclass(frozen=True)
class BackboneDef:
    stem_channels: int
    stages: Tuple[BlockSpec, ...]
    width: float = 1.0
    depth: float = 1.0
    act_type: str = "swish"
    pad_type: str = ""                   # '' torch-symmetric, 'same' TF SAME
    fix_stem: bool = False               # don't width-scale the stem
    fix_first_last: bool = False         # don't depth-scale first/last stage
    se_from_expanded: bool = False       # SE reduce base: expanded vs input
    se_gate: str = "sigmoid"
    se_divisor: int = 1                  # round SE reduce chs (mnv3: 8)


# ---------------------------------------------------------------------------
# stage specs (the JAX package's tables)
# ---------------------------------------------------------------------------

_EFFNET_STAGES = (
    BlockSpec("ds", 1, 3, 1, 1.0, 16, 0.25),
    BlockSpec("ir", 2, 3, 2, 6.0, 24, 0.25),
    BlockSpec("ir", 2, 5, 2, 6.0, 40, 0.25),
    BlockSpec("ir", 3, 3, 2, 6.0, 80, 0.25),
    BlockSpec("ir", 3, 5, 1, 6.0, 112, 0.25),
    BlockSpec("ir", 4, 5, 2, 6.0, 192, 0.25),
    BlockSpec("ir", 1, 3, 1, 6.0, 320, 0.25),
)

_EFFNET_LITE_STAGES = tuple(
    dataclasses.replace(s, se_ratio=0.0) for s in _EFFNET_STAGES)

_EFFNET_EDGE_STAGES = (
    BlockSpec("er", 1, 3, 1, 4.0, 24, 0.0, fused_channels=24, no_skip=True),
    BlockSpec("er", 2, 3, 2, 8.0, 32, 0.0),
    BlockSpec("er", 4, 3, 2, 8.0, 48, 0.0),
    BlockSpec("ir", 5, 5, 2, 8.0, 96, 0.0),
    BlockSpec("ir", 4, 5, 1, 8.0, 144, 0.0),
    BlockSpec("ir", 2, 5, 2, 8.0, 192, 0.0),
)

_MOBILENET_V2_STAGES = (
    BlockSpec("ds", 1, 3, 1, 1.0, 16),
    BlockSpec("ir", 2, 3, 2, 6.0, 24),
    BlockSpec("ir", 3, 3, 2, 6.0, 32),
    BlockSpec("ir", 4, 3, 2, 6.0, 64),
    BlockSpec("ir", 3, 3, 1, 6.0, 96),
    BlockSpec("ir", 3, 3, 2, 6.0, 160),
    BlockSpec("ir", 1, 3, 1, 6.0, 320),
)

_MOBILENET_V3_LARGE_STAGES = (
    BlockSpec("ds", 1, 3, 1, 1.0, 16, 0.0, act_type="relu"),
    BlockSpec("ir", 1, 3, 2, 4.0, 24, 0.0, act_type="relu"),
    BlockSpec("ir", 1, 3, 1, 3.0, 24, 0.0, act_type="relu"),
    BlockSpec("ir", 3, 5, 2, 3.0, 40, 0.25, act_type="relu"),
    BlockSpec("ir", 1, 3, 2, 6.0, 80, 0.0),
    BlockSpec("ir", 1, 3, 1, 2.5, 80, 0.0),
    BlockSpec("ir", 2, 3, 1, 2.3, 80, 0.0),
    BlockSpec("ir", 2, 3, 1, 6.0, 112, 0.25),
    BlockSpec("ir", 3, 5, 2, 6.0, 160, 0.25),
)

# MixNet: grouped pointwise convs where timm's arch strings say a1.1 / p1.1
# (groups 2), mixed depthwise kernels where they list several
_MIXNET_S_STAGES = (
    BlockSpec("ds", 1, 3, 1, 1.0, 16, 0.0, act_type="relu"),
    BlockSpec("ir", 1, 3, 2, 6.0, 24, 0.0, act_type="relu",
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 3, 1, 3.0, 24, 0.0, act_type="relu",
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 0, 2, 6.0, 40, 0.5, act_type="swish", kernels=(3, 5, 7)),
    BlockSpec("ir", 3, 0, 1, 6.0, 40, 0.5, act_type="swish", kernels=(3, 5),
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 0, 2, 6.0, 80, 0.25, act_type="swish", kernels=(3, 5, 7),
              pwl_groups=2),
    BlockSpec("ir", 2, 0, 1, 6.0, 80, 0.25, act_type="swish", kernels=(3, 5),
              pwl_groups=2),
    BlockSpec("ir", 1, 0, 1, 6.0, 120, 0.5, act_type="swish", kernels=(3, 5, 7),
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 2, 0, 1, 3.0, 120, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9), exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 0, 2, 6.0, 200, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9, 11)),
    BlockSpec("ir", 2, 0, 1, 6.0, 200, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9), pwl_groups=2),
)

_MIXNET_M_STAGES = (
    BlockSpec("ds", 1, 3, 1, 1.0, 24, 0.0, act_type="relu"),
    BlockSpec("ir", 1, 0, 2, 6.0, 32, 0.0, act_type="relu", kernels=(3, 5, 7),
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 3, 1, 3.0, 32, 0.0, act_type="relu",
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 0, 2, 6.0, 40, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9)),
    BlockSpec("ir", 3, 0, 1, 6.0, 40, 0.5, act_type="swish", kernels=(3, 5),
              exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 0, 2, 6.0, 80, 0.25, act_type="swish", kernels=(3, 5, 7)),
    BlockSpec("ir", 3, 0, 1, 6.0, 80, 0.25, act_type="swish",
              kernels=(3, 5, 7, 9), exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 3, 1, 6.0, 120, 0.5, act_type="swish"),
    BlockSpec("ir", 3, 0, 1, 3.0, 120, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9), exp_groups=2, pwl_groups=2),
    BlockSpec("ir", 1, 0, 2, 6.0, 200, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9)),
    BlockSpec("ir", 3, 0, 1, 6.0, 200, 0.5, act_type="swish",
              kernels=(3, 5, 7, 9), pwl_groups=2),
)


def _effnet(width, depth, **kw):
    return BackboneDef(32, _EFFNET_STAGES, width=width, depth=depth, **kw)


def _effnet_lite(width, depth, **kw):
    return BackboneDef(32, _EFFNET_LITE_STAGES, width=width, depth=depth,
                       act_type="relu6", fix_stem=True, fix_first_last=True,
                       **kw)


_WIDTH_DEPTH = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}
_LITE_WIDTH_DEPTH = {f"lite{i}": _WIDTH_DEPTH[f"b{i}"] for i in range(5)}

BACKBONE_DEFS: Dict[str, BackboneDef] = {}
for _v, (_w, _d) in _WIDTH_DEPTH.items():
    BACKBONE_DEFS[f"efficientnet_{_v}"] = _effnet(_w, _d)
    BACKBONE_DEFS[f"tf_efficientnet_{_v}"] = _effnet(_w, _d, pad_type="same")
for _v, (_w, _d) in _LITE_WIDTH_DEPTH.items():
    BACKBONE_DEFS[f"efficientnet_{_v}"] = _effnet_lite(_w, _d)
    BACKBONE_DEFS[f"tf_efficientnet_{_v}"] = _effnet_lite(_w, _d,
                                                           pad_type="same")
BACKBONE_DEFS.update({
    "efficientnet_es": BackboneDef(32, _EFFNET_EDGE_STAGES, 1.0, 1.0,
                                   act_type="relu"),
    "efficientnet_em": BackboneDef(32, _EFFNET_EDGE_STAGES, 1.0, 1.1,
                                   act_type="relu"),
    "mobilenetv2_100": BackboneDef(32, _MOBILENET_V2_STAGES, 1.0, 1.0,
                                   act_type="relu6"),
    "mobilenetv2_110d": BackboneDef(32, _MOBILENET_V2_STAGES, 1.1, 1.2,
                                    act_type="relu6", fix_stem=True,
                                    fix_first_last=True),
    "mobilenetv2_120d": BackboneDef(32, _MOBILENET_V2_STAGES, 1.2, 1.4,
                                    act_type="relu6", fix_stem=True,
                                    fix_first_last=True),
    "mobilenetv3_large_100": BackboneDef(
        16, _MOBILENET_V3_LARGE_STAGES, 1.0, 1.0, act_type="hard_swish",
        se_from_expanded=True, se_gate="hard_sigmoid", se_divisor=8),
    "mixnet_s": BackboneDef(16, _MIXNET_S_STAGES, 1.0, 1.0,
                            act_type="swish", fix_stem=True),
    "mixnet_m": BackboneDef(24, _MIXNET_M_STAGES, 1.0, 1.0,
                            act_type="swish", fix_stem=True),
    "mixnet_l": BackboneDef(24, _MIXNET_M_STAGES, 1.3, 1.0,
                            act_type="swish", fix_stem=True),
})


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _split_channels(total: int, groups: int) -> List[int]:
    """Even split of ``total`` channels, the remainder to the first group."""
    base = total // groups
    chans = [base] * groups
    chans[0] += total - base * groups
    return chans


class _MixedDepthwiseConv(nn.Module):
    """MixNet mixed depthwise conv: the channels split across the kernel
    sizes (``_split_channels``), one k x k depthwise conv a group
    (``conv_dw_{i}``), concatenated."""

    def __init__(self, channels: int, kernels: Tuple[int, ...], stride: int,
                 pad_type: str):
        super().__init__()
        self.splits = _split_channels(channels, len(kernels))
        for i, (k, ch) in enumerate(zip(kernels, self.splits)):
            self.add_module(f"conv_dw_{i}", Conv2d(
                ch, ch, k, stride, groups=ch, pad_type=pad_type))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        parts = torch.split(x, self.splits, dim=1)
        return torch.cat([getattr(self, f"conv_dw_{i}")(p)
                          for i, p in enumerate(parts)], dim=1)


class _DropPathBlock(nn.Module):
    """A block whose residual branch stochastic depth may drop: its
    ``drop_path_rate`` (0 without) and whether it has a skip."""
    drop_path_rate: float = 0.0
    has_skip: bool = False

    def _residual(self, x: torch.Tensor, shortcut: torch.Tensor,
                  mask: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.has_skip:
            return x
        return apply_drop(x, mask, self.drop_path_rate) + shortcut


class _ConvBnActBlock(_DropPathBlock):
    """Plain conv -> BN -> act ('cn')."""

    def __init__(self, spec: BlockSpec, in_ch: int, out_ch: int,
                 act_type: str, pad_type: str, **_):
        super().__init__()
        self.conv = Conv2d(in_ch, out_ch, spec.kernel, spec.stride,
                           pad_type=pad_type)
        self.bn = BatchNorm2d(out_ch)
        self.act = get_act(act_type)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class _DsBlock(_DropPathBlock):
    """Depthwise-separable block (no expansion): dw -> (se) -> pw."""

    def __init__(self, spec: BlockSpec, in_ch: int, out_ch: int, act_type: str,
                 pad_type: str, se_gate: str = "sigmoid", **_):
        super().__init__()
        k, s = spec.kernel, spec.stride
        self.conv_dw = Conv2d(in_ch, in_ch, k, s, groups=in_ch,
                              pad_type=pad_type)
        self.bn1 = BatchNorm2d(in_ch)
        self.act = get_act(act_type)
        self.se = (SqueezeExcite(in_ch, max(1, int(in_ch * spec.se_ratio)),
                                 act_type, se_gate)
                   if spec.se_ratio > 0 else None)
        self.conv_pw = Conv2d(in_ch, out_ch, 1)
        self.bn2 = BatchNorm2d(out_ch)
        self.has_skip = s == 1 and in_ch == out_ch and not spec.no_skip

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        return self._residual(self.bn2(self.conv_pw(x)), shortcut, mask)


class _IrBlock(_DropPathBlock):
    """Inverted residual (MBConv): pw-expand -> dw (or MixNet's mixed dw)
    -> (se) -> pw-project, the pointwise convs grouped for MixNet."""

    def __init__(self, spec: BlockSpec, in_ch: int, out_ch: int, act_type: str,
                 pad_type: str, se_gate: str = "sigmoid",
                 se_from_expanded: bool = False, se_divisor: int = 1, **_):
        super().__init__()
        mid = (round_channels(in_ch * spec.expand, divisor=8)
               if spec.expand != 1.0 else in_ch)
        k, s = spec.kernel, spec.stride
        self.act = get_act(act_type)
        self.conv_pw = self.bn1 = None
        if spec.expand != 1.0:
            self.conv_pw = Conv2d(in_ch, mid, 1, groups=spec.exp_groups)
            self.bn1 = BatchNorm2d(mid)
        if spec.kernels:
            self.conv_dw = _MixedDepthwiseConv(mid, spec.kernels, s, pad_type)
        else:
            self.conv_dw = Conv2d(mid, mid, k, s, groups=mid,
                                  pad_type=pad_type)
        self.bn2 = BatchNorm2d(mid)
        self.se = None
        if spec.se_ratio > 0:
            base = mid if se_from_expanded else in_ch
            reduced = max(1, int(base * spec.se_ratio))
            if se_divisor > 1:
                reduced = round_channels(reduced, 1.0, se_divisor)
            self.se = SqueezeExcite(mid, reduced, act_type, se_gate)
        self.conv_pwl = Conv2d(mid, out_ch, 1, groups=spec.pwl_groups)
        self.bn3 = BatchNorm2d(out_ch)
        self.has_skip = s == 1 and in_ch == out_ch and not spec.no_skip

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        shortcut = x
        if self.conv_pw is not None:
            x = self.act(self.bn1(self.conv_pw(x)))
        x = self.act(self.bn2(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        return self._residual(self.bn3(self.conv_pwl(x)), shortcut, mask)


class _ErBlock(_DropPathBlock):
    """Edge residual (fused MBConv): full k x k expand conv -> pw-project."""

    def __init__(self, spec: BlockSpec, in_ch: int, out_ch: int, act_type: str,
                 pad_type: str, **_):
        super().__init__()
        mid = spec.fused_channels or round_channels(in_ch * spec.expand,
                                                    divisor=8)
        self.conv_exp = Conv2d(in_ch, mid, spec.kernel, spec.stride,
                               pad_type=pad_type)
        self.bn1 = BatchNorm2d(mid)
        self.act = get_act(act_type)
        self.conv_pwl = Conv2d(mid, out_ch, 1)
        self.bn2 = BatchNorm2d(out_ch)
        self.has_skip = (spec.stride == 1 and in_ch == out_ch
                         and not spec.no_skip)

    def forward(self, x: torch.Tensor, mask=None) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_exp(x)))
        return self._residual(self.bn2(self.conv_pwl(x)), shortcut, mask)


_BLOCK_TYPES = {"ds": _DsBlock, "ir": _IrBlock, "er": _ErBlock,
                "cn": _ConvBnActBlock}


def stage_repeats(d: BackboneDef) -> List[int]:
    """Blocks of each stage: depth-scaled, except the first and last stage
    under ``fix_first_last``."""
    n = len(d.stages)
    return [spec.repeats if d.fix_first_last and i in (0, n - 1)
            else scale_repeats(spec.repeats, d.depth)
            for i, spec in enumerate(d.stages)]


class GenericBackbone(nn.Module):
    """Stage-spec driven MBConv backbone emitting the features at
    ``out_reductions`` (the last map before each stride-2 stage, and the
    final map); ``feature_info`` lists their channels and reductions.

    ``drop_path_rate``: the stochastic-depth rate of the deepest block
    (the JAX schedule: ``rate * block_idx / total_blocks`` over every
    block). ``remat_stages``: the first N stages' blocks run under
    ``layers.remat``."""

    def __init__(self, definition: BackboneDef,
                 out_reductions: Tuple[int, ...] = (8, 16, 32),
                 remat_stages: int = 0, drop_path_rate: float = 0.0):
        super().__init__()
        d = definition
        self.out_reductions = tuple(out_reductions)
        self.remat_stages = remat_stages
        stem_ch = d.stem_channels if d.fix_stem else round_channels(
            d.stem_channels, d.width)
        self.conv_stem = Conv2d(3, stem_ch, 3, 2, pad_type=d.pad_type)
        self.bn1 = BatchNorm2d(stem_ch)
        self.act = get_act(d.act_type)
        # (reduction at the stage's input, whether the stage downsamples):
        # the FPN takes the maps just before each stride-2 stage
        self.stage_taps: List[Tuple[int, bool]] = []
        tap_channels = {}
        stages = []
        in_ch, stride = stem_ch, 2
        repeats = stage_repeats(d)
        total_blocks, block_idx = sum(repeats), 0
        for spec, n_blocks in zip(d.stages, repeats):
            out_ch = round_channels(spec.channels, d.width)
            act = spec.act_type or d.act_type
            self.stage_taps.append((stride, spec.stride == 2))
            if spec.stride == 2:
                tap_channels[stride] = in_ch
                stride *= 2
            blocks = []
            for r in range(n_blocks):
                s = dataclasses.replace(spec, stride=spec.stride if r == 0
                                        else 1)
                block = _BLOCK_TYPES[spec.block](
                    s, in_ch, out_ch, act, d.pad_type, se_gate=d.se_gate,
                    se_from_expanded=d.se_from_expanded,
                    se_divisor=d.se_divisor)
                if spec.block != "cn" and drop_path_rate:
                    block.drop_path_rate = (drop_path_rate * block_idx
                                            / total_blocks)
                blocks.append(block)
                in_ch = out_ch
                block_idx += 1
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.final_reduction = stride
        tap_channels[stride] = in_ch
        self.feature_info = [dict(num_chs=tap_channels[r], reduction=r)
                             for r in self.out_reductions]

    def drop_masks(self, batch: int, generator: Optional[torch.Generator]
                   ) -> List[List[Optional[torch.Tensor]]]:
        """Each block's keep mask for one forward (None where it drops
        nothing), drawn in block order from ``generator``."""
        return [[drop_mask(batch, generator, b.drop_path_rate)
                 if generator is not None and b.has_skip
                 and b.drop_path_rate > 0 else None for b in stage]
                for stage in self.blocks]

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> List[torch.Tensor]:
        masks = self.drop_masks(x.shape[0], generator)
        x = self.act(self.bn1(self.conv_stem(x)))
        features = {}
        for i, (stage, (reduction, downsamples)) in enumerate(
                zip(self.blocks, self.stage_taps)):
            if downsamples:
                features[reduction] = x
            for block, mask in zip(stage, masks[i]):
                x = remat(block, x, mask) if i < self.remat_stages else \
                    block(x, mask)
        features[self.final_reduction] = x
        return [features[r] for r in self.out_reductions]


# ---------------------------------------------------------------------------
# ResNet (resdet50)
# ---------------------------------------------------------------------------

class _Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1 (x4), projected shortcut where the shape
    changes, ReLU after the sum."""

    def __init__(self, in_ch: int, mid: int, stride: int = 1):
        super().__init__()
        out_ch = mid * 4
        self.conv1 = Conv2d(in_ch, mid, 1)
        self.bn1 = BatchNorm2d(mid)
        self.conv2 = Conv2d(mid, mid, 3, stride)
        self.bn2 = BatchNorm2d(mid)
        self.conv3 = Conv2d(mid, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch)
        self.downsample_conv = self.downsample_bn = None
        if in_ch != out_ch or stride != 1:
            self.downsample_conv = Conv2d(in_ch, out_ch, 1, stride)
            self.downsample_bn = BatchNorm2d(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        shortcut = x
        if self.downsample_conv is not None:
            shortcut = self.downsample_bn(self.downsample_conv(x))
        return F.relu(y + shortcut)


class ResNetBackbone(nn.Module):
    """ResNet-50 style backbone -> C3 / C4 / C5 (strides 8 / 16 / 32)."""

    def __init__(self, layers: Tuple[int, ...] = (3, 4, 6, 3)):
        super().__init__()
        self.conv_stem = Conv2d(3, 64, 7, 2)
        self.bn_stem = BatchNorm2d(64)
        self.layer_names: List[List[str]] = []
        in_ch = 64
        for i, (blocks, mid) in enumerate(zip(layers, (64, 128, 256, 512))):
            names = []
            for b in range(blocks):
                stride = 2 if i > 0 and b == 0 else 1
                names.append(f"layer{i + 1}_{b}")
                self.add_module(names[-1], _Bottleneck(in_ch, mid, stride))
                in_ch = mid * 4
            self.layer_names.append(names)
        self.feature_info = [dict(num_chs=c, reduction=r) for c, r in
                             zip((512, 1024, 2048), (8, 16, 32))]

    def forward(self, x: torch.Tensor, generator=None) -> List[torch.Tensor]:
        x = F.relu(self.bn_stem(self.conv_stem(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)
        outs = []
        for i, names in enumerate(self.layer_names):
            for name in names:
                x = getattr(self, name)(x)
            if i >= 1:
                outs.append(x)
        return outs


def available_backbones() -> List[str]:
    """Every backbone name, in the JAX package's order."""
    from .csp import CSP_DEFS
    return sorted(BACKBONE_DEFS) + ["resnet50"] + sorted(CSP_DEFS)


def create_backbone(name: str, drop_path_rate: float = 0.0,
                    remat_stages: int = 0, **backbone_args):
    """Backbone module + feature_info [{num_chs, reduction}] by zoo name.

    As the JAX ``create_backbone``: other ``backbone_args`` (such as
    ``efficientdet_w0``'s ``feature_location``) are accepted and unused,
    and ResNet / CSP take no ``remat_stages`` or ``drop_path_rate``."""
    del backbone_args
    if name in BACKBONE_DEFS:
        backbone = GenericBackbone(BACKBONE_DEFS[name],
                                   remat_stages=remat_stages,
                                   drop_path_rate=drop_path_rate)
        return backbone, backbone.feature_info
    if name == "resnet50":
        backbone = ResNetBackbone()
        return backbone, backbone.feature_info
    from .csp import CSP_DEFS, CspBackbone
    if name in CSP_DEFS:
        backbone = CspBackbone(CSP_DEFS[name])
        return backbone, backbone.feature_info
    raise NotImplementedError(
        f"backbone '{name}' is not implemented yet "
        f"(available: {available_backbones()})")
