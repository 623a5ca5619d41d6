"""EfficientNet backbones emitting the P3/P4/P5 features.

Port of the EfficientNet path of ``ood_object_detection_tpu.models.backbone``
(``round_channels``, the stage-spec system, ``_DsBlock``, ``_IrBlock``,
``GenericBackbone``, ``create_backbone``). Submodules carry the timm /
effdet names (``conv_stem``, ``bn1``, ``blocks.S.B.conv_dw`` ...), so the
port's state_dict is the reference effdet layout that
``utils/from_jax.py`` maps to and from the JAX tree.

MixNet, the edge / lite / MobileNet / ResNet / CSP families wait for a
later slice; ``create_backbone`` refuses them by name. Every BatchNorm
(stem, ``_DsBlock``, ``_IrBlock``) follows the module's train / eval mode.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from .layers import BatchNorm2d, Conv2d, SqueezeExcite, get_act


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
    """One stage of identical blocks: 'ds' depthwise-separable or 'ir'
    inverted residual."""
    block: str
    repeats: int
    kernel: int
    stride: int
    expand: float
    channels: int
    se_ratio: float = 0.0
    act_type: Optional[str] = None       # None = model default
    no_skip: bool = False


@dataclasses.dataclass(frozen=True)
class BackboneDef:
    stem_channels: int
    stages: Tuple[BlockSpec, ...]
    width: float = 1.0
    depth: float = 1.0
    act_type: str = "swish"
    pad_type: str = ""                   # '' torch-symmetric, 'same' TF SAME
    se_gate: str = "sigmoid"


_EFFNET_STAGES = (
    BlockSpec("ds", 1, 3, 1, 1.0, 16, 0.25),
    BlockSpec("ir", 2, 3, 2, 6.0, 24, 0.25),
    BlockSpec("ir", 2, 5, 2, 6.0, 40, 0.25),
    BlockSpec("ir", 3, 3, 2, 6.0, 80, 0.25),
    BlockSpec("ir", 3, 5, 1, 6.0, 112, 0.25),
    BlockSpec("ir", 4, 5, 2, 6.0, 192, 0.25),
    BlockSpec("ir", 1, 3, 1, 6.0, 320, 0.25),
)

_WIDTH_DEPTH = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
}

BACKBONE_DEFS: Dict[str, BackboneDef] = {}
for _v, (_w, _d) in _WIDTH_DEPTH.items():
    BACKBONE_DEFS[f"efficientnet_{_v}"] = BackboneDef(
        32, _EFFNET_STAGES, width=_w, depth=_d)
    BACKBONE_DEFS[f"tf_efficientnet_{_v}"] = BackboneDef(
        32, _EFFNET_STAGES, width=_w, depth=_d, pad_type="same")


class _DsBlock(nn.Module):
    """Depthwise-separable block (no expansion): dw -> (se) -> pw."""

    def __init__(self, spec: BlockSpec, in_ch: int, out_ch: int, act_type: str,
                 pad_type: str, se_gate: str):
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.act(self.bn1(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn2(self.conv_pw(x))
        return x + shortcut if self.has_skip else x


class _IrBlock(nn.Module):
    """Inverted residual (MBConv): pw-expand -> dw -> (se) -> pw-project."""

    def __init__(self, spec: BlockSpec, in_ch: int, out_ch: int, act_type: str,
                 pad_type: str, se_gate: str):
        super().__init__()
        mid = (round_channels(in_ch * spec.expand, divisor=8)
               if spec.expand != 1.0 else in_ch)
        k, s = spec.kernel, spec.stride
        self.act = get_act(act_type)
        self.conv_pw = self.bn1 = None
        if spec.expand != 1.0:
            self.conv_pw = Conv2d(in_ch, mid, 1)
            self.bn1 = BatchNorm2d(mid)
        self.conv_dw = Conv2d(mid, mid, k, s, groups=mid, pad_type=pad_type)
        self.bn2 = BatchNorm2d(mid)
        self.se = (SqueezeExcite(mid, max(1, int(in_ch * spec.se_ratio)),
                                 act_type, se_gate)
                   if spec.se_ratio > 0 else None)
        self.conv_pwl = Conv2d(mid, out_ch, 1)
        self.bn3 = BatchNorm2d(out_ch)
        self.has_skip = s == 1 and in_ch == out_ch and not spec.no_skip

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        if self.conv_pw is not None:
            x = self.act(self.bn1(self.conv_pw(x)))
        x = self.act(self.bn2(self.conv_dw(x)))
        if self.se is not None:
            x = self.se(x)
        x = self.bn3(self.conv_pwl(x))
        return x + shortcut if self.has_skip else x


_BLOCK_TYPES = {"ds": _DsBlock, "ir": _IrBlock}


class GenericBackbone(nn.Module):
    """Stage-spec driven MBConv backbone emitting the features at
    ``out_reductions`` (the last map before each stride-2 stage, and the
    final map); ``feature_info`` lists their channels and reductions."""

    def __init__(self, definition: BackboneDef,
                 out_reductions: Tuple[int, ...] = (8, 16, 32)):
        super().__init__()
        d = definition
        self.out_reductions = tuple(out_reductions)
        stem_ch = round_channels(d.stem_channels, d.width)
        self.conv_stem = Conv2d(3, stem_ch, 3, 2, pad_type=d.pad_type)
        self.bn1 = BatchNorm2d(stem_ch)
        self.act = get_act(d.act_type)
        # (reduction at the stage's input, whether the stage downsamples):
        # the FPN takes the maps just before each stride-2 stage
        self.stage_taps: List[Tuple[int, bool]] = []
        tap_channels = {}
        stages = []
        in_ch, stride = stem_ch, 2
        for spec in d.stages:
            out_ch = round_channels(spec.channels, d.width)
            act = spec.act_type or d.act_type
            self.stage_taps.append((stride, spec.stride == 2))
            if spec.stride == 2:
                tap_channels[stride] = in_ch
                stride *= 2
            blocks = []
            for r in range(scale_repeats(spec.repeats, d.depth)):
                s = dataclasses.replace(spec, stride=spec.stride if r == 0 else 1)
                blocks.append(_BLOCK_TYPES[spec.block](
                    s, in_ch, out_ch, act, d.pad_type, d.se_gate))
                in_ch = out_ch
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.final_reduction = stride
        tap_channels[stride] = in_ch
        self.feature_info = [dict(num_chs=tap_channels[r], reduction=r)
                             for r in self.out_reductions]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = self.act(self.bn1(self.conv_stem(x)))
        features = {}
        for stage, (reduction, downsamples) in zip(self.blocks,
                                                   self.stage_taps):
            if downsamples:
                features[reduction] = x
            for block in stage:
                x = block(x)
        features[self.final_reduction] = x
        return [features[r] for r in self.out_reductions]


def create_backbone(name: str, drop_path_rate: float = 0.0,
                    remat_stages: int = 0, **backbone_args):
    """Backbone module + feature_info [{num_chs, reduction}] by zoo name.

    Stochastic depth (``drop_path_rate > 0``) and rematerialised stages
    (``remat_stages > 0``) are not ported yet and raise; so does any other
    backbone argument."""
    if drop_path_rate > 0.0:
        raise NotImplementedError("drop_path_rate > 0 is not ported yet")
    if remat_stages > 0:
        raise NotImplementedError("remat_stages > 0 is not ported yet")
    if backbone_args:
        raise NotImplementedError(
            f"backbone_args {sorted(backbone_args)} are not ported yet")
    if name not in BACKBONE_DEFS:
        raise NotImplementedError(
            f"backbone {name!r} is not ported yet (available: "
            f"{sorted(BACKBONE_DEFS)})")
    backbone = GenericBackbone(BACKBONE_DEFS[name])
    return backbone, backbone.feature_info
