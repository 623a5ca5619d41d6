"""BiFPN / PAN / Quad-FPN feature network from the declarative node graphs.

Port of ``ood_object_detection_tpu.models.bifpn``. Submodule names follow
the reference effdet tree (``fpn.resample.L``, ``fpn.cell.R.fnode.I.
combine.resample.O``, ``.combine.edge_weights``, ``.after_combine.conv``).
The combine weights are computed in the features' dtype, as the JAX
package does (``bifpn.py:59-68``).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ..config.fpn_config import FpnGraph, get_fpn_config
from ..config.model_config import ModelConfig
from .layers import (ConvBnAct, ResampleFeatureMap, SeparableConv, get_act,
                     remat)


def _resample(cfg: ModelConfig, in_channels: int, reduction_ratio: float
              ) -> ResampleFeatureMap:
    return ResampleFeatureMap(
        in_channels, cfg.fpn_channels, reduction_ratio=reduction_ratio,
        pad_type=cfg.pad_type, downsample=cfg.downsample_type,
        upsample=cfg.upsample_type, apply_bn=cfg.apply_resample_bn,
        conv_after_downsample=cfg.conv_after_downsample,
        redundant_bias=cfg.redundant_bias, norm_eps=cfg.norm_eps,
        norm_momentum=cfg.norm_momentum)


class FpnCombine(nn.Module):
    """Resample each input node to the target resolution / width and fuse
    them with sum, softmax-attention or fast-attention edge weights."""

    def __init__(self, cfg: ModelConfig, feature_info: Sequence[Dict[str, int]],
                 inputs_offsets: Tuple[int, ...], target_reduction: int,
                 weight_method: str):
        super().__init__()
        if weight_method not in ("sum", "attn", "fastattn"):
            raise ValueError(f"unknown weight_method {weight_method}")
        self.inputs_offsets = tuple(inputs_offsets)
        self.weight_method = weight_method
        self.resample = nn.ModuleDict({
            str(off): _resample(cfg, feature_info[off]["num_chs"],
                                target_reduction
                                / feature_info[off]["reduction"])
            for off in inputs_offsets})
        if weight_method != "sum":
            self.edge_weights = nn.Parameter(torch.ones(len(inputs_offsets)))

    def forward(self, x: List[torch.Tensor]) -> torch.Tensor:
        nodes = [self.resample[str(off)](x[off]) for off in self.inputs_offsets]
        if self.weight_method == "sum":
            return sum(nodes)
        w = self.edge_weights.to(nodes[0].dtype)
        if self.weight_method == "attn":
            w = torch.softmax(w, dim=0)
        else:
            w = torch.clamp(w, min=0.0)
            w = w / (torch.sum(w) + 1e-4)
        return sum(n * w[i] for i, n in enumerate(nodes))


class Fnode(nn.Module):
    """combine -> act -> (separable) conv -> BN, one FPN graph node (or
    combine -> conv -> BN -> act with ``conv_bn_relu_pattern``)."""

    def __init__(self, cfg: ModelConfig, feature_info: Sequence[Dict[str, int]],
                 inputs_offsets: Tuple[int, ...], target_reduction: int,
                 weight_method: str):
        super().__init__()
        self.combine = FpnCombine(cfg, feature_info, inputs_offsets,
                                  target_reduction, weight_method)
        conv_cls = SeparableConv if cfg.separable_conv else ConvBnAct
        self.act_first = not cfg.conv_bn_relu_pattern
        self.act = get_act(cfg.act_type)
        conv = conv_cls(
            cfg.fpn_channels, cfg.fpn_channels, kernel_size=3,
            pad_type=cfg.pad_type,
            bias=False if cfg.conv_bn_relu_pattern else cfg.redundant_bias,
            norm=True,
            act_type=cfg.act_type if cfg.conv_bn_relu_pattern else None,
            norm_eps=cfg.norm_eps, norm_momentum=cfg.norm_momentum)
        self.after_combine = nn.ModuleDict({"conv": conv})

    def forward(self, x: List[torch.Tensor]) -> torch.Tensor:
        out = self.combine(x)
        if self.act_first:
            out = self.act(out)
        return self.after_combine["conv"](out)


class BiFpnLayer(nn.Module):
    """One FPN cell: every graph node in order; the last num_levels out."""

    def __init__(self, cfg: ModelConfig, graph: FpnGraph,
                 feature_info: Sequence[Dict[str, int]]):
        super().__init__()
        self.num_levels = cfg.num_levels
        info = list(feature_info)
        nodes = []
        for node in graph.nodes:
            nodes.append(Fnode(cfg, tuple(info), node.inputs_offsets,
                               node.reduction, node.weight_method))
            info.append(dict(num_chs=cfg.fpn_channels,
                             reduction=node.reduction))
        self.fnode = nn.ModuleList(nodes)

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x = list(x)
        for fnode in self.fnode:
            x.append(fnode(x))
        return x[-self.num_levels:]


class BiFpn(nn.Module):
    """Extra coarse levels (P6, P7 ... by downsampling the deepest backbone
    feature) + the stacked cells, each cell under ``layers.remat`` with
    ``cfg.remat_fpn`` (the JAX package's lifted ``nn.remat`` of
    ``BiFpnLayer``)."""

    def __init__(self, cfg: ModelConfig, feature_info: Sequence[Dict[str, int]]):
        super().__init__()
        graph = get_fpn_config(cfg.fpn_name, min_level=cfg.min_level,
                               max_level=cfg.max_level)
        info = [dict(f) for f in feature_info]
        resample = {}
        for level in range(len(feature_info), cfg.num_levels):
            resample[str(level)] = _resample(cfg, info[-1]["num_chs"], 2)
            info.append(dict(num_chs=cfg.fpn_channels,
                             reduction=info[-1]["reduction"] * 2))
        self.resample = nn.ModuleDict(resample)
        cells = []
        for _ in range(cfg.fpn_cell_repeats):
            cells.append(BiFpnLayer(cfg, graph, tuple(info)))
            info = [dict(num_chs=cfg.fpn_channels, reduction=1 << lvl)
                    for lvl in range(cfg.min_level, cfg.max_level + 1)]
        self.cell = nn.ModuleList(cells)
        self.remat = cfg.remat_fpn

    def forward(self, x: List[torch.Tensor]) -> List[torch.Tensor]:
        x = list(x)
        for resample in self.resample.values():
            x.append(resample(x[-1]))
        for cell in self.cell:
            x = remat(cell, x) if self.remat else cell(x)
        return x
