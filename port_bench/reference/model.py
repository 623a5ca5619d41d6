"""Plain EfficientDet (EfficientNet-B0 / B4 backbone, BiFPN, class and box
heads) in float32 PyTorch: the benchmark's reference forward.

Written from the published description (Tan et al., arXiv:1911.09070;
EfficientNet, arXiv:1905.11946) and timm / effdet's module layout, whose
parameter names it keeps, so that one state dict loads into this model and
into the program alike. It imports nothing of the program.

Every convolution runs through ``conv``, which inside ``precision("fp8")``
rounds its input and weight to float8 e4m3 and, in a backward pass, the
gradients that reach them to e5m2 (one scale a tensor, as float8 training
does): that is the benchmark's control, the reference computed one
precision below the configuration's bfloat16. Outside it everything is
float32 with TF32 off.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

_PRECISION = ["fp32"]
FP8_MAX = 448.0      # the largest finite float8 e4m3 value
E5M2_MAX = 57344.0   # the largest finite float8 e5m2 value


@contextlib.contextmanager
def precision(name: str):
    """Run the reference's convolutions in ``name``: 'fp32' or 'fp8'."""
    if name not in ("fp32", "fp8"):
        raise ValueError(f"unknown precision {name!r}")
    _PRECISION.append(name)
    try:
        yield
    finally:
        _PRECISION.pop()


def _round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """``x`` rounded to the float8 ``dtype`` under one scale that maps its
    largest magnitude to ``top``, and back."""
    scale = top / x.abs().amax().clamp(min=1e-30)
    return (x * scale).to(dtype).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):
    """Float8 as it trains: values rounded to e4m3 on the way forward,
    gradients to e5m2 on the way back, one scale a tensor."""

    @staticmethod
    def forward(ctx, x):
        return _round(x, torch.float8_e4m3fn, FP8_MAX)

    @staticmethod
    def backward(ctx, g):
        return _round(g, torch.float8_e5m2, E5M2_MAX)


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    return _Fp8.apply(x)


def conv(x: torch.Tensor, weight: torch.Tensor, bias: Optional[torch.Tensor],
         stride: int, groups: int, same: bool) -> torch.Tensor:
    """2-D convolution with symmetric ``(k - 1) // 2`` padding, or TF SAME
    padding (asymmetric, more at the end) with ``same``."""
    if _PRECISION[-1] == "fp8":
        x, weight = fp8_round(x), fp8_round(weight)
    k = weight.shape[-1]
    if same:
        x = F.pad(x, (*_same_pads(x.shape[3], k, stride),
                      *_same_pads(x.shape[2], k, stride)))
        pad = 0
    else:
        pad = (k - 1) // 2
    return F.conv2d(x, weight, bias, stride, pad, 1, groups)


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def max_pool(x: torch.Tensor, same: bool) -> torch.Tensor:
    """3 x 3 max pooling at stride 2, padded with -inf."""
    if same:
        x = F.pad(x, (*_same_pads(x.shape[3], 3, 2),
                      *_same_pads(x.shape[2], 3, 2)), value=float("-inf"))
        return F.max_pool2d(x, 3, 2)
    return F.max_pool2d(x, 3, 2, padding=1)


class Conv(nn.Module):
    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 groups: int = 1, bias: bool = False, same: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin // groups, k, k))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.groups, self.same = stride, groups, same

    def forward(self, x):
        return conv(x, self.weight, self.bias, self.stride, self.groups,
                    self.same)


class BatchNorm(nn.Module):
    """Batch normalisation, eps 1e-3: the batch's mean and (biased)
    variance in train mode, the running ones in eval mode. Train mode also
    moves the running statistics by ``momentum`` toward the batch's."""

    def __init__(self, c: int, momentum: float = 0.01, counter: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        if counter:
            self.register_buffer("num_batches_tracked",
                                 torch.zeros((), dtype=torch.long))
        self.momentum, self.eps = momentum, 1e-3

    def forward(self, x):
        if self.training:
            mean = x.mean(dim=(0, 2, 3))
            var = x.var(dim=(0, 2, 3), unbiased=False)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean.detach())
                self.running_var.mul_(1 - m).add_(m * var.detach())
        else:
            mean, var = self.running_mean, self.running_var
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(1, -1, 1, 1)) * scale.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)


def swish(x):
    return x * torch.sigmoid(x)


class SqueezeExcite(nn.Module):
    def __init__(self, c: int, reduced: int):
        super().__init__()
        self.conv_reduce = Conv(c, reduced, 1, bias=True)
        self.conv_expand = Conv(reduced, c, 1, bias=True)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        return x * torch.sigmoid(self.conv_expand(swish(self.conv_reduce(s))))


class DepthwiseSeparable(nn.Module):
    """EfficientNet's first stage: depthwise, squeeze-excite, pointwise."""

    def __init__(self, cin, cout, k, stride, se, same):
        super().__init__()
        self.conv_dw = Conv(cin, cin, k, stride, groups=cin, same=same)
        self.bn1 = BatchNorm(cin)
        self.se = SqueezeExcite(cin, max(1, int(cin * se)))
        self.conv_pw = Conv(cin, cout, 1)
        self.bn2 = BatchNorm(cout)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        y = self.bn2(self.conv_pw(self.se(swish(self.bn1(self.conv_dw(x))))))
        return y + x if self.skip else y


class InvertedResidual(nn.Module):
    """MBConv: pointwise expansion, depthwise, squeeze-excite (reduced from
    the block's input width), pointwise projection, residual."""

    def __init__(self, cin, cout, k, stride, expand, se, same):
        super().__init__()
        mid = round_channels(cin * expand)
        self.conv_pw = Conv(cin, mid, 1)
        self.bn1 = BatchNorm(mid)
        self.conv_dw = Conv(mid, mid, k, stride, groups=mid, same=same)
        self.bn2 = BatchNorm(mid)
        self.se = SqueezeExcite(mid, max(1, int(cin * se)))
        self.conv_pwl = Conv(mid, cout, 1)
        self.bn3 = BatchNorm(cout)
        self.skip = stride == 1 and cin == cout

    def forward(self, x):
        y = swish(self.bn1(self.conv_pw(x)))
        y = self.se(swish(self.bn2(self.conv_dw(y))))
        y = self.bn3(self.conv_pwl(y))
        return y + x if self.skip else y


def round_channels(ch: float, mult: float = 1.0, divisor: int = 8) -> int:
    ch *= mult
    new = max(divisor, int(ch + divisor / 2) // divisor * divisor)
    return int(new + divisor if new < 0.9 * ch else new)


# EfficientNet-B0's stages (block, repeats, kernel, stride, expand,
# channels, squeeze-excite ratio), then (width, depth) of each variant
STAGES = (("ds", 1, 3, 1, 1, 16, 0.25), ("ir", 2, 3, 2, 6, 24, 0.25),
          ("ir", 2, 5, 2, 6, 40, 0.25), ("ir", 3, 3, 2, 6, 80, 0.25),
          ("ir", 3, 5, 1, 6, 112, 0.25), ("ir", 4, 5, 2, 6, 192, 0.25),
          ("ir", 1, 3, 1, 6, 320, 0.25))
SCALING = {"b0": (1.0, 1.0), "b4": (1.4, 1.8)}
TAPS = (3, 5)      # the stages whose input is the stride-8 and stride-16 map


class EfficientNet(nn.Module):
    """The backbone: the maps at strides 8, 16 and 32."""

    def __init__(self, name: str):
        super().__init__()
        same = name.startswith("tf_")
        width, depth = SCALING[name.rsplit("_", 1)[1]]
        stem = round_channels(32, width)
        self.conv_stem = Conv(3, stem, 3, 2, same=same)
        self.bn1 = BatchNorm(stem)
        stages, cin, self.channels = [], stem, []
        for i, (kind, reps, k, s, e, c, se) in enumerate(STAGES):
            cout = round_channels(c, width)
            if i in TAPS:
                self.channels.append(cin)
            blocks = []
            for r in range(int(math.ceil(reps * depth))):
                stride = s if r == 0 else 1
                blocks.append(DepthwiseSeparable(cin, cout, k, stride, se, same)
                              if kind == "ds" else
                              InvertedResidual(cin, cout, k, stride, e, se,
                                               same))
                cin = cout
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.channels.append(cin)

    def forward(self, x):
        x = swish(self.bn1(self.conv_stem(x)))
        feats = []
        for i, stage in enumerate(self.blocks):
            if i in TAPS:
                feats.append(x)
            for block in stage:
                x = block(x)
        return feats + [x]


class SeparableConv(nn.Module):
    def __init__(self, c, cout, bias, norm, same):
        super().__init__()
        self.conv_dw = Conv(c, c, 3, groups=c, same=same)
        self.conv_pw = Conv(c, cout, 1, bias=bias)
        self.bn = BatchNorm(cout) if norm else None

    def forward(self, x):
        x = self.conv_pw(self.conv_dw(x))
        return self.bn(x) if self.bn is not None else x


class ConvBn(nn.Module):
    """A 1 x 1 projection with batch normalisation (``conv.conv``,
    ``conv.bn``)."""

    def __init__(self, cin, cout, bias):
        super().__init__()
        self.conv = Conv(cin, cout, 1, bias=bias)
        self.bn = BatchNorm(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class Resample(nn.Module):
    """Project to the FPN width where it differs, then max-pool down or
    repeat pixels up to the target stride."""

    def __init__(self, cin, cout, ratio, same, bias):
        super().__init__()
        self.ratio, self.same = ratio, same
        self.conv = ConvBn(cin, cout, bias) if cin != cout else None

    def forward(self, x):
        if self.conv is not None:
            x = self.conv(x)
        if self.ratio > 1:
            x = max_pool(x, self.same)
        elif self.ratio < 1:
            x = x.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        return x


def bifpn_nodes(levels: int) -> List[Tuple[int, Tuple[int, ...]]]:
    """(level index, input node ids) of one BiFPN cell: a top-down pass,
    then a bottom-up pass that also takes each level's earlier nodes."""
    ids = {lvl: [lvl] for lvl in range(levels)}
    nodes, nxt = [], levels
    for lvl in range(levels - 2, -1, -1):
        nodes.append((lvl, (ids[lvl][-1], ids[lvl + 1][-1])))
        ids[lvl].append(nxt)
        nxt += 1
    for lvl in range(1, levels):
        nodes.append((lvl, tuple(ids[lvl]) + (ids[lvl - 1][-1],)))
        ids[lvl].append(nxt)
        nxt += 1
    return nodes


class Combine(nn.Module):
    def __init__(self, inputs, info, lvl, ch, same, bias):
        super().__init__()
        self.inputs = inputs
        self.resample = nn.ModuleDict({
            str(i): Resample(info[i][0], ch, 2.0 ** (lvl - info[i][1]), same,
                             bias) for i in inputs})
        self.edge_weights = nn.Parameter(torch.ones(len(inputs)))

    def forward(self, x):
        w = torch.relu(self.edge_weights)
        w = w / (w.sum() + 1e-4)
        return sum(self.resample[str(i)](x[i]) * w[j]
                   for j, i in enumerate(self.inputs))


class Fnode(nn.Module):
    def __init__(self, inputs, info, lvl, ch, same, bias):
        super().__init__()
        self.combine = Combine(inputs, info, lvl, ch, same, bias)
        self.after_combine = nn.ModuleDict(
            {"conv": SeparableConv(ch, ch, bias, True, same)})

    def forward(self, x):
        return self.after_combine["conv"](swish(self.combine(x)))


class BiFpn(nn.Module):
    def __init__(self, cfg: Dict, channels: List[int]):
        super().__init__()
        ch, same = cfg["fpn_channels"], cfg["pad_type"] == "same"
        bias, levels = cfg["redundant_bias"], cfg["max_level"] - cfg["min_level"] + 1
        # (channels, level index) of every node
        info = [(c, i) for i, c in enumerate(channels)]
        self.resample = nn.ModuleDict()
        for lvl in range(len(channels), levels):
            self.resample[str(lvl)] = Resample(info[-1][0], ch, 2, same, bias)
            info.append((ch, lvl))
        self.levels = levels
        cells = []
        for _ in range(cfg["fpn_cell_repeats"]):
            cell_info, fnodes = list(info), []
            for lvl, inputs in bifpn_nodes(levels):
                fnodes.append(Fnode(inputs, cell_info, lvl, ch, same, bias))
                cell_info.append((ch, lvl))
            cells.append(nn.ModuleDict({"fnode": nn.ModuleList(fnodes)}))
            info = [(ch, lvl) for lvl in range(levels)]
        self.cell = nn.ModuleList(cells)

    def forward(self, x):
        x = list(x)
        for r in self.resample.values():
            x.append(r(x[-1]))
        for cell in self.cell:
            for fnode in cell["fnode"]:
                x.append(fnode(x))
            x = x[-self.levels:]
        return x


class Head(nn.Module):
    """Separable convs shared over the levels, a batch norm for each
    (repeat, level), and the predict conv."""

    def __init__(self, cfg: Dict, outputs: int):
        super().__init__()
        ch, same = cfg["fpn_channels"], cfg["pad_type"] == "same"
        levels = cfg["max_level"] - cfg["min_level"] + 1
        self.conv_rep = nn.ModuleList([
            SeparableConv(ch, ch, cfg["redundant_bias"], False, same)
            for _ in range(cfg["box_class_repeats"])])
        self.bn_rep = nn.ModuleList([
            nn.ModuleList([nn.ModuleDict({"bn": BatchNorm(ch, counter=False)})
                           for _ in range(levels)])
            for _ in range(cfg["box_class_repeats"])])
        anchors = cfg["num_scales"] * len(cfg["aspect_ratios"])
        self.predict = SeparableConv(ch, outputs * anchors, True, False, same)

    def forward(self, feats):
        out = []
        for lvl, x in enumerate(feats):
            for conv, bns in zip(self.conv_rep, self.bn_rep):
                x = swish(bns[lvl]["bn"](conv(x)))
            out.append(self.predict(x).permute(0, 2, 3, 1))
        return out


class EfficientDet(nn.Module):
    """Images [B, H, W, 3] -> (class logits [B, H, W, A * C], box codes
    [B, H, W, A * 4]) of each level, NHWC, float32."""

    def __init__(self, cfg: Dict):
        super().__init__()
        self.backbone = EfficientNet(cfg["backbone_name"])
        self.fpn = BiFpn(cfg, self.backbone.channels)
        self.class_net = Head(cfg, cfg["num_classes"])
        self.box_net = Head(cfg, 4)

    def train_bn(self) -> "EfficientDet":
        """Train mode with the backbone's batch norms on their running
        statistics (``freeze_bn='backbone'``)."""
        self.train()
        self.backbone.eval()
        return self

    def forward(self, images: torch.Tensor):
        feats = self.fpn(self.backbone(images.permute(0, 3, 1, 2).float()))
        return self.class_net(feats), self.box_net(feats)
