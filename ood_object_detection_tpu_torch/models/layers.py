"""Building-block layers: activations, padding, conv blocks, resampling.

Port of ``ood_object_detection_tpu.models.layers``. Tensors are NCHW in
``torch.channels_last`` memory, so a permute to NHWC is a free view.

Dtype placement follows the JAX package, not ``torch.autocast``: the
parameters stay f32 and each conv casts its weight and bias to the
input's dtype per call (flax ``promote_dtype``); BatchNorm computes in
f32 from a low-precision input and returns the input's dtype (flax
``_normalize``). The model casts its input to the compute dtype once.

Padding: ``pad_type='same'`` is TF SAME (asymmetric for stride > 1);
``pad_type=''`` is symmetric ``(k-1)//2 * dilation``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

_ACTS: Dict[str, Callable] = {
    "swish": F.silu,
    "silu": F.silu,
    "relu": F.relu,
    "relu6": F.relu6,
    "leaky_relu": lambda x: F.leaky_relu(x, negative_slope=0.01),
    "hard_swish": F.hardswish,
    "hard_sigmoid": F.hardsigmoid,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "identity": lambda x: x,
}


def get_act(name: Optional[str]) -> Callable:
    return _ACTS["swish" if name is None else name]


def _same_pads(size: int, kernel: int, stride: int, dilation: int = 1):
    """TF SAME (low, high) padding of one spatial dim."""
    eff = (kernel - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def pad_same(x: torch.Tensor, kernel: int, stride: int, dilation: int = 1,
             value: float = 0.0) -> torch.Tensor:
    top, bottom = _same_pads(x.shape[2], kernel, stride, dilation)
    left, right = _same_pads(x.shape[3], kernel, stride, dilation)
    return F.pad(x, (left, right, top, bottom), value=value)


def _is_same(pad_type: str) -> bool:
    return pad_type in ("same", "SAME")


# ---------------------------------------------------------------------------
# initialisers (the JAX package's schemes, drawn from an explicit generator)
# ---------------------------------------------------------------------------

def init_conv_(conv: nn.Conv2d, generator: torch.Generator) -> None:
    """Draw a conv's weight by its ``init_kind``; zero its bias.

    'glorot_uniform': variance scaling 1.0, fan_avg, uniform (flax
    ConvBnAct / SeparableConv default). 'lecun_normal': variance scaling
    1.0, fan_in, truncated normal (flax nn.Conv default). 'fan_in_normal':
    variance scaling 1.0, fan_in, normal (the head convs). Fans count as
    flax does for a [kh, kw, in/g, out] kernel.
    """
    out_ch, in_g, kh, kw = conv.weight.shape
    fan_in, fan_out = in_g * kh * kw, out_ch * kh * kw
    with torch.no_grad():
        if conv.init_kind == "glorot_uniform":
            limit = math.sqrt(3.0 / ((fan_in + fan_out) / 2.0))
            nn.init.uniform_(conv.weight, -limit, limit, generator=generator)
        elif conv.init_kind == "lecun_normal":
            # flax truncates at 2 std and rescales to keep the variance
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2.0 * std,
                                  2.0 * std, generator=generator)
        elif conv.init_kind == "fan_in_normal":
            nn.init.normal_(conv.weight, 0.0, math.sqrt(1.0 / fan_in),
                            generator=generator)
        else:
            raise ValueError(f"unknown init_kind {conv.init_kind!r}")
        if conv.bias is not None:
            conv.bias.zero_()


# ---------------------------------------------------------------------------
# conv / norm
# ---------------------------------------------------------------------------

class Conv2d(nn.Conv2d):
    """nn.Conv2d with the JAX package's padding rules; the f32 weight and
    bias are cast to the input's dtype per call."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 bias: bool = False, pad_type: str = "",
                 init_kind: str = "lecun_normal"):
        self.same = _is_same(pad_type)
        padding = 0 if self.same else ((kernel_size - 1) // 2) * dilation
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=padding, dilation=dilation,
                         groups=groups, bias=bias)
        self.init_kind = init_kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.same:
            x = pad_same(x, self.kernel_size[0], self.stride[0],
                         self.dilation[0])
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), bias, self.stride,
                        self.padding, self.dilation, self.groups)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with eps 1e-3 and flax ``nn.BatchNorm`` semantics (the JAX
    package's ``layers.batch_norm``, ``dtype=compute_dtype``).

    Eval mode normalises with the running statistics: f32 statistics and
    affine applied to a low-precision input, output in the input's dtype.

    Train mode (``module.train()``) normalises with the batch statistics,
    as flax's ``_compute_stats`` / ``_normalize`` do: mean and variance
    over (N, H, W) in f32 from the input, the variance as E[x^2] - E[x]^2
    clipped at 0 (flax ``use_fast_variance``), normalise and apply the
    affine in f32, cast back to the input's dtype. The running statistics
    are then updated in place, under no_grad, with the biased batch
    variance: ``ra = (1 - m) * ra + m * batch`` with ``m = momentum``,
    unless ``write_stats`` is False (``batch_stats_mode``) or the forward
    is ``remat``'s recompute.
    ``F.batch_norm(training=True)`` is not used: it updates the running
    variance with the unbiased variance (N / (N - 1) larger).
    """

    def __init__(self, num_features: int, eps: float = 1e-3,
                 momentum: float = 0.01):
        super().__init__(num_features, eps=eps, momentum=momentum)
        self.write_stats = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        x32 = x.float()
        mean = x32.mean(dim=(0, 2, 3))
        var = torch.clamp((x32 * x32).mean(dim=(0, 2, 3)) - mean * mean,
                          min=0.0)
        if self.write_stats and not recomputing():
            update_running_stats(self, mean, var, 1.0 - self.momentum)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - mean.view(1, -1, 1, 1)) * mul.view(1, -1, 1, 1) \
            + self.bias.view(1, -1, 1, 1)
        return y.to(x.dtype)


@contextlib.contextmanager
def batch_stats_mode(module: nn.Module, batch_stats: bool = True):
    """Within the block every BatchNorm of ``module`` (the modules with a
    ``write_stats`` flag) normalises with the batch statistics
    (``batch_stats``) or with its running ones, and writes no running
    statistic; each one's mode and flag are restored after. The JAX
    package's ``apply(training=True, mutable=["batch_stats"])`` with the
    new statistics thrown away (``meta/episode.py:48-60``)."""
    norms = [m for m in module.modules() if hasattr(m, "write_stats")]
    saved = [(m.training, m.write_stats) for m in norms]
    for m in norms:
        m.training, m.write_stats = batch_stats, False
    try:
        yield
    finally:
        for m, (training, write) in zip(norms, saved):
            m.training, m.write_stats = training, write


@torch.no_grad()
def update_running_stats(norm: nn.Module, mean: torch.Tensor,
                         var: torch.Tensor, keep: float) -> None:
    """``ra = keep * ra + (1 - keep) * batch`` for the running mean and the
    running (biased) variance, in place."""
    norm.running_mean.copy_(keep * norm.running_mean + (1 - keep) * mean)
    norm.running_var.copy_(keep * norm.running_var + (1 - keep) * var)


_RECOMPUTE = threading.local()


def recomputing() -> bool:
    """Whether this thread is inside ``remat``'s recompute of a forward."""
    return getattr(_RECOMPUTE, "on", False)


def remat(fn: Callable, *args):
    """``fn(*args)`` with its intermediate activations recomputed in the
    backward pass instead of kept (``torch.utils.checkpoint``, not
    reentrant): the JAX package's ``nn.remat`` with ``nothing_saveable``.
    flax's lifted remat writes the BatchNorm statistics once; here the
    recompute runs with ``recomputing()`` set, so no running statistic
    is written twice. Whatever is random in ``fn`` must come in through
    ``args`` (a drop mask drawn before the region), as the checkpoint does
    not replay an explicit generator. Without autograd it is a plain
    call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    calls = []

    def run(*inner):
        if not calls:
            calls.append(True)
            return fn(*inner)
        _RECOMPUTE.on = True
        try:
            return fn(*inner)
        finally:
            _RECOMPUTE.on = False
    return checkpoint(run, *args, use_reentrant=False,
                      preserve_rng_state=False)


class ConvBnAct(nn.Module):
    """Conv -> (BN) -> (act)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 pad_type: str = "", bias: bool = False, norm: bool = True,
                 act_type: Optional[str] = "swish", norm_eps: float = 1e-3,
                 norm_momentum: float = 0.01,
                 init_kind: str = "glorot_uniform"):
        super().__init__()
        self.conv = Conv2d(in_channels, out_channels, kernel_size, stride,
                           dilation, bias=bias, pad_type=pad_type,
                           init_kind=init_kind)
        self.bn = (BatchNorm2d(out_channels, norm_eps, norm_momentum)
                   if norm else None)
        self.act = None if act_type is None else get_act(act_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


class SeparableConv(nn.Module):
    """Depthwise conv -> pointwise conv -> (BN) -> (act)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, dilation: int = 1,
                 pad_type: str = "", bias: bool = False,
                 channel_multiplier: int = 1, norm: bool = True,
                 act_type: Optional[str] = "swish", norm_eps: float = 1e-3,
                 norm_momentum: float = 0.01,
                 init_kind: str = "glorot_uniform"):
        super().__init__()
        mid = in_channels * channel_multiplier
        self.conv_dw = Conv2d(in_channels, mid, kernel_size, stride,
                              dilation, groups=in_channels, bias=False,
                              pad_type=pad_type, init_kind=init_kind)
        self.conv_pw = Conv2d(mid, out_channels, 1, bias=bias,
                              init_kind=init_kind)
        self.bn = (BatchNorm2d(out_channels, norm_eps, norm_momentum)
                   if norm else None)
        self.act = None if act_type is None else get_act(act_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv_pw(self.conv_dw(x))
        if self.bn is not None:
            x = self.bn(x)
        if self.act is not None:
            x = self.act(x)
        return x


# ---------------------------------------------------------------------------
# resize / resample
# ---------------------------------------------------------------------------

def upsample_nearest(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Integer nearest upsample: every pixel repeated ``scale`` times per
    axis (bit-exact with the JAX package's ``jnp.repeat``)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


def interpolate(x: torch.Tensor, out_hw, mode: str = "nearest"
                ) -> torch.Tensor:
    """Resize the spatial dims to ``out_hw`` as the JAX package's
    ``interpolate`` does: nearest upsampling by a repeat, else
    ``jax.image.resize``, which samples at half-pixel centres and
    antialiases when it shrinks ('nearest' -> 'nearest-exact'; 'bilinear'
    and 'bicubic' through the antialiased kernels, whose cubic is Keys'
    a = -0.5 as jax's; bilinear enlarging through the plain kernel,
    which it equals there). Linear modes compute in f32 and round once."""
    h, w = x.shape[2:]
    oh, ow = int(out_hw[0]), int(out_hw[1])
    if mode == "nearest":
        if oh == h * (oh // h) and ow == w * (oh // h):
            return upsample_nearest(x, oh // h)
        # half-pixel centres (an integer factor is a repeat here too)
        return F.interpolate(x, size=(oh, ow), mode="nearest-exact")
    if mode not in ("bilinear", "bicubic"):
        raise ValueError(f"unknown interpolation mode {mode!r}")
    if mode == "bilinear" and oh >= h and ow >= w:
        # no antialiasing when enlarging: the plain kernel, which computes
        # a bf16 map in f32 and rounds once, in the map's own dtype
        return F.interpolate(x, size=(oh, ow), mode=mode,
                             align_corners=False)
    y = F.interpolate(x.float(), size=(oh, ow), mode=mode,
                      align_corners=False, antialias=True)
    return y.to(x.dtype)


def max_pool2d(x: torch.Tensor, kernel_size: int, stride: int,
               pad_type: str) -> torch.Tensor:
    if _is_same(pad_type):
        # TF SAME pooling: asymmetric -inf padding
        return F.max_pool2d(pad_same(x, kernel_size, stride,
                                     value=float("-inf")),
                            kernel_size, stride)
    return F.max_pool2d(x, kernel_size, stride, padding=(kernel_size - 1) // 2)


def avg_pool2d(x: torch.Tensor, kernel_size: int, stride: int,
               pad_type: str) -> torch.Tensor:
    """flax ``nn.avg_pool`` over ``pool_padding``'s pads: the padded zeros
    count in the divisor (the window size), under TF SAME (asymmetric
    pads) and under '' ((k-1)//2 a side) alike."""
    if _is_same(pad_type):
        x = pad_same(x, kernel_size, stride)
    else:
        pad = (kernel_size - 1) // 2
        x = F.pad(x, (pad, pad, pad, pad))
    return F.avg_pool2d(x, kernel_size, stride, padding=0)


class ResampleFeatureMap(nn.Module):
    """Channel projection (1x1 conv, optional BN) + spatial resample.

    Downsampling pools (``max`` / ``avg``, kernel = stride + 1) or
    interpolates (any other ``downsample``: ``interpolate``'s modes) to
    ``int(size / reduction_ratio)``; upsampling is ``interpolate`` by the
    integer scale (nearest by repeat, or ``bilinear``). The 1x1 conv runs
    when the channels change, before or after a downsample by
    ``conv_after_downsample``.
    """

    def __init__(self, in_channels: int, out_channels: int,
                 reduction_ratio: float = 1.0, pad_type: str = "",
                 downsample: str = "max", upsample: str = "nearest",
                 apply_bn: bool = False, conv_after_downsample: bool = False,
                 redundant_bias: bool = False, norm_eps: float = 1e-3,
                 norm_momentum: float = 0.01):
        super().__init__()
        self.reduction_ratio = reduction_ratio
        self.pad_type = pad_type
        self.downsample = downsample
        self.upsample = upsample
        self.conv_after_downsample = conv_after_downsample
        self.conv = None
        if in_channels != out_channels:
            self.conv = ConvBnAct(
                in_channels, out_channels, kernel_size=1, pad_type=pad_type,
                norm=apply_bn, bias=not apply_bn or redundant_bias,
                act_type=None, norm_eps=norm_eps, norm_momentum=norm_momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.reduction_ratio > 1:
            if self.conv is not None and not self.conv_after_downsample:
                x = self.conv(x)
            stride = int(self.reduction_ratio)
            if self.downsample in ("max", "avg"):
                pool = max_pool2d if self.downsample == "max" else avg_pool2d
                x = pool(x, stride + 1, stride, self.pad_type)
            else:
                x = interpolate(x, (int(x.shape[2] / self.reduction_ratio),
                                    int(x.shape[3] / self.reduction_ratio)),
                                self.downsample)
            if self.conv is not None and self.conv_after_downsample:
                x = self.conv(x)
        else:
            if self.conv is not None:
                x = self.conv(x)
            if self.reduction_ratio < 1:
                scale = int(1 // self.reduction_ratio)
                x = interpolate(x, (x.shape[2] * scale, x.shape[3] * scale),
                                self.upsample)
        return x


class SqueezeExcite(nn.Module):
    """SE block: global mean -> reduce conv -> act -> expand conv -> gate."""

    def __init__(self, channels: int, reduced_channels: int,
                 act_type: str = "swish", gate_type: str = "sigmoid"):
        super().__init__()
        self.conv_reduce = Conv2d(channels, reduced_channels, 1, bias=True)
        self.conv_expand = Conv2d(reduced_channels, channels, 1, bias=True)
        self.act = get_act(act_type)
        self.gate = get_act(gate_type)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.conv_expand(self.act(self.conv_reduce(s)))
        return x * self.gate(s)


def drop_mask(batch: int, generator: torch.Generator, rate: float,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A per-sample keep mask [batch, 1, 1, 1] of 0 / 1 in ``dtype``, each
    sample kept with probability ``1 - rate`` (``jax.random.bernoulli``:
    a uniform draw below the keep probability), drawn from ``generator``
    on its device."""
    u = torch.rand((batch, 1, 1, 1), generator=generator,
                   device=generator.device)
    return (u < 1.0 - rate).to(dtype)


def apply_drop(x: torch.Tensor, mask: Optional[torch.Tensor],
               rate: float) -> torch.Tensor:
    """``x * mask / keep``, the JAX package's ``drop_path`` arithmetic,
    for a mask from ``drop_mask``; ``x`` itself without a mask."""
    if mask is None or rate <= 0.0:
        return x
    return x * mask.to(device=x.device, dtype=x.dtype) / (1.0 - rate)


def drop_path(x: torch.Tensor, generator: Optional[torch.Generator],
              rate: float) -> torch.Tensor:
    """Stochastic depth on the batch dim: each sample of ``x`` zeroed with
    probability ``rate`` and the kept ones scaled by ``1 / (1 - rate)``;
    ``x`` itself at rate 0 or without a generator."""
    if rate <= 0.0 or generator is None:
        return x
    return apply_drop(x, drop_mask(x.shape[0], generator, rate), rate)
