"""Image-H sharding over the spatial axis of a 2-D mesh (the port of the
JAX package's ``make_train_step(..., spatial_axis=...)`` leg, where GSPMD
partitions every op of an image sharded ``P('data', spatial)``).

Stock PyTorch has no partitioner, so each operation of the model that
reads across rows knows how to run on a block of rows. The ``S`` ranks of
one data block (the mesh's spatial group) hold the same images; rank
``s`` holds rows ``[s * H / S, (s + 1) * H / S)`` of each map. Under
``spatially_sharded(model, mesh, image_hw)`` every module of the model
with a ``spatial`` attribute gets the rank's ``Shards``:

- a conv or pool whose output rows split evenly, with the rank's input
  rows aligned to its stride, takes the rows its windows reach past its
  block from its neighbours (``Shards.halo``, a differentiable exchange:
  the backward adds the halo rows' gradients to the neighbours' edge
  rows) and fills past the image's top and bottom edges with the op's
  own padding (zeros for convs and average pools, -inf for max pools),
  the pads computed from the global height (TF SAME included);
- otherwise it gathers the map onto every rank of the group
  (``Shards.gather``): where the output's rows split but the halo would
  reach past a neighbour's block, it runs the op on the whole map and
  keeps the rank's rows of the output; where they do not split (a map too
  short: P7 of 128 px at S = 2 has one row) the output stays whole,
  replicated on the group, and so does what is computed from it; an
  interpolation that is not a repeat gathers as well and keeps the rank's
  rows where the output splits;
- where a whole map meets blocks of rows (an FPN node fusing an
  upsampled whole level with a split one) it gives the rank's rows of it
  (``Shards.own_rows``);
- squeeze-excite means sum the rank's partial sums over the group.

Which maps are split follows from the global shapes alone, so every rank
takes the same path and the collectives match. A map's global height is
read from its width, which is never split: the image's aspect ratio
holds at every level (the anchors require sizes divisible by
2**max_level), so a map whose height is short of ``width * H / W`` is
split, and one that has it is whole.

The rule that counts a replicated map's contributions once: the
gradients of a replicated map are partial sums, the true gradient being
their sum over the spatial group. The gather's backward therefore sums
its gradient over the group and keeps the rank's rows; taking a rank's
rows of a replicated map back (``Shards.own_rows``) passes the rows'
gradient on zero-padded, with no collective; the train step counts the
loss terms of a replicated level's anchors on spatial index 0 alone
(weight 0 elsewhere, so that the other ranks' backward still runs every
collective of that level). Train-mode norms sum their moments over the
whole mesh (``synced_batch_norms``): a replicated map adds the same sums
and counts ``S`` times over, which leaves the moments equal, and the
partial-sum rule carries their gradient.

Transport: every exchange is an ``all_reduce`` of a zero-padded slot
buffer over the spatial group (each rank writes its edge rows into its own
slot; a sum of one value and zeros is exact). The port's backends differ
in what they take: ``gloo`` runs ``all_reduce`` on CUDA tensors but not
its point-to-point calls, and ranks that share one card run ``gloo``;
``nccl`` takes both. One ``all_reduce`` works for both, on the
card and on the CPU, at the cost of moving ``S`` slots where two rows
would do, which for halos of one or two rows is small.
``EXCHANGES`` counts the exchanges by kind, forward and backward; each
is an ``odt.spatial.<kind>`` span of a profiler trace when spans are on
(``utils.profiling``), which gives their time.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..utils.profiling import span
from .mesh import Mesh

# collectives of the spatial group by kind ('halo', 'gather' and
# 'se_sum'), forward and backward
EXCHANGES: Dict[str, int] = {"halo": 0, "gather": 0, "se_sum": 0}


def reset_exchanges() -> None:
    for k in EXCHANGES:
        EXCHANGES[k] = 0


def _all_reduce(t: torch.Tensor, group, kind: str) -> None:
    EXCHANGES[kind] += 1
    with span(f"odt.spatial.{kind}"):
        dist.all_reduce(t, group=group)


def window_halo(height: int, count: int, kernel: int, stride: int,
                dilation: int, pads: Tuple[int, int]
                ) -> Optional[Tuple[int, int]]:
    """The rows a rank's block of a map of global ``height`` split over
    ``count`` ranks needs from above and from below (negative: rows of its
    own block left unread) for a window op of ``kernel`` / ``stride`` /
    ``dilation`` with global pads ``pads`` (top, bottom); None when the
    output's rows cannot stay split: they do not divide over the ranks, or
    a rank's first output row does not start at its first input row."""
    top, bottom = pads
    eff = (kernel - 1) * dilation + 1
    out = (height + top + bottom - eff) // stride + 1
    rows = height // count
    if height % count or out % count or rows != (out // count) * stride:
        return None
    return top, eff - stride - top


class _Halo(torch.autograd.Function):
    """The rank's block extended by ``above`` rows of the rank above and
    ``below`` rows of the rank below (cropped where ``below`` < 0), the
    rows past the image's edges ``fill``; the backward adds the halo
    rows' gradients to the neighbours' edge rows."""

    @staticmethod
    def forward(ctx, x, shards, above, below, fill):
        ctx.shards, ctx.above, ctx.below = shards, above, below
        s, n, h = shards.index, shards.count, x.shape[2]
        b = max(below, 0)
        buf = x.new_zeros((n,) + x.shape[:2] + (above + b, x.shape[3]))
        buf[s, :, :, :above] = x[:, :, h - above:]
        buf[s, :, :, above:] = x[:, :, :b]
        _all_reduce(buf, shards.group, "halo")
        bn, c, w = x.shape[0], x.shape[1], x.shape[3]
        top = buf[s - 1, :, :, :above] if s > 0 else \
            x.new_full((bn, c, above, w), fill)
        bot = buf[s + 1, :, :, above:] if s < n - 1 else \
            x.new_full((bn, c, b, w), fill)
        out = torch.cat([top, x[:, :, :h + min(below, 0)], bot], dim=2)
        if x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, grad):
        shards, above, below = ctx.shards, ctx.above, ctx.below
        s, n = shards.index, shards.count
        b = max(below, 0)
        h = grad.shape[2] - above - b - min(below, 0)
        gx = grad.new_zeros(grad.shape[:2] + (h, grad.shape[3]))
        gx[:, :, :h + min(below, 0)] = grad[:, :, above:above + h
                                            + min(below, 0)]
        buf = grad.new_zeros((n,) + grad.shape[:2] + (above + b,
                                                      grad.shape[3]))
        if s > 0:
            buf[s - 1, :, :, :above] = grad[:, :, :above]
        if s < n - 1:
            buf[s + 1, :, :, above:] = grad[:, :, grad.shape[2] - b:]
        _all_reduce(buf, shards.group, "halo")
        gx[:, :, h - above:] += buf[s, :, :, :above]
        gx[:, :, :b] += buf[s, :, :, above:]
        return gx, None, None, None, None


class _Gather(torch.autograd.Function):
    """The whole map on every rank of the group, rank s's block the s-th;
    the backward sums the ranks' partial gradients and keeps the rank's
    rows."""

    @staticmethod
    def forward(ctx, x, shards):
        ctx.shards = shards
        s, h = shards.index, x.shape[2]
        out = x.new_zeros(x.shape[:2] + (h * shards.count, x.shape[3]))
        out[:, :, s * h:(s + 1) * h] = x
        _all_reduce(out, shards.group, "gather")
        if x.is_contiguous(memory_format=torch.channels_last):
            out = out.contiguous(memory_format=torch.channels_last)
        return out

    @staticmethod
    def backward(ctx, grad):
        shards = ctx.shards
        total = grad.contiguous().clone()
        _all_reduce(total, shards.group, "gather")
        h = grad.shape[2] // shards.count
        return total[:, :, shards.index * h:(shards.index + 1) * h], None


class _GroupSum(torch.autograd.Function):
    """A squeeze-excite's partial sums summed over the group; the gradient
    is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, t, shards):
        ctx.shards = shards
        out = t.contiguous().clone()
        _all_reduce(out, shards.group, "se_sum")
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        _all_reduce(out, ctx.shards.group, "se_sum")
        return out, None


@dataclasses.dataclass(frozen=True)
class Shards:
    """This rank's place in the split of every map's rows: the spatial
    group, the rank's index in it, the group's size and the global image
    (height, width), from which each map's global height follows."""
    group: Any
    index: int
    count: int
    image_hw: Tuple[int, int]

    def global_height(self, x: torch.Tensor) -> int:
        """The global height of a map (NCHW) at the image's aspect ratio:
        ``width * H / W``."""
        h, w = self.image_hw
        if (x.shape[3] * h) % w:
            raise ValueError(f"a map of width {x.shape[3]} is no level of "
                             f"a {h} x {w} image")
        return x.shape[3] * h // w

    def is_split(self, x: torch.Tensor) -> bool:
        """Whether ``x`` holds the rank's block of rows (else the whole
        map, replicated on the group)."""
        full = self.global_height(x)
        if x.shape[2] == full:
            return False
        if x.shape[2] * self.count != full:
            raise ValueError(f"a map of {x.shape[2]} rows is neither a "
                             f"block nor the whole of {full} rows over "
                             f"{self.count} ranks")
        return True

    def halo(self, x: torch.Tensor, above: int, below: int,
             fill: float = 0.0) -> torch.Tensor:
        """``x``'s block with ``above`` rows of the rank above and
        ``below`` of the rank below (``fill`` past the image's edges;
        ``below`` < 0 crops), differentiable; no exchange where neither
        side reads a neighbour's rows."""
        if above + max(below, 0) == 0:
            return x[:, :, :x.shape[2] + below]
        return _Halo.apply(x, self, above, below, fill)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole map from the ranks' blocks, differentiable."""
        return _Gather.apply(x, self)

    def own_rows(self, x: torch.Tensor, dim: int = 2) -> torch.Tensor:
        """This rank's block of a whole (replicated) map or batch along
        ``dim``."""
        rows = x.shape[dim] // self.count
        return x.narrow(dim, self.index * rows, rows)

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the group, differentiable (the backward sums
        the gradients)."""
        return _GroupSum.apply(t, self)


def mesh_shards(mesh: Mesh, image_hw) -> Shards:
    """The rank's ``Shards`` on a 2-D mesh for images of ``image_hw``."""
    return Shards(group=mesh.spatial_group, index=mesh.spatial_index,
                  count=mesh.spatial_size,
                  image_hw=(int(image_hw[0]), int(image_hw[1])))


@contextlib.contextmanager
def spatially_sharded(module: torch.nn.Module, mesh: Optional[Mesh],
                      image_hw):
    """Within the block every module of ``module`` with a ``spatial``
    attribute (the convs, squeeze-excites, resamples, FPN combines and the
    ResNet / CSP stems' pools) computes on this rank's block of rows of
    images of global size ``image_hw``, as the module docstring sets out.
    Nothing changes without a spatial axis of more than one rank."""
    shards = None
    if mesh is not None and mesh.spatial_size > 1:
        shards = mesh_shards(mesh, image_hw)
    parts = [m for m in module.modules() if hasattr(m, "spatial")]
    for m in parts:
        m.spatial = shards
    try:
        yield shards
    finally:
        for m in parts:
            m.spatial = None
