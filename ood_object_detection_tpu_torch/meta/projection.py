"""ProjectionNet: per-anchor embedding MLP + fixed positional encodings
(port of ``ood_object_detection_tpu.meta.projection``).

An anchor's embedding input row is [fpn cell feature (C) | level enc (6) |
cell y enc (14) | cell x enc (14) | anchor-id enc (8)]; with
``ref_pos_enc`` it is the reference's interleaved cell encoding in the
reference layout [feature | anchor (8) | level (6) | cell (28)]
(infer.py:370-377). The sinusoid tables are built with numpy by the JAX
package's code, so they are bit-equal.

Selection is a stable descending sort (``ops.post_process._topk``): equal
confidences come back lowest index first, the order of ``jax.lax.top_k``.
"""
from __future__ import annotations

import functools
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops.post_process import _topk
from .config import MetaConfig


def _sinusoid_table(num_pos: int, step: float, num_freqs: int) -> np.ndarray:
    """Reference encoding scheme (efficientdet.py:705-730):
    locs = arange(-1, 1, step) * pi (truncated to num_pos), features
    [sin(2^f * loc), cos(2^f * loc)] for f in range(num_freqs)."""
    locs = (np.arange(-1.0, 1.0, step) * math.pi)[:num_pos]
    feats = []
    for f in range(num_freqs):
        feats.append(np.sin(2.0 ** f * locs))
        feats.append(np.cos(2.0 ** f * locs))
    return np.stack(feats, axis=1).astype(np.float32)   # [num_pos, 2*num_freqs]


ANCHOR_ENC = _sinusoid_table(9, 1.0 / 8, 4)     # [9, 8]
CELL_ENC = _sinusoid_table(80, 1.0 / 64, 7)     # [80, 14]
LEVEL_ENC = _sinusoid_table(5, 1.0 / 4, 3)      # [5, 6]

POS_DIM = 8 + 6 + 28


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    """flax's default Dense kernel init: fan-in variance 1, normal
    truncated at 2 std and rescaled to keep the variance."""
    std = math.sqrt(1.0 / weight.shape[1]) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class ProjectionNet(nn.Module):
    """MLP: (fpn_channels + 42) -> width -> ... -> width/2, bias-free, ReLU.

    Also owns the confidence-gate scalars ``dot_mult`` / ``dot_add``
    (efficientdet.py:702-703), which ``forward`` does not use: the
    clustering reads them. ``dense.{i}.weight`` is the JAX ``dense_{i}``
    kernel transposed (``utils.from_jax.load_jax_projection``).
    """

    def __init__(self, fpn_channels: int, width: int = 512, depth: int = 2,
                 dot_mult_init: float = 3.0, dot_add_init: float = 3.0):
        super().__init__()
        dims = [fpn_channels + POS_DIM] + [width] * (depth - 1) + \
            [width // 2]
        self.dense = nn.ModuleList(nn.Linear(i, o, bias=False)
                                   for i, o in zip(dims[:-1], dims[1:]))
        self.dot_mult = nn.Parameter(torch.tensor(float(dot_mult_init)))
        self.dot_add = nn.Parameter(torch.tensor(float(dot_add_init)))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Draw every dense kernel from flax's default initialiser."""
        for layer in self.dense:
            _lecun_normal_(layer.weight, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.dense[:-1]:
            x = torch.relu(layer(x))
        return self.dense[-1](x)


class ProjectionGate(nn.Module):
    """Standalone holder for the dot_mult / dot_add confidence-gate scalars
    (the JAX package keeps it beside the MLP so the gate can be frozen on
    its own, mirroring inner_thresh_train, infer.py:611-614)."""

    def __init__(self, dot_mult_init: float = 3.0, dot_add_init: float = 3.0):
        super().__init__()
        self.dot_mult = nn.Parameter(torch.tensor(float(dot_mult_init)))
        self.dot_add = nn.Parameter(torch.tensor(float(dot_add_init)))

    def forward(self, conf_logits: torch.Tensor) -> torch.Tensor:
        return self.dot_mult * (conf_logits + self.dot_add)


def confidence_topk(conf_logits: torch.Tensor, keep_frac: float,
                    min_keep_all: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Static top-k per image over [B, A] confidence logits (the
    reference's quantile-adjust loop, infer.py:384-394, as an exact static
    top-k). Returns (indices [B, K], values [B, K])."""
    a = conf_logits.shape[-1]
    if min_keep_all and a <= min_keep_all:
        k = a
    else:
        k = max(1, int(round(a * keep_frac)))
    vals, idx = _topk(conf_logits, k)
    return idx, vals


def select_confident_anchors(feats: Sequence[torch.Tensor],
                             cls_out: Sequence[torch.Tensor],
                             meta_cfg: MetaConfig,
                             labels_flat: Optional[torch.Tensor] = None,
                             level_sizes: Optional[Sequence[int]] = None,
                             sep_out: Optional[Sequence[torch.Tensor]] = None):
    """Per level, keep the top ``conf_keep_frac`` anchors by confidence;
    gather features, confidences, (optionally) flat anchor labels and
    ``sep_out`` logits at the same positions. Levels whose grid is <=
    ``min_level_cells`` keep all anchors. Returns (rows [B, K, C+42],
    confs [B, K], labels [B, K] or None, sep [B, K] or None)."""
    with_labels = labels_flat is not None
    if with_labels:
        if not (len(feats) == len(cls_out) == len(level_sizes)):
            raise ValueError(
                f"level mismatch: {len(feats)} feature levels, "
                f"{len(cls_out)} head levels, {len(level_sizes)} label "
                "levels — the head must run with level_offset matching "
                "the anchor labeler's")
    sel_feats, sel_confs, sel_labels, sel_sep = [], [], [], []
    offset = 0
    for li, (level_feats, level_cls) in enumerate(zip(feats, cls_out)):
        b = level_cls.shape[0]
        conf = level_cls.reshape(b, -1)
        keep_all = level_cls.shape[1] <= meta_cfg.min_level_cells
        idx, vals = confidence_topk(
            conf, meta_cfg.conf_keep_frac,
            min_keep_all=conf.shape[-1] if keep_all else 0)
        sel_confs.append(vals)
        sel_feats.append(torch.gather(
            level_feats, 1,
            idx[..., None].expand(-1, -1, level_feats.shape[-1])))
        if sep_out is not None:
            sel_sep.append(torch.gather(sep_out[li].reshape(b, -1), 1, idx))
        if with_labels:
            lsz = level_sizes[li]
            if conf.shape[-1] != lsz:
                raise ValueError(
                    f"{conf.shape[-1]} anchors vs {lsz} labels in one "
                    "level: head/labeler level grids misaligned")
            lab_level = labels_flat[:, offset:offset + lsz]
            sel_labels.append(torch.gather(lab_level, 1, idx))
            offset += lsz
    rows = torch.cat(sel_feats, dim=1)
    confs = torch.cat(sel_confs, dim=1)
    labels = torch.cat(sel_labels, dim=1) if with_labels else None
    sep = torch.cat(sel_sep, dim=1) if sep_out is not None else None
    return rows, confs, labels, sep


def _ref_interleaved_cell_enc(h: int, w: int,
                              cell: torch.Tensor) -> torch.Tensor:
    """Reference-exact 28-d cell encoding (infer.py:370-371): cell (y, x)
    gets [S[2x], S[2x+1]] where S[k] = cell[y] if k < W else cell[k-W], so
    left-half cells encode (y, y) and right-half cells an x-pair. Requires
    H == W. Returns [h, w, 28]."""
    if h != w:
        raise ValueError(
            f"ref_pos_enc requires square feature maps, got {h}x{w} "
            "(the reference's torch.cat(dim=2) does too, infer.py:371)")
    j = torch.arange(w, device=cell.device)
    i1, i2 = 2 * j, 2 * j + 1
    y_rows = cell[:h][:, None, :]                               # [h,1,14]
    x1 = cell[torch.clamp(i1 - w, min=0)][None]                 # [1,w,14]
    x2 = cell[torch.clamp(i2 - w, min=0)][None]
    e1 = torch.where((i1 < w)[None, :, None], y_rows, x1)       # [h,w,14]
    e2 = torch.where((i2 < w)[None, :, None], y_rows, x2)
    return torch.cat([e1, e2], dim=-1)                           # [h,w,28]


@functools.lru_cache(maxsize=None)
def _tables(device: torch.device, dtype: torch.dtype):
    """(ANCHOR_ENC, CELL_ENC, LEVEL_ENC) on ``device``, copied there once."""
    return tuple(torch.from_numpy(t).to(device, dtype)
                 for t in (ANCHOR_ENC, CELL_ENC, LEVEL_ENC))


def build_anchor_features(level_embds: Sequence[torch.Tensor],
                          level_offset: int = 0, num_anchors: int = 9,
                          ref_pos_enc: bool = False) -> List[torch.Tensor]:
    """Per level: [B, H, W, C] head activations -> [B, H*W*A, C+42] anchor
    feature rows (cell feature repeated per anchor + positional
    encodings). ``level_offset`` indexes LEVEL_ENC for the first level
    given; ``ref_pos_enc`` selects the reference-exact encoding and row
    layout."""
    out = []
    for li, embds in enumerate(level_embds):
        b, h, w, c = embds.shape
        dt = torch.promote_types(embds.dtype, torch.float32)
        anch, cell, lev = _tables(embds.device, dt)   # [A, 8] [80, 14] [5, 6]
        lev = lev[min(level_offset + li, lev.shape[0] - 1)]
        if ref_pos_enc:
            cell_enc = _ref_interleaved_cell_enc(h, w, cell)
        else:
            cell_enc = torch.cat([cell[:h][:, None].expand(h, w, 14),
                                  cell[:w][None].expand(h, w, 14)], dim=-1)
        pos = torch.cat([lev.expand(h, w, 6), cell_enc], dim=-1)
        per_cell = torch.cat([embds.to(dt), pos[None].expand(b, h, w, 34)],
                             dim=-1).reshape(b, h * w, 1, c + 34)
        per_cell = per_cell.expand(b, h * w, num_anchors, c + 34)
        anch_enc = anch[None, None].expand(b, h * w, num_anchors, 8)
        if ref_pos_enc:
            # reference order: [feature | anchor | level | cell]
            rows = torch.cat([per_cell[..., :c], anch_enc, per_cell[..., c:]],
                             dim=-1)
        else:
            rows = torch.cat([per_cell, anch_enc], dim=-1)
        out.append(rows.reshape(b, h * w * num_anchors, c + POS_DIM))
    return out
