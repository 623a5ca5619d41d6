"""Detection losses: focal (legacy and 'new'), huber, cosine, smooth-L1,
L2, one-hot with ignore, the flat, per-level and per-level NHWC detection
losses and the class-only / box-only variants (port of
``ood_object_detection_tpu.ops.losses``).

Dtypes follow the JAX functions op by op. Where jax promotes a bf16 array
against an f32 0-d array (a normalizer, a cotangent) to f32, torch would
keep bf16 (a 0-d tensor does not promote a dimensioned one), so the port
casts to f32 explicitly at those places.

The reference's active focal path applies only the alpha factor (the
(1 - p_t)^gamma modulation is commented out, reference loss.py:75-95);
``modulation=True`` restores it. That alpha-only path runs through
``FusedAlphaFocalSum``: one masked reduce forward, a backward recomputed
from (logits, targets), nothing logit-sized kept in between.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross entropy with logits:
    max(x, 0) - x * t + log1p(exp(-|x|))."""
    return torch.clamp(logits, min=0.0) - logits * targets + \
        torch.log1p(torch.exp(-torch.abs(logits)))


def _f32_if_tensor(loss: torch.Tensor, normalizer) -> torch.Tensor:
    """jax promotes ``loss / normalizer`` to f32 when the normalizer is an
    f32 array; a Python number keeps the loss's dtype."""
    return loss.float() if isinstance(normalizer, torch.Tensor) else loss


def focal_loss_legacy(logits, targets, alpha: float, gamma: float,
                      normalizer):
    """Legacy TF focal loss with the full (1 - p_t)^gamma modulation."""
    targets = targets.to(logits.dtype)
    positive_mask = targets == 1.0
    ce = sigmoid_bce(logits, targets)
    neg_logits = -logits
    modulator = torch.exp(gamma * targets * neg_logits
                          - gamma * torch.log1p(torch.exp(neg_logits)))
    loss = modulator * ce
    weighted = torch.where(positive_mask, alpha * loss, (1.0 - alpha) * loss)
    return _f32_if_tensor(weighted, normalizer) / normalizer


def new_focal_loss(logits, targets, alpha: Optional[float], gamma: float,
                   normalizer, label_smoothing: float = 0.01,
                   modulation: bool = False, loss_func=sigmoid_bce):
    """'New' focal loss with label smoothing; alpha-only unless
    ``modulation``."""
    targets = targets.to(logits.dtype)
    scale = None
    if alpha is not None:
        onem_targets = 1.0 - targets
        scale = targets * alpha + onem_targets * (1.0 - alpha)
        if modulation:
            pred_prob = torch.sigmoid(logits)
            p_t = targets * pred_prob + onem_targets * (1.0 - pred_prob)
            scale = scale * torch.pow(1.0 - p_t, gamma)
    if label_smoothing > 0.0:
        targets = targets * (1.0 - label_smoothing) + 0.5 * label_smoothing
    loss = loss_func(logits, targets)
    if scale is not None:
        loss = scale * loss
    return _f32_if_tensor(loss, normalizer) / normalizer


def cosine_loss(inputs, targets, margin: float = 0.0) -> torch.Tensor:
    """Hinged cosine-similarity loss: ``1 - x`` where the target is 1,
    ``x - margin`` elsewhere, clipped at 0, averaged."""
    loss = torch.where(targets == 1.0, 1.0 - inputs, inputs - margin)
    return torch.mean(torch.clamp(loss, min=0.0))


def _signed_weight_sums(err, weights):
    """(sum of the positive, sum of the negative) ``sign(err) * weights``:
    the reference's gradient-sum extras."""
    weighted_sign = torch.sign(err) * weights
    zero = torch.zeros_like(weighted_sign)
    return (torch.sum(torch.where(weighted_sign > 0, weighted_sign, zero)),
            torch.sum(torch.where(weighted_sign < 0, weighted_sign, zero)))


def smooth_l1_loss(inputs, targets, beta: float = 1.0 / 9,
                   weights: Optional[torch.Tensor] = None):
    """Smooth-L1 summed; with ``weights`` also the positive and negative
    weighted-sign sums: (loss, pos_grad_sum, neg_grad_sum)."""
    err = inputs - targets
    abs_err = torch.abs(err)
    if beta < 1e-5:
        loss = abs_err
    else:
        loss = torch.where(abs_err < beta, 0.5 * abs_err * abs_err / beta,
                           abs_err - 0.5 * beta)
    if weights is None:
        return torch.sum(loss)
    return (torch.sum(loss * weights),) + _signed_weight_sums(err, weights)


def l2_loss(inputs, targets, weights: Optional[torch.Tensor] = None):
    """Mean squared error; with ``weights`` (weighted mean, pos_grad_sum,
    neg_grad_sum) as ``smooth_l1_loss``."""
    err = inputs - targets
    loss = err * err
    if weights is None:
        return torch.mean(loss)
    return (torch.mean(loss * weights),) + _signed_weight_sums(err, weights)


def huber_loss(inputs, targets, delta: float = 1.0,
               weights: Optional[torch.Tensor] = None,
               size_average: bool = True):
    err = inputs - targets
    abs_err = torch.abs(err)
    quadratic = torch.clamp(abs_err, max=delta)
    linear = abs_err - quadratic
    loss = 0.5 * quadratic * quadratic + delta * linear
    if weights is not None:
        loss = loss * weights
    return torch.mean(loss) if size_average else torch.sum(loss)


def one_hot(x: torch.Tensor, num_classes: int) -> torch.Tensor:
    """f32 one-hot in which negative entries give all-zero rows."""
    non_neg = x >= 0
    oh = F.one_hot(torch.where(non_neg, x, torch.zeros_like(x)).long(),
                   num_classes).to(torch.float32)
    return oh * non_neg.unsqueeze(-1).to(torch.float32)


def _box_loss(box_outputs, box_targets, num_positives_sum,
              delta: float = 0.1):
    """Huber box loss over matched anchors, normalised by 4 * positives."""
    normalizer = num_positives_sum * 4.0
    mask = (box_targets != 0.0).to(box_outputs.dtype)
    loss = huber_loss(box_outputs, box_targets, weights=mask, delta=delta,
                      size_average=False)
    return loss / normalizer


def detection_loss_flat(cls_logits, box_outputs, cls_targets, box_targets,
                        num_positives, num_classes: int, alpha: float,
                        gamma: float, delta: float, box_loss_weight: float,
                        label_smoothing: float = 0.0,
                        legacy_focal: bool = False,
                        focal_modulation: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Total detection loss over flat [B, A, C] / [B, A, 4] outputs and
    [B, A] / [B, A, 4] targets. Returns (total, class loss, box loss)."""
    num_positives_sum = torch.sum(num_positives) + 1.0
    cls_targets_oh = one_hot(cls_targets, num_classes)
    compute_dtype = cls_logits.dtype
    if legacy_focal:
        cls_loss = focal_loss_legacy(
            cls_logits, cls_targets_oh.to(compute_dtype), alpha=alpha,
            gamma=gamma, normalizer=num_positives_sum)
    else:
        cls_loss = new_focal_loss(
            cls_logits, cls_targets_oh.to(compute_dtype), alpha=alpha,
            gamma=gamma, normalizer=num_positives_sum,
            label_smoothing=label_smoothing, modulation=focal_modulation)
    ignore_mask = (cls_targets != -2).to(compute_dtype)
    cls_loss = torch.sum(cls_loss * ignore_mask.unsqueeze(-1))
    box_loss = _box_loss(box_outputs, box_targets, num_positives_sum,
                         delta=delta)
    total = cls_loss + box_loss_weight * box_loss
    return total, cls_loss, box_loss


def detection_loss_levels(cls_outputs: Sequence[torch.Tensor],
                          box_outputs: Sequence[torch.Tensor],
                          cls_targets: Sequence[torch.Tensor],
                          box_targets: Sequence[torch.Tensor],
                          num_positives, num_classes: int, alpha: float,
                          gamma: float, delta: float, box_loss_weight: float,
                          label_smoothing: float = 0.0,
                          legacy_focal: bool = False,
                          focal_modulation: bool = False):
    """``detection_loss_flat`` of per-level NHWC outputs and per-level
    targets (class [B, H, W, A], box [B, H, W, A*4]): the reference's
    per-level loss signature."""
    return detection_loss_flat(
        levels_to_flat(cls_outputs, num_classes),
        levels_to_flat(box_outputs, 4),
        levels_to_flat([t.unsqueeze(-1) for t in cls_targets], 1)[..., 0],
        levels_to_flat(box_targets, 4),
        num_positives, num_classes=num_classes, alpha=alpha, gamma=gamma,
        delta=delta, box_loss_weight=box_loss_weight,
        label_smoothing=label_smoothing, legacy_focal=legacy_focal,
        focal_modulation=focal_modulation)


def class_loss_flat(cls_logits, cls_targets, num_positives,
                    alpha: Optional[float], gamma: float,
                    label_smoothing: float = 0.0,
                    loss_type: str = "ce") -> torch.Tensor:
    """Class-only loss of [B, A, C] logits against [B, A, C] float
    (one-hot or soft) targets, summed over the 'new' focal terms
    normalised by positives + 1; ``loss_type`` 'ce' (sigmoid BCE) or
    'mse'."""
    num_positives_sum = torch.sum(num_positives) + 1.0
    loss_func = sigmoid_bce if loss_type == "ce" else \
        (lambda lo, t: (lo - t) ** 2)
    loss = new_focal_loss(cls_logits, cls_targets, alpha=alpha, gamma=gamma,
                          normalizer=num_positives_sum,
                          label_smoothing=label_smoothing,
                          loss_func=loss_func)
    return torch.sum(loss)


def box_only_loss_flat(box_outputs, box_targets, num_positives,
                       delta: float, box_loss_weight: float) -> torch.Tensor:
    """``box_loss_weight`` times the huber box loss alone."""
    num_positives_sum = torch.sum(num_positives) + 1.0
    return box_loss_weight * _box_loss(box_outputs, box_targets,
                                       num_positives_sum, delta=delta)


def _focal_elem_terms(alpha, label_smoothing, logits, tgt):
    """Per-element target, alpha scale and ignore mask of the alpha-only
    focal loss; the class-axis compare stands in for the one-hot."""
    dt = logits.dtype
    cls_ids = torch.arange(logits.shape[-1], device=logits.device)
    is_t = cls_ids == tgt.unsqueeze(-1)
    t = torch.where(is_t, 1.0 - 0.5 * label_smoothing,
                    0.5 * label_smoothing).to(dt)
    sc = None if alpha is None else \
        torch.where(is_t, alpha, 1.0 - alpha).to(dt)
    ign = (tgt != -2).unsqueeze(-1)
    return t, sc, ign


class FusedAlphaFocalSum(torch.autograd.Function):
    """Summed alpha-only focal class loss with a hand-written backward.

    ``apply(logits [..., C], tgt [...] int (-1 bg, -2 ignore), normalizer,
    alpha, label_smoothing)`` -> f32 scalar. The same math as
    ``new_focal_loss(modulation=False)`` + ignore mask + sum. The backward
    recomputes ``scale * (sigmoid(x) - t) * g / normalizer`` from (logits,
    targets); the normalizer gets no gradient (the reference treats the
    positive count as data).
    """

    @staticmethod
    def forward(ctx, logits, tgt, normalizer, alpha, label_smoothing):
        ctx.save_for_backward(logits, tgt, normalizer)
        ctx.alpha, ctx.label_smoothing = alpha, label_smoothing
        t, sc, ign = _focal_elem_terms(alpha, label_smoothing, logits, tgt)
        loss = sigmoid_bce(logits, t)
        if sc is not None:
            loss = sc * loss
        loss = torch.where(ign, loss.float() / normalizer,
                           torch.zeros((), device=logits.device))
        return torch.sum(loss).to(torch.float32)

    @staticmethod
    def backward(ctx, g):
        logits, tgt, normalizer = ctx.saved_tensors
        t, sc, ign = _focal_elem_terms(ctx.alpha, ctx.label_smoothing,
                                       logits, tgt)
        dx = torch.sigmoid(logits) - t
        if sc is not None:
            dx = sc * dx
        dx = torch.where(ign, dx.float() * (g / normalizer),
                         torch.zeros((), device=logits.device))
        return dx.to(logits.dtype), None, None, None, None


def levels_to_flat(per_level: Sequence[torch.Tensor], last_dim: int
                   ) -> torch.Tensor:
    """Per-level NHWC outputs [B, H, W, A*k] -> flat [B, A_total, k]."""
    batch = per_level[0].shape[0]
    return torch.cat([x.reshape(batch, -1, last_dim) for x in per_level],
                     dim=1)


def detection_loss_nhwc(cls_outputs: Sequence[torch.Tensor],
                        box_outputs: Sequence[torch.Tensor],
                        cls_targets: torch.Tensor, box_targets: torch.Tensor,
                        num_positives: torch.Tensor, num_classes: int,
                        alpha: float, gamma: float, delta: float,
                        box_loss_weight: float, label_smoothing: float = 0.0,
                        legacy_focal: bool = False,
                        focal_modulation: bool = False,
                        remat_cls: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The detection loss level by level on the heads' NHWC outputs, with
    flat [B, A_total] / [B, A_total, 4] targets; equal to
    ``detection_loss_flat`` without building the flat class tensor.

    ``remat_cls`` checkpoints each level's class loss
    (``torch.utils.checkpoint``): the backward recomputes it from (logits,
    targets) instead of keeping its intermediates. It only matters off
    the fused alpha-only path, which keeps nothing logit-sized anyway.
    """
    num_positives_sum = torch.sum(num_positives) + 1.0
    compute_dtype = cls_outputs[0].dtype
    fused = not legacy_focal and not focal_modulation

    def level_cls_loss(lvl, tgt, npos_sum):
        b, h, w, ac = lvl.shape
        a = ac // num_classes
        tgt = tgt.reshape(b, h, w, a)
        logits = lvl.reshape(b, h, w, a, num_classes)
        if fused:
            return FusedAlphaFocalSum.apply(logits, tgt, npos_sum.detach(),
                                            alpha, label_smoothing)
        tgt_oh = one_hot(tgt, num_classes).to(compute_dtype)
        if legacy_focal:
            loss = focal_loss_legacy(logits, tgt_oh, alpha=alpha, gamma=gamma,
                                     normalizer=npos_sum)
        else:
            loss = new_focal_loss(logits, tgt_oh, alpha=alpha, gamma=gamma,
                                  normalizer=npos_sum,
                                  label_smoothing=label_smoothing,
                                  modulation=focal_modulation)
        ignore = (tgt != -2).to(compute_dtype)
        return torch.sum(loss * ignore.unsqueeze(-1)).to(torch.float32)

    cls_loss_total = torch.zeros((), dtype=torch.float32,
                                 device=cls_targets.device)
    offset = 0
    for lvl in cls_outputs:
        b, h, w, ac = lvl.shape
        size = h * w * (ac // num_classes)
        tgt = cls_targets[:, offset:offset + size]
        if remat_cls:
            cls_loss_total = cls_loss_total + checkpoint(
                level_cls_loss, lvl, tgt, num_positives_sum,
                use_reentrant=False)
        else:
            cls_loss_total = cls_loss_total + level_cls_loss(
                lvl, tgt, num_positives_sum)
        offset += size

    box_loss_total = torch.zeros((), dtype=torch.float32,
                                 device=box_targets.device)
    offset = 0
    for lvl in box_outputs:
        b, h, w, a4 = lvl.shape
        size = h * w * (a4 // 4)
        tgt = box_targets[:, offset:offset + size].reshape(b, h, w, a4)
        mask = (tgt != 0.0).to(lvl.dtype)
        box_loss_total = box_loss_total + (
            huber_loss(lvl, tgt, weights=mask, delta=delta,
                       size_average=False) / (num_positives_sum * 4.0)
        ).to(torch.float32)
        offset += size

    total = cls_loss_total + box_loss_weight * box_loss_total
    return total, cls_loss_total, box_loss_total


class DetectionLoss:
    """Config-bound loss: per-level lists go through ``levels_to_flat``,
    flat arrays straight to ``detection_loss_flat``."""

    def __init__(self, config):
        self.num_classes = config.num_classes
        self.alpha = config.alpha
        self.gamma = config.gamma
        self.delta = config.delta
        self.box_loss_weight = config.box_loss_weight
        self.label_smoothing = config.label_smoothing
        self.legacy_focal = config.legacy_focal
        self.focal_modulation = getattr(config, "focal_modulation", False)

    def __call__(self, cls_outputs, box_outputs, cls_targets, box_targets,
                 num_positives):
        if isinstance(cls_outputs, (list, tuple)):
            cls_outputs = levels_to_flat(cls_outputs, self.num_classes)
            box_outputs = levels_to_flat(box_outputs, 4)
            cls_targets = levels_to_flat(
                [t.unsqueeze(-1) for t in cls_targets], 1)[..., 0]
            box_targets = levels_to_flat(box_targets, 4)
        return detection_loss_flat(
            cls_outputs, box_outputs, cls_targets, box_targets, num_positives,
            num_classes=self.num_classes, alpha=self.alpha, gamma=self.gamma,
            delta=self.delta, box_loss_weight=self.box_loss_weight,
            label_smoothing=self.label_smoothing,
            legacy_focal=self.legacy_focal,
            focal_modulation=self.focal_modulation)
