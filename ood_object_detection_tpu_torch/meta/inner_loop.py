"""MAML inner loop: adapt the class head on pseudo-labeled supports (port of
``ood_object_detection_tpu.meta.inner_loop``).

Fast weights are a dict of class-head tensors (parameter name -> tensor)
that ``EfficientDet.class_head(params=...)`` runs in place of the head's
own parameters (``torch.func.functional_call``); the module's parameters
are never written. The inner gradient comes from ``torch.autograd.grad``,
with ``create_graph=True`` when a meta-gradient will flow through the
update (second order), as ``jax.grad`` over the JAX episode gives.

Per-layer inner LRs (reference infer.py:660-678), by the port's parameter
names:
  conv_rep.{i}.*                     -> lrs['conv'][i]
  predict.conv_dw.*                  -> lrs['predict_dw']
  predict.conv_pw.* / predict.conv.* -> lrs['predict_pw']
  predict_sep.*                      -> lrs['predict_pw']
  bn_rep.*                           -> not adapted
``only_final`` adapts only the predict pointwise leaves (and the sep
head); ``separate_head`` freezes the main predict pointwise while the conv
reps, the predict depthwise and the sep head adapt (infer.py:663).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..models.layers import batch_stats_mode
from ..ops.losses import sigmoid_bce
from .clustering import cluster_pseudo_targets
from .config import MetaConfig
from .projection import build_anchor_features, select_confident_anchors


def init_inner_lrs(box_class_repeats: int, inner_lr: float,
                   multi_inner: bool = True) -> Dict[str, torch.Tensor]:
    """Learnable per-layer inner LRs (reference infer.py:243-257)."""
    if not multi_inner:
        return {"shared": torch.tensor(inner_lr, dtype=torch.float32)}
    return {
        "conv": torch.full((box_class_repeats,), inner_lr,
                           dtype=torch.float32),
        "predict_dw": torch.tensor(inner_lr, dtype=torch.float32),
        "predict_pw": torch.tensor(inner_lr, dtype=torch.float32),
    }


def _lr_for_path(name: str, lrs: Dict[str, torch.Tensor], only_final: bool,
                 separate_head: bool = False) -> Optional[torch.Tensor]:
    """LR of one class-head parameter (its name in ``class_net``); None =
    not adapted. A non-separable head's single ``predict.conv`` takes the
    pointwise role."""
    if "bn_rep" in name:
        return None
    is_main_pw = name.startswith(("predict.conv_pw.", "predict.conv."))
    is_sep_pw = name.startswith("predict_sep.")
    if separate_head and is_main_pw:
        return None                      # main head frozen, sep adapts
    if only_final and not (is_main_pw or is_sep_pw):
        return None
    if "shared" in lrs:
        return lrs["shared"]
    if is_main_pw or is_sep_pw:
        return lrs["predict_pw"]
    if name.startswith("predict."):      # predict.conv_dw
        return lrs["predict_dw"]
    if name.startswith("conv_rep."):
        return lrs["conv"][int(name.split(".")[1])]
    return None


def adapted_lrs(names, lrs: Dict[str, torch.Tensor], only_final: bool = False,
                separate_head: bool = False) -> Dict[str, torch.Tensor]:
    """{name: LR} of the class-head parameters the inner loop adapts.
    Raises when the freeze rules match none: a naming mismatch must not
    become an inner loop that adapts nothing."""
    rates = {}
    for name in names:
        lr = _lr_for_path(name, lrs, only_final, separate_head)
        if lr is not None:
            rates[name] = lr
    if not rates:
        raise ValueError(
            "inner loop adapts no class_net leaves — freeze rules "
            f"(only_final={only_final}, separate_head={separate_head}) "
            "matched no param paths")
    return rates


def sgd_fast_update(class_params: Dict[str, torch.Tensor],
                    grads: Dict[str, torch.Tensor],
                    lrs: Dict[str, torch.Tensor], only_final: bool = False,
                    separate_head: bool = False) -> Dict[str, torch.Tensor]:
    """fast_w = w - lr_layer * grad for the adapted leaves; the others
    (BatchNorm, frozen predict convs) are passed through."""
    rates = adapted_lrs(class_params, lrs, only_final, separate_head)
    return {name: p - rates[name] * grads[name] if name in rates else p
            for name, p in class_params.items()}


def class_head(model, activs, params: Optional[Dict[str, torch.Tensor]],
               **kwargs):
    """``model.class_head`` with ``params`` for its parameters, normalising
    as the JAX head does outside a mutable apply: with the running
    statistics, or the batch statistics under ``force_batch_stats``; it
    writes no running statistic, whatever the module's mode."""
    with batch_stats_mode(model.class_net, False):
        return model.class_head(activs, params=params, **kwargs)


def support_pseudo_loss(model, proj_net, class_params: Dict[str, torch.Tensor],
                        proj_params: Dict[str, torch.Tensor], supp_activs,
                        meta_cfg: MetaConfig
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One inner iteration's support loss (infer.py:559-656): class head
    with ``class_params`` (batch statistics, levels from
    ``supp_level_offset``), confidence top-k, projection embedding,
    clustering, BCE(cls_logits, pseudo_target). With ``separate_head`` the
    gating and clustering read the main head's logits and the BCE the sep
    head's (infer.py:560-564, 595-596, 656). Every operation is twice
    differentiable."""
    off = meta_cfg.supp_level_offset
    sep_out = None
    if meta_cfg.separate_head:
        sep_out, cls_out, activs = class_head(
            model, supp_activs, class_params, ret_activs=True,
            level_offset=off, force_batch_stats=True, heads="both")
    else:
        cls_out, activs = class_head(
            model, supp_activs, class_params, ret_activs=True,
            level_offset=off, force_batch_stats=True)

    feats = build_anchor_features(activs, level_offset=off,
                                  ref_pos_enc=meta_cfg.ref_pos_enc)
    rows, confs, _, sep_sel = select_confident_anchors(
        feats, cls_out, meta_cfg, sep_out=sep_out)
    if meta_cfg.proj_stop_grad:
        rows = rows.detach()
    embds = torch.func.functional_call(proj_net, proj_params, (rows,))

    result = cluster_pseudo_targets(
        embds, confs, proj_params["dot_mult"], proj_params["dot_add"],
        sim_thresh=meta_cfg.sim_thresh, refine_reduce="sum",
        sim_target=meta_cfg.sim_target,
        gate_stop_grad=not meta_cfg.inner_thresh_train)

    cls_flat = (sep_sel if meta_cfg.separate_head else confs).reshape(-1)
    target = result.target if meta_cfg.inner_thresh_train else \
        result.target.detach()
    loss = torch.mean(sigmoid_bce(cls_flat, target))
    metrics = {
        "supp_class_loss": loss,
        "target_sum": torch.sum(result.target),
        "supp_valid_champions": result.valid_count,
    }
    return loss, metrics


def inner_adapt(model, proj_net, class_params: Dict[str, torch.Tensor],
                proj_params: Dict[str, torch.Tensor],
                inner_lrs: Dict[str, torch.Tensor], supp_activs,
                meta_cfg: MetaConfig, create_graph: bool = True
                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """Run ``meta_cfg.steps`` inner SGD steps on the class head from
    ``class_params``. Returns (fast class-head tensors, last-step
    metrics). With ``create_graph`` the fast weights stay differentiable
    through the inner gradient (second order); without it the inner
    gradient is a constant (first order)."""
    rates = adapted_lrs(class_params, inner_lrs, meta_cfg.only_final,
                        meta_cfg.separate_head)
    names = list(rates)
    metrics = {}
    with torch.enable_grad():
        params = {n: p if p.requires_grad else p.detach().requires_grad_()
                  for n, p in class_params.items()}
        for _ in range(meta_cfg.steps):
            loss, metrics = support_pseudo_loss(
                model, proj_net, params, proj_params, supp_activs, meta_cfg)
            grads = torch.autograd.grad(
                loss, [params[n] for n in names], create_graph=create_graph,
                allow_unused=True, materialize_grads=True)
            params = sgd_fast_update(params, dict(zip(names, grads)),
                                     inner_lrs, meta_cfg.only_final,
                                     meta_cfg.separate_head)
    return params, metrics
