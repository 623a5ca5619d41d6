"""Confidence-gated similarity clustering for pseudo-labeling web supports
(port of ``ood_object_detection_tpu.meta.clustering``).

The clustering core shared by the reference's projection-pretraining
phase (infer.py:421-472) and its inner-loop pseudo-target construction
(infer.py:606-654): L2-normalised anchor embeddings, similarities gated by
a learned confidence threshold sigmoid(dot_mult * (conf + dot_add)), one
champion anchor an image, champions validated by mutual coherence and
refined once against the valid subset, per-anchor soft pseudo-targets.

The factorised form is kept: the [M, M] similarity matrix is never
built. Every use of it is a champion-column gather (``embds @
embds[champs].T``, [M, S]) or a mean over all anchors, which factorises
as ``mean_j(t_j e_i.e_j) = e_i . (sum_j t_j e_j) / M``. Ties go to the
lowest index (``torch.argmax`` returns the first maximum, as
``jnp.argmax`` does; the median's sort is stable, as ``jnp.argsort`` is).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..ops.losses import sigmoid_bce


@dataclasses.dataclass(frozen=True)
class ClusterResult:
    target: torch.Tensor          # [M] per-anchor soft pseudo-target
    soft_thresh: torch.Tensor     # [M] sigmoid confidence gate
    champion_idx: torch.Tensor    # [S] refined per-image champion (flat idx)
    champion_coherence: torch.Tensor   # [S] refined champion cluster quality
    valid_count: torch.Tensor     # [] number of valid initial champions
    champ_sims: torch.Tensor      # [M, S] similarities to refined champions
    target_clust: torch.Tensor    # [M] per-anchor cluster-quality factor
    champion_target_clust: torch.Tensor   # [S] refined champions' quality


def cluster_pseudo_targets(
        embeddings: torch.Tensor,     # [S, K, D] per-image anchor embeddings
        conf_logits: torch.Tensor,    # [S, K] confidence logits
        dot_mult: torch.Tensor,
        dot_add: torch.Tensor,
        sim_thresh: Optional[float] = None,
        refine_reduce: str = "sum",   # 'sum' (inner loop) | 'mean' (phase A)
        sim_target: str = "max",
        gate_stop_grad: bool = False) -> ClusterResult:
    """Cluster S*K anchors into one task cluster and emit soft targets.

    With ``sim_thresh`` None a champion is valid when its coherence is
    above the mean (projection phase, infer.py:438), else above
    ``sim_thresh`` (inner loop, infer.py:631).
    """
    s, k, d = embeddings.shape
    m = s * k

    embds = embeddings.reshape(m, d)
    embds = embds / torch.clamp(
        torch.linalg.vector_norm(embds, dim=-1, keepdim=True), min=1e-12)

    conf_flat = conf_logits.reshape(m)
    soft_thresh = torch.sigmoid(dot_mult * (conf_flat + dot_add))
    if gate_stop_grad:
        soft_thresh = soft_thresh.detach()

    # initial champions: per image, the anchor with the largest mean gated
    # similarity, t_i * (e_i . sum_j t_j e_j) / M
    gated_sum = embds.T @ soft_thresh                             # [D]
    img_avg_all = (soft_thresh * (embds @ gated_sum) / m).reshape(s, k)
    base = torch.arange(s, device=embds.device) * k
    champ0 = base + torch.argmax(img_avg_all, dim=1)               # [S]

    champ0_embds = embds[champ0]                                  # [S, D]
    init_cluster = champ0_embds @ champ0_embds.T                  # [S, S]
    avg_init = torch.mean(init_cluster, dim=1) - 1.0 / s
    if sim_thresh is None:
        valid = avg_init > torch.mean(avg_init)
    else:
        valid = avg_init > sim_thresh
    valid_f = valid.to(embds.dtype)
    valid_count = torch.sum(valid_f)
    denom = torch.clamp(valid_count, min=1.0)

    # means / sums over the valid champions' columns only
    champ_cols = embds @ champ0_embds.T                           # [M, S]
    target_clust_all = torch.sum(champ_cols * valid_f[None, :], dim=1) / denom

    # w_champ[i, j] = t_i * t_{champ0_j} * sim[i, champ0_j] * valid_j
    w_champ = (soft_thresh[:, None] * champ_cols
               * (soft_thresh[champ0] * valid_f)[None, :]).reshape(s, k, s)
    img_clust = torch.sum(w_champ, dim=2)
    if refine_reduce != "sum":
        img_clust = img_clust / denom
    champs = base + torch.argmax(img_clust, dim=1)                 # refined

    target_clust_champ = target_clust_all[champs]                 # [S]
    champ_embds = embds[champs]                                   # [S, D]
    refined_cluster = champ_embds @ champ_embds.T
    champion_coherence = torch.mean(refined_cluster, dim=1) - 1.0 / s

    champ_sims = embds @ champ_embds.T                            # [M, S]
    if sim_target == "max":
        all_max = torch.amax(champ_sims, dim=1)                   # [M]
        all_arg = torch.argmax(champ_sims, dim=1)                 # [M]
        target_clust = target_clust_champ[all_arg]
        target = soft_thresh * target_clust * all_max
    else:  # 'avg'
        all_avg = torch.mean(champ_sims, dim=1)
        target = soft_thresh * all_avg
        target_clust = all_avg

    return ClusterResult(
        target=target, soft_thresh=soft_thresh, champion_idx=champs,
        champion_coherence=champion_coherence, valid_count=valid_count,
        champ_sims=champ_sims, target_clust=target_clust,
        champion_target_clust=target_clust_champ)


def weighted_median(embds: torch.Tensor, confs: torch.Tensor,
                    stop_gradient: bool = True):
    """Confidence-weighted median per embedding dim (reference
    ProjectionNet.weighted_median, effdet/efficientdet.py:746-758).

    embds: [N, D]; confs: [N]. Returns ([1, D] median, conf_sum scalar).
    """
    conf_sum = torch.sum(confs)
    order = torch.argsort(embds, dim=0, stable=True)             # [N, D]
    sorted_elems = torch.gather(embds, 0, order)
    cum = torch.cumsum(confs[order], dim=0)
    median_idx = torch.argmax((cum >= conf_sum / 2).to(torch.int32),
                              dim=0)[None, :]
    median = torch.gather(sorted_elems, 0, median_idx)
    if stop_gradient:
        median = median.detach()
    return median, conf_sum


def cosine_hinge_loss(inputs: torch.Tensor, targets: torch.Tensor,
                      margin: float = 0.0) -> torch.Tensor:
    """Hinged cosine loss (reference cosine_loss, loss.py:97-101):
    positives pay 1 - x, negatives pay max(x - margin, 0)."""
    loss = torch.where(targets == 1.0, 1.0 - inputs, inputs - margin)
    return torch.mean(torch.clamp(loss, min=0.0))


def projection_losses(
        result: ClusterResult,
        proj_labels: torch.Tensor,     # [M] anchor GT labels (-1 = bg)
        task_cls: torch.Tensor,        # scalar task category id
        soft_logits: torch.Tensor,     # [M] pre-sigmoid gate logits
        loss_mode: str = "separate",
        sim_target: str = "max",
        margin: float = 0.0
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Phase-A supervision (infer.py:448-494): cosine losses pulling
    same-task-class anchor pairs together + objectness BCE on the gate.

    Returns (embds_loss, clust_loss, obj_loss).
    """
    soft = result.soft_thresh
    champ_sims = result.champ_sims                                # [M, S]
    zero = torch.zeros((), dtype=torch.float32, device=soft.device)
    if sim_target == "max":
        all_max = torch.amax(champ_sims, dim=1)
        all_arg = torch.argmax(champ_sims, dim=1)
        # pair_target[i, j] = 1 iff label_i == label_j == task_cls, read
        # only at the champion columns
        champ_labels = proj_labels[result.champion_idx]           # [S]
        champ_labels_target = torch.where(champ_labels == task_cls, 1.0, -1.0)
        nearest_champ_label = champ_labels[all_arg]               # [M]
        per_anchor_target = torch.where(
            (proj_labels == nearest_champ_label)
            & (nearest_champ_label == task_cls), 1.0, -1.0)

        if loss_mode == "separate":
            clust_loss = cosine_hinge_loss(
                result.champion_target_clust, champ_labels_target, margin)
            embds_loss = cosine_hinge_loss(
                soft * all_max, per_anchor_target, margin)
        elif loss_mode == "same":
            clust_loss = zero
            embds_loss = cosine_hinge_loss(
                soft * all_max * result.target_clust, per_anchor_target,
                margin)
        else:  # 'no_conf'
            clust_loss = cosine_hinge_loss(
                result.champion_target_clust, champ_labels_target, margin)
            embds_loss = cosine_hinge_loss(all_max, per_anchor_target, margin)
    else:  # 'avg'
        all_avg = torch.mean(champ_sims, dim=1)
        anchor_target = torch.where(proj_labels == task_cls, 1.0, -1.0)
        embds_loss = cosine_hinge_loss(soft * all_avg, anchor_target, margin)
        clust_loss = zero

    obj_target = (proj_labels > -1).to(torch.float32)
    obj_loss = torch.sum(sigmoid_bce(soft_logits, obj_target))
    return embds_loss, clust_loss, obj_loss
