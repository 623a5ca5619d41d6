"""Episodic meta-training step: projection pretraining + MAML meta-update
(port of ``ood_object_detection_tpu.meta.episode``).

* Phase A (step < proj_iters): train the ProjectionNet and its gate on
  projection crops — confidence-selected anchor embeddings, similarity
  clustering, cosine embedding / cluster losses + objectness BCE
  (infer.py:356-494).
* Phase B: MAML episode — inner-adapt the class head on pseudo-labeled
  supports, score the adapted head on the query detection loss, add the
  projection regularizer, meta-step (infer.py:557-687).

The meta parameters are three dicts of tensors: ``class_net`` (the class
head's parameters by name), ``proj`` (the ProjectionNet's, ``dot_mult`` /
``dot_add`` among them) and ``inner_lrs``. The model's other parameters
and every BatchNorm statistic are the frozen variables: no pass of the
episode writes them. Each subnet normalises as its ``freeze_*_bn`` flag
says (``layers.batch_stats_mode``: batch statistics, nothing written).
Passes that lead to no meta parameter (the supports' trunk, the queries'
trunk unless ``train_bb`` / ``train_fpn``) run under ``torch.no_grad``.

Episode batch contract (built by ``data.episodic.EpisodeBuilder``):
  supp_images  [S, hs, ws, 3]   normalized float
  qry_images   [Q, hq, wq, 3]
  proj_images  [P, hs, ws, 3]
  qry_cls / qry_box / qry_num_positives : flat anchor labels (query anchors)
  proj_cls : flat anchor labels (projection anchors)
  task_cls : scalar int (the episode's category id, 0-based)
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config.model_config import ModelConfig
from ..factory import resolve_device
from ..models.layers import batch_stats_mode
from ..ops.anchors import Anchors
from ..ops.boxes import pairwise_iou_yxyx
from ..ops.losses import detection_loss_nhwc
from ..ops.post_process import _per_anchor_reduce, generate_detections
from ..parallel.mesh import all_reduce_sum
from ..train.train_state import _clip_by_global_norm
from .clustering import cluster_pseudo_targets, projection_losses
from .config import MetaConfig
from .inner_loop import class_head, init_inner_lrs, inner_adapt
from .projection import build_anchor_features, select_confident_anchors

MetaParams = Dict[str, Dict[str, torch.Tensor]]


def _image_features(model, images: torch.Tensor, meta_cfg: MetaConfig,
                    grad_bb: bool = False, grad_fpn: bool = False
                    ) -> List[torch.Tensor]:
    """image -> FPN pyramid (NHWC) with per-subnet BN modes (backbone:
    freeze_bb_bn, FPN: freeze_fpn_bn). The backbone / FPN keep an
    autograd graph only with ``grad_bb`` / ``grad_fpn`` (where the JAX
    episode has no ``stop_gradient``) and grad mode on."""
    grad = torch.is_grad_enabled()
    with torch.set_grad_enabled(grad and grad_bb), \
            batch_stats_mode(model.backbone, not meta_cfg.freeze_bb_bn):
        feats = model.backbone_features(images)
    with torch.set_grad_enabled(grad and grad_fpn), \
            batch_stats_mode(model.fpn, not meta_cfg.freeze_fpn_bn):
        return model.fpn_features(feats)


def _box_head(model, activs, meta_cfg: MetaConfig) -> List[torch.Tensor]:
    with batch_stats_mode(model.box_net, not meta_cfg.freeze_box_bn):
        return model.box_head(activs)


def projection_phase_loss(model, proj_net,
                          class_params: Dict[str, torch.Tensor],
                          proj_params: Dict[str, torch.Tensor],
                          batch: Dict, meta_cfg: MetaConfig,
                          proj_level_sizes, activs_override=None
                          ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Phase-A loss on projection crops (infer.py:349-494).

    ``activs_override``: precomputed FPN activations used instead of the
    batch's proj crops (the ``ref_stale_proj_activs`` compat mode feeds
    the last phase-A episode's here); the batch still supplies the
    labels. The class head runs on the levels from ``supp_level_offset``,
    whose grids equal the offset projection labeler's."""
    if activs_override is not None:
        activs = activs_override
    else:
        activs = _image_features(model, batch["proj_images"], meta_cfg,
                                 grad_bb=meta_cfg.train_fpn,
                                 grad_fpn=meta_cfg.train_fpn)
    off = meta_cfg.supp_level_offset
    cls_out, obj_embds = class_head(
        model, activs, class_params, ret_activs=True, level_offset=off,
        force_batch_stats=True)
    if meta_cfg.proj_stop_grad:
        obj_embds = [e.detach() for e in obj_embds]

    feats = build_anchor_features(obj_embds, level_offset=off,
                                  ref_pos_enc=meta_cfg.ref_pos_enc)
    rows, confs, labels, _ = select_confident_anchors(
        feats, cls_out, meta_cfg, labels_flat=batch["proj_cls"],
        level_sizes=proj_level_sizes)
    embds = torch.func.functional_call(proj_net, proj_params, (rows,))
    dot_mult, dot_add = proj_params["dot_mult"], proj_params["dot_add"]

    result = cluster_pseudo_targets(
        embds, confs, dot_mult, dot_add, sim_thresh=None,
        refine_reduce="mean", sim_target=meta_cfg.sim_target)
    soft_logits = dot_mult * (confs.reshape(-1) + dot_add)
    embds_loss, clust_loss, obj_loss = projection_losses(
        result, labels.reshape(-1), batch["task_cls"], soft_logits,
        loss_mode=meta_cfg.loss_mode, sim_target=meta_cfg.sim_target,
        margin=meta_cfg.margin)

    total = meta_cfg.proj_coeff * (embds_loss + clust_loss) + \
        meta_cfg.obj_coeff * obj_loss
    metrics = {
        "embds_loss": embds_loss, "clust_loss": clust_loss,
        "obj_loss": obj_loss, "proj_loss": total,
        "valid_champions": result.valid_count,
    }
    return total, metrics


def maml_episode_loss(model, proj_net, meta_params: MetaParams, batch: Dict,
                      meta_cfg: MetaConfig, model_cfg: ModelConfig,
                      proj_level_sizes, stale_proj_activs=None,
                      create_graph: bool = True
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Phase-B episode: inner-adapt -> query detection loss -> + proj reg.

    ``create_graph=False`` takes the inner gradient as a constant (a
    first-order meta-gradient, or a loss-only evaluation).
    ``stale_proj_activs`` feeds the projection regularizer under the
    ``ref_stale_proj_activs`` compat mode."""
    if (meta_cfg.ref_stale_proj_activs and meta_cfg.proj_reg > 0.0
            and stale_proj_activs is None):
        raise ValueError(
            "ref_stale_proj_activs=True requires stale_proj_activs (the "
            "cached phase-A activations) — MetaTrainer plumbs this "
            "automatically")
    # supports: frozen feature extractor (reference no_grad,
    # infer.py:341-342); queries: frozen unless train_bb / train_fpn
    with torch.no_grad():
        supp_activs = _image_features(model, batch["supp_images"], meta_cfg)
    qry_activs = _image_features(
        model, batch["qry_images"], meta_cfg,
        grad_bb=meta_cfg.train_bb and meta_cfg.train_fpn,
        grad_fpn=meta_cfg.train_fpn)
    qry_box_out = _box_head(model, qry_activs, meta_cfg)

    fast_class, inner_metrics = inner_adapt(
        model, proj_net, meta_params["class_net"], meta_params["proj"],
        meta_params["inner_lrs"], supp_activs, meta_cfg,
        create_graph=create_graph)
    qry_class_out = class_head(model, qry_activs, fast_class)

    qry_loss, qry_cls_loss, qry_box_loss = detection_loss_nhwc(
        qry_class_out, qry_box_out, batch["qry_cls"], batch["qry_box"],
        batch["qry_num_positives"], num_classes=model_cfg.num_classes,
        alpha=model_cfg.alpha, gamma=model_cfg.gamma, delta=model_cfg.delta,
        box_loss_weight=model_cfg.box_loss_weight,
        label_smoothing=model_cfg.label_smoothing,
        legacy_focal=model_cfg.legacy_focal,
        focal_modulation=model_cfg.focal_modulation)

    if meta_cfg.proj_reg > 0.0:
        proj_loss, proj_metrics = projection_phase_loss(
            model, proj_net, meta_params["class_net"], meta_params["proj"],
            batch, meta_cfg, proj_level_sizes,
            activs_override=stale_proj_activs)
    else:
        proj_loss = torch.zeros((), device=qry_loss.device)
        proj_metrics = {}

    final = qry_loss + meta_cfg.proj_reg * proj_loss
    metrics = {
        "qry_loss": qry_loss, "qry_class_loss": qry_cls_loss,
        "qry_box_loss": qry_box_loss, "final_loss": final,
        **inner_metrics, **proj_metrics,
    }
    return final, metrics


@torch.no_grad()
def _adapted_query_outputs(model, proj_net, meta_params: MetaParams,
                           batch: Dict, meta_cfg: MetaConfig
                           ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Inner-adapt the class head on the episode's supports, then run the
    queries through the frozen trunk + adapted head: (qry_class_out,
    qry_box_out) per level, the stem of the detection and open-set
    paths."""
    supp_activs = _image_features(model, batch["supp_images"], meta_cfg)
    fast_class, _ = inner_adapt(
        model, proj_net, meta_params["class_net"], meta_params["proj"],
        meta_params["inner_lrs"], supp_activs, meta_cfg, create_graph=False)
    qry_activs = _image_features(model, batch["qry_images"], meta_cfg)
    return (class_head(model, qry_activs, fast_class),
            _box_head(model, qry_activs, meta_cfg))


def maml_episode_detections(model, proj_net, meta_params: MetaParams,
                            batch: Dict, meta_cfg: MetaConfig,
                            model_cfg: ModelConfig, qry_anchors: Anchors
                            ) -> torch.Tensor:
    """Query detections [Q, max_dets, 6] from the inner-adapted head, at
    ``meta_cfg.nms_thresh`` (reference infer.py:689-700)."""
    qry_class_out, qry_box_out = _adapted_query_outputs(
        model, proj_net, meta_params, batch, meta_cfg)
    dets, _ = generate_detections(
        qry_class_out, qry_box_out, qry_anchors,
        num_classes=model_cfg.num_classes,
        max_detection_points=model_cfg.max_detection_points,
        max_det_per_image=meta_cfg.max_dets, soft_nms=model_cfg.soft_nms,
        iou_threshold=meta_cfg.nms_thresh, topk_method=model_cfg.topk_method)
    return dets


@torch.no_grad()
def maml_episode_ood_scores(model, proj_net, meta_params: MetaParams,
                            batch: Dict, meta_cfg: MetaConfig,
                            model_cfg: ModelConfig, qry_anchors: Anchors,
                            ood_method: str = "energy"):
    """Open-set scores from the inner-adapted head (the meta training
    CLI's ``--eval-ood``).

    Returns (dets [Q, max_det, 6], det_ood [Q, max_det], gt_ood [Q, M],
    gt_valid [Q, M]): every kept detection's OOD score, and each GT
    instance's best-IoU anchor's score (the lowest anchor on ties)."""
    if not isinstance(qry_anchors, Anchors):
        raise TypeError(
            "maml_episode_ood_scores requires qry_anchors=Anchors(...), "
            f"got {type(qry_anchors).__name__}")
    qry_class_out, qry_box_out = _adapted_query_outputs(
        model, proj_net, meta_params, batch, meta_cfg)
    dets, det_ood = generate_detections(
        qry_class_out, qry_box_out, qry_anchors,
        num_classes=model_cfg.num_classes,
        max_detection_points=model_cfg.max_detection_points,
        max_det_per_image=meta_cfg.max_dets, soft_nms=model_cfg.soft_nms,
        iou_threshold=meta_cfg.nms_thresh, ood_method=ood_method,
        topk_method=model_cfg.topk_method)

    _, _, ood_all = _per_anchor_reduce(qry_class_out, model_cfg.num_classes,
                                       ood_method=ood_method)
    anchor_boxes = torch.from_numpy(qry_anchors.boxes).to(ood_all.device)
    # one image at a time: [M, A] IoU, not [Q, M, A]
    gt_ood = torch.stack([
        ood_row[torch.argmax(pairwise_iou_yxyx(boxes, anchor_boxes), dim=1)]
        for ood_row, boxes in zip(ood_all, batch["qry_gt_bbox"])])
    gt_valid = batch["qry_gt_cls"] > 0
    return dets, det_ood, gt_ood, gt_valid


class MetaOptimizer:
    """The meta optimizer, optax's ``chain(clip_by_global_norm(meta_clip),
    multi_transform(...))`` written out over the meta-parameter dicts and
    applied in place. Groups (infer.py:259-274, 815-818):

    * 'predict' — the predict pointwise leaves (the sep head with
      ``separate_head``, else ``predict.conv_pw``): ``meta_lr`` from step 0;
    * 'main' / 'staged' — the rest of the class head and the projection
      net: ``meta_lr`` from step 0 ('main'), or, with ``separate_head``,
      LR 0 for the first ``lr_stage_step`` updates ('staged');
    * 'lrs' — the inner LRs: staged when ``learn_inner``, frozen
      (``optax.set_to_zero``) when not, a constant ``lr_lr`` when given.

    Each group is adam (optax's: moments first, bias correction in f32,
    eps outside the square root) or nesterov SGD (``optax.sgd(lr, 0.9,
    nesterov=True)``). At LR 0 the moments move and the parameters do not,
    as in optax; every leaf takes a gradient, zero where it is unused.
    """

    B1, B2, EPS, MOMENTUM = 0.9, 0.999, 1e-8, 0.9

    def __init__(self, meta_cfg: MetaConfig, lr_lr: Optional[float] = None):
        self.meta_cfg = meta_cfg
        meta_lr = meta_cfg.meta_lr

        def staged(count: int) -> float:
            return 0.0 if count < meta_cfg.lr_stage_step else meta_lr

        self.schedules = {"predict": lambda count: meta_lr,
                          "main": lambda count: meta_lr, "staged": staged}
        if lr_lr is not None:
            self.schedules["lrs"] = lambda count: lr_lr
        elif meta_cfg.learn_inner:
            self.schedules["lrs"] = staged
        else:
            self.schedules["lrs"] = None          # set_to_zero
        self.count = 0
        self.leaves: List[Tuple[str, str, torch.Tensor, str]] = []
        self.state: Dict[Tuple[str, str], Dict[str, torch.Tensor]] = {}

    def label(self, tree: str, name: str) -> str:
        """The group of meta parameter ``name`` of dict ``tree``."""
        rest = "staged" if self.meta_cfg.separate_head else "main"
        if tree == "class_net":
            pw = "predict_sep." if self.meta_cfg.separate_head else \
                "predict.conv_pw."
            return "predict" if name.startswith(pw) else rest
        return "lrs" if tree == "inner_lrs" else rest

    def init(self, meta_params: MetaParams) -> None:
        """Zero moments (adam) or traces (SGD) for every leaf."""
        self.count = 0
        self.leaves, self.state = [], {}
        keys = ("mu", "nu") if self.meta_cfg.optim == "adam" else ("trace",)
        for tree, params in meta_params.items():
            for name, p in params.items():
                group = self.label(tree, name)
                self.leaves.append((tree, name, p, group))
                if self.schedules[group] is not None:
                    self.state[tree, name] = {k: torch.zeros_like(p)
                                              for k in keys}

    @torch.no_grad()
    def step(self, grads: MetaParams) -> None:
        """One update from ``grads`` (same dicts as the parameters)."""
        g_all = [grads[tree][name].detach().clone()
                 for tree, name, _, _ in self.leaves]
        if self.meta_cfg.meta_clip:
            _clip_by_global_norm(g_all, self.meta_cfg.meta_clip)
        count = self.count
        count_inc = np.float32(count + 1)
        bc1 = float(np.float32(1) - np.float32(self.B1) ** count_inc)
        bc2 = float(np.float32(1) - np.float32(self.B2) ** count_inc)
        for (tree, name, p, group), g in zip(self.leaves, g_all):
            schedule = self.schedules[group]
            if schedule is None:
                continue
            st = self.state[tree, name]
            if self.meta_cfg.optim == "adam":
                st["mu"].copy_((1 - self.B1) * g + self.B1 * st["mu"])
                st["nu"].copy_((1 - self.B2) * (g * g) + self.B2 * st["nu"])
                u = (st["mu"] / bc1) / (torch.sqrt(st["nu"] / bc2 + 0.0)
                                        + self.EPS)
            else:
                st["trace"].copy_(g + self.MOMENTUM * st["trace"])
                u = g + self.MOMENTUM * st["trace"]
            p.add_(u * -schedule(count))
        self.count += 1


def make_meta_optimizer(meta_cfg: MetaConfig,
                        lr_lr: Optional[float] = None) -> MetaOptimizer:
    """The param-group meta optimizer with the reference's staged LR
    enable (see ``MetaOptimizer``); call ``init(meta_params)`` before
    ``step``."""
    return MetaOptimizer(meta_cfg, lr_lr=lr_lr)


def _flat(tree: MetaParams) -> List[Tuple[str, str, torch.Tensor]]:
    return [(t, n, v) for t, d in tree.items() for n, v in d.items()]


class MetaTrainer:
    """Owns the episode step and the meta-batch accumulation (the reference
    accumulates ``meta_batch_size`` episode gradients before stepping,
    infer.py:796-809).

    The meta parameters are the model's class-head parameters and the
    ProjectionNet's, updated in place, plus the inner LRs; every other
    model parameter is frozen (``requires_grad`` off). The model and the
    ProjectionNet move to ``device``: the CUDA card when None (raises
    without one)."""

    def __init__(self, model, proj_net, meta_cfg: MetaConfig,
                 model_cfg: ModelConfig, proj_level_sizes,
                 lr_lr: Optional[float] = None, device=None):
        if meta_cfg.separate_head != model_cfg.separate_head:
            raise ValueError(
                "MetaConfig.separate_head and ModelConfig.separate_head "
                "disagree: the second predict head's params exist only "
                "when the MODEL config enables it")
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.proj_net = proj_net.to(self.device)
        self.meta_cfg = meta_cfg
        self.model_cfg = model_cfg
        self.proj_level_sizes = tuple(proj_level_sizes)
        for name, p in model.named_parameters():
            p.requires_grad_(name.startswith("class_net."))
        self.meta_params: MetaParams = {
            "class_net": dict(model.class_net.named_parameters()),
            "proj": dict(proj_net.named_parameters()),
            "inner_lrs": {k: v.to(self.device).requires_grad_()
                          for k, v in init_inner_lrs(
                              model_cfg.box_class_repeats, meta_cfg.inner_lr,
                              meta_cfg.multi_inner).items()},
        }
        self.tx = make_meta_optimizer(meta_cfg, lr_lr=lr_lr)
        self.tx.init(self.meta_params)
        self.accum: Optional[List[torch.Tensor]] = None
        self._accum_count = 0
        self._accum_phase = None
        # ref_stale_proj_activs compat: the phase-B regularizer re-embeds
        # the LAST phase-A episode's activations (reference infer.py:349-359)
        self._stale_mode = (meta_cfg.ref_stale_proj_activs
                            and meta_cfg.proj_reg > 0.0)
        self._stale_proj_activs = None
        self._qry_anchors = None

    def _loss(self, batch: Dict, phase_a: bool, create_graph: bool):
        if phase_a:
            return projection_phase_loss(
                self.model, self.proj_net, self.meta_params["class_net"],
                self.meta_params["proj"], batch, self.meta_cfg,
                self.proj_level_sizes)
        if self._stale_mode and self._stale_proj_activs is None:
            raise ValueError(
                "ref_stale_proj_activs: no phase-A episode has run yet — the "
                "reference reads an undefined proj_activs in this state "
                "(infer.py:349-359); run at least one phase-A episode "
                "(proj_iters >= 1) before phase B")
        return maml_episode_loss(
            self.model, self.proj_net, self.meta_params, batch, self.meta_cfg,
            self.model_cfg, self.proj_level_sizes,
            stale_proj_activs=self._stale_proj_activs,
            create_graph=create_graph)

    def _capture_stale(self, batch: Dict, phase_a: bool) -> None:
        if phase_a and self._stale_mode:
            with torch.no_grad():
                self._stale_proj_activs = _image_features(
                    self.model, batch["proj_images"], self.meta_cfg)

    def episode_grads(self, batch: Dict, phase_a: bool
                      ) -> Tuple[torch.Tensor, Dict, List[torch.Tensor]]:
        """(loss, metrics, gradients of every meta parameter in
        ``meta_params`` order, zero where unused) of one episode."""
        with torch.enable_grad():
            loss, metrics = self._loss(batch, phase_a, create_graph=True)
            grads = torch.autograd.grad(
                loss, [v for _, _, v in _flat(self.meta_params)],
                allow_unused=True, materialize_grads=True)
        return loss.detach(), metrics, list(grads)

    def train_episode(self, batch: Dict, phase_a: bool) -> Dict:
        """Accumulate one episode's gradients; step when the meta-batch is
        full. Crossing the phase-A/B boundary mid-accumulation drops the
        partial batch: the two phases' gradients optimise different
        objectives and must not share one step."""
        self._capture_stale(batch, phase_a)
        _, metrics, grads = self.episode_grads(batch, phase_a)
        metrics = {k: v.detach() for k, v in metrics.items()}
        if self._accum_phase is not None and self._accum_phase != phase_a:
            self.accum = None
            self._accum_count = 0
        self._accum_phase = phase_a
        if self.accum is None:
            self.accum = grads
        else:
            self.accum = [a + g for a, g in zip(self.accum, grads)]
        self._accum_count += 1
        if self._accum_count >= self.meta_cfg.meta_batch_size:
            scale = 1.0 / self._accum_count
            mean = {}
            for (tree, name, _), g in zip(_flat(self.meta_params), self.accum):
                mean.setdefault(tree, {})[name] = g * scale
            self.tx.step(mean)
            self.accum = None
            self._accum_count = 0
            metrics["meta_step"] = True
        return metrics

    def eval_episode(self, batch: Dict, phase_a: bool) -> Dict:
        """Loss-only validation episode (no meta-gradient)."""
        # the reference updates proj_activs on val episodes too
        self._capture_stale(batch, phase_a)
        with torch.no_grad():
            _, metrics = self._loss(batch, phase_a, create_graph=False)
        return {k: v.detach() for k, v in metrics.items()}

    def qry_anchors(self) -> Anchors:
        """Anchors at the query resolution (``model_cfg.image_size`` may
        differ; ``EpisodeBuilder`` labels with the same override)."""
        if self._qry_anchors is None:
            self._qry_anchors = Anchors.from_config(
                self.model_cfg, img_size=self.meta_cfg.qry_img_size)
        return self._qry_anchors

    def episode_detections(self, batch: Dict) -> torch.Tensor:
        """Query detections from the inner-adapted head, for per-episode
        mAP / CorLoc (reference infer.py:689-700)."""
        return maml_episode_detections(
            self.model, self.proj_net, self.meta_params, batch,
            self.meta_cfg, self.model_cfg, self.qry_anchors())

    def episode_ood_scores(self, batch: Dict, ood_method: str = "energy"):
        """(dets, det_ood, gt_ood, gt_valid) from the adapted head (the meta
        training CLI's ``--eval-ood``)."""
        return maml_episode_ood_scores(
            self.model, self.proj_net, self.meta_params, batch,
            self.meta_cfg, self.model_cfg, self.qry_anchors(),
            ood_method=ood_method)

    def train_meta_batch_sharded(self, episodes, mesh, axis: str = "episode",
                                 phase_a: bool = False) -> Dict:
        """One meta update from a meta batch computed in parallel over
        ``mesh`` (``make_sharded_meta_step``): ``episodes`` are this
        process's share, as many on every rank (``axis`` names the mesh's
        axis, as in the JAX signature; a process-group mesh has one).
        Resets the sequential accumulator (a partial one must not leak
        into a later step) and returns the meta-batch means of the
        metrics."""
        if self._stale_mode:
            raise NotImplementedError(
                "ref_stale_proj_activs is a fidelity compat mode and is not "
                "plumbed through the sharded meta-batch step; use "
                "sequential accumulation (episode_mesh=0)")
        self.accum = None
        self._accum_count = 0
        self._accum_phase = None
        return make_sharded_meta_step(self, mesh, axis)(
            stack_episodes(episodes), phase_a=phase_a)

    @torch.no_grad()
    def adapted_variables(self, supp_images: torch.Tensor
                          ) -> Dict[str, torch.Tensor]:
        """Inference-time open-set adaptation: inner-adapt on supports and
        return the model's parameters and buffers by name with the fast
        class head in place of its own (for ``functional_call``)."""
        supp_activs = _image_features(self.model, supp_images, self.meta_cfg)
        fast_class, _ = inner_adapt(
            self.model, self.proj_net, self.meta_params["class_net"],
            self.meta_params["proj"], self.meta_params["inner_lrs"],
            supp_activs, self.meta_cfg, create_graph=False)
        out = {**dict(self.model.named_parameters()),
               **dict(self.model.named_buffers())}
        out.update({f"class_net.{n}": t.detach()
                    for n, t in fast_class.items()})
        return out


def make_sharded_meta_step(trainer: MetaTrainer, mesh, axis: str = "episode"):
    """The episode-parallel meta step (JAX's ``shard_map`` step): each
    process sums the meta-gradients and metrics of its share of the
    episodes, one all-reduce sums them over the ranks, both are divided by
    the total episode count, and every rank applies the same update: the
    sequential accumulation's semantics (``train_episode``), with
    meta_batch_size above the mesh size looping each rank's chunk. Each
    episode normalises with its own batch statistics, as in
    ``train_episode``: nothing synchronises inside an episode.

    Returns ``step(stacked_batches, phase_a=False) -> mean metrics``, the
    leading dim of ``stacked_batches`` (``stack_episodes``) this rank's
    episodes; the meta parameters and the optimizer update in place. JAX's
    step is phase B's; ``phase_a`` runs the projection phase the same
    way."""
    group = mesh.group if mesh is not None else None
    size = mesh.size if mesh is not None else 1

    def step(batches: Dict[str, torch.Tensor], phase_a: bool = False):
        e_local = next(iter(batches.values())).shape[0]
        grads = metrics = None
        for i in range(e_local):
            _, m, g = trainer.episode_grads(
                {k: v[i] for k, v in batches.items()}, phase_a)
            m = {k: v.detach().float() for k, v in m.items()}
            grads = g if grads is None else \
                [a + b for a, b in zip(grads, g)]
            metrics = m if metrics is None else \
                {k: metrics[k] + m[k] for k in m}
        keys = list(metrics)
        flat = torch.cat([g.detach().reshape(-1) for g in grads]
                         + [torch.stack([metrics[k] for k in keys])])
        if group is not None:
            flat = all_reduce_sum(flat, group)
        flat = flat / float(e_local * size)
        mean, offset = {}, 0
        for (tree, name, _), g in zip(_flat(trainer.meta_params), grads):
            n = g.numel()
            mean.setdefault(tree, {})[name] = flat[offset:offset + n].view(
                g.shape)
            offset += n
        trainer.tx.step(mean)
        return {k: flat[offset + i] for i, k in enumerate(keys)}
    return step


# Keys of an episode batch that are per-episode arrays (stackable to a
# leading meta-batch dim). 'task_cats' / 'val_iter' are host metadata.
_EPISODE_ARRAY_KEYS = (
    "supp_images", "supp_cls_lab", "qry_images", "qry_cls", "qry_box",
    "qry_num_positives", "qry_gt_bbox", "qry_gt_cls", "proj_images",
    "proj_cls", "task_cls")


def stack_episodes(episodes) -> Dict[str, torch.Tensor]:
    """Stack a list of episode batches along a leading meta-batch dim."""
    return {k: torch.stack([torch.as_tensor(e[k]) for e in episodes])
            for k in _EPISODE_ARRAY_KEYS}
