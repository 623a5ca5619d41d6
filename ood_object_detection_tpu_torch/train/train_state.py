"""Train state and the single-device train / eval steps (port of
``ood_object_detection_tpu.train.train_state``).

One step: anchor labels on the images' device (K3 / K4 on the card) ->
forward with the BatchNorm of the ``freeze_bn`` scope frozen -> the
per-level NHWC focal + huber loss -> backward -> global-norm clip ->
optimizer update -> EMA of the parameters.

Where the JAX package builds new pytrees, the port updates in place: the
step changes the model's parameters and BatchNorm statistics, the
optimizer's state and the EMA copy, and returns the same ``TrainState``.
The optimizer is a ``torch.optim`` optimizer chosen to match optax update
for update: momentum SGD is ``torch.optim.SGD`` with no dampening,
nesterov or weight decay (optax's trace ``t = g + m * t`` starts at zero,
torch's buffer at the first gradient: the same first step); adam /
adamw put eps outside the square root after bias correction and decay
decoupled from the gradient, as optax does. The clip is optax's
``clip_by_global_norm``, written out: ``g / norm * max_norm`` only when
``norm >= max_norm`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the
norm and scales always). A learning-rate schedule is a function of the
step, kept in the param group as ``lr_schedule``.

Stochastic depth: with the backbone's ``drop_path_rate > 0`` each step
draws its drop masks from a ``torch.Generator`` on the images' device,
seeded from (``DROP_PATH_SEED``, step): the JAX step's
``fold_in(key(0x0D10), step)``, a different block subset every step and
the same one again under resume. The masks cannot be bit-equal to JAX's.

Data parallelism (``make_train_step(mesh=...)`` with a launched
``parallel.create_mesh``): each process labels its own rows (K3 / K4 on
its card) and the step computes what the one-process step computes on
the global batch, rank r's rows the r-th block, as the JAX mesh step
does. The train-mode BatchNorm moments are the global batch's
(``parallel.synced_batch_norms``); the positives are summed over the
ranks before the loss, so each rank's loss is its share of the global
loss; the gradients are summed (one all-reduce of a flat buffer), then
clipped by their global norm, and every rank steps the optimizer and the
EMA alike.

The image-H leg (``make_train_step(mesh=create_mesh((D, S), ("data",
"spatial")), spatial_axis="spatial")``): the ``S`` ranks of a data block
hold its full images and split their rows (``parallel/spatial.py``).
Each rank labels its block's images over all anchors (K3 / K4, so that
each row's force-match spans the image), sums the positives over its
data group (the ``S`` ranks of a block share them), runs the model on its
rows of the images, and takes the loss of the anchors on its rows: a
level whose maps split keeps the rank's rows of anchors (the anchors are
level-major, then row, column and anchor config, so they are one range a
level); a level computed whole (too short to split) counts on spatial
index 0 alone. Losses and gradients are summed over every rank, the norm
moments are the whole mesh's, and the update is the data-parallel one.
One step, ``mesh_train_step``, runs both meshes: on a 1-D mesh the data
group is every rank and each rank computes all the rows of its images.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..bench import unwrap_bench
from ..config.train_config import TrainConfig
from ..models.efficientdet import EfficientDet
from ..ops.anchors import Anchors
from ..ops.losses import detection_loss_nhwc
from ..ops.target_assigner import LabelResult, batch_label_anchors
from ..parallel.mesh import Mesh, all_reduce_sum, synced_batch_norms
from ..parallel.spatial import spatially_sharded
from ..utils.profiling import span

LrSchedule = Union[float, Callable[[int], float]]
PARAM_GROUPS = ("backbone", "fpn", "heads")
# the stochastic-depth stream of the train step (the JAX step's key 0x0D10)
DROP_PATH_SEED = 0x0D10


def drop_path_generator(model: EfficientDet, step: int,
                        device: torch.device) -> Optional[torch.Generator]:
    """The generator of train step ``step``'s drop masks on ``device``,
    seeded from (DROP_PATH_SEED, step); None when the backbone drops
    nothing (``drop_path_rate`` 0)."""
    rate = float((model.config.backbone_args or {}).get("drop_path_rate",
                                                        0.0))
    if rate <= 0.0:
        return None
    return torch.Generator(device=device).manual_seed(
        (DROP_PATH_SEED << 32) + int(step))


@dataclasses.dataclass
class TrainState:
    """The step count, the model (parameters and BatchNorm statistics),
    its optimizer, and the EMA copy of the parameters (not of the
    BatchNorm statistics): parameter name -> tensor, or None."""
    step: int
    model: EfficientDet
    optimizer: torch.optim.Optimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None

    def variables(self, use_ema: bool = False) -> Dict[str, torch.Tensor]:
        """Parameters (the EMA copy with ``use_ema``, when there is one) and
        buffers by name, for ``torch.func.functional_call``."""
        params = dict(self.model.named_parameters())
        if use_ema and self.ema_params is not None:
            params = self.ema_params
        return {**params, **dict(self.model.named_buffers())}


def _base_tx(train_config: TrainConfig, param_groups) -> torch.optim.Optimizer:
    """The optimizer over ``param_groups`` (dicts with 'params', 'lr' and
    'lr_schedule'), without the clip (the train step applies it)."""
    opt_name = train_config.opt
    if opt_name == "momentum":
        return torch.optim.SGD(param_groups, lr=train_config.lr,
                               momentum=train_config.momentum, dampening=0.0,
                               nesterov=False, weight_decay=0.0)
    if opt_name == "adam":
        return torch.optim.Adam(param_groups, lr=train_config.lr,
                                eps=train_config.eps, weight_decay=0.0)
    if opt_name == "adamw":
        return torch.optim.AdamW(param_groups, lr=train_config.lr,
                                 eps=train_config.eps,
                                 weight_decay=train_config.weight_decay)
    raise ValueError(f"unknown optimizer {opt_name}")


def _group(params, lr: LrSchedule) -> Dict:
    schedule = lr if callable(lr) else None
    return {"params": list(params),
            "lr": float(schedule(0) if schedule else lr),
            "lr_schedule": schedule}


def make_optimizer(train_config: TrainConfig, model: nn.Module,
                   lr_schedule: Optional[Callable[[int], float]] = None
                   ) -> torch.optim.Optimizer:
    """The optimizer of ``train_config.opt`` over every parameter of the
    model, at ``lr_schedule(step)`` or the constant ``train_config.lr``."""
    lr = lr_schedule if lr_schedule is not None else train_config.lr
    return _base_tx(train_config, [_group(model.parameters(), lr)])


def param_group_labels(model: nn.Module) -> Dict[str, str]:
    """Each parameter name -> 'backbone' / 'fpn' / 'heads' by its top-level
    module (the reference's optimizer param groups, pretrain.py:179-187)."""
    def top_label(name: str) -> str:
        top = name.split(".", 1)[0]
        return top if top in ("backbone", "fpn") else "heads"
    return {name: top_label(name) for name, _ in model.named_parameters()}


def make_grouped_optimizer(train_config: TrainConfig,
                           group_schedules: Dict[str, LrSchedule],
                           model: nn.Module) -> torch.optim.Optimizer:
    """One torch param group per module group ('backbone', 'fpn',
    'heads'), each at its own schedule (or constant lr): the reference's
    per-group learning rates (pretrain.py:179-187, 279-281)."""
    labels = param_group_labels(model)
    named = dict(model.named_parameters())
    groups = [_group([p for n, p in named.items() if labels[n] == g], lr)
              for g, lr in group_schedules.items()]
    covered = sum(len(g["params"]) for g in groups)
    if covered != len(named):
        raise ValueError(f"group_schedules {sorted(group_schedules)} cover "
                         f"{covered} of {len(named)} parameters; give all "
                         f"of {PARAM_GROUPS}")
    return _base_tx(train_config, groups)


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """optax ``linear_schedule``: ``init_value`` moving linearly to
    ``end_value`` over ``transition_steps`` steps, then constant; computed
    in f32 as optax computes it."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = np.float32(1) - np.float32(min(max(count, 0),
                                              transition_steps)) \
            / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac
                     + np.float32(end_value))
    return schedule


def cosine_lr_schedule(train_config: TrainConfig,
                       steps_per_epoch: int) -> Callable[[int], float]:
    """Linear warm-up from ``warmup_lr`` to ``lr`` over the warm-up epochs,
    then cosine decay to ``min_lr`` (optax ``linear_schedule`` +
    ``cosine_decay_schedule`` joined at the warm-up boundary)."""
    tc = train_config
    warmup_steps = tc.warmup_epochs * steps_per_epoch
    decay_steps = max(1, (tc.epochs - tc.warmup_epochs) * steps_per_epoch)
    alpha = tc.min_lr / tc.lr

    def warmup(count: int) -> float:
        if warmup_steps <= 0:
            return tc.warmup_lr
        frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
        return (tc.warmup_lr - tc.lr) * frac + tc.lr

    def cosine(count: int) -> float:
        count = min(count, decay_steps)
        cosine_decay = 0.5 * (1 + math.cos(math.pi * count / decay_steps))
        return tc.lr * ((1 - alpha) * cosine_decay + alpha)

    def schedule(step: int) -> float:
        return warmup(step) if step < warmup_steps else \
            cosine(step - warmup_steps)

    return schedule


def create_train_state(model: nn.Module, train_config: TrainConfig,
                       lr_schedule: Optional[Callable[[int], float]] = None,
                       tx: Optional[torch.optim.Optimizer] = None
                       ) -> Tuple[TrainState, torch.optim.Optimizer]:
    """(TrainState at step 0, its optimizer) for an initialised model (or a
    bench around one, e.g. ``create_model(..., bench_task='train')``). The
    optimizer is ``tx`` or ``make_optimizer``'s; the EMA copy starts equal
    to the parameters when ``train_config.use_ema``."""
    model = unwrap_bench(model)
    if tx is None:
        tx = make_optimizer(train_config, model, lr_schedule)
    ema = None
    if train_config.use_ema:
        ema = {n: p.detach().clone() for n, p in model.named_parameters()}
    return TrainState(step=0, model=model, optimizer=tx, ema_params=ema), tx


def _clip_by_global_norm(grads, max_norm: float) -> torch.Tensor:
    """optax ``clip_by_global_norm`` in place on ``grads``; returns the
    global norm of the unclipped gradients (a device scalar, no sync)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    if max_norm:
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * max_norm))
    return norm


@torch.no_grad()
def _update_ema(state: TrainState, decay: float) -> None:
    """``e = e * d + p * (1 - d)`` with the warm-up-corrected decay
    ``d = min(decay, (1 + n) / (10 + n))``, n the step count after this
    step, computed in f32 as the JAX step does."""
    step_f = np.float32(state.step) + np.float32(1.0)
    d = min(np.float32(decay), (np.float32(1.0) + step_f)
            / (np.float32(10.0) + step_f))
    one_minus = np.float32(1.0) - d
    for name, p in state.model.named_parameters():
        e = state.ema_params[name]
        e.copy_(e * float(d) + p * float(one_minus))


def detection_loss(cfg, cls_out, box_out, labels: LabelResult,
                   remat_cls: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(total, class, box) loss of per-level head outputs against flat
    labels, with the model config's loss settings."""
    with span("odt.loss"):
        return detection_loss_nhwc(
            cls_out, box_out, labels.cls_targets, labels.box_targets,
            labels.num_positives, num_classes=cfg.num_classes,
            alpha=cfg.alpha, gamma=cfg.gamma, delta=cfg.delta,
            box_loss_weight=cfg.box_loss_weight,
            label_smoothing=cfg.label_smoothing,
            legacy_focal=cfg.legacy_focal,
            focal_modulation=cfg.focal_modulation, remat_cls=remat_cls)


def apply_gradients(state: TrainState, tx: torch.optim.Optimizer,
                    train_config: TrainConfig) -> torch.Tensor:
    """The update half of a step, on the gradients the backward left in
    the parameters' ``.grad``: global-norm clip, the learning rate of each
    param group's schedule at this step, the optimizer step, the EMA and
    the step count. Returns the unclipped gradients' global norm."""
    with span("odt.update"):
        params = list(state.model.parameters())
        for p in params:
            if p.grad is None:          # optax sees a zero gradient
                p.grad = torch.zeros_like(p)
        with torch.no_grad():
            grad_norm = _clip_by_global_norm([p.grad for p in params],
                                             train_config.clip_grad_norm)
        for group in tx.param_groups:
            if group.get("lr_schedule") is not None:
                group["lr"] = float(group["lr_schedule"](state.step))
        tx.step()
        if state.ema_params is not None:
            _update_ema(state, train_config.ema_decay)
        state.step += 1
        return grad_norm


def detection_train_step(model: EfficientDet, tx: torch.optim.Optimizer,
                         anchor_boxes: torch.Tensor,
                         train_config: TrainConfig, state: TrainState,
                         batch: Dict[str, torch.Tensor],
                         freeze_bn: str = "none"
                         ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """One train step on ``batch`` {'image' [B, H, W, 3] float, 'bbox'
    [B, M, 4] yxyx, 'cls' [B, M] int (pad -1)}, updating ``state`` in
    place. ``freeze_bn``: 'none' | 'backbone' | 'all', the BatchNorm scope
    that uses and keeps its running statistics. Returns (state, metrics:
    loss, class_loss, box_loss, num_positives, grad_norm of the unclipped
    gradients), the metrics as device scalars."""
    labels = batch_label_anchors(anchor_boxes, batch["bbox"], batch["cls"])
    model.train_bn(freeze_bn)
    image = batch["image"]
    cls_out, box_out = model(image, drop_path_generator(model, state.step,
                                                        image.device))
    total, cls_loss, box_loss = detection_loss(
        model.config, cls_out, box_out, labels,
        remat_cls=train_config.remat_cls_loss)
    with span("odt.backward"):
        tx.zero_grad()
        total.backward()
    grad_norm = apply_gradients(state, tx, train_config)
    metrics = {
        "loss": total.detach(),
        "class_loss": cls_loss.detach(),
        "box_loss": box_loss.detach(),
        "num_positives": torch.sum(labels.num_positives),
        "grad_norm": grad_norm,
    }
    return state, metrics


def sum_gradients(params, mesh: Mesh) -> None:
    """Each parameter's ``.grad`` summed over the mesh's ranks in place
    (one all-reduce of a flat buffer); a missing gradient counts as
    zero, as ``apply_gradients`` takes it."""
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = all_reduce_sum(torch.cat([g.reshape(-1) for g in grads]),
                          mesh.group)
    offset = 0
    for p, g in zip(params, grads):
        n = g.numel()
        g.copy_(flat[offset:offset + n].view(g.shape))
        p.grad = g
        offset += n


def _level_anchor_ranges(cls_out, anchors: Anchors, index: int):
    """For each level's local class output [B, h, W, A*C]: (the range of
    flat anchor indices it holds, whether the level is whole), the rank's
    rows of a split level, all of a whole one."""
    ranges, offset = [], 0
    for lvl, (height, width) in zip(
            cls_out, anchors.feat_sizes[anchors.min_level:]):
        per_row = width * len(anchors.aspect_ratios) * anchors.num_scales
        rows = lvl.shape[1]
        whole = rows == height
        start = offset if whole else offset + index * rows * per_row
        ranges.append((slice(start, start + rows * per_row), whole))
        offset += height * per_row
    return ranges


def spatial_loss(cfg, cls_out, box_out, labels: LabelResult,
                 anchors: Anchors, index: int, remat_cls: bool = False
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's share of the (total, class, box) loss over its rows of
    the levels' outputs: the anchors of its rows of each split level,
    and the anchors of each whole level on spatial index 0 (weight 0 on
    the others, so that their backward still runs), against the global
    positives of ``labels``. Unsplit (every level whole, index 0) it is
    ``detection_loss`` of every anchor."""
    ranges = _level_anchor_ranges(cls_out, anchors, index)
    parts = []
    for whole in (False, True):
        keep = [i for i, (_, w) in enumerate(ranges) if w == whole]
        if not keep:
            continue
        part = labels if len(keep) == len(ranges) and whole else \
            dataclasses.replace(
                labels,
                cls_targets=torch.cat([labels.cls_targets[:, ranges[i][0]]
                                       for i in keep], dim=1),
                box_targets=torch.cat([labels.box_targets[:, ranges[i][0]]
                                       for i in keep], dim=1))
        losses = detection_loss(cfg, [cls_out[i] for i in keep],
                                [box_out[i] for i in keep], part,
                                remat_cls=remat_cls)
        if whole and index != 0:
            losses = [loss * 0.0 for loss in losses]
        parts.append(losses)
    totals = parts[0]
    for losses in parts[1:]:
        totals = [a + b for a, b in zip(totals, losses)]
    return tuple(totals)


def mesh_train_step(model: EfficientDet, tx: torch.optim.Optimizer,
                    anchors: Anchors, anchor_boxes: torch.Tensor,
                    train_config: TrainConfig, mesh: Mesh,
                    state: TrainState, batch: Dict[str, torch.Tensor],
                    freeze_bn: str = "none"
                    ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
    """``detection_train_step`` on a launched mesh: ``batch`` is this
    rank's data block (``shard_batch``), full images, of which the rank
    computes its rows on a 2-D mesh and all on a 1-D one (the module
    docstring). The same update on every rank, the global metrics."""
    labels = batch_label_anchors(anchor_boxes, batch["bbox"], batch["cls"])
    positives = all_reduce_sum(torch.sum(labels.num_positives).float()
                               .reshape(1), mesh.data_group)
    labels = dataclasses.replace(labels, num_positives=positives)
    model.train_bn(freeze_bn)
    image = batch["image"]
    index = mesh.spatial_index
    rows = image.shape[1] // mesh.spatial_size
    local = image[:, index * rows:(index + 1) * rows]
    with synced_batch_norms(model, mesh), \
            spatially_sharded(model, mesh, image.shape[1:3]):
        cls_out, box_out = model(local, drop_path_generator(
            model, state.step, image.device))
        total, cls_loss, box_loss = spatial_loss(
            model.config, cls_out, box_out, labels, anchors, index,
            remat_cls=train_config.remat_cls_loss)
        with span("odt.backward"):
            tx.zero_grad()
            total.backward()
    with span("odt.mesh.grad_all_reduce"):
        sum_gradients(list(model.parameters()), mesh)
    grad_norm = apply_gradients(state, tx, train_config)
    losses = all_reduce_sum(torch.stack([total, cls_loss, box_loss])
                            .detach(), mesh.group)
    metrics = {
        "loss": losses[0],
        "class_loss": losses[1],
        "box_loss": losses[2],
        "num_positives": positives[0],
        "grad_norm": grad_norm,
    }
    return state, metrics


def make_train_step(model: nn.Module, tx: torch.optim.Optimizer,
                    anchors: Anchors, train_config: TrainConfig,
                    mesh: Optional[Mesh] = None, freeze_bn: str = "none",
                    spatial_axis: Optional[str] = None):
    """The train step as ``step(state, batch) -> (state, metrics)`` on the
    model's device. With a ``mesh`` of a launched group
    (``parallel.create_mesh`` under torchrun) ``batch`` is this rank's
    rows and the step is ``mesh_train_step``; a 2-D mesh takes
    ``spatial_axis`` (its second axis' name, the JAX keyword), the axis
    the images' rows split over. A mesh of one process outside torchrun
    is the one-process step."""
    model = unwrap_bench(model)
    device = next(model.parameters()).device
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)
    if mesh is not None and (spatial_axis is not None
                             or len(mesh.axis_names) > 1):
        if len(mesh.axis_names) != 2 or mesh.axis_names[1] != spatial_axis:
            raise ValueError(
                f"spatial_axis {spatial_axis!r} on a mesh of axes "
                f"{mesh.axis_names}: the image-H leg takes a 2-D mesh "
                "whose second axis is spatial_axis")

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        if mesh is not None and mesh.distributed:
            return mesh_train_step(model, tx, anchors, anchor_boxes,
                                   train_config, mesh, state, batch,
                                   freeze_bn=freeze_bn)
        return detection_train_step(model, tx, anchor_boxes, train_config,
                                    state, batch, freeze_bn=freeze_bn)
    return step


@torch.no_grad()
def detection_eval_step(model: nn.Module, anchor_boxes: torch.Tensor,
                        state: TrainState, batch: Dict[str, torch.Tensor],
                        use_ema: bool = True, mesh: Optional[Mesh] = None
                        ) -> Dict[str, torch.Tensor]:
    """Loss only, with running BatchNorm statistics and the EMA parameters
    (``use_ema``, when there are some): the validation loss. With a
    launched ``mesh``, ``batch`` is this rank's rows and the losses are
    the global batch's (positives and losses summed over the ranks), as
    the JAX eval step over the mesh gives them."""
    model = unwrap_bench(model)
    labels = batch_label_anchors(anchor_boxes, batch["bbox"], batch["cls"])
    if mesh is not None and mesh.distributed:
        labels = dataclasses.replace(labels, num_positives=all_reduce_sum(
            torch.sum(labels.num_positives).float().reshape(1), mesh.group))
    was_training = model.training
    model.eval()
    try:
        cls_out, box_out = functional_call(model, state.variables(use_ema),
                                           (batch["image"],))
    finally:
        model.train(was_training)
    total, cls_loss, box_loss = detection_loss(model.config, cls_out,
                                               box_out, labels)
    if mesh is not None and mesh.distributed:
        total, cls_loss, box_loss = all_reduce_sum(
            torch.stack([total, cls_loss, box_loss]), mesh.group)
    return {"loss": total, "class_loss": cls_loss, "box_loss": box_loss}
