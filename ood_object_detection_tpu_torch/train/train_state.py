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

Data parallelism (a ``mesh``) and the image-H sharded leg are later
slices: ``make_train_step(mesh=...)`` raises.
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
    return detection_loss_nhwc(
        cls_out, box_out, labels.cls_targets, labels.box_targets,
        labels.num_positives, num_classes=cfg.num_classes, alpha=cfg.alpha,
        gamma=cfg.gamma, delta=cfg.delta,
        box_loss_weight=cfg.box_loss_weight,
        label_smoothing=cfg.label_smoothing, legacy_focal=cfg.legacy_focal,
        focal_modulation=cfg.focal_modulation, remat_cls=remat_cls)


def apply_gradients(state: TrainState, tx: torch.optim.Optimizer,
                    train_config: TrainConfig) -> torch.Tensor:
    """The update half of a step, on the gradients the backward left in
    the parameters' ``.grad``: global-norm clip, the learning rate of each
    param group's schedule at this step, the optimizer step, the EMA and
    the step count. Returns the unclipped gradients' global norm."""
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


def make_train_step(model: nn.Module, tx: torch.optim.Optimizer,
                    anchors: Anchors, train_config: TrainConfig, mesh=None,
                    freeze_bn: str = "none"):
    """The train step as ``step(state, batch) -> (state, metrics)`` on the
    model's device. ``mesh`` (data parallelism) is not ported yet."""
    if mesh is not None:
        raise NotImplementedError("data-parallel training (mesh=) is not "
                                  "ported yet")
    model = unwrap_bench(model)
    device = next(model.parameters()).device
    anchor_boxes = torch.from_numpy(anchors.boxes).to(device)

    def step(state: TrainState, batch: Dict[str, torch.Tensor]):
        return detection_train_step(model, tx, anchor_boxes, train_config,
                                    state, batch, freeze_bn=freeze_bn)
    return step


@torch.no_grad()
def detection_eval_step(model: nn.Module, anchor_boxes: torch.Tensor,
                        state: TrainState, batch: Dict[str, torch.Tensor],
                        use_ema: bool = True) -> Dict[str, torch.Tensor]:
    """Loss only, with running BatchNorm statistics and the EMA parameters
    (``use_ema``, when there are some): the validation loss."""
    model = unwrap_bench(model)
    labels = batch_label_anchors(anchor_boxes, batch["bbox"], batch["cls"])
    was_training = model.training
    model.eval()
    try:
        cls_out, box_out = functional_call(model, state.variables(use_ema),
                                           (batch["image"],))
    finally:
        model.train(was_training)
    total, cls_loss, box_loss = detection_loss(model.config, cls_out,
                                               box_out, labels)
    return {"loss": total, "class_loss": cls_loss, "box_loss": box_loss}
