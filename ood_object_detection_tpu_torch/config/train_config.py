"""Training hyperparameter config (framework-free dataclass).

A copy of ``ood_object_detection_tpu.config.train_config`` as data, kept
in this package so the port never imports the JAX package. The JAX
package's mesh, orbax-checkpoint and async-eval fields are left out: no
ported code reads them yet (data parallelism, checkpointing and the
pretrain driver are later slices, ROADMAP Queue 1).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class TrainConfig:
    # optimizer
    opt: str = "momentum"
    lr: float = 0.09
    momentum: float = 0.9
    weight_decay: float = 4e-5
    eps: float = 1e-3

    # schedule
    sched: str = "cosine"
    epochs: int = 300
    warmup_epochs: int = 5
    warmup_lr: float = 1e-4
    min_lr: float = 1e-5
    lr_noise: Optional[Tuple[float, float]] = None

    # regularization / stabilization
    clip_grad_norm: float = 10.0
    ema_decay: float = 0.9998        # moving_average_decay in the reference
    use_ema: bool = True
    # recompute each level's class focal loss in the backward pass instead
    # of keeping its residuals (torch.utils.checkpoint)
    remat_cls_loss: bool = False

    # data
    batch_size: int = 32
    max_instances_per_image: int = 100
    workers: int = 4

    # logging
    log_every_steps: int = 50


def default_detection_train_config() -> TrainConfig:
    return TrainConfig()
