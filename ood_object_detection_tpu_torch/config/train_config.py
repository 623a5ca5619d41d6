"""Training hyperparameter config (framework-free dataclass).

A copy of ``ood_object_detection_tpu.config.train_config`` as data, kept
in this package so the port never imports the JAX package; every field
and default is the JAX package's. The pretrain driver
(``train/pretrain.py``) fills ``checkpoint_dir`` from its
``--checkpoint-dir``, as the JAX driver does, and opens its checkpoints
there. The other fields of the mesh, checkpoint and eval groups are data
only, here as in the JAX package, whose drivers read none of them: the
process group comes from ``--mesh`` (``parallel.create_mesh``; a 2-D mesh
raises), and the pretrain CLI keeps 3 torch checkpoints
(``train/checkpoint.py``, always written synchronously), evaluates every
``--val-freq`` steps and saves when the val loss improves and at the end.
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

    # data parallelism
    mesh_shape: Tuple[int, ...] = (-1,)     # -1 = all devices on the data axis
    mesh_axis_names: Tuple[str, ...] = ("data",)

    # checkpointing
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_steps: int = 1000
    keep_checkpoints: int = 5
    async_checkpoint: bool = True

    # eval
    eval_every_steps: int = 500
    eval_metric: str = "map"

    # logging
    log_every_steps: int = 50


def default_detection_train_config() -> TrainConfig:
    return TrainConfig()
