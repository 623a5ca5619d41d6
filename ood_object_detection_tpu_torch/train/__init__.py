"""Train state, the single-device train / eval steps and the torch
checkpoints with true resume (the ``pretrain`` CLI is
``python -m ood_object_detection_tpu_torch.train.pretrain``)."""
from .checkpoint import CheckpointManager, restore_variables, save_variables
from .train_state import (
    TrainState,
    cosine_lr_schedule,
    create_train_state,
    detection_eval_step,
    detection_train_step,
    linear_schedule,
    make_grouped_optimizer,
    make_optimizer,
    make_train_step,
    param_group_labels,
)

__all__ = [
    "CheckpointManager", "TrainState", "cosine_lr_schedule",
    "create_train_state", "detection_eval_step", "detection_train_step",
    "linear_schedule", "make_grouped_optimizer", "make_optimizer",
    "make_train_step", "param_group_labels", "restore_variables",
    "save_variables",
]
