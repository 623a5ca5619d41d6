"""Train state and the single-device train / eval steps. The JAX
package's checkpoint manager waits for a later slice."""
from .train_state import (
    TrainState,
    cosine_lr_schedule,
    create_train_state,
    detection_eval_step,
    detection_train_step,
    make_grouped_optimizer,
    make_optimizer,
    make_train_step,
    param_group_labels,
)

__all__ = [
    "TrainState", "cosine_lr_schedule", "create_train_state",
    "detection_eval_step", "detection_train_step", "make_grouped_optimizer",
    "make_optimizer", "make_train_step", "param_group_labels",
]
