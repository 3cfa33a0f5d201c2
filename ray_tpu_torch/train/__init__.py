"""Train steps and the optimizer. Importing this package pulls in only
the step factory and AdamW, no trainer runtime."""

from ray_tpu_torch.train.optim import AdamWConfig, adamw_init, adamw_update
from ray_tpu_torch.train.train_step import (
    TrainState,
    make_init_fn,
    make_train_step,
    value_and_grad,
)

__all__ = [
    "AdamWConfig",
    "TrainState",
    "adamw_init",
    "adamw_update",
    "make_init_fn",
    "make_train_step",
    "value_and_grad",
]
