"""Models as plain functions over nested-dict parameter trees."""

from ray_tpu_torch.models.gpt2 import (
    GPT2Config,
    gpt2_forward,
    gpt2_init,
    gpt2_loss,
)

__all__ = ["GPT2Config", "gpt2_forward", "gpt2_init", "gpt2_loss"]
