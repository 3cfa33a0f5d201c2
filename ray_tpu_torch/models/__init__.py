"""Models as plain functions over nested-dict parameter trees."""

from ray_tpu_torch.models.gpt2 import (
    GPT2Config,
    gpt2_forward,
    gpt2_init,
    gpt2_loss,
)
from ray_tpu_torch.models.llama import (
    LlamaConfig,
    llama_flops_per_token,
    llama_forward,
    llama_init,
    llama_loss,
)
from ray_tpu_torch.models.moe import (
    MoEConfig,
    moe_forward,
    moe_init,
    moe_loss,
)

__all__ = ["GPT2Config", "gpt2_forward", "gpt2_init", "gpt2_loss",
           "LlamaConfig", "llama_flops_per_token", "llama_forward",
           "llama_init", "llama_loss", "MoEConfig", "moe_forward",
           "moe_init", "moe_loss"]
