"""Compute ops: attention (dense and flash), sequence-parallel attention
(ring and Ulysses), the fused LayerNorm, RMSNorm and GELU kernels, and the
mixture-of-experts FFN."""

from ray_tpu_torch.ops.attention import causal_attention, dense_causal_attention
from ray_tpu_torch.ops.flash_attention import flash_causal_attention
from ray_tpu_torch.ops.fused_norm import (
    fused_gelu,
    fused_layer_norm,
    fused_layer_norm_residual,
    fused_rms_norm,
    fused_rms_norm_residual,
)
from ray_tpu_torch.ops.moe import init_moe_params, moe_ffn, moe_ffn_ep
from ray_tpu_torch.ops.ring_attention import (
    ring_causal_attention,
    ring_causal_attention_local,
    ring_flash_attention_local,
)
from ray_tpu_torch.ops.ulysses import ulysses_attention, ulysses_attention_local

__all__ = [
    "causal_attention",
    "dense_causal_attention",
    "flash_causal_attention",
    "fused_gelu",
    "fused_layer_norm",
    "fused_layer_norm_residual",
    "fused_rms_norm",
    "fused_rms_norm_residual",
    "init_moe_params",
    "moe_ffn",
    "moe_ffn_ep",
    "ring_causal_attention",
    "ring_causal_attention_local",
    "ring_flash_attention_local",
    "ulysses_attention",
    "ulysses_attention_local",
]
