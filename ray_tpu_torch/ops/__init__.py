"""Compute ops: attention and the fused LayerNorm/GELU kernels."""

from ray_tpu_torch.ops.attention import causal_attention, dense_causal_attention
from ray_tpu_torch.ops.fused_norm import (
    fused_gelu,
    fused_layer_norm,
    fused_layer_norm_residual,
)

__all__ = [
    "causal_attention",
    "dense_causal_attention",
    "fused_gelu",
    "fused_layer_norm",
    "fused_layer_norm_residual",
]
