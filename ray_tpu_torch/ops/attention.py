"""Causal attention, training half (port of ``ray_tpu/ops/attention.py:29-73``).

``dense_causal_attention`` is the counterpart of ``xla_causal_attention``:
plain PyTorch, fp32 scores and softmax, probabilities cast to ``q.dtype``.
The flash kernels are ported in a later slice; until then a call that asks
for flash, by name or by the ``None`` default resolving to it, raises.
"""

from __future__ import annotations

import torch

# Sequence length at which ``use_flash=None`` picks flash on a GPU. Carried
# over from the JAX package; it is to be set anew from GPU measurements when
# the flash kernels are ported.
_FLASH_MIN_SEQ = 1024


def dense_causal_attention(q, k, v, *, softmax_scale: float | None = None):
    """Causal multi-head attention. q, k, v and the result are
    [batch, seq, heads, head_dim]. Scores are taken in fp32 on the upcast
    operands (exact), as JAX's ``preferred_element_type=float32``."""
    t, d = q.shape[1], q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    # The scale goes on q, not on the T/D times larger [B, H, T, T] scores:
    # the same product, exactly so when the scale is a power of two
    # (head_dim 64 -> 1/8), else up to rounding.
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float() * scale, k.float())
    mask = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def causal_attention(q, k, v, *, softmax_scale: float | None = None,
                     use_flash: bool | None = None):
    """[B, T, H, D] causal attention. ``use_flash=None`` resolves to flash
    on a GPU at T >= 1024 and to dense otherwise (always dense on the CPU,
    as in the JAX package)."""
    if use_flash is None:
        use_flash = q.is_cuda and q.shape[1] >= _FLASH_MIN_SEQ
    if use_flash:
        raise NotImplementedError(
            "flash attention is ported in a later slice; pass use_flash=False")
    return dense_causal_attention(q, k, v, softmax_scale=softmax_scale)
