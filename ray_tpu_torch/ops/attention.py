"""Attention ops (port of ``ray_tpu/ops/attention.py``).

``causal_attention`` dispatches between:

* ``dense_causal_attention``, the counterpart of ``xla_causal_attention``:
  plain PyTorch, fp32 scores and softmax, probabilities cast to
  ``q.dtype`` -- always right, and the CPU default;
* ``flash_causal_attention`` (``ops/flash_attention.py``), the hand-written
  CUDA flash kernels on a GPU; on the CPU the same autograd Function over
  the kernels' plain versions, as the JAX package runs flash in interpret
  mode there.

The choice is made before anything is launched. Unlike the JAX package,
nothing falls back to dense after a flash call fails: a request the kernels
cannot take raises.

The serving half (``cache_write_token``, ``cache_write_prompt``,
``cached_decode_attention``) is shared by both models' decode steps; it is
plain PyTorch, as the reference is plain XLA. The cache writes update the
cache in place (the reference's donated buffer), with index writes that a
CUDA graph captures.
"""

from __future__ import annotations

import torch

from ray_tpu_torch.ops.flash_attention import HEAD_DIMS, flash_causal_attention

# Sequence length at which ``use_flash=None`` picks flash on a GPU. Kept at
# the JAX package's value, so the model's default config runs the kernels at
# seq 1024. Measured crossover (chip_smoke.py phase 3, forward plus backward,
# B*H = 96, D = 64, bf16, NVIDIA H100 80GB HBM3 at 700 W): flash 0.22 ms vs
# dense 1.06 ms at T = 512, 0.57 vs 3.71 at 1024, 1.60 vs 13.9 at 2048 --
# flash is already faster at 512, so the threshold is to be set anew, lower,
# from a sweep that also covers T < 512.
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


def _flash_by_default(q) -> bool:
    """``use_flash=None``: flash on a GPU at T >= _FLASH_MIN_SEQ for the
    head dims and dtype the kernels take; dense otherwise (always on the
    CPU, as in the JAX package)."""
    return (q.is_cuda and q.shape[1] >= _FLASH_MIN_SEQ
            and q.shape[-1] in HEAD_DIMS and q.dtype == torch.bfloat16)


def causal_attention(q, k, v, *, softmax_scale: float | None = None,
                     use_flash: bool | None = None):
    """[B, T, H, D] causal attention. ``use_flash=True`` takes the flash
    path on any device; ``None`` resolves by ``_flash_by_default``."""
    if use_flash is None:
        use_flash = _flash_by_default(q)
    if use_flash:
        return flash_causal_attention(q, k, v, softmax_scale=softmax_scale)
    return dense_causal_attention(q, k, v, softmax_scale=softmax_scale)


# -- KV-cache writes and cached attention (serving decode path) -------------


def take_rows(table, idx):
    """``table[idx]`` with the JAX package's gather semantics, for token
    ids from outside the program: a negative index wraps once, then every
    index is clamped into ``[0, len(table))``. A raw out-of-range index
    would raise on the CPU and trip a device-side assert on the GPU, which
    leaves the CUDA context unusable for the whole engine."""
    n = table.shape[0]
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    return table[idx]


def cache_write_token(cache, rows, cursor):
    """Per-slot ring-cursor write of ONE token's K or V rows, in place.

    cache [S, L, H, hd], rows [S, 1, H, hd], cursor [S] int -- each slot's
    row lands at its own cursor (``cursor`` < L). Returns ``cache``."""
    slots = torch.arange(cache.shape[0], device=cache.device)
    cache[slots, cursor] = rows[:, 0].to(cache.dtype)
    return cache


def cache_write_prompt(cache, rows, slots):
    """Prefill-lane write, in place: row block ``rows[i]`` ([P, H, hd])
    lands at rows ``[0, P)`` of cache slot ``slots[i]``. Returns ``cache``.

    One vectorised write where the reference loops in order: the engine's
    rows target distinct slots, except the unused rows, which all target
    its scratch slot -- there the write that wins is unspecified, and
    nothing reads that slot."""
    cache[slots, :rows.shape[1]] = rows.to(cache.dtype)
    return cache


def cached_decode_attention(q, k, v, valid, out_dtype):
    """One query token per slot over the slot's ring-cache window.

    q [S, H, hd]; k, v [S, L, H, hd] (GQA callers expand the KV heads to
    the query heads first); valid [S] = live cache entries (the ring
    mask). Scores and softmax in fp32 on the upcast operands, masked
    places at -1e30; the output cast to ``out_dtype``."""
    hd = q.shape[-1]
    scores = torch.einsum("shd,slhd->shl", q.float(), k.float()) / hd ** 0.5
    mask = (torch.arange(k.shape[1], device=k.device)[None, :]
            < valid[:, None])  # [S, L]
    weights = torch.softmax(
        torch.where(mask[:, None, :], scores, -1e30), dim=-1)
    out = torch.einsum("shl,slhd->shd", weights, v.float())
    return out.to(out_dtype)
