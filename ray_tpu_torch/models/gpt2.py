"""GPT-2 in PyTorch, training half (port of ``ray_tpu/models/gpt2.py``).

Parameters are a nested dict with the JAX package's key names and stacked
``[n_layer, ...]`` block leaves (``gpt2_param_axes`` there), so a JAX
parameter tree converted through numpy (``models/convert.py``) loads as it
is. Compute is in ``cfg.dtype`` (bf16), parameters and the loss in fp32.

What differs from the JAX module, and why:

* ``scan_layers`` is accepted and ignored: the layers run as a Python loop
  over per-layer views of the stacked leaves (PyTorch runs eagerly; there
  is no trace to shorten).
* ``with_logical_constraint`` is dropped: this slice runs on one device.
* ``remat`` maps onto ``torch.utils.checkpoint`` per block: ``True`` saves
  nothing inside the block, ``"dots"`` saves only ``aten.mm``/``aten.addmm``
  outputs (the four projections, as ``dots_with_no_batch_dims_saveable``;
  the attention products are recomputed), ``False`` saves everything.
* Where JAX multiplies bf16 operands with ``preferred_element_type=float32``
  the product is taken in fp32 on the upcast operands (the upcast is exact).
* ``attention_impl`` other than ``"auto"`` raises: ring and Ulysses
  attention are later slices.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.fused_norm import (
    fused_gelu,
    fused_layer_norm,
    fused_layer_norm_residual,
    ref_gelu,
    ref_layer_norm,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50304  # 50257 padded to a multiple of 128
    n_layer: int = 12
    n_head: int = 12
    d_model: int = 768
    seq_len: int = 1024
    dtype: torch.dtype = torch.bfloat16  # activation/compute dtype
    param_dtype: torch.dtype = torch.float32
    # True: full per-block recompute; "dots": save matmul outputs only;
    # False: save everything.
    remat: Any = True
    scan_layers: bool = True  # accepted for parity; layers always loop
    use_flash: bool | None = None  # None = auto by seq_len and device
    attention_impl: str = "auto"
    # LM-head matmul output dtype; None = fp32 logits. The CE reductions
    # run in fp32 either way.
    logits_dtype: torch.dtype | None = None
    # LayerNorm(+residual) and GELU through the CUDA kernels of
    # ops/fused_norm.py (forward and backward).
    fused_norm: bool = False
    # Cross-entropy over vocab chunks (>1 enables): an online logsumexp over
    # [V/n, D] slices of the tied head, each chunk recomputed in backward, so
    # the [B, T, V] logits never exist at once. Must divide vocab_size.
    ce_vocab_chunks: int = 1

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def n_params(self) -> int:
        """Parameter count (tied embeddings)."""
        d, l, v, s = self.d_model, self.n_layer, self.vocab_size, self.seq_len
        per_layer = 12 * d * d + 13 * d  # qkv+proj+mlp weights & biases + 2 LN
        return v * d + s * d + l * per_layer + 2 * d

    @classmethod
    def small(cls) -> "GPT2Config":
        return cls()  # 124M

    @classmethod
    def tiny(cls) -> "GPT2Config":
        """CPU-test sized."""
        return cls(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64)


def gpt2_init(generator: torch.Generator, cfg: GPT2Config, *,
              device=None) -> Params:
    """GPT-2 init: normal(0.02), residual projections scaled by 1/sqrt(2L).
    Draws on ``generator``'s device, then moves to ``device``."""
    device = resolve_device(device)
    d, l, v, s = cfg.d_model, cfg.n_layer, cfg.vocab_size, cfg.seq_len
    pd = cfg.param_dtype
    std = 0.02
    resid_std = std / math.sqrt(2 * l)

    def norm(shape, stddev):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * stddev
        return x.to(device=device, dtype=pd)

    def full(shape, value):
        return torch.full(shape, value, dtype=pd, device=device)

    return {
        "wte": norm((v, d), std),
        "wpe": norm((s, d), std),
        "blocks": {
            "ln1_scale": full((l, d), 1.0),
            "ln1_bias": full((l, d), 0.0),
            "attn_qkv_w": norm((l, d, 3 * d), std),
            "attn_qkv_b": full((l, 3 * d), 0.0),
            "attn_out_w": norm((l, d, d), resid_std),
            "attn_out_b": full((l, d), 0.0),
            "ln2_scale": full((l, d), 1.0),
            "ln2_bias": full((l, d), 0.0),
            "mlp_in_w": norm((l, d, 4 * d), std),
            "mlp_in_b": full((l, 4 * d), 0.0),
            "mlp_out_w": norm((l, 4 * d, d), resid_std),
            "mlp_out_b": full((l, d), 0.0),
        },
        "lnf_scale": full((d,), 1.0),
        "lnf_bias": full((d,), 0.0),
    }


_layer_norm = ref_layer_norm


def _norm_residual(x, scale, bias, cfg: GPT2Config):
    """(LN(x), residual-skip x). With ``cfg.fused_norm`` the skip rides
    through the fused op so the residual-add gradient lands inside the one
    backward kernel."""
    if cfg.fused_norm:
        return fused_layer_norm_residual(x, scale, bias)
    return _layer_norm(x, scale, bias), x


def _block(x, p: Params, cfg: GPT2Config):
    """One transformer block. x: [B, T, D] in cfg.dtype."""
    b, t, d = x.shape
    h, hd = cfg.n_head, cfg.head_dim
    dt = cfg.dtype

    y, x_skip = _norm_residual(x, p["ln1_scale"], p["ln1_bias"], cfg)
    qkv = y @ p["attn_qkv_w"].to(dt) + p["attn_qkv_b"].to(dt)
    q, k_, v_ = (a.reshape(b, t, h, hd) for a in qkv.split(d, dim=-1))
    attn = causal_attention(q, k_, v_, use_flash=cfg.use_flash)
    attn = attn.reshape(b, t, d)
    x = x_skip + attn @ p["attn_out_w"].to(dt) + p["attn_out_b"].to(dt)

    y, x_skip = _norm_residual(x, p["ln2_scale"], p["ln2_bias"], cfg)
    y = y @ p["mlp_in_w"].to(dt) + p["mlp_in_b"].to(dt)
    y = fused_gelu(y) if cfg.fused_norm else ref_gelu(y)
    return x_skip + y @ p["mlp_out_w"].to(dt) + p["mlp_out_b"].to(dt)


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _block_fn(cfg: GPT2Config):
    block = functools.partial(_block, cfg=cfg)
    if cfg.remat == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_dots)
        return lambda x, p: checkpoint(block, x, p, use_reentrant=False,
                                       context_fn=ctx_fn)
    if cfg.remat:
        return lambda x, p: checkpoint(block, x, p, use_reentrant=False)
    return block


def gpt2_hidden(params: Params, tokens, cfg: GPT2Config):
    """tokens [B, T] int -> final-layernormed hidden states [B, T, D]."""
    if cfg.attention_impl != "auto":
        raise NotImplementedError(
            f"attention_impl={cfg.attention_impl!r} is ported in a later "
            "slice; use 'auto'")
    t = tokens.shape[1]
    dt = cfg.dtype
    x = params["wte"].to(dt)[tokens] + params["wpe"].to(dt)[:t]
    block_fn = _block_fn(cfg)
    # unbind, not v[i]: its backward stacks the per-layer gradients once,
    # where indexing would scatter each layer's gradient into a zeroed
    # full-size [n_layer, ...] tensor and add n_layer of those up.
    layers = {k: v.unbind(0) for k, v in params["blocks"].items()}
    for i in range(cfg.n_layer):
        x = block_fn(x, {k: v[i] for k, v in layers.items()})
    if cfg.fused_norm:
        return fused_layer_norm(x, params["lnf_scale"], params["lnf_bias"])
    return _layer_norm(x, params["lnf_scale"], params["lnf_bias"])


def _head_dtype(cfg: GPT2Config) -> torch.dtype:
    return cfg.logits_dtype if cfg.logits_dtype is not None else torch.float32


def _head(x, w, cfg: GPT2Config):
    """x [..., D] @ w[V, D]^T in the head dtype. An fp32 head multiplies
    the upcast bf16 operands, as ``preferred_element_type=float32``."""
    hd = _head_dtype(cfg)
    return x.to(hd) @ w.to(hd).T


def gpt2_forward(params: Params, tokens, cfg: GPT2Config):
    """tokens [B, T] -> logits [B, T, V] (fp32 unless cfg.logits_dtype)."""
    x = gpt2_hidden(params, tokens, cfg)
    return _head(x, params["wte"].to(cfg.dtype), cfg)


def _ce_chunk(m, s, picked, x, wc, targets, base: int, cfg: GPT2Config):
    """One vocab chunk of the online logsumexp: running max m, running
    sum(exp(logit - m)) s, and the target's logit where it falls here."""
    vc = wc.shape[0]
    logits = _head(x, wc, cfg).float()
    new_m = torch.maximum(m, logits.amax(-1))
    s = s * torch.exp(m - new_m) + torch.exp(logits - new_m[..., None]).sum(-1)
    idx = (targets - base).clamp(0, vc - 1)
    p = logits.gather(-1, idx[..., None])[..., 0]
    here = (targets >= base) & (targets < base + vc)
    return new_m, s, torch.where(here, p, picked)


def _chunked_ce(x, wte, targets, cfg: GPT2Config):
    """Online-logsumexp cross-entropy over vocab chunks; each chunk is
    checkpointed, so peak logits memory is [B, T, V/n] forward and back."""
    n = cfg.ce_vocab_chunks
    v, _ = wte.shape
    if v % n:
        raise ValueError(f"ce_vocab_chunks={n} must divide vocab_size={v}")
    vc = v // n
    w_chunks = wte.to(cfg.dtype).reshape(n, vc, -1)
    bt = targets.shape
    m = torch.full(bt, float("-inf"), device=x.device)
    s = torch.zeros(bt, device=x.device)
    picked = torch.zeros(bt, device=x.device)
    for i in range(n):
        m, s, picked = checkpoint(_ce_chunk, m, s, picked, x, w_chunks[i],
                                  targets, i * vc, cfg, use_reentrant=False)
    return torch.mean(m + torch.log(s) - picked)


def gpt2_loss(params: Params, batch: dict, cfg: GPT2Config):
    """Next-token cross-entropy. batch: {'tokens': [B, T+1] int}: inputs are
    tokens[:, :-1], targets tokens[:, 1:]."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.ce_vocab_chunks > 1:
        x = gpt2_hidden(params, inputs, cfg)
        return _chunked_ce(x, params["wte"], targets, cfg)
    logits = gpt2_forward(params, inputs, cfg).float()
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return torch.mean(lse - picked)


def gpt2_flops_per_token(cfg: GPT2Config, seq_len: int | None = None) -> float:
    """Training FLOPs/token: 6*N for matmuls + attention score/value FLOPs.

    Standard estimate (PaLM appendix B): 6*n_params + 12*L*D*T (causal)."""
    t = seq_len or cfg.seq_len
    return 6 * cfg.n_params + 12 * cfg.n_layer * cfg.d_model * t // 2
