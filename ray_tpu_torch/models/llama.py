"""Llama-family decoder in PyTorch (port of ``ray_tpu/models/llama.py``):
RMSNorm, rotary embeddings, SwiGLU, grouped-query attention and an untied
head, the training half and the decode half the serving engine runs.

Parameters are a nested dict with the JAX package's key names and layouts
(stacked ``[n_layer, ...]`` block leaves, ``lm_head`` ``[d, V]``), so a JAX
parameter tree converted through numpy (``models/convert.py``) loads as it
is. Compute is in ``cfg.dtype`` (bf16), parameters and the loss in fp32.

What differs from the JAX module, and why (as in ``models/gpt2.py``):

* ``scan_layers`` is accepted and ignored: the layers run as a Python loop.
* ``with_logical_constraint`` and the ``mesh`` field are dropped: the
  model runs on plain local tensors; the sharded train step gathers the
  parameters before it (``train/train_step.py``), laid out by
  ``llama_shardings``. ``attention_impl`` other than ``"auto"`` (ring,
  Ulysses) raises.
* ``remat`` maps onto ``torch.utils.checkpoint`` per block
  (``models/_remat.py``); under ``"dots"`` the seven projections are saved
  and the norms, RoPE, attention and SwiGLU are recomputed.
* The head multiplies the upcast bf16 operands in fp32, as JAX's
  ``preferred_element_type=float32`` (the upcast is exact).
* With ``fused_norm`` the norms go through the RMSNorm kernels at every
  width; the JAX package takes its Pallas kernel only where ``D % 128 ==
  0`` and the plain chain elsewhere, which computes the same function.

The decode half (``llama_init_cache``, ``_rope_at``, ``llama_decode_step``,
``llama_prefill``) reaches no kernel: it runs the plain RMSNorm chain, as
the reference does. As in ``models/gpt2.py``, it updates the cache in place
and maps token ids as JAX's gather does.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any

import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch._tree import tree_map
from ray_tpu_torch.models._remat import (
    check_attention_impl,
    remat_block,
    run_layers,
)
from ray_tpu_torch.ops.attention import (
    cache_write_prompt,
    cache_write_token,
    cached_decode_attention,
    causal_attention,
    take_rows,
)
from ray_tpu_torch.ops.fused_norm import (
    fused_rms_norm,
    fused_rms_norm_residual,
    ref_rms_norm,
)

Params = dict[str, Any]


def _round_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    n_layer: int = 16
    n_head: int = 16
    n_kv_head: int = 4
    d_model: int = 1024
    seq_len: int = 2048
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    remat: Any = "dots"  # same semantics as GPT2Config.remat
    scan_layers: bool = True  # accepted for parity; layers always loop
    use_flash: bool | None = None
    attention_impl: str = "auto"
    # RMSNorm(+residual) through the CUDA kernels of ops/fused_norm.py.
    fused_norm: bool = False

    def __post_init__(self):
        assert self.n_head % self.n_kv_head == 0, "GQA needs even groups"
        assert self.d_model % self.n_head == 0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_head

    @property
    def d_ff(self) -> int:
        # Llama's 2/3 * 4d SwiGLU hidden, rounded up to a multiple of 128.
        return _round_to(int(8 * self.d_model / 3), 128)

    @property
    def n_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_head * hd) + 2 * d * (self.n_kv_head * hd) \
            + (self.n_head * hd) * d
        mlp = 3 * d * self.d_ff
        per_layer = attn + mlp + 2 * d  # + the two RMSNorm scales
        return (self.vocab_size * d            # embed
                + self.n_layer * per_layer
                + d                            # final norm
                + d * self.vocab_size)         # untied head

    @classmethod
    def tiny(cls) -> "LlamaConfig":
        """CPU-test sized."""
        return cls(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                   d_model=64, seq_len=64)

    @classmethod
    def small(cls) -> "LlamaConfig":
        """~246M parameters, for single-device measurement."""
        return cls(n_layer=16, n_head=16, n_kv_head=4, d_model=1024,
                   seq_len=2048)


def llama_param_axes(cfg: LlamaConfig) -> Params:
    """Logical axis names for every param leaf (same tree structure)."""
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "qkv"),
            "wk": ("layers", "embed", "qkv"),
            "wv": ("layers", "embed", "qkv"),
            "wo": ("layers", "qkv", "embed"),
            "mlp_norm": ("layers", None),
            "w_gate": ("layers", "embed", "mlp"),
            "w_up": ("layers", "embed", "mlp"),
            "w_down": ("layers", "mlp", "embed"),
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def llama_shardings(cfg: LlamaConfig, mesh, rules=None) -> Params:
    """A ``parallel.sharding.NamedSharding`` for every param leaf."""
    from ray_tpu_torch.parallel.sharding import logical_sharding

    return tree_map(lambda axes: logical_sharding(mesh, axes, rules),
                    llama_param_axes(cfg))


def llama_init(generator: torch.Generator, cfg: LlamaConfig, *,
               device=None) -> Params:
    """normal(0.02) weights, residual projections (wo, w_down) at
    0.02 / sqrt(2L), norm scales at 1. Draws on ``generator``'s device,
    then moves to ``device``."""
    device = resolve_device(device)
    d, l, v = cfg.d_model, cfg.n_layer, cfg.vocab_size
    hd, nh, nkv, ff = cfg.head_dim, cfg.n_head, cfg.n_kv_head, cfg.d_ff
    pd = cfg.param_dtype

    def norm(shape, stddev=0.02):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * stddev
        return x.to(device=device, dtype=pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    resid = 0.02 / (2 * l) ** 0.5
    return {
        "embed": norm((v, d)),
        "blocks": {
            "attn_norm": ones((l, d)),
            "wq": norm((l, d, nh * hd)),
            "wk": norm((l, d, nkv * hd)),
            "wv": norm((l, d, nkv * hd)),
            "wo": norm((l, nh * hd, d), resid),
            "mlp_norm": ones((l, d)),
            "w_gate": norm((l, d, ff)),
            "w_up": norm((l, d, ff)),
            "w_down": norm((l, ff, d), resid),
        },
        "final_norm": ones((d,)),
        "lm_head": norm((d, v)),
    }


_rms_norm = ref_rms_norm  # the plain chain, eps 1e-6


def _rope(x, theta: float):
    """Rotary embedding over [B, T, H, D] at positions 0..T-1: the two
    halves of the head dim are rotated (not interleaved pairs), with fp32
    angles, and the result is cast back to ``x.dtype``."""
    _, t, _, d = x.shape
    half = d // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = torch.arange(t, dtype=torch.float32,
                          device=x.device)[:, None] * freqs[None, :]
    cos = torch.cos(angles)[None, :, None, :]  # [1, T, 1, half]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _expand_kv(t, cfg: LlamaConfig):
    """GQA: each KV head serves ``n_head // n_kv_head`` consecutive query
    heads -- ``repeat_interleave`` on the head axis, as ``jnp.repeat``
    (``Tensor.repeat`` would tile the heads instead)."""
    rep = cfg.n_head // cfg.n_kv_head
    return t.repeat_interleave(rep, dim=2) if rep > 1 else t


def _norm_residual(x, scale, cfg: LlamaConfig):
    """(RMSNorm(x), residual-skip x). With ``cfg.fused_norm`` the skip rides
    through the fused op so the residual-add gradient lands inside the one
    backward kernel."""
    if cfg.fused_norm:
        return fused_rms_norm_residual(x, scale)
    return _rms_norm(x, scale), x


def _block(x, p: Params, cfg: LlamaConfig):
    """One decoder block. x: [B, T, D] in cfg.dtype."""
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dt = cfg.dtype

    y, x_skip = _norm_residual(x, p["attn_norm"], cfg)
    q = (y @ p["wq"].to(dt)).reshape(b, t, nh, hd)
    k = (y @ p["wk"].to(dt)).reshape(b, t, nkv, hd)
    v = (y @ p["wv"].to(dt)).reshape(b, t, nkv, hd)
    q = _rope(q, cfg.rope_theta)
    k = _rope(k, cfg.rope_theta)
    # GQA; the result is contiguous, as the flash kernels take it.
    attn = causal_attention(q, _expand_kv(k, cfg), _expand_kv(v, cfg),
                            use_flash=cfg.use_flash)
    x = x_skip + attn.reshape(b, t, nh * hd) @ p["wo"].to(dt)

    y, x_skip = _norm_residual(x, p["mlp_norm"], cfg)
    gate = y @ p["w_gate"].to(dt)
    up = y @ p["w_up"].to(dt)
    return x_skip + (F.silu(gate) * up) @ p["w_down"].to(dt)


def llama_forward(params: Params, tokens, cfg: LlamaConfig):
    """tokens [B, T] int -> logits [B, T, V] fp32."""
    check_attention_impl(cfg.attention_impl)
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens]
    block_fn = remat_block(functools.partial(_block, cfg=cfg), cfg.remat)
    x = run_layers(block_fn, x, params["blocks"], cfg.n_layer)
    if cfg.fused_norm:
        x = fused_rms_norm(x, params["final_norm"])
    else:
        x = _rms_norm(x, params["final_norm"])
    return x.float() @ params["lm_head"].to(dt).float()


def llama_loss(params: Params, batch: dict, cfg: LlamaConfig):
    """Next-token cross-entropy. batch: {'tokens': [B, T+1] int}: inputs are
    tokens[:, :-1], targets tokens[:, 1:]."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = llama_forward(params, inputs, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return torch.mean(lse - picked)


# -- autoregressive decoding (serving path) --------------------------------
#
# The contract of the GPT-2 decode half (``models/gpt2.py``): one decode
# step over a fixed slot batch and one chunked-prefill lane over a
# slot-indexed ring cache. The cache keeps only the ``n_kv_head`` heads
# (``[n_layer, slots, cache_len, n_kv_head, head_dim]`` in ``cfg.dtype``);
# the query-head groups re-read the shared KV at attention time.


def llama_init_cache(cfg: LlamaConfig, slots: int, cache_len: int, *,
                     device=None) -> Params:  # decode-path
    device = resolve_device(device)
    shape = (cfg.n_layer, slots, cache_len, cfg.n_kv_head, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


def _rope_at(x, pos, theta: float):
    """Rotary embedding for ONE token per slot at its ABSOLUTE position
    (not the ring cursor): x [S, H, D], pos [S] int."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    angles = pos.float()[:, None] * freqs[None, :]  # [S, half]
    cos = torch.cos(angles)[:, None, :]  # [S, 1, half]
    sin = torch.sin(angles)[:, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _decode_mlp(x, p: Params, dt):
    """The second half of a block: x + SwiGLU(RMSNorm(x))."""
    y = _rms_norm(x, p["mlp_norm"])
    gate = y @ p["w_gate"].to(dt)
    up = y @ p["w_up"].to(dt)
    return x + (F.silu(gate) * up) @ p["w_down"].to(dt)


def _logits(x, params: Params, dt):
    """fp32 logits from the bf16-cast operands (the upcast is exact)."""
    x = _rms_norm(x, params["final_norm"])
    return x.float() @ params["lm_head"].to(dt).float()


def llama_decode_step(params: Params, cache: Params, tokens, pos,
                      cfg: LlamaConfig):
    """One decode iteration for every slot: tokens [S] int, pos [S] int ->
    (logits [S, V] fp32, cache), the cache updated in place. See
    ``gpt2_decode_step`` for the ring-cursor and mask contract."""
    s = tokens.shape[0]
    nh, nkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    cache_len = cache["k"].shape[2]
    dt = cfg.dtype
    cursor = pos % cache_len
    valid = (pos + 1).clamp(max=cache_len)
    x = take_rows(params["embed"], tokens).to(dt)  # [S, D]
    for i in range(cfg.n_layer):
        p = {k: v[i] for k, v in params["blocks"].items()}
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        y = _rms_norm(x, p["attn_norm"])
        q = _rope_at((y @ p["wq"].to(dt)).reshape(s, nh, hd), pos,
                     cfg.rope_theta)
        k_new = _rope_at((y @ p["wk"].to(dt)).reshape(s, nkv, hd), pos,
                         cfg.rope_theta)
        v_new = (y @ p["wv"].to(dt)).reshape(s, nkv, hd)
        cache_write_token(k_cache, k_new[:, None], cursor)
        cache_write_token(v_cache, v_new[:, None], cursor)
        attn = cached_decode_attention(q, _expand_kv(k_cache, cfg),
                                       _expand_kv(v_cache, cfg), valid, dt)
        x = x + attn.reshape(s, nh * hd) @ p["wo"].to(dt)
        x = _decode_mlp(x, p, dt)
    return _logits(x, params, dt), cache


def llama_prefill(params: Params, cache: Params, tokens, slots, lengths,
                  cfg: LlamaConfig):
    """Chunked-prefill lane (fixed [R, P] shape): the causal forward over
    the padded prompts with dense attention, K/V written into each row's
    target slot in place, logits at each prompt's last real token. Same
    pad-garbage contract as ``gpt2_prefill``."""
    r, p_len = tokens.shape
    nh, nkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dt = cfg.dtype
    x = take_rows(params["embed"], tokens).to(dt)
    for i in range(cfg.n_layer):
        p = {k: v[i] for k, v in params["blocks"].items()}
        y = _rms_norm(x, p["attn_norm"])
        q = _rope((y @ p["wq"].to(dt)).reshape(r, p_len, nh, hd),
                  cfg.rope_theta)
        k_ = _rope((y @ p["wk"].to(dt)).reshape(r, p_len, nkv, hd),
                   cfg.rope_theta)
        v_ = (y @ p["wv"].to(dt)).reshape(r, p_len, nkv, hd)
        cache_write_prompt(cache["k"][i], k_, slots)
        cache_write_prompt(cache["v"][i], v_, slots)
        attn = causal_attention(q, _expand_kv(k_, cfg), _expand_kv(v_, cfg),
                                use_flash=False)
        x = x + attn.reshape(r, p_len, nh * hd) @ p["wo"].to(dt)
        x = _decode_mlp(x, p, dt)
    last = x[torch.arange(r, device=x.device), (lengths - 1).clamp(0, p_len - 1)]
    return _logits(last, params, dt), cache


def llama_flops_per_token(cfg: LlamaConfig,
                          seq_len: int | None = None) -> float:
    """6*N matmul FLOPs + causal attention score/value FLOPs."""
    t = seq_len or cfg.seq_len
    return 6 * cfg.n_params + 12 * cfg.n_layer * cfg.d_model * t // 2
