"""Mixtral-style MoE decoder in PyTorch (port of ``ray_tpu/models/moe.py``):
Llama attention (RMSNorm, rotary embeddings, GQA, untied head) with each
layer's SwiGLU MLP replaced by a top-k routed mixture of SiLU experts
(``ops/moe.py``). The loss carries the router's load-balancing auxiliary
term. With ``expert_parallel`` and a ``mesh`` the FFN takes the
all_to_all path over the mesh's ``ep`` axis.

Parameters are a nested dict with the JAX package's key names and layouts
(stacked ``[n_layer, ...]`` block leaves, the expert weights under
``blocks["moe"]``), so a JAX parameter tree converted through numpy
(``models/convert.py``) loads as it is.

What differs from the JAX module, and why (as in ``models/llama.py``):

* ``scan_layers`` is accepted and ignored: the layers run as a Python loop
  (``models/_remat.run_layers``) carrying ``(x, aux)``.
* ``with_logical_constraint`` is dropped: the model runs on plain local
  tensors, and the sharded train step gathers the parameters before it,
  laid out by ``moe_shardings``. The expert weights are stored whole over
  ``ep`` (``ops/moe.moe_param_axes``), as in the JAX package.
* ``remat`` maps onto ``torch.utils.checkpoint`` per block; under
  ``"dots"`` the projections, the router logits and the dispatch and
  combine products (``aten.mm``) are saved, and the rest is recomputed,
  the expert exchange of the ``ep`` path included.
* As in the JAX module, the norms are the plain RMSNorm chain whatever
  ``fused_norm`` says; attention goes through ``causal_attention``.
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
from ray_tpu_torch.models.llama import LlamaConfig, _expand_kv, _rms_norm, _rope
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.moe import (
    init_moe_params,
    moe_ffn,
    moe_ffn_ep,
    moe_param_axes,
)

Params = dict[str, Any]


@dataclasses.dataclass(frozen=True)
class MoEConfig(LlamaConfig):
    """Llama geometry + expert mixture. ``expert_parallel`` switches the
    FFN to the all_to_all path over ``mesh``'s ``ep`` axis."""

    n_experts: int = 8
    top_k: int = 2
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    expert_parallel: bool = False
    mesh: Any = dataclasses.field(default=None, compare=False)

    @classmethod
    def tiny(cls) -> "MoEConfig":
        return cls(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                   d_model=64, seq_len=64, n_experts=4, top_k=2)

    @property
    def n_params(self) -> int:
        d, hd = self.d_model, self.head_dim
        attn = d * (self.n_head * hd) + 2 * d * (self.n_kv_head * hd) \
            + (self.n_head * hd) * d
        moe = d * self.n_experts + 2 * self.n_experts * d * self.d_ff
        per_layer = attn + moe + 2 * d
        return (self.vocab_size * d + self.n_layer * per_layer
                + d + d * self.vocab_size)

    @property
    def n_active_params(self) -> int:
        """Params touched per token (top_k of n_experts)."""
        d = self.d_model
        dense = self.n_params - self.n_layer * 2 * self.n_experts * d * self.d_ff
        return dense + self.n_layer * 2 * self.top_k * d * self.d_ff


def moe_param_axes_tree(cfg: MoEConfig) -> Params:
    m = {k: ("layers", *v) for k, v in moe_param_axes().items()}
    return {
        "embed": ("vocab", "embed"),
        "blocks": {
            "attn_norm": ("layers", None),
            "wq": ("layers", "embed", "qkv"),
            "wk": ("layers", "embed", "qkv"),
            "wv": ("layers", "embed", "qkv"),
            "wo": ("layers", "qkv", "embed"),
            "mlp_norm": ("layers", None),
            "moe": m,
        },
        "final_norm": (None,),
        "lm_head": ("embed", "vocab"),
    }


def moe_shardings(cfg: MoEConfig, mesh, rules=None) -> Params:
    """A ``parallel.sharding.NamedSharding`` for every param leaf."""
    from ray_tpu_torch.parallel.sharding import logical_sharding

    return tree_map(lambda axes: logical_sharding(mesh, axes, rules),
                    moe_param_axes_tree(cfg))


def moe_init(generator: torch.Generator, cfg: MoEConfig, *,
             device=None) -> Params:
    """normal(0.02) weights, ``wo`` at 0.02 / sqrt(2L), norm scales at 1;
    each layer's experts from ``init_moe_params``. Draws on
    ``generator``'s device, then moves to ``device``."""
    device = resolve_device(device)
    d, l, v = cfg.d_model, cfg.n_layer, cfg.vocab_size
    hd, nh, nkv = cfg.head_dim, cfg.n_head, cfg.n_kv_head
    pd = cfg.param_dtype

    def norm(shape, stddev=0.02):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * stddev
        return x.to(device=device, dtype=pd)

    def ones(shape):
        return torch.ones(shape, dtype=pd, device=device)

    per_layer = [init_moe_params(generator, d, cfg.d_ff, cfg.n_experts,
                                 dtype=pd, device=device) for _ in range(l)]
    moe_stacked = {k: torch.stack([p[k] for p in per_layer])
                   for k in per_layer[0]}
    del per_layer
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
            "moe": moe_stacked,
        },
        "final_norm": ones((d,)),
        "lm_head": norm((d, v)),
    }


def _block(carry, p: Params, cfg: MoEConfig):
    """One decoder block: (x [B, T, D] in cfg.dtype, aux sum) -> the
    same, the layer's aux loss added."""
    x, aux_sum = carry
    b, t, _ = x.shape
    nh, nkv, hd = cfg.n_head, cfg.n_kv_head, cfg.head_dim
    dt = cfg.dtype

    y = _rms_norm(x, p["attn_norm"])
    q = _rope((y @ p["wq"].to(dt)).reshape(b, t, nh, hd), cfg.rope_theta)
    k = _rope((y @ p["wk"].to(dt)).reshape(b, t, nkv, hd), cfg.rope_theta)
    v = (y @ p["wv"].to(dt)).reshape(b, t, nkv, hd)
    attn = causal_attention(q, _expand_kv(k, cfg), _expand_kv(v, cfg),
                            use_flash=cfg.use_flash)
    x = x + attn.reshape(b, t, nh * hd) @ p["wo"].to(dt)

    y = _rms_norm(x, p["mlp_norm"])
    kw = dict(top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
              activation=F.silu)
    if cfg.expert_parallel and cfg.mesh is not None:
        ff, aux = moe_ffn_ep(p["moe"], y, cfg.mesh, **kw)
    else:
        ff, aux = moe_ffn(p["moe"], y, **kw)
    return x + ff, aux_sum + aux


def moe_forward(params: Params, tokens, cfg: MoEConfig):
    """tokens [B, T] int -> (logits [B, T, V] fp32, aux_loss scalar, the
    mean over layers)."""
    check_attention_impl(cfg.attention_impl)
    dt = cfg.dtype
    x = params["embed"].to(dt)[tokens]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    block_fn = remat_block(functools.partial(_block, cfg=cfg), cfg.remat)
    x, aux = run_layers(block_fn, (x, aux), params["blocks"], cfg.n_layer)
    x = _rms_norm(x, params["final_norm"])
    logits = x.float() @ params["lm_head"].to(dt).float()
    return logits, aux / cfg.n_layer


def moe_loss(params: Params, batch: dict, cfg: MoEConfig):
    """Next-token cross-entropy + the router's load-balancing term."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits, aux = moe_forward(params, inputs, cfg)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None])[..., 0]
    return torch.mean(lse - picked) + cfg.aux_loss_coef * aux


def moe_flops_per_token(cfg: MoEConfig, seq_len: int | None = None) -> float:
    """Model FLOPs a token: 6 x the active parameters + causal attention
    score/value FLOPs (``llama_flops_per_token``'s rule). The dispatch and
    combine products and the dropped or padded capacity rows are not
    model FLOPs."""
    t = seq_len or cfg.seq_len
    return 6 * cfg.n_active_params + 12 * cfg.n_layer * cfg.d_model * t // 2
