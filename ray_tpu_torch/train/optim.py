"""AdamW with global-norm clipping over nested-dict parameter trees (port of
``ray_tpu/train/optim.py``).

The arithmetic is that of ``adamw_update`` there, step for step: fp32
moments, the global norm in fp32, the clip scale ``clip / max(gnorm, 1e-12)``
applied only when ``gnorm > clip`` (``clip_grad_norm_`` would add 1e-6),
weight decay on every leaf, bias corrections and the warmup factor in fp32.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from ray_tpu_torch._tree import tree_leaves, tree_map

Params = Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 0


def adamw_init(params: Params) -> dict[str, Params]:
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params)}


def _schedule(cfg: AdamWConfig, step: int) -> float:
    """The learning rate at ``step`` (0-based), rounded as JAX's float32."""
    lr = np.float32(cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * np.minimum(np.float32(1.0),
                             np.float32((step + 1) / cfg.warmup_steps))
    return float(np.float32(lr))


def adamw_update(cfg: AdamWConfig, grads: Params, params: Params,
                 opt_state: dict[str, Params], step: int):
    """One AdamW step. Returns (params, opt_state, lr, gnorm): ``lr`` a
    float, ``gnorm`` a 0-d fp32 tensor on the parameters' device.

    Updates ``params`` and the moments IN PLACE under ``torch.no_grad()``
    and returns the same trees (the JAX version donates the old state to
    XLA instead; either way the caller must not reuse the old state)."""
    with torch.no_grad():
        gnorm = torch.sqrt(sum(g.float().square().sum()
                               for g in tree_leaves(grads)))
        scale = torch.where(gnorm > cfg.grad_clip,
                            cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                            torch.ones_like(gnorm))
        lr = _schedule(cfg, step)
        t = np.float32(step + 1)
        bc1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
        bc2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)

        def upd(p, g, mu, nu):
            g = g.float() * scale
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            step_ = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            p32 = p.float()
            p.copy_(p32 - lr * (step_ + cfg.weight_decay * p32))

        tree_map(upd, params, grads, opt_state["mu"], opt_state["nu"])
    return params, opt_state, lr, gnorm
