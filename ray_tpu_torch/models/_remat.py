"""Per-block rematerialisation shared by the models (the counterpart of the
``jax.checkpoint`` wrapping in ``ray_tpu/models/gpt2.py`` and ``llama.py``),
and the attention dispatch GPT-2 and Llama share.

``remat`` maps onto ``torch.utils.checkpoint`` around one block: ``True``
saves nothing inside the block, ``"dots"`` saves only ``aten.mm`` /
``aten.addmm`` outputs (the projections, as
``dots_with_no_batch_dims_saveable``; attention products and every kernel
of the block are recomputed), ``False`` saves everything.
"""

from __future__ import annotations

import functools
from typing import Any, Callable

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ray_tpu_torch._tree import tree_map
from ray_tpu_torch.ops.attention import causal_attention
from ray_tpu_torch.ops.ring_attention import ring_causal_attention
from ray_tpu_torch.ops.ulysses import ulysses_attention

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    if op in _SAVED_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_block(block: Callable, remat: Any) -> Callable:
    """``block(carry, p)`` wrapped for the ``remat`` setting."""
    if remat == "dots":
        ctx_fn = functools.partial(create_selective_checkpoint_contexts,
                                   _save_dots)
        return lambda x, p: checkpoint(block, x, p, use_reentrant=False,
                                       context_fn=ctx_fn)
    if remat:
        return lambda x, p: checkpoint(block, x, p, use_reentrant=False)
    return block


def run_layers(block_fn: Callable, carry, blocks: dict, n_layer: int):
    """Apply ``carry = block_fn(carry, layer)`` once per layer, ``layer``
    the per-layer views of the stacked ``[n_layer, ...]`` leaves of the
    (nested) ``blocks`` tree. The carry is whatever the block takes and
    returns: GPT-2's and Llama's ``x``, the MoE model's ``(x, aux)``.
    ``unbind``, not ``v[i]``: its backward stacks the per-layer gradients
    once, where indexing would scatter each layer's gradient into a zeroed
    full-size tensor and add ``n_layer`` of those up."""
    layers = tree_map(lambda v: v.unbind(0), blocks)
    for i in range(n_layer):
        carry = block_fn(carry, tree_map(lambda v: v[i], layers))
    return carry


def attention(q, k, v, cfg):
    """The models' attention, dispatched as the JAX models do: ``"ring"``
    over ``cfg.mesh`` runs ring attention, ``"ulysses"`` over it the head
    scatter, both over the mesh's ``sp`` axis; anything else, ``"ring"``
    and ``"ulysses"`` without a mesh included, ``causal_attention``."""
    if cfg.attention_impl == "ring" and cfg.mesh is not None:
        return ring_causal_attention(q, k, v, cfg.mesh, axis="sp")
    if cfg.attention_impl == "ulysses" and cfg.mesh is not None:
        return ulysses_attention(q, k, v, cfg.mesh, axis="sp")
    return causal_attention(q, k, v, use_flash=cfg.use_flash)


def seq_shard(cfg) -> tuple[int, int]:
    """(sp, idx): the size of ``cfg.mesh``'s ``sp`` axis and this rank's
    position on it where the attention shards the sequence over it (ring
    or Ulysses over a mesh); (1, 0) otherwise. A rank then computes the
    positions ``[idx * T/sp, (idx + 1) * T/sp)``."""
    mesh = cfg.mesh
    if cfg.attention_impl not in ("ring", "ulysses") or mesh is None:
        return 1, 0
    return mesh.size(mesh.mesh_dim_names.index("sp")), \
        mesh.get_local_rank("sp")


def local_positions(cfg, t: int) -> slice:
    """The slice of ``t`` positions this rank computes (``seq_shard``)."""
    sp, idx = seq_shard(cfg)
    if t % sp:
        raise ValueError(f"seq length {t} must divide by sp={sp}")
    c = t // sp
    return slice(idx * c, (idx + 1) * c)
