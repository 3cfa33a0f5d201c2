"""Per-block rematerialisation shared by the models (the counterpart of the
``jax.checkpoint`` wrapping in ``ray_tpu/models/gpt2.py`` and ``llama.py``).

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


def check_attention_impl(impl: str) -> None:
    if impl != "auto":
        raise NotImplementedError(
            f"attention_impl={impl!r} is ported in a later slice; use 'auto'")
