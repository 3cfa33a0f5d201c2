"""Ulysses sequence parallelism: all-to-all head scatter (port of
``ray_tpu/ops/ulysses.py``).

Inputs arrive sequence-sharded, [B, T/sp, H, D] on each rank of the mesh's
``sp`` axis; an ``all_to_all`` over that axis re-shards them head-sharded,
[B, T, H/sp, D], each rank runs full-sequence attention on its heads (any
kernel), and a second ``all_to_all`` restores the sequence sharding. Two
collectives bound the whole exchange, against ``sp`` point-to-point steps
for ring attention; preferable when H >= sp.

What differs from the JAX module, and why:

* ``ulysses_attention`` runs on the caller's local tensors (this rank's
  rows and positions), as the port's train step does; ``batch_axes`` is
  accepted for the same signature and has nothing to do.
* ``ulysses_attention_local`` takes the ``sp`` process group, where the
  JAX body names the ``shard_map`` axis. The exchange is
  ``all_to_all_single`` with autograd (``ops/moe.py``'s ``_all_to_all``),
  in JAX's ``tiled=True`` order.
* The default ``attn_fn`` is ``dense_causal_attention``, the counterpart
  of the JAX default ``xla_causal_attention``: this path launches no
  kernel, as in the JAX package.
"""

from __future__ import annotations

from typing import Callable

import torch.distributed as dist

from ray_tpu_torch.ops.attention import dense_causal_attention
from ray_tpu_torch.ops.moe import _all_to_all


def ulysses_attention_local(q, k, v, *, group,
                            attn_fn: Callable = dense_causal_attention,
                            softmax_scale: float | None = None):
    """Per-rank body over the ranks of ``group``: q/k/v [B, C, H, D] ->
    out [B, C, H, D]."""
    sp = dist.get_world_size(group)

    def scatter_heads(x):
        # [B, C, H, D] -> [B, sp*C, H/sp, D]: head block j to rank j; the
        # sequence blocks received concatenated in source-rank order.
        b, c, h, d = x.shape
        send = x.reshape(b, c, sp, h // sp, d).permute(2, 0, 1, 3, 4)
        recv = _all_to_all(send, group)  # [sp (source), B, C, H/sp, D]
        return recv.transpose(0, 1).reshape(b, sp * c, h // sp, d)

    def gather_heads(x):
        # The inverse: sequence block j to rank j; the head blocks
        # received concatenated in source-rank order.
        b, t, hs, d = x.shape
        send = x.reshape(b, sp, t // sp, hs, d).transpose(0, 1)
        recv = _all_to_all(send, group)  # [sp (source), B, C, H/sp, D]
        return recv.permute(1, 2, 0, 3, 4).reshape(b, t // sp, sp * hs, d)

    qh, kh, vh = scatter_heads(q), scatter_heads(k), scatter_heads(v)
    out = attn_fn(qh, kh, vh, softmax_scale=softmax_scale)
    return gather_heads(out)


def ulysses_attention(q, k, v, mesh, *, axis: str = "sp",
                      attn_fn: Callable = dense_causal_attention,
                      softmax_scale: float | None = None,
                      batch_axes=("dp", "fsdp")):
    """Attention of this rank's [B, C, H, D] q/k/v, its positions on
    ``mesh``'s ``axis``, through the head scatter over that axis."""
    del batch_axes  # the rows are this rank's already
    sp = mesh.size(mesh.mesh_dim_names.index(axis))
    if q.shape[2] % sp:
        raise ValueError(f"n_heads {q.shape[2]} must divide by sp={sp}")
    return ulysses_attention_local(q, k, v, group=mesh.get_group(axis),
                                   attn_fn=attn_fn,
                                   softmax_scale=softmax_scale)
