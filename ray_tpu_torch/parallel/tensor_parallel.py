"""Megatron-style tensor parallelism over the mesh's ``tp`` axis.

The JAX package has no counterpart module: there the models name
``"qkv"``, ``"mlp"``, ``"heads"`` and ``"vocab"`` on their parameters, the
rules map those names to ``tp`` (``parallel/sharding.py``), and XLA
partitions the computation and inserts the collectives. The port's models
compute on plain local tensors (the train step gathers every parameter
whole), so they take their ``tp`` slices and issue the collectives
themselves, through this module:

* ``copy_to_tp`` is the identity in the forward and an all-reduce of the
  gradient over ``tp`` in the backward: the input of every
  column-parallel product (a rank computes its heads' or columns' share
  of the input's gradient only);
* ``reduce_from_tp`` is the reverse, an all-reduce in the forward and the
  identity in the backward: the output of every row-parallel product (a
  rank holds a partial sum), taken in the product's dtype, as XLA
  all-reduces the partials;
* ``vocab_parallel_embed`` looks up the tokens of this rank's V/tp rows
  of a table, zero for the others, and all-reduces;
* ``vocab_parallel_ce`` combines the ranks' online-logsumexp statistics of
  their V/tp logits into the cross-entropy over the whole vocabulary.

Every ``tp`` rank computes the same loss. A parameter a rank uses a slice
of gets its slice's gradient only, so the train step sums those over
``tp``; one every rank uses whole gets the same gradient on every rank
and is averaged (``train/train_step.py``). With ``tp == 1`` every helper
returns its input, so the models run the unsharded operations.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# How many times a model entered a column-parallel product over a group of
# more than one rank; the train step reads it to check that the model it
# runs on a tp mesh computes sharded.
_ENTRIES = [0]


def entries() -> int:
    return _ENTRIES[0]


def tp_shard(cfg) -> tuple[int, int, object]:
    """(tp, idx, group): the size of ``cfg.mesh``'s ``tp`` axis, this
    rank's position on it and its process group; (1, 0, None) without a
    mesh or at tp = 1."""
    mesh = getattr(cfg, "mesh", None)
    if mesh is None:
        return 1, 0, None
    tp = mesh.size(mesh.mesh_dim_names.index("tp"))
    if tp == 1:
        return 1, 0, None
    return tp, mesh.get_local_rank("tp"), mesh.get_group("tp")


def check_divisible(tp: int, **sizes: int) -> None:
    """Raise unless every size divides by ``tp``."""
    bad = {k: v for k, v in sizes.items() if v % tp}
    if bad:
        raise ValueError(f"tensor parallelism over tp={tp} needs "
                         f"{', '.join(bad)} ({bad}) to divide by {tp}")


def tp_slice(w, dim: int, tp: int, idx: int, parts: int = 1):
    """This rank's share of ``w`` along ``dim``: of each of ``parts``
    equal blocks of the dim (GPT-2's fused q|k|v columns: 3), the
    ``idx``-th of ``tp`` slices, the blocks' slices concatenated."""
    if tp == 1:
        return w
    dim = dim % w.dim()
    n = w.shape[dim] // (parts * tp)
    if parts == 1:
        return w.narrow(dim, idx * n, n)
    return w.unflatten(dim, (parts, tp, n)).select(dim + 1, idx) \
        .flatten(dim, dim + 1)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=op, group=group)
    return out


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather along the last dim; the backward keeps this rank's
    columns of the (same on every rank) gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.n = x.shape[-1]
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        idx = dist.get_rank(ctx.group)
        return g.narrow(-1, idx * ctx.n, ctx.n).contiguous(), None


def copy_to_tp(x, group):
    """The input of a column-parallel product (see the module docstring)."""
    if group is None:
        return x
    _ENTRIES[0] += 1
    return _CopyToTP.apply(x, group)


def reduce_from_tp(x, group):
    """The output of a row-parallel product: the sum over ``tp``."""
    if group is None:
        return x
    return _ReduceFromTP.apply(x, group)


def gather_from_tp(x, group):
    """This rank's last-dim columns -> all ranks' columns, in rank order."""
    if group is None:
        return x
    return _GatherFromTP.apply(x, group)


def vocab_parallel_embed(table, tokens, tp: int, idx: int, group):
    """``table[tokens]`` from this rank's V/tp rows of ``table`` [V, D]:
    a token of another rank's rows looks up zero, and the sum over ``tp``
    gives every row."""
    if group is None:
        return table[tokens]
    v = table.shape[0] // tp
    local = tokens - idx * v
    here = (local >= 0) & (local < v)
    rows = table.narrow(0, idx * v, v)[local.clamp(0, v - 1)]
    return reduce_from_tp(torch.where(here[..., None], rows, 0), group)


def vocab_parallel_ce(m, s, picked, group):
    """mean(logsumexp - target logit) over all ranks' vocab slices, from
    each rank's running max ``m``, sum of exp(logit - m) ``s`` and target
    logit ``picked`` (0 where the target is another rank's): the max over
    ``tp`` is a shift and takes no gradient, the sums are all-reduced."""
    if group is None:
        return torch.mean(m + torch.log(s) - picked)
    big_m = _all_reduce(m.detach(), group, dist.ReduceOp.MAX)
    big_s = reduce_from_tp(s * torch.exp(m - big_m), group)
    return torch.mean(big_m + torch.log(big_s)
                      - reduce_from_tp(picked, group))
