"""Mixture-of-Experts layer with expert parallelism (port of
``ray_tpu/ops/moe.py``).

Switch-style top-1 / top-2 routing with static shapes:

* router: [tokens, E] fp32 logits -> top-k experts per token and their
  gates (renormalised over the chosen experts when k > 1);
* capacity: each expert takes at most C = capacity_factor * tokens / E
  tokens of this rank's batch; a token past it is dropped (its one-hot
  position row is zero);
* dispatch and combine: [T, E, C] one-hot (and gate-weighted) matrices
  turn the gather and the scatter into fp32 matrix products;
* expert parallelism: ``moe_ffn_ep`` keeps this rank's E/ep experts and
  exchanges the [E, C, D] token buffers with the other ranks of the
  mesh's ``ep`` axis by ``all_to_all``, so each rank computes only its own
  experts' FFNs.

What differs from the JAX module, and why:

* ``moe_ffn_ep`` runs on the caller's local tensors, as the port's train
  step does (``train/train_step.py``): ``x`` holds this rank's rows (the
  batch sharded over ``dp``/``fsdp`` and replicated over ``ep``) and the
  parameters are whole; it slices this rank's experts out of ``w_in`` and
  ``w_out`` as ``shard_map``'s ``P("ep")`` in_spec does.
* ``moe_ffn_ep_local`` takes the ``ep`` process group, where the JAX body
  takes the axis name of the surrounding ``shard_map``.
* ``init_moe_params`` draws from a ``torch.Generator``, so its values are
  not JAX's; the tests carry JAX's through numpy.
* Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
  does (a stable descending sort; ``torch.topk`` promises no order), and
  the capacity one-hot is a comparison with an ``arange``, which gives
  ``jax.nn.one_hot``'s zero row for a position past the capacity where
  ``F.one_hot`` would raise.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device

# jax.nn.gelu's default form, the layer's default activation.
gelu_tanh = functools.partial(F.gelu, approximate="tanh")


def init_moe_params(generator: torch.Generator, d_model: int, d_ff: int,
                    n_experts: int, dtype=torch.float32, *,
                    device=None) -> dict:
    """normal(0.02) router [D, E], w_in [E, D, F] and w_out [E, F, D],
    drawn on ``generator``'s device, then moved to ``device``."""
    device = resolve_device(device)

    def norm(shape):
        x = torch.randn(shape, generator=generator, dtype=torch.float32,
                        device=generator.device) * 0.02
        return x.to(device=device, dtype=dtype)

    return {"router": norm((d_model, n_experts)),
            "w_in": norm((n_experts, d_model, d_ff)),
            "w_out": norm((n_experts, d_ff, d_model))}


def moe_param_axes() -> dict:
    """Logical axes, JAX's names: ``"experts"`` is in no rules table, so
    the expert dim is replicated (the stored weights are whole over
    ``ep``, as in the JAX package); ``embed`` shards over ``fsdp``."""
    return {
        "router": ("embed", None),
        "w_in": ("experts", "embed", "mlp"),
        "w_out": ("experts", "mlp", "embed"),
    }


def _top_k(probs, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index, as ``jax.lax.top_k``."""
    values, indices = torch.sort(probs, dim=-1, descending=True, stable=True)
    return values[:, :k], indices[:, :k]


def _route(x2d, router_w, n_experts: int, top_k: int, capacity: int):
    """Returns (dispatch [T, E, C] one-hot, combine [T, E, C] gate
    weights, aux_loss), all fp32. Shapes static; overflow dropped."""
    logits = x2d.float() @ router_w.float()
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    t = x2d.shape[0]

    gates, experts = _top_k(probs, top_k)  # [T, k]
    if top_k > 1:
        # GShard-style: renormalise over the selected experts.
        gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    # Load-balancing auxiliary loss (Switch Transformer eq. 4).
    density = probs.mean(dim=0)
    top1_mask = F.one_hot(experts[:, 0], n_experts).float()
    aux_loss = n_experts * torch.sum(density * top1_mask.mean(dim=0))

    slots = torch.arange(capacity, device=x2d.device)
    dispatch = torch.zeros((t, n_experts, capacity), dtype=torch.float32,
                           device=x2d.device)
    combine = torch.zeros_like(dispatch)
    # Each token's position in its expert's buffer: running per-expert
    # counts across the k routing slots keep positions unique.
    counts = torch.zeros(n_experts, dtype=torch.float32, device=x2d.device)
    for j in range(top_k):
        onehot = F.one_hot(experts[:, j], n_experts).float()  # [T, E]
        prior = torch.cumsum(onehot, dim=0) - onehot + counts[None, :]
        pos = (prior * onehot).sum(dim=1).to(torch.int32)  # [T]
        counts = counts + onehot.sum(dim=0)
        keep = (pos < capacity).float()
        pos_oh = (pos[:, None] == slots[None, :]).float()  # [T, C]
        sel = (onehot * keep[:, None])[:, :, None] * pos_oh[:, None, :]
        dispatch = dispatch + sel
        combine = combine + sel * gates[:, j][:, None, None]
    return dispatch, combine, aux_loss


def _capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    return max(1, int(capacity_factor * n_tokens / n_experts))


def _dispatch(dispatch, x2d):
    """[T, E, C] one-hot x [T, D] -> [E, C, D] expert inputs, fp32: the
    einsum ``tec,td->ecd`` as one matrix product (``aten.mm``, which the
    models' dots remat saves, as JAX's policy saves a dot with no batch
    dims; ``torch.einsum`` would lower it to a batched product)."""
    t, e, c = dispatch.shape
    return (dispatch.reshape(t, e * c).t() @ x2d.float()).reshape(e, c, -1)


def _combine(combine, expert_out):
    """[T, E, C] gate weights x [E, C, D] -> [T, D], fp32: the einsum
    ``tec,ecd->td`` as one matrix product."""
    t, e, c = combine.shape
    return combine.reshape(t, e * c) @ expert_out.reshape(e * c, -1)


def moe_ffn(params: dict, x, *, top_k: int = 1,
            capacity_factor: float = 1.25,
            activation=gelu_tanh):
    """MoE FFN over every expert on this device. x: [B, T, D] ->
    ([B, T, D] in x's dtype, aux_loss fp32 scalar)."""
    b, t, d = x.shape
    e = params["router"].shape[1]
    x2d = x.reshape(b * t, d)
    capacity = _capacity(b * t, e, capacity_factor)
    dispatch, combine, aux = _route(x2d, params["router"], e, top_k, capacity)
    expert_in = _dispatch(dispatch, x2d)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in,
                                params["w_in"].float()))
    expert_out = torch.einsum("ecf,efd->ecd", h, params["w_out"].float())
    out = _combine(combine, expert_out)
    return out.reshape(b, t, d).to(x.dtype), aux


def moe_ffn_ep(params: dict, x, mesh, *, axis: str = "ep", top_k: int = 1,
               capacity_factor: float = 1.25, activation=gelu_tanh):
    """Expert-parallel MoE FFN: x holds this rank's rows, ``params`` the
    whole weights; this rank computes the experts
    ``[i * E/ep, (i+1) * E/ep)``, i its index on ``axis``."""
    ep = mesh.size(mesh.mesh_dim_names.index(axis))
    e = params["router"].shape[1]
    if e % ep:
        raise ValueError(f"n_experts {e} must divide by ep={ep}")
    per = e // ep
    lo = mesh.get_local_rank(axis) * per
    return moe_ffn_ep_local(
        x, params["router"], params["w_in"][lo:lo + per],
        params["w_out"][lo:lo + per], n_experts=e,
        group=mesh.get_group(axis), top_k=top_k,
        capacity_factor=capacity_factor, activation=activation)


class _PMean(torch.autograd.Function):
    """The mean over ``group`` on every rank (``jax.lax.pmean``); its
    adjoint is the mean of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_reduce_mean(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_mean(g.contiguous(), ctx.group), None


def _all_reduce_mean(x, group):
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_reduce(x, "sum", group)) \
        / dist.get_world_size(group)


def _all_to_all(x, group):
    """``x`` [ep, ...]: block j to rank j; returns the blocks received,
    [ep, ...] by source rank. Autograd-aware (the adjoint is the reverse
    exchange)."""
    from torch.distributed import _functional_collectives as funcol

    return funcol.wait_tensor(funcol.all_to_all_single_autograd(
        x.contiguous(), None, None, group))


def moe_ffn_ep_local(px, p_router, p_win, p_wout, *, n_experts: int, group,
                     top_k: int = 1, capacity_factor: float = 1.25,
                     activation=gelu_tanh):
    """Per-rank expert-parallel FFN body. ``p_win`` / ``p_wout`` hold this
    rank's E/ep experts, ``p_router`` is whole; ``group`` is the ``ep``
    process group, whose ranks hold the expert slices in group-rank
    order."""
    e = n_experts
    ep = dist.get_world_size(group)
    b, t, d = px.shape
    x2d = px.reshape(b * t, d)
    capacity = _capacity(b * t, e, capacity_factor)
    dispatch, combine, aux = _route(x2d, p_router, e, top_k, capacity)
    expert_in = _dispatch(dispatch, x2d)
    # [E, C, D] -> [E/ep, ep*C, D]: split the experts, concatenate the
    # capacity rows of every source rank, in rank order.
    recv = _all_to_all(expert_in.reshape(ep, e // ep, capacity, d), group)
    expert_in = recv.transpose(0, 1).reshape(e // ep, ep * capacity, d)
    h = activation(torch.einsum("ecd,edf->ecf", expert_in, p_win.float()))
    expert_out = torch.einsum("ecf,efd->ecd", h, p_wout.float())
    # Back: [E/ep, ep*C, D] -> [E, C, D], rank j's rows to rank j.
    send = expert_out.reshape(e // ep, ep, capacity, d).transpose(0, 1)
    expert_out = _all_to_all(send, group).reshape(e, capacity, d)
    out = _combine(combine, expert_out)
    aux = _PMean.apply(aux, group)
    return out.reshape(b, t, d).to(px.dtype), aux
