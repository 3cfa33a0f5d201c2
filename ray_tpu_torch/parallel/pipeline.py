"""Pipeline parallelism over the mesh axis ``pp``: GPipe forward streaming
and a 1F1B training schedule (port of ``ray_tpu/parallel/pipeline.py``).

Layer stacks shard over ``pp``: stage s holds the leading-dim slice s of
every stage parameter. Microbatches stream through the stages, each
stage's output handed to the next stage one tick later.

* ``pipeline_apply``: the forward GPipe stream.
* ``pipeline_value_and_grad``: 1F1B (or GPipe): each tick a stage runs at
  most one microbatch forward and one backward, by the static timetable
  of ``build_1f1b_schedule``. Stage inputs (not residuals) are saved and
  the backward slot recomputes the stage's forward under autograd, so a
  stage holds at most ``pp`` inputs under 1F1B and ``n_micro`` under
  GPipe.

What differs from the JAX module, and why:

* The executor takes its exchange, where the JAX body names the
  ``shard_map`` axis. ``GroupPipe`` runs one stage a rank of the mesh's
  ``pp`` group, each tick's sends and the receives the timetable names
  for the next tick in one ``batch_isend_irecv`` (NCCL on the card, gloo
  on the CPU), so no pair of stages deadlocks on send order.
  ``FoldedPipe`` runs every stage in one process and hands activations
  over locally: with ``mesh=None`` both entry points take plain tensors
  with the stage dim whole.
* Masked slots are skipped. JAX runs every slot of every tick with the
  invalid ones masked, because SPMD runs one program on every device;
  their values are discarded, so skipping them changes no result. The
  last stage's forward slot only keeps its input: its output feeds no
  stage (JAX sends it round to stage 0, which ignores it), and the
  backward slot recomputes it. A stage's inputs and cotangents are kept
  by microbatch index, where JAX keeps ring buffers of ``pp`` slots,
  which hold the same values under the timetable.
* Over a group, ``pipeline_apply`` runs under ``no_grad`` (its exchange
  carries no gradient) and broadcasts the last stage's outputs to every
  stage, as JAX's replicated output; ``pipeline_value_and_grad`` is the
  training pass. Folded, ``pipeline_apply`` is differentiable.
* The stage parameters over a mesh are DTensors of ``shard_pytree``
  (``Shard(0)`` over ``axis``, the JAX ``P(axis, None, ...)``), or of
  ``param_specs``; the gradients come back in the same placements.
  ``x`` and ``y`` are the global batch, the same on every rank; with
  ``data_spec`` each rank takes its block of the microbatched
  ``[n_micro, mb, ...]`` activations.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ray_tpu_torch._tree import tree_leaves, tree_map


def build_1f1b_schedule(n_micro: int, pp: int, style: str = "1f1b"):
    """Static pipeline timetable. Returns (fwd, bwd, fwd_arrive,
    bwd_arrive), each a [T, pp] int list: the microbatch index stage s
    handles (or receives) at tick t, -1 for idle.

    Rules (greedy, backward-priority -- the canonical 1F1B shape):
      * stage s may forward mb i once stage s-1 forwarded it on an earlier
        tick (the handoff costs one tick); stage 0 is source-fed;
      * stage s may backward mb i once stage s+1 backwarded it on an
        earlier tick; the LAST stage may backward mb i on the same tick it
        forwards it (the fwd slot runs first within a tick);
      * in-flight forwards per stage are capped at pp - s (the 1F1B
        memory bound).

    ``style="gpipe"``: no in-flight cap, and backwards wait for EVERY
    forward to finish (all-fwd-then-all-bwd), with O(n_micro) live
    activations instead of 1F1B's O(pp).
    """
    f_time = [[None] * n_micro for _ in range(pp)]
    b_time = [[None] * n_micro for _ in range(pp)]
    f_next = [0] * pp
    b_next = [0] * pp
    fwd, bwd = [], []
    t = 0
    while any(b < n_micro for b in b_next):
        frow = [-1] * pp
        for s in range(pp):
            i = f_next[s]
            if i >= n_micro:
                continue
            if style == "1f1b" \
                    and f_next[s] - b_next[s] >= max(1, pp - s):
                continue  # 1F1B in-flight cap
            ready = (s == 0) or (
                f_time[s - 1][i] is not None and f_time[s - 1][i] < t)
            if ready:
                frow[s] = i
                f_time[s][i] = t
                f_next[s] += 1
        brow = [-1] * pp
        all_fwd_done = all(f >= n_micro for f in f_next)
        for s in range(pp):
            i = b_next[s]
            if i >= n_micro:
                continue
            if style == "gpipe" and not all_fwd_done:
                continue  # flush phase: backwards only after every fwd
            if s == pp - 1:
                ready = f_time[s][i] is not None and f_time[s][i] <= t
            else:
                ready = b_time[s + 1][i] is not None and b_time[s + 1][i] < t
            if ready:
                brow[s] = i
                b_time[s][i] = t
                b_next[s] += 1
        fwd.append(frow)
        bwd.append(brow)
        t += 1
        if t > 4 * (n_micro + pp) + 16:  # schedule bug guard
            raise AssertionError("1F1B schedule failed to converge")
    T = len(fwd)
    fwd_arrive = [
        [fwd[t - 1][s - 1] if t >= 1 and s >= 1 else -1 for s in range(pp)]
        for t in range(T)
    ]
    bwd_arrive = [
        [bwd[t - 1][s + 1] if t >= 1 and s < pp - 1 else -1
         for s in range(pp)]
        for t in range(T)
    ]
    return fwd, bwd, fwd_arrive, bwd_arrive


# -- the exchange ----------------------------------------------------------


class GroupPipe:
    """One stage a rank of ``group`` (the mesh's ``pp`` group): stage s is
    the group's rank s."""

    def __init__(self, group):
        self.group = group
        self.size = dist.get_world_size(group)
        self.stages = (dist.get_rank(group),)

    def exchange(self, sends: dict, expects: dict) -> dict:
        """``sends``: (kind, from, to) -> tensor; ``expects``: (kind,
        from, to) -> a tensor of the arriving shape and dtype. All in one
        batch of point-to-point operations; returns (kind, from, to) ->
        the arrived tensor."""
        tags = {"f": 0, "b": 1}
        ops, got = [], {}
        for (kind, _, to), x in sends.items():
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  dist.get_global_rank(self.group, to),
                                  self.group, tags[kind]))
        for key, like in expects.items():
            got[key] = torch.empty_like(like)
            ops.append(dist.P2POp(dist.irecv, got[key],
                                  dist.get_global_rank(self.group, key[1]),
                                  self.group, tags[key[0]]))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return got

    def sum(self, x):
        dist.all_reduce(x, group=self.group)
        return x

    def from_last(self, x):
        """The last stage's ``x`` on every stage (``x`` of that shape and
        dtype elsewhere)."""
        dist.broadcast(x, dist.get_global_rank(self.group, self.size - 1),
                       group=self.group)
        return x


class FoldedPipe:
    """Every stage of a ``size``-stage pipeline in one process: a send is
    handed to its receiver as it is."""

    def __init__(self, size: int):
        self.size = size
        self.stages = tuple(range(size))

    def exchange(self, sends: dict, expects: dict) -> dict:
        return {key: sends[key] for key in expects}

    def sum(self, x):
        return x


# -- the executors ---------------------------------------------------------


def _expects(table, t: int, pipe, like) -> dict:
    """The messages the stages of ``pipe`` receive after tick ``t`` of
    ``table`` (``fwd``: from s - 1; ``bwd``: from s + 1)."""
    fwd, bwd = table
    out = {}
    for s in pipe.stages:
        if s > 0 and fwd[t][s - 1] >= 0:
            out[("f", s - 1, s)] = like
        if bwd is not None and s < pipe.size - 1 and bwd[t][s + 1] >= 0:
            out[("b", s + 1, s)] = like
    return out


def _apply_stream(params: dict, x_micro, pipe, stage_fn):
    """GPipe forward: stage s runs microbatch t - s at tick t. Returns the
    last stage's outputs [n_micro, mb, ...] (None on other stages)."""
    pp, n_micro = pipe.size, x_micro.shape[0]
    inbox: dict = {}
    outs = []
    fwd = [[t - s if 0 <= t - s < n_micro else -1 for s in range(pp)]
           for t in range(n_micro + pp - 1)]
    for t in range(len(fwd)):
        sends = {}
        for s in pipe.stages:
            i = fwd[t][s]
            if i < 0:
                continue
            x_in = x_micro[i] if s == 0 else inbox.pop((s, i))
            out = stage_fn(params[s], x_in)
            if s < pp - 1:
                sends[("f", s, s + 1)] = out
            else:
                outs.append(out)
        got = pipe.exchange(sends, _expects((fwd, None), t, pipe,
                                            x_micro[0]))
        for (_, frm, to), x in got.items():
            inbox[(to, fwd[t][frm])] = x
    return torch.stack(outs) if outs else None


def _run_schedule(params: dict, x_micro, y_micro, pipe, stage_fn, loss_fn,
                  style: str):
    """The 1F1B / GPipe training pass over the stages of ``pipe``.
    ``params``: stage -> its parameter tree (leaves requiring grad).
    Returns (the sum over microbatches of the last stage's losses, or 0
    elsewhere; stage -> the sum over microbatches of its gradients)."""
    pp, n_micro = pipe.size, x_micro.shape[0]
    fwd, bwd, _, _ = build_1f1b_schedule(n_micro, pp, style)
    n_save = pp if style == "1f1b" else n_micro
    act_dtype = x_micro.dtype
    inbox, gbox, saved = {}, {}, {s: {} for s in pipe.stages}
    leaves = {s: tree_leaves(params[s]) for s in pipe.stages}
    gacc = {s: [torch.zeros_like(p) for p in leaves[s]] for s in pipe.stages}
    loss_sum = torch.zeros((), dtype=torch.float32, device=x_micro.device)
    for t in range(len(fwd)):
        sends = {}
        for s in pipe.stages:
            i = fwd[t][s]
            if i >= 0:  # forward slot: the stage input is all it keeps
                x_in = x_micro[i] if s == 0 else inbox.pop((s, i))
                saved[s][i] = x_in
                if len(saved[s]) > n_save:
                    raise AssertionError(f"stage {s} holds {len(saved[s])} "
                                         f"inputs, over {n_save}")
                if s < pp - 1:
                    with torch.no_grad():
                        sends[("f", s, s + 1)] = stage_fn(
                            params[s], x_in).to(act_dtype)
            i = bwd[t][s]
            if i >= 0:  # backward slot: recompute the forward, then vjp
                with torch.enable_grad():
                    x_in = saved[s].pop(i).detach().requires_grad_(s > 0)
                    out = stage_fn(params[s], x_in)
                    wrt = leaves[s] + ([x_in] if s > 0 else [])
                    if s == pp - 1:
                        loss = loss_fn(out, y_micro[i])
                        grads = torch.autograd.grad(loss, wrt,
                                                    allow_unused=True)
                        loss_sum = loss_sum + loss.detach().float()
                    else:
                        grads = torch.autograd.grad(
                            out, wrt, gbox.pop((s, i)).to(out.dtype),
                            allow_unused=True)
                for a, g in zip(gacc[s], grads):
                    if g is not None:
                        a.add_(g)
                if s > 0:
                    sends[("b", s, s - 1)] = grads[-1].to(act_dtype)
        got = pipe.exchange(sends, _expects((fwd, bwd), t, pipe, x_micro[0]))
        for (kind, frm, to), x in got.items():
            if kind == "f":
                inbox[(to, fwd[t][frm])] = x
            else:
                gbox[(to, bwd[t][frm])] = x
    return loss_sum, gacc


def _microbatch(x, n_micro: int):
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} must divide into {n_micro} microbatches")
    return x.reshape(n_micro, b // n_micro, *x.shape[1:])


def _stage_params(stage_params, mesh, axis: str, param_specs):
    """(pipe, stage -> its parameter tree). Folded (``mesh`` None): every
    stage's slice of the plain leaves; over a mesh: this rank's local
    block of each DTensor, its stage dim squeezed."""
    if mesh is None:
        pp = tree_leaves(stage_params)[0].shape[0]
        return FoldedPipe(pp), {s: tree_map(lambda p: p[s], stage_params)
                                for s in range(pp)}
    from ray_tpu_torch.parallel.sharding import spec_placements

    pipe = GroupPipe(mesh.get_group(axis))

    def local(p, spec=None):
        want = spec_placements(spec if spec is not None else
                               (axis,) + (None,) * (p.dim() - 1),
                               mesh.mesh_dim_names)
        if tuple(p.placements) != want:
            raise ValueError(f"a stage parameter's placements "
                             f"{p.placements} are not its spec's {want}")
        block = p.to_local()
        if block.shape[0] != 1:
            raise ValueError(f"a stage parameter of {p.shape[0]} stages over "
                             f"{axis}={pipe.size}: one stage a rank")
        return block[0]

    tree = (tree_map(local, stage_params) if param_specs is None
            else tree_map(local, stage_params, param_specs))
    return pipe, {pipe.stages[0]: tree}


def pipeline_apply(stage_params, x, mesh, *, stage_fn: Callable,
                   n_micro: int, axis: str = "pp"):
    """Run x [batch, ...] through the stage stack; returns [batch, ...]
    outputs of the last stage, on every rank. ``stage_params``: a tree
    whose leaves have a leading stage dim (over ``mesh``, DTensors
    sharded over ``axis``; with ``mesh=None``, plain tensors run folded in
    this process)."""
    x_micro = _microbatch(x, n_micro)
    pipe, params = _stage_params(stage_params, mesh, axis, None)
    if mesh is None:
        outs = _apply_stream(params, x_micro, pipe, stage_fn)
        return outs.reshape(x.shape[0], *outs.shape[2:])
    with torch.no_grad():
        outs = _apply_stream(params, x_micro, pipe, stage_fn)
        if outs is None:
            outs = torch.empty_like(x_micro)
        outs = pipe.from_last(outs)
    return outs.reshape(x.shape[0], *outs.shape[2:])


def pipeline_value_and_grad(stage_params, x, y, mesh, *,
                            stage_fn: Callable, loss_fn: Callable,
                            n_micro: int, axis: str = "pp",
                            param_specs=None, data_spec=None,
                            grad_psum_axes: tuple = (),
                            style: str = "1f1b"):
    """1F1B (or ``style="gpipe"``) training pass: returns (mean microbatch
    loss, d loss / d stage_params) for ``loss_fn(stage_fn(...last
    stage...), y)``, the loss a 0-d fp32 tensor on every rank and the
    gradients in ``stage_params``' layout (with ``mesh=None``, plain
    tensors with the stage dim whole, every stage run in this process).

    ``param_specs`` (over a mesh) gives the stage parameters' specs where
    they are not ``(axis, None, ...)``; ``data_spec`` the spec of the
    microbatched activations [n_micro, mb, ...] (and y), each rank
    computing on its block; ``grad_psum_axes`` the mesh axes that shard
    data, over which the loss and gradients are averaged."""
    if style not in ("1f1b", "gpipe"):
        raise ValueError(f"style {style!r}: '1f1b' or 'gpipe'")
    x_micro, y_micro = _microbatch(x, n_micro), _microbatch(y, n_micro)
    if data_spec is not None and mesh is not None:
        from ray_tpu_torch.train.train_step import _local_rows

        coord = mesh.get_coordinate()
        x_micro = _local_rows(x_micro, data_spec, mesh, coord)
        y_micro = _local_rows(y_micro, data_spec, mesh, coord)
    pipe, params = _stage_params(stage_params, mesh, axis, param_specs)
    params = {s: tree_map(lambda p: p.detach().requires_grad_(True), tree)
              for s, tree in params.items()}
    loss_sum, gacc = _run_schedule(params, x_micro, y_micro, pipe, stage_fn,
                                   loss_fn, style)
    loss = pipe.sum(loss_sum) / n_micro
    grads = {s: [g / n_micro for g in gs] for s, gs in gacc.items()}
    if mesh is not None:
        for a in grad_psum_axes:  # a mean (gloo has no ReduceOp.AVG)
            group = mesh.get_group(a)
            n = dist.get_world_size(group)
            for t in [loss] + grads[pipe.stages[0]]:
                dist.all_reduce(t, group=group)
                t.div_(n)
    if mesh is None:
        stacked = [torch.stack(gs) for gs in zip(*(grads[s] for s in
                                                   pipe.stages))]
        it = iter(stacked)
        return loss, tree_map(lambda _: next(it), stage_params)
    from torch.distributed.tensor import DTensor

    it = iter(grads[pipe.stages[0]])
    return loss, tree_map(
        lambda p: DTensor.from_local(next(it)[None], mesh, p.placements,
                                     run_check=False, shape=p.shape,
                                     stride=p.stride()),
        stage_params)
