"""Train-step factory (port of ``ray_tpu/train/train_step.py``).

Eager PyTorch: forward, backward and AdamW run as they are called; there
is no compilation. The state is ``{'params', 'opt': {'mu', 'nu'},
'step'}`` as in the JAX package; ``step`` is a Python int.

Without a mesh the step runs on one device. With a mesh (a
``parallel.mesh`` ``DeviceMesh`` over every rank of the default group)
the parameters and AdamW moments are DTensors laid out by
``param_shardings`` (the logical-axis rules), and each step:

* keeps this rank's rows of the global batch, by ``batch_spec``;
* gathers every parameter to a plain full tensor, whose gradient
  placements are ``Partial("avg")`` over the mesh axes the batch is
  sharded over and over ``ep``, so the backward reduce-scatters (or
  all-reduces) the gradients to the parameters' own placements -- the
  collectives XLA inserts from the shardings in the JAX package;
* runs the model on plain tensors only, so a DTensor never reaches a
  kernel wrapper;
* updates the local shards (``train/optim.py``) and returns the global
  ``loss`` and ``grad_norm`` on every rank.

What differs from the JAX module, and why:

* The loss is the mean of the ranks' losses over their own rows, where JAX
  computes it over the global batch: the same value for a loss that is a
  mean over rows, as the models' losses are, since every rank holds as
  many rows.
* The whole parameter tree is gathered for the step (not layer by layer),
  and init draws the full tree on every rank before sharding it; JAX
  initialises sharded, without a full copy. At GPT-2 and Llama small a
  full copy on each rank fits.
* Only ``dp``, ``fsdp`` and ``ep`` may exceed 1: ``tp``, ``sp`` and
  ``pp`` above 1 need the model to compute sharded, which is not ported,
  and raise rather than run as storage-only sharding.

``ep`` is the MoE model's expert axis (``models/moe.py`` with
``expert_parallel``). The batch is replicated over it, so every ``ep``
rank computes the same loss, and a rank's expert weights get the
gradient of all ``ep`` ranks' losses through the expert exchange: its own
experts' slice ``ep`` times over, the other experts' none. The mean over
``ep`` is therefore the gradient of the one loss, for the expert weights
and, since every rank computes the same gradient of the others, for every
other parameter.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ray_tpu_torch._tree import tree_leaves, tree_map
from ray_tpu_torch.train.optim import AdamWConfig, adamw_init, adamw_update

Params = Any
TrainState = dict[str, Any]  # {'params', 'opt': {'mu','nu'}, 'step'}

# The batch's rows over the data-parallel axes, dim 0 (JAX's
# P(("dp", "fsdp"))).
DEFAULT_BATCH_SPEC = (("dp", "fsdp"),)

# Mesh axes whose size above 1 needs the model to compute sharded.
_NOT_PORTED_AXES = {
    "tp": "tensor parallelism (ROADMAP A10b)",
    "sp": "ring / Ulysses sequence parallelism (ROADMAP A10, A11)",
    "pp": "the pipeline (ROADMAP A13)",
}

# Mesh axes over which the gathered parameters' gradients are averaged
# besides the batch's: the batch is replicated over ``ep``, the expert
# weights' gradients are not (see above).
_GRAD_MEAN_AXES = {"ep"}


def state_shardings(param_shardings: Params) -> TrainState:
    """Optimizer state mirrors the param tree => shardings are shared; the
    step is a Python int on every rank (None)."""
    return {
        "params": param_shardings,
        "opt": {"mu": param_shardings, "nu": param_shardings},
        "step": None,
    }


def batch_sharding(mesh, spec=None):
    from ray_tpu_torch.parallel.sharding import NamedSharding

    return NamedSharding(mesh, spec if spec is not None else DEFAULT_BATCH_SPEC)


def _check_mesh(mesh) -> None:
    """Raise unless the step can run on ``mesh``: every rank of the default
    group in it, and no axis but ``dp``, ``fsdp`` and ``ep`` above 1."""
    for name, size in zip(mesh.mesh_dim_names, mesh.shape):
        if size > 1 and name in _NOT_PORTED_AXES:
            raise NotImplementedError(
                f"mesh axis {name}={size}: {_NOT_PORTED_AXES[name]} is not "
                "ported; only dp, fsdp and ep may exceed 1")
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"the mesh holds {mesh.size()} of "
                         f"{dist.get_world_size()} ranks; it must hold all")


def value_and_grad(loss_fn: Callable[[Params, Any], torch.Tensor],
                   params: Params, batch) -> tuple[torch.Tensor, Params]:
    """(loss, grads) of ``loss_fn(params, batch)`` with respect to every
    leaf of ``params``, as ``jax.value_and_grad``; the caller's tensors
    are not marked as requiring grad."""
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = loss_fn(leaves, batch)
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss, flat)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), leaves)


def make_init_fn(init_params: Callable[[torch.Generator], Params],
                 param_shardings: Params | None = None, mesh=None):
    """Returns generator -> TrainState. With ``param_shardings`` (and
    their ``mesh``) every rank draws the full tree from its generator --
    the same seed on every rank -- and ``distribute_tensor`` keeps rank 0's
    values, sharded; the moments take the same layout."""
    if (param_shardings is None) != (mesh is None):
        raise ValueError("pass param_shardings and mesh together")
    if mesh is not None:
        _check_mesh(mesh)

    def init(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        if mesh is not None:
            from ray_tpu_torch.parallel.sharding import shard_pytree

            params = shard_pytree(params, param_shardings, mesh)
        return {"params": params, "opt": adamw_init(params), "step": 0}

    return init


def _local_rows(x: torch.Tensor, spec, mesh, coord) -> torch.Tensor:
    """This rank's block of ``x`` by ``spec``: on each dim, the index of
    the rank over the dim's mesh axes (in mesh order, the first
    outermost); an uneven split raises."""
    from ray_tpu_torch.parallel.sharding import spec_axes

    names = mesh.mesh_dim_names
    for d, entry in enumerate(spec):
        n, k = 1, 0
        for a in spec_axes(entry):
            i = names.index(a)
            n, k = n * mesh.shape[i], k * mesh.shape[i] + coord[i]
        if n == 1:
            continue
        if x.shape[d] % n:
            raise ValueError(f"batch dim {d} of size {x.shape[d]} does not "
                             f"split evenly over {spec_axes(entry)} ({n})")
        rows = x.shape[d] // n
        x = x.narrow(d, k * rows, rows)
    return x


def _same(x):
    return x


def make_train_step(loss_fn: Callable[[Params, Any], torch.Tensor],
                    param_shardings: Params | None = None, mesh=None, *,
                    optimizer: AdamWConfig | None = None, batch_spec=None,
                    extra_metrics: Callable[[Params, Any], dict] | None = None):
    """Build the (state, batch) -> (state, metrics) step. Metrics are
    ``loss`` and ``grad_norm`` (0-d tensors, not synced to the host) and
    ``lr`` (a float). The state is updated in place and returned.

    With ``param_shardings`` and ``mesh`` the step takes the global batch
    (the same on every rank) and the sharded state of ``make_init_fn``;
    ``batch_spec`` is the spec of every batch leaf's dims, by default
    ``DEFAULT_BATCH_SPEC``."""
    opt_cfg = optimizer or AdamWConfig()
    if (param_shardings is None) != (mesh is None):
        raise ValueError("pass param_shardings and mesh together")
    if mesh is None:
        return _step_fn(loss_fn, _same, _same, opt_cfg, extra_metrics)

    from torch.distributed.tensor import Partial, Replicate

    from ray_tpu_torch.parallel.sharding import spec_axes, spec_placements

    _check_mesh(mesh)
    if batch_spec is None:
        batch_spec = DEFAULT_BATCH_SPEC
    spec_placements(batch_spec, mesh.mesh_dim_names)  # raises if invalid
    batch_axes = {a for entry in batch_spec for a in spec_axes(entry)}
    mean_axes = batch_axes | _GRAD_MEAN_AXES
    grad_placements = tuple(
        Partial("avg") if name in mean_axes and size > 1 else Replicate()
        for name, size in zip(mesh.mesh_dim_names, mesh.shape))
    replicated = (Replicate(),) * mesh.ndim
    coord = mesh.get_coordinate()

    def gather(p, sharding):
        if p.placements != sharding.placements:
            raise ValueError(f"a parameter's placements {p.placements} are "
                             f"not its sharding's {sharding.placements}")
        return p.redistribute(mesh, replicated).to_local(
            grad_placements=grad_placements)

    def local_batch(batch):
        return tree_map(lambda v: _local_rows(v, batch_spec, mesh, coord),
                        batch)

    def gathered_loss(params, batch):
        return loss_fn(tree_map(gather, params, param_shardings), batch)

    def global_loss(loss):
        # The mean over the global batch, on every rank.
        if mesh.size() > 1:
            dist.all_reduce(loss)
            loss = loss / mesh.size()
        return loss

    return _step_fn(gathered_loss, local_batch, global_loss, opt_cfg,
                    extra_metrics)


def _step_fn(loss_fn, local_batch, global_loss, opt_cfg, extra_metrics):
    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = value_and_grad(loss_fn, state["params"],
                                     local_batch(batch))
        new_params, new_opt, lr, gnorm = adamw_update(
            opt_cfg, grads, state["params"], state["opt"], state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": global_loss(loss), "lr": lr, "grad_norm": gnorm}
        if extra_metrics is not None:
            metrics.update(extra_metrics(new_params, batch))
        return new_state, metrics

    return step
