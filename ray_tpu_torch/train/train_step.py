"""Train-step factory (port of ``ray_tpu/train/train_step.py``).

Eager PyTorch: forward, backward and AdamW run as they are called; there
is no compilation and, in this slice, no mesh or sharding (one device).
The state is ``{'params', 'opt': {'mu', 'nu'}, 'step'}`` as in the JAX
package; ``step`` is a Python int.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from ray_tpu_torch._tree import tree_leaves, tree_map
from ray_tpu_torch.train.optim import AdamWConfig, adamw_init, adamw_update

Params = Any
TrainState = dict[str, Any]  # {'params', 'opt': {'mu','nu'}, 'step'}


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


def make_init_fn(init_params: Callable[[torch.Generator], Params]):
    """Returns generator -> TrainState."""

    def init(generator: torch.Generator) -> TrainState:
        params = init_params(generator)
        return {"params": params, "opt": adamw_init(params), "step": 0}

    return init


def make_train_step(loss_fn: Callable[[Params, Any], torch.Tensor], *,
                    optimizer: AdamWConfig | None = None,
                    extra_metrics: Callable[[Params, Any], dict] | None = None):
    """Build the (state, batch) -> (state, metrics) step. Metrics are
    ``loss`` and ``grad_norm`` (0-d tensors, not synced to the host) and
    ``lr`` (a float). The state is updated in place and returned."""
    opt_cfg = optimizer or AdamWConfig()

    def step(state: TrainState, batch) -> tuple[TrainState, dict]:
        loss, grads = value_and_grad(loss_fn, state["params"], batch)
        new_params, new_opt, lr, gnorm = adamw_update(
            opt_cfg, grads, state["params"], state["opt"], state["step"])
        new_state = {"params": new_params, "opt": new_opt,
                     "step": state["step"] + 1}
        metrics = {"loss": loss, "lr": lr, "grad_norm": gnorm}
        if extra_metrics is not None:
            metrics.update(extra_metrics(new_params, batch))
        return new_state, metrics

    return step
