"""Logical-axis sharding rules (port of ``ray_tpu/parallel/sharding.py``).

Model code names tensor dimensions logically ("batch", "embed", "mlp", ...);
a rules table maps logical names to physical mesh axes. Swapping parallelism
strategy = swapping the rules table, with no model changes.

A spec is a tuple with one entry per tensor dimension, as a
``jax.sharding.PartitionSpec`` iterates: None (replicated), a mesh axis
name, or a tuple of mesh axis names. The port's ``NamedSharding`` turns a
spec into DTensor placements, one per mesh dimension: a mesh axis named on
tensor dimension d is ``Shard(d)``, every other one ``Replicate()``.

What differs from the JAX module, and why:

* Several mesh axes on one tensor dimension must come in mesh order, as
  ``('dp', 'fsdp')`` on the batch: DTensor shards a dimension by the mesh
  dimensions in mesh order (the first the outermost), as JAX does for a
  spec in that order, and has no placement for another order. Another
  order raises rather than give another layout.
* ``with_logical_constraint`` returns ``x``: the port's model code runs on
  plain local tensors (the train step gathers the parameters), where the
  JAX models pass only hints to XLA.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard, distribute_tensor

from ray_tpu_torch._tree import tree_map
from ray_tpu_torch.parallel.mesh import AXIS_ORDER

# logical dim -> physical mesh axis (or tuple of axes, or None = replicated).
# Mirrors the MaxText/t5x convention.
DEFAULT_RULES: dict[str, tuple[str, ...] | None] = {
    "batch": ("dp", "fsdp"),
    "seq": ("sp",),  # activation sequence dim (context parallelism)
    "vocab": ("tp",),
    "embed": ("fsdp",),  # param hidden dim => ZeRO-3 sharding
    "mlp": ("tp",),
    "heads": ("tp",),
    "qkv": ("tp",),
    "kv_seq": ("sp",),
    "layers": ("pp",),  # stacked per-layer params; pp>1 shards stages
    "expert": ("ep",),
    None: None,
}

Spec = tuple  # per tensor dim: None, an axis name, or a tuple of them


def logical_spec(
    logical_axes: Sequence[str | None],
    rules: Mapping[str, tuple[str, ...] | None] | None = None,
) -> Spec:
    """Translate logical dims to a spec via the rules table.

    Each physical axis may be used at most once per spec; later logical dims
    that map to an already-used physical axis fall back to replicated — e.g.
    ('batch', 'seq', 'embed') -> (('dp','fsdp'), 'sp', None)
    because 'batch' already consumed fsdp. This keeps one rules table valid
    for every tensor in the model.
    """
    rules = rules or DEFAULT_RULES
    used: set[str] = set()
    out: list[tuple[str, ...] | str | None] = []
    for name in logical_axes:
        axes = rules.get(name) if name is not None else None
        if axes is None:
            out.append(None)
            continue
        free = tuple(a for a in axes if a not in used)
        if not free:
            out.append(None)
            continue
        used.update(free)
        out.append(free if len(free) > 1 else free[0])
    return tuple(out)


def spec_axes(entry) -> tuple[str, ...]:
    """The mesh axes of one spec entry (None, a name or a tuple)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_placements(spec: Spec, axis_names: Sequence[str] = AXIS_ORDER):
    """One DTensor placement per mesh axis of ``axis_names``: ``Shard(d)``
    for an axis that ``spec`` names on tensor dim d, else ``Replicate()``.
    Raises for an unknown axis, an axis named twice, and several axes on
    one dim out of mesh order."""
    axis_names = tuple(axis_names)
    placements: list = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        unknown = [a for a in axes if a not in axis_names]
        if unknown:
            raise ValueError(f"spec {spec}: no mesh axis {unknown} in "
                             f"{axis_names}")
        idx = [axis_names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(
                f"spec {spec}: axes {axes} on dim {d} are out of mesh order "
                f"{axis_names}; DTensor shards a dim in mesh order only")
        for a, i in zip(axes, idx):
            if placements[i] != Replicate():
                raise ValueError(f"spec {spec}: mesh axis {a!r} used twice")
            placements[i] = Shard(d)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """The port's ``jax.sharding.NamedSharding``: a mesh, a spec, and the
    DTensor placements the spec gives on that mesh."""

    mesh: DeviceMesh
    spec: Spec
    placements: tuple = dataclasses.field(init=False)

    def __post_init__(self):
        object.__setattr__(self, "placements", spec_placements(
            self.spec, self.mesh.mesh_dim_names))


def logical_sharding(
    mesh: DeviceMesh,
    logical_axes: Sequence[str | None],
    rules: Mapping[str, tuple[str, ...] | None] | None = None,
) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(logical_axes, rules))


def with_logical_constraint(x, logical_axes: Sequence[str | None],
                            mesh: DeviceMesh | None = None,
                            rules: Mapping[str, tuple[str, ...] | None]
                            | None = None):
    """A sharding hint by logical names; the port's model code runs on plain
    local tensors, so ``x`` comes back as it is."""
    return x


def shard_pytree(tree, sharding_tree, mesh: DeviceMesh) -> Any:
    """``distribute_tensor`` each leaf of a tree of full tensors onto its
    sharding; every rank passes the same tree shape, and rank 0's values
    are kept."""
    return tree_map(lambda x, s: distribute_tensor(x, s.mesh, s.placements),
                    tree, sharding_tree)
