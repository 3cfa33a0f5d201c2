"""Parallelism layer (port of ``ray_tpu/parallel``): device meshes over a
``torch.distributed`` process group, and the logical-axis sharding rules
as DTensor placements. The pipeline (``pipeline_apply``) is not ported
yet (ROADMAP A13)."""

from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshConfig,
    auto_mesh_config,
    build_hybrid_mesh,
    build_mesh,
    local_device_count,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    logical_sharding,
    logical_spec,
    shard_pytree,
    with_logical_constraint,
)

__all__ = [
    "AXIS_ORDER",
    "MeshConfig",
    "auto_mesh_config",
    "build_hybrid_mesh",
    "build_mesh",
    "local_device_count",
    "DEFAULT_RULES",
    "logical_sharding",
    "logical_spec",
    "shard_pytree",
    "with_logical_constraint",
]
