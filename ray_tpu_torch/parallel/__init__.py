"""Parallelism layer (port of ``ray_tpu/parallel``): device meshes over a
``torch.distributed`` process group, the logical-axis sharding rules as
DTensor placements, the pipeline over ``pp`` (``pipeline_apply``,
``pipeline_value_and_grad``), and the collectives the models compute
over ``tp`` with (``tensor_parallel``, which has no JAX counterpart)."""

from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshConfig,
    auto_mesh_config,
    build_hybrid_mesh,
    build_mesh,
    local_device_count,
)
from ray_tpu_torch.parallel.pipeline import (
    build_1f1b_schedule,
    pipeline_apply,
    pipeline_value_and_grad,
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
    "build_1f1b_schedule",
    "pipeline_apply",
    "pipeline_value_and_grad",
    "DEFAULT_RULES",
    "logical_sharding",
    "logical_spec",
    "shard_pytree",
    "with_logical_constraint",
]
