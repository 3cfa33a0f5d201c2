"""ray_tpu_torch -- the PyTorch/CUDA port of ray_tpu, for NVIDIA Hopper GPUs.

It mirrors ``ray_tpu``'s module paths (``ray_tpu/ops/fused_norm.py`` ->
``ray_tpu_torch/ops/fused_norm.py``) so each file can be held against its
counterpart. It imports ``torch`` and never ``jax``, and nothing from
``ray_tpu``: what it needs from there it carries its own copy of.

Importing the package builds and launches nothing and starts no thread.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; the
CUDA kernels are built from ``ops/csrc/`` at first use.

The task/actor/object API (``init``, ``remote``, ``get``, ``put``, ...)
runs on the local in-process backend; the cluster backend is not ported.
"""

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.api import (
    ObjectRef,
    available_resources,
    cancel,
    cluster_resources,
    get,
    get_actor,
    init,
    is_initialized,
    kill,
    nodes,
    put,
    remote,
    shutdown,
    wait,
)
from ray_tpu_torch.core.object_ref import (
    ActorError,
    GetTimeoutError,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
)

__all__ = [
    "ActorError",
    "GetTimeoutError",
    "ObjectLostError",
    "ObjectRef",
    "TaskCancelledError",
    "TaskError",
    "available_resources",
    "cancel",
    "cluster_resources",
    "get",
    "get_actor",
    "init",
    "is_initialized",
    "kill",
    "nodes",
    "put",
    "remote",
    "resolve_device",
    "shutdown",
    "wait",
]
