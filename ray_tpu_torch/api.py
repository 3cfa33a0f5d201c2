"""Public task/actor/object API (port of ``ray_tpu/api.py``; reference:
``python/ray/_private/worker.py`` ``init:1031, get:2242, put:2335,
wait:2391, get_actor:2508``)."""

from __future__ import annotations

import inspect
from typing import Any, Sequence

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch.actor import ActorClass, ActorHandle
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.remote_function import RemoteFunction


def init(address: str | None = None, **kwargs):
    """Connect this process to a runtime.

    address=None or "local" -> in-process backend (single node). Any
    other address (a cluster's control plane) raises NotImplementedError:
    the cluster backend is not ported.
    """
    return _worker.init(address, **kwargs)


def is_initialized() -> bool:
    return _worker.is_initialized()


def shutdown():
    _worker.shutdown()


def remote(*args, **options):
    """``@remote`` decorator for functions and classes, with or without args."""

    def wrap(target):
        if inspect.isclass(target):
            return ActorClass(target, options)
        if callable(target):
            return RemoteFunction(target, options)
        raise TypeError(f"@remote target must be a function or class: {target}")

    if len(args) == 1 and not options and (inspect.isclass(args[0]) or callable(args[0])):
        return wrap(args[0])
    if args:
        raise TypeError("@remote() takes keyword options only")
    return wrap


def put(value: Any) -> ObjectRef:
    if isinstance(value, ObjectRef):
        raise TypeError("Calling put() on an ObjectRef is not allowed")
    return _worker.backend().put(value)


def get(refs, timeout: float | None = None):
    single = isinstance(refs, ObjectRef)
    if single:
        refs = [refs]
    refs = list(refs)
    if not all(isinstance(r, ObjectRef) for r in refs):
        raise TypeError("get() accepts an ObjectRef or a list of ObjectRefs")
    values = _worker.backend().get(refs, timeout)
    return values[0] if single else values


def wait(
    refs: Sequence[ObjectRef],
    *,
    num_returns: int = 1,
    timeout: float | None = None,
    fetch_local: bool = True,
):
    if isinstance(refs, ObjectRef):
        raise TypeError("wait() expects a list of ObjectRefs")
    if num_returns > len(refs):
        raise ValueError(f"num_returns={num_returns} > len(refs)={len(refs)}")
    return _worker.backend().wait(list(refs), num_returns, timeout, fetch_local)


def get_actor(name: str) -> ActorHandle:
    actor_id = _worker.backend().get_named_actor(name)
    return ActorHandle(actor_id, name)


def kill(actor: ActorHandle, *, no_restart: bool = True):
    _worker.backend().kill_actor(actor._actor_id, no_restart)


def cancel(ref: ObjectRef, *, force: bool = False):
    _worker.backend().cancel(ref, force)


def cluster_resources() -> dict:
    return _worker.backend().cluster_resources()


def available_resources() -> dict:
    return _worker.backend().available_resources()


def nodes() -> list[dict]:
    return _worker.backend().nodes()
