"""Actor classes and handles (port of ``ray_tpu/actor.py``; reference:
``python/ray/actor.py:377,657,1020``)."""

from __future__ import annotations

from typing import Any

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.options import validate_actor_options


class ActorMethod:
    """Bound method proxy: ``handle.method.remote(args)``."""

    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1,
                 concurrency_group: str | None = None):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def remote(self, *args, **kwargs):
        extra = {}
        if self._concurrency_group is not None:
            extra["concurrency_group"] = self._concurrency_group
        refs = _worker.backend().submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            **extra,
        )
        return refs[0] if self._num_returns == 1 else refs

    def options(self, num_returns: int = 1,
                concurrency_group: str | None = None) -> "ActorMethod":
        """Per-call overrides (reference ``@ray.method`` options):
        ``concurrency_group`` routes the call to one of the actor's
        declared executor groups instead of the default queue."""
        if not isinstance(num_returns, int) or isinstance(num_returns, bool):
            raise ValueError(
                f"num_returns must be an int, got {num_returns!r}"
            )
        return ActorMethod(self._handle, self._method_name, num_returns,
                           concurrency_group)


class ActorHandle:
    def __init__(self, actor_id: str, class_name: str = "Actor"):
        self._actor_id = actor_id
        self._class_name = class_name

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id[:12]}…)"

    def __reduce__(self):
        return (ActorHandle, (self._actor_id, self._class_name))


class ActorClass:
    def __init__(self, cls: type, options: dict[str, Any] | None = None):
        self._cls = cls
        self._options = validate_actor_options(options or {})

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._cls.__name__} cannot be instantiated directly; "
            f"use {self._cls.__name__}.remote()."
        )

    def remote(self, *args, **kwargs) -> ActorHandle:
        actor_id = _worker.backend().create_actor(
            self._cls, args, kwargs, **self._options
        )
        return ActorHandle(actor_id, self._cls.__name__)

    def options(self, **new_options) -> "ActorClass":
        merged = {**self._options, **validate_actor_options(new_options)}
        return ActorClass(self._cls, merged)

    @property
    def cls(self) -> type:
        return self._cls
