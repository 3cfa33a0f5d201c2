"""ObjectRef: a future handle to an immutable object in the object plane
(port of ``ray_tpu/core/object_ref.py``).

Reference parity: ``python/ray/_raylet.pyx`` ObjectRef + the ownership model
of ``src/ray/core_worker/reference_count.h:61`` (every object has an owning
worker). Here the owner is recorded as metadata; local mode has a single
owner (the driver process). The cluster backend's serialization-time ref
capture and its memory monitor's ``OutOfMemoryError`` are not ported.
"""

from __future__ import annotations

from typing import Any


class ObjectRef:
    __slots__ = ("id", "_owner", "__weakref__")

    def __init__(self, object_id: str, owner: str = ""):
        self.id = object_id
        self._owner = owner

    def hex(self) -> str:
        return self.id

    def __repr__(self) -> str:
        return f"ObjectRef({self.id[:16]}…)"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, ObjectRef) and other.id == self.id

    def __hash__(self) -> int:
        return hash(self.id)

    def __reduce__(self):
        return (ObjectRef, (self.id, self._owner))


class TaskError(Exception):
    """A task raised; re-raised at every ray.get of its outputs.

    Mirrors ``ray.exceptions.RayTaskError`` — carries the remote traceback.
    """

    def __init__(self, function_name: str, remote_traceback: str, cause_repr: str):
        self.function_name = function_name
        self.remote_traceback = remote_traceback
        self.cause_repr = cause_repr
        super().__init__(
            f"task {function_name} failed:\n{remote_traceback}"
        )

    def __reduce__(self):
        return (
            TaskError,
            (self.function_name, self.remote_traceback, self.cause_repr),
        )


class TaskCancelledError(TaskError):
    """The task was cancelled via ray_tpu_torch.cancel
    (cf. ``ray.exceptions.TaskCancelledError``). Raised at every get() of
    the cancelled task's outputs. Subclasses TaskError so every store/raise
    path that forwards task failures forwards cancellations unchanged.
    Zero-arg constructible: cooperative cancellation injects the CLASS into
    the executing thread (PyThreadState_SetAsyncExc instantiates it bare).
    """

    def __init__(self, function_name: str = "task",
                 remote_traceback: str = "",
                 cause_repr: str = "cancelled"):
        self.function_name = function_name
        self.remote_traceback = remote_traceback
        self.cause_repr = cause_repr
        Exception.__init__(self, f"task {function_name} was cancelled")

    def __reduce__(self):
        return (
            TaskCancelledError,
            (self.function_name, self.remote_traceback, self.cause_repr),
        )


class ActorError(Exception):
    """The actor died before/while executing this call (cf. RayActorError)."""


class GetTimeoutError(TimeoutError):
    """ray.get(timeout=...) expired (cf. ray.exceptions.GetTimeoutError)."""


class ObjectLostError(Exception):
    """Object is gone and cannot be recovered (cf. ray.exceptions.ObjectLostError)."""
