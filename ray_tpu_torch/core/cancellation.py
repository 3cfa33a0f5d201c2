"""Cooperative task cancellation primitives (port of
``ray_tpu/core/cancellation.py``).

The executing side of ``ray.cancel`` (reference: CancelTask in
``src/ray/protobuf/core_worker.proto``, delivered as KeyboardInterrupt to
the worker's execution thread). CPython lets us raise an exception in a
specific thread at its next bytecode boundary — the right unit here, since
one worker process may run tasks on several executor threads (threaded
actors). The caveat matches the reference's: code blocked in a C call
(socket recv, jitted computation) is not interrupted until it returns to
the interpreter; ``force=True`` escalates to killing the worker process.
"""

from __future__ import annotations

import ctypes


def inject_async_exc(thread_ident: int, exc_type) -> None:
    """Raise ``exc_type`` in the thread with ``thread_ident``; ``None``
    clears a pending not-yet-delivered injection (used when a cancel races
    task completion, so the stale exception cannot land on the thread's
    next task)."""
    ctypes.pythonapi.PyThreadState_SetAsyncExc(
        ctypes.c_ulong(thread_ident),
        ctypes.py_object(exc_type) if exc_type is not None else None,
    )


class CancelRegistry:
    """Tracks cancelled task ids and which thread is running which task.

    Used by the local backend: ``cancel``
    before the task runs parks the id (the runner checks ``begin`` and
    skips execution); ``cancel`` mid-run injects into the executor thread;
    ``end`` clears a raced, undelivered injection.
    """

    _MAX_PARKED = 4096  # late cancels for finished tasks must not leak

    def __init__(self, lock):
        self._lock = lock
        # Insertion-ordered so the bound evicts oldest-first (a parked id
        # whose task already finished is never consumed by begin()).
        self.cancelled: dict[str, bool] = {}
        self._running: dict[str, int] = {}

    def cancel(self, task_id: str, exc_type) -> bool:
        """Returns True if the task was running (exception injected).

        The injection happens UNDER the lock: if it raced ahead of it, the
        task could finish and ``end`` could run its clear-pending pass
        before the injection landed — delivering the stale exception to
        whatever the thread runs next."""
        with self._lock:
            self.cancelled[task_id] = True
            while len(self.cancelled) > self._MAX_PARKED:
                self.cancelled.pop(next(iter(self.cancelled)))
            tid = self._running.get(task_id)
            if tid is not None:
                inject_async_exc(tid, exc_type)
                return True
        return False

    def begin(self, task_id: str, thread_ident: int) -> bool:
        """Register the runner; False means already cancelled — skip
        (the id is consumed so the set stays bounded)."""
        with self._lock:
            if task_id in self.cancelled:
                self.cancelled.pop(task_id, None)
                return False
            self._running[task_id] = thread_ident
        return True

    def end(self, task_id: str, thread_ident: int) -> None:
        with self._lock:
            self._running.pop(task_id, None)
            if task_id in self.cancelled:
                self.cancelled.pop(task_id, None)
                inject_async_exc(thread_ident, None)
