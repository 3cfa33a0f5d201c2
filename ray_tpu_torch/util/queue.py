"""FIFO queue backed by an actor (port of ``ray_tpu/util/queue.py``; its
``driver_node_options``, which pins the actor to a cluster's driver node,
waits for the cluster backend).

Reference parity: ``python/ray/util/queue.py`` — Queue with optional
``maxsize``, blocking put/get with timeouts, nowait variants, batch ops,
and ``Empty``/``Full`` exceptions re-exported.
"""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: list = []

    def qsize(self) -> int:
        return len(self.items)

    def put_nowait(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def put_nowait_batch(self, items: list) -> bool:
        if self.maxsize > 0 and len(self.items) + len(items) > self.maxsize:
            return False
        self.items.extend(items)
        return True

    def get_nowait(self):
        if not self.items:
            return False, None
        return True, self.items.pop(0)

    def get_nowait_batch(self, num_items: int):
        if len(self.items) < num_items:
            return False, None
        out = self.items[:num_items]
        del self.items[:num_items]
        return True, out


class Queue:
    """Actor-backed queue; handles are serializable and shareable."""

    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        opts = dict(actor_options or {})
        opts.setdefault("num_cpus", 0)
        self.actor = (
            ray_tpu_torch.remote(_QueueActor).options(**opts).remote(maxsize)
        )

    def __reduce__(self):
        return (_rebuild_queue, (self.maxsize, self.actor))

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def _poll(self, op, timeout: float | None, err):
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            ok, value = op()
            if ok:
                return value
            if deadline is not None and time.monotonic() >= deadline:
                raise err
            time.sleep(0.005)

    def put(self, item, block: bool = True, timeout: float | None = None):
        if not block:
            if not ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                raise Full
            return
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            # Ship the payload only when the queue looks acceptable; while
            # full, poll the cheap qsize probe instead of re-serializing the
            # item every tick.
            if ray_tpu_torch.get(self.actor.put_nowait.remote(item)):
                return
            while (
                self.maxsize > 0
                and ray_tpu_torch.get(self.actor.qsize.remote()) >= self.maxsize
            ):
                if deadline is not None and time.monotonic() >= deadline:
                    raise Full
                time.sleep(0.005)

    def put_nowait(self, item):
        self.put(item, block=False)

    def put_nowait_batch(self, items: List[Any]):
        if not ray_tpu_torch.get(self.actor.put_nowait_batch.remote(list(items))):
            raise Full

    def get(self, block: bool = True, timeout: float | None = None):
        if not block:
            ok, value = ray_tpu_torch.get(self.actor.get_nowait.remote())
            if not ok:
                raise Empty
            return value

        def op():
            return ray_tpu_torch.get(self.actor.get_nowait.remote())

        return self._poll(op, timeout, Empty())

    def get_nowait(self):
        return self.get(block=False)

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        ok, values = ray_tpu_torch.get(self.actor.get_nowait_batch.remote(num_items))
        if not ok:
            raise Empty
        return values

    def shutdown(self):
        ray_tpu_torch.kill(self.actor)


def _rebuild_queue(maxsize, actor):
    q = object.__new__(Queue)
    q.maxsize = maxsize
    q.actor = actor
    return q
