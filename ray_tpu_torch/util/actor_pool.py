"""ActorPool: load-balance tasks over a fixed set of actors (port of
``ray_tpu/util/actor_pool.py``).

Reference parity: ``python/ray/util/actor_pool.py`` — same surface
(map / map_unordered / submit / get_next / get_next_unordered / has_next /
has_free / push / pop_idle). Internals are queue-structured rather than
index-counted: submission order lives in one FIFO of futures that ordered
consumption drains (lazily skipping entries already taken out of order),
so there are no return-index bookkeeping counters to keep in sync.
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Iterable, List

import ray_tpu_torch


class ActorPool:
    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        # future -> the actor running it (membership = still in flight).
        self._actor_of: dict = {}
        # Futures in submission order; entries consumed unordered stay in
        # the deque and are skipped lazily when an ordered get reaches
        # them (reference behavior: mixing ordered/unordered gets skips
        # past results already taken).
        self._order: "collections.deque" = collections.deque()
        # Submissions waiting for an actor to free up.
        self._backlog: "collections.deque" = collections.deque()

    def map(self, fn: Callable, values: Iterable):
        """Apply fn(actor, value) over values, yielding results in order."""
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable, values: Iterable):
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable, value):
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._actor_of[future] = actor
            self._order.append(future)
        else:
            self._backlog.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._actor_of) or bool(self._backlog)

    def _oldest_pending(self):
        """Front of the submission queue that is still in flight."""
        while self._order and self._order[0] not in self._actor_of:
            self._order.popleft()  # consumed unordered: skip
        return self._order[0] if self._order else None

    def get_next(self, timeout: float | None = None):
        """Next result in submission order. A timeout leaves the pool
        untouched so the call can be retried."""
        from ray_tpu_torch.core.object_ref import GetTimeoutError

        if not self.has_next():
            raise StopIteration("no more results to get")
        future = self._oldest_pending()
        if future is None:
            # Backlogged work but nothing in flight: no actor can ever pick
            # it up (pool built with zero actors, or all were pop_idle'd).
            raise RuntimeError(
                f"ActorPool has {len(self._backlog)} queued submission(s) "
                "but no actors to run them; push() an actor first")
        try:
            value = ray_tpu_torch.get(future, timeout=timeout)
        except GetTimeoutError:
            raise  # task still running; state unchanged, retryable
        except Exception:
            self._consume(future)  # task finished (with an error)
            raise
        self._consume(future)
        return value

    def get_next_ref(self, timeout: float | None = None):
        """Next result in submission order as an OBJECT REF, without
        fetching the value to this process (the dataset pool path keeps
        blocks in the store instead of round-tripping every block
        through driver memory). Waits for completion; a timeout leaves
        the pool untouched so the call can be retried."""
        if not self.has_next():
            raise StopIteration("no more results to get")
        future = self._oldest_pending()
        if future is None:
            raise RuntimeError(
                f"ActorPool has {len(self._backlog)} queued submission(s) "
                "but no actors to run them; push() an actor first")
        ready, _ = ray_tpu_torch.wait([future], num_returns=1, timeout=timeout)
        if not ready:
            raise TimeoutError("timed out waiting for a result")
        self._consume(future)
        return future

    def get_next_unordered(self, timeout: float | None = None):
        """Earliest-finishing result, any order."""
        if not self.has_next():
            raise StopIteration("no more results to get")
        if not self._actor_of:
            raise RuntimeError(
                f"ActorPool has {len(self._backlog)} queued submission(s) "
                "but no actors to run them; push() an actor first")
        ready, _ = ray_tpu_torch.wait(
            list(self._actor_of), num_returns=1, timeout=timeout
        )
        if not ready:
            raise TimeoutError("timed out waiting for a result")
        future = ready[0]
        try:
            value = ray_tpu_torch.get(future)
        finally:
            self._consume(future)
        return value

    def _consume(self, future):
        actor = self._actor_of.pop(future)
        self._recycle(actor)

    def _recycle(self, actor):
        self._idle.append(actor)
        if self._backlog:
            fn, value = self._backlog.popleft()
            self.submit(fn, value)

    def has_free(self) -> bool:
        return bool(self._idle) and not self._backlog

    def push(self, actor):
        """Add a new idle actor to the pool."""
        self._recycle(actor)

    def pop_idle(self):
        """Remove and return an idle actor, or None if none are idle."""
        return self._idle.pop() if self.has_free() else None


class AutoscalingActorPool(ActorPool):
    """ActorPool that grows on queue depth and shrinks on idle
    (reference ``data/_internal/compute.py:173`` ActorPoolStrategy
    semantics): starts at ``min_size`` actors, adds one whenever a
    submission finds no idle actor and the backlog has reached
    ``scale_up_queue_depth`` (up to ``max_size``), and retires surplus
    actors the moment they go idle with an empty backlog. Driver-side,
    single-threaded like the base pool.

    Every scale decision passes the ``data.pool.before_scale``
    failpoint (a raise-armed site skips that decision — the pool keeps
    working at its current size) and records the pool-size/queue-depth
    gauges through the goodput recorder so the federated scrape sees
    the pool breathe."""

    def __init__(self, make_actor, min_size: int = 1, max_size: int = 4,
                 *, scale_up_queue_depth: int = 2, name: str = "pool"):
        self._make_actor = make_actor
        self.min_size = max(1, int(min_size))
        self.max_size = max(self.min_size, int(max_size))
        self._scale_up_queue_depth = max(1, int(scale_up_queue_depth))
        self.name = name
        self.size = 0
        # (direction, size_after) per scale decision, in order — the
        # observability surface tests and the dataflow bench read.
        self.scale_events: list = []
        super().__init__([])
        for _ in range(self.min_size):
            self._grow(initial=True)

    def _record_gauges(self) -> None:
        try:
            from ray_tpu_torch.util import goodput

            goodput.record_pool_size(self.name, self.size,
                                     len(self._backlog))
        except Exception:
            pass

    def _grow(self, initial: bool = False) -> bool:
        if not initial:
            from ray_tpu_torch.util import failpoints

            try:
                failpoints.hit("data.pool.before_scale")
            except failpoints.FailpointError:
                return False  # chaos vetoed this decision; stay as-is
        try:
            actor = self._make_actor()
        except Exception:
            return False  # no capacity for another actor: stay as-is
        self.size += 1
        if not initial:
            self.scale_events.append(("up", self.size))
        self._record_gauges()
        # ActorPool._recycle drains one backlog entry onto the new actor.
        super()._recycle(actor)
        return True

    def submit(self, fn, value):
        if not self._idle and self.size < self.max_size and \
                len(self._backlog) + 1 >= self._scale_up_queue_depth:
            self._grow()
        super().submit(fn, value)

    def _recycle(self, actor):
        if not self._backlog and self.size > self.min_size:
            # Idle with nothing queued: retire the surplus actor now
            # (scale-down-on-idle; its finished results live in the
            # object store, not in the actor).
            from ray_tpu_torch.util import failpoints

            try:
                failpoints.hit("data.pool.before_scale")
            except failpoints.FailpointError:
                super()._recycle(actor)
                return
            self.size -= 1
            self.scale_events.append(("down", self.size))
            self._record_gauges()
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
            return
        super()._recycle(actor)

    @property
    def peak_size(self) -> int:
        return max([self.min_size]
                   + [s for _d, s in self.scale_events])

    def shutdown(self) -> None:
        """Kill the remaining (idle) actors and zero the gauges. Call
        only after every result was consumed."""
        for actor in list(self._idle):
            try:
                ray_tpu_torch.kill(actor)
            except Exception:
                pass
        self._idle.clear()
        self.size = 0
        self._record_gauges()
