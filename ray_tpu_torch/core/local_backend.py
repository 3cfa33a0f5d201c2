"""In-process backend: tasks on a thread pool, actors on dedicated threads
(port of ``ray_tpu/core/local_backend.py``).

This is the ``ray.init(local_mode=...)`` analog but with real asynchrony —
tasks run concurrently and ObjectRefs are genuine futures. It implements the
same ``Backend`` surface the cluster backend (multi-process) implements,
so the public API code is backend-agnostic — preserving the reference's
invariant that libraries sit only on tasks/actors/objects (SURVEY.md §1).

Semantics mirrored from the reference:
* Object table entries are reference-counted against live ``ObjectRef``
  handles plus in-flight task-argument pins, and freed when the count drops
  to zero (``src/ray/core_worker/reference_count.h:61``).
* Actor-task dependencies are resolved on the *caller* side before the call
  is enqueued to the actor, preserving per-caller submission order — the
  ``DependencyResolver`` + sequence-number design of
  ``direct_actor_task_submitter.h``. The actor's execution thread never
  blocks on an unresolved argument.

The copy keeps what the trainer stands on: tasks, actors, ``put``/``get``/
``wait``, kill and cancel, placement groups and resources; and the state
API's local half, so each ``state`` call answers on both backends: task
records with their per-phase wall time, actor and object listings (each
object with its put-time attribution, ``core/attribution.py``), memory
summaries, store and worker stats, spans, and the trace flight recorder
over this process's spans (``cluster/traces.TraceStore``, rebuilt per
query, nothing sampled out). A task or actor call submitted under a span
gets a ``submit:`` span and runs in a ``run:`` span parented under it,
as on a cluster. ``device_stats`` reads the port's
``util/device_telemetry`` (the CUDA devices of this process). The stack
dumps and sampled profiles sample this process's threads
(``util/stack_sampler``); the profiler capture, the ``/metrics`` text and
the (empty) log listing answer for this process too.

Streaming tasks (``num_returns="streaming"``) store each yielded item at
the next return index of the task, then a ``_StreamEnd``; the caller reads
them through an ``ObjectRefGenerator``, and dropping it releases the
unconsumed tail (``release_stream``). An actor method that returns a
coroutine runs on the backend's one shared event loop (reference
``ray_tpu/core/local_backend.py:266-275``, :1258-1274): the executor
thread waits for it, so calls interleave at their awaits when the actor
has ``max_concurrency`` above 1, and a cancel reaches the coroutine.
The internal KV is a dict of this process (reference
``ray_tpu/core/local_backend.py:281-300``). ``runtime_env`` is accepted
and ignored, as the reference's local backend does: one interpreter
cannot give each task its own environment.

Two departures from the reference's local backend (ROADMAP D35): a
killed actor's method, which its thread cannot be made to leave, raises
``ActorError`` at its next ``get`` (the reference's thread runs on to its
end); and an actor placed with ``placement_group_capture_child_tasks``
captures its children as a task does (the reference captures a task's
only), so ``get_current_placement_group()`` inside it names its group.
"""

from __future__ import annotations

import asyncio
import collections
import queue
import threading
import time
import traceback
import weakref
from contextlib import nullcontext
from typing import Any, Callable, Sequence

from ray_tpu_torch.core import ids
from ray_tpu_torch.core.cancellation import CancelRegistry
from ray_tpu_torch.core.object_ref import (
    ActorError,
    GetTimeoutError,
    ObjectRef,
    ObjectLostError,
    TaskCancelledError,
    TaskError,
)
from ray_tpu_torch.core.resources import ResourcePool, default_node_resources, demand_of


class _DaemonPool:
    """Thread pool with daemon threads: in-flight tasks never block
    interpreter exit (cf. the raylet worker pool being killable)."""

    def __init__(self, max_workers: int):
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._max = max_workers
        self._count = 0
        self._idle = 0
        self._lock = threading.Lock()

    def submit(self, fn: Callable, *args) -> None:
        self._q.put((fn, args))
        with self._lock:
            if self._idle == 0 and self._count < self._max:
                self._count += 1
                threading.Thread(target=self._loop, daemon=True).start()

    def _loop(self):
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn, args = self._q.get()
            finally:
                with self._lock:
                    self._idle -= 1
            try:
                fn(*args)
            except BaseException:  # noqa: BLE001 — pool must survive anything
                from ray_tpu_torch.util import metrics as _metrics

                _metrics.count_loop_restart("local.daemon_pool")
                traceback.print_exc()


def _approx_size(value) -> int:
    """Cheap size estimate for the state API's size ordering: exact for
    buffer-bearing values (nbytes), shallow ``getsizeof`` otherwise (the
    local backend never serializes)."""
    nbytes = getattr(value, "nbytes", None)
    if isinstance(nbytes, int):
        return nbytes
    import sys as _sys

    try:
        return _sys.getsizeof(value)
    except Exception:
        return 0


class _Entry:
    """Object-table slot: either a concrete value or a pending event."""

    __slots__ = ("event", "value", "error", "attr", "size")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: BaseException | None = None
        # Put-time attribution (owner/task/callsite/created_at) and size
        # estimate, for state.list_objects / memory_summary.
        self.attr: dict | None = None
        self.size = 0

    def set(self, value):
        self.value = value
        self.event.set()

    def set_error(self, err: BaseException):
        self.error = err
        self.event.set()


class _ActorState:
    def __init__(self, instance, max_concurrency: int, name: str | None):
        self.instance = instance
        self.name = name
        self.dead = False
        self.death_cause: str | None = None
        self.queue: queue.Queue = queue.Queue()
        self.max_concurrency = max_concurrency
        self.threads: list[threading.Thread] = []
        self.lock = threading.Lock()
        # Per-caller-thread submission chains: tail event of the last deferred
        # dispatch, so a caller's calls enqueue in submission order even when
        # argument resolution happens off-thread.
        self.caller_chains: dict[int, threading.Event] = {}
        # Set once the ctor acquires lifetime resources; called on kill.
        self.release_resources: Callable[[], None] | None = None
        # Declared concurrency group names (local mode shares one pool,
        # but an unknown group must still error like the cluster does).
        self.concurrency_groups: set[str] = set()


class _PlacementGroupState:
    """A gang reservation: per-bundle sub-pools carved out of the node pool.

    Single-node analog of the GCS 2-phase commit
    (``gcs_placement_group_scheduler.h:265``): prepare = blocking acquire of
    the union demand from the node pool; commit = expose per-bundle pools.
    """

    def __init__(self, pg_id, bundles, strategy, name):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.name = name
        self.state = "PENDING"  # PENDING | CREATED | INFEASIBLE | REMOVED
        self.union: dict[str, float] = {}
        self.bundle_pools: list[ResourcePool] = []
        self.ready_event = threading.Event()
        self.lock = threading.Lock()
        # Signaled whenever capacity returns to any bundle, so acquirers
        # waiting for "any bundle" wake without busy-polling.
        self.release_cv = threading.Condition()

    def table_entry(self) -> dict:
        return {
            "placement_group_id": self.id,
            "name": self.name,
            "bundles": self.bundles,
            "strategy": self.strategy,
            "state": self.state,
        }


class _Lease:
    """Resources a running task/actor holds, releasable and re-acquirable.

    The release/reacquire pair is what lets a blocked ``get`` give its CPUs
    back — the analog of the raylet releasing a worker's CPUs while it is
    blocked in ``ray.get`` (reference: worker-blocked handling in
    ``node_manager.cc``). If the task's placement group was removed while it
    ran, the release is redirected to the node pool (the bundle pool is
    orphaned; its capacity was already returned).
    """

    __slots__ = ("backend", "pool", "demand", "pg", "held")

    def __init__(self, backend, pool, demand, pg=None):
        self.backend = backend
        self.pool = pool
        self.demand = demand
        self.pg = pg
        self.held = bool(demand)

    def release(self):
        if not self.held:
            return
        self.held = False
        if self.pg is not None:
            with self.pg.lock:
                if self.pg.state == "REMOVED":
                    self.backend._node_pool.release(self.demand)
                    return
                self.pool.release(self.demand)
            with self.pg.release_cv:
                self.pg.release_cv.notify_all()
        else:
            self.pool.release(self.demand)

    def reacquire(self):
        if self.held or not self.demand:
            return
        while True:
            if self.pg is not None and self.pg.state == "REMOVED":
                # Bundle pool is orphaned (its free capacity went back to the
                # node pool at removal, including what we released) — so the
                # node pool is now the right source and sink.
                self.pg = None
                self.pool = self.backend._node_pool
            if self.pool.acquire(self.demand, timeout=0.05):
                self.held = True
                return


_POISON = object()


class LocalBackend:
    """Single-process task/actor/object runtime."""

    def __init__(self, num_cpus: int | None = None, resources: dict | None = None):
        import os

        self._ncpu = num_cpus or os.cpu_count() or 8
        # Oversized pool: tasks may block waiting on upstream deps.
        self._pool = _DaemonPool(max_workers=max(64, self._ncpu * 8))
        self._objects: dict[str, _Entry] = {}
        self._refcounts: dict[str, int] = {}
        # MUST be reentrant: ObjectRef finalizers call _decref, and a GC
        # pass can fire them on whatever thread happens to allocate —
        # including one already inside this lock (e.g. _entry building a
        # threading.Event). A plain Lock self-deadlocks the whole
        # backend when that happens.
        self._objects_lock = threading.RLock()
        self._actors: dict[str, _ActorState] = {}
        self._named_actors: dict[str, str] = {}
        self._lock = threading.Lock()
        self._shutdown = False
        node_res = default_node_resources(self._ncpu)
        node_res.update(resources or {})
        self._node_pool = ResourcePool(node_res)
        self._pgs: dict[str, _PlacementGroupState] = {}
        self._current_pg = threading.local()
        # The resource lease held by the task running on this thread, so a
        # blocking get() can give the CPUs back (raylet parity: workers
        # blocked in ray.get release their CPUs).
        self._current_lease = threading.local()
        # The actor whose executor thread this is (``create_actor``).
        self._current_actor = threading.local()
        # Cancellation: task ids cancelled pre-run + running-thread idents
        # for cooperative mid-run interruption (cancellation.py).
        self._cancels = CancelRegistry(threading.Lock())
        self.node_id = "local"
        # State-API records (bounded): task lifecycle events for
        # list_tasks / summaries / timeline, and each actor's class.
        self._task_records: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        self._task_records_cap = 10_000
        self._actor_records: dict[str, dict] = {}
        # The shared event loop of async actor methods (made at the first
        # coroutine), and the abandoned streams: task id -> the first
        # unconsumed index, whose items are dropped as they are stored.
        self._aio_loop_obj = None
        self._aio_lock = threading.Lock()
        self._released_streams: dict[str, int] = {}
        self._kv: dict = {}

    def _aio_loop(self):
        """The backend's one event loop for async actor methods, on a
        daemon thread of its own (reference
        ``ray_tpu/core/local_backend.py:270``)."""
        with self._aio_lock:
            if self._aio_loop_obj is None:
                loop = asyncio.new_event_loop()
                threading.Thread(target=loop.run_forever, daemon=True,
                                 name="local-aio-loop").start()
                self._aio_loop_obj = loop
        return self._aio_loop_obj

    # -- internal KV -------------------------------------------------------

    def kv_put(self, key: str, value, overwrite: bool = True) -> bool:
        with self._lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            return True

    def kv_get(self, key: str):
        with self._lock:
            return self._kv.get(key)

    def kv_del(self, key: str) -> bool:
        with self._lock:
            return self._kv.pop(key, None) is not None

    def kv_keys(self, prefix: str = "") -> list[str]:
        with self._lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # -- ref counting ------------------------------------------------------

    def make_ref(self, oid: str, owner: str | None = None) -> ObjectRef:
        """Mint an ObjectRef whose lifetime pins the object-table entry.
        ``owner`` is the cluster backend's directory address; one process
        owns everything here, and it is taken for ``ObjectRefGenerator``."""
        with self._objects_lock:
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1
        ref = ObjectRef(oid)
        weakref.finalize(ref, self._decref, oid)
        return ref

    def _incref(self, oid: str):
        with self._objects_lock:
            self._refcounts[oid] = self._refcounts.get(oid, 0) + 1

    def _decref(self, oid: str):
        with self._objects_lock:
            n = self._refcounts.get(oid, 0) - 1
            if n <= 0:
                self._refcounts.pop(oid, None)
                e = self._objects.get(oid)
                # Free only resolved entries; a pending task result with no
                # handles left is freed when the task completes (see
                # _store_returns).
                if e is not None and e.event.is_set():
                    del self._objects[oid]
            else:
                self._refcounts[oid] = n

    # -- object plane -----------------------------------------------------

    def _entry(self, oid: str) -> _Entry:
        with self._objects_lock:
            e = self._objects.get(oid)
            if e is None:
                e = self._objects[oid] = _Entry()
            return e

    def put(self, value: Any) -> ObjectRef:
        from ray_tpu_torch.core import attribution

        oid = ids.new_object_id()
        ref = self.make_ref(oid)
        e = self._entry(oid)
        e.attr = attribution.make("local")
        e.size = _approx_size(value)
        e.set(value)
        return ref

    def get(self, refs: Sequence[ObjectRef], timeout: float | None = None):
        import time

        actor = getattr(self._current_actor, "state", None)
        if actor is not None and actor.dead:
            # A killed actor's running method cannot be stopped in its
            # thread; it stops here, at its next get, as the reference's
            # killed worker process stops at once.
            raise ActorError(f"this actor is dead: {actor.death_cause}")
        deadline = None if timeout is None else time.monotonic() + timeout
        lease: _Lease | None = getattr(self._current_lease, "lease", None)
        released = False
        out = []
        try:
            for r in refs:
                with self._objects_lock:
                    e = self._objects.get(r.id)
                if e is None:
                    if self._refcounts.get(r.id):
                        e = self._entry(r.id)
                    else:
                        raise ObjectLostError(
                            f"object {r.id[:16]}… was freed (all references dropped)"
                        )
                if not e.event.is_set() and lease is not None and not released:
                    # About to block inside a task: give the CPUs back so
                    # nested tasks can run (deadlock avoidance).
                    lease.release()
                    released = True
                remaining = (
                    None if deadline is None else max(0.0, deadline - time.monotonic())
                )
                if not e.event.wait(remaining):
                    raise GetTimeoutError(f"ray_tpu_torch.get timed out on {r}")
                if e.error is not None:
                    raise e.error
                out.append(e.value)
        finally:
            if released:
                lease.reacquire()
        return out

    def wait(
        self,
        refs: Sequence[ObjectRef],
        num_returns: int,
        timeout: float | None,
        fetch_local: bool = True,
    ):
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list[ObjectRef] = []
        pending = list(refs)
        while len(ready) < num_returns:
            progressed = False
            for r in list(pending):
                if self._entry(r.id).event.is_set():
                    ready.append(r)
                    pending.remove(r)
                    progressed = True
                    if len(ready) >= num_returns:
                        break
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            if not progressed:
                time.sleep(0.001)
        return ready, pending

    # -- resources + placement groups -------------------------------------

    def _plan_resources(self, options: dict, *, is_actor: bool) -> dict:
        """Resolve options into {demand, pg, bundle_index}; raise on demands
        this node can never satisfy (surfaced at submit time, unlike the
        reference which leaves the task pending forever)."""
        from ray_tpu_torch.util.scheduling_strategies import (
            PlacementGroupSchedulingStrategy,
            validate_strategy,
        )

        demand = demand_of(options, is_actor=is_actor)
        strategy = options.get("scheduling_strategy")
        validate_strategy(strategy)
        pg_handle = options.get("placement_group")
        bundle_index = options.get("placement_group_bundle_index", -1)
        capture = False
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg_handle = strategy.placement_group
            bundle_index = strategy.placement_group_bundle_index
            capture = strategy.placement_group_capture_child_tasks
        if pg_handle is None and strategy in (None, "DEFAULT"):
            # Child-task capture: inherit the caller's PG if it asked for it.
            inherited = getattr(self._current_pg, "info", None)
            if inherited is not None:
                pg_handle = inherited["id"]
                bundle_index = -1
                capture = True
        pg_state = None
        if pg_handle is not None:
            pg_id = getattr(pg_handle, "id", pg_handle)
            pg_state = self._pgs.get(pg_id)
            if pg_state is None:
                raise ValueError(f"no such placement group: {pg_id}")
            if pg_state.state == "INFEASIBLE":
                raise ValueError(f"placement group {pg_id} is infeasible")
            if bundle_index >= len(pg_state.bundles) or bundle_index < -1:
                raise ValueError(
                    f"bundle index {bundle_index} out of range for placement "
                    f"group {pg_id} with {len(pg_state.bundles)} bundles"
                )
            for b in (
                pg_state.bundles
                if bundle_index < 0
                else [pg_state.bundles[bundle_index]]
            ):
                if all(b.get(k, 0.0) >= v for k, v in demand.items()):
                    break
            else:
                raise ValueError(
                    f"demand {demand} does not fit any bundle of placement "
                    f"group {pg_id} (bundles: {pg_state.bundles})"
                )
        elif demand and not self._node_pool.feasible(demand):
            raise ValueError(
                f"demand {demand} is infeasible on this node "
                f"(total: {self._node_pool.total})"
            )
        return {
            "demand": demand,
            "pg": pg_state,
            "bundle_index": bundle_index,
            "capture": capture,
        }

    def _acquire_planned(self, plan: dict) -> _Lease:
        """Blocking-acquire the planned resources; returns the held lease."""
        demand, pg = plan["demand"], plan["pg"]
        if pg is None:
            self._node_pool.acquire(demand)
            return _Lease(self, self._node_pool, demand)
        pg.ready_event.wait()
        idx = plan["bundle_index"]
        while True:
            if pg.state == "REMOVED":
                raise ValueError(f"placement group {pg.id} was removed")
            candidates = (
                list(range(len(pg.bundle_pools))) if idx < 0 else [idx]
            )
            for i in candidates:
                pool = pg.bundle_pools[i]
                if pool.try_acquire(demand):
                    return _Lease(self, pool, demand, pg)
            if not demand:
                return _Lease(self, self._node_pool, {})
            with pg.release_cv:
                pg.release_cv.wait(0.05)

    def create_placement_group(
        self, bundles: list, strategy: str, name: str = "", lifetime=None,
        spot: bool = True,
    ) -> str:
        pg_id = ids.new_placement_group_id()
        pg = _PlacementGroupState(pg_id, bundles, strategy, name)
        union: dict[str, float] = {}
        for b in bundles:
            for k, v in b.items():
                union[k] = union.get(k, 0.0) + v
        pg.union = union
        # Single-node backend: STRICT_SPREAD needs len(bundles) distinct
        # nodes, so >1 bundle is infeasible here by definition.
        if (strategy == "STRICT_SPREAD" and len(bundles) > 1) or (
            not self._node_pool.feasible(union)
        ):
            pg.state = "INFEASIBLE"
            self._pgs[pg_id] = pg
            return pg_id
        self._pgs[pg_id] = pg

        def reserve():
            # Poll-acquire so a concurrent removal cancels the reservation
            # instead of leaving this thread blocked forever.
            while not self._node_pool.acquire(union, timeout=0.05):
                if pg.state == "REMOVED":
                    return
            with pg.lock:
                if pg.state == "REMOVED":
                    self._node_pool.release(union)
                    return
                pg.bundle_pools = [ResourcePool(b) for b in bundles]
                pg.state = "CREATED"
                pg.ready_event.set()

        self._pool.submit(reserve)
        return pg_id

    def remove_placement_group(self, pg_id: str) -> None:
        pg = self._pgs.get(pg_id)
        if pg is None:
            return
        with pg.lock:
            prev = pg.state
            pg.state = "REMOVED"
            if prev == "CREATED":
                # Return only capacity not currently held by running
                # tasks/actors; their leases release straight to the node
                # pool once they finish (see _Lease.release).
                freed: dict[str, float] = {}
                for pool in pg.bundle_pools:
                    for k, v in pool.available().items():
                        freed[k] = freed.get(k, 0.0) + v
                self._node_pool.release(freed)
        # Wake anything blocked on readiness; they observe REMOVED and fail.
        pg.ready_event.set()
        with pg.release_cv:
            pg.release_cv.notify_all()

    def placement_group_ready(self, pg_id: str) -> ObjectRef:
        oid = ids.new_object_id()
        ref = self.make_ref(oid)
        pg = self._pgs.get(pg_id)
        entry = self._entry(oid)
        if pg is None or pg.state in ("INFEASIBLE", "REMOVED"):
            entry.set_error(
                ValueError(f"placement group {pg_id} cannot become ready")
            )
            return ref

        def waiter():
            pg.ready_event.wait()
            if pg.state == "REMOVED":
                entry.set_error(ValueError(f"placement group {pg_id} was removed"))
            else:
                entry.set(pg_id)

        self._pool.submit(waiter)
        return ref

    def placement_group_table(self, pg_id: str | None = None):
        if pg_id is not None:
            pg = self._pgs.get(pg_id)
            return pg.table_entry() if pg else None
        return {pid: pg.table_entry() for pid, pg in self._pgs.items()}

    def current_placement_group(self):
        return getattr(self._current_pg, "info", None)

    # -- state records ----------------------------------------------------

    def _record_task(self, task_id: str, name: str, kind: str = "NORMAL_TASK"):
        with self._lock:
            if len(self._task_records) >= self._task_records_cap:
                self._task_records.popitem(last=False)
            self._task_records[task_id] = {
                "task_id": task_id,
                "name": name,
                "type": kind,
                "state": "PENDING",
                "submitted_at": time.time(),
                "start_time": None,
                "end_time": None,
                "error": None,
                # Wall-ns per execution phase (get_args/execute/
                # put_outputs): the shape cluster workers report.
                "phases": {},
            }

    def _record_task_phase(self, task_id: str, name: str, ns: int) -> None:
        with self._lock:
            rec = self._task_records.get(task_id)
            if rec is not None:
                phases = rec.setdefault("phases", {})
                phases[name] = phases.get(name, 0) + int(ns)

    def _record_task_attempt(self, task_id: str) -> None:
        """A new execution attempt begins: stamp start_time (the first
        attempt anchors the timeline slice) and drop the previous
        attempt's phases, so a retried task reports the phases of the
        attempt that produced its outcome."""
        with self._lock:
            rec = self._task_records.get(task_id)
            if rec is not None:
                if rec["start_time"] is None:
                    rec["start_time"] = time.time()
                rec["phases"] = {}

    def _record_task_state(self, task_id: str, state: str,
                           error: str | None = None):
        with self._lock:
            rec = self._task_records.get(task_id)
            if rec is None:
                return
            rec["state"] = state
            if state == "RUNNING":
                if rec["start_time"] is None:
                    rec["start_time"] = time.time()
            elif state in ("FINISHED", "FAILED", "CANCELLED"):
                rec["end_time"] = time.time()
                rec["error"] = error

    def list_tasks(self, limit: int = 1000) -> list[dict]:
        with self._lock:
            return [dict(r) for r in list(self._task_records.values())[-limit:]]

    def list_actors(self) -> list[dict]:
        out = []
        for actor_id, state in list(self._actors.items()):
            rec = self._actor_records.get(actor_id, {})
            out.append({
                "actor_id": actor_id,
                "class_name": rec.get("class_name", "?"),
                "name": state.name,
                "state": "DEAD" if state.dead else "ALIVE",
                "node_id": self.node_id,
                "death_cause": state.death_cause,
            })
        return out

    def list_objects(self, limit: int = 1000) -> dict:
        """{"objects": [...], "truncated": bool, "total": int} sorted by
        size descending: the limit clips AFTER the sort, and clipping is
        reported."""
        now = time.time()
        with self._objects_lock:
            # Snapshot first: building the records allocates, which can
            # fire an ObjectRef finalizer -> a reentrant _decref.
            items = list(self._objects.items())
            out = []
            for oid, entry in items:
                attr = entry.attr or {}
                created = attr.get("created_at")
                out.append({
                    "object_id": oid,
                    "status": "READY" if entry.event.is_set() else "PENDING",
                    "refcount": self._refcounts.get(oid, 0),
                    "size": entry.size,
                    "owner": attr.get("owner", ""),
                    "task": attr.get("task", ""),
                    "callsite": attr.get("callsite", ""),
                    "nodes": ["local"],
                    "age_s": round(now - created, 3) if created else None,
                })
        out.sort(key=lambda r: r["size"], reverse=True)
        total = len(out)
        return {"objects": out[:limit], "truncated": total > limit,
                "total": total}

    def memory_summary(self, top_k: int = 20,
                       group_by: str = "callsite") -> dict:
        """Single-process analog of the cluster memory rollup: this
        backend's object table grouped by callsite / task / node / owner
        (sizes are the local estimates: there is no store to meter)."""
        if group_by not in ("callsite", "task", "node", "owner"):
            raise ValueError(
                f"group_by must be callsite|task|node|owner, "
                f"got {group_by!r}")
        listing = self.list_objects(limit=1 << 20)["objects"]
        bytes_used = sum(r["size"] for r in listing)
        groups: dict[str, dict] = {}
        for r in listing:
            key = (self.node_id if group_by == "node"
                   else r.get(group_by)) or "(unknown)"
            g = groups.setdefault(key, {"key": key, "bytes": 0,
                                        "objects": 0})
            g["bytes"] += r["size"]
            g["objects"] += 1
        node = {"bytes_used": bytes_used, "bytes_capacity": 0,
                "occupancy": 0.0, "objects": len(listing), "evictions": 0,
                "spilled_bytes": 0, "oom_reports": []}
        return {
            "totals": {"bytes_used": bytes_used, "bytes_capacity": 0,
                       "objects": len(listing), "evictions": 0,
                       "spilled_bytes": 0, "spilled_objects": 0,
                       "nodes": 1},
            "nodes": {self.node_id: node},
            "top_objects": listing[:top_k],
            "group_by": group_by,
            "groups": sorted(groups.values(),
                             key=lambda g: g["bytes"], reverse=True),
            "leaks": 0,
        }

    def memory_leaks(self) -> list[dict]:
        """The local backend frees on the last decref: nothing is left
        unreachable-but-pinned to sweep."""
        return []

    def object_store_stats(self, node_id=None,
                           include_objects: bool = True) -> list[dict]:
        listing = self.list_objects(limit=1 << 20)["objects"]
        report = {
            "node_id": self.node_id,
            "stats": {"capacity": 0,
                      "used": sum(r["size"] for r in listing),
                      "num_objects": len(listing), "num_evictions": 0,
                      "spilled_objects": 0, "spilled_bytes": 0},
            "oom_reports": [],
        }
        if include_objects:
            report["objects"] = listing
        return [report]

    def worker_stats(self, fresh: bool = False) -> list[dict]:
        """No worker processes: tasks run on this process's threads."""
        return []

    def list_spans(self, trace_id=None, limit: int = 10_000) -> list[dict]:
        """This process's finished spans (the cluster backend reads the
        head's span store)."""
        from ray_tpu_torch.util import tracing

        spans = tracing.collect()
        if trace_id is not None:
            spans = [s for s in spans if s["trace_id"] == trace_id]
        return spans[-limit:]

    def _trace_store(self):
        """A fresh TraceStore over this process's finished spans: one
        process, so no clock alignment and no quiet window, and nothing
        tail-sampled out. Rebuilt per query; the span buffer itself is
        the bounded state."""
        from ray_tpu_torch.cluster.traces import TraceStore
        from ray_tpu_torch.core.config import config
        from ray_tpu_torch.util import tracing

        store = TraceStore(
            max_traces=config.head_trace_retention,
            sample_rate=1.0,
            slow_threshold_s=config.trace_slow_threshold_s,
            max_spans_per_trace=config.trace_max_spans,
            quiet_s=0.0)
        store.add_spans(tracing.collect())
        store.finalize_quiet(force=True)
        return store

    def get_trace(self, trace_id: str):
        return self._trace_store().get(trace_id)

    def list_traces(self, limit: int = 50) -> list:
        return self._trace_store().list(limit)

    def trace_stats(self) -> dict:
        return self._trace_store().stats()

    def ttft_decomposition(self, window_s: float | None = None,
                           deployment: str | None = None) -> dict:
        return self._trace_store().ttft_decomposition(
            window_s=window_s, deployment=deployment)

    # -- telemetry ---------------------------------------------------------

    # -- logs, stacks and profiles: everything runs in THIS process, so
    # stacks and profiles sample its own threads (tasks run on pool
    # threads here); there are no per-worker log files.

    def list_logs(self) -> list[dict]:
        return []

    def get_log(self, worker_id: str, *a, **kw):
        raise ValueError(
            "the local backend runs tasks in-process and captures no "
            "per-worker log files (use a cluster for state.get_log)")

    def dump_worker_stack(self, worker_id: str | None = None,
                          node_id=None) -> str:
        import os as _os

        from ray_tpu_torch.util import stack_sampler

        return stack_sampler.dump_stacks(
            header=f"local backend (pid {_os.getpid()})")

    def profile_worker(self, worker_id: str | None = None,
                       duration_s: float = 1.0, interval_s: float = 0.01,
                       node_id=None) -> dict:
        from ray_tpu_torch.util import stack_sampler

        prof = stack_sampler.sample(duration_s, interval_s)
        prof["worker_id"] = worker_id or "local"
        prof["node_id"] = self.node_id
        return prof

    def capture_profile(self, worker_id=None, duration_s: float = 1.0,
                        interval_s: float = 0.01, out_dir=None,
                        node_id=None) -> dict:
        """A profiler window over this process (``torch.profiler`` where
        CUDA is up here, the stack sampler otherwise), its files in
        ``out_dir`` (a fresh temporary directory by default)."""
        import os as _os
        import tempfile

        from ray_tpu_torch.util import device_telemetry

        out_dir = out_dir or tempfile.mkdtemp(prefix="rtorch_tprof_")
        res = device_telemetry.capture_to_dir(
            out_dir, duration_s, interval_s, worker_id=worker_id or "local")
        return {"kind": res["kind"], "worker_id": worker_id or "local",
                "node_id": self.node_id, "duration_s": res["duration_s"],
                "dir": out_dir,
                "files": [_os.path.join(out_dir, rel)
                          for rel in sorted(res["files"])]}

    def cluster_metrics_text(self) -> str:
        """One process: the federated view IS this registry."""
        from ray_tpu_torch.util import metrics as _metrics

        return _metrics.prometheus_text()

    def device_stats(self, fresh: bool = False) -> list[dict]:
        """This process's CUDA device view (a stub until something creates
        a CUDA context -- the snapshot never creates one itself)."""
        from ray_tpu_torch.util import device_telemetry

        snap = device_telemetry.snapshot()
        snap["worker_id"] = "local"
        snap["node_id"] = self.node_id
        return [snap]

    # -- task plane -------------------------------------------------------

    def _pin_ref_args(self, args, kwargs) -> list[str]:
        """Pin ObjectRef arguments for the duration of a task (the lineage-
        pinning analog of TaskManager, ``task_manager.h:87``)."""
        pins = [a.id for a in args if isinstance(a, ObjectRef)]
        pins += [v.id for v in kwargs.values() if isinstance(v, ObjectRef)]
        for oid in pins:
            self._incref(oid)
        return pins

    def _unpin(self, pins: list[str]):
        for oid in pins:
            self._decref(oid)

    def _resolve_args(self, args, kwargs):
        args = [self.get([a])[0] if isinstance(a, ObjectRef) else a for a in args]
        kwargs = {
            k: self.get([v])[0] if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return args, kwargs

    def _set_result(self, oid: str, value) -> None:
        """Store one task-return value with put-time attribution (the
        creating task's name comes from the ambient task_context)."""
        from ray_tpu_torch.core import attribution

        e = self._entry(oid)
        e.attr = attribution.make("local", default_task="task")
        e.size = _approx_size(value)
        e.set(value)

    def _store_returns(self, oids: list[str], result, num_returns):
        if num_returns == "streaming":
            return self._store_stream(oids, result)
        if num_returns == 1:
            self._set_result(oids[0], result)
        else:
            vals = list(result)
            if len(vals) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(vals)} values"
                )
            for oid, v in zip(oids, vals):
                self._set_result(oid, v)
        self._gc_unreferenced(oids)

    def _store_stream(self, oids: list[str], result) -> bool:
        """The generator protocol (reference
        ``ray_tpu/core/local_backend.py:923-960``): each yielded item at the
        next return index, then a ``_StreamEnd``; a mid-stream error is
        stored AT the failing index, where the consumer raises. Returns
        False on failure, contained here: index 0 may already hold an
        item the generic error path would overwrite, and a stream the
        consumer has read from must not be retried. An item of a released
        stream's tail is dropped as soon as it is stored."""
        from ray_tpu_torch.core.object_ref import _StreamEnd

        task_id = ids.task_of_object(oids[0])[0]
        i = 0
        try:
            for item in result:
                self._set_stream_item(task_id, i, item)
                i += 1
            self._set_stream_item(task_id, i, _StreamEnd())
        except BaseException as e:  # noqa: BLE001 — stored at its index
            err = e if isinstance(e, TaskCancelledError) else TaskError(
                "streaming_task", traceback.format_exc(), repr(e))
            self._set_stream_item(task_id, i, err, error=True)
            self._record_task_state(
                task_id, "CANCELLED" if err is e else "FAILED", repr(e))
            self._gc_unreferenced(oids)
            return False
        self._gc_unreferenced(oids)
        return True

    def _set_stream_item(self, task_id: str, i: int, value,
                         error: bool = False) -> None:
        oid = ids.object_id_for(task_id, i)
        if error:
            self._entry(oid).set_error(value)
        else:
            self._set_result(oid, value)
        with self._objects_lock:
            cut = self._released_streams.get(task_id)
            if cut is not None and i >= cut and not self._refcounts.get(oid):
                self._objects.pop(oid, None)

    def release_stream(self, task_id: str, from_index: int) -> None:
        """Drop an abandoned stream's unconsumed items (the
        ``ObjectRefGenerator`` finalizer; reference
        ``ray_tpu/core/local_backend.py:962``): cancel a still-running
        producer, then delete the items stored from ``from_index`` on.
        Items it stores after this are dropped as they land."""
        with self._objects_lock:
            self._released_streams[task_id] = int(from_index)
            while len(self._released_streams) > 100_000:
                del self._released_streams[next(iter(self._released_streams))]
        self._cancels.cancel(task_id, TaskCancelledError)
        i = from_index
        while True:
            oid = ids.object_id_for(task_id, i)
            with self._objects_lock:
                e = self._objects.get(oid)
                if e is None or not e.event.is_set():
                    break
                if not self._refcounts.get(oid):
                    del self._objects[oid]
            i += 1

    def _store_error(self, oids: list[str], err: BaseException):
        for oid in oids:
            self._entry(oid).set_error(err)
        self._gc_unreferenced(oids)

    def _gc_unreferenced(self, oids: list[str]):
        with self._objects_lock:
            for oid in oids:
                if not self._refcounts.get(oid):
                    self._objects.pop(oid, None)

    def submit_task(
        self,
        func: Callable,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        max_retries: int = 0,
        retry_exceptions: bool | tuple = False,
        name: str = "",
        **_options,
    ) -> list[ObjectRef]:
        task_id = ids.new_task_id()
        # A streaming task tracks index 0 only; the generator mints the
        # refs of later items (reference local_backend.py:1001).
        n_oids = 1 if num_returns == "streaming" else num_returns
        oids = [ids.object_id_for(task_id, i) for i in range(n_oids)]
        refs = [self.make_ref(o) for o in oids]
        fname = name or getattr(func, "__name__", "task")
        self._record_task(task_id, fname)
        try:
            plan = self._plan_resources(_options, is_actor=False)
        except (ValueError, TypeError) as e:
            self._record_task_state(task_id, "FAILED", repr(e))
            self._store_error(oids, e)
            return refs
        pins = self._pin_ref_args(args, kwargs)
        from ray_tpu_torch.core import attribution
        from ray_tpu_torch.util import tracing

        # Submit-time callsite: by store time the user frames are gone,
        # so the .remote() line is the return objects' creation site.
        submit_site = attribution.submit_site()

        def run():
            try:
                if not self._cancels.begin(task_id, threading.get_ident()):
                    self._record_task_state(task_id, "CANCELLED")
                    self._store_error(oids, TaskCancelledError(fname))
                    return
                # The run span parents under the submit span's context,
                # the shape a cluster worker gives it.
                run_cm = (tracing.span(f"run:{fname}",
                                       {"task_id": task_id},
                                       parent=trace_ctx)
                          if trace_ctx and tracing.is_enabled()
                          else nullcontext())
                # Attribution context: the task's returns and any nested
                # puts its user code makes attribute to this task name.
                with attribution.task_context(fname, submit_site), run_cm:
                    run_attempts()
            finally:
                try:
                    self._cancels.end(task_id, threading.get_ident())
                finally:
                    self._unpin(pins)

        def run_attempts():
            attempts = 0
            while True:
                try:
                    # Stamp start BEFORE arg resolution (the get_args
                    # slice must nest in the task's timeline slice); the
                    # state stays PENDING until resources are held.
                    self._record_task_attempt(task_id)
                    t_phase = time.monotonic_ns()
                    a, kw = self._resolve_args(args, kwargs)
                    self._record_task_phase(
                        task_id, "get_args", time.monotonic_ns() - t_phase)
                    lease = self._acquire_planned(plan)
                    self._current_lease.lease = lease
                    if plan["capture"]:
                        self._current_pg.info = {
                            "id": plan["pg"].id,
                            "bundles": plan["pg"].bundles,
                            "strategy": plan["pg"].strategy,
                            "name": plan["pg"].name,
                        }
                    self._record_task_state(task_id, "RUNNING")
                    t_phase = time.monotonic_ns()
                    try:
                        result = func(*a, **kw)
                        self._record_task_phase(
                            task_id, "execute",
                            time.monotonic_ns() - t_phase)
                        if num_returns == "streaming":
                            # The generator's body runs while it is
                            # iterated: the lease stays held for it
                            # (reference local_backend.py:1081-1096).
                            t_phase = time.monotonic_ns()
                            ok = self._store_returns(oids, result,
                                                     num_returns)
                            self._record_task_phase(
                                task_id, "put_outputs",
                                time.monotonic_ns() - t_phase)
                    finally:
                        self._current_lease.lease = None
                        lease.release()
                        if plan["capture"]:
                            self._current_pg.info = None
                    if num_returns == "streaming":
                        if ok:
                            self._record_task_state(task_id, "FINISHED")
                        return  # a failure is recorded where it is stored
                    t_phase = time.monotonic_ns()
                    self._store_returns(oids, result, num_returns)
                    self._record_task_phase(
                        task_id, "put_outputs", time.monotonic_ns() - t_phase)
                    self._record_task_state(task_id, "FINISHED")
                    return
                except BaseException as e:  # noqa: BLE001 — stored, not dropped
                    if isinstance(e, TaskCancelledError):
                        self._record_task_state(task_id, "CANCELLED")
                        self._store_error(oids, e)
                        return
                    self._record_task_state(task_id, "FAILED", repr(e))
                    retriable = retry_exceptions is True or (
                        isinstance(retry_exceptions, tuple)
                        and isinstance(e, retry_exceptions)
                    )
                    if retriable and attempts < max_retries:
                        attempts += 1
                        continue
                    if isinstance(e, (TaskError, ActorError)):
                        self._store_error(oids, e)
                    else:
                        self._store_error(
                            oids,
                            TaskError(fname, traceback.format_exc(), repr(e)),
                        )
                    return

        # The submission span covers the enqueue only (dispatch is
        # async); its context is the trace_ctx the run span parents under.
        with tracing.span(f"submit:{fname}", {"task_id": task_id}) as sp:
            trace_ctx = ({"trace_id": sp["trace_id"],
                          "span_id": sp["span_id"]}
                         if sp is not None else None)
            self._pool.submit(run)
        return refs

    # -- actor plane ------------------------------------------------------

    def create_actor(
        self,
        cls: type,
        args: tuple,
        kwargs: dict,
        *,
        name: str | None = None,
        max_concurrency: int = 1,
        **_options,
    ) -> str:
        actor_id = ids.new_actor_id()
        # Local-mode approximation of concurrency groups: the group
        # threads join one shared pool (total parallelism matches; the
        # per-group queue ISOLATION is a cluster-backend property).
        groups = _options.get("concurrency_groups") or {}
        max_concurrency += sum(int(n) for n in groups.values())
        plan = self._plan_resources(_options, is_actor=True)  # raises if infeasible
        with self._lock:
            if name is not None:
                if name in self._named_actors:
                    raise ValueError(f"actor name {name!r} already taken")
                self._named_actors[name] = actor_id
        state = _ActorState(None, max_concurrency, name)
        state.concurrency_groups = set(groups)
        self._actors[actor_id] = state
        self._actor_records[actor_id] = {"class_name": cls.__name__}
        pins = self._pin_ref_args(args, kwargs)

        ctor_done = threading.Event()

        def ctor():
            lease = None
            try:
                a, kw = self._resolve_args(args, kwargs)
                # Resources are held for the actor's whole lifetime.
                lease = self._acquire_planned(plan)
                state.instance = cls(*a, **kw)
                state.release_resources = lease.release
            except BaseException:  # noqa: BLE001
                state.dead = True
                state.death_cause = traceback.format_exc()
                if lease is not None:
                    lease.release()
            finally:
                self._unpin(pins)
                ctor_done.set()

        def worker_loop(run_ctor: bool = False):
            # The ctor runs on worker thread 0 so that thread-local state a
            # constructor sets (e.g. a collective-group context) is visible
            # to subsequent method calls on a max_concurrency=1 actor —
            # matching the reference, where ctor and methods share a process.
            # This thread's actor: a killed actor's method stops at its next
            # get (``get``), and an actor placed with
            # placement_group_capture_child_tasks captures its children, as
            # a task does (``_plan_resources``).
            self._current_actor.state = state
            if plan["capture"]:
                self._current_pg.info = {
                    "id": plan["pg"].id,
                    "bundles": plan["pg"].bundles,
                    "strategy": plan["pg"].strategy,
                    "name": plan["pg"].name,
                }
            if run_ctor:
                ctor()
            else:
                ctor_done.wait()
            while True:
                item = state.queue.get()
                if item is _POISON:
                    return
                (oids, method_name, m_args, m_kwargs, num_returns, site,
                 trace_ctx, pins) = item
                call_tid = ids.task_of_object(oids[0])[0]
                try:
                    self._run_actor_item(
                        state, cls, actor_id, oids, method_name, m_args,
                        m_kwargs, num_returns, pins, call_tid, site,
                        trace_ctx)
                except BaseException:  # noqa: BLE001
                    # A cancel injection delivered after the item's own
                    # handlers (e.g. inside a finally) must not kill this
                    # actor's executor thread.
                    from ray_tpu_torch.util import metrics as _metrics

                    _metrics.count_loop_restart("local.actor_exec")
                    traceback.print_exc()

        for i in range(max_concurrency):
            t = threading.Thread(target=worker_loop, args=(i == 0,), daemon=True)
            t.start()
            state.threads.append(t)
        return actor_id

    def _run_actor_item(self, state, cls, actor_id, oids, method_name,
                        m_args, m_kwargs, num_returns, pins, call_tid,
                        site=None, trace_ctx=None):
        """Execute one dequeued actor call (body of the actor's executor
        loop, factored out so worker_loop can shield its thread from a
        late-delivered cancel injection)."""
        try:
            if state.dead:
                self._store_error(
                    oids,
                    ActorError(
                        f"actor {actor_id} is dead: {state.death_cause}"
                    ),
                )
                return
            if not self._cancels.begin(call_tid, threading.get_ident()):
                self._record_task_state(call_tid, "CANCELLED")
                self._store_error(oids, TaskCancelledError(method_name))
                return
            try:
                from ray_tpu_torch.core import attribution
                from ray_tpu_torch.util import tracing

                self._record_task_attempt(call_tid)
                t_phase = time.monotonic_ns()
                a, kw = self._resolve_args(m_args, m_kwargs)
                self._record_task_phase(
                    call_tid, "get_args", time.monotonic_ns() - t_phase)
                method = getattr(state.instance, method_name)
                self._record_task_state(call_tid, "RUNNING")
                run_cm = (tracing.span(f"run:{method_name}",
                                       {"task_id": call_tid},
                                       parent=trace_ctx)
                          if trace_ctx and tracing.is_enabled()
                          else nullcontext())
                t_phase = time.monotonic_ns()
                with attribution.task_context(method_name, site):
                    with run_cm:
                        result = method(*a, **kw)
                        if asyncio.iscoroutine(result):
                            result = self._await_on_loop(
                                result, method_name, site)
                    self._record_task_phase(
                        call_tid, "execute", time.monotonic_ns() - t_phase)
                    t_phase = time.monotonic_ns()
                    self._store_returns(oids, result, num_returns)
                self._record_task_phase(
                    call_tid, "put_outputs", time.monotonic_ns() - t_phase)
                self._record_task_state(call_tid, "FINISHED")
            except BaseException as e:  # noqa: BLE001
                if isinstance(e, TaskCancelledError):
                    self._record_task_state(call_tid, "CANCELLED")
                    self._store_error(oids, e)
                else:
                    self._record_task_state(call_tid, "FAILED", repr(e))
                    self._store_error(
                        oids,
                        TaskError(
                            f"{cls.__name__}.{method_name}",
                            traceback.format_exc(),
                            repr(e),
                        ),
                    )
            finally:
                self._cancels.end(call_tid, threading.get_ident())
        finally:
            self._unpin(pins)

    def _await_on_loop(self, coro, method_name: str, site):
        """Run an async actor method's coroutine on the shared loop and
        wait for it here (reference local_backend.py:1258-1274). The
        attribution rides the asyncio task's own context: this thread's
        context does not reach the loop. The wait wakes every 0.1 s, so a
        cancel injected into this thread lands and cancels the coroutine."""
        import concurrent.futures

        from ray_tpu_torch.core import attribution

        async def attributed():
            with attribution.task_context(method_name, site):
                return await coro

        fut = asyncio.run_coroutine_threadsafe(attributed(), self._aio_loop())
        try:
            while True:
                try:
                    return fut.result(timeout=0.1)
                except concurrent.futures.TimeoutError:
                    continue
                except concurrent.futures.CancelledError:
                    raise TaskCancelledError(method_name) from None
        except TaskCancelledError:
            fut.cancel()
            raise

    def submit_actor_task(
        self,
        actor_id: str,
        method_name: str,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        **_options,
    ) -> list[ObjectRef]:
        state = self._actors.get(actor_id)
        task_id = ids.new_task_id()
        oids = [ids.object_id_for(task_id, i) for i in range(num_returns)]
        refs = [self.make_ref(o) for o in oids]
        self._record_task(task_id, method_name, kind="ACTOR_TASK")
        if state is None:
            self._store_error(oids, ActorError(f"no such actor: {actor_id}"))
            return refs
        group = _options.get("concurrency_group")
        if group and group not in state.concurrency_groups:
            # Same contract as the cluster worker: unknown group = error
            # (local mode shares one pool but must not mask the typo).
            self._store_error(
                oids,
                TaskError(method_name,
                          f"actor has no concurrency group {group!r}",
                          "no-such-group"),
            )
            self._record_task_state(task_id, "FAILED", "no-such-group")
            return refs

        from ray_tpu_torch.core import attribution
        from ray_tpu_torch.util import tracing

        pins = self._pin_ref_args(args, kwargs)
        # A call submitted under a span carries a submit span's context;
        # the actor thread's run span parents under it (as on a cluster).
        with tracing.span(f"submit:{method_name}",
                          {"task_id": task_id}) as sp:
            trace_ctx = ({"trace_id": sp["trace_id"],
                          "span_id": sp["span_id"]}
                         if sp is not None else None)
        item = (oids, method_name, args, kwargs, num_returns,
                attribution.submit_site(), trace_ctx, pins)
        caller = threading.get_ident()

        # Unresolved ObjectRef args are resolved OFF the actor's execution
        # thread (caller-side dependency resolution), then the call is
        # enqueued — chained per caller thread to preserve submission order.
        has_deps = any(
            isinstance(a, ObjectRef) and not self._entry(a.id).event.is_set()
            for a in list(args) + list(kwargs.values())
        )
        with state.lock:
            if state.dead:
                self._unpin(pins)
                self._store_error(
                    oids, ActorError(f"actor {actor_id} is dead: {state.death_cause}")
                )
                return refs
            prev = state.caller_chains.get(caller)
            if not has_deps and (prev is None or prev.is_set()):
                state.queue.put(item)
                return refs
            done = threading.Event()
            state.caller_chains[caller] = done

        def resolve_then_enqueue():
            try:
                if prev is not None:
                    prev.wait()
                for a in list(args) + list(kwargs.values()):
                    if isinstance(a, ObjectRef):
                        self._entry(a.id).event.wait()
                with state.lock:
                    if state.dead:
                        self._unpin(pins)
                        self._store_error(
                            oids,
                            ActorError(
                                f"actor {actor_id} is dead: {state.death_cause}"
                            ),
                        )
                    else:
                        state.queue.put(item)
            finally:
                done.set()

        self._pool.submit(resolve_then_enqueue)
        return refs

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        state = self._actors.get(actor_id)
        if state is None:
            return
        with state.lock:
            state.dead = True
            state.death_cause = "killed via ray_tpu_torch.kill"
            # Fail everything still queued, then poison the worker threads.
            drained = []
            try:
                while True:
                    drained.append(state.queue.get_nowait())
            except queue.Empty:
                pass
            for item in drained:
                if item is _POISON:
                    continue
                oids, *_rest, pins = item
                self._unpin(pins)
                self._store_error(
                    oids, ActorError(f"actor {actor_id} is dead: killed")
                )
            for _ in state.threads:
                state.queue.put(_POISON)
            if state.release_resources is not None:
                state.release_resources()
                state.release_resources = None
        with self._lock:
            if state.name and self._named_actors.get(state.name) == actor_id:
                del self._named_actors[state.name]

    def get_named_actor(self, name: str) -> str:
        with self._lock:
            aid = self._named_actors.get(name)
        if aid is None:
            raise ValueError(f"no actor named {name!r}")
        return aid

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        """Best-effort cancel. Not-yet-started work (pool backlog, actor
        queue) is skipped at pickup; a running task gets TaskCancelledError
        injected into its executor thread (cooperative — C-blocked code
        finishes its call first; there is no separate process to kill in
        local mode, so ``force`` adds nothing here)."""
        task_id = ids.task_of_object(ref.id)[0]
        if self._entry(ref.id).event.is_set():
            return  # already finished: no-op
        self._cancels.cancel(task_id, TaskCancelledError)

    # -- lifecycle --------------------------------------------------------

    def shutdown(self) -> None:
        self._shutdown = True
        for aid in list(self._actors):
            self.kill_actor(aid)

    # -- introspection ----------------------------------------------------

    def cluster_resources(self) -> dict:
        return self._node_pool.total

    def available_resources(self) -> dict:
        return self._node_pool.available()

    def nodes(self) -> list[dict]:
        return [{"NodeID": "local", "Alive": True, "Resources": self.cluster_resources()}]
