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
``wait``, kill and cancel, placement groups and resources. Left out: the
stack dumps and sampled profiles (``util/stack_sampler``), the profiler
capture, the trace flight recorder (``cluster/traces.TraceStore``) and the
federated ``/metrics`` text, which reach modules the port does not have;
the state and observability API (task, actor and object listings, memory
summaries, logs, spans) with the records and object attribution that only
it reads; streaming returns; async actor methods; and the internal KV,
which only the cluster's rendezvous reads (ROADMAP A4b). ``device_stats``
reads the port's ``util/device_telemetry`` (the CUDA devices of this
process).
"""

from __future__ import annotations

import queue
import threading
import traceback
import weakref
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


class _Entry:
    """Object-table slot: either a concrete value or a pending event."""

    __slots__ = ("event", "value", "error")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: BaseException | None = None

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
        # Cancellation: task ids cancelled pre-run + running-thread idents
        # for cooperative mid-run interruption (cancellation.py).
        self._cancels = CancelRegistry(threading.Lock())
        self.node_id = "local"

    # -- ref counting ------------------------------------------------------

    def make_ref(self, oid: str) -> ObjectRef:
        """Mint an ObjectRef whose lifetime pins the object-table entry."""
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
        oid = ids.new_object_id()
        ref = self.make_ref(oid)
        self._entry(oid).set(value)
        return ref

    def get(self, refs: Sequence[ObjectRef], timeout: float | None = None):
        import time

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

    # -- telemetry ---------------------------------------------------------

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

    def _store_returns(self, oids: list[str], result, num_returns):
        if num_returns == 1:
            self._entry(oids[0]).set(result)
        else:
            vals = list(result)
            if len(vals) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(vals)} values"
                )
            for oid, v in zip(oids, vals):
                self._entry(oid).set(v)
        self._gc_unreferenced(oids)

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
        oids = [ids.object_id_for(task_id, i) for i in range(num_returns)]
        refs = [self.make_ref(o) for o in oids]
        fname = name or getattr(func, "__name__", "task")
        try:
            plan = self._plan_resources(_options, is_actor=False)
        except (ValueError, TypeError) as e:
            self._store_error(oids, e)
            return refs
        pins = self._pin_ref_args(args, kwargs)

        def run():
            try:
                if not self._cancels.begin(task_id, threading.get_ident()):
                    self._store_error(oids, TaskCancelledError(fname))
                    return
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
                    a, kw = self._resolve_args(args, kwargs)
                    lease = self._acquire_planned(plan)
                    self._current_lease.lease = lease
                    if plan["capture"]:
                        self._current_pg.info = {
                            "id": plan["pg"].id,
                            "bundles": plan["pg"].bundles,
                            "strategy": plan["pg"].strategy,
                            "name": plan["pg"].name,
                        }
                    try:
                        result = func(*a, **kw)
                    finally:
                        self._current_lease.lease = None
                        lease.release()
                        if plan["capture"]:
                            self._current_pg.info = None
                    self._store_returns(oids, result, num_returns)
                    return
                except BaseException as e:  # noqa: BLE001 — stored, not dropped
                    if isinstance(e, TaskCancelledError):
                        self._store_error(oids, e)
                        return
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
            if run_ctor:
                ctor()
            else:
                ctor_done.wait()
            while True:
                item = state.queue.get()
                if item is _POISON:
                    return
                oids, method_name, m_args, m_kwargs, num_returns, pins = item
                call_tid = ids.task_of_object(oids[0])[0]
                try:
                    self._run_actor_item(
                        state, cls, actor_id, oids, method_name, m_args,
                        m_kwargs, num_returns, pins, call_tid)
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
                        m_args, m_kwargs, num_returns, pins, call_tid):
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
                self._store_error(oids, TaskCancelledError(method_name))
                return
            try:
                a, kw = self._resolve_args(m_args, m_kwargs)
                method = getattr(state.instance, method_name)
                result = method(*a, **kw)
                self._store_returns(oids, result, num_returns)
            except BaseException as e:  # noqa: BLE001
                if isinstance(e, TaskCancelledError):
                    self._store_error(oids, e)
                else:
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
            return refs

        pins = self._pin_ref_args(args, kwargs)
        item = (oids, method_name, args, kwargs, num_returns, pins)
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
