"""ClusterBackend: the in-process runtime for drivers and workers (port of
``ray_tpu/cluster/client.py``).

Implements the same Backend surface as ``core.local_backend.LocalBackend``
over the cluster's control plane (head) and data plane (shm stores + node
agents) — task submission with cluster scheduling, direct actor calls
(caller → actor worker RPC, no agent hop: the direct actor transport of
``direct_actor_task_submitter.h``), object put/get with pull-based
transfer, and lineage-based re-execution: if the node that was computing a
task dies, the owner resubmits the task spec elsewhere
(``object_recovery_manager.h:41``).

Kept: refs and distributed ref-counting, the owner directory,
put/get/wait, lineage re-execution on node death (a task or actor call
lost to a drained or preempted node is resubmitted without spending
``max_retries`` / ``max_task_retries``: ``_is_preemption_loss``; an
object spilled to a shared target is restored instead,
``_try_restore_spilled``), the KV, task submission (lease-pipelined:
prefer-local leased pushes, head placement for the rest), actors
(create, calls, restart replay, kill, named lookup), cancel, placement
groups, and the cluster resource and node views. A put that finds its
store full asks the node's agent to spill and retries. Cross-node pulls
(``_pull_object``) take one of three paths by size: the data inline in
the info reply (up to ``transfer_whole_fetch_max_bytes``), one streamed
request (up to ``transfer_stream_max_chunks`` chunks), or parallel chunk
pulls over ``transfer_pull_concurrency`` connections into one buffer of
this node's store, created once and sealed once; the two chunked paths
are admitted by the pull manager (``_PullManager``: get > wait > args,
at most ``pull_max_inflight_bytes`` in flight). A leased push the local
node rejects spills to a peer chosen from the local agent's gossiped
view (``_spill_to_peers``: entries under 10 s old, the same leased
admission there); only what no peer admits goes to the head, flagged
``spilled``, and a push to a peer that died mid-call fails its refs
unless the head confirms the peer dead (``_node_confirmed_dead``).
Every put and task return carries its attribution (owner, creating
task, time, and the callsite when ``record_callsite`` is on) in its
store meta, the owner's table and the head's directory. A task or actor
call submitted under a span gets a ``submit:`` span whose context rides
the spec (``trace_ctx``), and a driver's finished spans go to the head's
trace store every 0.5 s (``_flush_spans``). The state API's readers
(listings, memory summaries and leaks, store, worker and device stats,
spans and traces; logs, stacks and profiles, with a capture's files
downloaded through the head in 1 MiB reads; the federated metrics, the
signal plane's queries and SLOs; the failpoint and network chaos
control plane) ask the head. A driver follows its workers' stdout and
stderr on the head's ``LOGS`` channel and prints each line as
``(pid=..., node=...) line`` unless ``log_to_driver=False``; the lines
it received are kept in a bounded ring (``received_logs``). Every
client carries a chaos source tag: a worker its node's agent address, a
driver its owner-directory address. A streaming task
(``num_returns="streaming"``) is submitted with its index-0 object
alone: the generator mints the refs of later items, an item lost with
its node is recovered by re-running the task through the index-0 spec,
and ``release_stream`` cancels an abandoned stream's producer and has
the head free its tail, present and future. A task's or actor's
``runtime_env`` is packaged here, on the submitting process's host
(``_resolve_runtime_env``, memoized per env: its zips uploaded to the
head's KV once), and rides the spec to the node, whose agent runs it in a
worker of that env. A function, class, argument blob or put that a
``ray://`` proxy hands on arrives as ``serialization.Serialized`` and is
stored as its client serialized it, and ``get(..., raw=True)`` returns the
stored bytes unopened, so the proxy never imports a client's code.
``connect("ray://host:port")`` returns the client backend
(``util/client``). Left out (ROADMAP A4c.6d, A21): C++ tasks and the
autoscaler view.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Callable, Sequence

from ray_tpu_torch._native.shm_store import ShmStore, StoreFullError
from ray_tpu_torch.cluster.rpc import ConnectionLost, RpcClient, RpcServer
from ray_tpu_torch.core import ids
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.object_ref import (
    ActorError,
    GetTimeoutError,
    ObjectRef,
    ObjectLostError,
    TaskError,
)
from ray_tpu_torch.cluster.head import DEAD_AFTER_S
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.resources import demand_of
from ray_tpu_torch.util import metrics as _metrics


# Poll-again sentinel: a fetch hit only stale/dead locations; the oid
# stays pending and the next location round decides (recovery, head
# fallback, or a fresh copy).
_REFETCH = object()


def _is_preemption_loss(cause) -> bool:
    """Was this loss caused by a planned drain / preemption? Such losses
    are exempt from retry budgets (Ray's preemption exemption: work lost
    to a preempted node does not consume ``max_retries``)."""
    c = (cause or "").lower()
    return c.startswith("drained") or "draining" in c or "preempt" in c


class _PullManager:
    """Admission control for the chunked pulls of one process (the client
    side of ``src/ray/object_manager/pull_manager.h:48``): the bytes in
    flight are capped at ``pull_max_inflight_bytes``, and waiting pulls
    are admitted by priority class -- ``get`` before ``wait``'s
    prefetches before a task's arguments -- first come first served
    within a class. A pull larger than the cap is admitted alone (a huge
    object must not deadlock)."""

    def __init__(self):
        self._cv = threading.Condition()
        self._inflight = 0
        self._waiters: list = []  # heap of (priority, seq)
        self._seq = 0

    def acquire(self, nbytes: int, priority: int) -> None:
        import heapq

        with self._cv:
            me = (priority, self._seq)
            self._seq += 1
            heapq.heappush(self._waiters, me)
            while True:
                fits = (self._inflight == 0 or self._inflight + nbytes
                        <= config.pull_max_inflight_bytes)
                if self._waiters[0] == me and fits:
                    heapq.heappop(self._waiters)
                    self._inflight += nbytes
                    self._cv.notify_all()
                    return
                self._cv.wait(0.5)

    def release(self, nbytes: int) -> None:
        with self._cv:
            self._inflight -= nbytes
            self._cv.notify_all()

    def stats(self) -> dict:
        with self._cv:
            return {"inflight_bytes": self._inflight,
                    "queued": len(self._waiters)}


class _GetError:
    """An exception captured for one ref of a multi-ref get, deferred so
    errors raise in ref order."""

    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


class _OwnerService:
    """RPC surface of a client's owner directory (the per-worker half of
    the reference's ownership protocol: executing workers report result
    locations to the owner; borrowers resolve/wait against the owner)."""

    def __init__(self, backend: "ClusterBackend"):
        self._b = backend

    def rpc_owner_add_location(self, oid, node_id, address, store_path,
                               is_error=False, size=0, attr=None):
        self._b._owner_record(oid, node_id, address, store_path,
                              is_error, size, attr)
        return True

    def rpc_owner_wait_locations(self, oids, timeout=None):
        return self._b.owner_wait_locations(oids, timeout)


class ClusterBackend:
    def __init__(self, head_address: str, *, node_id: str | None = None,
                 store_path: str | None = None, agent_address: str | None = None,
                 process_kind: str = "d", log_to_driver: bool = True):
        import os

        # Reconnect window: a busy head retries instead of failing
        # in-flight location/ref/schedule calls.
        self.head = RpcClient(
            head_address,
            reconnect_window=config.head_reconnect_window_s,
        )
        self.head_address = head_address
        self._agent_address = agent_address
        if node_id is None:
            nodes = [n for n in self.head.call("nodes") if n["Alive"]]
            if not nodes:
                raise RuntimeError("cluster has no alive nodes")
            node_id, store_path = nodes[0]["NodeID"], nodes[0]["StorePath"]
            self._agent_address = nodes[0]["Address"]
        self.node_id = node_id
        self.store_path = store_path
        # "d" = driver (survives node death), "w" = worker (dies with node).
        self.client_id = (
            f"{process_kind}:{node_id}:{os.getpid()}:{os.urandom(3).hex()}"
        )
        self.store = ShmStore(store_path)
        self._node_clients: dict[str, RpcClient] = {}
        self._worker_clients: dict[str, RpcClient] = {}
        self._actor_cache: dict[str, dict] = {}
        self._lock = threading.Lock()
        # Owner-side lineage: oid -> task spec, for re-execution on loss.
        self._lineage: dict[str, dict] = {}
        # Actor-creation lineage: actor_id -> creation spec, until the
        # actor registers. A ctor lost WITH its node (killed before the
        # agent could dispatch/register) has no worker/agent left to
        # report anything — the creating driver resubmits, exactly like
        # task lineage (safe: the assigned node is dead).
        self._actor_creations: dict[str, dict] = {}
        # Pending actor-task results: oid -> actor_id (for fail-fast when
        # the actor dies with calls in flight).
        self._actor_tasks: dict[str, str] = {}
        # Function-table export memo: func -> (key, closure_refs)
        # (reference function_manager export-once semantics).
        import weakref

        self._fn_exports = weakref.WeakKeyDictionary()
        self._fn_keys: set[str] = set()  # for close-time KV cleanup
        # Packaged runtime envs, by the env's canonical JSON.
        self._rtenv_cache: dict[str, dict] = {}
        self._pins: dict[str, Any] = {}  # zero-copy views we hold alive
        # Set by the worker process: (on_block, on_unblock) callbacks that
        # tell the node agent to release/reacquire this task's resources
        # while we block in get() (nested-task deadlock avoidance).
        self._block_hooks: tuple | None = None
        # Process-local ref counts feeding the head's distributed table
        # (reference_count.h analog): transitions 0->1 / 1->0 are batched
        # to the head by a flusher thread; ObjectRef finalizers only touch
        # dicts (no RPC on the GC path).
        # RLock: _deref runs from weakref finalizers, which GC may invoke
        # on a thread that already holds this lock mid-allocation.
        self._ref_lock = threading.RLock()
        self._local_refs: dict[str, int] = {}
        self._dirty_add: set[str] = set()
        self._dirty_remove: set[str] = set()
        # Batched head location reports: put_with_id appends; the ref
        # flusher ships them (always BEFORE ref updates, so container
        # holds for nested refs reach the head ahead of any borrow
        # release they must outlive).
        self._loc_dirty: list = []
        self._ref_cv = threading.Condition(self._ref_lock)
        # Serializes flush I/O: flush_refs() must not return while another
        # thread's ref_update RPC is still in flight (borrower-handoff
        # ordering depends on add-before-task-end). Holding it across
        # the RPC is this lock's entire job — nothing else contends it
        # except a concurrent flush, which must wait anyway.
        self._flush_io_lock = threading.Lock()  # analyze: allow-blocking
        self._closed = False
        threading.Thread(target=self._ref_flush_loop, daemon=True).start()
        # Pipelined submission (direct_task_transport.h:57 in spirit):
        # submit_task enqueues; the submitter thread drains bursts and
        # (a) pushes default-strategy specs straight to THIS client's own
        # node under strict admission — the decentralized prefer-local
        # half of the reference's hybrid policy, no head RPC at all — then
        # (b) places whatever the local node rejected (plus SPREAD/
        # affinity/PG specs) with ONE schedule_batch call. Natural
        # batching: a lone task dispatches immediately; under load
        # batches grow.
        import collections as _collections

        self._submit_q: "_collections.deque[dict]" = _collections.deque()
        self._submit_cv = threading.Condition()
        self._dispatching = 0  # specs popped from the queue, mid-dispatch
        self._retry_heap: list = []  # (due, seq, spec) — shared retry timer
        self._retry_seq = 0
        # (ts, {NodeID: info}) head node-table snapshot shared by the
        # loss-recovery paths (_maybe_recover, actor recovery, parked-
        # affinity fallback); refreshed at most ~1/s so a mass-recovery
        # storm costs one `nodes` RPC per second, not one per spec.
        self._nodes_cache: tuple = (-1e9, None)
        # Owner-distributed object directory (reference ownership model:
        # reference_count.h:61 holds per-object state on the OWNING worker,
        # ownership_based_object_directory.h resolves locations from
        # owners, not the GCS). This process is the authoritative location
        # directory for every object it creates (put / outputs of tasks it
        # submits): executing workers report result locations straight to
        # the owner, get()/wait() on self-owned refs block on this local
        # table with NO head RPC, and borrowers long-poll the owner's
        # server. The head keeps object->owner routing plus its own
        # asynchronously-batched location view as the fallback when an
        # owner dies (owner death = objects lost, reference semantics).
        self._owned: dict[str, dict] = {}
        # RLock for the same reason as _ref_lock: _deref runs from
        # weakref finalizers, which GC may invoke on a thread already
        # holding this lock mid-allocation.
        self._owned_lock = threading.RLock()
        self._owned_cv = threading.Condition(self._owned_lock)
        # Abandoned streams: task id -> the first index nobody will read.
        self._released_streams: dict[str, int] = {}  # guarded-by: _owned_lock
        self._dead_owners: set[str] = set()
        self._owner_clients: dict[str, RpcClient] = {}
        host = (self._agent_address or "127.0.0.1:0").rsplit(":", 1)[0]
        try:
            self._owner_server = RpcServer(_OwnerService(self), host=host)
        except OSError:
            self._owner_server = RpcServer(_OwnerService(self))
        self.owner_addr = self._owner_server.address
        # Chaos source identity: a worker carries its node's (the agent
        # address), so node-keyed partition rules cut its traffic too; a
        # driver carries its own owner-directory address.
        self._chaos_tag = (self._agent_address
                           if process_kind == "w" and self._agent_address
                           else self.owner_addr)
        self.head.chaos_src = self._chaos_tag
        self._prefetching: set[str] = set()
        # Chunked pulls' admission, and this thread's priority class.
        self._pulls = _PullManager()
        self._pull_prio = threading.local()
        # oid -> time of the last restore-from-spill-URI attempt (bounded).
        self._restore_attempts: dict[str, float] = {}
        # task_id -> borrowed oids held locally until borrow registration
        # reaches the head (so callers may drop arg handles immediately
        # even though dispatch is now asynchronous).
        self._submit_holds: dict[str, list[str]] = {}
        threading.Thread(target=self._submit_loop, daemon=True).start()
        self.process_kind = process_kind
        # The workers' lines this driver received over LOGS.
        self._driver_logs: "_collections.deque[dict]" = _collections.deque(
            maxlen=10_000)
        self._log_to_driver = log_to_driver
        if process_kind == "d":
            # Subscribed before the poll thread starts, so lines published
            # right after connect reach this driver.
            try:
                self.head.call("pubsub_subscribe", "logs:" + self.client_id,
                               "LOGS")
                subscribed = True
            except Exception:
                subscribed = False  # the poll loop subscribes
            threading.Thread(target=self._log_poll_loop,
                             args=(subscribed,), daemon=True).start()
        if process_kind != "w":
            # Driver-side spans (submit:, the caller's own) have no worker
            # event flusher to carry them: without this loop the head's
            # flight recorder assembles traces missing their roots.
            threading.Thread(target=self._span_flush_loop,
                             daemon=True).start()

    # -- plumbing ----------------------------------------------------------

    def _span_flush_loop(self):
        while not self._closed:
            time.sleep(0.5)
            try:
                self._flush_spans()
            except Exception:
                _metrics.count_loop_restart("client.span_flush")

    def _flush_spans(self):
        """Ship this process's finished spans (and its span-buffer drop
        count) to the head's flight recorder."""
        from ray_tpu_torch.util import tracing

        # A closed client must not keep draining the process-wide span
        # buffer: the next backend (or a local collect()) owns it.
        if self._closed or not tracing.is_enabled():
            return
        spans = tracing.drain()
        dropped = tracing.drain_dropped()
        if not spans and not dropped:
            return
        with tracing.suppressed():
            try:
                self.head.call(
                    "report_spans", spans, "driver:" + self.client_id,
                    dropped=dropped, timeout=10.0)
            except Exception:
                # The batch is gone (drain pops): count it as dropped.
                tracing.requeue_dropped(dropped + len(spans))
                raise

    def _node_client(self, address: str) -> RpcClient:
        with self._lock:
            c = self._node_clients.get(address)
            if c is None:
                c = self._node_clients[address] = RpcClient(address)
                c.chaos_src = self._chaos_tag
            return c

    def _worker_client(self, address: str) -> RpcClient:
        with self._lock:
            c = self._worker_clients.get(address)
            if c is None:
                c = self._worker_clients[address] = RpcClient(address)
                c.chaos_src = self._chaos_tag
            return c

    def _agent_client(self) -> RpcClient:
        """RPC client to THIS node's agent (spill requests, etc.)."""
        if self._agent_address is None:
            for n in self.head.call("nodes"):
                if n["NodeID"] == self.node_id:
                    self._agent_address = n["Address"]
                    break
            else:
                raise RuntimeError(f"node {self.node_id} not in directory")
        return self._node_client(self._agent_address)

    # -- ref counting ------------------------------------------------------

    def _incref(self, oid: str) -> None:
        with self._ref_lock:
            n = self._local_refs.get(oid, 0)
            self._local_refs[oid] = n + 1
            if n == 0:
                if oid in self._dirty_remove:
                    self._dirty_remove.discard(oid)
                else:
                    self._dirty_add.add(oid)
                self._ref_cv.notify_all()

    def make_ref(self, oid: str, owner: str | None = None) -> ObjectRef:
        self._incref(oid)
        # The ref carries its owner's directory address: any borrower that
        # deserializes it can resolve locations straight from the owner.
        ref = ObjectRef(oid, owner if owner is not None else self.owner_addr)
        import weakref

        weakref.finalize(ref, self._deref, oid)
        return ref

    def on_ref_deserialized(self, oid: str, owner: str) -> ObjectRef:
        """Unpickle hook: this process becomes a holder (borrower)."""
        return self.make_ref(oid, owner)

    def _deref(self, oid: str) -> None:
        with self._ref_lock:
            n = self._local_refs.get(oid, 0) - 1
            if n > 0:
                self._local_refs[oid] = n
                return
            self._local_refs.pop(oid, None)
            # Always send the remove, even when the matching add was never
            # flushed: the head treats a remove for an unknown oid as
            # "held-and-released between flushes" and frees it — otherwise
            # a pinned primary copy with no registered holder would be
            # immortal.
            self._dirty_add.discard(oid)
            self._dirty_remove.add(oid)
            self._ref_cv.notify_all()
        self._lineage.pop(oid, None)  # owner dropped it: no recovery needed
        with self._owned_cv:
            self._owned.pop(oid, None)

    def _ref_flush_loop(self) -> None:
        while True:
            with self._ref_cv:
                while (
                    not self._dirty_add and not self._dirty_remove
                    and not self._loc_dirty and not self._closed
                ):
                    self._ref_cv.wait(0.5)
                if self._closed:
                    return
            time.sleep(0.02)  # coalesce bursts into one RPC
            try:
                self.flush_refs()
            except Exception:
                # The flusher must survive anything one flush throws: a
                # dead flusher silently stops all ref/location reporting
                # for the rest of the process's life.
                _metrics.count_loop_restart("client.ref_flush")
                continue

    def flush_refs(self) -> None:
        """Push pending holder add/removes to the head. Workers call this
        synchronously before reporting task end so borrower registration
        can never lose the race against the borrow release. The io lock
        makes that guarantee hold even when the background flusher already
        popped the dirty sets: we wait for its RPC to finish."""
        with self._flush_io_lock:
            with self._ref_lock:
                if not self._dirty_add and not self._dirty_remove \
                        and not self._loc_dirty:
                    return
                add, self._dirty_add = list(self._dirty_add), set()
                remove, self._dirty_remove = list(self._dirty_remove), set()
                locs, self._loc_dirty = self._loc_dirty, []
            # Locations FIRST: an add_locations batch carries container
            # holds for nested refs (contained=...), which must reach the
            # head before any ref remove flushed after it can zero them.
            if locs:
                try:
                    self.head.call("add_locations", locs)
                except (ConnectionLost, OSError):
                    # Restore EVERYTHING popped — the ref batches too:
                    # dropping them would leak holders (lost removes) or
                    # free held objects (lost adds), same invariant as
                    # the ref_update failure path below.
                    with self._ref_lock:
                        if not self._closed:
                            self._loc_dirty = locs + self._loc_dirty
                            self._dirty_add.update(add)
                            self._dirty_remove.update(remove)
                    return  # keep add-before-remove ordering on retry
            try:
                self.head.call("ref_update", self.client_id, add, remove)
            except (ConnectionLost, OSError):
                # Transient failure: requeue the batch — dropping it would
                # leak holders (lost removes) or free held objects (lost
                # adds).
                with self._ref_lock:
                    if not self._closed:
                        self._dirty_add.update(add)
                        self._dirty_remove.update(remove)

    # -- owner directory ---------------------------------------------------

    def _owner_record(self, oid: str, node_id: str, address: str,
                      store_path: str, is_error: bool = False,
                      size: int = 0, attr: dict | None = None) -> None:
        """A copy of an object WE own appeared on ``node_id``."""
        with self._owned_cv:
            cut = self._released_streams.get(oid[:32])
            if cut is not None and ids.task_of_object(oid)[1] >= cut:
                return  # a released stream's tail: nobody will read it
            e = self._owned.setdefault(
                oid, {"nodes": {}, "error": False, "size": 0})
            e["nodes"][node_id] = (address, store_path)
            e["error"] = e["error"] or bool(is_error)
            e["size"] = max(e["size"], int(size))
            if attr and "attr" not in e:
                # Creation attribution: first writer wins (replica
                # reports carry none).
                e["attr"] = dict(attr)
            self._owned_cv.notify_all()

    def _owner_drop(self, oid: str, node_ids) -> None:
        with self._owned_cv:
            e = self._owned.get(oid)
            if not e:
                return
            for nid in node_ids:
                e["nodes"].pop(nid, None)
            if not e["nodes"]:
                self._owned.pop(oid, None)

    def _owner_knows(self, oid: str) -> bool:
        """Is this oid either resolvable or still expected (a pending
        output of a task/actor call we submitted)? False = we dropped
        our handle: a borrower should resolve through the head instead."""
        if oid in self._owned or oid in self._lineage \
                or oid in self._actor_tasks:
            return True
        # Streaming indices > 1 share the index-0 spec's lineage entry.
        return ids.object_id_for(oid[:32], 0) in self._lineage

    def owner_wait_locations(self, oids, timeout=None) -> dict:
        """Head-``wait_locations`` semantics against the local owner
        table: block until at least one of ``oids`` has a location (or
        timeout); returns {oid: {"nodes": [(nid, addr, store_path)],
        "error": bool}} for every currently-resolvable oid. Oids this
        owner no longer tracks come back as {"forgotten": True} so a
        borrower falls over to the head's FT view immediately."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._owned_cv:
            while True:
                found = {}
                pending_known = False
                for oid in oids:
                    e = self._owned.get(oid)
                    if e and e["nodes"]:
                        found[oid] = {
                            "nodes": [(nid, a, sp) for nid, (a, sp)
                                      in e["nodes"].items()],
                            "error": e["error"],
                        }
                    elif self._owner_knows(oid):
                        pending_known = True
                    else:
                        found[oid] = {"forgotten": True}
                if found or not pending_known:
                    return found
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return {}
                self._owned_cv.wait(
                    1.0 if remaining is None else min(remaining, 1.0))

    def _owner_client(self, addr: str) -> RpcClient:
        with self._lock:
            c = self._owner_clients.get(addr)
            if c is None:
                c = self._owner_clients[addr] = RpcClient(addr, timeout=30.0)
                c.chaos_src = self._chaos_tag
            return c

    def _report_location(self, oid: str, owner: str | None,
                         is_error: bool, size: int,
                         attr: dict | None = None) -> None:
        """Tell the object's owner a copy now lives on this node. Local
        record when we ARE the owner (the common case: the driver's own
        puts); one direct RPC worker->owner otherwise — the head is not
        on this path at all."""
        if not owner or owner == self.owner_addr:
            self._owner_record(oid, self.node_id, self._agent_address or "",
                               self.store_path or "", is_error, size, attr)
            return
        if owner in self._dead_owners:
            return
        try:
            self._owner_client(owner).call(
                "owner_add_location", oid, self.node_id,
                self._agent_address or "", self.store_path or "",
                is_error, size, attr, timeout=10.0)
        except (ConnectionLost, OSError):
            # Owner gone: its objects are recoverable only through the
            # head's batched view / lineage. Best-effort by design.
            self._dead_owners.add(owner)

    # -- object plane ------------------------------------------------------

    def put_with_id(self, oid: str, value: Any, is_error: bool = False,
                    owner: str | None = None) -> None:
        from ray_tpu_torch.core import attribution

        flag = b"E" if is_error else b"V"
        contained: list[str] = []
        # Put-time attribution (owner process id, creating task, time,
        # optional callsite) rides the store-entry meta, so any node
        # holding a copy can say whose bytes these are without the head.
        attr = attribution.make(
            self.client_id,
            default_task="driver" if self.process_kind == "d" else "worker")
        if isinstance(value, ser.Serialized):
            # Serialized by a ray:// client: stored as it came, with this
            # process's attribution added to its meta.
            contained.extend(value.refs)
            meta, chunks = ser.with_meta(value.meta, {"attr": attr}), [
                value.data]
        else:
            meta, chunks = ser.serialize(value, found_refs=contained,
                                         extra_meta={"attr": attr})
        size = ser.total_size(chunks)
        for attempt in range(8):
            try:
                self.store.put(oid, chunks, flag + meta)
                break
            except StoreFullError:
                # Ask this node's agent to spill cold objects and retry
                # (create-request backpressure, local_object_manager.h:110).
                if self._spill_for(size) <= 0:
                    if attempt >= 6:
                        raise
                    # Nothing to spill, but a free may be IN FLIGHT: the
                    # head already forgot a dropped object while the
                    # fanout delete hasn't reached this store yet.
                    time.sleep(0.05 * (attempt + 1))
        else:
            raise StoreFullError(f"object {oid[:16]}… ({size} bytes)")
        # Primary copy: protect from LRU eviction until the cluster
        # ref-counter frees it.
        self.store.pin(oid)
        # Ownership split: the owner learns the location synchronously
        # (worker->owner direct, or a lock-free local record when we own
        # it) — that is what unblocks a waiting get(). The head's copy is
        # batched through the ref flusher: it serves the fallback view
        # and the free fanout, neither of which needs sync latency.
        self._report_location(oid, owner, is_error, size, attr)
        with self._ref_lock:
            self._loc_dirty.append(
                (oid, self.node_id, is_error, size, contained,
                 owner or self.owner_addr, attr))
            self._ref_cv.notify_all()

    def _spill_for(self, size: int) -> int:
        """Have this node's agent spill ``size`` bytes and the headroom;
        returns the bytes freed. This process's pending location reports
        go first (the agent picks its candidates from the head's
        directory), and no lock of ours is held across the agent's RPC."""
        try:
            self.flush_refs()
            return int(self._agent_client().call(
                "spill", size + config.spill_headroom_bytes, timeout=60.0))
        except (ConnectionLost, OSError, RuntimeError):
            return 0

    def put(self, value: Any) -> ObjectRef:
        oid = ids.new_object_id()
        self.put_with_id(oid, value)
        return self.make_ref(oid)

    def _read_local(self, oid: str, raw: bool = False):
        """Returns (value,) or None if the object isn't in the local store.
        (The 1-tuple disambiguates a stored None from a miss.)"""
        got = self.store.get(oid)
        if got is None:
            return None
        data, meta = got
        views: list = []
        try:
            value = self._decode(meta, data, views, raw)
        except BaseException:
            self.store.release(oid)
            raise
        self._scope_pin(oid, views)
        return (value,)

    def _scope_pin(self, oid: str, views: list) -> None:
        """Hold the store refcount (zero-copy pin) only while deserialized
        views into the segment can still be alive: the arrays the load
        built over the segment's buffers (numpy arrays, and the byte
        arrays under CPU tensors, which a tensor's storage keeps alive;
        ``core/serialization.py`` reports each). With none, nothing points
        into the segment — release now; else release when they are all
        collected (plasma parity: buffer lifetime pins the object)."""
        if not views:
            self.store.release(oid)
            return
        import weakref

        remaining = {"n": len(views)}
        store = self.store

        def on_dead():
            remaining["n"] -= 1
            if remaining["n"] == 0:
                try:
                    store.release(oid)
                except Exception:
                    pass

        for a in views:
            weakref.finalize(a, on_dead)
        # Drop the strong refs now so the finalizers fire on plain
        # refcount death and the store pin releases promptly.
        views.clear()

    @staticmethod
    def _decode(meta: bytes, data, views: list | None = None,
                raw: bool = False):
        if raw:
            # The stored bytes, copied out (no view into the segment):
            # the error flag stays the first byte of the meta.
            return (bytes(meta), bytes(data))
        flag, ser_meta = meta[:1], meta[1:]
        value = ser.deserialize(ser_meta, data, views)
        if flag == b"E":
            raise value
        return value

    def _fetch_remote(self, oid: str, locations: list,
                      raw: bool = False) -> Any:
        last_err: Exception | None = None
        for node_id, address, _store_path in locations:
            if node_id == self.node_id or self.store.contains(oid):
                # Here, or a copy a parallel pull left in this store.
                boxed = self._read_local(oid, raw)
                if boxed is not None:
                    return boxed[0]
                # On this node but not in its store: spilled -- the
                # agent serves (and restores) it like any peer.
            try:
                got = self._pull_object(address, oid)
            except (ConnectionLost, OSError, ObjectLostError) as e:
                # ObjectLostError: this replica vanished mid-pull
                # (evicted); the next location may still be intact.
                last_err = e
                continue
            if got is None:
                continue
            meta, data, pinned = got
            if not pinned:
                return self._decode(meta, data, None, raw)
            views: list = []
            try:
                value = self._decode(meta, data, views, raw)
            except BaseException:
                self.store.release(oid)
                raise
            self._scope_pin(oid, views)
            return value
        raise ObjectLostError(
            f"object {oid[:16]}… not retrievable from {len(locations)} "
            f"location(s): {last_err}"
        )

    # Pull priority classes (the pull manager admits lower first).
    PULL_GET, PULL_WAIT, PULL_ARGS = 0, 1, 2

    def _pull_priority(self) -> int:
        return getattr(self._pull_prio, "v", self.PULL_GET)

    def pull_priority_override(self, prio: int):
        """Context manager: this thread's pulls take class ``prio`` (a
        worker materializing a task's arguments ranks below explicit
        gets)."""
        import contextlib

        @contextlib.contextmanager
        def cm():
            prev = getattr(self._pull_prio, "v", None)
            self._pull_prio.v = prio
            try:
                yield
            finally:
                if prev is None:
                    del self._pull_prio.v
                else:
                    self._pull_prio.v = prev

        return cm()

    def _pull_object(self, address: str, oid: str):
        """``(meta, data, pinned)`` from a peer node, or None when it no
        longer holds the object. By size (``fetch_object_info`` first):

        * up to ``transfer_whole_fetch_max_bytes``, the data came inline
          in the info reply -- one round trip;
        * up to ``transfer_stream_max_chunks`` chunks of
          ``transfer_chunk_bytes``, one streamed request
          (``fetch_object``: the chunk frames back to back);
        * above that, parallel per-chunk requests over
          ``transfer_pull_concurrency`` connections, written into one
          buffer of this node's store (created once, sealed once; an
          unpinned secondary copy that LRU eviction may take, so it is
          not reported as a location), or into memory when the store has
          no room for it.

        The chunked paths are admitted by the pull manager. ``pinned``:
        ``data`` is a view of this node's store holding a read pin that
        the caller releases (``_scope_pin``)."""
        chunk = config.transfer_chunk_bytes
        client = self._node_client(address)
        info = client.call("fetch_object_info", oid,
                           config.transfer_whole_fetch_max_bytes)
        if info is None:
            return None
        meta, size, inline = info
        if inline is not None:
            return meta, inline, False
        if self.store.contains(oid):
            # Restored into this node's store by the info call (the object
            # was spilled here), or a copy another pull left.
            got = self.store.get(oid)
            if got is not None:
                return meta, got[0], True
        self._pulls.acquire(size, self._pull_priority())
        try:
            if -(-size // chunk) <= config.transfer_stream_max_chunks:
                return meta, self._pull_streamed(client, oid, size,
                                                 chunk), False
            return self._pull_chunked(client, oid, meta, size, chunk)
        finally:
            self._pulls.release(size)

    def _pull_streamed(self, client, oid: str, size: int, chunk: int):
        stream = client.call_stream("fetch_object", oid, chunk)
        head = next(stream, None)
        if head is None:
            stream.close()
            raise ObjectLostError(f"object {oid[:16]}… left its node")
        buf = bytearray(size)
        off = 0
        for piece in stream:
            buf[off:off + len(piece)] = piece
            off += len(piece)
        if off != size:
            raise ObjectLostError(
                f"stream of {oid[:16]}… ended early at {off}/{size}")
        return buf

    def _pull_chunked(self, client, oid: str, meta: bytes, size: int,
                      chunk: int):
        """The parallel path: ``(meta, data, pinned)``. A pull that fails
        aborts its store buffer -- never an unsealed object left behind."""
        from ray_tpu_torch._native.shm_store import ObjectExistsError

        try:
            buf = self.store.create(oid, size, meta)
            in_store = True
        except (StoreFullError, ObjectExistsError, OSError):
            buf, in_store = bytearray(size), False

        def pull_chunk(off: int):
            length = min(chunk, size - off)
            piece = client.call("fetch_object_chunk", oid, off, length)
            if piece is None or len(piece) != length:
                raise ObjectLostError(
                    f"chunk [{off}:{off + length}) of {oid[:16]}… missing")
            buf[off:off + length] = piece

        try:
            futs = [self._pull_pool().submit(pull_chunk, off)
                    for off in range(0, size, chunk)]
            err = None
            for fut in futs:
                try:
                    fut.result()
                except BaseException as e:  # noqa: BLE001 — re-raised below
                    err = err or e
            if err is not None:
                raise err
        except BaseException:
            if in_store:
                del buf
                self.store.abort(oid)
            raise
        if not in_store:
            return meta, buf, False
        del buf
        self.store.seal(oid)
        got = self.store.get(oid)
        if got is None:
            raise ObjectLostError(
                f"object {oid[:16]}… evicted from this store as it landed")
        return meta, got[0], True

    def _pull_pool(self):
        """One chunk-pull executor a backend: its threads keep their
        pooled connections (one a thread) warm across pulls."""
        pool = getattr(self, "_chunk_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:
                pool = getattr(self, "_chunk_pool", None)
                if pool is None:
                    pool = self._chunk_pool = ThreadPoolExecutor(
                        config.transfer_pull_concurrency,
                        thread_name_prefix="chunk-pull")
        return pool

    def _try_restore_spilled(self, oid: str) -> bool:
        """The object's node is dead, but a copy spilled to a shared
        target may survive: have the head restore it onto a live node (at
        most one try an oid every 2 s) and record the new location in
        the owner table. True when it was restored."""
        now = time.monotonic()
        if now - self._restore_attempts.get(oid, -1e9) < 2.0:
            return False
        if len(self._restore_attempts) > 4096:
            self._restore_attempts.clear()
        self._restore_attempts[oid] = now
        try:
            loc = self.head.call("restore_spilled", oid, timeout=45.0)
        except (ConnectionLost, OSError):
            return False
        if not loc:
            return False
        node_id, address, store_path = loc
        self._owner_record(oid, node_id, address, store_path)
        return True

    def _nodes_snapshot(self, max_age_s: float = 1.0) -> dict | None:
        """{NodeID: info} head node-table snapshot, cached ``max_age_s``:
        the loss-recovery paths poll repeatedly, so ≤1s-stale liveness
        only defers a recovery to the next poll — it never recovers a
        task whose node is actually alive (dead nodes stay dead; node
        ids are never reused). Returns None when the head is
        unreachable (callers treat that as "retry later")."""
        now = time.monotonic()
        ts, nodes = self._nodes_cache
        if nodes is None or now - ts > max_age_s:
            try:
                nodes = {n["NodeID"]: n for n in self.head.call("nodes")}
            except (ConnectionLost, OSError):
                return None
            self._nodes_cache = (now, nodes)
        return nodes

    def _maybe_recover(self, oid: str) -> bool:
        """Lineage reconstruction: resubmit the creating task if its node
        died before the object appeared, within its retry budget. Returns
        True if recovery was initiated."""
        spec = self._lineage.get(oid)
        if spec is None:
            # A streaming item past index 0 never entered the lineage
            # table: it is recovered through the index-0 spec, by running
            # the whole task again, which stores every index again
            # (reference client.py:900-912).
            tid, idx = ids.task_of_object(oid)
            root = (self._lineage.get(ids.object_id_for(tid, 0))
                    if idx > 0 else None)
            if root is not None and root.get("num_returns") == "streaming":
                spec = root
        if spec is None:
            return False
        assigned = spec.get("assigned_node")
        if assigned is None:
            return False  # not yet placed; the pending-retry thread owns it
        nodes = self._nodes_snapshot()
        if nodes is None:
            return False  # head unreachable: the get loop retries
        info = nodes.get(assigned, {})
        if info.get("Alive"):
            return False  # still computing (a DRAINING node finishes work)
        # The node is dead; a copy spilled to a shared target is restored
        # rather than recomputed (cheaper, and it needs no inputs).
        if self._try_restore_spilled(oid):
            return True
        # Preemption exemption: a task lost to a drained/preempted node
        # re-executes WITHOUT consuming retries_left — planned node
        # departure is the platform's fault, not the task's.
        exempt = _is_preemption_loss(info.get("DeathCause"))
        if spec.get("retries_left", 0) <= 0 and not exempt:
            return False
        if not exempt:
            spec["retries_left"] -= 1
        # Soft affinity on recovery: the pinned node is gone, so let the
        # scheduler place the retry anywhere feasible.
        spec["sinfo"]["node_affinity"] = None
        try:
            self._submit_spec(spec)
        except (ValueError, TimeoutError):
            return False
        return True

    def _check_actor_alive(self, oid: str, refresh: bool = True) -> None:
        """A pending actor-task result can never appear if the actor died —
        fail fast (RayActorError parity). If the actor RESTARTED and this
        call was lost with it, replay the call within the actor's
        max_task_retries budget (direct_actor_task_submitter retry analog).
        ``refresh=False`` trusts the actor cache a caller just refreshed
        (wait()'s per-round dedup across refs of one actor)."""
        entry = self._actor_tasks.get(oid)
        if entry is None:
            return
        actor_id = entry["actor_id"]
        info = self._actor_info(actor_id, refresh=refresh)
        if info["state"] == "DEAD":
            for o in entry.get("oids", [oid]):
                self._actor_tasks.pop(o, None)
            raise ActorError(
                f"actor {actor_id} died before this call completed: "
                f"{info.get('death_cause')}"
            )
        if info["state"] != "ALIVE":
            return  # restarting: keep waiting
        if info.get("num_restarts", 0) > entry["incarnation"]:
            # The call was in flight across a restart: its execution (and
            # queued successors) died with the old worker. Calls lost to
            # a drain-migration replay budget-free (preemption exemption,
            # mirroring the task-retry exemption).
            exempt = _is_preemption_loss(info.get("restart_cause"))
            if entry["retries_left"] == 0 and not exempt:
                for o in entry.get("oids", [oid]):
                    self._actor_tasks.pop(o, None)
                raise ActorError(
                    f"actor {actor_id} restarted and the call was lost "
                    f"(max_task_retries exhausted)"
                )
            if entry["retries_left"] > 0 and not exempt:
                entry["retries_left"] -= 1
            entry["incarnation"] = info["num_restarts"]
            spec = entry["spec"]
            self._register_borrows(spec, info["node_id"])
            try:
                self._worker_client(info["address"]).call(
                    "push_actor_task", spec
                )
            except (ConnectionLost, OSError):
                self._end_borrows(spec)  # next get() round retries again
                entry["incarnation"] -= 1  # didn't actually replay

    def _poll_locations(self, window, owner_of, head_oids: set,
                        sweep_head: bool, timeout: float = 1.0) -> dict:
        """One location-poll round: self-owned oids block on the LOCAL
        owner table (zero RPCs — the common case: a driver getting its
        own tasks' results), borrowed oids long-poll their owner's
        directory server directly, and only oids with no/dead/forgetful
        owner touch the head (plus a whole-window head sweep every 4th
        round as the safety net for owner-unaware reporters). Returns
        {oid: {"nodes": [...], "error": bool}} for resolvable oids;
        mutates ``head_oids`` as owners die or disavow oids."""
        mine, by_owner, to_head = [], {}, []
        for oid in window:
            owner = owner_of.get(oid) or ""
            if oid in head_oids or not owner \
                    or owner in self._dead_owners:
                to_head.append(oid)
            elif owner == self.owner_addr:
                mine.append(oid)
            else:
                by_owner.setdefault(owner, []).append(oid)
        if sweep_head:
            to_head = list(window)

        jobs = []  # (kind, oids, thunk)
        if mine:
            jobs.append(("local", mine,
                         lambda o=mine: self.owner_wait_locations(
                             o, timeout)))
        for owner, oids in by_owner.items():
            jobs.append((owner, oids,
                         lambda ow=owner, o=oids: self._owner_client(
                             ow).call("owner_wait_locations", o, timeout,
                                      timeout=timeout + 30.0)))
        if to_head:
            jobs.append(("head", to_head,
                         lambda o=to_head: self.head.call(
                             "wait_locations", o, timeout, timeout=15.0)))
        results: dict = {}

        def run(job):
            kind, oids, thunk = job
            try:
                return thunk()
            except (ConnectionLost, OSError):
                if kind not in ("local", "head"):
                    # Owner process is gone: its objects resolve through
                    # the head's FT view from now on (or lineage re-exec).
                    self._dead_owners.add(kind)
                    head_oids.update(oids)
                return {}

        if len(jobs) == 1:
            outs = [run(jobs[0])]
        else:
            outs = list(self._get_pool().map(run, jobs))
        for out in outs:
            for oid, entry in (out or {}).items():
                if entry.get("forgotten"):
                    # The owner dropped its handle but we still hold one:
                    # the head's directory is the fallback of record.
                    head_oids.add(oid)
                elif entry.get("nodes"):
                    results[oid] = entry
        return results

    def get(self, refs: Sequence[ObjectRef], timeout: float | None = None,
            raw: bool = False):
        """Resolve every ref: local reads first, then one batched
        location poll per round for everything still missing — against
        the LOCAL owner table for self-owned refs (no RPC), each owner's
        directory for borrowed refs, the head only as FT fallback — with
        ready objects fetched concurrently (the reference resolves from
        owners the same way, ownership_based_object_directory.h). Errors
        raise in ref order — an error ref raises once every ref before
        it has resolved. ``raw``: each value as its stored ``(meta,
        data)`` bytes, undecoded (meta's first byte ``E`` for a task
        error, which then does not raise here) -- what a ``ray://`` proxy
        sends its client."""
        deadline = None if timeout is None else time.monotonic() + timeout
        hooks = self._block_hooks
        blocked = False
        _UNSET = object()
        slots = [_UNSET] * len(refs)
        pending: dict[str, list[int]] = {}
        owner_of = {r.id: getattr(r, "_owner", "") for r in refs}
        head_oids: set[str] = set()  # oids demoted to head resolution
        fetch_fails: dict[str, int] = {}
        round_idx = 0

        def ordered_raise():
            for v in slots:
                if v is _UNSET:
                    return
                if isinstance(v, _GetError):
                    raise v.exc

        def resolve_value(oid: str, i: int):
            boxed = self._read_local(oid, raw)
            if boxed is not None:
                slots[i] = boxed[0]
                return True
            return False

        try:
            for i, r in enumerate(refs):
                try:
                    if not resolve_value(r.id, i):
                        pending.setdefault(r.id, []).append(i)
                except BaseException as e:  # noqa: BLE001 — ordered raise
                    slots[i] = _GetError(e)
            ordered_raise()
            while pending:
                if hooks is not None and not blocked:
                    hooks[0]()  # give our CPUs back while we block
                    blocked = True
                # Window the poll: the head rescans the requested oids on
                # every store event while blocked, so a 5k-ref get must
                # not make each scan 5k wide. Refs resolve roughly in
                # submission order; polling the first unresolved window
                # keeps scans O(64) and still batches.
                window = list(pending)[:64]
                locs = self._poll_locations(
                    window, owner_of, head_oids,
                    sweep_head=(round_idx % 4 == 3))
                round_idx += 1
                ready = [(oid, loc) for oid, loc in locs.items()
                         if oid in pending]
                if ready:
                    def fetch(oid, loc):
                        try:
                            return self._fetch_remote(oid, loc["nodes"],
                                                      raw)
                        except (ObjectLostError, ConnectionLost,
                                OSError) as e:
                            # Owner-table locations aren't liveness-
                            # filtered the way the head's are: a died
                            # node leaves stale entries. Purge and retry
                            # the poll (recovery/re-exec decides next);
                            # after repeated failures resolve through
                            # the head, whose view drops dead nodes.
                            self._owner_drop(
                                oid, [nid for nid, _a, _s in loc["nodes"]])
                            n = fetch_fails[oid] = fetch_fails.get(oid, 0) + 1
                            if n >= 3:
                                head_oids.add(oid)
                            if n >= 6:
                                return _GetError(e)
                            return _REFETCH
                        except BaseException as e:  # noqa: BLE001
                            return _GetError(e)

                    if len(ready) == 1:
                        values = [fetch(*ready[0])]
                    else:
                        values = list(self._get_pool().map(
                            lambda p: fetch(*p), ready))
                    for (oid, _), value in zip(ready, values):
                        if value is _REFETCH:
                            continue
                        for i in pending.pop(oid):
                            slots[i] = value
                for oid in window:
                    if oid in pending and oid not in locs:
                        self._maybe_recover(oid)
                        self._check_actor_alive(oid)
                ordered_raise()
                if pending and deadline is not None \
                        and time.monotonic() > deadline:
                    raise GetTimeoutError(
                        f"ray_tpu_torch.get timed out on {len(pending)} "
                        f"ref(s)")
        finally:
            if blocked:
                hooks[1]()
        for r in refs:
            self._actor_tasks.pop(r.id, None)  # resolved; stop tracking
        # Values may have carried nested ObjectRefs: make sure the head
        # knows about our new holds before our caller can release the
        # containers they arrived in.
        with self._ref_lock:
            dirty = bool(self._dirty_add)
        if dirty:
            self.flush_refs()
        return slots

    def _get_pool(self):
        """Concurrent fetches for multi-ref gets. Separate from the chunk
        pool (a fetch SUBMITS chunk work there; sharing would deadlock at
        saturation)."""
        pool = getattr(self, "_fetch_pool", None)
        if pool is None:
            from concurrent.futures import ThreadPoolExecutor

            with self._lock:
                pool = getattr(self, "_fetch_pool", None)
                if pool is None:
                    pool = self._fetch_pool = ThreadPoolExecutor(
                        4, thread_name_prefix="get-fetch")
        return pool

    def wait(self, refs, num_returns, timeout, fetch_local=True):
        deadline = None if timeout is None else time.monotonic() + timeout
        ready: list[ObjectRef] = []
        pending = list(refs)
        owner_of = {r.id: getattr(r, "_owner", "") for r in refs}
        head_oids: set[str] = set()
        round_idx = 0
        while len(ready) < num_returns:
            for r in list(pending):
                if self.store.contains(r.id):
                    ready.append(r)
                    pending.remove(r)
            if len(ready) >= num_returns or not pending:
                break
            # Actor-death fail-fast, same contract as get(): a pending
            # actor-call ref whose actor is DEAD can never resolve — and
            # its stored error object may have died WITH the actor's
            # node (a preempted gang bundle vacated mid-call), so a
            # wait()-based poller (Tune's event loop, the trainer's
            # consume loop) would otherwise spin forever. The error
            # lands in the local store and the ref reports ready (this
            # pass or the caller's next poll); get() raises it.
            # Replay-on-restart rides along (the same _check_actor_alive
            # path get() uses). Throttled PER CLIENT: repeated
            # wait(timeout=0) polls collectively sweep at most every
            # quarter second — each check is a head RPC per distinct
            # actor — and runs only after the contains-check above found
            # unresolved refs.
            now = time.monotonic()
            if now - getattr(self, "_last_actor_check", 0.0) > 0.25:
                self._last_actor_check = now

                seen_actors: set = set()
                for r in list(pending):
                    entry = self._actor_tasks.get(r.id)
                    if entry is None:
                        continue
                    aid = entry["actor_id"]
                    # Only actors whose registration this client has
                    # already seen: a ctor still forking has no head
                    # record yet, and the lookup would BLOCK wait()
                    # for the registration timeout (ctor failures
                    # surface through the record the agent writes).
                    with self._lock:
                        known = aid in self._actor_cache
                    if not known:
                        continue
                    # One head refresh per DISTINCT actor per round: a
                    # wait over a 500-call fan-out to one actor must
                    # not cost 500 get_actor RPCs every quarter second.
                    # The entry's oids are captured BEFORE the check:
                    # it pops every sibling of a multi-return call, so
                    # the error must be stored for ALL of them or the
                    # unchecked siblings would hang forever.
                    call_oids = list(entry.get("oids") or [r.id])
                    try:
                        self._check_actor_alive(
                            r.id, refresh=aid not in seen_actors)
                    except ActorError as e:
                        for oid in call_oids:
                            self.put_with_id(oid, e, is_error=True)
                    except Exception:
                        pass  # lookup hiccup: next round retries
                    seen_actors.add(aid)
                for r in list(pending):
                    if self.store.contains(r.id):
                        ready.append(r)
                        pending.remove(r)
                if len(ready) >= num_returns or not pending:
                    break
            # One batched, owner-routed poll per round (non-blocking):
            # self-owned refs cost zero RPCs; the 5 ms cadence below would
            # otherwise hammer the head with a locations call per ref.
            locs = self._poll_locations(
                [r.id for r in pending], owner_of, head_oids,
                sweep_head=(round_idx % 64 == 63), timeout=0)
            round_idx += 1
            for r in list(pending):
                loc = locs.get(r.id)
                if loc and loc.get("nodes"):
                    ready.append(r)
                    pending.remove(r)
                    if fetch_local:
                        self._prefetch(r.id, loc["nodes"],
                                       owner=owner_of.get(r.id))
            if len(ready) >= num_returns:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(0.005)
        return ready, pending

    def _prefetch(self, oid: str, locations: list,
                  owner: str | None = None) -> None:
        """``wait(fetch_local=True)`` semantics (reference: ready objects
        are pulled to the caller's node): replicate the raw bytes into the
        LOCAL store in the background, so the eventual
        ``get`` is a local read. Best-effort — failures leave the remote
        copy authoritative."""
        if any(node_id == self.node_id for node_id, _a, _s in locations):
            return  # already local
        with self._lock:
            if oid in self._prefetching:
                return
            self._prefetching.add(oid)
            pool = getattr(self, "_prefetch_pool", None)
            if pool is None:
                from concurrent.futures import ThreadPoolExecutor

                pool = self._prefetch_pool = ThreadPoolExecutor(
                    2, thread_name_prefix="prefetch")

        def job():
            try:
                for _node_id, address, _sp in locations:
                    with self.pull_priority_override(self.PULL_WAIT):
                        got = self._pull_object(address, oid)
                    if got is None:
                        continue
                    meta, data, pinned = got
                    size = len(data)
                    if pinned:
                        # The parallel path left the copy in this store.
                        del data
                        self.store.release(oid)
                    else:
                        self.store.put(oid, [bytes(data)], meta)
                    # Secondary copy: the owner's directory spreads
                    # future pulls across it; the head's batched view
                    # keeps it as a fallback location. No owner on
                    # the ref -> head only (we must not claim
                    # ownership of a borrowed object).
                    if owner:
                        self._report_location(
                            oid, owner, meta[:1] == b"E", size)
                    with self._ref_lock:
                        self._loc_dirty.append(
                            (oid, self.node_id, meta[:1] == b"E",
                             size, None, owner or ""))
                        self._ref_cv.notify_all()
                    return
            except BaseException:  # noqa: BLE001 — best-effort
                pass
            finally:
                with self._lock:
                    self._prefetching.discard(oid)

        pool.submit(job)

    # -- internal KV -------------------------------------------------------

    def kv_put(self, key: str, value, overwrite: bool = True) -> bool:
        return self.head.call("kv_put", key, value, overwrite)

    def kv_get(self, key: str):
        return self.head.call("kv_get", key)

    def kv_del(self, key: str) -> bool:
        return self.head.call("kv_del", key)

    def kv_keys(self, prefix: str = "") -> list[str]:
        return self.head.call("kv_keys", prefix)

    # -- task plane --------------------------------------------------------

    def _strategy_info(self, options: dict) -> dict:
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
            PlacementGroupSchedulingStrategy,
        )

        strategy = options.get("scheduling_strategy")
        info: dict[str, Any] = {
            "strategy": strategy if isinstance(strategy, str) else None,
            "pg_id": None,
            "bundle_index": -1,
            "node_affinity": None,
        }
        pg = options.get("placement_group")
        if isinstance(strategy, PlacementGroupSchedulingStrategy):
            pg = strategy.placement_group
            info["bundle_index"] = strategy.placement_group_bundle_index
            if strategy.placement_group_capture_child_tasks:
                info["capture"] = True
        elif isinstance(strategy, NodeAffinitySchedulingStrategy):
            info["node_affinity"] = strategy.node_id
        if pg is not None:
            info["pg_id"] = getattr(pg, "id", pg)
            if "placement_group_bundle_index" in options:
                info["bundle_index"] = options["placement_group_bundle_index"]
        return info

    def _resolve_runtime_env(self, options: dict) -> dict | None:
        """Package a task's or actor's ``runtime_env`` (its zips uploaded
        to the head's KV, content-addressed) and return the shippable
        resolved spec, memoized per env (reference client.py:1375-1393).
        Paths are read here, on this process's host: through a ``ray://``
        proxy, on the proxy's."""
        env = options.get("runtime_env")
        if not env:
            return None
        import json

        from ray_tpu_torch._private import runtime_env as rtenv

        memo_key = json.dumps(env, sort_keys=True, default=str)
        resolved = self._rtenv_cache.get(memo_key)
        if resolved is None:
            resolved = rtenv.package(
                env, lambda k, v, ow: self.head.call("kv_put", k, v, ow))
            self._rtenv_cache[memo_key] = resolved
        return resolved

    @staticmethod
    def _dump_args(args, kwargs, borrowed: list) -> bytes:
        """The task's argument blob; a ``ray://`` client's arrives
        serialized already (``Serialized``), its refs listed with it."""
        if isinstance(args, ser.Serialized):
            borrowed.extend(args.refs)
            return args.data
        return ser.dumps((args, kwargs), found_refs=borrowed)

    def _choose_node(self, demand, sinfo):
        if sinfo["pg_id"] is not None:
            return self.head.call(
                "pg_node_for_bundle", sinfo["pg_id"], sinfo["bundle_index"],
                60.0, timeout=75.0,
            )
        return self.head.call(
            "schedule", demand, caller_node=self.node_id,
            strategy=sinfo["strategy"], node_affinity=sinfo["node_affinity"],
        )

    def _submit_spec(self, spec: dict, *, allow_pending: bool = False):
        placed = self._choose_node(spec["demand"], spec["sinfo"])
        if placed is None:
            if not allow_pending:
                raise ValueError(
                    f"demand {spec['demand']} is infeasible on this cluster"
                )
            # Keep the task pending until capacity appears, up to
            # pending_task_timeout_s (reference: infeasible tasks wait).
            threading.Thread(
                target=self._retry_submit, args=(spec,), daemon=True
            ).start()
            return
        node_id, address = placed
        spec["assigned_node"] = node_id
        self._register_borrows(spec, node_id)
        try:
            self._node_client(address).call("submit_task", spec)
        except (ConnectionLost, OSError):
            self._end_borrows(spec)  # nothing will ever end them otherwise
            raise

    def _register_borrows(self, spec: dict, node_id: str) -> None:
        """Task args borrow their objects until the task ends — registered
        BEFORE dispatch so the caller may drop its handles immediately.
        Actor-method borrows carry the actor id so the head can end them
        when the actor dies with calls still queued."""
        if spec.get("borrowed"):
            self.head.call(
                "ref_task_begin", spec["task_id"], node_id, spec["borrowed"],
                spec.get("actor_id") if spec.get("method") else None,
            )
        self._drop_holds(spec)

    def _register_borrows_batch(self, specs: list, node_id: str) -> None:
        entries = [
            (s["task_id"], node_id, s["borrowed"],
             s.get("actor_id") if s.get("method") else None)
            for s in specs if s.get("borrowed")
        ]
        if entries:
            self.head.call("ref_task_begin_batch", entries)
        for s in specs:
            self._drop_holds(s)

    def _deliver_late_cancels(self, specs: list, address: str) -> None:
        """cancel() racing the asynchronous dispatch sees assigned_node
        None and sends no node RPC; now that these specs have a home,
        forward the flag (the agent's cancelled-set covers every
        queue/checkout window)."""
        for s in specs:
            if s.get("cancelled"):
                try:
                    self._node_client(address).call(
                        "cancel_task", s["task_id"], False)
                except (ConnectionLost, OSError):
                    pass

    def _drop_holds(self, spec: dict) -> None:
        """Release the submission-window holds on a task's borrowed args
        (safe once the head knows the borrows, or the task has failed)."""
        oids = self._submit_holds.pop(spec.get("task_id"), None)
        if oids:
            for oid in oids:
                self._deref(oid)

    def _fail_spec(self, spec: dict, err: Exception) -> None:
        spec["_handled"] = True
        self._drop_holds(spec)
        for oid in spec["oids"]:
            self._lineage.pop(oid, None)
            self.put_with_id(oid, err, is_error=True)

    # -- lease-pipelined submission ----------------------------------------

    @staticmethod
    def _leasable(spec: dict) -> bool:
        """Only default-strategy tasks with real demand take the
        prefer-local direct path; SPREAD/affinity/PG placement must
        consult the head every time, and zero-demand specs fit local
        admission unconditionally (they'd never spill — the head
        round-robins them instead)."""
        s = spec["sinfo"]
        return (s["pg_id"] is None and s["node_affinity"] is None
                and s["strategy"] is None and bool(spec["demand"]))

    def _submit_loop(self) -> None:
        import heapq

        while True:
            with self._submit_cv:
                limit = config.submit_batch_max
                while True:
                    now = time.monotonic()
                    # Re-inject due retries AT MOST one batch per loop
                    # pass: at 100k parked specs hitting max backoff,
                    # every spec comes due inside the same window, and
                    # draining them ALL here would put ~400 consecutive
                    # retry batches ahead of any fresh submission (a
                    # feasible probe task measured 40s queue latency
                    # behind the circulating backlog). Bounded, the
                    # remainder stays at the heap top — still due, so
                    # the next pass drains the next batch — and fresh
                    # work interleaves at batch granularity.
                    drained = 0
                    while (self._retry_heap
                           and self._retry_heap[0][0] <= now
                           and drained < limit):
                        self._submit_q.append(
                            heapq.heappop(self._retry_heap)[2])
                        drained += 1
                    if self._submit_q or self._closed:
                        break
                    wait = 0.5
                    if self._retry_heap:
                        wait = min(wait, self._retry_heap[0][0] - now)
                    self._submit_cv.wait(max(wait, 0.01))
                if self._closed and not self._submit_q:
                    # Anything still in the retry heap is shutdown()'s
                    # to snapshot-and-fail; don't dispatch it here.
                    return
                batch = []
                while self._submit_q and len(batch) < limit:
                    batch.append(self._submit_q.popleft())
                # Popped-but-not-dispatched specs count as in flight so
                # shutdown()'s drain cannot slip between the pop and the
                # dispatch and release the submit holds early.
                self._dispatching = len(batch)
            for spec in batch:
                spec.pop("_handled", None)
            try:
                self._dispatch_batch(batch)
            except BaseException as e:  # noqa: BLE001 — submitter must live
                # Fail only specs the dispatch never handed off anywhere:
                # earlier specs in the batch may already be RUNNING on a
                # node, and writing a TaskError over their oids would race
                # their real results.
                _metrics.count_loop_restart("client.submit")
                for spec in batch:
                    if spec.get("_handled"):
                        continue
                    try:
                        self._fail_spec(spec, TaskError(
                            spec.get("fname", "task"),
                            f"submission failed: {e!r}", repr(e)))
                    # Per-spec error-write guard inside the already-
                    # counted batch handler: ticking here too would
                    # inflate the series by the batch width on one
                    # transient outage.
                    except BaseException:  # analyze: ignore[DL002]
                        pass
            finally:
                with self._submit_cv:
                    self._dispatching = 0

    def _queue_retry(self, spec: dict, delay: float | None = None) -> None:
        """Park a temporarily unplaceable spec for ONE shared retry timer
        (not a thread per spec): due specs re-enter the submit queue and
        re-batch through the normal dispatch path.

        Per-spec exponential backoff (submit_retry_base_s doubling to
        submit_retry_max_s): at 100k parked specs a flat 0.25s timer
        re-batched the ENTIRE backlog through schedule_batch every tick
        (~400 head RPCs per 250ms of pure misses, forever); backoff
        decays a standing backlog to a trickle while the first few
        attempts still land fast when capacity appears quickly."""
        import heapq

        spec["_handled"] = True
        spec.setdefault("_pending_since", time.monotonic())
        if delay is None:
            delay = spec.get("_retry_delay", config.submit_retry_base_s)
            spec["_retry_delay"] = min(
                config.submit_retry_max_s, delay * 2.0)
        with self._submit_cv:
            if not self._closed:
                self._retry_seq += 1
                heapq.heappush(
                    self._retry_heap,
                    (time.monotonic() + delay, self._retry_seq, spec))
                self._submit_cv.notify()
                return
        # Shutdown in progress: nothing will ever drain the retry heap
        # again (shutdown's fail pass may already have run) — fail the
        # spec into its refs now so no get() is left blocking. Guarded:
        # the store may already be unreachable this late in shutdown, and
        # an escape here would mark the spec handled-but-unfailed.
        try:
            self._end_borrows(spec)
            self._fail_spec(spec, TaskError(
                spec.get("fname", "task"),
                "client shut down with the task still unscheduled",
                "shutdown",
            ))
        except Exception:
            pass

    def _park_pending(self, spec: dict) -> None:
        """No feasible node right now: bounded retry via the shared timer,
        honoring cancellation and the pending-task timeout."""
        from ray_tpu_torch.core.object_ref import TaskCancelledError

        if spec.get("cancelled"):
            self._end_borrows(spec)
            self._fail_spec(
                spec, TaskCancelledError(spec.get("fname", "task")))
            return
        aff = spec["sinfo"].get("node_affinity")
        if aff is not None:
            # Hard affinity to a DEAD node can never place. Recovery of
            # PLACED specs already falls back to soft affinity when the
            # pinned node dies (_maybe_recover); a never-placed spec
            # parked on the same loss deserves the same fallback instead
            # of a guaranteed pending-timeout. Cached snapshot: a batch of parked affinity specs costs at
            # most one `nodes` RPC per second on the dispatch thread,
            # not one full-table fetch per spec per retry round.
            nodes = self._nodes_snapshot()
            if nodes is not None:
                info = nodes.get(aff)
                if info is None or not info.get("Alive"):
                    spec["sinfo"]["node_affinity"] = None
        since = spec.setdefault("_pending_since", time.monotonic())
        timeout = config.pending_task_timeout_s
        if time.monotonic() - since > timeout:
            self._end_borrows(spec)
            self._fail_spec(spec, TaskError(
                spec.get("fname", "task"),
                f"demand {spec['demand']} unsatisfiable for {timeout}s",
                "infeasible",
            ))
            return
        self._queue_retry(spec)

    def _dispatch_batch(self, batch: list) -> None:
        from ray_tpu_torch.core.object_ref import TaskCancelledError

        head_specs: list[dict] = []
        local_specs: list[dict] = []
        for spec in batch:
            if spec.get("cancelled"):
                self._end_borrows(spec)
                self._fail_spec(
                    spec, TaskCancelledError(spec.get("fname", "task")))
                continue
            if spec["sinfo"]["pg_id"] is not None:
                # PG bundles block on readiness server-side: keep them on
                # the per-spec path (rare, latency-insensitive).
                try:
                    self._submit_spec(spec, allow_pending=True)
                    spec["_handled"] = True
                except TimeoutError:
                    # Not ready within the resolve window — the group is
                    # still reserving, or RESCHEDULING while the head
                    # migrates bundles off a lost node. Park with the
                    # shared backoff timer: tasks pinned to a migrating
                    # gang re-resolve when the reservation lands, they
                    # don't error (bounded by pending_task_timeout_s).
                    self._park_pending(spec)
                except (ConnectionLost, OSError) as e:
                    if getattr(e, "maybe_executed", False):
                        # The push itself died mid-call: resubmitting
                        # could fork the task into two executions.
                        self._fail_spec(spec, TaskError(
                            spec.get("fname", "task"), str(e), repr(e)))
                    else:
                        # Nothing reached the node — typically a bundle
                        # host that died before the head declared it
                        # (the resolution pointed at a corpse). Park:
                        # the head flips the group to RESCHEDULING on
                        # death detection and the retry re-resolves to
                        # the bundle's new home.
                        self._park_pending(spec)
                except ValueError as e:
                    self._fail_spec(spec, TaskError(
                        spec.get("fname", "task"), str(e), repr(e)))
                continue
            if self._leasable(spec):
                local_specs.append(spec)
            else:
                head_specs.append(spec)

        if local_specs:
            # Prefer-local without the head: push to this client's own
            # node agent, which admits only what fits its UNCOMMITTED
            # capacity. Borrows register BEFORE dispatch (a begin must
            # never lose the race against the worker's task-end); a
            # rejected spec is re-registered by the head path
            # (begin-replaces semantics).
            rejected: set = set()
            try:
                agent = self._agent_client()
                self._register_borrows_batch(local_specs, self.node_id)
                for s in local_specs:
                    s["assigned_node"] = self.node_id
                rejected = set(agent.call(
                    "submit_tasks_leased", local_specs))
            except (ConnectionLost, OSError, RuntimeError) as e:
                if getattr(e, "maybe_executed", False):
                    # The push itself died mid-call: the agent may have
                    # enqueued the batch. Resubmitting could fork a task
                    # into two executions — fail the refs instead.
                    for s in local_specs:
                        self._end_borrows(s)
                        self._fail_spec(s, TaskError(
                            s.get("fname", "task"),
                            f"local agent unreachable during submit: "
                            f"{e!r}", repr(e)))
                    local_specs = []
                else:
                    # Nothing reached the agent (connect refused, borrow
                    # registration failed, ...): the whole set spills to
                    # head scheduling, exactly like a full local node.
                    rejected = set(range(len(local_specs)))
            spilled = []
            for i, s in enumerate(local_specs):
                if i in rejected:
                    spilled.append(s)
                else:
                    s["_handled"] = True
            if spilled:
                # Decentralized spillback (ray_syncer.h consumer): place
                # on a peer straight from the local agent's GOSSIPED
                # load view -- same leased admission there; only what no
                # peer admits falls through to the head. The spilled
                # flag tells the head to avoid the caller's node (its
                # heartbeat hasn't reflected the leased admissions that
                # caused the rejection yet).
                for s in self._spill_to_peers(spilled):
                    s["assigned_node"] = None
                    s["_spilled"] = True
                    head_specs.append(s)
            if local_specs and len(rejected) < len(local_specs):
                self._deliver_late_cancels(
                    [s for i, s in enumerate(local_specs)
                     if i not in rejected],
                    self._agent_address)

        if not head_specs:
            return
        reqs = [
            {"demand": s["demand"], "caller_node": self.node_id,
             "strategy": s["sinfo"]["strategy"],
             "node_affinity": s["sinfo"]["node_affinity"],
             "spilled": s.pop("_spilled", False)}
            for s in head_specs
        ]
        try:
            placements = self.head.call("schedule_batch", reqs)
        except (ConnectionLost, OSError) as e:
            for s in head_specs:
                self._end_borrows(s)
                self._fail_spec(s, TaskError(
                    s.get("fname", "task"),
                    f"head unreachable during submit: {e!r}", repr(e)))
            return
        by_node: dict[tuple, list[dict]] = {}
        for spec, placed in zip(head_specs, placements):
            if placed is None:
                self._park_pending(spec)
                continue
            node_id, address = placed
            spec["assigned_node"] = node_id
            # Placement succeeded: the unplaceable-backoff streak is
            # over. A later transient push failure re-parks at the base
            # delay, not this spec's stale max-backoff cadence.
            spec.pop("_retry_delay", None)
            by_node.setdefault((node_id, address), []).append(spec)
        for (node_id, address), specs in by_node.items():
            try:
                self._register_borrows_batch(specs, node_id)
                self._node_client(address).call("submit_tasks", specs)
                for s in specs:
                    s["_handled"] = True
                self._deliver_late_cancels(specs, address)
            except (ConnectionLost, OSError):
                # Leave any borrow registrations in place: they pin the
                # args through the retry window (the caller may have
                # dropped its handles already); the retried dispatch
                # re-registers (begin-replaces) or ends them on failure.
                for s in specs:
                    s["assigned_node"] = None
                    self._queue_retry(s)

    def _node_confirmed_dead(self, node_id: str) -> bool:
        """Whether the HEAD declares this node dead (or gone entirely).
        A maybe-executed push to a confirmed-dead peer cannot fork
        execution -- the process is gone and its store with it -- so the
        spec is safe to resubmit."""
        try:
            nodes = self.head.call("nodes", timeout=5.0)
        except (ConnectionLost, OSError):
            return False  # can't confirm: stay conservative
        for n in nodes:
            if n["NodeID"] == node_id:
                return not n["Alive"]
        return True  # deregistered entirely

    def _spill_to_peers(self, specs: list) -> list:
        """Try to place locally-rejected leasable specs on peers chosen
        from the local agent's gossiped cluster view (no head RPC).
        Returns the specs no peer admitted; everything else is handed
        off (leased push, same admission as the local path)."""
        try:
            view = self._agent_client().call("peer_view", timeout=5.0)
        except (ConnectionLost, OSError):
            return specs
        now = time.time()
        avail: dict[str, dict] = {}
        addr_of: dict[str, str] = {}
        for nid, e in (view or {}).items():
            if nid == self.node_id or not e.get("address"):
                continue
            # Staleness gate is generous (gossip cadence stretches with
            # cluster size): the peer's LEASED admission is the real
            # correctness check -- stale availability just costs a
            # rejected push and a head fallback.
            if now - e.get("ts", 0.0) > 10.0:
                continue
            avail[nid] = dict(e.get("available") or {})
            addr_of[nid] = e["address"]
        if not avail:
            return specs
        by_peer: dict[str, list] = {}
        unplaced: list = []
        for s in specs:
            demand = s["demand"]
            best = None
            for nid, av in avail.items():
                if all(av.get(k, 0.0) >= v for k, v in demand.items()):
                    if best is None or av.get("CPU", 0.0) > \
                            avail[best].get("CPU", 0.0):
                        best = nid
            if best is None:
                unplaced.append(s)
                continue
            for k, v in demand.items():
                avail[best][k] = avail[best].get(k, 0.0) - v
            by_peer.setdefault(best, []).append(s)
        for nid, group in by_peer.items():
            address = addr_of[nid]
            try:
                self._register_borrows_batch(group, nid)
                for s in group:
                    s["assigned_node"] = nid
                rej = set(self._node_client(address).call(
                    "submit_tasks_leased", group))
            except (ConnectionLost, OSError, RuntimeError) as e:
                if getattr(e, "maybe_executed", False) \
                        and not self._node_confirmed_dead(nid):
                    # The push died mid-call: the peer may have enqueued
                    # the batch; resubmitting could fork execution.
                    for s in group:
                        self._end_borrows(s)
                        self._fail_spec(s, TaskError(
                            s.get("fname", "task"),
                            f"peer agent unreachable during spillback: "
                            f"{e!r}", repr(e)))
                    continue
                rej = set(range(len(group)))
            for i, s in enumerate(group):
                if i in rej:
                    s["assigned_node"] = None
                    unplaced.append(s)
                else:
                    s["_handled"] = True
            if len(rej) < len(group):
                self._deliver_late_cancels(
                    [s for i, s in enumerate(group) if i not in rej],
                    address)
        return unplaced

    def _retry_submit(self, spec: dict, timeout: float | None = None):
        from ray_tpu_torch.core.object_ref import TaskCancelledError

        if timeout is None:
            timeout = config.pending_task_timeout_s
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            time.sleep(0.25)
            if spec.get("cancelled"):
                self._drop_holds(spec)
                self._end_borrows(spec)
                err = TaskCancelledError(spec.get("fname", "task"))
                for oid in spec["oids"]:
                    self.put_with_id(oid, err, is_error=True)
                return
            placed = self._choose_node(spec["demand"], spec["sinfo"])
            if placed is not None:
                node_id, address = placed
                spec["assigned_node"] = node_id
                self._register_borrows(spec, node_id)
                try:
                    self._node_client(address).call("submit_task", spec)
                except (ConnectionLost, OSError):
                    self._end_borrows(spec)
                    continue
                if spec.get("cancelled"):
                    # cancel() saw assigned_node=None and sent no node RPC;
                    # now that the task has a home, deliver it there (the
                    # agent's cancelled-set covers every dispatch window).
                    try:
                        self._node_client(address).call(
                            "cancel_task", spec["task_id"], False)
                    except (ConnectionLost, OSError):
                        pass
                return
        self._drop_holds(spec)
        self._end_borrows(spec)  # no-op unless a leased attempt registered
        err = TaskError(
            spec.get("fname", "task"),
            f"demand {spec['demand']} unsatisfiable for {timeout}s",
            "infeasible",
        )
        for oid in spec["oids"]:
            self.put_with_id(oid, err, is_error=True)

    def submit_task(
        self,
        func: Callable,
        args: tuple,
        kwargs: dict,
        *,
        num_returns: int = 1,
        max_retries: int | None = None,
        retry_exceptions: bool | tuple = False,
        name: str = "",
        **options,
    ) -> list[ObjectRef]:
        if max_retries is None:
            max_retries = config.task_default_max_retries
        runtime_env = self._resolve_runtime_env(options)
        task_id = ids.new_task_id()
        # A streaming task tracks one oid, index 0 (its first item); the
        # generator mints the later ones (reference client.py:1955).
        n_oids = 1 if num_returns == "streaming" else num_returns
        oids = [ids.object_id_for(task_id, i) for i in range(n_oids)]
        refs = [self.make_ref(o) for o in oids]
        borrowed: list[str] = []
        args_blob = self._dump_args(args, kwargs, borrowed)
        # Function table (reference: function export to the GCS function
        # table, _private/function_manager.py): the function serializes
        # ONCE per driver, lands in the cluster KV under its content
        # hash, and specs carry only the hash — workers cache the
        # deserialized function. Refs captured in the closure are borrows
        # of every task using the function.
        fn_hash, closure_refs = self._export_function(func)
        borrowed.extend(closure_refs)
        spec = {
            "task_id": task_id,
            "oids": oids,
            "owner_addr": self.owner_addr,
            "num_returns": num_returns,
            "fname": name or getattr(func, "__name__", "task"),
            "func_hash": fn_hash,
            "args": args_blob,
            "borrowed": borrowed,
            "demand": demand_of(options, is_actor=False),
            "sinfo": self._strategy_info(options),
            "pg_id": None,
            "bundle_index": -1,
            "retries_left": max_retries,
            "runtime_env": runtime_env,
        }
        spec["pg_id"] = spec["sinfo"]["pg_id"]
        spec["bundle_index"] = spec["sinfo"]["bundle_index"]
        self._stamp_callsite(spec)
        # The submission span covers the client-side submit (enqueue);
        # its context rides the spec so the worker parents the run span
        # under it. Dispatch is asynchronous: the submitter thread
        # batches it with its neighbors.
        with self._submit_span(spec, spec["fname"]):
            for oid in oids:
                self._lineage[oid] = spec
            if borrowed:
                # Hold borrowed args until the head learns of the borrows
                # (the caller may drop its handles the moment we return).
                for oid in borrowed:
                    self._incref(oid)
                self._submit_holds[task_id] = list(borrowed)
            with self._submit_cv:
                self._submit_q.append(spec)
                self._submit_cv.notify()
        return refs

    def release_stream(self, task_id: str, from_index: int) -> None:
        """Drop an abandoned stream's unconsumed items (the
        ``ObjectRefGenerator`` finalizer; reference client.py:2023-2045):
        cancel a still-running producer cooperatively -- past
        ``cancel()``'s guard for finished tasks, which a stream with one
        item stored always trips -- then have the head free the tail,
        present and future (``stream_release``). The owner table forgets
        the tail too, and ignores the producer's later reports of it."""
        spec = self._lineage.get(ids.object_id_for(task_id, 0))
        with self._owned_cv:
            self._released_streams[task_id] = int(from_index)
            while len(self._released_streams) > 100_000:
                del self._released_streams[next(iter(self._released_streams))]
            for oid in [o for o in self._owned if o[:32] == task_id
                        and ids.task_of_object(o)[1] >= from_index]:
                self._owned.pop(oid, None)
        if spec is not None:
            spec["retries_left"] = 0
            spec["cancelled"] = True
            assigned = spec.get("assigned_node")
            if assigned is not None:
                try:
                    node = (self._nodes_snapshot(0.0) or {}).get(assigned)
                    if node is not None and node["Alive"]:
                        self._node_client(node["Address"]).call(
                            "cancel_task", spec["task_id"], False)
                except (ConnectionLost, OSError):
                    pass
        try:
            self.head.call("stream_release", task_id, from_index)
        except (ConnectionLost, OSError):
            pass

    @staticmethod
    def _stamp_callsite(spec: dict) -> None:
        """Submit-time callsite (``record_callsite`` on): the worker
        attributes the call's return objects to the ``.remote()`` line."""
        from ray_tpu_torch.core import attribution

        site = attribution.submit_site()
        if site:
            spec["callsite"] = site

    @staticmethod
    @contextlib.contextmanager
    def _submit_span(spec: dict, name: str):
        """A ``submit:<name>`` span around the submit when tracing is on,
        its context stored as the spec's ``trace_ctx``."""
        from ray_tpu_torch.util import tracing

        with tracing.span(f"submit:{name}",
                          {"task_id": spec["task_id"]}) as sp:
            if sp is not None:
                spec["trace_ctx"] = {"trace_id": sp["trace_id"],
                                     "span_id": sp["span_id"]}
            yield

    def _export_function(self, func) -> tuple[str, list]:
        """(function_table_key, closure_ref_ids); exports to the KV on
        first sight. Keys are namespaced per driver (``fn:<client_id>:
        <hash>``) and deleted when the driver closes, so closure-heavy
        drivers can't grow the head without bound — the reference's
        function table is likewise scoped and cleaned per job. The memo
        is weak-keyed so dynamically created lambdas don't accumulate;
        unhashable callables just re-export."""
        import hashlib

        cached = None
        try:
            cached = self._fn_exports.get(func)
        except TypeError:
            pass
        if cached is None:
            closure_refs: list[str] = []
            if isinstance(func, ser.Serialized):
                blob = func.data  # a ray:// client's, by reference
                closure_refs.extend(func.refs)
            else:
                blob = ser.dumps(func, found_refs=closure_refs)
            key = (f"fn:{self.client_id}:"
                   f"{hashlib.sha1(blob).hexdigest()}")
            with self._ref_lock:
                known = key in self._fn_keys
            if not known:
                # overwrite=False: first writer wins; same key = same
                # bytes.
                self.head.call("kv_put", key, blob, False)
                with self._ref_lock:
                    self._fn_keys.add(key)
            cached = (key, closure_refs)
            try:
                self._fn_exports[func] = cached
            except TypeError:
                pass
        return cached

    # -- actor plane -------------------------------------------------------

    def create_actor(
        self,
        cls: type,
        args: tuple,
        kwargs: dict,
        *,
        name: str | None = None,
        max_concurrency: int = 1,
        **options,
    ) -> str:
        runtime_env = self._resolve_runtime_env(options)
        actor_id = ids.new_actor_id()
        borrowed: list[str] = []
        args_blob = self._dump_args(args, kwargs, borrowed)
        if isinstance(cls, ser.Serialized):
            cls_blob = cls.data  # a ray:// client's, by reference
            borrowed.extend(cls.refs)
        else:
            cls_blob = ser.dumps(cls, found_refs=borrowed)
        spec = {
            "actor_create": True,
            "actor_id": actor_id,
            "task_id": ids.new_task_id(),
            "oids": [],
            "class_name": cls.__name__,
            "name": name,
            "fname": f"{cls.__name__}.__init__",
            "func": cls_blob,
            "args": args_blob,
            "borrowed": borrowed,
            "demand": demand_of(options, is_actor=True),
            "sinfo": self._strategy_info(options),
            "retries_left": 0,
            # >1 = threaded actor: methods run on a pool of this many
            # executor threads (reference threaded-actor semantics; call
            # ordering is relaxed).
            "max_concurrency": int(max_concurrency),
            # {group_name: n_threads}: named executor groups with their
            # own queues (reference concurrency groups) — calls routed
            # via ActorMethod.options(concurrency_group=...).
            "concurrency_groups": options.get("concurrency_groups"),
            # An actor's method calls run in its worker, so in its env.
            "runtime_env": runtime_env,
        }
        spec["pg_id"] = spec["sinfo"]["pg_id"]
        spec["bundle_index"] = spec["sinfo"]["bundle_index"]
        # The head keeps the creation spec so it can reconstruct the actor
        # on worker/node death (max_restarts budget; -1 = infinite).
        self.head.call(
            "create_actor_record", actor_id,
            options.get("max_restarts", 0),
            options.get("max_task_retries", 0),
            spec,
        )
        with self._lock:
            self._actor_creations[actor_id] = spec
        self._submit_spec(spec)  # raises if infeasible
        return actor_id

    def _recover_actor_creation(self, actor_id: str) -> bool:
        """The actor never registered and the node its creation was
        dispatched to is gone: resubmit the creation spec (driver-side
        lineage for actor ctors; duplicate-safe because the assigned
        node is dead — its queue died with it). Returns True if a
        resubmission happened."""
        with self._lock:
            spec = self._actor_creations.get(actor_id)
            if spec is None or spec.get("_recovering"):
                # Another thread is already recovering this creation:
                # report True so the caller re-enters its wait instead
                # of failing — a second concurrent resubmit would fork
                # the ctor into two incarnations.
                return spec is not None and bool(spec.get("_recovering"))
            spec["_recovering"] = True
        try:
            assigned = spec.get("assigned_node")
            if assigned is None:
                return False  # not dispatched yet: absence is slowness
            nodes = self._nodes_snapshot()
            if nodes is None:
                return False
            if nodes.get(assigned, {}).get("Alive"):
                return False  # creation still in flight on a live node
            spec["assigned_node"] = None
            spec["sinfo"]["node_affinity"] = None
            try:
                self._submit_spec(spec)
            except (ValueError, TimeoutError):
                return False
            return True
        finally:
            with self._lock:
                spec.pop("_recovering", None)

    def _wait_actor_alive(self, actor_id: str, timeout: float = 60.0) -> dict:
        """Block through a RESTARTING window until the actor is ALIVE (or
        raise if it ends up DEAD / never recovers)."""
        deadline = time.monotonic() + timeout
        while True:
            try:
                info = self._actor_info(actor_id, refresh=True)
            except ValueError:
                # Never registered: the creation itself may have died
                # with its node — resubmit through creation lineage.
                if self._recover_actor_creation(actor_id) and \
                        time.monotonic() < deadline:
                    continue
                raise
            if info["state"] == "ALIVE":
                return info
            if info["state"] == "DEAD":
                raise ActorError(
                    f"actor {actor_id} is dead: {info['death_cause']}"
                )
            if time.monotonic() > deadline:
                raise ActorError(
                    f"actor {actor_id} stuck in {info['state']} for {timeout}s"
                )
            time.sleep(0.05)

    def _actor_info(self, actor_id: str, refresh: bool = False) -> dict:
        with self._lock:
            info = self._actor_cache.get(actor_id)
        if info is None or refresh or info["state"] != "ALIVE":
            t = config.actor_register_timeout_s
            info = self.head.call("get_actor", actor_id, t, timeout=t * 1.5)
            if info is None:
                raise ValueError(f"no such actor: {actor_id}")
            with self._lock:
                self._actor_cache[actor_id] = info
                # Registered: the head owns restarts from here on; the
                # creation-lineage spec is spent.
                self._actor_creations.pop(actor_id, None)
        return info

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
        task_id = ids.new_task_id()
        oids = [ids.object_id_for(task_id, i) for i in range(num_returns)]
        refs = [self.make_ref(o) for o in oids]
        borrowed: list[str] = []
        args_blob = self._dump_args(args, kwargs, borrowed)
        spec = {
            "task_id": task_id,
            "actor_id": actor_id,
            "method": method_name,
            "oids": oids,
            "owner_addr": self.owner_addr,
            "num_returns": num_returns,
            "args": args_blob,
            "borrowed": borrowed,
            "concurrency_group": _options.get("concurrency_group"),
        }
        self._stamp_callsite(spec)
        # The submit span covers the push; the run span in the actor's
        # worker parents under it (spec["trace_ctx"]).
        with self._submit_span(spec, method_name):
            try:
                try:
                    info = self._actor_info(actor_id)
                except ValueError:
                    # Creation lost with its node before registering: the
                    # creation-lineage resubmit (duplicate-safe — the
                    # assigned node is dead) brings it up elsewhere.
                    if not self._recover_actor_creation(actor_id):
                        raise
                    info = self._wait_actor_alive(actor_id)
                if info["state"] != "ALIVE":
                    info = self._wait_actor_alive(actor_id)
                # Push under a TIME budget, not an attempt count: under
                # node kills and restarts several
                # consecutive targets can each be transiently unreachable,
                # and a fixed attempt count burns out in milliseconds while
                # the head's view is stale. Genuine permanent death still
                # fails fast — _wait_actor_alive raises the moment the head
                # settles the actor DEAD.
                detect_s = DEAD_AFTER_S
                push_deadline = time.monotonic() + max(
                    60.0, 3 * detect_s + 30.0)
                pushed = False
                while time.monotonic() < push_deadline:
                    self._register_borrows(spec, info["node_id"])
                    try:
                        self._worker_client(info["address"]).call(
                            "push_actor_task", spec
                        )
                        pushed = True
                        break
                    except (ConnectionLost, OSError) as e:
                        self._end_borrows(spec)
                        if getattr(e, "maybe_executed", False):
                            # The push was FULLY sent and only the reply was
                            # lost: the worker most likely has (or ran) the
                            # call — its task-id dup-suppression makes the
                            # immediate re-push safe, so probe right away.
                            time.sleep(0.1)
                            info = self._wait_actor_alive(actor_id)
                            continue
                        # Worker unreachable at connect: the head may still
                        # report the dead incarnation ALIVE at this address
                        # for up to the death-detection window. Wait for the
                        # head's view to MOVE (restarted incarnation or new
                        # address) before re-pushing; fall out periodically
                        # to re-probe the same address in case the loss was
                        # a transient blip.
                        prev_addr = info["address"]
                        prev_restarts = info.get("num_restarts", 0)
                        moved_deadline = min(
                            time.monotonic() + detect_s + 5.0, push_deadline)
                        while time.monotonic() < moved_deadline:
                            info = self._wait_actor_alive(actor_id)
                            if info["address"] != prev_addr or \
                                    info.get("num_restarts",
                                             0) > prev_restarts:
                                break
                            time.sleep(0.25)
                if not pushed:
                    raise ActorError(f"actor {actor_id}: push failed repeatedly")
                # ONE shared entry for all return oids: a restart must replay
                # the call once, not once per return value.
                entry = {
                    "actor_id": actor_id,
                    "spec": spec,
                    "oids": oids,
                    "incarnation": info.get("num_restarts", 0),
                    "retries_left": info.get("max_task_retries", 0),
                }
                for oid in oids:
                    self._actor_tasks[oid] = entry
            except ActorError as e:
                self._end_borrows(spec)
                for oid in oids:
                    self.put_with_id(oid, e, is_error=True)
        return refs

    def _end_borrows(self, spec: dict) -> None:
        if spec.get("borrowed"):
            try:
                self.head.call("ref_task_end", spec["task_id"])
            except (ConnectionLost, OSError):
                pass

    def kill_actor(self, actor_id: str, no_restart: bool = True) -> None:
        info = self._actor_info(actor_id, refresh=True)
        if info["state"] == "DEAD":
            return
        if no_restart:
            # Burn the restart budget so an in-flight reconstruction can't
            # resurrect it either.
            try:
                self.head.call(
                    "mark_actor_dead", actor_id,
                    "killed via ray_tpu_torch.kill",
                    False,
                )
            except (ConnectionLost, OSError):
                pass
        nodes = {n["NodeID"]: n for n in self.head.call("nodes")}
        node = nodes.get(info["node_id"])
        if node is None or not node["Alive"]:
            return
        try:
            self._node_client(node["Address"]).call(
                "kill_actor", actor_id, no_restart
            )
        except (ConnectionLost, OSError):
            pass

    def get_named_actor(self, name: str) -> str:
        info = self.head.call("get_named_actor", name)
        if info is None or info["state"] == "DEAD":
            raise ValueError(f"no actor named {name!r}")
        with self._lock:
            self._actor_cache[info["actor_id"]] = info
        return info["actor_id"]

    def cancel(self, ref: ObjectRef, force: bool = False) -> None:
        """Best-effort cancel (``ray.cancel`` parity): queued tasks are
        dropped and their refs raise TaskCancelledError; running tasks are
        force-killed (worker process) or cooperatively interrupted; actor
        calls are cancelled in the actor's queue or interrupted in place
        (the actor itself survives — force never kills an actor)."""
        oid = ref.id
        entry = self._actor_tasks.get(oid)
        if entry is not None:
            spec = entry["spec"]
            entry["retries_left"] = 0  # a cancelled call must not replay
            try:
                info = self._actor_info(spec["actor_id"], refresh=True)
                if info.get("address"):
                    self._worker_client(info["address"]).call(
                        "cancel_task", spec["task_id"], force
                    )
            except (ConnectionLost, OSError, ActorError, KeyError):
                pass
            return
        spec = self._lineage.get(oid)
        if spec is None:
            return  # finished-and-dropped or not owned here: no-op
        # Already-finished outputs have locations (or a local copy):
        # cancel must stay a no-op AND must not burn the lineage budget
        # that protects the computed value against later node loss.
        try:
            if self.store.contains(oid):
                return
            loc = self.head.call("locations", oid)
            if loc and loc["nodes"]:
                return
        except (ConnectionLost, OSError):
            pass
        spec["retries_left"] = 0   # no lineage re-exec of a cancelled task
        spec["cancelled"] = True   # the pending-retry thread checks this
        assigned = spec.get("assigned_node")
        if assigned is None:
            return  # still unplaced: _retry_submit stores the error
        try:
            nodes = {n["NodeID"]: n for n in self.head.call("nodes")}
            node = nodes.get(assigned)
            if node is not None and node["Alive"]:
                self._node_client(node["Address"]).call(
                    "cancel_task", spec["task_id"], force
                )
        except (ConnectionLost, OSError):
            pass

    # -- placement groups --------------------------------------------------

    def create_placement_group(self, bundles, strategy, name="",
                               lifetime=None, spot=True):
        # Client-generated id makes the call idempotent under the head
        # client's reconnect-window retry (a replayed create must not
        # reserve a second PG's resources). ``spot`` is an autoscaler
        # hint the port does not read (ROADMAP A4c).
        pg_id = ids.new_placement_group_id()
        return self.head.call(
            "create_placement_group", bundles, strategy, name, lifetime,
            pg_id,
        )

    def remove_placement_group(self, pg_id: str) -> None:
        self.head.call("remove_placement_group", pg_id)

    def placement_group_table(self, pg_id=None):
        table = self.head.call("placement_group_table", pg_id)
        if table is None:
            return None
        if pg_id is not None:
            return {**table, "state": table["state"]}
        return table

    def placement_group_ready(self, pg_id: str) -> ObjectRef:
        oid = ids.new_object_id()
        ref = self.make_ref(oid)

        def waiter():
            deadline = time.monotonic() + 300.0
            while time.monotonic() < deadline:
                table = self.head.call("placement_group_table", pg_id)
                if table is None:
                    break
                if table["state"] == "CREATED":
                    self.put_with_id(oid, pg_id)
                    return
                if table["state"] in ("INFEASIBLE", "REMOVED", "DEAD"):
                    break
                time.sleep(0.02)
            self.put_with_id(
                oid,
                ValueError(f"placement group {pg_id} cannot become ready"),
                is_error=True,
            )

        threading.Thread(target=waiter, daemon=True).start()
        return ref

    def current_placement_group(self):
        """The group that captured this worker's actor (an actor placed
        with ``placement_group_capture_child_tasks``; ``workerproc``
        records it at construction), else None. The actor's children
        are not placed in it by default, as the local backend places
        them: a child names the group itself (``train/trainer.py
        WorkerGroup``). The reference's cluster backend reports none."""
        pg_id = getattr(self, "captured_pg_id", None)
        if pg_id is None:
            return None
        table = self.head.call("placement_group_table", pg_id)
        if table is None:
            return None
        return {"id": pg_id, "bundles": table["bundles"],
                "strategy": table["strategy"], "name": table.get("name", "")}

    # -- introspection / lifecycle ----------------------------------------

    @property
    def node_ip(self) -> str:
        """The host part of this node's agent address: where the cluster
        reaches this node."""
        return (self._agent_address or "127.0.0.1:0").rsplit(":", 1)[0]

    def cluster_resources(self) -> dict:
        return self.head.call("cluster_resources")

    def available_resources(self) -> dict:
        return self.head.call("available_resources")

    def nodes(self) -> list[dict]:
        return self.head.call("nodes")

    # -- state API (experimental/state/api.py analog) ----------------------

    def list_tasks(self, limit: int = 1000) -> list:
        return self.head.call("list_tasks", limit, timeout=15.0)

    def list_actors(self) -> list:
        return self.head.call("list_actors")

    def list_objects(self, limit: int = 1000) -> dict:
        """{"objects": [...], "truncated": bool, "total": int}: records
        sorted by size descending, with owner, task, callsite and age."""
        return self.head.call("list_objects", limit)

    def memory_summary(self, top_k: int = 20,
                       group_by: str = "callsite") -> dict:
        """Cluster-wide object and memory rollup (``ray memory``)."""
        return self.head.call("memory_summary", top_k, group_by,
                              timeout=30.0)

    def memory_leaks(self) -> list:
        """Objects the head's leak sweeper currently flags."""
        return self.head.call("memory_leaks", timeout=15.0)

    def object_store_stats(self, node_id=None,
                           include_objects: bool = True) -> list:
        """Per-node store stats, with the per-key size / refcount /
        pinned / attribution join when ``include_objects``."""
        return self.head.call("object_store_stats", node_id,
                              include_objects, timeout=30.0)

    def worker_stats(self, fresh: bool = False) -> list:
        return self.head.call("worker_stats", fresh, timeout=15.0)

    def device_stats(self, fresh: bool = False) -> list:
        """Per-worker CUDA device snapshots across the cluster."""
        return self.head.call("device_stats", fresh, timeout=20.0)

    def list_spans(self, trace_id=None, limit: int = 10_000) -> list:
        """Finished spans from the head's span store."""
        self._flush_spans_quiet()
        return self.head.call("list_spans", trace_id, limit, timeout=15.0)

    def _flush_spans_quiet(self):
        """Best-effort pre-query flush, so a trace queried right after its
        request finished is not missing this process's spans."""
        try:
            self._flush_spans()
        except Exception:
            pass

    def get_trace(self, trace_id: str):
        self._flush_spans_quiet()
        return self.head.call("get_trace", trace_id, timeout=15.0)

    def list_traces(self, limit: int = 50) -> list:
        self._flush_spans_quiet()
        return self.head.call("list_traces", limit, timeout=15.0)

    def trace_stats(self) -> dict:
        self._flush_spans_quiet()
        return self.head.call("trace_stats", timeout=15.0)

    def ttft_decomposition(self, window_s: float | None = None,
                           deployment: str | None = None) -> dict:
        self._flush_spans_quiet()
        return self.head.call("ttft_decomposition", window_s, deployment,
                              timeout=15.0)

    # -- operating the cluster: logs, stacks, profiles ----------------------

    def list_logs(self) -> list:
        """Per-worker captured log files across the cluster."""
        return self.head.call("list_logs", timeout=15.0)

    def get_log(self, worker_id: str, stream: str = "out", offset=None,
                max_bytes: int = 1 << 20, tail_lines=None,
                node_id=None) -> dict:
        return self.head.call("get_log", worker_id, stream, offset,
                              max_bytes, tail_lines, node_id, timeout=20.0)

    def follow_log(self, worker_id: str, stream: str = "out",
                   offset: int = 0, idle_timeout_s: float = 10.0,
                   node_id=None):
        """Iterator of {"offset", "data"} chunks, streamed end to end
        (the agent's file -> the head -> here)."""
        return self.head.call_stream(
            "follow_log", worker_id, stream, offset, idle_timeout_s,
            node_id, timeout=idle_timeout_s + 60.0)

    def dump_worker_stack(self, worker_id: str, node_id=None) -> str:
        return self.head.call("dump_worker_stack", worker_id, node_id,
                              timeout=30.0)

    def profile_worker(self, worker_id: str, duration_s: float = 1.0,
                       interval_s: float = 0.01, node_id=None) -> dict:
        return self.head.call("profile_worker", worker_id, duration_s,
                              interval_s, node_id,
                              timeout=float(duration_s) + 60.0)

    def capture_profile(self, worker_id: str, duration_s: float = 1.0,
                        interval_s: float = 0.01, out_dir=None,
                        node_id=None) -> dict:
        """A profiler capture in the worker, its files downloaded in 1 MiB
        reads through the head into ``out_dir`` (a fresh temporary
        directory by default). A file served short of its manifest size
        fails the capture."""
        import tempfile

        from ray_tpu_torch.util.device_telemetry import resolve_capture_path

        manifest = self.head.call(
            "capture_profile", worker_id, float(duration_s),
            float(interval_s), node_id, timeout=float(duration_s) + 120.0)
        out_dir = out_dir or tempfile.mkdtemp(prefix="rtorch_tprof_")
        paths = []
        for f in manifest.get("files", []):
            path = resolve_capture_path(out_dir, f["name"])
            if path is None:
                continue  # a remote name never escapes out_dir
            offset = 0
            with open(path, "wb") as fh:
                while True:
                    chunk = self.head.call(
                        "read_capture_file", manifest["node_id"],
                        manifest["capture_id"], f["name"], offset, 1 << 20,
                        timeout=60.0)
                    data = chunk.get("data") or b""
                    if data:
                        fh.write(data)
                        offset = chunk["offset"]
                    if not data or offset >= chunk.get("size", 0):
                        break
            if offset < f.get("size", 0):
                raise ValueError(
                    f"capture file {f['name']!r} truncated at "
                    f"{offset}/{f['size']} bytes (capture evicted?)")
            paths.append(path)
        return {"kind": manifest.get("kind"), "worker_id": worker_id,
                "node_id": manifest.get("node_id"),
                "duration_s": manifest.get("duration_s"),
                "import_s": manifest.get("import_s"),
                "dir": out_dir, "files": paths}

    def received_logs(self) -> list:
        """The workers' lines this driver received over LOGS (bounded):
        dicts of node_id, pid, worker_id and line."""
        return list(self._driver_logs)

    def _log_poll_loop(self, subscribed: bool = False) -> None:
        """Follow the LOGS channel (long polls). A None poll means the
        head lost the subscription (a restart): subscribe again."""
        sub_id = "logs:" + self.client_id
        while not self._closed:
            try:
                if not subscribed:
                    self.head.call("pubsub_subscribe", sub_id, "LOGS")
                    subscribed = True
                got = self.head.call("pubsub_poll", sub_id, 2.0,
                                     timeout=15.0)
            except Exception:
                _metrics.count_loop_restart("client.log_poll")
                subscribed = False
                time.sleep(0.5)
                continue
            if got is None:
                subscribed = False
                continue
            msgs, _dropped = got
            for m in msgs:
                d = m["data"]
                for line in d["lines"]:
                    self._driver_logs.append({
                        "node_id": d["node_id"], "pid": d["pid"],
                        "worker_id": d.get("worker_id"), "line": line})
                    if self._log_to_driver:
                        try:
                            print(f"(pid={d['pid']}, "
                                  f"node={d['node_id'][-8:]}) {line}")
                        except Exception:
                            # stdout swapped or closed under us: the
                            # poller lives on.
                            _metrics.count_loop_restart("client.log_poll")

    # -- metrics, the signal plane, SLOs -------------------------------------

    def cluster_metrics_text(self) -> str:
        """The head's federated /metrics/cluster body."""
        return self.head.call("cluster_metrics_text", timeout=30.0)

    def metrics_endpoint(self):
        """The head's scrape endpoint {address, cluster_path,
        targets_path}, or None when disabled."""
        return self.head.call("metrics_endpoint")

    def query_metrics(self, spec: dict) -> dict:
        return self.head.call("query_metrics", spec, timeout=15.0)

    def slo_status(self) -> dict:
        return self.head.call("slo_status", timeout=15.0)

    def register_slo(self, name: str, expr: str) -> dict:
        return self.head.call("register_slo", name, expr, timeout=15.0)

    def remove_slo(self, name: str) -> dict:
        return self.head.call("remove_slo", name, timeout=15.0)

    def signal_top(self, window_s: float = 60.0) -> dict:
        return self.head.call("signal_top", window_s, timeout=15.0)

    # -- the failpoint and network chaos control plane -----------------------

    def set_failpoints(self, specs: dict,
                       include_workers: bool = True) -> dict:
        """Arm/disarm failpoints cluster-wide (head -> agents ->
        workers); a falsy spec disarms the site."""
        return self.head.call("set_failpoints", specs, include_workers,
                              timeout=30.0)

    def list_failpoints(self) -> dict:
        return self.head.call("list_failpoints", timeout=30.0)

    def set_channel_chaos(self, rules: list, label: str = "") -> dict:
        return self.head.call("set_channel_chaos", rules, label,
                              timeout=30.0)

    def clear_channel_chaos(self, label=None) -> dict:
        return self.head.call("clear_channel_chaos", label, timeout=30.0)

    def list_channel_chaos(self) -> dict:
        return self.head.call("list_channel_chaos", timeout=30.0)

    def partition(self, groups: list) -> dict:
        """A symmetric network partition between endpoint groups (node
        ids, or "head"); ``heal`` removes it."""
        return self.head.call("partition", groups, timeout=30.0)

    def heal(self) -> dict:
        return self.head.call("heal", timeout=30.0)

    def shutdown(self) -> None:
        """Disconnect this client (the cluster keeps running; use
        Cluster.shutdown / shutdown_cluster to tear it down)."""
        # This process's daemon loops die with it: retract their
        # restart series.
        _metrics.retract_loop_series(["client.ref_flush", "client.submit",
                                      "client.span_flush", "client.log_poll"])
        # Drain the submit queue first: tasks handed to submit_task before
        # shutdown must reach a node (or fail into their refs) — then the
        # closed flag stops the submitter thread. "_dispatching" covers
        # the window where the submitter has popped a batch but not yet
        # registered its borrows.
        deadline = time.monotonic() + 5.0
        while ((self._submit_q or self._dispatching)
               and time.monotonic() < deadline):
            time.sleep(0.02)
        # Specs parked on the retry timer (unplaceable demand, node-submit
        # retries) can never run now — fail them into their result refs so
        # a concurrent get() raises instead of blocking to its own timeout.
        # _closed is set under the same lock BEFORE the heap snapshot so a
        # retry that comes due mid-shutdown cannot re-park after the clear
        # (_queue_retry fails specs instead once closed).
        with self._submit_cv:
            self._closed = True
            parked = [entry[2] for entry in self._retry_heap]
            self._retry_heap.clear()
            self._submit_cv.notify_all()
        for spec in parked:
            # Parked specs carry _handled=True (the dispatch loop took
            # responsibility) but by definition have produced no result.
            try:
                self._end_borrows(spec)
                self._fail_spec(spec, TaskError(
                    spec.get("fname", "task"),
                    "client shut down with the task still unscheduled",
                    "shutdown",
                ))
            except Exception:
                pass  # store may already be unreachable
        # Release every hold this process still has so the cluster can
        # free the objects (clean-exit ref release).
        with self._ref_lock:
            self._closed = True
            release = set(self._local_refs) | self._dirty_remove
            self._local_refs.clear()
            self._dirty_add.clear()
            self._dirty_remove.clear()
            self._ref_cv.notify_all()
        if release:
            try:
                self.head.call(
                    "ref_update", self.client_id, [], sorted(release)
                )
            except (ConnectionLost, OSError):
                pass
        # Function-table cleanup: this driver's exports are namespaced by
        # client_id, so deleting them can't break other drivers.
        with self._ref_lock:
            fn_keys, self._fn_keys = self._fn_keys, set()
        for key in fn_keys:
            try:
                self.head.call("kv_del", key)
            except (ConnectionLost, OSError):
                break  # head gone: its KV dies with it anyway
        with self._lock:
            clients = (
                list(self._node_clients.values())
                + list(self._worker_clients.values())
                + list(self._owner_clients.values())
            )
            self._node_clients.clear()
            self._worker_clients.clear()
            self._owner_clients.clear()
        for c in clients:
            c.close()
        # Owner directory dies with the owner (reference semantics: owner
        # failure = its objects become unrecoverable except via the head's
        # FT view / lineage). Borrowers fail over on ConnectionLost.
        try:
            self._owner_server.stop()
        except Exception:
            pass
        for attr in ("_prefetch_pool", "_fetch_pool", "_chunk_pool"):
            pool = getattr(self, attr, None)
            if pool is not None:
                pool.shutdown(wait=False)
        self._pins.clear()
        self.store.close()
        self.head.close()


def connect(address: str, **kwargs):
    """Backend factory for ``ray_tpu_torch.init(address=...)`` (reference
    client.py:2876-2888). ``host:port`` of a head: a driver on a cluster
    machine (shared-memory object plane). ``ray://host:port``: a remote
    client through a ``ClientProxyServer`` (``util/client``), which maps
    no store and joins no cluster."""
    if address.startswith("ray://"):
        from ray_tpu_torch.util.client import ClientBackend

        return ClientBackend(address.removeprefix("ray://"))
    return ClusterBackend(address.removeprefix("tcp://"),
                          log_to_driver=kwargs.get("log_to_driver", True))
