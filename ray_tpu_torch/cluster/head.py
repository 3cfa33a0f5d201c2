"""Head server: the cluster control plane (port of
``ray_tpu/cluster/head.py``; GCS equivalent).

Mirrors the managers booted by the reference GCS
(``src/ray/gcs/gcs_server/gcs_server.cc:119-166``): node manager +
heartbeats, internal KV, actor directory, placement groups with 2-phase
commit across node agents (``gcs_placement_group_scheduler.h:265,423``),
plus the cluster-wide scheduler view. The object directory lives here too
(the reference resolves locations from owners; a central directory is the
simpler equivalent at this scale — the protocol shape toward clients is the
same: "where is object X / tell me when it exists").

Scheduling policy: hybrid — prefer the caller's node until it cannot fit
the demand, then best-fit over the cluster view
(``hybrid_scheduling_policy.cc:26``).

Kept: node registration, heartbeats, resources and the death monitor;
the KV; reference counting and object locations as far as put/get/wait
and cross-node pulls need them; actors (records, registration, death,
restarts within ``max_restarts``); scheduling; placement groups
(reserve, remove, table, bundle resolution); the graceful drain
(``rpc_drain_node``: DRAINING, proactive actor migration that spends no
restart budget, the agent's quiescence, deadline force-kill, the
``"drained: <reason>"`` death cause, the ``head.drain.before_migrate``
failpoint); placement-group rescheduling (a group that loses a node goes
``RESCHEDULING``, its lost bundles are re-reserved on healthy nodes by a
2PC coordinator -- failpoints ``head.pg.before_reschedule``,
``head.pg.prepare``, ``head.pg.commit`` -- and it is ``CREATED`` again,
the surviving bundles kept); the pubsub plane (``pubsub.py``: NODES,
ACTORS and PLACEMENT_GROUPS events, long-poll RPCs); head fault tolerance
(``HeadServer(persist_path=...)``: a write-behind sqlite store of the
node table and the KV, and snapshots of the actor, placement-group and
object tables, reloaded by a head restarted on the same address --
``_PersistentStore``, the ``head.snapshot.before_persist`` failpoint);
and the records of objects spilled to a shared target, from which a
dead node's objects are restored onto a live one (``rpc_add_spilled``,
``rpc_restore_spilled``, the restore loop); the span store and trace
assembly (``rpc_report_spans`` into a bounded ring and the
``traces.TraceStore`` flight recorder -- tail sampling, drop counts by
cause, clock alignment from the agents' probes, ``rpc_clock_probe`` /
``rpc_report_clock``; ``rpc_list_spans``, ``rpc_get_trace``,
``rpc_list_traces``, ``rpc_trace_stats``, ``rpc_ttft_decomposition``;
a dead node's clock entry dropped in ``_mark_dead``; in memory only);
the state listings (``rpc_list_actors``, ``rpc_list_tasks`` over the
agents' task records, ``rpc_list_objects`` sorted by size with its
truncation report and each object's attribution, which the directory
keeps per key); worker and device stats and the store reports fanned
out to the agents (``rpc_worker_stats``, ``rpc_device_stats``,
``rpc_object_store_stats``), ``rpc_memory_summary``, the leak sweeper
(``rpc_memory_leaks``, every ``leak_sweep_interval_s``) and the handler
statistics (``rpc_event_stats``, and each handler's latency in
``ray_tpu_head_rpc_seconds``; time waiting on a contended lock shard in
``ray_tpu_head_lock_wait_seconds``). Operating the cluster: the workers'
captured lines in a bounded ring and on the ``LOGS`` pubsub channel
(``rpc_worker_logs``, ``rpc_drain_logs``); the log, stack and profile
RPCs routed to the agent that owns a worker (``rpc_list_logs``,
``rpc_get_log``, the streamed ``rpc_follow_log``,
``rpc_dump_worker_stack``, ``rpc_profile_worker``,
``rpc_capture_profile``, ``rpc_read_capture_file``); metrics federation
(``cluster_metrics_text``: the head's registry merged with every alive
agent's, served over HTTP as ``/metrics``, ``/metrics/cluster`` and
``/metrics/targets`` with ``HeadServer(metrics_port=0)``, None disabling
it); the signal plane (``cluster/signals.py``: a scrape loop feeding the
federated body into a bounded history ring with tracing suppressed, an
SLO loop publishing burn transitions on the ``SLO`` channel,
``rpc_query_metrics``, ``rpc_slo_status``, ``rpc_register_slo``,
``rpc_remove_slo``, ``rpc_signal_top``; a dead node's series aged out in
``_mark_dead``); and the failpoint and network chaos control plane
fanned out to every agent and its workers (``rpc_set_failpoints``,
``rpc_list_failpoints``, ``rpc_set_channel_chaos``,
``rpc_clear_channel_chaos``, ``rpc_list_channel_chaos``,
``rpc_partition``, ``rpc_heal``). An abandoned stream's tail
(``rpc_stream_release``) is freed, present and future: an item its
producer stores after the release is deleted as it is reported. Left out
(ROADMAP A21): the autoscaler's demand log and terminate acks.

The persistent store writes its records with the port's wire codec
(``wire.py``), not pickle: no pickle on the control plane, on disk
either. Its file is the port's own; nothing reads one package's file
with the other package.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Optional

from ray_tpu_torch.cluster.pubsub import Publisher
from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer, channel_chaos
from ray_tpu_torch.cluster.traces import TraceStore, drop_node
from ray_tpu_torch.cluster.wire import WireCodec
from ray_tpu_torch.core import ids
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import failpoints
from ray_tpu_torch.util import metrics as _metrics

# A node silent for DEAD_AFTER_S is declared dead (reference:
# num_heartbeats_timeout): node_death_timeout_s, and never fewer than ten
# of the agents' heartbeat_interval_s (reference head.py:32).
DEAD_AFTER_S = max(config.node_death_timeout_s,
                   10 * config.heartbeat_interval_s)
# A placement group's reschedule coordinator retries a round that found
# no capacity (or whose 2PC failed) after a delay doubling from the base
# to the max (the reference's submit_retry_base_s / submit_retry_max_s).
RESCHEDULE_RETRY_BASE_S = 0.25
RESCHEDULE_RETRY_MAX_S = 2.0

# The head's shard-lock partial order, machine-readable: cross-shard
# paths (_mark_dead, actor death, create_actor_record borrow holds)
# must acquire strictly left to right. The static analyzer imports this
# tuple (lock-order pass, rule LO001) and flags any nesting that
# inverts it.
LOCK_ORDER = ("_lock", "_obj_lock", "_event_lock")

_codec = WireCodec()


class _PersistentStore:
    """Write-behind sqlite store behind the head's tables (GCS fault
    tolerance: the role of ``store_client/redis_store_client.h:28``, here
    a local file so a head restarted on the same address reloads it,
    ``gcs_init_data.h``). Namespaced key -> a value in the wire codec.

    Writes land in a dirty queue coalesced per key (the last write or
    delete of a (ns, key) wins) that a flusher thread drains every
    ``head_persist_flush_interval_s``, one transaction a batch of at most
    ``head_persist_max_batch`` statements:

    * a batch commits whole or not at all -- a crash loses whole batches
      (the last interval's writes), never a torn row;
    * a failed batch goes back at the FRONT of the queue (a newer write
      of the same key wins), so a transient sqlite error retries in
      order;
    * ``flush()`` drains synchronously (the snapshot loop calls it each
      tick it wrote, so its failpoint gates real disk writes; ``close``
      calls it);
    * ``load_ns`` flushes first: a reader sees its own writes;
    * ``abandon()`` is a crash: the queue is dropped and the flusher
      stopped and joined before the connection closes, so no flusher of
      a dead head writes beside the restarted head's connection to the
      same file.
    """

    _DELETE = object()  # queue sentinel: the key was deleted

    def __init__(self, path: str):
        import sqlite3

        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.execute(
            "CREATE TABLE IF NOT EXISTS t "
            "(ns TEXT, k TEXT, v BLOB, PRIMARY KEY (ns, k))")
        self._conn.commit()
        # The connection's mutex: serializing sqlite I/O is its whole job.
        self._mu = threading.Lock()  # analyze: allow-blocking
        # (ns, key) -> blob | _DELETE, oldest first.
        self._dirty: "collections.OrderedDict[tuple, object]" = (
            collections.OrderedDict())
        self._dirty_mu = threading.Lock()
        # Serializes whole flush passes across the batched transaction.
        self._flush_mu = threading.Lock()  # analyze: allow-blocking
        self._stop_flusher = threading.Event()
        self._n_coalesced = 0
        self._n_flushes = 0
        self._n_flush_failures = 0
        self._flusher = threading.Thread(target=self._flush_loop,
                                         daemon=True)
        self._flusher.start()

    def put(self, ns: str, key: str, value) -> None:
        self._enqueue(ns, key, _codec.packb(value))

    def put_blob(self, ns: str, key: str, blob: bytes) -> None:
        self._enqueue(ns, key, blob)

    def delete(self, ns: str, key: str) -> None:
        self._enqueue(ns, key, self._DELETE)

    def _enqueue(self, ns: str, key: str, value) -> None:
        with self._dirty_mu:
            if (ns, key) in self._dirty:
                self._n_coalesced += 1
                _metrics.HEAD_PERSIST_COALESCED.inc()
            self._dirty[(ns, key)] = value
            depth = len(self._dirty)
        _metrics.HEAD_PERSIST_QUEUE_DEPTH.set(depth)

    def _flush_loop(self) -> None:
        interval = max(0.005, config.head_persist_flush_interval_s)
        while not self._stop_flusher.wait(interval):
            try:
                self.flush()
            except Exception:
                # The batch went back to the queue; the next tick retries.
                _metrics.count_loop_restart("head.persist")

    def flush(self) -> int:
        """Drain the dirty queue now; returns the statements written.
        Each batch is one transaction."""
        max_batch = max(1, config.head_persist_max_batch)
        written = 0
        with self._flush_mu:
            while True:
                with self._dirty_mu:
                    if not self._dirty:
                        break
                    batch = []
                    while self._dirty and len(batch) < max_batch:
                        batch.append(self._dirty.popitem(last=False))
                t0 = time.perf_counter()
                try:
                    with self._mu:
                        for (ns, key), v in batch:
                            if v is self._DELETE:
                                self._conn.execute(
                                    "DELETE FROM t WHERE ns = ? AND k = ?",
                                    (ns, key))
                            else:
                                self._conn.execute(
                                    "INSERT OR REPLACE INTO t (ns, k, v) "
                                    "VALUES (?, ?, ?)", (ns, key, v))
                        self._conn.commit()
                except Exception:
                    try:
                        with self._mu:
                            self._conn.rollback()
                    except Exception:
                        pass
                    # Back to the FRONT, in order; a newer write of the
                    # same key supersedes the failed one.
                    with self._dirty_mu:
                        self._n_flush_failures += 1
                        for k, v in reversed(batch):
                            if k not in self._dirty:
                                self._dirty[k] = v
                                self._dirty.move_to_end(k, last=False)
                    raise
                self._n_flushes += 1
                written += len(batch)
                _metrics.HEAD_PERSIST_FLUSH_SECONDS.observe(
                    time.perf_counter() - t0)
        with self._dirty_mu:
            depth = len(self._dirty)
        _metrics.HEAD_PERSIST_QUEUE_DEPTH.set(depth)
        return written

    def stats(self) -> dict:
        with self._dirty_mu:
            return {
                "queued": len(self._dirty),
                "coalesced": self._n_coalesced,
                "flushes": self._n_flushes,
                "flush_failures": self._n_flush_failures,
            }

    def load_ns(self, ns: str) -> dict:
        try:
            self.flush()  # read-your-writes
        except Exception:
            pass
        with self._mu:
            rows = self._conn.execute(
                "SELECT k, v FROM t WHERE ns = ?", (ns,)).fetchall()
        return {k: _codec.unpackb(v) for k, v in rows}

    def close(self) -> None:
        self._stop_flusher.set()
        self._flusher.join(timeout=10.0)
        try:
            self.flush()
        except Exception:
            pass
        with self._mu:
            try:
                self._conn.commit()
                self._conn.close()
            except Exception:
                pass

    def abandon(self) -> None:
        """A crash (``Cluster.kill_head``): drop the dirty queue, stop and
        join the flusher (a flush in progress completes or rolls back
        whole), then close the connection -- uncommitted work rolls
        back, committed batches stay."""
        self._stop_flusher.set()
        with self._dirty_mu:
            self._dirty.clear()
        self._flusher.join(timeout=10.0)
        with self._flush_mu, self._mu:
            try:
                self._conn.close()
            except Exception:
                pass


class _ShardLock:
    """RLock that observes time spent WAITING on a contended acquire into
    ``ray_tpu_head_lock_wait_seconds{shard=...}``; an uncontended acquire
    costs one extra try-acquire and records nothing. ``threading.
    Condition`` works over it as over an RLock (its protocol methods are
    delegated; a condition's re-acquire after ``wait`` is not counted)."""

    __slots__ = ("_rl", "_shard")

    def __init__(self, shard: str):
        self._rl = threading.RLock()
        self._shard = shard

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if self._rl.acquire(False):
            return True
        if not blocking:
            return False
        t0 = time.perf_counter()
        ok = self._rl.acquire(True, timeout)
        _metrics.HEAD_LOCK_WAIT_SECONDS.observe(
            time.perf_counter() - t0, tags={"shard": self._shard})
        return ok

    def release(self) -> None:
        self._rl.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self._rl.release()

    def _is_owned(self):
        return self._rl._is_owned()

    def _release_save(self):
        return self._rl._release_save()

    def _acquire_restore(self, state):
        return self._rl._acquire_restore(state)


class NodeInfo:
    def __init__(self, node_id, address, resources, store_path):
        self.node_id = node_id
        self.address = address
        self.resources = dict(resources)  # total
        self.available = dict(resources)  # latest reported view
        self.store_path = store_path
        self.last_heartbeat = time.monotonic()
        self.alive = True
        # Lifecycle: ALIVE -> (DRAINING ->) DEAD. A DRAINING node keeps
        # heartbeating and serving objects but takes no new placements
        # (node_manager.proto DrainRaylet analog).
        self.state = "ALIVE"
        self.drain_reason = None
        self.drain_started = None
        self.drain_done: threading.Event | None = None
        self.drain_forced = False
        self.drain_duration = None
        self.migrated_actors: list[str] = []
        self.death_cause = None
        # Heartbeats THIS head received from the node, and the wall time
        # of the first (a head restarted from its store counts anew).
        self.heartbeats = 0
        self.first_heartbeat_wall = None
        self.client = RpcClient(address)

    @property
    def schedulable(self) -> bool:
        return self.alive and self.state != "DRAINING"


class HeadServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 persist_path: str | None = None,
                 metrics_port: int | None = 0):
        self._store = (_PersistentStore(persist_path) if persist_path
                       else None)
        # Lock sharding along table boundaries so the object plane does
        # not contend with scheduling and heartbeats. Cross-shard
        # acquisition order is the module-level LOCK_ORDER tuple.
        #
        # Object-plane code reads NodeInfo entries (alive/address/
        # store_path) WITHOUT the node lock: _nodes is insert-only (dead
        # nodes stay, re-registration swaps a fresh NodeInfo), dict gets
        # are GIL-atomic, and every consumer tolerates a node dying
        # between the read and the use.
        self._lock = _ShardLock("nodes")
        self._obj_lock = _ShardLock("objects")
        self._nodes: dict[str, NodeInfo] = {}  # guarded-by: _lock
        # Incrementally-maintained cluster resource totals: rebuilt on
        # membership transitions, delta-updated on heartbeats and
        # scheduling debits.
        self._res_total: dict[str, float] = {}  # guarded-by: _lock
        self._res_avail: dict[str, float] = {}  # guarded-by: _lock
        self._kv: dict[str, Any] = {}  # guarded-by: _kv_lock
        self._kv_lock = threading.Lock()  # KV I/O only
        # object directory: oid -> {"nodes": set, "error": bool}
        self._objects: dict[str, dict] = {}  # guarded-by: _obj_lock
        self._objects_cv = threading.Condition(self._obj_lock)
        # actor directory: actor_id -> info dict
        self._actors: dict[str, dict] = {}  # guarded-by: _lock
        self._actor_specs: dict[str, dict] = {}  # guarded-by: _lock
        self._named_actors: dict[str, str] = {}  # guarded-by: _lock
        self._actors_cv = threading.Condition(self._lock)
        self._pgs: dict[str, dict] = {}  # guarded-by: _lock
        self._rr_counter = 0
        # The pub/sub plane (src/ray/pubsub analog): NODES, ACTORS and
        # PLACEMENT_GROUPS feeds with long-poll delivery (pubsub.py).
        self.pubsub = Publisher()
        # Distributed ref-counting (reference_count.h:61 analog, centralized):
        # oid -> set of holders. A holder is a client process id ("c:...")
        # or a containing object ("obj:<oid>" — the container keeps nested
        # refs alive). An oid ABSENT from the table is conservatively kept
        # (never freed); an entry with no holders and no in-flight borrows
        # is freed cluster-wide.
        self._refs: dict[str, set] = {}  # guarded-by: _obj_lock
        # oid -> count of in-flight task-arg borrows (submitted-but-running
        # tasks whose args reference the object).
        self._inflight: dict[str, int] = {}  # guarded-by: _obj_lock
        self._inflight_by_task: dict[str, tuple] = {}  # guarded-by: _obj_lock
        self._contained: dict[str, list] = {}  # guarded-by: _obj_lock
        self._freed: dict[str, bool] = {}  # guarded-by: _obj_lock (tombstones, bounded)
        # Abandoned streams: task id -> the first unconsumed index. Items
        # at that index and past it are freed on sight, those a
        # still-running producer reports after the release included.
        self._released_streams: dict[str, int] = {}  # guarded-by: _obj_lock
        self._free_queue: list[tuple] = []  # guarded-by: _obj_lock
        self._free_cv = threading.Condition(self._obj_lock)
        # Objects reloaded from a snapshot: the ref table is not persisted,
        # so their holders are unknown to this head -- they are never
        # freed (no GC for objects from before a restart, never an early
        # free).
        self._untracked: set[str] = set()  # guarded-by: _obj_lock
        # Spill records: oid -> the spill URI of its copy on a shared
        # target (rpc_add_spilled). A dead node's spilled objects are
        # restored from there onto a live node (rpc_restore_spilled, the
        # wait-location hook) instead of being recomputed or lost.
        self._spilled: dict[str, str] = {}  # guarded-by: _obj_lock
        # Restore work queue, in-flight dedup (one restore an oid at a
        # time; waiters see the restored location through add_location)
        # and the time of an oid's last failed attempt (an unreachable
        # target must not become a restore storm).
        self._restore_queue: list[str] = []  # guarded-by: _obj_lock
        self._restore_inflight: set[str] = set()  # guarded-by: _obj_lock
        self._restore_backoff: dict[str, float] = {}  # guarded-by: _obj_lock
        self._restore_cv = threading.Condition(self._obj_lock)
        # Tracing spans reported by workers (via their agents) and
        # drivers: a bounded ring (the oldest drop, counted), and the
        # trace flight recorder assembling them (cluster/traces.py).
        self._event_lock = _ShardLock("events")
        # The workers' captured stdout/stderr lines: a bounded ring read
        # with a cursor (rpc_drain_logs); followers get them pushed on the
        # LOGS channel.
        self._logs: collections.deque = collections.deque(
            maxlen=20_000)  # guarded-by: _event_lock
        self._log_seq = 0  # guarded-by: _event_lock
        self._spans: collections.deque = collections.deque(
            maxlen=max(1, config.head_span_retention))  # guarded-by: _event_lock
        self._spans_dropped = 0  # guarded-by: _event_lock
        self._worker_span_drops = 0  # guarded-by: _event_lock
        self._traces = TraceStore(
            max_traces=config.head_trace_retention,
            sample_rate=config.trace_sample_rate,
            slow_threshold_s=config.trace_slow_threshold_s,
            max_spans_per_trace=config.trace_max_spans,
            quiet_s=config.trace_quiet_s)
        # The leak sweeper's current flags: oid -> record.
        self._leaks: dict[str, dict] = {}  # guarded-by: _obj_lock
        try:
            if self._store is not None:
                self._load_persisted()
            self._server = RpcServer(
                self, host, port, rpc_histogram=_metrics.HEAD_RPC_SECONDS)
        except BaseException:
            # A failed bind (``Cluster.restart_head`` retries it) must not
            # leave this attempt's sqlite connection and flusher behind.
            if self._store is not None:
                self._store.abandon()
            raise
        self.address = self._server.address
        # Chaos source identity: the head's outbound clients carry its
        # address, so a partition's drop rules catch head->agent calls
        # (nodes reloaded from the store were made before the bind).
        with self._lock:
            for n in self._nodes.values():
                n.client.chaos_src = self.address
        # Metrics federation over HTTP (best-effort: the RPC plane is not).
        self.metrics_address: str | None = None
        self._metrics_shutdown = None
        if metrics_port is not None:
            try:
                bound, self._metrics_shutdown = _metrics.serve_metrics(
                    host, metrics_port, routes={
                        "/metrics": (_metrics.prometheus_text,
                                     _metrics.PROM_CONTENT_TYPE),
                        "/metrics/cluster": (self.cluster_metrics_text,
                                             _metrics.PROM_CONTENT_TYPE),
                        "/metrics/targets": (self._file_sd_text,
                                             "application/json"),
                    })
                self.metrics_address = f"{host}:{bound}"
            except OSError:
                pass
        self._stop = threading.Event()
        # The signal plane: a history ring fed by the scrape loop, SLOs
        # evaluated over it; a 0 interval disables both.
        self._signals = None
        if config.signal_scrape_interval_s > 0:
            from ray_tpu_torch.cluster.signals import SignalPlane

            self._signals = SignalPlane(
                history_s=config.signal_history_s,
                max_series=config.signal_max_series,
                scrape_interval_s=config.signal_scrape_interval_s,
                burn_evals=config.slo_burn_evals)
            self._signals.set_exemplar_source(self._traces.exemplars)
            threading.Thread(
                target=self._signal_scrape_loop, daemon=True).start()
            if config.slo_eval_interval_s > 0:
                threading.Thread(
                    target=self._slo_eval_loop, daemon=True).start()
        self._monitor = threading.Thread(target=self._monitor_loop, daemon=True)
        self._monitor.start()
        threading.Thread(target=self._free_loop, daemon=True).start()
        threading.Thread(target=self._restore_loop, daemon=True).start()
        if config.leak_age_threshold_s > 0:
            threading.Thread(
                target=self._leak_sweep_loop, daemon=True).start()
        if self._store is not None:
            threading.Thread(target=self._snapshot_loop, daemon=True).start()
            # A reservation whose 2PC the old head was running resolves
            # here: the agents absorb a replayed prepare and commit.
            with self._lock:
                pending = [k for k, pg in self._pgs.items()
                           if pg["state"] == "PENDING"]
            for pg_id in pending:
                threading.Thread(target=self._reserve_pg, args=(pg_id,),
                                 daemon=True).start()

    # -- persistence ------------------------------------------------------

    def _persist(self, ns: str, key: str, value) -> None:
        if self._store is not None:
            self._store.put(ns, key, value)

    def _persist_del(self, ns: str, key: str) -> None:
        if self._store is not None:
            self._store.delete(ns, key)

    def _load_persisted(self) -> None:
        """Rebuild the tables after a restart (``gcs_init_data.h``).

        Nodes come back provisionally alive, their last heartbeat now:
        their agents kept running, and their heartbeats -- blocked in the
        reconnect window while no head listened -- settle the truth (or
        the monitor's timeout does). Named actors are re-indexed. Every
        group's ``_resched_active`` is cleared: its coordinator thread
        died with the old head, and the monitor loop starts a fresh one
        for a group that was RESCHEDULING. The ref table is not persisted
        (high churn); the reloaded objects join ``_untracked``."""
        nodes = self._store.load_ns("node")
        kv = self._store.load_ns("kv")
        snap = self._store.load_ns("snap")
        with self._lock:
            for node_id, rec in nodes.items():
                self._nodes[node_id] = NodeInfo(
                    node_id, rec["address"], rec["resources"],
                    rec["store_path"])
            self._actors.update(snap.get("actors", {}))
            for actor_id, rec in self._actors.items():
                if rec.get("name") and rec.get("state") != "DEAD":
                    self._named_actors[rec["name"]] = actor_id
            self._actor_specs.update(snap.get("aspecs", {}))
            self._pgs.update(snap.get("pgs", {}))
            for pg in self._pgs.values():
                pg["_resched_active"] = False
            self._rebuild_res_caches()
        with self._kv_lock:
            self._kv.update(kv)
        with self._obj_lock:
            for oid, rec in snap.get("objects", {}).items():
                entry = {"nodes": set(rec["nodes"]), "error": rec["error"],
                         "size": rec["size"]}
                if rec.get("owner"):
                    entry["owner"] = rec["owner"]
                self._objects[oid] = entry
            self._spilled.update(snap.get("spilled", {}))
            self._untracked.update(self._objects)
            self._untracked.update(self._spilled)

    def _snapshot_tables(self) -> dict:
        """The snapshotted tables, each as one wire-encoded blob. The
        entries are copied under their lock, one level deep (their fields
        are reassigned in place, never mutated deeper), and encoded after
        it is released, so scheduling and heartbeats wait only for the
        copy."""
        with self._lock:
            tables = {
                "actors": {k: dict(v) for k, v in self._actors.items()},
                "aspecs": {k: dict(v) for k, v in self._actor_specs.items()},
                "pgs": {k: dict(v) for k, v in self._pgs.items()},
            }
        with self._obj_lock:
            tables["objects"] = {
                oid: {"nodes": sorted(e["nodes"]), "error": e["error"],
                      "size": e.get("size", 0), "owner": e.get("owner", "")}
                for oid, e in self._objects.items()}
            tables["spilled"] = dict(self._spilled)
        return {k: _codec.packb(t) for k, t in tables.items()}

    def _snapshot_loop(self) -> None:
        """Persist the high-churn tables (actors, their specs, placement
        groups, object locations and spill records) every snapshot
        interval when they changed -- compared blob to blob, so an idle
        cluster writes nothing. A crash loses at most one interval; lost
        locations heal through lineage."""
        last: dict[str, bytes] = {}
        while not self._stop.wait(config.head_snapshot_interval_s):
            try:
                failpoints.hit("head.snapshot.before_persist")
                blobs = {k: b for k, b in self._snapshot_tables().items()
                         if last.get(k) != b}
                for key, blob in blobs.items():
                    self._store.put_blob("snap", key, blob)
                if blobs:
                    # Durable this tick (the failpoint above gates it);
                    # ``last`` records a blob only once its transaction
                    # landed, so a failed flush retries next tick.
                    self._store.flush()
                    last.update(blobs)
            except Exception:
                _metrics.count_loop_restart("head.snapshot")

    # -- nodes ------------------------------------------------------------

    def _rebuild_res_caches(self) -> None:
        """Caller holds self._lock. O(nodes) — only on membership
        transitions (register/death); heartbeats and
        scheduling debits maintain the available cache incrementally."""
        total: dict[str, float] = {}
        avail: dict[str, float] = {}
        for n in self._nodes.values():
            if not n.alive:
                continue
            for k, v in n.resources.items():
                total[k] = total.get(k, 0.0) + v
            if n.schedulable:
                for k, v in n.available.items():
                    avail[k] = avail.get(k, 0.0) + v
        self._res_total, self._res_avail = total, avail

    def rpc_register_node(self, node_id, address, resources, store_path):
        with self._lock:
            info = NodeInfo(node_id, address, resources, store_path)
            info.client.chaos_src = self.address
            self._nodes[node_id] = info
            self._rebuild_res_caches()
        self._persist("node", node_id, {
            "address": address, "resources": dict(resources),
            "store_path": store_path,
        })
        self.pubsub.publish("NODES", node_id, {
            "node_id": node_id, "state": "ALIVE", "address": address,
            "resources": dict(resources),
        })
        return {"head_time": time.time()}

    def rpc_heartbeat(self, node_id, available):  # idempotent (full-state)
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return {"ok": False}  # node was declared dead; it must exit
            node.last_heartbeat = time.monotonic()
            # A statistic: a replayed beat counts twice, nothing acts on it.
            node.heartbeats += 1  # analyze: ignore[RT002]
            if node.first_heartbeat_wall is None:
                node.first_heartbeat_wall = time.time()
            if node.schedulable:
                # Incremental availability maintenance: apply the delta
                # between the node's previous view (including any
                # optimistic _pick debits) and the fresh report.
                avail = self._res_avail
                old = node.available
                for k in old.keys() | available.keys():
                    d = available.get(k, 0.0) - old.get(k, 0.0)
                    if d:
                        avail[k] = avail.get(k, 0.0) + d
            node.available = dict(available)
            return {"ok": True}

    def rpc_drain_node(self, node_id, reason: str = "requested",
                       deadline_s: float | None = None, wait: bool = True):
        """Graceful node removal (DrainRaylet analog): the node enters
        DRAINING — excluded from every new task/actor/PG placement while
        heartbeats keep flowing — in-flight tasks get up to ``deadline_s``
        to finish, restartable actors are PROACTIVELY reconstructed on
        other nodes (budget-free: a planned drain must not consume
        ``max_restarts``), then the node is deregistered and its agent
        shut down. ``wait=False`` returns after initiating (the path a
        preempted agent takes: it must not block on its own removal)."""
        if deadline_s is None:
            deadline_s = config.drain_deadline_s
        deadline_s = max(0.0, float(deadline_s))
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None:
                return {"ok": False, "node_id": node_id, "state": "UNKNOWN"}
            if not node.alive:
                return {"ok": False, "node_id": node_id, "state": "DEAD",
                        "cause": node.death_cause}
            started = node.state != "DRAINING"
            if started:
                node.state = "DRAINING"
                node.drain_reason = reason
                node.drain_started = time.monotonic()
                node.drain_done = threading.Event()
                self._rebuild_res_caches()  # no longer schedulable
            evt = node.drain_done
        if started:
            _metrics.NODE_DRAINS_TOTAL.inc(tags={"reason": reason})
            self.pubsub.publish("NODES", node_id, {
                "node_id": node_id, "state": "DRAINING", "reason": reason,
            })
            threading.Thread(
                target=self._drain_coordinator,
                args=(node_id, reason, deadline_s), daemon=True,
            ).start()
        if wait and evt is not None:
            evt.wait(deadline_s + 30.0)
        with self._lock:
            node = self._nodes.get(node_id)
            return {
                "ok": True,
                "node_id": node_id,
                "state": node.state if node else "UNKNOWN",
                "reason": reason,
                "migrated_actors": list(node.migrated_actors) if node else [],
                "forced": bool(node.drain_forced) if node else False,
                "duration_s": node.drain_duration if node else None,
            }

    def _drain_coordinator(self, node_id: str, reason: str,
                           deadline_s: float):
        """One drain's lifecycle: migrate restartable actors off, let the
        agent quiesce (finish queued+running tasks) up to the deadline,
        then deregister. Tasks force-killed at deadline expiry recover
        through owner lineage — exempt from their retry budget because
        the death cause below marks the loss as a drain."""
        t0 = time.monotonic()
        deadline = t0 + deadline_s
        failpoints.hit("head.drain.before_migrate")
        with self._lock:
            node = self._nodes.get(node_id)
        if node is None:
            return
        node.migrated_actors = self._migrate_actors_off(node_id, reason)
        # Proactive gang migration: bundles on the draining node move to
        # healthy nodes NOW (prepare/commit elsewhere, then return the
        # old reservation), while the departing node still serves its
        # objects — the placement-group half of the actor migration
        # above. Work killed with the old bundle recovers through owner
        # lineage with the drain retry-budget exemption.
        with self._lock:
            draining_pgs = [
                pg for pg in self._pgs.values()
                if pg["state"] in ("CREATED", "RESCHEDULING") and any(
                    nid == node_id for nid, _ in pg["placement"]
                )
            ]
            for pg in draining_pgs:
                self._pg_mark_rescheduling_locked(
                    pg, f"node {node_id} draining: {reason}")
        try:
            node.client.call("drain_self", reason, deadline_s, timeout=5.0)
        except Exception:
            pass  # agent may already be gone; the mark-dead below settles it
        forced = True
        probe_misses = 0
        while time.monotonic() < deadline and not self._stop.is_set():
            with self._lock:
                if not node.alive:
                    forced = False  # heartbeat monitor raced us to DEAD
                    break
            try:
                st = node.client.call("drain_status", timeout=5.0)
            except Exception:
                # One failed probe may just be a busy agent (RPC
                # timeout); only repeated failures mean it exited on
                # its own and there is nothing left to wait for.
                probe_misses += 1
                if probe_misses >= 3:
                    forced = False
                    break
                time.sleep(0.1)
                continue
            probe_misses = 0
            if st.get("queued", 0) == 0 and st.get("running", 0) == 0 and \
                    all(self._actor_settled_elsewhere(aid, node_id)
                        for aid in node.migrated_actors):
                # Quiet, and every migrated actor is live on another node
                # (or terminally settled) BEFORE the drained agent exits.
                forced = False
                break
            time.sleep(0.1)
        node.drain_forced = forced
        node.drain_duration = round(time.monotonic() - t0, 3)
        _metrics.NODE_DRAIN_DURATION_SECONDS.observe(
            node.drain_duration, tags={"reason": reason})
        self._mark_dead(node_id, f"drained: {reason}")
        try:
            node.client.call("shutdown_node", timeout=5.0)
        except Exception:
            pass
        if node.drain_done is not None:
            node.drain_done.set()

    def _actor_settled_elsewhere(self, actor_id: str, node_id: str) -> bool:
        """Has a migrated actor finished leaving the draining node (ALIVE
        on another node, or terminally DEAD)?"""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is None or info["state"] == "DEAD":
                return True  # restart failed/killed meanwhile: settled
            return info["state"] == "ALIVE" and info["node_id"] != node_id

    def _migrate_actors_off(self, node_id: str, reason: str) -> list[str]:
        """Proactive migration (the drain half of ReconstructActor): every
        restartable ALIVE actor on the node transitions to RESTARTING
        WITHOUT burning ``restarts_left`` — planned removal is not a crash
        — and reconstructs through the ordinary restart path, which the
        scheduler now points away from this node. The old incarnation's
        worker is detached-and-killed agent-side so its death is plain
        worker cleanup, not a second (budget-consuming) actor death."""
        moved: list[str] = []
        with self._lock:
            node = self._nodes.get(node_id)
            for info in self._actors.values():
                if info["node_id"] != node_id or info["state"] != "ALIVE":
                    continue
                rec = self._actor_specs.get(info["actor_id"])
                if rec is None or rec["restarts_left"] == 0:
                    continue  # not restartable: rides the node down
                info["state"] = "RESTARTING"
                info["death_cause"] = (
                    f"node {node_id} draining: {reason}")
                info["num_restarts"] = info.get("num_restarts", 0) + 1
                moved.append(info["actor_id"])
                self.pubsub.publish("ACTORS", info["actor_id"], dict(info))
            if moved:
                self._actors_cv.notify_all()
        if moved:
            _metrics.NODE_DRAIN_ACTORS_MIGRATED.inc(
                len(moved), tags={"reason": reason})
        for actor_id in moved:
            if node is not None:
                try:
                    node.client.call(
                        "detach_actor_worker", actor_id, timeout=5.0)
                except Exception:
                    pass
            threading.Thread(
                target=self._restart_actor, args=(actor_id,), daemon=True,
            ).start()
        return moved

    def rpc_nodes(self):  # idempotent (read-only)
        with self._lock:
            return [
                {
                    "NodeID": n.node_id,
                    "Alive": n.alive,
                    "State": n.state,
                    "DrainReason": n.drain_reason,
                    "DeathCause": n.death_cause,
                    "Address": n.address,
                    "Resources": dict(n.resources),
                    "Available": dict(n.available),
                    "StorePath": n.store_path,
                }
                for n in self._nodes.values()
            ]

    def rpc_node_heartbeats(self):  # idempotent (read-only)
        """{node_id: {"heartbeats", "first_wall"}}: the heartbeats this
        head received from each node, and when the first landed."""
        with self._lock:
            return {n.node_id: {"heartbeats": n.heartbeats,
                                "first_wall": n.first_heartbeat_wall}
                    for n in self._nodes.values()}

    def rpc_cluster_resources(self):
        # O(keys) snapshot of the incrementally-maintained cache: status
        # pollers no longer rebuild dicts over every node under the lock.
        with self._lock:
            return dict(self._res_total)

    def rpc_available_resources(self):
        with self._lock:
            # Clamp float-delta dust from the incremental maintenance:
            # repeated add/subtract of nearly-equal heartbeat values
            # leaves ~1e-16 residue where the true sum is 0.0.
            return {k: (0.0 if -1e-9 < v < 1e-9 else v)
                    for k, v in self._res_avail.items()}

    def _monitor_loop(self):
        # Death needs BOTH (a) absolute staleness > DEAD_AFTER_S and (b)
        # N consecutive monitor ticks each observing staleness. (b) is
        # the false-positive guard for CPU-starved boxes (worker-fork
        # storms at cluster boot, parallel test suites on one core):
        # whatever starves the agents' heartbeat threads starves THIS
        # loop identically, so the required tick count stretches the
        # wall-clock window by exactly the starvation factor — a
        # machine-independent analog of num_heartbeats_timeout counting
        # MISSED heartbeats rather than wall time.
        required = max(4, int(DEAD_AFTER_S / 0.25))
        stale_after = 2 * config.heartbeat_interval_s
        missed: dict[str, int] = {}
        while not self._stop.wait(0.25):
            now = time.monotonic()
            dead = []
            with self._lock:
                for n in self._nodes.values():
                    if not n.alive:
                        missed.pop(n.node_id, None)
                        continue
                    if now - n.last_heartbeat > stale_after:
                        missed[n.node_id] = missed.get(n.node_id, 0) + 1
                        # Both gates: enough consecutive stale ticks AND
                        # absolute staleness — so detection lands at
                        # ~DEAD_AFTER_S on a healthy box, later only by
                        # however much the monitor itself was starved.
                        if missed[n.node_id] >= required and \
                                now - n.last_heartbeat > DEAD_AFTER_S:
                            dead.append(n.node_id)
                    else:
                        missed.pop(n.node_id, None)
            for node_id in dead:
                missed.pop(node_id, None)
                self._mark_dead(node_id, "heartbeat timeout")
            # Self-healing reschedule drivers: a RESCHEDULING group with
            # no live coordinator (an injected coordinator crash) gets a
            # fresh one here — the group can never wedge in RESCHEDULING
            # with nothing driving it.
            stuck: list[tuple] = []
            with self._lock:
                for pg in self._pgs.values():
                    if pg["state"] == "RESCHEDULING" \
                            and not pg.get("_resched_active"):
                        pg["_resched_active"] = True
                        stuck.append(
                            (pg["placement_group_id"],
                             pg.get("reschedule_cause") or "unknown"))
            for pg_id, pg_cause in stuck:
                threading.Thread(
                    target=self._reschedule_pg,
                    args=(pg_id, pg_cause), daemon=True).start()

    def _mark_dead(self, node_id: str, cause: str):
        # Cross-shard path: node/actor/PG work under the node lock, THEN
        # the object/ref sweep under the object lock (fixed order). The
        # alive=False flag is written first, so an add_location racing
        # the sweep either sees the flag (skips the node) or lands the
        # location before the sweep removes it — never after.
        self._persist_del("node", node_id)
        with self._lock:
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                return  # already dead/unknown: no duplicate DEAD event
            if node.state == "DRAINING" and not cause.startswith("drained"):
                # A draining (e.g. preempted) node can vanish before the
                # coordinator finishes — the heartbeat monitor then wins
                # the race to declare death. Fold the drain reason into
                # the cause so owners still get the retry-budget
                # exemption for exactly the loss it was built for.
                cause = f"drained: {node.drain_reason} ({cause})"
            node.alive = False
            node.state = "DEAD"
            node.death_cause = cause
            self._rebuild_res_caches()
            self.pubsub.publish("NODES", node_id, {
                "node_id": node_id, "state": "DEAD", "cause": cause,
            })
            # Actors on the node die with it; restartable ones reconstruct
            # elsewhere (GcsActorManager::OnNodeDead -> ReconstructActor).
            for info in list(self._actors.values()):
                if info["node_id"] == node_id and info["state"] == "ALIVE":
                    self._on_actor_death(
                        info["actor_id"], f"node {node_id} died: {cause}",
                        True,
                    )
            # Placement groups with bundles there enter RESCHEDULING: the
            # reservation outlives the node that held it — a coordinator
            # re-runs the 2PC for the lost bundles on healthy nodes
            # (gcs_placement_group_manager reschedule-on-dead path).
            to_reschedule = [
                pg for pg in self._pgs.values()
                if pg["state"] in ("CREATED", "RESCHEDULING") and any(
                    nid == node_id for nid, _ in pg["placement"]
                )
            ]
            for pg in to_reschedule:
                self._pg_mark_rescheduling_locked(
                    pg, f"node {node_id} died: {cause}")
            self._actors_cv.notify_all()
        # A dead node's clock samples go with it (retraction discipline),
        # and its series leave the history ring: windowed values must not
        # blend a dead node's last samples into live signals.
        drop_node(self._traces.clock, node_id)
        if self._signals is not None:
            try:
                self._signals.age_out_node(node_id)
            except Exception:
                pass
        with self._obj_lock:
            # Drop its object locations; lineage re-execution is the
            # client's job (object_recovery_manager.h:41 analog).
            for entry in self._objects.values():
                entry["nodes"].discard(node_id)
            # Ref-counting cleanup: worker processes on the node died with
            # it — drop their holds and their tasks' in-flight borrows.
            # (Driver clients use the "d:" prefix and survive node death;
            # their objects are recovered via lineage.)
            prefix = f"w:{node_id}:"
            for oid, holders in list(self._refs.items()):
                dead = {h for h in holders if h.startswith(prefix)}
                if dead:
                    holders.difference_update(dead)
                    self._maybe_free(oid)
            for task_id, (nid, _oids, _a) in list(
                self._inflight_by_task.items()
            ):
                if nid == node_id:
                    self._end_task_borrows(task_id)
            self._objects_cv.notify_all()

    # -- KV ---------------------------------------------------------------

    # The KV is a self-contained subsystem under its own lock: values
    # can be large (function blobs), and copying them under the node
    # lock would stall scheduling and heartbeats.

    def rpc_kv_put(self, key, value, overwrite=True):
        with self._kv_lock:
            if not overwrite and key in self._kv:
                return False
            self._kv[key] = value
            # Under the KV lock: concurrent writers of one key reach the
            # store in the order they reached memory.
            self._persist("kv", key, value)
        return True

    def rpc_kv_get(self, key):
        with self._kv_lock:
            return self._kv.get(key)

    def rpc_kv_del(self, key):
        with self._kv_lock:
            existed = self._kv.pop(key, None) is not None
            if existed:
                self._persist_del("kv", key)
        return existed

    def rpc_kv_keys(self, prefix=""):
        with self._kv_lock:
            return [k for k in self._kv if k.startswith(prefix)]

    # -- pubsub -----------------------------------------------------------

    def rpc_pubsub_subscribe(self, sub_id, channel, keys=None):  # idempotent
        return self.pubsub.subscribe(sub_id, channel, keys)

    def rpc_pubsub_unsubscribe(self, sub_id, channel=None):
        return self.pubsub.unsubscribe(sub_id, channel)

    def rpc_pubsub_poll(self, sub_id, timeout=10.0, max_msgs=1000):  # idempotent
        # Long-poll: safe to block — the RPC server is thread-per-
        # connection, and a subscriber polls over a connection of its own
        # (rpc.RpcClient pools one per calling thread), so a parked poll
        # never stalls heartbeats or scheduling calls.
        return self.pubsub.poll(sub_id, min(float(timeout), 30.0), max_msgs)

    def rpc_publish(self, channel, key, message):
        """External publishers (agents/workers) push through the head."""
        return self.pubsub.publish(channel, key, message)

    def rpc_pubsub_stats(self):
        """Pubsub health (subscribers, buffered, published, dropped and
        coalesced counts, indexed keys per channel) and, with a store,
        the write-behind queue's under ``persist``."""
        out = self.pubsub.stats()
        if self._store is not None:
            out["persist"] = self._store.stats()
        return out

    # -- distributed ref-counting -----------------------------------------

    def rpc_ref_update(self, client_id, add, remove):
        """Batched holder registration/release from one client process."""
        with self._obj_lock:
            for oid in add:
                if oid in self._freed:
                    continue  # already freed: don't create ghost holders
                self._refs.setdefault(oid, set()).add(client_id)
            for oid in remove:
                if oid in self._freed:
                    continue
                # A remove with no prior entry means the client held and
                # released entirely between flushes — materialize an empty
                # entry so the free condition can fire (otherwise the
                # pinned primary copy would be untracked and immortal).
                holders = self._refs.setdefault(oid, set())
                holders.discard(client_id)
                self._maybe_free(oid)
        return True

    def rpc_ref_task_begin(self, task_id, node_id, oids, actor_id=None):
        """Args of a submitted task borrow their objects until the task
        ends (borrower registration at submission, so the caller may drop
        its handles while the task is in flight)."""
        with self._obj_lock:
            self._end_task_borrows(task_id)  # resubmission replaces
            self._inflight_by_task[task_id] = (node_id, list(oids), actor_id)
            for oid in oids:
                self._inflight[oid] = self._inflight.get(oid, 0) + 1
        return True

    def rpc_ref_task_begin_batch(self, entries):
        """One lock pass for a submitter batch's borrow registrations."""
        with self._obj_lock:
            for task_id, node_id, oids, actor_id in entries:
                self._end_task_borrows(task_id)  # resubmission replaces
                self._inflight_by_task[task_id] = (
                    node_id, list(oids), actor_id)
                for oid in oids:
                    self._inflight[oid] = self._inflight.get(oid, 0) + 1
        return True

    def rpc_ref_task_end(self, task_id):
        with self._obj_lock:
            self._end_task_borrows(task_id)
        return True

    def _end_task_borrows(self, task_id):
        entry = self._inflight_by_task.pop(task_id, None)
        if entry is None:
            return
        _node, oids, _actor = entry
        for oid in oids:
            n = self._inflight.get(oid, 0) - 1
            if n <= 0:
                self._inflight.pop(oid, None)
            else:
                self._inflight[oid] = n
            self._maybe_free(oid)

    def _maybe_free(self, oid):
        """Free the object cluster-wide when nothing can reach it anymore.
        Caller holds self._obj_lock. Untracked oids are conservatively
        kept. NodeInfo reads below are lock-free (see the shard-order
        comment in __init__): a node dying between the alive check and
        the free fanout just costs one failed best-effort RPC."""
        if oid in self._untracked:
            return  # holders unknown since a restart: never freed
        if oid not in self._freed:
            holders = self._refs.get(oid)
            if holders is None or holders:
                return
            if self._inflight.get(oid, 0) > 0:
                return
        self._refs.pop(oid, None)
        self._freed[oid] = True
        if len(self._freed) > 200_000:
            for k in list(self._freed)[:100_000]:
                del self._freed[k]
        entry = self._objects.pop(oid, None)
        queued_live = False
        if entry is not None:
            for nid in entry["nodes"]:
                node = self._nodes.get(nid)
                if node is not None and node.alive:
                    self._free_queue.append((node, oid))
                    queued_live = True
        # A spilled copy on a shared target whose spiller is gone: any
        # live node deletes it, or the target keeps a file an object.
        uri = self._spilled.pop(oid, None)
        if uri is not None and not queued_live:
            anynode = next(
                (n for n in self._nodes.values() if n.alive), None)
            if anynode is not None:
                self._free_queue.append((anynode, oid, uri))
        if entry is not None or uri is not None:
            self._free_cv.notify_all()
        # Cascade: the container no longer holds its nested refs.
        for inner in self._contained.pop(oid, []):
            holders = self._refs.get(inner)
            if holders is not None:
                holders.discard("obj:" + oid)
            self._maybe_free(inner)

    def _free_loop(self):
        """Fan out store deletes outside the lock (free-on-zero broadcast)."""
        while not self._stop.is_set():
            with self._free_cv:
                while not self._free_queue and not self._stop.is_set():
                    self._free_cv.wait(0.5)
                batch, self._free_queue = self._free_queue[:], []
            for item in batch:
                try:
                    if len(item) == 3:  # (node, oid, uri): a spilled copy
                        node, oid, uri = item
                        node.client.call("delete_spilled", oid, uri,
                                         timeout=5.0)
                    else:
                        node, oid = item
                        node.client.call("free_object", oid, timeout=5.0)
                except Exception:
                    # Per-item fan-out guard: a dead node's delete is
                    # moot, but the loop itself must survive and say so.
                    _metrics.count_loop_restart("head.free")

    def rpc_ref_client_dead(self, client_id):
        """A client process died: drop every hold it registered."""
        with self._obj_lock:
            for oid, holders in list(self._refs.items()):
                if client_id in holders:
                    holders.discard(client_id)
                    self._maybe_free(oid)
        return True

    # -- object directory -------------------------------------------------

    def rpc_stream_release(self, task_id, from_index):  # idempotent
        """An abandoned ``ObjectRefGenerator``: free the stream's items
        from ``from_index`` on, present and future (reference
        head.py:1348-1386). A streamed item was never registered at
        submit, so its tail has no holder: each is tombstoned in
        ``_freed`` and freed at once -- a reloaded (``_untracked``) one
        too, since nobody read it -- unless a client registered a hold on
        it, which keeps it until that hold goes. Returns how many items
        were freed."""
        freed = 0
        with self._obj_lock:
            self._released_streams[task_id] = int(from_index)
            while len(self._released_streams) > 100_000:
                del self._released_streams[next(iter(self._released_streams))]
            tail = [oid for oid in set(self._objects) | set(self._spilled)
                    if oid[:32] == task_id and self._stream_released(oid)]
            for oid in tail:
                if self._refs.get(oid):
                    continue  # held: freed when its last holder goes
                self._untracked.discard(oid)
                self._freed[oid] = True  # _maybe_free frees a tombstone
                self._maybe_free(oid)
                freed += 1
        return freed

    def _stream_released(self, oid: str) -> bool:
        """Caller holds ``_obj_lock``: is this oid in a released stream's
        unconsumed tail (reference head.py:1388)?"""
        cut = self._released_streams.get(oid[:32])
        if cut is None or len(oid) < 40:
            return False
        try:
            return int(oid[32:], 16) >= cut
        except ValueError:
            return False

    def rpc_add_locations(self, items):
        """Batched location adds from a client's ref flusher. Each item:
        (oid, node_id, is_error, size, contained, owner_addr[, attr]);
        attr is the put-time attribution (owner, creating task,
        callsite, created_at) feeding the listings, memory_summary and
        the leak sweeper.
        The head's directory is the fallback view and the free
        authority; the latency-critical wait path resolves at owners
        (client.py owner service), so these arrive asynchronously
        batched. owner_addr is recorded as object->owner routing
        (ownership_based_object_directory.h: the GCS keeps owner
        routing, not the authoritative location set)."""
        for item in items:
            self.rpc_add_location(*item)
        return True


    def rpc_add_location(self, oid, node_id, is_error=False, size=0,
                         contained=None, owner_addr="", attr=None):
        with self._obj_lock:
            if oid in self._freed or (self._stream_released(oid)
                                      and not self._refs.get(oid)):
                # Freed while the task computing it was still running:
                # delete the fresh copy straight away.
                node = self._nodes.get(node_id)
                if node is not None and node.alive:
                    self._free_queue.append((node, oid))
                    self._free_cv.notify_all()
                return True
            entry = self._objects.setdefault(
                oid, {"nodes": set(), "error": False, "size": 0}
            )
            node = self._nodes.get(node_id)
            if node is not None and node.alive:
                # A location report can arrive AFTER its node died (a
                # batched/reconnect-retried flush landing late):
                # _mark_dead already swept this node's locations, and
                # re-adding one would leave the directory pointing at a
                # store that no longer exists. The holder bookkeeping
                # below still applies — the object may have live
                # replicas elsewhere.
                entry["nodes"].add(node_id)
            entry["error"] = entry["error"] or is_error
            entry["size"] = max(entry["size"], size)
            if owner_addr:
                entry["owner"] = owner_addr
            # Creation attribution: first writer wins PER KEY (replica
            # and restore reports pass attr=None but may stamp created_at
            # first; the owner's own report still lands its fields, and
            # the earliest created_at is the creation); every entry gets
            # a created_at so ages and the leak sweeper work everywhere.
            dst = entry.setdefault("attr", {})
            if attr:
                for k, v in attr.items():
                    if k == "created_at":
                        dst["created_at"] = min(
                            dst.get("created_at", v), v)
                    else:
                        dst.setdefault(k, v)
            dst.setdefault("created_at", round(time.time(), 3))
            if contained:
                # The container holds its nested refs until it is freed.
                self._contained[oid] = list(contained)
                for inner in contained:
                    self._refs.setdefault(inner, set()).add("obj:" + oid)
            self._objects_cv.notify_all()
        return True

    def rpc_remove_location(self, oid, node_id):
        with self._obj_lock:
            entry = self._objects.get(oid)
            if entry:
                entry["nodes"].discard(node_id)
                if not entry["nodes"]:
                    del self._objects[oid]
        return True

    def rpc_objects_on_node(self, node_id):  # idempotent (read-only)
        """The oids the directory places on a node (its agent's spill
        candidates: the store's keys are digests, the oids live here)."""
        with self._obj_lock:
            return [oid for oid, e in self._objects.items()
                    if node_id in e["nodes"]]

    # -- spill records and restores from a spill URI ------------------------

    def rpc_add_spilled(self, oids, uri):  # idempotent (last write wins)
        """An agent moved these objects to a shared spill target: record
        them, so the copies outlive the spiller (a dead node's spilled
        objects are restored from ``uri``, not recomputed)."""
        with self._obj_lock:
            for oid in oids:
                if oid in self._freed or self._stream_released(oid):
                    continue  # freed while it was being spilled
                self._spilled[oid] = uri
        return True

    def rpc_spilled_objects(self):  # idempotent (read-only)
        """{oid: uri} of the spill records."""
        with self._obj_lock:
            return dict(self._spilled)

    def _queue_restore_locked(self, oid: str) -> None:
        """Caller holds ``_obj_lock``: queue a restore of an oid whose only
        copy is on the spill target -- one in flight an oid, and none
        within 5 s of a failed attempt."""
        if oid in self._restore_inflight:
            return
        if time.monotonic() - self._restore_backoff.get(oid, -1e9) < 5.0:
            return
        self._restore_inflight.add(oid)
        self._restore_queue.append(oid)
        self._restore_cv.notify_all()

    def _restore_loop(self):
        """Run queued restores outside the object lock (the free loop's
        shape); waiters see the location through add_location."""
        while not self._stop.is_set():
            with self._restore_cv:
                while not self._restore_queue and not self._stop.is_set():
                    self._restore_cv.wait(0.5)
                batch, self._restore_queue = self._restore_queue[:], []
            for oid in batch:
                try:
                    self._restore_one(oid)
                except Exception:
                    _metrics.count_loop_restart("head.restore")

    def _restore_one(self, oid: str) -> bool:
        """One attempt: a live agent reads the object from its spill URI
        into its store, and its location is recorded. Clears the
        in-flight mark either way."""
        with self._obj_lock:
            uri = self._spilled.get(oid)
            entry = self._objects.get(oid)
            owner = (entry or {}).get("owner", "")
            has_live = bool(entry and any(
                self._nodes.get(nid) and self._nodes[nid].alive
                for nid in entry["nodes"]))
        restored_on = None
        if uri is not None and not has_live:
            for cand in list(self._nodes.values()):
                if not cand.alive:
                    continue
                try:
                    ok = bool(cand.client.call(
                        "restore_from_uri", oid, uri, owner, timeout=30.0))
                except Exception:
                    ok = False
                if ok:
                    restored_on = cand
                    break
        if restored_on is not None:
            self.rpc_add_location(oid, restored_on.node_id)
        with self._obj_lock:
            self._restore_inflight.discard(oid)
            if restored_on is not None or has_live:
                self._restore_backoff.pop(oid, None)
            else:
                if len(self._restore_backoff) > 4096:
                    self._restore_backoff.clear()
                self._restore_backoff[oid] = time.monotonic()
            self._objects_cv.notify_all()
        return restored_on is not None or has_live

    def rpc_restore_spilled(self, oid, timeout=30.0):
        """For lineage recovery (the client's ``_maybe_recover``): when the
        object has a spill record, make sure a live copy exists --
        restoring it from the URI if needed -- and return its
        ``(node_id, address, store_path)``; None when it is not spilled
        or the restore failed (the caller recomputes). Concurrent callers
        share one restore and wait for its location."""
        deadline = time.monotonic() + (timeout or 30.0)
        with self._obj_lock:
            if oid not in self._spilled:
                return None
            claimed = oid not in self._restore_inflight
            if claimed:
                self._restore_inflight.add(oid)
        if claimed:
            self._restore_one(oid)
        with self._obj_lock:
            while True:
                entry = self._objects.get(oid)
                for nid in (entry or {}).get("nodes", ()):
                    node = self._nodes.get(nid)
                    if node is not None and node.alive:
                        return (nid, node.address, node.store_path)
                if claimed or time.monotonic() >= deadline:
                    return None
                self._objects_cv.wait(
                    min(1.0, max(0.05, deadline - time.monotonic())))


    def rpc_wait_locations(self, oids, timeout=None):
        """Batched long-poll: block until AT LEAST ONE of ``oids`` has a
        live location (or timeout); returns {oid: {"nodes", "error"}} for
        every oid currently resolvable. One lock pass + one RPC instead
        of a long-poll per ref (GetObjectStatus batching)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._obj_lock:
            while True:
                found = {}
                for oid in oids:
                    entry = self._objects.get(oid)
                    if not (entry and entry["nodes"]):
                        continue
                    nodes = [
                        (nid, self._nodes[nid].address,
                         self._nodes[nid].store_path)
                        for nid in entry["nodes"]
                        if self._nodes.get(nid) and self._nodes[nid].alive
                    ]
                    if nodes:
                        found[oid] = {"nodes": nodes,
                                      "error": entry["error"]}
                if found:
                    return found
                # No live copy, but the bytes survive on the spill
                # target: restore while the caller waits.
                for oid in oids:
                    if oid in self._spilled:
                        self._queue_restore_locked(oid)
                remaining = (
                    None if deadline is None
                    else deadline - time.monotonic()
                )
                if remaining is not None and remaining <= 0:
                    return {}
                self._objects_cv.wait(
                    remaining if remaining is None
                    else min(remaining, 1.0))

    def rpc_locations(self, oid):
        with self._obj_lock:
            entry = self._objects.get(oid)
            if not entry:
                return None
            return {
                "nodes": [
                    (nid, self._nodes[nid].address, self._nodes[nid].store_path)
                    for nid in entry["nodes"]
                    if self._nodes.get(nid) and self._nodes[nid].alive
                ],
                "error": entry["error"],
            }

    # -- actor directory --------------------------------------------------

    def rpc_create_actor_record(self, actor_id, max_restarts,
                                max_task_retries, spec):
        """Keep the creation spec so the head can reconstruct the actor on
        worker/node death (GcsActorManager::ReconstructActor state,
        gcs_actor_manager.cc:1051-1079). -1 = infinite restarts."""
        with self._lock:
            self._actor_specs[actor_id] = {
                "spec": spec,
                "restarts_left": max_restarts,
                "max_task_retries": max_task_retries,
            }
            if max_restarts != 0:
                # A restart replays the ctor, which needs its arg objects:
                # hold them for the actor's whole lifetime (released when
                # it is permanently DEAD). Nested obj-lock acquisition —
                # shard order nodes -> objects.
                with self._obj_lock:
                    for oid in spec.get("borrowed", []):
                        self._refs.setdefault(oid, set()).add(
                            "actor:" + actor_id
                        )
        return True

    def rpc_register_actor(
        self, actor_id, node_id, worker_address, class_name, name=None
    ):
        with self._lock:
            prev = self._actors.get(actor_id)
            if prev is not None and prev["state"] == "DEAD":
                # Killed while its (re)start was in flight: refuse to
                # resurrect; the agent retires the worker.
                raise ValueError(
                    f"actor {actor_id} was killed during (re)start"
                )
            if name:
                existing = self._named_actors.get(name)
                if existing is not None and existing != actor_id and \
                        self._actors[existing]["state"] != "DEAD":
                    raise ValueError(f"actor name {name!r} already taken")
                self._named_actors[name] = actor_id
            rec = self._actor_specs.get(actor_id, {})
            self._actors[actor_id] = {
                "actor_id": actor_id,
                "node_id": node_id,
                "address": worker_address,
                "class_name": class_name,
                "name": name,
                "state": "ALIVE",
                "death_cause": None,
                # Incarnation counter: callers detect restarts (and replay
                # lost calls) by comparing this against their submit-time view.
                "num_restarts": prev.get("num_restarts", 0) if prev else 0,
                # Why the previous incarnation died: callers exempt calls
                # lost to a drain/preemption from max_task_retries.
                "restart_cause": prev.get("death_cause") if prev else None,
                "max_task_retries": rec.get("max_task_retries", 0),
            }
            self._actors_cv.notify_all()
            info = dict(self._actors[actor_id])
            node = self._nodes.get(node_id)
            if node is None or not node.alive:
                # Registration raced the node's death (a heartbeat
                # timeout landed between placement and this RPC):
                # _mark_dead's actor sweep already ran and missed this
                # record, so without this check the actor would stay
                # ALIVE at a dead address FOREVER. Process it as the
                # node-death loss it is, and let restartable actors
                # reconstruct elsewhere.
                cause = (node.death_cause if node is not None
                         else None) or "unknown"
                self._on_actor_death(
                    actor_id, f"node {node_id} died: {cause}", True)
                info = dict(self._actors[actor_id])
        self.pubsub.publish("ACTORS", actor_id, info)
        return True

    def rpc_get_actor(self, actor_id, timeout=10.0):
        deadline = time.monotonic() + timeout
        with self._lock:
            while True:
                info = self._actors.get(actor_id)
                if info is not None:
                    return dict(info)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return None
                self._actors_cv.wait(min(remaining, 1.0))

    def rpc_get_named_actor(self, name):
        with self._lock:
            actor_id = self._named_actors.get(name)
            if actor_id is None:
                return None
            return dict(self._actors[actor_id])

    def rpc_mark_actor_dead(self, actor_id, cause, allow_restart=True,
                            worker_address=None):
        """``worker_address`` (when the reporter is a node agent: the
        dead worker's RPC address) identifies WHICH incarnation died, so
        the head can drop reports about a PREVIOUS one: a restarted
        actor's OLD worker dying late must not read as a second death —
        whether the new incarnation is still RESTARTING or already
        ALIVE. A death of any OTHER worker
        (in particular a restart's constructor process, even one placed
        back on the same node) is processed normally so failed restarts
        still settle to DEAD."""
        with self._lock:
            info = self._actors.get(actor_id)
            if info is not None and allow_restart and worker_address:
                if info["state"] == "ALIVE" and \
                        info.get("address") != worker_address:
                    return True  # stale: the live incarnation is another
                    # process; this report is about a predecessor
                if info["state"] == "RESTARTING" and \
                        info.get("address") == worker_address:
                    return True  # the departing incarnation's death —
                    # the restart it triggered is already in flight
            self._on_actor_death(actor_id, cause, allow_restart)
        return True

    def rpc_register_actor_failed(self, actor_id, cause):
        """The agent could not bring the actor up (name conflict, killed
        mid-start): record a dead entry so callers fail fast."""
        with self._lock:
            if actor_id not in self._actors:
                self._actors[actor_id] = {
                    "actor_id": actor_id,
                    "node_id": None,
                    "address": None,
                    "class_name": "Actor",
                    "name": None,
                    "state": "DEAD",
                    "death_cause": cause,
                    "num_restarts": 0,
                    "max_task_retries": 0,
                }
                self._actors_cv.notify_all()
            else:
                self._on_actor_death(actor_id, cause, False)
        return True

    def _on_actor_death(self, actor_id, cause, allow_restart):
        """Restart (ReconstructActor) within the max_restarts budget, else
        mark DEAD. Caller holds self._lock."""
        info = self._actors.get(actor_id)
        if info is None or info["state"] == "DEAD":
            return
        rec = self._actor_specs.get(actor_id)
        if (
            allow_restart
            and rec is not None
            and rec["restarts_left"] != 0
            and info["state"] != "RESTARTING"
        ):
            if rec["restarts_left"] > 0:
                rec["restarts_left"] -= 1
            info["state"] = "RESTARTING"
            info["death_cause"] = cause
            info["num_restarts"] = info.get("num_restarts", 0) + 1
            self._actors_cv.notify_all()
            self.pubsub.publish("ACTORS", actor_id, dict(info))
            threading.Thread(
                target=self._restart_actor, args=(actor_id,), daemon=True
            ).start()
            return
        info["state"] = "DEAD"
        info["death_cause"] = cause
        self.pubsub.publish("ACTORS", actor_id, dict(info))
        name = info.get("name")
        if name and self._named_actors.get(name) == actor_id:
            del self._named_actors[name]
        # Calls queued on the dead actor will never report task-end:
        # release their arg borrows. (Kept alive through RESTARTING so
        # replayed calls still find their args.) Nested obj-lock
        # acquisition — shard order nodes -> objects.
        rec = self._actor_specs.pop(actor_id, None)
        with self._obj_lock:
            for task_id, (_n, _o, aid) in list(
                    self._inflight_by_task.items()):
                if aid == actor_id:
                    self._end_task_borrows(task_id)
            # Release the lifetime holds on the ctor's arg objects.
            if rec is not None:
                holder = "actor:" + actor_id
                for oid in rec["spec"].get("borrowed", []):
                    holders = self._refs.get(oid)
                    if holders is not None:
                        holders.discard(holder)
                        self._maybe_free(oid)
        self._actors_cv.notify_all()

    def _restart_actor(self, actor_id):
        """Re-run the creation spec on a live node; the agent re-registers
        the actor (state -> ALIVE) once the ctor finishes."""
        with self._lock:
            rec = self._actor_specs.get(actor_id)
        if rec is None:
            return
        spec = dict(rec["spec"])
        # The original placement (PG bundle / affinity) may have died with
        # the node: restart anywhere the resources fit.
        spec["sinfo"] = {"strategy": None, "pg_id": None,
                         "bundle_index": -1, "node_affinity": None}
        spec["pg_id"], spec["bundle_index"] = None, -1
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline and not self._stop.is_set():
            with self._lock:
                info = self._actors.get(actor_id)
                if info is None or info["state"] != "RESTARTING":
                    return  # killed (or already re-registered) meanwhile
            placed = self.rpc_schedule(spec["demand"])
            if placed is not None:
                node_id, _addr = placed
                with self._lock:
                    node = self._nodes.get(node_id)
                if node is not None:
                    try:
                        node.client.call("submit_task", spec, timeout=30.0)
                        return
                    except Exception:
                        pass
            time.sleep(0.25)
        with self._lock:
            info = self._actors.get(actor_id)
            if info is not None and info["state"] == "RESTARTING":
                self._on_actor_death(
                    actor_id, "restart failed: no placement", False
                )

    # -- scheduling -------------------------------------------------------

    def rpc_schedule(self, demand, caller_node=None, strategy=None,
                     node_affinity=None):
        """Pick a node for a task/actor; returns (node_id, address) or None
        if no alive node can ever fit the demand."""
        with self._lock:
            return self._schedule_locked(
                demand, caller_node, strategy, node_affinity)

    def rpc_schedule_batch(self, requests):
        """Place many tasks under ONE lock acquisition (the head-side half
        of lease pipelining, cf. the reference's backlog-aware
        RequestWorkerLease batching in direct_task_transport.h:57).
        ``requests``: list of dicts with the rpc_schedule kwargs; returns a
        placement (or None) per request, with the optimistic debit applied
        sequentially so a burst spreads across feasible nodes. A request
        marked ``spilled`` was just REJECTED by the caller's own node
        (leased-push admission) — the view of that node is stale-high, so
        prefer-local is suppressed and other feasible nodes win ties."""
        with self._lock:
            return [
                self._schedule_locked(
                    r["demand"], r.get("caller_node"), r.get("strategy"),
                    r.get("node_affinity"),
                    spilled=r.get("spilled", False))
                for r in requests
            ]

    def _schedule_locked(self, demand, caller_node=None, strategy=None,
                         node_affinity=None, spilled=False):
        # DRAINING nodes are excluded from every new placement (they only
        # finish what they already have).
        alive = [n for n in self._nodes.values() if n.schedulable]
        if node_affinity is not None:
            node = self._nodes.get(node_affinity)
            if node is not None and node.schedulable:
                return self._pick(node, demand)
            return None
        feasible = [
            n
            for n in alive
            if all(n.resources.get(k, 0.0) >= v for k, v in demand.items())
        ]
        if not feasible:
            return None

        def headroom(n: NodeInfo) -> float:
            return min(
                (n.available.get(k, 0.0) - v for k, v in demand.items()),
                default=1.0,
            )

        if strategy == "SPREAD" or not demand:
            # Zero-demand tasks/actors have headroom EVERYWHERE, so
            # hybrid prefer-local would pile every one of them onto the
            # caller's node (and through its worker pool) forever —
            # round-robin them instead.
            self._rr_counter += 1
            return self._pick(
                feasible[self._rr_counter % len(feasible)], demand)
        # Hybrid: prefer caller's node while it has headroom — unless
        # the caller's node itself just rejected this spec (spilled).
        if caller_node is not None and not spilled:
            local = self._nodes.get(caller_node)
            if local is not None and local.schedulable and local in feasible:
                if headroom(local) >= 0:
                    return self._pick(local, demand)
        if spilled and len(feasible) > 1:
            others = [n for n in feasible
                      if n.node_id != caller_node]
            if others:
                return self._pick(max(others, key=headroom), demand)
        best = max(feasible, key=headroom)
        return self._pick(best, demand)

    def _pick(self, node: NodeInfo, demand):
        # Optimistically debit the view so bursts spread before the next
        # heartbeat refreshes truth (the node agent's heartbeat remains
        # authoritative and restores the real availability). The cached
        # cluster-available sum tracks the same debit so status pollers
        # see it; the node's next heartbeat delta restores both together.
        debit_cache = node.schedulable
        for k, v in demand.items():
            node.available[k] = node.available.get(k, 0.0) - v
            if debit_cache:
                self._res_avail[k] = self._res_avail.get(k, 0.0) - v
        return node.node_id, node.address

    # -- placement groups (2-phase commit) --------------------------------

    def rpc_create_placement_group(self, bundles, strategy, name="",
                                   lifetime=None, pg_id=None):
        if pg_id is None:
            pg_id = ids.new_placement_group_id()
        with self._lock:
            if pg_id in self._pgs:
                # Idempotent replay (client retried through its
                # reconnect window): don't double-reserve.
                return pg_id
            self._pgs[pg_id] = {
                "placement_group_id": pg_id,
                "bundles": bundles,
                "strategy": strategy,
                "name": name,
                "state": "PENDING",
                "placement": [],  # [(node_id, bundle_index)]
                "reschedules": 0,
            }
        threading.Thread(
            target=self._reserve_pg, args=(pg_id,), daemon=True
        ).start()
        return pg_id

    def _pg_assign(self, bundles, strategy) -> Optional[list]:
        """Choose a node per bundle against total capacities: the
        degenerate every-bundle-lost case of the reschedule
        coordinator's partial assign — ONE bin-packing implementation
        for both the initial reserve and the migration."""
        return self._pg_assign_partial(
            bundles, strategy, [], list(range(len(bundles))))

    def _reserve_pg(self, pg_id: str):
        # Reservation retries while the PG is PENDING: a prepare that
        # fails because another group currently holds the resources is
        # TRANSIENT (reference PGs stay pending until placeable);
        # INFEASIBLE is only declared when no assignment exists against
        # node TOTALS — it can never fit.
        while True:
            if self._stop.is_set():
                return  # a stopped (or crashed) head's reservation stops
            with self._lock:
                pg = self._pgs.get(pg_id)
                if pg is None or pg["state"] != "PENDING":
                    return  # removed (or already settled) while retrying
                bundles, strategy = pg["bundles"], pg["strategy"]
            assignment = self._pg_assign(bundles, strategy)
            if assignment is None:
                with self._lock:
                    pg["state"] = "INFEASIBLE"
                    self._pg_event(pg)
                return
            # Phase 1: prepare every bundle on its node (blocking until
            # the node can reserve it); phase 2: commit. Rollback and
            # retry on any failure.
            prepared: list[tuple[str, int]] = []
            ok = True
            for node_id, bundle_index in assignment:
                with self._lock:
                    node = self._nodes.get(node_id)
                if node is None or not node.alive:
                    ok = False
                    break
                # Appended BEFORE the call: a prepare that LANDED
                # agent-side but whose reply was lost (severed channel,
                # timeout) must still be rolled back, or the carve-out
                # leaks when the retry round picks a different node.
                # return_bundle on a node the prepare never reached is
                # an idempotent no-op.
                prepared.append((node_id, bundle_index))
                try:
                    failpoints.hit("head.pg.prepare")
                    node.client.call(
                        "prepare_bundle", pg_id, bundle_index,
                        bundles[bundle_index],
                        # timeout-budget: outlasts config.bundle_reserve_timeout_s
                        timeout=config.bundle_reserve_timeout_s * 2,
                    )
                except Exception:
                    ok = False
                    break
            if ok:
                break
            for node_id, bundle_index in prepared:
                with self._lock:
                    node = self._nodes.get(node_id)
                if node is not None:
                    try:
                        node.client.call("return_bundle", pg_id, bundle_index)
                    except Exception:
                        # Best-effort: a dead node's carve-out died with it.
                        _metrics.count_loop_restart("head.reserve_pg")
            time.sleep(0.25)
        for node_id, bundle_index in assignment:
            with self._lock:
                node = self._nodes.get(node_id)
            try:
                failpoints.hit("head.pg.commit")
                node.client.call("commit_bundle", pg_id, bundle_index)
            except Exception:
                pass
        rollback = False
        with self._lock:
            if pg["state"] == "REMOVED":
                # Removed while we were reserving: give everything back
                # instead of resurrecting the group.
                rollback = True
            else:
                pg["placement"] = assignment
                pg["state"] = "CREATED"
                self._pg_event(pg)
        if rollback:
            for node_id, bundle_index in assignment:
                with self._lock:
                    node = self._nodes.get(node_id)
                if node is not None and node.alive:
                    try:
                        node.client.call("return_bundle", pg_id, bundle_index)
                    except Exception:
                        pass

    def rpc_remove_placement_group(self, pg_id):
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None:
                return False
            prev, pg["state"] = pg["state"], "REMOVED"
            placement = list(pg["placement"])
            self._pg_event(pg)
        if prev in ("CREATED", "RESCHEDULING"):
            # RESCHEDULING placements may include dead nodes (nothing to
            # return there) and draining nodes (return, so the drain can
            # finish); a reschedule coordinator racing this sees REMOVED
            # under the lock and rolls back its own prepared bundles.
            for node_id, bundle_index in placement:
                with self._lock:
                    node = self._nodes.get(node_id)
                if node is not None and node.alive:
                    try:
                        node.client.call("return_bundle", pg_id, bundle_index)
                    except Exception:
                        pass
        return True

    def _pg_table_entry(self, pg: dict) -> dict:
        """Caller holds self._lock. Public table view of one PG: the
        coordinator's private keys are stripped, and the bundle->node
        map plus per-bundle liveness ride along so gang holders (the
        elastic trainer) can see exactly which bundles survived a node
        loss (a DRAINING node's bundles are not live)."""
        e = {k: v for k, v in pg.items() if not k.startswith("_")}
        e["placement"] = list(pg["placement"])
        e["bundle_nodes"] = {bi: nid for nid, bi in pg["placement"]}
        e["live_bundles"] = sorted(
            bi for nid, bi in pg["placement"]
            if self._nodes.get(nid) is not None
            and self._nodes[nid].schedulable
        )
        e.setdefault("reschedules", 0)
        return e

    def rpc_placement_group_table(self, pg_id=None):
        with self._lock:
            if pg_id is not None:
                pg = self._pgs.get(pg_id)
                return self._pg_table_entry(pg) if pg else None
            return {k: self._pg_table_entry(v)
                    for k, v in self._pgs.items()}

    def rpc_pg_node_for_bundle(self, pg_id, bundle_index, timeout=30.0):
        """Blocking: node that holds the given bundle (or any, if -1).
        A PENDING group parks the caller until it is reserved, and so
        does a RESCHEDULING one for its lost bundles — they are being
        migrated to healthy nodes, and the resolution that eventually
        returns points at the bundle's NEW home (tasks pinned to a
        migrated bundle re-resolve instead of erroring)."""
        deadline = time.monotonic() + timeout
        while True:
            with self._lock:
                pg = self._pgs.get(pg_id)
                if pg is None:
                    raise ValueError(f"no such placement group {pg_id}")
                if pg["state"] == "INFEASIBLE":
                    raise ValueError(f"placement group {pg_id} is infeasible")
                if pg["state"] == "REMOVED":
                    raise ValueError(f"placement group {pg_id} was removed")
                if pg["state"] == "CREATED":
                    for node_id, bi in pg["placement"]:
                        if bundle_index < 0 or bi == bundle_index:
                            node = self._nodes.get(node_id)
                            if node and node.alive:
                                return node_id, node.address
                    raise ValueError(
                        f"bundle {bundle_index} of {pg_id} has no live node"
                    )
                if pg["state"] == "RESCHEDULING":
                    # Only the LOST bundles park. A surviving bundle
                    # resolves immediately — an elastic gang running at
                    # shrunk world size places its workers on the live
                    # bundles while the coordinator migrates the rest.
                    for node_id, bi in pg["placement"]:
                        if bundle_index < 0 or bi == bundle_index:
                            node = self._nodes.get(node_id)
                            if node is not None and node.schedulable:
                                return node_id, node.address
            if time.monotonic() > deadline:
                raise TimeoutError(f"placement group {pg_id} not ready")
            time.sleep(0.02)

    # -- placement-group rescheduling (reservation outlives its nodes) -----
    #
    # Podracer-style preemptible fleets lose nodes as the NORMAL case:
    # a gang reservation must migrate, not die, when a bundle's node
    # drains or crashes. The state machine is
    #
    #     CREATED --(bundle node dead/draining)--> RESCHEDULING
    #     RESCHEDULING --(2PC re-reserve on healthy nodes)--> CREATED
    #     RESCHEDULING --(remove_placement_group)--> REMOVED
    #
    # driven by one coordinator thread per group (restarted by the
    # monitor loop if it ever dies). Lock discipline: every node RPC runs
    # OUTSIDE the head's locks.

    @staticmethod
    def _pg_reschedule_cause(cause: str) -> str:
        """Metric cause class for a reschedule trigger: planned drains
        (including a drained node whose heartbeat-death won the race)
        vs a crash-detected node death."""
        if "drain" in cause:
            return "drain"
        return "node_death"

    def _pg_event(self, pg: dict, cause: str | None = None) -> None:
        """Caller holds self._lock. Publish the group's latest lifecycle
        state on the PLACEMENT_GROUPS channel (the NODES/ACTORS
        state-update shape: full latest state per key, coalesced for
        slow subscribers) so gang holders learn their bundles moved
        without polling the table."""
        msg = {
            "placement_group_id": pg["placement_group_id"],
            "state": pg["state"],
            "placement": list(pg["placement"]),
            "reschedules": pg.get("reschedules", 0),
        }
        if cause:
            msg["cause"] = cause
        self.pubsub.publish(
            "PLACEMENT_GROUPS", pg["placement_group_id"], msg)

    def _pg_mark_rescheduling_locked(self, pg: dict, cause: str) -> None:
        """Caller holds self._lock. Move the group to RESCHEDULING and
        ensure exactly one coordinator drives it: a second node loss
        mid-reschedule only refreshes the cause — the running
        coordinator re-derives the lost bundle set every round."""
        pg["state"] = "RESCHEDULING"
        pg["reschedule_cause"] = cause
        self._pg_event(pg, cause)
        if pg.get("_resched_active"):
            return
        pg["_resched_active"] = True
        threading.Thread(
            target=self._reschedule_pg,
            args=(pg["placement_group_id"], cause), daemon=True,
        ).start()

    def _pg_assign_partial(self, bundles, strategy, keep,
                           lost) -> Optional[list]:
        """Choose a node for each LOST bundle against node totals,
        honoring the strategy alongside the surviving placement:
        surviving bundles' demand counts into the plan (no
        double-booking their nodes), SPREAD ranks surviving nodes last,
        STRICT_SPREAD excludes them, STRICT_PACK targets the surviving
        node (or one fresh node for a full loss)."""
        with self._lock:
            alive = [n for n in self._nodes.values() if n.schedulable]
        if not alive:
            return None
        planned: dict[str, dict[str, float]] = {
            n.node_id: {} for n in alive}
        keep_nodes: set[str] = set()
        for nid, bi in keep:
            keep_nodes.add(nid)
            add = planned.get(nid)
            if add is not None:
                for k, v in bundles[bi].items():
                    add[k] = add.get(k, 0.0) + v

        def fits(n: NodeInfo, b: dict) -> bool:
            add = planned[n.node_id]
            return all(
                n.resources.get(k, 0.0) >= add.get(k, 0.0) + v
                for k, v in b.items()
            )

        def commit(n: NodeInfo, b: dict):
            add = planned[n.node_id]
            for k, v in b.items():
                add[k] = add.get(k, 0.0) + v

        assignment: list[tuple[str, int]] = []
        if strategy in ("PACK", "STRICT_PACK"):
            order = sorted(alive, key=lambda n: -sum(n.resources.values()))
            if strategy == "STRICT_PACK":
                # Everything on ONE node: the survivors' node if any
                # bundle survived, else the single best fresh node.
                if keep_nodes:
                    order = [n for n in order if n.node_id in keep_nodes]
                order = order[:1]
            for bi in lost:
                b = bundles[bi]
                for n in order:
                    if fits(n, b):
                        commit(n, b)
                        assignment.append((n.node_id, bi))
                        break
                else:
                    return None
        elif strategy in ("SPREAD", "STRICT_SPREAD"):
            used = set(keep_nodes)
            for bi in lost:
                b = bundles[bi]
                ranked = sorted(
                    alive,
                    key=lambda n: (n.node_id in used,
                                   -sum(n.resources.values())),
                )
                placed = False
                for n in ranked:
                    if strategy == "STRICT_SPREAD" and n.node_id in used:
                        continue
                    if fits(n, b):
                        commit(n, b)
                        used.add(n.node_id)
                        assignment.append((n.node_id, bi))
                        placed = True
                        break
                if not placed:
                    return None
        else:
            return None
        return assignment

    def _pg_rollback(self, pg_id: str, prepared: list) -> None:
        """Return every bundle a failed 2PC round prepared — per node,
        best-effort (a dead node's reservation died with it) — so a
        partial prepare can never leak a per-node reservation."""
        for node_id, bi in prepared:
            with self._lock:
                node = self._nodes.get(node_id)
            if node is not None and node.alive:
                try:
                    node.client.call("return_bundle", pg_id, bi,
                                     timeout=30.0)
                except Exception:
                    pass

    def _pg_commit_assignment(self, pg_id: str, assignment: list) -> bool:
        """Phase 2 on the replacement nodes. ``commit_bundle`` is
        idempotent agent-side and ``prepare_bundle`` replays are
        absorbed there too, so a commit whose reply was severed
        mid-channel retries safely — exactly-once reservation. Returns
        False when a target died mid-commit (caller re-derives)."""
        for node_id, bi in assignment:
            for attempt in range(3):
                with self._lock:
                    node = self._nodes.get(node_id)
                    node_alive = node is not None and node.alive
                if not node_alive:
                    return False
                try:
                    failpoints.hit("head.pg.commit")
                    node.client.call("commit_bundle", pg_id, bi,
                                     timeout=30.0)
                    break
                except Exception:
                    if attempt == 2:
                        return False
                    time.sleep(0.1)
        return True

    def _reschedule_pg(self, pg_id: str, cause: str) -> None:
        """One group's reschedule lifecycle: re-run the reserve 2PC for
        its lost bundles on healthy nodes — prepare every replacement
        (rollback on partial failure), commit, install the new
        placement — re-queuing behind capacity with a doubling backoff
        (the gang was feasible once; it waits for a replacement node
        rather than dying). Old reservations on
        still-alive DRAINING nodes are returned only AFTER their
        replacement committed, so the gang always holds a reservation
        somewhere. No node RPC ever runs under a lock."""
        t0 = time.monotonic()
        try:
            failpoints.hit("head.pg.before_reschedule")
        except failpoints.FailpointError:
            # Injected coordinator crash: DIE (the finally below clears
            # _resched_active) and let the monitor loop restart a fresh
            # coordinator — swallowing the raise would make the
            # injection a no-op and the recovery path untestable.
            with self._lock:
                pg = self._pgs.get(pg_id)
                if pg is not None:
                    pg["_resched_active"] = False
            return
        backoff = RESCHEDULE_RETRY_BASE_S
        try:
            while not self._stop.is_set():
                with self._lock:
                    pg = self._pgs.get(pg_id)
                    if pg is None or pg["state"] != "RESCHEDULING":
                        return  # removed / settled while retrying
                    bundles, strategy = pg["bundles"], pg["strategy"]
                    keep: list[tuple] = []
                    lost: list[int] = []
                    vacate: list[tuple] = []
                    for nid, bi in pg["placement"]:
                        n = self._nodes.get(nid)
                        if n is not None and n.schedulable:
                            keep.append((nid, bi))
                        else:
                            lost.append(bi)
                            if n is not None and n.alive:
                                # DRAINING: reservation still held there;
                                # return it after the replacement lands.
                                vacate.append((n, bi))
                if not lost:
                    # Every bundle is back on a schedulable node (e.g. a
                    # transient drain view): settle without a 2PC round.
                    if self._pg_install(pg_id, keep, [], [], t0, cause):
                        return
                    continue
                assignment = self._pg_assign_partial(
                    bundles, strategy, keep, lost)
                if assignment is None:
                    time.sleep(backoff)
                    backoff = min(RESCHEDULE_RETRY_MAX_S,
                                  backoff * 2.0)
                    continue
                prepared: list[tuple] = []
                ok = True
                for node_id, bi in assignment:
                    with self._lock:
                        node = self._nodes.get(node_id)
                        node_ok = node is not None and node.schedulable
                    if not node_ok:
                        ok = False
                        break
                    # Appended BEFORE the call (see _reserve_pg): a
                    # prepare that landed but lost its reply must roll
                    # back too, or the reservation leaks when the next
                    # round assigns a different node.
                    prepared.append((node_id, bi))
                    try:
                        failpoints.hit("head.pg.prepare")
                        node.client.call(
                            "prepare_bundle", pg_id, bi, bundles[bi],
                            # timeout-budget: outlasts config.bundle_reserve_timeout_s
                            timeout=config.bundle_reserve_timeout_s * 2)
                    except Exception:
                        ok = False
                        break
                if ok:
                    ok = self._pg_commit_assignment(pg_id, assignment)
                if not ok:
                    self._pg_rollback(pg_id, prepared)
                    time.sleep(backoff)
                    backoff = min(RESCHEDULE_RETRY_MAX_S,
                                  backoff * 2.0)
                    continue
                if self._pg_install(
                        pg_id, keep, assignment, vacate, t0, cause):
                    return
                # A keep-node died mid-2PC: the committed replacements
                # are already installed in the placement; loop to
                # re-derive and re-reserve only the newly lost bundles.
        finally:
            with self._lock:
                pg = self._pgs.get(pg_id)
                if pg is not None:
                    pg["_resched_active"] = False

    def _pg_install(self, pg_id: str, keep: list, assignment: list,
                    vacate: list, t0: float, cause: str) -> bool:
        """Install keep+assignment as the group's placement. Returns
        True when the reschedule is DONE (group CREATED again, or
        removed meanwhile — prepared bundles rolled back); False when a
        surviving node died mid-2PC and the coordinator must re-derive
        (the commit landed: the placement keeps it either way)."""
        placement = sorted(keep + assignment, key=lambda p: p[1])
        removed = False
        done = False
        with self._lock:
            pg = self._pgs.get(pg_id)
            if pg is None or pg["state"] != "RESCHEDULING":
                removed = True
            else:
                pg["placement"] = placement
                still_lost = [
                    nid for nid, _bi in placement
                    if not (self._nodes.get(nid) is not None
                            and self._nodes[nid].schedulable)
                ]
                if not still_lost:
                    pg["state"] = "CREATED"
                    pg["reschedules"] = pg.get("reschedules", 0) + 1
                    pg.pop("reschedule_cause", None)
                    self._pg_event(pg, cause)
                    done = True
        if removed:
            self._pg_rollback(pg_id, assignment)
            return True
        # Vacate the old reservations on draining nodes now that their
        # replacements are committed (kills bundle tasks still there;
        # owners recover them with the drain retry exemption).
        for node, bi in vacate:
            try:
                node.client.call("return_bundle", pg_id, bi, timeout=30.0)
            except Exception:
                pass
        if done:
            _metrics.PG_RESCHEDULES_TOTAL.inc(
                tags={"cause": self._pg_reschedule_cause(cause)})
            _metrics.PG_RESCHEDULE_SECONDS.observe(time.monotonic() - t0)
        return done

    # -- tracing span store (util/tracing.py; OTel-shaped) ----------------

    def rpc_report_spans(self, spans, node_id=None, dropped=0):
        """A batch of finished spans from an agent (its workers') or a
        driver, with the reporter's span-buffer drop count. Resends are
        absorbed by the trace store (span ids)."""
        if dropped:
            with self._event_lock:
                self._worker_span_drops += int(dropped)
            _metrics.TRACING_DROPPED_SPANS.inc(
                int(dropped), tags={"node_id": node_id or "unknown"})
        with self._event_lock:
            overflow = max(
                0, len(self._spans) + len(spans) - self._spans.maxlen)
            self._spans.extend(spans)
            if overflow:
                self._spans_dropped += overflow
        if overflow:
            _metrics.HEAD_SPANS_DROPPED.inc(overflow)
        # Assembly: the same batch stitches into whole traces, node-
        # attributed so alignment knows whose clock stamped each span.
        # Outside _event_lock: the store has its own lock.
        self._traces.add_spans(spans, node_id=node_id)
        return True

    def rpc_list_spans(self, trace_id=None, limit: int = 10_000):  # idempotent (read-only)
        with self._event_lock:
            out = [s for s in self._spans
                   if trace_id is None or s["trace_id"] == trace_id]
            return out[-limit:]

    def _drain_own_spans(self) -> None:
        """The head's own spans (rpc: handler spans opened when a traced
        call carries a traceparent) have no event flusher: fold them in
        on the query path."""
        from ray_tpu_torch.util import tracing as _tracing

        if not _tracing.is_enabled():
            return
        spans = _tracing.drain()
        if spans:
            self.rpc_report_spans(spans)

    def rpc_get_trace(self, trace_id: str):  # idempotent (read-only)
        self._drain_own_spans()
        return self._traces.get(trace_id)

    def rpc_list_traces(self, limit: int = 50):  # idempotent (read-only)
        self._drain_own_spans()
        return self._traces.list(limit)

    def rpc_trace_stats(self):  # idempotent (read-only)
        out = self._traces.stats()
        with self._event_lock:
            out["spans_retained"] = len(self._spans)
            out["spans_dropped"] = self._spans_dropped
            out["worker_spans_dropped"] = self._worker_span_drops
        return out

    def rpc_ttft_decomposition(self, window_s=None, deployment=None):  # idempotent (read-only)
        self._drain_own_spans()
        return self._traces.ttft_decomposition(window_s, deployment)

    def rpc_clock_probe(self, t0: float):  # idempotent (read-only)
        """NTP-style exchange: the agent sends its clock's ``t0``; we
        answer (receive time, reply time) on ours."""
        t1 = time.time()
        return (t1, time.time())

    def rpc_report_clock(self, node_id: str, offset_s: float,  # idempotent
                         rtt_s: float):
        self._traces.clock.observe(node_id, offset_s, rtt_s)
        return True

    # -- state API aggregation ----------------------------------------------

    def rpc_list_actors(self):  # idempotent (read-only)
        with self._lock:
            return [dict(v) for v in self._actors.values()]

    def _alive_agents(self) -> list:
        with self._lock:
            return [(n.node_id, n.client) for n in self._nodes.values()
                    if n.alive]

    def _fanout_agents(self, method: str, *args, timeout: float = 5.0,
                       agents=None, args_for=None) -> list:
        """Call one RPC on every alive agent CONCURRENTLY and return the
        successful results (a wedged agent costs its timeout, not the
        sum over the cluster). ``args_for(node_id)`` supplies per-agent
        args (each node's slice of the object directory)."""
        agents = self._alive_agents() if agents is None else agents
        if not agents:
            return []

        def one(item):
            nid, client = item
            call_args = args if args_for is None else args_for(nid)
            try:
                return nid, client.call(method, *call_args, timeout=timeout)
            except Exception:
                return nid, None  # node died or wedged: best-effort

        if len(agents) == 1:
            results = [one(agents[0])]
        else:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(
                    max_workers=min(16, len(agents))) as pool:
                results = list(pool.map(one, agents))
        return [(nid, r) for nid, r in results if r is not None]

    def rpc_list_tasks(self, limit: int = 1000):
        """The alive agents' task records merged by recency
        (state_aggregator.py querying raylet GetTasksInfo analog)."""
        records = []
        for node_id, recs in self._fanout_agents(
                "list_task_records", limit, timeout=5.0):
            for rec in recs:
                rec["node_id"] = node_id
                records.append(rec)
        records.sort(
            key=lambda r: r.get("submitted_at") or r.get("start_time") or 0)
        return records[-limit:]

    def rpc_list_objects(self, limit: int = 1000):
        """Object records from the directory and the ref table (no agent
        RPC), sorted by size DESCENDING with the limit applied after the
        sort, and the clipping reported ({"objects", "truncated",
        "total"}). Records carry the put-time attribution and age."""
        now = time.time()
        with self._obj_lock:
            out = []
            for oid, entry in self._objects.items():
                attr = entry.get("attr") or {}
                created = attr.get("created_at")
                out.append({
                    "object_id": oid,
                    "size": entry.get("size", 0),
                    "locations": sorted(entry["nodes"]),
                    "is_error": entry.get("error", False),
                    "ref_holders": len(self._refs.get(oid, ())),
                    "owner": attr.get("owner", ""),
                    "owner_addr": entry.get("owner", ""),
                    "task": attr.get("task", ""),
                    "callsite": attr.get("callsite", ""),
                    "age_s": round(now - created, 3) if created else None,
                })
        out.sort(key=lambda r: r["size"], reverse=True)
        total = len(out)
        return {"objects": out[:limit], "truncated": total > limit,
                "total": total}

    def rpc_worker_stats(self, fresh: bool = False):
        """Per-worker CPU/RSS/uptime (and last task's phases), cluster-wide."""
        out = []
        for _nid, stats in self._fanout_agents("worker_stats", fresh,
                                               timeout=10.0):
            out.extend(stats)
        return out

    def rpc_device_stats(self, fresh: bool = False):
        """Per-worker CUDA device snapshots across the cluster."""
        out = []
        for _nid, snaps in self._fanout_agents("device_stats", fresh,
                                               timeout=10.0):
            out.extend(snaps)
        return out

    # -- memory observability (`ray memory` / memory_summary analog) -------

    def rpc_object_store_stats(self, node_id=None,  # idempotent (read-only)
                               include_objects: bool = True):
        """Per-node store reports: each agent's ``stats()`` joined with
        per-key ``info()`` and the attribution in each entry's meta; the
        head fills attribution gaps (restored copies) from its directory
        and stamps ref-holder counts."""
        agents = [(nid, c) for nid, c in self._alive_agents()
                  if node_id is None or nid == node_id]
        oids_by_node: dict[str, list] = {}
        attr_by_oid: dict[str, dict] = {}
        holders_by_oid: dict[str, int] = {}
        if include_objects:
            with self._obj_lock:
                for oid, e in self._objects.items():
                    for nid in e["nodes"]:
                        oids_by_node.setdefault(nid, []).append(oid)
                    attr_by_oid[oid] = dict(e.get("attr") or {})
                    holders_by_oid[oid] = len(self._refs.get(oid, ()))
        reports = [rep for _nid, rep in self._fanout_agents(
            "object_store_stats", timeout=15.0, agents=agents,
            args_for=lambda nid: (oids_by_node.get(nid, []),
                                  include_objects))]
        now = time.time()
        for rep in reports:
            for rec in rep.get("objects") or []:
                attr = attr_by_oid.get(rec["object_id"]) or {}
                for key in ("owner", "task", "callsite"):
                    if not rec.get(key) and attr.get(key):
                        rec[key] = attr[key]
                if rec.get("age_s") is None and attr.get("created_at"):
                    rec["age_s"] = round(now - attr["created_at"], 3)
                rec["ref_holders"] = holders_by_oid.get(
                    rec["object_id"], 0)
        return reports

    def rpc_memory_summary(self, top_k: int = 20,  # idempotent (read-only)
                           group_by: str = "callsite"):
        """Cluster-wide memory rollup: per-node store totals and
        occupancy, the top-K resident objects (replicas deduped), and
        live bytes grouped by callsite / task / node / owner."""
        if group_by not in ("callsite", "task", "node", "owner"):
            raise ValueError(
                f"group_by must be callsite|task|node|owner, "
                f"got {group_by!r}")
        reports = self.rpc_object_store_stats()
        totals = {"bytes_used": 0, "bytes_capacity": 0, "objects": 0,
                  "evictions": 0, "spilled_bytes": 0, "spilled_objects": 0,
                  "nodes": len(reports)}
        nodes: dict[str, dict] = {}
        best: dict[str, dict] = {}
        for rep in reports:
            st = rep.get("stats") or {}
            nid = rep.get("node_id", "?")
            totals["bytes_used"] += st.get("used", 0)
            totals["bytes_capacity"] += st.get("capacity", 0)
            totals["objects"] += st.get("num_objects", 0)
            totals["evictions"] += st.get("num_evictions", 0)
            totals["spilled_bytes"] += st.get("spilled_bytes", 0)
            totals["spilled_objects"] += st.get("spilled_objects", 0)
            cap = st.get("capacity", 0)
            nodes[nid] = {
                "bytes_used": st.get("used", 0), "bytes_capacity": cap,
                "occupancy": round(st.get("used", 0) / cap, 4) if cap
                else 0.0,
                "objects": st.get("num_objects", 0),
                "evictions": st.get("num_evictions", 0),
                "spilled_bytes": st.get("spilled_bytes", 0),
                "oom_reports": [r.get("path")
                                for r in rep.get("oom_reports") or []],
            }
            for rec in rep.get("objects") or []:
                cur = best.get(rec["object_id"])
                if cur is None:
                    cur = best[rec["object_id"]] = dict(rec)
                    cur["nodes"] = [nid]
                else:
                    # A replica: one entry, all its homes.
                    cur["nodes"].append(nid)
                    cur["size"] = max(cur["size"], rec.get("size", 0))
        objs = sorted(best.values(), key=lambda r: r.get("size", 0),
                      reverse=True)
        groups: dict[str, dict] = {}
        for rec in objs:
            if group_by == "node":
                keys = rec.get("nodes") or ["(unknown)"]
            else:
                keys = [rec.get(group_by) or "(unknown)"]
            for key in keys:
                g = groups.setdefault(
                    key, {"key": key, "bytes": 0, "objects": 0})
                g["bytes"] += rec.get("size", 0)
                g["objects"] += 1
        with self._obj_lock:
            n_leaks = len(self._leaks)
        return {
            "totals": totals,
            "nodes": nodes,
            "top_objects": objs[:top_k],
            "group_by": group_by,
            "groups": sorted(groups.values(),
                             key=lambda g: g["bytes"], reverse=True),
            "leaks": n_leaks,
        }

    def rpc_memory_leaks(self):  # idempotent (read-only)
        """Objects the sweeper currently flags, largest first."""
        with self._obj_lock:
            leaks = [dict(v) for v in self._leaks.values()]
        leaks.sort(key=lambda r: r.get("size", 0), reverse=True)
        return leaks

    def _leak_sweep_loop(self):
        while not self._stop.wait(max(0.25, config.leak_sweep_interval_s)):
            try:
                self._sweep_leaks_once()
            except Exception:
                _metrics.count_loop_restart("head.leak_sweep")

    def _sweep_leaks_once(self):
        """Flag objects alive past the age threshold that nothing can
        reach: NO registered holder and no in-flight borrow (an owner
        that died before its ref flush leaves a pinned primary copy),
        or held refs whose every replica is gone. A flag clears the
        moment a holder appears or the object is freed."""
        threshold = config.leak_age_threshold_s
        if threshold <= 0:
            return
        now = time.time()
        with self._obj_lock:
            flagged: dict[str, dict] = {}
            for oid, entry in self._objects.items():
                attr = entry.get("attr") or {}
                created = attr.get("created_at")
                if not created or now - created < threshold:
                    continue
                holders = self._refs.get(oid)
                inflight = self._inflight.get(oid, 0)
                live_nodes = [
                    nid for nid in entry["nodes"]
                    if self._nodes.get(nid) and self._nodes[nid].alive
                ]
                if not holders and inflight == 0:
                    kind = "no_reachable_refs"
                elif holders and not live_nodes:
                    kind = "primary_copy_lost"
                else:
                    continue
                prev = self._leaks.get(oid)
                flagged[oid] = {
                    "object_id": oid,
                    "kind": kind,
                    "size": entry.get("size", 0),
                    "nodes": sorted(entry["nodes"]),
                    "age_s": round(now - created, 1),
                    "owner": attr.get("owner", ""),
                    "task": attr.get("task", ""),
                    "callsite": attr.get("callsite", ""),
                    "holders": sorted(holders or ()),
                    "first_flagged": (prev or {}).get(
                        "first_flagged", round(now, 3)),
                }
            self._leaks = flagged

    # -- logs (log_monitor -> GCS pubsub -> driver analog) ------------------

    def rpc_worker_logs(self, node_id, pid, lines, worker_id=None):
        """A worker's captured lines, forwarded by its agent: into the
        ring (cursor reads) and onto the LOGS channel (drivers follow)."""
        with self._event_lock:
            for line in lines:
                self._log_seq += 1
                self._logs.append({"seq": self._log_seq, "node_id": node_id,
                                   "pid": pid, "worker_id": worker_id,
                                   "line": line})
        self.pubsub.publish("LOGS", node_id, {
            "node_id": node_id, "pid": pid, "worker_id": worker_id,
            "lines": lines})
        return True

    def rpc_drain_logs(self, after_seq: int = 0, limit: int = 1000):
        """Up to ``limit`` log entries newer than ``after_seq``, oldest
        first, as (cursor, entries): pass the cursor back to resume."""
        with self._event_lock:
            newer: list = []
            for e in reversed(self._logs):
                if e["seq"] <= after_seq:
                    break
                newer.append(e)
            newer.reverse()
            entries = newer[:limit]
            cursor = entries[-1]["seq"] if entries else self._log_seq
            return cursor, entries

    # -- routing to the agent that owns a worker (logs, stacks, profiles) ---

    def _route_worker(self, worker_id, node_id=None, need_live=False):
        """(node_id, client) of the agent that owns ``worker_id``."""
        agents = self._alive_agents()
        if node_id is not None:
            for nid, client in agents:
                if nid == node_id:
                    return nid, client
            raise ValueError(f"node {node_id!r} is not alive")
        for nid, client in agents:
            try:
                got = client.call("has_worker", worker_id, timeout=5.0)
            except Exception:
                continue
            if got.get("live") or (not need_live and got.get("known")):
                return nid, client
        raise ValueError(f"worker {worker_id!r} not found on any alive node")

    def rpc_list_logs(self):
        """Captured worker logs across the cluster (live and recently dead
        workers), merged from every alive agent."""
        out = []
        for _nid, recs in self._fanout_agents("list_worker_logs",
                                              timeout=5.0):
            out.extend(recs)
        out.sort(key=lambda r: r.get("started_at") or 0)
        return out

    def rpc_get_log(self, worker_id, stream: str = "out", offset=None,
                    max_bytes: int = 1 << 20, tail_lines=None,
                    node_id=None):
        _nid, client = self._route_worker(worker_id, node_id)
        return client.call("read_worker_log", worker_id, stream, offset,
                           max_bytes, tail_lines, timeout=15.0)

    def rpc_follow_log(self, worker_id, stream: str = "out",
                       offset: int = 0, idle_timeout_s: float = 10.0,
                       node_id=None):
        """``tail -f`` proxied from the owning agent, streamed on."""
        _nid, client = self._route_worker(worker_id, node_id)
        return client.call_stream(
            "follow_worker_log", worker_id, stream, offset, idle_timeout_s,
            timeout=idle_timeout_s + 30.0)

    def rpc_dump_worker_stack(self, worker_id, node_id=None):
        _nid, client = self._route_worker(worker_id, node_id,
                                          need_live=True)
        return client.call("dump_worker_stack", worker_id, timeout=20.0)

    def rpc_profile_worker(self, worker_id, duration_s: float = 1.0,
                           interval_s: float = 0.01, node_id=None):
        _nid, client = self._route_worker(worker_id, node_id,
                                          need_live=True)
        return client.call("profile_worker", worker_id, duration_s,
                           interval_s, timeout=float(duration_s) + 45.0)

    def rpc_capture_profile(self, worker_id, duration_s: float = 1.0,
                            interval_s: float = 0.01, node_id=None):
        """A profiler capture in the worker, routed to its agent; returns
        the manifest (the files stream back through
        ``rpc_read_capture_file``)."""
        _nid, client = self._route_worker(worker_id, node_id,
                                          need_live=True)
        return client.call("capture_profile", worker_id, duration_s,
                           interval_s, timeout=float(duration_s) + 90.0)

    def rpc_read_capture_file(self, node_id, capture_id, name,  # idempotent (read-only)
                              offset: int = 0, max_bytes: int = 1 << 20):
        node = self._nodes.get(node_id)
        if node is None or not node.alive:
            raise ValueError(f"node {node_id!r} is not alive")
        return node.client.call("read_capture_file", capture_id, name,
                                offset, max_bytes, timeout=30.0)

    # -- metrics federation --------------------------------------------------

    def cluster_metrics_text(self) -> str:
        """One exposition body for the whole cluster: the head's registry
        merged with every alive agent's (``/metrics/cluster``). A series
        of node X takes X's own render: in an in-process cluster the head
        and the agents share one registry, rendered by each of them at
        once, and only X refreshes X's device and store gauges just
        before it renders (the reference keeps every series' first-seen
        sample, ``ray_tpu/cluster/head.py:2348``, which can be another
        render's copy of X's previous refresh)."""
        rendered = self._fanout_agents("metrics_text", timeout=5.0)
        return _metrics.merge_prometheus(
            [_metrics.prometheus_text()] + [t for _nid, t in rendered],
            owners=[None] + [nid for nid, _t in rendered])

    def rpc_cluster_metrics_text(self) -> str:  # idempotent (read-only)
        return self.cluster_metrics_text()

    def _file_sd_text(self) -> str:
        import json

        return json.dumps(
            _metrics.file_sd_targets(self.metrics_address or ""), indent=1)

    def rpc_metrics_endpoint(self):  # idempotent (read-only)
        """Where to scrape this cluster (None when disabled)."""
        if self.metrics_address is None:
            return None
        return {"address": self.metrics_address,
                "cluster_path": "/metrics/cluster",
                "targets_path": "/metrics/targets"}

    # -- the signal plane (metrics history ring + SLO evaluation) ------------

    def _signal_scrape_loop(self):
        """Scrape the federated exposition into the history ring; a dead
        agent's chunk is skipped by the fan-out, so one bad node degrades
        a snapshot, never the loop."""
        interval = max(0.1, config.signal_scrape_interval_s)
        while not self._stop.wait(interval):
            try:
                self._scrape_signals_once()
            except Exception:
                _metrics.count_loop_restart("head.signal_scrape")

    def _scrape_signals_once(self):
        from ray_tpu_torch.util import tracing as _tracing

        # Suppressed: the scrape fans an RPC out to every agent every
        # interval, forever; traced, it would fill the traces with
        # control-plane spans.
        with _tracing.suppressed():
            t0 = time.perf_counter()
            text = self.cluster_metrics_text()
            n_series = self._signals.ingest_text(time.time(), text)
        _metrics.HEAD_SIGNAL_SCRAPE_SECONDS.observe(time.perf_counter() - t0)
        _metrics.HEAD_SIGNAL_SERIES.set(float(n_series))

    def _slo_eval_loop(self):
        interval = max(0.1, config.slo_eval_interval_s)
        while not self._stop.wait(interval):
            try:
                for ev in self._signals.evaluate_slos(time.time()):
                    self.pubsub.publish("SLO", ev["slo"], ev)
            except Exception:
                _metrics.count_loop_restart("head.slo_eval")

    def rpc_query_metrics(self, spec: dict):  # idempotent (read-only)
        """A windowed query against the history ring (``signals.
        SignalPlane.query``); ``{"ok": False, "error"}`` when the plane
        is disabled."""
        if self._signals is None:
            return {"ok": False, "error": "signal plane disabled"}
        return self._signals.query(spec)

    def rpc_slo_status(self):  # idempotent (read-only)
        if self._signals is None:
            return {"ok": False, "error": "signal plane disabled"}
        return {"ok": True, **self._signals.slo_status()}

    def rpc_register_slo(self, name: str, expr: str):
        if self._signals is None:
            return {"ok": False, "error": "signal plane disabled"}
        try:
            return {"ok": True,
                    "slo": self._signals.register_slo(name, expr)}
        except ValueError as e:
            return {"ok": False, "error": str(e)}

    def rpc_remove_slo(self, name: str):
        if self._signals is None:
            return {"ok": False, "error": "signal plane disabled"}
        return {"ok": True, "removed": self._signals.remove_slo(name)}

    def rpc_signal_top(self, window_s: float = 60.0):  # idempotent (read-only)
        """The cluster rollup (nodes, serving, training, SLOs), every
        number a ring query, and the trace plane's counts."""
        if self._signals is None:
            return {"ok": False, "error": "signal plane disabled"}
        out = {"ok": True, **self._signals.top_summary(float(window_s))}
        out["traces"] = self._traces.stats()
        with self._event_lock:
            out["traces"]["head_spans_dropped"] = self._spans_dropped
            out["traces"]["worker_spans_dropped"] = self._worker_span_drops
        return out

    # -- the failpoint and network chaos control plane -----------------------
    # The head arms the whole cluster: specs and rules fan out to every
    # alive agent, which fans them on to its live workers.

    def rpc_set_failpoints(self, specs: dict, include_workers: bool = True):
        """Arm/disarm failpoints everywhere (a falsy spec disarms).
        Returns {"head": armed, <node_id>: the agent's answer}."""
        out = {"head": failpoints.set_failpoints(specs)}
        for nid, client in self._alive_agents():
            try:
                out[nid] = client.call("set_failpoints", specs,
                                       include_workers, timeout=10.0)
            except Exception as e:
                out[nid] = {"error": repr(e)}
        return out

    def rpc_list_failpoints(self):  # idempotent (read-only)
        """Armed failpoints per process: {"head": {...}, <node_id>:
        {"agent": {...}, <worker_id>: {...}}}."""
        out = {"head": failpoints.list_armed()}
        for nid, client in self._alive_agents():
            try:
                out[nid] = client.call("list_failpoints", timeout=10.0)
            except Exception as e:
                out[nid] = {"error": repr(e)}
        return out

    def rpc_set_channel_chaos(self, rules: list, label: str = ""):
        """Arm network-chaos rules (wire-shaped dicts: action, src, dst,
        method, arg, prob, times) in every alive agent and its workers,
        then here. Returns the count armed per process."""
        out = {}
        for nid, client in self._alive_agents():
            try:
                out[nid] = client.call("set_channel_chaos", rules, label,
                                       timeout=10.0)
            except Exception as e:
                out[nid] = {"error": repr(e)}
        out["head"] = channel_chaos.add_rule_dicts(rules, label)
        return out

    def rpc_clear_channel_chaos(self, label: str | None = None):
        """Remove network-chaos rules everywhere (all, or one label)."""
        out = {"head": channel_chaos.clear(label)}
        for nid, client in self._alive_agents():
            try:
                out[nid] = client.call("clear_channel_chaos", label,
                                       timeout=10.0)
            except Exception as e:
                out[nid] = {"error": repr(e)}
        return out

    def rpc_list_channel_chaos(self):  # idempotent (read-only)
        """Rules per process: {"head": [...], <node_id>: {"agent": [...],
        <worker_id>: [...]}}."""
        out = {"head": channel_chaos.describe()}
        for nid, client in self._alive_agents():
            try:
                out[nid] = client.call("list_channel_chaos", timeout=10.0)
            except Exception as e:
                out[nid] = {"error": repr(e)}
        return out

    def rpc_partition(self, groups: list):
        """A network partition between groups of endpoints (node ids, or
        "head"): symmetric drop rules for every cross-group pair, armed
        in every process, so heartbeats, gossip, fan-outs and object
        traffic all see the cut. A node's group covers its workers'
        addresses too. ``rpc_heal`` removes it."""
        with self._lock:
            addr_of = {nid: n.address for nid, n in self._nodes.items()}
            client_of = {nid: n.client for nid, n in self._nodes.items()}
        addr_groups = []
        for group in groups:
            addrs = set()
            for member in group:
                if member == "head":
                    addrs.add(self.address)
                elif member in addr_of:
                    addrs.add(addr_of[member])
                    try:
                        addrs.update(client_of[member].call(
                            "worker_addresses", timeout=5.0))
                    except Exception:
                        pass  # the agent-level cut still holds
                elif ":" in member:
                    addrs.add(member)  # already a host:port address
                else:
                    raise ValueError(
                        f"unknown partition group member {member!r} "
                        f"(known node ids: {sorted(addr_of)} or 'head')")
            addr_groups.append(addrs)
        rules = []
        for i, a in enumerate(addr_groups):
            for b in addr_groups[i + 1:]:
                rules.append({"action": "drop", "src": sorted(a),
                              "dst": sorted(b), "label": "partition"})
                rules.append({"action": "drop", "src": sorted(b),
                              "dst": sorted(a), "label": "partition"})
        return self.rpc_set_channel_chaos(rules, label="partition")

    def rpc_heal(self):
        return self.rpc_clear_channel_chaos("partition")

    # -- lifecycle --------------------------------------------------------

    def rpc_ping(self):  # idempotent (read-only)
        return "pong"

    def rpc_event_stats(self):  # idempotent (read-only)
        """Per-RPC-handler timing stats (event_stats.h analog)."""
        return self._server.handler_stats()


    def stop(self):
        self._stop.set()
        with self._free_cv:
            self._free_cv.notify_all()
        # Dead head = dead loops: their restart series leave the scrape.
        _metrics.retract_loop_series(["head.free", "head.reserve_pg",
                                      "head.restore", "head.snapshot",
                                      "head.persist", "head.leak_sweep",
                                      "head.signal_scrape", "head.slo_eval"])
        self._stop_metrics_server()
        self._server.stop()
        with self._lock:
            nodes = list(self._nodes.values())
        for n in nodes:
            n.client.close()
        if self._store is not None:
            self._store.close()

    def crash(self) -> None:
        """Stop as a killed process would (``Cluster.kill_head``): no
        final snapshot or flush, the write-behind queue dropped, the
        listener and its connections closed."""
        self._stop.set()
        with self._free_cv:
            self._free_cv.notify_all()
        self._stop_metrics_server()
        self._server.stop()
        if self._store is not None:
            self._store.abandon()
        with self._lock:
            nodes = list(self._nodes.values())
        for n in nodes:
            n.client.close()

    def _stop_metrics_server(self) -> None:
        if self._metrics_shutdown is not None:
            try:
                self._metrics_shutdown()
            except Exception:
                pass
            self._metrics_shutdown = None
