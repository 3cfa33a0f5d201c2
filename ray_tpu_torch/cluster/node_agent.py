"""Node agent: per-node daemon (port of ``ray_tpu/cluster/node_agent.py``;
raylet equivalent).

Mirrors ``src/ray/raylet/node_manager.h``: owns the node's resources and
worker processes. Implements:

  * worker pool — Python worker processes (``python -m
    ray_tpu_torch.cluster.workerproc``), cached when idle
    (``worker_pool.h:80``); a dead worker's in-flight task is failed by
    storing an error object (the owner then retries);
  * local task dispatch — FIFO queue + blocking resource acquisition, the
    LocalTaskManager analog, over a ``ResourcePool`` that counts the
    node's CPUs and GPUs (``core/resources.py``);
  * placement-group bundle 2PC participant — prepare/commit/return
    (``node_manager.proto:375`` PrepareBundleResources/CommitBundleResources);
  * local object store — creates this node's C++ shm segment and serves
    object bytes to peer nodes (``ObjectManager::Push`` analog, pull-based):
    ``fetch_object_info`` (the data inline when it is small), one streamed
    request (``fetch_object``) or ranged chunks (``fetch_object_chunk``,
    for the parallel pulls), each from the store or, once the object is
    spilled, from its spill file;
  * spilling and restore (``local_object_manager.h`` analog): ``spill``
    moves cold primary copies no reader holds to the spill target
    (``spill_storage.py``: the node's own directory, or a shared
    ``spill_uri`` whose spills the head records) until the bytes asked
    for are free; a fetch of a spilled object restores it;
    ``restore_from_uri`` restores a dead node's object from a shared
    target;
  * the memory monitor (``memory_monitor.py``): under pressure the newest
    task's worker is killed and its task fails with
    ``OutOfMemoryError``;
  * heartbeats to the head with the live resource view
    (``gcs_heartbeat_manager.h``), and detection of worker and actor death;
  * drain (``DrainRaylet`` analog): the head's drain coordinator calls
    ``drain_self`` (no new leased work), polls ``drain_status`` until the
    node is quiet and detaches migrated actors' workers
    (``detach_actor_worker``); a preemption notice -- the configured
    ``preemption_signal_file`` naming this node's id, or the
    ``preemption_metadata_url`` answering ``TRUE`` -- or a first SIGTERM
    to a standalone agent (``python -m ray_tpu_torch.cluster.node_agent
    --head ADDR``; a second SIGTERM stops it) self-drains with reason
    ``"preemption"``. With ``cuda_visible_devices`` the node's workers
    start with ``CUDA_VISIBLE_DEVICES`` set to it (the card a simulated
    node stands for).

  * resource-view gossip (``ray_syncer.h`` analog): each agent bumps its
    own versioned load entry (what is available, the queue's depth; a
    draining node gossips nothing available) and exchanges views with
    ``gossip_fanout`` random peers every ``gossip_interval_s`` (the
    interval stretched with the peer count, at most 8x), merging by
    per-origin version; membership comes from the head every
    ``gossip_membership_every`` ticks, so a dead node leaves the view.
    ``peer_view`` is what a client's spillback reads (``client.py
    _spill_to_peers``);
  * the state API's node half: task records (PENDING at enqueue, RUNNING
    at dispatch, the worker's own record with its per-phase wall time
    when it ends; a bounded ring), the workers' event batches
    (``worker_events``: records, captured log lines forwarded to the
    head's ``worker_logs``, spans forwarded to the head with this node's
    id and the span drop count, device snapshots, and training goodput
    observations replayed into this registry; a resent batch is absorbed
    by its sequence number, so each step counts once), per-worker CPU,
    RSS and uptime from ``/proc`` (``worker_stats``, with each worker's
    last task and its phases), the workers' device snapshots
    (``device_stats``: the workers answer, the agent never makes a CUDA
    context), the store's per-object report with each object's
    attribution and the OOM-report index (``object_store_stats``), the
    clock probe against the head on every ``clock_probe_every_beats``-th
    heartbeat, and the OOM forensic report the memory monitor writes
    before a kill (``write_oom_report``: per-worker RSS, the store, its
    largest objects; its path rides the victim's death cause and the
    ``OOM_KILL`` event);
  * operating the node (``log_monitor.py`` and the reporter agent
    analog): each worker's raw stdout and stderr go to its own files
    under the node's log directory (``<tmp>/rtorch_wlogs_<session>_
    <node>``, which also holds the OOM reports and profile captures; the
    ``worker_log_retention`` newest workers keep theirs), served by
    ``list_worker_logs``, ``read_worker_log`` and the streamed
    ``follow_worker_log``; ``dump_worker_stack``, ``profile_worker`` and
    ``capture_profile`` (the worker writes its trace into the log
    directory, ``read_capture_file`` serves it in bounded reads; the 16
    newest captures are kept); ``metrics_text`` (this process's registry
    with the node's store gauges and the device gauges filled from the
    workers' snapshots, retracted when a worker or the node dies) for
    the head's ``/metrics/cluster``; and the failpoint and network chaos
    RPCs, fanned on to the live workers and re-applied to each worker
    that registers later.

A worker batch's failed tasks are published on the head's ``ERRORS``
channel as ``{node_id, pid, errors: [{task_id, name, error}]}``.

  * runtime envs (reference node_agent.py:122-132, 381-440, 540-623):
    idle pools keyed by ``env_key`` (a worker serves tasks and actors of
    the env it was started in, never another's), a worker spawned into an
    env with its packages materialized under the session's cache root
    (``runtime_env.ensure_local``), and, at the pool's cap with nothing
    idle in the asked env, an idle worker of another env retired (reaped
    first) to make room; prestart and replenish keep the plain pool only.
    An env that cannot be set up fails its task with "worker setup
    failed" (and its actor's creation). The agent pins
    ``ray_tpu_torch``'s package root on every worker's path.

A worker's Serve observations ride its event batch and replay into this
agent's registry (``serve/_observability.py:apply_events``, reference
:790-800); the gauges a dead worker's events made are retracted with its
other series (reference :2170-2181), so ``/metrics/cluster`` shows a
replica's series once, and never after it died.

Left out (ROADMAP A4c.6d): C++ workers.
"""

from __future__ import annotations

import collections
import os
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional

from ray_tpu_torch._native.shm_store import ShmStore, store_key
from ray_tpu_torch.cluster import spill_storage
from ray_tpu_torch.cluster.memory_monitor import MemoryMonitor
from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer, channel_chaos
from ray_tpu_torch.core import ids
from ray_tpu_torch.core.config import config
from ray_tpu_torch.core.object_ref import ObjectLostError
from ray_tpu_torch.core.resources import ResourcePool, default_node_resources
from ray_tpu_torch.util import failpoints
from ray_tpu_torch.util import metrics as _metrics

DEFAULT_STORE_CAPACITY = config.object_store_capacity_bytes
# Profile captures an agent keeps (with their trace files).
MAX_CAPTURES = 16


class _Worker:
    def __init__(self, worker_id, proc, address=None, env_key=""):
        self.worker_id = worker_id
        self.proc = proc
        self.address = address
        # The runtime env this process was started in ("" the plain one):
        # it serves tasks of that env only.
        self.env_key = env_key
        self.started_at = time.time()
        self.client: Optional[RpcClient] = None
        self.client_id: Optional[str] = None  # ref-table holder id
        self.ready = threading.Event()
        self.current_task = None  # (task_spec, release_fn) while executing
        self.is_actor = False
        self.actor_id = None


class NodeAgent:
    def __init__(
        self,
        head_address: str,
        *,
        num_cpus: float | None = None,
        num_gpus: float | None = None,
        resources: dict | None = None,
        store_capacity: int = DEFAULT_STORE_CAPACITY,
        host: str = "127.0.0.1",
        session: str | None = None,
        cuda_visible_devices: str | None = None,
        memory_usage_threshold: float | None = None,
        memory_limit_bytes: int | None = None,
    ):
        self.node_id = ids.new_node_id()
        # The cards this node's workers see (None: the host's, unmasked).
        self.cuda_visible_devices = cuda_visible_devices
        self.head_address = head_address
        # Reconnect window so a busy head doesn't fail in-flight
        # add_location/register calls from this agent.
        self.head = RpcClient(
            head_address, reconnect_window=config.head_reconnect_window_s)
        # CPUs and GPUs (A5: an explicit num_gpus, else the count torch
        # reports, read without creating a CUDA context), plus any
        # custom resources.
        node_res = default_node_resources(num_cpus, num_gpus)
        node_res.update(resources or {})
        self.pool = ResourcePool(node_res)
        self.total_resources = dict(node_res)
        session = session or f"s{os.getpid()}"
        # The port's own segment prefix (util/shm_sweep.py): the JAX
        # package's sweep must never match it, nor this sweep theirs.
        self.store_path = f"/dev/shm/rtorch_{session}_{self.node_id[-8:]}"
        self.store = ShmStore(self.store_path, store_capacity, create=True)
        # Spill target: the node's own directory (it dies with the node),
        # or the shared backend of ``spill_uri`` -- a mistyped URI fails
        # here, not at the first spill.
        self.spill_dir = os.path.join(
            tempfile.gettempdir(),
            f"rtorch_spill_{session}_{self.node_id[-8:]}")
        if config.spill_uri:
            self.spill_backend = spill_storage.backend_for(config.spill_uri)
        else:
            self.spill_backend = spill_storage.local_backend(self.spill_dir)
        self._spill_lock = threading.Lock()
        # Backends of other URIs a restore named (objects spilled under
        # another spill_uri), bounded.
        self._restore_backends: dict[str, spill_storage.SpillBackend] = {}
        # Spill and restore counters (rpc_store_stats): bytes written,
        # objects read back, denials, and the seconds each took.
        self._spill_stats = {"spilled_bytes_total": 0, "spills": 0,
                             "spill_s": 0.0, "spill_restores": 0,
                             "restored_bytes": 0, "restore_s": 0.0,
                             "spill_denied": 0}
        # What this agent served to pulls (rpc_fetch_stats): calls by
        # kind and data bytes by path (the reference's transfer counters,
        # with the bytes beside them), and for each recent parallel chunk
        # pull (by oid) the first and last chunk's wall time and its
        # bytes.
        self._fetch_stats = {"info": 0, "inline": 0, "streams": 0,
                             "chunks": 0, "inline_bytes": 0,
                             "stream_bytes": 0, "chunk_bytes": 0,
                             "spill_file_bytes": 0}
        self._chunk_pulls: "collections.OrderedDict[str, list]" = (
            collections.OrderedDict())
        self._deferred_deletes: set[str] = set()

        self._lock = threading.RLock()
        self._workers: dict[str, _Worker] = {}
        # Idle pools keyed by runtime env (``env_key``; "" the plain env),
        # as worker_pool.cc keys its pools by the runtime env's hash.
        self._idle: dict[str, list[_Worker]] = {}
        self._max_workers = max(
            config.worker_min_pool,
            int(node_res.get("CPU", 4)) * config.workers_per_cpu,
        )
        # Set BEFORE the dispatch thread starts: _checkout_worker touches
        # these, and a task can dispatch while __init__ is still running.
        self._prestart_target = 0
        self._replenish_evt = threading.Event()
        # Worker spawns decided but not yet registered in _workers: each
        # holds a pool slot from the decision on, so the checkout, the
        # replenisher and the prestarter never overfill the pool between
        # them (a runtime env's set-up can take a while).
        self._spawning = 0
        # The runtime envs' packages (and pip venvs) materialized on this
        # node, by content hash; one root a session, so the nodes of one
        # simulated cluster share it (``Cluster.shutdown`` removes it).
        # Made at the first env's worker.
        self._rtenv_cache_root = os.path.join(
            tempfile.gettempdir(), f"rtorch_rtenv_{session}")
        self._bundles: dict[tuple, ResourcePool] = {}
        self._task_queue: list[dict] = []
        self._queue_cv = threading.Condition(self._lock)
        # Draining (DrainRaylet analog): set by the head's drain
        # coordinator (or a preemption self-drain). A draining node
        # finishes what it has but admits no new leased pushes.
        self._draining = False
        self._drain_reason: Optional[str] = None
        # Specs popped from the queue but not yet bound to a worker
        # (acquiring resources / waiting for a fork).
        self._dispatch_inflight = 0
        # Demand of queued-or-acquiring tasks, not yet debited from the
        # pool: leased-push admission compares against available minus this.
        self._committed: dict[str, float] = {}
        self._shutdown = threading.Event()
        # Task ids cancelled before the dispatcher picked them up (covers
        # the queue→checkout window where a task is in neither place).
        # Ordered so the bound evicts oldest-first.
        self._cancelled_tasks: "collections.OrderedDict[str, bool]" = (
            collections.OrderedDict()
        )
        # Owner-directory clients, for pushing dead-worker error
        # locations straight to the owning client (bounded LRU).
        self._owner_clients: "collections.OrderedDict[str, RpcClient]" = (
            collections.OrderedDict()
        )
        # Task state records for the state API (GetTasksInfo analog):
        # PENDING on enqueue, RUNNING on dispatch, final state from the
        # worker's batched event reports.
        self._task_records: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict()
        )
        self._task_records_cap = max(16, config.task_record_retention)
        # (worker_id, pid) -> last applied event-batch sequence number.
        self._event_seqs: "collections.OrderedDict[tuple, int]" = (
            collections.OrderedDict()
        )
        # worker_id -> the worker's latest device snapshot / its last
        # finished task {name, state, phases}.
        self._device_stats: dict[str, dict] = {}
        self._last_task: dict[str, dict] = {}
        # Node reporter: the latest per-worker sample, the cpu-tick base
        # of each worker, and the gauge series exported (retracted when
        # the worker dies or the agent stops). One sampler at a time.
        self._worker_stats: dict[str, dict] = {}
        self._cpu_prev: dict[str, tuple] = {}
        self._exported_gauges: set = set()
        self._telemetry_lock = threading.Lock()
        self._last_sample = 0.0
        # The node's log directory: each worker's stdout/stderr files,
        # the OOM reports and the profile captures. The index keeps dead
        # workers' logs reachable for post-mortems (bounded by
        # worker_log_retention).
        self.log_dir: Optional[str] = os.path.join(
            tempfile.gettempdir(),
            f"rtorch_wlogs_{session}_{self.node_id[-8:]}")
        try:
            os.makedirs(self.log_dir, exist_ok=True)
        except OSError:
            self.log_dir = None  # degrade: workers inherit our streams
        self._worker_logs: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        # Profile captures by id: manifest and directory (MAX_CAPTURES).
        self._captures: "collections.OrderedDict[str, dict]" = (
            collections.OrderedDict())
        # OOM forensics: the bounded index of pre-kill reports, written
        # under the log directory.
        self._oom_reports: list[dict] = []
        # worker_id -> the goodput gauge keys its events made (retracted
        # when it dies); the device gauge children exported; the store's
        # exported eviction count and whether its gauges exist.
        self._train_gauges: dict[str, set] = {}
        # worker_id -> the Serve gauge keys its events made (the replica's
        # ongoing gauge, a router's queue depth, the reconcile gauge).
        self._serve_gauges: dict[str, set] = {}
        self._exported_device: set = set()
        self._evictions_exported = 0
        self._store_gauges_exported = False
        # The failpoints and chaos rules armed on this node's workers,
        # re-applied to each worker that registers later.
        self._worker_failpoints: dict[str, str] = {}
        self._worker_channel_rules: list[dict] = []
        # Resource-view gossip (ray_syncer.h:88): membership from the
        # head, load node<->node by versioned anti-entropy push-pull.
        self._cluster_view: dict[str, dict] = {}
        self._view_version = 0
        self._gossip_clients: "collections.OrderedDict[str, RpcClient]" = (
            collections.OrderedDict()
        )

        self._server = RpcServer(self, host)
        self.address = self._server.address
        # Chaos source identity: node-keyed rules (partitions) match this
        # agent's outbound calls.
        self.head.chaos_src = self.address
        self.head.call(
            "register_node", self.node_id, self.address,
            self.total_resources, self.store_path,
        )
        threading.Thread(target=self._heartbeat_loop, daemon=True).start()
        threading.Thread(target=self._dispatch_loop, daemon=True).start()
        # Kept joinable: stop() waits the reaper out before detaching the
        # shm store (its release_dead on a detached segment is a crash).
        self._reap_thread = threading.Thread(
            target=self._reap_loop, daemon=True)
        self._reap_thread.start()
        if config.worker_telemetry_interval_s > 0:
            threading.Thread(target=self._telemetry_loop, daemon=True).start()
        if config.gossip_interval_s > 0:
            threading.Thread(target=self._gossip_loop, daemon=True).start()
        if config.preemption_poll_interval_s > 0 and (
                config.preemption_signal_file
                or config.preemption_metadata_url):
            threading.Thread(
                target=self._preemption_watcher, daemon=True).start()
        # OOM protection (memory_monitor.h / worker_killing_policy.h):
        # under pressure the newest task's worker is killed.
        self.memory_monitor = MemoryMonitor(
            self, usage_threshold=memory_usage_threshold,
            limit_bytes=memory_limit_bytes)
        self.memory_monitor.start()
        # The store gauges exist from boot (the telemetry loop and each
        # scrape refresh them).
        try:
            self._export_store_gauges()
        except Exception:
            pass
        # Prestart plain-env workers, worker_prestart_per_cpu a CPU
        # (reference: worker_pool.cc PrestartWorkers), so a first burst
        # doesn't serialize behind interpreter cold starts.
        n_prestart = min(
            int(config.worker_prestart_per_cpu
                * self.total_resources.get("CPU", 0.0)),
            self._max_workers,
        )
        self._prestart_target = n_prestart
        if n_prestart > 0:
            threading.Thread(
                target=self._prestart_workers, args=(n_prestart,),
                daemon=True,
            ).start()
            # Keep the pool warm for the REST of the node's life: actor
            # creations consume idle workers permanently (dedicated
            # processes), so without replenishment the Nth actor
            # cold-forks again.
            threading.Thread(
                target=self._replenish_loop, daemon=True).start()

    def _replenish_loop(self) -> None:
        while not self._shutdown.is_set():
            if not self._replenish_evt.wait(1.0):
                continue  # not signaled: only checkout demand replenishes
            if self._shutdown.is_set():
                return
            self._replenish_evt.clear()
            while not self._shutdown.is_set():
                with self._lock:
                    idle = len(self._idle.get("", []))
                    need = (idle < self._prestart_target
                            and self._n_poolable_locked() < self._max_workers)
                    if need:
                        self._spawning += 1
                if not need:
                    break
                try:
                    w = self._spawn_reserved()
                    if w.ready.wait(config.worker_start_timeout_s):
                        self._return_worker(w)
                    else:
                        break
                except (OSError, RuntimeError):
                    break  # replenish is an optimization, never fatal

    def _prestart_workers(self, n: int) -> None:
        # Deferred + serialized: a cluster booting many agents at once must
        # not fork an interpreter storm that starves node registration;
        # each fork waits for the previous worker to come up, and demand
        # that arrives meanwhile shrinks what's left to prestart.
        self._shutdown.wait(config.worker_prestart_delay_s)
        for _ in range(n):
            if self._shutdown.is_set():
                return
            with self._lock:
                idle = sum(len(v) for v in self._idle.values())
                live = self._spawning + len([
                    w for w in self._workers.values()
                    if w.proc.poll() is None])
                if idle >= n or live >= self._max_workers:
                    return
                self._spawning += 1
            try:
                w = self._spawn_reserved()
                if w.ready.wait(config.worker_start_timeout_s):
                    self._return_worker(w)
            except (OSError, RuntimeError):
                return  # prestart is an optimization, never fatal
            # Space the forks out: N agents' prestarts otherwise
            # compress into one interpreter storm exactly when a cluster
            # boot needs the CPU.
            if self._shutdown.wait(config.worker_prestart_spacing_s):
                return

    # -- worker pool ------------------------------------------------------

    def _n_poolable_locked(self) -> int:
        """Live poolable (non-actor) workers and the spawns in flight."""
        return self._spawning + sum(
            1 for w in self._workers.values()
            if w.proc.poll() is None and not w.is_actor)

    def _spawn_reserved(self, env_key: str = "",
                        resolved_env: dict | None = None) -> _Worker:
        """``_spawn_worker`` for a caller that took a slot
        (``_spawning``) under the lock; the slot is the new worker's once
        it is registered, and given back if the spawn fails."""
        try:
            return self._spawn_worker(env_key, resolved_env)
        finally:
            with self._lock:
                self._spawning -= 1

    def _worker_pythonpath(self, prior: str, env_paths=()) -> str:
        """The worker's PYTHONPATH: a runtime env's own paths (its
        py_modules and working_dir, which shadow the rest), this package's
        root, then the code search path of the process that runs this
        agent (its ``sys.path`` entries outside the interpreter's own
        prefix -- the driver's script directory, a test directory pytest
        put there), then the inherited PYTHONPATH. Functions travel by
        reference (``core/serialization.py``), so whatever the driver can
        import by name the worker must reach the same way. Entries
        matching ``worker_pythonpath_exclude`` are stripped: a site hook
        that pre-imports jax at interpreter start must not load it into a
        port worker. The JAX package's root is never pinned."""
        import ray_tpu_torch as _pkg

        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(_pkg.__file__)))
        prefixes = tuple({sys.prefix, sys.base_prefix, sys.exec_prefix})
        search = [p for p in sys.path
                  if p and os.path.isdir(p) and not p.startswith(prefixes)
                  and "-packages" not in p]
        exclude = [x for x in config.worker_pythonpath_exclude.split(",")
                   if x]
        paths = [*env_paths, pkg_root, *search,
                 *(prior.split(os.pathsep) if prior else [])]
        out: list[str] = []
        for p in paths:
            p = os.path.abspath(p)
            if p in out or any(x in p for x in exclude):
                continue
            out.append(p)
        return os.pathsep.join(out)

    def _spawn_worker(self, env_key: str = "",
                      resolved_env: dict | None = None) -> _Worker:
        """Start a worker process in the plain env, or in ``resolved_env``
        (reference node_agent.py:381-440): its packages are materialized
        on this node first (``runtime_env.ensure_local``, cached by
        content hash), then baked into the process -- the env vars into
        its environment, py_modules and the working_dir onto its
        PYTHONPATH, the working_dir as its cwd, a pip env's venv
        interpreter as its python. A set-up that fails raises
        ``RuntimeError``, which fails the task with "worker setup
        failed"."""
        worker_id = "w-" + os.urandom(6).hex()
        env = dict(os.environ)
        cwd, python, env_paths = None, sys.executable, []
        if resolved_env is not None:
            from ray_tpu_torch._private import runtime_env as rtenv

            try:
                os.makedirs(self._rtenv_cache_root, exist_ok=True)
                recipe = rtenv.ensure_local(
                    resolved_env, lambda k: self.head.call("kv_get", k),
                    self._rtenv_cache_root)
            except Exception as e:  # noqa: BLE001 -- the task's error
                raise RuntimeError(f"{type(e).__name__}: {e}") from e
            env.update(recipe["env_vars"])
            cwd, env_paths = recipe["cwd"], recipe["py_paths"]
            python = recipe["python"] or python
        env["RAY_TPU_TORCH_NODE_ID"] = self.node_id
        env["RAY_TPU_TORCH_WORKER_ID"] = worker_id
        env["PYTHONPATH"] = self._worker_pythonpath(
            env.get("PYTHONPATH", ""), env_paths)
        if self.cuda_visible_devices is not None:
            env["CUDA_VISIBLE_DEVICES"] = self.cuda_visible_devices
        # Unbuffered: a captured log file is as current as the worker's
        # last write (what follow_worker_log tails).
        env["PYTHONUNBUFFERED"] = "1"
        # Log capture: the process's raw stdout/stderr land in files the
        # log RPCs serve (the event batch's line tee to the head is apart
        # from it); without a log directory it inherits ours.
        out_path = err_path = out_f = err_f = None
        if self.log_dir is not None:
            try:
                out_path = os.path.join(self.log_dir, f"{worker_id}.out")
                err_path = os.path.join(self.log_dir, f"{worker_id}.err")
                out_f = open(out_path, "ab")
                err_f = open(err_path, "ab")
            except OSError:
                if out_f is not None:
                    out_f.close()
                out_path = err_path = out_f = err_f = None
        try:
            proc = subprocess.Popen(
                [
                    python, "-m", "ray_tpu_torch.cluster.workerproc",
                    "--head", self.head_address,
                    "--agent", self.address,
                    "--node-id", self.node_id,
                    "--store", self.store_path,
                    "--worker-id", worker_id,
                ],
                env=env, cwd=cwd, stdout=out_f, stderr=err_f,
            )
        finally:
            # Popen holds its own descriptors.
            for f in (out_f, err_f):
                if f is not None:
                    f.close()
        w = _Worker(worker_id, proc, env_key=env_key)
        evicted = []
        with self._lock:
            self._workers[worker_id] = w
            if out_path is not None:
                self._worker_logs[worker_id] = {
                    "worker_id": worker_id,
                    "node_id": self.node_id,
                    "pid": proc.pid,
                    "stdout_path": out_path,
                    "stderr_path": err_path,
                    "started_at": w.started_at,
                    "ended_at": None,
                }
                while len(self._worker_logs) > config.worker_log_retention:
                    evicted.append(self._worker_logs.popitem(last=False)[1])
        for old in evicted:
            for path in (old["stdout_path"], old["stderr_path"]):
                try:
                    os.unlink(path)
                except OSError:
                    pass
        return w

    def rpc_register_worker(self, worker_id, address, client_id=None):
        with self._lock:
            w = self._workers.get(worker_id)
            if w is None:
                return False
            w.address = address
            w.client_id = client_id  # its holder id in the head's ref table
            w.client = RpcClient(address)
            w.client.chaos_src = self.address
            armed = dict(self._worker_failpoints)
            chan_rules = list(self._worker_channel_rules)
        # A worker forked after an arm inherits the node's table before it
        # is ready, so no task reaches an unarmed worker.
        if armed:
            try:
                w.client.call("set_failpoints", armed, timeout=5.0)
            except Exception:
                pass
        if chan_rules:
            try:
                w.client.call("set_channel_chaos", chan_rules, "",
                              timeout=5.0)
            except Exception:
                pass
        w.ready.set()
        return True

    def _checkout_worker(self, timeout: float | None = None,
                         env_key: str = "",
                         resolved_env: dict | None = None,
                         dedicated: bool = False) -> _Worker:
        """An idle worker of the SAME runtime env, or a fresh one spawned
        into it (lease grant, ``PopWorker`` analog; reference
        node_agent.py:540-617). ``dedicated`` (actor creation) bypasses
        the pool cap: an actor keeps its process for life, so counting it
        against the task pool would let N long-lived actors starve every
        future task on the node — the reference's worker pool likewise
        caps only poolable workers. At the cap with nothing idle in this
        env, an idle worker of another env is retired to make room."""
        if timeout is None:
            timeout = config.worker_start_timeout_s
        with self._lock:
            pool = self._idle.get(env_key)
            if pool:
                w = pool.pop()
                if dedicated and env_key == "":
                    # The actor keeps this process for life: top the
                    # plain pool back up in the background.
                    self._replenish_evt.set()
                return w
            if env_key == "":
                self._replenish_evt.set()  # pool empty: warm it for next
            can_spawn = dedicated or \
                self._n_poolable_locked() < self._max_workers
            victim = None
            if not can_spawn:
                # Otherwise a node whose slots filled with (now idle)
                # workers of one env could never serve another env's
                # task: an idle worker holds no resource the task's
                # acquire would wait for, only its process slot.
                victim = next((w for key, lst in self._idle.items()
                               if key != env_key for w in lst), None)
                if victim is not None:
                    self._idle[victim.env_key].remove(victim)
                    self._workers.pop(victim.worker_id, None)
                    can_spawn = True
            if can_spawn:
                self._spawning += 1
        if victim is not None:
            # Reaped before its replacement starts: a worker that ran a
            # GPU task holds a CUDA context and its cached device memory
            # until it exits, and the new worker may need them.
            self._on_worker_failure(
                victim, "retired: an idle worker of another runtime env",
                requeued=True)
        if can_spawn:
            w = self._spawn_reserved(env_key, resolved_env)
        else:
            # Every slot is BUSY: wait for one of this env's workers to
            # come back (or for capacity to free via task turnover).
            deadline = time.monotonic() + timeout
            while True:
                with self._lock:
                    pool = self._idle.get(env_key)
                    if pool:
                        w = pool.pop()
                        break
                    if self._n_poolable_locked() < self._max_workers:
                        can_spawn = True
                        self._spawning += 1
                        break
                if time.monotonic() > deadline:
                    raise TimeoutError("no worker became available")
                time.sleep(0.005)
            if can_spawn:
                w = self._spawn_reserved(env_key, resolved_env)
        if not w.ready.wait(timeout):
            raise TimeoutError(f"worker {w.worker_id} failed to start")
        return w

    def _return_worker(self, w: _Worker):
        with self._lock:
            if w.proc.poll() is None and not w.is_actor:
                w.current_task = None
                self._idle.setdefault(w.env_key, []).append(w)

    # -- task dispatch ----------------------------------------------------

    def rpc_submit_task(self, spec: dict):  # idempotent
        """Enqueue a task; the dispatcher leases a worker when resources
        allow. Returns immediately (results flow through the store).

        Idempotent under the task model's own contract: a replayed
        plain-task enqueue re-executes a task lineage recovery is
        allowed to re-run anyway (results land by oid, last-write-
        wins), and a replayed ACTOR push dedups at the actor's single
        worker (``_is_duplicate_push`` — exactly-once per
        incarnation)."""
        self._record_task(spec, "PENDING")
        self._requeue(spec)
        return True

    def _requeue(self, spec: dict) -> None:
        """The one queue-admission sequence (commit + enqueue + notify) —
        submit, checkout-timeout retry, and dispatch-failure retry must
        all account identically."""
        with self._queue_cv:
            self._commit_locked(spec)
            self._task_queue.append(spec)
            self._queue_cv.notify()

    def rpc_submit_tasks(self, specs: list):
        """Head-placed batch enqueue: one RPC, one queue notify."""
        for spec in specs:
            self._record_task(spec, "PENDING")
        with self._queue_cv:
            for spec in specs:
                self._commit_locked(spec)
            self._task_queue.extend(specs)
            self._queue_cv.notify()
        return True

    def rpc_submit_tasks_leased(self, specs: list):
        """Direct (head-bypassing) submission under a client-held
        scheduling-key lease — the decentralized half of lease pipelining
        (reference: leased-worker task pushes, direct_task_transport.cc).
        This node is NOT obligated to accept: a spec is admitted only if
        its demand fits the node's UNCOMMITTED capacity (available minus
        everything already queued), so a leased burst can never pile up
        behind running tasks while other nodes sit idle — overflow spills
        back through the head, which still balances the cluster. Returns
        the list of REJECTED indices; the client reschedules those through
        the head and drops its lease."""
        rejected = []
        accepted = []
        with self._queue_cv:
            if self._draining:
                # A draining node takes no new work: the client's leased
                # burst spills back through the head, which excludes us.
                return list(range(len(specs)))
            avail = self.pool.available()
            for k, v in self._committed.items():
                avail[k] = avail.get(k, 0.0) - v
            for i, spec in enumerate(specs):
                demand = spec["demand"]
                if all(avail.get(k, 0.0) >= v for k, v in demand.items()):
                    for k, v in demand.items():
                        avail[k] = avail.get(k, 0.0) - v
                    self._commit_locked(spec)
                    accepted.append(spec)
                else:
                    rejected.append(i)
            self._task_queue.extend(accepted)
            self._queue_cv.notify()
        for spec in accepted:
            self._record_task(spec, "PENDING")
        return rejected

    # -- queued-demand accounting (admission control for leased pushes) ----

    def _commit_locked(self, spec: dict) -> None:
        """Caller holds self._lock. PG tasks draw on bundle capacity (carved
        out of the pool at prepare time), not on free node capacity."""
        if spec.get("pg_id") is not None:
            return
        for k, v in spec.get("demand", {}).items():
            self._committed[k] = self._committed.get(k, 0.0) + v

    def _uncommit(self, spec: dict) -> None:
        """After the dispatcher's acquire resolves (either way), the demand
        is reflected in (or irrelevant to) pool availability."""
        if spec.get("pg_id") is not None:
            return
        with self._lock:
            for k, v in spec.get("demand", {}).items():
                n = self._committed.get(k, 0.0) - v
                if n <= 1e-9:
                    self._committed.pop(k, None)
                else:
                    self._committed[k] = n

    # -- task state records (state API) -----------------------------------

    def _task_key(self, spec: dict) -> str:
        return spec.get("task_id") or spec.get("oids", ["?"])[0]

    def _record_task(self, spec: dict, state: str):
        rec = {
            "task_id": self._task_key(spec),
            "name": spec.get("fname") or spec.get("method")
            or spec.get("class_name", "task"),
            "type": "ACTOR_CREATION_TASK" if spec.get("actor_create")
            else "NORMAL_TASK",
            "state": state,
            "submitted_at": time.time(),
            "start_time": None,
            "end_time": None,
            "error": None,
        }
        evicted = False
        with self._lock:
            old = self._task_records.get(rec["task_id"])
            if old is not None:
                if state in ("PENDING", "RUNNING") and \
                        old.get("state") in ("FINISHED", "FAILED",
                                             "CANCELLED"):
                    # A duplicate delivery of an already-settled task
                    # must not regress its terminal record.
                    return
                old["state"] = state
                return
            if len(self._task_records) >= self._task_records_cap:
                self._task_records.popitem(last=False)
                evicted = True
            self._task_records[rec["task_id"]] = rec
        if evicted:
            _metrics.TASK_RECORDS_EVICTED.inc(tags={"node_id": self.node_id})

    def rpc_worker_events(self, worker_id, pid, task_events,  # idempotent
                          log_lines=None, spans=None, device=None,
                          train=None, seq=None, dropped=None,
                          serve=None):
        """A worker's batched report: its task records (timings, outcome,
        per-phase wall ns), its captured stdout/stderr lines (forwarded to
        the head's log ring and ``LOGS`` channel), finished spans
        (forwarded to the head's trace store with this node's id, for its
        clock offset) with the span drop count, an optional device
        snapshot, and training goodput and Serve observations (replayed
        into THIS registry, the one the head federates; a worker's own is
        never scraped).

        Idempotent per (worker, pid, seq): a batch resent after a lost
        reply is absorbed here, so no observation counts twice."""
        if self._is_duplicate_event_batch(worker_id, pid, seq):
            return True
        if serve:
            from ray_tpu_torch.serve import _observability as _serve_obs

            keys = _serve_obs.apply_events(serve, node_id=self.node_id,
                                           worker=worker_id)
            if keys:
                with self._lock:
                    self._serve_gauges.setdefault(worker_id,
                                                  set()).update(keys)
        if train:
            from ray_tpu_torch.util import goodput as _goodput

            keys = _goodput.apply_events(train, node_id=self.node_id)
            if keys:
                with self._lock:
                    self._train_gauges.setdefault(worker_id,
                                                  set()).update(keys)
        for rec in task_events:
            for phase, ns in (rec.get("phases") or {}).items():
                _metrics.TASK_PHASE_SECONDS.observe(
                    ns / 1e9, tags={"node_id": self.node_id, "phase": phase})
        evicted = 0
        with self._lock:
            if device is not None:
                self._device_stats[worker_id] = device
            for rec in task_events:
                old = self._task_records.get(rec["task_id"])
                if old is not None and rec.get("submitted_at") is None:
                    # The agent saw the submit; the worker only the run.
                    rec["submitted_at"] = old.get("submitted_at")
                if old is None and \
                        len(self._task_records) >= self._task_records_cap:
                    self._task_records.popitem(last=False)
                    evicted += 1
                self._task_records[rec["task_id"]] = rec
                self._last_task[worker_id] = {
                    "task_id": rec["task_id"], "name": rec.get("name"),
                    "state": rec.get("state"),
                    "phases": dict(rec.get("phases") or {}),
                }
        if evicted:
            _metrics.TASK_RECORDS_EVICTED.inc(
                evicted, tags={"node_id": self.node_id})
        if log_lines:
            try:
                self.head.call("worker_logs", self.node_id, pid, log_lines,
                               worker_id, timeout=10.0)
            except Exception:
                pass  # the head is restarting: the lines are in the file
        if spans or dropped:
            try:
                self.head.call("report_spans", spans or [], self.node_id,
                               dropped=dropped or 0, timeout=10.0)
            except Exception:
                pass  # the head is restarting: spans are best-effort
        failed = [r for r in task_events if r.get("state") == "FAILED"]
        if failed:
            # Pushed task errors (reference node_agent.py:859-872): the
            # batch's failed tasks, on the head's ERRORS channel.
            try:
                self.head.call("publish", "ERRORS", self.node_id, {
                    "node_id": self.node_id, "pid": pid,
                    "errors": [{"task_id": r["task_id"],
                                "name": r.get("name"),
                                "error": r.get("error")} for r in failed],
                }, timeout=10.0)
            except Exception:
                pass  # the head is restarting: the feed is best-effort
        return True

    def _is_duplicate_event_batch(self, worker_id, pid, seq) -> bool:
        """Record-and-test a worker event batch's sequence number, keyed
        by (worker_id, pid) so a restarted worker's fresh numbering never
        collides with its previous incarnation's."""
        if seq is None:
            return False
        key = (worker_id, pid)
        with self._lock:
            last = self._event_seqs.get(key)
            if last is not None and seq <= last:
                return True
            self._event_seqs[key] = seq
            self._event_seqs.move_to_end(key)
            while len(self._event_seqs) > 4096:
                self._event_seqs.popitem(last=False)
        return False

    def rpc_list_task_records(self, limit: int = 1000):  # idempotent (read-only)
        with self._lock:
            return [dict(r) for r in list(self._task_records.values())[-limit:]]

    def _dispatch_loop(self):
        while not self._shutdown.is_set():
            with self._queue_cv:
                while not self._task_queue and not self._shutdown.is_set():
                    self._queue_cv.wait(0.5)
                if self._shutdown.is_set():
                    return
                spec = self._task_queue.pop(0)
                self._dispatch_inflight += 1
            threading.Thread(
                target=self._dispatch_tracked, args=(spec,), daemon=True
            ).start()

    def _dispatch_tracked(self, spec: dict):
        try:
            self._dispatch_one(spec)
        finally:
            with self._lock:
                self._dispatch_inflight -= 1

    def _bundle_pool(self, spec) -> Optional[ResourcePool]:
        pg_id, idx = spec.get("pg_id"), spec.get("bundle_index", -1)
        if pg_id is None:
            return None
        with self._lock:
            if idx >= 0:
                return self._bundles.get((pg_id, idx))
            for (p, _i), pool in self._bundles.items():
                if p == pg_id and pool.feasible(spec.get("demand", {})):
                    return pool
        return None

    def _consume_cancel(self, task_id) -> bool:
        with self._lock:
            if task_id is not None and task_id in self._cancelled_tasks:
                self._cancelled_tasks.pop(task_id, None)
                return True
        return False

    def _dispatch_one(self, spec: dict):
        if self._consume_cancel(spec.get("task_id")):
            self._uncommit(spec)
            self._cancel_spec(spec)
            return
        demand = spec.get("demand", {})
        pool = self.pool
        if spec.get("pg_id") is not None:
            deadline = time.monotonic() + 60.0
            while True:
                bp = self._bundle_pool(spec)
                if bp is not None and bp.try_acquire(demand):
                    pool = bp
                    acquired = True
                    break
                if time.monotonic() > deadline:
                    self._fail_task(spec, "placement group bundle unavailable")
                    return
                time.sleep(0.01)
        else:
            acquired = pool.acquire(demand, timeout=300.0)
            self._uncommit(spec)  # demand now reflected in pool (or failed)
        if not acquired:
            self._fail_task(spec, f"resources {demand} unavailable")
            return
        try:
            rtenv = spec.get("runtime_env")
            w = self._checkout_worker(
                env_key=(rtenv or {}).get("env_key", ""),
                resolved_env=rtenv,
                dedicated=bool(spec.get("actor_create")))
        except (TimeoutError, RuntimeError, OSError) as e:
            pool.release(demand)
            if isinstance(e, TimeoutError) and \
                    spec.setdefault("_checkout_misses", 0) < 2:
                # No worker became available in time — transient under
                # load (interpreter cold starts on a saturated host are
                # unbounded). Requeue rather than fail: the reference's
                # lease request simply stays queued in this situation.
                spec["_checkout_misses"] += 1
                self._requeue(spec)
                return
            # RuntimeError/OSError: the worker could not be spawned or
            # its runtime env not set up (a missing package, a bad zip, a
            # failed pip install) — surfaced as the task's error, as the
            # reference's runtime-env set-up failures are.
            if isinstance(e, TimeoutError):
                self._fail_task(
                    spec,
                    f"no worker became available after "
                    f"{spec.get('_checkout_misses', 0) + 1} attempts of "
                    f"{config.worker_start_timeout_s:.0f}s (node "
                    f"saturated?)")
            else:
                reason = f"worker setup failed: {e}"
                if spec.get("actor_create"):
                    # The actor never starts: its callers fail now, not
                    # after the registration timeout.
                    try:
                        self.head.call("register_actor_failed",
                                       spec["actor_id"], reason)
                    except Exception:
                        pass
                self._fail_task(spec, reason)
            return
        self._record_task(spec, "RUNNING")
        w.current_task = {
            "spec": spec, "pool": pool, "demand": demand, "released": False,
            "started_at": time.monotonic(),
        }
        # A cancel that raced the queue→checkout window parked its id in
        # the cancelled set; honor it now that the task is attributable.
        if not spec.get("actor_create") and self._consume_cancel(
                spec.get("task_id")):
            self._release_current(w)
            self._return_worker(w)
            self._cancel_spec(spec)
            return
        try:
            if spec.get("actor_create"):
                w.is_actor = True
                w.actor_id = spec["actor_id"]
                w.client.call("create_actor", spec)
                try:
                    self.head.call(
                        "register_actor", spec["actor_id"], self.node_id,
                        w.address, spec.get("class_name", "Actor"),
                        spec.get("name"),
                    )
                except ValueError as e:
                    # Registration refused (name conflict, or the actor was
                    # killed while starting): record the death for callers
                    # and retire the worker — it already constructed state.
                    self._release_current(w)
                    w.is_actor = False
                    w.actor_id = None
                    try:
                        self.head.call(
                            "register_actor_failed", spec["actor_id"], str(e)
                        )
                    except Exception:
                        pass
                    w.proc.kill()
            else:
                if w.client.call("push_task", spec) is False:
                    # Duplicate admission: this worker process already
                    # accepted the same task id (a retried push whose
                    # first delivery lost only its reply). The first
                    # copy owns the task's fate — just release this
                    # dispatch's lease and return the worker.
                    with self._lock:
                        self._release_current(w)
                        w.current_task = None
                    self._return_worker(w)
        except Exception as e:  # worker died between checkout and push
            # The task never STARTED on the corpse, so retrying with a
            # fresh worker is always safe (unlike a mid-execution death,
            # which _on_worker_failure handles with retry budgets). A
            # pooled worker can die in this window legitimately: its
            # agent-death watchdog fires under extreme load, an operator
            # kills the pid.
            # CLAIM the task atomically against the reap loop: whoever
            # pops current_task owns the spec's fate — without this, the
            # reaper could fail the refs while we requeue (spurious error
            # + duplicate execution).
            with self._lock:
                current = w.current_task
                w.current_task = None
            if current is not None and not current["released"]:
                current["released"] = True
                current["pool"].release(current["demand"])
            retries = spec.setdefault("_dispatch_retries", 0)
            if current is None:
                # The reaper claimed it first and already settled the
                # task's fate; just make sure the corpse is cleaned up.
                self._on_worker_failure(w, f"dispatch failed: {e}",
                                        requeued=True)
            elif current.get("cancelled"):
                # A force-cancel killed the worker in this very window:
                # the task's fate is TaskCancelledError, never a retry
                # (the cancel marker was consumed; a requeue would run
                # a cancelled task to completion).
                self._on_worker_failure(w, f"dispatch failed: {e}",
                                        requeued=True)
                self._cancel_spec(spec)
            elif not spec.get("actor_create") and retries < 2:
                spec["_dispatch_retries"] = retries + 1
                self._requeue(spec)
                self._on_worker_failure(w, f"dispatch failed: {e}",
                                        requeued=True)
            else:
                self._on_worker_failure(w, f"dispatch failed: {e}")
                self._fail_task(spec, f"worker died: dispatch failed: {e}")

    @staticmethod
    def _release_current(w: _Worker):
        current = w.current_task
        if current is not None and not current["released"]:
            current["released"] = True
            current["pool"].release(current["demand"])

    def rpc_task_done(self, worker_id):  # idempotent
        """Worker finished its current task; release + return to pool.

        Replay-absorbing: a worker whose task-done ACK was severed
        retries, and the second delivery must be a no-op — without the
        guard the replay appended the worker to the idle pool TWICE,
        and the dispatcher could lease one process for two concurrent
        tasks. The claim is taken ATOMICALLY under the lock (a pure
        current_task check would race a concurrent replay still
        between the check and the idle-pool append)."""
        with self._lock:
            w = self._workers.get(worker_id)
            current = w.current_task if w is not None else None
            if w is None or current is None or current.get("_done"):
                return False  # unknown worker, or a replayed done
            current["_done"] = True  # first delivery owns the return
        self._release_current(w)
        self._return_worker(w)
        return True

    def rpc_task_blocked(self, worker_id):
        """The worker's task is blocked in get(): free its resources so
        other (possibly nested) tasks can run (raylet parity for workers
        blocked in ray.get)."""
        with self._lock:
            w = self._workers.get(worker_id)
        if w is not None:
            self._release_current(w)
        return True

    def rpc_task_unblocked(self, worker_id):
        with self._lock:
            w = self._workers.get(worker_id)
        if w is None or w.current_task is None:
            return False
        current = w.current_task
        if current["released"]:
            current["pool"].acquire(current["demand"],
                                    timeout=config.cpu_reacquire_budget_s)
            current["released"] = False
        return True

    def _end_borrows(self, spec: dict):
        """Release the task's in-flight arg borrows on its behalf (the
        worker that would normally report task end is gone)."""
        if spec.get("borrowed") and spec.get("task_id"):
            try:
                self.head.call("ref_task_end", spec["task_id"])
            except Exception:
                pass

    def _fail_task(self, spec: dict, reason: str):
        from ray_tpu_torch.core.object_ref import TaskError

        err = TaskError(spec.get("fname", "task"), reason, reason)
        self._store_task_error(spec, err, "FAILED")

    def _cancel_spec(self, spec: dict):
        from ray_tpu_torch.core.object_ref import TaskCancelledError

        err = TaskCancelledError(spec.get("fname", "task"))
        self._store_task_error(spec, err, "CANCELLED")

    def _store_task_error(self, spec: dict, err: Exception,
                          state: str = "FAILED"):
        from ray_tpu_torch.core import serialization as ser

        self._record_task(spec, state)
        self._end_borrows(spec)
        meta, chunks = ser.serialize(err)
        owner = spec.get("owner_addr")
        for oid in spec["oids"]:
            try:
                self.store.put(oid, chunks, b"E" + meta)
            except Exception:
                continue
            try:
                self.head.call("add_location", oid, self.node_id,
                               is_error=True, owner_addr=owner or "")
            except Exception:
                # Head unreachable (shutdown): the owner notify below still unblocks the owner directly, and
                # the owner's lineage path recovers otherwise. A failed
                # directory report must not kill the calling thread
                # (the reap loop runs through here).
                pass
            if owner:
                # Unblock the owner's local wait directly (its get() no
                # longer long-polls the head for self-owned refs).
                try:
                    self._owner_notify(owner, oid)
                except Exception:
                    pass

    def _owner_notify(self, owner: str, oid: str) -> None:
        with self._lock:
            c = self._owner_clients.get(owner)
            if c is None:
                if len(self._owner_clients) > 256:
                    old = self._owner_clients.popitem(last=False)[1]
                    old.close()
                c = self._owner_clients[owner] = RpcClient(
                    owner, timeout=10.0)
        c.call("owner_add_location", oid, self.node_id, self.address,
               self.store_path, True, 0, timeout=10.0)

    def rpc_cancel_task(self, task_id: str, force: bool = False):  # idempotent
        """CancelTask analog (``core_worker.proto`` CancelTask → raylet).
        Queued: dropped here, TaskCancelledError stored. Running:
        force kills the worker process (its lease/pins are reclaimed by
        the reap path); otherwise the cancel is forwarded to the worker
        for cooperative delivery. Returns True if the task was found."""
        with self._queue_cv:
            self._cancelled_tasks[task_id] = True
            while len(self._cancelled_tasks) > 10_000:
                # Oldest-first eviction: never the id just inserted.
                self._cancelled_tasks.popitem(last=False)
            for i, spec in enumerate(self._task_queue):
                if spec.get("task_id") == task_id:
                    self._task_queue.pop(i)
                    self._cancelled_tasks.pop(task_id, None)
                    break
            else:
                spec = None
        if spec is not None:
            self._uncommit(spec)
            self._cancel_spec(spec)
            return True
        with self._lock:
            target = next(
                (w for w in self._workers.values()
                 if w.current_task is not None
                 and w.current_task["spec"].get("task_id") == task_id),
                None,
            )
            if target is None:
                return False
            target.current_task["cancelled"] = True
            self._cancelled_tasks.pop(task_id, None)
            if force:
                # Kill UNDER the lock: outside it, the task could finish
                # and the worker be re-leased to an innocent task first.
                target.proc.kill()  # reap loop stores TaskCancelledError
                return True
            client = target.client
        try:
            client.call("cancel_task", task_id, False)
        except Exception:
            return False
        return True

    def kill_worker_oom(self, w: _Worker, reason: str,
                        expected_task=None) -> bool:
        """The memory monitor's kill: the task fails with
        ``OutOfMemoryError`` (not a retried worker death), an actor goes
        through its restart budget; the reap loop does the rest. Called
        off (False) when the worker no longer runs ``expected_task``."""
        with self._lock:
            current = w.current_task
            if expected_task is not None and current is not expected_task:
                return False
            if current is not None:
                current["oom_reason"] = reason
            w.proc.kill()
        return True

    def write_oom_report(self, reason: str, victim: _Worker,
                         current_task=None):
        """OOM forensics: snapshot WHY the node is out of memory --
        per-worker RSS, the store's occupancy, its largest objects with
        their owners and tasks -- to a JSON report BEFORE the kill
        destroys the evidence, under the node's log directory. Returns the
        report's path (the victim's death cause and the ``OOM_KILL``
        event carry it), or None without a log directory."""
        import json as _json

        from ray_tpu_torch.cluster.memory_monitor import system_memory

        used, total = system_memory()
        try:
            workers = self.rpc_worker_stats(fresh=True)
        except Exception:
            workers = []
        top_objects = []
        store_stats = {}
        try:
            # Bounded scan: the node is out of memory right now.
            rep = self.rpc_object_store_stats(max_objects=256)
            store_stats = rep.get("stats", {})
            top_objects = (rep.get("objects") or [])[:20]
        except Exception:
            pass
        spec = (current_task or {}).get("spec") or {}
        ts = time.time()
        report = {
            "ts": round(ts, 3),
            "node_id": self.node_id,
            "reason": reason,
            "victim": {
                "worker_id": victim.worker_id,
                "pid": victim.proc.pid,
                "is_actor": victim.is_actor,
                "actor_id": victim.actor_id,
                "task": spec.get("fname") or spec.get("method")
                or spec.get("class_name"),
                "task_id": spec.get("task_id"),
            },
            "system_memory": {"used_bytes": used, "total_bytes": total},
            "workers": [
                {"worker_id": st.get("worker_id"), "pid": st.get("pid"),
                 "rss_bytes": st.get("rss_bytes"),
                 "is_actor": st.get("is_actor")}
                for st in workers
            ],
            "object_store": store_stats,
            "top_objects": top_objects,
        }
        if self.log_dir is None:
            return None
        path = os.path.join(
            self.log_dir,
            f"oom_report_{victim.worker_id}_{int(ts * 1000)}.json")
        try:
            with open(path, "w") as f:
                _json.dump(report, f, indent=1, default=str)
        except OSError:
            return None
        with self._lock:
            self._oom_reports.append({
                "path": path, "ts": round(ts, 3), "reason": reason,
                "worker_id": victim.worker_id,
            })
            # Bounded: evicted entries take their files with them.
            evicted, self._oom_reports = (
                self._oom_reports[:-16], self._oom_reports[-16:])
        for old in evicted:
            try:
                os.unlink(old["path"])
            except OSError:
                pass
        return path

    def discard_oom_report(self, path: str) -> None:
        """The kill this report was written for never landed (the
        victim's task ended meanwhile): drop the orphan."""
        with self._lock:
            self._oom_reports = [r for r in self._oom_reports
                                 if r.get("path") != path]
        try:
            os.unlink(path)
        except OSError:
            pass

    def record_oom_kill(self, cause: str, victim: _Worker,
                        current_task=None, report_path=None) -> None:
        """A kill that landed: count it and publish a NODES event in the
        drain-event shape, with the forensic report's path."""
        _metrics.OOM_KILLS_TOTAL.inc(tags={"node_id": self.node_id})
        spec = (current_task or {}).get("spec") or {}
        try:
            self.head.call("publish", "NODES", self.node_id, {
                "node_id": self.node_id, "state": "OOM_KILL",
                "reason": cause, "worker_id": victim.worker_id,
                "task": spec.get("fname") or spec.get("method")
                or spec.get("class_name"),
                "report_path": report_path,
            }, timeout=5.0)
        except Exception:
            pass  # the head is restarting: the kill itself stands

    def _on_worker_failure(self, w: _Worker, cause: str,
                           requeued: bool = False):
        """Clean up a dead worker. ``requeued``: the caller already put
        the task back on the queue (pre-start death), so its refs must
        NOT be failed here."""
        with self._lock:
            self._workers.pop(w.worker_id, None)
            pool = self._idle.get(w.env_key)
            if pool and w in pool:
                pool.remove(w)
            rec = self._worker_logs.get(w.worker_id)
            if rec is not None and rec["ended_at"] is None:
                rec["ended_at"] = time.time()
            # Its device snapshot dies with it (the gauges follow at the
            # next telemetry pass or scrape).
            self._device_stats.pop(w.worker_id, None)
            current = None if requeued else w.current_task
            w.current_task = None
        if w.proc.poll() is None:
            w.proc.kill()
            try:
                w.proc.wait(timeout=5)
            except Exception:
                pass
        # Reclaim shm pins the dead process can never release.
        try:
            self.store.release_dead(w.proc.pid)
        except Exception:
            pass
        if w.is_actor and w.actor_id:
            try:
                self.head.call("mark_actor_dead", w.actor_id, cause,
                               True, w.address)
            except Exception:
                pass
        if w.client_id:
            # The process's holder registrations die with it.
            try:
                self.head.call("ref_client_dead", w.client_id)
            except Exception:
                pass
        if current is not None:
            if not current["released"]:
                current["released"] = True
                current["pool"].release(current["demand"])
            spec = current["spec"]
            if spec.get("actor_create"):
                self._end_borrows(spec)
            elif current.get("cancelled"):
                # Force-cancel killed this worker on purpose: the result is
                # TaskCancelledError, not a retriable worker death.
                self._cancel_spec(spec)
            elif current.get("oom_reason"):
                from ray_tpu_torch.core.object_ref import OutOfMemoryError

                self._store_task_error(spec, OutOfMemoryError(
                    spec.get("fname", "task"), current["oom_reason"]))
            else:
                self._fail_task(spec, f"worker died: {cause}")  # ends borrows

    def _reap_loop(self):
        """Detect dead worker processes (WorkerPool's disconnect handling)
        and retry deletes deferred while readers held the object."""
        while not self._shutdown.wait(0.2):
            with self._lock:
                dead = [
                    w for w in self._workers.values() if w.proc.poll() is not None
                ]
                deferred = list(self._deferred_deletes)
            for w in dead:
                try:
                    self._on_worker_failure(
                        w, f"exit code {w.proc.returncode}"
                    )
                except Exception:
                    # The reap loop must survive anything one corpse's
                    # cleanup throws (an unreachable head, store teardown
                    # races): a dead reaper leaks every later worker
                    # death.
                    continue
            for oid in deferred:
                if self.store.delete(oid) or not self.store.contains(oid):
                    with self._lock:
                        self._deferred_deletes.discard(oid)

    # -- actors -----------------------------------------------------------

    def rpc_kill_actor(self, actor_id, no_restart=True):
        with self._lock:
            target = next(
                (w for w in self._workers.values() if w.actor_id == actor_id),
                None,
            )
        if target is None:
            return False
        if no_restart:
            try:
                self.head.call("mark_actor_dead", actor_id,
                               "killed via ray_tpu_torch.kill", False)
            except Exception:
                pass
            target.is_actor = False  # already marked dead; don't re-mark
            target.actor_id = None
        # The actor's last task records and spans reach the head before
        # the kill (best-effort, bounded): a call whose result its caller
        # just read is otherwise lost to the state API.
        if target.client is not None and target.proc.poll() is None:
            try:
                target.client.call("flush_events", timeout=2.0)
            except Exception:
                pass
        # With no_restart=False, the reap loop observes the death and the
        # head reconstructs within the max_restarts budget.
        target.proc.kill()
        return True

    def rpc_detach_actor_worker(self, actor_id):
        """Drain-migration support: the head already owns this actor's
        state transition (RESTARTING on another node), so the OLD
        incarnation's worker is detached from its actor binding and
        killed — the reap loop then does plain worker cleanup instead of
        reporting a second, budget-consuming actor death."""
        with self._lock:
            target = next(
                (w for w in self._workers.values()
                 if w.actor_id == actor_id),
                None,
            )
            if target is None:
                return False
            target.is_actor = False
            target.actor_id = None
        target.proc.kill()
        return True

    # -- drain / preemption (node_manager.proto DrainRaylet analog) --------

    def rpc_drain_self(self, reason: str = "requested",
                       deadline_s: float | None = None):
        """The head's drain coordinator (or our own preemption watcher)
        says this node is leaving: stop admitting leased pushes; queued
        and running tasks keep going until the coordinator's deadline."""
        with self._lock:
            self._draining = True
            self._drain_reason = reason
        return True

    def rpc_drain_status(self):  # idempotent
        """Quiescence probe for the drain coordinator: queued tasks plus
        busy non-actor workers (actor processes hold their creation spec
        as current_task for life, so they never count as 'running')."""
        with self._lock:
            running = self._dispatch_inflight + sum(
                1 for w in self._workers.values()
                if w.current_task is not None and not w.is_actor
                and w.proc.poll() is None
            )
            return {
                "draining": self._draining,
                "reason": self._drain_reason,
                "queued": len(self._task_queue),
                "running": running,
            }

    def _self_drain(self, reason: str = "preemption") -> None:
        """Self-initiated drain (SIGTERM / preemption notice): ask the
        head to run the drain protocol for us — wait=False because the
        coordinator will call back into this agent (drain_self, then
        shutdown_node once quiesced)."""
        with self._lock:
            if self._draining:
                return
            self._draining = True
            self._drain_reason = reason
        try:
            self.head.call(
                "drain_node", self.node_id, reason, None, False,
                timeout=10.0)
        except Exception:
            # Head unreachable and the node is going away regardless:
            # local stop is the only remaining graceful option.
            self.stop()

    def _preemption_watcher(self) -> None:
        """Pluggable preemption-signal poll (the metadata-server watcher
        of cloud deployments; file-triggered in tests). Detection
        self-initiates a drain with reason="preemption" so actors migrate
        and owners get the retry-budget exemption BEFORE the VM vanishes."""
        interval = max(0.05, config.preemption_poll_interval_s)
        sig_file = config.preemption_signal_file
        url = config.preemption_metadata_url
        while not self._shutdown.wait(interval):
            with self._lock:
                if self._draining:
                    return
            if sig_file and self._signal_file_hit(sig_file):
                self._self_drain("preemption")
                return
            if url and self._metadata_preempted(url):
                self._self_drain("preemption")
                return

    def _signal_file_hit(self, path: str) -> bool:
        """The signal file preempts the nodes whose ids it names (on a
        simulated cluster every node of the host polls the same file)."""
        try:
            with open(path) as f:
                body = f.read()
        except OSError:
            return False
        return self.node_id in body

    @staticmethod
    def _metadata_preempted(url: str) -> bool:
        """GCE-shaped poll: .../instance/preempted returns "TRUE" once
        the termination notice lands."""
        import urllib.request

        try:
            req = urllib.request.Request(
                url, headers={"Metadata-Flavor": "Google"})
            with urllib.request.urlopen(req, timeout=2.0) as resp:
                body = resp.read().decode("utf-8", "replace").strip()
            return body.upper() in ("TRUE", "PREEMPTED", "1")
        except Exception:
            return False

    def rpc_actor_ctor_failed(self, actor_id, cause):
        # A raising constructor is deterministic — restarting would just
        # raise again (reference restarts only on process failure).
        try:
            self.head.call("mark_actor_dead", actor_id, cause, False)
        except Exception:
            pass
        return True

    # -- placement group bundles (2PC participant) ------------------------

    def rpc_prepare_bundle(self, pg_id, bundle_index, bundle):  # idempotent
        with self._lock:
            if (pg_id, bundle_index) in self._bundles:
                # Idempotent replay: the head's prepare landed but its
                # reply was lost (reconnect retry).
                # Acquiring again would double-reserve the node for one
                # logical bundle — exactly-once reservation means the
                # retry is an ack, not a second carve-out.
                return True
        if not self.pool.feasible(bundle):
            raise ValueError(f"bundle {bundle} infeasible on node {self.node_id}")
        if not self.pool.acquire(
                bundle, timeout=config.bundle_reserve_timeout_s):
            raise TimeoutError(f"bundle {bundle} not reservable on {self.node_id}")
        with self._lock:
            if (pg_id, bundle_index) in self._bundles:
                # Lost the race against a concurrent replay that
                # acquired first: give this acquisition back.
                self.pool.release(bundle)
                return True
            self._bundles[(pg_id, bundle_index)] = ResourcePool(bundle)
        return True

    def rpc_commit_bundle(self, pg_id, bundle_index):  # idempotent
        """2PC phase 2. The prepare already carved the bundle out of the
        node's pool; the reference records the committed state for its
        bundle table (a state listing, ROADMAP A4c), which the port does
        not keep, so there is nothing more to do."""
        return True

    def rpc_bundle_table(self):
        """This node's live placement-group reservations:
        ``{"<pg_id>:<bundle_index>": "RESERVED"}`` (the port keeps no
        PREPARED / COMMITTED distinction, see ``rpc_commit_bundle``). A
        reservation here that no live group's placement explains is a
        leaked carve-out."""
        with self._lock:
            return {f"{pg_id}:{bi}": "RESERVED"
                    for pg_id, bi in self._bundles}

    def rpc_return_bundle(self, pg_id, bundle_index):  # idempotent
        with self._lock:
            pool = self._bundles.pop((pg_id, bundle_index), None)
            # Reference semantics: removing a PG kills the work running
            # in its bundles (gcs_placement_group_manager removal path).
            # Without this, returning the reservation below would
            # oversubscribe the node for as long as a straggler runs.
            # Scoped to THIS bundle: returning one bundle (a reserve
            # rollback) must not kill a SIBLING bundle's healthy workers
            # on the same node — only any-bundle tasks (bundle_index < 0,
            # whose pool we never recorded) die with whichever bundle
            # goes first.
            victims = [
                w for w in self._workers.values()
                if w.current_task is not None
                and w.current_task["spec"].get("pg_id") == pg_id
                and w.current_task["spec"].get(
                    "bundle_index", -1) in (-1, bundle_index)
                and w.proc.poll() is None
            ]
        for w in victims:
            w.proc.kill()  # reap loop stores the task error / actor death
        if pool is not None:
            # Return the bundle's FULL reservation. Any just-killed (or
            # killed-but-unreaped) worker's release drains into this now-
            # orphaned pool object, not the node pool, so returning the
            # total cannot double-free — while returning only
            # pool.available() would permanently leak whatever a
            # not-yet-reaped worker still held.
            self.pool.release(pool.total)
        return True

    # -- object serving ---------------------------------------------------

    def _served(self, path: str, nbytes: int) -> None:
        with self._lock:
            self._fetch_stats[path + "_bytes"] += nbytes

    def rpc_fetch_object_info(self, oid, inline_max: int = 0):
        """``(meta, data_size, data or None)`` for a pull, or None when the
        object is neither in the store nor spilled here. The data rides
        in the reply when it fits in ``inline_max`` bytes: a small object
        is one round trip. A spilled object is restored first, so the
        chunk reads that follow find it in shared memory."""
        with self._lock:
            self._fetch_stats["info"] += 1
        got = self.store.get(oid)
        if got is not None:
            data, meta = got
            try:
                if len(data) <= inline_max:
                    self._count_inline(len(data))
                    return meta, len(data), bytes(data)
                return meta, len(data), None
            finally:
                self.store.release(oid)
        restored = self._restore_from_spill(oid)
        if restored is None:
            return None
        meta, data = restored
        if len(data) <= inline_max:
            self._count_inline(len(data))
            return meta, len(data), data
        return meta, len(data), None

    def _count_inline(self, nbytes: int) -> None:
        with self._lock:
            self._fetch_stats["inline"] += 1
        self._served("inline", nbytes)

    def rpc_fetch_object(self, oid, chunk: int):
        """Server-streamed pull of one object: first ``(meta, size)``, or
        None when it is neither here nor spilled here, then its data in
        ``chunk``-sized frames -- one request, the frames back to back.
        Each chunk is read on its own (``rpc_fetch_object_chunk``): a
        spill in the middle of the stream falls back to the spill file."""
        with self._lock:
            self._fetch_stats["streams"] += 1
        got = self.store.get(oid)
        if got is not None:
            data, meta = got
            size = len(data)
            self.store.release(oid)
        else:
            restored = self._restore_from_spill(oid)
            if restored is None:
                yield None
                return
            meta, size = restored[0], len(restored[1])
            del restored
        yield meta, size
        for off in range(0, size, chunk):
            piece = self._read_chunk(oid, off, min(chunk, size - off))
            if piece is None:
                raise ObjectLostError(
                    f"object {oid[:16]}… lost mid-stream at offset {off}")
            with self._lock:
                self._fetch_stats["chunks"] += 1
            self._served("stream", len(piece))
            yield piece

    def rpc_fetch_object_chunk(self, oid, offset: int, length: int):
        """``length`` bytes of the object's data from ``offset`` (one chunk
        of a parallel pull), or None when it is gone. Stateless: each
        chunk pins and releases the object on its own, and one spilled
        meanwhile is read from its spill file (whose bytes are the
        store's: a spill file is written once and never changed)."""
        failpoints.hit("agent.fetch.chunk")
        piece = self._read_chunk(oid, offset, length)
        if piece is not None:
            now = time.time()
            with self._lock:
                self._fetch_stats["chunks"] += 1
                rec = self._chunk_pulls.get(oid)
                if rec is None:
                    rec = self._chunk_pulls[oid] = [now, now, 0, 0]
                    while len(self._chunk_pulls) > 64:
                        self._chunk_pulls.popitem(last=False)
                rec[1] = now
                rec[2] += len(piece)
                rec[3] += 1
            self._served("chunk", len(piece))
        return piece

    def _read_chunk(self, oid: str, offset: int, length: int):
        got = self.store.get(oid)
        if got is not None:
            try:
                return bytes(got[0][offset:offset + length])
            finally:
                self.store.release(oid)
        piece = self.spill_backend.read_range(oid, offset, length)
        if piece is not None:
            with self._lock:
                self._fetch_stats["spill_file_bytes"] += len(piece)
        return piece

    def rpc_fetch_stats(self):  # idempotent (read-only)
        """{"counts": calls by kind (info, inline, streams, and chunks --
        every chunk served, streamed or pulled on its own), data bytes
        by path (inline_bytes, stream_bytes, chunk_bytes) and the chunk
        bytes read from a spill file, not the store (spill_file_bytes),
        "chunk_pulls": {oid: {first_wall, last_wall, bytes, chunks}} for
        the recent parallel pulls this agent served}."""
        with self._lock:
            return {
                "counts": dict(self._fetch_stats),
                "chunk_pulls": {
                    oid: {"first_wall": r[0], "last_wall": r[1],
                          "bytes": r[2], "chunks": r[3]}
                    for oid, r in self._chunk_pulls.items()},
            }

    # -- spilling and restore ----------------------------------------------

    def _restore_backend_for(self, uri: str) -> spill_storage.SpillBackend:
        """This node's backend when ``uri`` is its own (one cluster-wide
        spill_uri, the common case), else a cached backend of ``uri``."""
        if uri == self.spill_backend.uri:
            return self.spill_backend
        with self._lock:
            be = self._restore_backends.get(uri)
            if be is None:
                if len(self._restore_backends) > 8:
                    self._restore_backends.clear()
                be = self._restore_backends[uri] = \
                    spill_storage.backend_for(uri)
        return be

    def _count_restore(self, nbytes: int, seconds: float) -> None:
        with self._lock:
            self._spill_stats["spill_restores"] += 1
            self._spill_stats["restored_bytes"] += nbytes
            self._spill_stats["restore_s"] += seconds
        _metrics.SPILL_RESTORES_TOTAL.inc(tags={"node_id": self.node_id})

    def _restore_from_spill(self, oid):
        """(meta, data) of an object spilled here, put back into the store
        when it fits (unpinned: the spill file stays the durable copy
        until the object is freed, so evicting it again costs only a
        re-read); None when it was not spilled here."""
        t0 = time.perf_counter()
        try:
            failpoints.hit("agent.restore.before_fetch")
        except failpoints.FailpointError:
            return None
        got = self.spill_backend.read(oid)
        if got is None:
            return None
        meta, data = got
        try:
            self.store.put(oid, data, meta)
        except Exception:
            pass  # no room (or restored by a concurrent fetch): serve anyway
        self._count_restore(len(data), time.perf_counter() - t0)
        return meta, data

    def rpc_restore_from_uri(self, oid, uri, owner=None):
        """Restore an object from a (shared) spill target into THIS
        node's store: the head routes a dead node's spilled objects here
        instead of recomputing them. An object already here returns True
        without reading the target. ``owner`` (the owning client's
        directory address) is told the new location. Returns whether the
        object is now in this store."""
        if self.store.contains(oid):
            return True
        t0 = time.perf_counter()
        try:
            failpoints.hit("agent.restore.before_fetch")
            backend = self._restore_backend_for(uri)
        except Exception:
            return False
        got = backend.read(oid)
        if got is None:
            return False
        meta, data = got
        for attempt in range(4):
            try:
                self.store.put(oid, data, meta)
                break
            except Exception:
                # Full: make room as a put does; one that cannot fit
                # gives up (the caller recomputes through lineage).
                if attempt == 3 or self.rpc_spill(
                        len(data) + config.spill_headroom_bytes) <= 0:
                    return False
        self._count_restore(len(data), time.perf_counter() - t0)
        if owner:
            try:
                self._owner_notify(owner, oid)
            except Exception:
                pass  # the owner is gone: the head's view resolves it
        return True

    def rpc_spill(self, bytes_needed: int):  # idempotent (level-triggered)
        """Move cold primary copies to the spill target until
        ``bytes_needed`` bytes of the store are free; returns the bytes
        freed (``local_object_manager.h:110,122`` SpillObjects). A
        candidate is sealed and held by no reader (``info``'s refcount
        0), coldest first; it is written while pinned by this read and
        evicted after, and one a reader took meanwhile stays (its spill
        file is deleted). The oids come from the head's directory (the
        store's keys are digests), asked for before the spill lock so a
        slow head holds up no other spiller; spills to a shared target
        are reported to the head after the lock."""
        try:
            oids = self.head.call("objects_on_node", self.node_id,
                                  timeout=10.0)
        except Exception:
            oids = []
        spilled_remote: list[str] = []
        spilled_bytes = 0
        t0 = time.perf_counter()
        with self._spill_lock:
            here = set(self.store.list_keys())
            cands = []
            for oid in oids:
                if store_key(oid) not in here:
                    continue  # spilled already, or gone
                try:
                    info = self.store.info(oid)
                except RuntimeError:
                    return 0  # the segment was unlinked under us
                if info is not None and info["refcount"] == 0:
                    cands.append((info["lru_tick"], oid,
                                  info["data_size"] + info["meta_size"]))
            cands.sort()  # coldest first
            freed = 0
            for _tick, oid, size in cands:
                if freed >= bytes_needed:
                    break
                got = self.store.get(oid)  # our read pins it while we copy
                if got is None:
                    continue
                data, meta = got
                try:
                    failpoints.hit("agent.spill.before_write")
                    written = self.spill_backend.write(oid, meta, data)
                except Exception:
                    # An injected fault or an I/O error: the object stays.
                    del data
                    self.store.release(oid)
                    continue
                del data
                self.store.release(oid)
                if self.store.evict(oid):
                    freed += size
                    spilled_bytes += written
                    if self.spill_backend.remote:
                        spilled_remote.append(oid)
                else:
                    self.spill_backend.delete(oid)  # a reader took it
            seconds = time.perf_counter() - t0
            with self._lock:
                self._spill_stats["spill_s"] += seconds
                self._spill_stats["spilled_bytes_total"] += spilled_bytes
                self._spill_stats["spills"] += 1 if spilled_bytes else 0
                if freed < bytes_needed:
                    # Statistics only; replays stay level-triggered.
                    self._spill_stats["spill_denied"] += 1  # analyze: ignore[RT002]
            if freed < bytes_needed:
                _metrics.OBJECT_SPILL_DENIED.inc(
                    tags={"node_id": self.node_id})
        if spilled_bytes:
            _metrics.SPILL_BYTES_TOTAL.inc(
                spilled_bytes, tags={"node_id": self.node_id})
        if spilled_remote:
            try:
                self.head.call("add_spilled", spilled_remote,
                               self.spill_backend.uri, timeout=10.0)
            except Exception:
                pass  # unrecorded: a dead node's copy is recomputed instead
        return freed

    def rpc_free_object(self, oid):  # idempotent
        """Head says nothing references this object anymore: drop the shm
        copy and any spilled copy (free-on-zero broadcast target). Under
        the spill lock, so a spill in progress cannot write the file
        again after the delete."""
        with self._spill_lock:
            self.store.pin(oid, False)
            if not self.store.delete(oid) and self.store.contains(oid):
                # Actively read right now (zero-copy views alive); the
                # reap loop retries until readers release.
                with self._lock:
                    self._deferred_deletes.add(oid)
            self.spill_backend.delete(oid)
        return True

    def rpc_delete_spilled(self, oid, uri):  # idempotent
        """Drop an object from a spill target this node reaches (the
        head's free of a dead node's spilled copy on a shared target)."""
        try:
            return self._restore_backend_for(uri).delete(oid)
        except Exception:
            return False

    def rpc_store_stats(self):  # idempotent (read-only)
        """The store's ``stats()``, the spill target's objects and bytes,
        and the spill and restore counters."""
        stats = self.store.stats()
        sp = self.spill_backend.stats()
        stats["spilled_objects"] = sp["objects"]
        stats["spilled_bytes"] = sp["bytes"]
        with self._lock:
            stats.update(self._spill_stats)
        return stats


    # -- operating the node: logs, stacks, profiles, the metrics text -------

    def _log_record(self, worker_id: str) -> dict:
        with self._lock:
            rec = self._worker_logs.get(worker_id)
        if rec is None:
            raise ValueError(
                f"no log capture for worker {worker_id!r} on node "
                f"{self.node_id} (unknown worker, or capture disabled)")
        return rec

    @staticmethod
    def _log_path(rec: dict, stream: str) -> str:
        if stream in ("out", "stdout"):
            return rec["stdout_path"]
        if stream in ("err", "stderr"):
            return rec["stderr_path"]
        raise ValueError(f"stream must be out|err, got {stream!r}")

    def rpc_list_worker_logs(self):
        """Every worker (live and recently dead) with captured logs: id,
        pid, file paths and sizes, lifetime, actor binding."""
        with self._lock:
            recs = [dict(r) for r in self._worker_logs.values()]
            live = {w.worker_id: w for w in self._workers.values()
                    if w.proc.poll() is None}
        out = []
        for rec in recs:
            w = live.get(rec["worker_id"])
            rec["alive"] = w is not None
            rec["is_actor"] = bool(w is not None and w.is_actor)
            rec["actor_id"] = w.actor_id if w is not None else None
            for stream in ("stdout", "stderr"):
                try:
                    rec[f"{stream}_bytes"] = os.path.getsize(
                        rec[f"{stream}_path"])
                except OSError:
                    rec[f"{stream}_bytes"] = 0
            out.append(rec)
        return out

    def rpc_read_worker_log(self, worker_id, stream: str = "out",
                            offset: int | None = None,
                            max_bytes: int = 1 << 20,
                            tail_lines: int | None = None):
        """One bounded read of a worker's captured stdout/stderr.
        ``tail_lines`` reads the file's end; otherwise [offset,
        offset+max_bytes) -- pass the returned ``offset`` back to
        poll-follow."""
        path = self._log_path(self._log_record(worker_id), stream)
        try:
            size = os.path.getsize(path)
        except OSError:
            size = 0
        max_bytes = max(1, min(int(max_bytes), 8 << 20))
        if tail_lines is not None:
            start = max(0, size - max_bytes)
            try:
                with open(path, "rb") as f:
                    f.seek(start)
                    blob = f.read(max_bytes)
            except OSError:  # evicted between the stat and the read
                blob = b""
            n = int(tail_lines)
            lines = blob.decode("utf-8", "replace").splitlines()
            data = "\n".join(lines[-n:]) if n > 0 else ""
            if data:
                data += "\n"
            return {"worker_id": worker_id, "stream": stream,
                    "offset": size, "size": size, "data": data}
        start = min(max(0, int(offset or 0)), size)
        try:
            with open(path, "rb") as f:
                f.seek(start)
                blob = f.read(max_bytes)
        except OSError:
            blob = b""
        return {"worker_id": worker_id, "stream": stream,
                "offset": start + len(blob), "size": size,
                "data": blob.decode("utf-8", "replace")}

    def rpc_follow_worker_log(self, worker_id, stream: str = "out",
                              offset: int = 0, idle_timeout_s: float = 10.0,
                              poll_s: float = 0.2):
        """Server-streamed ``tail -f`` of a worker's log (use with
        ``call_stream``): yields ``{"offset", "data"}`` chunks as the
        file grows; ends once the worker is gone and its file drained,
        or after ``idle_timeout_s`` without growth."""
        path = self._log_path(self._log_record(worker_id), stream)
        offset = max(0, int(offset))
        last_growth = time.monotonic()
        while not self._shutdown.is_set():
            try:
                size = os.path.getsize(path)
            except OSError:
                return
            if offset < size:
                with open(path, "rb") as f:
                    f.seek(offset)
                    blob = f.read(1 << 16)
                offset += len(blob)
                last_growth = time.monotonic()
                yield {"offset": offset,
                       "data": blob.decode("utf-8", "replace")}
                continue
            with self._lock:
                w = self._workers.get(worker_id)
                dead = w is None or w.proc.poll() is not None
            if dead or time.monotonic() - last_growth > idle_timeout_s:
                return
            time.sleep(poll_s)

    def _live_worker(self, worker_id) -> _Worker:
        with self._lock:
            w = self._workers.get(worker_id)
        if w is None or w.proc.poll() is not None:
            raise ValueError(
                f"no live worker {worker_id!r} on node {self.node_id}")
        if w.client is None and not w.ready.wait(5.0):
            raise ValueError(f"worker {worker_id!r} is not serving yet")
        return w

    def rpc_dump_worker_stack(self, worker_id):  # idempotent (read-only)
        """Every thread's stack in one worker, now."""
        return self._live_worker(worker_id).client.call(
            "dump_stack", timeout=15.0)

    def rpc_profile_worker(self, worker_id, duration_s: float = 1.0,  # idempotent (read-only)
                           interval_s: float = 0.01):
        """A time-sampled profile of one worker
        (``util/stack_sampler.py``'s plain-data profile)."""
        w = self._live_worker(worker_id)
        prof = w.client.call(
            "profile", float(duration_s), float(interval_s),
            timeout=float(duration_s) + 30.0)
        prof["node_id"] = self.node_id
        prof["pid"] = w.proc.pid
        return prof

    def rpc_capture_profile(self, worker_id, duration_s: float = 1.0,
                            interval_s: float = 0.01):
        """A profiler window in one worker (``torch.profiler`` where it
        runs CUDA, else the stack sampler), its files written by the
        worker straight into a capture directory under the node's log
        directory (no trace bytes on the worker's reply). The manifest's
        files stream back through ``read_capture_file``."""
        import shutil

        w = self._live_worker(worker_id)
        base = self.log_dir or tempfile.mkdtemp(prefix="rtorch_tprof_")
        cap_id = f"tprof-{worker_id}-{os.urandom(3).hex()}"
        cap_dir = os.path.join(base, cap_id)
        os.makedirs(cap_dir, exist_ok=True)
        try:
            res = w.client.call(
                "capture_profile", float(duration_s), float(interval_s),
                cap_dir, timeout=float(duration_s) + 60.0)
        except Exception:
            shutil.rmtree(cap_dir, ignore_errors=True)
            raise
        # The manifest comes from this walk, not the worker's claim:
        # read_capture_file trusts these names when it joins paths.
        names = []
        for dirpath, _dirs, fnames in os.walk(cap_dir):
            for fname in fnames:
                path = os.path.join(dirpath, fname)
                try:
                    names.append({"name": os.path.relpath(path, cap_dir),
                                  "size": os.path.getsize(path)})
                except OSError:
                    continue
        manifest = {
            "capture_id": cap_id,
            "node_id": self.node_id,
            "worker_id": worker_id,
            "kind": res.get("kind"),
            "duration_s": res.get("duration_s"),
            "import_s": res.get("import_s"),
            "files": sorted(names, key=lambda f: f["name"]),
        }
        with self._lock:
            self._captures[cap_id] = {**manifest, "dir": cap_dir}
            evict = []
            while len(self._captures) > MAX_CAPTURES:
                evict.append(self._captures.popitem(last=False)[1])
        for old in evict:
            shutil.rmtree(old["dir"], ignore_errors=True)
        return manifest

    def rpc_read_capture_file(self, capture_id, name, offset: int = 0,  # idempotent (read-only)
                              max_bytes: int = 1 << 20):
        """One bounded read ([offset, offset+max_bytes)) of a capture's
        file, so a large trace streams instead of riding one frame."""
        with self._lock:
            m = self._captures.get(capture_id)
        if m is None:
            raise ValueError(
                f"no capture {capture_id!r} on node {self.node_id}")
        if not any(f["name"] == name for f in m["files"]):
            raise ValueError(f"capture {capture_id} has no file {name!r}")
        path = os.path.join(m["dir"], name)
        start = max(0, int(offset))
        max_bytes = max(1, min(int(max_bytes), 8 << 20))
        try:
            size = os.path.getsize(path)
            with open(path, "rb") as f:
                f.seek(start)
                blob = f.read(max_bytes)
        except OSError as e:
            # A vanished file fails the download rather than hand over a
            # truncated trace.
            raise ValueError(
                f"capture {capture_id} file {name!r} unreadable: {e}")
        return {"name": name, "offset": start + len(blob), "size": size,
                "data": blob}

    def rpc_metrics_text(self):  # idempotent (read-only)
        """This process's registry in Prometheus exposition format (the
        node's input to the head's ``/metrics/cluster``), the store
        gauges and the device gauges (from the workers' latest snapshots,
        what ``device_stats`` answers) refreshed first. The render-time
        gauge carries the previous render's cost (this one's is known
        only after it)."""
        try:
            with self._telemetry_lock:
                if not self._shutdown.is_set():
                    self._export_device_gauges()
                self._export_store_gauges_locked()
            _metrics.AGENT_METRICS_RENDER_SECONDS.set(
                self._last_metrics_render_s, tags={"node_id": self.node_id})
        except Exception:
            pass
        t0 = time.perf_counter()
        body = _metrics.prometheus_text()
        self._last_metrics_render_s = time.perf_counter() - t0
        return body

    _last_metrics_render_s = 0.0

    def rpc_has_worker(self, worker_id):  # idempotent (read-only)
        """The head's routing probe: does this node know the worker?"""
        with self._lock:
            w = self._workers.get(worker_id)
            return {
                "known": worker_id in self._worker_logs or w is not None,
                "live": w is not None and w.proc.poll() is None,
            }

    def rpc_worker_addresses(self):  # idempotent (read-only)
        """Live workers' RPC addresses: a partition of this node covers
        traffic sent straight to its workers too."""
        with self._lock:
            return [w.address for w in self._workers.values()
                    if w.address and w.proc.poll() is None]

    # -- the failpoint and network chaos control plane ----------------------

    def _live_worker_clients(self) -> list:
        with self._lock:
            return [(w.worker_id, w.client) for w in self._workers.values()
                    if w.client is not None and w.proc.poll() is None]

    def rpc_set_failpoints(self, specs: dict, include_workers: bool = True):
        """Arm/disarm failpoints in this process and (by default) every
        live worker of the node, and in each worker that registers later.
        Returns {"agent": armed, <worker_id>: armed-or-error}."""
        out = {"agent": failpoints.set_failpoints(specs)}
        if include_workers:
            with self._lock:
                for site, spec in (specs or {}).items():
                    if spec:
                        self._worker_failpoints[site] = spec
                    else:
                        self._worker_failpoints.pop(site, None)
            for wid, client in self._live_worker_clients():
                try:
                    out[wid] = client.call("set_failpoints", specs,
                                           timeout=5.0)
                except Exception as e:
                    out[wid] = {"error": repr(e)}
        return out

    def rpc_list_failpoints(self):  # idempotent (read-only)
        """This agent's armed table and each live worker's."""
        out = {"agent": failpoints.list_armed()}
        for wid, client in self._live_worker_clients():
            try:
                out[wid] = client.call("list_failpoints", timeout=5.0)
            except Exception as e:
                out[wid] = {"error": repr(e)}
        return out

    def rpc_set_channel_chaos(self, rules: list, label: str = "",
                              include_workers: bool = True):
        """Arm network-chaos rules here and on the live workers (kept for
        the workers that register later)."""
        n = channel_chaos.add_rule_dicts(rules, label)
        if include_workers:
            with self._lock:
                self._worker_channel_rules.extend(
                    dict(r, label=label) if label and not r.get("label")
                    else dict(r) for r in rules)
            for _wid, client in self._live_worker_clients():
                try:
                    client.call("set_channel_chaos", rules, label,
                                timeout=5.0)
                except Exception:
                    continue
        return n

    def rpc_clear_channel_chaos(self, label: str | None = None,
                                include_workers: bool = True):
        n = channel_chaos.clear(label)
        if include_workers:
            with self._lock:
                self._worker_channel_rules = [
                    r for r in self._worker_channel_rules
                    if label is not None and r.get("label") != label]
            for _wid, client in self._live_worker_clients():
                try:
                    client.call("clear_channel_chaos", label, timeout=5.0)
                except Exception:
                    continue
        return n

    def rpc_list_channel_chaos(self):  # idempotent (read-only)
        """This process's rules and each live worker's: {"agent": [...],
        <worker_id>: [...]}."""
        out = {"agent": channel_chaos.describe()}
        for wid, client in self._live_worker_clients():
            try:
                out[wid] = client.call("list_channel_chaos", timeout=5.0)
            except Exception as e:
                out[wid] = [{"error": repr(e)}]
        return out

    # -- node reporter (per-worker and device telemetry) --------------------

    def rpc_device_stats(self, fresh: bool = False):  # idempotent (read-only)
        """Per-worker device snapshots on this node. Steady state comes
        from the workers' batched reports; ``fresh`` asks every live
        worker for one now (a worker that never initialised CUDA answers
        with the stub). The agent itself never makes a CUDA context."""
        with self._lock:
            live = {
                w.worker_id: w for w in self._workers.values()
                if w.proc.poll() is None
            }
            snaps = {wid: dict(s) for wid, s in self._device_stats.items()
                     if wid in live}
        if fresh:
            targets = [(wid, w.client) for wid, w in live.items()
                       if w.client is not None]
            if targets:
                from concurrent.futures import ThreadPoolExecutor

                def one(item):
                    wid, client = item
                    try:
                        return wid, client.call("device_stats", timeout=3.0)
                    except Exception:
                        return wid, None

                with ThreadPoolExecutor(
                        max_workers=min(8, len(targets))) as pool:
                    for wid, snap in pool.map(one, targets):
                        if snap is not None:
                            snaps[wid] = snap
        out = []
        for wid, snap in snaps.items():
            snap["worker_id"] = wid
            snap["node_id"] = self.node_id
            out.append(snap)
        return out

    @staticmethod
    def _read_proc(pid: int):
        """(cpu_ticks, rss_bytes) of a pid from /proc, or None."""
        try:
            with open(f"/proc/{pid}/stat", "rb") as f:
                # Fields after the parenthesized comm: index 11/12 are
                # utime/stime (fields 14/15).
                parts = f.read().rsplit(b")", 1)[1].split()
            ticks = int(parts[11]) + int(parts[12])
            with open(f"/proc/{pid}/statm", "rb") as f:
                rss_pages = int(f.read().split()[1])
            return ticks, rss_pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError, IndexError):
            return None

    def _sample_worker_stats(self) -> list:
        """Sample every live worker's CPU/RSS/uptime, refresh the gauges
        (retracting dead workers' series) and keep the snapshot for
        ``worker_stats``. One pass at a time, at most one per 200 ms:
        cpu%% needs a meaningful tick delta."""
        with self._telemetry_lock:
            return self._sample_worker_stats_locked()

    def _sample_worker_stats_locked(self) -> list:
        hz = os.sysconf("SC_CLK_TCK") or 100
        now = time.monotonic()
        if self._shutdown.is_set():
            return []  # stopping: never re-export retracted series
        if now - self._last_sample < 0.2 and self._worker_stats:
            with self._lock:
                return [dict(s) for s in self._worker_stats.values()]
        self._last_sample = now
        with self._lock:
            workers = [
                (w.worker_id, w.proc.pid, w.started_at, w.is_actor,
                 w.actor_id)
                for w in self._workers.values() if w.proc.poll() is None
            ]
            last_task = {wid: dict(t) for wid, t in self._last_task.items()}
        stats: dict[str, dict] = {}
        for wid, pid, started_at, is_actor, actor_id in workers:
            got = self._read_proc(pid)
            if got is None:
                continue
            ticks, rss = got
            prev = self._cpu_prev.get(wid)
            cpu = 0.0
            if prev is not None and now > prev[1]:
                cpu = max(0.0, (ticks - prev[0]) / hz / (now - prev[1])
                          * 100.0)
            self._cpu_prev[wid] = (ticks, now)
            stats[wid] = {
                "worker_id": wid,
                "node_id": self.node_id,
                "pid": pid,
                "cpu_percent": round(cpu, 2),
                "rss_bytes": rss,
                "uptime_s": round(time.time() - started_at, 2),
                "is_actor": is_actor,
                "actor_id": actor_id,
                # The worker's last finished task and its phase wall ns.
                "last_task": last_task.get(wid),
            }
        exported = set()
        for st in stats.values():
            tags = {"node_id": self.node_id, "worker_id": st["worker_id"],
                    "pid": str(st["pid"])}
            exported.add((st["worker_id"], str(st["pid"])))
            _metrics.WORKER_CPU_PERCENT.set(st["cpu_percent"], tags=tags)
            _metrics.WORKER_RSS_BYTES.set(st["rss_bytes"], tags=tags)
            _metrics.WORKER_UPTIME_SECONDS.set(st["uptime_s"], tags=tags)
        _metrics.NODE_WORKER_COUNT.set(
            len(stats), tags={"node_id": self.node_id})
        for wid, pid in self._exported_gauges - exported:
            self._retract_worker_series(wid, pid)
            self._cpu_prev.pop(wid, None)
        self._exported_gauges = exported
        with self._lock:
            live = {wid for wid, *_ in workers}
            for table in (self._device_stats, self._last_task):
                for wid in [w for w in table if w not in live]:
                    del table[wid]
            dead_train = [wid for wid in self._train_gauges
                          if wid not in live]
            dead_serve = [wid for wid in self._serve_gauges
                          if wid not in live]
            self._worker_stats = stats
        for wid in dead_train:
            self._retract_train_series(wid)
        for wid in dead_serve:
            self._retract_serve_series(wid)
        self._export_device_gauges()
        self._export_store_gauges_locked()
        return list(stats.values())

    def _export_device_gauges(self) -> None:
        """Refresh the ray_tpu_device_* families from the live workers'
        latest device snapshots (dead workers' snapshots are already
        pruned), retracting the children of devices no longer reported.
        The node's device count is always set: 0 where no worker has
        initialised CUDA."""
        with self._lock:
            snaps = dict(self._device_stats)
        exported: set = set()
        n_devices = 0
        for wid, snap in snaps.items():
            devices = snap.get("devices") or []
            n_devices = max(n_devices, len(devices))
            for d in devices:
                dev = f"{d.get('platform', '?')}:{d.get('id', -1)}"
                tags = {"node_id": self.node_id, "worker_id": wid,
                        "device": dev}
                _metrics.DEVICE_MEM_IN_USE.set(d.get("bytes_in_use", 0),
                                               tags=tags)
                _metrics.DEVICE_MEM_PEAK.set(d.get("peak_bytes_in_use", 0),
                                             tags=tags)
                _metrics.DEVICE_MEM_LIMIT.set(d.get("bytes_limit", 0),
                                              tags=tags)
                exported.add((wid, dev))
        _metrics.DEVICE_COUNT.set(n_devices, tags={"node_id": self.node_id})
        for wid, dev in self._exported_device - exported:
            self._retract_device_series(wid, dev)
        self._exported_device = exported

    def _retract_device_series(self, wid: str, dev: str) -> None:
        tags = {"node_id": self.node_id, "worker_id": wid, "device": dev}
        _metrics.DEVICE_MEM_IN_USE.remove(tags=tags)
        _metrics.DEVICE_MEM_PEAK.remove(tags=tags)
        _metrics.DEVICE_MEM_LIMIT.remove(tags=tags)

    def _retract_train_series(self, wid: str) -> None:
        """Drop the goodput gauge children (per-rank step time, anatomy,
        MFU) a dead worker's events made."""
        with self._lock:
            keys = self._train_gauges.pop(wid, None)
        if keys:
            from ray_tpu_torch.util import goodput as _goodput

            _goodput.retract_gauges(keys, self.node_id)

    def _retract_serve_series(self, wid: str) -> None:
        """Drop the Serve gauge children a dead worker's events made (a
        dead replica must vanish from the federated scrape)."""
        with self._lock:
            keys = self._serve_gauges.pop(wid, None)
        if keys:
            from ray_tpu_torch.serve import _observability as _serve_obs

            _serve_obs.retract_gauges(keys, self.node_id)

    def _export_store_gauges(self) -> None:
        with self._telemetry_lock:
            self._export_store_gauges_locked()

    def _export_store_gauges_locked(self) -> None:
        """Refresh the node's object-store gauges (used, capacity,
        objects) and its eviction counter by delta."""
        if self._shutdown.is_set():
            return  # stopping: never re-export retracted series
        try:
            st = self.store.stats()
        except RuntimeError:
            return  # the segment is gone
        tags = {"node_id": self.node_id}
        _metrics.OBJECT_STORE_BYTES_USED.set(st["used"], tags=tags)
        _metrics.OBJECT_STORE_BYTES_CAPACITY.set(st["capacity"], tags=tags)
        _metrics.OBJECT_STORE_OBJECTS.set(st["num_objects"], tags=tags)
        delta = st["num_evictions"] - self._evictions_exported
        if delta > 0:
            _metrics.OBJECT_STORE_EVICTIONS.inc(delta, tags=tags)
        self._evictions_exported = st["num_evictions"]
        self._store_gauges_exported = True

    def _retract_worker_series(self, wid: str, pid: str) -> None:
        tags = {"node_id": self.node_id, "worker_id": wid, "pid": pid}
        _metrics.WORKER_CPU_PERCENT.remove(tags=tags)
        _metrics.WORKER_RSS_BYTES.remove(tags=tags)
        _metrics.WORKER_UPTIME_SECONDS.remove(tags=tags)

    def _telemetry_loop(self):
        while not self._shutdown.wait(config.worker_telemetry_interval_s):
            try:
                self._sample_worker_stats()
            except Exception:
                _metrics.count_loop_restart("agent.telemetry")

    def rpc_worker_stats(self, fresh: bool = False):  # idempotent (read-only)
        """Latest per-worker CPU/RSS/uptime snapshot, each with its last
        task's phase breakdown (GetNodeStats analog); ``fresh`` forces a
        sample pass now."""
        with self._lock:
            snap = [dict(st) for st in self._worker_stats.values()]
        if fresh or not snap:
            snap = self._sample_worker_stats()
        return snap

    # -- memory observability ----------------------------------------------

    def _object_attr(self, oid: str) -> dict:
        """The put-time attribution embedded in a sealed object's store
        meta ({} when absent: error markers the agent stores)."""
        from ray_tpu_torch.core import serialization as ser

        got = self.store.get(oid)
        if got is None:
            return {}
        _data, meta = got
        try:
            return ser.meta_field(meta[1:], "attr") or {}
        finally:
            self.store.release(oid)

    def rpc_object_store_stats(self, oids=None,
                               include_objects: bool = True,
                               max_objects: int | None = None):
        """This node's memory report: the store's ``stats()`` joined with
        each key's ``info()`` (size, refcount, pinned) and the
        attribution riding its meta, plus the OOM-report index. ``oids``
        is normally the head's directory slice for this node (the store
        keys are digests); None asks the head. ``max_objects`` bounds
        the scan (the pre-kill OOM snapshot)."""
        with self._lock:
            reports = [dict(r) for r in self._oom_reports]
        report = {"node_id": self.node_id, "ts": time.time(),
                  "stats": self.rpc_store_stats(),
                  "oom_reports": reports}
        if not include_objects:
            return report
        if oids is None:
            try:
                oids = self.head.call("objects_on_node", self.node_id,
                                      timeout=5.0)
            except Exception:
                oids = []
        objs = []
        now = time.time()
        if max_objects is not None:
            oids = list(oids)[:max_objects]
        for oid in oids:
            try:
                info = self.store.info(oid)
            except RuntimeError:
                break  # segment unlinked under us: stats-only report
            if info is None:
                continue  # freed or spilled since the directory snapshot
            attr = self._object_attr(oid)
            created = attr.get("created_at")
            objs.append({
                "object_id": oid,
                "size": info["data_size"] + info["meta_size"],
                "refcount": info["refcount"],
                "pinned": info["pinned"],
                "sealed": True,
                "owner": attr.get("owner", ""),
                "task": attr.get("task", ""),
                "callsite": attr.get("callsite", ""),
                "age_s": round(now - created, 3) if created else None,
            })
        objs.sort(key=lambda r: r["size"], reverse=True)
        report["objects"] = objs
        return report

    # -- resource-view gossip ----------------------------------------------

    def _my_view_entry(self) -> dict:
        with self._lock:
            qdepth = len(self._task_queue)
            self._view_version += 1
            version = self._view_version
            draining = self._draining
        return {
            # A draining node gossips zero availability so no peer picks
            # it as a spillback target (leased admission rejects anyway).
            "available": {} if draining else dict(self.pool.available()),
            "queue": qdepth,
            "version": version,
            "address": self.address,
            "ts": time.time(),
        }

    def _merge_view(self, theirs: dict) -> None:
        with self._lock:
            for nid, entry in (theirs or {}).items():
                if nid == self.node_id:
                    continue  # we are authoritative for ourselves
                cur = self._cluster_view.get(nid)
                if cur is None or entry.get("version", 0) > \
                        cur.get("version", 0):
                    self._cluster_view[nid] = entry

    def rpc_gossip(self, their_view: dict) -> dict:  # idempotent
        """Push-pull anti-entropy exchange: merge the caller's view,
        return ours (ray_syncer.h bidirectional sync analog)."""
        self._merge_view(their_view)
        with self._lock:
            return dict(self._cluster_view)

    def rpc_peer_view(self) -> dict:  # idempotent (read-only)
        """The gossiped cluster load view, for client-side spillback
        target selection (no head involved)."""
        with self._lock:
            return dict(self._cluster_view)

    def _gossip_client(self, address: str) -> RpcClient:
        with self._lock:
            c = self._gossip_clients.get(address)
            if c is None:
                if len(self._gossip_clients) > 128:
                    self._gossip_clients.popitem(last=False)[1].close()
                c = self._gossip_clients[address] = RpcClient(
                    address, timeout=10.0)
            return c

    def _gossip_loop(self):
        import random

        from ray_tpu_torch.cluster.rpc import ConnectionLost

        tick = 0
        interval = config.gossip_interval_s
        while not self._shutdown.wait(interval):
            tick += 1
            # Adaptive cadence: anti-entropy converges in O(log n) rounds
            # whatever the interval, but n agents x fanout at a fixed
            # interval is O(n) RPCs/s cluster-wide. The stretch is capped
            # so entries stay fresher than the spillback consumer's 10 s
            # staleness gate (client.py _spill_to_peers) after O(log n)
            # hops.
            with self._lock:
                n_peers = max(0, len(self._cluster_view) - 1)  # minus self
            interval = config.gossip_interval_s * min(
                8.0, max(1.0, n_peers / 4.0))
            mine = self._my_view_entry()
            with self._lock:
                self._cluster_view[self.node_id] = mine
            if tick % max(1, config.gossip_membership_every) == 1:
                # Membership from the head (its job): learn joins, drop
                # nodes it declared dead.
                try:
                    nodes = self.head.call("nodes", timeout=5.0)
                    alive = {n["NodeID"]: n["Address"]
                             for n in nodes if n["Alive"]}
                    with self._lock:
                        for nid, addr in alive.items():
                            if nid != self.node_id and \
                                    nid not in self._cluster_view:
                                self._cluster_view[nid] = {
                                    "available": {}, "queue": 0,
                                    "version": 0, "address": addr,
                                    "ts": 0.0,
                                }
                        for nid in list(self._cluster_view):
                            if nid != self.node_id and nid not in alive:
                                del self._cluster_view[nid]
                except Exception:
                    # A head hiccup: keep gossiping the stale view.
                    _metrics.count_loop_restart("agent.gossip")
            with self._lock:
                peers = [(nid, e["address"])
                         for nid, e in self._cluster_view.items()
                         if nid != self.node_id and e.get("address")]
                snapshot = dict(self._cluster_view)
            if not peers:
                continue
            for _nid, addr in random.sample(
                    peers, min(config.gossip_fanout, len(peers))):
                try:
                    theirs = self._gossip_client(addr).call(
                        "gossip", snapshot, timeout=5.0)
                    self._merge_view(theirs)
                except (ConnectionLost, OSError):
                    continue  # peer down: membership refresh cleans up

    # -- lifecycle --------------------------------------------------------

    def _heartbeat_loop(self):
        beats = 0
        while not self._shutdown.wait(config.heartbeat_interval_s):
            try:
                resp = self.head.call(
                    "heartbeat", self.node_id, self.pool.available(),
                    timeout=5.0,
                )
                if not resp.get("ok"):
                    # Head declared us dead: actually exit (kill workers,
                    # stop serving) instead of running on as a zombie node.
                    self.stop()
                    return
                beats += 1
                every = config.clock_probe_every_beats
                if every > 0 and beats % every == 0:
                    self._probe_clock()
            except Exception:
                continue

    def _probe_clock(self):
        """NTP-style offset estimate against the head's clock on the
        heartbeat cadence: offset = ((t1-t0)+(t2-t3))/2, rtt the quality
        weight. The head's trace assembly shifts this node's span
        timestamps by it. Suppressed: the probe records no spans."""
        from ray_tpu_torch.util import tracing as _tracing

        try:
            with _tracing.suppressed():
                t0 = time.time()
                t1, t2 = self.head.call("clock_probe", t0, timeout=5.0)
                t3 = time.time()
                offset = ((t1 - t0) + (t2 - t3)) / 2.0
                rtt = (t3 - t0) - (t2 - t1)
                self.head.call("report_clock", self.node_id, offset,
                               rtt, timeout=5.0)
        except Exception:
            pass  # best-effort: the next probe retries

    def rpc_ping(self):  # idempotent (read-only)
        return "pong"

    def rpc_shutdown_node(self):
        threading.Thread(target=self.stop, daemon=True).start()
        return True

    def close_outbound_clients(self):
        """Close this agent's outbound clients (head, owners) so threads
        blocked in a reconnect window (the head client retries for
        head_reconnect_window_s) observe ``_closed`` and exit NOW — a
        stopped agent must not leave heartbeat threads retrying past
        teardown into the next test's cluster."""
        with self._lock:
            outbound = [self.head, *self._gossip_clients.values(),
                        *self._owner_clients.values()]
        for c in outbound:
            try:
                c.close()
            except Exception:
                pass

    def stop(self):
        with self._lock:
            if getattr(self, "_stopped", False):
                done = self._stop_done
            else:
                done = None
                self._stopped = True
                self._stop_done = threading.Event()
        if done is not None:
            # Another thread (the head's shutdown_node RPC, or the
            # heartbeat loop after the head declared us dead) is already
            # stopping this agent: wait it out so callers get the
            # synchronous contract — by return, the store is
            # closed/unlinked and no native call can race a new segment.
            done.wait(15.0)
            return
        try:
            self._stop_inner()
        finally:
            self._stop_done.set()

    def _stop_inner(self):
        self._shutdown.set()
        # Retract this node's worker series (tests run many agents in one
        # process; a stopped node must leave no stale gauge children).
        with self._telemetry_lock:
            for wid, pid in self._exported_gauges:
                self._retract_worker_series(wid, pid)
            self._exported_gauges = set()
            tags = {"node_id": self.node_id}
            _metrics.NODE_WORKER_COUNT.remove(tags=tags)
            # The device, store and goodput series die with the node: a
            # dead node must not keep reporting into the federated scrape.
            for wid, dev in self._exported_device:
                self._retract_device_series(wid, dev)
            self._exported_device = set()
            _metrics.DEVICE_COUNT.remove(tags=tags)
            if self._store_gauges_exported:
                _metrics.OBJECT_STORE_BYTES_USED.remove(tags=tags)
                _metrics.OBJECT_STORE_BYTES_CAPACITY.remove(tags=tags)
                _metrics.OBJECT_STORE_OBJECTS.remove(tags=tags)
                self._store_gauges_exported = False
            _metrics.OBJECT_STORE_EVICTIONS.remove(tags=tags)
            _metrics.AGENT_METRICS_RENDER_SECONDS.remove(tags=tags)
            for wid in list(self._train_gauges):
                self._retract_train_series(wid)
            for wid in list(self._serve_gauges):
                self._retract_serve_series(wid)
        with self._lock:
            workers = list(self._workers.values())
        for w in workers:
            if w.proc.poll() is None:
                w.proc.kill()
        for w in workers:
            try:
                w.proc.wait(timeout=5)
            except Exception:
                pass
        self._server.stop()
        self.close_outbound_clients()
        # The reap loop may be mid-iteration on the workers just killed;
        # let it finish before the store detaches (release_dead on a
        # closed segment is guarded, but ordering keeps cleanup complete).
        try:
            self._reap_thread.join(timeout=10.0)
        except RuntimeError:
            pass  # stop() invoked from the reap thread itself
        self.store.close(unlink=True)
        with self._spill_lock:
            self.spill_backend.close()  # the node's own directory goes
        # The log directory (worker logs, OOM reports, captures) outlives
        # the agent for post-mortems; ``Cluster.shutdown`` removes its
        # nodes' directories.


def main(argv=None):
    """A standalone agent joining the head at ``--head``. Its first
    SIGTERM is a preemption notice: the node self-drains with reason
    ``"preemption"`` (the head migrates its actors and placement groups,
    owners get the retry exemption, and the head shuts the agent down);
    a second SIGTERM, or SIGINT, stops it at once."""
    import argparse
    import json
    import signal

    parser = argparse.ArgumentParser()
    parser.add_argument("--head", required=True)
    parser.add_argument("--num-cpus", type=float, default=None)
    parser.add_argument("--num-gpus", type=float, default=None)
    parser.add_argument("--resources", default="{}")
    parser.add_argument("--store-capacity", type=int,
                        default=DEFAULT_STORE_CAPACITY)
    parser.add_argument("--session", default=None)
    args = parser.parse_args(argv)

    # Standalone agents sweep dead runs' leaked shm segments before
    # allocating their own (same hygiene as cluster_utils.Cluster).
    from ray_tpu_torch.util.shm_sweep import sweep_stale_shm

    sweep_stale_shm()
    agent = NodeAgent(
        args.head,
        num_cpus=args.num_cpus,
        num_gpus=args.num_gpus,
        resources=json.loads(args.resources),
        store_capacity=args.store_capacity,
        session=args.session,
    )
    def _on_signal(signum, _frame):
        if signum == signal.SIGTERM and not agent._shutdown.is_set():
            with agent._lock:
                first = not agent._draining
            if first:
                threading.Thread(
                    target=agent._self_drain, args=("preemption",),
                    daemon=True,
                ).start()
                return
        threading.Thread(target=agent.stop, daemon=True).start()

    # The handlers are in place before the node announces itself: a
    # SIGTERM sent as soon as NODE_ID is read must drain the node, not
    # kill the process by the default action.
    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    print(f"NODE_ID={agent.node_id}", flush=True)
    print(f"NODE_ADDRESS={agent.address}", flush=True)
    agent._shutdown.wait()
    agent.stop()


if __name__ == "__main__":
    main()
