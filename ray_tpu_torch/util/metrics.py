"""Counter / Gauge / Histogram, the Prometheus text exposition and its
parser (the parts of ``ray_tpu/util/metrics.py`` the serving engine and
the Serve runtime, the train session and trainer, the data library, the
cluster head's drain, placement-group reschedule, pubsub and persistence
planes, the RPC reconnects, the object plane's spills and restores, the
memory monitor's kills, and their tests call).

The registry is this process's own. A cluster federates the registries
of its head and agents into one scrape (``merge_prometheus``; the head's
``/metrics/cluster``, served by ``serve_metrics``); a worker's training
observations reach its agent's registry over the event batch
(``util/goodput.py``). The metric families keep the JAX package's names,
so one scrape reads the same for either engine.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: "List[Metric]" = []

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
]


class Metric:
    metric_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        tags = tags or {}
        missing = set(self.tag_keys) - set(tags)
        if missing:
            raise ValueError(f"metric {self.name} missing tags {missing}")
        return tuple(tags[k] for k in self.tag_keys)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> bool:
        """Drop one tagged series; returns whether it existed."""
        key = self._key(tags)
        removed = False
        with self._lock:
            for table in ("_values", "_counts", "_sums", "_totals"):
                d = getattr(self, table, None)
                if d is not None and d.pop(key, None) is not None:
                    removed = True
        return removed

    def series(self) -> List[Dict[str, str]]:
        """Tag dicts of every live child."""
        keys: List[Tuple] = []
        with self._lock:
            for table in ("_values", "_counts"):
                d = getattr(self, table, None)
                if d is not None:
                    keys.extend(d.keys())
        return [dict(zip(self.tag_keys, k)) for k in dict.fromkeys(keys)]

    def _fmt_tags(self, key: Tuple, extra=()) -> str:
        pairs = list(zip(self.tag_keys, key)) + list(extra)
        if not pairs:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {self.description}",
                f"# TYPE {self.name} {self.metric_type}"]

    def expose(self) -> List[str]:
        out = self._header()
        with self._lock:
            for key, v in self._values.items():
                out.append(f"{self.name}{self._fmt_tags(key)} {v}")
        return out


class Counter(Metric):
    metric_type = "counter"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    metric_type = "gauge"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            self._values[key] = float(value)

    def get(self, tags: Optional[Dict[str, str]] = None) -> Optional[float]:
        """The series' value, None where it is not set."""
        key = self._key(tags)
        with self._lock:
            return self._values.get(key)


class Histogram(Metric):
    metric_type = "histogram"

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        super().__init__(name, description, tag_keys)
        self.boundaries = list(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def expose(self) -> List[str]:
        out = self._header()
        with self._lock:
            for key, counts in self._counts.items():
                cumulative = 0
                for bound, c in zip(self.boundaries + ["+Inf"], counts):
                    cumulative += c
                    tags = self._fmt_tags(key, [("le", str(bound))])
                    out.append(f"{self.name}_bucket{tags} {cumulative}")
                tags = self._fmt_tags(key)
                out.append(f"{self.name}_sum{tags} {self._sums[key]}")
                out.append(f"{self.name}_count{tags} {self._totals[key]}")
        return out


# -- the families this package records -------------------------------------

SERVE_LATENCY_BOUNDARIES = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
]
# The Serve request path (serve/_private.py, serve/_observability.py):
# every family node_id-tagged, as the JAX package's, so one agent's series
# never federates as another's.
SERVE_REQUEST_SECONDS = Histogram(
    "ray_tpu_serve_request_seconds",
    "Serve request wall time per phase (route=router assign, "
    "queue_wait=assign to replica execution, batch_wait=time queued in "
    "a @serve.batch queue, execute=user callable, serialize=response "
    "serialize/transfer remainder, total=end to end)",
    boundaries=SERVE_LATENCY_BOUNDARIES,
    tag_keys=("node_id", "deployment", "phase"),
)
SERVE_REQUESTS_TOTAL = Counter(
    "ray_tpu_serve_requests_total",
    "Serve requests by terminal status (ok/error/shed), counted once "
    "at the router",
    tag_keys=("node_id", "deployment", "status"),
)
SERVE_SHED_TOTAL = Counter(
    "ray_tpu_serve_shed_total",
    "Deadline-expired serve requests shed instead of executed, by the "
    "site that shed them",
    tag_keys=("node_id", "deployment", "reason"),
)
SERVE_REPLICA_ONGOING = Gauge(
    "ray_tpu_serve_replica_ongoing",
    "In-flight requests executing on one serve replica",
    tag_keys=("node_id", "deployment", "replica"),
)
SERVE_ROUTER_QUEUE_DEPTH = Gauge(
    "ray_tpu_serve_router_queue_depth",
    "Requests blocked in a router process waiting for replica capacity "
    "(backpressure behind max_concurrent_queries)",
    tag_keys=("node_id", "deployment", "worker"),
)
SERVE_BATCH_SIZE = Histogram(
    "ray_tpu_serve_batch_size",
    "Items per executed @serve.batch batch",
    boundaries=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_RECONCILE_SECONDS = Gauge(
    "ray_tpu_serve_reconcile_seconds",
    "Duration of the serve controller's last reconcile pass (health "
    "probes + autoscaling + replica convergence)",
    tag_keys=("node_id",),
)
SERVE_EVENTS_DROPPED = Counter(
    "ray_tpu_serve_events_dropped_total",
    "Serve observations discarded by a worker's bounded ship buffer "
    "before the event flusher drained them",
    tag_keys=("node_id",),
)
SERVE_DECODE_STEP_SECONDS = Histogram(
    "ray_tpu_serve_decode_step_seconds",
    "Wall time of one decode iteration of the LLM engine (device step + "
    "host sampling sync)",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_BATCH_OCCUPANCY = Histogram(
    "ray_tpu_serve_decode_batch_occupancy",
    "Active slots per decode iteration",
    boundaries=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_TTFT_SECONDS = Histogram(
    "ray_tpu_serve_decode_ttft_seconds",
    "Time to first token per admitted stream (submit -> first token "
    "available for delivery, engine-side)",
    boundaries=SERVE_LATENCY_BOUNDARIES + [120.0, 300.0, 600.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_TOKENS_TOTAL = Counter(
    "ray_tpu_serve_decode_tokens_total",
    "Tokens produced by the LLM decode engine (prefill first tokens + "
    "decode-step tokens, all streams)",
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_ITL_SECONDS = Histogram(
    "ray_tpu_serve_decode_itl_seconds",
    "Inter-token latency per decode-step token: wall time from a "
    "stream's previous token to this one, engine-side",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5],
    tag_keys=("node_id", "deployment"),
)
TRAIN_STEP_ANATOMY_SECONDS = Gauge(
    "ray_tpu_step_phase_seconds",
    "Most recent step-anatomy decomposition per rank: data_wait / host "
    "(dispatch until device launch) / compute (synced device wall) / "
    "sync (barrier skew)",
    tag_keys=("node_id", "trial", "phase", "rank"),
)
TRAIN_STEP_PHASE_SECONDS = Histogram(
    "ray_tpu_train_step_phase_seconds",
    "Wall time of one training-step phase per reported step (data_wait "
    "/ step / report / checkpoint_save / checkpoint_restore), driven "
    "from the session API",
    boundaries=[0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0],
    tag_keys=("node_id", "trial", "phase"),
)
TRAIN_RANK_STEP_SECONDS = Gauge(
    "ray_tpu_train_rank_step_seconds",
    "Most recent step compute seconds per rank of a gang (the "
    "straggler gauge); retracted when the trial stops",
    tag_keys=("node_id", "trial", "rank"),
)
TRAIN_REPORTS_TOTAL = Counter(
    "ray_tpu_train_reports_total",
    "session.report calls per trial (all ranks)",
    tag_keys=("node_id", "trial"),
)
TRAIN_DOWNTIME_SECONDS = Counter(
    "ray_tpu_train_downtime_seconds_total",
    "Non-productive trial wall seconds attributed by the trainer's "
    "downtime ledger (cause: drain:<reason> / preemption / failure)",
    tag_keys=("node_id", "trial", "cause"),
)
TRAIN_MFU_PERCENT = Gauge(
    "ray_tpu_mfu_percent",
    "Model-FLOPs utilization per rank: FlopCounterMode FLOPs per step "
    "(util/xla_cost) over the synced step wall, against the measure.py "
    "per-device peak; retracted when the trial stops",
    tag_keys=("node_id", "trial", "rank"),
)
# -- the data library's input-pipeline families (recorded through
# util/goodput.py: dataset stages, consumer-loop stall accounting, dynamic
# block splits, and the autoscaling actor pools' size and queue depth).
DATA_STAGE_SECONDS = Histogram(
    "ray_tpu_data_stage_seconds",
    "Wall time of one executed dataset stage (driver-observed, whole "
    "stage across its blocks)",
    boundaries=[0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 15.0,
                60.0, 300.0],
    tag_keys=("node_id", "stage"),
)
DATA_BLOCK_SECONDS = Histogram(
    "ray_tpu_data_block_seconds",
    "Wall time of one block through one dataset stage (task-measured)",
    boundaries=[0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0,
                30.0],
    tag_keys=("node_id", "stage"),
)
DATA_BLOCK_ROWS = Histogram(
    "ray_tpu_data_block_rows",
    "Rows per output block of a dataset stage (skew shows up here)",
    boundaries=[1.0, 16.0, 64.0, 256.0, 1024.0, 4096.0, 16384.0,
                65536.0, 262144.0, 1048576.0],
    tag_keys=("node_id", "stage"),
)
DATA_BLOCK_BYTES = Histogram(
    "ray_tpu_data_block_bytes",
    "Bytes per output block of a dataset stage",
    boundaries=[1e3, 1e4, 1e5, 1e6, 1e7, 1e8, 1e9, 1e10],
    tag_keys=("node_id", "stage"),
)
DATA_ITER_SECONDS = Histogram(
    "ray_tpu_data_iter_seconds",
    "Consumer-loop time per batch by phase (wait=consumer starved for "
    "the next batch, user=consumer's own time between batches, "
    "transfer=host->device dispatch in iter_device_batches); the "
    "derived stall fraction is wait.sum / (wait.sum + user.sum)",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0],
    tag_keys=("node_id", "phase"),
)
DATA_PREFETCH_OCCUPANCY = Histogram(
    "ray_tpu_data_prefetch_occupancy",
    "Prefetch-buffer occupancy observed as the consumer takes each "
    "block batch (0 = the producer never gets ahead: every batch "
    "starves)",
    boundaries=[0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0],
    tag_keys=("node_id",),
)
DATA_BLOCK_SPLITS = Counter(
    "ray_tpu_block_splits_total",
    "Extra output blocks produced by dynamic block splitting (a stage "
    "whose output exceeded target_block_size_bytes)",
    tag_keys=("node_id", "stage"),
)
DATA_POOL_SIZE = Gauge(
    "ray_tpu_data_pool_size",
    "Live actors in an autoscaling dataset actor pool "
    "(ActorPoolStrategy(min, max): grows on queue depth, shrinks on "
    "idle)",
    tag_keys=("node_id", "pool"),
)
DATA_POOL_QUEUE_DEPTH = Gauge(
    "ray_tpu_data_pool_queue_depth",
    "Blocks queued behind an autoscaling dataset actor pool (the "
    "scale-up pressure signal, sampled at scale decisions)",
    tag_keys=("node_id", "pool"),
)
# -- node drain lifecycle (head-side; the drain coordinator records one
# increment per initiated drain and the wall time from DRAINING to
# deregistration, so preemption churn is visible per reason).
NODE_DRAINS_TOTAL = Counter(
    "ray_tpu_node_drains_total",
    "Node drains initiated, by reason (preemption, autoscaler_idle, ...)",
    tag_keys=("reason",),
)
NODE_DRAIN_DURATION_SECONDS = Histogram(
    "ray_tpu_node_drain_duration_seconds",
    "Wall time from drain start to node deregistration",
    boundaries=[0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0],
    tag_keys=("reason",),
)
NODE_DRAIN_ACTORS_MIGRATED = Counter(
    "ray_tpu_node_drain_actors_migrated_total",
    "Actors proactively reconstructed off draining nodes",
    tag_keys=("reason",),
)
# -- placement-group rescheduling (head-side; one increment per completed
# bundle migration, and the wall time from losing a bundle's node to the
# reservation being whole again on healthy nodes).
PG_RESCHEDULES_TOTAL = Counter(
    "ray_tpu_pg_reschedules_total",
    "Completed placement-group reschedules, by trigger cause "
    "(drain = planned departure, node_death = crash-detected loss)",
    tag_keys=("cause",),
)
PG_RESCHEDULE_SECONDS = Histogram(
    "ray_tpu_pg_reschedule_seconds",
    "Wall time from a gang bundle losing its node to the group's "
    "reservation being CREATED again on healthy nodes",
    boundaries=[0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 60.0,
                120.0],
)
# -- the head's pubsub plane (cluster/pubsub.py).
PUBSUB_COALESCED = Counter(
    "ray_tpu_pubsub_coalesced_total",
    "Pubsub messages absorbed by per-(subscriber,channel,key) "
    "coalescing (subscriber saw latest state instead of history)",
)
PUBSUB_DROPPED = Counter(
    "ray_tpu_pubsub_dropped_total",
    "Pubsub messages dropped on slow-subscriber buffer overflow",
)
TRACING_DROPPED_SPANS = Counter(
    "ray_tpu_tracing_dropped_spans_total",
    "Finished spans dropped by this process's bounded span buffer",
    tag_keys=("node_id",),
)
HEAD_SPANS_DROPPED = Counter(
    "ray_tpu_head_spans_dropped_total",
    "Tracing spans dropped by the head's bounded span ring",
)
HEAD_TRACES_DROPPED = Counter(
    "ray_tpu_head_traces_dropped_total",
    "Assembled traces evicted from the head's bounded trace store, "
    "by cause (sampled = tail-sampling declined, evicted = retention "
    "cap, span_cap = per-trace span limit clipped spans)",
    tag_keys=("cause",),
)
# -- the state API's records and the node reporter (cluster/node_agent.py).
TASK_RECORDS_EVICTED = Counter(
    "ray_tpu_task_records_evicted_total",
    "Finished task records evicted from a node agent's bounded ring",
    tag_keys=("node_id",),
)
TASK_PHASE_SECONDS = Histogram(
    "ray_tpu_task_phase_seconds",
    "Wall time of one task execution phase (get_args/execute/put_outputs)",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0],
    tag_keys=("node_id", "phase"),
)
WORKER_CPU_PERCENT = Gauge(
    "ray_tpu_worker_cpu_percent",
    "CPU utilization of a worker process (percent of one core)",
    tag_keys=("node_id", "worker_id", "pid"),
)
WORKER_RSS_BYTES = Gauge(
    "ray_tpu_worker_rss_bytes",
    "Resident set size of a worker process in bytes",
    tag_keys=("node_id", "worker_id", "pid"),
)
WORKER_UPTIME_SECONDS = Gauge(
    "ray_tpu_worker_uptime_seconds",
    "Seconds since the worker process was spawned",
    tag_keys=("node_id", "worker_id", "pid"),
)
NODE_WORKER_COUNT = Gauge(
    "ray_tpu_node_worker_count",
    "Live worker processes on a node",
    tag_keys=("node_id",),
)
# -- the head's write-behind persistence (cluster/head.py).
HEAD_PERSIST_QUEUE_DEPTH = Gauge(
    "ray_tpu_head_persist_queue_depth",
    "Dirty keys waiting in the head's write-behind persistence queue",
)
HEAD_PERSIST_FLUSH_SECONDS = Histogram(
    "ray_tpu_head_persist_flush_seconds",
    "Wall time of one write-behind sqlite batch transaction",
    boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 1.0],
)
HEAD_PERSIST_COALESCED = Counter(
    "ray_tpu_head_persist_coalesced_total",
    "Per-key writes absorbed by the write-behind queue before a flush",
)
# -- the RPC plane (client side; one increment a reconnect attempt of a
# retry-windowed call that lost its connection, by peer).
RPC_RECONNECTS_TOTAL = Counter(
    "ray_tpu_rpc_reconnects_total",
    "RPC reconnect attempts after connection loss, by peer address",
    tag_keys=("peer",),
)
# -- the object plane: spilling and restores (agent side).
OBJECT_SPILL_DENIED = Counter(
    "ray_tpu_object_spill_denied_total",
    "Spill requests that could not free the requested bytes "
    "(everything left referenced or pinned)",
    tag_keys=("node_id",),
)
SPILL_BYTES_TOTAL = Counter(
    "ray_tpu_spill_bytes_total",
    "Bytes written to the node's spill target under memory pressure",
    tag_keys=("node_id",),
)
SPILL_RESTORES_TOTAL = Counter(
    "ray_tpu_spill_restores_total",
    "Spilled objects read back for a node (local spill-file reads and "
    "restores from a spill URI)",
    tag_keys=("node_id",),
)
OOM_KILLS_TOTAL = Counter(
    "ray_tpu_oom_kills_total",
    "Workers killed by the node memory monitor under memory pressure",
    tag_keys=("node_id",),
)
LOOP_RESTARTS_TOTAL = Counter(
    "ray_tpu_loop_restarts_total",
    "Exceptions a daemon loop survived (swallowed and re-entered the "
    "iteration), by loop name",
    tag_keys=("loop",),
)

# -- the cluster's operations plane: the head's RPC handlers and lock
# shards, the agents' device and store gauges, the signal plane's ring
# and the SLOs it evaluates.
HEAD_RPC_SECONDS = Histogram(
    "ray_tpu_head_rpc_seconds",
    "Head RPC handler wall time, per method",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5],
    tag_keys=("method",),
)
HEAD_LOCK_WAIT_SECONDS = Histogram(
    "ray_tpu_head_lock_wait_seconds",
    "Time head threads spent blocked acquiring a contended lock shard "
    "(nodes = node/actor/PG tables, objects = object/ref tables, "
    "events = spans/logs)",
    boundaries=[0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0],
    tag_keys=("shard",),
)
# CUDA devices a node's workers use, from the workers' own snapshots
# (util/device_telemetry.py): the agent never makes a CUDA context.
DEVICE_COUNT = Gauge(
    "ray_tpu_device_count",
    "CUDA devices the workers of a node report (0 = no worker has "
    "initialised CUDA)",
    tag_keys=("node_id",),
)
DEVICE_MEM_IN_USE = Gauge(
    "ray_tpu_device_memory_bytes_in_use",
    "Device bytes a worker process's caching allocator holds in live "
    "allocations, per device",
    tag_keys=("node_id", "worker_id", "device"),
)
DEVICE_MEM_PEAK = Gauge(
    "ray_tpu_device_memory_peak_bytes",
    "Peak device bytes in live allocations of a worker process, per "
    "device",
    tag_keys=("node_id", "worker_id", "device"),
)
DEVICE_MEM_LIMIT = Gauge(
    "ray_tpu_device_memory_bytes_limit",
    "Total memory of a device a worker process uses",
    tag_keys=("node_id", "worker_id", "device"),
)
OBJECT_STORE_BYTES_USED = Gauge(
    "ray_tpu_object_store_bytes_used",
    "Bytes resident in a node's shared-memory object store",
    tag_keys=("node_id",),
)
OBJECT_STORE_BYTES_CAPACITY = Gauge(
    "ray_tpu_object_store_bytes_capacity",
    "Byte capacity of a node's shared-memory object store",
    tag_keys=("node_id",),
)
OBJECT_STORE_OBJECTS = Gauge(
    "ray_tpu_object_store_objects",
    "Objects resident in a node's shared-memory object store",
    tag_keys=("node_id",),
)
OBJECT_STORE_EVICTIONS = Counter(
    "ray_tpu_object_store_evictions_total",
    "Objects evicted from a node's object store (LRU or spill-evict)",
    tag_keys=("node_id",),
)
AGENT_METRICS_RENDER_SECONDS = Gauge(
    "ray_tpu_agent_metrics_render_seconds",
    "Wall seconds the node agent spent rendering its previous "
    "metrics_text response (one scrape behind by construction)",
    tag_keys=("node_id",),
)
HEAD_SIGNAL_SCRAPE_SECONDS = Histogram(
    "ray_tpu_head_signal_scrape_seconds",
    "Wall time of one head signal-plane self-scrape (federated "
    "cluster_metrics_text render + parse + ring ingest)",
    boundaries=[0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0, 2.5],
)
HEAD_SIGNAL_SERIES = Gauge(
    "ray_tpu_head_signal_series",
    "Distinct time series retained in the head's signal-plane history "
    "ring (bounded by signal_max_series)",
)
HEAD_SIGNAL_EVICTIONS_TOTAL = Counter(
    "ray_tpu_head_signal_evictions_total",
    "Series evicted from the head's signal-plane ring, by reason "
    "(series_cap = ring full at signal_max_series, dead_node = node "
    "died, stale = series stopped reporting for a full history window)",
    tag_keys=("reason",),
)
SLO_STATE = Gauge(
    "ray_tpu_slo_state",
    "Burn-rate state of a registered SLO (0=ok 1=warning 2=burning)",
    tag_keys=("slo",),
)
SLO_VALUE = Gauge(
    "ray_tpu_slo_value",
    "Most recent windowed value of a registered SLO's signal",
    tag_keys=("slo",),
)
SLO_THRESHOLD = Gauge(
    "ray_tpu_slo_threshold",
    "Configured threshold of a registered SLO",
    tag_keys=("slo",),
)
TRAIN_EVENTS_DROPPED = Counter(
    "ray_tpu_train_events_dropped_total",
    "Goodput observations discarded by a worker's bounded ship buffer "
    "before the event flusher drained them (no silent caps)",
    tag_keys=("node_id",),
)


def count_loop_restart(loop: str) -> None:
    """One survived daemon-loop exception. Never raises: the survival
    handler calling this is its loop's last line of defense."""
    try:
        LOOP_RESTARTS_TOTAL.inc(tags={"loop": loop})
    except Exception:
        pass


def retract_loop_series(loops: Sequence[str]) -> None:
    """Drop the loop-restart children a stopping component owns. Never
    raises (stop paths call it)."""
    for loop in loops:
        try:
            LOOP_RESTARTS_TOTAL.remove(tags={"loop": loop})
        except Exception:
            pass


def registered() -> "List[Metric]":
    """Snapshot of the registry."""
    with _registry_lock:
        return list(_registry)


def prometheus_text() -> str:
    """The whole registry in Prometheus exposition format."""
    lines: List[str] = []
    for m in registered():
        lines.extend(m.expose())
    return "\n".join(lines) + "\n"


def merge_prometheus(chunks: Sequence[str],
                     owners: Optional[Sequence[Optional[str]]] = None) -> str:
    """Merge several exposition bodies into one scrape-able document
    (the head's ``/metrics/cluster`` federation). ``# HELP``/``# TYPE``
    headers are kept once per metric family, and duplicate SERIES
    (same metric name + label set) keep their first-seen place: the
    agents of an in-process cluster share ONE process registry, so
    every agent reports the same series (possibly re-sampled between
    chunk renders -- identity is the name+labels, not the whole line);
    per-node series stay distinct through their ``node_id`` tag.

    ``owners`` names the node each chunk came from (None for the
    head's). A series tagged ``node_id="X"`` then takes its sample from
    X's own chunk where X's carries it: X refreshes its gauges just
    before it renders, while another render of the shared registry, made
    concurrently, can hold X's series as X last refreshed them."""
    preferred: dict = {}
    for chunk, owner in zip(chunks, owners or ()):
        if owner is None:
            continue
        tags = (f'{{node_id="{owner}"', f',node_id="{owner}"')
        for line in (chunk or "").splitlines():
            if not line.startswith("#") and any(t in line for t in tags):
                preferred.setdefault(line.rsplit(" ", 1)[0], line)
    seen_headers: set = set()
    seen_series: set = set()
    out: List[str] = []
    for chunk in chunks:
        for line in (chunk or "").splitlines():
            if not line.strip():
                continue
            if line.startswith("#"):
                parts = line.split(None, 3)
                key = tuple(parts[1:3])  # ("HELP"|"TYPE", metric name)
                if key in seen_headers:
                    continue
                seen_headers.add(key)
            else:
                series = line.rsplit(" ", 1)[0]  # name{labels}
                if series in seen_series:
                    continue
                seen_series.add(series)
                line = preferred.get(series, line)
            out.append(line)
    return "\n".join(out) + "\n"


def file_sd_targets(address: str, labels: Optional[Dict[str, str]] = None,
                    path: str = "/metrics/cluster") -> List[dict]:
    """Prometheus file-SD document pointing one scrape job at the head's
    federated endpoint: one entry covers the whole cluster."""
    return [{
        "targets": [address],
        "labels": {"job": "ray_tpu", "__metrics_path__": path,
                   **(labels or {})},
    }]


PROM_CONTENT_TYPE = "text/plain; version=0.0.4"


def serve_metrics(host: str = "127.0.0.1", port: int = 0,
                  routes: Optional[Dict[str, tuple]] = None):
    """HTTP exposition server. ``routes`` maps a path to ``(body_fn,
    content_type)``; defaults to the process registry at ``/metrics``.
    Returns ``(port, shutdown_fn)``."""
    import http.server

    route_map = dict(routes or {})
    route_map.setdefault("/metrics", (prometheus_text, PROM_CONTENT_TYPE))

    class Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):
            path = self.path.split("?", 1)[0].rstrip("/")
            entry = route_map.get(path or "/metrics")
            if entry is None:
                self.send_response(404)
                self.end_headers()
                return
            fn, ctype = entry
            try:
                body = fn().encode()
            except Exception as e:  # a scrape sees the failure, never hangs
                self.send_response(500)
                self.end_headers()
                self.wfile.write(repr(e).encode())
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):
            pass

    server = http.server.ThreadingHTTPServer((host, port), Handler)
    server.daemon_threads = True
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def shutdown():
        server.shutdown()
        server.server_close()

    return server.server_address[1], shutdown


def start_metrics_server(host: str = "127.0.0.1", port: int = 0) -> int:
    """Serve /metrics for Prometheus scraping; returns the bound port."""
    bound, _shutdown = serve_metrics(host, port)
    return bound


# -- reading an exposition back --------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> Dict[str, Dict[tuple, float]]:
    """Exposition text -> {metric_name: {sorted (label, value) tuple:
    sample value}} (comments skipped)."""
    out: Dict[str, Dict[tuple, float]] = {}
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.groups()
        try:
            val = float(value)
        except ValueError:
            continue
        labels = tuple(sorted(_LABEL_RE.findall(labels_raw or "")))
        out.setdefault(name, {})[labels] = val
    return out


def _labels_get(labels: tuple, key: str) -> Optional[str]:
    for k, v in labels:
        if k == key:
            return v
    return None


def _matches(labels: tuple, match: Dict[str, str]) -> bool:
    return all(_labels_get(labels, k) == v for k, v in match.items())


def sum_counter(parsed: dict, name: str, group_label: str,
                **match: str) -> Dict[str, float]:
    """Sum a family's samples across node_id (and any other label not
    grouped on), grouped by one label, filtered by exact label matches."""
    out: Dict[str, float] = {}
    for labels, val in (parsed.get(name) or {}).items():
        if _matches(labels, match):
            key = _labels_get(labels, group_label) or ""
            out[key] = out.get(key, 0.0) + val
    return out


def histogram_dist(parsed: dict, name: str, **match: str) -> Optional[dict]:
    """One histogram's cumulative buckets, sum and count, summed across
    node_id, filtered by exact label matches. Returns {"buckets":
    [(le, cum)], "sum": s, "count": n}, or None when nothing matched."""
    buckets: Dict[float, float] = {}
    for labels, val in (parsed.get(name + "_bucket") or {}).items():
        if _matches(labels, match):
            le_raw = _labels_get(labels, "le")
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
            buckets[le] = buckets.get(le, 0.0) + val
    total = sum(val for labels, val in (parsed.get(name + "_sum") or {})
                .items() if _matches(labels, match))
    count = sum(val for labels, val in (parsed.get(name + "_count") or {})
                .items() if _matches(labels, match))
    if not buckets or count <= 0:
        return None
    return {"buckets": sorted(buckets.items()), "sum": total,
            "count": count}


def quantile_from_buckets(dist: Optional[dict], q: float) -> Optional[float]:
    """Prometheus-style histogram_quantile: linear interpolation inside
    the bucket holding the q-th sample (the +Inf bucket clamps to the
    last finite bound, as in PromQL)."""
    if not dist:
        return None
    rank = q * dist["count"]
    prev_le, prev_cum = 0.0, 0.0
    last_finite = 0.0
    for le, cum in dist["buckets"]:
        if le != float("inf"):
            last_finite = le
        if cum >= rank and cum > prev_cum:
            if le == float("inf"):
                return last_finite
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = (0.0 if le == float("inf") else le), cum
    return last_finite


def bucket_width_at(dist: Optional[dict], value: float) -> float:
    """Width of the histogram bucket a value falls in: the resolution
    floor of any agreement check against a histogram quantile."""
    if not dist:
        return float("inf")
    prev = 0.0
    for le, _ in dist["buckets"]:
        if le == float("inf"):
            break
        if value <= le:
            return le - prev
        prev = le
    return float("inf")


def percentile(sorted_vals: Sequence[float], q: float) -> float:
    """Nearest-rank percentile of an ascending-sorted non-empty
    sequence."""
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q * (len(sorted_vals) - 1)))))
    return sorted_vals[idx]


def latency_dist_ms(vals_ms: Sequence[float]) -> Dict[str, float]:
    """{count, p50_ms, p99_ms, mean_ms} of a non-empty ms sample set."""
    vals = sorted(vals_ms)
    return {
        "count": len(vals),
        "p50_ms": round(percentile(vals, 0.50), 3),
        "p99_ms": round(percentile(vals, 0.99), 3),
        "mean_ms": round(sum(vals) / len(vals), 3),
    }


def diff_parsed(before: dict, after: dict) -> dict:
    """Per-series ``after - before``: isolates one run's counts from
    whatever the shared registry already held."""
    out: Dict[str, Dict[tuple, float]] = {}
    for name, series in after.items():
        base = before.get(name) or {}
        out[name] = {labels: val - base.get(labels, 0.0)
                     for labels, val in series.items()}
    return out
