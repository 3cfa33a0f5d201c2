"""Serve request-path observability: the SLO latency plane (port of
``ray_tpu/serve/_observability.py``).

Every hop of a serve request -- router assign, replica ongoing queue,
``@serve.batch`` queue, user callable, response serialize -- and every
decode iteration of the LLM engine records an observation here. Recording
is two-sided (reference :1-26, ``_emit`` :102-112):

* the observation lands in THIS process's registry at once
  (``util/metrics.py``): on the local backend replicas are threads of the
  driver, so this registry is what ``/metrics`` scrapes;
* the same observation goes into a bounded ship buffer that a cluster
  worker's event flusher drains into its batch (``drain_events``,
  ``cluster/workerproc.py``); the node agent replays it into its own
  registry (``apply_events``), the one the head federates on
  ``/metrics/cluster``, and retracts a dead worker's gauges
  (``retract_gauges``).

Also here: the per-request context that carries a deadline and the
caller's span context to the replica, the batch queue and the engine,
``RequestShedError``, and the readers of a parsed exposition that
``serve.stats()`` builds on (``metrics_text`` :341, ``deployment_stats``
:358, ``decode_stats`` :416, ``_history_deltas`` :456, ``stats`` :487).
"""

from __future__ import annotations

import collections
import contextvars
import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util.metrics import (  # noqa: F401  (re-exported)
    _labels_get,
    bucket_width_at,
    diff_parsed,
    histogram_dist,
    parse_prometheus,
    quantile_from_buckets,
    sum_counter,
)

# Phases a request can observe (the request histogram's phase values).
PHASES = ("route", "queue_wait", "batch_wait", "execute", "serialize",
          "total")


class RequestShedError(Exception):
    """A request whose deadline expired (or that found the queue full):
    shed by the router, the replica, the batch queue or the engine
    instead of run, with the site's ``reason``. The HTTP proxy answers it
    with 503."""

    def __init__(self, message: str, reason: str = "deadline"):
        super().__init__(message)
        self.reason = reason


# -- per-request context (the deadline rides the trace context) -----------

_request_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_request", default=None)


@contextmanager
def request_scope(deployment: str, deadline_ts: Optional[float],
                  trace_ctx: Optional[dict] = None):
    """Active while the replica runs the user callable: the batch queue
    and the engine's admission path read the deployment, the absolute
    deadline and the caller's span context from it (the engine's loop
    runs on its own thread, where no thread-local span stack reaches)."""
    token = _request_ctx.set({"deployment": deployment,
                              "deadline_ts": deadline_ts,
                              "trace_ctx": trace_ctx})
    try:
        yield
    finally:
        _request_ctx.reset(token)


def current_request() -> Optional[dict]:
    return _request_ctx.get()


# -- recording --------------------------------------------------------------

_LOCAL_NODE = "local"
# Ship buffer drained by the worker's event flusher; bounded so a process
# nothing drains (the local backend's driver) stays flat.
_buf: "collections.deque" = collections.deque(maxlen=8192)
_buf_lock = threading.Lock()
# Events the bounded buffer pushed out before a drain: reported as a drop
# event on the next drain, never a silent cap.
_buf_dropped = 0
# Router-side queue depth per deployment in THIS process.
_router_queued: Dict[str, int] = {}
_router_lock = threading.Lock()


def _emit(ev: dict) -> None:
    """Observe locally and queue for the agent (see the module
    docstring)."""
    global _buf_dropped
    try:
        apply_events([ev], node_id=_LOCAL_NODE)
    except Exception:
        pass
    with _buf_lock:
        if len(_buf) == _buf.maxlen:
            _buf_dropped += 1  # the deque discards the oldest silently
        _buf.append(ev)


def drain_events() -> List[dict]:
    """Pop the queued observations (the worker flusher's hook). An
    overflow before it leads as a drop event, so the agent's registry
    counts exactly what this process lost."""
    global _buf_dropped
    with _buf_lock:
        out = list(_buf)
        _buf.clear()
        if _buf_dropped:
            out.insert(0, {"k": "drop", "n": _buf_dropped})
            _buf_dropped = 0
    return out


def requeue_events(events: List[dict]) -> None:
    """Put drained observations back at the FRONT of the ship buffer (the
    flusher does when it gives up on a batch the agent never took).
    Overflow past capacity counts as drops, oldest first."""
    global _buf_dropped
    if not events:
        return
    with _buf_lock:
        space = _buf.maxlen - len(_buf)
        if space < len(events):
            _buf_dropped += len(events) - space
            events = events[len(events) - space:]
        _buf.extendleft(reversed(events))


def record_phases(deployment: str, phases: Dict[str, float]) -> None:
    """Observe wall seconds per request phase."""
    phases = {p: s for p, s in phases.items() if p in PHASES and s >= 0}
    if phases:
        _emit({"k": "ph", "d": deployment, "p": phases})


def record_status(deployment: str, status: str) -> None:
    """Count one terminal request outcome (at the router, the one place
    every request passes exactly once)."""
    _emit({"k": "st", "d": deployment, "s": status})


def record_shed(deployment: str, reason: str) -> None:
    """Count one shed at the site that shed it."""
    _emit({"k": "shed", "d": deployment, "r": reason})


def record_batch(deployment: str, size: int) -> None:
    _emit({"k": "batch", "d": deployment, "n": int(size)})


def record_reconcile(seconds: float) -> None:
    _emit({"k": "rec", "s": float(seconds)})


def record_decode_step(deployment: str, seconds: float, occupancy: int,
                       tokens: int) -> None:
    """One decode iteration: its wall time, active slots and tokens, in
    one event so a step is never half recorded."""
    _emit({"k": "dstep", "d": deployment, "s": float(seconds),
           "o": int(occupancy), "n": int(tokens)})


def record_ttft(deployment: str, seconds: float) -> None:
    """Time to first token for one admitted stream."""
    _emit({"k": "ttft", "d": deployment, "s": float(seconds)})


def record_decode_itl(deployment: str, seconds: float, tokens: int) -> None:
    """Inter-token latency for one decode step: every token it produced
    arrived ``seconds`` after its stream's previous one (the slots move
    in lockstep); replayed as ``tokens`` observations."""
    if tokens > 0 and seconds >= 0:
        _emit({"k": "itl", "d": deployment, "s": float(seconds),
               "n": int(tokens)})


def record_decode_tokens(deployment: str, tokens: int) -> None:
    """Tokens produced outside a decode step (each admitted stream's
    first token, from the prefill lane)."""
    if tokens > 0:
        _emit({"k": "dtok", "d": deployment, "n": int(tokens)})


def set_replica_ongoing(deployment: str, replica: str, ongoing: int) -> None:
    _emit({"k": "g", "d": deployment, "r": replica, "n": int(ongoing)})


def router_queue_delta(deployment: str, delta: int) -> None:
    """Track requests blocked in this process's router ``assign`` and
    export the absolute depth (the demand replicas cannot see behind
    ``max_concurrent_queries``)."""
    with _router_lock:
        n = max(0, _router_queued.get(deployment, 0) + delta)
        _router_queued[deployment] = n
    _emit({"k": "q", "d": deployment, "n": n})


def apply_events(events: List[dict], node_id: str,
                 worker: Optional[str] = None) -> List[Tuple]:
    """Replay shipped observations into THIS process's registry (the node
    agent calls it with its node id and the reporting worker's id).
    Returns the gauge keys the batch touched, so the agent can retract
    them when the worker dies."""
    worker = worker or str(os.getpid())
    gauge_keys: List[Tuple] = []
    for ev in events or []:
        try:
            kind = ev.get("k")
            dep = ev.get("d", "")
            tags = {"node_id": node_id, "deployment": dep}
            if kind == "ph":
                for phase, sec in (ev.get("p") or {}).items():
                    _metrics.SERVE_REQUEST_SECONDS.observe(
                        float(sec), tags={**tags, "phase": phase})
            elif kind == "st":
                _metrics.SERVE_REQUESTS_TOTAL.inc(
                    tags={**tags, "status": ev.get("s", "ok")})
            elif kind == "shed":
                _metrics.SERVE_SHED_TOTAL.inc(
                    tags={**tags, "reason": ev.get("r", "deadline")})
            elif kind == "batch":
                _metrics.SERVE_BATCH_SIZE.observe(float(ev.get("n", 0)),
                                                  tags=tags)
            elif kind == "rec":
                _metrics.SERVE_RECONCILE_SECONDS.set(
                    float(ev.get("s", 0.0)), tags={"node_id": node_id})
                gauge_keys.append(("reconcile",))
            elif kind == "g":
                rep = ev.get("r", "")
                _metrics.SERVE_REPLICA_ONGOING.set(
                    float(ev.get("n", 0)), tags={**tags, "replica": rep})
                gauge_keys.append(("ongoing", dep, rep))
            elif kind == "q":
                _metrics.SERVE_ROUTER_QUEUE_DEPTH.set(
                    float(ev.get("n", 0)), tags={**tags, "worker": worker})
                gauge_keys.append(("queued", dep, worker))
            elif kind == "dstep":
                _metrics.SERVE_DECODE_STEP_SECONDS.observe(
                    float(ev.get("s", 0.0)), tags=tags)
                _metrics.SERVE_DECODE_BATCH_OCCUPANCY.observe(
                    float(ev.get("o", 0)), tags=tags)
                n_tok = float(ev.get("n", 0))
                if n_tok > 0:
                    _metrics.SERVE_DECODE_TOKENS_TOTAL.inc(n_tok, tags=tags)
            elif kind == "ttft":
                _metrics.SERVE_DECODE_TTFT_SECONDS.observe(
                    float(ev.get("s", 0.0)), tags=tags)
            elif kind == "itl":
                # One observation a token of the step; bounded far above
                # any slot count so a corrupt event cannot spin here.
                gap = float(ev.get("s", 0.0))
                for _ in range(min(int(ev.get("n", 0)), 4096)):
                    _metrics.SERVE_DECODE_ITL_SECONDS.observe(gap, tags=tags)
            elif kind == "dtok":
                _metrics.SERVE_DECODE_TOKENS_TOTAL.inc(
                    float(ev.get("n", 0)), tags=tags)
            elif kind == "drop":
                _metrics.SERVE_EVENTS_DROPPED.inc(
                    float(ev.get("n", 0)), tags={"node_id": node_id})
        except Exception:
            continue  # one bad event must not drop the batch
    return gauge_keys


def retract_gauges(keys, node_id: str) -> None:
    """Drop the gauge children a dead worker's events created (the
    federated scrape must not go on reporting a dead replica)."""
    for key in keys or ():
        try:
            if key[0] == "ongoing":
                _metrics.SERVE_REPLICA_ONGOING.remove(tags={
                    "node_id": node_id, "deployment": key[1],
                    "replica": key[2]})
            elif key[0] == "queued":
                _metrics.SERVE_ROUTER_QUEUE_DEPTH.remove(tags={
                    "node_id": node_id, "deployment": key[1],
                    "worker": key[2]})
            elif key[0] == "reconcile":
                _metrics.SERVE_RECONCILE_SECONDS.remove(
                    tags={"node_id": node_id})
        except Exception:
            pass


# -- reading the plane back (serve.stats) ------------------------------------


def _ms(dist, q) -> Optional[float]:
    v = quantile_from_buckets(dist, q)
    return round(v * 1e3, 3) if v is not None else None


def metrics_text() -> str:
    """The scrape of record: the head's federated ``/metrics/cluster`` on
    a cluster backend, this process's registry on the local one."""
    from ray_tpu_torch._private import worker as _worker

    try:
        backend = _worker.backend()
    except Exception:
        backend = None
    if backend is not None and hasattr(backend, "cluster_metrics_text"):
        try:
            return backend.cluster_metrics_text()
        except Exception:
            pass
    return _metrics.prometheus_text()


def deployment_stats(parsed: dict, deployment: str) -> dict:
    """One deployment's rollup from a parsed exposition."""
    out: dict = {"deployment": deployment}
    dist = histogram_dist(parsed, "ray_tpu_serve_request_seconds",
                          deployment=deployment, phase="total")
    if dist:
        out["count"] = int(dist["count"])
        out["mean_ms"] = round(dist["sum"] / dist["count"] * 1e3, 3)
        out["p50_ms"] = _ms(dist, 0.50)
        out["p99_ms"] = _ms(dist, 0.99)
    phases = {}
    for phase in PHASES[:-1]:
        d = histogram_dist(parsed, "ray_tpu_serve_request_seconds",
                           deployment=deployment, phase=phase)
        if d:
            phases[phase] = {
                "count": int(d["count"]),
                "mean_ms": round(d["sum"] / d["count"] * 1e3, 3),
                "p50_ms": _ms(d, 0.50),
            }
    if phases:
        out["phases"] = phases
    statuses = sum_counter(parsed, "ray_tpu_serve_requests_total",
                           "status", deployment=deployment)
    if statuses:
        out["requests"] = {k: int(v) for k, v in statuses.items()}
    sheds = sum_counter(parsed, "ray_tpu_serve_shed_total", "reason",
                        deployment=deployment)
    if sheds:
        out["shed"] = {k: int(v) for k, v in sheds.items()}
    ongoing = sum_counter(parsed, "ray_tpu_serve_replica_ongoing",
                          "deployment", deployment=deployment)
    if ongoing:
        out["ongoing"] = int(sum(ongoing.values()))
    queued = sum_counter(parsed, "ray_tpu_serve_router_queue_depth",
                         "deployment", deployment=deployment)
    if queued:
        out["queued"] = int(sum(queued.values()))
    decode = decode_stats(parsed, deployment)
    if decode:
        out["decode"] = decode
    return out


def decode_stats(parsed: dict, deployment: str) -> dict:
    """One deployment's decode rollup (empty when it runs no engine):
    TTFT quantiles, ITL median, steps, mean occupancy, tokens."""
    out: dict = {}
    ttft = histogram_dist(parsed, "ray_tpu_serve_decode_ttft_seconds",
                          deployment=deployment)
    if ttft:
        out["streams"] = int(ttft["count"])
        out["ttft_p50_ms"] = _ms(ttft, 0.50)
        out["ttft_p99_ms"] = _ms(ttft, 0.99)
    itl = histogram_dist(parsed, "ray_tpu_serve_decode_itl_seconds",
                         deployment=deployment)
    if itl:
        out["itl_p50_ms"] = _ms(itl, 0.50)
    steps = histogram_dist(parsed, "ray_tpu_serve_decode_step_seconds",
                           deployment=deployment)
    if steps:
        out["steps"] = int(steps["count"])
        out["step_mean_ms"] = round(steps["sum"] / steps["count"] * 1e3, 3)
    occ = histogram_dist(parsed, "ray_tpu_serve_decode_batch_occupancy",
                         deployment=deployment)
    if occ:
        out["mean_occupancy"] = round(occ["sum"] / occ["count"], 3)
    tokens = sum_counter(parsed, "ray_tpu_serve_decode_tokens_total",
                         "deployment", deployment=deployment)
    if tokens:
        out["tokens"] = int(sum(tokens.values()))
    return out


def _history_deltas(window_s: float):
    """Windowed deltas of the request counter from the head's history
    ring, with no sleep: ``(deltas, actual_window_s)``, or ``(None, 0.0)``
    where no ring answers (the local backend, a ring with fewer than two
    samples)."""
    from ray_tpu_torch._private import worker as _worker

    try:
        backend = _worker.backend()
    except Exception:
        return None, 0.0
    if backend is None or not hasattr(backend, "query_metrics"):
        return None, 0.0
    try:
        res = backend.query_metrics(
            {"op": "series_delta",
             "name": "ray_tpu_serve_requests_total",
             "window_s": float(window_s)})
    except Exception:
        return None, 0.0
    if not isinstance(res, dict) or not res.get("ok"):
        return None, 0.0
    actual = float(res.get("window_s") or 0.0)
    if actual <= 0:
        return None, 0.0
    series = {tuple(tuple(kv) for kv in labels): float(v)
              for labels, v in (res.get("series") or [])}
    return {"ray_tpu_serve_requests_total": series}, actual


def stats(window_s: float = 0.0, allow_sleep: bool = True) -> dict:
    """Per-deployment serving stats: replica counts from the controller's
    routing table joined with the plane's latency quantiles, phases,
    statuses, sheds, batch sizes, live gauges and decode rollup. With
    ``window_s > 0`` the head's history ring answers the windowed ``qps``
    with no sleep; off a cluster the fallback sleeps between two scrapes
    unless ``allow_sleep`` is False."""
    import ray_tpu_torch
    from ray_tpu_torch.serve import _private as sp

    # A stats read must not spawn a controller where serve never ran.
    try:
        controller = ray_tpu_torch.get_actor(sp.CONTROLLER_NAME)
    except ValueError:
        controller = None
    table = {}
    if controller is not None:
        _, table = ray_tpu_torch.get(
            controller.get_routing_table.remote(), timeout=30)
    parsed = parse_prometheus(metrics_text())
    deltas: Optional[dict] = None
    window_used = 0.0
    if window_s and window_s > 0:
        deltas, window_used = _history_deltas(window_s)
        if deltas is None and allow_sleep:
            time.sleep(window_s)
            parsed_after = parse_prometheus(metrics_text())
            deltas = diff_parsed(parsed, parsed_after)
            parsed = parsed_after
            window_used = float(window_s)
    deployments = {}
    names = set(table) | set(
        sum_counter(parsed, "ray_tpu_serve_requests_total", "deployment"))
    for name in sorted(n for n in names if n):
        entry = deployment_stats(parsed, name)
        if name in table:
            entry["replicas"] = len(table[name]["replicas"])
            entry["max_concurrent_queries"] = \
                table[name]["max_concurrent_queries"]
            entry["route_prefix"] = table[name]["route_prefix"]
        if deltas is not None and window_used > 0:
            done = sum(sum_counter(
                deltas, "ray_tpu_serve_requests_total", "deployment",
                deployment=name).values())
            entry["qps"] = round(done / window_used, 2)
            entry["window_count"] = int(done)
        deployments[name] = entry
    out = {"deployments": deployments}
    rec = parsed.get("ray_tpu_serve_reconcile_seconds")
    if rec:
        out["reconcile_s"] = round(max(rec.values()), 6)
    return out
