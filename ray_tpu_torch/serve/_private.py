"""Serve internals: controller, replicas, router, handles, HTTP proxy,
``@serve.batch`` (port of ``ray_tpu/serve/_private.py``).

Reference parity (``python/ray/serve``):
  * control plane -- a detached ``ServeController`` actor reconciling each
    deployment's goal state into replica actors every 0.25 s: rolling
    redeploys, dead and wedged replicas replaced, queue-depth autoscaling
    between min and max, one HTTP proxy per node (``serve/controller.py``,
    ``_private/deployment_state.py``, ``_private/autoscaling_policy.py``,
    ``_private/http_state.py``);
  * config fan-out -- routers and proxies hold a blocking
    ``listen_for_change`` long poll on the controller and are PUSHED each
    new routing table (``_private/long_poll.py``), so the request path
    never polls;
  * data plane -- ``Router``: power-of-two choices bounded by
    ``max_concurrent_queries`` (``_private/router.py``); replicas run
    ``handle_request`` (``_private/replica.py``); the token-streaming lane
    over the LLM engine's ``llm_submit`` / ``llm_next`` protocol;
  * HTTP ingress -- an asyncio server driving an ASGI-style app, routing by
    longest path prefix, chunked ndjson for streams
    (``_private/http_proxy.py``);
  * ``@serve.batch`` dynamic batching (``serve/batching.py``).

On a cluster every class and function here, and a deployment's own, reaches
a worker by reference (module and name, ``core/serialization.py``): a
deployment lives at the top level of an importable module. The replica's
user calls run on ``max_concurrency`` executor threads; a GPU deployment
whose work belongs to one thread (the LLM engine's loop owns its CUDA
graphs) only enqueues from them.
"""

from __future__ import annotations

import asyncio
import math
import os
import random
import threading
import time
from contextlib import nullcontext
from typing import Any, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import _observability as _obs
from ray_tpu_torch.serve._observability import RequestShedError
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing

CONTROLLER_NAME = "ray_tpu_torch.serve.controller"
# One reconcile pass every interval: health checks, autoscale decisions,
# replica replacement.
RECONCILE_INTERVAL_S = 0.25
LONG_POLL_TIMEOUT_S = 10.0
# Consecutive failed health probes after which a replica is declared
# wedged (deadlocked, not just saturated) and replaced. With the 10s
# shared probe budget this is ~50s of continuous unresponsiveness.
# Saturation alone cannot trip this: replicas run with +1 executor
# thread of headroom reserved for probes (see _make_replica), so a miss
# means the process can't even answer a trivial call for ~10s — user
# code holding the GIL or a true deadlock, not just long requests.
_WEDGED_PROBE_FAILURES = 5


# -- replica ---------------------------------------------------------------


class Replica:
    """Actor wrapping one copy of the user's deployment callable
    (reference :56-181)."""

    def __init__(self, cls_or_fn, init_args, init_kwargs,
                 deployment_name: Optional[str] = None):
        if isinstance(cls_or_fn, type):
            self.callable = cls_or_fn(*init_args, **init_kwargs)
        else:
            self.callable = cls_or_fn
        if deployment_name and hasattr(self.callable,
                                       "set_deployment_name"):
            # Callables that self-report metrics (the LLM engine's
            # decode families) need THIS deployment's name as their
            # label, or the stats join misses them under any name the
            # user didn't also pass into the bind args.
            try:
                self.callable.set_deployment_name(deployment_name)
            except Exception:
                pass
        self.num_ongoing = 0
        self._lock = threading.Lock()
        # Stable per-replica metrics label: pid is unique per node and
        # replicas are one actor per worker process; the id() suffix
        # disambiguates the in-process replicas of the local backend.
        self._replica_tag = f"{os.getpid()}-{id(self) & 0xFFFF:x}"

    def _target(self, method: str):
        return (self.callable if method == "__call__"
                else getattr(self.callable, method))

    def handle_request(self, method: str, args: tuple, kwargs: dict,
                       request_meta: Optional[dict] = None):
        """Execute one routed request.

        ``request_meta`` (set by ``routed_call``) carries the serve
        request context: deployment name, router enqueue timestamp
        (queue_wait = now - enqueue_ts covers the RPC + this replica's
        ongoing queue), the absolute deadline, and the trace context.
        Instrumented requests return a ``{"__serve_envelope__": ...}``
        dict so the replica-side phase breakdown rides back to the
        router with the result; meta-less direct calls keep the legacy
        bare-result shape. Controller health/autoscaling probes use
        ``get_num_ongoing``/``check_health`` and never pass through
        here, so they cannot pollute the request metrics."""
        if request_meta is None:
            with self._lock:
                self.num_ongoing += 1
            try:
                return self._target(method)(*args, **kwargs)
            finally:
                with self._lock:
                    self.num_ongoing -= 1

        dep = request_meta.get("deployment", "")
        now = time.time()
        queue_wait = max(0.0, now - request_meta.get("enqueue_ts", now))
        deadline_ts = request_meta.get("deadline_ts")
        if deadline_ts is not None and now > deadline_ts:
            # Arrived already expired (queued behind slow requests past
            # its budget): shed instead of executing dead work.
            _obs.record_shed(dep, "replica")
            return {"__serve_envelope__": 1, "shed": "replica",
                    "phases": {"queue_wait": queue_wait}}
        trace_ctx = request_meta.get("trace_ctx")
        if trace_ctx:
            tracing.enable()  # the caller traces: continue here
        span_cm = (tracing.span(
            f"serve.replica:{dep}.{method}",
            {"deployment": dep, "replica": self._replica_tag,
             "queue_wait_ms": round(queue_wait * 1e3, 3)},
            parent=trace_ctx, cat="serve")
            if trace_ctx and tracing.is_enabled() else nullcontext())
        # Gauge emits happen INSIDE the lock: counter capture and
        # publish must be atomic, or two concurrent completions can
        # publish out of order and strand the gauge at a stale nonzero
        # value on an idle replica.
        with self._lock:
            self.num_ongoing += 1
            _obs.set_replica_ongoing(dep, self._replica_tag,
                                     self.num_ongoing)
        try:
            # The scope carries the CALLER's span context (the stream/
            # route span that covers the whole request), not the replica
            # span just opened: the engine's queue/prefill/decode spans
            # outlive this handler call by the stream's whole life, and
            # critical-path extraction clips children to their parent's
            # interval — parenting them under a span that ends at
            # llm_submit-return would zero them out.
            with span_cm, _obs.request_scope(dep, deadline_ts,
                                             trace_ctx=trace_ctx):
                t_exec = time.time()
                try:
                    result = self._target(method)(*args, **kwargs)
                except RequestShedError as e:
                    # The @serve.batch queue shed this item (counted at
                    # the shed site); report it up as a shed envelope so
                    # the router raises a typed 503, not a user error.
                    return {"__serve_envelope__": 1,
                            "shed": getattr(e, "reason", "batch"),
                            "phases": {"queue_wait": queue_wait}}
                execute = time.time() - t_exec
        finally:
            with self._lock:
                self.num_ongoing -= 1
                _obs.set_replica_ongoing(dep, self._replica_tag,
                                         self.num_ongoing)
        phases = {"queue_wait": queue_wait, "execute": execute}
        _obs.record_phases(dep, phases)
        return {"__serve_envelope__": 1, "result": result,
                "phases": phases, "replica": self._replica_tag}

    def get_num_ongoing(self) -> int:
        return self.num_ongoing

    def reconfigure(self, user_config):
        if hasattr(self.callable, "reconfigure"):
            self.callable.reconfigure(user_config)
        return True

    def check_health(self) -> str:
        return "ok"


# -- controller ------------------------------------------------------------


class ServeController:
    """Detached actor: goal-state reconciliation for all deployments
    (reference :182-530).

    A background loop (``DeploymentState.update`` analog) continuously:
      * health-checks replicas and REPLACES dead ones,
      * applies queue-depth autoscaling between min/max replicas,
      * pushes any change to long-polling routers via ``listen_for_change``.
    """

    def __init__(self):
        # name -> {"replicas": [handles], goal state, autoscaling state}
        self.apps: Dict[str, dict] = {}
        self.config_version = 0
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._stop = False
        # node_id -> {"handle", "port"}; goal set by ensure_proxies and
        # maintained by the reconcile loop (http_state.py:30 analog).
        self._proxies: Dict[str, dict] = {}
        self._proxy_goal: Optional[dict] = None
        # Serializes whole reconcile passes (the loop vs. concurrent
        # ensure_proxies actor calls): check-then-create outside it would
        # double-start proxies and leak the losers.
        self._proxy_pass_lock = threading.Lock()
        threading.Thread(target=self._reconcile_loop, daemon=True).start()

    # -- goal-state writes --------------------------------------------------

    def deploy(self, name: str, cls_or_fn, init_args, init_kwargs,
               num_replicas: int, max_concurrent_queries: int,
               route_prefix: Optional[str], version: Optional[str],
               ray_actor_options: Optional[dict],
               autoscaling_config: Optional[dict] = None):
        """Create/update a deployment; rolling replace on redeploy."""
        auto = None
        if autoscaling_config is not None:
            auto = {
                "min_replicas": 1,
                "max_replicas": 8,
                "target_ongoing_requests": 2.0,
                "downscale_delay_s": 5.0,
                **autoscaling_config,
            }
            num_replicas = max(num_replicas, auto["min_replicas"])
        app = {
            "name": name,
            "route_prefix": route_prefix,
            "num_replicas": num_replicas,  # current target
            "max_concurrent_queries": max_concurrent_queries,
            "version": version or "1",
            "replicas": [],
            # Creation recipe — the reconcile loop uses it to start
            # replacement/scale-up replicas at any later time.
            "factory": (cls_or_fn, init_args, init_kwargs,
                        dict(ray_actor_options or {}), max_concurrent_queries),
            "autoscaling": auto,
            "last_high_demand_ts": time.monotonic(),
        }
        new_replicas = [self._start_replica(app) for _ in range(num_replicas)]
        # Verify the first replica constructed (fail fast on bad ctor) —
        # and never leak the batch if it didn't.
        try:
            ray_tpu_torch.get(new_replicas[0].check_health.remote(),
                              timeout=60)
        except Exception:
            for r in new_replicas:
                self._kill_replica(r)
            raise
        app["replicas"] = new_replicas

        with self._lock:
            existing = self.apps.get(name)
            old = existing["replicas"] if existing else []
            self.apps[name] = app
            self._bump_locked()
        # Rolling replace: retire old replicas after the new set is live.
        for r in old:
            self._kill_replica(r)
        return self.config_version

    def _start_replica(self, app: dict):
        cls_or_fn, init_args, init_kwargs, opts, max_q = app["factory"]
        replica_cls = ray_tpu_torch.remote(Replica)
        opts = dict(opts)
        opts.setdefault("num_cpus", 0)
        # +1 thread of headroom so controller health probes are never
        # starved behind a fully saturated request queue.
        opts["max_concurrency"] = max(2, max_q) + 1
        return replica_cls.options(**opts).remote(
            cls_or_fn, init_args, init_kwargs, app["name"]
        )

    @staticmethod
    def _kill_replica(handle):
        try:
            ray_tpu_torch.kill(handle)
        except Exception:
            pass

    def delete_deployment(self, name: str):
        with self._lock:
            app = self.apps.pop(name, None)
            if app:
                self._bump_locked()
        if app:
            for r in app["replicas"]:
                self._kill_replica(r)
        return True

    def _bump_locked(self):
        self.config_version += 1
        self._cv.notify_all()

    # -- reconcile loop ------------------------------------------------------

    def _reconcile_loop(self):
        while not self._stop:
            time.sleep(RECONCILE_INTERVAL_S)
            # Suppress tracing for the whole pass: health probes and
            # autoscaling fan out actor calls every 250ms — with tracing
            # enabled they would flood the span store and the timeline
            # with control-plane noise that is not user traffic.
            t0 = time.monotonic()
            with tracing.suppressed():
                try:
                    self._reconcile_once()
                except Exception:
                    # next tick retries; the loop must never die
                    _metrics.count_loop_restart("serve.reconcile")
                try:
                    self._reconcile_proxies()
                except Exception:
                    _metrics.count_loop_restart("serve.reconcile")
            try:
                _obs.record_reconcile(time.monotonic() - t0)
            except Exception:
                _metrics.count_loop_restart("serve.reconcile")

    def _reconcile_once(self):
        with self._lock:
            apps = list(self.apps.values())
        for app in apps:
            # 1. Probe replicas: liveness + in-flight depth in one call.
            #    All probes share one time budget so a single wedged
            #    replica can't stall repair of the others for 10s each.
            probes = [(r, r.get_num_ongoing.remote()) for r in app["replicas"]]
            deadline = time.monotonic() + 10.0
            alive, ongoing = [], []
            fails = app.setdefault("probe_failures", {})
            # Prune entries for replicas that left by scale-down/redeploy
            # (their miss counts would otherwise accumulate forever).
            current = {r._actor_id for r in app["replicas"]}
            for aid in [a for a in fails if a not in current]:
                del fails[aid]
            from ray_tpu_torch.core.object_ref import ActorError

            # Every ref above is already in flight, so even a late get()
            # with a small residual timeout has given its probe the FULL
            # budget of wall-clock since issuance — a miss is ~10s of
            # unresponsiveness no matter where the replica sits in the list.
            for r, ref in probes:
                aid = r._actor_id
                try:
                    tmo = max(0.5, deadline - time.monotonic())
                    ongoing.append(float(ray_tpu_torch.get(ref, timeout=tmo)))
                    alive.append(r)
                    fails.pop(aid, None)
                except ActorError:
                    self._kill_replica(r)  # actually dead: replace it
                    fails.pop(aid, None)
                except Exception:
                    # Slow/saturated probes merely queued behind real
                    # requests — keep the replica, treat as fully busy.
                    # But N consecutive misses = wedged (deadlocked user
                    # code): kill and replace.
                    fails[aid] = fails.get(aid, 0) + 1
                    if fails[aid] >= _WEDGED_PROBE_FAILURES:
                        self._kill_replica(r)
                        fails.pop(aid, None)
                    else:
                        alive.append(r)
                        ongoing.append(float(app["max_concurrent_queries"]))
            changed = len(alive) != len(app["replicas"])

            # 2. Autoscale: desired = ceil(total in-flight / target),
            #    clamped to [min, max]; downscale only after a sustained
            #    quiet period (autoscaling_policy.py behavior). Replicas
            #    can never carry more than max_concurrent_queries, so the
            #    effective per-replica target is capped there — and a
            #    fully saturated fleet scales up even though the queued
            #    demand behind the router cap is invisible to replicas.
            target = app["num_replicas"]
            auto = app["autoscaling"]
            if auto is not None:
                max_q = app["max_concurrent_queries"]
                eff_target = max(
                    1e-9, min(auto["target_ongoing_requests"], max_q))
                desired = math.ceil(sum(ongoing) / eff_target)
                if alive and all(o >= max_q for o in ongoing):
                    desired = max(desired, len(alive) + 1)
                desired = max(auto["min_replicas"],
                              min(auto["max_replicas"], desired))
                now = time.monotonic()
                if desired >= target:
                    app["last_high_demand_ts"] = now
                    target = desired
                elif now - app["last_high_demand_ts"] \
                        >= auto["downscale_delay_s"]:
                    target = desired
                app["num_replicas"] = target

            # 3. Converge replica count toward the target.
            started = []
            while len(alive) + len(started) < target:
                started.append(self._start_replica(app))
                changed = True
            while len(alive) > target:
                self._kill_replica(alive.pop())
                changed = True
            alive.extend(started)

            if changed:
                published = False
                with self._lock:
                    if self.apps.get(app["name"]) is app:
                        app["replicas"] = alive
                        self._bump_locked()
                        published = True
                if not published:
                    # Raced a redeploy/delete: this app dict is stale and
                    # replicas started for it would leak forever.
                    for r in started:
                        self._kill_replica(r)

    # -- per-node HTTP proxies (http_state.py:30 analog) ---------------------

    def ensure_proxies(self, host: str = "127.0.0.1") -> Dict[str, int]:
        """Goal-state write: one HTTPProxy actor on EVERY alive node,
        recreated by the reconcile loop when a proxy or its node dies —
        the reference starts an HTTPProxyActor per node the same way.
        Returns {node_id: port} (ports are ephemeral per proxy; a
        recreated proxy reports a fresh one via proxy_ports)."""
        with self._lock:
            self._proxy_goal = {"host": host}
        self._reconcile_proxies()
        return self.proxy_ports()

    def proxy_ports(self) -> Dict[str, int]:
        with self._lock:
            return {nid: p["port"] for nid, p in self._proxies.items()}

    def sync_proxies(self, version: int) -> bool:
        """Bring every proxy of the fleet to table ``version`` or newer.
        A proxy that does not answer is left to the reconcile loop: the
        proxy that replaces it reads the current table when it starts."""
        with self._lock:
            handles = [p["handle"] for p in self._proxies.values()]
        refs = [h.sync_to.remote(version) for h in handles]
        for ref in refs:
            try:
                ray_tpu_torch.get(ref, timeout=30)
            except Exception:
                pass
        return True

    def _reconcile_proxies(self):
        with self._proxy_pass_lock:
            self._reconcile_proxies_locked()

    def _reconcile_proxies_locked(self):
        with self._lock:
            goal = self._proxy_goal
            current = dict(self._proxies)
        if goal is None:
            return
        from ray_tpu_torch.util.scheduling_strategies import (
            NodeAffinitySchedulingStrategy,
        )

        alive = {n["NodeID"] for n in ray_tpu_torch.nodes() if n["Alive"]}
        for nid in list(current):
            if nid not in alive:
                current.pop(nid, None)
                with self._lock:
                    self._proxies.pop(nid, None)
        for nid in sorted(alive):
            ent = current.get(nid)
            if ent is not None:
                try:
                    ray_tpu_torch.get(ent["handle"].get_port.remote(),
                                      timeout=10)
                    continue  # healthy
                except Exception:
                    try:
                        ray_tpu_torch.kill(ent["handle"])
                    except Exception:
                        pass
                    with self._lock:
                        self._proxies.pop(nid, None)
            proxy_cls = ray_tpu_torch.remote(HTTPProxy)
            handle = proxy_cls.options(
                num_cpus=0, max_concurrency=16,
                scheduling_strategy=NodeAffinitySchedulingStrategy(nid),
            ).remote(goal["host"], 0)
            try:
                port = ray_tpu_torch.get(handle.get_port.remote(), timeout=60)
            except Exception:
                self._kill_replica(handle)
                continue  # node may be going away; next tick retries
            with self._lock:
                self._proxies[nid] = {"handle": handle, "port": port}

    # -- config plane ---------------------------------------------------------

    def get_routing_table(self):
        """(version, {name: {replicas, max_concurrent_queries,
        route_prefix}}) for handles + proxies."""
        with self._lock:
            table = {
                name: {
                    "replicas": list(app["replicas"]),
                    "max_concurrent_queries": app["max_concurrent_queries"],
                    "route_prefix": app["route_prefix"],
                }
                for name, app in self.apps.items()
            }
            return self.config_version, table

    def listen_for_change(self, cur_version: int,
                          timeout: float = LONG_POLL_TIMEOUT_S):
        """Long-poll: block until config_version > cur_version (or
        timeout), then return the fresh routing table — config is PUSHED
        to routers, never polled per-request (long_poll.py:68,185)."""
        with self._cv:
            self._cv.wait_for(
                lambda: self.config_version > cur_version, timeout)
        return self.get_routing_table()

    def status(self):
        with self._lock:
            return {
                name: {
                    "num_replicas": app["num_replicas"],
                    "version": app["version"],
                    "route_prefix": app["route_prefix"],
                }
                for name, app in self.apps.items()
            }

    def shutdown_all(self):
        self._stop = True
        for name in list(self.apps):
            self.delete_deployment(name)
        with self._lock:
            proxies, self._proxies = dict(self._proxies), {}
            self._proxy_goal = None
        for ent in proxies.values():
            try:
                ray_tpu_torch.get(ent["handle"].stop.remote(), timeout=5)
            except Exception:
                pass
            self._kill_replica(ent["handle"])
        return True


def get_or_create_controller():
    """The named controller actor, created on first use (reference :531)."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    controller_cls = ray_tpu_torch.remote(ServeController)
    try:
        handle = controller_cls.options(
            name=CONTROLLER_NAME, num_cpus=0, max_concurrency=64
        ).remote()
        ray_tpu_torch.get(handle.status.remote(), timeout=30)
        return handle
    except ValueError:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)


# -- router / handle --------------------------------------------------------


class _TableListener:
    """Shared long-poll client: a daemon thread blocks in the controller's
    ``listen_for_change`` and invokes ``apply_fn(version, table)`` on every
    push (used by Router and the HTTP proxy; long_poll.py:68 analog;
    reference :550)."""

    def __init__(self, controller, apply_fn, current_version):
        self.controller = controller
        self._apply_fn = apply_fn
        self._current_version = current_version
        self.stopped = False
        with tracing.suppressed():  # config plane, not user traffic
            self._apply_fn(*ray_tpu_torch.get(
                controller.get_routing_table.remote(), timeout=30))
        threading.Thread(target=self._loop, daemon=True).start()

    def refresh(self):
        """Synchronous out-of-band fetch (error-retry path)."""
        try:
            with tracing.suppressed():
                self._apply_fn(*ray_tpu_torch.get(
                    self.controller.get_routing_table.remote(),
                    timeout=30))
        except Exception:
            pass

    def _loop(self):
        # Suppressed like the reconcile loop: a long-poll re-issued
        # every ~10s per router forever is config-plane traffic and
        # must not pollute request traces.
        while not self.stopped:
            try:
                with tracing.suppressed():
                    version, table = ray_tpu_torch.get(
                        self.controller.listen_for_change.remote(
                            self._current_version()),
                        timeout=LONG_POLL_TIMEOUT_S + 30,
                    )
                self._apply_fn(version, table)
            except Exception:
                if self.stopped:
                    return
                _metrics.count_loop_restart("serve.table_listener")
                time.sleep(0.5)  # controller restarting; retry


class Router:
    """Power-of-two-choices replica selection with per-replica in-flight
    caps (client-side view of max_concurrent_queries; reference :595-740).

    Routing-table updates are PUSHED via a ``_TableListener`` long-poll —
    ``assign`` never talks to the controller."""

    def __init__(self, controller, deployment_name: str):
        self.controller = controller
        self.name = deployment_name
        self._version = -1
        self._replicas: List = []
        self._max_q = 100
        # in-flight keyed by actor id so counts survive table swaps.
        self._inflight: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._known_name = False
        self._listener = _TableListener(
            controller, self._apply, lambda: self._version)
        if not self._known_name:
            self._listener.stopped = True
            raise ValueError(f"no deployment named {self.name!r}")

    @property
    def _stopped(self):
        return self._listener.stopped

    @_stopped.setter
    def _stopped(self, value):
        self._listener.stopped = value

    def _apply(self, version: int, table: dict):
        entry = table.get(self.name)
        self._known_name = entry is not None
        with self._lock:
            if version <= self._version:
                return
            self._version = version
            if entry is None:
                self._replicas = []
                return
            self._replicas = list(entry["replicas"])
            self._max_q = entry["max_concurrent_queries"]
            live = {r._actor_id for r in self._replicas}
            self._inflight = {
                aid: n for aid, n in self._inflight.items() if aid in live
            }

    def refresh(self):
        self._listener.refresh()

    def assign(self, exclude: Optional[set] = None,
               deadline_ts: Optional[float] = None):
        """Pick a replica, skipping ``exclude``d actor ids (known-dead from
        a failed attempt). Blocks while all candidates are saturated;
        raises :class:`RequestShedError` the moment ``deadline_ts``
        (absolute ``time.time()``) expires — a request whose budget died
        waiting for capacity must be shed, not executed late."""
        deadline = time.monotonic() + 60.0
        waiting = False
        try:
            while True:
                if deadline_ts is not None and time.time() > deadline_ts:
                    _obs.record_shed(self.name, "router")
                    raise RequestShedError(
                        f"deadline expired while waiting for a replica "
                        f"of {self.name!r}", reason="router")
                with self._lock:
                    pool = self._replicas
                    if exclude:
                        filtered = [r for r in pool
                                    if r._actor_id not in exclude]
                        # All known-dead: fall back to the full set and
                        # let the retry loop wait for the controller's
                        # replacement.
                        pool = filtered or pool
                    n = len(pool)
                    if n:
                        cands = [pool[0]] if n == 1 \
                            else random.sample(pool, 2)
                        best = min(
                            cands,
                            key=lambda r: self._inflight.get(
                                r._actor_id, 0))
                        aid = best._actor_id
                        if self._inflight.get(aid, 0) < self._max_q:
                            self._inflight[aid] = \
                                self._inflight.get(aid, 0) + 1
                            return aid, best
                if time.monotonic() > deadline:
                    raise TimeoutError(
                        f"no replica of {self.name!r} available "
                        f"(backpressure)"
                    )
                if not waiting:
                    # Queued demand invisible to replicas (the router cap
                    # holds it here): export the depth while we wait.
                    waiting = True
                    _obs.router_queue_delta(self.name, +1)
                time.sleep(0.002)
        finally:
            if waiting:
                _obs.router_queue_delta(self.name, -1)

    def complete(self, aid: str):
        with self._lock:
            if self._inflight.get(aid, 0) > 0:
                self._inflight[aid] -= 1


# Per-process router cache, shared by handles and proxies.
_routers: Dict[str, Router] = {}
_routers_lock = threading.Lock()


def _router_for(name: str) -> Router:
    # Hot path: a cached router is returned with no controller RPC; stale
    # routers (from before a serve restart in a long-lived worker) are
    # evicted by _drop_router on routed_call's terminal failure.
    with _routers_lock:
        router = _routers.get(name)
    if router is not None:
        return router
    controller = get_or_create_controller()
    with _routers_lock:
        router = _routers.get(name)
        if router is None:
            router = _routers[name] = Router(controller, name)
        return router


def _drop_router(name: str, router: Router) -> None:
    with _routers_lock:
        if _routers.get(name) is router:
            router._stopped = True
            del _routers[name]


def reset_routers() -> None:
    """Stop long-poll threads and drop cached routers (serve.shutdown)."""
    with _routers_lock:
        for r in _routers.values():
            r._stopped = True
        _routers.clear()
    with _stream_tables_lock:
        _stream_tables.clear()


def routed_call(deployment_name: str, method: str, args: tuple, kwargs: dict,
                request_meta: Optional[dict] = None):
    """Route one request with retry-on-replica-death (reference
    :743-870): a request that lands
    on a replica retired by a rolling update refreshes the routing table
    and retries elsewhere (the handle-side retry of the reference router).

    The request-path instrumentation lives here: one ``serve.route``
    span covering assign -> replica -> response (parented on the
    caller's trace context, so ingress -> router -> replica -> nested
    handle calls share one trace id across processes), the per-phase
    latency histogram (route / queue_wait / execute / serialize /
    total), the per-request status counter, and the deadline shed
    (:class:`RequestShedError` — mapped to HTTP 503 by the proxy)."""
    from ray_tpu_torch.core.object_ref import ActorError

    meta = dict(request_meta or {})
    meta["deployment"] = deployment_name
    deadline_ts = meta.get("deadline_ts")
    trace_parent = meta.get("trace_ctx")
    if trace_parent:
        tracing.enable()  # the caller traces: continue here
    t0 = time.time()
    # Span only when the REQUEST carries trace context (same guard as
    # the replica): tracing.enable() above ratchets the process-global
    # flag, and gating on is_enabled() alone would make one traced
    # request flip this router into recording a root span for every
    # untraced request thereafter — flooding the head's span ring.
    span_cm = (tracing.span(
        f"serve.route:{deployment_name}",
        {"deployment": deployment_name, "method": method},
        parent=trace_parent, cat="serve")
        if trace_parent and tracing.is_enabled() else nullcontext())
    try:
        with span_cm as route_span:
            if route_span is not None:
                # The replica parents its span under the route span —
                # the serve trace context rides the request meta, not
                # the task spec, so it survives thread-pool hops (HTTP
                # proxy executor) and actor-call boundaries alike.
                meta["trace_ctx"] = {"trace_id": route_span["trace_id"],
                                     "span_id": route_span["span_id"]}
            router = _router_for(deployment_name)
            last_err = None
            dead: set = set()
            # route = time actually spent in assign, ACCUMULATED across
            # attempts — a dead-replica retry must not fold the failed
            # attempt's RPC time + backoff into the route histogram
            # (PROFILE.md reads "growing route" as a capacity signal;
            # retry losses land in the serialize remainder instead).
            route_s = 0.0
            for attempt in range(4):
                t_assign = time.time()
                aid, replica = router.assign(
                    exclude=dead, deadline_ts=deadline_ts)
                route_s += time.time() - t_assign
                meta["enqueue_ts"] = time.time()
                # A deadline bounds the IN-FLIGHT call too (+5s grace
                # for the response to ship): a replica wedged behind a
                # partition must not hold a deadlined request for the
                # full 120s — the caller gets a timely typed shed even
                # though the dispatched work itself cannot be recalled.
                rpc_timeout = 120.0
                if deadline_ts is not None:
                    rpc_timeout = max(
                        0.5, min(120.0, deadline_ts - time.time() + 5.0))
                try:
                    resp = ray_tpu_torch.get(
                        replica.handle_request.remote(
                            method, args, kwargs, meta),
                        timeout=rpc_timeout,
                    )
                except TimeoutError:
                    if deadline_ts is None or time.time() < deadline_ts:
                        raise
                    _obs.record_shed(deployment_name, "inflight")
                    raise RequestShedError(
                        f"deadline expired while the request to "
                        f"{deployment_name!r} was in flight",
                        reason="inflight")
                except ActorError as e:
                    last_err = e
                    dead.add(aid)
                    # Back off so the controller's reconcile tick
                    # (0.25s) can replace the dead replica before we
                    # run out of attempts.
                    time.sleep(0.2 * (attempt + 1))
                    router.refresh()
                    continue
                finally:
                    router.complete(aid)
                return _finish_routed(
                    deployment_name, resp, t0, route_s)
            # Terminal failure: the router (and possibly its controller)
            # may be stale from before a serve restart — evict so the
            # next call rebuilds against the live controller.
            _drop_router(deployment_name, router)
            raise last_err
    except RequestShedError:
        _obs.record_status(deployment_name, "shed")
        raise
    except BaseException:
        _obs.record_status(deployment_name, "error")
        raise


def _finish_routed(deployment_name: str, resp, t0: float, route_s: float):
    """Unwrap the replica envelope (reference :873-899); record the
    request's phase breakdown
    and terminal status (this is the single place every routed request
    passes exactly once)."""
    replica_phases: dict = {}
    if isinstance(resp, dict) and resp.get("__serve_envelope__"):
        shed = resp.get("shed")
        if shed:
            raise RequestShedError(
                f"request to {deployment_name!r} shed: deadline expired "
                f"at {shed}", reason=shed)
        replica_phases = resp.get("phases") or {}
        result = resp.get("result")
    else:  # legacy replica without envelope support
        result = resp
    total = time.time() - t0
    accounted = route_s + sum(
        replica_phases.get(p, 0.0) for p in ("queue_wait", "execute"))
    # Router-side phases ONLY: the replica already observed
    # queue_wait/execute (attributed to ITS node) when it ran the
    # request — re-recording them here would double-count. The
    # serialize remainder is the response's serialize/transfer/
    # deserialize path (the worker stores+ships the envelope after
    # execute returns).
    _obs.record_phases(deployment_name, {
        "route": route_s,
        "total": total,
        "serialize": max(0.0, total - accounted),
    })
    _obs.record_status(deployment_name, "ok")
    return result


# -- token streaming (LLM engine protocol) ----------------------------------

# Streaming replica table: deployment -> (fetched_at, [replica actor
# ids]). stream_call runs OUTSIDE the router (it must work from the
# ray:// proxy process, whose global backend is not the cluster's), so
# it resolves replicas straight off the controller with a short TTL
# cache — one controller round trip per deployment per TTL, not per
# stream.
_STREAM_TABLE_TTL_S = 2.0
_stream_tables: Dict[str, tuple] = {}
_stream_tables_lock = threading.Lock()

# Long-poll budget per llm_next call; the outer RPC timeout adds slack
# so a partitioned replica fails the stream FAST (typed, bounded by
# _STREAM_POLL_S + _STREAM_RPC_SLACK_S), never hangs it.
_STREAM_POLL_S = 1.0
_STREAM_RPC_SLACK_S = 25.0


def _stream_replicas(backend, deployment: str,
                     refresh: bool = False) -> List[str]:
    now = time.monotonic()
    with _stream_tables_lock:
        ent = _stream_tables.get(deployment)
        if ent and not refresh and now - ent[0] < _STREAM_TABLE_TTL_S:
            return ent[1]
    controller_id = backend.get_named_actor(CONTROLLER_NAME)
    with tracing.suppressed():
        [ref] = backend.submit_actor_task(
            controller_id, "get_routing_table", (), {})
        _, table = backend.get([ref], timeout=30.0)[0]
    entry = table.get(deployment)
    if entry is None:
        raise ValueError(f"no deployment named {deployment!r}")
    replicas = [r._actor_id for r in entry["replicas"]]
    if not replicas:
        raise RuntimeError(f"deployment {deployment!r} has no replicas")
    with _stream_tables_lock:
        _stream_tables[deployment] = (now, replicas)
    return replicas


def _stream_rpc(backend, actor_id: str, method: str, args: tuple,
                kwargs: dict, meta: Optional[dict], timeout: float):
    [ref] = backend.submit_actor_task(
        actor_id, "handle_request", (method, args, kwargs, meta), {})
    return backend.get([ref], timeout=timeout)[0]


# Sentinel frame the ray:// proxy interleaves on idle poll rounds so a
# deep-queued stream (TTFT = minutes) keeps its client socket alive;
# ClientBackend.serve_stream filters it out.
STREAM_KEEPALIVE = {"__stream_keepalive__": True}


def stream_call(deployment_name: str, args: tuple, kwargs: dict,
                request_meta: Optional[dict] = None, backend=None,
                poll_s: float = _STREAM_POLL_S,
                keepalive_every: Optional[float] = None):
    """Route one STREAMING request: generator of token chunks (reference
    :900-1085, with ``_stream_replicas``, ``_stream_rpc`` and
    ``_stream_call_impl``).

    The replica's callable must speak the LLM engine protocol
    (``llm_submit`` -> stream id, ``llm_next`` -> chunk drain; see
    ``serve/llm_engine.py``). The stream pins to ONE replica for its
    whole life — the KV-cache slot lives there. Submit retries across
    replicas on a dead pick; a replica dying MID-stream fails the
    stream fast (the slot died with the worker), and a deadline that
    expires mid-decode surfaces as a typed :class:`RequestShedError`
    (reason=decode) shed by the engine at a step boundary.

    When the caller traces (``trace_ctx`` in the request meta), the
    whole stream is one ``serve.stream`` span: downstream hops — the
    replica's llm_submit span, the engine's queue/prefill/decode spans
    — re-parent under it, and the first real token stamps the
    client-observed TTFT on its attributes.

    ``backend`` defaults to this process's backend; the ``ray://``
    proxy passes its own ClusterBackend explicitly (its process-global
    backend belongs to the CLIENT side)."""
    meta = dict(request_meta or {})
    trace_parent = meta.get("trace_ctx")
    if trace_parent:
        tracing.enable()  # the caller traces: continue here
    if not (trace_parent and tracing.is_enabled()):
        yield from _stream_call_impl(deployment_name, args, kwargs, meta,
                                     backend, poll_s, keepalive_every)
        return
    # Manual span (start_span/finish_span): the generator frame
    # interleaves with the consumer's code on one thread, so a
    # context-manager span's thread-local restore order would corrupt
    # across yields (same rule as the asgi proxy's await points).
    span = tracing.start_span(
        f"serve.stream:{deployment_name}",
        {"deployment": deployment_name}, parent=trace_parent, cat="serve")
    if span is not None:
        meta["trace_ctx"] = {"trace_id": span["trace_id"],
                             "span_id": span["span_id"]}
    status = "OK"
    t0 = time.monotonic()
    first = True
    try:
        for chunk in _stream_call_impl(deployment_name, args, kwargs,
                                       meta, backend, poll_s,
                                       keepalive_every):
            if first and span is not None and not (
                    isinstance(chunk, dict)
                    and chunk.get("__stream_keepalive__")):
                span["attributes"]["ttft_s"] = round(
                    time.monotonic() - t0, 6)
                first = False
            yield chunk
    except BaseException as e:
        status = f"ERROR: {type(e).__name__}"
        raise
    finally:
        tracing.finish_span(span, status)


def _stream_call_impl(deployment_name: str, args: tuple, kwargs: dict,
                      request_meta: Optional[dict], backend,
                      poll_s: float, keepalive_every: Optional[float]):
    if backend is None:
        from ray_tpu_torch._private import worker as _worker

        backend = _worker.backend()
    meta = dict(request_meta or {})
    meta["deployment"] = deployment_name
    deadline_ts = meta.get("deadline_ts")
    if deadline_ts is not None:
        # The engine owns mid-stream deadline semantics (shed at a step
        # boundary, slot freed); the submit's request meta keeps the
        # deadline too so an already-dead arrival sheds at the replica.
        kwargs = {**kwargs, "deadline_ts": deadline_ts}
    from ray_tpu_torch.core.object_ref import ActorError, GetTimeoutError

    last_err: Optional[BaseException] = None
    resp = None
    aid = None
    for attempt in range(3):
        try:
            replicas = _stream_replicas(
                backend, deployment_name, refresh=attempt > 0)
            aid = replicas[random.randrange(len(replicas))]
            resp = _stream_rpc(backend, aid, "llm_submit", args, kwargs,
                               meta, timeout=60.0)
            break
        except (ValueError, RequestShedError):
            raise
        except GetTimeoutError:
            # The submit may have EXECUTED on a wedged replica — the
            # task layer's dup suppression covers retried pushes of the
            # same spec, but a fresh submit here would be a second
            # admission (orphaned stream holding a decode slot). Fail
            # the stream instead of guessing.
            raise
        except (ActorError, RuntimeError) as e:
            # Dead replica pick / empty table mid-replacement: the old
            # incarnation's engine state died with the worker, so a
            # resubmit cannot double-admit. Anything else propagates.
            last_err = e
            time.sleep(0.2 * (attempt + 1))
    else:
        raise last_err
    if isinstance(resp, dict) and resp.get("__serve_envelope__"):
        shed = resp.get("shed")
        if shed:
            raise RequestShedError(
                f"stream to {deployment_name!r} shed at admission",
                reason=shed)
        rid = resp.get("result")
    else:
        rid = resp
    last_yield = time.monotonic()
    while True:
        # Polls go meta-less (the legacy bare-result path): a long-poll
        # is transport, not a request — it must not enter the request
        # histograms or be shed by the replica's arrival check.
        r = _stream_rpc(backend, aid, "llm_next", (rid,),
                        {"timeout_s": poll_s}, None,
                        timeout=poll_s + _STREAM_RPC_SLACK_S)
        chunks = r.get("chunks") or ()
        for chunk in chunks:
            yield chunk
        if chunks:
            last_yield = time.monotonic()
        elif keepalive_every is not None \
                and time.monotonic() - last_yield >= keepalive_every:
            # Deep-queued stream: nothing to say yet, but the consumer's
            # transport (the ray:// proxy RPC) needs frames to not time
            # out while the request waits for a slot.
            yield STREAM_KEEPALIVE
            last_yield = time.monotonic()
        if r.get("done"):
            shed = r.get("shed")
            if shed:
                raise RequestShedError(
                    f"stream to {deployment_name!r} shed mid-decode",
                    reason=shed)
            err = r.get("error")
            if err:
                raise RuntimeError(
                    f"stream to {deployment_name!r} failed: {err}")
            return


class DeploymentHandle:
    """Python-level handle: ``handle.remote(...)`` / ``handle.method.remote``
    (reference ``serve/handle.py``; ray_tpu :1086-1177). Requests go
    through a routing proxy
    task so callers get a plain ObjectRef while routing keeps retry
    semantics.

    ``handle.options(deadline_s=...)`` attaches a per-request SLO
    deadline that rides the request context: the router and the batch
    queue shed the request (``RequestShedError`` / HTTP 503) instead of
    executing it once the budget is spent. The deadline is an absolute
    ``time.time()`` compared on whichever host the request reaches —
    correct within one host, and within NTP skew (typically ms) across
    hosts; sub-skew deadlines on unsynchronized multi-host clusters
    will mis-shed. When tracing is enabled, the caller's active span
    context rides along too, so the whole routed request joins the
    caller's trace."""

    def __init__(self, deployment_name: str, method_name: str = "__call__",
                 deadline_s: Optional[float] = None):
        self.deployment_name = deployment_name
        self.method_name = method_name
        self.deadline_s = deadline_s

    _UNSET = object()

    def options(self, *, deadline_s: "Optional[float]" = _UNSET
                ) -> "DeploymentHandle":
        # Sentinel default: an explicit deadline_s=None CLEARS an
        # inherited deadline; omitting the argument keeps it.
        return DeploymentHandle(
            self.deployment_name, self.method_name,
            deadline_s=self.deadline_s
            if deadline_s is DeploymentHandle._UNSET else deadline_s)

    def _request_meta(self) -> Optional[dict]:
        meta: dict = {}
        if self.deadline_s is not None:
            meta["deadline_ts"] = time.time() + self.deadline_s
        if tracing.is_enabled():
            ctx = tracing.current_context()
            if ctx:
                meta["trace_ctx"] = ctx
        return meta or None

    def remote(self, *args, **kwargs):
        call = ray_tpu_torch.remote(routed_call).options(num_cpus=0)
        return call.remote(self.deployment_name, self.method_name, args,
                           kwargs, self._request_meta())

    def stream(self, *args, **kwargs):
        """Token-streaming call path (LLM engine protocol): a generator
        of per-step token chunks. ``handle.options(deadline_s=...)``
        applies — the engine sheds the stream typed (reason=decode) at
        the next step boundary once the budget dies. Over a ``ray://``
        connection the chunks are forwarded by the client proxy's
        server-streaming RPC."""
        from ray_tpu_torch._private import worker as _worker

        backend = _worker.backend()
        if hasattr(backend, "serve_stream"):  # ray:// client backend
            return backend.serve_stream(
                self.deployment_name, args, kwargs, self._request_meta())
        return stream_call(self.deployment_name, args, kwargs,
                           self._request_meta())

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self.deployment_name, name,
                                deadline_s=self.deadline_s)

    def __reduce__(self):
        return (DeploymentHandle,
                (self.deployment_name, self.method_name, self.deadline_s))


# -- HTTP proxy -------------------------------------------------------------


_REASONS = {200: "OK", 404: "Not Found", 500: "Internal Server Error",
            503: "Service Unavailable"}

# Per-request deadline header: milliseconds of budget from ingress; the
# proxy converts it to the absolute deadline that rides the request
# context through router and batch queue.
DEADLINE_HEADER = "x-serve-deadline-ms"
# Opt into the token-streaming lane (LLM engine protocol): the response
# becomes chunked-transfer ndjson — one {"tokens": [...]} line per
# engine chunk, then a {"done": true, ...} terminator.
STREAM_HEADER = "x-serve-stream"


def make_asgi_app():
    """The proxy's ASGI application (reference :1178-1374): routes by
    longest matching
    ``route_prefix`` from the (long-poll-pushed) routing table, decodes a
    JSON body, and dispatches through the shared Router. The blocking
    replica RPC runs in a thread pool so the event loop keeps accepting
    connections (http_proxy.py:218 uvicorn/ASGI analog).

    Request-path observability at the ingress: a W3C ``traceparent``
    header joins the caller's distributed trace (one ``serve.http``
    span covers the whole request, parenting the route/replica spans),
    ``x-serve-deadline-ms`` arms the per-request deadline, and a shed
    request answers 503 with the shedding site."""
    import asyncio
    import json as _json
    from concurrent.futures import ThreadPoolExecutor

    controller = get_or_create_controller()
    pool = ThreadPoolExecutor(max_workers=32)
    state = {"version": -1, "routes": []}  # [(prefix, name)]
    state_lock = threading.Lock()

    def apply_table(version, table):
        routes = sorted(
            ((e["route_prefix"], name) for name, e in table.items()
             if e.get("route_prefix")),
            key=lambda p: -len(p[0]),
        )
        with state_lock:
            if version > state["version"]:
                state["version"] = version
                state["routes"] = routes

    listener = _TableListener(
        controller, apply_table, lambda: state["version"])

    def resolve(path: str):
        with state_lock:
            for prefix, name in state["routes"]:
                if path.startswith(prefix):
                    return name
        return None

    async def app(scope, receive, send):
        assert scope["type"] == "http"
        body = b""
        while True:
            event = await receive()
            body += event.get("body", b"")
            if not event.get("more_body"):
                break

        async def reply(status: int, payload):
            blob = _json.dumps(payload).encode()
            await send({
                "type": "http.response.start",
                "status": status,
                "headers": [(b"content-type", b"application/json"),
                            (b"content-length",
                             str(len(blob)).encode())],
            })
            await send({"type": "http.response.body", "body": blob})

        name = resolve(scope["path"])
        if name is None:
            await reply(404, {"error": f"no route for {scope['path']}"})
            return
        headers = {}
        for k, v in scope.get("headers") or ():
            try:
                headers[k.decode("latin-1").lower()] = v.decode("latin-1")
            except Exception:
                continue
        meta: dict = {}
        # An upstream traceparent joins the caller's trace ONLY when
        # the operator enabled tracing here (RAY_TPU_TRACING_ENABLED /
        # tracing.enable()): the sampling decision belongs to the
        # server — an unauthenticated header must not be able to
        # switch on process-wide span recording.
        parent = (tracing.parse_traceparent(headers.get("traceparent"))
                  if tracing.is_enabled() else None)
        if parent is not None:
            meta["trace_ctx"] = parent
        deadline_raw = headers.get(DEADLINE_HEADER)
        if deadline_raw is not None:
            try:
                meta["deadline_ts"] = (
                    time.time() + max(0.0, float(deadline_raw)) / 1e3)
            except ValueError:
                pass  # malformed budget: serve without a deadline
        # Manual (non-context-manager) span: it stays open across the
        # await below, and interleaved request coroutines on this one
        # event-loop thread would corrupt a thread-local span stack's
        # restore order. Created only for requests that CARRY a
        # traceparent (the route/replica guards mirror this): serving
        # traces follow the caller's sampling decision — a proxy whose
        # tracing flag got ratcheted on by one propagated request must
        # not start recording every untraced request.
        http_span = (tracing.start_span(
            f"serve.http:{scope['path']}",
            {"deployment": name, "path": scope["path"]},
            parent=parent, cat="serve")
            if parent is not None else None)
        if http_span is not None:
            meta["trace_ctx"] = {
                "trace_id": http_span["trace_id"],
                "span_id": http_span["span_id"]}
        status = "OK"
        try:
            payload = _json.loads(body) if body else None
            loop = asyncio.get_running_loop()
            if headers.get(STREAM_HEADER):
                # Token-streaming lane: ndjson chunks over chunked
                # transfer encoding. The blocking stream generator runs
                # on a pool thread feeding an asyncio queue; the FIRST
                # event decides the status line, so a stream shed at
                # admission still answers a clean 503 instead of a 200
                # that dies mid-body.
                q: asyncio.Queue = asyncio.Queue()

                def pump():
                    try:
                        for chunk in stream_call(
                                name, (payload,), {}, meta or None):
                            loop.call_soon_threadsafe(
                                q.put_nowait, ("chunk", chunk))
                        loop.call_soon_threadsafe(
                            q.put_nowait, ("end", None))
                    except RequestShedError as e:
                        loop.call_soon_threadsafe(
                            q.put_nowait,
                            ("shed", getattr(e, "reason", "deadline")))
                    except BaseException as e:  # noqa: BLE001
                        loop.call_soon_threadsafe(
                            q.put_nowait, ("error", repr(e)))

                # Dedicated thread per stream, NOT the shared executor:
                # a pump blocks for the stream's whole life (minutes in
                # a deep admission queue), and 32 concurrent streams on
                # the 32-worker pool would wedge every non-streaming
                # request behind them.
                threading.Thread(target=pump, daemon=True).start()
                kind, val = await q.get()
                if kind == "shed":
                    status = "ERROR: RequestShedError"
                    await reply(503, {"error": "stream shed",
                                      "shed": val})
                    return
                if kind == "error":
                    status = "ERROR: stream"
                    await reply(500, {"error": val})
                    return
                await send({
                    "type": "http.response.start",
                    "status": 200,
                    "headers": [
                        (b"content-type", b"application/x-ndjson"),
                        (b"transfer-encoding", b"chunked")],
                })
                while True:
                    if kind == "chunk":
                        await send({
                            "type": "http.response.body",
                            "body": _json.dumps(
                                {"tokens": val}).encode() + b"\n",
                            "more_body": True})
                    else:
                        tail: dict = {"done": True}
                        if kind == "shed":
                            tail["shed"] = val
                            status = "ERROR: RequestShedError"
                        elif kind == "error":
                            tail["error"] = val
                            status = "ERROR: stream"
                        await send({
                            "type": "http.response.body",
                            "body": _json.dumps(tail).encode() + b"\n",
                            "more_body": False})
                        return
                    kind, val = await q.get()
            result = await loop.run_in_executor(
                pool, routed_call, name, "__call__", (payload,), {},
                meta or None)
            await reply(200, result)
        except RequestShedError as e:
            status = "ERROR: RequestShedError"
            await reply(503, {"error": str(e),
                              "shed": getattr(e, "reason", "deadline")})
        except Exception as e:  # noqa: BLE001 — HTTP boundary
            status = f"ERROR: {type(e).__name__}"
            await reply(500, {"error": repr(e)})
        finally:
            tracing.finish_span(http_span, status)

    def sync_to(version: int) -> int:
        """Fetch the table now unless this proxy already routes by
        ``version`` or a newer one; ``serve.run`` calls it so that a
        request sent as it returns finds its route."""
        with state_lock:
            behind = state["version"] < version
        if behind:
            with tracing.suppressed():  # config plane, not user traffic
                apply_table(*ray_tpu_torch.get(
                    controller.get_routing_table.remote(), timeout=30))
        with state_lock:
            return state["version"]

    app.table_listener = listener  # so the proxy can stop it
    app.sync_to = sync_to
    return app


class HTTPProxy:
    """Actor hosting an asyncio HTTP/1.1 server that drives the ASGI app
    above (reference :1375-1493) — connections multiplex on one event
    loop; only replica RPCs occupy pool threads."""

    def __init__(self, host: str, port: int):
        import asyncio

        self._app = make_asgi_app()
        self._loop = asyncio.new_event_loop()
        started = threading.Event()
        holder: dict = {}

        def run_loop():
            asyncio.set_event_loop(self._loop)

            async def boot():
                server = await asyncio.start_server(
                    self._handle_conn, host, port)
                holder["port"] = server.sockets[0].getsockname()[1]
                holder["server"] = server
                started.set()

            self._loop.run_until_complete(boot())
            self._loop.run_forever()

        threading.Thread(target=run_loop, daemon=True).start()
        if not started.wait(30):
            raise RuntimeError("HTTP proxy failed to start")
        self.port = holder["port"]
        self._server = holder["server"]

    async def _handle_conn(self, reader, writer):
        try:
            while True:
                request_line = await reader.readline()
                if not request_line or request_line == b"\r\n":
                    break
                method, path, _ = request_line.decode().split(" ", 2)
                headers = {}
                while True:
                    line = await reader.readline()
                    if line in (b"\r\n", b"", b"\n"):
                        break
                    k, _, v = line.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                length = int(headers.get("content-length") or 0)
                body = await reader.readexactly(length) if length else b""

                scope = {
                    "type": "http",
                    "method": method,
                    "path": path.split("?")[0],
                    "headers": [(k.encode(), v.encode())
                                for k, v in headers.items()],
                }
                received = {"done": False}

                async def receive():
                    if received["done"]:
                        return {"type": "http.disconnect"}
                    received["done"] = True
                    return {"type": "http.request", "body": body,
                            "more_body": False}

                chunked = {"on": False}

                async def send(event):
                    if event["type"] == "http.response.start":
                        status = event["status"]
                        writer.write(
                            f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}"
                            "\r\n".encode())
                        for k, v in event.get("headers", []):
                            if (k.lower() == b"transfer-encoding"
                                    and v.lower() == b"chunked"):
                                chunked["on"] = True
                            writer.write(k + b": " + v + b"\r\n")
                        writer.write(b"\r\n")
                    elif event["type"] == "http.response.body":
                        body_bytes = event.get("body", b"")
                        if chunked["on"]:
                            # Chunked transfer framing: each body event
                            # ships as its own chunk so the client sees
                            # tokens as the engine produces them.
                            if body_bytes:
                                writer.write(
                                    f"{len(body_bytes):x}\r\n".encode()
                                    + body_bytes + b"\r\n")
                            if not event.get("more_body"):
                                writer.write(b"0\r\n\r\n")
                        else:
                            writer.write(body_bytes)
                        await writer.drain()

                await self._app(scope, receive, send)
                if headers.get("connection", "").lower() == "close":
                    break
        except (ConnectionError, asyncio.IncompleteReadError, ValueError):
            pass
        finally:
            try:
                writer.close()
            except Exception:
                pass

    def get_port(self) -> int:
        return self.port

    def sync_to(self, version: int) -> int:
        return self._app.sync_to(version)

    def stop(self):
        self._app.table_listener.stopped = True
        self._loop.call_soon_threadsafe(self._server.close)
        self._loop.call_soon_threadsafe(self._loop.stop)
        return True


# -- dynamic batching -------------------------------------------------------


class _BatchQueue:
    """One ``@serve.batch`` queue: a daemon thread forms batches of at
    most ``max_batch_size`` items within ``batch_wait_timeout_s`` of the
    first (reference :1494-1575)."""

    def __init__(self, fn, max_batch_size: int, batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        # (arg, event, result_box, enqueue wall-ts, request ctx or None)
        self.items: list = []
        self.cv = threading.Condition()
        threading.Thread(target=self._loop, daemon=True).start()

    def submit(self, arg):
        event = threading.Event()
        box: list = [None, None]  # [value, error]
        # The serve request context (deployment + absolute deadline) is
        # captured HERE, on the request's own thread — the batch loop
        # thread has no contextvars of its own.
        ctx = _obs.current_request()
        with self.cv:
            self.items.append((arg, event, box, time.time(), ctx))
            self.cv.notify()
        event.wait()
        if box[1] is not None:
            raise box[1]
        return box[0]

    def _loop(self):
        while True:
            with self.cv:
                while not self.items:
                    self.cv.wait()
                deadline = time.monotonic() + self.timeout
                while (len(self.items) < self.max_batch_size
                       and time.monotonic() < deadline):
                    self.cv.wait(max(0.0, deadline - time.monotonic()))
                batch = self.items[: self.max_batch_size]
                del self.items[: self.max_batch_size]
            # Shed items whose request deadline expired while they sat
            # in the queue: executing them would spend batch capacity on
            # work whose caller already gave up (503 at the boundary).
            now = time.time()
            run = []
            for item in batch:
                ctx = item[4]
                dl = ctx.get("deadline_ts") if ctx else None
                if dl is not None and now > dl:
                    dep = ctx.get("deployment", "") if ctx else ""
                    _obs.record_shed(dep, "batch")
                    item[2][1] = RequestShedError(
                        "deadline expired in the batch queue",
                        reason="batch")
                    item[1].set()
                else:
                    run.append(item)
            if not run:
                continue
            dep = next((it[4]["deployment"] for it in run if it[4]), "")
            _obs.record_batch(dep, len(run))
            for item in run:
                _obs.record_phases(
                    item[4]["deployment"] if item[4] else dep or "",
                    {"batch_wait": max(0.0, now - item[3])})
            args = [b[0] for b in run]
            try:
                results = self.fn(args)
                if len(results) != len(args):
                    raise ValueError(
                        f"batched fn returned {len(results)} results for "
                        f"{len(args)} inputs"
                    )
                for (_, event, box, _, _), r in zip(run, results):
                    box[0] = r
                    event.set()
            except BaseException as e:  # noqa: BLE001 — fan the error out
                _metrics.count_loop_restart("serve.batch_queue")
                for _, event, box, _, _ in run:
                    box[1] = e
                    event.set()


def batch(_fn=None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch``: calls taking one item each are transparently
    batched into one call of the wrapped list->list function (reference
    :1576-1607)."""

    def wrap(fn):
        queue_holder: dict = {}
        lock = threading.Lock()

        def single(*args):
            # Methods: args = (self, item); functions: (item,).
            if len(args) == 2:
                self_obj, item = args
                key = id(self_obj)
                bound = lambda items: fn(self_obj, items)
            elif len(args) == 1:
                item = args[0]
                key = 0
                bound = fn
            else:
                raise TypeError("@serve.batch functions take exactly one item")
            with lock:
                q = queue_holder.get(key)
                if q is None:
                    q = queue_holder[key] = _BatchQueue(
                        bound, max_batch_size, batch_wait_timeout_s
                    )
            return q.submit(item)

        single.__name__ = getattr(fn, "__name__", "batched")
        return single

    if _fn is not None:
        return wrap(_fn)
    return wrap
