"""Serve: scalable model serving on actors (port of
``ray_tpu/serve/__init__.py``).

Reference parity: ``python/ray/serve`` -- ``@serve.deployment`` ->
``serve.run`` -> controller-reconciled replica actors, handles with
power-of-two routing and backpressure, an HTTP proxy a node, and
``@serve.batch`` dynamic batching (``_private.py``). On a GPU a replica's
callable typically holds a model on its card (``ray_actor_options=
{"num_gpus": ...}``), or the continuous-batching ``LLMEngine``, reached
through ``handle.stream()`` and chunked HTTP.

On a cluster a deployment travels to its replica by reference (module and
name, ``core/serialization.py``): decorate it at the top level of an
importable module, and a bound graph's deployments likewise.
"""

from __future__ import annotations

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu("serve")

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

import ray_tpu_torch
from ray_tpu_torch.serve import _observability, _private
from ray_tpu_torch.serve._observability import RequestShedError
from ray_tpu_torch.serve._private import (
    CONTROLLER_NAME,
    DEADLINE_HEADER,
    STREAM_HEADER,
    DeploymentHandle,
    HTTPProxy,
    batch,
    get_or_create_controller,
)


def __getattr__(name: str):
    # The LLM engine pulls in torch; resolve it lazily (reference :33-41)
    # so importing serve in a torch-less control-plane process (a cluster
    # worker hosting the controller or a proxy) stays cheap.
    if name == "LLMEngine":
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        return LLMEngine
    raise AttributeError(name)


@dataclass
class Deployment:
    func_or_class: Any
    name: str
    num_replicas: int = 1
    max_concurrent_queries: int = 100
    route_prefix: Optional[str] = None
    version: Optional[str] = None
    user_config: Optional[dict] = None
    ray_actor_options: Optional[dict] = None
    # Queue-depth autoscaling (reference autoscaling_policy.py): keys
    # min_replicas, max_replicas, target_ongoing_requests,
    # downscale_delay_s. None = fixed num_replicas.
    autoscaling_config: Optional[dict] = None
    init_args: tuple = ()
    init_kwargs: dict = field(default_factory=dict)

    # By-reference travel (``core/serialization.py``): a module-level
    # ``@serve.deployment`` resolves to the callable it wraps on load, as
    # an ``@remote`` function does, so a replica's worker imports it.
    @property
    def _func(self):
        target = self.func_or_class
        return None if isinstance(target, type) else target

    @property
    def _cls(self):
        target = self.func_or_class
        return target if isinstance(target, type) else None

    def options(self, **kwargs) -> "Deployment":
        known = {f for f in self.__dataclass_fields__}  # noqa: C416
        bad = set(kwargs) - known
        if bad:
            raise ValueError(f"unknown deployment options: {bad}")
        merged = {**self.__dict__, **kwargs}
        return Deployment(**merged)

    def bind(self, *args, **kwargs) -> "Application":
        return Application(self, args, kwargs)


@dataclass
class Application:
    deployment: Deployment
    init_args: tuple
    init_kwargs: dict


def deployment(_func_or_class=None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_concurrent_queries: int = 100,
               route_prefix: Optional[str] = None,
               version: Optional[str] = None,
               user_config: Optional[dict] = None,
               ray_actor_options: Optional[dict] = None,
               autoscaling_config: Optional[dict] = None):
    """``@serve.deployment`` decorator (``python/ray/serve/api.py``)."""

    def wrap(target):
        return Deployment(
            func_or_class=target,
            name=name or getattr(target, "__name__", "deployment"),
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            route_prefix=route_prefix,
            version=version,
            user_config=user_config,
            ray_actor_options=ray_actor_options,
            autoscaling_config=autoscaling_config,
        )

    if _func_or_class is not None:
        return wrap(_func_or_class)
    return wrap


def _resolve_graph_arg(value, controller, used_names: dict):
    """Deployment-graph composition (reference
    ``serve/deployment_graph_build.py``): a bound deployment appearing in
    another deployment's init args deploys first (post-order DFS) and is
    replaced by a ``DeploymentHandle`` — the constructed replica holds
    live handles to its upstream models."""
    if isinstance(value, Deployment):
        value = value.bind()
    if isinstance(value, Application):
        inner, _ = _deploy_app(value, controller, route_prefix=None,
                               used_names=used_names)
        return DeploymentHandle(inner)
    if isinstance(value, (list, tuple)):
        resolved = [_resolve_graph_arg(v, controller, used_names)
                    for v in value]
        return type(value)(resolved)
    if isinstance(value, dict):
        return {k: _resolve_graph_arg(v, controller, used_names)
                for k, v in value.items()}
    return value


def _deploy_app(target: "Application", controller,
                name: Optional[str] = None,
                route_prefix: Optional[str] = "__use_deployment__",
                used_names: Optional[dict] = None) -> str:
    used_names = used_names if used_names is not None else {}
    dep = target.deployment
    init_args = tuple(
        _resolve_graph_arg(a, controller, used_names)
        for a in target.init_args)
    init_kwargs = {
        k: _resolve_graph_arg(v, controller, used_names)
        for k, v in target.init_kwargs.items()
    }
    prefix = dep.route_prefix if route_prefix == "__use_deployment__" \
        else route_prefix
    # Unique graph-node names (reference graph build does the same): two
    # bindings of one deployment in a graph are distinct deployments —
    # without this the second would silently redeploy over the first.
    final = name or dep.name
    count = used_names.get(final, 0)
    used_names[final] = count + 1
    if count:
        final = f"{final}_{count + 1}"
    version = ray_tpu_torch.get(
        controller.deploy.remote(
            final,
            dep.func_or_class,
            init_args,
            init_kwargs,
            dep.num_replicas,
            dep.max_concurrent_queries,
            prefix,
            dep.version,
            dep.ray_actor_options,
            dep.autoscaling_config,
        ),
        timeout=120,
    )
    return final, version


def run(target: "Application | Deployment", *, name: Optional[str] = None,
        route_prefix: Optional[str] = None) -> DeploymentHandle:
    """Deploy (or redeploy) an application — possibly a deployment GRAPH
    whose init args contain other bound deployments — and return a handle
    (``serve/api.py:455`` + graph build)."""
    if isinstance(target, Deployment):
        target = target.bind()
    controller = get_or_create_controller()
    prefix = route_prefix if route_prefix is not None else "__use_deployment__"
    deployed, version = _deploy_app(target, controller, name=name,
                                    route_prefix=prefix)
    _sync_proxies(controller, version)
    return DeploymentHandle(deployed)


def _sync_proxies(controller, version: int) -> None:
    """Return once every HTTP proxy routes by table ``version`` or a newer
    one: the long-poll push may still be in flight when ``deploy``
    returns, and a request sent then would miss its route."""
    if _proxy_handle is not None:
        ray_tpu_torch.get(_proxy_handle.sync_to.remote(version), timeout=60)
    ray_tpu_torch.get(controller.sync_proxies.remote(version), timeout=60)


def get_deployment_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def get_app_handle(name: str) -> DeploymentHandle:
    return DeploymentHandle(name)


def delete(name: str) -> None:
    controller = get_or_create_controller()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=60)


def status() -> Dict[str, dict]:
    controller = get_or_create_controller()
    return ray_tpu_torch.get(controller.status.remote(), timeout=30)


def stats(window_s: float = 0.0,
          allow_sleep: bool = True) -> Dict[str, dict]:
    """Per-deployment serving stats from the SLO latency plane:
    replica counts, p50/p99/mean request latency, per-phase breakdown
    (route / queue_wait / batch_wait / execute / serialize), status and
    shed counts, live ongoing/queued gauges. ``window_s > 0`` adds a
    measured QPS over that window — answered from the head's metrics
    history ring when one is reachable; ``allow_sleep=False`` forbids
    the off-cluster double-scrape fallback (request paths like the
    dashboard must never stall). Surfaced as ``ray-tpu serve stats``
    and the dashboard's ``/api/serve_stats``."""
    return _observability.stats(window_s, allow_sleep=allow_sleep)


_proxy_handle = None


@deployment(name="DAGDriver", route_prefix="/")
class DAGDriver:
    """HTTP ingress for a deployment graph (reference
    ``serve/drivers.py`` DAGDriver): bind it over a composed application
    — ``serve.run(DAGDriver.bind(graph))`` — and each request payload is
    fed to the graph's root handle. ``http_adapter`` optionally reshapes
    the decoded JSON body first."""

    def __init__(self, graph: DeploymentHandle, http_adapter=None):
        self._handle = graph
        self._adapter = http_adapter

    def __call__(self, request):
        payload = self._adapter(request) if self._adapter else request
        return ray_tpu_torch.get(self._handle.remote(payload), timeout=120)


def start_http_proxy(host: str = "127.0.0.1", port: int = 0) -> int:
    """Start a single HTTP ingress; returns the bound port. For one
    ingress per node (reference default: an HTTPProxyActor on every node,
    ``http_state.py:30``) use :func:`start_http_proxies`."""
    global _proxy_handle
    proxy_cls = ray_tpu_torch.remote(HTTPProxy)
    _proxy_handle = proxy_cls.options(num_cpus=0, max_concurrency=16).remote(
        host, port
    )
    return ray_tpu_torch.get(_proxy_handle.get_port.remote(), timeout=60)


def start_http_proxies(host: str = "127.0.0.1") -> Dict[str, int]:
    """One HTTP ingress per alive node, owned and kept alive by the
    controller: a dead proxy (or a proxy whose node died) is recreated on
    the next reconcile tick, and new nodes get proxies as they join.
    Returns {node_id: port}; call :func:`proxy_ports` later for the
    current mapping (recreated proxies bind fresh ports)."""
    controller = _private.get_or_create_controller()
    return ray_tpu_torch.get(
        controller.ensure_proxies.remote(host), timeout=120)


def proxy_ports() -> Dict[str, int]:
    """Current {node_id: port} of the controller-managed proxy fleet."""
    controller = _private.get_or_create_controller()
    return ray_tpu_torch.get(controller.proxy_ports.remote(), timeout=30)


def shutdown() -> None:
    global _proxy_handle
    from ray_tpu_torch.serve import _private as _serve_private

    _serve_private.reset_routers()
    if _proxy_handle is not None:
        try:
            ray_tpu_torch.get(_proxy_handle.stop.remote(), timeout=10)
            ray_tpu_torch.kill(_proxy_handle)
        except Exception:
            pass
        _proxy_handle = None
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.shutdown_all.remote(), timeout=60)
        ray_tpu_torch.kill(controller)
    except ValueError:
        pass


__all__ = [
    "deployment",
    "Deployment",
    "Application",
    "DeploymentHandle",
    "DAGDriver",
    "run",
    "get_deployment_handle",
    "get_app_handle",
    "delete",
    "status",
    "stats",
    "RequestShedError",
    "DEADLINE_HEADER",
    "STREAM_HEADER",
    "LLMEngine",
    "start_http_proxy",
    "start_http_proxies",
    "proxy_ports",
    "shutdown",
    "batch",
]
