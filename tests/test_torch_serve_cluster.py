"""The port's Serve runtime on its cluster backend: the controller, the
replicas, the routers and the HTTP proxies are actors and tasks in worker
processes of a port ``Cluster``, their classes and functions sent by
reference (``tests/torch_serve_loops.py``).

``tests/test_serve_cluster.py``'s three cases (Serve on the cluster, a
proxy on each node with failover, a replica's death under live HTTP load),
then:

- a deployment defined in a closure failing at ``serve.run`` (it cannot
  travel by reference; ROADMAP D33);
- ``tests/test_serve_observability.py::test_federation_one_scrape_and_
  dead_replica_pruned``'s counterpart: the replicas' observations ride
  their workers' event batches to the agent, one ``/metrics/cluster``
  scrape carries each series once, and a deleted deployment's replica
  gauges are retracted when its workers die;
- ``tests/test_llm_serving.py::test_cluster_stream_and_ray_client_proxy``'s
  counterpart: the tiny engine on a replica, streamed from this driver and
  then through a ``ray://`` client proxy (a long prompt through the store,
  a shed crossing the RPC stream).

One two-node cluster serves every case; ``serve.shutdown()`` runs after
each, and the last case (which swaps this process's driver for a
``ray://`` client) restores the driver before it ends.
"""

import threading
import time

import pytest

import ray_tpu_torch
import torch_serve_loops as L
from ray_tpu_torch import serve, state
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.cluster.gcs_client import GcsClient
from ray_tpu_torch.scripts.measure import http_post_json
from ray_tpu_torch.serve import _observability as obs
from ray_tpu_torch.serve import _private as sp
from ray_tpu_torch.serve._observability import RequestShedError

PROMPT = [5, 9, 2, 17, 3]


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    c = Cluster()
    c.add_node(num_cpus=4)
    c.add_node(num_cpus=4)
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


@pytest.fixture(autouse=True)
def _clean_between_tests(cluster):
    yield
    serve.shutdown()


def _until(cond, timeout=30.0, every=0.2):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return bool(cond())


def _table(name):
    controller = sp.get_or_create_controller()
    return ray_tpu_torch.get(controller.get_routing_table.remote(),
                             timeout=30)[1][name]


def _alive_proxy(node_id):
    return [a for a in state.list_actors()
            if a["class_name"] == "HTTPProxy" and a["state"] == "ALIVE"
            and a["node_id"] == node_id]


def test_serve_on_cluster_backend(cluster):
    handle = serve.run(L.Echo.bind())
    out = ray_tpu_torch.get([handle.remote(i) for i in range(12)],
                            timeout=120)
    assert sorted(x for _, x in out) == list(range(12))
    assert len({p for p, _ in out}) == 2  # both replica processes served
    dead = _table("EchoPid")["replicas"][0]
    ray_tpu_torch.kill(dead)
    assert _until(lambda: len({r._actor_id for r in _table("EchoPid")[
        "replicas"]} - {dead._actor_id}) == 2)
    assert ray_tpu_torch.get(handle.remote(99), timeout=60)[1] == 99
    # serve.shutdown leaves no replica, proxy or controller behind.
    serve.shutdown()
    assert _until(lambda: not [
        a for a in state.list_actors() if a["state"] != "DEAD"
        and a["class_name"] in ("Replica", "HTTPProxy", "ServeController")],
        10.0)


def test_a_deployment_in_a_closure_fails_at_run_on_a_cluster(cluster):
    """A deployment reaches its replica by reference (D32-D33): one
    defined inside a function cannot be found by name in a worker, so
    ``serve.run`` fails at once with a ``PicklingError`` naming it (the
    reference pickles it by value), and nothing is left deployed."""
    import pickle

    @serve.deployment(name="Local")
    class Local:
        def __call__(self, x):
            return x

    with pytest.raises(pickle.PicklingError, match="Local"):
        serve.run(Local.bind())
    assert "Local" not in serve.status()


def test_per_node_proxies_and_failover(cluster):
    """One HTTP ingress per node, owned by the controller: both serve, and
    a killed proxy actor is recreated on its node with a fresh port."""
    serve.run(L.Double.bind())
    ports = serve.start_http_proxies()
    assert len(ports) == 2
    for port in ports.values():
        assert http_post_json(port, "/double", 21, timeout=15) == (200, 42)
    victim = sorted(ports)[0]
    [proxy] = _alive_proxy(victim)
    worker_mod.backend().kill_actor(proxy["actor_id"])
    assert _until(lambda: serve.proxy_ports().get(victim, ports[victim])
                  != ports[victim], 60.0, 0.5)
    port = serve.proxy_ports()[victim]
    assert _until(lambda: http_post_json(port, "/double", 5, timeout=15)
                  == (200, 10), 30.0, 0.5)


def test_replica_death_under_live_http_load(cluster):
    """Continuous HTTP load while a replica is killed: every request
    succeeds (the routed call's retry masks the death); then a proxy is
    killed: the other proxy never fails, and the victim's successor
    serves."""
    serve.run(L.WorkDep.bind())
    ports = serve.start_http_proxies()
    assert len(ports) == 2
    for port in ports.values():
        assert http_post_json(port, "/work", 1, timeout=15) == (200, 2)
    stop = threading.Event()
    stats = {p: {"ok": 0, "fail": 0} for p in ports.values()}
    lock = threading.Lock()

    def hammer(port):
        i = 0
        while not stop.is_set():
            try:
                ok = http_post_json(port, "/work", i, timeout=30) \
                    == (200, i + 1)
            except Exception:  # noqa: BLE001 -- a dropped socket counts
                ok = False
            with lock:
                stats[port]["ok" if ok else "fail"] += 1
            i += 1

    threads = [threading.Thread(target=hammer, args=(p,), daemon=True)
               for p in ports.values() for _ in range(2)]
    for t in threads:
        t.start()
    try:
        assert _until(lambda: all(s["ok"] >= 5 for s in stats.values()),
                      30.0, 0.05)
        dead = _table("Work")["replicas"][0]
        ray_tpu_torch.kill(dead)
        assert _until(lambda: dead._actor_id not in {
            r._actor_id for r in _table("Work")["replicas"]}
            and len(_table("Work")["replicas"]) == 2)
        with lock:
            snap = {p: dict(s) for p, s in stats.items()}
        base = dict(snap)
        assert _until(lambda: all(stats[p]["ok"] > base[p]["ok"] + 5
                                  for p in ports.values()), 30.0, 0.05)
        with lock:
            snap = {p: dict(s) for p, s in stats.items()}
        assert all(s["fail"] == 0 for s in snap.values()), snap

        victim = sorted(ports)[0]
        survivor = next(p for n, p in ports.items() if n != victim)
        [proxy] = _alive_proxy(victim)
        worker_mod.backend().kill_actor(proxy["actor_id"])
        with lock:
            before = dict(stats[survivor])
        assert _until(lambda: serve.proxy_ports().get(victim, ports[victim])
                      != ports[victim], 60.0, 0.5)
        assert _until(lambda: stats[survivor]["ok"] > before["ok"] + 5,
                      30.0, 0.05)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
    assert stats[survivor]["fail"] == 0, stats
    port = serve.proxy_ports()[victim]
    assert _until(lambda: http_post_json(port, "/work", 5, timeout=15)
                  == (200, 6), 30.0, 0.5)


def test_federation_one_scrape_and_dead_replica_pruned(cluster):
    """The replicas' observations reach the agents' registries over the
    worker event batch and federate on one ``/metrics/cluster`` scrape,
    each series once, under the replica's node; a deleted deployment's
    replica gauges are retracted when its workers die."""
    gcs = GcsClient(cluster.address)
    try:
        handle = serve.run(L.Echo.options(name="FedDep").bind())
        refs = [handle.remote(i) for i in range(12)]
        assert sorted(x for _, x in ray_tpu_torch.get(
            refs, timeout=120)) == list(range(12))
        nodes = {n.node_id for n in cluster.nodes}

        def scrape():
            return obs.parse_prometheus(gcs.metrics.cluster_text())

        def total(parsed):
            return obs.histogram_dist(parsed, "ray_tpu_serve_request_seconds",
                                      deployment="FedDep", phase="total")

        assert _until(lambda: (total(scrape()) or {}).get("count") == 12,
                      30.0, 0.25)
        text = gcs.metrics.cluster_text()
        parsed = obs.parse_prometheus(text)
        assert obs.sum_counter(parsed, "ray_tpu_serve_requests_total",
                               "status", deployment="FedDep") == {"ok": 12.0}
        lines = [ln.rsplit(" ", 1)[0] for ln in text.splitlines()
                 if ln.startswith("ray_tpu_serve_") and 'deployment="FedDep"'
                 in ln]
        assert len(lines) == len(set(lines))  # each series once
        assert {dict(lab)["node_id"] for fam in (
            "ray_tpu_serve_requests_total", "ray_tpu_serve_replica_ongoing")
            for lab in parsed.get(fam, {}) if dict(lab).get(
                "deployment") == "FedDep"} <= nodes

        def ongoing(p):
            return [dict(lab)["replica"] for lab in
                    (p.get("ray_tpu_serve_replica_ongoing") or {})
                    if dict(lab).get("deployment") == "FedDep"]

        assert _until(lambda: len(ongoing(scrape())) == 2, 20.0, 0.25)
        serve.delete("FedDep")
        assert _until(lambda: not ongoing(scrape()), 60.0, 0.5), \
            f"dead replica series survived: {ongoing(scrape())}"
    finally:
        gcs.close()


def test_cluster_stream_and_ray_client_proxy(cluster):
    """The tiny engine on a replica: the blocking lane, a stream from this
    driver and the decode series federated; then the same stream through
    a ``ray://`` client proxy, a long prompt through the store, and a shed
    across the RPC stream."""
    from ray_tpu_torch.util.client import ClientProxyServer

    handle = L.tiny_engine_app()
    want = ray_tpu_torch.get(
        handle.remote({"tokens": PROMPT, "max_tokens": 5}),
        timeout=300)["tokens"]
    assert len(want) == 5
    assert [t for ch in handle.stream(PROMPT, 5) for t in ch] == want
    assert _until(lambda: obs.decode_stats(obs.parse_prometheus(
        obs.metrics_text()), "llm").get("streams", 0) >= 2, 30.0, 0.25)
    proxy = ClientProxyServer(cluster.address)
    ray_tpu_torch.shutdown()
    try:
        ray_tpu_torch.init(address=f"ray://{proxy.address}")
        h2 = serve.get_deployment_handle("llm")
        assert [t for ch in h2.stream(PROMPT, 5) for t in ch] == want
        big = PROMPT + [1] * (proxy.PROMPT_SHM_MIN_TOKENS + 88)
        assert len([t for ch in h2.stream(big, 4) for t in ch]) == 4
        with pytest.raises(RequestShedError):
            list(h2.options(deadline_s=0.0).stream(PROMPT, 4))
    finally:
        ray_tpu_torch.shutdown()
        proxy.shutdown()
        ray_tpu_torch.init(address=cluster.address)
