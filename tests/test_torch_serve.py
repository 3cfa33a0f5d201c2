"""The port's Serve runtime (``ray_tpu_torch/serve/``) on its local backend.

- ``tests/test_serve.py``'s cases on the port: handles, function
  deployments, power-of-two spread, rolling redeploys, delete, dynamic
  batching, the HTTP proxy's prefix routing, a dead replica replaced,
  autoscaling up and down, the routing table pushed by long poll, graphs
  and ``DAGDriver``. Its jitted-inference case becomes a tiny GPT-2
  scoring deployment (``measure.GPT2Scorer`` through ``@serve.batch``):
  the JAX package's initial weights carried over as numpy
  (``models/convert.py``), every row's NLL within rtol 1e-5 of JAX's
  ``gpt2_forward`` (``tests/test_torch_batch_predictor.py``'s tolerance).
- ``tests/test_llm_serving.py``'s Serve cases (:405-475): the engine
  streamed through the handle and chunked HTTP, and the typed sheds on the
  stream and blocking lanes. Through Serve the tiny fp32 engine gives the
  JAX package's ``LLMEngine``'s tokens on the same weights, exactly.
- ``tests/test_serve_observability.py``'s cases that need no CLI, Grafana
  panel, ``bench_log`` or ``serve_bench``: both trace propagations, the
  phase and batch histograms, the sheds at the router and the batch queue,
  503 on the deadline header, probes kept out of metrics and traces,
  ``serve.stats()``, the handle's deadline options, the traceparent
  helpers.
- The runtime held against the JAX package's in one process: the same app
  (a ``DAGDriver`` over two deployments behind two route prefixes, and a
  ``@serve.batch`` deployment) on both packages' local backends, the same
  requests sent to both, the status codes, bodies, answering deployments
  and batch sizes compared.

Tests wait on events or conditions with a deadline, not on fixed sleeps,
except where a reference case holds a request in flight for a set time.
"""

import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu_torch
import torch_serve_loops as L
from ray_tpu_torch import serve, state
from ray_tpu_torch.scripts.measure import http_post_json as _post
from ray_tpu_torch.serve import _observability as obs
from ray_tpu_torch.serve._observability import RequestShedError
from ray_tpu_torch.util import metrics, tracing

PROMPT = [5, 9, 2, 17, 3]


@pytest.fixture(autouse=True, scope="module")
def _runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16)
    yield
    serve.shutdown()
    ray_tpu_torch.shutdown()


@pytest.fixture(autouse=True)
def _clean_between_tests():
    yield
    tracing.disable()
    serve.shutdown()


def _until(cond, timeout=20.0, every=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(every)
    return bool(cond())


def _snapshot():
    return obs.parse_prometheus(metrics.prometheus_text())


def _delta_since(before):
    return obs.diff_parsed(before, _snapshot())


# -- tests/test_serve.py ---------------------------------------------------


def test_basic_deployment_and_handle():
    @serve.deployment(num_replicas=2)
    class Adder:
        def __init__(self, offset):
            self.offset = offset

        def __call__(self, x):
            return x + self.offset

        def describe(self):
            return f"offset={self.offset}"

    handle = serve.run(Adder.bind(10))
    assert ray_tpu_torch.get(handle.remote(5), timeout=30) == 15
    assert ray_tpu_torch.get(handle.describe.remote(),
                             timeout=30) == "offset=10"
    assert serve.status()["Adder"]["num_replicas"] == 2


def test_function_deployment():
    @serve.deployment
    def square(x):
        return x * x

    handle = serve.run(square.bind())
    assert ray_tpu_torch.get(handle.remote(7), timeout=30) == 49


def test_requests_spread_across_replicas():
    @serve.deployment(num_replicas=3)
    class WhoAmI:
        def __init__(self):
            self.ident = id(self)

        def __call__(self, _):
            time.sleep(0.05)
            return self.ident

    handle = serve.run(WhoAmI.bind())
    refs = [handle.remote(None) for _ in range(12)]
    assert len(set(ray_tpu_torch.get(refs, timeout=60))) >= 2


def test_redeploy_rolls_replicas():
    @serve.deployment
    class V:
        def __init__(self, version):
            self.v = version

        def __call__(self, _):
            return self.v

    handle = serve.run(V.bind("v1"))
    assert ray_tpu_torch.get(handle.remote(None), timeout=30) == "v1"
    serve.run(V.options(version="2").bind("v2"))
    assert _until(lambda: ray_tpu_torch.get(handle.remote(None),
                                            timeout=30) == "v2", 10.0)


def test_get_handle_by_name_and_delete():
    @serve.deployment(name="named_dep")
    def hello(_):
        return "hi"

    serve.run(hello.bind())
    handle = serve.get_deployment_handle("named_dep")
    assert ray_tpu_torch.get(handle.remote(None), timeout=30) == "hi"
    serve.delete("named_dep")
    assert "named_dep" not in serve.status()


def test_dynamic_batching():
    sizes = []

    @serve.deployment(max_concurrent_queries=32)
    class BatchModel:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.1)
        def handle_batch(self, items):
            sizes.append(len(items))
            return [i * 2 for i in items]

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(BatchModel.bind())
    out = ray_tpu_torch.get([handle.remote(i) for i in range(16)],
                            timeout=60)
    assert sorted(out) == [2 * i for i in range(16)]
    assert sum(sizes) == 16 and max(sizes) <= 8


def test_http_proxy_routes_by_prefix():
    @serve.deployment(route_prefix="/double")
    def double(payload):
        return {"result": payload["x"] * 2}

    @serve.deployment(route_prefix="/negate")
    def negate(payload):
        return {"result": -payload["x"]}

    serve.run(double.bind())
    serve.run(negate.bind())
    port = serve.start_http_proxy()
    assert _post(port, "/double", {"x": 21}) == (200, {"result": 42})
    assert _post(port, "/negate", {"x": 5}) == (200, {"result": -5})
    assert _post(port, "/nope", {})[0] == 404


def test_http_proxy_routes_a_deployment_its_push_has_not_reached(
        monkeypatch):
    """``serve.run`` returns only once the proxy routes by the new table:
    a deployment routes at once (here the long-poll pushes are stopped, so
    only ``serve.run``'s sync can bring it)."""
    from ray_tpu_torch.serve import _private as sp

    monkeypatch.setattr(sp._TableListener, "_loop", lambda self: None)
    port = serve.start_http_proxy()

    @serve.deployment(route_prefix="/late")
    def late(payload):
        return {"result": payload["x"] + 1}

    serve.run(late.bind())
    assert _post(port, "/late", {"x": 1}) == (200, {"result": 2})
    assert _post(port, "/nope", {})[0] == 404


def test_http_404s_ask_the_controller_nothing(monkeypatch):
    """A route miss answers 404 from the proxy's own table. With the
    controller's table fetch hung, 64 misses in flight together all answer
    and a routed request goes through beside them."""
    from ray_tpu_torch.serve import _private as sp

    @serve.deployment(route_prefix="/kept")
    def kept(payload):
        return {"result": payload["x"]}

    serve.run(kept.bind())
    port = serve.start_http_proxy()
    assert _post(port, "/kept", {"x": 2}) == (200, {"result": 2})
    release = threading.Event()
    real = sp.ServeController.get_routing_table

    def hung(self):
        release.wait(60)
        return real(self)

    monkeypatch.setattr(sp.ServeController, "get_routing_table", hung)
    codes = []
    misses = [threading.Thread(
        target=lambda i=i: codes.append(
            _post(port, f"/typo{i}", {}, timeout=60)[0]))
        for i in range(64)]
    try:
        for t in misses:
            t.start()
        assert _post(port, "/kept", {"x": 3}, timeout=20) == (
            200, {"result": 3})
        for t in misses:
            t.join(timeout=20)
        assert codes == [404] * 64
    finally:
        release.set()
        for t in misses:
            t.join(timeout=60)


def test_dead_replica_replaced_by_controller():
    from ray_tpu_torch.serve import _private as sp

    @serve.deployment(num_replicas=2)
    class Sturdy:
        def __call__(self, _):
            return "ok"

    serve.run(Sturdy.bind())
    controller = sp.get_or_create_controller()

    def replicas():
        return ray_tpu_torch.get(controller.get_routing_table.remote(),
                                 timeout=30)[1]["Sturdy"]["replicas"]

    first = replicas()
    assert len(first) == 2
    dead_id = first[0]._actor_id
    ray_tpu_torch.kill(first[0])
    assert _until(lambda: len({r._actor_id for r in replicas()} - {dead_id})
                  == 2, 20.0)
    handle = serve.get_deployment_handle("Sturdy")
    assert ray_tpu_torch.get(handle.remote(None), timeout=30) == "ok"


def test_autoscaling_up_then_down():
    @serve.deployment(
        max_concurrent_queries=4,
        autoscaling_config={"min_replicas": 1, "max_replicas": 3,
                            "target_ongoing_requests": 1.0,
                            "downscale_delay_s": 1.0})
    class Slow:
        def __call__(self, _):
            time.sleep(0.3)
            return "done"

    handle = serve.run(Slow.bind())
    assert serve.status()["Slow"]["num_replicas"] == 1
    stop = threading.Event()
    errors = []

    def hammer():
        while not stop.is_set():
            try:
                ray_tpu_torch.get(handle.remote(None), timeout=60)
            except Exception as e:  # noqa: BLE001
                errors.append(e)
                return

    threads = [threading.Thread(target=hammer) for _ in range(8)]
    for t in threads:
        t.start()
    try:
        scaled_up = _until(
            lambda: serve.status()["Slow"]["num_replicas"] >= 2, 6.0, 0.2)
    finally:
        stop.set()
        for t in threads:
            t.join()
    assert not errors, errors[:1]
    assert scaled_up, "replicas never scaled up under load"
    assert _until(lambda: serve.status()["Slow"]["num_replicas"] == 1,
                  20.0, 0.2)


def test_config_pushed_without_requests():
    from ray_tpu_torch.serve import _private as sp

    @serve.deployment
    class Versioned:
        def __init__(self, v):
            self.v = v

        def __call__(self, _):
            return self.v

    handle = serve.run(Versioned.bind("v1"))
    assert ray_tpu_torch.get(handle.remote(None), timeout=30) == "v1"
    router = sp._routers["Versioned"]
    old = {r._actor_id for r in router._replicas}
    serve.run(Versioned.options(version="2").bind("v2"))
    # No requests from here on: the router's replica set must still swap.
    assert _until(lambda: router._replicas and {
        r._actor_id for r in router._replicas} != old, 10.0)
    assert ray_tpu_torch.get(handle.remote(None), timeout=30) == "v2"


TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64)


def test_gpt2_scoring_deployment_matches_jax_forward():
    """The reference's jitted-inference deployment on the port: a tiny
    fp32 GPT-2 (JAX's initial weights as numpy) in ``GPT2Scorer`` on the
    CPU, one row a request through ``@serve.batch``; each row's NLL within
    rtol 1e-5 of JAX's forward on the same row."""
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.scripts.measure import GPT2Scorer

    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.gpt2_init(jax.random.key(0),
                                                      jcfg))
    tokens = np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (12, TINY["seq_len"] + 1))
    logits = jgpt2.gpt2_forward(params, jnp.asarray(tokens[:, :-1]), jcfg)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    want = -np.asarray(jnp.take_along_axis(
        logp, jnp.asarray(tokens[:, 1:, None]), axis=-1)[..., 0].mean(-1))

    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    dep = serve.deployment(name="score", max_concurrent_queries=16)(
        GPT2Scorer)
    handle = serve.run(dep.bind(params, cfg=tcfg, device="cpu"))
    refs = [handle.remote({"id": i, "tokens": t.tolist()})
            for i, t in enumerate(tokens)]
    got = ray_tpu_torch.get(refs, timeout=120)
    assert [g["id"] for g in got] == list(range(len(tokens)))
    np.testing.assert_allclose([g["nll"] for g in got], want, rtol=1e-5)
    stats = ray_tpu_torch.get(handle.stats.remote(), timeout=30)
    assert sum(stats["batch_sizes"]) == len(tokens)
    assert max(stats["batch_sizes"]) <= 8
    assert stats["launches"] == [{}] * len(stats["batch_sizes"])  # the CPU


def test_deployment_graph_composition():
    @serve.deployment
    class Preprocessor:
        def __call__(self, x):
            return x * 2

    @serve.deployment
    class ModelA:
        def __call__(self, x):
            return x + 1

    @serve.deployment
    class ModelB:
        def __call__(self, x):
            return x + 2

    @serve.deployment
    class Ensemble:
        def __init__(self, pre, models):
            self.pre = pre
            self.models = models

        def __call__(self, x):
            y = ray_tpu_torch.get(self.pre.remote(x), timeout=30)
            outs = ray_tpu_torch.get([m.remote(y) for m in self.models],
                                     timeout=30)
            return sum(outs) / len(outs)

    handle = serve.run(
        Ensemble.bind(Preprocessor.bind(), [ModelA.bind(), ModelB.bind()]))
    assert ray_tpu_torch.get(handle.remote(3), timeout=30) == 7.5
    assert {"Ensemble", "Preprocessor", "ModelA", "ModelB"} <= set(
        serve.status())


def test_dag_driver_http_ingress():
    scale = serve.deployment(L.Scale)
    shift = serve.deployment(L.Shift)
    serve.run(serve.DAGDriver.bind(shift.bind(scale.bind(),
                                              ray_tpu_torch.get)))
    port = serve.start_http_proxy()
    assert _post(port, "/", 4) == (200, 41)


def test_graph_duplicate_bindings_stay_distinct():
    @serve.deployment
    class Model:
        def __init__(self, k):
            self.k = k

        def __call__(self, x):
            return x * self.k

    @serve.deployment
    class Combine:
        def __init__(self, a, b):
            self.a = a
            self.b = b

        def __call__(self, x):
            return ray_tpu_torch.get([self.a.remote(x), self.b.remote(x)],
                                     timeout=30)

    handle = serve.run(Combine.bind(Model.bind(10), Model.bind(100)))
    assert ray_tpu_torch.get(handle.remote(3), timeout=30) == [30, 300]


# -- tests/test_llm_serving.py's Serve cases --------------------------------


@pytest.fixture(scope="module")
def jax_engine_run():
    """The JAX package's tiny fp32 GPT-2 engine: its parameters (numpy)
    and its greedy tokens for PROMPT, 5 new."""
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.serve.llm_engine import LLMEngine as JaxEngine

    jcfg = dataclasses.replace(jgpt2.GPT2Config.tiny(), dtype=jnp.float32)
    eng = JaxEngine(model="gpt2", config=jcfg, max_batch=4, cache_len=32,
                    max_prompt_len=8, max_new_tokens=6)
    try:
        tokens = eng.generate(PROMPT, 5)
        params = jax.tree.map(np.asarray, eng.params)
    finally:
        eng.shutdown_engine()
    return params, tokens


def test_engine_streamed_through_handle_and_http_gives_jax_tokens(
        jax_engine_run):
    """Order and completeness through the real transports: the blocking
    lane, ``handle.stream`` and chunked-HTTP ndjson all give the JAX
    package's engine's tokens on the same weights; keep-alive survives a
    chunked response; ``serve.stats()`` grows a decode section under the
    deployment's name (the engine took it through
    ``set_deployment_name``)."""
    import http.client

    params, want = jax_engine_run
    handle = L.tiny_engine_app(params=params)
    got = ray_tpu_torch.get(
        handle.remote({"tokens": PROMPT, "max_tokens": 5}), timeout=120)
    assert got["tokens"] == want
    chunks = list(handle.stream(PROMPT, 5))
    assert [t for ch in chunks for t in ch] == want
    assert all(len(ch) >= 1 for ch in chunks)

    port = serve.start_http_proxy()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        body = json.dumps({"tokens": PROMPT, "max_tokens": 5}).encode()
        conn.request("POST", "/llm", body=body,
                     headers={"Content-Type": "application/json",
                              serve.STREAM_HEADER: "1"})
        resp = conn.getresponse()
        assert resp.status == 200
        assert resp.getheader("Transfer-Encoding") == "chunked"
        lines = []
        while True:
            line = resp.readline()
            if not line:
                break
            lines.append(json.loads(line))
        assert [t for ln in lines if "tokens" in ln
                for t in ln["tokens"]] == want
        assert lines[-1].get("done") is True
        conn.request("POST", "/llm", body=body,
                     headers={"Content-Type": "application/json"})
        r2 = conn.getresponse()
        assert r2.status == 200
        assert json.loads(r2.read())["tokens"] == want
    finally:
        conn.close()
    decode = serve.stats()["deployments"]["llm"].get("decode")
    assert decode and decode["streams"] >= 3
    assert decode.get("tokens", 0) >= 15


def test_stream_deadline_shed_typed_through_handle():
    handle = L.tiny_engine_app()
    with pytest.raises(RequestShedError):
        list(handle.options(deadline_s=0.0).stream(PROMPT, 4))


def test_blocking_lane_deadline_shed_mid_decode():
    """The blocking lane inherits the request context's deadline: a budget
    dying mid-decode sheds typed and frees the slot."""
    handle = L.tiny_engine_app(max_new_tokens=500, max_new_cap=1000,
                               step_throttle_s=0.02)
    t0 = time.monotonic()
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(handle.options(deadline_s=0.6).remote(
            {"tokens": PROMPT, "max_tokens": 500}), timeout=120)
    assert "shed" in repr(ei.value).lower(), repr(ei.value)
    assert time.monotonic() - t0 < 60.0


# -- tests/test_serve_observability.py --------------------------------------


def test_trace_propagation_handle_path_one_trace():
    @serve.deployment(name="TraceInner")
    class Inner:
        def __call__(self, x):
            return x * 2

    @serve.deployment(name="TraceOuter")
    class Outer:
        def __init__(self, inner):
            self.inner = inner

        def __call__(self, x):
            return ray_tpu_torch.get(self.inner.remote(x), timeout=30) + 1

    handle = serve.run(Outer.bind(Inner.bind()))
    tracing.enable()
    with tracing.span("client-root") as root:
        assert ray_tpu_torch.get(handle.remote(5), timeout=60) == 11
        trace_id = root["trace_id"]
    spans = [s for s in tracing.collect()
             if s["trace_id"] == trace_id and s.get("cat") == "serve"]
    by_name = {s["name"]: s for s in spans}
    route_outer = by_name["serve.route:TraceOuter"]
    rep_outer = by_name["serve.replica:TraceOuter.__call__"]
    route_inner = by_name["serve.route:TraceInner"]
    rep_inner = by_name["serve.replica:TraceInner.__call__"]
    assert route_outer["parent_id"] == root["span_id"]
    assert rep_outer["parent_id"] == route_outer["span_id"]
    assert route_inner["parent_id"] == rep_outer["span_id"]
    assert rep_inner["parent_id"] == route_inner["span_id"]
    ids = {e["args"].get("span_id") for e in state.timeline()
           if e.get("cat") == "serve"}
    assert route_outer["span_id"] in ids and rep_inner["span_id"] in ids


def test_trace_propagation_http_traceparent():
    import http.client

    @serve.deployment(name="HttpTraced", route_prefix="/traced")
    def traced(payload):
        return {"ok": True}

    serve.run(traced.bind())
    port = serve.start_http_proxy()

    def send(trace_id, parent):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("POST", "/traced", body=b"null", headers={
            "Content-Type": "application/json",
            "traceparent": f"00-{trace_id}-{parent}-01"})
        resp = conn.getresponse()
        resp.read()
        conn.close()
        return resp.status

    # The header alone must not switch tracing on (the server samples).
    assert send("ef" * 16, "01" * 8) == 200
    assert not tracing.is_enabled()
    assert not any(s["trace_id"] == "ef" * 16 for s in tracing.collect())
    tracing.enable()
    assert send("ab" * 16, "cd" * 8) == 200

    def traced_spans():
        return {s["name"]: s for s in tracing.collect()
                if s["trace_id"] == "ab" * 16 and s.get("cat") == "serve"}

    # The proxy closes its span after the response is written, so the
    # client can read the response first.
    assert _until(lambda: "serve.http:/traced" in traced_spans(), 10.0)
    by_name = traced_spans()
    assert any(n.startswith("serve.replica:HttpTraced") for n in by_name)
    http_span = by_name["serve.http:/traced"]
    assert http_span["parent_id"] == "cd" * 8
    assert by_name["serve.route:HttpTraced"]["parent_id"] == \
        http_span["span_id"]


def test_phase_histograms_populated_per_phase():
    before = _snapshot()

    @serve.deployment(name="PhaseDep")
    def phased(x):
        time.sleep(0.002)
        return x

    handle = serve.run(phased.bind())
    for i in range(6):
        assert ray_tpu_torch.get(handle.remote(i), timeout=30) == i
    delta = _delta_since(before)
    for phase in ("route", "queue_wait", "execute", "serialize", "total"):
        dist = obs.histogram_dist(delta, "ray_tpu_serve_request_seconds",
                                  deployment="PhaseDep", phase=phase)
        assert dist is not None and dist["count"] == 6, (phase, dist)
    assert obs.sum_counter(delta, "ray_tpu_serve_requests_total", "status",
                           deployment="PhaseDep") == {"ok": 6.0}


def test_batch_wait_phase_and_batch_size_histogram():
    before = _snapshot()

    @serve.deployment(name="BatchDep", max_concurrent_queries=32)
    class BatchModel:
        @serve.batch(max_batch_size=8, batch_wait_timeout_s=0.05)
        def handle_batch(self, items):
            return [i * 2 for i in items]

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(BatchModel.bind())
    assert sorted(ray_tpu_torch.get([handle.remote(i) for i in range(12)],
                                    timeout=60)) == [2 * i for i in range(12)]
    delta = _delta_since(before)
    wait = obs.histogram_dist(delta, "ray_tpu_serve_request_seconds",
                              deployment="BatchDep", phase="batch_wait")
    assert wait is not None and wait["count"] == 12
    sizes = obs.histogram_dist(delta, "ray_tpu_serve_batch_size",
                               deployment="BatchDep")
    assert sizes is not None and 1 <= sizes["count"] < 12
    assert sizes["sum"] == 12


def test_deadline_shed_at_router():
    before = _snapshot()
    executed = []
    started = threading.Event()

    @serve.deployment(name="ShedRouter", num_replicas=1,
                      max_concurrent_queries=1)
    class Slow:
        def __call__(self, x):
            executed.append(x)
            started.set()
            time.sleep(0.4)
            return x

    handle = serve.run(Slow.bind())
    blocker = handle.remote("blocker")
    assert started.wait(30)  # in flight: capacity now 0
    ref = handle.options(deadline_s=0.05).remote("victim")
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(ref, timeout=30)
    assert "RequestShedError" in repr(ei.value) or "shed" in repr(ei.value)
    assert ray_tpu_torch.get(blocker, timeout=30) == "blocker"
    assert "victim" not in executed
    delta = _delta_since(before)
    assert obs.sum_counter(delta, "ray_tpu_serve_shed_total", "reason",
                           deployment="ShedRouter").get("router", 0) >= 1
    assert obs.sum_counter(delta, "ray_tpu_serve_requests_total", "status",
                           deployment="ShedRouter").get("shed", 0) >= 1


def test_deadline_shed_at_batch_queue():
    before = _snapshot()
    seen = []
    running = threading.Event()

    @serve.deployment(name="ShedBatch", max_concurrent_queries=32)
    class SlowBatch:
        @serve.batch(max_batch_size=2, batch_wait_timeout_s=0.01)
        def handle_batch(self, items):
            seen.extend(items)
            running.set()
            time.sleep(0.4)
            return list(items)

        def __call__(self, x):
            return self.handle_batch(x)

    handle = serve.run(SlowBatch.bind())
    first = handle.remote("first")
    assert running.wait(30)  # the first batch is mid-execution
    victim = handle.options(deadline_s=0.1).remote("victim")
    with pytest.raises(Exception) as ei:
        ray_tpu_torch.get(victim, timeout=30)
    assert "RequestShedError" in repr(ei.value) or "shed" in repr(ei.value)
    assert ray_tpu_torch.get(first, timeout=30) == "first"
    assert "victim" not in seen
    assert obs.sum_counter(_delta_since(before), "ray_tpu_serve_shed_total",
                           "reason", deployment="ShedBatch").get(
                               "batch", 0) >= 1


def test_http_deadline_header_returns_503():
    @serve.deployment(name="Shed503", route_prefix="/shed503")
    def slow(payload):
        time.sleep(0.2)
        return {"ok": True}

    serve.run(slow.bind())
    port = serve.start_http_proxy()
    status, body = _post(port, "/shed503", None,
                         headers={serve.DEADLINE_HEADER: "0"})
    assert status == 503 and body.get("shed") == "router"


def test_probes_excluded_from_metrics_and_traces():
    """The controller's probes and the long polls run every 0.25 s: they
    appear in neither the request counters nor the trace stream; the
    reconcile pass exports its duration gauge."""
    before = _snapshot()

    @serve.deployment(name="ProbeDep", num_replicas=2)
    def probed(x):
        return x

    handle = serve.run(probed.bind())
    for i in range(5):
        assert ray_tpu_torch.get(handle.remote(i), timeout=30) == i
    tracing.enable()
    tracing.collect(clear=True)
    # Several reconcile passes, seen through the gauge they set.
    metrics.SERVE_RECONCILE_SECONDS.remove(tags={"node_id": "local"})
    for _ in range(4):
        assert _until(lambda: metrics.SERVE_RECONCILE_SECONDS.get(
            tags={"node_id": "local"}) is not None, 10.0, 0.02)
        metrics.SERVE_RECONCILE_SECONDS.remove(
            tags={"node_id": "local"})
    spans = tracing.collect(clear=True)
    polluters = [s["name"] for s in spans if any(k in s["name"] for k in (
        "get_num_ongoing", "check_health", "listen_for_change",
        "get_routing_table"))]
    assert polluters == [], polluters
    assert obs.sum_counter(_delta_since(before),
                           "ray_tpu_serve_requests_total", "status",
                           deployment="ProbeDep") == {"ok": 5.0}
    assert _until(lambda: _snapshot().get(
        "ray_tpu_serve_reconcile_seconds"), 10.0)


def test_serve_stats():
    @serve.deployment(name="StatsDep", num_replicas=2)
    def stats_dep(x):
        time.sleep(0.002)
        return x

    handle = serve.run(stats_dep.bind())
    for i in range(4):
        ray_tpu_torch.get(handle.remote(i), timeout=30)
    entry = serve.stats()["deployments"]["StatsDep"]
    assert entry["replicas"] == 2 and entry["route_prefix"] is None
    assert entry["count"] >= 4 and entry["requests"]["ok"] >= 4
    assert entry["p50_ms"] is not None and entry["p99_ms"] is not None
    assert set(entry["phases"]) >= {"route", "queue_wait", "execute"}
    # Off a cluster no history ring answers: the window sleeps between
    # two scrapes, or is left out where sleeping is not allowed.
    windowed = serve.stats(window_s=0.2)["deployments"]["StatsDep"]
    assert windowed["window_count"] == 0 and windowed["qps"] == 0.0
    assert "qps" not in serve.stats(
        window_s=5.0, allow_sleep=False)["deployments"]["StatsDep"]


def test_handle_options_deadline_semantics():
    import pickle

    from ray_tpu_torch.serve._private import DeploymentHandle

    h = DeploymentHandle("D")
    h5 = h.options(deadline_s=5.0)
    assert h5.deadline_s == 5.0 and h.deadline_s is None
    assert h5.options().deadline_s == 5.0
    assert h5.options(deadline_s=None).deadline_s is None
    assert h5.method.deadline_s == 5.0
    assert pickle.loads(pickle.dumps(h5)).deadline_s == 5.0


def test_traceparent_helpers_roundtrip():
    ctx = {"trace_id": "ab" * 16, "span_id": "12" * 8}
    hdr = tracing.format_traceparent(ctx)
    assert hdr == f"00-{'ab' * 16}-{'12' * 8}-01"
    assert tracing.parse_traceparent(hdr) == ctx
    for bad in (None, "", "00-short-bad-01", "garbage",
                f"00-{'0' * 32}-{'12' * 8}-01",
                f"00-{'zz' * 16}-{'12' * 8}-01"):
        assert tracing.parse_traceparent(bad) is None


# -- the runtime against the JAX package's ----------------------------------


def _app_outcomes(serve_mod, obs_mod, registry):
    """The parity app on ``serve_mod``'s package's local backend: deploy,
    send the same requests, return what came back, with the request
    counts (by deployment and status) ``registry``'s scrape gained."""
    before = obs_mod.parse_prometheus(registry.prometheus_text())
    port = L.parity_app(serve_mod)
    out = {}
    for path, body, hdr in (("/", 4, None), ("/graph", 7, None),
                            ("/graph/deeper", -1, None),
                            ("/other", "x", None),
                            ("/graph", 3, {serve_mod.DEADLINE_HEADER: "0"})):
        status, reply = _post(port, path, body, hdr)
        # A 500's text names the other package's error types.
        out[(path, json.dumps(body), bool(hdr))] = (
            status, reply if status == 200 else
            {k: v for k, v in (reply or {}).items() if k == "shed"})
    replies = [None] * 8

    def one(i):
        replies[i] = _post(port, "/batch", i)

    threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    out["batch"] = replies
    delta = obs_mod.diff_parsed(
        before, obs_mod.parse_prometheus(registry.prometheus_text()))
    counts = {
        name: {k: v for k, v in obs_mod.sum_counter(
            delta, "ray_tpu_serve_requests_total", "status",
            deployment=name).items() if v}
        for name in obs_mod.sum_counter(
            delta, "ray_tpu_serve_requests_total", "deployment")}
    out["requests"] = {name: c for name, c in counts.items() if c}
    out["status"] = {name: e["route_prefix"]
                     for name, e in serve_mod.status().items()}
    return out


def test_same_app_on_both_packages_answers_alike():
    """A DAGDriver over Shift(Scale) behind "/" and "/graph" and a
    ``@serve.batch`` deployment behind "/batch", on the JAX package's
    local backend and the port's in one process: the same requests give
    the same status codes (200, 500 for a bad payload, 503 for a spent
    deadline), bodies, answering deployments (request counts by
    deployment and status, which prefix took which path) and batch
    sizes."""
    import ray_tpu
    from ray_tpu import serve as jserve
    from ray_tpu.serve import _observability as jobs
    from ray_tpu.util import metrics as jmetrics

    port_out = _app_outcomes(serve, obs, metrics)
    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=16)
    try:
        jax_out = _app_outcomes(jserve, jobs, jmetrics)
    finally:
        jserve.shutdown()
        ray_tpu.shutdown()
    assert port_out["batch"] == [(200, [2 * i, 4]) for i in range(8)]
    assert port_out[("/", "4", False)] == (200, 41)
    assert port_out[("/graph", "3", True)] == (503, {"shed": "router"})
    assert port_out[("/other", '"x"', False)][0] == 500
    assert port_out["requests"]["batched"] == {"ok": 8.0}
    assert port_out == jax_out
