"""Operating a port cluster through ``ray_tpu_torch.state``: the workers'
logs, stacks and profiles, the federated metrics and the signal plane,
on one module-scoped ``Cluster`` (a driver node and a second node; the
signal plane scraping and evaluating every 0.2 s).

Held, as the JAX package's own cluster tests hold it
(``tests/test_signal_plane.py``, ``tests/test_chaos.py``): a worker's ``print`` reaches the driver over ``LOGS`` and ``get_log``;
``follow_log`` streams a growing log; ``dump_stack`` and
``profile_worker`` see a busy task's frame; ``capture_profile`` of a
worker that never initialised CUDA is the stack sampler's, its files
downloaded through the head; ``/metrics/cluster`` over HTTP carries both
nodes' store gauges and loses a dead node's series; a
``CudaTrainer(device="cpu")`` run's steps reach the federated step
histogram exactly once each and ``train_stats`` counts them; an SLO
burns and recovers with one event each way on the ``SLO`` channel; the
OOM report is written under the node's log directory.
"""

import json
import os
import tempfile
import time
import urllib.request

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import state
from ray_tpu_torch._private import worker as worker_mod
from ray_tpu_torch.cluster.cluster_utils import Cluster
from ray_tpu_torch.cluster.gcs_client import GcsClient
from ray_tpu_torch.core.config import config
from ray_tpu_torch.util import goodput
from ray_tpu_torch.util import metrics

import torch_ops_loops as L

OVERRIDES = {"signal_scrape_interval_s": 0.2, "slo_eval_interval_s": 0.2,
             "slo_burn_evals": 2}


@pytest.fixture(scope="module")
def cluster():
    for k, v in OVERRIDES.items():
        config.override(k, v)
    ray_tpu_torch.shutdown()
    c = Cluster()
    c.add_node(num_cpus=2)
    c.add_node(num_cpus=2)
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address, log_to_driver=False)
    yield c
    ray_tpu_torch.shutdown()
    dirs = [n.log_dir for n in c.nodes]
    c.shutdown()
    assert not any(os.path.exists(d) for d in dirs)
    for k in OVERRIDES:
        config.reset(k)


def _wait(pred, timeout=30.0, interval=0.1):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(interval)
    return pred()


def _scrape(c, path="/metrics/cluster") -> str:
    url = f"http://{c.head.metrics_address}{path}"
    with urllib.request.urlopen(url, timeout=15) as r:
        assert r.status == 200
        return r.read().decode()


def _worker_of(pid):
    return next(rec["worker_id"] for rec in state.list_logs()
                if rec["pid"] == pid)


# -- logs ------------------------------------------------------------------------


def test_a_workers_print_reaches_the_driver_and_get_log(cluster):
    pid = ray_tpu_torch.get(L.chatty.remote("alpha", 5), timeout=60)
    wid = _worker_of(pid)
    backend = worker_mod.backend()
    want = [f"alpha line {i}" for i in range(5)]
    got = _wait(lambda: [r["line"] for r in backend.received_logs()
                         if r["line"].startswith("alpha")] or None)
    assert got[:5] == want and got[5] == "alpha on stderr"
    assert all(r["worker_id"] == wid and r["pid"] == pid
               for r in backend.received_logs()
               if r["line"].startswith("alpha"))
    tail = state.get_log(wid, tail_lines=50)
    assert all(line in tail.splitlines() for line in want)
    assert "alpha on stderr" in state.get_log(wid, stream="err")
    rec = state.get_log(wid, offset=0)
    assert rec["offset"] == rec["size"] and "alpha line 0" in rec["data"]
    listed = {r["worker_id"]: r for r in state.list_logs()}
    assert listed[wid]["alive"] and listed[wid]["stdout_bytes"] > 0
    # The head's ring, read with a cursor.
    cursor, entries = cluster.head.rpc_drain_logs(0, 10_000)
    assert [e["line"] for e in entries if e["pid"] == pid][:5] == want


def test_threads_printing_at_once_splice_no_line():
    """``print`` writes its text and its newline in two calls: a tee
    that kept one partial line for the process would join one thread's
    text to another's."""
    import io
    import threading

    from ray_tpu_torch.cluster.workerproc import _TeeStream

    sink = []
    tee = _TeeStream(io.StringIO(), sink, threading.Lock())

    def run(*texts):
        t = threading.Thread(target=lambda: [tee.write(x) for x in texts])
        t.start()
        t.join()

    first = threading.Thread(target=lambda: (tee.write("a1"), hold.wait(),
                                             tee.write("\n")))
    hold = threading.Event()
    first.start()
    _wait(lambda: bool(tee._partial))
    run("b1", "\n")
    hold.set()
    first.join()
    assert sink == ["b1", "a1"] and not tee._partial


def test_a_workers_threads_reach_the_driver_line_by_line(cluster):
    pid = ray_tpu_torch.get(L.chorus.remote("gamma", 4, 200), timeout=60)
    backend = worker_mod.backend()
    want = sorted(f"gamma {t}.{i}" for t in range(4) for i in range(200))
    got = _wait(lambda: (lambda lines: lines if len(lines) >= len(want)
                         else None)(
        [r["line"] for r in backend.received_logs()
         if r["pid"] == pid and "gamma" in r["line"]]))
    assert sorted(got) == want


def test_follow_log_streams_a_growing_log(cluster):
    ref = L.drip.remote("beta", 6, 0.15)
    wid = _wait(lambda: next((r["worker_id"] for r in state.list_logs()
                              if "beta drip 0" in (state.get_log(
                                  r["worker_id"], tail_lines=20)
                                  if r["alive"] else "")), None))
    assert wid
    chunks = []
    for chunk in state.follow_log(wid, idle_timeout_s=1.0):
        chunks.append(chunk)
        if "beta drip 5" in "".join(c["data"] for c in chunks):
            break
    assert ray_tpu_torch.get(ref, timeout=60) == wid
    text = "".join(c["data"] for c in chunks)
    assert all(f"beta drip {i}" in text for i in range(6))
    assert len(chunks) >= 2  # it streamed as the file grew
    assert chunks[-1]["offset"] == sum(len(c["data"].encode())
                                       for c in chunks)


# -- stacks and profiles ---------------------------------------------------------


def _busy_worker():
    """(ref, worker id) of a ``busy`` task, found by its stack."""
    ref = L.busy.remote(3.0)

    def find():
        for st in state.worker_stats(fresh=True):
            try:
                if "_spin_here" in state.dump_stack(st["worker_id"]):
                    return st["worker_id"]
            except ValueError:
                continue
        return None

    return ref, _wait(find, timeout=20.0, interval=0.05)


def test_dump_stack_and_profile_worker_see_the_busy_frame(cluster):
    ref, wid = _busy_worker()
    assert wid is not None
    stack = state.dump_stack(wid)
    assert stack.startswith(f"worker {wid}") and "_spin_here" in stack
    prof = state.profile_worker(wid, duration_s=0.3)
    assert prof["worker_id"] == wid and prof["num_samples"] > 5
    assert any("_spin_here" in f for s in prof["stacks"]
               for f in s["frames"])
    assert "_spin_here" in state.profile_worker(wid, duration_s=0.1,
                                                fmt="collapsed")
    assert ray_tpu_torch.get(ref, timeout=60) == wid


def test_capture_profile_of_a_cpu_worker_is_the_stack_samplers(cluster):
    ref, wid = _busy_worker()
    with tempfile.TemporaryDirectory() as out:
        cap = state.capture_profile(wid, duration_s=0.4, out_dir=out)
        assert cap["kind"] == "stack_sampler" and cap["worker_id"] == wid
        names = sorted(os.path.basename(p) for p in cap["files"])
        assert names == ["stack_collapsed.txt", "stack_report.txt",
                         "stack_trace.json"]
        with open(os.path.join(out, "stack_collapsed.txt")) as f:
            assert "_spin_here" in f.read()
        with open(os.path.join(out, "stack_trace.json")) as f:
            events = json.load(f)
        assert events and all(e["ph"] == "X" for e in events)
    assert ray_tpu_torch.get(ref, timeout=60) == wid


def test_capture_downloads_in_bounded_reads(cluster):
    """A file larger than one read streams back in several, and the
    bytes are the agent's."""
    agent = cluster.nodes[0]
    cap_dir = os.path.join(agent.log_dir, "tprof-test")
    os.makedirs(cap_dir, exist_ok=True)
    blob = os.urandom(2_500_000)
    with open(os.path.join(cap_dir, "big.bin"), "wb") as f:
        f.write(blob)
    agent._captures["tprof-test"] = {
        "capture_id": "tprof-test", "node_id": agent.node_id,
        "files": [{"name": "big.bin", "size": len(blob)}], "dir": cap_dir}
    reads = []
    parts = []
    offset = 0
    while offset < len(blob):
        chunk = cluster.head.rpc_read_capture_file(
            agent.node_id, "tprof-test", "big.bin", offset, 1 << 20)
        reads.append(len(chunk["data"]))
        parts.append(chunk["data"])
        offset = chunk["offset"]
    assert b"".join(parts) == blob and reads == [1 << 20, 1 << 20,
                                                 len(blob) - (2 << 20)]
    with pytest.raises(ValueError):
        agent.rpc_read_capture_file("tprof-test", "../escape", 0)


# -- metrics federation and the signal plane --------------------------------------


def test_metrics_cluster_carries_both_nodes_store_gauges(cluster):
    body = _scrape(cluster)
    parsed = metrics.parse_prometheus(body)
    for fam in ("ray_tpu_object_store_bytes_used",
                "ray_tpu_object_store_bytes_capacity",
                "ray_tpu_object_store_objects"):
        nodes = {dict(k)["node_id"] for k in parsed.get(fam, {})}
        assert {n.node_id for n in cluster.nodes} <= nodes, fam
    cap = {dict(k)["node_id"]: v for k, v in parsed[
        "ray_tpu_object_store_bytes_capacity"].items()}
    for n in cluster.nodes:
        assert cap[n.node_id] == n.store.stats()["capacity"]
    assert "ray_tpu_head_rpc_seconds_count" in parsed
    assert body.count("# TYPE ray_tpu_object_store_bytes_used") == 1
    targets = json.loads(_scrape(cluster, "/metrics/targets"))
    assert targets[0]["targets"] == [cluster.head.metrics_address]
    assert targets[0]["labels"]["__metrics_path__"] == "/metrics/cluster"
    gcs = GcsClient(cluster.address)
    try:
        assert gcs.metrics.endpoint()["address"] == \
            cluster.head.metrics_address
    finally:
        gcs.close()


def test_metrics_cluster_takes_an_agents_fresh_gauge_over_the_heads(
        cluster, monkeypatch):
    """The head and the agents of an in-process cluster share one
    registry, and a duplicate series keeps its first-seen sample: an
    agent's render, made right after it refreshed its device gauges, must
    win over the head's copy of the previous refresh (phase 12 of
    ``chip_smoke.py`` holds the scraped gauge to ``device_stats``)."""
    tags = {"node_id": cluster.nodes[0].node_id, "worker_id": "w-probe",
            "device": "cuda:0"}
    metrics.DEVICE_MEM_IN_USE.set(111.0, tags=tags)  # the last refresh
    fresh = metrics.prometheus_text().replace(
        'device="cuda:0"} 111.0', 'device="cuda:0"} 222.0')
    assert 'device="cuda:0"} 222.0' in fresh
    monkeypatch.setattr(cluster.head, "_fanout_agents",
                        lambda method, timeout: [(tags["node_id"], fresh)])
    try:
        parsed = metrics.parse_prometheus(cluster.head.cluster_metrics_text())
    finally:
        metrics.DEVICE_MEM_IN_USE.remove(tags=tags)
    got = {dict(k)["worker_id"]: v for k, v in parsed[
        "ray_tpu_device_memory_bytes_in_use"].items()}
    assert got["w-probe"] == 222.0


def test_metrics_cluster_takes_a_nodes_series_from_its_own_agent(
        cluster, monkeypatch):
    """Two agents render the shared registry at once: the one rendered
    first carries node B's gauge as B last refreshed it, B's own render
    the value B refreshed just before; the scrape takes B's (phase 12 of
    ``chip_smoke.py`` failed on the other agent's copy)."""
    a, b = "node-a-probe", cluster.nodes[0].node_id
    tags = {"node_id": b, "worker_id": "w-probe-b", "device": "cuda:0"}
    metrics.DEVICE_MEM_IN_USE.set(111.0, tags=tags)  # B's last refresh
    stale = metrics.prometheus_text()
    fresh = stale.replace('device="cuda:0"} 111.0', 'device="cuda:0"} 222.0')
    assert 'device="cuda:0"} 222.0' in fresh
    monkeypatch.setattr(cluster.head, "_fanout_agents",
                        lambda method, timeout: [(a, stale), (b, fresh)])
    try:
        parsed = metrics.parse_prometheus(cluster.head.cluster_metrics_text())
    finally:
        metrics.DEVICE_MEM_IN_USE.remove(tags=tags)
    got = {dict(k)["worker_id"]: v for k, v in parsed[
        "ray_tpu_device_memory_bytes_in_use"].items()}
    assert got["w-probe-b"] == 222.0


def test_a_dead_nodes_series_are_pruned(cluster):
    extra = cluster.add_node(num_cpus=1)
    cluster.wait_for_nodes()
    q = {"op": "gauge_last", "name": "ray_tpu_object_store_bytes_capacity",
         "window_s": 30.0, "group_by": "node_id"}
    assert _wait(lambda: extra.node_id in (
        state.query_metrics(q).get("value") or {}))
    cluster.remove_node(extra, graceful=False)
    parsed = metrics.parse_prometheus(_scrape(cluster))
    assert extra.node_id not in {
        dict(k)["node_id"] for k in
        parsed.get("ray_tpu_object_store_bytes_used", {})}
    assert extra.node_id not in (state.query_metrics(q).get("value") or {})
    assert state.slo_status()["evictions"]["dead_node"] > 0


def test_a_cluster_trainer_run_counts_each_step_once(cluster):
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2

    cfg = GPT2Config(vocab_size=256, n_layer=2, n_head=4, d_model=64,
                     seq_len=64, dtype=torch.float32, remat="dots")
    with tempfile.TemporaryDirectory() as tmp:
        progress = os.path.join(tmp, "progress.jsonl")
        run = measure_trainer_gpt2(
            cfg, 4, steps=8, warmup=2, device="cpu",
            address=cluster.address, progress_path=progress,
            print_loss=True, stay_connected=True)
        lines = [json.loads(x) for x in open(progress).read().splitlines()]
    node = lines[0]["node"]
    wid = lines[0]["worker_id"]
    reports = len(run["reports"]) + 1  # the step reports and the final
    want_losses = [f"step {i + 1} loss {loss!r}"
                   for i, loss in enumerate(run["losses"])]

    def step_count():
        parsed = metrics.parse_prometheus(_scrape(cluster))
        return sum(v for k, v in parsed.get(
            "ray_tpu_train_step_phase_seconds_count", {}).items()
            if dict(k).get("phase") == "step"
            and dict(k).get("node_id") == node)

    assert _wait(lambda: step_count() >= reports, timeout=20.0)
    time.sleep(0.6)  # a duplicate would land with the next batches
    assert step_count() == reports
    stats = state.train_stats()["trials"]["train"]
    assert stats["reports"] >= reports
    assert stats["phases"]["step"]["count"] >= reports
    # The ring holds the federated counter at its count.
    assert _wait(lambda: state.query_metrics({
        "op": "gauge_last", "name": "ray_tpu_train_reports_total",
        "window_s": 60.0, "match": {"node_id": node}}).get("value")
        == reports)
    logged = [ln for ln in state.get_log(wid, tail_lines=200).splitlines()
              if ln.startswith("step ")]
    assert logged == want_losses
    backend = worker_mod.backend()
    assert _wait(lambda: [r["line"] for r in backend.received_logs()
                          if r["worker_id"] == wid
                          and r["line"].startswith("step ")]
                 == want_losses)


def test_an_slo_burns_and_recovers_over_pubsub(cluster):
    gcs = GcsClient(cluster.address)
    gcs.pubsub.subscribe("test-slo", "SLO")
    events = []

    def drain(until=None, timeout=15.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            msgs, _ = gcs.pubsub.poll("test-slo", timeout=0.3)
            events.extend(m["data"] for m in msgs
                          if m["data"].get("slo") == "pool")
            if until and any(e["state"] == until for e in events):
                return True
        return False

    try:
        goodput.record_pool_size("slo-pool", 1, 0)
        reg = state.register_slo(
            "pool", 'gauge_last(ray_tpu_data_pool_size){pool="slo-pool"} '
                    '< 5 over 2s')
        assert reg["ok"], reg
        bad = state.register_slo("bad", "frobnicate(x) < 1s")
        assert bad["ok"] is False and "frobnicate" in bad["error"]
        drain(timeout=1.0)
        assert events == []
        goodput.record_pool_size("slo-pool", 10, 0)
        assert drain(until="burning")
        assert state.slo_status()["slos"]["pool"]["state"] == "burning"
        goodput.record_pool_size("slo-pool", 1, 0)
        assert drain(until="ok")
        assert [e["state"] for e in events] == ["burning", "ok"]
        top = state.signal_top(10.0)
        assert top["ok"] and "pool" in top["slos"]
    finally:
        state.remove_slo("pool")
        goodput.retract_gauges([("pool", "slo-pool")], "local")
        gcs.close()
    assert "pool" not in state.slo_status()["slos"]


# -- OOM reports -------------------------------------------------------------------


def test_oom_reports_live_under_the_log_directory(cluster):
    agent = cluster.nodes[1]
    ray_tpu_torch.get(L.job.remote(), timeout=60)
    with agent._lock:
        victim = next(iter(agent._workers.values()))
    path = agent.write_oom_report("test pressure", victim)
    try:
        assert os.path.dirname(path) == agent.log_dir
        with open(path) as f:
            report = json.load(f)
        assert report["reason"] == "test pressure"
        assert report["victim"]["worker_id"] == victim.worker_id
        assert any(r["path"] == path for rep in state.object_store_stats(
            node_id=agent.node_id) for r in rep["oom_reports"])
    finally:
        agent.discard_oom_report(path)
    assert not os.path.exists(path)
