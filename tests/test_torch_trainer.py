"""ray_tpu_torch's trainer and its runtime against the JAX package's, on
the CPU.

The first cases mirror ``tests/test_train.py`` on the port's local
backend, with the same expectations: report and result, ranks, dataset
sharding, the best checkpoint kept, the ``Checkpoint`` forms (the object
ref through the port's object store), a restart from a checkpoint, and
the failure budget used up. Then the port is held against the JAX package:
a tiny GPT-2 (fp32, weights drawn from one numpy seed and carried to both
packages as numpy arrays, ``models/convert.py`` on the port's side) trains
4 steps under JAX's ``DataParallelTrainer`` and under the port's
``CudaTrainer(device="cpu")``: the ``metrics_history`` losses agree within
rtol 1e-4. The same run with rank 0 raising after step 2 restarts from
the step-2 checkpoint in both packages, and each resumed run's losses
match its unbroken run's within rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import train as jtrain
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import session as jsession
from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
from ray_tpu.train.train_step import make_train_step as jmake_train_step
from ray_tpu_torch._tree import tree_map
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.train import session
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
from ray_tpu_torch.train.trainer import CudaTrainer, DataParallelTrainer


@pytest.fixture(autouse=True, scope="module")
def _runtime():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()


# -- the runtime the trainer stands on ------------------------------------------


def test_tasks_objects_and_wait():
    @ray_tpu_torch.remote(num_returns=2)
    def split(x):
        return x, x * 2

    @ray_tpu_torch.remote
    def slow():
        import time

        time.sleep(0.5)

    a, b = split.remote(ray_tpu_torch.put(3))
    assert ray_tpu_torch.get([a, b]) == [3, 6]
    pending = slow.remote()
    ready, rest = ray_tpu_torch.wait([a, pending], num_returns=1,
                                     timeout=0.0)
    assert ready == [a] and rest == [pending]
    with pytest.raises(ray_tpu_torch.GetTimeoutError):
        ray_tpu_torch.get(pending, timeout=0.01)
    assert ray_tpu_torch.get(pending, timeout=10) is None
    with pytest.raises(TypeError):
        ray_tpu_torch.put(a)


def test_actors_keep_order_and_die_when_killed():
    @ray_tpu_torch.remote
    class Counter:
        def __init__(self):
            self.n = 0

        def add(self, k):
            self.n += k
            return self.n

    c = Counter.options(name="counter").remote()
    assert ray_tpu_torch.get([c.add.remote(k) for k in (1, 2, 3)]) == [1, 3, 6]
    assert ray_tpu_torch.get_actor("counter")._actor_id == c._actor_id
    ray_tpu_torch.kill(c)
    with pytest.raises(ray_tpu_torch.ActorError):
        ray_tpu_torch.get(c.add.remote(1))
    with pytest.raises(ValueError):
        ray_tpu_torch.get_actor("counter")


def test_task_errors_and_infeasible_demands():
    @ray_tpu_torch.remote
    def boom():
        raise KeyError("x")

    with pytest.raises(ray_tpu_torch.TaskError, match="KeyError"):
        ray_tpu_torch.get(boom.remote())
    # No GPU resource is advertised yet (ROADMAP A5): the demand raises.
    with pytest.raises(ValueError, match="infeasible"):
        ray_tpu_torch.get(boom.options(num_gpus=1).remote())
    assert ray_tpu_torch.cluster_resources() == {"CPU": 8.0}


def test_placement_groups_reserve_and_release():
    from ray_tpu_torch.util.placement_group import (
        placement_group,
        placement_group_table,
        remove_placement_group,
    )

    free = ray_tpu_torch.available_resources()["CPU"]
    pg = placement_group([{"CPU": 2}, {"CPU": 2}], strategy="PACK")
    assert ray_tpu_torch.get(pg.ready(), timeout=10) == pg.id
    assert ray_tpu_torch.available_resources()["CPU"] == free - 4
    remove_placement_group(pg)
    assert placement_group_table(pg)["state"] == "REMOVED"
    assert ray_tpu_torch.available_resources()["CPU"] == free
    bad = placement_group([{"CPU": 100}])
    assert not bad.wait(0.1)
    assert placement_group_table(bad)["state"] == "INFEASIBLE"


def test_device_stats_is_the_telemetry_snapshot_and_streams_are_refused():
    from ray_tpu_torch._private import worker

    (snap,) = worker.backend().device_stats()
    # No CUDA context in the CPU tests: the stub, with no device listed.
    assert snap["worker_id"] == "local" and snap["node_id"] == "local"
    assert not snap["available"] and snap["devices"] == []

    def gen():
        yield 1

    with pytest.raises(TypeError):
        ray_tpu_torch.remote(num_returns="streaming")(gen)


# -- tests/test_train.py on the port's runtime --------------------------------


def test_basic_report_and_result():
    def loop(config):
        for i in range(3):
            session.report({"step": i, "loss": 1.0 / (i + 1)})

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2)).fit()
    assert result.error is None
    assert result.metrics["step"] == 2
    assert len(result.metrics_history) == 3  # rank-0 reports only


def test_world_rank_and_size():
    def loop(config):
        session.report(
            {"rank": session.get_world_rank(), "ws": session.get_world_size()})

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=3)).fit()
    assert result.metrics == {"rank": 0, "ws": 3}


def test_dataset_sharding():
    data = np.arange(12)

    def loop(config):
        shard = session.get_dataset_shard("train")
        session.report({"total": int(np.sum(shard)), "n": len(shard)})

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": data}).fit()
    assert result.metrics["n"] == 6  # 12 items over 2 workers


def test_checkpoint_reported_and_best_kept():
    def loop(config):
        for i in range(4):
            session.report({"score": i},
                           checkpoint=Checkpoint.from_dict({"model": i}))

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(checkpoint_config=CheckpointConfig(
            num_to_keep=2, checkpoint_score_attribute="score"))).fit()
    assert result.checkpoint is not None
    assert result.checkpoint.to_dict()["model"] == 3  # best score


def test_checkpoint_roundtrip_forms(tmp_path):
    ckpt = Checkpoint.from_dict({"weights": np.ones(4), "step": 7,
                                 "t": torch.arange(3.0)})
    d = ckpt.to_directory(str(tmp_path / "ck"))
    restored = Checkpoint.from_directory(d).to_dict()
    assert restored["step"] == 7
    np.testing.assert_allclose(restored["weights"], np.ones(4))
    assert torch.equal(restored["t"], torch.arange(3.0))
    ref = ckpt.to_object_ref()
    assert isinstance(ref, ray_tpu_torch.ObjectRef)
    again = Checkpoint.from_object_ref(ref)
    assert again.to_object_ref() is ref
    assert again.to_dict()["step"] == 7
    with pytest.raises(ValueError):
        Checkpoint(data={}, directory=str(tmp_path))


def test_elastic_restart_resumes_from_checkpoint():
    """First attempt dies mid-run; retry resumes from the checkpoint."""

    def loop(config):
        start = 0
        ckpt = session.get_checkpoint()
        if ckpt is not None:
            start = ckpt.to_dict()["step"] + 1
        for i in range(start, 4):
            session.report({"step": i},
                           checkpoint=Checkpoint.from_dict({"step": i}))
            if i == 1 and ckpt is None and session.get_world_rank() == 0:
                raise RuntimeError("simulated worker failure")

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)),
    ).fit()
    assert result.error is None
    assert result.metrics["step"] == 3
    # resumed at 2 (ckpt step 1 + 1), so 0,1 then 2,3 -> 4 reports
    assert [m["step"] for m in result.metrics_history] == [0, 1, 2, 3]
    assert result.goodput["restarts"] == 1
    assert set(result.goodput["by_cause"]) == {"failure"}


def test_failure_exhausts_retries():
    def loop(config):
        raise RuntimeError("always fails")

    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is not None
    assert isinstance(result.error, ray_tpu_torch.TaskError)
    assert result.goodput["restarts"] == 0


def test_elastic_group_is_kept_across_attempts():
    """With ``min_workers`` one placement group serves every attempt."""
    from ray_tpu_torch.util.placement_group import placement_group_table

    attempts = []

    def loop(config):
        if session.get_world_rank() == 0:
            attempts.append(1)
            if len(attempts) == 1:
                raise RuntimeError("first attempt fails")
        session.report({"ws": session.get_world_size()})

    before = set(placement_group_table())
    result = DataParallelTrainer(
        loop, scaling_config=ScalingConfig(num_workers=2, min_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
    ).fit()
    assert result.error is None and result.metrics == {"ws": 2}
    assert len(attempts) == 2
    created = set(placement_group_table()) - before
    assert len(created) == 1  # one group for both attempts
    assert placement_group_table()[created.pop()]["state"] == "REMOVED"
    with pytest.raises(ValueError, match="min_workers"):
        ScalingConfig(num_workers=2, min_workers=3)


def test_cuda_trainer_names_its_device_and_raises_without_cuda(monkeypatch):
    def loop(config):
        session.report({"device": str(session.get_device())})

    result = CudaTrainer(loop, device="cpu").fit()
    assert result.metrics == {"device": "cpu"}
    assert DataParallelTrainer(loop).fit().metrics == {"device": "None"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        CudaTrainer(loop)


def test_init_refuses_a_cluster_address():
    ray_tpu_torch.shutdown()
    try:
        with pytest.raises(NotImplementedError, match="A4b"):
            ray_tpu_torch.init(address="tcp://127.0.0.1:6379")
        assert not ray_tpu_torch.is_initialized()
    finally:
        ray_tpu_torch.init(num_cpus=8)


# -- the port's trainer against the JAX package's -------------------------------

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64,
            remat="dots", ce_vocab_chunks=4, fused_norm=True,
            scan_layers=False)
N_STEPS = 4


def _numpy_params():
    """The tiny GPT-2's parameter tree drawn from one numpy seed: N(0, 0.02)
    matrices and biases, LayerNorm scales around 1."""
    shapes = tree_map(lambda t: tuple(t.shape), tgpt2.gpt2_init(
        torch.Generator().manual_seed(0),
        tgpt2.GPT2Config(**TINY, dtype=torch.float32), device="cpu"))
    rng = np.random.default_rng(11)
    out = {}

    def draw(tree, node, prefix=""):
        for k in sorted(tree):
            if isinstance(tree[k], dict):
                node[k] = {}
                draw(tree[k], node[k], k)
                continue
            x = rng.standard_normal(tree[k]).astype(np.float32)
            node[k] = 1.0 + 0.1 * x if k.endswith("scale") else 0.02 * x

    draw(shapes, out)
    return out


def _tokens():
    return np.random.default_rng(5).integers(0, 256, (8, 65), dtype=np.int32)


def _jax_run(params, tokens, fail_after):
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    mesh = build_mesh(MeshConfig())
    shardings = jgpt2.gpt2_shardings(jcfg, mesh)
    init = jmake_init_fn(lambda r: jax.tree.map(jnp.asarray, params),
                         shardings, mesh)
    step = jmake_train_step(lambda p, b: jgpt2.gpt2_loss(p, b, jcfg),
                            shardings, mesh)
    batch = {"tokens": jnp.asarray(tokens)}

    def loop(config):
        ckpt = jsession.get_checkpoint()
        state = (init(jax.random.key(0)) if ckpt is None
                 else ckpt.to_dict()["state"])
        for i in range(int(state["step"]), N_STEPS):
            if i == fail_after and ckpt is None:
                raise RuntimeError("injected failure after step 2")
            state, m = step(state, batch)
            keep = (jtrain.Checkpoint.from_dict({"state": state})
                    if (i + 1) % 2 == 0 else None)
            jsession.report({"loss": float(m["loss"]), "step": i + 1},
                            checkpoint=keep)

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        result = jtrain.DataParallelTrainer(
            loop, scaling_config=jtrain.ScalingConfig(num_workers=1),
            run_config=jtrain.RunConfig(failure_config=jtrain.FailureConfig(
                max_failures=1))).fit()
    finally:
        ray_tpu.shutdown()
    return result


def _port_run(params, tokens, fail_after):
    cfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    step = make_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, cfg))

    def copy(state):
        return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor)
                        else x, state)

    def loop(config):
        dev = session.get_device()
        batch = {"tokens": torch.from_numpy(tokens).to(dev)}
        ckpt = session.get_checkpoint()
        if ckpt is None:
            state = make_init_fn(lambda g: params_from_numpy(params, dev))(
                torch.Generator())
        else:
            state = copy(ckpt.to_dict()["state"])
        for i in range(state["step"], N_STEPS):
            if i == fail_after and ckpt is None:
                raise RuntimeError("injected failure after step 2")
            state, m = session.timed_step(step, state, batch)
            keep = (Checkpoint.from_dict({"state": copy(state)})
                    if (i + 1) % 2 == 0 else None)
            session.report({"loss": float(m["loss"]), "step": i + 1},
                           checkpoint=keep)

    return CudaTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
        device="cpu").fit()


@pytest.fixture(scope="module")
def runs():
    params, tokens = _numpy_params(), _tokens()
    return {(pkg, fail): run(params, tokens, fail)
            for pkg, run in (("jax", _jax_run), ("port", _port_run))
            for fail in (None, 2)}


def _losses(result):
    assert result.error is None
    assert [m["step"] for m in result.metrics_history] == list(
        range(1, N_STEPS + 1))
    return [m["loss"] for m in result.metrics_history]


def test_trainer_losses_match_jax(runs):
    port, jax_ = _losses(runs["port", None]), _losses(runs["jax", None])
    np.testing.assert_allclose(port[0], jax_[0], rtol=1e-5)
    np.testing.assert_allclose(port, jax_, rtol=1e-4)
    assert port[-1] < port[0]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_restart_from_checkpoint_resumes_the_unbroken_run(runs, pkg):
    broken = runs[pkg, 2]
    assert broken.goodput["restarts"] == 1
    np.testing.assert_allclose(_losses(broken), _losses(runs[pkg, None]),
                               rtol=1e-5)


def test_restarted_port_run_matches_the_restarted_jax_run(runs):
    np.testing.assert_allclose(_losses(runs["port", 2]),
                               _losses(runs["jax", 2]), rtol=1e-4)
