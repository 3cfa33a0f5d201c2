"""ray_tpu_torch.tune's Tuner and trial runner on the local backend.

The first cases are the port's counterparts of the Tuner tests of
``tests/test_tune.py``, ``tests/test_tune_search.py`` and
``tests/test_tune_syncer.py``, with the same checks: fit and the best
result, a captured error, a retry from a checkpoint, PBT, the legacy
``run``, stoppers and ``with_resources``, persistence and
``Tuner.restore``, a sync to ``file://`` and a restore from it, TPE and
BOHB inside a Tuner. Then what the port adds: a trial failed by a
preemption retried without spending ``max_failures``, a stopped trial's
thread stopping at its next report, and a trainer run in a trial's gang placing its worker in
the gang.

Then the slice as a whole against the JAX package: ASHA over three
learning rates of the tiny GPT-2 of ``tests/test_torch_trainer.py``
(fp32, the same numpy parameters and tokens), one trial at a time,
through the JAX package's Tuner (a JAX trial function) and through the
port's (``scripts/measure.py:measure_tune_gpt2``, which runs
``tune_gpt2_trial``): the same trials stop at the same iterations, the
best config is the same, and the losses agree within fp32 rtol 1e-4. And
a trial running ``CudaTrainer(device="cpu")`` gives the direct trainer
run's losses.
"""

import json
import os
import pickle
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
import torch_tune_loops as L
from ray_tpu import tune as jtune
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train.optim import AdamWConfig as JAdamWConfig
from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
from ray_tpu.train.train_step import make_train_step as jmake_train_step
from ray_tpu_torch import tune
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.scripts import measure
from ray_tpu_torch.train.config import FailureConfig, RunConfig
from ray_tpu_torch.tune import (
    ASHAScheduler,
    BOHBSearcher,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TPESearcher,
    TuneConfig,
    Tuner,
)
from ray_tpu_torch.tune.search_space import Uniform
from ray_tpu_torch.util.placement_group import placement_group_table
from test_torch_trainer import TINY, _numpy_params, _tokens


@pytest.fixture(autouse=True, scope="module")
def _runtime():
    # One intra-op thread: the tiny GPT-2's ops are too small to split,
    # and split over every core they wait on each other when the other
    # processes of a parallel test run hold the cores.
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=16)
    yield
    ray_tpu_torch.shutdown()
    torch.set_num_threads(threads)


# -- the reference's Tuner tests, on the port -----------------------------------


def test_tuner_fit_and_best_result():
    def objective(config):
        tune.report(score=-((config["x"] - 3.0) ** 2))

    grid = Tuner(
        objective,
        param_space={"x": tune.grid_search([0.0, 1.0, 3.0, 5.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
    ).fit()
    assert len(grid) == 4
    best = grid.get_best_result()
    assert best.config["x"] == 3.0
    assert best.metrics["score"] == 0.0
    df = grid.get_dataframe()
    assert "config/x" in df.columns and len(df) == 4


def test_trial_error_is_captured():
    def objective(config):
        if config["x"] == 1:
            raise RuntimeError("bad trial")
        tune.report(score=config["x"])

    grid = Tuner(
        objective,
        param_space={"x": tune.grid_search([0, 1, 2])},
        tune_config=TuneConfig(metric="score"),
    ).fit()
    assert len(grid.errors) == 1
    assert "bad trial" in str(grid.errors[0])
    assert grid.get_best_result().config["x"] == 2


@pytest.mark.parametrize("scheduler", ["asha", "median"])
def test_early_stopping_schedulers_stop_bad_trials(scheduler):
    if scheduler == "asha":
        def objective(config):
            for i in range(32):
                tune.report(score=config["target"] * (i + 1))

        # Good trials first: a trial with no peers at a rung is never
        # stopped (async halving), so the bad ones are the ones cut.
        grid = Tuner(
            objective,
            param_space={"target": tune.grid_search([10.0, 1.0, 0.1, 0.0])},
            tune_config=TuneConfig(
                metric="score", mode="max",
                scheduler=ASHAScheduler(metric="score", mode="max", max_t=32,
                                        grace_period=2, reduction_factor=2),
                max_concurrent_trials=1),
        ).fit()
        assert grid.get_best_result().config["target"] == 10.0
        worst = min(grid, key=lambda r: r.config["target"])
        assert len(worst.metrics_history) < 32
    else:
        def objective(config):
            for _ in range(8):
                tune.report(score=config["q"])

        grid = Tuner(
            objective,
            param_space={"q": tune.grid_search([1.0, 1.0, 1.0, 0.0])},
            tune_config=TuneConfig(
                metric="score",
                scheduler=MedianStoppingRule(metric="score", grace_period=1,
                                             min_samples_required=2),
                max_concurrent_trials=2),
        ).fit()
        assert grid.get_best_result().metrics["score"] == 1.0


def test_trial_retry_from_checkpoint():
    def objective(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt else 0
        for i in range(start, 5):
            tune.report({"i": i},
                        checkpoint=tune.Checkpoint.from_dict({"i": i}))
            if i == 2 and ckpt is None:
                raise RuntimeError("mid-trial crash")

    grid = Tuner(
        objective,
        param_space={"x": tune.grid_search([0])},
        tune_config=TuneConfig(metric="i"),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=1)),
    ).fit()
    r = grid[0]
    assert r.error is None
    assert r.metrics["i"] == 4
    assert [m["i"] for m in r.metrics_history] == [0, 1, 2, 3, 4]


def test_a_preempted_trial_retries_without_spending_max_failures(
        monkeypatch):
    """A failure whose cause names a drain (the head's format for a node
    lost to a preemption) restarts the trial from its checkpoint although
    ``max_failures`` is 0, and the trial's downtime is booked to it."""
    def objective(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["i"] + 1 if ckpt else 0
        for i in range(start, 4):
            tune.report({"i": i},
                        checkpoint=tune.Checkpoint.from_dict({"i": i}))
            if i == 1 and ckpt is None:
                raise RuntimeError("node n1 died: drained: preemption")

    runner_trials = []
    orig = tune.TrialRunner.run

    def keep(self):
        runner_trials.extend(self.trials)
        return orig(self)

    monkeypatch.setattr(tune.TrialRunner, "run", keep)
    grid = Tuner(objective, param_space={"x": tune.grid_search([0])},
                 tune_config=TuneConfig(metric="i")).fit()
    assert grid[0].error is None
    assert [m["i"] for m in grid[0].metrics_history] == [0, 1, 2, 3]
    (trial,) = runner_trials
    assert trial.num_failures == 0
    view = trial.goodput()
    assert view["restarts"] == 1
    assert list(view["by_cause"]) == ["drain:preemption"]


def test_pbt_exploits_and_perturbs():
    """Low-lr trials adopt (a perturbation of) a high lr."""

    def objective(config):
        lr = config["lr"]
        ckpt = tune.get_checkpoint()
        total = ckpt.to_dict()["total"] if ckpt else 0.0
        for _ in range(16):
            total += lr
            tune.report({"score": total, "lr": lr},
                        checkpoint=tune.Checkpoint.from_dict({"total": total}))

    pbt = PopulationBasedTraining(
        metric="score", mode="max", perturbation_interval=4,
        hyperparam_mutations={"lr": (0.001, 1.0)}, quantile_fraction=0.5,
        seed=0)
    grid = Tuner(
        objective,
        param_space={"lr": tune.grid_search([0.001, 0.002, 0.5, 0.6])},
        tune_config=TuneConfig(metric="score", mode="max", scheduler=pbt,
                               max_concurrent_trials=4),
    ).fit()
    assert grid.get_best_result().metrics["score"] > 0.5
    final_lrs = sorted(r.config["lr"] for r in grid)
    assert final_lrs[0] > 0.001 or final_lrs[1] > 0.002


def test_tune_run_legacy_entry():
    def objective(config):
        tune.report(score=config["x"] ** 2)

    grid = tune.run(objective, config={"x": tune.grid_search([1, 2, 3])},
                    metric="score", mode="min")
    assert grid.get_best_result().config["x"] == 1


def test_tuner_over_trainer():
    """Tune x Train: each trial runs a DataParallelTrainer."""
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    def trial_fn(config):
        def loop(loop_config):
            session.report({"loss": loop_config["lr"] * 10})

        result = DataParallelTrainer(
            loop, train_loop_config={"lr": config["lr"]},
            scaling_config=ScalingConfig(num_workers=1)).fit()
        tune.report(loss=result.metrics["loss"])

    grid = Tuner(
        trial_fn, param_space={"lr": tune.grid_search([0.1, 0.01])},
        tune_config=TuneConfig(metric="loss", mode="min",
                               max_concurrent_trials=2),
    ).fit()
    assert grid.get_best_result().config["lr"] == 0.01


def test_stoppers_and_with_resources():
    from ray_tpu_torch.tune import MaximumIterationStopper, TrialPlateauStopper

    def trainable(config):
        for i in range(50):
            tune.report({"score": float(min(i, 10))})  # plateaus at 10

    def fit(stop, fn=trainable):
        return Tuner(fn, param_space={},
                     tune_config=TuneConfig(metric="score", mode="max"),
                     run_config=RunConfig(stop=stop)).fit()

    grid = fit({"score": 5.0})
    assert not grid.errors
    assert grid[0].metrics["score"] == 5.0
    assert len(grid[0].metrics_history) <= 7
    grid = fit(MaximumIterationStopper(3))
    assert len(grid[0].metrics_history) <= 3
    grid = fit(TrialPlateauStopper("score", std=0.0, num_results=3))
    assert len(grid[0].metrics_history) < 50
    wrapped = tune.with_resources(trainable, {"CPU": 2})
    assert wrapped._tune_resources == {"CPU": 2}
    assert not fit(MaximumIterationStopper(2), wrapped).errors


def test_with_resources_rewrap_does_not_mutate():
    def fn(config):
        pass

    w1 = tune.with_resources(fn, {"CPU": 1})
    w2 = tune.with_resources(w1, {"CPU": 4})
    assert w1._tune_resources == {"CPU": 1}
    assert w2._tune_resources == {"CPU": 4}
    assert w1 is not w2
    assert w2.__wrapped__ is w1 and w1.__wrapped__ is fn
    assert w1.__name__ == "fn"


def test_a_stopped_trial_stops_at_its_next_report():
    """The runner kills a stopped trial's actor; on the local backend its
    thread runs on until its next report, which raises there (a killed
    actor's next get): the step it was in when stopped is its last."""
    steps, ended, stopped = [], threading.Event(), threading.Event()

    class Watch(tune.FIFOScheduler):
        def on_trial_complete(self, runner, trial, result):
            stopped.set()  # called after the runner killed the actor

    def trainable(config):
        try:
            for i in range(1000):
                steps.append(i)
                tune.report({"score": float(i)})
                if i == 3:
                    assert stopped.wait(30)
        finally:
            ended.set()

    grid = Tuner(trainable, param_space={},
                 tune_config=TuneConfig(metric="score", mode="max",
                                        scheduler=Watch()),
                 run_config=RunConfig(stop={"score": 3.0})).fit()
    assert grid[0].metrics["score"] == 3.0
    assert ended.wait(30)
    assert steps == [0, 1, 2, 3, 4]


def test_tuner_persistence_and_restore(tmp_path):
    """The runner snapshots trial state and checkpoints as it goes; a
    restored Tuner keeps finished trials' results and re-runs unfinished
    ones from their last checkpoint."""
    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = (ckpt.to_dict()["it"] + 1) if ckpt else 1
        for it in range(start, 6):
            tune.report(score=config["x"] * it, iteration_seen=it,
                        checkpoint=tune.Checkpoint.from_dict({"it": it}))

    storage = str(tmp_path)
    res = Tuner(
        trainable,
        param_space={"x": tune.grid_search([1.0, 2.0, 3.0])},
        tune_config=TuneConfig(metric="score", mode="max"),
        run_config=RunConfig(name="exp1", storage_path=storage),
    ).fit()
    assert len(res) == 3
    exp_dir = os.path.join(storage, "exp1")
    state_path = os.path.join(exp_dir, "experiment_state.json")
    with open(state_path) as f:
        state = json.load(f)
    assert len(state["trials"]) == 3
    assert all(r["status"] == "TERMINATED" for r in state["trials"])
    assert all(r["checkpoint_file"] for r in state["trials"])
    # A crash snapshot: two trials mid-flight at iteration 3.
    for rec in state["trials"][:2]:
        rec["status"] = "RUNNING"
        rec["last_result"] = {"score": 0.0, "training_iteration": 3}
        with open(rec["checkpoint_file"], "wb") as f:
            pickle.dump({"it": 3}, f)
    with open(state_path, "w") as f:
        json.dump(state, f)

    res2 = Tuner.restore(exp_dir, trainable).fit()
    assert len(res2) == 3
    for r in res2:
        assert r.metrics["score"] == r.config["x"] * 5
    rerun = [r for r in res2
             if r.trial_id in {t["trial_id"] for t in state["trials"][:2]}]
    assert len(rerun) == 2
    for r in rerun:
        assert r.metrics["iteration_seen"] == 5
        assert r.metrics["training_iteration"] == 2, r.metrics


def test_persisted_results_take_torch_scalars(tmp_path):
    """``_json_default`` writes a 0-d tensor as its number (and numpy
    scalars, as the reference)."""
    def trainable(config):
        tune.report(score=torch.tensor(2.5), n=np.int64(3))

    Tuner(trainable, param_space={},
          tune_config=TuneConfig(metric="score"),
          run_config=RunConfig(name="scalars",
                               storage_path=str(tmp_path))).fit()
    with open(tmp_path / "scalars" / "experiment_state.json") as f:
        (rec,) = json.load(f)["trials"]
    assert not rec.get("lossy")
    assert rec["last_result"]["score"] == 2.5 and rec["last_result"]["n"] == 3


def _sync_trainable(config):
    from ray_tpu_torch.train import session

    session.report({"score": config["x"] * 2})


def test_tuner_syncs_experiment_to_uri_and_restores(tmp_path):
    remote = f"file://{tmp_path}/remote-store"
    results = Tuner(
        _sync_trainable, param_space={"x": Uniform(0, 1)},
        tune_config=TuneConfig(metric="score", mode="max", num_samples=4,
                               seed=0),
        run_config=RunConfig(name="sync-exp", storage_path=remote),
    ).fit()
    assert len(results) == 4
    state_file = os.path.join(f"{tmp_path}/remote-store/sync-exp",
                              "experiment_state.json")
    assert os.path.exists(state_file)
    with open(state_file) as f:
        assert len(json.load(f)["trials"]) == 4
    restored = Tuner.restore(f"{remote}/sync-exp", _sync_trainable,
                             param_space={"x": Uniform(0, 1)})
    results2 = restored.fit()
    assert len(results2) == 4
    assert results2.get_best_result().metrics["score"] == pytest.approx(
        results.get_best_result().metrics["score"])
    with pytest.raises(FileNotFoundError, match="nothing to restore"):
        Tuner.restore(f"file://{tmp_path}/absent/exp", _sync_trainable)


@pytest.mark.parametrize("searcher", ["tpe", "bohb"])
def test_model_based_searchers_inside_a_tuner(searcher):
    if searcher == "tpe":
        def objective(config):
            tune.report(score=-((config["x"] - 3.0) ** 2))

        res = Tuner(
            objective, param_space={"x": tune.uniform(0.0, 10.0)},
            tune_config=TuneConfig(
                metric="score", mode="max", num_samples=25,
                search_alg=TPESearcher(n_initial=8, seed=0),
                max_concurrent_trials=4),
        ).fit()
        assert len(res) == 25
        assert abs(res.get_best_result().config["x"] - 3.0) < 1.0
    else:
        def objective(config):
            for i in range(8):
                tune.report({"score": config["x"] * (i + 1) / 8.0,
                             "training_iteration": i + 1})

        res = Tuner(
            objective, param_space={"x": Uniform(0, 1)},
            tune_config=TuneConfig(
                metric="score", mode="max", num_samples=12,
                search_alg=BOHBSearcher(n_initial=4, seed=1),
                scheduler=HyperBandScheduler(metric="score", mode="max",
                                             max_t=8)),
        ).fit()
        assert len(res) == 12
        assert res.get_best_result().metrics["score"] > 0.5


def test_searcher_space_conflict_raises():
    with pytest.raises(ValueError, match="one place"):
        Tuner(
            lambda cfg: tune.report(score=0.0),
            param_space={"x": tune.uniform(0, 1)},
            tune_config=TuneConfig(
                metric="score", num_samples=2,
                search_alg=TPESearcher(param_space={"y": tune.uniform(0, 1)})),
        ).fit()


def test_hyperband_brackets_stop_bad_trials():
    def objective(config):
        for it in range(1, 28):
            tune.report(score=config["q"] * it)

    res = Tuner(
        objective,
        param_space={"q": tune.grid_search(
            [8.0, 9.0, 10.0, 11.0, 0.1, 0.2, 0.3, 0.4])},
        tune_config=TuneConfig(
            metric="score", mode="max",
            scheduler=HyperBandScheduler(metric="score", mode="max",
                                         max_t=27, eta=3, brackets=3),
            max_concurrent_trials=8),
    ).fit()
    iters = {r.config["q"]: (r.metrics or {}).get("training_iteration", 0)
             for r in res}
    assert any(v < 27 for q, v in iters.items() if q < 1.0), iters
    assert max(v for q, v in iters.items() if q > 1.0) >= 27, iters


# -- what the port adds ------------------------------------------------------


def test_a_trainer_in_a_trial_gang_places_its_worker_in_the_gang():
    """A gang trial running ``CudaTrainer(device="cpu")`` on the tiny
    GPT-2: the trainer's worker takes the gang's second bundle (no group
    of the trainer's own is made), and the losses are those of the direct
    trainer run."""
    cfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    direct = measure.measure_trainer_gpt2(cfg, 8, steps=3, device="cpu",
                                          ckpt_every=0)
    before = set(placement_group_table() or {})
    grid = Tuner(
        measure.tune_trainer_gpt2_trial,
        param_space={"lr": 3e-4, "cfg": cfg, "batch": 8, "steps": 3,
                     "device": "cpu"},
        tune_config=TuneConfig(metric="loss", mode="min"),
        resources_per_trial={"bundles": [{"CPU": 1}, {"CPU": 1}],
                             "strategy": "PACK"}).fit()
    assert not grid.errors, grid.errors
    new = {k: v for k, v in (placement_group_table() or {}).items()
           if k not in before}
    assert len(new) == 1  # the trial's gang, and nothing of the trainer's
    assert [v["state"] for v in new.values()] == ["REMOVED"]
    np.testing.assert_array_equal(grid[0].metrics["losses"],
                                  direct["losses"])
    np.testing.assert_allclose(direct["losses"], L.TINY_GPT2_LOSSES,
                               rtol=1e-5)


# -- the slice against the JAX package ---------------------------------------

LRS = [1e-3, 3e-4, 3e-3]
ASHA = dict(max_t=4, grace_period=2, reduction_factor=2)


def _jax_asha(params, tokens):
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    mesh = build_mesh(MeshConfig())
    shardings = jgpt2.gpt2_shardings(jcfg, mesh)
    init = jmake_init_fn(lambda r: jax.tree.map(jnp.asarray, params),
                         shardings, mesh)
    batch = {"tokens": jnp.asarray(tokens)}

    def trial(config):
        step = jmake_train_step(
            lambda p, b: jgpt2.gpt2_loss(p, b, jcfg), shardings, mesh,
            optimizer=JAdamWConfig(lr=config["lr"]))
        state = init(jax.random.key(0))
        for i in range(ASHA["max_t"]):
            state, m = step(state, batch)
            jtune.report(loss=float(m["loss"]), step=i + 1,
                         training_iteration=i + 1)

    ray_tpu.shutdown()
    ray_tpu.init(num_cpus=4)
    try:
        return jtune.Tuner(
            trial, param_space={"lr": jtune.grid_search(LRS)},
            tune_config=jtune.TuneConfig(
                metric="loss", mode="min", max_concurrent_trials=1,
                scheduler=jtune.ASHAScheduler(metric="loss", mode="min",
                                              **ASHA))).fit()
    finally:
        ray_tpu.shutdown()


@pytest.fixture(scope="module")
def asha_runs():
    params, tokens = _numpy_params(), _tokens()
    port = measure.measure_tune_gpt2(
        tgpt2.GPT2Config(**TINY, dtype=torch.float32), 8, lrs=LRS,
        steps=ASHA["max_t"], max_concurrent=1, resources={"CPU": 1},
        params=params, tokens=tokens, grace_period=ASHA["grace_period"],
        reduction_factor=ASHA["reduction_factor"])
    return port, _jax_asha(params, tokens)


def test_asha_over_tiny_gpt2_stops_the_same_trials_as_jax(asha_runs):
    port, jax_ = asha_runs
    assert not port["errors"] and not jax_.errors
    got = {t["lr"]: t["steps"] for t in port["trials"]}
    want = {r.config["lr"]: [m["step"] for m in r.metrics_history]
            for r in jax_}
    assert got == want
    assert any(len(s) < ASHA["max_t"] for s in got.values())  # a stop
    assert port["best"]["lr"] == jax_.get_best_result().config["lr"]
    # The recorded decisions replay exactly on a fresh scheduler.
    assert port["replay"] == port["decisions"]


def test_asha_over_tiny_gpt2_losses_match_jax(asha_runs):
    port, jax_ = asha_runs
    want = {r.config["lr"]: [m["loss"] for m in r.metrics_history]
            for r in jax_}
    for t in port["trials"]:
        np.testing.assert_allclose(t["losses"], want[t["lr"]], rtol=1e-4)
        # A stopped trial starts at most the one step its stop cut short.
        assert len(t["steps"]) <= t["steps_started"] <= len(t["steps"]) + 1
    assert port["steps_started"] == sum(t["steps_started"]
                                        for t in port["trials"])
