"""ray_tpu_torch.tune on the cluster backend: one module-scoped ``Cluster``
of one 3-CPU node (the port's counterpart of ``tests/test_tune_pg.py``).

- Gang trials (one placement group a trial) serialize without deadlock,
  and their groups are released after. Their trainable is a
  ``with_resources`` object asking for the gang, which reaches its worker
  by reference.
- Tune x Train with gangs, the CPU form of ``chip_smoke.py`` phase 18c:
  a trial of ``measure.tune_trainer_gpt2_trial`` on the tiny GPT-2,
  a ``CudaTrainer(device="cpu")`` whose worker process lands in the
  trial's gang gives the losses of the same steps run directly
  (``torch_tune_loops.TINY_GPT2_LOSSES``, which
  ``tests/test_torch_tune_runner.py`` holds the direct run to), and no
  group is left.
- A trainable in a closure fails at ``fit`` with the ``PicklingError``
  naming it (functions travel by reference, ROADMAP D33).

The trainables are in ``tests/torch_tune_loops.py``: the reference's
tests pickle theirs by value with cloudpickle, the port imports them.
"""

import os
import pickle
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch
import torch_tune_loops as L
from ray_tpu_torch import tune
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.scripts import measure
from ray_tpu_torch.tune import Tuner
from ray_tpu_torch.util.placement_group import placement_group_table

# tests/test_torch_trainer.py's tiny GPT-2 (this file imports no JAX).
TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64,
            remat="dots", ce_vocab_chunks=4, fused_norm=True,
            scan_layers=False)


@pytest.fixture(scope="module")
def cluster():
    ray_tpu_torch.shutdown()
    # One intra-op thread a worker process: the tiny GPT-2's ops are too
    # small to split, and split over every core they wait on each other
    # when the other processes of a parallel test run hold the cores.
    saved = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS",
                                            "MKL_NUM_THREADS")}
    os.environ.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    c = Cluster()
    try:
        c.add_node(num_cpus=3, num_gpus=0)
        c.wait_for_nodes()
        ray_tpu_torch.init(address=c.address)
        yield c
    finally:
        ray_tpu_torch.shutdown()
        c.shutdown()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _live_pgs():
    return [k for k, v in (placement_group_table() or {}).items()
            if v.get("state") in ("CREATED", "PENDING")]


def _settled(cpus: float, timeout: float = 15.0) -> bool:
    """Wait until the head lists no live group and ``cpus`` free CPUs
    (the trials' actors are killed as ``fit`` returns; their node gives
    the CPUs back a moment later)."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if not _live_pgs() and \
                ray_tpu_torch.available_resources().get("CPU") == cpus:
            return True
        time.sleep(0.05)
    return False


@pytest.fixture(scope="module")
def gang_grid(cluster):
    """Two trials of ``L.score_in_a_gang``: each needs bundles
    [{CPU: 2}, {CPU: 1}] on the 3-CPU node."""
    return Tuner(L.score_in_a_gang,
                 param_space={"x": tune.grid_search([1, 2])}).fit()


def test_gang_trials_serialize_without_deadlock(gang_grid):
    """With a group a trial, the two run one after the other, and both
    finish."""
    assert not gang_grid.errors, gang_grid.errors
    assert sorted(r.metrics["score"] for r in gang_grid) == [10, 20]
    first, second = sorted((r.metrics for r in gang_grid),
                           key=lambda m: m["start"])
    assert first["end"] <= second["start"]


def test_gang_groups_are_released_after_their_trials(gang_grid):
    assert _settled(3.0), (_live_pgs(), ray_tpu_torch.available_resources())


def test_with_resources_trainable_reaches_a_worker_by_reference(gang_grid):
    assert not gang_grid.errors, gang_grid.errors
    assert sorted(r.metrics["score"] for r in gang_grid) == [10, 20]
    assert all(r.metrics["pid"] != os.getpid() for r in gang_grid)


def test_a_trainable_in_a_closure_fails_at_fit_naming_it(cluster):
    def local_trainable(config):
        tune.report(score=1)

    with pytest.raises(pickle.PicklingError, match="local_trainable"):
        Tuner(tune.with_resources(local_trainable, {"CPU": 1}),
              param_space={"x": tune.grid_search([1])}).fit()
    assert not _live_pgs()


def test_tune_over_trainer_gangs_on_the_cluster(cluster):
    """Phase 18c on the CPU: the trial's trainer puts its worker in the
    trial's gang ([{CPU: 1}, {CPU: 1}]), in a process of its own; the
    trial gives the losses of the same three steps run directly, and no
    group is left once ``fit`` returns."""
    cfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    before = set(placement_group_table() or {})
    out = measure.measure_tune_trainer_gpt2(
        cfg, 8, cluster.address, lrs=[3e-4], steps=3, device="cpu")
    ray_tpu_torch.init(address=cluster.address)
    (trial,) = out["trials"]
    assert trial["error"] is None
    np.testing.assert_allclose(trial["losses"], L.TINY_GPT2_LOSSES,
                               rtol=1e-5)
    assert trial["worker_pid"] != trial["pid"]
    assert out["live_pgs"] == []
    new = {k: v for k, v in (placement_group_table() or {}).items()
           if k not in before}
    # The trial's gang, and no group of the trainer's own.
    assert [v["state"] for v in new.values()] == ["REMOVED"]
    assert _settled(3.0)
