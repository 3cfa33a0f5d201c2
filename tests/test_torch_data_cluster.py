"""The data library on the port's cluster backend, on the CPU: a plan of
importable functions gives on a ``Cluster`` (its tasks and pool actors in
worker processes) what it gives on the local backend, and a lambda fails
at submit with the port's ``PicklingError``; ``iter_device_batches`` with
a ``NamedSharding`` over 2 gloo ranks (``CudaTrainer`` worker processes)
gives each rank JAX's shard at the same mesh coordinate, as a DTensor of
the global shape; and ``CudaTrainer(datasets=...)`` over two gloo worker
processes trains each rank on its shard as the local backend does
(losses and tokens equal). The functions live in
``tests/torch_data_loops.py`` (they reach the workers by reference)."""

import pickle

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding as JNamedSharding
from jax.sharding import PartitionSpec as P

import ray_tpu_torch
import torch_data_loops as L
from ray_tpu import data as jdata
from ray_tpu.parallel.mesh import MeshConfig as JMeshConfig
from ray_tpu.parallel.mesh import build_mesh as jbuild_mesh
from ray_tpu_torch import data as tdata
from ray_tpu_torch.cluster import Cluster
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.train.trainer import CudaTrainer


def _plan(d):
    """Every kind of stage, on importable functions."""
    base = d.range(40, parallelism=4)
    rows = base.map(L.plus_one).filter(L.is_even).flat_map(L.twice)
    arr = d.from_numpy(np.arange(24.0), parallelism=3).map_batches(
        L.with_square, batch_size=5)
    return {
        "rows": rows.take_all(),
        "shuffle": base.random_shuffle(seed=5).take_all(),
        "sort": base.map(L.plus_one).sort(key=L.key_mod3).take_all(),
        "groupby": base.groupby(L.key_mod3).sum().take_all(),
        "split": [s.take_all() for s in base.split(3, equal=True)],
        "repartition": base.repartition(3).take_all(),
        "zip": base.zip(base.map(L.plus_one)).take_all(),
        "batches": [b["sq"].tolist() for b in arr.iter_batches(batch_size=7)],
        "pool": [r["data"].item() for r in arr.map_batches(
            L.AddOffset, fn_constructor_args=(100,), batch_size=4,
            compute=d.ActorPoolStrategy(min_size=1, max_size=2)).take_all()],
    }


@pytest.fixture(scope="module")
def local_results():
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(num_cpus=4)
    try:
        params, tokens = _gpt2_inputs()
        ds = _tokens_ds(tokens)
        per_rank = [CudaTrainer(
            L.gpt2_ingest_loop,
            train_loop_config={"params": params, "rows": ROWS},
            datasets={"train": shard}, device="cpu").fit()
            for shard in ds.split(2, equal=True)]
        yield {"plan": _plan(tdata),
               "ingest": [r.metrics["ranks"][0] for r in per_rank]}
    finally:
        ray_tpu_torch.shutdown()


@pytest.fixture(scope="module")
def cluster(local_results):
    ray_tpu_torch.shutdown()
    c = Cluster()
    c.add_node(num_cpus=4, num_gpus=0)
    c.wait_for_nodes()
    ray_tpu_torch.init(address=c.address)
    yield c
    ray_tpu_torch.shutdown()
    c.shutdown()


def test_plan_on_the_cluster_matches_local(cluster, local_results):
    assert _plan(tdata) == local_results["plan"]


def test_a_lambda_fails_at_submit_on_the_cluster(cluster):
    with pytest.raises(pickle.PicklingError, match="lambda"):
        tdata.range(8).map(lambda x: x + 1).take_all()


SPECS = {"rows": ("dp", None), "cols": (None, "dp")}
BATCH = 4


def test_named_sharding_over_two_ranks_matches_jax_shards(cluster):
    arr = np.arange(12 * 6, dtype=np.float32).reshape(12, 6)
    res = CudaTrainer(
        L.sharded_batches_loop,
        train_loop_config={"ds": tdata.from_numpy(arr, parallelism=2),
                           "specs": SPECS, "batch": BATCH},
        scaling_config=ScalingConfig(num_workers=2), device="cpu").fit()
    assert res.error is None, res.error
    ranks = res.metrics["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]

    mesh = jbuild_mesh(JMeshConfig(dp=2, devices=jax.devices()[:2]))
    dp = mesh.axis_names.index("dp")
    for name, spec in SPECS.items():
        sharding = JNamedSharding(mesh, P(*spec))
        jbatches = list(jdata.from_numpy(arr, parallelism=2)
                        .iter_device_batches(batch_size=BATCH,
                                             sharding=sharding))
        assert len(jbatches) == 3
        for r in ranks:
            pieces = r["pieces"][name]
            assert len(pieces) == len(jbatches)
            for (shape, local), jb in zip(pieces, jbatches):
                assert shape == list(jb["data"].shape)
                # JAX's shard on the device at this rank's dp coordinate.
                shard = next(
                    s for s in jb["data"].addressable_shards
                    if np.argwhere(mesh.devices == s.device)[0][dp]
                    == r["coord"][dp])
                np.testing.assert_array_equal(np.asarray(local),
                                              np.asarray(shard.data))


def test_cuda_trainer_datasets_over_two_processes_match_local(
        cluster, local_results):
    params, tokens = _gpt2_inputs()
    res = CudaTrainer(
        L.gpt2_ingest_loop,
        train_loop_config={"params": params, "rows": ROWS},
        scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": _tokens_ds(tokens)}, device="cpu").fit()
    assert res.error is None, res.error
    ranks = res.metrics["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for got, want in zip(ranks, local_results["ingest"]):
        assert got["tokens"] == want["tokens"]
        assert len(got["losses"]) == N_STEPS
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-6)
    assert ranks[0]["tokens"] != ranks[1]["tokens"]


N_STEPS, ROWS = 2, 4


def _gpt2_inputs():
    import torch

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.models.convert import params_to_numpy

    cfg = gpt2.GPT2Config(**L.TINY, dtype=torch.float32)
    params = params_to_numpy(gpt2.gpt2_init(torch.Generator().manual_seed(0),
                                            cfg, device="cpu"))
    tokens = np.random.default_rng(4).integers(
        0, 256, (2 * N_STEPS * ROWS, 65)).astype(np.int64)
    return params, tokens


def _tokens_ds(tokens):
    from ray_tpu_torch.scripts.measure import as_tokens

    return tdata.from_numpy(tokens, parallelism=3).map_batches(as_tokens)
