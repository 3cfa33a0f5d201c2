"""ray_tpu_torch's data library against the JAX package's, on the CPU.

Every case of ``tests/test_data.py`` runs here on both packages, each on
its own local runtime, from the same numpy inputs, and the port must give
what the JAX package gives: the same rows in the same order (a seeded
shuffle included), the same blocks, aggregates, splits, preprocessor
statistics and outputs, and the same files read back. Then the parts the
port adds or changes: ``iter_device_batches(device="cpu")`` against JAX's
on its CPU devices (the same batches, counts and ``drop_last``; a
``transfer`` sample a batch; the iterator's wait reaching the port's
session and its step anatomy), the actor-pool cases of
``tests/test_streaming_dataflow.py`` and ``tests/test_util.py``, dynamic
block splitting, and the trainer fed by a Dataset: a tiny GPT-2 through
``CudaTrainer(device="cpu", datasets=...)`` against the JAX package's
``JaxTrainer`` reading the same dataset (losses within rtol 1e-4, each
rank's shard equal at ``num_workers=2``).
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.data import preprocessors as jpre
from ray_tpu_torch import data as tdata
from ray_tpu_torch.data import block as B
from ray_tpu_torch.data import preprocessors as tpre


@pytest.fixture(autouse=True, scope="module")
def _runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8)
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def both(build):
    """``build(data_module)`` on each package: (JAX's, the port's)."""
    return build(jdata), build(tdata)


def _rows(rows):
    """Rows made comparable: numpy scalars and arrays as Python values."""
    def norm(v):
        if isinstance(v, np.ndarray):
            return v.tolist()
        if isinstance(v, np.generic):
            return v.item()
        if isinstance(v, dict):
            return {k: norm(x) for k, x in v.items()}
        if isinstance(v, tuple):
            return tuple(norm(x) for x in v)
        return v
    return [norm(r) for r in rows]


def assert_same_rows(j, t):
    assert _rows(j) == _rows(t)


# -- tests/test_data.py's cases, both packages --------------------------------


def test_range_count_take():
    j, t = both(lambda d: d.range(100, parallelism=4))
    assert t.num_blocks == j.num_blocks == 4
    assert t.count() == j.count() == 100
    assert t.take(5) == j.take(5) == [0, 1, 2, 3, 4]


def test_map_filter_flatmap_fused():
    j, t = both(lambda d: d.range(20, parallelism=4)
                .map(lambda x: x * 2)
                .filter(lambda x: x % 4 == 0)
                .flat_map(lambda x: [x, x + 1]))
    assert_same_rows(j.take_all(), t.take_all())
    assert "map+filter+flat_map" in t.stats()
    assert [s.name for s in t.stats().lineage()] == \
        [s.name for s in j.stats().lineage()]


def test_map_batches_numpy_and_pandas():
    arr = np.arange(16.0)
    j, t = both(lambda d: d.from_numpy(arr).map_batches(
        lambda b: {"data": b["data"] * 2}))
    assert_same_rows(j.take_all(), t.take_all())
    df = pd.DataFrame({"a": [1, 2, 3], "b": [4.0, 5.0, 6.0]})
    j, t = both(lambda d: d.from_pandas(df).map_batches(
        lambda pdf: pdf.assign(c=pdf.a + pdf.b), batch_format="pandas"))
    pd.testing.assert_frame_equal(j.to_pandas(), t.to_pandas())
    assert list(t.to_pandas()["c"]) == [5.0, 7.0, 9.0]


@pytest.mark.parametrize("max_size", [1, 2, 4])
def test_map_batches_with_actor_pool(max_size):
    j, t = both(lambda d: d.range(32, parallelism=4).map_batches(
        lambda b: np.asarray(b) + 1,
        compute=d.ActorPoolStrategy(min_size=1, max_size=max_size)))
    assert_same_rows(j.take_all(), t.take_all())
    assert sorted(_rows(t.take_all())) == list(range(1, 33))


def test_repartition():
    j, t = both(lambda d: d.range(30, parallelism=3).repartition(5))
    assert t.num_blocks == j.num_blocks == 5
    assert_same_rows(j.take_all(), t.take_all())
    counts = [len(ray_tpu_torch.get(r)) for r in t._execute()]
    assert counts == [len(ray_tpu.get(r)) for r in j._execute()] == [6] * 5


@pytest.mark.parametrize("seed,n,blocks", [(42, 50, 5), (0, 37, 3),
                                          (7, 64, 8), (123, 10, 1)])
def test_random_shuffle_same_order_as_jax(seed, n, blocks):
    j, t = both(lambda d: d.range(n, parallelism=blocks)
                .random_shuffle(seed=seed))
    got = t.take_all()
    want = j.take_all()
    if blocks == 1:
        # The JAX package nests a one-block shuffle's rows one level deep
        # (its one row is the block, so its reduce shuffles one row); the
        # port returns the rows, the map's permutation then the reduce's,
        # from the same seeds.
        assert len(want) == 1 and sorted(want[0]) == list(range(n))
        rows = np.random.default_rng(seed).permutation(n).tolist()
        np.random.default_rng(seed * 7919).shuffle(rows)
        want = rows
    assert got == want
    assert sorted(got) == list(range(n))
    again = tdata.range(n, parallelism=blocks).random_shuffle(seed=seed)
    assert again.take_all() == got  # deterministic for a fixed seed


@pytest.mark.parametrize("descending", [False, True])
def test_sort(descending):
    vals = np.random.default_rng(0).permutation(100).tolist()
    j, t = both(lambda d: d.from_items(vals, parallelism=4)
                .sort(descending=descending))
    assert t.take_all() == j.take_all() == sorted(vals, reverse=descending)


def test_sort_of_one_block_returns_its_rows():
    """One block sorts into one part: the port returns its rows, sorted
    (the JAX package's one row is the block, nested one level deep and so
    left unsorted)."""
    vals = [3, 1, 2]
    j, t = both(lambda d: d.from_items(vals, parallelism=1).sort())
    assert t.take_all() == [1, 2, 3]
    assert j.take_all() == [[3, 1, 2]]
    desc = tdata.from_items(vals, parallelism=1).sort(descending=True)
    assert desc.take_all() == [3, 2, 1]


def test_sort_by_key_column():
    items = [{"k": i % 5, "v": i} for i in range(25)]
    j, t = both(lambda d: d.from_items(items, parallelism=3).sort(key="k"))
    assert_same_rows(j.take_all(), t.take_all())


@pytest.mark.parametrize("agg,on", [("count", None), ("sum", "v"),
                                    ("mean", "v"), ("min", "v"),
                                    ("max", "v")])
def test_groupby_aggregates(agg, on):
    items = [{"k": i % 3, "v": float(i)} for i in range(12)]

    def build(d):
        g = d.from_items(items, parallelism=4).groupby("k")
        return getattr(g, agg)() if on is None else getattr(g, agg)(on=on)

    j, t = both(build)
    assert t.take_all() == j.take_all()
    if agg == "count":
        assert {r["key"]: r["value"] for r in t.take_all()} == \
            {0: 4, 1: 4, 2: 4}


@pytest.mark.parametrize("n,blocks,shards", [(10, 3, 2), (64, 8, 3),
                                             (17, 4, 4)])
def test_split_equal(n, blocks, shards):
    j, t = both(lambda d: d.range(n, parallelism=blocks)
                .split(shards, equal=True))
    assert [s.count() for s in t] == [s.count() for s in j] == \
        [n // shards] * shards
    assert [s.take_all() for s in t] == [s.take_all() for s in j]


def test_split_unequal():
    j, t = both(lambda d: d.range(20, parallelism=5).split(2))
    assert [s.take_all() for s in t] == [s.take_all() for s in j]


def test_union_zip_limit():
    def build(d):
        a = d.range(5)
        b = d.range(5).map(lambda x: x + 10)
        return (a.union(b).count(), a.zip(b).take_all(),
                d.range(100).limit(7).count(),
                d.range(7, parallelism=2).zip(d.range(7, parallelism=3))
                .take_all())

    j, t = both(build)
    assert _rows(t) == _rows(j)
    assert t[1][0] == (0, 10)


def test_iter_batches_and_schema():
    j, t = both(lambda d: d.from_numpy(np.arange(32.0)))
    for drop_last in (False, True):
        jb = list(j.iter_batches(batch_size=10, drop_last=drop_last))
        tb = list(t.iter_batches(batch_size=10, drop_last=drop_last))
        assert [b["data"].tolist() for b in tb] == \
            [b["data"].tolist() for b in jb]
    assert t.schema() == j.schema()
    assert "data" in t.schema()


def test_iter_torch_batches():
    j, t = both(lambda d: d.from_numpy(np.arange(20, dtype=np.int32)))
    jb = list(j.iter_torch_batches(batch_size=6,
                                   dtypes={"data": torch.float64}))
    tb = list(t.iter_torch_batches(batch_size=6,
                                   dtypes={"data": torch.float64}))
    assert len(tb) == len(jb) == 4
    for a, b in zip(jb, tb):
        assert b["data"].dtype == torch.float64
        assert torch.equal(a["data"], b["data"])


def test_read_write_roundtrip(tmp_path):
    df = pd.DataFrame({"x": np.arange(20), "y": np.arange(20) * 1.5})
    for pkg, d in (("jax", jdata), ("port", tdata)):
        ds = d.from_pandas(df, parallelism=2)
        ds.write_parquet(str(tmp_path / pkg / "pq"))
        ds.write_csv(str(tmp_path / pkg / "csv"))
    for fmt, reader in (("pq", "read_parquet"), ("csv", "read_csv")):
        j = getattr(jdata, reader)(str(tmp_path / "jax" / fmt))
        t = getattr(tdata, reader)(str(tmp_path / "port" / fmt))
        assert t.count() == j.count() == 20
        pd.testing.assert_frame_equal(t.to_pandas(), j.to_pandas())
    for name in sorted(p.name for p in (tmp_path / "jax" / "pq").iterdir()):
        assert pq.read_table(tmp_path / "port" / "pq" / name).equals(
            pq.read_table(tmp_path / "jax" / "pq" / name))
    assert tdata.read_parquet(str(tmp_path / "port" / "pq")) \
        .to_pandas()["y"].sum() == df["y"].sum()


def test_read_text_json(tmp_path):
    p = tmp_path / "t.txt"
    p.write_text("alpha\nbeta\ngamma\n")
    j, t = both(lambda d: d.read_text(str(p)).take_all())
    assert t == j == ["alpha", "beta", "gamma"]
    f = tmp_path / "d.jsonl"
    f.write_text('{"a": 1}\n{"a": 2}\n')
    j, t = both(lambda d: d.read_json(str(f)).take_all())
    assert t == j == [{"a": 1}, {"a": 2}]
    b = tmp_path / "blob.bin"
    b.write_bytes(b"\x00\x01\x02")
    j, t = both(lambda d: d.read_binary_files(str(b)).take_all())
    assert t == j == [b"\x00\x01\x02"]


def test_preprocessors():
    df = pd.DataFrame(
        {"a": [1.0, 2.0, 3.0, 4.0], "b": [10.0, 20.0, 30.0, 40.0],
         "label": ["x", "y", "x", "z"]})
    out = {}
    for name, d, p in (("jax", jdata, jpre), ("port", tdata, tpre)):
        ds = d.from_pandas(df, parallelism=2)
        scaler = p.StandardScaler(columns=["a"])
        mm = p.MinMaxScaler(columns=["b"]).fit(ds)
        le = p.LabelEncoder("label").fit(ds)
        chain = p.Chain(
            p.BatchMapper(lambda b: {**b, "a2": np.asarray(b["a"]) * 2}),
            p.Concatenator(exclude=["label"], output_column_name="features"))
        out[name] = {
            "scaled": scaler.fit_transform(ds).to_pandas(),
            "scaler_stats": scaler.stats_,
            "minmax": mm.transform(ds).to_pandas(),
            "minmax_stats": mm.stats_,
            "labels": le.transform(ds).to_pandas(),
            "classes": le.classes_,
            "features": np.stack([r["features"] for r in
                                  chain.fit_transform(ds).take_all()]),
            "batch": chain.transform_batch(
                {"a": np.array([1.0]), "b": np.array([2.0]),
                 "label": np.array(["x"])})["features"],
        }
    j, t = out["jax"], out["port"]
    for key in ("scaled", "minmax", "labels"):
        pd.testing.assert_frame_equal(t[key], j[key])
    assert t["scaler_stats"] == j["scaler_stats"]
    assert t["minmax_stats"] == j["minmax_stats"]
    assert t["classes"] == j["classes"] == ["x", "y", "z"]
    np.testing.assert_array_equal(t["features"], j["features"])
    assert t["features"].shape == (4, 3)  # a, a2, b
    np.testing.assert_array_equal(t["batch"], j["batch"])
    assert t["scaled"]["a"].mean() == pytest.approx(0.0, abs=1e-9)
    with pytest.raises(RuntimeError, match="must be fit first"):
        tpre.StandardScaler(columns=["a"]).transform(
            tdata.from_pandas(df))


def test_train_integration_get_dataset_shard():
    from ray_tpu import train as jtrain
    from ray_tpu.train import session as jsession
    from ray_tpu_torch.train import session as tsession
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.trainer import DataParallelTrainer

    def loop_for(session):
        def loop(config):
            vals = session.get_dataset_shard("train").take_all()
            session.report({"rank": session.get_world_rank(),
                            "vals": vals})
        return loop

    jr = jtrain.DataParallelTrainer(
        loop_for(jsession), scaling_config=jtrain.ScalingConfig(
            num_workers=2),
        datasets={"train": jdata.range(16, parallelism=4)}).fit()
    tr = DataParallelTrainer(
        loop_for(tsession), scaling_config=ScalingConfig(num_workers=2),
        datasets={"train": tdata.range(16, parallelism=4)}).fit()
    assert tr.error is None, tr.error
    assert tr.metrics == jr.metrics
    assert len(tr.metrics["vals"]) == 8


def test_arrow_blocks_end_to_end(tmp_path):
    path = str(tmp_path / "t.parquet")
    pq.write_table(
        pa.table({"x": list(range(100)),
                  "y": [float(i) for i in range(100)]}),
        path, row_group_size=25)

    def build(d):
        ds = d.read_parquet(path, parallelism=4)
        out = ds.map_batches(
            lambda t: t.append_column(
                "z", pa.array([v * 2 for v in t["x"].to_pylist()])),
            batch_format="pyarrow")
        small = out.filter(lambda r: r["x"] < 10).sort(key="x",
                                                       descending=True)
        ds2 = d.from_arrow(pa.table({"a": [1, 2, 3]}))
        return ds, out, small, ds2

    (jds, jout, jsmall, jds2), (tds, tout, tsmall, tds2) = both(build)
    assert tds.num_blocks == jds.num_blocks >= 2
    assert isinstance(ray_tpu_torch.get(tds._execute()[0]), pa.Table)
    blk = ray_tpu_torch.get(tout._execute()[0])
    assert isinstance(blk, pa.Table) and "z" in blk.column_names
    assert tout.to_arrow().equals(jout.to_arrow())
    assert tsmall.take_all() == jsmall.take_all()
    assert [r["x"] for r in tsmall.take_all()] == list(range(9, -1, -1))
    jb = list(jds2.iter_batches(batch_size=3, batch_format="numpy"))
    tb = list(tds2.iter_batches(batch_size=3, batch_format="numpy"))
    assert list(tb[0]["a"]) == list(jb[0]["a"]) == [1, 2, 3]


# -- the device feed ----------------------------------------------------------


@pytest.mark.parametrize("n,batch,drop_last", [(64, 16, True), (70, 16, True),
                                               (70, 16, False), (9, 4, False)])
def test_iter_device_batches_match_jax(n, batch, drop_last):
    """The same batches as JAX's ``iter_device_batches`` on its CPU
    devices (values, count, ``drop_last``), as tensors on the CPU; one
    ``transfer`` sample per batch in the port's registry and its
    iteration stats."""
    from ray_tpu_torch.util import metrics

    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    j, t = both(lambda d: d.from_numpy(arr, parallelism=3))
    jb = [np.asarray(b["data"]) for b in j.iter_device_batches(
        batch_size=batch, drop_last=drop_last)]
    before = metrics.parse_prometheus(metrics.prometheus_text())
    tb = list(t.iter_device_batches(batch_size=batch, drop_last=drop_last,
                                    device="cpu"))
    delta = metrics.diff_parsed(
        before, metrics.parse_prometheus(metrics.prometheus_text()))
    assert len(tb) == len(jb)
    for a, b in zip(jb, tb):
        assert isinstance(b["data"], torch.Tensor)
        assert b["data"].device == torch.device("cpu")
        np.testing.assert_array_equal(b["data"].numpy(), a)
    xfer = metrics.histogram_dist(delta, "ray_tpu_data_iter_seconds",
                                  phase="transfer")
    assert xfer["count"] == len(tb)
    it = t.stats().iterations[-1]
    assert it.device and it.batches == len(tb) and it.transfer_s > 0
    assert "transfer" in it.summary_line()


def test_iter_device_batches_dtype_and_array_batches():
    j, t = both(lambda d: d.from_items(list(range(12)), parallelism=2))
    jb = [np.asarray(b) for b in j.iter_device_batches(batch_size=5,
                                                       dtype=np.float32)]
    tb = list(t.iter_device_batches(batch_size=5, dtype=np.float32,
                                    device="cpu"))
    assert [b.dtype for b in tb] == [torch.float32] * 2
    assert [b.tolist() for b in tb] == [a.tolist() for a in jb]


@ray_tpu_torch.remote
def _slow_block(i):
    time.sleep(0.3)
    return {"data": np.full((4, 2), i, dtype=np.int64)}


def test_iter_device_batches_wait_reaches_the_session_anatomy():
    """A consumer starved by a block still being produced: the wait
    lands in ``ray_tpu_data_iter_seconds`` and in the session's
    ``data_wait`` (its report's phases and the step anatomy gauge)."""
    from ray_tpu_torch.data.dataset import _SESSION_MODULE, Dataset
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.trainer import CudaTrainer
    from ray_tpu_torch.util import metrics

    assert session.__name__ == _SESSION_MODULE

    def loop(config):
        ds = Dataset([_slow_block.remote(i) for i in range(2)])
        seen = []
        for b in ds.iter_device_batches(batch_size=4,
                                        device=session.get_device()):
            session.timed_step(lambda x: x * 2, b["data"])
            seen.append(int(b["data"][0, 0]))
            session.report({"seen": list(seen)})
            tags = {"node_id": "local", "trial": "train", "rank": "0"}
            session.report({"data_wait": metrics.TRAIN_STEP_ANATOMY_SECONDS
                            .get({**tags, "phase": "data_wait"})})

    before = metrics.parse_prometheus(metrics.prometheus_text())
    result = CudaTrainer(loop, device="cpu").fit()
    assert result.error is None, result.error
    delta = metrics.diff_parsed(
        before, metrics.parse_prometheus(metrics.prometheus_text()))
    waits = [m["data_wait"] for m in result.metrics_history
             if "data_wait" in m]
    assert [m["seen"] for m in result.metrics_history if "seen" in m] == \
        [[0], [0, 1]]
    assert waits[0] >= 0.2  # the first block took 0.3 s to produce
    phase = metrics.histogram_dist(delta, "ray_tpu_train_step_phase_seconds",
                                   trial="train", phase="data_wait")
    assert phase is not None and phase["sum"] >= 0.2
    it_wait = metrics.histogram_dist(delta, "ray_tpu_data_iter_seconds",
                                     phase="wait")
    assert it_wait["sum"] >= 0.2


# -- actor pools (tests/test_streaming_dataflow.py, tests/test_util.py) -------


@ray_tpu_torch.remote
class _Doubler:
    def double(self, x):
        return 2 * x


@ray_tpu.remote
class _JDoubler:
    def double(self, x):
        return 2 * x


def _pools(n):
    from ray_tpu.util.actor_pool import ActorPool as JPool
    from ray_tpu_torch.util.actor_pool import ActorPool as TPool

    return (JPool([_JDoubler.remote() for _ in range(n)]),
            TPool([_Doubler.remote() for _ in range(n)]))


def test_actor_pool_map_ordered_and_unordered():
    jp, tp = _pools(3)
    f = (lambda a, v: a.double.remote(v))
    assert list(tp.map(f, range(10))) == list(jp.map(f, range(10))) == \
        [2 * i for i in range(10)]
    jp, tp = _pools(3)
    assert sorted(tp.map_unordered(f, range(10))) == \
        sorted(jp.map_unordered(f, range(10)))


def test_actor_pool_submit_get_next_push_pop():
    from ray_tpu_torch.util.actor_pool import ActorPool

    pool = ActorPool([_Doubler.remote()])
    pool.submit(lambda a, v: a.double.remote(v), 1)
    pool.submit(lambda a, v: a.double.remote(v), 2)
    assert pool.get_next() == 2
    assert pool.get_next() == 4
    assert not pool.has_next()
    with pytest.raises(StopIteration):
        pool.get_next()
    a = pool.pop_idle()
    assert a is not None and pool.pop_idle() is None
    pool.push(a)
    assert pool.has_free()
    empty = ActorPool([])
    empty.submit(lambda a, v: a.double.remote(v), 1)
    with pytest.raises(RuntimeError, match="no actors"):
        empty.get_next()


def test_autoscaling_pool_grows_and_shrinks():
    from ray_tpu.util.actor_pool import AutoscalingActorPool as JPool
    from ray_tpu_torch.util import metrics
    from ray_tpu_torch.util.actor_pool import AutoscalingActorPool as TPool

    @ray_tpu_torch.remote
    class Worker:
        def work(self, x):
            time.sleep(0.02)
            return x * 2

    @ray_tpu.remote
    class JWorker:
        def work(self, x):
            time.sleep(0.02)
            return x * 2

    out = {}
    for name, cls, W, api in (("jax", JPool, JWorker, ray_tpu),
                              ("port", TPool, Worker, ray_tpu_torch)):
        pool = cls(W.remote, min_size=1, max_size=3,
                   scale_up_queue_depth=1, name="t-pool")
        assert pool.size == 1
        for i in range(8):
            pool.submit(lambda a, v: a.work.remote(v), i)
        got = []
        while pool.has_next():
            got.append(api.get(pool.get_next_ref()))
        out[name] = (got, pool.peak_size, list(pool.scale_events))
        pool.shutdown()
        assert pool.size == 0
    assert out["port"] == out["jax"]
    got, peak, events = out["port"]
    assert got == [i * 2 for i in range(8)] and peak == 3
    downs = [s for d, s in events if d == "down"]
    assert downs and downs[-1] == 1
    assert metrics.DATA_POOL_SIZE.get(
        {"node_id": "local", "pool": "t-pool"}) == 0.0


def test_map_batches_pool_stats_expose_scaling():
    j, t = both(lambda d: d.range(64, parallelism=16).map_batches(
        lambda b: np.asarray(b) + 1,
        compute=d.ActorPoolStrategy(min_size=1, max_size=4,
                                    scale_up_queue_depth=1)))
    assert_same_rows(j.take_all(), t.take_all())
    tstage = next(s for s in t.stats().lineage()
                  if s.name == "map_batches(actors)")
    jstage = next(s for s in j.stats().lineage()
                  if s.name == "map_batches(actors)")
    assert tstage.extra == jstage.extra
    assert tstage.extra["pool_peak"] > 1
    assert tstage.extra["pool_scale_ups"] >= 1
    assert tstage.extra["pool_scale_downs"] >= 1
    assert tstage.rows_total == jstage.rows_total == 64
    assert "pool_peak" in t.stats().summary()


def test_pool_scale_failpoint_vetoes_but_completes():
    from ray_tpu_torch.util import failpoints

    failpoints.arm("data.pool.before_scale", "raise")
    try:
        ds = tdata.range(32, parallelism=8).map_batches(
            lambda b: np.asarray(b) * 3,
            compute=tdata.ActorPoolStrategy(min_size=1, max_size=4,
                                            scale_up_queue_depth=1))
        assert sorted(_rows(ds.take_all())) == [i * 3 for i in range(32)]
        stage = next(s for s in ds.stats().lineage()
                     if s.name == "map_batches(actors)")
        assert stage.extra["pool_peak"] == 1
        assert stage.extra["pool_scale_ups"] == 0
    finally:
        failpoints.reset()


class _AddOffset:
    """A callable class for the pool: each actor builds one."""

    builds = 0

    def __init__(self, offset):
        type(self).builds += 1
        self.offset = offset

    def __call__(self, batch):
        return {"data": batch["data"] + self.offset}


def test_map_batches_callable_class_builds_once_per_actor():
    _AddOffset.builds = 0
    ds = tdata.from_numpy(np.arange(40), parallelism=8).map_batches(
        _AddOffset, batch_size=3, fn_constructor_args=(100,),
        compute=tdata.ActorPoolStrategy(min_size=2, max_size=2))
    assert [r["data"] for r in _rows(ds.take_all())] == list(range(100, 140))
    assert _AddOffset.builds == 2
    with pytest.raises(ValueError, match="actor pool"):
        tdata.range(4).map_batches(_AddOffset)


# -- dynamic block splitting --------------------------------------------------


def test_split_block_matches_jax():
    from ray_tpu.data import block as JB

    cases = [({"x": np.zeros((1024, 8), np.float32)}, 8 << 10),
             ({"x": np.zeros((1000, 8), np.float32)}, 7000),
             (list(range(1000)), 3000), ({"x": np.zeros((5, 8))}, 1),
             ({"x": np.zeros((1, 65536), np.float32)}, 1024)]
    for blk, target in cases:
        j, t = JB.split_block(blk, target), B.split_block(blk, target)
        assert [B.num_rows(p) for p in t] == [JB.num_rows(p) for p in j]
        assert _rows(list(B.rows_of(B.concat_blocks(t)))) == \
            _rows(list(B.rows_of(blk)))


def test_dynamic_split_matches_jax():
    from ray_tpu.core.config import config as jconfig
    from ray_tpu_torch.core.config import config as tconfig

    jconfig.override("target_block_size_bytes", 64 << 10)
    tconfig.override("target_block_size_bytes", 64 << 10)
    try:
        j, t = both(lambda d: d.from_numpy(np.arange(65536.0), parallelism=4)
                    .map_batches(lambda b: {"data": b["data"] * 2}))
        assert t.count() == j.count() == 65536
        assert t.num_blocks == j.num_blocks > 4
        assert t._block_rows == j._block_rows
        assert [s.extra for s in t.stats().lineage()] == \
            [s.extra for s in j.stats().lineage()]
        assert [b["data"].tolist() for b in t.iter_batches(batch_size=5000)] \
            == [b["data"].tolist() for b in j.iter_batches(batch_size=5000)]
    finally:
        jconfig.reset("target_block_size_bytes")
        tconfig.reset("target_block_size_bytes")


def test_data_stats_rollup():
    from ray_tpu_torch.util import goodput, metrics

    before = metrics.parse_prometheus(metrics.prometheus_text())
    ds = tdata.from_numpy(np.arange(64.0), parallelism=4).map_batches(
        lambda b: b)
    for _ in ds.iter_batches(batch_size=8):
        time.sleep(0.002)
    delta = metrics.diff_parsed(
        before, metrics.parse_prometheus(metrics.prometheus_text()))
    stats = goodput.data_stats(delta)
    assert stats["stages"]["map_batches"]["blocks"] == 4
    assert stats["stages"]["map_batches"]["rows_total"] == 64
    assert stats["iterator"]["wait"]["count"] == 8
    assert stats["iterator"]["user"]["count"] == 8
    assert 0.0 <= stats["stall_fraction"] < 0.5
    assert goodput.stall_fraction_from({}) is None


# -- the trainer fed by a Dataset, against the JAX package's ------------------

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64,
            remat="dots", ce_vocab_chunks=4, fused_norm=True,
            scan_layers=False)
N_STEPS = 3
ROWS = 4  # a rank's batch


def _gpt2_inputs():
    from ray_tpu.models import gpt2 as jgpt2

    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.gpt2_init(jax.random.key(0),
                                                      jcfg))
    tokens = np.random.default_rng(3).integers(
        0, 256, (2 * N_STEPS * ROWS, 65)).astype(np.int64)
    return params, tokens


def _jax_loop(config):
    from ray_tpu.models import gpt2 as jgpt2
    from ray_tpu.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu.train import session as jsession
    from ray_tpu.train.train_step import make_init_fn, make_train_step

    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    mesh = build_mesh(MeshConfig(devices=jax.devices()[:1]))
    shardings = jgpt2.gpt2_shardings(jcfg, mesh)
    state = make_init_fn(lambda r: jax.tree.map(jnp.asarray,
                                                config["params"]),
                         shardings, mesh)(jax.random.key(0))
    step = make_train_step(lambda p, b: jgpt2.gpt2_loss(p, b, jcfg),
                           shardings, mesh)
    shard = jsession.get_dataset_shard("train")
    for batch in shard.iter_device_batches(batch_size=ROWS):
        state, m = step(state, {"tokens": batch["tokens"]})
        jsession.report({"loss": float(m["loss"]),
                         "rank": jsession.get_world_rank(),
                         "tokens": np.asarray(batch["tokens"]).tolist()})


def _port_loop(config):
    from ray_tpu_torch.models import gpt2 as tgpt2
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    cfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    dev = session.get_device()
    state = make_init_fn(lambda g: params_from_numpy(config["params"], dev))(
        torch.Generator())
    step = make_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, cfg))
    shard = session.get_dataset_shard("train")
    for batch in shard.iter_device_batches(batch_size=ROWS, device=dev):
        state, m = step(state, batch)
        session.report({"loss": float(m["loss"]),
                        "rank": session.get_world_rank(),
                        "tokens": batch["tokens"].tolist()})


def _by_rank(result):
    out: dict = {}
    for m in result.metrics_history:
        out.setdefault(m["rank"], []).append(m)
    return out


@pytest.mark.parametrize("workers", [1, 2])
def test_cuda_trainer_on_a_dataset_matches_jax_trainer(workers):
    """A tiny GPT-2 (fp32) through ``CudaTrainer(device="cpu",
    datasets=...)`` and the JAX package's ``JaxTrainer`` on the same
    dataset (``map_batches`` renaming the column, then ``split(equal=
    True)`` by the trainers): each rank sees the same batches in both,
    and rank 0's losses agree within rtol 1e-4. (The local backend's
    ranks are threads: at 2 workers each trains its own copy on its
    shard, and rank 0's reports are the ``metrics_history``.)"""
    from ray_tpu import train as jtrain
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.trainer import CudaTrainer

    params, tokens = _gpt2_inputs()
    n = workers * N_STEPS * ROWS

    def ds_for(d):
        return d.from_numpy(tokens[:n], parallelism=3).map_batches(
            lambda b: {"tokens": b["data"]})

    jres = jtrain.JaxTrainer(
        _jax_loop, train_loop_config={"params": params},
        scaling_config=jtrain.ScalingConfig(num_workers=workers),
        datasets={"train": ds_for(jdata)}).fit()
    tres = CudaTrainer(
        _port_loop, train_loop_config={"params": params},
        scaling_config=ScalingConfig(num_workers=workers),
        datasets={"train": ds_for(tdata)}, device="cpu").fit()
    assert jres.error is None, jres.error
    assert tres.error is None, tres.error
    jl = [m["loss"] for m in jres.metrics_history]
    tl = [m["loss"] for m in tres.metrics_history]
    assert len(tl) == len(jl) == N_STEPS
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    # Each rank's shard: rank 0's batches from the history, every rank's
    # from a direct split (what the trainer hands rank r).
    assert [m["tokens"] for m in tres.metrics_history] == \
        [m["tokens"] for m in jres.metrics_history]
    jsh = ds_for(jdata).split(workers, equal=True)
    tsh = ds_for(tdata).split(workers, equal=True)
    for js, ts in zip(jsh, tsh):
        jb = [np.asarray(b["tokens"]) for b in js.iter_device_batches(
            batch_size=ROWS)]
        tb = [b["tokens"].numpy() for b in ts.iter_device_batches(
            batch_size=ROWS, device="cpu")]
        assert len(tb) == len(jb) == N_STEPS
        for a, b in zip(jb, tb):
            np.testing.assert_array_equal(a, b)


def test_shard_dataset_splits_a_dataset_equally():
    """``trainer._shard_dataset``: a Dataset goes through
    ``split(equal=True)`` (rows balanced, the remainder dropped), as in
    the JAX package; arrays and lists are striped."""
    from ray_tpu.train.trainer import _shard_dataset as jshard
    from ray_tpu_torch.train.trainer import _shard_dataset as tshard

    j, t = jshard(jdata.range(11, parallelism=3), 3), \
        tshard(tdata.range(11, parallelism=3), 3)
    assert [s.take_all() for s in t] == [s.take_all() for s in j] == \
        [[0, 1, 2], [3, 4, 5], [6, 7, 8]]
    assert tshard(list(range(6)), 2) == jshard(list(range(6)), 2) == \
        [[0, 2, 4], [1, 3, 5]]
    assert tshard(None, 2) == [None, None]


# -- usage stats (tests/test_util_extras.py's case, both packages) -------------


def test_usage_report_is_written_only_under_the_ports_env(monkeypatch,
                                                          tmp_path):
    """The report the port writes carries the JAX package's keys (but its
    ``version``), and the
    port's switch is its own ``RAY_TPU_TORCH_`` one: the JAX package's
    env name leaves the port's report off, and the reverse."""
    import json

    from ray_tpu._private import usage as jusage
    from ray_tpu_torch._private import usage as tusage

    monkeypatch.setattr(jusage, "_report_path",
                        lambda: str(tmp_path / "jax.jsonl"))
    monkeypatch.setattr(tusage, "_report_path",
                        lambda: str(tmp_path / "torch.jsonl"))
    monkeypatch.setenv("RAY_TPU_USAGE_STATS_ENABLED", "1")
    monkeypatch.delenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", raising=False)
    assert tusage.write_report() is None
    assert not (tmp_path / "torch.jsonl").exists()

    monkeypatch.setenv("RAY_TPU_USAGE_STATS_ENABLED", "0")
    monkeypatch.setenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1")
    assert jusage.write_report() is None
    for u in (jusage, tusage):
        u.record_extra_usage_tag("test", "yes")
    path = tusage.write_report()
    assert path == str(tmp_path / "torch.jsonl")
    rec = json.loads(open(path).read().splitlines()[-1])
    assert "data" in rec["library_usages"]  # recorded by the import
    assert rec["extra_usage_tags"]["test"] == "yes"
    assert rec["total_num_nodes"] >= 1
    assert rec["source"] == "ray_tpu_torch"
    # The port has no version string of its own.
    assert set(rec) == set(jusage.generate_report()) - {"version"}

    monkeypatch.setenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "0")
    assert tusage.write_report() is None
    assert len(open(path).read().splitlines()) == 1
