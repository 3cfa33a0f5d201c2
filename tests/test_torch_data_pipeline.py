"""ray_tpu_torch's readers and ``DatasetPipeline`` against the JAX
package's, on the CPU: every case of ``tests/test_data_pipeline.py`` on
both packages from the same files -- ``parallelism`` sets the read tasks
(parquet split by row groups, capped by them; text, CSV and JSON lines by
byte ranges, each line read once), and windows execute lazily in order,
repeat for epochs and batch across window edges -- with the same blocks
and rows in both."""

import json

import numpy as np
import pandas as pd
import pytest

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu_torch import data as tdata


@pytest.fixture(scope="module", autouse=True)
def _runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=4)
    ray_tpu_torch.init(num_cpus=4)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


def both(build):
    return build(jdata), build(tdata)


def _py(rows):
    return [{k: (v.item() if isinstance(v, np.generic) else v)
             for k, v in r.items()} if isinstance(r, dict) else r
            for r in rows]


@pytest.mark.parametrize("parallelism,blocks", [(5, 5), (3, 4), (20, 10)])
def test_parquet_single_file_parallelism(tmp_path, parallelism, blocks):
    path = str(tmp_path / "big.parquet")
    df = pd.DataFrame({"x": np.arange(1000), "y": np.arange(1000) * 2.0})
    df.to_parquet(path, row_group_size=100)  # 10 row groups
    j, t = both(lambda d: d.read_parquet(path, parallelism=parallelism))
    assert t.num_blocks == j.num_blocks == blocks
    out = t.take_all()
    assert out == j.take_all()
    assert sorted(r["x"] for r in out) == list(range(1000))


def test_parquet_parallelism_capped_by_row_groups(tmp_path):
    path = str(tmp_path / "small.parquet")
    pd.DataFrame({"x": [1, 2, 3]}).to_parquet(path)  # 1 row group
    j, t = both(lambda d: d.read_parquet(path, parallelism=8))
    assert t.num_blocks == j.num_blocks == 1
    assert t.take_all() == j.take_all() == [{"x": 1}, {"x": 2}, {"x": 3}]


def test_parquet_columns(tmp_path):
    path = str(tmp_path / "c.parquet")
    pd.DataFrame({"x": np.arange(10), "y": np.arange(10) * 1.5}).to_parquet(
        path, row_group_size=4)
    j, t = both(lambda d: d.read_parquet(path, columns=["y"]))
    assert t.take_all() == j.take_all()
    assert list(t.take(1)[0]) == ["y"]


@pytest.mark.parametrize("parallelism", [1, 6, 17])
def test_text_byte_range_split(tmp_path, parallelism):
    path = str(tmp_path / "lines.txt")
    lines = [f"line-{i:04d}" for i in range(500)]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    j, t = both(lambda d: d.read_text(path, parallelism=parallelism))
    assert t.num_blocks == j.num_blocks
    assert parallelism == 1 or t.num_blocks > 1
    assert t.take_all() == j.take_all() == lines  # each line once, in order


def test_csv_byte_range_split(tmp_path):
    path = str(tmp_path / "t.csv")
    df = pd.DataFrame({"a": np.arange(300), "b": np.arange(300) * 3})
    df.to_csv(path, index=False)
    j, t = both(lambda d: d.read_csv(path, parallelism=4))
    assert t.num_blocks == j.num_blocks > 1
    rows = _py(t.take_all())
    assert rows == _py(j.take_all())
    assert sorted(int(r["a"]) for r in rows) == list(range(300))
    assert all(r["b"] == 3 * r["a"] for r in rows)


def test_csv_quoted_newlines_one_task_a_file(tmp_path):
    path = str(tmp_path / "q.csv")
    pd.DataFrame({"a": [1, 2], "s": ["x\ny", "z"]}).to_csv(path, index=False)
    j, t = both(lambda d: d.read_csv(path, quoted_newlines=True))
    assert t.num_blocks == j.num_blocks == 1
    assert _py(t.take_all()) == _py(j.take_all())
    assert [r["s"] for r in t.take_all()] == ["x\ny", "z"]


def test_json_byte_range_split(tmp_path):
    path = str(tmp_path / "t.jsonl")
    with open(path, "w") as f:
        for i in range(120):
            f.write(json.dumps({"i": i}) + "\n")
    j, t = both(lambda d: d.read_json(path, parallelism=3))
    assert t.num_blocks == j.num_blocks >= 2
    assert t.take_all() == j.take_all()
    assert sorted(r["i"] for r in t.take_all()) == list(range(120))


def test_pipeline_windows_and_order():
    j, t = both(lambda d: d.range(100).window(blocks_per_window=2))
    assert t.num_windows == j.num_windows >= 2
    assert list(t.iter_rows()) == list(j.iter_rows()) == list(range(100))


def test_pipeline_lazy_transform_and_repeat():
    j, t = both(lambda d: d.range(60).window(blocks_per_window=3)
                .map(lambda x: x * 2).repeat(2))
    expect = [x * 2 for x in range(60)]
    assert list(t.iter_rows()) == list(j.iter_rows()) == expect + expect
    assert t.count() == j.count() == 120
    assert t.take(5) == j.take(5) == expect[:5]
    assert "map" in t.stats()


def test_pipeline_iter_batches():
    j, t = both(lambda d: d.range(64).window(blocks_per_window=4))
    jb = [list(b) for b in j.iter_batches(batch_size=16)]
    tb = [list(b) for b in t.iter_batches(batch_size=16)]
    assert tb == jb
    assert sum(len(b) for b in tb) == 64


def test_dataset_repeat_and_map_batches_window():
    j, t = both(lambda d: d.from_numpy(np.arange(12.0), parallelism=3)
                .repeat(2).map_batches(lambda b: {"data": b["data"] + 1}))
    jb = [b["data"].tolist() for b in j.iter_batches(batch_size=5)]
    tb = [b["data"].tolist() for b in t.iter_batches(batch_size=5)]
    assert tb == jb
    assert sum(len(b) for b in tb) == 24
