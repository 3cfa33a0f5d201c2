"""ray_tpu_torch's batch inference against the JAX package's, on the CPU:
``tests/test_batch_predictor.py``'s two cases on both packages (a
``Predictor`` subclass through ``BatchPredictor``, and the framework
predictor -- ``CudaPredictor(device="cpu")`` beside ``JaxPredictor`` --
from a checkpoint's ``params``), then GPT-2 scoring: a tiny GPT-2 (fp32,
JAX's initial weights carried over as numpy, ``models/convert.py`` on the
port's side) scored through ``BatchPredictor`` with ``gpt2_score`` and
with a JAX counterpart of it through ``JaxPredictor``: each id's NLL
within rtol 1e-5; ``measure_batch_predict_gpt2(device="cpu")`` returning
every id once and the NLL of a direct ``gpt2_score`` call bit for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
import ray_tpu_torch
from ray_tpu import data as jdata
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.train.batch_predictor import BatchPredictor as JBatchPredictor
from ray_tpu.train.batch_predictor import JaxPredictor
from ray_tpu.train.batch_predictor import Predictor as JPredictor
from ray_tpu.train.checkpoint import Checkpoint as JCheckpoint
from ray_tpu_torch import data as tdata
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.scripts.measure import (gpt2_score,
                                           measure_batch_predict_gpt2)
from ray_tpu_torch.train.batch_predictor import BatchPredictor, CudaPredictor
from ray_tpu_torch.train.batch_predictor import Predictor
from ray_tpu_torch.train.checkpoint import Checkpoint


@pytest.fixture(autouse=True, scope="module")
def _runtimes():
    ray_tpu.shutdown()
    ray_tpu_torch.shutdown()
    ray_tpu.init(num_cpus=8)
    ray_tpu_torch.init(num_cpus=8)
    yield
    ray_tpu_torch.shutdown()
    ray_tpu.shutdown()


class CountingPredictor(Predictor):
    """Scales inputs; counts constructions (one per scoring actor)."""

    builds = 0

    def __init__(self, scale):
        type(self).builds += 1
        self.scale = scale

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs):
        return cls(checkpoint.to_dict()["scale"])

    def predict(self, batch):
        return {"out": batch["x"] * self.scale}


class JCountingPredictor(JPredictor):
    def __init__(self, scale):
        self.scale = scale

    @classmethod
    def from_checkpoint(cls, checkpoint, **kwargs):
        return cls(checkpoint.to_dict()["scale"])

    def predict(self, batch):
        return {"out": batch["x"] * self.scale}


@pytest.mark.parametrize("workers", [1, 2])
def test_batch_predictor_scores_dataset(workers):
    arr = np.arange(64, dtype=np.float32).reshape(64, 1)
    CountingPredictor.builds = 0
    out = {}
    for name, d, bp_cls, ckpt_cls, pred in (
            ("jax", jdata, JBatchPredictor, JCheckpoint, JCountingPredictor),
            ("port", tdata, BatchPredictor, Checkpoint, CountingPredictor)):
        bp = bp_cls.from_checkpoint(ckpt_cls.from_dict({"scale": 3.0}), pred)
        ds = d.from_numpy(arr).map_batches(lambda b: {"x": b["data"]})
        res = bp.predict(ds, batch_size=8, max_scoring_workers=workers)
        out[name] = np.concatenate([r["out"] for r in res.take_all()],
                                   axis=None)
    np.testing.assert_array_equal(out["port"], out["jax"])
    np.testing.assert_allclose(np.sort(out["port"]),
                               3.0 * np.arange(64, dtype=np.float32))
    # One predictor a scoring actor (the pool starts at one and may grow
    # to ``workers``), never one a batch.
    assert 1 <= CountingPredictor.builds <= workers


def test_framework_predictor_from_checkpoint():
    w = np.array([[2.0], [1.0]], np.float32)
    items = [{"x": np.array([float(i), 1.0], np.float32)} for i in range(10)]
    jbp = JBatchPredictor.from_checkpoint(
        JCheckpoint.from_dict({"params": {"w": w}}), JaxPredictor,
        apply_fn=lambda params, batch: batch["x"] @ jnp.asarray(
            params["w"]))
    tbp = BatchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": {"w": w}}), CudaPredictor,
        apply_fn=lambda params, batch: batch["x"] @ params["w"],
        device="cpu")
    jvals = sorted(float(np.ravel(r["predictions"])[0]) for r in
                   jbp.predict(jdata.from_items(items), batch_size=5)
                   .take_all())
    tvals = sorted(float(np.ravel(r["predictions"])[0]) for r in
                   tbp.predict(tdata.from_items(items), batch_size=5)
                   .take_all())
    assert tvals == jvals == [2.0 * i + 1.0 for i in range(10)]


def test_cuda_predictor_returns_numpy_and_upcasts_bf16():
    p = CudaPredictor(lambda params, b: {"y": (b * params["s"]).to(
        torch.bfloat16), "n": b.sum()}, {"s": np.float32(2.0)}, device="cpu")
    out = p.predict(np.arange(4, dtype=np.float32))
    assert isinstance(out["y"], np.ndarray) and out["y"].dtype == np.float32
    np.testing.assert_array_equal(out["y"], [0.0, 2.0, 4.0, 6.0])
    assert float(out["n"]) == 6.0
    with pytest.raises(ValueError, match="apply_fn"):
        CudaPredictor.from_checkpoint(Checkpoint.from_dict({"params": {}}))
    with pytest.raises(ValueError, match="params"):
        CudaPredictor.from_checkpoint(Checkpoint.from_dict({"w": 1}),
                                      apply_fn=gpt2_score, device="cpu")


TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=64, seq_len=64)
ROWS, BATCH = 32, 4  # the harness's 8 blocks: 4 rows, one batch, each


def _jax_score(cfg, params, batch):
    tokens = batch["tokens"].astype(jnp.int32)
    logits = jgpt2.gpt2_forward(params, tokens[:, :-1], cfg)
    logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
    picked = jnp.take_along_axis(logp, tokens[:, 1:, None], axis=-1)[..., 0]
    return {"id": batch["id"], "nll": -picked.mean(-1)}


@pytest.fixture(scope="module")
def gpt2_inputs():
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.gpt2_init(jax.random.key(0),
                                                      jcfg))
    tokens = np.random.default_rng(2).integers(
        0, TINY["vocab_size"], (ROWS, TINY["seq_len"] + 1)).astype(np.int64)
    return params, tokens


def _by_id(rows):
    ids = np.array([int(r["id"]) for r in rows])
    nll = np.array([float(r["nll"]) for r in rows])
    return ids, nll


@pytest.mark.parametrize("fused", [False, True])
def test_cuda_predictor_gpt2_nll_matches_jax_predictor(gpt2_inputs, fused):
    """Each id's NLL through ``BatchPredictor`` + ``CudaPredictor`` with
    ``gpt2_score`` (plain or fused-norm and flash paths, their CPU plain
    versions) within rtol 1e-5 of ``JaxPredictor`` with JAX's forward,
    fp32, on the same weights and rows."""
    params, tokens = gpt2_inputs
    items = [{"id": i, "tokens": t} for i, t in enumerate(tokens)]
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32, fused_norm=fused,
                            use_flash=fused)
    jres = JBatchPredictor.from_checkpoint(
        JCheckpoint.from_dict({"params": params}), JaxPredictor,
        apply_fn=functools.partial(_jax_score, jcfg)).predict(
            jdata.from_items(items, parallelism=3), batch_size=BATCH)
    tres = BatchPredictor.from_checkpoint(
        Checkpoint.from_dict({"params": params}), CudaPredictor,
        apply_fn=functools.partial(gpt2_score, cfg=tcfg), device="cpu"
    ).predict(tdata.from_items(items, parallelism=3), batch_size=BATCH,
              max_scoring_workers=1)
    jid, jnll = _by_id(jres.take_all())
    tid, tnll = _by_id(tres.take_all())
    assert sorted(tid.tolist()) == list(range(ROWS))
    np.testing.assert_allclose(tnll[np.argsort(tid)], jnll[np.argsort(jid)],
                               rtol=1e-5)


def test_measure_batch_predict_gpt2_equals_the_direct_call(gpt2_inputs):
    """The harness scores every id once, launches nothing on the CPU, and
    gives the NLL of a direct ``gpt2_score`` call on the same rows, bit
    for bit: the predictor adds nothing to the numbers."""
    params, tokens = gpt2_inputs
    cfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32, fused_norm=True,
                           use_flash=True)
    res = measure_batch_predict_gpt2(cfg, params=params, tokens=tokens,
                                     batch_size=BATCH, device="cpu")
    assert res["rows"] == ROWS and res["batches"] == ROWS // BATCH
    np.testing.assert_array_equal(res["ids"], np.arange(ROWS))
    assert res["launches"] == {} and res["peak_memory_bytes"] is None
    dev_params = params_from_numpy(params, "cpu")
    with torch.inference_mode():
        direct = np.concatenate([gpt2_score(dev_params, {
            "id": torch.arange(i, i + BATCH),
            "tokens": torch.from_numpy(tokens[i:i + BATCH])}, cfg)["nll"]
            .numpy() for i in range(0, ROWS, BATCH)])
    np.testing.assert_array_equal(res["nll"], direct)
    assert res["rows_s"] > 0 and res["device"] == "cpu"
