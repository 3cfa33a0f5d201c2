"""The port's pipeline (``ray_tpu_torch/parallel/pipeline.py``) against the
JAX package's (``ray_tpu/parallel/pipeline.py``) on the CPU.

- ``build_1f1b_schedule``: the four tables equal JAX's for pp 2, 3 and 4,
  n_micro 1, 2, 4, 6 and 8, both styles.
- ``pipeline_value_and_grad`` (1F1B and GPipe) and ``pipeline_apply`` for
  the JAX test's stage function (``tests/test_parallel_ops.py``:
  ``tanh(x @ w + b)``, MSE) at pp 2 and 4, n_micro 2, 4 and 6, against
  JAX's on 2 or 4 of the suite's CPU devices: folded in this process
  (``mesh=None``), and over gloo ranks (``tests/torch_mesh_ranks.py`` job
  ``pp_ops``) on a mesh of pp=4 and one of pp=2 x dp=2 (each microbatch
  split over ``dp`` and averaged over it); loss, gradients and outputs
  to rtol 1e-5 (atol 1e-6, a few fp32 ulps at the outputs' scale).
- GPT-2's blocks (the tiny fused settings of ``torch_mesh_ranks.py``) as
  a 2-stage folded pipeline of 4 microbatches, both styles, against one
  ``value_and_grad`` of the blocks in sequence (rtol 1e-5), with each
  stage's stash within its bound.
- The train step at ``pp=2 x fsdp=2`` (storage only: the layers stored
  over ``pp``, gathered whole; job ``runs``, 4 ranks) against the JAX
  package's one-device steps: first loss rtol 1e-5, every loss and grad
  norm 1e-4.
"""

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import pipeline as jpipe
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.parallel import pipeline as tpipe
from ray_tpu_torch.train.train_step import value_and_grad
from test_torch_sharded_train import N_STEPS, _flat, _jax_steps, _join, _spawn
from torch_mesh_ranks import GPT2_TINY

STYLES = ("1f1b", "gpipe")
N_MICROS = (2, 4, 6)
PPS = (2, 4)
D, BATCH = 12, 24
GROUP_MESHES = {"pp4": dict(pp=4, fsdp=1), "pp2_dp2": dict(pp=2, dp=2,
                                                            fsdp=1)}


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("n_micro", (1, 2, 4, 6, 8))
@pytest.mark.parametrize("pp", (2, 3, 4))
def test_schedule_tables_match_jax(pp, n_micro, style):
    assert tpipe.build_1f1b_schedule(n_micro, pp, style) == \
        jpipe.build_1f1b_schedule(n_micro, pp, style)


def _inputs():
    rng = np.random.default_rng(3)
    out = {"x": rng.standard_normal((BATCH, D), dtype=np.float32),
           "y": rng.standard_normal((BATCH, D), dtype=np.float32)}
    for pp in PPS:
        out[f"pp{pp}/w"] = (rng.standard_normal((pp, D, D)) * 0.4).astype(
            np.float32)
        out[f"pp{pp}/b"] = (rng.standard_normal((pp, D)) * 0.1).astype(
            np.float32)
    return out


def _jstage(p, x):
    return jnp.tanh(x @ p["w"] + p["b"])


def _jmse(o, y):
    return jnp.mean((o - y) ** 2)


def _jax_pipeline(inputs):
    """JAX's value_and_grad and apply for every (pp, n_micro, style), on
    a few threads: each call compiles its own program, and XLA compiles
    outside the GIL."""
    x, y = jnp.asarray(inputs["x"]), jnp.asarray(inputs["y"])
    meshes, params = {}, {}
    for pp in PPS:
        meshes[pp] = Mesh(np.array(jax.devices()[:pp]), ("pp",))
        params[pp] = {k: jax.device_put(
            jnp.asarray(inputs[f"pp{pp}/{k}"]),
            NamedSharding(meshes[pp], P("pp", *([None] * (inputs[
                f"pp{pp}/{k}"].ndim - 1))))) for k in "wb"}

    def one(key):
        pp, n, style = key
        if style == "apply":
            return np.asarray(jpipe.pipeline_apply(
                params[pp], x, meshes[pp], stage_fn=_jstage, n_micro=n))
        loss, grads = jpipe.pipeline_value_and_grad(
            params[pp], x, y, meshes[pp], stage_fn=_jstage, loss_fn=_jmse,
            n_micro=n, style=style)
        return float(loss), {k: np.asarray(v) for k, v in grads.items()}

    keys = [(pp, n, style) for pp in PPS for n in N_MICROS
            for style in STYLES + ("apply",)]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(zip(keys, pool.map(one, keys)))


def _tstage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _tmse(o, y):
    return torch.mean((o - y) ** 2)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The gloo ranks (the pipeline on two meshes, and GPT-2's steps at
    pp=2 x fsdp=2) and the JAX side while they run."""
    tmp = tmp_path_factory.mktemp("pp")
    inputs = _inputs()
    np.savez(tmp / "pp_in.npz", **inputs)
    tokens = np.random.default_rng(13).integers(0, 256, (4, 65),
                                                dtype=np.int32)
    jcfg = jgpt2.GPT2Config(**GPT2_TINY, dtype=jnp.float32)
    params = jax.tree.map(np.asarray, jgpt2.gpt2_init(jax.random.key(0),
                                                      jcfg))
    np.savez(tmp / "gpt2_in.npz", tokens=tokens, **_flat(params, "param"))
    job = dict(pp_ops=list(GROUP_MESHES.values()), n_micro=list(N_MICROS),
               inputs=str(tmp / "pp_in.npz"),
               runs=[dict(name="gpt2_pp2_fsdp2", model="gpt2",
                          mesh=dict(pp=2, fsdp=2), steps=N_STEPS,
                          inputs=str(tmp / "gpt2_in.npz"))],
               out=str(tmp / "pp_world4.npz"))
    started = time.monotonic()
    procs = _spawn(4, job, tmp)
    out = {"inputs": inputs, "jax": _jax_pipeline(inputs),
           "jax_gpt2": _jax_steps(jcfg, jgpt2.gpt2_loss,
                                  jgpt2.gpt2_shardings, params, tokens,
                                  dict(fsdp=1), 1)}
    _join(procs, started, tmp, "pp_world4")
    out["group"] = dict(np.load(job["out"]))
    return out


def _close(got, want):
    # atol: a few fp32 ulps at the values' scale (tanh outputs, ~1), for
    # the elements near zero, where two summation orders part by more
    # than 1e-5 relative.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("n_micro", N_MICROS)
@pytest.mark.parametrize("pp", PPS)
def test_folded_value_and_grad_matches_jax(runs, pp, n_micro, style):
    inputs = runs["inputs"]
    params = {k: torch.from_numpy(inputs[f"pp{pp}/{k}"]) for k in "wb"}
    loss, grads = tpipe.pipeline_value_and_grad(
        params, torch.from_numpy(inputs["x"]), torch.from_numpy(inputs["y"]),
        None, stage_fn=_tstage, loss_fn=_tmse, n_micro=n_micro, style=style)
    want_loss, want_grads = runs["jax"][(pp, n_micro, style)]
    _close(float(loss), want_loss)
    for k in "wb":
        assert grads[k].shape == params[k].shape
        _close(grads[k].numpy(), want_grads[k])


@pytest.mark.parametrize("n_micro", N_MICROS)
@pytest.mark.parametrize("pp", PPS)
def test_folded_apply_matches_jax(runs, pp, n_micro):
    inputs = runs["inputs"]
    params = {k: torch.from_numpy(inputs[f"pp{pp}/{k}"]) for k in "wb"}
    got = tpipe.pipeline_apply(params, torch.from_numpy(inputs["x"]), None,
                               stage_fn=_tstage, n_micro=n_micro)
    _close(got.numpy(), runs["jax"][(pp, n_micro, "apply")])


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("n_micro", N_MICROS)
@pytest.mark.parametrize("mesh", list(GROUP_MESHES))
def test_group_value_and_grad_matches_jax(runs, mesh, n_micro, style):
    """Over gloo ranks, one stage a rank; the pp=2 x dp=2 mesh against
    JAX's pp=2 (each dp rank computes half of each microbatch)."""
    pp = GROUP_MESHES[mesh]["pp"]
    got = runs["group"]
    want_loss, want_grads = runs["jax"][(pp, n_micro, style)]
    _close(got[f"{mesh}/{n_micro}_{style}/loss"], want_loss)
    for k in "wb":
        _close(got[f"{mesh}/{n_micro}_{style}/{k}"], want_grads[k])


@pytest.mark.parametrize("n_micro", N_MICROS)
@pytest.mark.parametrize("mesh", list(GROUP_MESHES))
def test_group_apply_matches_jax_on_every_rank(runs, mesh, n_micro):
    """Rank 0 (the first stage) holds the last stage's outputs."""
    pp = GROUP_MESHES[mesh]["pp"]
    _close(runs["group"][f"{mesh}/apply/{n_micro}"],
           runs["jax"][(pp, n_micro, "apply")])


def test_gpt2_pp2_fsdp2_steps_match_jax_one_device(runs):
    got, ref = runs["group"], runs["jax_gpt2"]
    losses = got["gpt2_pp2_fsdp2/losses"]
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["gpt2_pp2_fsdp2/grad_norms"],
                               ref["grad_norms"], rtol=1e-4)
    assert losses[-1] < losses[0]


@pytest.fixture
def one_thread():
    """torch on one thread here: beside XLA's CPU threads its default pool
    spins (a step 50x slower)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("style", STYLES)
def test_gpt2_blocks_folded_pipeline_matches_the_sequential_blocks(
        style, one_thread):
    """The pipeline of GPT-2's blocks (2 stages of 1 block, 4
    microbatches, dots remat inside each stage) against one
    value_and_grad of the two blocks in sequence, on the same weights."""
    cfg = tgpt2.GPT2Config(**GPT2_TINY, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    blocks = tgpt2.gpt2_init(gen, cfg, device="cpu")["blocks"]
    x = torch.randn((8, 16, cfg.d_model), generator=gen)
    y = torch.randn((8, 16, cfg.d_model), generator=gen)
    stage = tgpt2.gpt2_stage_fn(cfg)

    def mse(o, t):
        return torch.mean((o.float() - t) ** 2)

    loss, grads = tpipe.pipeline_value_and_grad(
        tgpt2.gpt2_stage_params(blocks, 2), x, y, None, stage_fn=stage,
        loss_fn=mse, n_micro=4, style=style)
    # The mean of the 4 microbatches' MSEs is the MSE over the batch.
    ref_loss, ref_grads = value_and_grad(
        lambda p, b: mse(stage(p, b), y), blocks, x)
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for k, g in ref_grads.items():
        np.testing.assert_allclose(grads[k].reshape(g.shape).numpy(),
                                   g.numpy(), rtol=1e-5,
                                   atol=1e-6 * float(g.abs().max()),
                                   err_msg=k)
