"""The port's train step with the sequence sharded over ``sp`` (ring
attention and Ulysses), on gloo ranks, against the JAX package.

GPT-2 and Llama (``tests/torch_mesh_ranks.py``'s ``GPT2_TINY`` and
``LLAMA_SMALL``: fp32, dots remat, the fused-norm ops, chunked CE for
GPT-2, flash for Llama) train three steps on 2 ranks at ``sp=2`` (job
``sp_steps``) with ``attention_impl`` ``"ring"``, ``"ulysses"`` and
``"auto"``, the model on the mesh: under ring and Ulysses each rank
computes its 32 of the 64 positions, under ``"auto"`` every rank the whole
sequence (ROADMAP G3). Each is held against the JAX package's one-device
steps (``attention_impl="auto"``, no mesh) from the same numpy weights and
batch: every loss and every grad norm to rtol 1e-4 -- the same fp32
arithmetic, summed in another order. The ranks count the model's calls
of ring attention and Ulysses: one a layer per forward, the dots remat's
recomputation doubling it, and none under ``"auto"``.
"""

import time

import jax
import numpy as np
import pytest

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from test_torch_sharded_train import N_STEPS, _flat, _jax_steps, _join, _spawn
from torch_mesh_ranks import GPT2_TINY, LLAMA_SMALL

IMPLS = ("ring", "ulysses", "auto")
MODELS = {
    "gpt2": (jgpt2.GPT2Config(**GPT2_TINY, dtype=jax.numpy.float32),
             jgpt2.gpt2_init, jgpt2.gpt2_loss, jgpt2.gpt2_shardings),
    "llama": (jllama.LlamaConfig(**LLAMA_SMALL, dtype=jax.numpy.float32),
              jllama.llama_init, jllama.llama_loss, jllama.llama_shardings),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both models' ranks at once (every impl in one job a model), and the
    JAX one-device steps while they run."""
    tmp = tmp_path_factory.mktemp("sp")
    tokens = np.random.default_rng(7).integers(0, 256, (4, 65),
                                               dtype=np.int32)
    params, jobs = {}, {}
    for model, (jcfg, init, _, _) in MODELS.items():
        params[model] = jax.tree.map(np.asarray, init(jax.random.key(0), jcfg))
        np.savez(tmp / f"{model}_in.npz", tokens=tokens,
                 **_flat(params[model], "param"))
        jobs[model] = dict(model=model, sp_steps=list(IMPLS),
                           mesh=dict(fsdp=1, sp=2), steps=N_STEPS,
                           inputs=str(tmp / f"{model}_in.npz"),
                           out=str(tmp / f"sp_{model}.npz"))
    started = time.monotonic()
    procs = {model: _spawn(2, job, tmp) for model, job in jobs.items()}
    out = {"jax": {model: _jax_steps(jcfg, loss, shardings, params[model],
                                     tokens, dict(fsdp=1), 1)
                   for model, (jcfg, _, loss, shardings) in MODELS.items()}}
    for model, ps in procs.items():
        _join(ps, started, tmp, f"sp_{model}")
        out[model] = dict(np.load(jobs[model]["out"]))
    return out


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("model", list(MODELS))
def test_sp2_steps_match_jax_one_device(runs, model, impl):
    ref, got = runs["jax"][model], runs[model]
    np.testing.assert_allclose(got[f"{impl}/losses"], ref["losses"],
                               rtol=1e-4)
    np.testing.assert_allclose(got[f"{impl}/grad_norms"], ref["grad_norms"],
                               rtol=1e-4)
    assert got[f"{impl}/losses"][-1] < got[f"{impl}/losses"][0]


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("model", list(MODELS))
def test_the_model_calls_the_impl_it_names(runs, model, impl):
    """Per rank over three steps: one call a layer in the forward and one
    in the dots remat's recomputation (2 layers: 4 a step)."""
    layers = MODELS[model][0].n_layer
    want = {"ring": [2 * layers * N_STEPS, 0],
            "ulysses": [0, 2 * layers * N_STEPS], "auto": [0, 0]}[impl]
    assert list(runs[model][f"{impl}/calls"]) == want
