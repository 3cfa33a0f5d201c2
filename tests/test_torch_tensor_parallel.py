"""The port's train step with the models computing over ``tp``
(``parallel/tensor_parallel.py``), on gloo ranks, against the JAX
package.

GPT-2 and Llama (``tests/torch_mesh_ranks.py``'s ``GPT2_TINY`` and
``LLAMA_SMALL``: fp32, dots remat, the fused-norm ops, flash for Llama)
train three steps with the model on the mesh (job ``runs``): on 2 ranks
at ``tp=2`` (GPT-2 with ``ce_vocab_chunks`` 2 and 1, Llama), on 4 at
``fsdp=2 x tp=2`` (both) and Llama at ``tp=2 x sp=2`` with ring
attention. Each is held against the JAX package's one-device steps from
the same numpy weights and batch: the first loss to rtol 1e-5, every loss
and every grad norm to 1e-4 (the same fp32 arithmetic, summed in another
order). At ``tp=2`` the gradients the step hands AdamW at step 1 are held
leaf by leaf against ``jax.grad`` of the one-device loss (rtol 1e-4, and
1e-5 of the leaf's largest magnitude absolute): a leaf a rank uses a
slice of is summed over ``tp``, the others averaged, and a mean over both
would halve the first kind, which losses do not show (Adam's first steps
are close to lr * sign(g)). The models' forward logits on the tp mesh
(each rank's V/tp columns, gathered) equal those off it to 1e-5 of their
largest magnitude.

Checkpoints across ``tp``: the GPT-2 state after three steps at ``tp=2``
saves with ``save_sharded`` and loads onto ``fsdp=2`` and onto one rank
(this process), one saved at ``fsdp=2`` and one saved by one rank load
onto ``tp=2``, each bit for bit. In this process, over a ``fake`` group:
the MoE model at ``tp=2`` raises ``NotImplementedError``, a ``tp`` that
does not divide the heads raises before the first step, and a model that
is not given the mesh raises at its first step.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
from test_torch_mesh import fake_world
from test_torch_sharded_train import N_STEPS, _flat, _jax_steps, _join, _spawn
from torch_mesh_ranks import GPT2_TINY, LLAMA_SMALL

# name -> (model, JAX config, mesh, port cfg settings, world)
RUNS = {
    "gpt2_ce2_tp2": ("gpt2", 2, dict(fsdp=1, tp=2), {}, 2),
    "gpt2_ce1_tp2": ("gpt2", 1, dict(fsdp=1, tp=2), {}, 2),
    "llama_tp2": ("llama", None, dict(fsdp=1, tp=2), {}, 2),
    "gpt2_ce2_fsdp2_tp2": ("gpt2", 2, dict(fsdp=2, tp=2), {}, 4),
    "llama_fsdp2_tp2": ("llama", None, dict(fsdp=2, tp=2), {}, 4),
    "llama_sp2_tp2_ring": ("llama", None, dict(fsdp=1, sp=2, tp=2),
                           {"attention_impl": "ring"}, 4),
}
GRAD_RUNS = ("gpt2_ce2_tp2", "gpt2_ce1_tp2", "llama_tp2")


def _jcfg(model, chunks):
    if model == "gpt2":
        return jgpt2.GPT2Config(**dict(GPT2_TINY, ce_vocab_chunks=chunks),
                                dtype=jnp.float32)
    return jllama.LlamaConfig(**LLAMA_SMALL, dtype=jnp.float32)


def _jax_ref(model, chunks, params, tokens):
    """JAX's one-device steps and step 1's gradients."""
    jcfg = _jcfg(model, chunks)
    jm = jgpt2 if model == "gpt2" else jllama
    loss = jm.gpt2_loss if model == "gpt2" else jm.llama_loss
    shardings = jm.gpt2_shardings if model == "gpt2" else jm.llama_shardings
    out = _jax_steps(jcfg, loss, shardings, params, tokens, dict(fsdp=1), 1)
    grads = jax.jit(jax.grad(lambda p: loss(p, {"tokens": jnp.asarray(
        tokens)}, jcfg)))(jax.tree.map(jnp.asarray, params))
    out["grads"] = _flat(jax.tree.map(np.asarray, grads), "grad")
    return out


def _port_one_rank_state(params, tokens):
    """One step of the port's one-device GPT-2 (ce 2) here: a state saved
    by one rank."""
    cfg = tgpt2.GPT2Config(**dict(GPT2_TINY, ce_vocab_chunks=2),
                           dtype=torch.float32)
    state = make_init_fn(lambda g: params_from_numpy(params, "cpu"))(
        torch.Generator())
    step = make_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, cfg))
    state, _ = step(state, {"tokens": torch.from_numpy(tokens)})
    return state


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both spawns at once (every run of a world in one job), and the JAX
    references while they run."""
    tmp = tmp_path_factory.mktemp("tp")
    tokens = np.random.default_rng(11).integers(0, 256, (4, 65),
                                                dtype=np.int32)
    params = {
        "gpt2": jax.tree.map(np.asarray, jgpt2.gpt2_init(
            jax.random.key(0), _jcfg("gpt2", 2))),
        "llama": jax.tree.map(np.asarray, jllama.llama_init(
            jax.random.key(0), _jcfg("llama", None)))}
    for model, p in params.items():
        np.savez(tmp / f"{model}_in.npz", tokens=tokens, **_flat(p, "param"))
    one = _port_one_rank_state(params["gpt2"], tokens)
    tckpt.save_sharded(one, str(tmp / "ck_one"))
    entries = {2: [], 4: []}
    for name, (model, chunks, mesh, cfg, world) in RUNS.items():
        if model == "gpt2":
            cfg = dict(cfg, ce_vocab_chunks=chunks)
        entries[world].append(dict(
            name=name, model=model, mesh=mesh, cfg=cfg, steps=N_STEPS,
            inputs=str(tmp / f"{model}_in.npz"), grads=name in GRAD_RUNS,
            forward=name in GRAD_RUNS,
            save=str(tmp / "ck_tp2") if name == "gpt2_ce2_tp2" else None))
    ce2 = {"ce_vocab_chunks": 2}
    entries[2] += [
        dict(name="gpt2_fsdp2", model="gpt2", mesh=dict(fsdp=2), cfg=ce2,
             steps=1, inputs=str(tmp / "gpt2_in.npz"),
             save=str(tmp / "ck_fsdp2")),
        dict(name="tp2_on_fsdp2", model="gpt2", mesh=dict(fsdp=2), cfg=ce2,
             load=str(tmp / "ck_tp2")),
        dict(name="fsdp2_on_tp2", model="gpt2", mesh=dict(fsdp=1, tp=2),
             cfg=ce2, load=str(tmp / "ck_fsdp2")),
        dict(name="one_on_tp2", model="gpt2", mesh=dict(fsdp=1, tp=2),
             cfg=ce2, load=str(tmp / "ck_one"))]
    jobs = {w: dict(runs=e, out=str(tmp / f"tp_world{w}.npz"))
            for w, e in entries.items()}
    started = time.monotonic()
    procs = {w: _spawn(w, job, tmp) for w, job in jobs.items()}
    out = {"jax": {key: _jax_ref(model, chunks, params[model], tokens)
                   for key, (model, chunks) in {
                       "gpt2_ce2": ("gpt2", 2), "gpt2_ce1": ("gpt2", 1),
                       "llama": ("llama", None)}.items()}}
    for w, ps in procs.items():
        _join(ps, started, tmp, f"tp_world{w}")
        out.update(dict(np.load(jobs[w]["out"])))
    out["one"] = _flat({k: v for k, v in one.items() if k != "step"},
                       "state")
    out["tmp"] = tmp
    return out


def _ref_key(name):
    return "llama" if name.startswith("llama") else name[:len("gpt2_ce2")]


@pytest.mark.parametrize("name", list(RUNS))
def test_tp_steps_match_jax_one_device(runs, name):
    ref = runs["jax"][_ref_key(name)]
    losses, norms = runs[f"{name}/losses"], runs[f"{name}/grad_norms"]
    np.testing.assert_allclose(losses[0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses, ref["losses"], rtol=1e-4)
    np.testing.assert_allclose(norms, ref["grad_norms"], rtol=1e-4)
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("name", GRAD_RUNS)
def test_tp2_step_gradients_match_jax_grad_leaf_by_leaf(runs, name):
    want = runs["jax"][_ref_key(name)]["grads"]
    prefix = f"{name}/grad/"
    got = {k[len(prefix):]: v for k, v in runs.items()
           if isinstance(k, str) and k.startswith(prefix)}
    assert sorted(got) == sorted(k[len("grad/"):] for k in want)
    for key, g in got.items():
        w = want["grad/" + key]
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=1e-5 * np.abs(w).max(), err_msg=key)


@pytest.mark.parametrize("name", GRAD_RUNS)
def test_tp2_forward_gives_every_rank_the_whole_logits(runs, name):
    """``gpt2_forward`` / ``llama_forward`` on the tp mesh (each rank its
    V/tp columns, gathered) against the same model off the mesh."""
    assert float(runs[f"{name}/forward_gap"]) < 1e-5


def _states(runs, prefix):
    return {k[len(prefix):]: v for k, v in runs.items()
            if isinstance(k, str) and k.startswith(prefix)}


@pytest.mark.parametrize("saved,loaded", [
    ("gpt2_ce2_tp2/state/", "tp2_on_fsdp2/loaded/"),
    ("gpt2_fsdp2/state/", "fsdp2_on_tp2/loaded/"),
    ("one", "one_on_tp2/loaded/")])
def test_checkpoints_reshard_across_tp_bit_for_bit(runs, saved, loaded):
    want = (_states(runs, saved) if saved != "one" else
            {k[len("state/"):]: v for k, v in runs["one"].items()})
    got = _states(runs, loaded)
    want.pop("step", None)
    assert sorted(k for k in got if k != "step") == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
        assert got[k].tobytes() == w.tobytes(), k


def test_tp2_checkpoint_loads_onto_one_rank_bit_for_bit(runs):
    state = tckpt.load_sharded(str(runs["tmp"] / "ck_tp2"))
    assert state["step"] == N_STEPS
    want = _states(runs, "gpt2_ce2_tp2/state/")
    got = _flat({k: v for k, v in state.items() if k != "step"}, "s")
    assert sorted(k[2:] for k in got) == sorted(k for k in want
                                                if k != "step")
    for k, g in got.items():
        assert g.tobytes() == want[k[2:]].tobytes(), k


def _tp_mesh(tp=2):
    return tmesh.build_mesh(tmesh.MeshConfig(fsdp=1, tp=tp), device="cpu")


def test_moe_at_tp2_raises_not_implemented():
    cfg = tmoe.MoEConfig.tiny()
    with fake_world(2):
        mesh = _tp_mesh()
        with pytest.raises(NotImplementedError, match="A12c"):
            tmoe.moe_shardings(cfg, mesh)
        tokens = torch.zeros((2, 65), dtype=torch.int64)
        with pytest.raises(NotImplementedError, match="A12c"):
            tmoe.moe_loss({}, {"tokens": tokens},
                          dataclasses.replace(cfg, mesh=mesh))


@pytest.mark.parametrize("model,kw,what", [
    ("gpt2", dict(n_head=3, d_model=96), "n_head"),
    ("gpt2", dict(vocab_size=255), "vocab_size"),
    ("llama", dict(n_head=4, n_kv_head=1), "n_kv_head"),
])
def test_tp_that_does_not_divide_raises_before_the_first_step(model, kw,
                                                              what):
    cfg = (tgpt2.GPT2Config.tiny() if model == "gpt2"
           else tllama.LlamaConfig.tiny())
    cfg = dataclasses.replace(cfg, **kw)
    shardings = (tgpt2.gpt2_shardings if model == "gpt2"
                 else tllama.llama_shardings)
    with fake_world(2):
        mesh = _tp_mesh()
        with pytest.raises(ValueError, match=f"tp=2.*{what}"):
            shardings(cfg, mesh)


def test_a_model_not_on_the_tp_mesh_raises_at_its_first_step():
    cfg = tgpt2.GPT2Config.tiny()  # no mesh: it would compute unsharded
    tokens = torch.zeros((2, 65), dtype=torch.int64)
    with fake_world(2):
        mesh = _tp_mesh()
        shardings = tgpt2.gpt2_shardings(cfg, mesh)
        state = make_init_fn(
            lambda g: tgpt2.gpt2_init(g, cfg, device="cpu"), shardings,
            mesh)(torch.Generator().manual_seed(0))
        step = make_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, cfg),
                               shardings, mesh)
        with pytest.raises(RuntimeError, match="computed nothing over tp"):
            step(state, {"tokens": tokens})
