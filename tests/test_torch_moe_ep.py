"""The port's expert-parallel MoE on gloo ranks (one process a rank,
``tests/torch_mesh_ranks.py``), against the port's one-device path and
the JAX package's sharded step on meshes of the same shape over the
suite's virtual CPU devices, from the same numpy weights and batch.

- ``moe_ffn_ep`` at ep=2 and ep=4 (every rank the whole batch, so the
  same capacity as one device) against ``moe_ffn`` in this process and
  JAX's ``moe_ffn``: the output and aux to rtol 1e-4, and the gradients of
  ``sum(out * dy) + aux``, averaged over the ranks as the train step
  averages them over ``ep``, to rtol 1e-4.
- ``MoEConfig.tiny()`` (fp32, dots remat, a capacity no token overflows)
  with ``expert_parallel`` at fsdp=2 x ep=2 (4 ranks) and at ep=2 against
  JAX's ``make_train_step`` on the same mesh with ``expert_parallel``:
  held as ``tests/test_torch_sharded_train.py`` holds the dense models
  (the first loss to rtol 1e-5, all to 1e-4, each step's grad norm to
  1e-4, the final parameters), and against the port's one-device step
  (losses rtol 1e-5 / 1e-4, grad norms 1e-4). A missing or doubled mean
  over ``ep`` of the expert weights' gradients scales their part of the
  grad norm by ep.
- ``save_sharded`` of the initial MoE parameters on fsdp=2 x ep=2 writes
  JAX's shard files, name for name and byte for byte.
"""

import dataclasses
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.ops import moe as jops
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import moe as tops
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
from test_torch_sharded_train import (N_STEPS, _check_against_jax, _flat,
                                      _jax_save, _jax_steps, _join,
                                      _shard_files, _spawn)
from torch_mesh_ranks import MOE_TINY

MESHES = {"fsdp2_ep2": dict(fsdp=2, ep=2), "ep2": dict(fsdp=1, ep=2)}
FFN_EPS = (2, 4)
FFN = dict(d_model=32, d_ff=64, n_experts=8, top_k=2, capacity_factor=4.0)


def _ffn_inputs():
    p = jops.init_moe_params(jax.random.key(3), FFN["d_model"], FFN["d_ff"],
                             FFN["n_experts"])
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 16, FFN["d_model"]), dtype=np.float32)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    return jax.tree.map(np.array, p), x, dy


def _ffn_reference(params, x, dy):
    """The port's moe_ffn on one device: output, aux and the gradients of
    sum(out * dy) + aux."""
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in params.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tops.moe_ffn(p, xt, top_k=FFN["top_k"],
                          capacity_factor=FFN["capacity_factor"])
    (y * torch.from_numpy(dy)).sum().add(aux).backward()
    grads = {f"grad/{k}": v.grad.numpy() for k, v in p.items()}
    return {"out": y.detach().numpy(), "aux": aux.detach().numpy(),
            "grad/x": xt.grad.numpy(), **grads}


def _port_unsharded(tcfg, params, tokens):
    state = make_init_fn(lambda g: params_from_numpy(params, "cpu"))(
        torch.Generator())
    step = make_train_step(lambda p, b: tmoe.moe_loss(p, b, tcfg))
    losses, norms = [], []
    for _ in range(N_STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms}


def _expert_parallel(cfg, mesh):
    return dataclasses.replace(cfg, expert_parallel=True, mesh=mesh)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both moe_ffn_ep spawns, then both model spawns (the second saving
    its initial parameters), each pair at once; the references while the
    ranks run."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    params, x, dy = _ffn_inputs()
    np.savez(tmp / "ffn_in.npz", x=x, dy=dy, **_flat(params, "param"))
    tokens = np.random.default_rng(5).integers(0, 256, (8, 65),
                                               dtype=np.int32)
    jcfg = jmoe.MoEConfig(**MOE_TINY, dtype=jnp.float32)
    m_params = jax.tree.map(np.asarray, jmoe.moe_init(jax.random.key(0),
                                                      jcfg))
    np.savez(tmp / "moe_in.npz", tokens=tokens, **_flat(m_params, "param"))
    jobs = {f"ffn_ep{n}": (n, dict(ffn_ep=True, mesh=dict(fsdp=1, ep=n),
                                   inputs=str(tmp / "ffn_in.npz"),
                                   top_k=FFN["top_k"],
                                   capacity_factor=FFN["capacity_factor"]))
            for n in FFN_EPS}
    for name, mesh in MESHES.items():
        world = int(np.prod(list(mesh.values())))
        jobs[f"moe_{name}"] = (world, dict(model="moe", mesh=mesh,
                                           inputs=str(tmp / "moe_in.npz"),
                                           steps=N_STEPS))
    jobs["moe_fsdp2_ep2"][1]["save_params"] = str(tmp / "ck_params")
    for name, (_, job) in jobs.items():
        job["out"] = str(tmp / f"{name}.npz")

    out = {}
    for phase in ([f"ffn_ep{n}" for n in FFN_EPS],
                  [f"moe_{name}" for name in MESHES]):
        started = time.monotonic()
        procs = {name: _spawn(jobs[name][0], jobs[name][1], tmp)
                 for name in phase}
        if phase[0] == "ffn_ep2":
            out["ffn_port"] = _ffn_reference(params, x, dy)
            jy, jaux = jops.moe_ffn(jax.tree.map(jnp.asarray, params),
                                    jnp.asarray(x), top_k=FFN["top_k"],
                                    capacity_factor=FFN["capacity_factor"])
            out["ffn_jax"] = {"out": np.asarray(jy), "aux": np.asarray(jaux)}
        else:
            out["jax"] = {
                name: _jax_steps(jcfg, jmoe.moe_loss, jmoe.moe_shardings,
                                 m_params, tokens, mesh,
                                 int(np.prod(list(mesh.values()))),
                                 on_mesh=_expert_parallel)
                for name, mesh in MESHES.items()}
            out["jax_writers"] = _jax_save(
                m_params, jmoe.moe_shardings, jcfg, tmp / "jax_params",
                MESHES["fsdp2_ep2"])
            out["port_unsharded"] = _port_unsharded(
                tmoe.MoEConfig(**MOE_TINY, dtype=torch.float32), m_params,
                tokens)
        for name, ps in procs.items():
            _join(ps, started, tmp, name)
    for name, (_, job) in jobs.items():
        out[name] = dict(np.load(job["out"]))
    out["tmp"] = tmp
    return out


@pytest.mark.parametrize("ep", FFN_EPS)
def test_moe_ffn_ep_matches_moe_ffn(runs, ep):
    got, want = runs[f"ffn_ep{ep}"], runs["ffn_port"]
    assert sorted(got) == sorted(want)
    for key in sorted(want):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-6,
                                   err_msg=key)
    for key in ("out", "aux"):
        np.testing.assert_allclose(got[key], runs["ffn_jax"][key], rtol=1e-4,
                                   atol=1e-6, err_msg=key)
    # Every expert's weights got a gradient, not only rank 0's.
    per_expert = np.abs(got["grad/w_in"]).sum(axis=(1, 2))
    assert (per_expert > 0).all(), per_expert


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_sharded_steps_match_jax(runs, mesh):
    _check_against_jax(runs[f"moe_{mesh}"], runs["jax"][mesh])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_moe_sharded_steps_match_the_ports_one_device_step(runs, mesh):
    got, want = runs[f"moe_{mesh}"], runs["port_unsharded"]
    np.testing.assert_allclose(got["losses"][0], want["losses"][0],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-4)
    np.testing.assert_allclose(got["grad_norms"], want["grad_norms"],
                               rtol=1e-4)


def test_moe_checkpoint_files_match_jax(runs):
    """save_sharded of the initial MoE parameters on fsdp=2 x ep=2: JAX's
    files for the same tree on the same mesh, byte for byte, each written
    by the lowest rank that holds it."""
    ours, theirs = runs["tmp"] / "ck_params", runs["tmp"] / "jax_params"
    names = _shard_files(ours)
    assert names == _shard_files(theirs)
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name
    written = [json.loads((runs["tmp"] / f"moe_fsdp2_ep2.rank{r}.json")
                          .read_text()) for r in range(4)]
    by_file = {}
    for rank, files in enumerate(written):
        for name in files:
            assert name not in by_file, f"{name} written twice"
            by_file[name] = rank
    assert by_file == runs["jax_writers"]
