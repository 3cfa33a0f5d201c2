"""The port's sharded train step and sharded checkpoints on gloo ranks (one
process a rank, ``tests/torch_mesh_ranks.py``), against the JAX package's
sharded step and ``save_sharded`` on meshes of the same shape over the
suite's virtual CPU devices, from the same numpy weights and batch.

- GPT-2 (``tests/test_torch_train_step.py``'s tiny fused settings) on 2
  ranks at ``fsdp=2`` and on 4 at ``dp=2, fsdp=2``; Llama at d_model 256
  on 2 at ``fsdp=2``. Held as that test holds the one-device step: the
  first loss to rtol 1e-5 and all three to 1e-4, each step's grad norm to
  1e-4 (the sum of squares is taken in another order), the final
  parameters within 2 * lr a step of JAX's and under 1e-3 of coordinates
  off at rtol 1e-4 (Adam's first steps are close to lr * sign(g), so a
  coordinate whose gradient is ~0 may move either way on rounding noise).
- The sharded steps against the port's own one-device step: losses to
  rtol 1e-5.
- ``save_sharded`` of the initial parameters on ``dp=2, fsdp=2`` writes
  JAX's shard files, name for name and byte for byte, each by the lowest
  rank holding it; a whole state saved on 2 ranks loads onto 1 rank and
  onto 4 (another layout), and without shardings, bit for bit.

Each spawn runs under its own time limit and kills its ranks, so a stuck
rendezvous fails the test rather than hanging the suite. Each rank checks
that it imported nothing of JAX or ``ray_tpu``.
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding as JNamedSharding

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import optim as joptim
from ray_tpu.train.checkpoint import _bounds, _shard_key
from ray_tpu.train.checkpoint import save_sharded as jsave_sharded
from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
from ray_tpu.train.train_step import make_train_step as jmake_train_step
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.parallel.distributed import free_port
from ray_tpu_torch.train import checkpoint as tckpt
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
from torch_mesh_ranks import GPT2_TINY, LLAMA_SMALL

REPO = Path(__file__).resolve().parents[1]
RANKS = REPO / "tests" / "torch_mesh_ranks.py"
SPAWN_LIMIT_S = 180
N_STEPS = 3
LR = joptim.AdamWConfig().lr

MESHES = {"fsdp2": dict(fsdp=2), "dp2_fsdp2": dict(dp=2, fsdp=2)}


def _flat(tree, prefix):
    return {"/".join((prefix,) + path): np.asarray(leaf)
            for path, leaf in tckpt._flatten(tree)}


def _spawn(world, job, logs):
    """Start ``world`` ranks of ``job``; returns the processes."""
    address = f"127.0.0.1:{free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        log = open(logs / f"{Path(job['out']).stem}.rank{r}.log", "w")
        procs.append(subprocess.Popen(
            [sys.executable, str(RANKS), str(r), str(world), address,
             json.dumps(job)], cwd=REPO, env=env, stdout=log,
            stderr=subprocess.STDOUT))
        log.close()
    return procs


def _join(procs, started, logs, name):
    """Wait for every rank until ``SPAWN_LIMIT_S`` after ``started``, kill
    what is left, and fail unless every rank exited 0."""
    try:
        for p in procs:
            p.wait(timeout=max(1.0, started + SPAWN_LIMIT_S - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    rcs = [p.returncode for p in procs]
    if rcs != [0] * len(procs):
        tails = "\n".join(
            (logs / f"{name}.rank{r}.log").read_text()[-3000:]
            for r in range(len(procs)))
        pytest.fail(f"{name}: ranks exited {rcs}\n{tails}")


def _jax_steps(jcfg, loss, shardings_fn, init_params, tokens, mesh_kw, n,
               on_mesh=lambda cfg, mesh: cfg):
    """JAX's sharded steps on ``n`` devices; ``on_mesh(jcfg, mesh)`` gives
    the config the model runs with on that mesh."""
    mesh = build_mesh(MeshConfig(**mesh_kw, devices=jax.devices()[:n]))
    jcfg = on_mesh(jcfg, mesh)
    shardings = shardings_fn(jcfg, mesh)
    state = jmake_init_fn(lambda r: jax.tree.map(jnp.asarray, init_params),
                          shardings, mesh)(jax.random.key(0))
    step = jmake_train_step(lambda p, b: loss(p, b, jcfg), shardings, mesh)
    losses, norms = [], []
    for _ in range(N_STEPS):
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"losses": losses, "grad_norms": norms, "lr": float(m["lr"]),
            "params": jax.tree.map(np.asarray, state["params"])}


def _jax_save(params, shardings_fn, jcfg, path,
              mesh_kw=MESHES["dp2_fsdp2"]):
    """JAX's save_sharded of ``params`` on a 4-device mesh (dp=2 x fsdp=2
    unless ``mesh_kw`` says otherwise); returns each shard file's writer
    (the lowest device id holding the shard)."""
    mesh = build_mesh(MeshConfig(**mesh_kw, devices=jax.devices()[:4]))
    shardings = shardings_fn(jcfg, mesh)
    arrays = jax.tree.map(jax.device_put, params, shardings)
    jsave_sharded(arrays, str(path))
    writers = {}
    for i, (leaf, sh) in enumerate(zip(jax.tree.leaves(arrays),
                                       jax.tree.leaves(shardings))):
        shape = tuple(leaf.shape)
        assert isinstance(sh, JNamedSharding)
        for dev, index in sh.devices_indices_map(shape).items():
            fname = f"leaf_{i}.{_shard_key(*_bounds(index, shape))}.npy"
            writers[fname] = min(writers.get(fname, dev.id), dev.id)
    return writers


def _port_steps(tcfg, params, tokens):
    """The port's one-device step, here in the test process."""
    state = make_init_fn(lambda g: params_from_numpy(params, "cpu"))(
        torch.Generator())
    step = make_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, tcfg))
    losses = []
    for _ in range(N_STEPS):
        state, m = step(state, {"tokens": torch.from_numpy(tokens)})
        losses.append(float(m["loss"]))
    return losses


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every spawn and every JAX reference, once: GPT-2 on fsdp=2 (then
    saving its state) beside Llama on fsdp=2, the JAX side meanwhile;
    then GPT-2 on dp=2 x fsdp=2 (saving its initial parameters, loading
    the fsdp=2 state) beside one rank loading that state."""
    tmp = tmp_path_factory.mktemp("sharded")
    tokens = np.random.default_rng(5).integers(0, 256, (8, 65),
                                               dtype=np.int32)
    jg = jgpt2.GPT2Config(**GPT2_TINY, dtype=jnp.float32)
    jl = jllama.LlamaConfig(**LLAMA_SMALL, dtype=jnp.float32)
    g_params = jax.tree.map(np.asarray, jgpt2.gpt2_init(jax.random.key(0), jg))
    l_params = jax.tree.map(np.asarray,
                            jllama.llama_init(jax.random.key(0), jl))
    np.savez(tmp / "gpt2_in.npz", tokens=tokens, **_flat(g_params, "param"))
    np.savez(tmp / "llama_in.npz", tokens=tokens, **_flat(l_params, "param"))
    jobs = {
        "gpt2_fsdp2": (2, dict(model="gpt2", mesh=MESHES["fsdp2"],
                               inputs=str(tmp / "gpt2_in.npz"),
                               steps=N_STEPS, save=str(tmp / "ck_fsdp2"))),
        "llama_fsdp2": (2, dict(model="llama", mesh=MESHES["fsdp2"],
                                inputs=str(tmp / "llama_in.npz"),
                                steps=N_STEPS)),
        "gpt2_dp2_fsdp2": (4, dict(model="gpt2", mesh=MESHES["dp2_fsdp2"],
                                   inputs=str(tmp / "gpt2_in.npz"),
                                   steps=N_STEPS,
                                   save_params=str(tmp / "ck_params"),
                                   load=str(tmp / "ck_fsdp2"))),
        "load_1": (1, dict(model="gpt2", mesh=dict(fsdp=1),
                           load=str(tmp / "ck_fsdp2"))),
    }
    for name, (_, job) in jobs.items():
        job["out"] = str(tmp / f"{name}.npz")

    out = {}
    for phase in (("gpt2_fsdp2", "llama_fsdp2"),
                  ("gpt2_dp2_fsdp2", "load_1")):
        started = time.monotonic()
        procs = {name: _spawn(jobs[name][0], jobs[name][1], tmp)
                 for name in phase}
        if phase[0] == "gpt2_fsdp2":  # the JAX side while the ranks run
            out["jax"] = {
                "gpt2_fsdp2": _jax_steps(jg, jgpt2.gpt2_loss,
                                         jgpt2.gpt2_shardings, g_params,
                                         tokens, MESHES["fsdp2"], 2),
                "gpt2_dp2_fsdp2": _jax_steps(jg, jgpt2.gpt2_loss,
                                             jgpt2.gpt2_shardings, g_params,
                                             tokens, MESHES["dp2_fsdp2"], 4),
                "llama_fsdp2": _jax_steps(jl, jllama.llama_loss,
                                          jllama.llama_shardings, l_params,
                                          tokens, MESHES["fsdp2"], 2),
            }
            out["jax_writers"] = _jax_save(g_params, jgpt2.gpt2_shardings,
                                           jg, tmp / "jax_params")
            out["port_unsharded"] = _port_steps(
                tgpt2.GPT2Config(**GPT2_TINY, dtype=torch.float32),
                g_params, tokens)
        for name, ps in procs.items():
            _join(ps, started, tmp, name)
    for name, (world, job) in jobs.items():
        out[name] = dict(np.load(job["out"]))
        out[name]["written"] = [
            json.loads(Path(job["out"]).with_suffix(f".rank{r}.json")
                       .read_text()) for r in range(world)]
    out["tmp"] = tmp
    return out


def _check_against_jax(port, ref):
    np.testing.assert_allclose(port["losses"][0], ref["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(port["losses"], ref["losses"], rtol=1e-4)
    assert port["losses"][-1] < port["losses"][0]
    np.testing.assert_allclose(port["grad_norms"], ref["grad_norms"],
                               rtol=1e-4)
    assert list(port["lrs"]) == [ref["lr"]] * N_STEPS
    paths = [p for p, _ in tckpt._flatten(ref["params"])]
    got = np.concatenate([port["state/params/" + "/".join(p)].ravel()
                          for p in paths])
    want = np.concatenate([leaf.ravel() for _, leaf in
                           tckpt._flatten(ref["params"])])
    assert np.abs(got - want).max() <= 2 * LR * N_STEPS
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert off.mean() < 1e-3, f"{off.sum()} of {off.size} coordinates off"


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gpt2_sharded_steps_match_jax(runs, mesh):
    _check_against_jax(runs[f"gpt2_{mesh}"], runs["jax"][f"gpt2_{mesh}"])


def test_llama_sharded_steps_match_jax(runs):
    _check_against_jax(runs["llama_fsdp2"], runs["jax"]["llama_fsdp2"])


@pytest.mark.parametrize("mesh", list(MESHES))
def test_sharded_steps_match_the_ports_one_device_step(runs, mesh):
    np.testing.assert_allclose(runs[f"gpt2_{mesh}"]["losses"],
                               runs["port_unsharded"], rtol=1e-5)


def _shard_files(path):
    return sorted(p.name for p in Path(path).glob("leaf_*.npy"))


def test_checkpoint_files_match_jax(runs):
    """The port's save_sharded of the initial parameters on dp=2 x fsdp=2
    writes JAX's files for the same tree on the same mesh, each with the
    same bytes."""
    ours, theirs = runs["tmp"] / "ck_params", runs["tmp"] / "jax_params"
    names = _shard_files(ours)
    assert names == _shard_files(theirs)
    assert len(names) > len(tckpt._flatten(runs["jax"]["gpt2_fsdp2"]
                                           ["params"]))
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), name


def test_each_shard_is_written_once_by_the_lowest_rank(runs):
    written = runs["gpt2_dp2_fsdp2"]["written"]
    by_file = {}
    for rank, names in enumerate(written):
        for name in names:
            assert name not in by_file, f"{name} written twice"
            by_file[name] = rank
    assert by_file == runs["jax_writers"]
    assert sorted(by_file) == _shard_files(runs["tmp"] / "ck_params")


@pytest.mark.parametrize("target", ["load_1", "gpt2_dp2_fsdp2"])
def test_checkpoint_reshards_bit_for_bit(runs, target):
    """The state saved on 2 ranks (fsdp=2) loads onto 1 rank and onto 4
    (dp=2 x fsdp=2): every leaf, whole, equals the saved state's bits."""
    saved = runs["gpt2_fsdp2"]
    loaded = runs[target]
    keys = sorted(k[len("state/"):] for k in saved if k.startswith("state/"))
    assert len(keys) == 3 * len(tckpt._flatten(runs["jax"]["gpt2_fsdp2"]
                                               ["params"])) + 1
    for k in keys:
        want, got = saved["state/" + k], loaded["loaded/" + k]
        assert got.dtype == want.dtype and got.shape == want.shape, k
        assert got.tobytes() == want.tobytes(), k
    assert int(loaded["loaded/step"]) == N_STEPS


def test_checkpoint_loads_whole_without_shardings(runs):
    saved = runs["gpt2_fsdp2"]
    state = tckpt.load_sharded(str(runs["tmp"] / "ck_fsdp2"))
    assert state["step"] == N_STEPS
    flat = _flat(params_to_numpy({k: v for k, v in state.items()
                                  if k != "step"}), "state")
    for k, got in flat.items():
        assert got.tobytes() == saved[k].tobytes(), k
