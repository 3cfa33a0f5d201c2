"""One rank of the port's sharded train step on the CPU, for
``tests/test_torch_sharded_train.py`` (run as a script, one process a
rank, over a gloo group).

    python tests/torch_mesh_ranks.py RANK WORLD ADDRESS JOB_JSON

The job (JSON) names the model (``gpt2`` or ``llama``, the tests' tiny
fused configurations, or ``moe``, the tiny MoE model on the expert-parallel
path), the mesh (``{"dp": 2, "fsdp": 2}``), an ``.npz`` of inputs (the
initial parameters under ``param/<path>`` and the batch under ``tokens``),
how many steps to take, and what to save and load:

- ``save_params``: a directory to ``save_sharded`` the initial
  parameters into, before the first step;
- ``save``: a directory to ``save_sharded`` the whole state into, after
  the last step;
- ``load``: a checkpoint directory to ``load_sharded`` onto this mesh.

A job with ``"ffn_ep": true`` instead runs ``ops.moe.moe_ffn_ep`` once
over the mesh's ``ep`` axis on the inputs' ``param/<router|w_in|w_out>``,
``x`` and ``dy`` (every rank the same) with ``top_k`` and
``capacity_factor``, and the backward of ``sum(out * dy) + aux``; rank 0
writes ``out``, ``aux`` and the gradients averaged over the ranks
(``grad/<name>``, as the train step averages them over ``ep``).

Rank 0 writes ``out`` (an ``.npz``): the losses, grad norms and lr of
every step, the final state gathered whole (``state/<path>``) and the
loaded state gathered whole (``loaded/<path>``). Every rank writes
``out`` with ``.rank<r>.json`` in place of ``.npz``: the shard files it
wrote. Each rank checks that it imported nothing of JAX or ``ray_tpu``.
"""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ray_tpu_torch.models import gpt2, llama, moe  # noqa: E402
from ray_tpu_torch.ops.moe import moe_ffn_ep  # noqa: E402
from ray_tpu_torch.parallel import distributed  # noqa: E402
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from ray_tpu_torch.train import checkpoint  # noqa: E402
from ray_tpu_torch.train.train_step import (make_init_fn,  # noqa: E402
                                            make_train_step, state_shardings)

# The models' settings, fp32 (the test builds the JAX side from them):
# tests/test_torch_train_step.py's tiny fused GPT-2, and Llama at a width
# the JAX side fuses (d_model 256).
GPT2_TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=128,
                 seq_len=64, remat="dots", ce_vocab_chunks=4, fused_norm=True,
                 scan_layers=False)
LLAMA_SMALL = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                   d_model=256, seq_len=64, scan_layers=False, remat="dots",
                   fused_norm=True, use_flash=True)
# MoEConfig.tiny() under dots remat, with a capacity no token overflows
# (top-2 of 4 experts: at most every token at one expert, capacity
# 4 * T / 4 = T), so the expert-parallel path, which takes the capacity
# of this rank's rows, routes as the one-device step does.
MOE_TINY = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2,
                d_model=64, seq_len=64, n_experts=4, top_k=2,
                capacity_factor=4.0, scan_layers=False, remat="dots")
# Each: (config on a mesh, loss, shardings).
MODELS = {
    "gpt2": (lambda mesh: gpt2.GPT2Config(**GPT2_TINY, dtype=torch.float32),
             gpt2.gpt2_loss, gpt2.gpt2_shardings),
    "llama": (lambda mesh: llama.LlamaConfig(**LLAMA_SMALL,
                                             dtype=torch.float32),
              llama.llama_loss, llama.llama_shardings),
    "moe": (lambda mesh: moe.MoEConfig(**MOE_TINY, dtype=torch.float32,
                                       expert_parallel=True, mesh=mesh),
            moe.moe_loss, moe.moe_shardings),
}


def _nest(flat: dict, prefix: str) -> dict:
    """``prefix/a/b`` keys of an npz -> a nested dict of tensors."""
    out: dict = {}
    for key, value in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        node, *path = key[len(prefix) + 1:].split("/")
        path = [node] + path
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = torch.from_numpy(np.array(value))
    return out


def _whole(tree, prefix: str, out: dict) -> None:
    """Every DTensor leaf of ``tree`` gathered whole, into ``out`` under
    ``prefix/<path>`` (inline values as they are)."""
    for path, leaf in checkpoint._flatten(tree):
        key = "/".join((prefix,) + path)
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.full_tensor() if hasattr(leaf, "full_tensor") else leaf
            out[key] = leaf.detach().numpy()
        else:
            out[key] = np.asarray(leaf)


def ffn_ep(mesh, job: dict, out: dict) -> None:
    """``moe_ffn_ep`` forward and backward on the job's inputs; the
    gradients averaged over the ranks."""
    inputs = dict(np.load(job["inputs"]))
    params = {k: v.requires_grad_(True)
              for k, v in _nest(inputs, "param").items()}
    x = torch.from_numpy(inputs["x"]).requires_grad_(True)
    y, aux = moe_ffn_ep(params, x, mesh, top_k=job["top_k"],
                        capacity_factor=job["capacity_factor"])
    (y * torch.from_numpy(inputs["dy"])).sum().add(aux).backward()
    out.update(out=y.detach().numpy(), aux=aux.detach().numpy())
    for name, t in [("x", x), *params.items()]:
        g = t.grad.clone()
        torch.distributed.all_reduce(g)
        out[f"grad/{name}"] = (g / mesh.size()).numpy()


def model_job(mesh, job: dict, out: dict) -> None:
    """The train steps, saves and loads of a model job (see above)."""
    make_cfg, loss, shardings_fn = MODELS[job["model"]]
    cfg = make_cfg(mesh)
    shardings = shardings_fn(cfg, mesh)
    if job.get("inputs"):
        inputs = dict(np.load(job["inputs"]))
        init = _nest(inputs, "param")
        state = make_init_fn(lambda g: init, shardings, mesh)(
            torch.Generator())
        if job.get("save_params"):
            checkpoint.save_sharded(state["params"], job["save_params"])
        step = make_train_step(lambda p, b: loss(p, b, cfg), shardings,
                               mesh)
        batch = {"tokens": torch.from_numpy(inputs["tokens"])}
        losses, norms, lrs = [], [], []
        for _ in range(job["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            lrs.append(m["lr"])
        out.update(losses=np.array(losses), grad_norms=np.array(norms),
                   lrs=np.array(lrs))
        _whole(state, "state", out)
        if job.get("save"):
            checkpoint.save_sharded(state, job["save"])
    if job.get("load"):
        loaded = checkpoint.load_sharded(job["load"],
                                         state_shardings(shardings))
        _whole(loaded, "loaded", out)


def main(rank: int, world: int, address: str, job: dict) -> None:
    torch.set_num_threads(1)
    written = []
    save = checkpoint._atomic_save

    def recording_save(path, arr):
        written.append(Path(path).name)
        save(path, arr)

    checkpoint._atomic_save = recording_save
    distributed.initialize("mesh-test", rank, world, device="cpu",
                           coordinator_address=address, timeout=120.0)
    try:
        mesh = build_mesh(MeshConfig(**job["mesh"]), device="cpu")
        out: dict = {}
        (ffn_ep if job.get("ffn_ep") else model_job)(mesh, job, out)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "ray_tpu"))
        if bad:
            raise AssertionError(f"rank {rank} imported {bad[:5]}")
        if rank == 0:
            np.savez(job["out"], **out)
        Path(job["out"]).with_suffix(f".rank{rank}.json").write_text(
            json.dumps(written))
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
         json.loads(sys.argv[4]))
