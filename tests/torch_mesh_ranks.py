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

A job with ``"sp_ops": true`` runs ring attention (``impl`` ``"fused"``
and ``"dense"``) and Ulysses once over the mesh's ``sp`` axis on this
rank's positions of the inputs' ``q``, ``k`` and ``v`` ([B, T, H, D],
every rank the same), and the backward of the sum of ``out ** 2`` over
the rank's positions; rank 0 writes ``<impl>/<out|dq|dk|dv>``, each
gathered whole along T from the ranks.

A job with ``"sp_steps"`` (a list of ``attention_impl`` values) runs the
model's train steps once for each, from the same inputs, with the model
on the mesh (``cfg.mesh``); rank 0 writes ``<impl>/losses``,
``<impl>/grad_norms`` and ``<impl>/calls``: how many times the model
called ring attention and Ulysses.

A job with ``"runs"`` (a list) runs each entry as a model job of its own
(``model``, ``mesh``, ``inputs``, ``steps``, ``save``) on a mesh of its
own over the same ranks, the model on that mesh (``cfg.mesh``) with the
entry's ``cfg`` settings (``ce_vocab_chunks``, ``attention_impl``); with
``"grads": true`` it records the gradients the step hands the optimizer
at its first step, gathered whole; with ``"forward": true`` it records
the largest difference between the model's forward logits on the mesh
and off it (``cfg.mesh`` None), on the final parameters gathered whole
and the job's tokens. An entry with ``load`` (and no ``inputs``) loads
that checkpoint onto its mesh instead. Rank 0 writes
each entry's results under ``<name>/``.

A job with ``"pp_ops"`` (a list of meshes) runs
``parallel.pipeline.pipeline_value_and_grad`` (1F1B and GPipe, each
``n_micro`` of the job) and ``pipeline_apply`` on each mesh, for the stage
function ``tanh(x @ w + b)`` and an MSE loss, on the inputs'
``pp<n>/w``, ``pp<n>/b``, ``x`` and ``y``; a mesh with ``dp`` above 1
splits each microbatch over ``dp`` (``data_spec``) and averages over it
(``grad_psum_axes``). Rank 0 writes ``<mesh>/<n_micro>_<style>/<loss|w|b>``
and ``<mesh>/apply/<n_micro>``, the gradients gathered whole.

Rank 0 writes ``out`` (an ``.npz``): the losses, grad norms and lr of
every step, the final state gathered whole (``state/<path>``) and the
loaded state gathered whole (``loaded/<path>``). Every rank writes
``out`` with ``.rank<r>.json`` in place of ``.npz``: the shard files it
wrote. Each rank checks that it imported nothing of JAX or ``ray_tpu``.
"""

import collections
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ray_tpu_torch._tree import tree_map  # noqa: E402
from ray_tpu_torch.models import _remat, gpt2, llama, moe  # noqa: E402
from ray_tpu_torch.ops.moe import moe_ffn_ep  # noqa: E402
from ray_tpu_torch.ops.ring_attention import (  # noqa: E402
    ring_causal_attention)
from ray_tpu_torch.ops.ulysses import ulysses_attention  # noqa: E402
from ray_tpu_torch.parallel import distributed  # noqa: E402
from ray_tpu_torch.parallel import pipeline  # noqa: E402
from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh  # noqa: E402
from ray_tpu_torch.parallel.sharding import (NamedSharding,  # noqa: E402
                                             shard_pytree)
from ray_tpu_torch.train import checkpoint, train_step  # noqa: E402
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


def sp_ops(mesh, job: dict, out: dict) -> None:
    """Ring attention and Ulysses forward and backward on this rank's
    positions; every result gathered whole along T."""
    inputs = dict(np.load(job["inputs"]))
    group = mesh.get_group("sp")
    sp, idx = torch.distributed.get_world_size(group), mesh.get_local_rank("sp")
    c = inputs["q"].shape[1] // sp
    bodies = {
        "fused": lambda *a: ring_causal_attention(*a, mesh, impl="fused"),
        "dense": lambda *a: ring_causal_attention(*a, mesh, impl="dense"),
        "ulysses": lambda *a: ulysses_attention(*a, mesh),
    }
    for name, body in bodies.items():
        leaves = [torch.from_numpy(inputs[n][:, idx * c:(idx + 1) * c])
                  .requires_grad_(True) for n in "qkv"]
        o = body(*leaves)
        (o ** 2).sum().backward()
        for key, t in zip(("out", "dq", "dk", "dv"),
                          [o.detach()] + [x.grad for x in leaves]):
            parts = [torch.empty_like(t) for _ in range(sp)]
            torch.distributed.all_gather(parts, t.contiguous(), group=group)
            out[f"{name}/{key}"] = torch.cat(parts, dim=1).numpy()


def sp_steps(mesh, job: dict, out: dict) -> None:
    """The model's train steps for each ``attention_impl`` of the job, the
    model on the mesh, counting its calls of ring attention and Ulysses."""
    make_cfg, loss, shardings_fn = MODELS[job["model"]]
    inputs = dict(np.load(job["inputs"]))
    calls: collections.Counter = collections.Counter()

    def counting(name, fn):
        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapper

    _remat.ring_causal_attention = counting("ring", _remat.ring_causal_attention)
    _remat.ulysses_attention = counting("ulysses", _remat.ulysses_attention)
    batch = {"tokens": torch.from_numpy(inputs["tokens"])}
    for impl in job["sp_steps"]:
        calls.clear()
        cfg = dataclasses.replace(make_cfg(mesh), attention_impl=impl,
                                  mesh=mesh)
        shardings = shardings_fn(cfg, mesh)
        init = _nest(inputs, "param")
        state = make_init_fn(lambda g: init, shardings, mesh)(
            torch.Generator())
        step = make_train_step(lambda p, b: loss(p, b, cfg), shardings,
                               mesh)
        losses, norms = [], []
        for _ in range(job["steps"]):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{impl}/losses"] = np.array(losses)
        out[f"{impl}/grad_norms"] = np.array(norms)
        out[f"{impl}/calls"] = np.array([calls["ring"], calls["ulysses"]])


def model_job(mesh, job: dict, out: dict, prefix: str = "",
              on_mesh: bool = False) -> None:
    """The train steps, saves and loads of a model job (see above); with
    ``on_mesh`` the model runs on ``mesh`` with the job's ``cfg``."""
    make_cfg, loss, shardings_fn = MODELS[job["model"]]
    cfg = make_cfg(mesh)
    if on_mesh:
        cfg = dataclasses.replace(cfg, mesh=mesh, **job.get("cfg", {}))
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
        for i in range(job["steps"]):
            if i == 0 and job.get("grads"):
                _record_grads(out, prefix + "grad")
            try:
                state, m = step(state, batch)
            finally:
                train_step.adamw_update = _ADAMW
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            lrs.append(m["lr"])
        out.update({prefix + "losses": np.array(losses),
                    prefix + "grad_norms": np.array(norms),
                    prefix + "lrs": np.array(lrs)})
        _whole(state, prefix + "state", out)
        if job.get("forward"):
            _forward_gap(state["params"], batch["tokens"], cfg, out,
                         prefix)
        if job.get("save"):
            checkpoint.save_sharded(state, job["save"])
    if job.get("load"):
        loaded = checkpoint.load_sharded(job["load"],
                                         state_shardings(shardings))
        _whole(loaded, prefix + "loaded", out)


_ADAMW = train_step.adamw_update
FORWARDS = {"gpt2": gpt2.gpt2_forward, "llama": llama.llama_forward}


def _forward_gap(params, tokens, cfg, out: dict, prefix: str) -> None:
    """max |forward on cfg.mesh - forward off it| / max |logits|."""
    tree = tree_map(lambda t: t.full_tensor(), params)
    forward = FORWARDS["gpt2" if isinstance(cfg, gpt2.GPT2Config)
                       else "llama"]
    inputs = tokens[:, :-1].long()
    with torch.no_grad():
        got = forward(tree, inputs, cfg)
        want = forward(tree, inputs, dataclasses.replace(cfg, mesh=None))
    out[prefix + "forward_gap"] = np.array(
        float((got - want).abs().max() / want.abs().max()))


def _record_grads(out: dict, prefix: str) -> None:
    """Have the next step's optimizer update record the gradients it is
    handed, gathered whole, under ``prefix/<path>``."""
    def recording(cfg, grads, *args, **kwargs):
        _whole(grads, prefix, out)
        return _ADAMW(cfg, grads, *args, **kwargs)

    train_step.adamw_update = recording


def runs(job: dict, out: dict) -> None:
    """Each entry of ``job["runs"]`` on a mesh of its own (see above)."""
    for run in job["runs"]:
        mesh = build_mesh(MeshConfig(**run["mesh"]), device="cpu")
        model_job(mesh, run, out, run["name"] + "/", on_mesh=True)


def _stage(p, x):
    return torch.tanh(x @ p["w"] + p["b"])


def _mse(o, y):
    return torch.mean((o - y) ** 2)


def pp_ops(job: dict, out: dict) -> None:
    """The pipeline's entry points on each mesh of the job (see above)."""
    inputs = dict(np.load(job["inputs"]))
    x, y = (torch.from_numpy(inputs[k]) for k in "xy")
    for mesh_kw in job["pp_ops"]:
        mesh = build_mesh(MeshConfig(**mesh_kw), device="cpu")
        pp = mesh_kw["pp"]
        tag = "_".join(f"{k}{v}" for k, v in mesh_kw.items() if v > 1)
        spec = NamedSharding(mesh, ("pp", None, None))
        params = shard_pytree(
            {k: torch.from_numpy(inputs[f"pp{pp}/{k}"]) for k in "wb"},
            {"w": spec, "b": NamedSharding(mesh, ("pp", None))}, mesh)
        split = {"data_spec": (None, "dp"), "grad_psum_axes": ("dp",)} \
            if mesh_kw.get("dp", 1) > 1 else {}
        for n in job["n_micro"]:
            for style in ("1f1b", "gpipe"):
                loss, grads = pipeline.pipeline_value_and_grad(
                    params, x, y, mesh, stage_fn=_stage, loss_fn=_mse,
                    n_micro=n, style=style, **split)
                out[f"{tag}/{n}_{style}/loss"] = loss.numpy()
                _whole(grads, f"{tag}/{n}_{style}", out)
            out[f"{tag}/apply/{n}"] = pipeline.pipeline_apply(
                params, x, mesh, stage_fn=_stage, n_micro=n).numpy()


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
        out: dict = {}
        if job.get("runs") or job.get("pp_ops"):
            if job.get("pp_ops"):
                pp_ops(job, out)
            if job.get("runs"):
                runs(job, out)
        else:
            mesh = build_mesh(MeshConfig(**job["mesh"]), device="cpu")
            run = next((fn for key, fn in (("ffn_ep", ffn_ep),
                                            ("sp_ops", sp_ops),
                                            ("sp_steps", sp_steps))
                        if job.get(key)), model_job)
            run(mesh, job, out)
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
