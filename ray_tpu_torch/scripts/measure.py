"""Throughput-measurement harness (port of ``ray_tpu/scripts/measure.py``).

One definition of the timed-step protocol (warmup, a device sync, timed
steps, tok/s and MFU accounting), shared by ``measure_gpt2``,
``measure_llama`` and ``measure_moe`` (MFU against ``_device``'s
per-device peak table), and ``measure_pipeline`` times the pipeline's
training pass; ``measure_trainer_gpt2`` drives ``measure_gpt2``'s
run through the trainer (``CudaTrainer(...).fit()``) with the session's
step anatomy, MFU gauge and sharded checkpoints, on the local backend or
on a cluster's worker processes (its loop, ``trainer_gpt2_loop``, lives
at the top level of this module: it reaches a worker by reference),
through a preemption notice (``preempt_at``) and as an elastic gang
(``min_workers``);
``measure_batch_predict_gpt2`` scores a dataset through
``BatchPredictor`` and ``CudaPredictor`` with ``gpt2_score`` (counted
in the scoring process), on the local backend or on a cluster
(``address``);
``measure_serve`` is their serving counterpart, over ``LLMEngine``, and
``serve_vs_naive`` holds the engine's greedy tokens against the model's
full-forward loop, and ``served_vs_fp32`` the engine's logits at its
served dtype against an fp32 copy of it; ``GPT2Scorer`` is a Serve
deployment class scoring one row a request through ``@serve.batch``
(it lives here, importable, because a cluster sends deployments by
reference), and ``http_post_json`` / ``http_stream_tokens`` are the HTTP
clients that drive Serve's proxy.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

from ray_tpu_torch._device import (device_name, peak_flops_per_chip,
                                   resolve_device)
from ray_tpu_torch.serve import batch as serve_batch

# bench.py's "fused" GPT-2 config (bench.py:67 and :81): flash attention,
# fused norms, dots remat, bf16 logits, chunked CE -- the configuration the
# JAX package benchmarks and the port's main path.
FUSED_FLAGS = dict(remat="dots", scan_layers=False, use_flash=True,
                   logits_dtype=torch.bfloat16, ce_vocab_chunks=3,
                   fused_norm=True)
# The same with dense attention (the first slice's path), kept beside it.
FUSED_DENSE_FLAGS = dict(FUSED_FLAGS, use_flash=False)
# The Llama train step's kernel path: flash attention and the RMSNorm
# kernels under dots remat (LlamaConfig has no logits or CE options).
LLAMA_FLAGS = dict(remat="dots", scan_layers=False, use_flash=True,
                   fused_norm=True)
# The MoE train step: flash attention under dots remat; its norms are the
# plain chain, as in the JAX module, so it takes no fused_norm.
MOE_FLAGS = dict(remat="dots", scan_layers=False, use_flash=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(init_params, loss_fn, vocab_size: int, seq_len: int,
             flops_per_token: float, batch: int, steps: int, warmup: int,
             device: torch.device, mesh=None, shardings=None) -> dict:
    """The timed-step protocol behind ``measure_gpt2``, ``measure_llama``
    and ``measure_moe``.

    Initialises the state from seed 0 (``init_params(generator)``) and a
    fixed batch from seed 1, runs ``warmup`` steps, syncs the device
    (``.item()`` of the loss, then ``torch.cuda.synchronize``), then times
    ``steps`` steps and syncs again. With ``mesh`` the state is sharded by
    ``shardings`` and every rank steps on the same global batch.

    Returns {tok_s, mfu, ms_step, loss, losses, dt, steps, warmup, batch,
    device, mesh, peak_memory_bytes}; ``losses`` holds every step's loss,
    warmup included, ``mfu`` is taken against the device's dense bf16 peak
    times the mesh's size, ``tok_s`` counts the global batch once (its
    rows are shared by the ``sp`` and ``ep`` ranks), and
    ``peak_memory_bytes`` is this rank's ``torch.cuda.max_memory_allocated``
    from before the init (None on the CPU).
    """
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a step on {device}")
    warmup = max(warmup, 1)  # >=1: the post-warmup sync reads metrics
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = make_init_fn(init_params, shardings, mesh)(
        torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(loss_fn, shardings, mesh)
    tokens = torch.randint(
        0, vocab_size, (batch, seq_len + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    batch_data = {"tokens": tokens}
    losses = []
    for _ in range(warmup):
        state, metrics = step_fn(state, batch_data)
        losses.append(metrics["loss"])
    losses[-1].item()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, batch_data)
        losses.append(metrics["loss"])
    loss = metrics["loss"].item()
    _sync(device)
    dt = time.perf_counter() - t0
    tok_s = batch * seq_len * steps / dt
    name = device_name(device)
    n_dev = mesh.size() if mesh is not None else 1
    mfu = tok_s * flops_per_token / (peak_flops_per_chip(name) * n_dev) * 100
    return {
        "tok_s": tok_s,
        "mfu": mfu,
        "ms_step": dt / steps * 1000,
        "loss": loss,
        "losses": [float(x) for x in losses],
        "dt": dt,
        "steps": steps,
        "warmup": warmup,
        "batch": batch,
        "device": name,
        "mesh": (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else None),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


def measure_gpt2(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                 device=None, mesh=None) -> dict:  # step-timed
    """Timed GPT-2 train-step loop -> measurement dict (see ``_measure``);
    with ``mesh`` the step is sharded by ``gpt2_shardings`` and the model
    runs on that mesh (ring or Ulysses attention over its ``sp`` axis
    where ``cfg.attention_impl`` says so)."""
    from ray_tpu_torch.models.gpt2 import (
        gpt2_flops_per_token,
        gpt2_init,
        gpt2_loss,
        gpt2_shardings,
    )

    device = resolve_device(device)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    return _measure(lambda g: gpt2_init(g, cfg, device=device),
                    lambda p, b: gpt2_loss(p, b, cfg), cfg.vocab_size,
                    cfg.seq_len, gpt2_flops_per_token(cfg), batch, steps,
                    warmup, device, mesh,
                    gpt2_shardings(cfg, mesh) if mesh is not None else None)


def measure_llama(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                  device=None, mesh=None) -> dict:  # step-timed
    """Timed Llama train-step loop -> measurement dict (see ``_measure``);
    MFU from ``llama_flops_per_token``; with ``mesh`` the step is sharded
    by ``llama_shardings`` and the model runs on that mesh, as in
    ``measure_gpt2``."""
    from ray_tpu_torch.models.llama import (
        llama_flops_per_token,
        llama_init,
        llama_loss,
        llama_shardings,
    )

    device = resolve_device(device)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    return _measure(lambda g: llama_init(g, cfg, device=device),
                    lambda p, b: llama_loss(p, b, cfg), cfg.vocab_size,
                    cfg.seq_len, llama_flops_per_token(cfg), batch, steps,
                    warmup, device, mesh,
                    llama_shardings(cfg, mesh) if mesh is not None else None)


def measure_moe(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                device=None, mesh=None) -> dict:  # step-timed
    """Timed MoE train-step loop -> measurement dict (see ``_measure``);
    MFU from ``moe_flops_per_token`` (the active parameters); with
    ``mesh`` the step is sharded by ``moe_shardings`` and the model runs
    on that mesh (the all_to_all path where ``cfg.expert_parallel``)."""
    from ray_tpu_torch.models.moe import (
        moe_flops_per_token,
        moe_init,
        moe_loss,
        moe_shardings,
    )

    device = resolve_device(device)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    return _measure(lambda g: moe_init(g, cfg, device=device),
                    lambda p, b: moe_loss(p, b, cfg), cfg.vocab_size,
                    cfg.seq_len, moe_flops_per_token(cfg), batch, steps,
                    warmup, device, mesh,
                    moe_shardings(cfg, mesh) if mesh is not None else None)


def measure_pipeline(stage_params, x, y, mesh, *, stage_fn, loss_fn,
                     n_micro: int, style: str, steps: int = 3,
                     warmup: int = 1, device=None) -> dict:  # step-timed
    """Timed ``pipeline_value_and_grad`` calls (``warmup`` untimed, then
    ``steps`` timed, each call synced through its loss) -> {ms (a call,
    on the host clock), loss, grads (the last call's), ticks, bubble_frac
    (1 - n_micro / ticks, the idle slots of the timetable), style,
    n_micro, peak_memory_bytes (``max_memory_allocated`` from before the
    warmup; None on the CPU)}. ``mesh=None`` runs every stage in this
    process."""
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.parallel.pipeline import (build_1f1b_schedule,
                                                 pipeline_value_and_grad)

    device = resolve_device(device)
    pp = (mesh.size(mesh.mesh_dim_names.index("pp")) if mesh is not None
          else tree_leaves(stage_params)[0].shape[0])
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    def call():
        loss, grads = pipeline_value_and_grad(
            stage_params, x, y, mesh, stage_fn=stage_fn, loss_fn=loss_fn,
            n_micro=n_micro, style=style)
        loss.item()
        return loss, grads

    for _ in range(warmup):
        call()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        loss, grads = call()
    _sync(device)
    ticks = len(build_1f1b_schedule(n_micro, pp, style)[0])
    return {"ms": (time.perf_counter() - t0) / steps * 1e3,
            "loss": float(loss), "grads": grads, "ticks": ticks,
            "bubble_frac": 1 - n_micro / ticks, "style": style,
            "n_micro": n_micro, "pp": pp,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else None)}


# The nine kernels' launch counters, in a fixed order (a column of
# ``gpt2_score_counted``).
KERNELS = ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd", "rms_fwd", "rms_bwd",
           "flash_fwd", "flash_dkv", "flash_dq")


# Each kernel's ``__global__`` names (``ops/csrc/*.cu``), as a
# torch.profiler trace names its device events: the norm kernels' one-warp
# body and the multi-warp body past it.
KERNEL_GLOBALS = {
    "ln_fwd": ("ln_fwd_kernel", "ln_fwd_wide_kernel"),
    "ln_bwd": ("ln_bwd_kernel", "ln_bwd_wide_kernel"),
    "gelu_fwd": ("gelu_fwd_kernel",),
    "gelu_bwd": ("gelu_bwd_kernel",),
    "rms_fwd": ("rms_fwd_kernel", "rms_fwd_wide_kernel"),
    "rms_bwd": ("rms_bwd_kernel", "rms_bwd_wide_kernel"),
    "flash_fwd": ("flash_fwd_kernel",),
    "flash_dkv": ("flash_dkv_kernel",),
    "flash_dq": ("flash_dq_kernel",),
}


def kernel_event_counts(trace: dict) -> dict:
    """The device events (category ``kernel``) of a torch.profiler Chrome
    trace, counted by port kernel: an event counts for a kernel when its
    demangled name holds one of the kernel's ``__global__`` names as a
    whole identifier."""
    import re

    pats = {k: re.compile(r"(?<![A-Za-z0-9_])(" + "|".join(names)
                          + r")(?![A-Za-z0-9_])")
            for k, names in KERNEL_GLOBALS.items()}
    counts = dict.fromkeys(KERNEL_GLOBALS, 0)
    events = trace.get("traceEvents", []) if isinstance(trace, dict) \
        else trace  # a bare event list (the stack sampler's)
    for e in events:
        if e.get("cat") != "kernel":
            continue
        for k, pat in pats.items():
            if pat.search(e.get("name", "")):
                counts[k] += 1
    return counts


def _zero_launches() -> None:
    from ray_tpu_torch.ops import flash_attention, fused_norm

    fused_norm.KERNEL_INVOCATIONS.clear()
    flash_attention.KERNEL_INVOCATIONS.clear()


def _launches() -> dict:
    from ray_tpu_torch.ops import flash_attention, fused_norm

    return {**fused_norm.KERNEL_INVOCATIONS,
            **flash_attention.KERNEL_INVOCATIONS}


def as_tokens(batch: dict) -> dict:
    """A ``map_batches`` function: ``from_numpy``'s ``data`` column as the
    train step's ``tokens`` (at the top level: it reaches a cluster's
    workers by reference)."""
    return {"tokens": batch["data"]}


class _BatchFeed:
    """``trainer_gpt2_loop``'s batches from its dataset shard:
    ``iter_device_batches(batch_size=batch)`` on the loop's device, timed
    from outside the iterator (the client side of the stall fraction:
    seconds inside ``next()`` over the loop's wall since the first
    ``next()``), with this process's ``ray_tpu_data_iter_seconds`` read
    before and after (the iterator's own account of the same loop). A
    restart at step ``start`` skips the batches its steps consumed."""

    def __init__(self, shard, batch: int, device, start: int):
        from ray_tpu_torch.util import metrics

        self._before = metrics.parse_prometheus(metrics.prometheus_text())
        self._it = iter(shard.iter_device_batches(batch_size=batch,
                                                  device=device))
        self.wait_s, self.batches, self._t0 = 0.0, 0, None
        self.devices = set()
        for _ in range(start):
            next(self._it)

    def next(self) -> dict:
        t = time.perf_counter()
        if self._t0 is None:
            self._t0 = t
        out = next(self._it)
        self.wait_s += time.perf_counter() - t
        self.batches += 1
        self.devices |= {(str(v.device), str(v.dtype)) for v in out.values()}
        return out

    def summary(self) -> dict:
        """{batches, client_wait_s, loop_wall_s, client_stall, devices,
        iter: {wait, user, transfer: {count, sum_s}}, server_stall}."""
        from ray_tpu_torch.util import metrics as m
        from ray_tpu_torch.util.goodput import stall_fraction_from

        wall = time.perf_counter() - self._t0
        delta = m.diff_parsed(self._before,
                              m.parse_prometheus(m.prometheus_text()))
        phases = {}
        for phase in ("wait", "user", "transfer"):
            d = m.histogram_dist(delta, "ray_tpu_data_iter_seconds",
                                 phase=phase)
            phases[phase] = ({"count": int(d["count"]), "sum_s": d["sum"]}
                             if d else {"count": 0, "sum_s": 0.0})
        return {"batches": self.batches, "client_wait_s": self.wait_s,
                "loop_wall_s": wall, "client_stall": self.wait_s / wall,
                "devices": sorted(self.devices), "iter": phases,
                "server_stall": stall_fraction_from(delta)}


def _process_start_wall() -> float | None:
    """The wall time this process started, from Linux's ``/proc`` (its
    start in clock ticks since boot against the uptime); None where
    ``/proc`` does not have it."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        return None
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def ms_per_step(reports, keep=lambda r: True) -> float | None:
    """Mean interval between consecutive reports (``trainer_gpt2_loop``'s)
    of one worker process, less the checkpoint save inside it, over the
    reports ``keep`` admits, in ms; None without such a pair. The first
    report of each process has no interval: it is not a step's."""
    gaps = [b["t"] - a["t"] - a["save_s"]
            for a, b in zip(reports, reports[1:])
            if keep(a) and keep(b) and a["pid"] == b["pid"]
            and b["step"] == a["step"] + 1]
    return sum(gaps) / len(gaps) * 1000 if gaps else None


def _node_id() -> str:
    """The cluster node this process runs on ("local" on the local
    backend)."""
    from ray_tpu_torch._private import worker as worker_mod

    return getattr(worker_mod.backend(), "node_id", "local")


def trainer_gpt2_loop(config: dict) -> None:
    """``measure_trainer_gpt2``'s loop, one rank of it. ``config``: cfg
    (a ``GPT2Config``), batch, steps, fail_at, ckpt_root, preempt_at,
    preempt_file, progress_path, and ``lr``, AdamW's learning rate (3e-4,
    ``AdamWConfig``'s, unless given).

    Zeroes this process's kernel counters, builds the state and the batch
    as ``_measure`` does (seed 0, seed 1; with a ``"train"`` dataset shard
    in the session, each step's batch instead comes from
    ``shard.iter_device_batches(batch_size=batch)``, through
    ``_BatchFeed``, and step_cost's call takes the first step's batch) --
    over ``build_mesh(MeshConfig(fsdp=-1))`` with ``gpt2_shardings`` when
    the world has more than one rank, unsharded otherwise -- attaches
    ``session.set_step_cost(step_cost(...))`` (one more call of the step,
    on copies), then runs
    each step through ``session.timed_step``. Every ``ckpt_every``-th
    step (default 2; 0: never) every rank ``save_sharded``s the state
    into ``ckpt_root/step<n>`` and the report carries a checkpoint naming
    that directory (a restart
    ``load_sharded``s it, resharding onto this attempt's world). Each
    step's report: {loss, step, t (after the step, before the save), wall
    (``time.time()`` there), save_s, anatomy, node, pid, world}; the
    first also step_cost's flops, flops_by_op and device_kind, and
    ``startup``: the wall times this process started (None without
    ``/proc``), those of ``session.get_startup()`` (the worker actor
    constructed, its group joined, its loop called), the loop's entry,
    and those by which the device was ready (CUDA's context), the state
    built or loaded and step_cost's call done (each after a device
    sync). With
    ``preempt_at`` k, rank 0 of the first attempt appends its node's id
    to ``preempt_file`` (the cluster's ``preemption_signal_file``) right
    after step k's report -- its checkpoint complete and in the queue --
    and trains on. With ``progress_path``, rank 0 appends a JSON line {step,
    world, node, wall, worker_id} there after each report (what a
    driver-side thread can watch while ``fit`` runs; ``worker_id`` is the
    cluster worker process's id, None on the local backend). With
    ``print_loss``, rank 0 prints ``step <n> loss <repr>`` to stdout after
    each report (what a cluster captures in the worker's log). ``anatomy`` is the previous
    step's MFU and phases as this rank's gauges read them after its
    report (the session sets them in ``report``; live only: ``fit``
    retracts them), None after a start. A last report, {final, anatomy,
    launches, data, peak_memory_bytes}, carries the last step's, this
    process's kernel launches, the feed's ``_BatchFeed.summary()`` (None
    without a dataset) and its peak device memory. With ``fail_at`` the
    first attempt raises before step ``fail_at`` (counted from 1)."""
    import torch.distributed as dist

    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss, gpt2_shardings
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import (Checkpoint, load_sharded,
                                                save_sharded)
    from ray_tpu_torch.train.optim import AdamWConfig
    from ray_tpu_torch.train.train_step import (make_init_fn,
                                                make_train_step,
                                                state_shardings)
    from ray_tpu_torch.util import metrics as _metrics
    from ray_tpu_torch.util.xla_cost import step_cost

    cfg, batch, steps = config["cfg"], config["batch"], config["steps"]
    startup = {"process": _process_start_wall(), **session.get_startup(),
               "loop": time.time()}
    _zero_launches()
    dev = session.get_device()

    def mark(name: str) -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        startup[name] = time.time()

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    mark("device")
    mesh = shardings = None
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = build_mesh(MeshConfig(fsdp=-1), device=dev.type)
        shardings = gpt2_shardings(cfg, mesh)
    step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), shardings,
                              mesh, optimizer=AdamWConfig(
                                  lr=config.get("lr", 3e-4)))
    ckpt = session.get_checkpoint()
    if ckpt is None:
        state = make_init_fn(lambda g: gpt2_init(g, cfg, device=dev),
                             shardings, mesh)(
            torch.Generator(device=dev).manual_seed(0))
    elif mesh is not None:
        state = load_sharded(ckpt.to_dict()["sharded"],
                             state_shardings(shardings))
    else:
        from ray_tpu_torch._tree import tree_map

        state = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                         else x, load_sharded(ckpt.to_dict()["sharded"]))
    start = int(state["step"])
    mark("state")
    shard = session.get_dataset_shard("train")
    feed = _BatchFeed(shard, batch, dev, start) if shard is not None else None
    if feed is not None:
        batch_data = feed.next()
    else:
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, cfg.seq_len + 1), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        batch_data = {"tokens": tokens}
    cost = step_cost(step_fn, state, batch_data)
    session.set_step_cost(cost)
    mark("step_cost")
    rank = str(session.get_world_rank())
    tags = {"node_id": "local", "trial": "train", "rank": rank}
    first, anatomy = True, None
    node, world = _node_id(), session.get_world_size()
    for i in range(start, steps):
        if config.get("fail_at") is not None and i + 1 == config["fail_at"] \
                and ckpt is None:
            raise RuntimeError(f"injected failure before step "
                               f"{config['fail_at']}")
        if feed is not None and i > start:
            batch_data = feed.next()
        state, metrics = session.timed_step(step_fn, state, batch_data)
        done = i + 1
        report = {"loss": float(metrics["loss"]), "step": done,
                  "t": time.perf_counter(), "wall": time.time(),
                  "save_s": 0.0, "anatomy": anatomy, "node": node,
                  "pid": os.getpid(), "world": world}
        keep = None
        every = config.get("ckpt_every", 2)
        if every and done % every == 0:
            path = os.path.join(config["ckpt_root"], f"step{done}")
            t0 = time.perf_counter()
            save_sharded(state, path)
            report["save_s"] = time.perf_counter() - t0
            keep = Checkpoint.from_dict({"sharded": path})
        if first:
            report.update(flops=cost["flops"],
                          flops_by_op=cost["flops_by_op"],
                          device_kind=cost["device_kind"], startup=startup)
            first = False
        session.report(report, checkpoint=keep)
        if rank == "0" and config.get("print_loss"):
            print(f"step {done} loss {report['loss']!r}", flush=True)
        if rank == "0" and config.get("progress_path"):
            with open(config["progress_path"], "a") as f:
                f.write(json.dumps({
                    "step": done, "world": world, "node": node,
                    "wall": report["wall"],
                    "worker_id": os.environ.get("RAY_TPU_TORCH_WORKER_ID")})
                    + "\n")
        if rank == "0" and done == config.get("preempt_at") \
                and ckpt is None:
            # The preemption notice, as a cloud's metadata server gives
            # it: the node's agent polls the file and self-drains.
            with open(config["preempt_file"], "a") as f:
                f.write(node + "\n")
        anatomy = {"step": done, "mfu": _metrics.TRAIN_MFU_PERCENT.get(tags),
                   **{ph: _metrics.TRAIN_STEP_ANATOMY_SECONDS.get(
                       {**tags, "phase": ph})
                      for ph in ("data_wait", "host", "compute", "sync")}}
    session.report({
        "final": True, "anatomy": anatomy, "launches": _launches(),
        "data": feed.summary() if feed is not None else None,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                              if dev.type == "cuda" else None)})


def measure_trainer_gpt2(cfg, batch: int, *, steps: int = 6,
                         warmup: int = 2, fail_at: int | None = None,
                         device=None, address: str | None = None,
                         num_workers: int = 1,
                         ckpt_dir: str | None = None,
                         dataset=None, preempt_at: int | None = None,
                         min_workers: int | None = None,
                         placement_strategy: str = "PACK",
                         progress_path: str | None = None,
                         print_loss: bool = False,
                         stay_connected: bool = False,
                         ckpt_every: int = 2) -> dict:
    """``measure_gpt2``'s run, ``steps`` steps in all, through the trainer:
    ``CudaTrainer(trainer_gpt2_loop, ScalingConfig(num_workers=...)).fit()``.

    Without ``address`` on the local backend, the loop on the worker's
    thread. With ``address`` (a head's) on that cluster: the driver
    connects (``ray_tpu_torch.init(address=...)``, disconnecting after),
    each rank is a worker process on ``cuda:{local_rank}``, and with
    ``num_workers`` N > 1 the ranks form one NCCL group and shard the step
    at ``fsdp=N`` (PR 9's sharded step; each rank the whole batch). With
    ``fail_at`` the first attempt raises before step ``fail_at`` and the
    restart resumes from the latest checkpoint
    (``FailureConfig(max_failures=1)``). Checkpoints (``save_sharded``,
    every second step) go under ``ckpt_dir`` (a temporary directory,
    removed after, when not given). With ``dataset`` (a
    ``ray_tpu_torch.data.Dataset`` of ``{"tokens": [rows, seq_len + 1]}``
    batches) the trainer splits it over its workers
    (``datasets={"train": dataset}``) and each step reads its batch from
    the rank's shard.

    Surviving a node's loss (on a cluster, ``address``): with
    ``preempt_at`` k, rank 0 of the first attempt writes its node's id
    into the cluster's ``preemption_signal_file`` (``core/config.py``; it
    must be set) right after step k's checkpoint and trains on; the
    node's agent self-drains and the trainer restarts from step k on
    another node. ``min_workers`` makes the gang elastic
    (``ScalingConfig(min_workers=...)``, one placement group for the
    whole fit, ``placement_strategy`` its strategy). ``progress_path``:
    rank 0 appends a line a step there (see ``trainer_gpt2_loop``);
    ``print_loss``: rank 0 prints each step's loss. ``stay_connected``
    leaves the driver connected to ``address`` after the fit (the caller
    disconnects). ``ckpt_every``: the checkpoint period in steps (0:
    none; GPT-2 small's state is 1.39 GiB a save).

    When the trainer's ``Result`` holds an error, raises
    ``RuntimeError("the trainer failed")`` from it, with the partial run
    as its ``run`` (reports, losses, steps_run, goodput, wall_s, device,
    num_workers, ckpt_dir, final_pg_state, drains_seen, restart_history
    and notice_wall).
    Returns {reports (rank 0's step reports, in report order: step, loss,
    node, pid, world, wall, t, save_s, startup), losses (rank 0's, one a
    reported step, in report order), steps_run, ms_step (``ms_per_step``
    over the steps from ``warmup``: the mean interval between consecutive
    reports of one worker process, less the checkpoint saves inside it;
    each interval holds a step, its device sync and its report), tok_s
    (the global batch), mfu_gauge (mean of rank 0's gauge over those steps),
    step_cost (flops, flops_by_op, device_kind), analytic_flops
    (``gpt2_flops_per_token`` x tokens), flops_ratio, anatomy (per step:
    the gauges' phases and MFU), save_s, restarts, goodput, wall_s (the
    whole ``fit``), device, peak_memory_bytes and launches (rank 0's
    process, its last attempt: the kernels its loop launched, step_cost's
    call included), data (rank 0's ``_BatchFeed.summary()``, None without
    ``dataset``), num_workers, ckpt_dir, final_pg_state (the elastic
    gang's placement group at the end), drains_seen ({node id: the wall
    time the trainer's drain watcher saw it DRAINING}), restart_history
    (the trainer's: a restart's wall time, exception, rule, cause and
    exemption), notice_wall (the wall time the notice was written: the
    signal file's mtime; None without ``preempt_at``)}."""
    import ray_tpu_torch
    from ray_tpu_torch.models.gpt2 import gpt2_flops_per_token
    from ray_tpu_torch.train.config import (FailureConfig, RunConfig,
                                            ScalingConfig)
    from ray_tpu_torch.train.trainer import CudaTrainer

    from ray_tpu_torch.core.config import config as rt_config

    device = resolve_device(device)
    preempt_file = rt_config.preemption_signal_file
    if preempt_at is not None and not (address and preempt_file):
        raise ValueError("preempt_at needs a cluster (address) whose "
                         "preemption_signal_file is set")
    own_dir = ckpt_dir is None
    ckpt_root = ckpt_dir or tempfile.mkdtemp(prefix="rtt_trainer_ckpt_")
    if address is not None:
        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(address=address)
    try:
        t0 = time.perf_counter()
        trainer = CudaTrainer(
            trainer_gpt2_loop,
            train_loop_config={"cfg": cfg, "batch": batch, "steps": steps,
                               "fail_at": fail_at, "ckpt_root": ckpt_root,
                               "preempt_at": preempt_at,
                               "preempt_file": preempt_file,
                               "progress_path": progress_path,
                               "print_loss": print_loss,
                               "ckpt_every": ckpt_every},
            scaling_config=ScalingConfig(
                num_workers=num_workers, min_workers=min_workers,
                placement_strategy=placement_strategy),
            run_config=RunConfig(failure_config=FailureConfig(
                max_failures=1 if fail_at is not None else 0)),
            datasets={"train": dataset} if dataset is not None else None,
            device=device)
        result = trainer.fit()
        wall = time.perf_counter() - t0
    finally:
        if address is not None and not stay_connected:
            ray_tpu_torch.shutdown()
        if own_dir:
            shutil.rmtree(ckpt_root, ignore_errors=True)
    hist = [m for m in result.metrics_history if "step" in m]
    reports = [{k: m.get(k) for k in ("step", "loss", "node", "pid", "world",
                                      "wall", "t", "save_s", "startup")}
               for m in hist]
    out = {
        "reports": reports,
        "losses": [m["loss"] for m in hist],
        "steps_run": [m["step"] for m in hist],
        "goodput": result.goodput,
        "wall_s": wall,
        "device": device_name(device),
        "num_workers": num_workers,
        "ckpt_dir": None if own_dir else ckpt_root,
        "final_pg_state": trainer.final_pg_state,
        "drains_seen": dict(trainer.drains_seen),
        "restart_history": list(trainer.restart_history),
        "notice_wall": (os.stat(preempt_file).st_mtime
                        if preempt_at is not None
                        and os.path.exists(preempt_file) else None),
    }
    if result.error is not None:
        exc = RuntimeError("the trainer failed")
        exc.run = out
        raise exc from result.error
    dt = ms_per_step([r for r in reports if r["step"] >= warmup]) / 1000
    anatomy = [m["anatomy"] for m in result.metrics_history
               if m.get("anatomy")]
    mfus = [a["mfu"] for a in anatomy if a["step"] > warmup]
    analytic = gpt2_flops_per_token(cfg) * batch * cfg.seq_len
    cost = next(m for m in hist if "flops" in m)
    last = result.metrics_history[-1]
    return {
        **out,
        "ms_step": dt * 1000,
        "tok_s": batch * cfg.seq_len / dt,
        "mfu_gauge": statistics.fmean(mfus),
        "step_cost": {k: cost[k] for k in ("flops", "flops_by_op",
                                           "device_kind")},
        "analytic_flops": analytic,
        "flops_ratio": cost["flops"] / analytic,
        "anatomy": anatomy,
        "save_s": [m["save_s"] for m in hist if m["save_s"]],
        "restarts": result.goodput["restarts"],
        "peak_memory_bytes": last["peak_memory_bytes"],
        "launches": last["launches"],
        "data": last["data"],
    }


# -- Tune: trials of GPT-2 training ---------------------------------------------

# Steps each trial of ``tune_gpt2_trial`` started and finished in this
# process, by trial id (a started step is counted before its first launch,
# a finished one after its loss is read), under ``_TUNE_CV``.
_TUNE_STEPS = {"started": {}, "done": {}}
_TUNE_CV = threading.Condition()


def _tune_count(kind: str, trial: str) -> int:
    with _TUNE_CV:
        n = _TUNE_STEPS[kind][trial] = _TUNE_STEPS[kind].get(trial, 0) + 1
        _TUNE_CV.notify_all()
    return n


def tune_gpt2_trial(config: dict) -> None:
    """A Tune trainable: ``measure_gpt2``'s GPT-2 run at ``config["lr"]``.
    ``config``: cfg (a ``GPT2Config``), batch, steps, lr, and optionally
    ckpt_every (steps; 0 or absent: no checkpoint), ckpt_root, params (a
    numpy parameter tree, ``models/convert.py``, in place of the seed-0
    init) and tokens (a numpy [batch, seq_len + 1] batch in place of the
    seed-1 one).

    Builds the state and the batch as ``_measure`` does (seed 0, seed 1)
    on the session's device, or, from ``tune.get_checkpoint()``,
    ``load_sharded``s the state the checkpoint names and goes on from its
    step. Runs ``make_train_step`` at ``AdamWConfig(lr=lr)`` and
    ``tune.report``s each step: {loss (a float), step and
    training_iteration (the step, counted from the run's start across
    restores), lr, t (``perf_counter`` after the step), wall, entry (the
    wall time this attempt began), load_s (the restore, on the first
    report of an attempt), save_s}. Every ``ckpt_every``-th step it
    ``save_sharded``s the state into ``ckpt_root/<trial>/step<n>`` and the
    report carries ``Checkpoint.from_dict({"sharded": path})``. Each step
    it starts and finishes is counted in ``_TUNE_STEPS`` (a step a stop
    cut short counts as started: the stop lands at the report after it)."""
    from ray_tpu_torch import tune
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import (Checkpoint, load_sharded,
                                                save_sharded)
    from ray_tpu_torch.train.optim import AdamWConfig
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    entry = time.time()
    dev = session.get_device()
    trial = tune.get_trial_id()
    cfg, batch, steps = config["cfg"], config["batch"], config["steps"]
    step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg),
                              optimizer=AdamWConfig(lr=config["lr"]))
    ckpt = tune.get_checkpoint()
    load_s = 0.0
    if ckpt is None:
        params = config.get("params")
        init = (gpt2_init if params is None else
                lambda g, c, device: params_from_numpy(params, device))
        state = make_init_fn(lambda g: init(g, cfg, device=dev))(
            torch.Generator(device=dev).manual_seed(0))
    else:
        t0 = time.perf_counter()
        state = tree_map(lambda x: x.to(dev) if isinstance(x, torch.Tensor)
                         else x, load_sharded(ckpt.to_dict()["sharded"]))
        _sync(dev)
        load_s = time.perf_counter() - t0
    if config.get("tokens") is not None:
        tokens = torch.from_numpy(np.asarray(config["tokens"])).to(dev)
    else:
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, cfg.seq_len + 1), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
    every = config.get("ckpt_every") or 0
    for i in range(int(state["step"]), steps):
        _tune_count("started", trial)
        state, metrics = step_fn(state, {"tokens": tokens})
        loss = float(metrics["loss"])
        _tune_count("done", trial)
        done = i + 1
        report = {"loss": loss, "step": done, "training_iteration": done,
                  "lr": config["lr"], "t": time.perf_counter(),
                  "wall": time.time(), "entry": entry, "load_s": load_s,
                  "save_s": 0.0}
        load_s = 0.0
        keep = None
        if every and done % every == 0:
            path = os.path.join(config["ckpt_root"], trial, f"step{done}")
            t0 = time.perf_counter()
            save_sharded(state, path)
            report["save_s"] = time.perf_counter() - t0
            keep = Checkpoint.from_dict({"sharded": path})
        tune.report(report, checkpoint=keep)


def _recording(cls):
    """``cls`` (a Tune scheduler) that records each result it is given,
    in order of arrival, with its decision, the wall time, and whether
    the trial was sent back to PENDING (a PBT exploit: then the values
    it took for the mutated keys, and the checkpoint). The runner is not
    changed."""

    class Recording(cls):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.log = []

        def on_trial_result(self, runner, trial, result):
            t = time.time()
            decision = super().on_trial_result(runner, trial, result)
            rec = {"trial": trial.trial_id, "result": dict(result),
                   "decision": decision, "wall": t, "decided": time.time()}
            if trial.status == "PENDING":
                rec["exploit"] = {
                    "config": {k: trial.config.get(k)
                               for k in getattr(self, "mutations", {})},
                    "checkpoint": (trial.checkpoint.to_dict()
                                   if trial.checkpoint is not None else None)}
            self.log.append(rec)
            return decision

    return Recording


class _TrialStub:
    def __init__(self, trial_id: str):
        self.trial_id = trial_id


def replay_decisions(scheduler, log) -> list:
    """The decisions ``scheduler`` (a fresh one) makes on ``log``'s
    results in ``log``'s order, one a record."""
    return [scheduler.on_trial_result(None, _TrialStub(r["trial"]),
                                      r["result"]) for r in log]


def _dir_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(root, f))
               for root, _dirs, files in os.walk(path) for f in files)


def measure_tune_gpt2(cfg, batch: int, *, lrs, scheduler: str = "asha",
                      steps: int = 6, max_concurrent: int = 2,
                      resources=None, ckpt_every: int = 0,
                      params=None, tokens=None, grace_period: int = 2,
                      reduction_factor: int = 2,
                      perturbation_interval: int = 2,
                      mutations=None, seed: int = 0) -> dict:
    """GPT-2 trials through ``Tuner.fit`` on the local backend:
    ``tune.with_resources(tune_gpt2_trial, resources)`` (default
    ``{"GPU": 0.5}``: two trials share one card, each from its own actor
    thread) over ``grid_search(lrs)``, metric ``loss``, mode ``min``,
    ``max_concurrent`` trials at once.

    ``scheduler="asha"``: ``ASHAScheduler(max_t=steps, grace_period,
    reduction_factor)``. ``"pbt"``: ``PopulationBasedTraining(
    perturbation_interval, hyperparam_mutations=mutations, seed)``, a
    checkpoint every ``ckpt_every`` steps; each exploit's first two steps
    are recomputed here from the donor's checkpoint at the exploit's lr
    (``exploits[i]["recomputed"]``), before the checkpoints' directory is
    removed. Either scheduler records what it is given (``_recording``);
    ``replay`` is a fresh scheduler's decisions on that record.

    This process's kernel counters are set to 0 before the fit and read
    after every trial's last started step has finished (the runner stops
    a trial at its next report, so a step it started runs to its end).
    Returns {trials (per trial: lr, status, error, losses, steps (the
    reported steps, in order), steps_started, first_report_s (from its
    attempt's entry), ms_step (the mean interval between consecutive
    reports of one attempt, less saves), load_s, save_s, attempts), log,
    decisions, replay, best ({lr, loss, step}), launches, steps_started,
    wall_s, peak_memory_bytes (this process's, all trials), decide_ms (a
    report's wall time to its decision), exploits, ckpt_bytes,
    dirs_left}."""
    import ray_tpu_torch
    from ray_tpu_torch import tune

    resources = dict(resources or {"GPU": 0.5})
    device = torch.device("cuda" if resources.get("GPU") else "cpu")
    if device.type == "cuda":
        resolve_device(device)  # raises without CUDA
        torch.cuda.reset_peak_memory_stats(device)
    root = tempfile.mkdtemp(prefix="rtt_tune_ckpt_")
    if scheduler == "asha":
        sched = _recording(tune.ASHAScheduler)(
            metric="loss", mode="min", max_t=steps, grace_period=grace_period,
            reduction_factor=reduction_factor)
        fresh = tune.ASHAScheduler(
            metric="loss", mode="min", max_t=steps, grace_period=grace_period,
            reduction_factor=reduction_factor)
    elif scheduler == "pbt":
        kw = dict(metric="loss", mode="min",
                  perturbation_interval=perturbation_interval,
                  hyperparam_mutations=mutations, seed=seed)
        sched = _recording(tune.PopulationBasedTraining)(**kw)
        fresh = None  # PBT's decisions act on the runner: not replayed
    else:
        raise ValueError(f"scheduler must be 'asha' or 'pbt': {scheduler!r}")
    with _TUNE_CV:
        for counts in _TUNE_STEPS.values():
            counts.clear()
    _zero_launches()
    ray_tpu_torch.init()
    try:
        t0 = time.perf_counter()
        grid = tune.Tuner(
            tune.with_resources(tune_gpt2_trial, resources),
            param_space={"lr": tune.grid_search(list(lrs)), "cfg": cfg,
                         "batch": batch, "steps": steps,
                         "ckpt_every": ckpt_every, "ckpt_root": root,
                         "params": params, "tokens": tokens},
            tune_config=tune.TuneConfig(
                metric="loss", mode="min", scheduler=sched,
                max_concurrent_trials=max_concurrent)).fit()
        wall = time.perf_counter() - t0
        with _TUNE_CV:
            settled = _TUNE_CV.wait_for(
                lambda: _TUNE_STEPS["started"] == _TUNE_STEPS["done"],
                timeout=300)
            started = dict(_TUNE_STEPS["started"])
        if not settled:
            raise RuntimeError(f"trial steps still running: {_TUNE_STEPS}")
        _sync(device)
        launches = _launches()
        exploits = [dict(r["exploit"], trial=r["trial"], wall=r["decided"],
                         step=r["result"]["step"])
                    for r in sched.log if "exploit" in r]
        for ex in exploits:
            ex["recomputed"] = _recompute_steps(
                cfg, batch, ex["checkpoint"]["sharded"], ex["config"]["lr"],
                device, tokens, 2) if ex["checkpoint"] else None
        ckpt_bytes = {d: _dir_bytes(os.path.join(root, d))
                      for d in sorted(os.listdir(root))}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    trials = []
    for r in grid:
        hist = r.metrics_history
        attempts = []
        for m in hist:
            if not attempts or attempts[-1][0]["entry"] != m["entry"]:
                attempts.append([])
            attempts[-1].append(m)
        gaps = [b["t"] - a["t"] - a["save_s"]
                for att in attempts for a, b in zip(att, att[1:])]
        trials.append({
            "trial_id": r.trial_id, "lr": r.config["lr"],
            "error": repr(r.error) if r.error is not None else None,
            "losses": [m["loss"] for m in hist],
            "steps": [m["step"] for m in hist],
            "steps_started": started.get(r.trial_id, 0),
            "first_report_s": hist[0]["wall"] - hist[0]["entry"]
            if hist else None,
            "ms_step": sum(gaps) / len(gaps) * 1000 if gaps else None,
            "load_s": [m["load_s"] for m in hist if m["load_s"]],
            "save_s": [m["save_s"] for m in hist if m["save_s"]],
            "attempts": [[m["step"] for m in att] for att in attempts],
            "attempt_losses": [[m["loss"] for m in att] for att in attempts]})
    best = grid.get_best_result()
    return {
        "trials": trials, "log": sched.log,
        "decisions": [r["decision"] for r in sched.log],
        "replay": replay_decisions(fresh, sched.log) if fresh else None,
        "best": {"lr": best.config["lr"], "loss": best.metrics["loss"],
                 "step": best.metrics["step"]},
        "errors": [repr(e) for e in grid.errors],
        "launches": launches, "steps_started": sum(started.values()),
        "wall_s": wall,
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
        "decide_ms": [(r["decided"] - r["result"]["wall"]) * 1000
                      for r in sched.log],
        "exploits": exploits, "ckpt_bytes": ckpt_bytes,
        "dirs_left": os.path.exists(root), "device": device_name(device),
    }


def _recompute_steps(cfg, batch: int, path: str, lr: float, device,
                     tokens, n: int) -> list:
    """The losses of ``n`` steps from the state saved at ``path`` at
    ``AdamWConfig(lr=lr)`` on ``tune_gpt2_trial``'s batch."""
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models.gpt2 import gpt2_loss
    from ray_tpu_torch.train.checkpoint import load_sharded
    from ray_tpu_torch.train.optim import AdamWConfig
    from ray_tpu_torch.train.train_step import make_train_step

    state = tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor)
                     else x, load_sharded(path))
    if tokens is not None:
        toks = torch.from_numpy(np.asarray(tokens)).to(device)
    else:
        toks = torch.randint(
            0, cfg.vocab_size, (batch, cfg.seq_len + 1), device=device,
            generator=torch.Generator(device=device).manual_seed(1))
    step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg),
                              optimizer=AdamWConfig(lr=lr))
    out = []
    for _ in range(n):
        state, metrics = step_fn(state, {"tokens": toks})
        out.append(float(metrics["loss"]))
    return out


def tune_trainer_gpt2_trial(config: dict) -> None:
    """A Tune trainable that trains through the trainer (Tune x Train):
    ``CudaTrainer(trainer_gpt2_loop, {cfg, batch, steps, lr, ckpt_every
    0}, ScalingConfig(num_workers=1), device=config.get("device"))``. Run
    in a trial's gang, the trainer's worker takes the gang's other
    bundle. Reports the trainer's run: {loss (the last), losses, steps,
    launches (its worker's), worker_pid, pid (this trial's), process (the
    wall time this trial's process started, ``_process_start_wall``),
    entry (the wall time the trial began), worker_startup (the worker's
    ``startup`` marks, ``trainer_gpt2_loop``), first_step_wall, end}. A
    trainer error is raised."""
    from ray_tpu_torch import tune
    from ray_tpu_torch.train.config import ScalingConfig
    from ray_tpu_torch.train.trainer import CudaTrainer

    entry = time.time()
    result = CudaTrainer(
        trainer_gpt2_loop,
        train_loop_config={"cfg": config["cfg"], "batch": config["batch"],
                           "steps": config["steps"], "lr": config["lr"],
                           "ckpt_every": 0, "ckpt_root": None},
        scaling_config=ScalingConfig(num_workers=1),
        device=config.get("device")).fit()
    if result.error is not None:
        raise result.error
    hist = [m for m in result.metrics_history if "step" in m]
    tune.report({"loss": hist[-1]["loss"],
                 "losses": [m["loss"] for m in hist],
                 "steps": [m["step"] for m in hist],
                 "launches": result.metrics_history[-1]["launches"],
                 "worker_pid": hist[0]["pid"], "pid": os.getpid(),
                 "process": _process_start_wall(), "entry": entry,
                 "worker_startup": hist[0]["startup"],
                 "first_step_wall": hist[0]["wall"], "end": time.time()})


def measure_tune_trainer_gpt2(cfg, batch: int, address: str, *, lrs,
                              steps: int = 3, device=None,
                              settle_s: float = 10.0) -> dict:
    """Tune x Train with gangs on a cluster (``address``, a head's): one
    trial per ``lrs`` entry, each ``tune_trainer_gpt2_trial`` in a gang
    ``{"bundles": [{"CPU": 1}, {"CPU": 1, "GPU": 1}], "strategy": "PACK"}``
    (on the CPU, ``device="cpu"``: ``{"CPU": 1}`` for the second), two at
    a time. The driver connects and disconnects after. Then waits (on the
    head, at most ``settle_s``) for no placement group CREATED or PENDING
    and every CPU and GPU free again. Returns {trials (lr, error, losses, steps, launches, pid,
    worker_pid, entry, first_step_wall, end), wall_s, live_pgs, pgs (every
    group the head knows, by state), available (the cluster's free
    resources then), settle_s}."""
    import ray_tpu_torch
    from ray_tpu_torch import tune
    from ray_tpu_torch.util.placement_group import placement_group_table

    on_cpu = device is not None and torch.device(device).type == "cpu"
    worker_bundle = {"CPU": 1} if on_cpu else {"CPU": 1, "GPU": 1}
    ray_tpu_torch.shutdown()
    ray_tpu_torch.init(address=address)
    try:
        t0, fit_wall = time.perf_counter(), time.time()
        grid = tune.Tuner(
            tune_trainer_gpt2_trial,
            param_space={"lr": tune.grid_search(list(lrs)), "cfg": cfg,
                         "batch": batch, "steps": steps, "device": device},
            tune_config=tune.TuneConfig(metric="loss", mode="min",
                                        max_concurrent_trials=2),
            resources_per_trial={"bundles": [{"CPU": 1}, worker_bundle],
                                 "strategy": "PACK"}).fit()
        wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        total = ray_tpu_torch.cluster_resources()
        while True:
            table = placement_group_table() or {}
            live = [k for k, v in table.items()
                    if v.get("state") in ("CREATED", "PENDING")]
            available = ray_tpu_torch.available_resources()
            settle = time.perf_counter() - t1
            if settle >= settle_s or not live and all(
                    available.get(k, 0.0) == total[k]
                    for k in ("CPU", "GPU") if k in total):
                break
            time.sleep(0.1)
    finally:
        ray_tpu_torch.shutdown()
    trials = [{"lr": r.config["lr"],
               "error": repr(r.error) if r.error is not None else None,
               **{k: (r.metrics or {}).get(k) for k in (
                   "losses", "steps", "launches", "pid", "worker_pid",
                   "process", "entry", "worker_startup", "first_step_wall",
                   "end")}}
              for r in grid]
    states: dict = {}
    for v in table.values():
        states[v.get("state")] = states.get(v.get("state"), 0) + 1
    return {"trials": trials, "wall_s": wall, "fit_wall": fit_wall,
            "live_pgs": live, "pgs": states, "available": available,
            "settle_s": settle}


def gpt2_score(params, batch: dict, cfg=None) -> dict:
    """GPT-2's per-row score, the ``apply_fn`` of ``CudaPredictor``:
    ``batch`` {"id": [B], "tokens": [B, T + 1]} -> {"id", "nll"}, where a
    row's ``nll`` is the mean over its T positions of minus the fp32
    log-softmax of ``gpt2_forward``'s logits (under ``cfg``'s flags;
    ``FUSED_FLAGS`` at GPT-2 small when None) at the next token."""
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_forward

    cfg = cfg if cfg is not None else GPT2Config(**FUSED_FLAGS)
    tokens = batch["tokens"].long()
    logits = gpt2_forward(params, tokens[:, :-1], cfg)
    logp = torch.log_softmax(logits.float(), dim=-1)
    picked = logp.gather(-1, tokens[:, 1:, None])[..., 0]
    return {"id": batch["id"], "nll": -picked.mean(-1)}


def gpt2_score_counted(params, batch: dict, cfg=None) -> dict:
    """``gpt2_score``, with what the scoring process saw as two more
    columns: ``launches`` (the batch's kernel launches, in ``KERNELS``
    order, on its first row; zeros on the others) and ``peak_memory``
    (the device's peak allocated bytes so far, every row). The
    ``apply_fn`` of ``measure_batch_predict_gpt2``'s scoring actor,
    whose process may not be the caller's."""
    before = _launches()
    out = gpt2_score(params, batch, cfg)
    after = _launches()
    n = len(out["id"])
    counts = torch.zeros((n, len(KERNELS)), dtype=torch.int64)
    counts[0] = torch.tensor([after.get(k, 0) - before.get(k, 0)
                              for k in KERNELS])
    dev = out["nll"].device
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    out.update(launches=counts,
               peak_memory=torch.full((n,), peak, dtype=torch.int64))
    return out


def task_node() -> str:
    """A trivial task's body: the id of the node whose worker ran it."""
    return _node_id()


def score_rows_seed0(tokens, ids) -> dict:
    """A task's body (``chip_smoke.py`` phase 11a): GPT-2 small's seed-0
    parameters (``FUSED_FLAGS``), built on this process's card, score one
    batch with ``gpt2_score``. Returns the rows' ``nll`` (numpy), this
    process's node id, and the batch's kernel launches."""
    import numpy as np

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init

    cfg = GPT2Config(**FUSED_FLAGS)
    dev = torch.device("cuda", torch.cuda.current_device())
    params = gpt2_init(torch.Generator(device=dev).manual_seed(0), cfg,
                       device=dev)
    batch = {"id": torch.as_tensor(np.asarray(ids)),
             "tokens": torch.as_tensor(np.asarray(tokens)).to(dev)}
    before = _launches()
    out = gpt2_score(params, batch, cfg)
    nll = out["nll"].cpu().numpy()
    after = _launches()
    return {"nll": nll, "node": _node_id(),
            "launches": {k: after.get(k, 0) - before.get(k, 0)
                         for k in KERNELS if after.get(k, 0) - before.get(k, 0)}}


class GpuHolder:
    """An actor that holds its node's GPU reservation and does nothing
    (``chip_smoke.py`` phase 11a)."""

    def node(self) -> str:
        return _node_id()


def score_stream(params, tokens, batch_size: int, tag: str = ""):
    """A streaming task's body (``chip_smoke.py`` phase 15a): GPT-2 small
    (``FUSED_FLAGS``) with ``params`` (a tree of numpy arrays, which the
    caller puts in the store) scores ``tokens`` ``batch_size`` rows at a
    time with ``gpt2_score`` on this process's card, and yields each
    batch's result as it is done: the rows' ``nll`` (numpy), the batch's
    kernel launches, this process's pid and the wall time just before the
    yield (``t_yield``). Each yield also prints ``<tag> yield <i>``."""
    import sys

    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.gpt2 import GPT2Config

    cfg = GPT2Config(**FUSED_FLAGS)
    dev = torch.device("cuda", torch.cuda.current_device())
    dev_params = params_from_numpy(params, dev)
    tokens = np.asarray(tokens)
    with torch.inference_mode():
        for i, lo in enumerate(range(0, len(tokens), batch_size)):
            part = torch.from_numpy(tokens[lo:lo + batch_size]).to(dev)
            before = _launches()
            out = gpt2_score(dev_params, {"id": torch.arange(len(part)),
                                          "tokens": part}, cfg)
            nll = out["nll"].cpu().numpy()
            after = _launches()
            print(f"{tag} yield {i}", file=sys.stdout, flush=True)
            yield {"nll": nll, "pid": os.getpid(), "t_yield": time.time(),
                   "launches": {k: after.get(k, 0) - before.get(k, 0)
                                for k in KERNELS
                                if after.get(k, 0) != before.get(k, 0)}}


def score_rows_counted(params, tokens, batch_size: int) -> dict:
    """A task's body (``chip_smoke.py`` phase 16): GPT-2 small
    (``FUSED_FLAGS``) with ``params`` (a tree of numpy arrays) scores
    ``tokens`` ``batch_size`` rows at a time with ``gpt2_score_counted`` on
    this process's card. Returns the rows' ``nll`` (numpy, in row order),
    each batch's kernel launches (``launches``, a dict a batch, the kernels
    it launched), this process's pid, and wall times (``time.time()``):
    the process's start (``t_process``), the call, the parameters on the
    card (the CUDA context and the upload), the first batch scored and
    the last (``t_entry``, ``t_device``, ``t_first``, ``t_end``)."""
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.gpt2 import GPT2Config

    t_entry = time.time()
    cfg = GPT2Config(**FUSED_FLAGS)
    dev = torch.device("cuda", torch.cuda.current_device())
    dev_params = params_from_numpy(params, dev)
    torch.cuda.synchronize(dev)
    t_device = time.time()
    tokens = np.asarray(tokens)
    nll, launches, t_first = [], [], None
    with torch.inference_mode():
        for lo in range(0, len(tokens), batch_size):
            part = torch.from_numpy(tokens[lo:lo + batch_size]).to(dev)
            out = gpt2_score_counted(
                dev_params, {"id": torch.arange(len(part)), "tokens": part},
                cfg)
            nll.append(out["nll"].cpu().numpy())
            launches.append({k: n for k, n in zip(
                KERNELS, out["launches"][0].tolist()) if n})
            t_first = t_first or time.time()
    return {"nll": np.concatenate(nll), "launches": launches,
            "pid": os.getpid(), "t_process": _process_start(),
            "t_entry": t_entry, "t_device": t_device, "t_first": t_first,
            "t_end": time.time()}


def _process_start() -> float:
    """This process's start as a wall time, to 10 ms (``/proc``: its start
    in clock ticks after boot, against the seconds since boot)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))


def fail_on_gpu(message: str) -> None:
    """A task's body that raises on its node (``chip_smoke.py`` 15d)."""
    raise RuntimeError(f"{message} on {_node_id()}")


class GPT2Scorer:
    """A Serve deployment class (``chip_smoke.py`` phase 17b): GPT-2
    (``cfg``; GPT-2 small under ``FUSED_FLAGS`` when None) with ``params``
    -- a tree of numpy arrays, or an ObjectRef of one, read from the store
    here -- on this process's card (or ``device``), scoring one row a
    request with ``gpt2_score`` through ``@serve.batch(max_batch_size=8)``
    (8b's batch). A request is {"id": int, "tokens": [T + 1 ints]}, its
    answer {"id", "nll"}. The batch queue's one thread is the only one
    that launches on the card; the replica's request threads only
    enqueue. On a GPU the constructor scores one batch of 8 rows of zeros
    first, so a fresh process's first-use costs (the kernels'
    load, the libraries' handles) fall in the deployment's start, not in
    its first request. ``stats()`` gives the sizes of the batches that
    formed, each batch's kernel launches in this process, and the device's
    peak allocated bytes."""

    def __init__(self, params, cfg=None, device=None):
        import ray_tpu_torch
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.models.convert import params_from_numpy
        from ray_tpu_torch.models.gpt2 import GPT2Config

        if isinstance(params, ObjectRef):
            params = ray_tpu_torch.get(params, timeout=600)
        self.cfg = cfg if cfg is not None else GPT2Config(**FUSED_FLAGS)
        dev = resolve_device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
            torch.cuda.reset_peak_memory_stats(dev)
        self.device = dev
        self.params = params_from_numpy(params, dev)
        if dev.type == "cuda":
            zeros = torch.zeros((8, self.cfg.seq_len + 1), dtype=torch.int64,
                                device=dev)
            with torch.inference_mode():
                gpt2_score(self.params, {"id": torch.arange(8),
                                         "tokens": zeros}, self.cfg)
            torch.cuda.synchronize(dev)
        self._lock = threading.Lock()
        self._sizes: list = []
        self._launches: list = []

    @serve_batch(max_batch_size=8)
    def score_batch(self, rows: list) -> list:
        tokens = torch.as_tensor(np.asarray([r["tokens"] for r in rows],
                                            dtype=np.int64))
        with torch.inference_mode():
            before = _launches()
            out = gpt2_score(self.params,
                             {"id": torch.arange(len(rows)),
                              "tokens": tokens.to(self.device)}, self.cfg)
            nll = out["nll"].float().cpu().numpy()
            after = _launches()
        with self._lock:
            self._sizes.append(len(rows))
            self._launches.append({k: after.get(k, 0) - before.get(k, 0)
                                   for k in KERNELS
                                   if after.get(k, 0) != before.get(k, 0)})
        return [{"id": r["id"], "nll": float(x)} for r, x in zip(rows, nll)]

    def __call__(self, row: dict) -> dict:
        return self.score_batch(row)

    def stats(self) -> dict:
        with self._lock:
            sizes, launches = list(self._sizes), list(self._launches)
        peak = (torch.cuda.max_memory_allocated(self.device)
                if self.device.type == "cuda" else None)
        return {"batch_sizes": sizes, "launches": launches,
                "peak_memory_bytes": peak, "pid": os.getpid(),
                "device": str(self.device)}


def http_post_json(port: int, path: str, payload, headers=None,
                   timeout: float = 600.0, host: str = "127.0.0.1"):
    """POST ``payload`` as JSON to Serve's proxy; returns (status, the
    decoded body)."""
    import http.client

    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json",
                              **(headers or {})})
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read() or b"null")
    finally:
        conn.close()


def http_stream_tokens(port: int, path: str, payload, t0: float | None = None,
                       timeout: float = 600.0, host: str = "127.0.0.1"):
    """Stream one request through Serve's proxy (the ``x-serve-stream``
    lane: chunked ndjson). Returns {status, tokens, chunks, done (the
    terminator line), ttft_s and latency_s: the first chunk and the last
    line as the client read them, after ``t0`` (``time.perf_counter()``,
    the request's start when None), headers (the response's)}."""
    import http.client

    t0 = time.perf_counter() if t0 is None else t0
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(payload).encode(),
                     headers={"Content-Type": "application/json",
                              "x-serve-stream": "1"})
        resp = conn.getresponse()
        out = {"status": resp.status, "tokens": [], "chunks": 0,
               "done": None, "ttft_s": None, "latency_s": None,
               "headers": resp.getheaders()}
        if resp.status != 200:
            out["done"] = json.loads(resp.read() or b"null")
            return out
        while True:
            line = resp.readline()
            if not line:
                break
            msg = json.loads(line)
            if "tokens" in msg:
                if out["ttft_s"] is None:
                    out["ttft_s"] = time.perf_counter() - t0
                out["tokens"].extend(msg["tokens"])
                out["chunks"] += 1
            else:
                out["done"] = msg
        out["latency_s"] = time.perf_counter() - t0
        return out
    finally:
        conn.close()


class AsyncEngineHost:
    """An async actor hosting ``LLMEngine`` (``chip_smoke.py`` phase 15c):
    the constructor builds ``measure_serve``'s engine for ``model``
    (``SERVE_ENGINES`` settings, seed 0, on this process's card), and
    ``generate`` submits a request and awaits its tokens without blocking
    the actor's event loop: one poller coroutine drains every live
    stream with ``llm_poll`` each millisecond and resolves each request's
    future, so the calls overlap in the engine's batch."""

    def __init__(self, model: str = "gpt2", preset: str = "small",
                 max_new_tokens: int = 64):
        from ray_tpu_torch.serve.llm_engine import LLMEngine

        self.engine = LLMEngine(
            model=model, preset=preset, seed=0,
            max_new_tokens=max_new_tokens, max_new_cap=max_new_tokens,
            device=torch.device("cuda", torch.cuda.current_device()),
            **SERVE_ENGINES[model])
        self._waiting: dict = {}  # rid -> (future, tokens so far)
        self._poller = None
        self.active_peak = 0

    async def generate(self, prompt, max_new_tokens: int):
        import asyncio

        rid = self.engine.llm_submit(list(prompt), max_new_tokens)
        fut = asyncio.get_running_loop().create_future()
        self._waiting[rid] = (fut, [])
        if self._poller is None or self._poller.done():
            self._poller = asyncio.ensure_future(self._poll())
        return await fut

    async def _poll(self):
        import asyncio

        while self._waiting:
            self.active_peak = max(self.active_peak,
                                   self.engine.llm_stats()["active"])
            for rid, resp in self.engine.llm_poll(list(self._waiting)).items():
                fut, toks = self._waiting[rid]
                for chunk in resp["chunks"]:
                    toks.extend(chunk)
                if resp["done"]:
                    del self._waiting[rid]
                    err = resp["shed"] or resp["error"]
                    if err:
                        fut.set_exception(RuntimeError(f"{rid}: {err}"))
                    else:
                        fut.set_result(toks)
            await asyncio.sleep(0.001)

    def stats(self) -> dict:
        """The engine's ``llm_stats`` with the largest number of active
        slots the poller saw (``active_peak``)."""
        return {**self.engine.llm_stats(), "active_peak": self.active_peak}


def measure_batch_predict_gpt2(cfg=None, *, params=None, tokens=None,
                               batch_size: int = 8, device=None,
                               address: str | None = None) -> dict:
    """Batch inference through the entry point a user calls:
    ``BatchPredictor.from_checkpoint(Checkpoint.from_dict({"params":
    params}), CudaPredictor, apply_fn=gpt2_score_counted)`` scoring a
    dataset of rows {"id", "tokens"} (``from_items`` over 8 blocks, put
    after the predictor puts its checkpoint) at ``batch_size``, on one
    scoring actor.

    ``cfg``: GPT-2 small under ``FUSED_FLAGS`` when None. ``params``: a
    tree of numpy arrays (``gpt2_init`` from seed 0, moved to the host,
    when None). ``tokens``: [rows, seq_len + 1] integers (256 rows of
    ``torch.randint`` from seed 2 on the device, moved to the host, when
    None). The launches and the peak device memory are what the scoring
    process saw, read from ``gpt2_score_counted``'s columns: the kernels
    it launched around each batch, summed, and the largest peak (None on
    the CPU). The peak counts from just before ``predict``: in-process on
    the local backend, from its start in a cluster's worker.

    With ``address`` (a head's), on that cluster: the driver connects
    (``ray_tpu_torch.init(address=...)``, disconnecting after), and the
    scoring actor is a worker process that reserves one GPU on ``cuda``
    and gets the checkpoint through the object store.

    Returns {ids, nll (both in id order), rows, batches, wall_s (the whole
    ``predict``: the actors, the predictor's build with its upload of the
    parameters, the scoring), rows_s, tokens_s, ms_batch (wall_s over the
    batches), launches, peak_memory_bytes, device}."""
    import functools

    from ray_tpu_torch import data
    from ray_tpu_torch.models.convert import params_to_numpy
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from ray_tpu_torch.train.batch_predictor import (BatchPredictor,
                                                     CudaPredictor)
    from ray_tpu_torch.train.checkpoint import Checkpoint

    device = resolve_device(device)
    cfg = cfg if cfg is not None else GPT2Config(**FUSED_FLAGS)
    gen = torch.Generator(device=device)
    if params is None:
        params = params_to_numpy(gpt2_init(gen.manual_seed(0), cfg,
                                           device=device))
    if tokens is None:
        tokens = torch.randint(
            0, cfg.vocab_size, (256, cfg.seq_len + 1), device=device,
            generator=gen.manual_seed(2)).cpu().numpy()
    rows, blocks = len(tokens), 8
    if address is not None:
        import ray_tpu_torch

        ray_tpu_torch.shutdown()
        ray_tpu_torch.init(address=address)
    try:
        predictor = BatchPredictor.from_checkpoint(
            Checkpoint.from_dict({"params": params}), CudaPredictor,
            apply_fn=functools.partial(gpt2_score_counted, cfg=cfg),
            device=device)
        ds = data.from_items([{"id": i, "tokens": t}
                              for i, t in enumerate(tokens)],
                             parallelism=blocks)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        out = predictor.predict(ds, batch_size=batch_size,
                                max_scoring_workers=1)
        wall = time.perf_counter() - t0
        ids, nll, counted, peaks = [], [], [], []
        for b in out.iter_batches(batch_size=rows, batch_format="numpy"):
            ids.append(b["id"])
            nll.append(b["nll"])
            counted.append(b["launches"].sum(0))
            peaks.append(b["peak_memory"].max())
    finally:
        if address is not None:
            import ray_tpu_torch

            ray_tpu_torch.shutdown()
    launches = {k: n for k, n in zip(KERNELS, np.sum(counted, 0).tolist())
                if n}
    ids, nll = np.concatenate(ids), np.concatenate(nll)
    order = np.argsort(ids, kind="stable")
    n = max(1, min(blocks, rows))  # from_items' blocks
    cuts = [round(i * rows / n) for i in range(n + 1)]
    n_batches = sum(-(-(b - a) // batch_size) for a, b in zip(cuts, cuts[1:]))
    return {
        "ids": ids[order], "nll": nll[order], "rows": rows,
        "batches": n_batches, "wall_s": wall, "rows_s": rows / wall,
        "tokens_s": rows * cfg.seq_len / wall,
        "ms_batch": wall / n_batches * 1000, "launches": launches,
        "peak_memory_bytes": (int(max(peaks)) if device.type == "cuda"
                              else None),
        "device": device_name(device),
    }


# The serving engines' settings at full width, by family: 32 slots, a ring
# cache of the model's window (GPT-2 1024, Llama 2048), a prefill lane of 4
# rows of 128 / 256 tokens; prompts drawn over 16..128 / 16..256 tokens.
SERVE_ENGINES = {
    "gpt2": dict(max_batch=32, cache_len=1024, max_prompt_len=128,
                 prefill_rows=4),
    "llama": dict(max_batch=32, cache_len=2048, max_prompt_len=256,
                  prefill_rows=4),
}
SERVE_PROMPT_MIN = 16


def serve_prompts(n: int, vocab_size: int, max_len: int, seed: int = 3):
    """``n`` prompts of random tokens, lengths uniform over
    [SERVE_PROMPT_MIN, max_len], from ``seed``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SERVE_PROMPT_MIN, max_len + 1, n)
    return [rng.integers(0, vocab_size, int(k)).tolist() for k in lengths]


def _median_ms(fn, device, reps: int) -> float:
    """Median host wall ms of ``fn`` followed by a device sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _step_inputs(eng, seed: int):
    """Random decode-step inputs (host arrays) for every slot."""
    rng = np.random.default_rng(seed)
    n = eng.max_batch + 1
    return (rng.integers(0, eng._cfg.vocab_size, n),
            rng.integers(0, eng.cache_len, n))


def decode_graph_vs_eager(eng, seed: int = 5) -> dict:
    """One decode step replayed from the engine's graph and the same step
    function called eagerly, from one cache snapshot and one input
    (random tokens and positions); the cache is restored after each.
    Returns {tokens_equal, logits_max_abs_diff}. The engine must be idle
    (``run_decode_step`` raises otherwise)."""
    tokens, pos = _step_inputs(eng, seed)
    snap = {k: v.clone() for k, v in eng._cache.items()}
    out = {}
    for eager in (False, True):
        nxt, logits = eng.run_decode_step(tokens, pos, eager=eager,
                                          logits=True)
        out[eager] = (nxt, logits.float().cpu())
        for k, v in snap.items():
            eng._cache[k].copy_(v)
    return {"tokens_equal": bool(np.array_equal(out[False][0],
                                                out[True][0])),
            "logits_max_abs_diff": float(
                (out[False][1] - out[True][1]).abs().max())}


def _collect(eng, rids, t_submit, on_poll=None, timeout_s: float = 600.0,
             done=None):
    """Drain every stream from this thread, one ``llm_poll`` of all live
    streams every 0.5 ms, calling ``on_poll()`` after each; returns per
    request (first token wall s after ``t_submit``, tokens, error). A
    ``done`` dict gets each request's last token wall s after
    ``t_submit``."""
    first, toks, err = {}, {rid: [] for rid in rids}, {}
    live = list(rids)
    deadline = time.monotonic() + timeout_s
    while live:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(live)} streams still open")
        eng.check_health()
        polled = eng.llm_poll(live)
        now = time.perf_counter() - t_submit
        for rid, resp in polled.items():
            if resp["chunks"] and rid not in first:
                first[rid] = now
            for chunk in resp["chunks"]:
                toks[rid].extend(chunk)
            if resp["done"]:
                err[rid] = resp["shed"] or resp["error"]
                if done is not None:
                    done[rid] = now
        live = [rid for rid in live if rid not in err]
        if on_poll is not None:
            on_poll()
        time.sleep(0.0005)
    return [(first.get(rid), toks[rid], err[rid]) for rid in rids]


def measure_serve(model: str, preset: str = "small", *, requests: int = 64,
                  max_new_tokens: int = 64, config=None, device=None,
                  reps: int = 20, seed: int = 0, **engine_kw) -> dict:
    """Serve ``requests`` random prompts (``serve_prompts``, seed 3) of
    ``max_new_tokens`` each, no eos, through one ``LLMEngine`` of family
    ``model`` (``SERVE_ENGINES`` settings unless overridden), and measure:

    - ``decode_tok_s_full``: decode tokens a second while every slot was
      busy (from the first to the last sample of the engine's counters,
      taken at each poll of the streams, that saw all ``max_batch`` slots
      active; the window includes the prefills admitted within it), and
      ``serve_tok_s``, all tokens over the whole run's wall time;
    - ``step_ms_graph`` / ``step_ms_eager``: the decode step's median wall
      ms (input copy, step, device sync) replayed from its graph and
      called eagerly, at random tokens and positions; ``prefill_ms_graph``
      / ``prefill_ms_eager`` the same for the prefill lane;
    - ``ttft_ms_p50`` / ``ttft_ms_p99``: submit to first token, per
      request on the client's clock, all requests submitted at once, and
      ``latency_ms_p50`` / ``latency_ms_p99`` submit to its last token;
    - ``peak_memory_bytes``: ``torch.cuda.max_memory_allocated`` from
      before the engine's construction (on a GPU);
    - ``graph_vs_eager``: ``decode_graph_vs_eager`` after the run.
    Also: every request's token count and tokens (``tokens_out``, in the
    prompts' order), ``compiles``, the engine's stats.
    The step times are taken before the requests, on an idle engine."""
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    device = resolve_device(device)
    kw = {**SERVE_ENGINES[model], **engine_kw}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    eng = LLMEngine(model=model, config=config, preset=preset, seed=seed,
                    max_new_tokens=max_new_tokens, max_new_cap=max_new_tokens,
                    device=device, **kw)
    build_s = time.perf_counter() - t0
    try:
        tokens, pos = _step_inputs(eng, seed + 1)
        rows, p_len = eng.prefill_rows, eng.max_prompt_len
        p_tokens = np.ones((rows, p_len), np.int64)
        p_slots = np.full(rows, eng.max_batch, np.int64)  # the scratch slot
        p_lengths = np.full(rows, p_len, np.int64)
        times = {}
        for eager in (False, True):
            tag = "eager" if eager else "graph"
            times[f"step_ms_{tag}"] = _median_ms(
                lambda: eng.run_decode_step(tokens, pos, eager=eager),
                device, reps)
            times[f"prefill_ms_{tag}"] = _median_ms(
                lambda: eng.run_prefill(p_tokens, p_slots, p_lengths,
                                        eager=eager), device, reps)
        prompts = serve_prompts(requests, eng._cfg.vocab_size,
                                eng.max_prompt_len)
        t_submit = time.perf_counter()
        samples = []

        def sample():
            st = eng.llm_stats()
            samples.append((time.perf_counter(), st["active"],
                            st["occupancy_sum"], st["steps"]))

        rids = eng.llm_submit_many([{"tokens": p} for p in prompts])
        done: dict = {}
        results = _collect(eng, rids, t_submit, on_poll=sample, done=done)
        latency = sorted(done[rid] * 1e3 for rid in rids)
        wall = time.perf_counter() - t_submit
        full = [s for s in samples if s[1] == eng.max_batch]
        window = full[-1][0] - full[0][0] if len(full) > 1 else 0.0
        stats = eng.llm_stats()
        ttft = sorted(r[0] * 1e3 for r in results if r[0] is not None)
        out = {
            "model": model, "preset": preset, "device": device_name(device),
            "dtype": str(eng._cfg.dtype).split(".")[-1],
            "n_params": eng._cfg.n_params, **kw,
            "requests": requests, "max_new_tokens": max_new_tokens,
            "prompt_tokens": sum(len(p) for p in prompts),
            "build_s": build_s, **times,
            "decode_tok_s_full": (full[-1][2] - full[0][2]) / window
            if window > 0 else None,
            "full_window_steps": full[-1][3] - full[0][3] if full else 0,
            "serve_tok_s": stats["tokens_out"] / wall, "wall_s": wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_ms_p99": float(np.percentile(ttft, 99)) if ttft else None,
            "latency_ms_p50": float(np.percentile(latency, 50)),
            "latency_ms_p99": float(np.percentile(latency, 99)),
            "tokens_per_request": [len(r[1]) for r in results],
            "tokens_out": [r[1] for r in results],
            "errors": [r[2] for r in results if r[2]],
            "compiles": stats["compiles"], "stats": stats,
            "graph_vs_eager": decode_graph_vs_eager(eng),
        }
    finally:
        eng.shutdown_engine()
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    del eng
    return out


def serve_vs_naive(model: str, config, *, prompts, n_tokens: int = 8,
                   device=None, seed: int = 0, **engine_kw) -> dict:
    """The engine's greedy tokens for ``prompts`` (submitted together)
    against the model's naive loop (full-context ``*_forward`` + argmax a
    token) on the engine's own weights. Compares up to the first step
    where the naive loop's top-2 logit gap is under 1e-4 * max(1, |top
    logit|) (a near tie, where summation order may pick either).
    Returns {match, compared (tokens compared over all prompts), min_gap,
    prompts: per prompt {engine, naive, gaps, compared, error}}."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    device = resolve_device(device)
    forward = gpt2.gpt2_forward if model == "gpt2" else llama.llama_forward
    kw = {**SERVE_ENGINES[model], **engine_kw}
    eng = LLMEngine(model=model, config=config, seed=seed,
                    max_new_tokens=n_tokens, device=device, **kw)
    try:
        rids = eng.llm_submit_many([{"tokens": p} for p in prompts])
        results = _collect(eng, rids, time.perf_counter())
        rows, match, compared, min_gap = [], True, 0, float("inf")
        with torch.no_grad():
            for p, (_, got, err) in zip(prompts, results):
                toks, gaps, tie = list(p), [], n_tokens
                for i in range(n_tokens):
                    logits = forward(eng.params, torch.tensor([toks],
                                                              device=device),
                                     eng._cfg)[0, -1].float()
                    top2 = logits.topk(2).values
                    gap = float(top2[0] - top2[1])
                    gaps.append(gap)
                    if tie == n_tokens and gap < 1e-4 * max(
                            1.0, abs(float(top2[0]))):
                        tie = i  # a near tie: either token may win
                    toks.append(int(logits.argmax()))
                want = toks[len(p):]
                match &= (err is None and len(got) == n_tokens
                          and got[:tie] == want[:tie])
                compared += tie
                min_gap = min(min_gap, min(gaps))
                rows.append({"engine": got, "naive": want, "gaps": gaps,
                             "compared": tie, "error": err})
    finally:
        eng.shutdown_engine()
    return {"match": match, "compared": compared, "min_gap": min_gap,
            "prompts": rows}


def served_vs_fp32(model: str, config, *, prompts, device=None,
                   seed: int = 0, **engine_kw) -> dict:
    """The engine at ``config``'s dtype against an fp32 copy of it (same
    seed, so the same fp32 weights), both idle: ``prompts`` (at most
    ``prefill_rows``) through the prefill lane into slots 0.., then one
    decode step at each prompt's next position, fed the fp32 copy's
    first tokens in both. Returns the smallest per-prompt cosine of the
    fp32 logits after the prefill and after the decode step, the K/V
    cache's relative error (Frobenius, the larger of K and V) over the
    prompts' slots after both, and how many first and next tokens agree
    ({prefill_cosine, decode_cosine, cache_rel_err, first_agree,
    next_agree, n})."""
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    device = resolve_device(device)
    kw = {**SERVE_ENGINES[model], **engine_kw}
    n = len(prompts)
    runs = {}
    # The fp32 copy first: its first tokens feed both decode steps.
    for name, cfg in (("fp32", dataclasses.replace(config,
                                                    dtype=torch.float32)),
                      ("served", config)):
        eng = LLMEngine(model=model, config=cfg, seed=seed, device=device,
                        **kw)
        try:
            rows, slots = eng.prefill_rows, eng.max_batch + 1
            if n > rows:
                raise ValueError(f"{n} prompts exceed {rows} prefill rows")
            toks = np.zeros((rows, eng.max_prompt_len), np.int64)
            p_slots = np.full(rows, eng.max_batch, np.int64)
            lengths = np.ones(rows, np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
                p_slots[i], lengths[i] = i, len(p)
            first, p_logits = eng.run_prefill(toks, p_slots, lengths,
                                              logits=True)
            feed = runs["fp32"]["first"] if "fp32" in runs else first[:n]
            tokens, pos = np.zeros(slots, np.int64), np.zeros(slots, np.int64)
            tokens[:n], pos[:n] = feed, lengths[:n]
            nxt, d_logits = eng.run_decode_step(tokens, pos, logits=True)
            runs[name] = {"first": first[:n], "next": nxt[:n],
                          "prefill": p_logits[:n].float().cpu(),
                          "decode": d_logits[:n].float().cpu(),
                          "cache": {k: v[:, :n].float().cpu()
                                    for k, v in eng._cache.items()}}
        finally:
            eng.shutdown_engine()
    a, b = runs["served"], runs["fp32"]
    cos = {k: float(torch.nn.functional.cosine_similarity(
        a[k], b[k], dim=-1).min()) for k in ("prefill", "decode")}
    cache_err = max(float((a["cache"][k] - b["cache"][k]).norm()
                          / b["cache"][k].norm()) for k in b["cache"])
    return {"prefill_cosine": cos["prefill"], "decode_cosine": cos["decode"],
            "cache_rel_err": cache_err,
            "first_agree": int((a["first"] == b["first"]).sum()),
            "next_agree": int((a["next"] == b["next"]).sum()), "n": n}
