"""Where a train step's (or a serving decode step's) device time goes.

Profiles ``--steps`` train steps of a GPT-2, Llama or MoE config on one GPU
with ``torch.profiler`` (after warmup steps and as many unprofiled, timed
steps) and prints one JSON object: the step's wall time with and without
the profiler, the summed device-kernel time and busy share, the time per
kernel class (the port's flash, RMSNorm and other fused-norm kernels,
fp32 and other matrix products, softmax, reductions, other elementwise,
the rest), the top kernels by device time, and the top PyTorch operators
by the device time of the kernels they launched themselves.

    python -m ray_tpu_torch.scripts.profile_step
        [--config flash|dense|llama|moe] [--batch N] [--steps 2] [--mesh]
        [--out profile_step.json]

``flash`` (the default) is GPT-2 small with ``measure.FUSED_FLAGS``,
``dense`` the same with ``measure.FUSED_DENSE_FLAGS`` (both batch 8 unless
``--batch``); ``llama`` is ``LlamaConfig.small()`` with
``measure.LLAMA_FLAGS`` (batch 4 unless ``--batch``); ``moe`` is
``MoEConfig.small()`` with ``measure.MOE_FLAGS`` (batch 4 unless
``--batch``), whose fp32 dispatch, combine and expert products are the
``matmul_fp32`` class. ``serve-gpt2`` and
``serve-llama`` profile ``--steps`` replays of an ``LLMEngine``'s captured
decode step (``measure.SERVE_ENGINES`` settings, 32 slots, random tokens
and positions), each replay followed by the step's device sync, with no
request in flight. ``--mesh`` profiles the train step sharded over a mesh
of 1 (a one-rank NCCL group, ``build_mesh(MeshConfig(fsdp=-1))``, the
model's shardings), as ``chip_smoke.py`` phase 5 runs it, and times it
against the unsharded step in the same process: ``MESH_PAIRS`` pairs of
single synced steps in turns (``paired_ms``), and the same pairs of a
step whose loss is only the sum of every parameter (``machinery_ms``:
what the mesh adds around the model -- the gather, its backward and
AdamW on local shards -- with almost no model work). Beside the device
time, the top operators by host (self CPU) time a step say where the
host's time goes. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import time
from pathlib import Path

import torch

# Kernel classes by substring of the kernel name, first match wins.
CLASSES = (
    ("flash", ("flash_fwd_kernel", "flash_dkv_kernel", "flash_dq_kernel")),
    ("rms", ("rms_fwd_kernel", "rms_fwd_wide_kernel", "rms_bwd_kernel",
             "rms_bwd_wide_kernel")),
    ("fused_norm", ("ln_fwd_kernel", "ln_fwd_wide_kernel", "ln_bwd_kernel",
                    "ln_bwd_wide_kernel", "norm_bwd_sum_kernel",
                    "gelu_fwd_kernel", "gelu_bwd_kernel")),
    # fp32 GEMMs (TF32 off): cuBLAS's sgemm / f32f32 / nvjet_sss names.
    ("matmul_fp32", ("sgemm", "f32f32", "nvjet_sss")),
    ("matmul", ("gemm", "xmma", "cutlass", "nvjet", "sm90_")),
    ("softmax", ("softmax",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


DEFAULT_BATCH = {"flash": 8, "dense": 8, "llama": 4, "moe": 4}
MESH_PAIRS = 10
SERVE_CONFIGS = ("serve-gpt2", "serve-llama")


def _model(config: str):
    """(cfg, init(generator, cfg, device=...), loss(params, batch, cfg),
    shardings(cfg, mesh))."""
    from ray_tpu_torch.models import gpt2, llama, moe
    from ray_tpu_torch.scripts.measure import (FUSED_DENSE_FLAGS,
                                               FUSED_FLAGS, LLAMA_FLAGS,
                                               MOE_FLAGS)

    if config == "llama":
        return (llama.LlamaConfig(**LLAMA_FLAGS), llama.llama_init,
                llama.llama_loss, llama.llama_shardings)
    if config == "moe":
        return (moe.MoEConfig(**MOE_FLAGS), moe.moe_init, moe.moe_loss,
                moe.moe_shardings)
    flags = {"flash": FUSED_FLAGS, "dense": FUSED_DENSE_FLAGS}[config]
    return (gpt2.GPT2Config(**flags), gpt2.gpt2_init, gpt2.gpt2_loss,
            gpt2.gpt2_shardings)


def profile_step(batch: int | None = None, steps: int = 2, warmup: int = 2,
                 config: str = "flash", mesh: bool = False) -> dict:
    if not mesh:
        return _profile_train(batch, steps, warmup, config, None)
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    distributed.initialize("profile-step", 0, 1)
    try:
        return _profile_train(batch, steps, warmup, config,
                              build_mesh(MeshConfig(fsdp=-1)))
    finally:
        distributed.shutdown()


def _profile_train(batch, steps, warmup, config, mesh) -> dict:
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    device = torch.device("cuda")
    batch = batch or DEFAULT_BATCH[config]
    cfg, init, loss, shardings = _model(config)
    sh = shardings(cfg, mesh) if mesh is not None else None
    state = make_init_fn(lambda g: init(g, cfg, device=device), sh, mesh)(
        torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(lambda p, b: loss(p, b, cfg), sh, mesh)
    tokens = torch.randint(0, cfg.vocab_size, (batch, cfg.seq_len + 1),
                           device=device,
                           generator=torch.Generator(device=device).manual_seed(1))
    for _ in range(warmup):
        state, _ = step_fn(state, {"tokens": tokens})
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        state, _ = step_fn(state, {"tokens": tokens})
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    out = _profile(lambda: step_fn(state, {"tokens": tokens}), steps,
                   plain_wall, {"config": config, "batch": batch,
                                "mesh": mesh is not None})
    if mesh is not None:
        out.update(_against_unsharded(lambda g: init(g, cfg, device=device),
                                      lambda p, b: loss(p, b, cfg), sh, mesh,
                                      {"tokens": tokens}))
    return out


def _against_unsharded(init, loss, sh, mesh, batch) -> dict:
    """Pairs of single synced steps, unsharded and over ``mesh`` in turns
    (the first of a pair alternating), of the model's step and of a step
    whose loss is the sum of the parameters; host ms of each, and their
    medians."""
    import statistics

    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    def param_sum(params, _):
        return sum(p.sum() for p in tree_leaves(params))

    def sync():
        if mesh.device_type == "cuda":
            torch.cuda.synchronize()

    out = {}
    for name, fn in (("paired_ms", loss), ("machinery_ms", param_sum)):
        runs = {}
        for key, s, m in (("unsharded", None, None), ("mesh", sh, mesh)):
            state = make_init_fn(init, s, m)(torch.Generator(
                device=mesh.device_type).manual_seed(0))
            step = make_train_step(fn, s, m)
            runs[key] = (step, state)
            step(state, batch)  # warm up
        times = {"unsharded": [], "mesh": []}
        for i in range(MESH_PAIRS):
            for key in (("unsharded", "mesh") if i % 2 == 0
                        else ("mesh", "unsharded")):
                step, state = runs[key]
                sync()
                t0 = time.perf_counter()
                step(state, batch)
                sync()
                times[key].append((time.perf_counter() - t0) * 1e3)
        out[name] = times
        out[name.replace("_ms", "_median_ms")] = {
            k: statistics.median(v) for k, v in times.items()}
        del runs
    return out


def profile_decode(model: str, steps: int = 20, warmup: int = 3) -> dict:
    """``steps`` replays of an ``LLMEngine``'s captured decode step (after
    ``warmup`` and as many unprofiled, timed replays), each followed by a
    sync, as the engine's loop does."""
    from ray_tpu_torch.scripts.measure import SERVE_ENGINES, _step_inputs
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    eng = LLMEngine(model=model, preset="small", device="cuda",
                    **SERVE_ENGINES[model])
    try:
        tokens, pos = _step_inputs(eng, 1)

        def step():
            eng.run_decode_step(tokens, pos)

        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        plain_wall = time.perf_counter() - t0
        return _profile(step, steps, plain_wall,
                        {"config": f"serve-{model}",
                         "batch": eng.max_batch + 1})
    finally:
        eng.shutdown_engine()


def _profile(step, steps: int, plain_wall: float, head: dict) -> dict:
    """Profile ``steps`` calls of ``step`` and summarise the kernels."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    by_class = collections.Counter()
    by_name = collections.Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_class[classify(e.name)] += us
        by_name[e.name] += us
    busy_us = sum(by_class.values())
    # Host-side operators only (kernel rows carry device time too). A
    # kernel launched through ctypes counts to the operator around it: the
    # flash backward kernels to ``_FlashAttentionBackward``, the RMSNorm
    # backward to ``_RMSNormBackward``.
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CPU
                  and e.self_device_time_total > 0),
                 key=lambda e: -e.self_device_time_total)[:15]
    host_ops = sorted((e for e in prof.key_averages()
                       if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:15]
    return {
        "device": torch.cuda.get_device_name(),
        **head,
        "steps": steps,
        "ms_per_step": plain_wall * 1e3 / steps,
        "profiled_ms_per_step": wall * 1e3 / steps,
        "kernel_ms_per_step": busy_us / 1e3 / steps,
        # Kernel time over the unprofiled step's wall time: the profiler's
        # own host cost stretches the profiled window.
        "busy_share": busy_us / 1e6 / plain_wall,
        "kernel_launches_per_step": len(kernels) / steps,
        "ms_per_step_by_class": {k: v / 1e3 / steps
                                 for k, v in by_class.most_common()},
        "top_kernels_ms_per_step": [(name[:120], us / 1e3 / steps)
                                    for name, us in by_name.most_common(15)],
        # (operator, device ms per step, calls per step)
        "top_ops_ms_per_step": [(e.key, e.self_device_time_total / 1e3 / steps,
                                 e.count / steps) for e in ops],
        # (operator, host self ms per step under the profiler, calls per
        # step)
        "top_host_ops_ms_per_step": [(e.key, e.self_cpu_time_total / 1e3
                                      / steps, e.count / steps)
                                     for e in host_ops],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=tuple(DEFAULT_BATCH) + SERVE_CONFIGS,
                    default="flash")
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--mesh", action="store_true",
                    help="the train step sharded over a mesh of 1")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    if args.config in SERVE_CONFIGS:
        result = profile_decode(args.config.split("-")[1], args.steps)
    else:
        result = profile_step(args.batch, args.steps, config=args.config,
                              mesh=args.mesh)
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
