"""Where the GPT-2 train step's device time goes.

Profiles ``--steps`` train steps of a GPT-2 config on one GPU with
``torch.profiler`` (after warmup steps and as many unprofiled, timed steps)
and prints one JSON object: the step's wall time with and without the
profiler, the summed device-kernel time and busy share, the time
per kernel class (the port's fused-norm kernels, matrix products, softmax,
reductions, other elementwise, the rest) and the top kernels by device time.

    python -m ray_tpu_torch.scripts.profile_step [--batch 8] [--steps 2]
        [--out profile_step.json]

The config is GPT-2 small with ``measure.FUSED_DENSE_FLAGS``, the one
``chip_smoke.py`` drives. Needs a CUDA device.
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
    ("fused_norm", ("ln_fwd_kernel", "ln_bwd_kernel", "gelu_fwd_kernel",
                    "gelu_bwd_kernel")),
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


def profile_step(batch: int = 8, steps: int = 2, warmup: int = 2) -> dict:
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss
    from ray_tpu_torch.scripts.measure import FUSED_DENSE_FLAGS
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    device = torch.device("cuda")
    cfg = GPT2Config(**FUSED_DENSE_FLAGS)
    state = make_init_fn(lambda g: gpt2_init(g, cfg, device=device))(
        torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg))
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
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step_fn(state, {"tokens": tokens})
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
    return {
        "device": torch.cuda.get_device_name(device),
        "batch": batch,
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
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: needs a CUDA device")
    result = profile_step(args.batch, args.steps)
    text = json.dumps(result, indent=1)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
