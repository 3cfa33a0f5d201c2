#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (nvcc); it builds the kernels
from ``ray_tpu_torch/ops/csrc`` and then runs, failing on the first phase
that fails:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: the kernels, timed;
3. kernel vs plain version: each kernel against its plain PyTorch version
   at the GPT-2-small shapes (R = 8 x 1024 rows, D = 768, GELU width 3072)
   in bf16 and fp32, plus odd widths that exercise the masked tails, and
   the device time of the kernel, the plain version and one PyTorch call
   for the same function (the yardstick, never called by the port);
4. the GPT-2-small train step (124M, seq 1024, batch 8, the fused-norm
   config with dense attention) through ``measure_gpt2``: 2 warmup and
   5 timed steps, the loss finite and falling, and every kernel launched
   the expected number of times per step;
5. kernel path vs plain path: loss and gradients of one batch with
   ``fused_norm=True`` and ``=False`` from the same weights;
6. one JSON line of every TPU kernel of the JAX package, ported or not;
7. the last line, ``{"ok": true, "device": {...}}``.

Tolerances: fp32 outputs within 1e-5 (forward) and 1e-4 (gradients) of the
plain version, relative to the larger of 1 and the output's largest
magnitude (the column sums dscale/dbias reach ~100 at R = 8192, where fp32
sums taken in another order differ by more than 1e-4 absolute); bf16
outputs within one bf16 ulp plus 1e-5 absolute (values near zero carry the
fp32 rounding from before the cast); bf16 dscale/dbias by cosine > 0.9999.
Kernel times are CUDA-event medians of 30 launches, after the clocks are
warmed up, with the 50 MB L2 flushed (by a read) before each, queued
behind a device sleep so that host launch overhead is not timed. Details
go to ``chip_smoke_out/chip_smoke.json``.

Exits non-zero, printing no result, when CUDA is not available or when the
``ray_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

OUT = Path(__file__).resolve().parent / "chip_smoke_out"
SOURCE = "ray_tpu_torch/ops/csrc/fused_norm.cu"

# Every function of the JAX package that reaches pl.pallas_call.
TPU_KERNELS = [
    ("ln_fwd", "ray_tpu/ops/fused_norm.py:121", "_ln_fwd_kernel"),
    ("ln_bwd", "ray_tpu/ops/fused_norm.py:184", "_norm_bwd_kernel, LayerNorm"),
    ("gelu_fwd", "ray_tpu/ops/fused_norm.py:278", "_gelu_fwd_kernel"),
    ("gelu_bwd", "ray_tpu/ops/fused_norm.py:284", "_gelu_bwd_kernel"),
    ("rms_fwd", "ray_tpu/ops/fused_norm.py:137", "_rms_fwd_kernel"),
    ("rms_bwd", "ray_tpu/ops/fused_norm.py:184", "_norm_bwd_kernel, RMSNorm"),
    ("flash_fwd", "ray_tpu/ops/flash_attention.py:84", "_fwd_kernel"),
    ("flash_dkv", "ray_tpu/ops/flash_attention.py:211", "_dkv_kernel"),
    ("flash_dq", "ray_tpu/ops/flash_attention.py:269", "_dq_kernel"),
]
PORTED = ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd")

BATCH, SEQ, D_MODEL = 8, 1024, 768
ROWS = BATCH * SEQ
WARMUP, STEPS = 2, 5
# Launches per train step of the fused config with remat="dots": two norms
# per block plus the final one; the forward ones run again when backward
# recomputes each block.
EXPECTED_PER_STEP = {"ln_fwd": 2 * 25 - 1, "ln_bwd": 25, "gelu_fwd": 24,
                     "gelu_bwd": 12}


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# -- measurement helpers -------------------------------------------------------


def warm_clocks(torch) -> None:
    """Run the card at load for a moment so that the first timings do not
    catch its clocks on the way up from idle."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(200):
        a @ a
    torch.cuda.synchronize()


def device_ms(torch, fn, flush, n: int = 30) -> float:
    """Median device time of ``fn`` over ``n`` launches (CUDA events). A
    read of a buffer larger than the 50 MB L2 before each launch leaves the
    cache cold but clean, so no write-back of other data is timed. A device
    sleep queued first lets the host enqueue every launch before the device
    reaches them."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(n)]
    torch.cuda._sleep(50_000_000)
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def bf16_within_ulp(torch, got, want) -> bool:
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + 1e-5).all())


def compare(torch, name, got, want, fp32_tol, failures) -> float:
    """Check one output against the plain version; returns max abs error."""
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ok = bf16_within_ulp(torch, got, want)
    else:
        ok = err <= fp32_tol * max(1.0, float(want.abs().max()))
    if not ok:
        failures.append(f"{name}: max abs err {err:.3e} ({got.dtype})")
    return err


def cosine(torch, a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


# -- phase 3 -------------------------------------------------------------------


def check_kernels(torch, fn, rows, d, dtype, failures, seed):
    """Run each kernel and its plain version on the same inputs; return
    (errors by kernel, inputs) for timing."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    bias = 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    dres = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    xg = (2 * torch.randn(rows, 4 * d, device="cuda", generator=g)).to(dtype)
    gg = torch.randn(rows, 4 * d, device="cuda", generator=g).to(dtype)
    tag = f"[{rows}x{d} {str(dtype).split('.')[-1]}]"
    errs = {}

    y, mu, rstd = fn.ln_fwd(x, scale, bias)
    y_r, mu_r, rstd_r = fn.ref_ln_fwd(x, scale, bias)
    errs["ln_fwd"] = max(compare(torch, f"ln_fwd y {tag}", y, y_r, 1e-5, failures),
                         compare(torch, f"ln_fwd mu {tag}", mu, mu_r, 1e-5, failures),
                         compare(torch, f"ln_fwd rstd {tag}", rstd, rstd_r, 1e-5,
                                 failures))
    errs["ln_bwd"] = 0.0
    for res in (None, dres):
        got = fn.ln_bwd(x, mu_r, rstd_r, scale, dy, res)
        want = fn.ref_ln_bwd(x, mu_r, rstd_r, scale, dy, res)
        case = f"{tag}{' +dres' if res is not None else ''}"
        e = [compare(torch, f"ln_bwd dx {case}", got[0], want[0], 1e-4, failures)]
        for part, a, b in zip(("dscale", "dbias"), got[1:], want[1:]):
            if dtype == torch.float32:
                e.append(compare(torch, f"ln_bwd {part} {case}", a, b, 1e-4,
                                 failures))
            else:
                e.append(float((a - b).abs().max()))
                c = cosine(torch, a, b)
                if not c > 0.9999:
                    failures.append(f"ln_bwd {part} {case}: cosine {c}")
        errs["ln_bwd"] = max(errs["ln_bwd"], *e)
    errs["gelu_fwd"] = compare(torch, f"gelu_fwd {tag}", fn.gelu_fwd(xg),
                               fn.ref_gelu(xg), 1e-5, failures)
    errs["gelu_bwd"] = compare(torch, f"gelu_bwd {tag}", fn.gelu_bwd(xg, gg),
                               fn.ref_gelu_bwd(xg, gg), 1e-4, failures)
    torch.cuda.synchronize()
    return errs, dict(x=x, scale=scale, bias=bias, dy=dy, dres=dres, mu=mu_r,
                      rstd=rstd_r, xg=xg, gg=gg)


def time_kernels(torch, fn, inp, spec, flush):
    """{kernel: {ms, plain_ms, library_ms, bound_ms, bound_by, ...}}."""
    F = torch.nn.functional
    x, scale, bias, dy, dres = (inp[k] for k in ("x", "scale", "bias", "dy",
                                                 "dres"))
    mu, rstd, xg, gg = inp["mu"], inp["rstd"], inp["xg"], inp["gg"]
    rows, d = x.shape
    n = xg.numel()
    es = x.element_size()
    w_l, b_l = scale.to(x.dtype), bias.to(x.dtype)
    x_l = x.detach().requires_grad_(True)
    w_g, b_g = (t.detach().requires_grad_(True) for t in (w_l, b_l))
    y_l = F.layer_norm(x_l, (d,), w_g, b_g, 1e-5)

    # (kernel, plain, library, bytes moved, fp32 operations)
    cases = {
        "ln_fwd": (lambda: fn.ln_fwd(x, scale, bias),
                   lambda: fn.ref_ln_fwd(x, scale, bias),
                   lambda: F.layer_norm(x, (d,), w_l, b_l, 1e-5),
                   2 * rows * d * es + 2 * rows * 4 + 2 * d * 4,
                   8 * rows * d),
        "ln_bwd": (lambda: fn.ln_bwd(x, mu, rstd, scale, dy, dres),
                   lambda: fn.ref_ln_bwd(x, mu, rstd, scale, dy, dres),
                   lambda: torch.autograd.grad(y_l, (x_l, w_g, b_g), dy,
                                               retain_graph=True),
                   4 * rows * d * es + 2 * rows * 4 + 3 * d * 4,
                   14 * rows * d),
        "gelu_fwd": (lambda: fn.gelu_fwd(xg), lambda: fn.ref_gelu(xg),
                     lambda: F.gelu(xg, approximate="tanh"),
                     2 * n * es, 12 * n),
        "gelu_bwd": (lambda: fn.gelu_bwd(xg, gg),
                     lambda: fn.ref_gelu_bwd(xg, gg),
                     lambda: torch.ops.aten.gelu_backward(gg, xg,
                                                          approximate="tanh"),
                     3 * n * es, 20 * n),
    }
    out = {}
    for name, (kern, plain, lib, nbytes, ops) in cases.items():
        t_bytes = nbytes / spec["hbm_bytes_s"] * 1e3
        t_ops = ops / spec["fp32_flops"] * 1e3
        out[name] = {
            "ms": device_ms(torch, kern, flush),
            "plain_ms": device_ms(torch, plain, flush),
            "library_ms": device_ms(torch, lib, flush),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes,
            "operations": ops,
        }
    return out


# -- main ----------------------------------------------------------------------


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA "
              "device", file=sys.stderr)
        return 1

    # Phase 1: device.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    name = torch.cuda.get_device_name(0)

    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.scripts.measure import (FUSED_DENSE_FLAGS, device_spec,
                                               measure_gpt2)
    from ray_tpu_torch.train.train_step import value_and_grad

    OUT.mkdir(exist_ok=True)
    report = {"nvidia_smi": smi, "device": name}

    # Phase 2: build.
    t0 = time.perf_counter()
    report["build_s"] = _build.build(["fused_norm"])
    print(f"build: {report['build_s']} s of nvcc, phase "
          f"{time.perf_counter() - t0:.1f} s")
    shutil.copy(_build.library_path("fused_norm").with_suffix(".log"),
                OUT / "nvcc_fused_norm.log")

    # Phase 3: each kernel against its plain version.
    spec = device_spec(name)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    warm_clocks(torch)
    failures = []
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        errs, inp = check_kernels(torch, fn, ROWS, D_MODEL, dtype, failures, 0)
        times = time_kernels(torch, fn, inp, spec, flush)
        key = str(dtype).split(".")[-1]
        results[key] = {k: {"max_abs_err": errs[k], **times[k]} for k in PORTED}
        del inp
    for rows, d in ((37, 100), (64, 8192), (37, 2050)):
        for dtype in (torch.bfloat16, torch.float32):
            check_kernels(torch, fn, rows, d, dtype, failures, rows + d)
    report["kernels"] = results
    for k in PORTED:
        r = results["bfloat16"][k]
        print(f"{k}: kernel_ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} bound_us={r['bound_ms'] * 1e3:.1f} "
              f"({r['bound_by']}) max_abs_err={r['max_abs_err']:.3e} "
              f"launches_per_step={EXPECTED_PER_STEP[k]} [bf16, R={ROWS}]")
    require(not failures, "kernel vs plain: " + "; ".join(failures))

    # Phase 4: the GPT-2-small train step through the kernels.
    cfg = GPT2Config(**FUSED_DENSE_FLAGS)
    torch.cuda.reset_peak_memory_stats()
    fn.KERNEL_INVOCATIONS.clear()
    step = measure_gpt2(cfg, BATCH, steps=STEPS, warmup=WARMUP, device="cuda")
    launches = {k: fn.KERNEL_INVOCATIONS[k] for k in PORTED}
    step["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    step["launches"] = launches
    report["train_step"] = step
    n_steps = WARMUP + STEPS
    per_step = {k: launches[k] / n_steps for k in PORTED}
    print(f"train step: GPT-2 {cfg.n_params / 1e6:.0f}M batch {BATCH} seq "
          f"{cfg.seq_len}: {step['tok_s']:.1f} tok/s, {step['ms_step']:.2f} "
          f"ms/step, MFU {step['mfu']:.2f}% of {device_spec(name)['bf16_flops'] / 1e12:.0f} "
          f"TFLOP/s, max_memory_allocated "
          f"{step['max_memory_allocated'] / 2**30:.2f} GiB, losses "
          f"{[round(x, 4) for x in step['losses']]}, launches/step {per_step}")
    losses = step["losses"]
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k, want in EXPECTED_PER_STEP.items():
        require(per_step[k] == want,
                f"{k}: {per_step[k]} launches per step, expected {want}")

    # Phase 5: kernel path vs plain path, same weights and batch.
    params = gpt2_init(torch.Generator(device="cuda").manual_seed(0), cfg,
                       device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, cfg.seq_len + 1),
                           device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    out = {}
    for fused in (True, False):
        c = dataclasses.replace(cfg, fused_norm=fused)
        loss, grads = value_and_grad(lambda p, b: gpt2_loss(p, b, c), params,
                                     {"tokens": tokens})
        out[fused] = (float(loss), grads)
    gk, gp = tree_leaves(out[True][1]), tree_leaves(out[False][1])
    require(all(a.shape == p.shape for a, p in zip(gk, tree_leaves(params))),
            "gradient shapes differ from the parameters'")
    require(all(bool(torch.isfinite(a).all()) for a in gk + gp),
            "non-finite gradients")
    cos = cosine(torch, torch.cat([a.flatten() for a in gk]),
                 torch.cat([a.flatten() for a in gp]))
    rel = abs(out[True][0] - out[False][0]) / abs(out[False][0])
    report["kernel_vs_plain_path"] = {"loss_kernel": out[True][0],
                                      "loss_plain": out[False][0],
                                      "loss_rel_diff": rel, "grad_cosine": cos}
    print(f"kernel vs plain path: loss {out[True][0]:.6f} vs {out[False][0]:.6f} "
          f"(rel {rel:.2e}), gradient cosine {cos:.6f}")
    require(rel <= 1e-2, f"losses differ by {rel:.3e} (rtol 1e-2)")
    require(cos > 0.999, f"gradient cosine {cos} <= 0.999")

    # Phase 6: the kernels line.
    kernels, not_ported = [], []
    for kname, where, body in TPU_KERNELS:
        if kname not in PORTED:
            not_ported.append({"name": kname, "replaces": where, "body": body,
                               "status": "not_ported"})
            continue
        bf, f32 = results["bfloat16"][kname], results["float32"][kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": SOURCE, "replaces": where,
            "launches": launches[kname], "max_abs_err": bf["max_abs_err"],
            "ms": bf["ms"], "plain_ms": bf["plain_ms"],
            "bound_ms": bf["bound_ms"], "bound_by": bf["bound_by"],
            "library_ms": bf["library_ms"], "status": "ported+checked",
            "launches_per_step": per_step[kname], "dtype": "bfloat16",
            "fp32": {k: f32[k] for k in ("max_abs_err", "ms", "plain_ms",
                                         "library_ms", "bound_ms")},
        })
    report["kernels_line"] = {"kernels": kernels, "not_ported": not_ported}
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report["kernels_line"]))

    # Phase 7.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
