#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA device and the CUDA toolkit (nvcc); it builds the kernels
from ``ray_tpu_torch/ops/csrc`` and then runs, failing on the first phase
that fails:

1. device: the card's name and power limit from nvidia-smi; TF32 off;
2. build: both kernel sources (fused_norm.cu, flash_attention.cu), one nvcc
   each, started together, timed; ptxas's registers, spills, shared memory
   and performance notes of every kernel of both;
3. kernel vs plain version: each kernel against its plain PyTorch version
   on the same inputs, and the device time of the kernel, the plain
   version and one PyTorch call for the same function (the yardstick,
   never called by the port):
   - the LayerNorm and GELU kernels at the GPT-2-small shapes (R = 8 x 1024
     rows, D = 768, GELU width 3072) in bf16 and fp32 (``ln_bwd``'s dscale
     and dbias come from its partial rows through ``ln_bwd_sum``, which
     the check and the time include; the LayerNorm backward's yardstick is
     autograd through ``F.layer_norm``, timed also with the dres add);
   - the RMSNorm kernels at the Llama-small shape (R = 4 x 2048 rows,
     D = 1024) in bf16 and fp32; yardstick ``F.rms_norm`` and its autograd
     backward;
   - all six norm kernels at odd widths that exercise the masked tails,
     the RMSNorm kernels at the widths around their one-warp limit (768
     and 1024 at 37 and 45 rows, not a multiple of ``rms_bwd``'s row
     block; 1025 and 1032: just past it, unaligned and aligned), at D = 1
     and 31 and on views one element past a 16-byte boundary, and the
     LayerNorm and GELU kernels around the LayerNorm kernels' one-warp
     rows (768 and 1024 at 37, 45 and 64 rows; 769 and 1025 past them);
     ``ln_bwd`` and ``rms_bwd`` are also called twice on the same inputs
     and must give the same bits; the GELU kernels alone at lengths that
     are not a multiple of a 16-byte pack, shorter than one CTA's span,
     and on views one element past a 16-byte boundary;
   - the flash kernels at the GPT-2-small shape (B=8, T=1024, H=12, D=64,
     bf16, causal, q/k/v strided views of one [B, T, 3*768] tensor, as the
     model passes them), at the Llama-small shape (B=4, T=2048, H=16,
     D=64, contiguous q/k/v, as the GQA repeat leaves them) and at odd
     shapes (T = 77 and 1000, D = 128, causal=False, B=1, H=2); yardstick
     ``scaled_dot_product_attention`` forward, and its backward for the
     dK/dV + dQ pair;
   - dense against flash attention, forward plus backward, at T = 512,
     1024 and 2048 (B*H = 96, D = 64), timed only;
4. the train steps, each with every kernel counter set to 0 just before
   it and its launches read just after: the loss finite and falling, and
   every kernel launched exactly the expected number of times per step:
   - GPT-2 small (124M, seq 1024, batch 8) through ``measure_gpt2``, in
     ``bench.py``'s ``fused`` config with flash attention (the GPT-2 main
     path: 2 warmup and 4 timed steps), then with dense attention (1
     warmup and 3 timed steps);
   - Llama small (246M, 16 layers, d 1024, 16 query and 4 KV heads, seq
     2048, batch 4) through ``measure_llama`` with ``LLAMA_FLAGS`` (flash
     attention, RMSNorm kernels, dots remat; the Llama main path: 2 warmup
     and 4 timed steps);
   - the MoE model (``MoEConfig.small()``: Llama small's attention with
     each MLP a top-2 mixture of 8 SiLU experts, capacity factor 1.25;
     846M parameters, 292M active a token; seq 2048, batch 4) through
     ``measure_moe`` with ``MOE_FLAGS`` (flash attention, dots remat, the
     plain RMSNorm chain as in the JAX module; the MoE main path: 2 warmup
     and 4 timed steps): the three flash kernels only;
   six steps, because the GPT-2 run (AdamW at 3e-4 with no warmup, one
   batch repeated) turns unstable at the seventh on every path, the
   fully plain one included: its seventh loss lands anywhere from 9.9 to
   11.8, above the first, depending on bf16 rounding alone;
4b. the trainer: ``measure_trainer_gpt2`` runs phase 4's GPT-2 flash run
   (same config, init and batch, six steps) through
   ``CudaTrainer(...).fit()`` with ``ScalingConfig(num_workers=1)`` on the
   local backend, with every kernel counter set to 0 just before it and
   read just after: the loop attaches ``step_cost`` (FlopCounterMode over
   one call of the step, on copies of the state), runs each step through
   ``session.timed_step`` and reports its loss with a checkpoint (a copy
   of the state) every second step. Held: each of the seven kernels
   launched exactly as in phase 4, per call of the step (the six steps and
   step_cost's call); the losses equal phase 4's within rtol 1e-5; the
   session's MFU gauge within 5% of step_cost's FLOPs over the trainer's
   own ms/step (the interval between its reports) against the card's
   peak, and each step's gauge equal to step_cost's FLOPs over the step's
   host and compute phases against that peak (the ratio of step_cost's
   FLOPs to the analytic count, and phase 4's MFU on either count,
   printed, not held: the trainer's step is not phase 4's);
   step_cost of the kernel path within 1% of the plain path's (dense
   attention, plain norms) on the same state and batch;
   ``device_telemetry.snapshot()`` naming the card; and a run that raises
   before step 3 restarting once from its step-2 checkpoint and giving
   phase 4's six losses within rtol 1e-5. The trainer's ms/step, tok/s
   and peak memory are printed beside phase 4's, with the card's name and
   power limit;
5. the mesh of 1: a one-rank NCCL group (``parallel.distributed.
   initialize``) and ``build_mesh(MeshConfig(fsdp=-1))``; the GPT-2, Llama
   and MoE main-path steps of phase 4 again, sharded over that mesh through
   ``measure_gpt2`` / ``measure_llama`` / ``measure_moe(mesh=...)`` (the
   MoE with ``expert_parallel``: its experts exchanged by all_to_all over
   the one-rank ``ep`` group; DTensor parameters and
   moments, gathered to plain tensors for the model), each with every
   kernel counter set to 0 just before it and read just after: the losses
   against phase 4's (same init and batch; the first within rtol 1e-5,
   all six within 1e-4; the largest relative gap printed) and the same
   launches of every kernel; ms/step, tok/s and peak memory beside phase
   4's; then ``save_sharded`` of the GPT-2 state after one step and
   ``load_sharded`` onto the same mesh, every leaf bit for bit (bytes and
   seconds printed); then, where there are two CUDA devices, 2 NCCL ranks
   of GPT-2 small at fsdp=2 and 2 of the MoE at ep=2 (each rank the whole
   batch, its 4 experts, the tokens exchanged by all_to_all; this script
   with ``--mesh-rank``): the first loss within rtol 1e-4 of the mesh of 1
   and the rest within 1e-2 -- with one device a line says the 2-rank runs
   did not run;
6. kernel path vs plain path, same weights and batch: GPT-2 (batch 4)
   flash + fused norms, and dense + fused norms, each against fully plain
   (dense attention, ``fused_norm=False``); Llama (batch 2) flash + RMSNorm
   kernels, and dense + RMSNorm kernels, each against fully plain; the MoE
   (batch 2) with flash against dense attention, the dense path's top-k
   choices replayed in the flash path (``compare_moe_paths``: routing is
   discontinuous, so the free-running flash path is held on its loss
   alone, its gradient cosine and the token-layers it routes otherwise
   printed);
7. serving: two ``LLMEngine``s at full width through ``measure_serve``
   (every kernel counter set to 0 just before each and read just after:
   the serving path reaches no kernel, as in the reference), each serving
   64 requests (prompts of 16-128 / 16-256 random tokens from seed 3, 64
   new tokens each, no eos), with its decode step and prefill lane as CUDA
   graphs:
   - GPT-2 small (bf16 activations), 32 slots, cache 1024, prefill lane
     4 x 128;
   - Llama small (bf16 activations), 32 slots, cache 2048, prefill lane
     4 x 256;
   each must return exactly 64 tokens a request, count ``{decode: 1,
   prefill: 1}`` compiles, and give the same tokens from one decode step
   replayed from its graph and called eagerly (same cache snapshot and
   input; the logits' max abs diff printed); a fresh engine of the same
   config (bf16) and its fp32 copy, same weights, must give logits whose
   cosine is above 0.999 for each of 4 prompts after the prefill lane and
   after one decode step fed the same tokens, and a K/V cache over those
   prompts' slots within 3% (relative, Frobenius); then an fp32 copy of each
   config must give, for 4 prompts x 8 tokens, the tokens of the model's
   naive full-forward loop up to the first step where that loop's top-2
   logit gap is under 1e-4 * max(1, |top logit|) (the smallest gap
   printed). The engines' numbers (decode tok/s at full occupancy, step
   ms graph and eager, prefill ms, TTFT p50/p99, peak memory) are
   printed beside the card's name and power limit;
8. one JSON line of every TPU kernel of the JAX package, all ported, with
   its launches on its main path, over the mesh of 1 and through the
   trainer (the flash kernels: GPT-2's, with Llama's and the MoE's beside
   them);
9. the last line, ``{"ok": true, "device": {...}}``.

Tolerances: fused-norm (LayerNorm, RMSNorm, GELU) fp32 outputs within
1e-5 (forward) and 1e-4 (gradients) of the plain version, relative to the
larger of 1 and the output's largest magnitude (the column sums
dscale/dbias reach ~100 at R = 8192, where fp32 sums taken in another order
differ by more than 1e-4 absolute); bf16 outputs within one bf16 ulp plus
1e-5 absolute (values near zero carry the fp32 rounding from before the
cast); bf16 dscale/dbias by cosine > 0.9999. Flash: lse within 1e-4 * max(1, |lse|) (fp32 sums taken
tile by tile, in another order than the dense plain version); out, dq, dk
and dv by cosine > 0.9999 with the max abs error printed (the kernels round
P and dS to bf16 against the running max of each tile, the plain version
against the row's final max, so single elements move by a bf16 ulp of
their magnitude; the JAX package's own bf16 criterion is 0.999). Paths:
loss within rtol 1e-2 and whole-tree gradient cosine > 0.999.
Kernel times are CUDA-event medians of 30 launches, after the clocks are
warmed up, with the 50 MB L2 flushed (by a read) before each, queued
behind a device sleep so that host launch overhead is not timed. Details
go to ``chip_smoke_out/chip_smoke.json``.

Exits non-zero, printing no result, when CUDA is not available or when the
``ray_tpu_torch`` package is not beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

from ray_tpu_torch.scripts.flash_bench import (bf16_within_ulp, cosine,
                                               device_ms, flash_inputs,
                                               host_us, ptxas_report,
                                               warm_clocks)

OUT = Path(__file__).resolve().parent / "chip_smoke_out"
SOURCES = {"fused_norm": "ray_tpu_torch/ops/csrc/fused_norm.cu",
           "flash_attention": "ray_tpu_torch/ops/csrc/flash_attention.cu"}

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
NORM_KERNELS = ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd")
RMS_KERNELS = ("rms_fwd", "rms_bwd")
FLASH_KERNELS = ("flash_fwd", "flash_dkv", "flash_dq")
PORTED = NORM_KERNELS + RMS_KERNELS + FLASH_KERNELS

BATCH, SEQ, D_MODEL, N_HEAD = 8, 1024, 768, 12
ROWS = BATCH * SEQ
# Llama small (LlamaConfig.small()) at batch 4: 8192 tokens a step.
L_BATCH, L_SEQ, L_D_MODEL, L_N_HEAD = 4, 2048, 1024, 16
L_ROWS = L_BATCH * L_SEQ
WARMUP, STEPS = 2, 4
DENSE_WARMUP, DENSE_STEPS = 1, 3
# Launches per train step of the fused config with remat="dots": two norms
# per block plus the final one, one attention per block; the forward ones
# run again when backward recomputes each block (the checkpoint policy
# saves matrix products only, so the flash forward is recomputed too).
EXPECTED_PER_STEP = {"ln_fwd": 2 * 25 - 1, "ln_bwd": 25, "gelu_fwd": 24,
                     "gelu_bwd": 12, "rms_fwd": 0, "rms_bwd": 0,
                     "flash_fwd": 24, "flash_dkv": 12, "flash_dq": 12}
EXPECTED_DENSE = dict(EXPECTED_PER_STEP, flash_fwd=0, flash_dkv=0, flash_dq=0)
# The Llama step, by the same rule over 16 blocks: rms_fwd 2*2*16 + 1,
# rms_bwd 2*16 + 1, flash 2*16 / 16 / 16.
EXPECTED_LLAMA = {"ln_fwd": 0, "ln_bwd": 0, "gelu_fwd": 0, "gelu_bwd": 0,
                  "rms_fwd": 65, "rms_bwd": 33, "flash_fwd": 32,
                  "flash_dkv": 16, "flash_dq": 16}
# The MoE step: Llama's attention over 16 blocks, its norms the plain chain.
EXPECTED_MOE = dict(EXPECTED_LLAMA, rms_fwd=0, rms_bwd=0)
# Flash check shapes (b, t, h, d, causal): the GPT-2-small one first.
# Then the tile edges of the warp-specialised kernels (128-row fixed tiles;
# swept tiles of 128 or 64 keys in flash_fwd, 64 or 16 q rows in flash_dkv,
# 64 keys in flash_dq), at B*H = 3.
FLASH_EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 2049)
FLASH_CASES = [(BATCH, SEQ, N_HEAD, 64, True), (1, 77, 2, 64, True),
               (1, 1000, 2, 64, True), (1, 1000, 2, 128, True),
               (1, 77, 2, 128, False), (1, 1000, 2, 64, False)] + [
    (1, t, 3, d, causal) for t in FLASH_EDGE_SEQS for d in (64, 128)
    for causal in (True, False)]
FLASH_LLAMA_CASE = (L_BATCH, L_SEQ, L_N_HEAD, 64, True)
# (rows, d) of the norm checks at odd widths, all six kernels; then the
# RMSNorm kernels alone around their one-warp rows (up to 1024 wide and
# read 16 bytes at a time), with 37 and 45 rows, not a multiple of
# rms_fwd's 8-row CTA or of rms_bwd's row block; then views one element
# past a 16-byte boundary (the multi-warp rows, an element at a time).
NORM_ODD_WIDTHS = ((37, 100), (64, 8192), (37, 2050))
RMS_WARP_WIDTHS = ((37, 1), (37, 31), (37, 1024), (45, 1024), (37, 768),
                   (45, 768), (37, 1025), (37, 1032))
RMS_UNALIGNED_WIDTHS = ((21, 96), (21, 1024))
# GELU lengths: shorter than one CTA's span of 16-byte packs (100),
# not a multiple of a pack (1001), whole CTAs plus a tail of elements
# (8199, 98309); each also on a view one element past a 16-byte boundary.
GELU_ODD_LENGTHS = (100, 1001, 8199, 3 * 8192 * 4 + 5)
# The LayerNorm kernels around their one-warp rows (up to 1024 wide and
# read 16 bytes at a time): 37 and 45 rows are not a multiple of ln_bwd's
# 32-row block; 769 is not readable 16 bytes at a time, 1025 too wide.
LN_WARP_WIDTHS = ((37, 768), (45, 768), (37, 769), (64, 1024), (64, 1025))
CROSSOVER_SEQS = (512, 1024, 2048)
# The serving phase: requests per engine and new tokens a request; the
# fp32 check's prompts and tokens.
SERVE_REQUESTS, SERVE_NEW_TOKENS = 64, 64
NAIVE_PROMPTS, NAIVE_TOKENS = 4, 8
# The served (bf16) engine against its fp32 copy: the smallest per-prompt
# cosine of the prefill and decode logits, and the largest relative error
# of the K/V cache over the prompts' slots. bf16 rounding alone gave
# cosines of 0.99986-0.99994 and cache errors of 0.009 (GPT-2 small) and
# 0.012 (Llama small) on an H100 80GB HBM3 at 700 W; a cache write 10% off
# gives 0.097 at tiny width.
SERVED_COSINE, SERVED_CACHE_REL = 0.999, 0.03


class PhaseError(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# -- measurement helpers -------------------------------------------------------


def compare(torch, name, got, want, fp32_tol, failures) -> float:
    """Check one output against the plain version; returns max abs error."""
    err = float((got.float() - want.float()).abs().max())
    if got.dtype == torch.bfloat16:
        ok = bf16_within_ulp(got, want)
    else:
        ok = err <= fp32_tol * max(1.0, float(want.abs().max()))
    if not ok:
        failures.append(f"{name}: max abs err {err:.3e} ({got.dtype})")
    return err


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
                c = cosine(a, b)
                if not c > 0.9999:
                    failures.append(f"ln_bwd {part} {case}: cosine {c}")
        errs["ln_bwd"] = max(errs["ln_bwd"], *e)
        again = fn.ln_bwd(x, mu_r, rstd_r, scale, dy, res)
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            failures.append(f"ln_bwd {case}: two calls differ")
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
    times = {name: {"ms": device_ms(kern, flush),
                    "plain_ms": device_ms(plain, flush),
                    "library_ms": device_ms(lib, flush),
                    **bound(nbytes, ops, spec, "fp32_flops")}
             for name, (kern, plain, lib, nbytes, ops) in cases.items()}
    # The library's backward has no dres add; with it, it does ln_bwd's work.
    times["ln_bwd"]["library_dres_ms"] = device_ms(
        lambda: cases["ln_bwd"][2]()[0] + dres, flush)
    return times


def _shifted(torch, t):
    """A copy of ``t`` one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, device=t.device, dtype=t.dtype)
    flat[1:] = t.flatten()
    return flat[1:].view(t.shape)


def check_rms(torch, fn, rows, d, dtype, failures, seed, shift=False):
    """rms_fwd and rms_bwd (with and without dres) against their plain
    versions, rms_bwd twice for the same bits; with ``shift`` every input
    one element past a 16-byte boundary. Returns (errors by kernel,
    inputs) for timing."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    dres = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    if shift:
        x, scale, dy, dres = (_shifted(torch, t) for t in (x, scale, dy, dres))
    tag = (f"[{rows}x{d} {str(dtype).split('.')[-1]}"
           f"{' unaligned' if shift else ''}]")
    y, rstd = fn.rms_fwd(x, scale)
    y_r, rstd_r = fn.ref_rms_fwd(x, scale)
    errs = {"rms_fwd": max(
        compare(torch, f"rms_fwd y {tag}", y, y_r, 1e-5, failures),
        compare(torch, f"rms_fwd rstd {tag}", rstd, rstd_r, 1e-5, failures))}
    errs["rms_bwd"] = 0.0
    for res in (None, dres):
        dx, dscale = fn.rms_bwd(x, rstd_r, scale, dy, res)
        dx_r, dscale_r = fn.ref_rms_bwd(x, rstd_r, scale, dy, res)
        case = f"{tag}{' +dres' if res is not None else ''}"
        e = [compare(torch, f"rms_bwd dx {case}", dx, dx_r, 1e-4, failures)]
        if dtype == torch.float32:
            e.append(compare(torch, f"rms_bwd dscale {case}", dscale,
                             dscale_r, 1e-4, failures))
        else:
            e.append(float((dscale - dscale_r).abs().max()))
            c = cosine(dscale, dscale_r)
            if not c > 0.9999:
                failures.append(f"rms_bwd dscale {case}: cosine {c}")
        errs["rms_bwd"] = max(errs["rms_bwd"], *e)
        again = fn.rms_bwd(x, rstd_r, scale, dy, res)
        if not (torch.equal(dx, again[0]) and torch.equal(dscale, again[1])):
            failures.append(f"rms_bwd {case}: two calls differ")
    torch.cuda.synchronize()
    return errs, dict(x=x, scale=scale, dy=dy, dres=dres, rstd=rstd_r)


def check_gelu(torch, fn, n, dtype, failures, seed):
    """gelu_fwd and gelu_bwd alone against their plain versions on n
    elements, aligned and on views one element past a 16-byte boundary."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (2 * torch.randn(n + 1, device="cuda", generator=g)).to(dtype)
    dy = torch.randn(n + 1, device="cuda", generator=g).to(dtype)
    for shift in (0, 1):
        xs, gs = x[shift:shift + n], dy[shift:shift + n]
        tag = f"[n={n} {str(dtype).split('.')[-1]} shift {shift}]"
        compare(torch, f"gelu_fwd {tag}", fn.gelu_fwd(xs), fn.ref_gelu(xs),
                1e-5, failures)
        compare(torch, f"gelu_bwd {tag}", fn.gelu_bwd(xs, gs),
                fn.ref_gelu_bwd(xs, gs), 1e-4, failures)
    torch.cuda.synchronize()


def time_rms(torch, fn, inp, spec, flush):
    """{rms_fwd, rms_bwd: {ms, plain_ms, library_ms, bound_ms, ...}}. The
    yardstick is ``F.rms_norm`` (weight in the input's dtype) and its
    autograd backward for (x, weight), which has no dres add. The bound
    counts each input read once and each output written once: rms_bwd's
    dscale is [D]; the partial rows it writes, one per block of
    ``rt_rms_bwd_rows_per_block()`` = 64 rows, and reads back to sum them
    are not counted."""
    F = torch.nn.functional
    x, scale, dy, dres, rstd = (inp[k] for k in ("x", "scale", "dy", "dres",
                                                 "rstd"))
    rows, d = x.shape
    es = x.element_size()
    w_l = scale.to(x.dtype)
    x_l = x.detach().requires_grad_(True)
    w_g = w_l.detach().requires_grad_(True)
    y_l = F.rms_norm(x_l, (d,), w_g, fn.RMS_EPS)
    cases = {
        "rms_fwd": (lambda: fn.rms_fwd(x, scale),
                    lambda: fn.ref_rms_fwd(x, scale),
                    lambda: F.rms_norm(x, (d,), w_l, fn.RMS_EPS),
                    2 * rows * d * es + rows * 4 + d * 4, 4 * rows * d),
        "rms_bwd": (lambda: fn.rms_bwd(x, rstd, scale, dy, dres),
                    lambda: fn.ref_rms_bwd(x, rstd, scale, dy, dres),
                    lambda: torch.autograd.grad(y_l, (x_l, w_g), dy,
                                                retain_graph=True),
                    4 * rows * d * es + rows * 4 + 2 * d * 4, 10 * rows * d),
    }
    return {name: {"ms": device_ms(kern, flush),
                   "plain_ms": device_ms(plain, flush),
                   "library_ms": device_ms(lib, flush),
                   **bound(nbytes, ops, spec, "fp32_flops")}
            for name, (kern, plain, lib, nbytes, ops) in cases.items()}


def bound(nbytes, ops, spec, rate):
    """The least time for ``nbytes`` of device-memory traffic and ``ops``
    operations at the ``rate`` peak: the larger of the two, and which."""
    t_bytes = nbytes / spec["hbm_bytes_s"] * 1e3
    t_ops = ops / spec[rate] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def check_flash(torch, fa, case, failures, seed, packed=True):
    """Each flash kernel against its plain version at one shape; returns
    (max abs error by kernel, inputs) for timing."""
    b, t, h, d, causal = case
    q, k, v, do = flash_inputs(b, t, h, d, seed, packed)
    kw = dict(softmax_scale=d ** -0.5, causal=causal)
    tag = f"[B={b} T={t} H={h} D={d} {'causal' if causal else 'full'}]"
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.ref_flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(out_r, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_r, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_r, delta, **kw)
    dq_r, dk_r, dv_r = fa.ref_flash_bwd(q, k, v, out_r, lse_r, do, **kw)
    torch.cuda.synchronize()
    lse_err = float((lse - lse_r).abs().max())
    lse_tol = 1e-4 * max(1.0, float(lse_r.abs().max()))
    if not lse_err <= lse_tol:
        failures.append(f"flash_fwd lse {tag}: max abs err {lse_err:.3e} > "
                        f"{lse_tol:.3e}")
    errs = {}
    for kname, pairs in (("flash_fwd", (("out", out, out_r),)),
                         ("flash_dkv", (("dk", dk, dk_r), ("dv", dv, dv_r))),
                         ("flash_dq", (("dq", dq, dq_r),))):
        errs[kname] = lse_err if kname == "flash_fwd" else 0.0
        for oname, got, want in pairs:
            err = float((got.float() - want.float()).abs().max())
            errs[kname] = max(errs[kname], err)
            if t == 1 and oname in ("dq", "dk"):
                # One key: dS is 0 up to the rounding of dO.V - delta, so
                # both versions are that noise; no cosine is defined.
                if not err <= 2e-3:
                    failures.append(f"{kname} {oname} {tag}: max abs err "
                                    f"{err:.3e} > 2e-3")
                continue
            cos = cosine(got, want)
            if not cos > 0.9999:
                failures.append(f"{kname} {oname} {tag}: cosine {cos:.6f}, "
                                f"max abs err {err:.3e}")
    print(f"flash check {tag}: lse err {lse_err:.2e}, max abs err "
          + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    return errs, dict(q=q, k=k, v=v, do=do, lse=lse_r, delta=delta,
                      out=out_r, kw=kw)


def time_flash(torch, fa, inp, spec, flush):
    """{kernel: {ms, host_us, plain_ms, library_ms, bound_ms, bound_by,
    ...}} at the inputs' shape; host_us is the wrapper's host cost per call
    (``host_us``). The yardstick is ``scaled_dot_product_attention``:
    its forward for flash_fwd, its backward (dq, dk, dv and its own delta)
    for both flash_dkv and flash_dq."""
    F = torch.nn.functional
    q, k, v, do, lse, delta, kw = (inp[x] for x in ("q", "k", "v", "do",
                                                    "lse", "delta", "kw"))
    b, t, h, d = q.shape
    qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
    leaves = [x.detach().requires_grad_(True) for x in (qh, kh, vh)]
    o_l = F.scaled_dot_product_attention(*leaves, is_causal=kw["causal"])
    do_h = do.transpose(1, 2)
    sdpa_bwd = device_ms(lambda: torch.autograd.grad(
        o_l, leaves, do_h, retain_graph=True), flush)
    # The (q, k) pairs the causal mask keeps, or all of them.
    pairs = t * (t + 1) // 2 if kw["causal"] else t * t
    bh, act, stat = b * h, b * t * h * d * 2, b * h * t * 4
    cases = {
        "flash_fwd": (lambda: fa.flash_fwd(q, k, v, **kw),
                      lambda: fa.ref_flash_fwd(q, k, v, **kw),
                      lambda: F.scaled_dot_product_attention(
                          qh, kh, vh, is_causal=kw["causal"]),
                      4 * act + stat, 4 * bh * pairs * d),
        "flash_dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, **kw),
                      lambda: fa.ref_flash_dkv(q, k, v, do, lse, delta, **kw),
                      None, 6 * act + 2 * stat, 8 * bh * pairs * d),
        "flash_dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, **kw),
                     lambda: fa.ref_flash_dq(q, k, v, do, lse, delta, **kw),
                     None, 5 * act + 2 * stat, 6 * bh * pairs * d),
    }
    return {name: {
        "ms": device_ms(kern, flush),
        "host_us": host_us(kern),
        "plain_ms": device_ms(plain, flush),
        "library_ms": device_ms(lib, flush) if lib else sdpa_bwd,
        "library": ("scaled_dot_product_attention forward" if lib else
                    "scaled_dot_product_attention backward (dq, dk, dv)"),
        **bound(nbytes, ops, spec, "bf16_flops")}
        for name, (kern, plain, lib, nbytes, ops) in cases.items()}


def time_crossover(torch, fa, dense, flush):
    """Forward plus backward device ms of dense and flash causal attention
    at each of CROSSOVER_SEQS (B=8, H=12, D=64, bf16). Timing only."""
    rows = []
    for t in CROSSOVER_SEQS:
        q, k, v, do = flash_inputs(BATCH, t, N_HEAD, 64, t)
        leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
        row = {"seq": t}
        for name, fn in (("dense_ms", dense), ("flash_ms",
                                                fa.flash_causal_attention)):
            row[name] = device_ms(lambda: torch.autograd.grad(
                fn(*leaves), leaves, do), flush, n=10)
        rows.append(row)
        print(f"attention fwd+bwd at T={t} (B*H=96, D=64, bf16): dense "
              f"{row['dense_ms']:.3f} ms, flash {row['flash_ms']:.3f} ms")
    return rows


def run_step(torch, counters, label, measure, cfg, batch, warmup, steps,
             expected):
    """One measured train-step run with every kernel counter set to 0 just
    before it; returns the step dict with launches and launches per step,
    after checking the loss and the per-step launch counts."""
    for c in counters:
        c.clear()
    step = measure(cfg, batch, steps=steps, warmup=warmup, device="cuda")
    launches = {k: sum(c[k] for c in counters) for k in PORTED}
    step["max_memory_allocated"] = step["peak_memory_bytes"]
    step["launches"] = launches
    n_steps = step["warmup"] + steps
    step["launches_per_step"] = {k: launches[k] / n_steps for k in PORTED}
    losses = step["losses"]
    print(f"train step ({'flash' if cfg.use_flash else 'dense'} attention): "
          f"{label} {cfg.n_params / 1e6:.0f}M batch {batch} seq {cfg.seq_len}: "
          f"{step['tok_s']:.1f} tok/s, {step['ms_step']:.2f} ms/step, MFU "
          f"{step['mfu']:.2f}%, max_memory_allocated "
          f"{step['max_memory_allocated'] / 2**30:.2f} GiB, losses "
          f"{[round(x, 4) for x in losses]}, launches/step "
          f"{step['launches_per_step']}")
    require(all(math.isfinite(x) for x in losses), f"non-finite loss: {losses}")
    require(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for k, want in expected.items():
        got = step["launches_per_step"][k]
        require(got == want, f"{k}: {got} launches per step, expected {want}")
    return step


def compare_paths(torch, loss_fn, params, tokens, paths, contexts=None,
                  loss_only=()):
    """Loss and whole-tree gradient of every path in ``paths`` (name ->
    config, run in that order, each inside ``contexts[name]()`` where
    given) on the same weights and batch; each path other than "plain"
    against "plain": loss within rtol 1e-2, and, unless the path is in
    ``loss_only``, gradient cosine > 0.999."""
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.train.train_step import value_and_grad

    contexts = contexts or {}
    out = {}
    for pname, c in paths.items():
        with contexts.get(pname, contextlib.nullcontext)():
            loss, grads = value_and_grad(lambda p, b: loss_fn(p, b, c),
                                         params, {"tokens": tokens})
        leaves = tree_leaves(grads)
        require(all(a.shape == p.shape for a, p in zip(leaves,
                                                       tree_leaves(params))),
                f"{pname}: gradient shapes differ from the parameters'")
        require(all(bool(torch.isfinite(a).all()) for a in leaves),
                f"{pname}: non-finite gradients")
        out[pname] = (float(loss), torch.cat([a.flatten() for a in leaves]))
        del grads, leaves
    loss_p, flat_p = out.pop("plain")
    report = {}
    for pname, (loss_k, flat_k) in out.items():
        cos = cosine(flat_k, flat_p)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        report[pname] = {"loss_kernel": loss_k, "loss_plain": loss_p,
                         "loss_rel_diff": rel, "grad_cosine": cos}
        print(f"{pname} vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(rel {rel:.2e}), gradient cosine {cos:.6f}"
              f"{' (printed, not held)' if pname in loss_only else ''}")
        require(rel <= 1e-2, f"{pname}: losses differ by {rel:.3e} (rtol 1e-2)")
        if pname not in loss_only:
            require(cos > 0.999, f"{pname}: gradient cosine {cos} <= 0.999")
    return report


def compare_moe_paths(torch, loss_fn, params, tokens, cfg):
    """The MoE on flash against dense attention (phase 6). Its router's
    top-k is a discrete choice: a bf16 rounding difference in attention
    moves a token whose k-th and (k+1)-th probabilities nearly tie to
    another expert, and shifts the buffer slots (so the drops) of the
    tokens after it. So the whole-tree gradient is held (cosine > 0.999)
    with the plain path's choices replayed in the flash path -- the gates
    still the flash path's own probabilities of those experts -- and the
    free-running flash path is held on its loss alone, its gradient cosine
    and the token-layers it routes differently printed."""
    from ray_tpu_torch.ops import moe as moe_ops

    top_k = moe_ops._top_k
    routes = {"plain": [], "moe flash": []}

    @contextlib.contextmanager
    def patched(fn):
        moe_ops._top_k = fn
        try:
            yield
        finally:
            moe_ops._top_k = top_k

    def recording(name):
        def rec(probs, k):
            values, idx = top_k(probs, k)
            routes[name].append(idx)
            return values, idx
        return patched(rec)

    def replaying():
        recorded = iter(routes["plain"])

        def rep(probs, k):
            idx = next(recorded)
            return probs.gather(1, idx), idx
        return patched(rep)

    report = compare_paths(
        torch, loss_fn, params, tokens,
        {"plain": dataclasses.replace(cfg, use_flash=False),
         "moe flash": cfg, "moe flash, plain routes": cfg},
        contexts={"plain": lambda: recording("plain"),
                  "moe flash": lambda: recording("moe flash"),
                  "moe flash, plain routes": replaying},
        loss_only=("moe flash",))
    # The forward's choices: the first n_layer calls (the recompute's
    # repeat them).
    pairs = list(zip(routes["plain"], routes["moe flash"]))[:cfg.n_layer]
    moved = sum(int((a.sort(dim=1).values != b.sort(dim=1).values)
                    .any(dim=1).sum()) for a, b in pairs)
    rows = sum(a.shape[0] for a, _ in pairs)
    report["moe flash"]["token_layers_routed_differently"] = moved
    report["moe flash"]["token_layers"] = rows
    print(f"moe flash vs plain path: {moved} of {rows} token-layers choose "
          f"other experts ({moved / rows:.3%})")
    return report


def serve_phase(torch, counters, smi):
    """Phase 7: both serving engines at full width, each with the kernel
    counters zeroed just before it and read just after, then the fp32
    copies against the naive loop. Returns the report entries."""
    import gc

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.scripts.measure import (SERVE_ENGINES, measure_serve,
                                               serve_prompts, serve_vs_naive,
                                               served_vs_fp32)

    out = {}
    for model, cfg in (("gpt2", GPT2Config.small()),
                       ("llama", LlamaConfig.small())):
        for c in counters:
            c.clear()
        r = measure_serve(model, "small", requests=SERVE_REQUESTS,
                          max_new_tokens=SERVE_NEW_TOKENS, device="cuda")
        r["kernel_launches"] = {k: sum(c[k] for c in counters)
                                for k in PORTED}
        gve = r["graph_vs_eager"]
        require(r["decode_tok_s_full"] is not None,
                f"serving {model}: no sample saw every slot busy")
        print(f"serving {model} {cfg.n_params / 1e6:.0f}M {r['dtype']}, "
              f"{r['max_batch']} slots, cache {r['cache_len']}, prefill "
              f"{r['prefill_rows']}x{r['max_prompt_len']}, "
              f"{SERVE_REQUESTS} requests x {SERVE_NEW_TOKENS} tokens "
              f"[{smi}]: decode {r['decode_tok_s_full']:.1f} tok/s at full "
              f"occupancy ({r['full_window_steps']} steps), "
              f"{r['serve_tok_s']:.1f} tok/s over the run "
              f"({r['wall_s']:.2f} s); decode step {r['step_ms_graph']:.3f} "
              f"ms graph / {r['step_ms_eager']:.3f} ms eager; prefill lane "
              f"{r['prefill_ms_graph']:.3f} / {r['prefill_ms_eager']:.3f} ms; "
              f"TTFT p50 {r['ttft_ms_p50']:.1f} ms p99 "
              f"{r['ttft_ms_p99']:.1f} ms; peak memory "
              f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; build "
              f"{r['build_s']:.1f} s")
        print(f"serving {model} [{smi}]: compiles {r['compiles']}, "
              f"tokens/request "
              f"{sorted(set(r['tokens_per_request']))}, graph vs eager step: "
              f"tokens equal {gve['tokens_equal']}, logits max abs diff "
              f"{gve['logits_max_abs_diff']:.3e}, kernel launches "
              f"{sum(r['kernel_launches'].values())}")
        require(not r["errors"] and all(
            n == SERVE_NEW_TOKENS for n in r["tokens_per_request"]),
            f"serving {model}: tokens per request {r['tokens_per_request']}, "
            f"errors {r['errors']}")
        require(r["compiles"] == {"decode": 1, "prefill": 1},
                f"serving {model}: compiles {r['compiles']}")
        require(gve["tokens_equal"],
                f"serving {model}: graph and eager decode tokens differ")
        require(not any(r["kernel_launches"].values()),
                f"serving {model} launched kernels: {r['kernel_launches']}")
        gc.collect()
        torch.cuda.empty_cache()
        prompts = serve_prompts(NAIVE_PROMPTS, cfg.vocab_size,
                                SERVE_ENGINES[model]["max_prompt_len"])
        served = served_vs_fp32(model, cfg, prompts=prompts, device="cuda")
        print(f"serving {model} {r['dtype']} vs its fp32 copy [{smi}]: "
              f"logits cosine prefill {served['prefill_cosine']:.6f}, "
              f"decode {served['decode_cosine']:.6f}; K/V cache relative "
              f"error {served['cache_rel_err']:.3e}; first tokens agree "
              f"{served['first_agree']}/{served['n']}, next "
              f"{served['next_agree']}/{served['n']}")
        require(min(served["prefill_cosine"], served["decode_cosine"])
                > SERVED_COSINE, f"serving {model}: {r['dtype']} logits "
                f"cosine to fp32 <= {SERVED_COSINE}: {served}")
        require(served["cache_rel_err"] < SERVED_CACHE_REL,
                f"serving {model}: {r['dtype']} K/V cache relative error "
                f"to fp32 >= {SERVED_CACHE_REL}: {served}")
        r["vs_fp32"] = served
        naive = serve_vs_naive(
            model, dataclasses.replace(cfg, dtype=torch.float32),
            prompts=prompts, n_tokens=NAIVE_TOKENS, device="cuda")
        print(f"serving {model} fp32 vs naive loop [{smi}]: match "
              f"{naive['match']}, "
              f"{naive['compared']} of {NAIVE_PROMPTS * NAIVE_TOKENS} tokens "
              f"compared, smallest top-2 logit gap {naive['min_gap']:.3e}")
        require(naive["match"], f"serving {model}: engine tokens differ "
                f"from the naive loop: {naive['prompts']}")
        r["vs_naive_fp32"] = naive
        out[model] = r
        gc.collect()
        torch.cuda.empty_cache()
    return out


def trainer_phase(torch, counters, cfg, ref, smi):
    """Phase 4b: ``measure_trainer_gpt2`` -- phase 4's GPT-2 flash run
    (``ref``: same config, init and batch) through ``CudaTrainer(...).fit()``
    with every kernel counter set to 0 just before it and read just after.
    Holds: each kernel's launches, those of phase 4's steps plus one step
    for ``step_cost``'s counted call; the losses; the session's MFU gauge
    against ``step_cost``'s FLOPs over the trainer's own ms/step (the
    interval between its reports) within 5%, and each step's gauge
    against those FLOPs over its host and compute phases (phase 4's MFU,
    on the analytic count and on ``step_cost``'s, is printed beside
    them, not held: the trainer's step is not phase 4's); the FLOP
    count of the kernel path against the plain path's (dense attention,
    plain norms) on the same state and batch; ``device_telemetry``
    naming the card; and a run that raises before step 3, restarts from
    its step-2 checkpoint and gives phase 4's losses. Returns the
    report entry."""
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss
    from ray_tpu_torch._device import peak_flops_per_chip
    from ray_tpu_torch.scripts.measure import measure_trainer_gpt2
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
    from ray_tpu_torch.util import device_telemetry
    from ray_tpu_torch.util.xla_cost import step_cost

    n_steps = WARMUP + STEPS
    for c in counters:
        c.clear()
    run = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                               device="cuda")
    launches = {k: sum(c[k] for c in counters) for k in PORTED}
    run["launches"] = launches
    calls = n_steps + 1  # the steps, and step_cost's call of the step
    gaps = [abs(a - b) / abs(b) for a, b in zip(run["losses"], ref["losses"])]
    same_flops_mfu = ref["mfu"] * run["flops_ratio"]
    peak = peak_flops_per_chip(torch.cuda.get_device_name(0))
    own_clock_mfu = (run["step_cost"]["flops"] / (run["ms_step"] / 1e3)
                     / peak * 100)
    run["own_clock_mfu"] = own_clock_mfu
    mem = run["peak_memory_bytes"] / 2**30
    print(f"trainer: CudaTrainer(...).fit(), GPT-2 {cfg.n_params / 1e6:.0f}M "
          f"batch {BATCH} seq {cfg.seq_len}, 1 worker [{smi}]: "
          f"{run['ms_step']:.2f} ms/step ({run['tok_s']:.1f} tok/s), peak "
          f"memory {mem:.2f} GiB; measure_gpt2 {ref['ms_step']:.2f} ms/step "
          f"({ref['tok_s']:.1f} tok/s), peak memory "
          f"{ref['peak_memory_bytes'] / 2**30:.2f} GiB; gap "
          f"{run['ms_step'] / ref['ms_step'] - 1:+.2%}; fit {run['wall_s']:.2f}"
          f" s; losses {[round(x, 4) for x in run['losses']]}, largest "
          f"relative gap to phase 4 {max(gaps):.3e}")
    print(f"trainer: step_cost {run['step_cost']['flops'] / 1e12:.4f} TFLOP "
          f"a step ({run['step_cost']['flops_by_op']}), analytic "
          f"{run['analytic_flops'] / 1e12:.4f}, ratio {run['flops_ratio']:.4f};"
          f" MFU gauge {run['mfu_gauge']:.3f}%, step_cost's FLOPs over the "
          f"trainer's ms/step {own_clock_mfu:.3f}% (ratio "
          f"{run['mfu_gauge'] / own_clock_mfu:.4f}); measure_gpt2's MFU "
          f"{ref['mfu']:.3f}% (analytic FLOPs), {same_flops_mfu:.3f}% on "
          f"step_cost's FLOPs; per step (host, compute, sync s): "
          f"{[(round(a['host'], 4), round(a['compute'], 4), round(a['sync'], 4)) for a in run['anatomy']]}")
    print(f"trainer: launches through the trainer {launches} over {calls} "
          f"calls of the step ({n_steps} steps, 1 in step_cost)")
    require(all(math.isfinite(x) for x in run["losses"]),
            f"trainer: non-finite loss {run['losses']}")
    require(run["steps_run"] == list(range(1, n_steps + 1)),
            f"trainer: reported steps {run['steps_run']}")
    require(max(gaps) <= 1e-5, f"trainer: losses off phase 4's by "
            f"{max(gaps):.3e} (rtol 1e-5)")
    for k in PORTED:
        want = ref["launches_per_step"][k] * calls
        require(launches[k] == want,
                f"trainer: {k} launched {launches[k]} times, expected {want}")
    require(abs(run["mfu_gauge"] / own_clock_mfu - 1) <= 0.05,
            f"trainer: MFU gauge {run['mfu_gauge']:.3f}% vs "
            f"{own_clock_mfu:.3f}% from step_cost's FLOPs over the "
            f"trainer's {run['ms_step']:.2f} ms/step (> 5%)")
    # The gauge's own arithmetic: step_cost's FLOPs over each step's host +
    # compute phases, against the card's peak.
    for a in run["anatomy"]:
        want = run["step_cost"]["flops"] / (a["host"] + a["compute"]) / peak
        require(abs(a["mfu"] - want * 100) <= 1e-6 * a["mfu"],
                f"trainer: step {a['step']} MFU gauge {a['mfu']} vs "
                f"{want * 100} from its phases")

    # The FLOP count of the kernel path against the plain path's.
    gen = torch.Generator(device="cuda")
    state = make_init_fn(lambda g: gpt2_init(g, cfg, device="cuda"))(
        gen.manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(1))
    plain = dataclasses.replace(cfg, use_flash=False, fused_norm=False)
    counts = {}
    for name, c in (("kernel", cfg), ("plain", plain)):
        step_fn = make_train_step(lambda p, b, c=c: gpt2_loss(p, b, c))
        counts[name] = step_cost(step_fn, state, {"tokens": tokens})["flops"]
    del state
    rel = abs(counts["kernel"] / counts["plain"] - 1)
    run["flops_kernel_vs_plain"] = {**counts, "rel": rel}
    print(f"trainer: step_cost of the kernel path {counts['kernel']:.6e} "
          f"FLOP, of the plain path {counts['plain']:.6e} (rel {rel:.2e})")
    require(rel <= 0.01, f"trainer: kernel path counts {counts['kernel']} "
            f"FLOP, plain path {counts['plain']} (> 1%)")

    snap = device_telemetry.snapshot()
    run["telemetry"] = snap
    name = torch.cuda.get_device_name(0)
    print(f"trainer: device_telemetry.snapshot(): "
          f"{[(d['device_kind'], d.get('bytes_in_use')) for d in snap['devices']]}")
    require(snap["available"] and snap["devices"]
            and snap["devices"][0]["device_kind"] == name,
            f"trainer: device_telemetry names {snap['devices']}, not {name}")

    rerun = measure_trainer_gpt2(cfg, BATCH, steps=n_steps, warmup=WARMUP,
                                 fail_at=3, device="cuda")
    rgaps = [abs(a - b) / abs(b)
             for a, b in zip(rerun["losses"], ref["losses"])]
    print(f"trainer: raised before step 3, restarted {rerun['restarts']} "
          f"time(s) from the step-2 checkpoint: steps {rerun['steps_run']}, "
          f"losses {[round(x, 4) for x in rerun['losses']]}, largest "
          f"relative gap to phase 4 {max(rgaps):.3e}; downtime "
          f"{rerun['goodput']['downtime_s']} s")
    require(rerun["restarts"] == 1
            and rerun["steps_run"] == list(range(1, n_steps + 1)),
            f"trainer restart: {rerun['restarts']} restarts, steps "
            f"{rerun['steps_run']}")
    require(max(rgaps) <= 1e-5, f"trainer restart: losses off phase 4's by "
            f"{max(rgaps):.3e} (rtol 1e-5)")
    run["restart"] = {k: rerun[k] for k in ("losses", "steps_run",
                                            "restarts", "goodput")}
    return run


def _bits_equal(torch, a, b) -> bool:
    """Same dtype, shape and bits (a DTensor by its local shard); a Python
    value (the step) by equality."""
    if not isinstance(a, torch.Tensor):
        return a == b
    if hasattr(a, "to_local"):
        if a.placements != b.placements:
            return False
        a, b = a.to_local(), b.to_local()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def checkpoint_round_trip(torch, mesh, cfg, smi):
    """The sharded GPT-2 state after one step, through ``save_sharded``
    into ``chip_smoke_out/ckpt`` and ``load_sharded`` back onto the same
    mesh: every leaf bit for bit. Returns bytes and seconds."""
    from ray_tpu_torch._tree import tree_leaves
    from ray_tpu_torch.models.gpt2 import gpt2_init, gpt2_loss, gpt2_shardings
    from ray_tpu_torch.train.checkpoint import load_sharded, save_sharded
    from ray_tpu_torch.train.train_step import (make_init_fn, make_train_step,
                                                state_shardings)

    sh = gpt2_shardings(cfg, mesh)
    gen = torch.Generator(device="cuda")
    state = make_init_fn(lambda g: gpt2_init(g, cfg, device="cuda"), sh,
                         mesh)(gen.manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, cfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(1))
    state, _ = make_train_step(lambda p, b: gpt2_loss(p, b, cfg), sh, mesh)(
        state, {"tokens": tokens})
    torch.cuda.synchronize()
    path = OUT / "ckpt"
    shutil.rmtree(path, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        save_sharded(state, str(path))
        save_s = time.perf_counter() - t0
        nbytes = sum(p.stat().st_size for p in path.iterdir())
        t0 = time.perf_counter()
        loaded = load_sharded(str(path), state_shardings(sh))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(path, ignore_errors=True)
    pairs = list(zip(tree_leaves(state), tree_leaves(loaded)))
    same = sum(_bits_equal(torch, a, b) for a, b in pairs)
    print(f"mesh of 1: checkpoint of the GPT-2 state after one step "
          f"[{smi}]: {len(pairs)} leaves, {nbytes / 1e9:.3f} GB, save "
          f"{save_s:.2f} s, load {load_s:.2f} s, {same} of {len(pairs)} "
          f"leaves bit for bit")
    require(same == len(pairs) and loaded["step"] == state["step"],
            f"checkpoint round trip: {same} of {len(pairs)} leaves equal, "
            f"step {loaded['step']} vs {state['step']}")
    return {"bytes": nbytes, "save_s": save_s, "load_s": load_s,
            "leaves": len(pairs), "bit_equal": same}


def mesh_phase(torch, counters, unsharded, smi):
    """Phase 5: a one-rank NCCL group and ``build_mesh(MeshConfig(fsdp=-1))``;
    the GPT-2, Llama and MoE (expert-parallel over the one-rank ``ep``
    group) main-path steps through ``measure_*(mesh=...)``, each with every
    kernel counter set to 0 just before it and read just after, held to
    the unsharded runs of phase 4 (``unsharded``: same init and batch);
    then the checkpoint round trip; then 2 NCCL ranks of GPT-2 at fsdp=2
    and of the MoE at ep=2 where there are two cards. Returns the report
    entries."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.models.moe import MoEConfig
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.scripts.measure import (FUSED_FLAGS, LLAMA_FLAGS,
                                               MOE_FLAGS, measure_gpt2,
                                               measure_llama, measure_moe)

    out = {}
    t0 = time.perf_counter()
    distributed.initialize("chip-smoke", 0, 1)
    try:
        mesh = build_mesh(MeshConfig(fsdp=-1))
        out["setup_s"] = time.perf_counter() - t0
        print(f"mesh of 1: {mesh} over a one-rank nccl group, up in "
              f"{out['setup_s']:.2f} s")
        for key, label, measure, cfg, batch in (
                ("gpt2", "GPT-2", measure_gpt2, GPT2Config(**FUSED_FLAGS),
                 BATCH),
                ("llama", "Llama", measure_llama, LlamaConfig(**LLAMA_FLAGS),
                 L_BATCH),
                ("moe", "MoE", measure_moe,
                 MoEConfig(**MOE_FLAGS, expert_parallel=True), L_BATCH)):
            ref = unsharded[key]
            for c in counters:
                c.clear()
            r = measure(cfg, batch, steps=STEPS, warmup=WARMUP,
                        device="cuda", mesh=mesh)
            r["launches"] = {k: sum(c[k] for c in counters) for k in PORTED}
            gaps = [abs(a - b) / abs(b)
                    for a, b in zip(r["losses"], ref["losses"])]
            r["loss_rel_gaps"] = gaps
            print(f"mesh of 1, {label} {cfg.n_params / 1e6:.0f}M batch "
                  f"{batch} seq {cfg.seq_len} [{smi}]: {r['ms_step']:.2f} "
                  f"ms/step, {r['tok_s']:.1f} tok/s, MFU {r['mfu']:.2f}%, "
                  f"peak memory {r['peak_memory_bytes'] / 2**30:.3f} GiB; "
                  f"unsharded {ref['ms_step']:.2f} ms/step, "
                  f"{ref['tok_s']:.1f} tok/s, peak memory "
                  f"{ref['peak_memory_bytes'] / 2**30:.3f} GiB; losses "
                  f"{[round(x, 4) for x in r['losses']]}, largest relative "
                  f"gap to unsharded {max(gaps):.3e}; launches "
                  f"{r['launches']}")
            require(gaps[0] <= 1e-5, f"mesh {key}: first loss off by "
                    f"{gaps[0]:.3e} (rtol 1e-5)")
            require(max(gaps) <= 1e-4, f"mesh {key}: losses off by "
                    f"{max(gaps):.3e} (rtol 1e-4)")
            require(r["launches"] == ref["launches"],
                    f"mesh {key}: launches {r['launches']} vs unsharded "
                    f"{ref['launches']}")
            require(all(r["launches"][k] > 0 for k in PORTED
                        if ref["launches"][k]),
                    f"mesh {key}: a kernel of the path did not launch")
            out[key] = r
        out["checkpoint"] = checkpoint_round_trip(
            torch, mesh, GPT2Config(**FUSED_FLAGS), smi)
    finally:
        distributed.shutdown()
    out["two_ranks"] = two_rank_phase(torch, out["gpt2"], smi, "gpt2")
    out["two_ranks_moe"] = two_rank_phase(torch, out["moe"], smi, "moe")
    return out


# The 2-rank runs: (mesh axis over the two ranks, global batch, label).
TWO_RANK_RUNS = {"gpt2": ("fsdp", BATCH, "GPT-2 small"),
                 "moe": ("ep", L_BATCH, "MoE small")}


def two_rank_phase(torch, one_rank, smi, model):
    """``model`` on 2 NCCL ranks (this script with ``--mesh-rank``), where
    there are two cards: GPT-2 small at fsdp=2, or the MoE at ep=2 (each
    rank routes the whole batch and computes its 4 experts). The first
    loss within rtol 1e-4 of the mesh of 1, the later ones within the bf16
    rule (rtol 1e-2). Otherwise one line saying why it did not run."""
    axis, batch, label = TWO_RANK_RUNS[model]
    n = torch.cuda.device_count()
    if n < 2:
        print(f"mesh of 2 ({axis}=2, {label}): not run: {n} CUDA device "
              "(needs 2)")
        return {"ran": False, "devices": n}
    from ray_tpu_torch.parallel.distributed import free_port

    result = OUT / f"mesh2_{model}.json"
    result.unlink(missing_ok=True)
    address = f"127.0.0.1:{free_port()}"
    procs = [subprocess.Popen([sys.executable, __file__, "--mesh-rank",
                               str(r), "2", address, str(result), model])
             for r in range(2)]
    try:
        rcs = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    require(rcs == [0, 0], f"mesh of 2 ({model}): ranks exited {rcs}")
    r = json.loads(result.read_text())
    gaps = [abs(a - b) / abs(b) for a, b in zip(r["losses"],
                                                one_rank["losses"])]
    print(f"mesh of 2 ({axis}=2), {label} batch {batch} [{smi}]: "
          f"{r['ms_step']:.2f} ms/step, {r['tok_s']:.1f} tok/s, MFU "
          f"{r['mfu']:.2f}%, rank 0 peak memory "
          f"{r['peak_memory_bytes'] / 2**30:.3f} GiB; losses "
          f"{[round(x, 4) for x in r['losses']]}, relative gaps to the mesh "
          f"of 1 {[f'{g:.2e}' for g in gaps]}")
    require(gaps[0] <= 1e-4, f"mesh of 2 ({model}): first loss off by "
            f"{gaps[0]:.3e}")
    require(max(gaps) <= 1e-2, f"mesh of 2 ({model}): losses off by "
            f"{max(gaps):.3e}")
    return {"ran": True, **r, "loss_rel_gaps": gaps}


def mesh_rank_main(rank: int, world: int, address: str, result: str,
                   model: str) -> int:
    """One NCCL rank of ``two_rank_phase``; rank 0 writes the result."""
    import torch

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.moe import MoEConfig
    from ray_tpu_torch.parallel import distributed
    from ray_tpu_torch.parallel.mesh import MeshConfig, build_mesh
    from ray_tpu_torch.scripts.measure import (FUSED_FLAGS, MOE_FLAGS,
                                               measure_gpt2, measure_moe)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    distributed.initialize("chip-smoke-2", rank, world,
                           coordinator_address=address)
    try:
        if model == "gpt2":
            r = measure_gpt2(GPT2Config(**FUSED_FLAGS), BATCH, steps=STEPS,
                             warmup=WARMUP,
                             mesh=build_mesh(MeshConfig(fsdp=world)))
        else:
            r = measure_moe(MoEConfig(**MOE_FLAGS, expert_parallel=True),
                            L_BATCH, steps=STEPS, warmup=WARMUP,
                            mesh=build_mesh(MeshConfig(fsdp=1, ep=world)))
    finally:
        distributed.shutdown()
    if rank == 0:
        Path(result).write_text(json.dumps(r))
    return 0


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

    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init, gpt2_loss
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init, llama_loss
    from ray_tpu_torch.models.moe import MoEConfig, moe_init, moe_loss
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn
    from ray_tpu_torch.ops.attention import dense_causal_attention
    from ray_tpu_torch._device import device_spec
    from ray_tpu_torch.scripts.measure import (FUSED_DENSE_FLAGS, FUSED_FLAGS,
                                               LLAMA_FLAGS, MOE_FLAGS,
                                               measure_gpt2, measure_llama,
                                               measure_moe)

    OUT.mkdir(exist_ok=True)
    report = {"nvidia_smi": smi, "device": name}

    # Phase 2: build.
    t0 = time.perf_counter()
    report["build_s"] = _build.build(list(SOURCES))
    print(f"build: {report['build_s']} s of nvcc, phase "
          f"{time.perf_counter() - t0:.1f} s")
    for lib in SOURCES:
        shutil.copy(_build.library_path(lib).with_suffix(".log"),
                    OUT / f"nvcc_{lib}.log")
    report["ptxas"] = ptxas_report(
        [(OUT / f"nvcc_{lib}.log").read_text() for lib in SOURCES], fa)
    print("ptxas (registers, spill stores/loads B, static + dynamic shared "
          "memory B, notes): " + "; ".join(
              f"{k} {r.get('registers')}, {r.get('spill_stores')}/"
              f"{r.get('spill_loads')}, {r.get('static_smem')} + "
              f"{r.get('dynamic_smem')}, {','.join(r['notes']) or 'none'}"
              for k, r in report["ptxas"].items()))
    spills = [k for k, r in report["ptxas"].items()
              if r.get("spill_stores") or r.get("spill_loads")]
    print(f"ptxas: {len(report['ptxas'])} kernels, spills in "
          f"{', '.join(spills) or 'none'}")

    # Phase 3: each kernel against its plain version.
    spec = device_spec(name)
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    warm_clocks()
    failures = []
    results = {}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype).split(".")[-1]
        errs, inp = check_kernels(torch, fn, ROWS, D_MODEL, dtype, failures, 0)
        times = time_kernels(torch, fn, inp, spec, flush)
        results[key] = {k: {"max_abs_err": errs[k], **times[k]}
                        for k in NORM_KERNELS}
        del inp
        errs, inp = check_rms(torch, fn, L_ROWS, L_D_MODEL, dtype, failures, 1)
        times = time_rms(torch, fn, inp, spec, flush)
        results[key].update({k: {"max_abs_err": errs[k], **times[k]}
                             for k in RMS_KERNELS})
        del inp
    for rows, d in NORM_ODD_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_kernels(torch, fn, rows, d, dtype, failures, rows + d)
            check_rms(torch, fn, rows, d, dtype, failures, rows + d + 1)
    for rows, d in RMS_WARP_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_rms(torch, fn, rows, d, dtype, failures, rows + d + 1)
    for rows, d in RMS_UNALIGNED_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_rms(torch, fn, rows, d, dtype, failures, rows + d + 2,
                      shift=True)
    for n in GELU_ODD_LENGTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_gelu(torch, fn, n, dtype, failures, n)
    for rows, d in LN_WARP_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            check_kernels(torch, fn, rows, d, dtype, failures, rows + d)
    errs, inp = check_flash(torch, fa, FLASH_CASES[0], failures, 0)
    times = time_flash(torch, fa, inp, spec, flush)
    results["bfloat16"].update({k: {"max_abs_err": errs[k], **times[k]}
                                for k in FLASH_KERNELS})
    del inp
    errs, inp = check_flash(torch, fa, FLASH_LLAMA_CASE, failures, 7,
                            packed=False)
    times = time_flash(torch, fa, inp, spec, flush)
    report["flash_llama_shape"] = {k: {"max_abs_err": errs[k], **times[k]}
                                   for k in FLASH_KERNELS}
    del inp
    report["flash_odd_shapes"] = [
        {"case": list(case), "max_abs_err": check_flash(
            torch, fa, case, failures, i + 1)[0]}
        for i, case in enumerate(FLASH_CASES[1:])]
    report["attention_crossover"] = time_crossover(
        torch, fa, dense_causal_attention, flush)
    report["kernels"] = results
    gpt2_shape = f"R={ROWS} D={D_MODEL}"
    llama_shape = f"R={L_ROWS} D={L_D_MODEL}"
    for k in PORTED:
        rows = [("", results["bfloat16"][k])]
        if k in FLASH_KERNELS:
            rows.append((" llama", report["flash_llama_shape"][k]))
        for tag, r in rows:
            if k in FLASH_KERNELS:
                shape = (f"B={L_BATCH} T={L_SEQ} H={L_N_HEAD} D=64" if tag else
                         f"B={BATCH} T={SEQ} H={N_HEAD} D=64")
            else:
                shape = llama_shape if k in RMS_KERNELS else gpt2_shape
            per_step = (EXPECTED_LLAMA if k in RMS_KERNELS or tag
                        else EXPECTED_PER_STEP)[k]
            extra = (f"host_us={r['host_us']:.1f} " if k in FLASH_KERNELS
                     else "")
            if "library_dres_ms" in r:
                extra = f"library_dres_ms={r['library_dres_ms']:.4f} "
            print(f"{k}{tag}: kernel_ms={r['ms']:.4f} {extra}"
                  f"plain_ms={r['plain_ms']:.4f} "
                  f"library_ms={r['library_ms']:.4f} "
                  f"bound_us={r['bound_ms'] * 1e3:.1f} ({r['bound_by']}) "
                  f"max_abs_err={r['max_abs_err']:.3e} "
                  f"launches_per_step={per_step} [bf16, {shape}]")
    require(not failures, "kernel vs plain: " + "; ".join(failures))

    # Phase 4: the train steps -- GPT-2's main path (flash) first, then
    # GPT-2 with dense attention, then Llama's main path, then the MoE's.
    counters = (fn.KERNEL_INVOCATIONS, fa.KERNEL_INVOCATIONS)
    cfg = GPT2Config(**FUSED_FLAGS)
    step = run_step(torch, counters, "GPT-2", measure_gpt2, cfg, BATCH,
                    WARMUP, STEPS, EXPECTED_PER_STEP)
    report["train_step"] = step
    report["train_step_dense"] = run_step(
        torch, counters, "GPT-2", measure_gpt2, GPT2Config(**FUSED_DENSE_FLAGS),
        BATCH, DENSE_WARMUP, DENSE_STEPS, EXPECTED_DENSE)
    lcfg = LlamaConfig(**LLAMA_FLAGS)
    lstep = run_step(torch, counters, "Llama", measure_llama, lcfg, L_BATCH,
                     WARMUP, STEPS, EXPECTED_LLAMA)
    report["train_step_llama"] = lstep
    mcfg = MoEConfig(**MOE_FLAGS)
    mstep = run_step(torch, counters, "MoE", measure_moe, mcfg, L_BATCH,
                     WARMUP, STEPS, EXPECTED_MOE)
    print(f"MoE: {mcfg.n_active_params / 1e6:.0f}M of "
          f"{mcfg.n_params / 1e6:.0f}M parameters active a token; "
          f"{mcfg.n_experts} experts, top-{mcfg.top_k}, capacity "
          f"{int(mcfg.capacity_factor * L_ROWS / mcfg.n_experts)} tokens an "
          f"expert of {L_ROWS} a step [{smi}]")
    report["train_step_moe"] = mstep

    # Phase 4b: the trainer, over phase 4's GPT-2 flash run.
    report["trainer"] = trainer_phase(torch, counters, cfg, step, smi)

    # Phase 5: the same steps over a mesh of 1, the sharded checkpoint,
    # and 2 ranks where there are two cards.
    mesh = mesh_phase(torch, counters,
                      {"gpt2": step, "llama": lstep, "moe": mstep}, smi)
    report["mesh"] = mesh

    # Phase 6: kernel paths vs the plain path, same weights and batch.
    gen = torch.Generator(device="cuda")
    params = gpt2_init(gen.manual_seed(0), cfg, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (4, cfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(2))
    dense = GPT2Config(**FUSED_DENSE_FLAGS)
    report["kernel_vs_plain_path"] = compare_paths(
        torch, gpt2_loss, params, tokens,
        {"flash+fused": cfg, "dense+fused": dense,
         "plain": dataclasses.replace(dense, fused_norm=False)})
    del params
    params = llama_init(gen.manual_seed(0), lcfg, device="cuda")
    tokens = torch.randint(0, lcfg.vocab_size, (2, lcfg.seq_len + 1),
                           device="cuda", generator=gen.manual_seed(2))
    report["kernel_vs_plain_path"].update(compare_paths(
        torch, llama_loss, params, tokens,
        {"llama flash+rms": lcfg,
         "llama dense+rms": dataclasses.replace(lcfg, use_flash=False),
         "plain": dataclasses.replace(lcfg, fused_norm=False,
                                      use_flash=False)}))
    del params
    params = moe_init(gen.manual_seed(0), mcfg, device="cuda")
    report["kernel_vs_plain_path"].update(compare_moe_paths(
        torch, moe_loss, params, tokens, mcfg))
    del params

    # Phase 7: the serving engines.
    report["serving"] = serve_phase(torch, counters, smi)

    # Phase 8: the kernels line. Each kernel's launches are those of the
    # main path it belongs to (the flash kernels: GPT-2's, with Llama's and
    # the MoE's beside them), and ``launches_mesh`` those of the same path
    # over the mesh of 1.
    kernels = []
    for kname, where, body in TPU_KERNELS:
        bf = results["bfloat16"][kname]
        main = lstep if kname in RMS_KERNELS else step
        entry = {
            "name": kname, "route": "cuda",
            "source": SOURCES["flash_attention" if kname in FLASH_KERNELS
                              else "fused_norm"],
            "replaces": where, "launches": main["launches"][kname],
            "max_abs_err": bf["max_abs_err"], "ms": bf["ms"],
            "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
            "bound_by": bf["bound_by"], "library_ms": bf["library_ms"],
            "status": "ported+checked", "body": body,
            "main_path": "llama" if kname in RMS_KERNELS else "gpt2",
            "launches_per_step": main["launches_per_step"][kname],
            "launches_mesh": mesh["llama" if kname in RMS_KERNELS
                                  else "gpt2"]["launches"][kname],
            "launches_trainer": report["trainer"]["launches"][kname],
            "dtype": "bfloat16",
        }
        if "library_dres_ms" in bf:
            entry["library_dres_ms"] = bf["library_dres_ms"]
        if kname in FLASH_KERNELS:
            entry["library"] = bf["library"]
            entry["host_us"] = bf["host_us"]
            entry["llama"] = {
                "launches": lstep["launches"][kname],
                "launches_mesh": mesh["llama"]["launches"][kname],
                "launches_per_step": lstep["launches_per_step"][kname],
                **{k: report["flash_llama_shape"][kname][k] for k in
                   ("max_abs_err", "ms", "host_us", "plain_ms", "library_ms",
                    "bound_ms")}}
            entry["moe"] = {
                "launches": mstep["launches"][kname],
                "launches_mesh": mesh["moe"]["launches"][kname],
                "launches_per_step": mstep["launches_per_step"][kname]}
        else:
            f32 = results["float32"][kname]
            entry["fp32"] = {k: f32[k] for k in ("max_abs_err", "ms",
                                                 "plain_ms", "library_ms",
                                                 "bound_ms")}
        kernels.append(entry)
    report["kernels_line"] = {"kernels": kernels, "not_ported": []}
    (OUT / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps(report["kernels_line"]))

    # Phase 9.
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank_main(int(sys.argv[2]), int(sys.argv[3]),
                                sys.argv[4], sys.argv[5], sys.argv[6]))
    sys.exit(main())
