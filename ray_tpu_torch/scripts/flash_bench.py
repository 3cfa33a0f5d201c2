"""Time the flash-attention kernels at the two main-path shapes, and the
RMSNorm and LayerNorm forward kernels at the two main-path row shapes.

For each attention shape -- GPT-2 small's (B=8, T=1024, H=12, D=64,
causal, q/k/v strided views of one qkv tensor), Llama small's (B=4,
T=2048, H=16, D=64, causal, contiguous q/k/v) and the same with head_dim
128 (H=8) -- it checks ``flash_fwd``,
``flash_dkv`` and ``flash_dq`` against their plain versions (lse within
1e-4 of max(1, |lse|), every other output by cosine > 0.9999), then takes
each kernel's device time (``device_ms``: CUDA-event median of 30
launches, cold L2) and its wrapper's host cost per call (``host_us``: the
host clock around 200 back-to-back calls, read before the device is
synced; the median of 5 such batches).
For each row shape -- Llama small's (R = 4 x 2048, D = 1024) and GPT-2
small's (R = 8 x 1024, D = 768) -- in bf16 and fp32 it checks ``rms_fwd``
and ``ln_fwd`` against their plain versions (bf16 within one ulp, fp32
within 1e-5 of max(1, |y|), rstd and mu within 1e-5 relative) and takes
their device times beside ``F.rms_norm``'s and ``F.layer_norm``'s (the
library calls, timed here only).
Prints one JSON line and exits non-zero if a check fails. Needs a CUDA
device.

    python ray_tpu_torch/scripts/flash_bench.py [--root DIR] [--label X]
        [--out FILE]

``--root`` names the checkout whose ``ray_tpu_torch`` is measured (by
default this one), so one call can time two trees in turns: unpack the
other with ``git archive`` and pass its directory. Only
``ray_tpu_torch.ops.flash_attention`` and ``ray_tpu_torch.ops.fused_norm``
are taken from that tree; the helpers here are this file's own, which is
why it is run as a file. ``--out`` appends the line to a file.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

# (name, b, t, h, d, causal, packed); "d128" is Llama's batch, sequence
# and width with head_dim 128 (8 heads), the kernels' other head dim.
SHAPES = (("gpt2", 8, 1024, 12, 64, True, True),
          ("llama", 4, 2048, 16, 64, True, False),
          ("d128", 4, 2048, 8, 128, True, False))
# (name, rows, d): the normalisation inputs of a step's tokens.
ROW_SHAPES = (("llama", 4 * 2048, 1024), ("gpt2", 8 * 1024, 768))
HOST_CALLS = 200


def warm_clocks() -> None:
    """Run the card at load for a moment so that the first timings do not
    catch its clocks on the way up from idle."""
    a = torch.randn(8192, 8192, device="cuda", dtype=torch.bfloat16)
    for _ in range(200):
        a @ a
    torch.cuda.synchronize()


def device_ms(fn, flush, n: int = 30) -> float:
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


def host_us(fn, n: int = HOST_CALLS, repeats: int = 5) -> float:
    """The wrapper's host cost per call: the host clock around ``n``
    back-to-back calls, read before the device is synced; the median of
    ``repeats`` such batches, since other work on the host's cores
    disturbs single batches."""
    per_call = []
    for _ in range(repeats):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        per_call.append((time.perf_counter() - t0) / n * 1e6)
        torch.cuda.synchronize()
    return statistics.median(per_call)


def flash_inputs(b, t, h, d, seed, packed=True):
    """q, k, v and a contiguous dO, from a seed: with ``packed`` q, k, v are
    strided views of one [B, T, 3*H*D] bf16 tensor (GPT-2's layout), else
    three contiguous [B, T, H, D] tensors (Llama's, after the GQA repeat)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, device="cuda",
                      generator=g).to(torch.bfloat16)
    q, k, v = (x.reshape(b, t, h, d) for x in qkv.split(h * d, dim=-1))
    if not packed:
        q, k, v = (x.contiguous() for x in (q, k, v))
    do = torch.randn(b, t, h, d, device="cuda", generator=g).to(torch.bfloat16)
    return q, k, v, do


def cosine(a, b) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def bench_shape(fa, shape, flush) -> dict:
    name, b, t, h, d, causal, packed = shape
    q, k, v, do = flash_inputs(b, t, h, d, 0, packed)
    kw = dict(softmax_scale=d ** -0.5, causal=causal)
    out_r, lse_r = fa.ref_flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(out_r, do)
    dq_r, dk_r, dv_r = fa.ref_flash_bwd(q, k, v, out_r, lse_r, do, **kw)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, **kw),
        "flash_dkv": lambda: fa.flash_dkv(q, k, v, do, lse_r, delta, **kw),
        "flash_dq": lambda: fa.flash_dq(q, k, v, do, lse_r, delta, **kw),
    }
    out, lse = calls["flash_fwd"]()
    (dk, dv), dq = calls["flash_dkv"](), calls["flash_dq"]()
    torch.cuda.synchronize()
    lse_err = float((lse - lse_r).abs().max())
    checks = {"lse_err": lse_err,
              "lse_ok": lse_err <= 1e-4 * max(1.0, float(lse_r.abs().max()))}
    for oname, got, want in (("out", out, out_r), ("dk", dk, dk_r),
                             ("dv", dv, dv_r), ("dq", dq, dq_r)):
        checks[f"{oname}_cosine"] = cosine(got, want)
    ok = checks["lse_ok"] and all(
        v > 0.9999 for k, v in checks.items() if k.endswith("_cosine"))
    del out_r, dq_r, dk_r, dv_r
    return {"shape": name, "ok": ok, **checks,
            **{f"{k}_ms": device_ms(fn, flush) for k, fn in calls.items()},
            **{f"{k}_host_us": host_us(fn) for k, fn in calls.items()}}


def _rel_err(got, want) -> float:
    """Max abs error over max(1, the largest |want|)."""
    err = float((got.float() - want.float()).abs().max())
    return err / max(1.0, float(want.float().abs().max()))


def bf16_within_ulp(got, want) -> bool:
    """Within one bf16 ulp of the larger magnitude, plus 1e-5 absolute."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + 1e-5).all())


def bench_rows(fn, shape, dtype, flush) -> dict:
    """rms_fwd and ln_fwd (the control) at one row shape and dtype."""
    F = torch.nn.functional
    name, rows, d = shape
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    bias = 0.1 * torch.randn(d, device="cuda", generator=g)
    w_l, b_l = scale.to(dtype), bias.to(dtype)
    (y, rstd), (y_r, rstd_r) = fn.rms_fwd(x, scale), fn.ref_rms_fwd(x, scale)
    (yl, mu, rs), (yl_r, mu_r, rs_r) = (fn.ln_fwd(x, scale, bias),
                                        fn.ref_ln_fwd(x, scale, bias))
    torch.cuda.synchronize()
    checks = {}
    for oname, got, want in (("rms_y", y, y_r), ("ln_y", yl, yl_r)):
        checks[f"{oname}_ok"] = (bf16_within_ulp(got, want)
                                 if dtype == torch.bfloat16
                                 else _rel_err(got, want) <= 1e-5)
    for oname, got, want in (("rms_rstd", rstd, rstd_r), ("ln_mu", mu, mu_r),
                             ("ln_rstd", rs, rs_r)):
        checks[f"{oname}_ok"] = _rel_err(got, want) <= 1e-5
    calls = {
        "rms_fwd": lambda: fn.rms_fwd(x, scale),
        "rms_norm_library": lambda: F.rms_norm(x, (d,), w_l, fn.RMS_EPS),
        "ln_fwd": lambda: fn.ln_fwd(x, scale, bias),
        "layer_norm_library": lambda: F.layer_norm(x, (d,), w_l, b_l, 1e-5),
    }
    return {"shape": name, "rows": rows, "d": d,
            "dtype": str(dtype).split(".")[-1], "ok": all(checks.values()),
            **checks, **{f"{k}_ms": device_ms(f, flush)
                         for k, f in calls.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn

    t0 = time.perf_counter()
    _build.build(["flash_attention", "fused_norm"])
    build_s = time.perf_counter() - t0
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    warm_clocks()
    rows = [bench_shape(fa, s, flush) for s in SHAPES]
    rows += [bench_rows(fn, s, dt, flush) for s in ROW_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    line = {"label": args.label, "root": args.root,
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "shapes": rows}
    text = json.dumps(line)
    print(text)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
