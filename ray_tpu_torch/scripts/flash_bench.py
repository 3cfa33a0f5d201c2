"""Time the flash-attention kernels at the two main-path shapes, and the
norm and GELU kernels at the two main-path row shapes.

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
small's (R = 8 x 1024, D = 768) -- in bf16 and fp32 it checks
``rms_fwd``, ``ln_fwd``, ``ln_bwd`` and ``rms_bwd`` (each backward with
and without dres), ``gelu_fwd`` and ``gelu_bwd`` (at four times the
width) against their plain versions (bf16 outputs within one ulp and
bf16 column sums by cosine > 0.9999; fp32 within 1e-5 forward and 1e-4
backward of max(1, the largest magnitude); rstd and mu within 1e-5
relative) and takes their device times beside the library calls for the
same functions (``F.rms_norm``, ``F.layer_norm``, their autograd
backwards, the LayerNorm one also plus the dres add, ``F.gelu`` and
``aten.gelu_backward``; timed here only), the partial rows' sum alone
(one array of ``rms_bwd``'s partials and two of ``ln_bwd``'s, by the
tree's sum kernel and by ``torch.sum``) and the backward wrappers' host
cost per call. It also reports ptxas's registers and spills for every
kernel of the tree's ``fused_norm.cu`` (``ptxas``).
Prints one JSON line and exits non-zero if a check fails. Needs a CUDA
device.

    python ray_tpu_torch/scripts/flash_bench.py [--root DIR] [--label X]
        [--out FILE] [--rows-only]

``--root`` names the checkout whose ``ray_tpu_torch`` is measured (by
default this one), so one call can time two trees in turns: unpack the
other with ``git archive`` and pass its directory. Only
``ray_tpu_torch.ops.flash_attention`` and ``ray_tpu_torch.ops.fused_norm``
are taken from that tree; the helpers here are this file's own, which is
why it is run as a file. ``--out`` appends the line to a file;
``--rows-only`` skips the attention shapes.
"""

from __future__ import annotations

import argparse
import json
import re
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


def _bwd_ok(got, want, dtype) -> bool:
    """A norm backward's (dx, column sums...) against its plain version:
    dx within one bf16 ulp (fp32: 1e-4 of max(1, |dx|)), the fp32 column
    sums within 1e-4 of max(1, their largest), bf16 ones by cosine >
    0.9999."""
    if dtype == torch.bfloat16:
        return bf16_within_ulp(got[0], want[0]) and all(
            cosine(a, b) > 0.9999 for a, b in zip(got[1:], want[1:]))
    return all(_rel_err(a, b) <= 1e-4 for a, b in zip(got, want))


def bench_rows(fn, shape, dtype, flush) -> dict:
    """The norm and GELU kernels at one row shape and dtype, each checked
    against its plain version and timed beside its library call: rms_fwd,
    ln_fwd, ln_bwd and rms_bwd (with and without dres), gelu_fwd and
    gelu_bwd (on [rows, 4 * d], the MLP's width). The library backwards
    are autograd through ``F.layer_norm`` / ``F.rms_norm`` for (x,
    weight(, bias)), which add no dres; ``layer_norm_bwd_dres_library``
    is the same plus the dres add, the work ``ln_bwd`` does with dres.
    The partials' sums are timed on random [k, n, D] fp32 arrays of the
    sizes the two backwards write at this shape (``*_partials_sum``: the
    tree's kernel; ``torch_*``: ``torch.sum`` over the middle axis)."""
    F = torch.nn.functional
    name, rows, d = shape
    g = torch.Generator(device="cuda").manual_seed(rows + d)
    x = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device="cuda", generator=g)
    bias = 0.1 * torch.randn(d, device="cuda", generator=g)
    dy = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    dres = torch.randn(rows, d, device="cuda", generator=g).to(dtype)
    xg = (2 * torch.randn(rows, 4 * d, device="cuda", generator=g)).to(dtype)
    gg = torch.randn(rows, 4 * d, device="cuda", generator=g).to(dtype)
    w_l, b_l = scale.to(dtype), bias.to(dtype)
    (y, rstd), (y_r, rstd_r) = fn.rms_fwd(x, scale), fn.ref_rms_fwd(x, scale)
    (yl, mu, rs), (yl_r, mu_r, rs_r) = (fn.ln_fwd(x, scale, bias),
                                        fn.ref_ln_fwd(x, scale, bias))
    torch.cuda.synchronize()
    checks = {}
    for oname, got, want in (("rms_y", y, y_r), ("ln_y", yl, yl_r),
                             ("gelu_y", fn.gelu_fwd(xg), fn.ref_gelu(xg))):
        checks[f"{oname}_ok"] = (bf16_within_ulp(got, want)
                                 if dtype == torch.bfloat16
                                 else _rel_err(got, want) <= 1e-5)
    for oname, got, want in (("rms_rstd", rstd, rstd_r), ("ln_mu", mu, mu_r),
                             ("ln_rstd", rs, rs_r)):
        checks[f"{oname}_ok"] = _rel_err(got, want) <= 1e-5
    for res, tag in ((None, ""), (dres, "_dres")):
        checks[f"ln_bwd{tag}_ok"] = _bwd_ok(
            fn.ln_bwd(x, mu_r, rs_r, scale, dy, res),
            fn.ref_ln_bwd(x, mu_r, rs_r, scale, dy, res), dtype)
    for res, tag in ((None, ""), (dres, "_dres")):
        checks[f"rms_bwd{tag}_ok"] = _bwd_ok(
            fn.rms_bwd(x, rstd_r, scale, dy, res),
            fn.ref_rms_bwd(x, rstd_r, scale, dy, res), dtype)
    gelu_dx, gelu_dx_r = fn.gelu_bwd(xg, gg), fn.ref_gelu_bwd(xg, gg)
    checks["gelu_bwd_ok"] = (bf16_within_ulp(gelu_dx, gelu_dx_r)
                             if dtype == torch.bfloat16
                             else _rel_err(gelu_dx, gelu_dx_r) <= 1e-4)

    x_l = x.detach().requires_grad_(True)
    w_g, b_g = (t.detach().requires_grad_(True) for t in (w_l, b_l))
    yl_l = F.layer_norm(x_l, (d,), w_g, b_g, fn.LN_EPS)
    yr_l = F.rms_norm(x_l, (d,), w_g, fn.RMS_EPS)

    def ln_grad():
        return torch.autograd.grad(yl_l, (x_l, w_g, b_g), dy,
                                   retain_graph=True)

    # The sums over the partial rows alone: ln_bwd's two arrays and
    # rms_bwd's one, by the tree's kernel where it has one and torch.sum.
    lib = fn._lib()
    parts = torch.randn(2, -(-rows // lib.rt_ln_bwd_rows_per_block()), d,
                        device="cuda", generator=g)
    rms_parts = torch.randn(1, -(-rows // lib.rt_rms_bwd_rows_per_block()),
                            d, device="cuda", generator=g)
    calls = {
        "rms_fwd": lambda: fn.rms_fwd(x, scale),
        "rms_norm_library": lambda: F.rms_norm(x, (d,), w_l, fn.RMS_EPS),
        "ln_fwd": lambda: fn.ln_fwd(x, scale, bias),
        "layer_norm_library": lambda: F.layer_norm(x, (d,), w_l, b_l,
                                                   fn.LN_EPS),
        "ln_bwd": lambda: fn.ln_bwd(x, mu_r, rs_r, scale, dy),
        "ln_bwd_dres": lambda: fn.ln_bwd(x, mu_r, rs_r, scale, dy, dres),
        "torch_partials_sum": lambda: parts.sum(1),
        "torch_rms_partials_sum": lambda: rms_parts.sum(1),
        "layer_norm_bwd_library": ln_grad,
        "layer_norm_bwd_dres_library": lambda: ln_grad()[0] + dres,
        "rms_bwd": lambda: fn.rms_bwd(x, rstd_r, scale, dy),
        "rms_bwd_dres": lambda: fn.rms_bwd(x, rstd_r, scale, dy, dres),
        "rms_norm_bwd_library": lambda: torch.autograd.grad(
            yr_l, (x_l, w_g), dy, retain_graph=True),
        "gelu_fwd": lambda: fn.gelu_fwd(xg),
        "gelu_library": lambda: F.gelu(xg, approximate="tanh"),
        "gelu_bwd": lambda: fn.gelu_bwd(xg, gg),
        "gelu_bwd_library": lambda: torch.ops.aten.gelu_backward(
            gg, xg, approximate="tanh"),
    }
    sums = {}
    if hasattr(fn, "norm_bwd_sum"):
        sums = {"ln": parts, "rms": rms_parts}
        part_sum = fn.norm_bwd_sum
    elif hasattr(fn, "ln_bwd_sum"):  # an earlier tree: ln_bwd's arrays only
        sums = {"ln": parts}
        part_sum = fn.ln_bwd_sum
    for tag, p in sums.items():
        calls[f"{tag}_partials_sum"] = lambda p=p: part_sum(p)
        checks[f"{tag}_partials_sum_ok"] = _rel_err(part_sum(p),
                                                    p.sum(1)) <= 1e-4
    hosts = {"rms_bwd_dres": calls["rms_bwd_dres"],
             "ln_bwd_dres": calls["ln_bwd_dres"],
             "gelu_bwd": calls["gelu_bwd"]}
    return {"shape": name, "rows": rows, "d": d,
            "dtype": str(dtype).split(".")[-1], "ok": all(checks.values()),
            **checks, **{f"{k}_ms": device_ms(f, flush)
                         for k, f in calls.items()},
            **{f"{k}_host_us": host_us(f) for k, f in hosts.items()}}


# Template arguments in a mangled kernel name: the I/O type, an int, a bool.
_MANGLED_ARG = re.compile(r"13__nv_bfloat16|f|Li(\d+)E|Lb([01])E")
# The name follows its length in the mangling, so a digit comes before it
# (and not before the source file's name in the anonymous namespace's).
_KERNEL = re.compile(r"(?<=\d)((?:ln|rms|gelu|norm|flash)_\w*?kernel)(?:I((?:"
                     r"13__nv_bfloat16|f|Li\d+E|Lb[01]E)+)E)?")


def _kernel_name(line):
    """``ln_bwd_kernel<bf16,8,3>`` (``norm_bwd_sum_kernel``: no template)
    for a line naming a mangled kernel of either source, else None."""
    m = _KERNEL.search(line)
    if not m:
        return None
    if m.group(2) is None:
        return m.group(1)
    args = []
    for a in _MANGLED_ARG.finditer(m.group(2)):
        args.append({"13__nv_bfloat16": "bf16", "f": "f32"}.get(
            a.group(0), a.group(1) or a.group(2)))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_report(log_texts, fa=None):
    """{kernel<args>: registers, spill bytes, static and dynamic shared
    memory and ptxas's performance notes} for every kernel in the
    ``-Xptxas -v`` logs the build keeps; a flash kernel's dynamic shared
    memory is what its launcher requests (``fa.smem_bytes``; ptxas sees
    only static shared memory), the norm kernels take none."""
    report, cur = {}, None
    for line in "\n".join(log_texts).splitlines():
        name = _kernel_name(line)
        if "Compiling entry function" in line and name:
            cur = name
            m = re.match(r"(flash_(?:fwd|dkv|dq))_kernel<(\d+)>", name)
            report.setdefault(cur, {"notes": []})["dynamic_smem"] = (
                fa.smem_bytes(m.group(1), int(m.group(2))) if m and fa
                else 0)
        elif name and re.search(r"\(C\d+\)", line):
            code = re.search(r"\((C\d+)\)", line).group(1)
            report.setdefault(name, {"notes": []})["notes"].append(code)
        elif cur and "spill stores" in line:
            st, ld = re.findall(r"(\d+) bytes spill (?:stores|loads)", line)
            report[cur].update(spill_stores=int(st), spill_loads=int(ld))
        elif cur and "Used" in line and "registers" in line:
            report[cur]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            report[cur]["static_smem"] = int(sm.group(1)) if sm else 0
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]))
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default=None)
    ap.add_argument("--rows-only", action="store_true",
                    help="time the norm and GELU kernels only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bench: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(args.root).resolve()))
    from ray_tpu_torch.ops import _build
    from ray_tpu_torch.ops import flash_attention as fa
    from ray_tpu_torch.ops import fused_norm as fn

    t0 = time.perf_counter()
    _build.build(["fused_norm"] if args.rows_only
                 else ["flash_attention", "fused_norm"])
    build_s = time.perf_counter() - t0
    flush = torch.zeros(64 << 20, dtype=torch.uint8, device="cuda")
    warm_clocks()
    rows = [] if args.rows_only else [bench_shape(fa, s, flush)
                                      for s in SHAPES]
    rows += [bench_rows(fn, s, dt, flush) for s in ROW_SHAPES
             for dt in (torch.bfloat16, torch.float32)]
    ptxas = ptxas_report(
        [_build.library_path("fused_norm").with_suffix(".log").read_text()])
    line = {"label": args.label, "root": args.root,
            "device": torch.cuda.get_device_name(0), "build_s": build_s,
            "ptxas": {k: {f: r.get(f) for f in ("registers", "spill_stores",
                                                "spill_loads")}
                      for k, r in ptxas.items()},
            "shapes": rows}
    text = json.dumps(line)
    print(text)
    if args.out:
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0 if all(r["ok"] for r in rows) else 1


if __name__ == "__main__":
    sys.exit(main())
