"""ray_tpu_torch as a package: import hygiene, device resolution, the
attention dispatch, and -- on a GPU only -- each CUDA kernel against its
plain version at small shapes.

The ``gpu`` tests skip without a CUDA device. On a GPU machine without JAX
run them with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_package.py -m gpu`` (this file imports no JAX; the
suite's conftest does).
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import fused_norm as fn
from ray_tpu_torch.ops.attention import causal_attention, dense_causal_attention

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "ray_tpu_torch",
    "ray_tpu_torch._device",
    "ray_tpu_torch._tree",
    "ray_tpu_torch.ops",
    "ray_tpu_torch.ops._build",
    "ray_tpu_torch.ops.attention",
    "ray_tpu_torch.ops.flash_attention",
    "ray_tpu_torch.ops.fused_norm",
    "ray_tpu_torch.ops.moe",
    "ray_tpu_torch.models",
    "ray_tpu_torch.models._remat",
    "ray_tpu_torch.models.gpt2",
    "ray_tpu_torch.models.llama",
    "ray_tpu_torch.models.moe",
    "ray_tpu_torch.models.convert",
    "ray_tpu_torch.train",
    "ray_tpu_torch.train.optim",
    "ray_tpu_torch.train.train_step",
    "ray_tpu_torch.train.checkpoint",
    "ray_tpu_torch.parallel",
    "ray_tpu_torch.parallel.mesh",
    "ray_tpu_torch.parallel.distributed",
    "ray_tpu_torch.parallel.sharding",
    "ray_tpu_torch.scripts",
    "ray_tpu_torch.scripts.flash_bench",
    "ray_tpu_torch.scripts.measure",
    "ray_tpu_torch.scripts.profile_step",
    "ray_tpu_torch.util",
    "ray_tpu_torch.util.metrics",
    "ray_tpu_torch.util.tracing",
    "ray_tpu_torch.util.failpoints",
    "ray_tpu_torch.util.goodput",
    "ray_tpu_torch.serve",
    "ray_tpu_torch.serve._observability",
    "ray_tpu_torch.serve.llm_engine",
]


def test_import_pulls_in_no_jax_and_nothing_of_ray_tpu():
    code = (
        "import importlib, sys\n"
        "before = set(sys.modules)\n"
        f"for m in {SLICE_MODULES!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in set(sys.modules) - before\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'ray_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_chip_smoke_imports_no_jax():
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = {alias.name.split(".")[0] for node in ast.walk(tree)
             if isinstance(node, ast.Import) for alias in node.names}
    roots |= {node.module.split(".")[0] for node in ast.walk(tree)
              if isinstance(node, ast.ImportFrom) and node.module}
    assert not roots & {"jax", "jaxlib", "ray_tpu"}, roots


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_raise_without_cuda(monkeypatch):
    from ray_tpu_torch.models.convert import params_from_numpy
    from ray_tpu_torch.models.gpt2 import GPT2Config, gpt2_init
    from ray_tpu_torch.models.llama import LlamaConfig, llama_init
    from ray_tpu_torch.models.moe import MoEConfig, moe_init
    from ray_tpu_torch.ops.moe import init_moe_params
    from ray_tpu_torch.scripts.measure import (measure_gpt2, measure_llama,
                                               measure_moe, measure_serve)
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    _no_cuda(monkeypatch)
    cfg = GPT2Config.tiny()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpt2_init(torch.Generator(), cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        params_from_numpy({"w": [1.0]})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_gpt2(cfg, 1, steps=1, warmup=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        llama_init(torch.Generator(), LlamaConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_llama(LlamaConfig.tiny(), 1, steps=1, warmup=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        moe_init(torch.Generator(), MoEConfig.tiny())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_moe_params(torch.Generator(), 8, 16, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_moe(MoEConfig.tiny(), 1, steps=1, warmup=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LLMEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        measure_serve("gpt2", "tiny")
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_requests_take_flash_on_cpu(monkeypatch):
    """``use_flash=True`` on the CPU runs the flash Function over the plain
    versions and matches dense attention; ``None`` resolves to dense on the
    CPU, as in the JAX package, even at T >= _FLASH_MIN_SEQ."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 24, 2, 8),
                                                    dtype=np.float32))
               for _ in range(3))
    calls = []
    orig = fa.flash_fwd
    monkeypatch.setattr(fa, "flash_fwd",
                        lambda *a, **kw: calls.append(1) or orig(*a, **kw))
    out = causal_attention(q, k, v, use_flash=True)
    assert calls == [1]
    torch.testing.assert_close(out, dense_causal_attention(q, k, v),
                               rtol=2e-5, atol=2e-5)
    long_q = torch.zeros(1, 1024, 1, 64)
    assert causal_attention(long_q, long_q, long_q).shape == long_q.shape
    assert calls == [1]


@pytest.mark.parametrize("k", [1, 2])
def test_norm_bwd_sum_takes_the_plain_sum_on_cpu(k):
    """On the CPU the partial rows' sum is its plain version, the column
    sums over the middle axis, so the CPU backward adds them as the JAX
    package adds its kernel's partials."""
    parts = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (k, 5, 7), dtype=np.float32))
    torch.testing.assert_close(fn.norm_bwd_sum(parts), parts.sum(1),
                               rtol=0, atol=0)


def test_wrappers_reject_other_devices():
    x = torch.empty(2, 4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fn.gelu_fwd(x)


def test_peak_table_refuses_unknown_cards():
    from ray_tpu_torch.scripts.measure import peak_flops_per_chip

    assert peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    with pytest.raises(ValueError):
        peak_flops_per_chip("TPU v5 lite")


# -- on a GPU: each kernel against its plain version --------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bf16_ok(got, want):
    """Within one bf16 ulp of the larger magnitude, plus 1e-5 absolute for
    values near zero, where the fp32 rounding before the cast dominates."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(1e-30)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + 1e-5).all())


def _check(got, want, fp32_tol):
    if got.dtype == torch.bfloat16:
        assert _bf16_ok(got, want)
    else:
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= fp32_tol * scale


def _ln_inputs(cuda, rows, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    bias = 0.1 * torch.randn(d, device=cuda, generator=g)
    dy = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    dres = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    return x, scale, bias, dy, dres


def _check_ln_bwd(got, want, dtype):
    """dx within one bf16 ulp (fp32: 1e-4); dscale and dbias within 1e-4
    in fp32, by cosine > 0.9999 in bf16."""
    _check(got[0], want[0], 1e-4)
    for a, b in zip(got[1:], want[1:]):
        if dtype == torch.float32:
            _check(a, b, 1e-4)
        else:
            assert float(torch.nn.functional.cosine_similarity(
                a, b, dim=0)) > 0.9999


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 768), (37, 100), (16, 8192),
                                    (37, 768), (37, 769), (64, 1024),
                                    (64, 1025), (45, 768), (1000, 768)])
def test_layer_norm_kernels_match_plain(cuda, dtype, rows, d):
    """ln_fwd and ln_bwd (with and without dres) against their plain
    versions: at GPT-2's width, at the one-warp kernels' limit (1024) and
    just past it (769 is not read 16 bytes at a time, 1025 is wider than a
    warp's row), at row counts that are not a multiple of ln_bwd's 32-row
    block (37, 45, 1000), at an odd width and on the wide path (8192)."""
    x, scale, bias, dy, dres = _ln_inputs(cuda, rows, d, dtype, rows + d)
    before = dict(fn.KERNEL_INVOCATIONS)
    y, mu, rstd = fn.ln_fwd(x, scale, bias)
    y_ref, mu_ref, rstd_ref = fn.ref_ln_fwd(x, scale, bias)
    _check(y, y_ref, 1e-5)
    _check(mu, mu_ref, 1e-5)
    _check(rstd, rstd_ref, 1e-5)
    for res in (None, dres):
        _check_ln_bwd(fn.ln_bwd(x, mu_ref, rstd_ref, scale, dy, res),
                      fn.ref_ln_bwd(x, mu_ref, rstd_ref, scale, dy, res),
                      dtype)
    torch.cuda.synchronize()
    assert fn.KERNEL_INVOCATIONS["ln_fwd"] == before.get("ln_fwd", 0) + 1
    assert fn.KERNEL_INVOCATIONS["ln_bwd"] == before.get("ln_bwd", 0) + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 768])
def test_layer_norm_kernels_take_unaligned_rows(cuda, dtype, d):
    """x, scale, bias, dy and dres one element past a 16-byte boundary:
    the kernels read them an element at a time and match the plain
    versions."""
    rows = 21

    def shifted(t):
        flat = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)
        flat[1:] = t.flatten()
        return flat[1:].view(t.shape)

    x, scale, bias, dy, dres = (shifted(t) for t in _ln_inputs(
        cuda, rows, d, dtype, d + 1))
    assert all(t.data_ptr() % 16 for t in (x, scale, bias, dy, dres))
    y, mu, rstd = fn.ln_fwd(x, scale, bias)
    y_ref, mu_ref, rstd_ref = fn.ref_ln_fwd(x, scale, bias)
    _check(y, y_ref, 1e-5)
    _check(mu, mu_ref, 1e-5)
    _check(rstd, rstd_ref, 1e-5)
    _check_ln_bwd(fn.ln_bwd(x, mu_ref, rstd_ref, scale, dy, dres),
                  fn.ref_ln_bwd(x, mu_ref, rstd_ref, scale, dy, dres), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1000, 768), (100, 1025)])
def test_ln_bwd_is_deterministic(cuda, dtype, rows, d):
    """dx, dscale and dbias bitwise the same in two calls: the column sums
    are added in a fixed order, with no atomics, on the one-warp path
    (768) and the multi-warp one (1025)."""
    x, scale, bias, dy, dres = _ln_inputs(cuda, rows, d, dtype, 3)
    _, mu, rstd = fn.ref_ln_fwd(x, scale, bias)
    first = fn.ln_bwd(x, mu, rstd, scale, dy, dres)
    second = fn.ln_bwd(x, mu, rstd, scale, dy, dres)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def _check_rms_bwd(got, want, dtype):
    """dx within one bf16 ulp (fp32: 1e-4); dscale within 1e-4 in fp32, by
    cosine > 0.9999 in bf16."""
    _check(got[0], want[0], 1e-4)
    if dtype == torch.float32:
        _check(got[1], want[1], 1e-4)
    else:
        assert float(torch.nn.functional.cosine_similarity(
            got[1], want[1], dim=0)) > 0.9999


def _shifted(cuda, t):
    """A copy of ``t`` one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, device=cuda, dtype=t.dtype)
    flat[1:] = t.flatten()
    return flat[1:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows", [16, 40, 48])
def test_rms_bwd_keeps_its_own_row_blocks(cuda, dtype, rows, monkeypatch):
    """rms_bwd sizes its partials by its own export,
    ``rt_rms_bwd_rows_per_block`` (one partial row per block, whatever
    ln_bwd's block is), hands them to ``norm_bwd_sum`` as one array, and
    still matches its plain version at row counts that are and are not
    multiples of either block."""
    per_block = fn._lib().rt_rms_bwd_rows_per_block()
    seen, real_sum = [], fn.norm_bwd_sum

    def spy(parts):
        seen.append(tuple(parts.shape))
        return real_sum(parts)

    monkeypatch.setattr(fn, "norm_bwd_sum", spy)
    d = 1024
    x, scale, _, dy, dres = _ln_inputs(cuda, rows, d, dtype, rows)
    _, rstd = fn.ref_rms_fwd(x, scale)
    for res in (None, dres):
        _check_rms_bwd(fn.rms_bwd(x, rstd, scale, dy, res),
                       fn.ref_rms_bwd(x, rstd, scale, dy, res), dtype)
    torch.cuda.synchronize()
    assert seen == [(1, -(-rows // per_block), d)] * 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(37, 1024), (45, 1024), (37, 768),
                                    (45, 768), (64, 1024), (1000, 1024),
                                    (37, 1025), (37, 1032)])
def test_rms_bwd_one_warp_rows_match_plain(cuda, dtype, rows, d):
    """rms_bwd takes one warp a row up to 1024 wide and the multi-warp rows
    past it (1025 not readable 16 bytes at a time, 1032 readable): dx and
    dscale against the plain version, with and without dres, at row counts
    that are not a multiple of its row block (37, 45, 1000)."""
    x, scale, _, dy, dres = _ln_inputs(cuda, rows, d, dtype, rows * d)
    _, rstd = fn.ref_rms_fwd(x, scale)
    before = fn.KERNEL_INVOCATIONS["rms_bwd"]
    for res in (None, dres):
        _check_rms_bwd(fn.rms_bwd(x, rstd, scale, dy, res),
                       fn.ref_rms_bwd(x, rstd, scale, dy, res), dtype)
    torch.cuda.synchronize()
    assert fn.KERNEL_INVOCATIONS["rms_bwd"] == before + 2


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 1024])
def test_rms_bwd_takes_unaligned_rows(cuda, dtype, d):
    """x, scale, dy and dres one element past a 16-byte boundary: rms_bwd
    takes the multi-warp rows, reads them an element at a time and matches
    the plain version."""
    x, scale, _, dy, dres = (_shifted(cuda, t) for t in _ln_inputs(
        cuda, 21, d, dtype, d + 2))
    assert all(t.data_ptr() % 16 for t in (x, scale, dy, dres))
    _, rstd = fn.ref_rms_fwd(x, scale)
    _check_rms_bwd(fn.rms_bwd(x, rstd, scale, dy, dres),
                   fn.ref_rms_bwd(x, rstd, scale, dy, dres), dtype)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(1000, 1024), (1000, 768), (100, 1025)])
def test_rms_bwd_is_deterministic(cuda, dtype, rows, d):
    """dx and dscale bitwise the same in two calls: the column sums are
    added in a fixed order, with no atomics, on the one-warp path (768,
    1024) and the multi-warp one (1025)."""
    x, scale, _, dy, dres = _ln_inputs(cuda, rows, d, dtype, 5)
    _, rstd = fn.ref_rms_fwd(x, scale)
    first = fn.rms_bwd(x, rstd, scale, dy, dres)
    second = fn.rms_bwd(x, rstd, scale, dy, dres)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("n,d", [(256, 1024), (256, 768), (1, 33), (37, 100)])
def test_norm_bwd_sum_matches_torch_sum(cuda, k, n, d):
    """The partial rows' sum kernel against ``parts.sum(1)`` for one array
    (rms_bwd) and two (ln_bwd), within 1e-5 of max(1, |sum|) (the rows are
    added in another order), and the same bits in two calls."""
    g = torch.Generator(device=cuda).manual_seed(k * n + d)
    parts = torch.randn(k, n, d, device=cuda, generator=g)
    got = fn.norm_bwd_sum(parts)
    again = fn.norm_bwd_sum(parts)
    torch.cuda.synchronize()
    assert got.shape == (k, d)
    _check(got, parts.sum(1), 1e-5)
    assert torch.equal(got, again)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 1024), (37, 100), (16, 8192),
                                    (37, 2050)])
def test_rms_norm_kernels_match_plain(cuda, dtype, rows, d):
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    dy = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    dres = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    before = dict(fn.KERNEL_INVOCATIONS)
    y, rstd = fn.rms_fwd(x, scale)
    y_ref, rstd_ref = fn.ref_rms_fwd(x, scale)
    _check(y, y_ref, 1e-5)
    _check(rstd, rstd_ref, 1e-5)
    for res in (None, dres):
        dx, dscale = fn.rms_bwd(x, rstd_ref, scale, dy, res)
        dx_ref, dscale_ref = fn.ref_rms_bwd(x, rstd_ref, scale, dy, res)
        _check(dx, dx_ref, 1e-4)
        if dtype == torch.float32:
            _check(dscale, dscale_ref, 1e-4)
        else:
            assert float(torch.nn.functional.cosine_similarity(
                dscale, dscale_ref, dim=0)) > 0.9999
    torch.cuda.synchronize()
    assert fn.KERNEL_INVOCATIONS["rms_fwd"] == before.get("rms_fwd", 0) + 1
    assert fn.KERNEL_INVOCATIONS["rms_bwd"] == before.get("rms_bwd", 0) + 2
    assert fn.KERNEL_INVOCATIONS["ln_fwd"] == before.get("ln_fwd", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 1024), (37, 1024), (37, 1025),
                                    (37, 1032), (37, 1), (37, 31),
                                    (16, 8192), (13, 768)])
def test_rms_fwd_one_warp_rows_match_plain(cuda, dtype, rows, d):
    """rms_fwd takes one warp a row up to 1024 wide and the multi-warp rows
    past it: y within one bf16 ulp (fp32: 1e-5) and rstd within 1e-5 of the
    plain version, at the limit and just past it (1032 aligned, 1025 not),
    at D = 1 and 31, and with row counts that are not a multiple of the
    CTA's 8 rows."""
    g = torch.Generator(device=cuda).manual_seed(rows * d)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    before = fn.KERNEL_INVOCATIONS["rms_fwd"]
    y, rstd = fn.rms_fwd(x, scale)
    y_ref, rstd_ref = fn.ref_rms_fwd(x, scale)
    torch.cuda.synchronize()
    assert fn.KERNEL_INVOCATIONS["rms_fwd"] == before + 1
    _check(y, y_ref, 1e-5)
    _check(rstd, rstd_ref, 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [96, 1024])
def test_rms_fwd_takes_unaligned_rows(cuda, dtype, d):
    """x and scale one element past a 16-byte boundary: the kernel reads
    them an element at a time (VEC = 1) and matches the plain version."""
    rows = 21
    g = torch.Generator(device=cuda).manual_seed(d)
    x = torch.randn(rows * d + 1, device=cuda, generator=g).to(dtype)
    x = x[1:].view(rows, d)
    scale = (1 + 0.1 * torch.randn(d + 1, device=cuda, generator=g))[1:]
    assert x.data_ptr() % 16 and scale.data_ptr() % 16
    y, rstd = fn.rms_fwd(x, scale)
    y_ref, rstd_ref = fn.ref_rms_fwd(x, scale)
    torch.cuda.synchronize()
    _check(y, y_ref, 1e-5)
    _check(rstd, rstd_ref, 1e-5)


@pytest.mark.gpu
def test_rms_autograd_through_kernels_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(4, 16, 1024, device=cuda, generator=g)
    s = 1 + 0.1 * torch.randn(1024, device=cuda, generator=g)
    w = torch.randn(1024, device=cuda, generator=g)
    grads = []
    for fused in (True, False):
        xs, ss = (t.clone().requires_grad_(True) for t in (x, s))
        if fused:
            y, skip = fn.fused_rms_norm_residual(xs, ss)
            y2 = fn.fused_rms_norm(y + skip, ss)
        else:
            y, skip = fn.ref_rms_norm(xs, ss), xs
            y2 = fn.ref_rms_norm(y + skip, ss)
        ((skip * 3.0 + y2 * w) ** 2).sum().backward()
        grads.append((xs.grad, ss.grad))
    for a, b_ in zip(*grads):
        _check(a, b_, 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(64, 3072), (37, 100)])
def test_gelu_kernels_match_plain(cuda, dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(shape[1])
    x = (2 * torch.randn(shape, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(shape, device=cuda, generator=g).to(dtype)
    _check(fn.gelu_fwd(x), fn.ref_gelu(x), 1e-5)
    _check(fn.gelu_bwd(x, dy), fn.ref_gelu_bwd(x, dy), 1e-4)
    torch.cuda.synchronize()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,shift", [(100, 0), (1001, 0), (8199, 0),
                                     (65536 + 5, 0), (3 * 8192, 0),
                                     (1001, 1), (65536 + 5, 1)])
def test_gelu_bwd_takes_any_length_and_alignment(cuda, dtype, n, shift):
    """gelu_bwd's one-shot grid against the plain version: lengths shorter
    than one CTA's span (100), not a multiple of a 16-byte pack (1001,
    8199, 65541), a whole number of CTAs (24576), and views one element
    past a 16-byte boundary (shift 1, read an element at a time)."""
    g = torch.Generator(device=cuda).manual_seed(n + shift)
    x = (2 * torch.randn(n + shift, device=cuda, generator=g)).to(dtype)
    dy = torch.randn(n + shift, device=cuda, generator=g).to(dtype)
    x, dy = x[shift:], dy[shift:]
    assert (x.data_ptr() % 16 != 0) == bool(shift)
    before = fn.KERNEL_INVOCATIONS["gelu_bwd"]
    got = fn.gelu_bwd(x, dy)
    torch.cuda.synchronize()
    assert fn.KERNEL_INVOCATIONS["gelu_bwd"] == before + 1
    _check(got, fn.ref_gelu_bwd(x, dy), 1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,shift", [(100, 0), (1001, 0), (8199, 0),
                                     (65536 + 5, 0), (3 * 8192, 0),
                                     (1001, 1), (65536 + 5, 1)])
def test_gelu_fwd_takes_any_length_and_alignment(cuda, dtype, n, shift):
    """gelu_fwd's one-shot grid against the plain version, at the lengths
    and alignments of test_gelu_bwd_takes_any_length_and_alignment."""
    g = torch.Generator(device=cuda).manual_seed(n + shift)
    x = (2 * torch.randn(n + shift, device=cuda, generator=g)).to(dtype)[shift:]
    assert (x.data_ptr() % 16 != 0) == bool(shift)
    before = fn.KERNEL_INVOCATIONS["gelu_fwd"]
    got = fn.gelu_fwd(x)
    torch.cuda.synchronize()
    assert fn.KERNEL_INVOCATIONS["gelu_fwd"] == before + 1
    _check(got, fn.ref_gelu(x), 1e-5)


@pytest.mark.gpu
def test_autograd_through_kernels_matches_plain(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(4, 16, 768, device=cuda, generator=g)
    s = 1 + 0.1 * torch.randn(768, device=cuda, generator=g)
    b = 0.1 * torch.randn(768, device=cuda, generator=g)
    grads = []
    for fused in (True, False):
        xs, ss, bs = (t.clone().requires_grad_(True) for t in (x, s, b))
        if fused:
            y, skip = fn.fused_layer_norm_residual(xs, ss, bs)
        else:
            y, skip = fn.ref_layer_norm(xs, ss, bs), xs
        h = fn.fused_gelu(y) if fused else fn.ref_gelu(y)
        ((skip + h) ** 2).sum().backward()
        grads.append((xs.grad, ss.grad, bs.grad))
    for a, b_ in zip(*grads):
        _check(a, b_, 1e-4)


# -- on a GPU: the flash kernels against their plain versions -----------------


def _cosine(a, b):
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def _flash_inputs(cuda, b, t, h, d, seed):
    """q, k, v as strided views of one [B, T, 3*H*D] bf16 tensor, as the
    model slices its fused qkv product, and a contiguous dO."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    qkv = torch.randn(b, t, 3 * h * d, device=cuda, generator=g)
    q, k, v = (x.reshape(b, t, h, d) for x in
               qkv.to(torch.bfloat16).split(h * d, dim=-1))
    do = torch.randn(b, t, h, d, device=cuda, generator=g).to(torch.bfloat16)
    return q, k, v, do


def _close_bf16(got, want):
    """Cosine > 0.9999 (bf16 P and dS are rounded at other running maxima
    than the dense plain version's) and no element off by more than 2% of
    the largest magnitude."""
    assert _cosine(got, want) > 0.9999
    err = float((got.float() - want.float()).abs().max())
    assert err <= 2e-2 * max(1.0, float(want.float().abs().max()))


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,d", [(77, 64), (1024, 64), (77, 128), (1024, 128)])
def test_flash_kernels_match_plain(cuda, t, d, causal):
    b, h = 2, 3
    q, k, v, do = _flash_inputs(cuda, b, t, h, d, t + d)
    assert not q.is_contiguous()
    kw = dict(softmax_scale=d ** -0.5, causal=causal)
    before = dict(fa.KERNEL_INVOCATIONS)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.ref_flash_fwd(q, k, v, **kw)
    assert float((lse - lse_r).abs().max()) <= 1e-4 * max(
        1.0, float(lse_r.abs().max()))
    _close_bf16(out, out_r)
    delta = fa.flash_delta(out_r, do)
    dk, dv = fa.flash_dkv(q, k, v, do, lse_r, delta, **kw)
    dq = fa.flash_dq(q, k, v, do, lse_r, delta, **kw)
    dk_r, dv_r = fa.ref_flash_dkv(q, k, v, do, lse_r, delta, **kw)
    dq_r = fa.ref_flash_dq(q, k, v, do, lse_r, delta, **kw)
    for got, want in ((dq, dq_r), (dk, dk_r), (dv, dv_r)):
        _close_bf16(got, want)
    torch.cuda.synchronize()
    for name in ("flash_fwd", "flash_dkv", "flash_dq"):
        assert fa.KERNEL_INVOCATIONS[name] == before.get(name, 0) + 1


@pytest.mark.gpu
def test_flash_autograd_on_kernels_matches_plain(cuda):
    q, k, v, do = _flash_inputs(cuda, 2, 200, 4, 64, 7)
    grads = []
    for kernels in (True, False):
        xs = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
        args = xs if kernels else [x.cpu() for x in xs]
        out = fa.flash_causal_attention(*args)
        out.backward(do.to(out.device))
        grads.append([out.detach().cuda()] + [x.grad for x in xs])
    for got, want in zip(*grads):
        _close_bf16(got, want)


@pytest.mark.gpu
def test_flash_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(1, 64, 2, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_fwd(x, x, x, softmax_scale=1.0, causal=True)
    y = torch.zeros(1, 64, 2, 64, device=cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fa.flash_fwd(y, y, y, softmax_scale=1.0, causal=True)
    z = torch.zeros(1, 2, 64, 64, device=cuda,
                    dtype=torch.bfloat16).transpose(1, 2)
    with pytest.raises(ValueError, match="packed"):
        fa.flash_fwd(z, z, z, softmax_scale=1.0, causal=True)


# Tile edges of the warp-specialised kernels: 128-row fixed tiles; swept
# tiles of 128 or 64 keys (forward), 64 or 16 q rows (dK/dV) and 64 keys
# (dQ); TMA's zero fill past T.
EDGE_SEQS = (1, 63, 64, 65, 127, 128, 129, 2049)
# The backward kernels the tile-edge, external-lse and determinism tests
# hold, each against its plain version.
BWD_KERNELS = ("flash_dkv", "flash_dq")


def _edge_inputs(cuda, t, d):
    """B*H = 3 as (3, 1) at odd T and (1, 3) at even T, so both the batch
    and the head stride of the strided views are exercised."""
    b, h = (3, 1) if t % 2 else (1, 3)
    return _flash_inputs(cuda, b, t, h, d, 1000 + t + d)


def _bwd(kernel, q, k, v, do, lse, delta, kw, plain=False):
    """The named backward kernel's outputs -- (dk, dv) or (dq,) -- or, with
    ``plain``, its plain version's."""
    if kernel == "flash_dkv":
        f = fa.ref_flash_dkv if plain else fa.flash_dkv
        return f(q, k, v, do, lse, delta, **kw)
    f = fa.ref_flash_dq if plain else fa.flash_dq
    return (f(q, k, v, do, lse, delta, **kw),)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("t", EDGE_SEQS)
@pytest.mark.parametrize("kernel", BWD_KERNELS)
def test_flash_fwd_and_dkv_at_tile_edges(cuda, kernel, t, d, causal):
    """The forward, then the ``kernel`` backward, at every tile edge."""
    q, k, v, do = _edge_inputs(cuda, t, d)
    assert not q.is_contiguous()
    kw = dict(softmax_scale=d ** -0.5, causal=causal)
    out, lse = fa.flash_fwd(q, k, v, **kw)
    out_r, lse_r = fa.ref_flash_fwd(q, k, v, **kw)
    assert float((lse - lse_r).abs().max()) <= 1e-4 * max(
        1.0, float(lse_r.abs().max()))
    _close_bf16(out, out_r)
    delta = fa.flash_delta(out_r, do)
    got = _bwd(kernel, q, k, v, do, lse_r, delta, kw)
    want = _bwd(kernel, q, k, v, do, lse_r, delta, kw, plain=True)
    # dk, dv or dq; dK and dQ are products of dS.
    for i, (a, b) in enumerate(zip(got, want)):
        if t == 1 and i == 0:
            # One key: the softmax is constant, dS is 0 up to the rounding
            # of dO.V - delta, and both dK (dQ) are that rounding noise.
            assert float(a.float().abs().max()) <= 1e-3
            assert float(b.float().abs().max()) <= 1e-3
        else:
            _close_bf16(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel", BWD_KERNELS)
def test_flash_dkv_takes_shifted_and_masking_lse(cuda, kernel, d):
    """A global lse (shifted) and ring attention's masking lse (+1e30,
    p = 0 with no NaN), for each backward kernel."""
    q, k, v, do = _edge_inputs(cuda, 129, d)
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    out_r, lse_r = fa.ref_flash_fwd(q, k, v, **kw)
    delta = fa.flash_delta(out_r, do)
    shifted = lse_r + 0.5  # P scaled by exp(-0.5), as a global lse gives
    got = _bwd(kernel, q, k, v, do, shifted, delta, kw)
    want = _bwd(kernel, q, k, v, do, shifted, delta, kw, plain=True)
    for a, b in zip(got, want):
        _close_bf16(a, b)
    masking = torch.full_like(lse_r, 1e30)  # ring attention's masked step
    for a in _bwd(kernel, q, k, v, do, masking, delta, kw):
        assert bool((a == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("kernel", BWD_KERNELS)
def test_flash_fwd_and_dkv_are_deterministic(cuda, kernel, d):
    """The forward and the ``kernel`` backward, bitwise the same twice."""
    q, k, v, do = _edge_inputs(cuda, 1000, d)
    kw = dict(softmax_scale=d ** -0.5, causal=True)
    runs = []
    for _ in range(2):
        out, lse = fa.flash_fwd(q, k, v, **kw)
        delta = fa.flash_delta(out, do)
        runs.append((out, lse, *_bwd(kernel, q, k, v, do, lse, delta, kw)))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


# -- on a GPU: the serving engine ---------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_decode_graph_replay_matches_eager_step(cuda, model):
    """One decode step replayed from the captured graph and the same step
    called eagerly, from one cache snapshot and input: the same tokens."""
    from ray_tpu_torch.scripts.measure import decode_graph_vs_eager
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    eng = LLMEngine(model=model, preset="tiny", max_batch=4, cache_len=32,
                    max_prompt_len=8, device=cuda)
    try:
        assert len(eng.generate([5, 9, 2, 17, 3], 6)) == 6
        check = decode_graph_vs_eager(eng)
        assert check["tokens_equal"], check
        assert eng.llm_stats()["compiles"] == {"decode": 1, "prefill": 1}
    finally:
        eng.shutdown_engine()


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["gpt2", "llama"])
def test_engine_on_cuda_matches_naive_loop(cuda, model):
    """The engine on the GPU (graphs) gives the tokens of the model's
    naive full-forward loop at fp32 tiny, up to a near tie."""
    import dataclasses

    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.llama import LlamaConfig
    from ray_tpu_torch.scripts.measure import serve_prompts, serve_vs_naive

    cfg = (GPT2Config if model == "gpt2" else LlamaConfig).tiny()
    cfg = dataclasses.replace(cfg, dtype=torch.float32)
    res = serve_vs_naive(model, cfg, prompts=serve_prompts(4, cfg.vocab_size,
                                                           16),
                         n_tokens=8, device=cuda, max_batch=4, cache_len=32,
                         max_prompt_len=16, prefill_rows=2)
    assert res["match"], res
    assert res["compared"] >= 16, res
