"""ray_tpu_torch as a package: import hygiene, device resolution, the
unported paths, and -- on a GPU only -- each CUDA kernel against its plain
version at small shapes.

The ``gpu`` tests skip without a CUDA device. On a GPU machine without JAX
run them with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_package.py -m gpu`` (this file imports no JAX; the
suite's conftest does).
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops import fused_norm as fn
from ray_tpu_torch.ops.attention import causal_attention

REPO = Path(__file__).resolve().parents[1]
SLICE_MODULES = [
    "ray_tpu_torch",
    "ray_tpu_torch._device",
    "ray_tpu_torch._tree",
    "ray_tpu_torch.ops",
    "ray_tpu_torch.ops._build",
    "ray_tpu_torch.ops.attention",
    "ray_tpu_torch.ops.fused_norm",
    "ray_tpu_torch.models",
    "ray_tpu_torch.models.gpt2",
    "ray_tpu_torch.models.convert",
    "ray_tpu_torch.train",
    "ray_tpu_torch.train.optim",
    "ray_tpu_torch.train.train_step",
    "ray_tpu_torch.scripts",
    "ray_tpu_torch.scripts.measure",
    "ray_tpu_torch.scripts.profile_step",
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
    from ray_tpu_torch.scripts.measure import measure_gpt2

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
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_requests_raise():
    q = torch.zeros(1, 8, 2, 4)
    with pytest.raises(NotImplementedError, match="later slice"):
        causal_attention(q, q, q, use_flash=True)
    # On the CPU, None resolves to dense, as in the JAX package.
    assert causal_attention(q, q, q).shape == q.shape


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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(64, 768), (37, 100), (16, 8192)])
def test_layer_norm_kernels_match_plain(cuda, dtype, rows, d):
    g = torch.Generator(device=cuda).manual_seed(rows + d)
    x = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    scale = 1 + 0.1 * torch.randn(d, device=cuda, generator=g)
    bias = 0.1 * torch.randn(d, device=cuda, generator=g)
    dy = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    dres = torch.randn(rows, d, device=cuda, generator=g).to(dtype)
    before = fn.KERNEL_INVOCATIONS["ln_fwd"]
    y, mu, rstd = fn.ln_fwd(x, scale, bias)
    assert fn.KERNEL_INVOCATIONS["ln_fwd"] == before + 1
    y_ref, mu_ref, rstd_ref = fn.ref_ln_fwd(x, scale, bias)
    _check(y, y_ref, 1e-5)
    _check(mu, mu_ref, 1e-5)
    _check(rstd, rstd_ref, 1e-5)
    for res in (None, dres):
        got = fn.ln_bwd(x, mu_ref, rstd_ref, scale, dy, res)
        want = fn.ref_ln_bwd(x, mu_ref, rstd_ref, scale, dy, res)
        _check(got[0], want[0], 1e-4)
        for a, b in zip(got[1:], want[1:]):
            if dtype == torch.float32:
                _check(a, b, 1e-4)
            else:
                assert float(torch.nn.functional.cosine_similarity(
                    a, b, dim=0)) > 0.9999
    torch.cuda.synchronize()


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
