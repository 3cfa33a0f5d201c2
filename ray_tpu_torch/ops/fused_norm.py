"""Fused LayerNorm(+residual) and tanh-GELU, with hand-written CUDA kernels
for the forward and the backward (``csrc/fused_norm.cu``).

Port of ``ray_tpu/ops/fused_norm.py`` (LayerNorm and GELU; the RMSNorm
kernels wait for the Llama slice). The design carries over: the LayerNorm
forward saves only fp32 mean and rstd per row; one backward kernel computes
dx, the dscale/dbias column partials and, in the ``_residual`` variant, adds
the residual cotangent; the GELU backward recomputes tanh from the saved
pre-activation.

Each kernel has a wrapper (``ln_fwd``, ``ln_bwd``, ``gelu_fwd``,
``gelu_bwd``) and a plain PyTorch version of the same function
(``ref_ln_fwd``, ``ref_ln_bwd``, ``ref_gelu``, ``ref_gelu_bwd``). A wrapper
given CPU tensors computes the plain version; given CUDA tensors it
launches the kernel or raises -- it never falls back. ``KERNEL_INVOCATIONS``
counts real launches only.

The public functions are ``torch.autograd.Function``s over the wrappers,
so on the CPU they run the same plumbing with the plain versions, which is
what the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import math

import torch

from ray_tpu_torch.ops._build import load_library

LN_EPS = 1e-5  # matches models/gpt2.py _layer_norm

# Launches per kernel name, bumped by a wrapper only where it launches.
KERNEL_INVOCATIONS: collections.Counter = collections.Counter()

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "rt_ln_max_d": [],
    "rt_ln_bwd_rows_per_block": [],
    "rt_ln_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rt_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rt_gelu_fwd": [_P, _P, _LL, _I, _P],
    "rt_gelu_bwd": [_P, _P, _P, _LL, _I, _P],
}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("fused_norm")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# -- plain versions (the CPU path, and what the kernels are held against) --


def ref_ln_fwd(x2d, scale, bias, eps: float = LN_EPS):
    """x2d [R, D] -> (y [R, D] in x2d.dtype, mu [R] fp32, rstd [R] fp32).
    Centered variance mean((x - mu)^2), as ``jnp.var`` and the kernel."""
    x32 = x2d.float()
    mu = x32.mean(-1, keepdim=True)
    xc = x32 - mu
    rstd = torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps)
    y = xc * rstd * scale + bias
    return y.to(x2d.dtype), mu[:, 0], rstd[:, 0]


def ref_ln_bwd(x2d, mu, rstd, scale, dy, dres=None):
    """-> (dx [R, D] in x2d.dtype, dscale [D] fp32, dbias [D] fp32)."""
    xhat = (x2d.float() - mu[:, None]) * rstd[:, None]
    dy32 = dy.float()
    dxhat = dy32 * scale
    c1 = dxhat.mean(-1, keepdim=True)
    c2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - c1 - xhat * c2)
    if dres is not None:
        dx = dx + dres.float()
    return dx.to(x2d.dtype), (dy32 * xhat).sum(0), dy32.sum(0)


def ref_layer_norm(x, scale, bias, eps: float = LN_EPS):
    """The model's ``_layer_norm`` chain over the last dim of ``x``:
    fp32 statistics, output in ``x.dtype``. Differentiable by autograd."""
    y, _, _ = ref_ln_fwd(x.reshape(-1, x.shape[-1]), scale, bias, eps)
    return y.reshape(x.shape)


def ref_gelu(x):
    """tanh-GELU in fp32, cast back to ``x.dtype``."""
    x32 = x.float()
    t = torch.tanh(_GELU_C * (x32 + _GELU_A * x32 * x32 * x32))
    return (0.5 * x32 * (1.0 + t)).to(x.dtype)


def ref_gelu_bwd(x, g):
    x32 = x.float()
    t = torch.tanh(_GELU_C * (x32 + _GELU_A * x32 * x32 * x32))
    du = _GELU_C * (1.0 + 3.0 * _GELU_A * x32 * x32)
    dgelu = 0.5 * (1.0 + t) + 0.5 * x32 * (1.0 - t * t) * du
    return (g.float() * dgelu).to(x.dtype)


# -- kernel wrappers -------------------------------------------------------


def _on_cpu(x) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return False


def _check(name, t, *, device, dtype, shape):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _io_dtype(name, x):
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: kernel takes float32 or bfloat16, "
                        f"got {x.dtype}")
    return _DTYPE_CODE[x.dtype]


def _check_width(name, d, lib):
    if d > lib.rt_ln_max_d():
        raise ValueError(f"{name}: D={d} exceeds the kernel's maximum "
                         f"{lib.rt_ln_max_d()}")


def _launch(name, fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")
    KERNEL_INVOCATIONS[name] += 1


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def ln_fwd(x2d, scale, bias, eps: float = LN_EPS):
    """LayerNorm forward of rows ``x2d`` [R, D] -> (y, mu [R], rstd [R]).
    ``scale`` and ``bias`` are [D] fp32."""
    if _on_cpu(x2d):
        return ref_ln_fwd(x2d, scale, bias, eps)
    code = _io_dtype("ln_fwd", x2d)
    r, d = x2d.shape
    lib = _lib()
    _check_width("ln_fwd", d, lib)
    dev = x2d.device
    _check("ln_fwd x", x2d, device=dev, dtype=x2d.dtype, shape=(r, d))
    for t in (scale, bias):
        _check("ln_fwd scale/bias", t, device=dev, dtype=torch.float32,
               shape=(d,))
    y = torch.empty_like(x2d)
    mu = torch.empty(r, device=dev, dtype=torch.float32)
    rstd = torch.empty(r, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        _launch("ln_fwd", lib.rt_ln_fwd, x2d.data_ptr(), scale.data_ptr(),
                bias.data_ptr(), y.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
                r, d, eps, code, _stream(dev))
    return y, mu, rstd


def ln_bwd(x2d, mu, rstd, scale, dy, dres=None):
    """LayerNorm backward -> (dx, dscale [D] fp32, dbias [D] fp32); ``dres``
    (the residual cotangent, or None) is added into dx. The kernel writes
    per-row-block fp32 partials that one ``torch.sum`` collapses, as the
    JAX package sums its kernel's partials outside the kernel."""
    if _on_cpu(x2d):
        return ref_ln_bwd(x2d, mu, rstd, scale, dy, dres)
    code = _io_dtype("ln_bwd", x2d)
    r, d = x2d.shape
    lib = _lib()
    _check_width("ln_bwd", d, lib)
    dev = x2d.device
    _check("ln_bwd x", x2d, device=dev, dtype=x2d.dtype, shape=(r, d))
    _check("ln_bwd dy", dy, device=dev, dtype=x2d.dtype, shape=(r, d))
    if dres is not None:
        _check("ln_bwd dres", dres, device=dev, dtype=x2d.dtype, shape=(r, d))
    for t in (mu, rstd):
        _check("ln_bwd mu/rstd", t, device=dev, dtype=torch.float32,
               shape=(r,))
    _check("ln_bwd scale", scale, device=dev, dtype=torch.float32, shape=(d,))
    rows_per_block = lib.rt_ln_bwd_rows_per_block()
    n_blocks = -(-r // rows_per_block)
    dx = torch.empty_like(x2d)
    parts = torch.empty(2, n_blocks, d, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        _launch("ln_bwd", lib.rt_ln_bwd, x2d.data_ptr(), mu.data_ptr(),
                rstd.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                None if dres is None else dres.data_ptr(), dx.data_ptr(),
                parts[0].data_ptr(), parts[1].data_ptr(), r, d, code,
                _stream(dev))
    dscale, dbias = parts.sum(1)
    return dx, dscale, dbias


def gelu_fwd(x):
    """tanh-GELU of a contiguous tensor, elementwise, in ``x.dtype``."""
    if _on_cpu(x):
        return ref_gelu(x)
    code = _io_dtype("gelu_fwd", x)
    _check("gelu_fwd x", x, device=x.device, dtype=x.dtype, shape=x.shape)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("gelu_fwd", _lib().rt_gelu_fwd, x.data_ptr(), y.data_ptr(),
                x.numel(), code, _stream(x.device))
    return y


def gelu_bwd(x, g):
    """dx = g * GELU'(x), with tanh recomputed from the pre-activation x."""
    if _on_cpu(x):
        return ref_gelu_bwd(x, g)
    code = _io_dtype("gelu_bwd", x)
    _check("gelu_bwd x", x, device=x.device, dtype=x.dtype, shape=x.shape)
    _check("gelu_bwd g", g, device=x.device, dtype=x.dtype, shape=x.shape)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("gelu_bwd", _lib().rt_gelu_bwd, x.data_ptr(), g.data_ptr(),
                dx.data_ptr(), x.numel(), code, _stream(x.device))
    return dx


# -- autograd wiring -------------------------------------------------------


class _LayerNorm(torch.autograd.Function):
    """With ``residual`` the Function also returns x: a view of the input,
    so its cotangent -- the residual-add gradient -- arrives in
    ``backward`` as ``dres`` and is summed into dx inside the one backward
    kernel."""

    @staticmethod
    def forward(ctx, x2d, scale, bias, eps, residual):
        y, mu, rstd = ln_fwd(x2d, scale, bias, eps)
        ctx.save_for_backward(x2d, scale, mu, rstd)
        return (y, x2d.view_as(x2d)) if residual else y

    @staticmethod
    def backward(ctx, dy, dres=None):
        x2d, scale, mu, rstd = ctx.saved_tensors
        if dres is not None:
            dres = dres.contiguous()
        dx, dscale, dbias = ln_bwd(x2d, mu, rstd, scale, dy.contiguous(), dres)
        return dx, dscale.to(scale.dtype), dbias.to(scale.dtype), None, None


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return gelu_fwd(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return gelu_bwd(x, g.contiguous())


# -- public API ------------------------------------------------------------


def fused_layer_norm(x, scale, bias, *, eps: float = LN_EPS):
    """LayerNorm over the last dim of ``x`` [..., D]; fp32 statistics,
    output in ``x.dtype``."""
    y = _LayerNorm.apply(x.reshape(-1, x.shape[-1]).contiguous(), scale,
                         bias, eps, False)
    return y.reshape(x.shape)


def fused_layer_norm_residual(x, scale, bias, *, eps: float = LN_EPS):
    """(LayerNorm(x), x): feed the second output into the residual add --
    its cotangent is summed into dx inside the one backward kernel."""
    y, x_skip = _LayerNorm.apply(
        x.reshape(-1, x.shape[-1]).contiguous(), scale, bias, eps, True)
    return y.reshape(x.shape), x_skip.reshape(x.shape)


def fused_gelu(x):
    """tanh-GELU with the fused backward (MLP path)."""
    return _Gelu.apply(x.contiguous())
