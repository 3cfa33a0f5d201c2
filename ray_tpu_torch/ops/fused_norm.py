"""Fused LayerNorm(+residual), RMSNorm(+residual) and tanh-GELU, with
hand-written CUDA kernels for the forward and the backward
(``csrc/fused_norm.cu``).

Port of ``ray_tpu/ops/fused_norm.py``. The design carries over: the
LayerNorm forward saves only fp32 mean and rstd per row (RMSNorm: rstd
only); one backward kernel computes dx, the dscale (and, for LayerNorm,
dbias) column partials and, in the ``_residual`` variant, adds the residual
cotangent; the GELU backward recomputes tanh from the saved pre-activation.

Each kernel has a wrapper (``ln_fwd``, ``ln_bwd``, ``rms_fwd``, ``rms_bwd``,
``gelu_fwd``, ``gelu_bwd``) and a plain PyTorch version of the same function
(``ref_ln_fwd``, ``ref_ln_bwd``, ``ref_rms_fwd``, ``ref_rms_bwd``,
``ref_gelu``, ``ref_gelu_bwd``). A wrapper
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

from ray_tpu_torch.ops._build import (launch, load_library, on_cpu,
                                      raise_on_error, stream)

LN_EPS = 1e-5  # matches models/gpt2.py _layer_norm
RMS_EPS = 1e-6  # matches models/llama.py _rms_norm

# Launches per kernel name, bumped by a wrapper only where it launches.
KERNEL_INVOCATIONS: collections.Counter = collections.Counter()
_launch = functools.partial(launch, KERNEL_INVOCATIONS)

_GELU_C = math.sqrt(2.0 / math.pi)
_GELU_A = 0.044715

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    "rt_ln_max_d": [],
    "rt_ln_bwd_rows_per_block": [],
    "rt_rms_bwd_rows_per_block": [],
    "rt_ln_fwd": [_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rt_ln_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "rt_norm_bwd_sum": [_P, _I, _I, _I, _P, _P],
    "rt_rms_fwd": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "rt_rms_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
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


def ref_rms_fwd(x2d, scale, eps: float = RMS_EPS):
    """x2d [R, D] -> (y [R, D] in x2d.dtype, rstd [R] fp32), with
    rstd = rsqrt(mean(x^2) + eps) and y = x * rstd * scale."""
    x32 = x2d.float()
    rstd = torch.rsqrt((x32 * x32).mean(-1, keepdim=True) + eps)
    return (x32 * rstd * scale).to(x2d.dtype), rstd[:, 0]


def ref_rms_bwd(x2d, rstd, scale, dy, dres=None):
    """-> (dx [R, D] in x2d.dtype, dscale [D] fp32). No mean, so no c1 and
    no dbias: dx = rstd * (dy*scale - xhat * mean(dy*scale*xhat)) (+ dres),
    dscale = sum over rows of dy * xhat, with xhat = x * rstd."""
    xhat = x2d.float() * rstd[:, None]
    dy32 = dy.float()
    dxhat = dy32 * scale
    c2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = rstd[:, None] * (dxhat - xhat * c2)
    if dres is not None:
        dx = dx + dres.float()
    return dx.to(x2d.dtype), (dy32 * xhat).sum(0)


def ref_rms_norm(x, scale, eps: float = RMS_EPS):
    """The model's ``_rms_norm`` chain over the last dim of ``x``: fp32
    statistics, output in ``x.dtype``. Differentiable by autograd."""
    y, _ = ref_rms_fwd(x.reshape(-1, x.shape[-1]), scale, eps)
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


def ln_fwd(x2d, scale, bias, eps: float = LN_EPS):
    """LayerNorm forward of rows ``x2d`` [R, D] -> (y, mu [R], rstd [R]).
    ``scale`` and ``bias`` are [D] fp32."""
    if on_cpu(x2d):
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
                r, d, eps, code, stream(dev))
    return y, mu, rstd


def ln_bwd(x2d, mu, rstd, scale, dy, dres=None):
    """LayerNorm backward -> (dx, dscale [D] fp32, dbias [D] fp32); ``dres``
    (the residual cotangent, or None) is added into dx. The kernel writes
    one fp32 partial row of dscale and of dbias per block of
    ``rt_ln_bwd_rows_per_block`` rows, and a second kernel
    (``norm_bwd_sum``) adds them in a fixed order, as the JAX package sums
    its kernel's partials outside the kernel."""
    if on_cpu(x2d):
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
                stream(dev))
    dscale, dbias = norm_bwd_sum(parts)
    return dx, dscale, dbias


def norm_bwd_sum(parts):
    """A backward's partial rows [k, n, D] fp32 -- ``ln_bwd``'s dscale and
    dbias (k = 2), ``rms_bwd``'s dscale (k = 1) -- -> their column sums
    [k, D], each column's rows added in a fixed order by one kernel
    (``torch.sum`` over the middle axis is slower on the card). A CPU
    tensor takes the plain version, ``parts.sum(1)``."""
    if on_cpu(parts):
        return parts.sum(1)
    k, n, d = parts.shape
    _check("norm_bwd_sum parts", parts, device=parts.device,
           dtype=torch.float32, shape=(k, n, d))
    dev = parts.device
    sums = torch.empty(k, d, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        raise_on_error("norm_bwd_sum", _lib().rt_norm_bwd_sum(
            parts.data_ptr(), k, n, d, sums.data_ptr(), stream(dev)))
    return sums


def rms_fwd(x2d, scale, eps: float = RMS_EPS):
    """RMSNorm forward of rows ``x2d`` [R, D] -> (y, rstd [R] fp32).
    ``scale`` is [D] fp32."""
    if on_cpu(x2d):
        return ref_rms_fwd(x2d, scale, eps)
    code = _io_dtype("rms_fwd", x2d)
    r, d = x2d.shape
    lib = _lib()
    _check_width("rms_fwd", d, lib)
    dev = x2d.device
    _check("rms_fwd x", x2d, device=dev, dtype=x2d.dtype, shape=(r, d))
    _check("rms_fwd scale", scale, device=dev, dtype=torch.float32,
           shape=(d,))
    y = torch.empty_like(x2d)
    rstd = torch.empty(r, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        _launch("rms_fwd", lib.rt_rms_fwd, x2d.data_ptr(), scale.data_ptr(),
                y.data_ptr(), rstd.data_ptr(), r, d, eps, code, stream(dev))
    return y, rstd


def rms_bwd(x2d, rstd, scale, dy, dres=None):
    """RMSNorm backward -> (dx, dscale [D] fp32); ``dres`` (the residual
    cotangent, or None) is added into dx. The kernel writes only dscale
    partials, one [D] fp32 row per block of ``rt_rms_bwd_rows_per_block``
    rows (its own, so that ln_bwd's geometry cannot move it), and
    ``norm_bwd_sum`` adds them in a fixed order."""
    if on_cpu(x2d):
        return ref_rms_bwd(x2d, rstd, scale, dy, dres)
    code = _io_dtype("rms_bwd", x2d)
    r, d = x2d.shape
    lib = _lib()
    _check_width("rms_bwd", d, lib)
    dev = x2d.device
    _check("rms_bwd x", x2d, device=dev, dtype=x2d.dtype, shape=(r, d))
    _check("rms_bwd dy", dy, device=dev, dtype=x2d.dtype, shape=(r, d))
    if dres is not None:
        _check("rms_bwd dres", dres, device=dev, dtype=x2d.dtype,
               shape=(r, d))
    _check("rms_bwd rstd", rstd, device=dev, dtype=torch.float32, shape=(r,))
    _check("rms_bwd scale", scale, device=dev, dtype=torch.float32,
           shape=(d,))
    n_blocks = -(-r // lib.rt_rms_bwd_rows_per_block())
    dx = torch.empty_like(x2d)
    parts = torch.empty(1, n_blocks, d, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        _launch("rms_bwd", lib.rt_rms_bwd, x2d.data_ptr(), rstd.data_ptr(),
                scale.data_ptr(), dy.data_ptr(),
                None if dres is None else dres.data_ptr(), dx.data_ptr(),
                parts.data_ptr(), r, d, code, stream(dev))
    return dx, norm_bwd_sum(parts)[0]


def gelu_fwd(x):
    """tanh-GELU of a contiguous tensor, elementwise, in ``x.dtype``."""
    if on_cpu(x):
        return ref_gelu(x)
    code = _io_dtype("gelu_fwd", x)
    _check("gelu_fwd x", x, device=x.device, dtype=x.dtype, shape=x.shape)
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("gelu_fwd", _lib().rt_gelu_fwd, x.data_ptr(), y.data_ptr(),
                x.numel(), code, stream(x.device))
    return y


def gelu_bwd(x, g):
    """dx = g * GELU'(x), with tanh recomputed from the pre-activation x."""
    if on_cpu(x):
        return ref_gelu_bwd(x, g)
    code = _io_dtype("gelu_bwd", x)
    _check("gelu_bwd x", x, device=x.device, dtype=x.dtype, shape=x.shape)
    _check("gelu_bwd g", g, device=x.device, dtype=x.dtype, shape=x.shape)
    dx = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("gelu_bwd", _lib().rt_gelu_bwd, x.data_ptr(), g.data_ptr(),
                dx.data_ptr(), x.numel(), code, stream(x.device))
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


class _RMSNorm(torch.autograd.Function):
    """The RMSNorm twin of ``_LayerNorm``: saves x and the fp32 rstd, and
    with ``residual`` returns a view of x whose cotangent arrives as
    ``dres``."""

    @staticmethod
    def forward(ctx, x2d, scale, eps, residual):
        y, rstd = rms_fwd(x2d, scale, eps)
        ctx.save_for_backward(x2d, scale, rstd)
        return (y, x2d.view_as(x2d)) if residual else y

    @staticmethod
    def backward(ctx, dy, dres=None):
        x2d, scale, rstd = ctx.saved_tensors
        if dres is not None:
            dres = dres.contiguous()
        dx, dscale = rms_bwd(x2d, rstd, scale, dy.contiguous(), dres)
        return dx, dscale.to(scale.dtype), None, None


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


def fused_rms_norm(x, scale, *, eps: float = RMS_EPS):
    """RMSNorm over the last dim of ``x`` [..., D] (no mean, no bias);
    fp32 rstd, output in ``x.dtype``."""
    y = _RMSNorm.apply(x.reshape(-1, x.shape[-1]).contiguous(), scale, eps,
                       False)
    return y.reshape(x.shape)


def fused_rms_norm_residual(x, scale, *, eps: float = RMS_EPS):
    """(RMSNorm(x), x): feed the second output into the residual add --
    its cotangent is summed into dx inside the one backward kernel."""
    y, x_skip = _RMSNorm.apply(x.reshape(-1, x.shape[-1]).contiguous(),
                               scale, eps, True)
    return y.reshape(x.shape), x_skip.reshape(x.shape)


def fused_gelu(x):
    """tanh-GELU with the fused backward (MLP path)."""
    return _Gelu.apply(x.contiguous())
