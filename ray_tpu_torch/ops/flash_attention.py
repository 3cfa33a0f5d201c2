"""Flash attention, forward and backward, with hand-written CUDA kernels
(``csrc/flash_attention.cu``).

Port of ``ray_tpu/ops/flash_attention.py``. Three kernels, each with a
wrapper and a plain PyTorch version of the same function:

* ``flash_fwd`` (``ref_flash_fwd``): online-softmax attention -> out and the
  fp32 logsumexp per row;
* ``flash_dkv`` (``ref_flash_dkv``): dK and dV for fixed K/V tiles,
  sweeping the q tiles, P recomputed from the lse it is given;
* ``flash_dq`` (``ref_flash_dq``): dQ for fixed Q tiles, sweeping the k
  tiles.

The backward is the JAX package's long-sequence path (``_dkv_kernel``
without dQ partials, then ``_dq_kernel``): the Hopper kernels sweep tiles
of 16 to 128 rows, so at T = 1024 there are at least 8 k-blocks, past the
TPU's ``_DQ_PARTIALS_MAX_KB``. ``delta = rowsum(dO * O)`` is one torch
reduction outside the kernels, as the JAX package's einsum is outside
Pallas.

A wrapper given CPU tensors computes the plain version; given CUDA tensors
it checks them, launches the kernel or raises -- it never falls back.
``KERNEL_INVOCATIONS`` counts real launches only. The kernels take bf16 and
head_dim 64 or 128; q, k, v and dO may be strided views (last two dims
packed), as the model's views into its fused qkv product are. lse and
delta are [B, H, T] fp32.

``flash_causal_attention`` is a ``torch.autograd.Function`` over the
wrappers, so on the CPU it runs the same plumbing over the plain versions,
which is what the CPU tests hold against the JAX package.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from ray_tpu_torch.ops._build import launch, load_library, on_cpu, stream

_NEG_INF = -1e30  # masked scores; exp(-1e30 - lse) is 0, never NaN

# Head dims the kernels are built for.
HEAD_DIMS = (64, 128)

# Launches per kernel name, bumped by a wrapper only where it launches.
KERNEL_INVOCATIONS: collections.Counter = collections.Counter()
_launch = functools.partial(launch, KERNEL_INVOCATIONS)

_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_longlong
_SIGNATURES = {
    # q, k, v, o, lse, B, H, T, D, sq_b, sq_t, sk_b, sk_t, sv_b, sv_t,
    # scale, causal, stream
    "rt_flash_fwd": [_P] * 5 + [_I] * 4 + [_LL] * 6 + [_F, _I, _P],
    # q, k, v, g, lse, delta, dk, dv, B, H, T, D, 8 strides, scale, causal,
    # stream
    "rt_flash_dkv": [_P] * 8 + [_I] * 4 + [_LL] * 8 + [_F, _I, _P],
    # q, k, v, g, lse, delta, dq, B, H, T, D, 8 strides, scale, causal,
    # stream
    "rt_flash_dq": [_P] * 7 + [_I] * 4 + [_LL] * 8 + [_F, _I, _P],
    # kernel (0 fwd, 1 dkv, 2 dq), D
    "rt_flash_smem": [_I, _I],
}
_SMEM_KERNELS = ("flash_fwd", "flash_dkv", "flash_dq")


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = load_library("flash_attention")
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


# -- plain versions (the CPU path, and what the kernels are held against) --


def _scores(q, k, softmax_scale: float, causal: bool):
    """[B, H, Tq, Tk] fp32 scores, scaled after the product (the kernels'
    order), masked entries at -1e30."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * softmax_scale
    if causal:
        t = q.shape[1]
        keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, _NEG_INF)
    return s


def ref_flash_fwd(q, k, v, *, softmax_scale: float, causal: bool):
    """q, k, v [B, T, H, D] -> (out [B, T, H, D] in q.dtype, lse [B, H, T]
    fp32). Dense fp32 scores; P is cast to v.dtype before the PV product,
    as the kernel does; the denominator is clamped at 1e-30."""
    s = _scores(q, k, softmax_scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    out = acc / l.permute(0, 2, 1, 3)
    return out.to(q.dtype), (m + torch.log(l))[..., 0]


def flash_delta(out, g):
    """delta = rowsum(dO * O) in fp32, [B, H, T]: the softmax Jacobian's
    diagonal term, one reduction outside the kernels."""
    return torch.einsum("bthd,bthd->bht", g.float(), out.float()).contiguous()


def _p_ds(q, k, v, g, lse, delta, softmax_scale: float, causal: bool):
    """P = exp(S - lse) and dS = P * (dO V^T - delta) * scale, both cast to
    q.dtype (the rounding the kernels apply before their products)."""
    p = torch.exp(_scores(q, k, softmax_scale, causal) - lse[..., None])
    dp = torch.einsum("bqhd,bkhd->bhqk", g.float(), v.float())
    ds = p * (dp - delta[..., None]) * softmax_scale
    return p.to(q.dtype).float(), ds.to(q.dtype).float()


def ref_flash_dkv(q, k, v, g, lse, delta, *, softmax_scale: float,
                  causal: bool):
    """-> (dk, dv) [B, T, H, D] in k.dtype / v.dtype."""
    p, ds = _p_ds(q, k, v, g, lse, delta, softmax_scale, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, g.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    return dk.to(k.dtype), dv.to(v.dtype)


def ref_flash_dq(q, k, v, g, lse, delta, *, softmax_scale: float,
                 causal: bool):
    """-> dq [B, T, H, D] in q.dtype."""
    _, ds = _p_ds(q, k, v, g, lse, delta, softmax_scale, causal)
    return torch.einsum("bhqk,bkhd->bqhd", ds, k.float()).to(q.dtype)


def ref_flash_bwd(q, k, v, out, lse, g, *, softmax_scale: float,
                  causal: bool):
    """-> (dq, dk, dv). ``lse`` is an input, as in ``_flash_bwd``: a caller
    may pass a global or masking lse (ring attention does)."""
    delta = flash_delta(out, g)
    kw = dict(softmax_scale=softmax_scale, causal=causal)
    dk, dv = ref_flash_dkv(q, k, v, g, lse, delta, **kw)
    return ref_flash_dq(q, k, v, g, lse, delta, **kw), dk, dv


# -- kernel wrappers -------------------------------------------------------


def _check_rows(name, t, shape, device):
    """A bf16 [B, T, H, D] operand with packed (H, D) dims and 16-byte
    aligned rows; returns its (batch, time) strides."""
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the flash kernels take bfloat16 on CUDA, "
                        f"got {t.dtype} (fp32 flash on CUDA is not ported)")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    sb, st, sh, sd = t.stride()
    if sd != 1 or sh != shape[3]:
        raise ValueError(f"{name}: the last two dims must be packed "
                         f"(strides {t.stride()})")
    if t.data_ptr() % 16 or sb % 8 or st % 8:
        raise ValueError(f"{name}: rows must be 16-byte aligned "
                         f"(strides {t.stride()})")
    return sb, st


def _check_stats(name, t, shape, device):
    if (t.device != device or t.dtype != torch.float32
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous()):
        raise ValueError(f"{name}: expected a contiguous fp32 tensor of shape "
                         f"{tuple(shape)} on {device}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _geometry(name, q):
    b, t, h, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: the kernels take head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    return b, t, h, d


def flash_fwd(q, k, v, *, softmax_scale: float, causal: bool):
    """q, k, v [B, T, H, D] -> (out [B, T, H, D], lse [B, H, T] fp32)."""
    if on_cpu(q):
        return ref_flash_fwd(q, k, v, softmax_scale=softmax_scale,
                             causal=causal)
    b, t, h, d = _geometry("flash_fwd", q)
    dev = q.device
    strides = [s for name, x in (("q", q), ("k", k), ("v", v))
               for s in _check_rows(f"flash_fwd {name}", x, q.shape, dev)]
    out = torch.empty(b, t, h, d, device=dev, dtype=q.dtype)
    lse = torch.empty(b, h, t, device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        _launch("flash_fwd", _lib().rt_flash_fwd, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), out.data_ptr(), lse.data_ptr(), b, h, t, d,
                *strides, softmax_scale, int(causal), stream(dev))
    return out, lse


def _bwd_checks(name, q, k, v, g, lse, delta):
    b, t, h, d = _geometry(name, q)
    dev = q.device
    strides = [s for n, x in (("q", q), ("k", k), ("v", v), ("g", g))
               for s in _check_rows(f"{name} {n}", x, q.shape, dev)]
    _check_stats(f"{name} lse", lse, (b, h, t), dev)
    _check_stats(f"{name} delta", delta, (b, h, t), dev)
    return (b, h, t, d), strides


def flash_dkv(q, k, v, g, lse, delta, *, softmax_scale: float, causal: bool):
    """-> (dk, dv) [B, T, H, D]; g is dO, lse and delta [B, H, T] fp32."""
    if on_cpu(q):
        return ref_flash_dkv(q, k, v, g, lse, delta,
                             softmax_scale=softmax_scale, causal=causal)
    dims, strides = _bwd_checks("flash_dkv", q, k, v, g, lse, delta)
    dk = torch.empty(q.shape, device=q.device, dtype=k.dtype)
    dv = torch.empty(q.shape, device=q.device, dtype=v.dtype)
    with torch.cuda.device(q.device):
        _launch("flash_dkv", _lib().rt_flash_dkv, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), *dims, *strides, softmax_scale,
                int(causal), stream(q.device))
    return dk, dv


def flash_dq(q, k, v, g, lse, delta, *, softmax_scale: float, causal: bool):
    """-> dq [B, T, H, D]; accumulated in fp32 without atomics."""
    if on_cpu(q):
        return ref_flash_dq(q, k, v, g, lse, delta,
                            softmax_scale=softmax_scale, causal=causal)
    dims, strides = _bwd_checks("flash_dq", q, k, v, g, lse, delta)
    dq = torch.empty(q.shape, device=q.device, dtype=q.dtype)
    with torch.cuda.device(q.device):
        _launch("flash_dq", _lib().rt_flash_dq, q.data_ptr(), k.data_ptr(),
                v.data_ptr(), g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), *dims, *strides, softmax_scale, int(causal),
                stream(q.device))
    return dq


def smem_bytes(kernel: str, d: int) -> int:
    """The dynamic shared memory a launch of ``kernel`` (``flash_fwd``,
    ``flash_dkv`` or ``flash_dq``) requests at head_dim ``d``, for reports
    beside ptxas's register counts."""
    return _lib().rt_flash_smem(_SMEM_KERNELS.index(kernel), d)


# -- autograd wiring -------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Saves (q, k, v, out, lse), as ``_vjp_fwd``; the backward runs delta,
    then ``flash_dkv``, then ``flash_dq``."""

    @staticmethod
    def forward(ctx, q, k, v, softmax_scale, causal):
        out, lse = flash_fwd(q, k, v, softmax_scale=softmax_scale,
                             causal=causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.softmax_scale, ctx.causal = softmax_scale, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        g = g.contiguous()
        delta = flash_delta(out, g)
        kw = dict(softmax_scale=ctx.softmax_scale, causal=ctx.causal)
        dk, dv = flash_dkv(q, k, v, g, lse, delta, **kw)
        dq = flash_dq(q, k, v, g, lse, delta, **kw)
        return dq, dk, dv, None, None


# -- public API ------------------------------------------------------------


def flash_causal_attention(q, k, v, *, softmax_scale: float | None = None,
                           block_q: int = 1024, block_k: int = 1024):
    """[B, T, H, D] causal flash attention (differentiable).

    ``block_q`` and ``block_k`` are the JAX package's TPU VMEM tile sizes;
    they are accepted for the same signature and ignored: the CUDA kernels
    fix their own tiles and mask any ragged tail, so every T runs."""
    del block_q, block_k
    d = q.shape[-1]
    scale = softmax_scale if softmax_scale is not None else d ** -0.5
    return _FlashAttention.apply(q, k, v, scale, True)
