"""ray_tpu_torch.ops.fused_norm against ray_tpu.ops.fused_norm on the CPU.

The same numpy inputs go through the JAX package's fused ops -- whose
Pallas kernels run in interpret mode on the CPU, asserted through its
KERNEL_INVOCATIONS -- and through the port's autograd Functions, which on
CPU tensors run their kernels' plain versions. D=128 (and, for LayerNorm,
GPT-2 small's 768 too) because the JAX side takes its Pallas path only
when D % 128 == 0.

Tolerances (fp32): forward rtol 1e-5, gradients rtol 1e-4. Both sides do
the same fp32 arithmetic; only the order of the row and column sums
differs, which moves results by a few ulp per reduction. bf16 (RMSNorm):
the two frameworks round at other points, so the JAX package's own bf16
criterion holds -- gradient cosine > 0.999.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import fused_norm as jfn
from ray_tpu_torch.ops import fused_norm as tfn

D = 128
ROWS = 48


def _data(seed, d=D, rows=ROWS):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((rows, d), dtype=np.float32) * 2 + 0.5
    scale = (rng.standard_normal(d, dtype=np.float32) * 0.1 + 1.0)
    bias = rng.standard_normal(d, dtype=np.float32) * 0.1
    w = rng.standard_normal(d, dtype=np.float32)
    return x, scale, bias, w


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _jax_moved(name, fn):
    before = jfn.KERNEL_INVOCATIONS[name]
    out = fn()
    assert jfn.KERNEL_INVOCATIONS[name] > before, f"JAX {name} kernel not taken"
    return out


def _close(port, ref, rtol, name=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=rtol, atol=rtol * 1e-1, err_msg=name)


def _layer_norm_forward_case(residual, d):
    x, scale, bias, _ = _data(0, d=d)
    port_before = dict(tfn.KERNEL_INVOCATIONS)
    if residual:
        ref, ref_skip = _jax_moved("ln_fwd", lambda: jfn.fused_layer_norm_residual(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
        y, skip = tfn.fused_layer_norm_residual(_t(x), _t(scale), _t(bias))
        np.testing.assert_array_equal(skip.numpy(), np.asarray(ref_skip))
    else:
        ref = _jax_moved("ln_fwd", lambda: jfn.fused_layer_norm(
            jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))
        y = tfn.fused_layer_norm(_t(x), _t(scale), _t(bias))
    _close(y, ref, 1e-5)
    # CPU tensors take the plain version: no kernel was launched.
    assert dict(tfn.KERNEL_INVOCATIONS) == port_before


def _layer_norm_gradients_case(residual, d):
    x, scale, bias, w = _data(1, d=d)

    def jax_loss(x, s, b):
        if residual:
            y, skip = jfn.fused_layer_norm_residual(x, s, b)
        else:
            y, skip = jfn.fused_layer_norm(x, s, b), 0.0
        return jnp.sum((skip + y * jnp.asarray(w)) ** 2)

    ref = _jax_moved("ln_bwd", lambda: jax.grad(jax_loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias)))

    xt, st, bt = _t(x, True), _t(scale, True), _t(bias, True)
    if residual:
        y, skip = tfn.fused_layer_norm_residual(xt, st, bt)
    else:
        y, skip = tfn.fused_layer_norm(xt, st, bt), 0.0
    torch.sum((skip + y * _t(w)) ** 2).backward()
    for got, want, name in zip((xt.grad, st.grad, bt.grad), ref,
                               ("dx", "dscale", "dbias")):
        _close(got, want, 1e-4, name)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_forward_matches_jax(residual):
    _layer_norm_forward_case(residual, D)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_gradients_match_jax(residual):
    """dx, dscale, dbias -- and with ``residual`` the skip output's
    cotangent, which must reach dx through the backward's dres."""
    _layer_norm_gradients_case(residual, D)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_forward_matches_jax_at_gpt2_width(residual):
    """GPT-2 small's D = 768, the width of the port's main path (the one
    the one-warp LayerNorm kernels take on the card)."""
    _layer_norm_forward_case(residual, 768)


@pytest.mark.parametrize("residual", [False, True])
def test_layer_norm_gradients_match_jax_at_gpt2_width(residual):
    """dx, dscale and dbias at D = 768, residual and not."""
    _layer_norm_gradients_case(residual, 768)


def test_residual_cotangent_matches_the_plain_chain():
    """The view returned as the skip output neither loses nor doubles the
    residual gradient: the fused op's d loss / d x equals that of the
    plain chain ``x + LN(x)`` in the port itself."""
    x, scale, bias, w = _data(2)
    xa, xb = _t(x, True), _t(x, True)
    y, skip = tfn.fused_layer_norm_residual(xa, _t(scale), _t(bias))
    torch.sum((skip * 3.0 + y * _t(w)) ** 2).backward()
    y_ref = tfn.ref_layer_norm(xb, _t(scale), _t(bias))
    torch.sum((xb * 3.0 + y_ref * _t(w)) ** 2).backward()
    _close(xa.grad, xb.grad.numpy(), 1e-4)


def test_gelu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((ROWS, 4 * D), dtype=np.float32) * 2
    g = rng.standard_normal((ROWS, 4 * D), dtype=np.float32)
    ref = _jax_moved("gelu_fwd", lambda: jfn.fused_gelu(jnp.asarray(x)))
    xt = _t(x, True)
    y = tfn.fused_gelu(xt)
    _close(y, ref, 1e-5)

    ref_dx = _jax_moved("gelu_bwd", lambda: jax.grad(
        lambda u: jnp.sum(jfn.fused_gelu(u) * jnp.asarray(g)))(jnp.asarray(x)))
    (y * _t(g)).sum().backward()
    _close(xt.grad, ref_dx, 1e-4)


def test_plain_versions_match_the_jax_plain_chains():
    """The port's plain versions (its CPU path and the kernels' oracle)
    equal the JAX package's plain references at a width the JAX side
    would never fuse (D=100)."""
    x, scale, bias, _ = _data(4, d=100, rows=8)
    _close(tfn.ref_layer_norm(_t(x), _t(scale), _t(bias)),
           jfn.ref_layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias)), 1e-5)
    _close(tfn.ref_gelu(_t(x)), jfn.ref_gelu(jnp.asarray(x)), 1e-5)


# -- RMSNorm --------------------------------------------------------------


def _rms_loss(mod, residual, w):
    """sum((skip + RMSNorm(x) * w)^2) through ``mod``'s fused RMS ops."""
    def loss(x, s):
        if residual:
            y, skip = mod.fused_rms_norm_residual(x, s)
        else:
            y, skip = mod.fused_rms_norm(x, s), 0.0
        return ((skip + y * w) ** 2).sum()
    return loss


@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_forward_matches_jax(residual):
    x, scale, _, _ = _data(5)
    port_before = dict(tfn.KERNEL_INVOCATIONS)
    if residual:
        ref, ref_skip = _jax_moved("rms_fwd", lambda: jfn.fused_rms_norm_residual(
            jnp.asarray(x), jnp.asarray(scale)))
        y, skip = tfn.fused_rms_norm_residual(_t(x), _t(scale))
        np.testing.assert_array_equal(skip.numpy(), np.asarray(ref_skip))
    else:
        ref = _jax_moved("rms_fwd", lambda: jfn.fused_rms_norm(
            jnp.asarray(x), jnp.asarray(scale)))
        y = tfn.fused_rms_norm(_t(x), _t(scale))
    _close(y, ref, 1e-5)
    # The plain rstd is the kernel's other output: rsqrt(mean(x^2) + 1e-6).
    _, rstd = tfn.ref_rms_fwd(_t(x), _t(scale))
    _close(rstd, 1 / np.sqrt((x.astype(np.float64) ** 2).mean(-1) + 1e-6),
           1e-5)
    assert dict(tfn.KERNEL_INVOCATIONS) == port_before


@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_gradients_match_jax(residual):
    """dx and dscale -- and with ``residual`` the skip output's cotangent,
    which must reach dx through the backward's dres."""
    x, scale, _, w = _data(6)
    ref = _jax_moved("rms_bwd", lambda: jax.grad(
        _rms_loss(jfn, residual, jnp.asarray(w)), argnums=(0, 1))(
            jnp.asarray(x), jnp.asarray(scale)))
    xt, st = _t(x, True), _t(scale, True)
    _rms_loss(tfn, residual, _t(w))(xt, st).backward()
    for got, want, name in zip((xt.grad, st.grad), ref, ("dx", "dscale")):
        _close(got, want, 1e-4, name)


@pytest.mark.parametrize("residual", [False, True])
def test_rms_norm_bf16_tracks_jax(residual):
    """bf16 activations (fp32 scale) through both packages: the forward
    within a bf16 ulp or two, the gradients by cosine > 0.999."""
    x, scale, _, w = _data(7)
    xb = jnp.asarray(x, jnp.bfloat16)
    ref_y = _jax_moved("rms_fwd", lambda: jfn.fused_rms_norm(
        xb, jnp.asarray(scale)))
    ref = _jax_moved("rms_bwd", lambda: jax.grad(
        lambda x, s: _rms_loss(jfn, residual, jnp.asarray(w))(x, s).astype(
            jnp.float32), argnums=(0, 1))(xb, jnp.asarray(scale)))
    xt = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    st = _t(scale, True)
    y = tfn.fused_rms_norm(xt.detach(), st.detach())
    assert y.dtype == torch.bfloat16
    np.testing.assert_allclose(y.float().numpy(),
                               np.asarray(ref_y, np.float32), rtol=2e-2,
                               atol=2e-2)
    _rms_loss(tfn, residual, _t(w))(xt, st).float().backward()
    for got, want in zip((xt.grad, st.grad), ref):
        a = got.float().numpy().ravel().astype(np.float64)
        b = np.asarray(want, np.float32).ravel().astype(np.float64)
        assert a @ b / (np.linalg.norm(a) * np.linalg.norm(b)) > 0.999


def test_rms_residual_cotangent_matches_the_plain_chain():
    """The skip view neither loses nor doubles the residual gradient."""
    x, scale, _, w = _data(8)
    xa, xb = _t(x, True), _t(x, True)
    y, skip = tfn.fused_rms_norm_residual(xa, _t(scale))
    torch.sum((skip * 3.0 + y * _t(w)) ** 2).backward()
    y_ref = tfn.ref_rms_norm(xb, _t(scale))
    torch.sum((xb * 3.0 + y_ref * _t(w)) ** 2).backward()
    _close(xa.grad, xb.grad.numpy(), 1e-4)


def test_rms_plain_versions_match_the_jax_plain_chain():
    """``ref_rms_norm`` (the CPU path and the kernels' oracle) equals the
    JAX package's plain reference at a width it would never fuse, and the
    plain backward equals autograd through the plain forward."""
    x, scale, _, _ = _data(9, d=100, rows=8)
    _close(tfn.ref_rms_norm(_t(x), _t(scale)),
           jfn.ref_rms_norm(jnp.asarray(x), jnp.asarray(scale)), 1e-5)
    rng = np.random.default_rng(10)
    dy, dres = (rng.standard_normal(x.shape, dtype=np.float32)
                for _ in range(2))
    xt, st = _t(x, True), _t(scale, True)
    y = tfn.ref_rms_norm(xt, st)
    torch.autograd.backward([y, xt], [_t(dy), _t(dres)])
    _, rstd = tfn.ref_rms_fwd(_t(x), _t(scale))
    dx, dscale = tfn.ref_rms_bwd(_t(x), rstd, _t(scale), _t(dy), _t(dres))
    _close(dx, xt.grad.numpy(), 1e-4)
    _close(dscale, st.grad.numpy(), 1e-4)
