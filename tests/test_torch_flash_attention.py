"""ray_tpu_torch.ops.flash_attention against ray_tpu.ops.flash_attention on
the CPU.

The same numpy inputs go through the JAX package's ``_flash_fwd`` and
``_flash_bwd`` -- whose Pallas kernels run in interpret mode on the CPU --
and through the port's plain versions and its autograd Function, which on
CPU tensors runs the kernels' plain versions. The backward is held on both
of the JAX package's paths: blocks of 32 at T = 64 (2 k-blocks, the fused
dQ-partials kernel) and blocks of 16 at T = 96 (6 k-blocks, the separate
``_dq_kernel``), with the lse given, and once with it shifted by log 2 (the
external-lse contract ring attention relies on).

Tolerances are the JAX flash tests' own (tests/test_parallel_ops.py): rtol
and atol 2e-5 forward, 2e-4 for gradients -- the same fp32 arithmetic, with
the softmax sums taken tile by tile on the JAX side and whole rows here.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import flash_attention as jfa
from ray_tpu_torch.ops import flash_attention as tfa

B, H, D = 2, 3, 16


def _data(t, seed):
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((B, t, H, D), dtype=np.float32)
                  for _ in range(4))
    return q, k, v, g


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _jax_lse(lse):
    """JAX [B*H, T, 1] -> the port's [B, H, T]."""
    lse = np.asarray(lse)
    return lse.reshape(B, H, lse.shape[1])


def _close(port, ref, tol, name=""):
    np.testing.assert_allclose(port.detach().numpy(), np.asarray(ref),
                               rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", [(64, 32), (96, 16)])
def test_forward_matches_jax(t, block, causal):
    q, k, v, _ = _data(t, seed=t + causal)
    scale = D ** -0.5
    out_j, lse_j = jfa._flash_fwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=block,
        block_k=block, softmax_scale=scale, causal=causal, interpret=True)
    out, lse = tfa.ref_flash_fwd(_t(q), _t(k), _t(v), softmax_scale=scale,
                                 causal=causal)
    _close(out, out_j, 2e-5, "out")
    _close(lse, _jax_lse(lse_j), 2e-5, "lse")
    # The wrapper on CPU tensors is the plain version.
    out_w, lse_w = tfa.flash_fwd(_t(q), _t(k), _t(v), softmax_scale=scale,
                                 causal=causal)
    assert torch.equal(out_w, out) and torch.equal(lse_w, lse)


@pytest.mark.parametrize("lse_shift", [0.0, math.log(2.0)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t,block", [(64, 32), (96, 16)])
def test_backward_matches_jax_on_both_paths(t, block, causal, lse_shift):
    """``_flash_bwd`` with with_dqp (T=64, 2 k-blocks) and with
    ``_dq_kernel`` (T=96, 6 k-blocks > _DQ_PARTIALS_MAX_KB); both sides get
    the same out and lse, shifted by ``lse_shift``."""
    assert (t // block > jfa._DQ_PARTIALS_MAX_KB) == (t == 96)
    q, k, v, g = _data(t, seed=10 * t + causal)
    scale = 0.3  # not a power of two: the scale's place must match
    jq, jk, jv, jg = map(jnp.asarray, (q, k, v, g))
    out_j, lse_j = jfa._flash_fwd(jq, jk, jv, block_q=block, block_k=block,
                                  softmax_scale=scale, causal=causal,
                                  interpret=True)
    lse_j = lse_j + lse_shift
    dq_j, dk_j, dv_j = jfa._flash_bwd(
        jq, jk, jv, out_j, lse_j, jg, block_q=block, block_k=block,
        softmax_scale=scale, causal=causal, interpret=True)
    out, lse = _t(out_j), _t(_jax_lse(lse_j))
    dq, dk, dv = tfa.ref_flash_bwd(_t(q), _t(k), _t(v), out, lse, _t(g),
                                   softmax_scale=scale, causal=causal)
    for name, got, want in (("dq", dq, dq_j), ("dk", dk, dk_j),
                            ("dv", dv, dv_j)):
        _close(got, want, 2e-4, name)
    # The per-kernel wrappers on CPU tensors give the same.
    delta = tfa.flash_delta(out, _t(g))
    kw = dict(softmax_scale=scale, causal=causal)
    dk_w, dv_w = tfa.flash_dkv(_t(q), _t(k), _t(v), _t(g), lse, delta, **kw)
    dq_w = tfa.flash_dq(_t(q), _t(k), _t(v), _t(g), lse, delta, **kw)
    assert torch.equal(dq_w, dq) and torch.equal(dk_w, dk)
    assert torch.equal(dv_w, dv)


@pytest.mark.parametrize("t,block", [(64, 32), (96, 16)])
def test_autograd_matches_jax_grad(t, block):
    q, k, v, g = _data(t, seed=t + 100)

    def jloss(q, k, v):
        out = jfa.flash_causal_attention(q, k, v, block_q=block,
                                         block_k=block)
        return jnp.sum(out * jnp.asarray(g))

    jgrads = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfa.flash_causal_attention(tq, tk, tv, block_q=block, block_k=block)
    _close(out, jfa.flash_causal_attention(
        *map(jnp.asarray, (q, k, v)), block_q=block, block_k=block), 2e-5,
        "out")
    (out * _t(g)).sum().backward()
    for name, got, want in zip("qkv", (tq.grad, tk.grad, tv.grad), jgrads):
        _close(got, want, 2e-4, f"d{name}")


def test_masked_rows_give_zero_not_nan():
    """A masking lse (+1e30, as ring attention passes for blocks ahead of
    the query shard) makes P exactly 0 and the gradients exactly 0."""
    q, k, v, g = (_t(a) for a in _data(32, seed=5))
    lse = torch.full((B, H, 32), 1e30)
    dq, dk, dv = tfa.ref_flash_bwd(q, k, v, torch.zeros_like(q), lse, g,
                                   softmax_scale=D ** -0.5, causal=False)
    for x in (dq, dk, dv):
        assert torch.equal(x, torch.zeros_like(x))
