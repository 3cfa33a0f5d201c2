"""The port's ring attention and Ulysses against the JAX package's on the
CPU (``ray_tpu_torch/ops/ring_attention.py``, ``ops/ulysses.py``).

One numpy q/k/v ([B=2, T=64, H=8, D=16], fp32) goes through:

- the JAX package's ``ring_causal_attention`` (``impl="fused"``: its
  Pallas flash kernels in interpret mode, asserted by counting
  ``_flash_fwd`` / ``_flash_bwd``; and ``"dense"``) and
  ``ulysses_attention`` over the suite's 8-device CPU mesh (dp=2, sp=4),
  as ``tests/test_parallel_ops.py`` runs them;
- the port's bodies in one process, all four ring positions folded into
  the batch (``FoldedRing``);
- the port's ``ring_causal_attention`` and ``ulysses_attention`` over 4
  gloo ranks at sp=4 (``tests/torch_mesh_ranks.py``, job ``sp_ops``), each
  rank its 16 positions.

Held: the output (rtol 1e-5, atol 1e-6) and the gradients of
``sum(out ** 2)`` with respect to q, k and v (rtol 1e-4, atol 1e-6 of
the gradient's largest magnitude, which reaches 15: elements near zero
carry the rounding of sums of terms that large) -- the same fp32
arithmetic, summed in another order. The folded ring and the gloo ranks
run the same arithmetic per row: they agree to rtol 1e-6.

The ring on the card (the flash kernels against their plain versions) is
held by ``gpu`` tests in ``tests/test_torch_package.py``, which imports no
JAX.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from ray_tpu.ops import flash_attention as jfa
from ray_tpu.ops.ring_attention import ring_causal_attention as jring
from ray_tpu.ops.ulysses import ulysses_attention as julysses
from ray_tpu_torch.ops import ring_attention as tra
from ray_tpu_torch.ops.ulysses import ulysses_attention
from ray_tpu_torch.parallel import mesh as tmesh
from test_torch_sharded_train import _join, _spawn

B, T, H, D = 2, 64, 8, 16
SP = 4
IMPLS = ("fused", "dense", "ulysses")
KEYS = ("out", "dq", "dk", "dv")


def _qkv(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D), dtype=np.float32)
            for _ in range(3)]


def _jax_run(impl, q, k, v, mesh, monkeypatch):
    """JAX's output and the gradients of sum(out ** 2); for the fused ring
    the Pallas forward and backward must have been called."""
    calls = {"fwd": 0, "bwd": 0}
    for name, key in (("_flash_fwd", "fwd"), ("_flash_bwd", "bwd")):
        def counting(*a, _orig=getattr(jfa, name), _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(jfa, name, counting)
    if impl == "ulysses":
        def f(q, k, v):
            return julysses(q, k, v, mesh, axis="sp", batch_axes=("dp",))
    else:
        def f(q, k, v):
            return jring(q, k, v, mesh, axis="sp", batch_axes=("dp",),
                         impl=impl)
    args = [jnp.asarray(x) for x in (q, k, v)]
    out = jax.jit(f)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) ** 2),
                             argnums=(0, 1, 2)))(*args)
    if impl == "fused":
        assert calls["fwd"] >= SP and calls["bwd"] >= SP, calls
    monkeypatch.undo()
    return dict(zip(KEYS, [np.asarray(out)] + [np.asarray(g) for g in grads]))


def _folded_run(impl, q, k, v, sp=SP):
    """The port's body in one process, the ring positions folded into the
    batch; the results unfolded to [B, T, H, D]."""
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    body = (tra.ring_flash_attention_local if impl == "fused"
            else tra.ring_causal_attention_local)
    out = tra.unfold_sequence(body(*(tra.fold_sequence(x, sp) for x in leaves),
                                   ring=tra.FoldedRing(sp)), sp)
    (out ** 2).sum().backward()
    return dict(zip(KEYS, [out.detach().numpy()]
                    + [x.grad.numpy() for x in leaves]))


def _check(got, want):
    np.testing.assert_allclose(got["out"], want["out"], rtol=1e-5, atol=1e-6)
    for key in KEYS[1:]:
        atol = 1e-6 * max(1.0, float(np.abs(want[key]).max()))
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   atol=atol, err_msg=key)


@pytest.fixture(scope="module")
def runs(tmp_path_factory, devices8):
    """The 4 gloo ranks (every impl) and, while they run, the JAX side on
    the (dp=2, sp=4) mesh."""
    tmp = tmp_path_factory.mktemp("ring")
    q, k, v = _qkv()
    np.savez(tmp / "qkv.npz", q=q, k=k, v=v)
    job = dict(sp_ops=True, mesh=dict(fsdp=1, sp=SP),
               inputs=str(tmp / "qkv.npz"), out=str(tmp / "sp_ops.npz"))
    started = time.monotonic()
    procs = _spawn(SP, job, tmp)
    mesh = Mesh(np.array(devices8).reshape(2, SP), ("dp", "sp"))
    with pytest.MonkeyPatch.context() as mp:
        out = {"jax": {impl: _jax_run(impl, q, k, v, mesh, mp)
                       for impl in IMPLS}}
    _join(procs, started, tmp, "sp_ops")
    ranks = dict(np.load(job["out"]))
    out["ranks"] = {impl: {key: ranks[f"{impl}/{key}"] for key in KEYS}
                    for impl in IMPLS}
    out["qkv"] = (q, k, v)
    return out


@pytest.mark.parametrize("impl", ["fused", "dense"])
def test_folded_ring_matches_jax(runs, impl):
    _check(_folded_run(impl, *runs["qkv"]), runs["jax"][impl])


@pytest.mark.parametrize("impl", IMPLS)
def test_gloo_ranks_match_jax(runs, impl):
    _check(runs["ranks"][impl], runs["jax"][impl])


@pytest.mark.parametrize("impl", ["fused", "dense"])
def test_folded_ring_equals_the_gloo_ring(runs, impl):
    got = _folded_run(impl, *runs["qkv"])
    for key in KEYS:
        np.testing.assert_allclose(got[key], runs["ranks"][impl][key],
                                   rtol=1e-6, atol=1e-7, err_msg=key)


@pytest.mark.parametrize("sp", [1, 2])
@pytest.mark.parametrize("impl", ["fused", "dense"])
def test_folded_ring_at_other_sizes_matches_jax_causal(runs, sp, impl):
    """A ring of 1 (the causal flash call alone) and of 2 give the same
    attention as the JAX package's ring of 4."""
    _check(_folded_run(impl, *runs["qkv"], sp=sp), runs["jax"]["dense"])


def test_ulysses_heads_must_divide_by_sp():
    """The JAX package's ValueError, before any exchange."""
    q = torch.zeros(1, 4, 6, 8)
    dist.init_process_group("fake", store=_fake_store(), rank=0,
                            world_size=SP)
    try:
        mesh = tmesh.build_mesh(tmesh.MeshConfig(fsdp=1, sp=SP),
                                device="cpu")
        with pytest.raises(ValueError, match="n_heads 6 must divide by sp=4"):
            ulysses_attention(q, q, q, mesh)
    finally:
        dist.destroy_process_group()


def _fake_store():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    return FakeStore()
