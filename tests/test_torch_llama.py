"""ray_tpu_torch.models.llama against ray_tpu.models.llama on the CPU.

One parameter tree from the JAX ``llama_init``, passed through numpy, and
one numpy token batch go through both packages' ``llama_loss`` and its
gradient. With ``fused_norm=True`` the JAX side runs its Pallas RMSNorm
kernels in interpret mode (asserted through its KERNEL_INVOCATIONS) and the
port its autograd Functions over the kernels' plain versions; with
``use_flash=True`` the same holds for the flash kernels. The width is one
the JAX side fuses (d_model 256: D % 128 == 0; ``LlamaConfig.tiny()``'s 64
would take its plain chain), with GQA (4 query heads over 2 KV heads).

Tolerances: fp32 loss and logits rtol 1e-5 and per-leaf gradients rtol
1e-4, atol 1e-6 -- the same fp32 arithmetic, summed in another order. The
bf16 case rounds at other points in the two frameworks, so it is held to
the JAX package's own bf16 criteria (tests/test_fused_norm.py): loss rtol
1e-2 and whole-tree gradient cosine > 0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu.ops import fused_norm as jfn
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import optim as joptim
from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
from ray_tpu.train.train_step import make_train_step as jmake_train_step
from ray_tpu_torch._tree import tree_leaves
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import fused_norm as tfn
from ray_tpu_torch.train.train_step import (make_init_fn, make_train_step,
                                            value_and_grad)

SMALL = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=256,
             seq_len=64)


def _configs(dtype: str = "fp32", **flags):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = jllama.LlamaConfig(**SMALL, dtype=jdt, scan_layers=False, **flags)
    tcfg = tllama.LlamaConfig(**SMALL, dtype=tdt, scan_layers=False, **flags)
    return jcfg, tcfg


def _inputs(jcfg, seed=0, batch=2):
    params = jax.tree.map(np.asarray, jllama.llama_init(jax.random.key(seed),
                                                        jcfg))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (batch, jcfg.seq_len + 1), dtype=np.int32)
    return params, tokens


def _jax_value_and_grad(jcfg, params, tokens):
    before = dict(jfn.KERNEL_INVOCATIONS)
    loss, grads = jax.jit(jax.value_and_grad(jllama.llama_loss),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)},
        jcfg)
    if jcfg.fused_norm:
        for name in ("rms_fwd", "rms_bwd"):
            assert jfn.KERNEL_INVOCATIONS[name] > before.get(name, 0), \
                f"JAX {name} kernel not taken"
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(tcfg, params, tokens):
    loss, grads = value_and_grad(
        lambda p, b: tllama.llama_loss(p, b, tcfg),
        params_from_numpy(params, "cpu"), {"tokens": torch.from_numpy(tokens)})
    return float(loss), params_to_numpy(grads)


def _cosine(a, b):
    fa = np.concatenate([x.ravel().astype(np.float64) for x in tree_leaves(a)])
    fb = np.concatenate([x.ravel().astype(np.float64) for x in tree_leaves(b)])
    return float(fa @ fb / (np.linalg.norm(fa) * np.linalg.norm(fb)))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("fused_norm", [False, True])
def test_loss_and_grads_match_jax_fp32(fused_norm, use_flash):
    """llama_loss and every per-leaf gradient, from the same JAX-made
    tree: the tree loads through params_from_numpy as it is (untied
    ``lm_head`` [d, V], stacked block leaves)."""
    jcfg, tcfg = _configs(fused_norm=fused_norm, use_flash=use_flash)
    params, tokens = _inputs(jcfg)
    jloss, jgrads = _jax_value_and_grad(jcfg, params, tokens)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_j) == len(tree_leaves(tgrads))
    for path, want in flat_j:
        got = tgrads
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_and_grads_track_jax_bf16(use_flash):
    """The measured config at bf16: RMSNorm kernels and dots remat, with
    dense or flash attention."""
    jcfg, tcfg = _configs("bf16", fused_norm=True, remat="dots",
                          use_flash=use_flash)
    params, tokens = _inputs(jcfg, seed=1)
    jloss, jgrads = _jax_value_and_grad(jcfg, params, tokens)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    assert _cosine(tgrads, jgrads) > 0.999


def test_forward_logits_match_jax():
    jcfg, tcfg = _configs(fused_norm=True)
    params, tokens = _inputs(jcfg, seed=2)
    want = jllama.llama_forward(jax.tree.map(jnp.asarray, params),
                                jnp.asarray(tokens[:, :-1]), jcfg)
    got = tllama.llama_forward(params_from_numpy(params, "cpu"),
                               torch.from_numpy(tokens[:, :-1]), tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_rope_matches_jax(dtype):
    """Halves of the head dim rotated by fp32 angles at positions 0..T-1,
    cast back to the input dtype."""
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(3).standard_normal((2, 40, 3, 64),
                                                 dtype=np.float32)
    want = np.asarray(jllama._rope(jnp.asarray(x, jdt), 10000.0), np.float32)
    got = tllama._rope(torch.from_numpy(x).to(tdt), 10000.0)
    assert got.dtype == tdt and got.shape == x.shape
    tol = 1e-5 if dtype == "fp32" else 1e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


def test_gqa_repeats_each_kv_head_over_its_query_group(monkeypatch):
    """One block with 4 query heads over 2 KV heads against the JAX block.
    ``jnp.repeat`` is ``repeat_interleave`` (KV head j serves query heads
    2j and 2j+1); tiling the heads instead (``Tensor.repeat``) gives
    another block output, which this test must tell apart."""
    jcfg, tcfg = _configs()
    params, _ = _inputs(jcfg, seed=4)
    layer = jax.tree.map(lambda a: a[0], params["blocks"])
    x = np.random.default_rng(4).standard_normal((2, 16, 256),
                                                 dtype=np.float32)
    want = np.asarray(jllama._block(jnp.asarray(x), jax.tree.map(
        jnp.asarray, layer), jcfg))
    tlayer = params_from_numpy(layer, "cpu")

    def port():
        return tllama._block(torch.from_numpy(x), tlayer, tcfg).numpy()

    np.testing.assert_allclose(port(), want, rtol=1e-5, atol=1e-5)

    def tiled(self, repeats, dim):
        reps = [1] * self.dim()
        reps[dim] = repeats
        return self.repeat(*reps)

    monkeypatch.setattr(torch.Tensor, "repeat_interleave", tiled)
    assert not np.allclose(port(), want, rtol=1e-3, atol=1e-3)


def test_param_tree_and_counts_match_jax():
    """Same keys and shapes from both inits (lm_head untied, [d, V]); the
    config's arithmetic (head_dim, d_ff, parameter count, FLOPs per token)
    is the JAX package's, for the test width and for small()."""
    jcfg, tcfg = _configs()
    jtree = jax.tree.map(lambda a: a.shape, jllama.llama_init(
        jax.random.key(0), jcfg))
    ttree = tllama.llama_init(torch.Generator().manual_seed(0), tcfg,
                              device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(
        jtree, is_leaf=lambda x: isinstance(x, tuple))[0]
    assert len(flat_j) == len(tree_leaves(ttree))
    for path, shape in flat_j:
        leaf = ttree
        for key in path:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.float32
    total = sum(leaf.numel() for leaf in tree_leaves(ttree))
    assert total == tcfg.n_params == jcfg.n_params
    assert tuple(ttree["lm_head"].shape) == (256, 256)
    for tc, jc in ((tllama.LlamaConfig.small(), jllama.LlamaConfig.small()),
                   (tllama.LlamaConfig.tiny(), jllama.LlamaConfig.tiny())):
        assert (tc.head_dim, tc.d_ff, tc.n_params) == (jc.head_dim, jc.d_ff,
                                                       jc.n_params)
        assert tllama.llama_flops_per_token(tc) == \
            jllama.llama_flops_per_token(jc)
    assert tllama.LlamaConfig.small().d_ff == 2816
    # Residual projections are drawn at 0.02 / sqrt(2L), norms at 1.
    std = float(ttree["blocks"]["wo"].std())
    assert abs(std - 0.02 / np.sqrt(2 * tcfg.n_layer)) < 1e-3
    assert bool((ttree["blocks"]["attn_norm"] == 1).all())


def test_remat_dots_recomputes_the_kernels(monkeypatch):
    """Under remat="dots" the backward reruns each block's forward RMSNorm
    and flash ops, as the JAX checkpoint policy does: the forward wrappers
    run twice per block, the backward ones once, the final norm once each.
    Counted at the wrappers (the kernel counters only move on a GPU); no
    LayerNorm or GELU wrapper runs."""
    jcfg, tcfg = _configs(fused_norm=True, remat="dots", use_flash=True)
    params, tokens = _inputs(jcfg)
    calls = {}
    for module, names in ((tfn, ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd",
                                 "rms_fwd", "rms_bwd")),
                          (tfa, ("flash_fwd", "flash_dkv", "flash_dq"))):
        for name in names:
            calls[name] = 0

            def counting(*a, _name=name, _orig=getattr(module, name), **kw):
                calls[_name] += 1
                return _orig(*a, **kw)

            monkeypatch.setattr(module, name, counting)
    _port_value_and_grad(tcfg, params, tokens)
    layers = tcfg.n_layer
    assert calls == {"ln_fwd": 0, "ln_bwd": 0, "gelu_fwd": 0, "gelu_bwd": 0,
                     "rms_fwd": 2 * (2 * layers) + 1,
                     "rms_bwd": 2 * layers + 1, "flash_fwd": 2 * layers,
                     "flash_dkv": layers, "flash_dq": layers}


def test_three_train_steps_match_jax():
    """make_init_fn + make_train_step on the small Llama with the RMSNorm
    ops, flash and dots remat, from the same initial weights and batch;
    held as tests/test_torch_train_step.py holds GPT-2's (Adam's first
    steps are close to lr * sign(g), so a coordinate whose gradient is ~0
    may move by up to lr either way on rounding noise)."""
    flags = dict(remat="dots", fused_norm=True, use_flash=True)
    jcfg, tcfg = _configs(**flags)
    tokens = np.random.default_rng(5).integers(0, 256, (8, 65),
                                               dtype=np.int32)
    lr = joptim.AdamWConfig().lr
    n_steps = 3

    mesh = build_mesh(MeshConfig())
    shardings = jllama.llama_shardings(jcfg, mesh)
    jstate = jmake_init_fn(lambda r: jllama.llama_init(r, jcfg), shardings,
                           mesh)(jax.random.key(0))
    init_params = jax.tree.map(np.asarray, jstate["params"])
    jstep = jmake_train_step(lambda p, b: jllama.llama_loss(p, b, jcfg),
                             shardings, mesh)
    jlosses = []
    for _ in range(n_steps):
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        jlosses.append(float(m["loss"]))
    jlr = float(m["lr"])

    tstate = make_init_fn(lambda g: params_from_numpy(init_params, "cpu"))(
        torch.Generator())
    tstep = make_train_step(lambda p, b: tllama.llama_loss(p, b, tcfg))
    tlosses = []
    for _ in range(n_steps):
        tstate, m = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        tlosses.append(float(m["loss"]))
        assert m["lr"] == jlr and np.isfinite(float(m["grad_norm"]))

    assert tstate["step"] == int(jstate["step"]) == n_steps
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]

    got = np.concatenate([a.ravel() for a in
                          tree_leaves(params_to_numpy(tstate["params"]))])
    want = np.concatenate([np.asarray(a).ravel() for a in
                           tree_leaves(jax.tree.map(np.asarray,
                                                    jstate["params"]))])
    assert np.abs(got - want).max() <= 2 * lr * n_steps
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert off.mean() < 1e-3, f"{off.sum()} of {off.size} coordinates off"


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_unported_attention_impls_raise(impl):
    jcfg, tcfg = _configs()
    params, tokens = _inputs(jcfg)
    with pytest.raises(NotImplementedError, match=impl):
        tllama.llama_loss(params_from_numpy(params, "cpu"),
                          {"tokens": torch.from_numpy(tokens)},
                          dataclasses.replace(tcfg, attention_impl=impl))
