"""ray_tpu_torch.models.gpt2 against ray_tpu.models.gpt2 on the CPU.

One parameter tree from the JAX ``gpt2_init``, passed through numpy, and
one numpy token batch go through both packages' ``gpt2_loss`` and its
gradient. With ``fused_norm=True`` or ``use_flash=True`` the JAX side runs
its Pallas kernels in interpret mode (asserted for the norm kernels) and the
port its autograd Functions over the kernels' plain versions.

Tolerances: fp32 loss rtol 1e-5 and per-leaf gradients rtol 1e-4,
atol 1e-6 -- the same fp32 arithmetic, summed in another order. The bf16
case rounds at other points in the two frameworks, so it is held to the
JAX package's own bf16 criteria (tests/test_fused_norm.py): loss rtol 1e-2
and whole-tree gradient cosine > 0.999.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.ops import fused_norm as jfn
from ray_tpu_torch._tree import tree_leaves
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import fused_norm as tfn
from ray_tpu_torch.train.train_step import value_and_grad

TINY = dict(vocab_size=256, n_layer=2, n_head=4, d_model=128, seq_len=64)


def _configs(dtype: str, **flags):
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jlog = flags.pop("logits_bf16", False)
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jdt, scan_layers=False,
                            logits_dtype=jnp.bfloat16 if jlog else None,
                            **flags)
    tcfg = tgpt2.GPT2Config(**TINY, dtype=tdt, scan_layers=False,
                            logits_dtype=torch.bfloat16 if jlog else None,
                            **flags)
    return jcfg, tcfg


def _inputs(jcfg, seed=0):
    params = jax.tree.map(np.asarray, jgpt2.gpt2_init(jax.random.key(seed),
                                                      jcfg))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (2, jcfg.seq_len + 1), dtype=np.int32)
    return params, tokens


def _jax_value_and_grad(jcfg, params, tokens):
    before = jfn.KERNEL_INVOCATIONS["ln_bwd"]
    loss, grads = jax.jit(jax.value_and_grad(jgpt2.gpt2_loss),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)},
        jcfg)
    if jcfg.fused_norm:
        assert jfn.KERNEL_INVOCATIONS["ln_bwd"] > before, "JAX kernels not taken"
    return float(loss), jax.tree.map(np.asarray, grads)


def _port_value_and_grad(tcfg, params, tokens):
    loss, grads = value_and_grad(
        lambda p, b: tgpt2.gpt2_loss(p, b, tcfg),
        params_from_numpy(params, "cpu"), {"tokens": torch.from_numpy(tokens)})
    return float(loss), params_to_numpy(grads)


def _cosine(a, b):
    fa = np.concatenate([x.ravel().astype(np.float64) for x in tree_leaves(a)])
    fb = np.concatenate([x.ravel().astype(np.float64) for x in tree_leaves(b)])
    return float(fa @ fb / (np.linalg.norm(fa) * np.linalg.norm(fb)))


@pytest.mark.parametrize("use_flash", [False, True])
@pytest.mark.parametrize("ce_vocab_chunks", [1, 4])
@pytest.mark.parametrize("remat", [False, "dots"])
@pytest.mark.parametrize("fused_norm", [False, True])
def test_loss_and_grads_match_jax_fp32(fused_norm, remat, ce_vocab_chunks,
                                       use_flash):
    jcfg, tcfg = _configs("fp32", fused_norm=fused_norm, remat=remat,
                          ce_vocab_chunks=ce_vocab_chunks,
                          use_flash=use_flash)
    params, tokens = _inputs(jcfg)
    jloss, jgrads = _jax_value_and_grad(jcfg, params, tokens)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    for path, want in flat_j:
        got = tgrads
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("use_flash", [False, True])
def test_loss_and_grads_track_jax_bf16(use_flash):
    """The bench's fused config at bf16: kernels, dots remat, bf16 logits,
    chunked CE, with dense or flash attention."""
    jcfg, tcfg = _configs("bf16", fused_norm=True, remat="dots",
                          ce_vocab_chunks=4, logits_bf16=True,
                          use_flash=use_flash)
    params, tokens = _inputs(jcfg, seed=1)
    jloss, jgrads = _jax_value_and_grad(jcfg, params, tokens)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    assert _cosine(tgrads, jgrads) > 0.999


def test_forward_logits_match_jax():
    jcfg, tcfg = _configs("fp32", fused_norm=True)
    params, tokens = _inputs(jcfg, seed=2)
    want = jgpt2.gpt2_forward(jax.tree.map(jnp.asarray, params),
                              jnp.asarray(tokens[:, :-1]), jcfg)
    got = tgpt2.gpt2_forward(params_from_numpy(params, "cpu"),
                             torch.from_numpy(tokens[:, :-1]), tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_param_tree_and_counts_match_jax():
    """Same keys and shapes from both inits; the config's arithmetic
    (parameter count, FLOPs per token) is the JAX package's."""
    jcfg, tcfg = _configs("fp32")
    jtree = jax.tree.map(lambda a: a.shape, jgpt2.gpt2_init(jax.random.key(0),
                                                            jcfg))
    gen = torch.Generator().manual_seed(0)
    ttree = tgpt2.gpt2_init(gen, tcfg, device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jtree,
                                                  is_leaf=lambda x: isinstance(x, tuple))[0]
    assert len(flat_j) == len(tree_leaves(ttree))
    for path, shape in flat_j:
        leaf = ttree
        for key in path:
            leaf = leaf[key.key]
        assert tuple(leaf.shape) == shape and leaf.dtype == torch.float32
    total = sum(leaf.numel() for leaf in tree_leaves(ttree))
    assert total == tcfg.n_params == jcfg.n_params
    small = tgpt2.GPT2Config.small()
    assert tgpt2.gpt2_flops_per_token(small) == jgpt2.gpt2_flops_per_token(
        jgpt2.GPT2Config.small())
    # Residual projections are drawn at 0.02 / sqrt(2L).
    std = float(ttree["blocks"]["attn_out_w"].std())
    assert abs(std - 0.02 / np.sqrt(2 * tcfg.n_layer)) < 1e-3


def test_remat_dots_recomputes_the_kernels(monkeypatch):
    """Under remat="dots" the backward reruns each block's forward norm,
    GELU and flash ops, as the JAX checkpoint policy does (it saves no
    ``pallas_call``): the forward wrappers run twice per block, the backward
    ones once, the final norm once each. Counted at the wrappers (the kernel
    counters only move on a GPU)."""
    jcfg, tcfg = _configs("fp32", fused_norm=True, remat="dots",
                          use_flash=True)
    params, tokens = _inputs(jcfg)
    calls = {}
    for module, names in ((tfn, ("ln_fwd", "ln_bwd", "gelu_fwd", "gelu_bwd")),
                          (tfa, ("flash_fwd", "flash_dkv", "flash_dq"))):
        for name in names:
            calls[name] = 0

            def counting(*a, _name=name, _orig=getattr(module, name), **kw):
                calls[_name] += 1
                return _orig(*a, **kw)

            monkeypatch.setattr(module, name, counting)
    _port_value_and_grad(tcfg, params, tokens)
    layers = tcfg.n_layer
    assert calls == {"ln_fwd": 2 * (2 * layers) + 1, "ln_bwd": 2 * layers + 1,
                     "gelu_fwd": 2 * layers, "gelu_bwd": layers,
                     "flash_fwd": 2 * layers, "flash_dkv": layers,
                     "flash_dq": layers}


def test_unported_paths_raise():
    _, tcfg = _configs("fp32", attention_impl="ring")
    params, tokens = _inputs(_configs("fp32")[0])
    with pytest.raises(NotImplementedError):
        tgpt2.gpt2_loss(params_from_numpy(params, "cpu"),
                        {"tokens": torch.from_numpy(tokens)}, tcfg)
    with pytest.raises(ValueError, match="ce_vocab_chunks"):
        tgpt2.gpt2_loss(params_from_numpy(params, "cpu"),
                        {"tokens": torch.from_numpy(tokens)},
                        dataclasses.replace(_configs("fp32")[1],
                                            ce_vocab_chunks=3))
