"""ray_tpu_torch.ops.moe and ray_tpu_torch.models.moe against
ray_tpu.ops.moe and ray_tpu.models.moe on the CPU, from the same numpy
inputs (JAX-made weights carried over through ``params_from_numpy``).

Tolerances: ``_route``'s dispatch equal, its combine (gates from an fp32
softmax, summed in another order) to rtol 1e-6 and aux to 1e-5;
``moe_ffn`` at fp32 to rtol 1e-5 forward and 1e-4 on gradients; the tiny
model at fp32: logits and aux to rtol 1e-4, every per-leaf gradient to
rtol 1e-4 / atol 1e-6, with every token routed to the same experts and
buffer slots as in JAX; at bf16, the loss to rtol 1e-2 and the whole-tree
gradient cosine above 0.999 (the JAX package's bf16 criteria), with the
count of tokens routed differently printed; three AdamW steps as
``tests/test_torch_llama.py`` holds Llama's.
"""

import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu.ops import moe as jops
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import optim as joptim
from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
from ray_tpu.train.train_step import make_train_step as jmake_train_step
from ray_tpu_torch._tree import tree_leaves
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.ops import flash_attention as tfa
from ray_tpu_torch.ops import fused_norm as tfn
from ray_tpu_torch.ops import moe as tops
from ray_tpu_torch.train.train_step import (make_init_fn, make_train_step,
                                            value_and_grad)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# MoEConfig.tiny()'s settings; WIDE puts them at d_model 256 (head_dim
# 64, which the flash kernels take), for the flash path.
TINY = dict(vocab_size=256, n_layer=2, n_head=4, n_kv_head=2, d_model=64,
            seq_len=64, n_experts=4, top_k=2)
WIDE = dict(d_model=256)


def _configs(dtype="fp32", **flags):
    jdt, tdt = DTYPES[dtype]
    kw = dict(TINY, scan_layers=False, **flags)
    return (jmoe.MoEConfig(**kw, dtype=jdt),
            tmoe.MoEConfig(**kw, dtype=tdt))


def _inputs(jcfg, seed=0, batch=2):
    params = jax.tree.map(np.array, jmoe.moe_init(jax.random.key(seed),
                                                  jcfg))
    tokens = np.random.default_rng(seed).integers(
        0, jcfg.vocab_size, (batch, jcfg.seq_len + 1), dtype=np.int32)
    return params, tokens


def _cosine(a, b):
    fa = np.concatenate([x.ravel().astype(np.float64) for x in tree_leaves(a)])
    fb = np.concatenate([x.ravel().astype(np.float64) for x in tree_leaves(b)])
    return float(fa @ fb / (np.linalg.norm(fa) * np.linalg.norm(fb)))


def _jax_value_and_grad(jcfg, params, tokens):
    loss, grads = jax.jit(jax.value_and_grad(jmoe.moe_loss),
                          static_argnums=2)(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)},
        jcfg)
    return float(loss), jax.tree.map(lambda a: np.asarray(a, np.float32),
                                     grads)


def _port_value_and_grad(tcfg, params, tokens):
    loss, grads = value_and_grad(
        lambda p, b: tmoe.moe_loss(p, b, tcfg),
        params_from_numpy(params, "cpu"), {"tokens": torch.from_numpy(tokens)})
    return float(loss), params_to_numpy(grads)


def _assert_grads_close(tgrads, jgrads, rtol=1e-4, atol=1e-6):
    flat_j = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(flat_j) == len(tree_leaves(tgrads))
    for path, want in flat_j:
        got = tgrads
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# -- _route and moe_ffn --------------------------------------------------------


def _layer_inputs(seed, t=64, d=32, e=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((t, d), dtype=np.float32)
    router = (rng.standard_normal((d, e), dtype=np.float32)
              * np.float32(0.5))
    return x, router


@pytest.mark.parametrize("capacity_factor", [0.5, 1.25])
@pytest.mark.parametrize("top_k", [1, 2])
def test_route_matches_jax(top_k, capacity_factor):
    """Same experts, same buffer slots, same drops: at capacity_factor 0.5
    some tokens overflow (a zero row, as jax.nn.one_hot gives past the
    capacity)."""
    x, router = _layer_inputs(top_k)
    t, e = x.shape[0], router.shape[1]
    capacity = max(1, int(capacity_factor * t / e))
    jd, jc, jaux = jops._route(jnp.asarray(x), jnp.asarray(router), e, top_k,
                               capacity)
    td, tc, taux = tops._route(torch.from_numpy(x), torch.from_numpy(router),
                               e, top_k, capacity)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    routed = td.numpy().sum()
    if capacity_factor < 1:
        assert routed < t * top_k, "no token dropped"
    else:
        assert routed > 0


def test_route_breaks_ties_to_the_lower_index():
    """A zero router gives every expert the same probability: top-k takes
    the lowest indices, as jax.lax.top_k does."""
    x, router = _layer_inputs(7)
    router[:] = 0
    e = router.shape[1]
    jd, jc, _ = jops._route(jnp.asarray(x), jnp.asarray(router), e, 2, 64)
    td, tc, _ = tops._route(torch.from_numpy(x), torch.from_numpy(router), e,
                            2, 64)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)
    assert td.numpy()[:, :2].sum() == 2 * x.shape[0]


@pytest.mark.parametrize("activation", ["gelu", "silu"])
def test_moe_ffn_matches_jax(activation):
    """The dense-path FFN at fp32 with its default (tanh-form GELU) and the
    model's SiLU: output and aux, and the gradients of sum(out * dy) + aux
    for x and every parameter."""
    jact, tact = {"gelu": (jax.nn.gelu, tops.gelu_tanh),
                  "silu": (jax.nn.silu, torch.nn.functional.silu)}[activation]
    params = jax.tree.map(np.array, jops.init_moe_params(
        jax.random.key(1), 32, 64, 4))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 24, 32), dtype=np.float32)
    dy = rng.standard_normal(x.shape, dtype=np.float32)
    kw = dict(top_k=2, capacity_factor=1.25)

    def jloss(p, xx):
        y, aux = jops.moe_ffn(p, xx, activation=jact, **kw)
        return jnp.sum(y * dy) + aux, (y, aux)

    (_, (jy, jaux)), jg = jax.value_and_grad(jloss, argnums=(0, 1),
                                             has_aux=True)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in params.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty, taux = tops.moe_ffn(tp, tx, activation=tact, **kw)
    (ty * torch.from_numpy(dy)).sum().add(taux).backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jg[1]), rtol=1e-4,
                               atol=1e-6)
    for k, v in tp.items():
        np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg[0][k]),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


# -- the model -----------------------------------------------------------------


def _routes(monkeypatch, module, run):
    """Every ``_route`` dispatch of ``run()`` (one a layer), as numpy."""
    seen = []
    orig = module._route

    def recording(*a, **kw):
        out = orig(*a, **kw)
        d = out[0]
        seen.append(d.numpy() if isinstance(d, torch.Tensor) else
                    np.asarray(d))
        return out

    monkeypatch.setattr(module, "_route", recording)
    run()
    monkeypatch.setattr(module, "_route", orig)
    return seen


def _routed_differently(monkeypatch, jcfg, tcfg, params, tokens):
    """Tokens (over all layers) whose experts or buffer slots differ
    between the two packages' forwards (eager, without remat, so every
    layer's dispatch is a concrete array)."""
    jcfg = dataclasses.replace(jcfg, remat=False)
    tcfg = dataclasses.replace(tcfg, remat=False)
    jr = _routes(monkeypatch, jops, lambda: jmoe.moe_forward(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens[:, :-1]), jcfg))
    tr = _routes(monkeypatch, tops, lambda: tmoe.moe_forward(
        params_from_numpy(params, "cpu"), torch.from_numpy(tokens[:, :-1]),
        tcfg))
    assert len(jr) == len(tr) == jcfg.n_layer
    return sum(int((a != b).any(axis=(1, 2)).sum()) for a, b in zip(jr, tr))


def test_forward_matches_jax_and_routes_every_token_alike(monkeypatch):
    jcfg, tcfg = _configs()
    params, tokens = _inputs(jcfg, seed=2)
    want, jaux = jax.jit(jmoe.moe_forward, static_argnums=2)(
        jax.tree.map(jnp.asarray, params), jnp.asarray(tokens[:, :-1]), jcfg)
    got, taux = tmoe.moe_forward(params_from_numpy(params, "cpu"),
                                 torch.from_numpy(tokens[:, :-1]), tcfg)
    assert got.shape == want.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-4)
    assert _routed_differently(monkeypatch, jcfg, tcfg, params, tokens) == 0


@pytest.mark.parametrize("remat", ["dots", False])
def test_loss_and_grads_match_jax_fp32(remat):
    jcfg, tcfg = _configs(remat=remat)
    params, tokens = _inputs(jcfg)
    jloss, jgrads = _jax_value_and_grad(jcfg, params, tokens)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_grads_close(tgrads, jgrads)
    # Every expert of every layer got a gradient.
    per_expert = np.abs(tgrads["blocks"]["moe"]["w_in"]).sum(axis=(2, 3))
    assert (per_expert > 0).all(), per_expert


def test_loss_and_grads_track_jax_bf16(monkeypatch):
    """bf16 against the JAX function evaluated op by op. Under ``jax.jit``
    XLA's CPU compiler computes this bf16 gradient less exactly: at this
    seed its cosine to JAX's own fp32 gradient is 0.9964, where JAX op by
    op and the port are both at 0.99999 (and the routing is the same in
    all three), so the jitted value is not the function's."""
    jcfg, tcfg = _configs("bf16")
    params, tokens = _inputs(jcfg, seed=1)
    jloss, jgrads = jax.value_and_grad(jmoe.moe_loss)(
        jax.tree.map(jnp.asarray, params), {"tokens": jnp.asarray(tokens)},
        jcfg)
    jloss = float(jloss)
    jgrads = jax.tree.map(lambda a: np.asarray(a, np.float32), jgrads)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    n = _routed_differently(monkeypatch, jcfg, tcfg, params, tokens)
    cos = _cosine(tgrads, jgrads)
    print(f"bf16: {n} of {tokens[:, :-1].size * jcfg.n_layer} token-layers "
          f"routed differently; loss {tloss} vs {jloss}; gradient cosine "
          f"{cos}")
    np.testing.assert_allclose(tloss, jloss, rtol=1e-2)
    assert cos > 0.999


def test_flash_path_matches_jax_and_dense():
    """At head_dim 64 with use_flash: the port's flash path (the kernels'
    plain versions on the CPU) against JAX's (Pallas in interpret mode) and
    against the port's dense path, fp32."""
    jcfg, tcfg = _configs(use_flash=True, **WIDE)
    params, tokens = _inputs(jcfg, seed=3)
    jloss, jgrads = _jax_value_and_grad(jcfg, params, tokens)
    tloss, tgrads = _port_value_and_grad(tcfg, params, tokens)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    _assert_grads_close(tgrads, jgrads)
    dloss, dgrads = _port_value_and_grad(
        dataclasses.replace(tcfg, use_flash=False), params, tokens)
    np.testing.assert_allclose(tloss, dloss, rtol=1e-5)
    _assert_grads_close(tgrads, dgrads)


def test_remat_dots_runs_only_the_flash_ops(monkeypatch):
    """Under remat="dots" with use_flash the block runs the flash forward
    twice (forward and recompute) and each backward op once, and no norm
    or GELU op: the plain RMSNorm chain, as in the JAX module, whatever
    fused_norm says. Counted at the wrappers (the kernel counters move
    only on a GPU)."""
    jcfg, tcfg = _configs(use_flash=True, fused_norm=True, remat="dots",
                          **WIDE)
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
                     "rms_fwd": 0, "rms_bwd": 0, "flash_fwd": 2 * layers,
                     "flash_dkv": layers, "flash_dq": layers}


def _op_counts(tcfg, params, tokens):
    """How many times each aten op ran in the port's value_and_grad."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Counting(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.counts = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.counts[func] += 1
            return func(*args, **(kwargs or {}))

    with Counting() as mode:
        _port_value_and_grad(tcfg, params, tokens)
    return mode.counts


def test_dots_remat_saves_the_dispatch_and_combine_products():
    """As JAX's dots_with_no_batch_dims_saveable saves the dispatch and
    combine dots (no batch dims) and recomputes the batched expert
    products: under remat="dots" every aten.mm runs once, as without
    remat, and the backward reruns only the batched products (the two
    expert products and dense attention's two, per layer)."""
    jcfg, tcfg = _configs(remat="dots")
    params, tokens = _inputs(jcfg)
    dots = _op_counts(tcfg, params, tokens)
    plain = _op_counts(dataclasses.replace(tcfg, remat=False), params, tokens)
    mm, bmm = torch.ops.aten.mm.default, torch.ops.aten.bmm.default
    assert dots[mm] == plain[mm] > 0
    assert dots[bmm] - plain[bmm] == 4 * tcfg.n_layer


def test_param_tree_and_counts_match_jax():
    """Same keys and shapes from both inits; the configs' arithmetic
    (d_ff, parameter and active-parameter counts) is the JAX package's,
    for tiny() and the inherited small(); the logical axes are JAX's."""
    jcfg, tcfg = _configs()
    jtree = jax.tree.map(lambda a: a.shape, jmoe.moe_init(jax.random.key(0),
                                                          jcfg))
    ttree = tmoe.moe_init(torch.Generator().manual_seed(0), tcfg,
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
    for tc, jc in ((tmoe.MoEConfig.small(), jmoe.MoEConfig.small()),
                   (tmoe.MoEConfig.tiny(), jmoe.MoEConfig.tiny())):
        assert (tc.d_ff, tc.n_params, tc.n_active_params, tc.n_experts,
                tc.top_k, tc.capacity_factor, tc.aux_loss_coef) == (
            jc.d_ff, jc.n_params, jc.n_active_params, jc.n_experts, jc.top_k,
            jc.capacity_factor, jc.aux_loss_coef)
    assert tmoe.MoEConfig.tiny() == tmoe.MoEConfig(**TINY)
    small = tmoe.MoEConfig.small()
    assert (small.d_model, small.n_layer, small.seq_len) == (1024, 16, 2048)
    assert round(small.n_params / 1e6) == 846
    assert round(small.n_active_params / 1e6) == 292
    assert tmoe.moe_param_axes_tree(tcfg) == jmoe.moe_param_axes_tree(jcfg)
    # The mesh field is not part of a config's identity.
    assert dataclasses.replace(tcfg, mesh=object()) == tcfg


def test_three_train_steps_match_jax():
    """make_init_fn + make_train_step on the tiny MoE (fp32, dots remat)
    from the same initial weights and batch, held as Llama's are."""
    jcfg, tcfg = _configs(remat="dots")
    tokens = np.random.default_rng(5).integers(0, 256, (8, 65),
                                               dtype=np.int32)
    lr = joptim.AdamWConfig().lr
    n_steps = 3

    mesh = build_mesh(MeshConfig())
    shardings = jmoe.moe_shardings(jcfg, mesh)
    jstate = jmake_init_fn(lambda r: jmoe.moe_init(r, jcfg), shardings,
                           mesh)(jax.random.key(0))
    init_params = jax.tree.map(np.array, jstate["params"])
    jstep = jmake_train_step(lambda p, b: jmoe.moe_loss(p, b, jcfg),
                             shardings, mesh)
    jlosses, jnorms = [], []
    for _ in range(n_steps):
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        jlosses.append(float(m["loss"]))
        jnorms.append(float(m["grad_norm"]))
    jlr = float(m["lr"])

    tstate = make_init_fn(lambda g: params_from_numpy(init_params, "cpu"))(
        torch.Generator())
    tstep = make_train_step(lambda p, b: tmoe.moe_loss(p, b, tcfg))
    tlosses, tnorms = [], []
    for _ in range(n_steps):
        tstate, m = tstep(tstate, {"tokens": torch.from_numpy(tokens)})
        tlosses.append(float(m["loss"]))
        tnorms.append(float(m["grad_norm"]))
        assert m["lr"] == jlr

    assert tstate["step"] == int(jstate["step"]) == n_steps
    np.testing.assert_allclose(tlosses[0], jlosses[0], rtol=1e-5)
    np.testing.assert_allclose(tlosses, jlosses, rtol=1e-4)
    np.testing.assert_allclose(tnorms, jnorms, rtol=1e-4)
    assert tlosses[-1] < tlosses[0]

    got = np.concatenate([a.ravel() for a in
                          tree_leaves(params_to_numpy(tstate["params"]))])
    want = np.concatenate([np.asarray(a).ravel() for a in
                           tree_leaves(jax.tree.map(np.asarray,
                                                    jstate["params"]))])
    assert np.abs(got - want).max() <= 2 * lr * n_steps
    off = ~np.isclose(got, want, rtol=1e-4, atol=1e-6)
    assert off.mean() < 1e-3, f"{off.sum()} of {off.size} coordinates off"
