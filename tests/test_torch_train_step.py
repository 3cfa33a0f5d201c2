"""ray_tpu_torch.train (AdamW and the train step) against ray_tpu.train on
the CPU, from the same numpy inputs.

``adamw_update``: params, moments, lr and gnorm to rtol 1e-5 -- both sides
do the same fp32 elementwise arithmetic on the same inputs; only the
global-norm sum may round differently, by an ulp or so.

The 3-step GPT-2 run: the first loss to rtol 1e-5 (same weights, same
batch). Later losses and the final parameters differ more, because
Adam's first steps are close to lr * sign(g): a coordinate whose gradient
is ~0 takes a step of up to lr either way depending on rounding noise in
g. So the final parameters agree to rtol 1e-4 on all but a tiny share of
coordinates, and every coordinate within 2 * lr per step taken.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel.mesh import MeshConfig, build_mesh
from ray_tpu.train import optim as joptim
from ray_tpu.train.train_step import make_init_fn as jmake_init_fn
from ray_tpu.train.train_step import make_train_step as jmake_train_step
from ray_tpu_torch._tree import tree_leaves
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import params_from_numpy, params_to_numpy
from ray_tpu_torch.train import optim as toptim
from ray_tpu_torch.train.train_step import make_init_fn, make_train_step


def _tree(rng, scale=1.0):
    return {"a": rng.standard_normal((4, 8), dtype=np.float32) * scale,
            "b": {"c": rng.standard_normal(16, dtype=np.float32) * scale,
                  "d": rng.standard_normal((2, 3), dtype=np.float32) * scale}}


@pytest.mark.parametrize("case", ["no_clip", "clip", "warmup"])
def test_adamw_update_matches_jax(case):
    rng = np.random.default_rng({"no_clip": 0, "clip": 1, "warmup": 2}[case])
    cfg = dict(grad_clip=1e3)
    if case == "clip":
        cfg = dict(grad_clip=0.5)  # gnorm of these grads is ~25
    if case == "warmup":
        cfg = dict(warmup_steps=10)
    params, grads = _tree(rng), _tree(rng, 3.0)
    opt = {"mu": _tree(rng, 0.1), "nu": jax.tree.map(np.abs, _tree(rng, 0.1))}
    step = 3

    jp, jopt, jlr, jgn = joptim.adamw_update(
        joptim.AdamWConfig(**cfg), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, opt), jnp.asarray(step, jnp.int32))
    tp, topt, tlr, tgn = toptim.adamw_update(
        toptim.AdamWConfig(**cfg), params_from_numpy(grads, "cpu"),
        params_from_numpy(params, "cpu"), params_from_numpy(opt, "cpu"), step)

    if case == "clip":
        assert float(jgn) > 0.5
    assert tlr == float(jlr)
    np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
    got = tree_leaves(params_to_numpy({"p": tp, "o": topt}))
    want = tree_leaves(jax.tree.map(np.asarray, {"p": jp, "o": jopt}))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-7)


def test_schedule_warmup_matches_jax():
    cfg = dict(lr=1e-3, warmup_steps=7)
    for step in (0, 3, 6, 10):
        assert toptim._schedule(toptim.AdamWConfig(**cfg), step) == float(
            joptim._schedule(joptim.AdamWConfig(**cfg),
                             jnp.asarray(step, jnp.int32)))


def test_three_train_steps_match_jax():
    """make_init_fn + make_train_step on the tiny GPT-2 with the fused ops,
    dots remat and chunked CE, from the same initial weights and batch."""
    tiny = dict(vocab_size=256, n_layer=2, n_head=4, d_model=128, seq_len=64,
                remat="dots", ce_vocab_chunks=4, fused_norm=True,
                scan_layers=False)
    jcfg = jgpt2.GPT2Config(**tiny, dtype=jnp.float32)
    tcfg = tgpt2.GPT2Config(**tiny, dtype=torch.float32)
    tokens = np.random.default_rng(5).integers(0, 256, (8, 65), dtype=np.int32)
    lr = joptim.AdamWConfig().lr
    n_steps = 3

    mesh = build_mesh(MeshConfig())
    shardings = jgpt2.gpt2_shardings(jcfg, mesh)
    jstate = jmake_init_fn(lambda r: jgpt2.gpt2_init(r, jcfg), shardings,
                           mesh)(jax.random.key(0))
    init_params = jax.tree.map(np.asarray, jstate["params"])
    jstep = jmake_train_step(lambda p, b: jgpt2.gpt2_loss(p, b, jcfg),
                             shardings, mesh)
    jlosses = []
    for _ in range(n_steps):
        jstate, m = jstep(jstate, {"tokens": jnp.asarray(tokens)})
        jlosses.append(float(m["loss"]))
    jlr = float(m["lr"])

    init = make_init_fn(lambda g: params_from_numpy(init_params, "cpu"))
    tstate = init(torch.Generator())
    tstep = make_train_step(lambda p, b: tgpt2.gpt2_loss(p, b, tcfg))
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
