"""The port's serving path against the JAX package's on the CPU: the KV-cache
helpers (``ops/attention.py``), both models' decode halves (prefill, decode
step, ring cache) and ``serve/llm_engine.py:LLMEngine``.

Parameters come from the JAX ``*_init`` and reach the port through numpy
(``models/convert.py:params_from_numpy``); every input is made with numpy
from a seed and handed to both packages.

Tolerances:
- cache writes move values and are compared for equality;
- ``cached_decode_attention`` and the fp32 prefill/decode logits: rtol and
  atol 1e-5 -- the same fp32 arithmetic, summed in another order; the
  fp32 caches the same, outside the scratch slot, whose duplicate writes
  land in an unspecified order (nothing reads it);
- bf16 logits: cosine > 0.999, the JAX package's own bf16 criterion (the
  two frameworks round at other points);
- generated tokens: equal, token for token, to the JAX package's naive
  full-context loop (``tests/test_llm_serving.py:62``) at fp32.
The engine tests mirror ``tests/test_llm_serving.py``'s scheduler tests on
``LLMEngine(device="cpu")``.
"""

import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.ops import attention as jattn
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import params_from_numpy
from ray_tpu_torch.ops import attention as tattn
from ray_tpu_torch.serve import _observability as obs
from ray_tpu_torch.serve._observability import RequestShedError
from ray_tpu_torch.serve.llm_engine import LLMEngine
from ray_tpu_torch.util import failpoints, metrics

PROMPT = [5, 9, 2, 17, 3]
TOL = dict(rtol=1e-5, atol=1e-5)
# (family, JAX module, port module, init seed)
FAMILIES = {"gpt2": (jgpt2, tgpt2, 0), "llama": (jllama, tllama, 1)}


def _t(a, dtype=None):
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _configs(family, dtype="fp32"):
    jmod, tmod, _ = FAMILIES[family]
    jdt, tdt = {"fp32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcls = jmod.GPT2Config if family == "gpt2" else jmod.LlamaConfig
    tcls = tmod.GPT2Config if family == "gpt2" else tmod.LlamaConfig
    return (dataclasses.replace(jcls.tiny(), dtype=jdt),
            dataclasses.replace(tcls.tiny(), dtype=tdt))


def _jax_params(family, jcfg):
    jmod, _, seed = FAMILIES[family]
    init = jmod.gpt2_init if family == "gpt2" else jmod.llama_init
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), jcfg))


def _fns(family):
    jmod, tmod, _ = FAMILIES[family]
    p = "gpt2" if family == "gpt2" else "llama"
    return ({k: getattr(jmod, f"{p}_{k}") for k in
             ("init_cache", "prefill", "decode_step", "forward")},
            {k: getattr(tmod, f"{p}_{k}") for k in
             ("init_cache", "prefill", "decode_step", "forward")})


def _jax_naive(family, jcfg, params, prompt, n):
    """The single-tenant reference loop: full-context forward + argmax."""
    forward = _fns(family)[0]["forward"]
    toks = list(prompt)
    for _ in range(n):
        logits = forward(jax.tree.map(jnp.asarray, params),
                         jnp.asarray([toks], jnp.int32), jcfg)
        toks.append(int(jnp.argmax(logits[0, -1])))
    return toks[len(prompt):]


def _cosine(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


# -- the cache helpers ------------------------------------------------------


@pytest.mark.parametrize("heads", [4, 2])  # query width, GQA KV width
def test_cache_write_token_matches_jax_with_wrapped_cursors(heads):
    rng = np.random.default_rng(heads)
    s, length, hd = 5, 8, 16
    cache = rng.standard_normal((s, length, heads, hd), dtype=np.float32)
    rows = rng.standard_normal((s, 1, heads, hd), dtype=np.float32)
    pos = np.array([0, 7, 8, 19, 3], np.int32)  # 8 and 19 wrap
    cursor = pos % length
    want = jattn.cache_write_token(jnp.asarray(cache), jnp.asarray(rows),
                                   jnp.asarray(cursor))
    got = _t(cache)
    out = tattn.cache_write_token(got, _t(rows), _t(cursor).long())
    assert out is got  # in place
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("heads", [4, 2])
def test_cache_write_prompt_matches_jax_outside_scratch(heads):
    rng = np.random.default_rng(10 + heads)
    slots_n, length, p, hd = 5, 8, 6, 16
    cache = rng.standard_normal((slots_n, length, heads, hd),
                                dtype=np.float32)
    rows = rng.standard_normal((4, p, heads, hd), dtype=np.float32)
    slots = np.array([2, 0, 4, 4], np.int32)  # two unused rows -> scratch 4
    want = np.asarray(jattn.cache_write_prompt(
        jnp.asarray(cache), jnp.asarray(rows), jnp.asarray(slots)))
    got = _t(cache)
    tattn.cache_write_prompt(got, _t(rows), _t(slots).long())
    np.testing.assert_array_equal(got.numpy()[:4], want[:4])
    # The scratch slot holds one of its two rows' blocks, whichever won.
    assert any(np.array_equal(got.numpy()[4, :p], rows[i]) for i in (2, 3))


@pytest.mark.parametrize("valid", [[1, 8, 3, 5], [8, 8, 8, 8]])
def test_cached_decode_attention_matches_jax(valid):
    rng = np.random.default_rng(len(valid) + valid[0])
    s, length, h, hd = 4, 8, 4, 16
    q = rng.standard_normal((s, h, hd), dtype=np.float32)
    k, v = (rng.standard_normal((s, length, h, hd), dtype=np.float32)
            for _ in range(2))
    valid = np.array(valid, np.int32)
    want = jattn.cached_decode_attention(*map(jnp.asarray, (q, k, v, valid)),
                                         jnp.float32)
    got = tattn.cached_decode_attention(_t(q), _t(k), _t(v),
                                        _t(valid).long(), torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_take_rows_maps_indices_as_jax_gather():
    table = np.arange(10, dtype=np.float32).reshape(5, 2)
    idx = np.array([[7, -1], [-7, 3], [-5, -6]], np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(idx)])
    got = tattn.take_rows(_t(table), _t(idx).long())
    np.testing.assert_array_equal(got.numpy(), want)


# -- the models' decode halves ----------------------------------------------


def _run_both(family, dtype, cache_len=8, steps=6):
    """Prefill (rows targeting slots 2 and 0, two unused rows on scratch
    slot 4) then ``steps`` decode steps over all five slots, in both
    packages, from one parameter tree. cache_len 8 with a 5-token prompt
    wraps the ring cursor at the fourth step. Returns per call
    (JAX logits, port logits) and the two final caches."""
    jcfg, tcfg = _configs(family, dtype)
    jf, tf = _fns(family)
    params = _jax_params(family, jcfg)
    tparams = params_from_numpy(params, device="cpu")
    jparams = jax.tree.map(jnp.asarray, params)
    jcache = jf["init_cache"](jcfg, 5, cache_len)
    tcache = tf["init_cache"](tcfg, 5, cache_len, device="cpu")
    toks = np.zeros((4, 8), np.int32)
    toks[0, :5] = PROMPT
    toks[1, :3] = [11, 4, 250]
    slots = np.array([2, 0, 4, 4], np.int32)
    lengths = np.array([5, 3, 1, 1], np.int32)
    jl, jcache = jax.jit(jf["prefill"], static_argnums=5)(
        jparams, jcache, *map(jnp.asarray, (toks, slots, lengths)), jcfg)
    tl, tcache = tf["prefill"](tparams, tcache, _t(toks).long(),
                               _t(slots).long(), _t(lengths).long(), tcfg)
    calls = [(np.asarray(jl, np.float32)[:2], tl.float().numpy()[:2])]
    cur = np.array([int(np.argmax(calls[0][0][1])), 7, int(
        np.argmax(calls[0][0][0])), 9, 0], np.int32)
    pos = np.array([3, 0, 5, 0, 0], np.int32)
    jstep = jax.jit(jf["decode_step"], static_argnums=4)
    for _ in range(steps):
        jl, jcache = jstep(jparams, jcache, jnp.asarray(cur),
                           jnp.asarray(pos), jcfg)
        tl, tcache = tf["decode_step"](tparams, tcache, _t(cur).long(),
                                       _t(pos).long(), tcfg)
        # The scratch slot (4) reads its own unspecified rows: not compared.
        calls.append((np.asarray(jl, np.float32)[:4], tl.float().numpy()[:4]))
        cur = np.argmax(calls[-1][0], -1).astype(np.int32).tolist() + [0]
        cur = np.array(cur, np.int32)
        pos = pos + np.array([1, 1, 1, 1, 0], np.int32)
    jcache = {k: np.asarray(v, np.float32) for k, v in jcache.items()}
    tcache = {k: v.float().numpy() for k, v in tcache.items()}
    return calls, jcache, tcache


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_prefill_and_decode_match_jax_fp32(family):
    calls, jcache, tcache = _run_both(family, "fp32")
    for want, got in calls:
        np.testing.assert_allclose(got, want, **TOL)
    for k in ("k", "v"):
        assert tcache[k].shape == jcache[k].shape
        np.testing.assert_allclose(tcache[k][:, :4], jcache[k][:, :4], **TOL)


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_prefill_and_decode_match_jax_bf16(family):
    calls, jcache, tcache = _run_both(family, "bf16", steps=3)
    for want, got in calls:
        assert _cosine(got, want) > 0.999
    for k in ("k", "v"):
        assert _cosine(tcache[k][:, :4], jcache[k][:, :4]) > 0.999


def test_llama_cache_keeps_the_kv_heads_in_the_activation_dtype():
    _, tcfg = _configs("llama", "bf16")
    cache = tllama.llama_init_cache(tcfg, 3, 16, device="cpu")
    assert cache["k"].shape == (tcfg.n_layer, 3, 16, tcfg.n_kv_head,
                                tcfg.head_dim)
    assert cache["k"].dtype == torch.bfloat16


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_decode_matches_jax_naive_loop(family):
    """prefill + cached decode steps == the JAX package's full-context
    loop, token for token (fp32)."""
    jcfg, tcfg = _configs(family)
    params = _jax_params(family, jcfg)
    want = _jax_naive(family, jcfg, params, PROMPT, 6)
    tf = _fns(family)[1]
    tparams = params_from_numpy(params, device="cpu")
    cache = tf["init_cache"](tcfg, 4, 32, device="cpu")
    toks = torch.zeros(1, 8, dtype=torch.long)
    toks[0, :5] = torch.tensor(PROMPT)
    logits, cache = tf["prefill"](tparams, cache, toks, torch.tensor([2]),
                                  torch.tensor([5]), tcfg)
    got = [int(logits[0].argmax())]
    cur, pos = torch.zeros(4, dtype=torch.long), torch.zeros(4,
                                                             dtype=torch.long)
    cur[2], pos[2] = got[0], 5
    for _ in range(5):
        lg, cache = tf["decode_step"](tparams, cache, cur, pos, tcfg)
        got.append(int(lg[2].argmax()))
        cur[2], pos[2] = got[-1], pos[2] + 1
    assert got == want


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_out_of_range_tokens_map_as_in_jax(family):
    """Token ids past the vocabulary (and negative ones) take the JAX
    gather's rows in prefill and decode instead of raising."""
    jcfg, tcfg = _configs(family)
    jf, tf = _fns(family)
    params = _jax_params(family, jcfg)
    jparams = jax.tree.map(jnp.asarray, params)
    tparams = params_from_numpy(params, device="cpu")
    v = jcfg.vocab_size
    toks = np.array([[3, v, v + 7, -1], [-v - 3, 1, 2, 0]], np.int32)
    slots, lengths = np.array([0, 1], np.int32), np.array([4, 3], np.int32)
    jl, jcache = jf["prefill"](jparams, jf["init_cache"](jcfg, 3, 8),
                               *map(jnp.asarray, (toks, slots, lengths)),
                               jcfg)
    tl, tcache = tf["prefill"](tparams, tf["init_cache"](tcfg, 3, 8,
                                                         device="cpu"),
                               _t(toks).long(), _t(slots).long(),
                               _t(lengths).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    cur = np.array([v + 100, -2, 5], np.int32)
    pos = np.array([4, 3, 0], np.int32)
    jl, _ = jf["decode_step"](jparams, jcache, jnp.asarray(cur),
                              jnp.asarray(pos), jcfg)
    tl, _ = tf["decode_step"](tparams, tcache, _t(cur).long(),
                              _t(pos).long(), tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)


# -- the engine -------------------------------------------------------------


@pytest.fixture(autouse=True)
def _reset_failpoints():
    yield
    failpoints.reset()


def _copy_tree(dst, src):
    """Load a numpy tree into the engine's parameters in place."""
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_tree(dst[k], v)
        else:
            dst[k].copy_(torch.from_numpy(np.array(v)))


def _engine(**kw):
    family = kw.setdefault("model", "gpt2")
    kw.setdefault("config", _configs(family)[1])
    kw.setdefault("max_batch", 4)
    kw.setdefault("cache_len", 32)
    kw.setdefault("max_prompt_len", 8)
    kw.setdefault("max_new_tokens", 6)
    return LLMEngine(device="cpu", **kw)


def _snapshot():
    return obs.parse_prometheus(metrics.prometheus_text())


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_engine_generate_matches_jax_naive(family):
    """The whole engine (admission -> prefill lane -> batched decode) on
    the JAX weights reproduces the JAX naive loop."""
    jcfg, _ = _configs(family)
    params = _jax_params(family, jcfg)
    eng = _engine(model=family)
    try:
        _copy_tree(eng.params, params)
        assert eng.generate(PROMPT, 6) == _jax_naive(family, jcfg, params,
                                                     PROMPT, 6)
    finally:
        eng.shutdown_engine()


def test_engine_refuses_a_prompt_window_past_the_position_table():
    with pytest.raises(ValueError, match="position window"):
        _engine(max_prompt_len=128, cache_len=256)
    with pytest.raises(ValueError, match="must fit the cache"):
        _engine(max_prompt_len=64, cache_len=32)


def test_slot_recycle_and_admission_queue():
    """More concurrent requests than slots: the overflow queues, slots
    recycle as streams finish, every request gets its full generation."""
    eng = _engine(max_batch=2, prefill_rows=2)
    try:
        results: dict = {}
        errors: list = []

        def one(i):
            try:
                results[i] = eng.generate([i + 1, 7, 11], 5)
            except Exception as e:  # noqa: BLE001
                errors.append(repr(e))

        threads = [threading.Thread(target=one, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        assert len(results) == 8
        assert all(len(v) == 5 for v in results.values())
        st = eng.llm_stats()
        assert st["admitted"] == 8
        assert st["admitted"] > eng.max_batch  # ... by recycling
        assert st["active"] == 0 and st["queued"] == 0
        assert st["completed"] == 8
    finally:
        eng.shutdown_engine()


def test_deadline_shed_mid_decode_frees_slot():
    before = _snapshot()
    eng = _engine(max_batch=2, max_new_tokens=500, max_new_cap=1000,
                  step_throttle_s=0.02)
    try:
        rid = eng.llm_submit(PROMPT, 500, deadline_ts=time.time() + 0.3)
        got_tokens, shed = 0, None
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            resp = eng.llm_next(rid, timeout_s=1.0)
            got_tokens += sum(len(c) for c in resp["chunks"])
            if resp["done"]:
                shed = resp["shed"]
                break
        assert shed == "decode"
        assert 0 < got_tokens < 500  # decoded some, then evicted
        st = eng.llm_stats()
        assert st["active"] == 0 and st["shed"] == 1
        assert len(eng.generate(PROMPT, 4)) == 4  # the slot is reusable
        delta = obs.diff_parsed(before, _snapshot())
        sheds = obs.sum_counter(delta, "ray_tpu_serve_shed_total", "reason",
                                deployment="llm")
        assert sheds.get("decode") == 1
    finally:
        eng.shutdown_engine()


def test_queued_deadline_shed_and_slack_admission():
    eng = _engine(max_batch=1, prefill_rows=1, max_new_tokens=50,
                  max_new_cap=100, step_throttle_s=0.01)
    try:
        busy = eng.llm_submit(PROMPT, 50)
        time.sleep(0.1)
        dead = eng.llm_submit(PROMPT, 4, deadline_ts=time.time() + 0.05)
        time.sleep(0.3)  # the budget dies while queued behind `busy`
        resp = eng.llm_next(dead, timeout_s=5.0)
        assert resp["done"] and resp["shed"] == "decode"
        deadline = time.monotonic() + 30.0
        while not eng.llm_next(busy, timeout_s=2.0)["done"]:
            assert time.monotonic() < deadline
    finally:
        eng.shutdown_engine()


def test_admission_full_queue_sheds_typed():
    eng = _engine(max_batch=1, max_queue=2, max_new_tokens=50,
                  max_new_cap=100, step_throttle_s=0.01)
    try:
        eng.llm_submit(PROMPT, 50)
        time.sleep(0.2)  # the first request takes the slot
        eng.llm_submit(PROMPT, 50)
        eng.llm_submit(PROMPT, 50)
        with pytest.raises(RequestShedError) as ei:
            eng.llm_submit(PROMPT, 4)
        assert ei.value.reason == "decode"
    finally:
        eng.shutdown_engine()


def _wait_active(eng, n=1):
    deadline = time.monotonic() + 30.0
    while eng.llm_stats()["active"] < n and time.monotonic() < deadline:
        time.sleep(0.02)
    assert eng.llm_stats()["active"] >= n


def test_cancel_frees_slot_and_queue():
    eng = _engine(max_batch=1, prefill_rows=1, max_new_tokens=100,
                  max_new_cap=200, step_throttle_s=0.01)
    try:
        active = eng.llm_submit(PROMPT, 100)
        _wait_active(eng)
        queued = eng.llm_submit(PROMPT, 4)
        assert eng.llm_cancel(queued)
        assert eng.llm_cancel(active)
        assert not eng.llm_cancel(active)  # already gone
        resp = eng.llm_next(active, timeout_s=2.0)
        assert resp["done"] and resp["error"] == "cancelled"
        assert len(eng.generate(PROMPT, 3)) == 3  # the slot is reusable
    finally:
        eng.shutdown_engine()


def test_run_step_needs_an_idle_engine_and_returns_host_arrays():
    """run_decode_step / run_prefill write K/V rows into every slot, so
    they refuse while a request is active or queued, and hand back host
    tokens and a copy of the logits, never the step's own buffers."""
    eng = _engine(max_batch=1, prefill_rows=1, max_new_tokens=100,
                  max_new_cap=200, step_throttle_s=0.01)
    slots = eng.max_batch + 1
    tokens, pos = np.ones(slots, np.int64), np.zeros(slots, np.int64)
    p_args = (np.ones((1, eng.max_prompt_len), np.int64),
              np.full(1, eng.max_batch, np.int64), np.ones(1, np.int64))
    try:
        active = eng.llm_submit(PROMPT, 100)
        _wait_active(eng)
        queued = eng.llm_submit(PROMPT, 100)
        with pytest.raises(RuntimeError, match="engine is serving"):
            eng.run_decode_step(tokens, pos)
        with pytest.raises(RuntimeError, match="engine is serving"):
            eng.run_prefill(*p_args)
        assert eng.llm_cancel(active)
        _wait_active(eng)  # the queued request takes the freed slot
        with pytest.raises(RuntimeError, match="engine is serving"):
            eng.run_decode_step(tokens, pos)
        assert eng.llm_cancel(queued)
        nxt, logits = eng.run_decode_step(tokens, pos, logits=True)
        assert isinstance(nxt, np.ndarray) and nxt.shape == (slots,)
        assert logits.shape == (slots, eng._cfg.vocab_size)
        np.testing.assert_array_equal(nxt, logits.argmax(-1).numpy())
        again, _ = eng.run_decode_step(tokens + 1, pos, logits=True)
        np.testing.assert_array_equal(nxt, logits.argmax(-1).numpy())
        first, none = eng.run_prefill(*p_args)
        assert first.shape == (1,) and none is None
        assert len(eng.generate(PROMPT, 3)) == 3  # serving resumes
    finally:
        eng.shutdown_engine()


def test_ring_cache_wrap():
    """Generation past cache_len wraps the ring cursor (sliding-window
    attention) instead of erroring."""
    eng = _engine(max_batch=2, cache_len=8, max_prompt_len=8,
                  max_new_tokens=20, max_new_cap=64)
    try:
        assert len(eng.generate([1, 2, 3], 20)) == 20
        assert eng.llm_stats()["ring_wraps"] > 0
    finally:
        eng.shutdown_engine()


def test_compile_counters_single_shape():
    """Assorted prompt and generation lengths all ride the same two step
    callables: no per-request rebuild."""
    eng = _engine(max_batch=4)
    try:
        for prompt, n in (([1], 1), ([1, 2, 3], 4), (list(range(1, 9)), 6),
                          ([9, 9], 2)):
            assert len(eng.generate(prompt, n)) == n
        assert eng.llm_stats()["compiles"] == {"decode": 1, "prefill": 1}
    finally:
        eng.shutdown_engine()


def test_ttft_histogram_exact_counts():
    """Every admitted stream observes exactly one TTFT sample, and the
    token counter matches the delivered tokens exactly."""
    before = _snapshot()
    eng = _engine(deployment="ttft_test")
    try:
        total = sum(len(eng.generate([i + 1, 3, 5], 4)) for i in range(5))
        delta = obs.diff_parsed(before, _snapshot())
        ttft = obs.histogram_dist(delta, "ray_tpu_serve_decode_ttft_seconds",
                                  deployment="ttft_test")
        assert ttft and int(ttft["count"]) == 5
        toks = obs.sum_counter(delta, "ray_tpu_serve_decode_tokens_total",
                               "deployment", deployment="ttft_test")
        assert int(sum(toks.values())) == total == 20
        occ = obs.histogram_dist(delta,
                                 "ray_tpu_serve_decode_batch_occupancy",
                                 deployment="ttft_test")
        steps = obs.histogram_dist(delta, "ray_tpu_serve_decode_step_seconds",
                                   deployment="ttft_test")
        assert occ and steps and occ["count"] == steps["count"]
        stats = obs.decode_stats(delta, "ttft_test")
        assert stats["streams"] == 5 and stats["tokens"] == 20
    finally:
        eng.shutdown_engine()


def test_failpoint_step_raise_fails_streams_fast():
    """A persistently raise-armed before_step trips the 3-strike
    fail-fast: active streams error out instead of hanging."""
    eng = _engine(max_new_tokens=50, max_new_cap=100, step_throttle_s=0.01)
    try:
        rid = eng.llm_submit(PROMPT, 50)
        _wait_active(eng)
        failpoints.arm("serve.llm.before_step", "raise")
        resp = {}
        deadline = time.monotonic() + 15.0
        while time.monotonic() < deadline:
            resp = eng.llm_next(rid, timeout_s=1.0)
            if resp["done"]:
                break
        assert resp.get("done"), "stream hung behind an armed failpoint"
        assert resp["error"], resp
        failpoints.reset()
        assert len(eng.generate(PROMPT, 3)) == 3  # the engine recovered
    finally:
        eng.shutdown_engine()


def test_failpoint_admission_raise_recovers():
    """A raise,once before_admit interrupts the admission batch; the
    engine requeues and the stream still completes."""
    assert "serve.llm.before_admit" in failpoints.SITES
    assert "serve.llm.before_step" in failpoints.SITES
    eng = _engine()
    try:
        failpoints.arm("serve.llm.before_admit", "raise,once")
        assert len(eng.generate(PROMPT, 4)) == 4
        assert eng.llm_stats()["completed"] == 1
    finally:
        eng.shutdown_engine()


def test_request_scope_deadline_reaches_the_blocking_lane():
    """``__call__`` takes the request scope's deadline: a dead budget
    sheds typed instead of decoding."""
    eng = _engine()
    try:
        with obs.request_scope("llm", time.time() - 1.0):
            with pytest.raises(RequestShedError):
                eng({"tokens": PROMPT, "max_tokens": 4})
        assert len(eng({"tokens": PROMPT, "max_tokens": 3})["tokens"]) == 3
    finally:
        eng.shutdown_engine()


def test_engine_out_of_range_prompt_tokens_are_served():
    """A prompt with ids past the vocabulary is served (the JAX gather's
    rows), not an engine error."""
    eng = _engine()
    try:
        out = eng.generate([3, 10 ** 6, -4], 3)
        assert len(out) == 3 and all(0 <= t < 256 for t in out)
        assert eng.llm_stats()["errors"] == 0
    finally:
        eng.shutdown_engine()


# -- the serving harness (scripts/measure.py) at a tiny size -----------------


def test_measure_serve_serves_every_request_on_cpu():
    from ray_tpu_torch.scripts.measure import measure_serve

    r = measure_serve("gpt2", "tiny", requests=6, max_new_tokens=4,
                      device="cpu", reps=2, max_batch=2, cache_len=32,
                      max_prompt_len=16, prefill_rows=2)
    assert r["tokens_per_request"] == [4] * 6 and not r["errors"]
    assert r["compiles"] == {"decode": 1, "prefill": 1}
    assert r["graph_vs_eager"]["tokens_equal"]
    assert r["stats"]["tokens_out"] == 24 and r["stats"]["admitted"] == 6
    assert r["device"] == "cpu" and "peak_memory_bytes" not in r


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_serve_vs_naive_agrees_on_cpu(family):
    from ray_tpu_torch.scripts.measure import serve_prompts, serve_vs_naive

    _, tcfg = _configs(family)
    res = serve_vs_naive(family, tcfg,
                         prompts=serve_prompts(4, tcfg.vocab_size, 16),
                         n_tokens=8, device="cpu", max_batch=4, cache_len=32,
                         max_prompt_len=16, prefill_rows=2)
    assert res["match"], res
    assert all(len(p["engine"]) == 8 for p in res["prompts"])


@pytest.mark.parametrize("family", ["gpt2", "llama"])
def test_served_bf16_engine_tracks_its_fp32_copy_on_cpu(family):
    """The engine at bf16 against its fp32 copy (same weights): logits
    cosine > 0.999 after the prefill lane and after one decode step, and
    the K/V cache within 3% (relative, Frobenius): bf16 rounding gives
    0.4% here, a cache write 10% off gives 9.7%."""
    from ray_tpu_torch.scripts.measure import serve_prompts, served_vs_fp32

    _, tcfg = _configs(family, "bf16")
    res = served_vs_fp32(family, tcfg,
                         prompts=serve_prompts(4, tcfg.vocab_size, 16),
                         device="cpu", max_batch=4, cache_len=32,
                         max_prompt_len=16, prefill_rows=4)
    assert res["n"] == 4
    assert min(res["prefill_cosine"], res["decode_cosine"]) > 0.999, res
    assert res["cache_rel_err"] < 0.03, res


def test_phase_spans_and_step_anatomy():
    """A traced request walks llm.queue -> llm.prefill -> llm.decode under
    the caller's span, each decode step records one llm.step span and the
    step anatomy (host + compute, no data wait or sync), which shutdown
    retracts; ITL observes one sample per decode-step token."""
    from ray_tpu_torch.util import tracing

    before = _snapshot()
    eng = _engine(deployment="span_test")
    was = tracing.is_enabled()
    try:
        tracing.drain()
        ctx = {"trace_id": "ab" * 16, "span_id": "cd" * 8}
        with obs.request_scope("span_test", None, trace_ctx=ctx):
            assert len(eng.generate(PROMPT, 4)) == 4
        spans = [s for s in tracing.drain() if s.get("cat") == "llm"]
        phases = [s["name"] for s in spans if s["name"] != "llm.step"]
        assert phases == ["llm.queue", "llm.prefill", "llm.decode"]
        assert all(s["trace_id"] == ctx["trace_id"] for s in spans)
        assert all(s["parent_id"] == ctx["span_id"] for s in spans
                   if s["name"] != "llm.step")
        steps = [s for s in spans if s["name"] == "llm.step"]
        assert len(steps) == 3 and all(s["status"] == "OK" for s in steps)
        delta = obs.diff_parsed(before, _snapshot())
        itl = obs.histogram_dist(delta, "ray_tpu_serve_decode_itl_seconds",
                                 deployment="span_test")
        assert itl and int(itl["count"]) == 3
        anatomy = {dict(k)["phase"]: v for k, v in obs.parse_prometheus(
            metrics.prometheus_text())["ray_tpu_step_phase_seconds"].items()
            if dict(k)["trial"] == "serve:span_test"}
        assert set(anatomy) == {"data_wait", "host", "compute", "sync"}
        assert anatomy["data_wait"] == anatomy["sync"] == 0.0
        assert anatomy["host"] > 0.0
    finally:
        eng.shutdown_engine()
        if not was:
            tracing.disable()
    series = obs.parse_prometheus(metrics.prometheus_text()).get(
        "ray_tpu_step_phase_seconds", {})
    assert not any(dict(k)["trial"] == "serve:span_test" for k in series)
