"""Throughput-measurement harness (port of ``ray_tpu/scripts/measure.py``).

One definition of the timed-step protocol (warmup, a device sync, timed
steps, tok/s and MFU accounting), shared by ``measure_gpt2``,
``measure_llama`` and ``measure_moe`` (MFU against ``_device``'s
per-device peak table); ``measure_trainer_gpt2`` drives ``measure_gpt2``'s
run through the trainer (``CudaTrainer(...).fit()``) with the session's
step anatomy, MFU gauge and checkpoints;
``measure_serve`` is their serving counterpart, over ``LLMEngine``, and
``serve_vs_naive`` holds the engine's greedy tokens against the model's
full-forward loop, and ``served_vs_fp32`` the engine's logits at its
served dtype against an fp32 copy of it.
"""

from __future__ import annotations

import dataclasses
import statistics
import time

import numpy as np
import torch

from ray_tpu_torch._device import (device_name, peak_flops_per_chip,
                                   resolve_device)

# bench.py's "fused" GPT-2 config (bench.py:67 and :81): flash attention,
# fused norms, dots remat, bf16 logits, chunked CE -- the configuration the
# JAX package benchmarks and the port's main path.
FUSED_FLAGS = dict(remat="dots", scan_layers=False, use_flash=True,
                   logits_dtype=torch.bfloat16, ce_vocab_chunks=3,
                   fused_norm=True)
# The same with dense attention (the first slice's path), kept beside it.
FUSED_DENSE_FLAGS = dict(FUSED_FLAGS, use_flash=False)
# The Llama train step's kernel path: flash attention and the RMSNorm
# kernels under dots remat (LlamaConfig has no logits or CE options).
LLAMA_FLAGS = dict(remat="dots", scan_layers=False, use_flash=True,
                   fused_norm=True)
# The MoE train step: flash attention under dots remat; its norms are the
# plain chain, as in the JAX module, so it takes no fused_norm.
MOE_FLAGS = dict(remat="dots", scan_layers=False, use_flash=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _measure(init_params, loss_fn, vocab_size: int, seq_len: int,
             flops_per_token: float, batch: int, steps: int, warmup: int,
             device: torch.device, mesh=None, shardings=None) -> dict:
    """The timed-step protocol behind ``measure_gpt2``, ``measure_llama``
    and ``measure_moe``.

    Initialises the state from seed 0 (``init_params(generator)``) and a
    fixed batch from seed 1, runs ``warmup`` steps, syncs the device
    (``.item()`` of the loss, then ``torch.cuda.synchronize``), then times
    ``steps`` steps and syncs again. With ``mesh`` the state is sharded by
    ``shardings`` and every rank steps on the same global batch.

    Returns {tok_s, mfu, ms_step, loss, losses, dt, steps, warmup, batch,
    device, mesh, peak_memory_bytes}; ``losses`` holds every step's loss,
    warmup included, ``mfu`` is taken against the device's dense bf16 peak
    times the mesh's size, ``tok_s`` counts the global batch, and
    ``peak_memory_bytes`` is this rank's ``torch.cuda.max_memory_allocated``
    from before the init (None on the CPU).
    """
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step

    if mesh is not None and mesh.device_type != device.type:
        raise ValueError(f"a {mesh.device_type} mesh for a step on {device}")
    warmup = max(warmup, 1)  # >=1: the post-warmup sync reads metrics
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    state = make_init_fn(init_params, shardings, mesh)(
        torch.Generator(device=device).manual_seed(0))
    step_fn = make_train_step(loss_fn, shardings, mesh)
    tokens = torch.randint(
        0, vocab_size, (batch, seq_len + 1), device=device,
        generator=torch.Generator(device=device).manual_seed(1))
    batch_data = {"tokens": tokens}
    losses = []
    for _ in range(warmup):
        state, metrics = step_fn(state, batch_data)
        losses.append(metrics["loss"])
    losses[-1].item()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        state, metrics = step_fn(state, batch_data)
        losses.append(metrics["loss"])
    loss = metrics["loss"].item()
    _sync(device)
    dt = time.perf_counter() - t0
    tok_s = batch * seq_len * steps / dt
    name = device_name(device)
    n_dev = mesh.size() if mesh is not None else 1
    mfu = tok_s * flops_per_token / (peak_flops_per_chip(name) * n_dev) * 100
    return {
        "tok_s": tok_s,
        "mfu": mfu,
        "ms_step": dt / steps * 1000,
        "loss": loss,
        "losses": [float(x) for x in losses],
        "dt": dt,
        "steps": steps,
        "warmup": warmup,
        "batch": batch,
        "device": name,
        "mesh": (dict(zip(mesh.mesh_dim_names, mesh.shape))
                 if mesh is not None else None),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


def measure_gpt2(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                 device=None, mesh=None) -> dict:  # step-timed
    """Timed GPT-2 train-step loop -> measurement dict (see ``_measure``);
    with ``mesh`` the step is sharded by ``gpt2_shardings``."""
    from ray_tpu_torch.models.gpt2 import (
        gpt2_flops_per_token,
        gpt2_init,
        gpt2_loss,
        gpt2_shardings,
    )

    device = resolve_device(device)
    return _measure(lambda g: gpt2_init(g, cfg, device=device),
                    lambda p, b: gpt2_loss(p, b, cfg), cfg.vocab_size,
                    cfg.seq_len, gpt2_flops_per_token(cfg), batch, steps,
                    warmup, device, mesh,
                    gpt2_shardings(cfg, mesh) if mesh is not None else None)


def measure_llama(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                  device=None, mesh=None) -> dict:  # step-timed
    """Timed Llama train-step loop -> measurement dict (see ``_measure``);
    MFU from ``llama_flops_per_token``; with ``mesh`` the step is sharded
    by ``llama_shardings``."""
    from ray_tpu_torch.models.llama import (
        llama_flops_per_token,
        llama_init,
        llama_loss,
        llama_shardings,
    )

    device = resolve_device(device)
    return _measure(lambda g: llama_init(g, cfg, device=device),
                    lambda p, b: llama_loss(p, b, cfg), cfg.vocab_size,
                    cfg.seq_len, llama_flops_per_token(cfg), batch, steps,
                    warmup, device, mesh,
                    llama_shardings(cfg, mesh) if mesh is not None else None)


def measure_moe(cfg, batch: int, *, steps: int = 20, warmup: int = 3,
                device=None, mesh=None) -> dict:  # step-timed
    """Timed MoE train-step loop -> measurement dict (see ``_measure``);
    MFU from ``moe_flops_per_token`` (the active parameters); with
    ``mesh`` the step is sharded by ``moe_shardings`` and the model runs
    on that mesh (the all_to_all path where ``cfg.expert_parallel``)."""
    from ray_tpu_torch.models.moe import (
        moe_flops_per_token,
        moe_init,
        moe_loss,
        moe_shardings,
    )

    device = resolve_device(device)
    if mesh is not None:
        cfg = dataclasses.replace(cfg, mesh=mesh)
    return _measure(lambda g: moe_init(g, cfg, device=device),
                    lambda p, b: moe_loss(p, b, cfg), cfg.vocab_size,
                    cfg.seq_len, moe_flops_per_token(cfg), batch, steps,
                    warmup, device, mesh,
                    moe_shardings(cfg, mesh) if mesh is not None else None)


def measure_trainer_gpt2(cfg, batch: int, *, steps: int = 6,
                         warmup: int = 2, fail_at: int | None = None,
                         device=None) -> dict:
    """``measure_gpt2``'s run, ``steps`` steps in all, through the trainer:
    ``CudaTrainer(loop, ScalingConfig(num_workers=1)).fit()`` on the local
    backend, the loop on the worker's thread.

    The loop builds the state and the batch as ``_measure`` does (seed 0,
    seed 1), attaches ``session.set_step_cost(step_cost(step, state,
    batch))`` (one more call of the step, on copies), then runs each step
    through ``session.timed_step`` and reports ``{loss, step, t}`` with a
    ``Checkpoint.from_dict`` of a copy of the state every second step. With ``fail_at`` the first attempt raises
    before step ``fail_at`` (counted from 1), and the restart resumes from
    the latest checkpoint (``FailureConfig(max_failures=1)``). After each
    report the loop reads its rank's MFU and anatomy gauges (live only:
    ``fit`` retracts them at the end).

    Returns {losses (one a reported step, in report order), steps_run,
    ms_step (mean interval between the reports of the steps after
    ``warmup``; each interval holds a step, its device sync, its report
    and, every second step, the state's copy), tok_s,
    mfu_gauge (mean of the gauge over those steps), step_cost (flops,
    flops_by_op, device_kind), analytic_flops (``gpt2_flops_per_token`` x
    tokens), flops_ratio, anatomy (per step: the gauges' phases and MFU),
    restarts, goodput, wall_s (the whole ``fit``), device,
    peak_memory_bytes}."""
    from ray_tpu_torch._tree import tree_map
    from ray_tpu_torch.models.gpt2 import (
        gpt2_flops_per_token,
        gpt2_init,
        gpt2_loss,
    )
    from ray_tpu_torch.train import session
    from ray_tpu_torch.train.checkpoint import Checkpoint
    from ray_tpu_torch.train.config import (FailureConfig, RunConfig,
                                            ScalingConfig)
    from ray_tpu_torch.train.train_step import make_init_fn, make_train_step
    from ray_tpu_torch.train.trainer import CudaTrainer
    from ray_tpu_torch.util import metrics as _metrics
    from ray_tpu_torch.util.xla_cost import step_cost

    device = resolve_device(device)
    costs, anatomy = [], []

    def copy(state):
        return tree_map(lambda x: x.detach().clone()
                        if isinstance(x, torch.Tensor) else x, state)

    def loop(config):
        dev = session.get_device()
        step_fn = make_train_step(lambda p, b: gpt2_loss(p, b, cfg))
        ckpt = session.get_checkpoint()
        if ckpt is None:
            state = make_init_fn(lambda g: gpt2_init(g, cfg, device=dev))(
                torch.Generator(device=dev).manual_seed(0))
        else:
            state = copy(ckpt.to_dict()["state"])
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, cfg.seq_len + 1), device=dev,
            generator=torch.Generator(device=dev).manual_seed(1))
        batch_data = {"tokens": tokens}
        cost = step_cost(step_fn, state, batch_data)
        costs.append(cost)
        session.set_step_cost(cost)
        tags = {"node_id": "local", "trial": "train", "rank": "0"}
        for i in range(state["step"], steps):
            if fail_at is not None and i + 1 == fail_at and ckpt is None:
                raise RuntimeError(f"injected failure before step {fail_at}")
            state, metrics = session.timed_step(step_fn, state, batch_data)
            done = i + 1
            keep = (Checkpoint.from_dict({"state": copy(state)})
                    if done % 2 == 0 else None)
            session.report({"loss": float(metrics["loss"]), "step": done,
                            "t": time.perf_counter()}, checkpoint=keep)
            anatomy.append({
                "step": done,
                "mfu": _metrics.TRAIN_MFU_PERCENT.get(tags),
                **{ph: _metrics.TRAIN_STEP_ANATOMY_SECONDS.get(
                    {**tags, "phase": ph})
                   for ph in ("data_wait", "host", "compute", "sync")}})

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    result = CudaTrainer(
        loop, scaling_config=ScalingConfig(num_workers=1),
        run_config=RunConfig(failure_config=FailureConfig(
            max_failures=1 if fail_at is not None else 0)),
        device=device).fit()
    wall = time.perf_counter() - t0
    if result.error is not None:
        raise RuntimeError("the trainer failed") from result.error
    hist = result.metrics_history
    timed = [m["t"] for m in hist if m["step"] >= warmup]
    dt = (timed[-1] - timed[0]) / (len(timed) - 1)
    mfus = [a["mfu"] for a in anatomy if a["step"] > warmup]
    analytic = gpt2_flops_per_token(cfg) * batch * cfg.seq_len
    cost = costs[0]
    return {
        "losses": [m["loss"] for m in hist],
        "steps_run": [m["step"] for m in hist],
        "ms_step": dt * 1000,
        "tok_s": batch * cfg.seq_len / dt,
        "mfu_gauge": statistics.fmean(mfus),
        "step_cost": {k: cost[k] for k in ("flops", "flops_by_op",
                                           "device_kind")},
        "analytic_flops": analytic,
        "flops_ratio": cost["flops"] / analytic,
        "anatomy": anatomy,
        "restarts": result.goodput["restarts"],
        "goodput": result.goodput,
        "wall_s": wall,
        "device": device_name(device),
        "peak_memory_bytes": (torch.cuda.max_memory_allocated(device)
                              if device.type == "cuda" else None),
    }


# The serving engines' settings at full width, by family: 32 slots, a ring
# cache of the model's window (GPT-2 1024, Llama 2048), a prefill lane of 4
# rows of 128 / 256 tokens; prompts drawn over 16..128 / 16..256 tokens.
SERVE_ENGINES = {
    "gpt2": dict(max_batch=32, cache_len=1024, max_prompt_len=128,
                 prefill_rows=4),
    "llama": dict(max_batch=32, cache_len=2048, max_prompt_len=256,
                  prefill_rows=4),
}
SERVE_PROMPT_MIN = 16


def serve_prompts(n: int, vocab_size: int, max_len: int, seed: int = 3):
    """``n`` prompts of random tokens, lengths uniform over
    [SERVE_PROMPT_MIN, max_len], from ``seed``."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(SERVE_PROMPT_MIN, max_len + 1, n)
    return [rng.integers(0, vocab_size, int(k)).tolist() for k in lengths]


def _median_ms(fn, device, reps: int) -> float:
    """Median host wall ms of ``fn`` followed by a device sync."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _step_inputs(eng, seed: int):
    """Random decode-step inputs (host arrays) for every slot."""
    rng = np.random.default_rng(seed)
    n = eng.max_batch + 1
    return (rng.integers(0, eng._cfg.vocab_size, n),
            rng.integers(0, eng.cache_len, n))


def decode_graph_vs_eager(eng, seed: int = 5) -> dict:
    """One decode step replayed from the engine's graph and the same step
    function called eagerly, from one cache snapshot and one input
    (random tokens and positions); the cache is restored after each.
    Returns {tokens_equal, logits_max_abs_diff}. The engine must be idle
    (``run_decode_step`` raises otherwise)."""
    tokens, pos = _step_inputs(eng, seed)
    snap = {k: v.clone() for k, v in eng._cache.items()}
    out = {}
    for eager in (False, True):
        nxt, logits = eng.run_decode_step(tokens, pos, eager=eager,
                                          logits=True)
        out[eager] = (nxt, logits.float().cpu())
        for k, v in snap.items():
            eng._cache[k].copy_(v)
    return {"tokens_equal": bool(np.array_equal(out[False][0],
                                                out[True][0])),
            "logits_max_abs_diff": float(
                (out[False][1] - out[True][1]).abs().max())}


def _collect(eng, rids, t_submit, on_poll=None, timeout_s: float = 600.0):
    """Drain every stream from this thread, one ``llm_poll`` of all live
    streams every 0.5 ms, calling ``on_poll()`` after each; returns per
    request (first token wall s after ``t_submit``, tokens, error)."""
    first, toks, err = {}, {rid: [] for rid in rids}, {}
    live = list(rids)
    deadline = time.monotonic() + timeout_s
    while live:
        if time.monotonic() > deadline:
            raise TimeoutError(f"{len(live)} streams still open")
        eng.check_health()
        polled = eng.llm_poll(live)
        now = time.perf_counter() - t_submit
        for rid, resp in polled.items():
            if resp["chunks"] and rid not in first:
                first[rid] = now
            for chunk in resp["chunks"]:
                toks[rid].extend(chunk)
            if resp["done"]:
                err[rid] = resp["shed"] or resp["error"]
        live = [rid for rid in live if rid not in err]
        if on_poll is not None:
            on_poll()
        time.sleep(0.0005)
    return [(first.get(rid), toks[rid], err[rid]) for rid in rids]


def measure_serve(model: str, preset: str = "small", *, requests: int = 64,
                  max_new_tokens: int = 64, config=None, device=None,
                  reps: int = 20, seed: int = 0, **engine_kw) -> dict:
    """Serve ``requests`` random prompts (``serve_prompts``, seed 3) of
    ``max_new_tokens`` each, no eos, through one ``LLMEngine`` of family
    ``model`` (``SERVE_ENGINES`` settings unless overridden), and measure:

    - ``decode_tok_s_full``: decode tokens a second while every slot was
      busy (from the first to the last sample of the engine's counters,
      taken at each poll of the streams, that saw all ``max_batch`` slots
      active; the window includes the prefills admitted within it), and
      ``serve_tok_s``, all tokens over the whole run's wall time;
    - ``step_ms_graph`` / ``step_ms_eager``: the decode step's median wall
      ms (input copy, step, device sync) replayed from its graph and
      called eagerly, at random tokens and positions; ``prefill_ms_graph``
      / ``prefill_ms_eager`` the same for the prefill lane;
    - ``ttft_ms_p50`` / ``ttft_ms_p99``: submit to first token, per
      request on the client's clock, all requests submitted at once;
    - ``peak_memory_bytes``: ``torch.cuda.max_memory_allocated`` from
      before the engine's construction (on a GPU);
    - ``graph_vs_eager``: ``decode_graph_vs_eager`` after the run.
    Also: every request's token count, ``compiles``, the engine's stats.
    The step times are taken before the requests, on an idle engine."""
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    device = resolve_device(device)
    kw = {**SERVE_ENGINES[model], **engine_kw}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    eng = LLMEngine(model=model, config=config, preset=preset, seed=seed,
                    max_new_tokens=max_new_tokens, max_new_cap=max_new_tokens,
                    device=device, **kw)
    build_s = time.perf_counter() - t0
    try:
        tokens, pos = _step_inputs(eng, seed + 1)
        rows, p_len = eng.prefill_rows, eng.max_prompt_len
        p_tokens = np.ones((rows, p_len), np.int64)
        p_slots = np.full(rows, eng.max_batch, np.int64)  # the scratch slot
        p_lengths = np.full(rows, p_len, np.int64)
        times = {}
        for eager in (False, True):
            tag = "eager" if eager else "graph"
            times[f"step_ms_{tag}"] = _median_ms(
                lambda: eng.run_decode_step(tokens, pos, eager=eager),
                device, reps)
            times[f"prefill_ms_{tag}"] = _median_ms(
                lambda: eng.run_prefill(p_tokens, p_slots, p_lengths,
                                        eager=eager), device, reps)
        prompts = serve_prompts(requests, eng._cfg.vocab_size,
                                eng.max_prompt_len)
        t_submit = time.perf_counter()
        samples = []

        def sample():
            st = eng.llm_stats()
            samples.append((time.perf_counter(), st["active"],
                            st["occupancy_sum"], st["steps"]))

        rids = eng.llm_submit_many([{"tokens": p} for p in prompts])
        results = _collect(eng, rids, t_submit, on_poll=sample)
        wall = time.perf_counter() - t_submit
        full = [s for s in samples if s[1] == eng.max_batch]
        window = full[-1][0] - full[0][0] if len(full) > 1 else 0.0
        stats = eng.llm_stats()
        ttft = sorted(r[0] * 1e3 for r in results if r[0] is not None)
        out = {
            "model": model, "preset": preset, "device": device_name(device),
            "dtype": str(eng._cfg.dtype).split(".")[-1],
            "n_params": eng._cfg.n_params, **kw,
            "requests": requests, "max_new_tokens": max_new_tokens,
            "prompt_tokens": sum(len(p) for p in prompts),
            "build_s": build_s, **times,
            "decode_tok_s_full": (full[-1][2] - full[0][2]) / window
            if window > 0 else None,
            "full_window_steps": full[-1][3] - full[0][3] if full else 0,
            "serve_tok_s": stats["tokens_out"] / wall, "wall_s": wall,
            "ttft_ms_p50": float(np.percentile(ttft, 50)) if ttft else None,
            "ttft_ms_p99": float(np.percentile(ttft, 99)) if ttft else None,
            "tokens_per_request": [len(r[1]) for r in results],
            "errors": [r[2] for r in results if r[2]],
            "compiles": stats["compiles"], "stats": stats,
            "graph_vs_eager": decode_graph_vs_eager(eng),
        }
    finally:
        eng.shutdown_engine()
    if device.type == "cuda":
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    del eng
    return out


def serve_vs_naive(model: str, config, *, prompts, n_tokens: int = 8,
                   device=None, seed: int = 0, **engine_kw) -> dict:
    """The engine's greedy tokens for ``prompts`` (submitted together)
    against the model's naive loop (full-context ``*_forward`` + argmax a
    token) on the engine's own weights. Compares up to the first step
    where the naive loop's top-2 logit gap is under 1e-4 * max(1, |top
    logit|) (a near tie, where summation order may pick either).
    Returns {match, compared (tokens compared over all prompts), min_gap,
    prompts: per prompt {engine, naive, gaps, compared, error}}."""
    from ray_tpu_torch.models import gpt2, llama
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    device = resolve_device(device)
    forward = gpt2.gpt2_forward if model == "gpt2" else llama.llama_forward
    kw = {**SERVE_ENGINES[model], **engine_kw}
    eng = LLMEngine(model=model, config=config, seed=seed,
                    max_new_tokens=n_tokens, device=device, **kw)
    try:
        rids = eng.llm_submit_many([{"tokens": p} for p in prompts])
        results = _collect(eng, rids, time.perf_counter())
        rows, match, compared, min_gap = [], True, 0, float("inf")
        with torch.no_grad():
            for p, (_, got, err) in zip(prompts, results):
                toks, gaps, tie = list(p), [], n_tokens
                for i in range(n_tokens):
                    logits = forward(eng.params, torch.tensor([toks],
                                                              device=device),
                                     eng._cfg)[0, -1].float()
                    top2 = logits.topk(2).values
                    gap = float(top2[0] - top2[1])
                    gaps.append(gap)
                    if tie == n_tokens and gap < 1e-4 * max(
                            1.0, abs(float(top2[0]))):
                        tie = i  # a near tie: either token may win
                    toks.append(int(logits.argmax()))
                want = toks[len(p):]
                match &= (err is None and len(got) == n_tokens
                          and got[:tie] == want[:tie])
                compared += tie
                min_gap = min(min_gap, min(gaps))
                rows.append({"engine": got, "naive": want, "gaps": gaps,
                             "compared": tie, "error": err})
    finally:
        eng.shutdown_engine()
    return {"match": match, "compared": compared, "min_gap": min_gap,
            "prompts": rows}


def served_vs_fp32(model: str, config, *, prompts, device=None,
                   seed: int = 0, **engine_kw) -> dict:
    """The engine at ``config``'s dtype against an fp32 copy of it (same
    seed, so the same fp32 weights), both idle: ``prompts`` (at most
    ``prefill_rows``) through the prefill lane into slots 0.., then one
    decode step at each prompt's next position, fed the fp32 copy's
    first tokens in both. Returns the smallest per-prompt cosine of the
    fp32 logits after the prefill and after the decode step, the K/V
    cache's relative error (Frobenius, the larger of K and V) over the
    prompts' slots after both, and how many first and next tokens agree
    ({prefill_cosine, decode_cosine, cache_rel_err, first_agree,
    next_agree, n})."""
    from ray_tpu_torch.serve.llm_engine import LLMEngine

    device = resolve_device(device)
    kw = {**SERVE_ENGINES[model], **engine_kw}
    n = len(prompts)
    runs = {}
    # The fp32 copy first: its first tokens feed both decode steps.
    for name, cfg in (("fp32", dataclasses.replace(config,
                                                    dtype=torch.float32)),
                      ("served", config)):
        eng = LLMEngine(model=model, config=cfg, seed=seed, device=device,
                        **kw)
        try:
            rows, slots = eng.prefill_rows, eng.max_batch + 1
            if n > rows:
                raise ValueError(f"{n} prompts exceed {rows} prefill rows")
            toks = np.zeros((rows, eng.max_prompt_len), np.int64)
            p_slots = np.full(rows, eng.max_batch, np.int64)
            lengths = np.ones(rows, np.int64)
            for i, p in enumerate(prompts):
                toks[i, :len(p)] = p
                p_slots[i], lengths[i] = i, len(p)
            first, p_logits = eng.run_prefill(toks, p_slots, lengths,
                                              logits=True)
            feed = runs["fp32"]["first"] if "fp32" in runs else first[:n]
            tokens, pos = np.zeros(slots, np.int64), np.zeros(slots, np.int64)
            tokens[:n], pos[:n] = feed, lengths[:n]
            nxt, d_logits = eng.run_decode_step(tokens, pos, logits=True)
            runs[name] = {"first": first[:n], "next": nxt[:n],
                          "prefill": p_logits[:n].float().cpu(),
                          "decode": d_logits[:n].float().cpu(),
                          "cache": {k: v[:, :n].float().cpu()
                                    for k, v in eng._cache.items()}}
        finally:
            eng.shutdown_engine()
    a, b = runs["served"], runs["fp32"]
    cos = {k: float(torch.nn.functional.cosine_similarity(
        a[k], b[k], dim=-1).min()) for k in ("prefill", "decode")}
    cache_err = max(float((a["cache"][k] - b["cache"][k]).norm()
                          / b["cache"][k].norm()) for k in b["cache"])
    return {"prefill_cosine": cos["prefill"], "decode_cosine": cos["decode"],
            "cache_rel_err": cache_err,
            "first_agree": int((a["first"] == b["first"]).sum()),
            "next_agree": int((a["next"] == b["next"]).sum()), "n": n}
