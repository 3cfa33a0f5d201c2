"""Continuous-batching LLM decode engine (port of
``ray_tpu/serve/llm_engine.py``).

ONE decode step over a fixed ``[max_batch]`` state, with requests admitted
into (and evicted from) the running batch **between** steps --
iteration-level scheduling:

* **Two compiled shapes, ever.** A fixed ``[max_batch + 1]`` decode step
  and a fixed ``[prefill_rows, max_prompt_len]`` chunked-prefill lane
  (``models/gpt2.py`` / ``models/llama.py`` decode halves). On ``cuda``
  each is captured once, in the constructor, as a ``torch.cuda.CUDAGraph``
  (the counterpart of the reference's one ``jax.jit`` compile each): the
  graph reads static input buffers that each step fills by ``copy_`` from
  the host arrays, updates the cache in place (the reference's donated
  buffer), takes the argmax on the device, and the step's one ``.cpu()``
  of the tokens is its one sync. On ``cpu`` the step functions run
  eagerly. ``llm_stats()["compiles"]`` counts captures (on the CPU, the
  one build of each step callable): ``{decode: 1, prefill: 1}`` for the
  engine's life.
* **Slot-indexed ring KV-cache in device memory**, in the model's
  activation dtype and, for Llama, the GQA ``n_kv_head`` layout. A
  finished or shed request's slot is recycled at the next step boundary;
  generations longer than the cache degrade to sliding-window attention.
  Slot ``max_batch`` is scratch: the unused prefill rows write there.
* **Deadlines.** A request whose absolute deadline dies -- queued or
  mid-decode -- frees its slot at the next step boundary as a typed shed
  (``RequestShedError``, ``reason="decode"``); admission prefers requests
  by deadline slack.
* **Token streaming.** Every request is a stream of per-step token chunks
  drained by ``llm_next`` (long poll) or ``llm_poll``.

Failpoints ``serve.llm.before_admit`` / ``serve.llm.before_step`` let
chaos crash, delay or hang the scheduler mid-iteration; the loop requeues
interrupted admissions (bounded retries) and fails active streams fast
after repeated step errors -- fail fast, never hang.

Mounted as a Serve deployment (``serve.deployment(...)(LLMEngine)``), the
replica names the engine's metric series after its deployment
(``set_deployment_name``), ``handle.stream()``, chunked HTTP and ``ray://``
drive ``llm_submit`` / ``llm_next``, and a prompt may arrive as an
``ObjectRef`` the ``ray://`` proxy put in the store (read back from this
node's shared memory). Every observation goes through the Serve recorder
(``_observability._emit``): this process's registry, and on a cluster the
worker's event batch to the agent's.

Left out against the reference: ``step_cost`` (the XLA cost model).
"""

from __future__ import annotations

import contextlib
import heapq
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.serve import _observability as _obs
from ray_tpu_torch.serve._observability import RequestShedError
from ray_tpu_torch.util import failpoints
from ray_tpu_torch.util import goodput as _goodput
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util import tracing

# How many consecutive decode-step failures fail the active streams (each
# failure already surfaced; three in a row means the step itself is
# broken, and holding streams open past that would be a hang).
_MAX_STEP_ERRORS = 3
# Abandoned-stream reap: a DONE stream nobody polls for this long is
# dropped.
_STREAM_TTL_S = 120.0


class _Stream:
    """One request's token stream: per-step chunks pending delivery plus
    the terminal state. ``event`` is set whenever there is something new
    to deliver (chunks or the terminal transition)."""

    __slots__ = ("pending", "done", "shed", "error", "last_poll", "event",
                 "n_tokens")

    def __init__(self):
        self.pending: List[List[int]] = []
        self.done = False
        self.shed: Optional[str] = None
        self.error: Optional[str] = None
        self.last_poll = time.monotonic()
        self.event = threading.Event()
        self.n_tokens = 0


class _Request:
    __slots__ = ("rid", "prompt", "max_new", "deadline_ts", "submitted",
                 "remaining", "retries", "stream", "seq", "trace_ctx",
                 "span")

    def __init__(self, rid: str, prompt: List[int], max_new: int,
                 deadline_ts: Optional[float], seq: int,
                 trace_ctx: Optional[dict] = None):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.deadline_ts = deadline_ts
        self.submitted = time.time()
        self.remaining = max_new
        self.retries = 0
        self.stream = _Stream()
        self.seq = seq  # FIFO tiebreak for slack ordering
        # The caller's span context (None when the caller doesn't trace)
        # and the request's OPEN phase span (llm.queue -> llm.prefill ->
        # llm.decode, one open at a time). Manual spans: a request crosses
        # from the submitting thread to the loop thread, which thread-local
        # context managers cannot follow. Mutated only under the engine
        # lock; every terminal path closes it in _finish_locked.
        self.trace_ctx = trace_ctx
        self.span: Optional[dict] = None


def _model_bundle(model: str, config, preset: str):
    """(config, init, init_cache, prefill, decode_step) for a family."""
    if model == "gpt2":
        from ray_tpu_torch.models import gpt2 as m

        cfg = config or (m.GPT2Config.tiny() if preset == "tiny"
                         else m.GPT2Config.small())
        return (cfg, m.gpt2_init, m.gpt2_init_cache, m.gpt2_prefill,
                m.gpt2_decode_step)
    if model == "llama":
        from ray_tpu_torch.models import llama as m

        cfg = config or (m.LlamaConfig.tiny() if preset == "tiny"
                         else m.LlamaConfig.small())
        return (cfg, m.llama_init, m.llama_init_cache, m.llama_prefill,
                m.llama_decode_step)
    raise ValueError(f"unknown model family {model!r} (want gpt2|llama)")


class LLMEngine:
    """One decode engine: ``llm_submit``/``llm_next``/``llm_poll`` are the
    streaming protocol, ``generate``/``__call__`` the blocking lane.

    Runs on ``cuda`` unless ``device`` says otherwise (raising without a
    GPU); weights are random from ``seed`` (``torch.Generator`` on the
    engine's device)."""

    def __init__(self, model: str = "gpt2", config=None,
                 preset: str = "tiny", seed: int = 0,
                 max_batch: int = 8, cache_len: int = 64,
                 max_prompt_len: int = 16, prefill_rows: int = 4,
                 max_new_tokens: int = 16, max_new_cap: int = 512,
                 max_queue: int = 8192, eos_token: Optional[int] = None,
                 step_throttle_s: float = 0.0,
                 deployment: Optional[str] = None, device=None):
        if max_prompt_len > cache_len:
            raise ValueError(
                f"max_prompt_len={max_prompt_len} must fit the cache "
                f"(cache_len={cache_len})")
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # The loop thread sets this device, which needs an index.
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = model
        self.max_batch = int(max_batch)
        self.cache_len = int(cache_len)
        self.max_prompt_len = int(max_prompt_len)
        self.prefill_rows = max(1, min(int(prefill_rows), self.max_batch))
        self.max_new_tokens = int(max_new_tokens)
        self.max_new_cap = int(max_new_cap)
        self.max_queue = int(max_queue)
        self.eos_token = eos_token
        self.step_throttle_s = float(step_throttle_s)
        self._dep = deployment or "llm"
        self._dep_explicit = deployment is not None

        cfg, init, init_cache, prefill, decode = _model_bundle(
            model, config, preset)
        if model == "gpt2" and self.max_prompt_len > cfg.seq_len:
            # gpt2's learned position table bounds the prefill window;
            # fail at construction, not per request inside the step.
            raise ValueError(
                f"max_prompt_len={self.max_prompt_len} exceeds the "
                f"model's position window (seq_len={cfg.seq_len})")
        self._cfg = cfg
        self.params = init(torch.Generator(device=self.device).manual_seed(
            seed), cfg, device=self.device)
        # One scratch slot past max_batch: inactive prefill rows write
        # their pad garbage there, keeping the prefill shape fixed.
        self._cache = init_cache(cfg, self.max_batch + 1, self.cache_len,
                                 device=self.device)
        self._compiles = {"decode": 0, "prefill": 0}

        # Host state, and the static device buffers each step copies it
        # into (a captured graph reads them at fixed addresses).
        slots, rows = self.max_batch + 1, self.prefill_rows
        self._tokens = np.zeros(slots, np.int64)
        self._pos = np.zeros(slots, np.int64)

        def zeros(*shape, fill=0):
            return torch.full(shape, fill, dtype=torch.int64,
                              device=self.device)

        self._in = {"tokens": zeros(slots), "pos": zeros(slots),
                    "p_tokens": zeros(rows, self.max_prompt_len),
                    "p_slots": zeros(rows, fill=self.max_batch),
                    "p_lengths": zeros(rows, fill=1)}

        @torch.no_grad()
        def step_body():
            logits, _ = decode(self.params, self._cache, self._in["tokens"],
                               self._in["pos"], cfg)
            return logits.argmax(-1), logits

        @torch.no_grad()
        def prefill_body():
            logits, _ = prefill(self.params, self._cache,
                                self._in["p_tokens"], self._in["p_slots"],
                                self._in["p_lengths"], cfg)
            return logits.argmax(-1), logits

        self._bodies = {"decode": step_body, "prefill": prefill_body}
        self._graphs = []
        self._step_fn = self._compile("decode")
        self._prefill_fn = self._compile("prefill")
        # One device user at a time: the loop holds the gate for each
        # admit-and-step iteration, a caller of run_decode_step /
        # run_prefill for its call (and only while nothing is served).
        self._gate = threading.Lock()

        self._slot_req: List[Optional[_Request]] = [None] * self.max_batch
        # Admission queue: a HEAP keyed (deadline slack, seq); expiry and
        # cancellation are lazy (checked at pop), _n_queued is the live
        # count (heap entries may be dead).
        self._queue: List[tuple] = []
        self._n_queued = 0
        self._streams: Dict[str, _Stream] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self._seq = 0
        self._step_errors_row = 0
        # Last wall-clock instant a token batch reached the streams: the
        # previous edge of the inter-token-latency gap (None until the
        # first prefill delivers).
        self._last_tokens_at: Optional[float] = None
        self._last_reap = time.monotonic()
        self.stats_counters = {
            "steps": 0, "admitted": 0, "completed": 0, "shed": 0,
            "errors": 0, "tokens_out": 0, "queue_peak": 0,
            "occupancy_sum": 0, "ring_wraps": 0,
        }
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="llm-engine-loop")
        self._thread.start()

    # -- the two step shapes ------------------------------------------------

    def _compile(self, name: str):
        """The step callable for ``name`` (returns (tokens, logits)),
        counted once: on ``cuda`` a CUDA graph captured after a warm-up
        on a side stream, replayed against the static buffers; elsewhere
        the eager body."""
        body = self._bodies[name]
        self._compiles[name] += 1
        if self.device.type != "cuda":
            return body
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):  # cuBLAS handles, workspaces, allocator
                body()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            out = body()
        self._graphs.append(graph)

        def replay():
            graph.replay()
            return out

        return replay

    def _run(self, name: str, inputs: dict, eager: bool = False,
             logits: bool = False):
        """Fill the static buffers from host ``inputs``, replay the
        captured ``name`` step (or, with ``eager``, call the same step
        function eagerly) and copy its tokens to the host: the step's one
        sync. Returns (tokens, a copy of the fp32 logits when ``logits``
        else None, perf_counter when the replay or call returned)."""
        for key, arr in inputs.items():
            self._in[key].copy_(torch.from_numpy(arr))
        fn = self._bodies[name] if eager else (
            self._step_fn if name == "decode" else self._prefill_fn)
        nxt, out = fn()
        t_dispatch = time.perf_counter()
        out = out.clone() if logits else None
        return nxt.cpu().numpy(), out, t_dispatch

    @contextlib.contextmanager
    def _idle(self):
        """Hold the loop off while a caller drives a step itself; raises
        unless nothing is active or queued (the caller's step writes K/V
        rows into every slot)."""
        def check():
            with self._lock:
                if any(r is not None for r in self._slot_req) \
                        or self._n_queued:
                    raise RuntimeError(
                        "engine is serving: run_decode_step / run_prefill "
                        "need an idle engine")

        # Checked before the gate too: a busy loop re-takes the gate at
        # once, so a waiter may only get it once the engine is idle.
        check()
        with self._gate:
            check()
            yield

    def run_decode_step(self, tokens, pos, *, eager: bool = False,
                        logits: bool = False):
        """One decode step on host arrays ``tokens``/``pos`` [max_batch+1],
        replayed from its graph or, with ``eager``, called eagerly, on an
        idle engine (raises otherwise): (next tokens [max_batch+1] on the
        host, a copy of the fp32 logits when ``logits`` else None). For
        measuring or checking the step; the caller owns the cache rows it
        writes."""
        with self._idle():
            return self._run("decode", {"tokens": tokens, "pos": pos},
                             eager, logits)[:2]

    def run_prefill(self, tokens, slots, lengths, *, eager: bool = False,
                    logits: bool = False):
        """The prefill lane on host arrays (tokens [rows, max_prompt_len],
        slots [rows], lengths [rows]), as ``run_decode_step``."""
        with self._idle():
            return self._run("prefill", {"p_tokens": tokens,
                                         "p_slots": slots,
                                         "p_lengths": lengths},
                             eager, logits)[:2]

    # -- scheduler loop ----------------------------------------------------

    def _loop(self):
        if self.device.type == "cuda":
            # Replay on the device the graphs were captured on.
            torch.cuda.set_device(self.device)
        while not self._stop:
            did = False
            with self._gate:
                try:
                    did = self._admit_once() or did
                except BaseException:
                    # _admit_once handles its own requeue; anything that
                    # still escapes must not kill the scheduler, but a
                    # crash-restart cycle must be visible on the scrape.
                    _metrics.count_loop_restart("llm.engine")
                try:
                    did = self._step_once() or did
                except BaseException:
                    # Step errors are already counted (3-strike fail-fast
                    # in _step_once); this tick records the loop's
                    # survival.
                    _metrics.count_loop_restart("llm.engine")
            if time.monotonic() - self._last_reap > 5.0:
                self._reap_streams()
            if not did:
                self._wake.wait(0.02)
                self._wake.clear()

    def _push_queued_locked(self, req: _Request):
        """Heap key = (deadline, seq): tightest budget first, FIFO among
        the unbounded; seq is unique, so _Request is never compared."""
        dl = req.deadline_ts if req.deadline_ts is not None \
            else float("inf")
        heapq.heappush(self._queue, (dl, req.seq, req))
        self._n_queued += 1

    def _shed_expired_locked(self, now: float):
        """Typed-shed the expired head of the queue (caller holds the
        lock). The heap is deadline-ordered, so expired entries are a
        prefix; this runs every iteration, so a dead budget sheds at the
        next step boundary even when no slot ever frees."""
        while self._queue:
            dl, _, req = self._queue[0]
            if req.stream.done:
                heapq.heappop(self._queue)  # cancelled: drop lazily
                continue
            if dl == float("inf") or now <= dl:
                break
            heapq.heappop(self._queue)
            self._n_queued -= 1
            self._finish_locked(req, shed="decode")

    def _admit_once(self) -> bool:
        with self._lock:
            now = time.time()
            self._shed_expired_locked(now)
            free = [i for i in range(self.max_batch)
                    if self._slot_req[i] is None]
            if not free or not self._n_queued:
                return False
            take = min(len(free), self.prefill_rows)
            batch: List[_Request] = []
            while self._queue and len(batch) < take:
                _, _, req = heapq.heappop(self._queue)
                if req.stream.done:
                    continue  # cancelled in queue: already accounted
                self._n_queued -= 1
                if req.deadline_ts is not None and now > req.deadline_ts:
                    # The budget died waiting for a slot: typed shed.
                    self._finish_locked(req, shed="decode")
                    continue
                batch.append(req)
            if not batch:
                return True  # expired/cancelled entries drained: progress
            slots = free[:len(batch)]
            for req in batch:
                # Queue phase ends; the prefill span covers the compute.
                self._phase_span_locked(req, "llm.prefill")
        try:
            failpoints.hit("serve.llm.before_admit")
            self._prefill_batch(batch, slots)
        except BaseException as e:  # requeue, bounded
            with self._lock:
                for req in batch:
                    req.retries += 1
                    if req.retries > 3:
                        self._finish_locked(req, error=repr(e))
                    else:
                        # The failed prefill span closes errored and a
                        # fresh queue span opens: an open span never
                        # re-enters the heap.
                        self._phase_span_locked(
                            req, "llm.queue", status="ERROR: prefill_retry")
                        self._push_queued_locked(req)
        return True

    def _prefill_batch(self, batch: List[_Request], slots: List[int]):
        rows, p_len = self.prefill_rows, self.max_prompt_len
        toks = np.zeros((rows, p_len), np.int64)
        slot_idx = np.full(rows, self.max_batch, np.int64)  # scratch row
        lengths = np.ones(rows, np.int64)
        for i, req in enumerate(batch):
            prompt = req.prompt[-p_len:]  # truncate to the lane window
            toks[i, :len(prompt)] = prompt
            slot_idx[i] = slots[i]
            lengths[i] = len(prompt)
        # The one sync per prefill: first tokens must reach the streams.
        first, _, _ = self._run("prefill", {"p_tokens": toks,
                                            "p_slots": slot_idx,
                                            "p_lengths": lengths})
        now = time.time()
        _obs.record_decode_tokens(self._dep, len(batch))
        with self._lock:
            for i, req in enumerate(batch):
                slot = slots[i]
                tok = int(first[i])
                self._tokens[slot] = tok
                self._pos[slot] = int(lengths[i])
                self._slot_req[slot] = req
                req.remaining = req.max_new - 1
                self.stats_counters["admitted"] += 1
                self.stats_counters["tokens_out"] += 1
                req.stream.n_tokens += 1
                req.stream.pending.append([tok])
                req.stream.event.set()
                # TTFT: submit -> first token available for delivery.
                _obs.record_ttft(self._dep, max(0.0, now - req.submitted))
                # The first token exists: the prefill phase ends here and
                # the decode phase runs until the terminal transition.
                self._phase_span_locked(req, "llm.decode")
                if req.remaining <= 0 or tok == self.eos_token:
                    self._finish_locked(req, done=True, slot=slot)
            self._last_tokens_at = now

    def _step_once(self) -> bool:  # step-timed
        with self._lock:
            now = time.time()
            # Deadline eviction at the step boundary: the slot frees NOW,
            # before compute, and the shed is typed.
            for slot in range(self.max_batch):
                req = self._slot_req[slot]
                if req is not None and req.deadline_ts is not None \
                        and now > req.deadline_ts:
                    self._finish_locked(req, shed="decode", slot=slot)
            active = [i for i in range(self.max_batch)
                      if self._slot_req[i] is not None]
            if not active:
                return False
            # ONE step span per engine step, parented under the oldest
            # traced request's decode span.
            step_parent = None
            for slot in active:
                req = self._slot_req[slot]
                if req.span is not None and (
                        step_parent is None
                        or req.submitted < step_parent[0]):
                    step_parent = (req.submitted, req.span)
        step_span = tracing.start_span(
            "llm.step", {"occupancy": len(active)},
            parent={"trace_id": step_parent[1]["trace_id"],
                    "span_id": step_parent[1]["span_id"]},
            cat="llm") if step_parent is not None else None
        t0 = time.perf_counter()
        try:
            # The failpoint sits inside the error-counted region: a
            # raise-armed before_step must trip the 3-strike fail-fast,
            # not skip every step while the site stays armed.
            failpoints.hit("serve.llm.before_step")
            # The host phase ends when the replay (or eager call)
            # returns; then the one sync per decode step: tokens fan out
            # to the streams from host memory.
            nxt, _, t_dispatch = self._run(
                "decode", {"tokens": self._tokens, "pos": self._pos})
        except BaseException:
            tracing.finish_span(step_span, "ERROR: step")
            self._step_errors_row += 1
            self.stats_counters["errors"] += 1
            if self._step_errors_row >= _MAX_STEP_ERRORS:
                with self._lock:
                    for slot in range(self.max_batch):
                        req = self._slot_req[slot]
                        if req is not None:
                            self._finish_locked(
                                req, error="decode step failing "
                                "repeatedly", slot=slot)
                self._step_errors_row = 0
            raise
        self._step_errors_row = 0
        step_s = time.perf_counter() - t0
        with self._lock:
            produced = 0
            for slot in active:
                req = self._slot_req[slot]
                if req is None:
                    continue  # cancelled while the step was in flight
                tok = int(nxt[slot])
                self._tokens[slot] = tok
                self._pos[slot] += 1
                if int(self._pos[slot]) % self.cache_len == 0:
                    self.stats_counters["ring_wraps"] += 1
                req.remaining -= 1
                produced += 1
                req.stream.n_tokens += 1
                req.stream.pending.append([tok])
                req.stream.event.set()
                if req.remaining <= 0 or tok == self.eos_token:
                    self._finish_locked(req, done=True, slot=slot)
            self.stats_counters["steps"] += 1
            self.stats_counters["tokens_out"] += produced
            self.stats_counters["occupancy_sum"] += len(active)
            # ITL: delivery-to-delivery gap, shared by every token of the
            # step (the slots advance in lockstep).
            done_at = time.time()
            itl = step_s if self._last_tokens_at is None \
                else max(0.0, done_at - self._last_tokens_at)
            self._last_tokens_at = done_at
        _obs.record_decode_step(self._dep, step_s, len(active), produced)
        _obs.record_decode_itl(self._dep, itl, produced)
        # Step anatomy: host = the dispatch wall, compute = the sync wait
        # after it; one engine has no gang barrier, so sync is 0 and host
        # + compute partition step_s.
        host_s = max(0.0, t_dispatch - t0)
        _goodput.record_anatomy(
            f"serve:{self._dep}", 0,
            {"data_wait": 0.0, "host": host_s,
             "compute": max(0.0, step_s - host_s), "sync": 0.0})
        if step_span is not None:
            step_span["attributes"]["tokens"] = produced
            tracing.finish_span(step_span)
        if self.step_throttle_s:
            time.sleep(self.step_throttle_s)
        return True

    def _phase_span_locked(self, req: _Request, name: Optional[str],
                           status: str = "OK") -> None:
        """Close the request's open phase span and (when ``name``) open the
        next one (caller holds the lock); a no-op for untraced requests."""
        if req.span is not None:
            tracing.finish_span(req.span, status)
            req.span = None
        if name is not None and req.trace_ctx and tracing.is_enabled():
            req.span = tracing.start_span(
                name, {"rid": req.rid, "deployment": self._dep},
                parent=req.trace_ctx, cat="llm")

    def _finish_locked(self, req: _Request, done: bool = False,
                       shed: Optional[str] = None,
                       error: Optional[str] = None,
                       slot: Optional[int] = None):
        """Terminal transition (caller holds the lock): free the slot,
        mark the stream, wake pollers, count the outcome, close the open
        phase span."""
        if slot is not None and self._slot_req[slot] is req:
            self._slot_req[slot] = None
        st = req.stream
        if st.done:
            return
        st.done = True
        st.shed = shed
        st.error = error
        st.event.set()
        if shed is not None:
            self.stats_counters["shed"] += 1
            _obs.record_shed(self._dep, shed)
        elif error is not None:
            self.stats_counters["errors"] += 1
        else:
            self.stats_counters["completed"] += 1
        self._phase_span_locked(
            req, None,
            status="OK" if done and not shed and not error
            else f"ERROR: {shed or error or 'aborted'}")

    def _reap_streams(self):
        self._last_reap = time.monotonic()
        cutoff = time.monotonic() - _STREAM_TTL_S
        with self._lock:
            for rid in [r for r, s in self._streams.items()
                        if s.done and s.last_poll < cutoff]:
                del self._streams[rid]

    # -- request surface ---------------------------------------------------

    def _normalize(self, prompt, max_new_tokens):
        if isinstance(prompt, dict):
            max_new_tokens = prompt.get("max_tokens", max_new_tokens)
            prompt = prompt.get("tokens")
        from ray_tpu_torch.core.object_ref import ObjectRef

        if isinstance(prompt, ObjectRef):
            # The store lane (reference :603-622): the ray:// proxy put a
            # long prompt in the object store and handed over the ref; the
            # read is a same-node shared-memory read, not a copy over RPC.
            import ray_tpu_torch

            prompt = ray_tpu_torch.get(prompt, timeout=30.0)
        if not prompt or not all(isinstance(t, int) for t in prompt):
            raise ValueError("prompt must be a non-empty list of token "
                             "ids (or {'tokens': [...]})")
        if max_new_tokens is None:
            max_new_tokens = self.max_new_tokens
        return list(prompt), max(1, min(int(max_new_tokens),
                                        self.max_new_cap))

    def llm_submit(self, prompt, max_new_tokens=None,
                   deadline_ts: Optional[float] = None) -> str:
        """Queue a request; returns the stream id. A full queue sheds
        typed (reason=decode); admission under a full batch only queues."""
        prompt, max_new = self._normalize(prompt, max_new_tokens)
        # The caller's span context rides the request scope; read on THIS
        # thread, before the request crosses to the loop thread.
        trace_ctx = (_obs.current_request() or {}).get("trace_ctx")
        if trace_ctx:
            tracing.enable()  # the caller traces: continue here
        with self._lock:
            if self._n_queued >= self.max_queue:
                _obs.record_shed(self._dep, "decode")
                self.stats_counters["shed"] += 1
                raise RequestShedError(
                    f"llm engine queue full ({self.max_queue})",
                    reason="decode")
            self._seq += 1
            rid = f"llm-{os.getpid():x}-{self._seq:x}"
            req = _Request(rid, prompt, max_new, deadline_ts, self._seq,
                           trace_ctx=trace_ctx)
            self._push_queued_locked(req)
            self._phase_span_locked(req, "llm.queue")
            self.stats_counters["queue_peak"] = max(
                self.stats_counters["queue_peak"], self._n_queued)
            self._streams[rid] = req.stream
        self._wake.set()
        return rid

    def llm_submit_many(self, requests: List[dict]) -> List[str]:
        """Batched submit: each entry is {"tokens": [...], "max_tokens": n,
        "deadline_ts": ts|None}."""
        return [self.llm_submit(r.get("tokens"), r.get("max_tokens"),
                                r.get("deadline_ts")) for r in requests]

    def _drain_locked(self, rid: str, st: _Stream) -> dict:
        chunks, st.pending = st.pending, []
        st.last_poll = time.monotonic()
        if st.done:
            self._streams.pop(rid, None)  # fully delivered
        return {"chunks": chunks, "done": st.done, "shed": st.shed,
                "error": st.error}

    def llm_next(self, rid: str, timeout_s: float = 2.0) -> dict:
        """Long-poll one stream: blocks until >=1 chunk (or the terminal
        transition) is available, up to ``timeout_s``."""
        with self._lock:
            st = self._streams.get(rid)
        if st is None:
            return {"chunks": [], "done": True, "shed": None,
                    "error": f"unknown stream {rid!r}"}
        st.event.wait(max(0.0, float(timeout_s)))
        with self._lock:
            resp = self._drain_locked(rid, st)
            if not st.done:
                st.event.clear()
        return resp

    def llm_poll(self, rids: List[str]) -> Dict[str, dict]:
        """Non-blocking batched drain."""
        out = {}
        with self._lock:
            for rid in rids:
                st = self._streams.get(rid)
                if st is None:
                    out[rid] = {"chunks": [], "done": True, "shed": None,
                                "error": f"unknown stream {rid!r}"}
                else:
                    out[rid] = self._drain_locked(rid, st)
        return out

    def llm_cancel(self, rid: str) -> bool:
        """Cancel a stream: a queued request leaves the queue, an active
        one frees its slot (the in-flight step's token for it is
        discarded). The stream ends with a 'cancelled' error; returns
        whether the request was still live. A request mid-admission (its
        prefill in flight) is in neither table and returns False."""
        with self._lock:
            for slot in range(self.max_batch):
                req = self._slot_req[slot]
                if req is not None and req.rid == rid:
                    self._finish_locked(req, error="cancelled", slot=slot)
                    return True
            for _, _, req in self._queue:
                if req.rid == rid and not req.stream.done:
                    # The heap entry is dropped lazily at pop; the live
                    # count updates now.
                    self._n_queued -= 1
                    self._finish_locked(req, error="cancelled")
                    return True
        return False

    def generate(self, prompt, max_new_tokens=None,
                 deadline_ts: Optional[float] = None,
                 timeout_s: Optional[float] = None) -> List[int]:
        """Blocking lane: submit, drain the stream, return the generated
        tokens. Sheds raise typed. On timeout the request is cancelled."""
        rid = self.llm_submit(prompt, max_new_tokens, deadline_ts)
        if timeout_s is None:
            timeout_s = 300.0 if deadline_ts is None else max(
                5.0, deadline_ts - time.time() + 30.0)
        out: List[int] = []
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            resp = self.llm_next(rid, timeout_s=2.0)
            for chunk in resp["chunks"]:
                out.extend(chunk)
            if resp["done"]:
                if resp["shed"]:
                    raise RequestShedError(
                        f"llm request shed: {resp['shed']}",
                        reason=resp["shed"])
                if resp["error"]:
                    raise RuntimeError(resp["error"])
                return out
        self.llm_cancel(rid)
        raise TimeoutError(
            f"llm generate did not finish within {timeout_s:.0f}s "
            f"(request cancelled)")

    def __call__(self, payload) -> dict:
        """{"tokens": [...], "max_tokens": n} -> {"tokens": [generated]};
        the request scope's deadline, if any, carries into the engine."""
        ctx = _obs.current_request() or {}
        return {"tokens": self.generate(
            payload, deadline_ts=ctx.get("deadline_ts"))}

    def llm_stats(self) -> dict:
        with self._lock:
            active = sum(1 for r in self._slot_req if r is not None)
            queued = self._n_queued
            c = dict(self.stats_counters)
        steps = c["steps"]
        return {
            "model": self.model,
            "device": str(self.device),
            "max_batch": self.max_batch,
            "cache_len": self.cache_len,
            "max_prompt_len": self.max_prompt_len,
            "prefill_rows": self.prefill_rows,
            "active": active,
            "queued": queued,
            "compiles": dict(self._compiles),
            "mean_occupancy": round(c["occupancy_sum"] / steps, 3)
            if steps else 0.0,
            **c,
        }

    def set_deployment_name(self, name: str) -> None:
        """Called by the Serve replica at construction (reference :786), so
        the decode series carry the deployment's name unless the engine
        was given one."""
        if not self._dep_explicit and name:
            self._dep = name

    def check_health(self) -> str:
        """"ok" while the scheduler loop runs; raises once it has died (its
        streams would otherwise wait forever)."""
        if not self._stop and not self._thread.is_alive():
            raise RuntimeError("llm engine loop is not running")
        return "ok"

    def shutdown_engine(self) -> bool:
        """Stop the loop (waiting for its iteration in flight) and retract
        the engine's series from the scrape."""
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=30.0)
        _metrics.retract_loop_series(["llm.engine"])
        _goodput.retract_trial(f"serve:{self._dep}")
        return True
