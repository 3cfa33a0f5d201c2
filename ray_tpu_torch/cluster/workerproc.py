"""Worker process: executes tasks and hosts actors (port of
``ray_tpu/cluster/workerproc.py``; CoreWorker equivalent).

The execution side of ``src/ray/core_worker``: receives pushed tasks over
RPC (``core_worker.proto:382`` PushTask), deserializes them (functions by
reference, ``core/serialization.py``), resolves ObjectRef args through the
object plane, runs the function, and stores returns in the node's shm
store + registers locations with the owner and the head (the
task-execution callback path, ``_raylet.pyx:956``).

A worker executes ONE task at a time on its executor thread; actor workers
are dedicated: the actor constructor is the first queued item and method
calls execute in arrival order (sequence-numbered actor queue analog;
``max_concurrency`` > 1 and concurrency groups add executor threads).
Nested ``ray_tpu_torch.*`` calls inside user code work because the worker
installs a full ClusterBackend as the process-wide backend. A worker whose
agent stops answering exits (the reference's shutdown-on-raylet-death).

The worker imports no ``ray_tpu`` module and no jax: its agent starts it
with a PYTHONPATH stripped of site hooks that would load jax
(``node_agent._worker_pythonpath``).

Observability: each task, actor construction and actor call makes a
task record with its per-phase wall time (``get_args``, ``execute``,
``put_outputs``; ``_PhaseClock``); ``sys.stdout`` and ``sys.stderr`` are
teed line by line into a buffer (the agent also captures the process's
raw streams into its log files); the records, the captured lines, this
process's finished spans with their drop count, its training goodput
observations (``util/goodput.py``'s ship buffer) and (about once a
second, once CUDA is up here) a device snapshot ride one batched
``worker_events`` call to the agent, resent under their sequence number
until acknowledged, so the agent applies each exactly once. Puts made
while a task runs carry the task's name in their attribution
(``core/attribution.py``), and a task or actor call submitted under a
span runs inside a ``run:`` span parented under the caller's context
(``spec["trace_ctx"]``). The operator's RPCs: ``dump_stack`` and
``profile`` (``util/stack_sampler.py``), ``capture_profile`` (a
``torch.profiler`` window where CUDA is up, the stack sampler where it
is not; ``util/device_telemetry.py``), and the failpoint and network
chaos RPCs that end the head's fan-out. The failpoint sites
``worker.execute.before`` / ``worker.execute.after`` bracket each task's
and actor call's user code.

A streaming task (``num_returns="streaming"``) stores each item as it is
yielded, at the next return index of the task, then a ``_StreamEnd``
(reference ``ray_tpu/cluster/workerproc.py:578-600``); an item already in
this node's store from an earlier attempt of the task stays as it is. An
actor with any public coroutine method is an async actor (reference
:137-148, :729-803): every call of it runs on its one event loop thread,
a coroutine interleaving with the others at its awaits and a sync method
blocking the loop while it runs; the executor thread only resolves the
arguments and schedules the call, and a completion thread stores the
result. ``cancel_task`` cancels an in-flight coroutine through its future.
The loop thread takes the CUDA device current on the thread that built
the actor before its first coroutine runs. The tee keeps a coroutine's
partial line per asyncio task, so coroutines printing across an await
splice no line.

Serve observations (``serve/_observability.py``: request phases,
statuses, sheds, batch sizes, replica and router gauges, the engine's
decode series) ride the event batch once something in the process imported
Serve (reference :246-305), and go back to their buffer when the agent
never took the batch they rode.
"""

from __future__ import annotations

import argparse
import collections
import io
import os
import queue
import sys
import threading
import time
import traceback

from contextlib import nullcontext

from ray_tpu_torch.cluster.rpc import RpcClient, RpcServer
from ray_tpu_torch.core import attribution
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.core.cancellation import CancelRegistry
from ray_tpu_torch.util import failpoints
from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.core.object_ref import (
    ActorError,
    ObjectRef,
    TaskCancelledError,
    TaskError,
)

class _TeeStream(io.TextIOBase):
    """Write-through stdout/stderr wrapper that also buffers whole lines
    into a shared list for the event flusher (the driver's log stream
    over the head's ``LOGS`` channel). Each thread keeps its own partial
    line (``print`` writes its text and its newline in two calls), and
    the partials and the sink change under one lock, so threads printing
    at once splice no line."""

    def __init__(self, inner, sink: list, lock: threading.Lock):
        self._inner = inner
        self._sink = sink
        self._lock = lock
        self._partial: dict = {}  # thread ident -> its unfinished line

    def write(self, s):
        self._inner.write(s)
        # A coroutine's partial line is its asyncio task's: the coroutines
        # of an async actor share one thread.
        tid = _current_task() or threading.get_ident()
        with self._lock:
            text = self._partial.pop(tid, "") + s
            if "\n" in text:
                *lines, text = text.split("\n")
                self._sink.extend(lines)
            if text:
                self._partial[tid] = text
        return len(s)

    def flush(self):
        self._inner.flush()

    def isatty(self):
        return False


def _current_task():
    """The asyncio task running on this thread, or None (asyncio is read
    only once something imported it)."""
    aio = sys.modules.get("asyncio")
    if aio is None:
        return None
    try:
        return aio.current_task()
    except RuntimeError:  # no running loop on this thread
        return None


class _PhaseClock:
    """Wall-ns accumulator for the per-task phase breakdown
    (``get_args`` = arg fetch + deserialize, ``execute`` = user code,
    ``put_outputs`` = result serialize + object-store put). ``lap``
    closes the current phase; phases ride the task record to the agent
    and surface in ``state.summarize_tasks()`` / ``timeline()``."""

    __slots__ = ("_phases", "_t")

    def __init__(self, phases: dict):
        self._phases = phases
        self._t = time.monotonic_ns()

    def lap(self, name: str) -> None:
        now = time.monotonic_ns()
        self._phases[name] = self._phases.get(name, 0) + (now - self._t)
        self._t = now


class WorkerHandler:
    def __init__(self, head_address, agent_address, node_id, store_path, worker_id):
        from ray_tpu_torch.cluster.client import ClusterBackend
        from ray_tpu_torch.core.config import config

        self.worker_id = worker_id
        self.agent = RpcClient(agent_address)
        self.backend = ClusterBackend(
            head_address, node_id=node_id, store_path=store_path,
            agent_address=agent_address, process_kind="w",
        )
        from ray_tpu_torch._private import worker as worker_mod

        worker_mod._backend = self.backend  # nested API calls inside tasks
        self._hooks = (
            lambda: self.agent.call("task_blocked", self.worker_id),
            # Unblock re-acquires the CPU slot and the agent-side acquire
            # may legitimately wait up to its full re-acquire budget when
            # the node is saturated — the RPC timeout must outlast it.
            lambda: self.agent.call(
                "task_unblocked", self.worker_id,
                # timeout-budget: outlasts config.cpu_reacquire_budget_s
                timeout=config.cpu_reacquire_budget_s + 30.0),
        )
        self._q: queue.Queue = queue.Queue()
        # Named concurrency groups: each gets its own queue + executor
        # threads (a long call in one group never blocks another group's
        # methods).
        self._group_queues: dict[str, queue.Queue] = {}
        self._actor_instance = None
        self._actor_dead_cause: str | None = None
        self._actor_id: str | None = None
        # Threaded actors (max_concurrency > 1): method calls may not run
        # before the constructor finishes, and extra executor threads are
        # only spawned after it (so the ctor itself is never raced).
        self._actor_ready = threading.Event()
        self._lock = threading.Lock()
        # Cancellation registry: ids cancelled before they ran, and the
        # executor-thread ident of each currently running task (so a
        # cooperative cancel can target the right thread).
        self._cancels = CancelRegistry(threading.Lock())
        # Async actors (reference workerproc.py:137-148): one loop thread,
        # made at the first call; the in-flight coroutines' futures by
        # task id (for cancel); whether the hosted actor is async (set
        # after its constructor); and the completion queue, whose thread
        # stores results off the loop.
        self._aio_loop = None
        self._aio_lock = threading.Lock()
        self._async_futs: dict[str, object] = {}
        self._actor_is_async = False
        self._actor_device = None
        self._async_done_q: queue.Queue = queue.Queue()
        # Function-table cache: table key -> deserialized function
        # (bounded LRU).
        self._fn_cache: "collections.OrderedDict[str, object]" = (
            collections.OrderedDict())
        # Duplicate-delivery suppression for pushed calls (bounded,
        # insertion-ordered): a caller that loses the REPLY to a push
        # retries the same spec — same task id — against this
        # incarnation; accepting it twice would double side effects.
        self._seen_pushes: "collections.OrderedDict[str, bool]" = (
            collections.OrderedDict())
        # Task records waiting for the event flusher (keeps the task hot
        # path free of extra RPCs).
        self._ev_lock = threading.Lock()
        self._task_events: list = []
        self._log_lines: list = []
        # The flusher's resend queue, its sequence numbers, and the last
        # device snapshot's time. One shipment at a time: holding the lock
        # across the agent's RPC is its job (batches must reach the agent
        # in sequence order; the flusher, a traced call's end and the
        # agent's pre-kill flush are its only contenders).
        self._ship_lock = threading.Lock()  # analyze: allow-blocking
        self._unacked: "collections.deque" = collections.deque()
        self._ship_seq = 0
        self._last_dev_ship = 0.0
        sys.stdout = _TeeStream(sys.stdout, self._log_lines, self._ev_lock)
        sys.stderr = _TeeStream(sys.stderr, self._log_lines, self._ev_lock)
        threading.Thread(target=self._event_flush_loop, daemon=True).start()
        threading.Thread(target=self._agent_watchdog, daemon=True).start()
        threading.Thread(target=self._exec_loop, daemon=True).start()
        threading.Thread(target=self._async_done_loop, daemon=True).start()

    def _agent_watchdog(self):
        """Exit when the agent is gone (a worker whose raylet dies exits
        with it): the agent kills its workers on a clean stop, but when
        it dies abruptly nothing would reap us. ~3 s of failed pings."""
        fails = 0
        while True:
            time.sleep(0.25)
            try:
                self.agent.call("ping", timeout=5.0)
                fails = 0
            except Exception:
                _metrics.count_loop_restart("worker.agent_watchdog")
                fails += 1
                if fails >= 12:
                    os._exit(1)

    # -- observability -----------------------------------------------------

    def _record(self, spec, kind: str) -> dict:
        return {
            "task_id": spec.get("task_id") or spec.get("oids", ["?"])[0],
            "name": spec.get("fname") or spec.get("method")
            or spec.get("class_name", "task"),
            "type": kind,
            "state": "RUNNING",
            "submitted_at": spec.get("submitted_at"),
            "start_time": time.time(),
            "end_time": None,
            "error": None,
            # Wall-ns per execution phase, filled by a _PhaseClock.
            "phases": {},
        }

    def _finish(self, rec: dict, error: str | None) -> None:
        rec["state"] = "FAILED" if error else "FINISHED"
        rec["end_time"] = time.time()
        rec["error"] = error
        with self._ev_lock:
            self._task_events.append(rec)

    def _event_flush_loop(self):
        while True:
            time.sleep(0.25)
            try:
                self.flush_events()
            except Exception:
                _metrics.count_loop_restart("worker.event_flush")

    def flush_events(self) -> None:
        """Ship task records, captured log lines, spans (with the span
        buffer's drop count), goodput and Serve observations and, about once a
        second while CUDA is up here, a device snapshot to the agent:
        every 0.25 s from the flusher, and at the end of a traced call
        before its result is stored (so its spans reach the head before
        the caller can see the result and, say, kill this process). A
        batch whose reply was lost is resent under its ORIGINAL sequence
        number (the agent absorbs the replay, so a step is counted once);
        at most 8 wait, an evicted one's spans counted as dropped and its
        goodput and Serve observations put back in their buffers. The agent
        watchdog decides when the agent is gone."""
        from ray_tpu_torch.util import device_telemetry, tracing

        go = sys.modules.get("ray_tpu_torch.util.goodput")
        so = sys.modules.get("ray_tpu_torch.serve._observability")
        with self._ship_lock:
            with self._ev_lock:
                # Drained in place: the tee streams hold these lists.
                events = self._task_events[:]
                del self._task_events[:]
                lines = self._log_lines[:]
                del self._log_lines[:]
            spans = tracing.drain() if tracing.is_enabled() else []
            span_drops = tracing.drain_dropped()
            train = go.drain_events() if go is not None else []
            serve = so.drain_events() if so is not None else []
            device = None
            now = time.monotonic()
            if device_telemetry.cuda_initialized() \
                    and now - self._last_dev_ship >= 1.0:
                device = device_telemetry.snapshot()
                self._last_dev_ship = now
            if events or lines or spans or span_drops or train or serve \
                    or device is not None:
                self._ship_seq += 1
                self._unacked.append((self._ship_seq, events, lines, spans,
                                      device, train or None,
                                      span_drops or None, serve or None))
            while len(self._unacked) > 8:
                _, _, _, lost, _, lost_train, drops, lost_serve = \
                    self._unacked.popleft()
                tracing.requeue_dropped((drops or 0) + len(lost))
                if lost_train and go is not None:
                    go.requeue_events(lost_train)
                if lost_serve and so is not None:
                    so.requeue_events(lost_serve)
            while self._unacked:
                (seq, b_events, b_lines, b_spans, b_device, b_train,
                 b_drops, b_serve) = self._unacked[0]
                with tracing.suppressed():  # the upload records no spans
                    self.agent.call(
                        "worker_events", self.worker_id, os.getpid(),
                        b_events, b_lines, b_spans, b_device, b_train,
                        seq=seq, dropped=b_drops, serve=b_serve,
                        timeout=10.0)
                self._unacked.popleft()

    def rpc_flush_events(self):  # idempotent
        """Ship what the flusher holds now (the agent calls it before
        killing an actor's process)."""
        self.flush_events()
        return True

    def rpc_device_stats(self):  # idempotent (read-only)
        """This process's device snapshot (a stub while CUDA is not
        initialised here: the snapshot never creates a context)."""
        from ray_tpu_torch.util import device_telemetry

        return device_telemetry.snapshot()

    # -- the operator's RPCs: failpoints, chaos, stacks, profiles -----------

    def rpc_set_failpoints(self, specs: dict):
        """Arm/disarm failpoints in this process (the end of the head ->
        agent -> worker fan-out)."""
        return failpoints.set_failpoints(specs)

    def rpc_list_failpoints(self):  # idempotent (read-only)
        return failpoints.list_armed()

    def rpc_set_channel_chaos(self, rules: list, label: str = ""):
        from ray_tpu_torch.cluster.rpc import channel_chaos

        return channel_chaos.add_rule_dicts(rules, label)

    def rpc_clear_channel_chaos(self, label: str | None = None):
        from ray_tpu_torch.cluster.rpc import channel_chaos

        return channel_chaos.clear(label)

    def rpc_list_channel_chaos(self):  # idempotent (read-only)
        from ray_tpu_torch.cluster.rpc import channel_chaos

        return channel_chaos.describe()

    def rpc_dump_stack(self):  # idempotent (read-only)
        """Every thread's stack in this worker, now."""
        from ray_tpu_torch.util import stack_sampler

        return stack_sampler.dump_stacks(
            header=f"worker {self.worker_id} (pid {os.getpid()})")

    def rpc_profile(self, duration_s: float = 1.0,
                    interval_s: float = 0.01):
        """A time-sampled profile of this worker's threads (the RPC
        server runs a thread a connection, so the executor keeps running
        the task being profiled)."""
        from ray_tpu_torch.util import stack_sampler

        prof = stack_sampler.sample(duration_s, interval_s)
        prof["worker_id"] = self.worker_id
        return prof

    def rpc_capture_profile(self, duration_s: float, interval_s: float,
                            out_dir: str):
        """A timed profiler window over this worker (``torch.profiler``
        where CUDA is up here, else the stack sampler), its files written
        into ``out_dir`` (the agent's capture directory, on this host):
        only a manifest rides the reply."""
        from ray_tpu_torch.util import device_telemetry

        return device_telemetry.capture_to_dir(
            out_dir, float(duration_s), float(interval_s),
            worker_id=self.worker_id)

    # -- rpc surface (called by agent and by remote callers) ---------------

    def _is_duplicate_push(self, spec: dict) -> bool:
        """Record-and-test the spec's task id against pushes this process
        already accepted (at-most-once admission per incarnation)."""
        task_id = spec.get("task_id")
        if not task_id:
            return False
        with self._lock:
            if task_id in self._seen_pushes:
                return True
            self._seen_pushes[task_id] = True
            while len(self._seen_pushes) > 4096:
                self._seen_pushes.popitem(last=False)
        return False

    def rpc_push_task(self, spec: dict):  # idempotent
        if self._is_duplicate_push(spec):
            # Refused (False): the agent releases this dispatch's lease;
            # the first delivery owns the task's fate.
            return False
        self._q.put(("task", spec))
        return True

    def rpc_create_actor(self, spec: dict):
        self._actor_id = spec["actor_id"]
        # Group queues exist from the start so calls routed to a group
        # can never race the constructor.
        for group in (spec.get("concurrency_groups") or {}):
            self._group_queues[group] = queue.Queue()
        self._q.put(("actor_ctor", spec))
        return True

    def rpc_push_actor_task(self, spec: dict):  # idempotent
        if self._is_duplicate_push(spec):
            # The caller's retry after a lost reply: exactly-once
            # observable effect per incarnation.
            return True
        group = spec.get("concurrency_group")
        q = self._group_queues.get(group) if group else None
        if group and q is None:
            self._store_error(
                spec,
                TaskError(
                    spec.get("method", "actor_task"),
                    f"actor has no concurrency group {group!r}",
                    "no-such-group",
                ),
            )
            self._end_borrows(spec)
            return False
        (q or self._q).put(("actor_task", spec))
        return True

    def rpc_ping(self):  # idempotent (read-only)
        return "pong"

    def rpc_cancel_task(self, task_id: str, force: bool = False):
        """Cancel a task this worker holds. Queued: marked so the executor
        skips it and stores TaskCancelledError. Running: the class is
        injected into the executor thread (best-effort — delivery waits
        out any C-level block); a running coroutine is cancelled through
        its asyncio future (reference workerproc.py:477-482). ``force`` is
        handled by the agent killing the process; by the time it reaches
        us it degrades to cooperative.
        """
        with self._ev_lock:
            fut = self._async_futs.get(task_id)
        if fut is not None:
            return "running" if fut.cancel() else "queued"
        running = self._cancels.cancel(task_id, TaskCancelledError)
        return "running" if running else "queued"

    # -- execution ---------------------------------------------------------

    def _begin_cancellable(self, spec) -> bool:
        """Register this thread as the runner of ``spec``. Returns False if
        the task was already cancelled (caller must not run it)."""
        return self._cancels.begin(spec.get("task_id"), threading.get_ident())

    def _end_cancellable(self, spec) -> None:
        """Unregister; if a cancel raced with completion, clear the
        injected-but-undelivered exception so it cannot land on the NEXT
        task this thread runs."""
        self._cancels.end(spec.get("task_id"), threading.get_ident())

    def _store_cancelled(self, spec, rec: dict) -> None:
        name = spec.get("fname") or spec.get("method", "task")
        self._store_error(spec, TaskCancelledError(name))
        self._end_borrows(spec)
        rec["state"] = "CANCELLED"
        rec["end_time"] = time.time()
        with self._ev_lock:
            self._task_events.append(rec)

    def _flush_traced(self, spec) -> None:
        """A traced call's spans go to the agent before its result is
        stored (best-effort: the flusher retries what this misses)."""
        if spec.get("trace_ctx"):
            try:
                self.flush_events()
            except Exception:
                _metrics.count_loop_restart("worker.event_flush")

    @staticmethod
    def _run_span(spec, name: str, worker_id: str):
        """The ``run:`` span of a call submitted under a span: parented
        under the caller's context, so spans the call opens (a train
        loop's steps) join the caller's trace."""
        from ray_tpu_torch.util import tracing

        ctx = spec.get("trace_ctx")
        if not ctx:
            return nullcontext()
        tracing.enable()  # the caller traces: continue here
        return tracing.span(
            f"run:{name}",
            {"task_id": spec.get("task_id"), "worker_id": worker_id},
            parent=ctx)

    def _exec_loop(self, q: queue.Queue | None = None):
        q = q if q is not None else self._q
        while True:
            kind, spec = q.get()
            try:
                if kind == "task":
                    # finally: a late-delivered cancel injection escaping
                    # _run_task's handlers must not skip the lease release.
                    try:
                        self._run_task(spec)
                    finally:
                        self.agent.call("task_done", self.worker_id)
                elif kind == "actor_ctor":
                    self._run_actor_ctor(spec)
                elif kind == "actor_task":
                    self._run_actor_task(spec)
            except Exception:
                _metrics.count_loop_restart("worker.exec")
                traceback.print_exc()

    def _resolve_function(self, spec):
        """Function-table lookup (reference function_manager fetch +
        cache): specs carry a table key; the blob comes from the cluster
        KV once and the deserialized function is reused for every
        subsequent task with the same key."""
        h = spec["func_hash"]
        func = self._fn_cache.get(h)
        if func is None:
            blob = self.backend.head.call("kv_get", h)
            if blob is None:
                raise TaskError(
                    spec.get("fname", "task"),
                    f"function {h} missing from the cluster function table",
                    "fn-table-miss",
                )
            func = ser.loads(blob)
            self._fn_cache[h] = func
            if len(self._fn_cache) > 256:
                self._fn_cache.popitem(last=False)
        else:
            self._fn_cache.move_to_end(h)
        return func

    def _resolve(self, args, kwargs):
        # ONE batched get for all ref args.
        refs = [a for a in args if isinstance(a, ObjectRef)] + [
            v for v in kwargs.values() if isinstance(v, ObjectRef)
        ]
        if not refs:
            return list(args), dict(kwargs)
        # Argument pulls rank below the task's own gets (pull manager).
        with self.backend.pull_priority_override(self.backend.PULL_ARGS):
            values = iter(self.backend.get(refs))
        args = [next(values) if isinstance(a, ObjectRef) else a
                for a in args]
        kwargs = {
            k: next(values) if isinstance(v, ObjectRef) else v
            for k, v in kwargs.items()
        }
        return args, kwargs

    def _store_result(self, spec, result):
        oids, num_returns = spec["oids"], spec.get("num_returns", 1)
        if num_returns == "streaming":
            return self._store_stream(spec, result)
        if num_returns == 1:
            values = [result]
        else:
            values = list(result)
            if len(values) != num_returns:
                raise ValueError(
                    f"task declared num_returns={num_returns} but returned "
                    f"{len(values)}"
                )
        for oid, v in zip(oids, values):
            self.backend.put_with_id(oid, v, owner=spec.get("owner_addr"))

    def _store_stream(self, spec, result) -> None:
        """The generator protocol (reference workerproc.py:578-600): item i
        at return index i, stored as it is yielded, then a ``_StreamEnd``.
        A mid-stream failure is stored AT the failing index, where the
        consumer raises, and re-raised; the spec's oids are emptied first,
        so the generic error path cannot overwrite index 0, which may
        already hold an item. A retried task yields again under the same
        ids: an item an earlier attempt left in this node's store is kept
        (the consumer may have read it), never stored twice."""
        from ray_tpu_torch._native.shm_store import ObjectExistsError
        from ray_tpu_torch.core import ids
        from ray_tpu_torch.core.object_ref import _StreamEnd

        task_id = ids.task_of_object(spec["oids"][0])[0]
        spec["oids"] = []
        owner = spec.get("owner_addr")

        def put(i, value, is_error=False):
            try:
                self.backend.put_with_id(ids.object_id_for(task_id, i),
                                         value, is_error=is_error,
                                         owner=owner)
            except ObjectExistsError:
                pass

        i = 0
        try:
            for item in result:
                put(i, item)
                i += 1
            put(i, _StreamEnd())
        except BaseException as e:  # noqa: BLE001 — stored, re-raised
            name = spec.get("fname", "task")
            if isinstance(e, TaskCancelledError):
                # A cancel injects the bare class: name the task.
                err = TaskCancelledError(name)
            elif isinstance(e, (TaskError, ActorError)):
                err = e
            else:
                err = TaskError(name, traceback.format_exc(), repr(e))
            put(i, err, is_error=True)
            if err is not e and isinstance(err, TaskCancelledError):
                raise err from None
            raise

    def _store_error(self, spec, err: BaseException):
        for oid in spec["oids"]:
            self.backend.put_with_id(oid, err, is_error=True,
                                     owner=spec.get("owner_addr"))

    def _end_borrows(self, spec):
        """Release the task's arg borrows — AFTER flushing our own holder
        registrations, so a ref this task deserialized and kept can never
        be freed in the gap (borrower handoff ordering)."""
        if spec.get("borrowed") and spec.get("task_id"):
            self.backend.flush_refs()
            try:
                self.backend.head.call("ref_task_end", spec["task_id"])
            except Exception:
                pass

    def _store_exception(self, spec, name: str, e: BaseException) -> None:
        if isinstance(e, (TaskError, ActorError)):
            self._store_error(spec, e)
        else:
            self._store_error(
                spec, TaskError(name, traceback.format_exc(), repr(e)))

    def _run_task(self, spec):
        rec = self._record(spec, "NORMAL_TASK")
        if not self._begin_cancellable(spec):
            self._store_cancelled(spec, rec)
            return
        # Only plain tasks hold a per-task lease worth releasing while
        # blocked; actor lifetime resources stay held (reference semantics).
        self.backend._block_hooks = self._hooks
        err = None
        clock = _PhaseClock(rec["phases"])
        name = spec.get("fname", "task")
        try:
            func = self._resolve_function(spec)
            args, kwargs = ser.loads(spec["args"])
            args, kwargs = self._resolve(args, kwargs)
            clock.lap("get_args")
            # Inside the try: a raise is stored as the task's error.
            failpoints.hit("worker.execute.before")
            # Attribution context: puts made while the task runs (its
            # returns and nested puts) carry the creating task's name.
            with attribution.task_context(name, spec.get("callsite")):
                with self._run_span(spec, name, self.worker_id):
                    result = func(*args, **kwargs)
                clock.lap("execute")
                self._flush_traced(spec)
                self._store_result(spec, result)
                clock.lap("put_outputs")
                failpoints.hit("worker.execute.after")
        except BaseException as e:  # noqa: BLE001 — stored, not dropped
            err = repr(e)
            self._store_exception(spec, name, e)
        finally:
            # Nested so a cancel injection delivered INSIDE this finally
            # (the tiny window before _end_cancellable clears it) cannot
            # abort the remaining cleanup steps.
            try:
                self._end_cancellable(spec)
            finally:
                self.backend._block_hooks = None
                try:
                    self._end_borrows(spec)
                finally:
                    self._finish(rec, err)

    def _run_actor_ctor(self, spec):
        rec = self._record(spec, "ACTOR_CREATION_TASK")
        err = None
        clock = _PhaseClock(rec["phases"])
        sinfo = spec.get("sinfo") or {}
        if sinfo.get("capture"):
            # The group that captures this actor, for
            # get_current_placement_group() in its methods.
            self.backend.captured_pg_id = sinfo["pg_id"]
        try:
            cls = ser.loads(spec["func"])
            args, kwargs = ser.loads(spec["args"])
            args, kwargs = self._resolve(args, kwargs)
            clock.lap("get_args")
            with attribution.task_context(
                    spec.get("fname", "actor.__init__"),
                    spec.get("callsite")):
                self._actor_instance = cls(*args, **kwargs)
            clock.lap("execute")
        except BaseException as e:  # noqa: BLE001
            err = repr(e)
            self._actor_dead_cause = traceback.format_exc()
            try:
                self.agent.call(
                    "actor_ctor_failed", self._actor_id, self._actor_dead_cause
                )
            except Exception:
                pass
        finally:
            self._note_async_actor()
            self._end_borrows(spec)
            self._finish(rec, err)
            self._actor_ready.set()
            for _ in range(int(spec.get("max_concurrency", 1)) - 1):
                threading.Thread(target=self._exec_loop, daemon=True).start()
            for group, n in (spec.get("concurrency_groups") or {}).items():
                gq = self._group_queues[group]  # created at rpc_create_actor
                for _ in range(max(1, int(n))):
                    threading.Thread(
                        target=self._exec_loop, args=(gq,), daemon=True
                    ).start()

    def _note_async_actor(self) -> None:
        """After the constructor: an actor with any public coroutine
        method is async (reference workerproc.py:729-743; a class-level
        scan), and its loop thread will take the CUDA device current on
        this thread, where the constructor ran."""
        import asyncio
        import inspect

        inst = self._actor_instance
        if inst is None:
            return
        self._actor_is_async = any(
            asyncio.iscoroutinefunction(f) and not name.startswith("_")
            for name, f in inspect.getmembers(type(inst), inspect.isfunction))
        torch = sys.modules.get("torch")
        if self._actor_is_async and torch is not None \
                and torch.cuda.is_initialized():
            self._actor_device = torch.cuda.current_device()

    def _ensure_aio_loop(self):
        """The actor's event loop, on a thread of its own made at the
        first call (reference workerproc.py:755). The thread sets the
        actor's CUDA device before the loop runs anything: the current
        device belongs to a thread."""
        import asyncio

        with self._aio_lock:
            if self._aio_loop is None:
                loop = asyncio.new_event_loop()
                device = self._actor_device

                def run():
                    if device is not None:
                        sys.modules["torch"].cuda.set_device(device)
                    loop.run_forever()

                threading.Thread(target=run, daemon=True,
                                 name="actor-aio-loop").start()
                self._aio_loop = loop
        return self._aio_loop

    def _run_actor_task_async(self, spec, method):
        """A call of an async actor (reference workerproc.py:766-850):
        every method runs on the actor's one loop. A coroutine method
        interleaves with the others at its awaits; a sync method runs on
        the loop too, blocking it for its duration, so the actor's state
        keeps the loop's mutual exclusion. This thread only resolves the
        arguments and schedules the call; the completion thread stores
        the result (a blocking RPC must never stall the loop). The
        failpoint sites and the caller's trace context bracket the
        coroutine's body as they bracket a sync call's."""
        import asyncio

        from ray_tpu_torch.util import tracing

        rec = self._record(spec, "ACTOR_TASK")
        if not self._begin_cancellable(spec):
            self._store_cancelled(spec, rec)
            return
        task_id = spec.get("task_id")
        name = spec.get("method", "actor_task")
        clock = _PhaseClock(rec["phases"])
        run_span = None
        try:
            args, kwargs = ser.loads(spec["args"])
            args, kwargs = self._resolve(args, kwargs)
            clock.lap("get_args")
            failpoints.hit("worker.execute.before")
            if asyncio.iscoroutinefunction(getattr(method, "__func__",
                                                   method)):
                coro = method(*args, **kwargs)
            else:
                async def on_loop():
                    return method(*args, **kwargs)

                coro = on_loop()
            if spec.get("trace_ctx"):
                # A manual span: the loop's thread-local current span
                # would leak into the coroutines interleaved with this one.
                tracing.enable()
                run_span = tracing.start_span(
                    f"run:{name}", {"task_id": task_id,
                                    "worker_id": self.worker_id},
                    parent=spec["trace_ctx"])

            # The attribution rides the asyncio task's context: puts the
            # method makes attribute to it, and never to the coroutines
            # interleaved with it.
            async def attributed(inner=coro):
                with attribution.task_context(name, spec.get("callsite")):
                    return await inner

            fut = asyncio.run_coroutine_threadsafe(
                attributed(), self._ensure_aio_loop())
            if task_id:
                with self._ev_lock:
                    self._async_futs[task_id] = fut
        except BaseException as e:  # noqa: BLE001
            tracing.finish_span(run_span, f"ERROR: {type(e).__name__}")
            self._store_exception(spec, name, e)
            self._end_borrows(spec)
            self._finish(rec, repr(e))
            return
        finally:
            # The call is in _async_futs (or failed): a cancel now targets
            # its future, not this thread.
            self._end_cancellable(spec)

        def done(f):
            if task_id:
                with self._ev_lock:
                    self._async_futs.pop(task_id, None)
            if f.cancelled():
                tracing.finish_span(run_span, "CANCELLED")
                self._store_cancelled(spec, rec)
                return
            # Scheduling, the loop's queue and the coroutine: the call's
            # execute phase.
            clock.lap("execute")
            err = None
            try:
                exc = f.exception()
                tracing.finish_span(run_span, "OK" if exc is None
                                    else f"ERROR: {type(exc).__name__}")
                self._flush_traced(spec)
                if exc is not None:
                    raise exc
                with attribution.task_context(name, spec.get("callsite")):
                    self._store_result(spec, f.result())
                clock.lap("put_outputs")
                failpoints.hit("worker.execute.after")
            except BaseException as e:  # noqa: BLE001
                err = repr(e)
                self._store_exception(spec, name, e)
            finally:
                try:
                    self._end_borrows(spec)
                finally:
                    self._finish(rec, err)

        # A done callback fires on the loop thread: the completion thread
        # does the blocking bookkeeping.
        fut.add_done_callback(lambda f: self._async_done_q.put((done, f)))

    def _async_done_loop(self):
        while True:
            fn, fut = self._async_done_q.get()
            try:
                fn(fut)
            except Exception:
                _metrics.count_loop_restart("worker.async_done")
                traceback.print_exc()

    def _run_actor_task(self, spec):
        self._actor_ready.wait(timeout=300.0)
        inst = self._actor_instance
        if inst is not None and self._actor_is_async:
            m = getattr(inst, spec.get("method", ""), None)
            if m is not None:
                return self._run_actor_task_async(spec, m)
        rec = self._record(spec, "ACTOR_TASK")
        if not self._begin_cancellable(spec):
            self._store_cancelled(spec, rec)
            return
        err = None
        clock = _PhaseClock(rec["phases"])
        name = spec.get("method", "actor_task")
        try:
            if self._actor_instance is None:
                raise ActorError(
                    f"actor is dead: {self._actor_dead_cause or 'not constructed'}"
                )
            args, kwargs = ser.loads(spec["args"])
            args, kwargs = self._resolve(args, kwargs)
            clock.lap("get_args")
            failpoints.hit("worker.execute.before")
            method = getattr(self._actor_instance, spec["method"])
            with attribution.task_context(name, spec.get("callsite")):
                with self._run_span(spec, name, self.worker_id):
                    result = method(*args, **kwargs)
                clock.lap("execute")
                self._flush_traced(spec)
                self._store_result(spec, result)
                clock.lap("put_outputs")
                failpoints.hit("worker.execute.after")
        except BaseException as e:  # noqa: BLE001
            err = repr(e)
            self._store_exception(spec, name, e)
        finally:
            try:
                self._end_cancellable(spec)
            finally:
                try:
                    self._end_borrows(spec)
                finally:
                    self._finish(rec, err)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--head", required=True)
    parser.add_argument("--agent", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--store", required=True)
    parser.add_argument("--worker-id", required=True)
    args = parser.parse_args()

    handler = WorkerHandler(
        args.head, args.agent, args.node_id, args.store, args.worker_id
    )
    server = RpcServer(handler)
    handler.agent.call(
        "register_worker", args.worker_id, server.address,
        handler.backend.client_id,
    )
    threading.Event().wait()  # serve forever; the agent kills us


if __name__ == "__main__":
    main()
