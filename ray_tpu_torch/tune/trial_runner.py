"""Trial + TrialRunner: the Tune execution event loop (port of
``ray_tpu/tune/trial_runner.py``).

Reference parity: ``python/ray/tune/execution/trial_runner.py:319,961`` —
the step loop asks the variant generator for configs, starts trials as
actors (``RayTrialExecutor``), consumes reported results, applies
scheduler decisions (ASHA stop / PBT exploit), retries failed trials from
their last checkpoint, and tracks per-trial checkpoints.

Function trainables run the user function inside the trial actor and
report through the shared queue (``trainable/function_trainable.py:126``).

What differs from the JAX module, and why:

* **Resources.** A trial's ``"GPU"`` (flat, or in its gang's bundle 0)
  becomes the actor's ``num_gpus``, fractions included, where the
  reference maps ``"TPU"`` to ``num_tpus`` (:283-297); there is no TPU
  key. The trial's session carries its device (``session.get_device()``):
  ``cuda`` for a trial that holds a GPU, the CPU otherwise.
* **An infeasible trial ends in ERROR.** A flat demand no node can meet
  (``{"GPU": 1}`` where no node has a GPU) makes the actor's creation
  raise; the trial ends in ``ERROR`` with that error, as an infeasible
  gang does (:270-279), where the reference lets the raise end ``fit``.
  It never runs on the CPU instead.
* ``_json_default`` also turns a 0-d torch tensor into its number.
* On the cluster backend the results queue's actor imports, as the
  trials start, the modules a report's unpickling will need
  (``_preload_queue``), as the trainer's queue does.
* The trial actor carries its gang: it is placed with
  ``placement_group_capture_child_tasks``, and on both backends
  ``get_current_placement_group()`` inside it names the trial's group, so
  a ``CudaTrainer`` run in the trial puts its workers in the gang's other
  bundles (``train/trainer.py WorkerGroup``).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict, List, Optional

import torch

import ray_tpu_torch
from ray_tpu_torch.core.object_ref import ActorError, TaskError
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune.schedulers import STOP, FIFOScheduler
from ray_tpu_torch.util.queue import Queue

PENDING = "PENDING"
RUNNING = "RUNNING"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class Trial:
    _counter = 0

    def __init__(self, config: dict, resources: Optional[dict] = None):
        Trial._counter += 1
        self.trial_id = f"trial_{Trial._counter:05d}_{os.urandom(2).hex()}"
        self.config = dict(config)
        # Flat dict ({"CPU": 1}) or a gang spec
        # ({"bundles": [{...}, ...], "strategy": "PACK"}): gang trials
        # reserve a placement group atomically, so two multi-bundle
        # trials can never deadlock each other by each grabbing half
        # (reference: tune/execution/placement_groups.py
        # PlacementGroupFactory).
        self.resources = resources or {"CPU": 1}
        self.pg = None  # PlacementGroup handle for gang trials
        self.status = PENDING
        self.last_result: Optional[dict] = None
        self.metrics_history: List[dict] = []
        self.checkpoint: Optional[Checkpoint] = None
        self.error: Optional[BaseException] = None
        self.num_failures = 0
        self.generation = 0  # bumped on restart; stale reports are dropped
        self.actor = None
        self.run_ref = None
        self.version = 0  # monotonic dirty counter, see __setattr__
        # Downtime ledger (the trainer's accounting, shared
        # implementation): opened when an attempt fails, closed at the
        # restarted attempt's first accepted report.
        from ray_tpu_torch.util.goodput import GoodputLedger

        self.ledger = GoodputLedger(self.trial_id)

    def mark_down(self, cause: str) -> None:
        self.ledger.mark_down(cause)

    def close_downtime(self) -> None:
        self.ledger.mark_progress()

    def goodput(self) -> dict:
        """Per-trial goodput % — a NON-mutating read (an open downtime
        interval shows in the view but stays open for the eventual
        recovery to attribute)."""
        return self.ledger.snapshot()

    # Persisted fields bump a monotonic version so the snapshot change
    # signature never relies on id() — a fresh object at a GC-reused
    # address would otherwise compare equal and skip a real state change
    # (advisor r4).
    _VERSIONED = frozenset(
        {"status", "last_result", "checkpoint", "num_failures", "error"})

    def __setattr__(self, name, value):
        object.__setattr__(self, name, value)
        if name in Trial._VERSIONED:
            object.__setattr__(self, "version",
                               getattr(self, "version", 0) + 1)

    def __repr__(self):
        return f"Trial({self.trial_id}, {self.status})"


class _TrialActor:
    """Actor hosting one trial's function trainable."""

    def run(self, train_fn, config, session_kwargs):
        session_mod.init_session(**session_kwargs)
        try:
            train_fn(config)
        finally:
            q = session_kwargs["results_queue"]
            q.put({
                "type": "finished",
                "trial_info": session_kwargs.get("trial_info"),
            })
            session_mod.shutdown_session()
        return True


class TrialRunner:
    def __init__(
        self,
        trainable: Callable,
        trials: List[Trial],
        *,
        scheduler=None,
        max_concurrent: int = 8,
        max_failures: int = 0,
        stopper=None,
        searcher=None,
        num_samples: int = 0,
        trial_resources: Optional[dict] = None,
        experiment_dir: Optional[str] = None,
        sync=None,
    ):
        self.trainable = trainable
        self.trials = trials
        self.by_id: Dict[str, Trial] = {t.trial_id: t for t in trials}
        self.scheduler = scheduler or FIFOScheduler()
        self.max_concurrent = max_concurrent
        self.max_failures = max_failures
        self.stopper = stopper  # RunConfig(stop=...) condition
        # Ask/tell search (reference searcher.py:21): when set, trials are
        # created lazily — suggest() sees completed results before it
        # proposes the next config (model-based search needs that).
        self.searcher = searcher
        self.num_samples = num_samples
        self.trial_resources = trial_resources
        # Experiment persistence (reference experiment_state snapshots):
        # a changed trial state rewrites <dir>/experiment_state.json so
        # Tuner.restore can resume unfinished trials after a crash.
        self.experiment_dir = experiment_dir
        # Optional syncer driver (tune/syncer.py _PeriodicSync): pushes
        # the persisted experiment dir to remote storage, throttled
        # during the run + unconditionally at the end.
        self.sync = sync
        self.experiment_meta: dict = {}  # metric/mode etc., persisted too
        self._persisted_sig = None
        # Pinned to the driver's node: the shared results queue riding a
        # node a drain/preemption takes would masquerade as a
        # drain-caused failure of EVERY trial wired to it — retried
        # exempt, forever (see queue.driver_node_options).
        from ray_tpu_torch.util.queue import driver_node_options

        self.queue = Queue(actor_options=driver_node_options())
        self._preload_queue(trials)
        self._actor_cls = ray_tpu_torch.remote(_TrialActor)

    def _preload_queue(self, trials: List[Trial]) -> None:
        """On the cluster backend the queue's actor process unpickles
        every report, whose ``trial_info`` carries the trial's config: the
        first report would make it import the modules of the config's
        values (a model config: torch, seconds) and of a checkpoint while
        the trial waits on its put. It imports them now, as the trials
        start (not waited on: the actor runs its calls in order)."""
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.core.local_backend import LocalBackend

        if isinstance(worker_mod.backend(), LocalBackend):
            return
        mods = {"ray_tpu_torch.train.checkpoint"}
        for t in trials:
            for v in t.config.values():
                mod = getattr(type(v), "__module__", None) or "builtins"
                if mod != "builtins":
                    mods.add(mod)
        self.queue.actor.preload.remote(sorted(mods))

    # -- experiment persistence -------------------------------------------

    @staticmethod
    def _json_default(o):
        import numpy as np

        if isinstance(o, np.generic):
            return o.item()
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(o, torch.Tensor) \
                and o.dim() == 0:
            return o.item()
        raise TypeError(type(o).__name__)

    def _persist(self) -> None:
        if not self.experiment_dir:
            return
        sig = tuple((t.trial_id, t.version) for t in self.trials)
        if sig == self._persisted_sig:
            return  # nothing changed since the last snapshot
        import json
        import pickle

        os.makedirs(self.experiment_dir, exist_ok=True)
        records = []
        for t in self.trials:
            ckpt_file = None
            if t.checkpoint is not None:
                ckpt_file = os.path.join(
                    self.experiment_dir, f"ckpt_{t.trial_id}.pkl")
                if getattr(t, "_persisted_ckpt", None) is t.checkpoint \
                        and os.path.exists(ckpt_file):
                    pass  # unchanged since last snapshot
                else:
                    try:
                        with open(ckpt_file + ".tmp", "wb") as f:
                            pickle.dump(t.checkpoint.to_dict(), f)
                        os.replace(ckpt_file + ".tmp", ckpt_file)
                        t._persisted_ckpt = t.checkpoint
                    except Exception:
                        ckpt_file = None  # unserializable (e.g. dead ref)
            rec = {
                "trial_id": t.trial_id,
                "config": t.config,
                "status": t.status,
                "last_result": t.last_result,
                "num_failures": t.num_failures,
                "checkpoint_file": ckpt_file,
                "resources": t.resources,
                "error": repr(t.error) if t.error is not None else None,
            }
            try:
                json.dumps(rec, default=self._json_default)
            except TypeError:
                # Exotic values (beyond numpy scalars) can't round-trip:
                # mark the record so restore refuses to re-run it with a
                # corrupted config instead of silently stringifying.
                rec["config"] = repr(t.config)
                rec["last_result"] = None
                rec["lossy"] = True
            records.append(rec)
        tmp = os.path.join(self.experiment_dir, "experiment_state.tmp")
        with open(tmp, "w") as f:
            json.dump({"trials": records, "meta": self.experiment_meta},
                      f, default=self._json_default)
        os.replace(
            tmp, os.path.join(self.experiment_dir,
                              "experiment_state.json"))
        self._persisted_sig = sig
        if self.sync is not None:
            try:
                self.sync.maybe_sync()
            except Exception:
                pass  # remote hiccup must not kill the experiment

    def _maybe_create_trial(self) -> Optional[Trial]:
        if self.searcher is None:
            return None
        # Variant-expanding searchers (grid x num_samples) own their trial
        # budget: run them until suggest() returns None. Capping those at
        # num_samples would silently drop grid variants (advisor r4).
        if (not getattr(self.searcher, "expands_variants", False)
                and len(self.trials) >= self.num_samples):
            return None
        trial = Trial({}, self.trial_resources)
        cfg = self.searcher.suggest(trial.trial_id)
        if cfg is None:
            return None  # exhausted, or waiting on results
        trial.config = cfg
        self.trials.append(trial)
        self.by_id[trial.trial_id] = trial
        return trial

    # -- lifecycle of one trial -------------------------------------------

    def _start_trial(self, trial: Trial) -> bool:
        """Try to start a trial. Returns False when its gang placement
        group is not reserved yet (the event loop retries on its next
        tick — starting must never block the loop, or a finished trial's
        PG removal could never be processed: deadlock)."""
        bundles = trial.resources.get("bundles")
        opts: dict
        if bundles:
            from ray_tpu_torch.util.placement_group import (
                placement_group,
                placement_group_table,
                remove_placement_group,
            )
            from ray_tpu_torch.util.scheduling_strategies import (
                PlacementGroupSchedulingStrategy,
            )

            if trial.pg is None:
                trial.pg = placement_group(
                    bundles, trial.resources.get("strategy", "PACK"),
                    name=trial.trial_id,
                )
            state = (placement_group_table(trial.pg) or {}).get("state")
            if state == "INFEASIBLE":
                remove_placement_group(trial.pg)
                trial.pg = None
                trial.status = ERROR
                trial.error = ValueError(
                    f"trial gang {bundles} is infeasible on this cluster"
                )
                return True  # handled (terminally)
            if state != "CREATED":
                return False  # PG pending: the event loop retries
            # Demand exactly what bundle 0 provides (default 0, not 1: a
            # CPU-less bundle, e.g. GPU-only, could never grant CPU).
            opts = {
                "num_cpus": bundles[0].get("CPU", 0),
                "scheduling_strategy": PlacementGroupSchedulingStrategy(
                    placement_group=trial.pg,
                    placement_group_bundle_index=0,
                    placement_group_capture_child_tasks=True,
                ),
            }
            gpus = bundles[0].get("GPU", 0)
        else:
            opts = {"num_cpus": trial.resources.get("CPU", 1)}
            gpus = trial.resources.get("GPU", 0)
        if gpus:
            opts["num_gpus"] = gpus
        trial.generation += 1
        session_kwargs = {
            "world_rank": 0,
            "world_size": 1,
            "local_rank": 0,
            "node_rank": 0,
            "results_queue": self.queue,
            "checkpoint": trial.checkpoint,
            "dataset_shards": {},
            "trial_info": {
                "trial_id": trial.trial_id,
                "generation": trial.generation,
                "config": trial.config,
            },
            "device": torch.device("cuda" if gpus else "cpu"),
        }
        try:
            trial.actor = self._actor_cls.options(**opts).remote()
        except ValueError as e:
            # An infeasible demand (e.g. a GPU where no node has one): the
            # trial ends here, and nothing runs it anywhere else.
            self._stop_actor(trial)
            trial.status = ERROR
            trial.error = e
            return True
        trial.run_ref = trial.actor.run.remote(
            self.trainable, trial.config, session_kwargs
        )
        trial.status = RUNNING
        return True

    def _stop_actor(self, trial: Trial, keep_pg: bool = False):
        if trial.actor is not None:
            try:
                ray_tpu_torch.kill(trial.actor)
            except Exception:
                pass
        trial.actor = None
        trial.run_ref = None
        if trial.pg is not None and not keep_pg:
            # Release the gang reservation so the next pending trial's
            # placement group can commit. Drain/preemption-exempt
            # restarts KEEP it: the head is migrating its bundles
            # (RESCHEDULING -> CREATED on healthy nodes), and the
            # retried trial re-enters the same reservation instead of
            # re-queuing a fresh gang behind everyone else.
            from ray_tpu_torch.util.placement_group import remove_placement_group

            try:
                remove_placement_group(trial.pg)
            except Exception:
                pass
            trial.pg = None

    def _pbt_exploit(self, trial: Trial, donor_id: str, scheduler) -> None:
        """Exploit+explore: adopt a perturbed copy of the donor's config and
        restart from the donor's checkpoint (``pbt.py`` _exploit)."""
        donor = self.by_id.get(donor_id)
        if donor is None or donor.checkpoint is None:
            return
        self._stop_actor(trial)
        trial.config = scheduler.perturb_config(donor.config)
        trial.checkpoint = donor.checkpoint
        trial.status = PENDING  # the event loop restarts it

    # -- event loop --------------------------------------------------------

    def run(self) -> List[Trial]:
        try:
            while True:
                running = [t for t in self.trials if t.status == RUNNING]
                pending = [t for t in self.trials if t.status == PENDING]
                # A gang trial waiting on its PG occupies a concurrency
                # slot too — otherwise every pending trial would create
                # (and possibly commit) a PG up front, hoarding cluster
                # resources far beyond max_concurrent.
                slots = len(running)
                while (slots + len(pending) < self.max_concurrent):
                    t = self._maybe_create_trial()
                    if t is None:
                        break
                    pending.append(t)
                for t in pending:
                    if slots >= self.max_concurrent:
                        break
                    started = self._start_trial(t)
                    if started and t.status == RUNNING:
                        running.append(t)
                        slots += 1
                    elif not started:
                        slots += 1  # PG pending: holds its slot
                if not running and not any(
                        t.status == PENDING for t in self.trials):
                    # With a searcher, idle + no new suggestion means the
                    # search is exhausted (suggest() already saw every
                    # completed result).
                    break
                self._drain_queue()
                self._poll_completions()
                self._persist()
        finally:
            self._persist()
            if self.sync is not None:
                try:
                    self.sync.final()
                except Exception:
                    pass
            for t in self.trials:
                self._stop_actor(t)
            self.queue.shutdown()
        return self.trials

    def _notify_searcher_complete(self, trial, result, error=False):
        if self.searcher is not None:
            self.searcher.on_trial_complete(
                trial.trial_id, result, error=error)

    def _drain_queue(self):
        try:
            msg = self.queue.get(timeout=0.2)
        except Exception:
            return
        while True:
            self._handle_message(msg)
            try:
                msg = self.queue.get(block=False)
            except Exception:
                return

    def _handle_message(self, msg: dict):
        info = msg.get("trial_info") or {}
        trial = self.by_id.get(info.get("trial_id", ""))
        if trial is None or msg["type"] != "report":
            return
        if info.get("generation") != trial.generation or trial.status != RUNNING:
            return  # stale report from a superseded attempt
        trial.close_downtime()  # a report proves progress again
        result = dict(msg["metrics"])
        result.setdefault("training_iteration", msg["iteration"])
        trial.last_result = result
        trial.metrics_history.append(result)
        if self.searcher is not None:
            self.searcher.on_trial_result(trial.trial_id, result)
        if msg["checkpoint"] is not None:
            trial.checkpoint = msg["checkpoint"]
        if self.stopper is not None and self.stopper(
                trial.trial_id, result):
            self._stop_actor(trial)
            trial.status = TERMINATED
            self.scheduler.on_trial_complete(self, trial, result)
            self._notify_searcher_complete(trial, result)
            if self.stopper.stop_all():
                for t in self.trials:
                    if t.status in (RUNNING, PENDING):
                        self._stop_actor(t)
                        t.status = TERMINATED
                        self.scheduler.on_trial_complete(
                            self, t, t.last_result or {})
                        self._notify_searcher_complete(t, t.last_result)
            return
        decision = self.scheduler.on_trial_result(self, trial, result)
        if decision == STOP:
            self._stop_actor(trial)
            trial.status = TERMINATED
            self.scheduler.on_trial_complete(self, trial, result)
            self._notify_searcher_complete(trial, result)

    def _drain_all_nowait(self):
        while True:
            try:
                msg = self.queue.get(block=False)
            except Exception:
                return
            self._handle_message(msg)

    def _poll_completions(self):
        for trial in self.trials:
            if trial.status != RUNNING or trial.run_ref is None:
                continue
            ready, _ = ray_tpu_torch.wait([trial.run_ref], num_returns=1, timeout=0)
            if not ready:
                continue
            # All of this attempt's reports were enqueued before run()
            # returned — apply them before completing the trial.
            self._drain_all_nowait()
            if trial.status != RUNNING:
                continue  # a drained report stopped it
            try:
                ray_tpu_torch.get(trial.run_ref)
            except (ActorError, TaskError) as e:
                from ray_tpu_torch.util import goodput as _goodput

                cause = _goodput.downtime_cause(e)
                trial.mark_down(cause)
                # Retry-budget exemption, extended from actors to gangs
                # (the PR-2 discipline): a trial lost to a planned
                # drain / preemption restarts WITHOUT consuming
                # max_failures, and a gang trial keeps its placement
                # group — the head is rescheduling its bundles onto
                # healthy nodes, so the retry waits for the SAME
                # reservation to come back instead of burning it.
                exempt = cause == "preemption" or cause.startswith("drain")
                if not exempt:
                    trial.num_failures += 1
                if exempt or trial.num_failures <= self.max_failures:
                    # Retry from the last checkpoint; back to PENDING so
                    # the event loop restarts it (a gang trial may need
                    # to wait for its new PG without blocking the loop).
                    self._stop_actor(trial, keep_pg=exempt)
                    trial.status = PENDING
                    continue
                trial.status = ERROR
                trial.error = e
                self._stop_actor(trial)
                self.scheduler.on_trial_complete(self, trial, None)
                self._notify_searcher_complete(trial, None, error=True)
                continue
            trial.status = TERMINATED
            self._stop_actor(trial)
            self.scheduler.on_trial_complete(self, trial, trial.last_result)
            self._notify_searcher_complete(trial, trial.last_result)
