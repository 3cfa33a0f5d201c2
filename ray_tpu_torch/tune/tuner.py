"""Tuner / tune.run: the user-facing experiment API (port of
``ray_tpu/tune/tuner.py``).

Reference parity: ``python/ray/tune/tuner.py:44,239`` (Tuner.fit ->
ResultGrid), ``tune/tune.py:131`` (tune.run), with trainers runnable as
trainables (``Trainer.fit`` wraps itself into a 1-trial experiment,
``train/base_trainer.py:339-363`` — here the composition goes the other
way: a Tuner can run a DataParallelTrainer factory per trial).

What differs from the JAX module, and why: ``with_resources`` returns a
``_WithResources`` object, not a closure (``ray_tpu/tune/tuner.py:338``).
The port's functions travel to a worker by reference
(``core/serialization.py``), and a closure cannot; the object is a plain
module-level class whose only contents are the trainable (which travels
by reference) and its resources. A remote experiment's local mirror is
under ``~/.ray_tpu_torch/mirrors``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.tune.schedulers import TrialScheduler
from ray_tpu_torch.tune.search_space import generate_variants
from ray_tpu_torch.tune.trial_runner import ERROR, TERMINATED, Trial, TrialRunner


@dataclass
class TuneConfig:
    metric: Optional[str] = None
    mode: str = "max"
    num_samples: int = 1
    max_concurrent_trials: int = 8
    scheduler: Optional[TrialScheduler] = None
    # Ask/tell search algorithm (reference tune.TuneConfig.search_alg);
    # None = the BasicVariant grid x random expansion.
    search_alg: Optional[Any] = None
    seed: Optional[int] = None


@dataclass
class TrialResult:
    trial_id: str
    config: dict
    metrics: Optional[dict]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException]
    metrics_history: List[dict] = field(default_factory=list)


class ResultGrid:
    def __init__(self, results: List[TrialResult],
                 default_metric: Optional[str], default_mode: str):
        self._results = results
        self._metric = default_metric
        self._mode = default_mode

    def __len__(self):
        return len(self._results)

    def __getitem__(self, i):
        return self._results[i]

    def __iter__(self):
        return iter(self._results)

    @property
    def errors(self) -> List[BaseException]:
        return [r.error for r in self._results if r.error is not None]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> TrialResult:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required (none set in TuneConfig)")
        candidates = [
            r for r in self._results
            if r.metrics is not None and metric in r.metrics
        ]
        if not candidates:
            raise ValueError(f"no trial reported metric {metric!r}")
        key = lambda r: r.metrics[metric]
        return max(candidates, key=key) if mode == "max" else min(candidates, key=key)

    def get_dataframe(self):
        import pandas as pd

        rows = []
        for r in self._results:
            row = {"trial_id": r.trial_id, **{f"config/{k}": v for k, v in r.config.items()}}
            row.update(r.metrics or {})
            rows.append(row)
        return pd.DataFrame(rows)


class Tuner:
    def __init__(
        self,
        trainable: Callable,
        *,
        param_space: Optional[Dict[str, Any]] = None,
        tune_config: Optional[TuneConfig] = None,
        run_config: Optional[RunConfig] = None,
        resources_per_trial: Optional[dict] = None,
    ):
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources_per_trial = resources_per_trial
        self._restored_trials: Optional[List[Trial]] = None

    def experiment_dir(self) -> Optional[str]:
        """Where experiment state snapshots live LOCALLY (None = no
        persistence): RunConfig(storage_path=...)/[name]. A remote
        ``storage_path`` URI (``file://``, ``s3://``) persists to a local
        mirror that the Syncer pushes up (reference tune/syncer.py:185)."""
        local, _uri = self._storage()
        return local

    def _storage(self):
        """(local_experiment_dir, remote_uri_or_None)."""
        import hashlib
        import os

        sp = self.run_config.storage_path
        if not sp:
            return None, None
        name = self.run_config.name or "experiment"
        from ray_tpu_torch.tune.syncer import is_remote_uri

        if is_remote_uri(sp):
            uri = sp.rstrip("/") + "/" + name
            mirror = os.path.join(
                os.path.expanduser("~/.ray_tpu_torch/mirrors"),
                hashlib.sha1(uri.encode()).hexdigest()[:12], name)
            return mirror, uri
        return os.path.join(sp, name), None

    @classmethod
    def restore(cls, path: str, trainable: Callable,
                *, param_space: Optional[Dict[str, Any]] = None,
                tune_config: Optional[TuneConfig] = None,
                run_config: Optional[RunConfig] = None,
                resources_per_trial: Optional[dict] = None) -> "Tuner":
        """Resume a crashed/interrupted experiment from its state
        snapshots (reference ``Tuner.restore(path, trainable)``):
        finished trials keep their results, errored trials keep their
        error, unfinished ones restart from their last persisted
        checkpoint when ``fit()`` is called. Pass ``tune_config`` to
        continue a search_alg-driven experiment (un-suggested samples are
        generated with the restored results replayed into the searcher);
        metric/mode default to the persisted values."""
        import copy
        import json
        import os
        import pickle

        from ray_tpu_torch.tune.syncer import get_syncer, is_remote_uri

        restore_uri = None
        if is_remote_uri(path):
            # Pull the synced experiment down into the deterministic
            # mirror dir, then restore from there; fit() keeps syncing
            # up to the same URI.
            import hashlib

            restore_uri = path.rstrip("/")
            name = os.path.basename(restore_uri)
            local = os.path.join(
                os.path.expanduser("~/.ray_tpu_torch/mirrors"),
                hashlib.sha1(restore_uri.encode()).hexdigest()[:12], name)
            if not get_syncer(restore_uri).sync_down(restore_uri, local):
                raise FileNotFoundError(
                    f"nothing to restore at {restore_uri}")
            path = local
        else:
            path = os.path.abspath(path)
        state_file = os.path.join(path, "experiment_state.json")
        with open(state_file) as f:
            state = json.load(f)
        from ray_tpu_torch.tune.trial_runner import ERROR, PENDING, TERMINATED

        trials: List[Trial] = []
        for rec in state["trials"]:
            t = Trial(rec["config"] if not rec.get("lossy") else {},
                      rec.get("resources"))
            t.trial_id = rec["trial_id"]
            t.last_result = rec.get("last_result")
            if t.last_result:
                t.metrics_history = [t.last_result]
            t.num_failures = rec.get("num_failures", 0)
            ckpt_file = rec.get("checkpoint_file")
            if ckpt_file and os.path.exists(ckpt_file):
                with open(ckpt_file, "rb") as f:
                    t.checkpoint = Checkpoint.from_dict(pickle.load(f))
            status = rec.get("status")
            if status == ERROR or rec.get("lossy"):
                # Keep the failure (or the un-round-trippable config)
                # visible instead of re-running or masquerading as done.
                t.status = ERROR
                t.error = RuntimeError(
                    rec.get("error")
                    or "config could not be restored losslessly")
            elif status == TERMINATED:
                t.status = TERMINATED
            else:
                t.status = PENDING  # re-runs from its checkpoint
            trials.append(t)
        meta = state.get("meta") or {}
        if tune_config is None:
            tune_config = TuneConfig(
                metric=meta.get("metric"),
                mode=meta.get("mode") or "max",
                num_samples=int(meta.get("num_samples") or len(trials)),
            )
        if restore_uri is not None:
            storage_root, name = restore_uri.rsplit("/", 1)
        else:
            storage_root, name = os.path.split(path.rstrip(os.sep))
        rc = copy.copy(run_config) if run_config is not None \
            else RunConfig()
        rc.storage_path = storage_root
        rc.name = name
        tuner = cls(trainable, param_space=param_space,
                    tune_config=tune_config, run_config=rc,
                    resources_per_trial=resources_per_trial)
        tuner._restored_trials = trials
        return tuner

    def fit(self) -> ResultGrid:
        from ray_tpu_torch.tune.stopper import coerce_stopper

        resources = self.resources_per_trial or getattr(
            self.trainable, "_tune_resources", None)
        searcher = self.tune_config.search_alg
        if self._restored_trials is not None:
            trials = self._restored_trials
            if searcher is not None:
                # Continue the search: replay finished trials into the
                # ask/tell state, then let the runner request the
                # remaining num_samples suggestions.
                searcher.set_search_properties(
                    self.tune_config.metric, self.tune_config.mode,
                    self.param_space)
                from ray_tpu_torch.tune.trial_runner import TERMINATED as _T

                if getattr(searcher, "expands_variants", False):
                    # Variant-expanding searchers pre-deal a fixed set:
                    # consume one variant per restored trial so resume
                    # deals only what was never created, instead of
                    # re-running the whole grid as duplicates.
                    for t in trials:
                        searcher.suggest(t.trial_id)
                for t in trials:
                    if t.status == _T and t.last_result:
                        # tell(), not on_trial_complete(): these ids were
                        # never suggest()-ed by THIS searcher instance.
                        searcher.tell(t.config, t.last_result)
        elif searcher is not None:
            ok = searcher.set_search_properties(
                self.tune_config.metric, self.tune_config.mode,
                self.param_space)
            if not ok:
                raise ValueError(
                    "search_alg was constructed with its own space/metric; "
                    "pass param_space/metric only in one place")
            trials: List[Trial] = []
        else:
            variants = generate_variants(
                self.param_space,
                num_samples=self.tune_config.num_samples,
                seed=self.tune_config.seed,
            )
            trials = [Trial(cfg, resources) for cfg in variants]
        local_dir, sync_uri = self._storage()
        sync = None
        if sync_uri:
            from ray_tpu_torch.tune.syncer import _PeriodicSync, get_syncer

            sync = _PeriodicSync(get_syncer(sync_uri), local_dir, sync_uri)
        runner = TrialRunner(
            self.trainable,
            trials,
            scheduler=self.tune_config.scheduler,
            max_concurrent=self.tune_config.max_concurrent_trials,
            max_failures=self.run_config.failure_config.max_failures,
            stopper=coerce_stopper(self.run_config.stop),
            searcher=searcher,
            num_samples=self.tune_config.num_samples,
            trial_resources=resources,
            experiment_dir=local_dir,
            sync=sync,
        )
        runner.experiment_meta = {
            "metric": self.tune_config.metric,
            "mode": self.tune_config.mode,
            "num_samples": self.tune_config.num_samples,
        }
        runner.run()
        trials = runner.trials
        results = [
            TrialResult(
                t.trial_id, t.config, t.last_result, t.checkpoint, t.error,
                t.metrics_history,
            )
            for t in trials
        ]
        return ResultGrid(results, self.tune_config.metric, self.tune_config.mode)


def run(
    trainable: Callable,
    *,
    config: Optional[dict] = None,
    num_samples: int = 1,
    scheduler: Optional[TrialScheduler] = None,
    metric: Optional[str] = None,
    mode: str = "max",
    max_concurrent_trials: int = 8,
    **_kw,
) -> ResultGrid:
    """Legacy ``tune.run`` entry point (``tune/tune.py:131``)."""
    return Tuner(
        trainable,
        param_space=config,
        tune_config=TuneConfig(
            metric=metric, mode=mode, num_samples=num_samples,
            scheduler=scheduler, max_concurrent_trials=max_concurrent_trials,
        ),
    ).fit()


class _WithResources:
    """A trainable with its per-trial resources attached (what
    ``with_resources`` returns). Calling it calls the trainable. It
    pickles as its two attributes, so it reaches a worker wherever its
    trainable does: by reference to a module-level function."""

    def __init__(self, trainable, resources: dict):
        self._trainable = trainable
        self._tune_resources = dict(resources)
        self.__wrapped__ = trainable
        for attr in ("__name__", "__qualname__", "__doc__"):
            if hasattr(trainable, attr):
                setattr(self, attr, getattr(trainable, attr))

    def __call__(self, *a, **kw):
        return self._trainable(*a, **kw)


def with_resources(trainable, resources: dict):
    """Attach per-trial resource requests to a trainable (reference
    ``tune.with_resources``): ``{"CPU": 2, "GPU": 0.5}`` or a
    placement-group shape ``{"bundles": [...], "strategy": "PACK"}``.
    Always returns a NEW wrapper — re-wrapping never mutates a trainable
    another experiment may still be holding."""
    return _WithResources(trainable, resources)
