"""Trial schedulers: early stopping + population-based training (port of
``ray_tpu/tune/schedulers.py``: ASHA :30, HyperBand :93, the median
stopping rule :142, PBT :178, each decision the reference's for the same
stream of results; PBT draws its donors and perturbations from its own
seeded ``random.Random``, as there).

Reference parity: ``python/ray/tune/schedulers/`` — FIFO,
AsyncHyperBand/ASHA (``async_hyperband.py``), median stopping rule
(``median_stopping_rule.py``), and PBT (``pbt.py``) exploit/explore.
"""

from __future__ import annotations

import random
from typing import Dict, List, Optional

CONTINUE = "CONTINUE"
STOP = "STOP"


class TrialScheduler:
    def on_trial_result(self, runner, trial, result: dict) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial, result: Optional[dict]) -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class ASHAScheduler(TrialScheduler):
    """Async successive halving: at each rung, stop trials below the top
    1/reduction_factor quantile of peers that reached the rung."""

    def __init__(
        self,
        metric: str = "score",
        mode: str = "max",
        max_t: int = 100,
        grace_period: int = 1,
        reduction_factor: int = 4,
        time_attr: str = "training_iteration",
    ):
        if mode not in ("max", "min"):
            raise ValueError("mode must be max|min")
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung value t -> {trial_id: recorded metric value at that rung}.
        # Each trial is recorded at most once per rung so rung populations
        # are peers-that-reached-the-rung, not per-iteration duplicates.
        self.rungs: Dict[int, Dict[str, float]] = {}
        t = grace_period
        while t < max_t:
            self.rungs[t] = {}
            t *= reduction_factor
        # Highest rung each trial has been recorded at (a trial never
        # late-records into a rung it already skipped past).
        self._trial_top: Dict[str, int] = {}

    def on_trial_result(self, runner, trial, result: dict) -> str:
        t = result.get(self.time_attr, 0)
        value = result.get(self.metric)
        if value is None:
            return CONTINUE
        if self.mode == "min":
            value = -value
        if t >= self.max_t:
            return STOP
        for rung_t in sorted(self.rungs, reverse=True):
            if t < rung_t:
                continue
            if self._trial_top.get(trial.trial_id, -1) >= rung_t:
                break  # already judged at (or above) this rung
            recorded = self.rungs[rung_t]
            # Cutoff from peers already at the rung, BEFORE recording
            # this trial (mirrors the async-successive-halving rule).
            cutoff = None
            if recorded:
                vals = sorted(recorded.values(), reverse=True)
                k = max(1, len(vals) // self.rf)
                cutoff = vals[k - 1]
            recorded[trial.trial_id] = value
            self._trial_top[trial.trial_id] = rung_t
            if cutoff is not None and value < cutoff:
                return STOP
            break
        return CONTINUE


class HyperBandScheduler(TrialScheduler):
    """HyperBand (Li et al. 2017): several successive-halving brackets with
    different exploration/exploitation trade-offs run side by side; new
    trials deal round-robin into brackets, each bracket stops trials below
    its top-1/eta quantile at its rung milestones.

    Async-bracket formulation (the reference's
    ``schedulers/async_hyperband.py`` with ``brackets=N``; its synchronous
    ``hyperband.py`` blocks rungs on stragglers — deliberately avoided
    here, same trade-off the reference recommends): bracket s has grace
    period max_t * eta^-s, so s=0 never early-stops and higher s cut
    earlier and more aggressively.
    """

    def __init__(self, metric: str = "score", mode: str = "max",
                 max_t: int = 81, eta: int = 3, brackets: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.brackets = [
            ASHAScheduler(
                metric=metric, mode=mode, max_t=max_t,
                grace_period=max(1, int(max_t * eta ** -s)),
                reduction_factor=eta, time_attr=time_attr,
            )
            for s in range(brackets)
        ]
        self._assignment: Dict[str, int] = {}
        self._next = 0

    def _bracket_for(self, trial) -> "ASHAScheduler":
        b = self._assignment.get(trial.trial_id)
        if b is None:
            b = self._assignment[trial.trial_id] = (
                self._next % len(self.brackets))
            self._next += 1
        return self.brackets[b]

    def on_trial_result(self, runner, trial, result: dict) -> str:
        return self._bracket_for(trial).on_trial_result(
            runner, trial, result)

    def on_trial_complete(self, runner, trial, result) -> None:
        if trial.trial_id in self._assignment:
            self._bracket_for(trial).on_trial_complete(
                runner, trial, result)


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose running mean is below the median of completed
    means at the same step."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self.histories: Dict[str, List[float]] = {}

    def on_trial_result(self, runner, trial, result: dict) -> str:
        value = result.get(self.metric)
        t = result.get(self.time_attr, 0)
        if value is None or t < self.grace:
            return CONTINUE
        if self.mode == "min":
            value = -value
        hist = self.histories.setdefault(trial.trial_id, [])
        hist.append(value)
        means = [
            sum(h) / len(h)
            for tid, h in self.histories.items()
            if tid != trial.trial_id and h
        ]
        if len(means) < self.min_samples:
            return CONTINUE
        means.sort()
        median = means[len(means) // 2]
        mine = sum(hist) / len(hist)
        return STOP if mine < median else CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT: every ``perturbation_interval`` results, bottom-quantile trials
    exploit (copy checkpoint + config of) a top-quantile trial, then
    explore (perturb hyperparameters) and restart from that checkpoint.

    The runner performs the actual restart (see TrialRunner._pbt_exploit).
    """

    def __init__(
        self,
        metric: str = "score",
        mode: str = "max",
        perturbation_interval: int = 4,
        hyperparam_mutations: Optional[dict] = None,
        quantile_fraction: float = 0.25,
        time_attr: str = "training_iteration",
        seed: Optional[int] = None,
    ):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.time_attr = time_attr
        self.last_perturb: Dict[str, int] = {}
        self.latest: Dict[str, float] = {}
        self.rng = random.Random(seed)

    def _score(self, result) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return -v if self.mode == "min" else v

    def on_trial_result(self, runner, trial, result: dict) -> str:
        score = self._score(result)
        if score is not None:
            self.latest[trial.trial_id] = score
        t = result.get(self.time_attr, 0)
        if t - self.last_perturb.get(trial.trial_id, 0) < self.interval:
            return CONTINUE
        self.last_perturb[trial.trial_id] = t
        ranked = sorted(self.latest.items(), key=lambda kv: kv[1])
        n = len(ranked)
        if n < 2:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = {tid for tid, _ in ranked[:k]}
        top = [tid for tid, _ in ranked[-k:]]
        if trial.trial_id in bottom:
            donor_id = self.rng.choice(top)
            if donor_id != trial.trial_id:
                runner._pbt_exploit(trial, donor_id, self)
        return CONTINUE

    def perturb_config(self, config: dict) -> dict:
        out = dict(config)
        for key, mutation in self.mutations.items():
            if callable(mutation):
                out[key] = mutation()
            elif isinstance(mutation, list):
                out[key] = self.rng.choice(mutation)
            elif isinstance(mutation, tuple) and len(mutation) == 2:
                lo, hi = mutation
                factor = self.rng.choice([0.8, 1.2])
                out[key] = min(hi, max(lo, out.get(key, lo) * factor))
        return out
