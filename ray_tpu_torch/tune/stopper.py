"""Stoppers: declarative trial-stop conditions (port of
``ray_tpu/tune/stopper.py``; reference ``python/ray/tune/stopper/``).
Attach via ``RunConfig(stop=...)`` — a Stopper instance, a ``{metric: threshold}`` dict (stop when
``result[metric] >= threshold``), or a callable
``(trial_id, result) -> bool``."""

from __future__ import annotations

import collections
import statistics
from typing import Callable, Dict


class Stopper:
    def __call__(self, trial_id: str, result: dict) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        """True = terminate the whole experiment, not just one trial."""
        return False


class MaximumIterationStopper(Stopper):
    def __init__(self, max_iter: int):
        self._max_iter = max_iter

    def __call__(self, trial_id: str, result: dict) -> bool:
        return result.get("training_iteration", 0) >= self._max_iter


class TrialPlateauStopper(Stopper):
    """Stop a trial whose metric stopped moving: std of the last
    ``num_results`` values <= ``std`` (reference trial_plateau shape)."""

    def __init__(self, metric: str, *, std: float = 0.01,
                 num_results: int = 4, grace_period: int = 4):
        self._metric = metric
        self._std = std
        self._num_results = num_results
        self._grace = grace_period
        self._window: Dict[str, collections.deque] = {}
        self._count: Dict[str, int] = {}

    def __call__(self, trial_id: str, result: dict) -> bool:
        if self._metric not in result:
            return False
        w = self._window.setdefault(
            trial_id, collections.deque(maxlen=self._num_results))
        w.append(float(result[self._metric]))
        self._count[trial_id] = self._count.get(trial_id, 0) + 1
        if self._count[trial_id] < self._grace or \
                len(w) < self._num_results:
            return False
        return statistics.pstdev(w) <= self._std


class FunctionStopper(Stopper):
    def __init__(self, fn: Callable[[str, dict], bool]):
        self._fn = fn

    def __call__(self, trial_id: str, result: dict) -> bool:
        return bool(self._fn(trial_id, result))


class CombinedStopper(Stopper):
    def __init__(self, *stoppers: Stopper):
        self._stoppers = stoppers

    def __call__(self, trial_id: str, result: dict) -> bool:
        return any(s(trial_id, result) for s in self._stoppers)

    def stop_all(self) -> bool:
        return any(s.stop_all() for s in self._stoppers)


def coerce_stopper(stop) -> Stopper | None:
    """RunConfig(stop=...) accepts Stopper | dict | callable | None."""
    if stop is None or isinstance(stop, Stopper):
        return stop
    if isinstance(stop, dict):
        conditions = dict(stop)

        def check(_tid, result):
            return any(
                m in result and result[m] >= v
                for m, v in conditions.items()
            )

        return FunctionStopper(check)
    if callable(stop):
        return FunctionStopper(stop)
    raise TypeError(f"stop must be a Stopper, dict, or callable; got "
                    f"{type(stop).__name__}")
