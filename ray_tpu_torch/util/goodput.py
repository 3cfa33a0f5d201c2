"""Training goodput: per-step phases, step anatomy with MFU, and the
trainer's downtime ledger (the parts of ``ray_tpu/util/goodput.py`` the
train session, the trainer and the serving engine call).

Every observation is set straight into this process's registry
(``util/metrics``): the local backend runs train workers as threads of
this process, so its registry is the whole plane. The reference's ship
buffer to a cluster's node agents, its dataset-stage and iterator
families and its readers (``train_stats``, ``data_stats``) are left out.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

from ray_tpu_torch.util import metrics as _metrics

# Phases a training step decomposes into (the train histogram's phase
# tag values). ``step`` is the residual compute time between reports
# after data waits / checkpoint traffic are subtracted out.
STEP_PHASES = ("data_wait", "step", "report", "checkpoint_save",
               "checkpoint_restore")
# data_wait = input starvation, host = dispatch until the device runs,
# compute = the synced device wall, sync = barrier skew; together they
# partition the instrumented step's wall time.
ANATOMY_PHASES = ("data_wait", "host", "compute", "sync")
_NODE = "local"


def _tags(trial: str, rank: int) -> Dict[str, str]:
    return {"node_id": _NODE, "trial": str(trial), "rank": str(int(rank))}


def record_step(trial: str, rank: int, phases: Dict[str, float]) -> None:
    """One reported training step's phase breakdown for one rank. Also
    feeds the per-rank straggler gauge (retracted by ``retract_trial``)."""
    trial = str(trial)
    phases = {p: max(0.0, float(s)) for p, s in phases.items()
              if p in STEP_PHASES}
    for phase, sec in phases.items():
        _metrics.TRAIN_STEP_PHASE_SECONDS.observe(
            sec, tags={"node_id": _NODE, "trial": trial, "phase": phase})
    _metrics.TRAIN_REPORTS_TOTAL.inc(tags={"node_id": _NODE, "trial": trial})
    if "step" in phases:
        _metrics.TRAIN_RANK_STEP_SECONDS.set(phases["step"],
                                             tags=_tags(trial, rank))


def record_anatomy(trial: str, rank: int, phases: Dict[str, float],
                   mfu: Optional[float] = None) -> None:
    """One instrumented step's anatomy for one rank of ``trial``, and its
    MFU percent when a step cost is attached (per-rank gauges, retracted
    by ``retract_trial``)."""
    tags = _tags(trial, rank)
    for phase, sec in phases.items():
        if phase in ANATOMY_PHASES:
            _metrics.TRAIN_STEP_ANATOMY_SECONDS.set(
                max(0.0, float(sec)), tags={**tags, "phase": phase})
    if mfu is not None:
        _metrics.TRAIN_MFU_PERCENT.set(float(mfu), tags=tags)


def record_downtime(trial: str, cause: str, seconds: float) -> None:
    """Non-productive trial wall time attributed to a cause (the
    trainer's downtime ledger)."""
    _metrics.TRAIN_DOWNTIME_SECONDS.inc(
        max(0.0, float(seconds)),
        tags={"node_id": _NODE, "trial": str(trial), "cause": str(cause)})


class GoodputLedger:
    """Attributes every non-productive second of a trial's wall time to a
    cause ("failure": the reference's drain and preemption causes come
    with the cluster backend, ROADMAP A4b). Downtime opens when an attempt
    dies and closes at the NEXT attempt's first report -- the moment
    training is provably making progress again -- so restart cost (group
    placement, checkpoint restore) is all accounted, never unattributed
    wall time."""

    def __init__(self, trial: str = "train"):
        self.trial = trial
        self.t0 = time.monotonic()
        self.by_cause: Dict[str, float] = {}
        self.restarts = 0
        self._down_since: Optional[float] = None
        self._down_cause: Optional[str] = None
        self.rank_step_s: Dict[int, float] = {}

    def mark_down(self, cause: str) -> None:
        if self._down_since is None:
            self._down_since = time.monotonic()
            self._down_cause = cause

    def _close_interval(self, restarted: bool) -> None:
        if self._down_since is None:
            return
        dt = time.monotonic() - self._down_since
        cause = self._down_cause or "failure"
        self.by_cause[cause] = self.by_cause.get(cause, 0.0) + dt
        # A restart only counts when PROGRESS closed the interval -- a
        # trial that ends on a terminal failure never restarted.
        if restarted:
            self.restarts += 1
        self._down_since = None
        self._down_cause = None
        record_downtime(self.trial, cause, dt)

    def mark_progress(self) -> None:
        """Training is provably making progress again (a report was
        accepted): close an open downtime interval as a restart."""
        self._close_interval(restarted=True)

    def observe_report(self, msg: dict) -> None:
        self.mark_progress()
        phases = msg.get("phases") or {}
        if "step" in phases:
            self.rank_step_s[msg.get("rank", 0)] = phases["step"]

    def _view(self, extra_open: float) -> dict:
        wall = time.monotonic() - self.t0
        by_cause = {c: round(s, 3) for c, s in self.by_cause.items()}
        if extra_open > 0:
            cause = self._down_cause or "failure"
            by_cause[cause] = round(by_cause.get(cause, 0.0) + extra_open, 3)
        down = round(sum(by_cause.values()), 3)
        out: dict = {
            "wall_s": round(wall, 3),
            "downtime_s": down,
            "by_cause": by_cause,
            "restarts": self.restarts,
            "goodput_pct": round(100.0 * max(0.0, wall - down) / wall, 2)
            if wall > 0 else None,
        }
        if self.rank_step_s:
            out["rank_step_s"] = {
                r: round(s, 4) for r, s in sorted(self.rank_step_s.items())}
            fastest = min(self.rank_step_s.values())
            if fastest > 0:
                out["rank_skew"] = round(
                    max(self.rank_step_s.values()) / fastest, 3)
        return out

    def summary(self) -> dict:
        """Terminal rollup: the trial is over, so an interval still open
        is closed (attributed, not counted as a restart)."""
        self._close_interval(restarted=False)
        return self._view(0.0)


def retract_trial(trial: str) -> None:
    """Session stop: drop every per-rank series of ``trial`` (step time,
    MFU, anatomy phases) from this process's registry."""
    for fam in (_metrics.TRAIN_RANK_STEP_SECONDS, _metrics.TRAIN_MFU_PERCENT,
                _metrics.TRAIN_STEP_ANATOMY_SECONDS):
        for tags in fam.series():
            if tags.get("trial") == str(trial):
                fam.remove(tags=tags)
