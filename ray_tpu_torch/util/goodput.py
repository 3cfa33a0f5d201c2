"""Training goodput and the input-pipeline plane: per-step phases, step
anatomy with MFU, the trainer's downtime ledger, and the data library's
stage, iterator, block-split and actor-pool observations (the parts of
``ray_tpu/util/goodput.py`` the train session, the trainer, the serving
engine and the data library call).

Every observation is set straight into this process's registry
(``util/metrics``): the local backend runs train workers and data tasks
as threads of this process, so its registry is the whole plane; on the
cluster backend each worker process records into its own. The
reference's ship buffer to a cluster's node agents and ``train_stats``
are left out. ``data_stats`` and ``stall_fraction_from`` read the
exposition back: the derived **stall fraction** (wait / (wait + user)
over the iterator phase histograms) is the input pipeline's health
number.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

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
# Phases of one consumer-loop batch (the data iterator histogram's phase
# tag values): wait = consumer starved for the next batch, user =
# consumer's own time between batches, transfer = host->device dispatch
# inside ``iter_device_batches``.
ITER_PHASES = ("wait", "user", "transfer")
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
    cause ("failure": the reference's drain and preemption causes are
    left out with the cluster's drain, ROADMAP A4c). Downtime opens when an attempt
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


# -- the input pipeline (the data library records these) --------------------


def record_stage(stage: str, wall_s: float,
                 blocks: Optional[List[Tuple[Optional[float], int, int]]]
                 = None) -> None:
    """One executed dataset stage: total wall seconds plus per-block
    (duration_s, rows, bytes) samples; a duration of None (actor-pool
    stages) observes the sizes only."""
    tags = {"node_id": _NODE, "stage": str(stage)}
    _metrics.DATA_STAGE_SECONDS.observe(float(wall_s), tags=tags)
    for dur, rows, nbytes in blocks or ():
        if dur is not None:
            _metrics.DATA_BLOCK_SECONDS.observe(float(dur), tags=tags)
        _metrics.DATA_BLOCK_ROWS.observe(float(rows), tags=tags)
        _metrics.DATA_BLOCK_BYTES.observe(float(nbytes), tags=tags)


def record_block_split(stage: str, n_splits: int) -> None:
    """A stage task split one oversized output block into ``n_splits``
    extra blocks."""
    if n_splits > 0:
        _metrics.DATA_BLOCK_SPLITS.inc(
            float(n_splits), tags={"node_id": _NODE, "stage": str(stage)})


def record_pool_size(pool: str, size: int, queue_depth: int) -> None:
    """An autoscaling dataset actor pool changed size (or reports its
    terminal size): the pool-size / queue-depth gauges."""
    tags = {"node_id": _NODE, "pool": str(pool)}
    _metrics.DATA_POOL_SIZE.set(float(size), tags=tags)
    _metrics.DATA_POOL_QUEUE_DEPTH.set(float(queue_depth), tags=tags)


def record_iter_batch(wait_s: Optional[float] = None,
                      user_s: Optional[float] = None,
                      transfer_s: Optional[float] = None,
                      occupancy: Optional[int] = None) -> None:
    """One consumer-loop batch: starvation wait vs consumer time (plus
    host->device dispatch seconds and the prefetch-buffer occupancy the
    consumer observed). Only the phases given are observed: an
    unmeasured phase must not count a zero."""
    for phase, sec in (("wait", wait_s), ("user", user_s),
                       ("transfer", transfer_s)):
        if sec is not None:
            _metrics.DATA_ITER_SECONDS.observe(
                max(0.0, float(sec)), tags={"node_id": _NODE, "phase": phase})
    if occupancy is not None:
        _metrics.DATA_PREFETCH_OCCUPANCY.observe(
            float(occupancy), tags={"node_id": _NODE})


def _dist_summary(dist: Optional[dict]) -> Optional[dict]:
    if not dist:
        return None
    out = {"count": int(dist["count"]),
           "sum_s": round(dist["sum"], 6),
           "mean_ms": round(dist["sum"] / dist["count"] * 1e3, 3)}
    for q, key in ((0.50, "p50_ms"), (0.99, "p99_ms")):
        v = _metrics.quantile_from_buckets(dist, q)
        out[key] = round(v * 1e3, 3) if v is not None else None
    return out


def stall_fraction_from(parsed: dict) -> Optional[float]:
    """Metrics-derived stall fraction: wait seconds / (wait + user)
    summed over the iterator histograms of ``parsed`` (a
    ``parse_prometheus`` result, or a ``diff_parsed`` of two). None until
    a consumer loop has recorded at least one batch."""
    wait = _metrics.histogram_dist(parsed, "ray_tpu_data_iter_seconds",
                                   phase="wait")
    user = _metrics.histogram_dist(parsed, "ray_tpu_data_iter_seconds",
                                   phase="user")
    if not wait or not user:
        return None
    denom = wait["sum"] + user["sum"]
    if denom <= 0:
        return None
    return wait["sum"] / denom


def data_stats(parsed: Optional[dict] = None) -> dict:
    """Input-pipeline rollup from this process's registry (or from
    ``parsed``): per-stage wall and per-block distributions,
    consumer-loop wait/user/transfer, prefetch occupancy, and the
    derived stall fraction."""
    if parsed is None:
        parsed = _metrics.parse_prometheus(_metrics.prometheus_text())
    stages: dict = {}
    stage_names = set(_metrics.sum_counter(
        parsed, "ray_tpu_data_stage_seconds_count", "stage"))
    for name in sorted(n for n in stage_names if n):
        entry: dict = {}
        wall = _metrics.histogram_dist(
            parsed, "ray_tpu_data_stage_seconds", stage=name)
        if wall:
            entry["executions"] = int(wall["count"])
            entry["wall_ms"] = round(wall["sum"] * 1e3, 3)
        blk = _metrics.histogram_dist(
            parsed, "ray_tpu_data_block_seconds", stage=name)
        if blk:
            entry["blocks"] = int(blk["count"])
            entry["block_seconds"] = _dist_summary(blk)
        rows = _metrics.histogram_dist(
            parsed, "ray_tpu_data_block_rows", stage=name)
        if rows:
            entry["rows_total"] = int(rows["sum"])
        nbytes = _metrics.histogram_dist(
            parsed, "ray_tpu_data_block_bytes", stage=name)
        if nbytes:
            entry["bytes_total"] = int(nbytes["sum"])
            if wall and wall["sum"] > 0:
                entry["bytes_per_s"] = round(nbytes["sum"] / wall["sum"])
        stages[name] = entry
    out: dict = {"stages": stages}
    iterator: dict = {}
    for phase in ITER_PHASES:
        d = _metrics.histogram_dist(parsed, "ray_tpu_data_iter_seconds",
                                    phase=phase)
        if d:
            iterator[phase] = _dist_summary(d)
    occ = _metrics.histogram_dist(parsed, "ray_tpu_data_prefetch_occupancy")
    if occ:
        iterator["occupancy"] = {
            "samples": int(occ["count"]),
            "mean": round(occ["sum"] / occ["count"], 3),
        }
    if iterator:
        out["iterator"] = iterator
    sf = stall_fraction_from(parsed)
    if sf is not None:
        out["stall_fraction"] = round(sf, 4)
    return out
