"""Training goodput and the input-pipeline plane: per-step phases, step
anatomy with MFU, the trainer's downtime ledger, and the data library's
stage, iterator, block-split and actor-pool observations (port of
``ray_tpu/util/goodput.py``).

Recording is two-sided, as in the reference: every observation lands in
this process's registry at once (the local backend runs train workers
and data tasks as threads of this process, so its registry is the whole
plane), and is queued in a bounded ship buffer that a cluster worker's
event flusher drains into its event batch (``drain_events``; a failed
upload puts them back, ``requeue_events``). The node agent replays each
batch once -- a resent batch is absorbed by its sequence number -- into
its own registry under its node id (``apply_events``), the registry the
head federates on ``/metrics/cluster``, and retracts the per-rank gauges
a worker's events made when that worker dies (``retract_gauges``).

Readers: ``data_stats`` and ``train_stats`` over ``scrape_text`` (the
cluster's federated exposition merged with this process's registry;
series identity dedups an in-process cluster's shared registry), the
derived **stall fraction** (wait / (wait + user) over the iterator phase
histograms) and ``straggler_attribution`` (the slowest rank of a gang
and the phase that carries its excess).
"""

from __future__ import annotations

import collections
import threading
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
# The slowest rank's excess classified by the phase that carries it.
ANATOMY_CAUSES = {"data_wait": "input-bound", "host": "compute-bound",
                  "compute": "compute-bound", "sync": "sync-bound"}
# Phases of one consumer-loop batch (the data iterator histogram's phase
# tag values): wait = consumer starved for the next batch, user =
# consumer's own time between batches, transfer = host->device dispatch
# inside ``iter_device_batches``.
ITER_PHASES = ("wait", "user", "transfer")
_NODE = "local"
# Ship buffer drained by a worker's event flusher; bounded so a process
# nothing drains (the local backend's driver) stays flat.
_buf: "collections.deque" = collections.deque(maxlen=8192)
_buf_lock = threading.Lock()
_buf_dropped = 0


def _emit(ev: dict) -> None:
    """Observe into this process's registry and queue for the agent."""
    global _buf_dropped
    apply_events([ev], node_id=_NODE)
    with _buf_lock:
        if len(_buf) == _buf.maxlen:
            _buf_dropped += 1  # the deque discards the oldest
        _buf.append(ev)


def drain_events() -> List[dict]:
    """Pop the queued observations (a worker's event flusher). A
    preceding overflow leads as a drop event, so the agent's registry
    counts what this process lost."""
    global _buf_dropped
    with _buf_lock:
        out = list(_buf)
        _buf.clear()
        if _buf_dropped:
            out.insert(0, {"k": "drop", "n": _buf_dropped})
            _buf_dropped = 0
    return out


def requeue_events(events: List[dict]) -> None:
    """Put drained observations back at the FRONT of the ship buffer (an
    upload the flusher gave up on); past the capacity the oldest count
    as dropped."""
    global _buf_dropped
    if not events:
        return
    with _buf_lock:
        space = _buf.maxlen - len(_buf)
        if space < len(events):
            _buf_dropped += len(events) - space
            events = events[len(events) - space:]
        _buf.extendleft(reversed(events))


def record_step(trial: str, rank: int, phases: Dict[str, float]) -> None:
    """One reported training step's phase breakdown for one rank. Also
    feeds the per-rank straggler gauge (retracted with the trial, or
    with the worker on a cluster)."""
    phases = {p: max(0.0, float(s)) for p, s in phases.items()
              if p in STEP_PHASES}
    _emit({"k": "step", "t": str(trial), "r": int(rank), "p": phases})


def record_anatomy(trial: str, rank: int, phases: Dict[str, float],
                   mfu: Optional[float] = None) -> None:
    """One instrumented step's anatomy for one rank of ``trial``, and its
    MFU percent when a step cost is attached (per-rank gauges)."""
    phases = {p: max(0.0, float(s)) for p, s in phases.items()
              if p in ANATOMY_PHASES}
    ev: dict = {"k": "anat", "t": str(trial), "r": int(rank), "p": phases}
    if mfu is not None:
        ev["m"] = float(mfu)
    _emit(ev)


def record_downtime(trial: str, cause: str, seconds: float) -> None:
    """Non-productive trial wall time attributed to a cause (the
    trainer's downtime ledger: restart/drain/preemption)."""
    _emit({"k": "down", "t": str(trial), "c": str(cause),
           "s": max(0.0, float(seconds))})


def downtime_cause(exc: BaseException) -> str:
    """Classify a trial-interrupting failure into a downtime-ledger
    cause: the HEAD-generated drain formats ("node <id> died: drained:
    <reason>" / "node <id> draining: ...") and the trainer's
    proactive-preemption restart map to planned causes; everything else
    is a plain failure."""
    import re

    s = str(exc)
    m = re.search(r"died: drained: ([\w.-]+)", s)
    if m:
        return f"drain:{m.group(1)}"
    if re.search(r"node \S+ draining:", s):
        return "drain"
    if "Preempted" in type(exc).__name__:
        return "preemption"
    return "failure"


def straggler_attribution(rank_phases: Dict[str, Dict[str, float]],
                          min_excess_frac: float = 0.05
                          ) -> Optional[dict]:
    """Name the slowest rank of a gang and classify its excess as
    input-bound, compute-bound or sync-bound. ``rank_phases`` maps rank
    -> anatomy phase seconds. The slowest rank has the most *own work*
    (everything but ``sync``: in lockstep every rank's wall is the same
    and the barrier wait is what differs). Its excess over the median of
    the other ranks goes to the phase with the largest delta against
    that median; below ``min_excess_frac`` of the baseline the gang is
    ``balanced``."""
    if not rank_phases or len(rank_phases) < 2:
        return None

    def own(p: Dict[str, float]) -> float:
        return sum(v for k, v in p.items() if k != "sync")

    totals = {r: own(p) for r, p in rank_phases.items()}
    slowest = max(totals, key=lambda r: totals[r])
    rest = sorted(t for r, t in totals.items() if r != slowest)
    baseline = rest[len(rest) // 2]
    excess = totals[slowest] - baseline
    out = {"rank": slowest, "own_s": round(totals[slowest], 6),
           "baseline_s": round(baseline, 6),
           "excess_s": round(max(0.0, excess), 6)}
    if baseline > 0 and excess < min_excess_frac * baseline:
        out["cause"] = "balanced"
        return out
    deltas = {}
    for phase in ANATOMY_PHASES:
        others = sorted(rank_phases[r].get(phase, 0.0)
                        for r in rank_phases if r != slowest)
        med = others[len(others) // 2] if others else 0.0
        deltas[phase] = rank_phases[slowest].get(phase, 0.0) - med
    worst_phase = max(deltas, key=lambda p: deltas[p])
    out["phase"] = worst_phase
    out["cause"] = ANATOMY_CAUSES[worst_phase]
    return out


def attribution_ok(goodput: dict) -> Tuple[bool, bool]:
    """The ledger-contract check every preemption harness shares:
    ``(planned, sums)`` — *planned* is True when every ``by_cause`` key
    is a planned cause (``preemption`` / ``reschedule`` /
    ``drain:<reason>`` / ``drain``), *sums* when the causes sum exactly
    (1e-6) to ``downtime_s``."""
    by_cause = goodput.get("by_cause") or {}
    planned = all(
        c in ("preemption", "reschedule") or c.startswith("drain")
        for c in by_cause)
    sums = abs(sum(by_cause.values())
               - (goodput.get("downtime_s") or 0.0)) < 1e-6
    return planned, sums


class GoodputLedger:
    """Attributes every non-productive second of a trial's wall time to a
    cause (``drain:<reason>`` / ``drain``, ``preemption``, ``reschedule``
    or ``failure``, see ``downtime_cause``). Downtime opens when an attempt
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

    def snapshot(self) -> dict:
        """Non-mutating read (``ray_tpu/util/goodput.py:370``): an OPEN
        downtime interval is included in the view (up to now) but stays
        open, so a poll can never swallow downtime that the eventual
        recovery should attribute. A Tune trial's ``goodput()``."""
        open_s = (time.monotonic() - self._down_since) \
            if self._down_since is not None else 0.0
        return self._view(open_s)

    def summary(self) -> dict:
        """Terminal rollup: the trial is over, so an interval still open
        is closed (attributed, not counted as a restart)."""
        self._close_interval(restarted=False)
        return self._view(0.0)


def retract_trial(trial: str, node_id: str = _NODE) -> None:
    """Session stop: drop every per-rank series of ``trial`` (step time,
    MFU, anatomy phases) from this process's registry. On a cluster the
    agent's copies go when the worker dies (``retract_gauges``)."""
    retract_gauges([("trial", str(trial))], node_id)


# -- replay (the node agent, and this process's own registry) ---------------


def apply_events(events: List[dict], node_id: str) -> List[Tuple]:
    """Replay shipped observations into THIS process's registry under
    ``node_id`` (the node agent calls this with its node id). Returns the gauge keys the batch touched, so
    the agent can retract them when the worker dies."""
    gauge_keys: List[Tuple] = []
    for ev in events or []:
        try:
            kind = ev.get("k")
            if kind == "stage":
                tags = {"node_id": node_id, "stage": ev.get("s", "")}
                _metrics.DATA_STAGE_SECONDS.observe(
                    float(ev.get("w", 0.0)), tags=tags)
                for dur, rows, nbytes in ev.get("b") or ():
                    if dur is not None:
                        _metrics.DATA_BLOCK_SECONDS.observe(float(dur),
                                                            tags=tags)
                    _metrics.DATA_BLOCK_ROWS.observe(float(rows), tags=tags)
                    _metrics.DATA_BLOCK_BYTES.observe(float(nbytes),
                                                      tags=tags)
            elif kind == "it":
                for phase, sec in (ev.get("p") or {}).items():
                    if phase in ITER_PHASES:
                        _metrics.DATA_ITER_SECONDS.observe(
                            float(sec),
                            tags={"node_id": node_id, "phase": phase})
                if ev.get("occ") is not None:
                    _metrics.DATA_PREFETCH_OCCUPANCY.observe(
                        float(ev["occ"]), tags={"node_id": node_id})
            elif kind == "step":
                trial = ev.get("t", "train")
                rank = str(ev.get("r", 0))
                phases = ev.get("p") or {}
                for phase, sec in phases.items():
                    _metrics.TRAIN_STEP_PHASE_SECONDS.observe(
                        float(sec), tags={"node_id": node_id,
                                          "trial": trial, "phase": phase})
                _metrics.TRAIN_REPORTS_TOTAL.inc(
                    tags={"node_id": node_id, "trial": trial})
                if "step" in phases:
                    _metrics.TRAIN_RANK_STEP_SECONDS.set(
                        float(phases["step"]),
                        tags={"node_id": node_id, "trial": trial,
                              "rank": rank})
                    gauge_keys.append(("rank", trial, rank))
            elif kind == "anat":
                trial = ev.get("t", "train")
                rank = str(ev.get("r", 0))
                for phase, sec in (ev.get("p") or {}).items():
                    if phase in ANATOMY_PHASES:
                        _metrics.TRAIN_STEP_ANATOMY_SECONDS.set(
                            float(sec),
                            tags={"node_id": node_id, "trial": trial,
                                  "phase": phase, "rank": rank})
                if ev.get("m") is not None:
                    _metrics.TRAIN_MFU_PERCENT.set(
                        float(ev["m"]),
                        tags={"node_id": node_id, "trial": trial,
                              "rank": rank})
                gauge_keys.append(("anat", trial, rank))
            elif kind == "down":
                _metrics.TRAIN_DOWNTIME_SECONDS.inc(
                    float(ev.get("s", 0.0)),
                    tags={"node_id": node_id,
                          "trial": ev.get("t", "train"),
                          "cause": ev.get("c", "failure")})
            elif kind == "split":
                _metrics.DATA_BLOCK_SPLITS.inc(
                    float(ev.get("n", 0)),
                    tags={"node_id": node_id, "stage": ev.get("s", "")})
            elif kind == "pool":
                pool = ev.get("s", "")
                tags = {"node_id": node_id, "pool": pool}
                _metrics.DATA_POOL_SIZE.set(float(ev.get("n", 0)), tags=tags)
                _metrics.DATA_POOL_QUEUE_DEPTH.set(float(ev.get("q", 0)),
                                                   tags=tags)
                gauge_keys.append(("pool", pool))
            elif kind == "drop":
                _metrics.TRAIN_EVENTS_DROPPED.inc(
                    float(ev.get("n", 0)), tags={"node_id": node_id})
        except Exception:
            continue  # one bad event must not drop the batch
    return gauge_keys


def retract_gauges(keys, node_id: str) -> None:
    """Drop the gauge children a dead worker's events created (the
    federated scrape must not keep reporting a dead rank's step time);
    ``("trial", name)`` sweeps every per-rank child of a trial."""
    for key in keys or ():
        try:
            if key[0] == "rank":
                _metrics.TRAIN_RANK_STEP_SECONDS.remove(tags={
                    "node_id": node_id, "trial": key[1], "rank": key[2]})
            elif key[0] == "anat":
                for phase in ANATOMY_PHASES:
                    _metrics.TRAIN_STEP_ANATOMY_SECONDS.remove(tags={
                        "node_id": node_id, "trial": key[1],
                        "phase": phase, "rank": key[2]})
                _metrics.TRAIN_MFU_PERCENT.remove(tags={
                    "node_id": node_id, "trial": key[1], "rank": key[2]})
            elif key[0] == "trial":
                for fam in (_metrics.TRAIN_RANK_STEP_SECONDS,
                            _metrics.TRAIN_MFU_PERCENT,
                            _metrics.TRAIN_STEP_ANATOMY_SECONDS):
                    for tags in fam.series():
                        if tags.get("trial") == key[1]:
                            fam.remove(tags=tags)
            elif key[0] == "pool":
                tags = {"node_id": node_id, "pool": key[1]}
                _metrics.DATA_POOL_SIZE.remove(tags=tags)
                _metrics.DATA_POOL_QUEUE_DEPTH.remove(tags=tags)
        except Exception:
            pass


# -- the input pipeline (the data library records these) --------------------


def record_stage(stage: str, wall_s: float,
                 blocks: Optional[List[Tuple[Optional[float], int, int]]]
                 = None) -> None:
    """One executed dataset stage: total wall seconds plus per-block
    (duration_s, rows, bytes) samples; a duration of None (actor-pool
    stages) observes the sizes only."""
    ev: dict = {"k": "stage", "s": str(stage), "w": float(wall_s)}
    if blocks:
        ev["b"] = [(None if d is None else float(d), int(r), int(n))
                   for d, r, n in blocks]
    _emit(ev)


def record_block_split(stage: str, n_splits: int) -> None:
    """A stage task split one oversized output block into ``n_splits``
    extra blocks."""
    if n_splits > 0:
        _emit({"k": "split", "s": str(stage), "n": int(n_splits)})


def record_pool_size(pool: str, size: int, queue_depth: int) -> None:
    """An autoscaling dataset actor pool changed size (or reports its
    terminal size): the pool-size / queue-depth gauges."""
    _emit({"k": "pool", "s": str(pool), "n": int(size),
           "q": int(queue_depth)})


def record_iter_batch(wait_s: Optional[float] = None,
                      user_s: Optional[float] = None,
                      transfer_s: Optional[float] = None,
                      occupancy: Optional[int] = None) -> None:
    """One consumer-loop batch: starvation wait vs consumer time (plus
    host->device dispatch seconds and the prefetch-buffer occupancy the
    consumer observed). Only the phases given are observed: an
    unmeasured phase must not count a zero."""
    p: Dict[str, float] = {}
    for phase, sec in (("wait", wait_s), ("user", user_s),
                       ("transfer", transfer_s)):
        if sec is not None:
            p[phase] = max(0.0, float(sec))
    ev: dict = {"k": "it", "p": p}
    if occupancy is not None:
        ev["occ"] = int(occupancy)
    if p or occupancy is not None:
        _emit(ev)


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


def scrape_text() -> str:
    """The cluster's federated exposition merged with this process's own
    registry (a driver's own observations -- the trainer's downtime
    ledger, driver-side dataset stages -- never ride an event batch);
    ``merge_prometheus`` keeps each series once, so an in-process
    cluster's shared registry does not count twice. Off a cluster, this
    process's registry."""
    from ray_tpu_torch._private import worker as _worker

    local = _metrics.prometheus_text()
    backend = _worker._backend  # never starts a backend of its own
    if backend is not None and hasattr(backend, "cluster_metrics_text"):
        try:
            return _metrics.merge_prometheus(
                [backend.cluster_metrics_text(), local])
        except Exception:
            pass
    return local


def data_stats(parsed: Optional[dict] = None) -> dict:
    """Input-pipeline rollup from the metrics plane (``scrape_text``, or
    ``parsed``): per-stage wall and per-block distributions,
    consumer-loop wait/user/transfer, prefetch occupancy, and the
    derived stall fraction."""
    if parsed is None:
        parsed = _metrics.parse_prometheus(scrape_text())
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


def train_stats(parsed: Optional[dict] = None) -> dict:
    """Per-trial training goodput rollup from the metrics plane
    (``scrape_text``, or ``parsed``): reports, per-phase step
    histograms, per-rank step time (straggler skew), the step anatomy
    with its straggler verdict and MFU, and the downtime ledger with its
    attribution and goodput percent."""
    if parsed is None:
        parsed = _metrics.parse_prometheus(scrape_text())
    trials: dict = {}
    names = set(_metrics.sum_counter(parsed, "ray_tpu_train_reports_total",
                                     "trial"))
    names |= set(_metrics.sum_counter(
        parsed, "ray_tpu_train_downtime_seconds_total", "trial"))
    # Anatomy-only producers (the serving engine's step loop) still get
    # a per-trial entry.
    names |= {dict(lb).get("trial", "") for lb in
              (parsed.get("ray_tpu_step_phase_seconds") or {})}
    for trial in sorted(n for n in names if n):
        entry: dict = {}
        reports = _metrics.sum_counter(
            parsed, "ray_tpu_train_reports_total", "trial",
            trial=trial).get(trial)
        if reports:
            entry["reports"] = int(reports)
        phases: dict = {}
        productive_s = 0.0
        for phase in STEP_PHASES:
            d = _metrics.histogram_dist(
                parsed, "ray_tpu_train_step_phase_seconds",
                trial=trial, phase=phase)
            if d:
                phases[phase] = _dist_summary(d)
                productive_s += d["sum"]
        if phases:
            entry["phases"] = phases
        ranks = {}
        for labels, val in (parsed.get(
                "ray_tpu_train_rank_step_seconds") or {}).items():
            ld = dict(labels)
            if ld.get("trial") == trial:
                ranks[ld.get("rank", "?")] = round(val, 6)
        if ranks:
            entry["rank_step_s"] = dict(sorted(ranks.items()))
            fastest = min(ranks.values())
            if fastest > 0:
                entry["rank_skew"] = round(max(ranks.values()) / fastest,
                                           3)
        anat_ranks: Dict[str, Dict[str, float]] = {}
        for labels, val in (parsed.get(
                "ray_tpu_step_phase_seconds") or {}).items():
            ld = dict(labels)
            if ld.get("trial") == trial:
                anat_ranks.setdefault(ld.get("rank", "?"), {})[
                    ld.get("phase", "?")] = round(val, 6)
        mfu: Dict[str, float] = {}
        for labels, val in (parsed.get("ray_tpu_mfu_percent")
                            or {}).items():
            ld = dict(labels)
            if ld.get("trial") == trial:
                mfu[ld.get("rank", "?")] = round(val, 3)
        if anat_ranks or mfu:
            anatomy: dict = {}
            if anat_ranks:
                anatomy["ranks"] = {
                    r: dict(sorted(anat_ranks[r].items()))
                    for r in sorted(anat_ranks)}
                verdict = straggler_attribution(anat_ranks)
                if verdict:
                    anatomy["straggler"] = verdict
            if mfu:
                anatomy["mfu_pct"] = dict(sorted(mfu.items()))
            entry["anatomy"] = anatomy
        downtime = _metrics.sum_counter(
            parsed, "ray_tpu_train_downtime_seconds_total", "cause",
            trial=trial)
        if downtime:
            entry["downtime_s"] = {
                c: round(v, 3) for c, v in downtime.items()}
        down_s = sum(downtime.values()) if downtime else 0.0
        if productive_s + down_s > 0:
            entry["goodput_pct"] = round(
                100.0 * productive_s / (productive_s + down_s), 2)
        trials[trial] = entry
    return {"trials": trials}
