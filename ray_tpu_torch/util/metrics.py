"""Counter / Gauge / Histogram, the Prometheus text exposition and its
parser (the parts of ``ray_tpu/util/metrics.py`` the serving engine, the
train session and trainer, and their tests call).

The registry is this process's own: nothing here ships to a cluster's
``/metrics`` plane. The metric families keep the JAX package's names, so
one scrape reads the same for either engine.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_registry_lock = threading.Lock()
_registry: "List[Metric]" = []

DEFAULT_HISTOGRAM_BOUNDARIES = [
    0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0
]


class Metric:
    metric_type = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name.replace("_", "").replace(":", "").isalnum():
            raise ValueError(f"invalid metric name {name!r}")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._lock = threading.Lock()
        with _registry_lock:
            _registry.append(self)

    def _key(self, tags: Optional[Dict[str, str]]) -> Tuple:
        tags = tags or {}
        missing = set(self.tag_keys) - set(tags)
        if missing:
            raise ValueError(f"metric {self.name} missing tags {missing}")
        return tuple(tags[k] for k in self.tag_keys)

    def remove(self, tags: Optional[Dict[str, str]] = None) -> bool:
        """Drop one tagged series; returns whether it existed."""
        key = self._key(tags)
        removed = False
        with self._lock:
            for table in ("_values", "_counts", "_sums", "_totals"):
                d = getattr(self, table, None)
                if d is not None and d.pop(key, None) is not None:
                    removed = True
        return removed

    def series(self) -> List[Dict[str, str]]:
        """Tag dicts of every live child."""
        keys: List[Tuple] = []
        with self._lock:
            for table in ("_values", "_counts"):
                d = getattr(self, table, None)
                if d is not None:
                    keys.extend(d.keys())
        return [dict(zip(self.tag_keys, k)) for k in dict.fromkeys(keys)]

    def _fmt_tags(self, key: Tuple, extra=()) -> str:
        pairs = list(zip(self.tag_keys, key)) + list(extra)
        if not pairs:
            return ""
        return "{" + ",".join(f'{k}="{v}"' for k, v in pairs) + "}"

    def _header(self) -> List[str]:
        return [f"# HELP {self.name} {self.description}",
                f"# TYPE {self.name} {self.metric_type}"]

    def expose(self) -> List[str]:
        out = self._header()
        with self._lock:
            for key, v in self._values.items():
                out.append(f"{self.name}{self._fmt_tags(key)} {v}")
        return out


class Counter(Metric):
    metric_type = "counter"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def inc(self, value: float = 1.0, tags: Optional[Dict[str, str]] = None):
        if value < 0:
            raise ValueError("counters only increase")
        key = self._key(tags)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value


class Gauge(Metric):
    metric_type = "gauge"

    def __init__(self, name, description="", tag_keys=None):
        super().__init__(name, description, tag_keys)
        self._values: Dict[Tuple, float] = {}

    def set(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            self._values[key] = float(value)

    def get(self, tags: Optional[Dict[str, str]] = None) -> Optional[float]:
        """The series' value, None where it is not set."""
        key = self._key(tags)
        with self._lock:
            return self._values.get(key)


class Histogram(Metric):
    metric_type = "histogram"

    def __init__(self, name, description="", boundaries=None, tag_keys=None):
        super().__init__(name, description, tag_keys)
        self.boundaries = list(boundaries or DEFAULT_HISTOGRAM_BOUNDARIES)
        self._counts: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._totals: Dict[Tuple, int] = {}

    def observe(self, value: float, tags: Optional[Dict[str, str]] = None):
        key = self._key(tags)
        with self._lock:
            counts = self._counts.setdefault(
                key, [0] * (len(self.boundaries) + 1))
            counts[bisect.bisect_left(self.boundaries, value)] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._totals[key] = self._totals.get(key, 0) + 1

    def expose(self) -> List[str]:
        out = self._header()
        with self._lock:
            for key, counts in self._counts.items():
                cumulative = 0
                for bound, c in zip(self.boundaries + ["+Inf"], counts):
                    cumulative += c
                    tags = self._fmt_tags(key, [("le", str(bound))])
                    out.append(f"{self.name}_bucket{tags} {cumulative}")
                tags = self._fmt_tags(key)
                out.append(f"{self.name}_sum{tags} {self._sums[key]}")
                out.append(f"{self.name}_count{tags} {self._totals[key]}")
        return out


# -- the families this package records -------------------------------------

SERVE_LATENCY_BOUNDARIES = [
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0,
    2.5, 5.0, 10.0, 30.0, 60.0,
]
SERVE_SHED_TOTAL = Counter(
    "ray_tpu_serve_shed_total",
    "Deadline-expired serve requests shed instead of executed, by the "
    "site that shed them",
    tag_keys=("node_id", "deployment", "reason"),
)
SERVE_DECODE_STEP_SECONDS = Histogram(
    "ray_tpu_serve_decode_step_seconds",
    "Wall time of one decode iteration of the LLM engine (device step + "
    "host sampling sync)",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_BATCH_OCCUPANCY = Histogram(
    "ray_tpu_serve_decode_batch_occupancy",
    "Active slots per decode iteration",
    boundaries=[1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0, 128.0, 256.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_TTFT_SECONDS = Histogram(
    "ray_tpu_serve_decode_ttft_seconds",
    "Time to first token per admitted stream (submit -> first token "
    "available for delivery, engine-side)",
    boundaries=SERVE_LATENCY_BOUNDARIES + [120.0, 300.0, 600.0],
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_TOKENS_TOTAL = Counter(
    "ray_tpu_serve_decode_tokens_total",
    "Tokens produced by the LLM decode engine (prefill first tokens + "
    "decode-step tokens, all streams)",
    tag_keys=("node_id", "deployment"),
)
SERVE_DECODE_ITL_SECONDS = Histogram(
    "ray_tpu_serve_decode_itl_seconds",
    "Inter-token latency per decode-step token: wall time from a "
    "stream's previous token to this one, engine-side",
    boundaries=[0.0001, 0.00025, 0.0005, 0.001, 0.0025, 0.005, 0.01,
                0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5],
    tag_keys=("node_id", "deployment"),
)
TRAIN_STEP_ANATOMY_SECONDS = Gauge(
    "ray_tpu_step_phase_seconds",
    "Most recent step-anatomy decomposition per rank: data_wait / host "
    "(dispatch until device launch) / compute (synced device wall) / "
    "sync (barrier skew)",
    tag_keys=("node_id", "trial", "phase", "rank"),
)
TRAIN_STEP_PHASE_SECONDS = Histogram(
    "ray_tpu_train_step_phase_seconds",
    "Wall time of one training-step phase per reported step (data_wait "
    "/ step / report / checkpoint_save / checkpoint_restore), driven "
    "from the session API",
    boundaries=[0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5, 5.0, 10.0, 30.0, 120.0],
    tag_keys=("node_id", "trial", "phase"),
)
TRAIN_RANK_STEP_SECONDS = Gauge(
    "ray_tpu_train_rank_step_seconds",
    "Most recent step compute seconds per rank of a gang (the "
    "straggler gauge); retracted when the trial stops",
    tag_keys=("node_id", "trial", "rank"),
)
TRAIN_REPORTS_TOTAL = Counter(
    "ray_tpu_train_reports_total",
    "session.report calls per trial (all ranks)",
    tag_keys=("node_id", "trial"),
)
TRAIN_DOWNTIME_SECONDS = Counter(
    "ray_tpu_train_downtime_seconds_total",
    "Non-productive trial wall seconds attributed by the trainer's "
    "downtime ledger (cause: preemption / failure)",
    tag_keys=("node_id", "trial", "cause"),
)
TRAIN_MFU_PERCENT = Gauge(
    "ray_tpu_mfu_percent",
    "Model-FLOPs utilization per rank: FlopCounterMode FLOPs per step "
    "(util/xla_cost) over the synced step wall, against the measure.py "
    "per-device peak; retracted when the trial stops",
    tag_keys=("node_id", "trial", "rank"),
)
TRACING_DROPPED_SPANS = Counter(
    "ray_tpu_tracing_dropped_spans_total",
    "Finished spans dropped by this process's bounded span buffer",
    tag_keys=("node_id",),
)
LOOP_RESTARTS_TOTAL = Counter(
    "ray_tpu_loop_restarts_total",
    "Exceptions a daemon loop survived (swallowed and re-entered the "
    "iteration), by loop name",
    tag_keys=("loop",),
)


def count_loop_restart(loop: str) -> None:
    """One survived daemon-loop exception. Never raises: the survival
    handler calling this is its loop's last line of defense."""
    try:
        LOOP_RESTARTS_TOTAL.inc(tags={"loop": loop})
    except Exception:
        pass


def retract_loop_series(loops: Sequence[str]) -> None:
    """Drop the loop-restart children a stopping component owns. Never
    raises (stop paths call it)."""
    for loop in loops:
        try:
            LOOP_RESTARTS_TOTAL.remove(tags={"loop": loop})
        except Exception:
            pass


def prometheus_text() -> str:
    """The whole registry in Prometheus exposition format."""
    with _registry_lock:
        metrics = list(_registry)
    lines: List[str] = []
    for m in metrics:
        lines.extend(m.expose())
    return "\n".join(lines) + "\n"


# -- reading an exposition back --------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})?\s+([^\s]+)$")
_LABEL_RE = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="([^"]*)"')


def parse_prometheus(text: str) -> Dict[str, Dict[tuple, float]]:
    """Exposition text -> {metric_name: {sorted (label, value) tuple:
    sample value}} (comments skipped)."""
    out: Dict[str, Dict[tuple, float]] = {}
    for line in (text or "").splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            continue
        name, labels_raw, value = m.groups()
        try:
            val = float(value)
        except ValueError:
            continue
        labels = tuple(sorted(_LABEL_RE.findall(labels_raw or "")))
        out.setdefault(name, {})[labels] = val
    return out


def _labels_get(labels: tuple, key: str) -> Optional[str]:
    for k, v in labels:
        if k == key:
            return v
    return None


def _matches(labels: tuple, match: Dict[str, str]) -> bool:
    return all(_labels_get(labels, k) == v for k, v in match.items())


def sum_counter(parsed: dict, name: str, group_label: str,
                **match: str) -> Dict[str, float]:
    """Sum a family's samples across node_id (and any other label not
    grouped on), grouped by one label, filtered by exact label matches."""
    out: Dict[str, float] = {}
    for labels, val in (parsed.get(name) or {}).items():
        if _matches(labels, match):
            key = _labels_get(labels, group_label) or ""
            out[key] = out.get(key, 0.0) + val
    return out


def histogram_dist(parsed: dict, name: str, **match: str) -> Optional[dict]:
    """One histogram's cumulative buckets, sum and count, summed across
    node_id, filtered by exact label matches. Returns {"buckets":
    [(le, cum)], "sum": s, "count": n}, or None when nothing matched."""
    buckets: Dict[float, float] = {}
    for labels, val in (parsed.get(name + "_bucket") or {}).items():
        if _matches(labels, match):
            le_raw = _labels_get(labels, "le")
            le = float("inf") if le_raw == "+Inf" else float(le_raw)
            buckets[le] = buckets.get(le, 0.0) + val
    total = sum(val for labels, val in (parsed.get(name + "_sum") or {})
                .items() if _matches(labels, match))
    count = sum(val for labels, val in (parsed.get(name + "_count") or {})
                .items() if _matches(labels, match))
    if not buckets or count <= 0:
        return None
    return {"buckets": sorted(buckets.items()), "sum": total,
            "count": count}


def quantile_from_buckets(dist: Optional[dict], q: float) -> Optional[float]:
    """Prometheus-style histogram_quantile: linear interpolation inside
    the bucket holding the q-th sample (the +Inf bucket clamps to the
    last finite bound, as in PromQL)."""
    if not dist:
        return None
    rank = q * dist["count"]
    prev_le, prev_cum = 0.0, 0.0
    last_finite = 0.0
    for le, cum in dist["buckets"]:
        if le != float("inf"):
            last_finite = le
        if cum >= rank and cum > prev_cum:
            if le == float("inf"):
                return last_finite
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_le + (le - prev_le) * frac
        prev_le, prev_cum = (0.0 if le == float("inf") else le), cum
    return last_finite


def diff_parsed(before: dict, after: dict) -> dict:
    """Per-series ``after - before``: isolates one run's counts from
    whatever the shared registry already held."""
    out: Dict[str, Dict[tuple, float]] = {}
    for name, series in after.items():
        base = before.get(name) or {}
        out[name] = {labels: val - base.get(labels, 0.0)
                     for labels, val in series.items()}
    return out
