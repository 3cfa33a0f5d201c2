"""Step anatomy gauges (the parts of ``ray_tpu/util/goodput.py`` the
serving engine calls): one instrumented step's phases per entity and
rank, set straight into this process's registry."""

from __future__ import annotations

from typing import Dict

from ray_tpu_torch.util import metrics as _metrics

# data_wait = input starvation, host = dispatch until the device runs,
# compute = the synced device wall, sync = barrier skew; together they
# partition the instrumented step's wall time.
ANATOMY_PHASES = ("data_wait", "host", "compute", "sync")
_NODE = "local"


def record_anatomy(trial: str, rank: int, phases: Dict[str, float]) -> None:
    """One step's anatomy for one rank of ``trial`` (per-rank gauges,
    retracted by ``retract_trial``)."""
    tags = {"node_id": _NODE, "trial": str(trial), "rank": str(int(rank))}
    for phase, sec in phases.items():
        if phase in ANATOMY_PHASES:
            _metrics.TRAIN_STEP_ANATOMY_SECONDS.set(
                max(0.0, float(sec)), tags={**tags, "phase": phase})


def retract_trial(trial: str) -> None:
    """Drop every per-rank series of ``trial`` (its session stopped)."""
    fam = _metrics.TRAIN_STEP_ANATOMY_SECONDS
    for tags in fam.series():
        if tags.get("trial") == str(trial):
            fam.remove(tags=tags)
