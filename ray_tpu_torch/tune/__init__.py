"""Tune: distributed hyperparameter search over trial actors (port of
``ray_tpu/tune/__init__.py``).

Reference parity: ``python/ray/tune`` (SURVEY.md §2.3) — search spaces,
variant generation, trial runner over actors with per-trial resources,
ASHA / HyperBand / median-stopping / PBT schedulers, the TPE and BOHB
searchers, per-trial checkpoints + retries, experiment persistence and
restore. A trial that holds a GPU (``with_resources(fn, {"GPU": 0.5})``)
runs on ``cuda`` (``session.get_device()``).
"""

from ray_tpu_torch._private.usage import record_library_usage as _rlu
_rlu("tune")

from ray_tpu_torch.train import session as _session
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.tune.schedulers import (
    ASHAScheduler,
    FIFOScheduler,
    HyperBandScheduler,
    MedianStoppingRule,
    PopulationBasedTraining,
    TrialScheduler,
)
from ray_tpu_torch.tune.search import (
    BasicVariantSearcher,
    BOHBSearcher,
    Searcher,
    TPESearcher,
)
from ray_tpu_torch.tune.search_space import (
    choice,
    grid_search,
    loguniform,
    quniform,
    randint,
    sample_from,
    uniform,
)
from ray_tpu_torch.tune.stopper import (
    CombinedStopper,
    FunctionStopper,
    MaximumIterationStopper,
    Stopper,
    TrialPlateauStopper,
)
from ray_tpu_torch.tune.trial_runner import Trial, TrialRunner
from ray_tpu_torch.tune.tuner import (ResultGrid, TrialResult, TuneConfig,
                                Tuner, run, with_resources)


def report(metrics: dict | None = None, *, checkpoint: Checkpoint | None = None,
           **kwargs) -> None:
    """``tune.report``: accepts a dict or keyword metrics."""
    payload = dict(metrics or {})
    payload.update(kwargs)
    _session.report(payload, checkpoint=checkpoint)


def get_checkpoint() -> Checkpoint | None:
    return _session.get_checkpoint()


def get_trial_id() -> str | None:
    info = _session.get_trial_info()
    return info["trial_id"] if info else None


__all__ = [
    "Stopper",
    "MaximumIterationStopper",
    "TrialPlateauStopper",
    "FunctionStopper",
    "CombinedStopper",
    "with_resources",
    "Tuner",
    "TuneConfig",
    "ResultGrid",
    "TrialResult",
    "Trial",
    "TrialRunner",
    "run",
    "report",
    "get_checkpoint",
    "get_trial_id",
    "uniform",
    "quniform",
    "loguniform",
    "randint",
    "choice",
    "grid_search",
    "sample_from",
    "TrialScheduler",
    "FIFOScheduler",
    "ASHAScheduler",
    "BOHBSearcher",
    "HyperBandScheduler",
    "MedianStoppingRule",
    "PopulationBasedTraining",
    "Searcher",
    "BasicVariantSearcher",
    "TPESearcher",
    "Checkpoint",
]
