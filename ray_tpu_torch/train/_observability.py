"""Training goodput plane -- the train-package name for the shared core
(port of ``ray_tpu/train/_observability.py``).

The implementation lives in ``ray_tpu_torch.util.goodput`` so the data
library can record into it without importing the train package; this
module is the same objects under the train-side name. The reference's
ship-buffer functions (``drain_events``, ``requeue_events``,
``apply_events``, ``retract_gauges``), its downtime-cause classifier and
straggler attribution, and its cluster-wide readers (``scrape_text``,
``train_stats``) are left out with the cluster's metrics plane (ROADMAP
A4c): each process's registry is read where it is.
"""

from ray_tpu_torch.util.goodput import (  # noqa: F401
    ANATOMY_PHASES,
    ITER_PHASES,
    STEP_PHASES,
    data_stats,
    record_anatomy,
    record_iter_batch,
    record_stage,
    record_step,
    retract_trial,
    stall_fraction_from,
)
