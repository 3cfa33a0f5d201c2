"""Train config dataclasses (port of ``ray_tpu/train/config.py``).

Reference parity: ``python/ray/air/config.py`` -- ``ScalingConfig:79``,
``FailureConfig:454``, ``CheckpointConfig:513``, ``RunConfig:642``.

``CudaConfig`` is the counterpart of ``JaxConfig``. The reference's TPU
fields (``use_tpu``, ``topology``, the chips-per-host default) and
``JaxConfig``'s CPU simulation fields have no counterpart: a worker here
takes CPUs only until the runtime advertises GPUs (ROADMAP A5), and a
group of worker processes is the cluster backend's (ROADMAP A4b).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional


@dataclass
class ScalingConfig:
    num_workers: int = 1
    resources_per_worker: Optional[Dict[str, float]] = None
    placement_strategy: str = "PACK"
    # Elastic world size: when set, the trainer keeps ONE placement group
    # across attempts instead of reserving a fresh one per attempt. None =
    # fixed gang (an attempt always waits for all num_workers bundles).
    # Shrinking to the live bundles after a node loss, and regrowing, need
    # the cluster backend (ROADMAP A4b).
    min_workers: Optional[int] = None

    def __post_init__(self):
        if self.min_workers is not None and not (
                1 <= self.min_workers <= self.num_workers):
            # Fail at construction: a floor above num_workers can never
            # be met (the gang has only num_workers bundles).
            raise ValueError(
                f"min_workers must be in [1, num_workers]; got "
                f"min_workers={self.min_workers} with "
                f"num_workers={self.num_workers}")

    def worker_resources(self) -> Dict[str, float]:
        res = dict(self.resources_per_worker or {})
        if "CPU" not in res:
            res["CPU"] = 1.0
        return res

    def as_placement_group_bundles(self) -> list[Dict[str, float]]:
        return [self.worker_resources() for _ in range(self.num_workers)]


@dataclass
class CudaConfig:
    """Per-worker CUDA runtime setup, the counterpart of ``JaxConfig``
    (the ``TorchConfig`` analog, ``python/ray/train/torch/config.py:29``):
    whether workers join one ``torch.distributed`` process group (NCCL).

    On the local backend every worker is a thread of one process, so
    there is no group to join and ``distributed`` changes nothing; a
    group of worker processes, and ``JaxConfig``'s ``init_timeout`` for
    its rendezvous, need the cluster backend (ROADMAP A4b).
    """

    distributed: bool = True


@dataclass
class FailureConfig:
    max_failures: int = 0  # 0 = no retries, -1 = infinite


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None  # None = keep all
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"  # or "min"

    def __post_init__(self):
        if self.checkpoint_score_order not in ("max", "min"):
            raise ValueError("checkpoint_score_order must be 'max' or 'min'")


@dataclass
class RunConfig:
    """The reference's ``name``, ``storage_path``, ``verbose`` and ``stop``
    (Tune's) are left out: the trainer reads none of them."""

    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
