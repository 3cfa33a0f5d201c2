"""Train config dataclasses (port of ``ray_tpu/train/config.py``).

Reference parity: ``python/ray/air/config.py`` -- ``ScalingConfig:79``,
``FailureConfig:454``, ``CheckpointConfig:513``, ``RunConfig:642``.

``CudaConfig`` is the counterpart of ``JaxConfig``. The reference's TPU
fields (``use_tpu``, ``topology``) and ``JaxConfig``'s CPU simulation
fields have no counterpart. The reference's default of "the host's chip
count" a worker becomes one GPU a worker: ``CudaTrainer`` on ``cuda``
fills ``resources_per_worker`` with ``{"GPU": 1}`` when the caller gives
none (``trainer.py``); on the CPU a worker takes CPUs only.
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
    # across attempts (the head reschedules its lost bundles onto healthy
    # nodes instead of the group dying) and an attempt runs at the live
    # bundles' world size, down to min_workers, then regrows to
    # num_workers when the lost bundles land again. None = fixed gang (an
    # attempt always waits for all num_workers bundles).
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
    whether workers join one ``torch.distributed`` process group (NCCL on
    ``cuda``, gloo on the CPU), and how long the group's rendezvous may
    take (``init_timeout``, seconds: rank 0 publishing its address
    through the cluster KV and every rank connecting).

    On the local backend every worker is a thread of one process, so
    there is no group to join and ``distributed`` changes nothing.
    """

    distributed: bool = True
    init_timeout: float = 120.0


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
    """The reference's fields (``ray_tpu/train/config.py RunConfig``). The
    trainer reads ``failure_config`` and ``checkpoint_config``; Tune reads
    ``name`` and ``storage_path`` (where its experiment state is kept, a
    local directory or a ``file://`` URI) and ``stop`` (a trial's stop
    condition: a ``Stopper``, a ``{metric: threshold}`` dict or a
    callable). The reference's ``verbose`` is left out: nothing reads
    it."""

    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    stop: Optional[object] = None
