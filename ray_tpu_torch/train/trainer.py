"""DataParallelTrainer: worker group + training loop + fault tolerance
(port of ``ray_tpu/train/trainer.py``).

Reference parity (SURVEY.md §3.4): ``BaseTrainer.fit``
(``train/base_trainer.py:339``) -> ``DataParallelTrainer``
(``data_parallel_trainer.py:244``) -> ``BackendExecutor.start``
(``_internal/backend_executor.py:93``) creates a ``WorkerGroup`` of actors
in the trial's placement group, initializes per-worker sessions, runs the
user loop, and consumes results through ``TrainingIterator._fetch_next_result``
(``trainer.py:155``). Worker failure => group restart from the latest
checkpoint within ``FailureConfig.max_failures`` (elastic restart).

``CudaTrainer`` is the counterpart of ``JaxTrainer``: its workers run the
user's loop on a CUDA device (``session.get_device()``), the CPU only when
asked for by name.

What runs here is the local backend's part of the reference: its workers
are threads of this process, so a group is its ranks on this process's
devices. Left out with the cluster backend (ROADMAP A4b): the drain
watcher and its proactive restart on a preemption notice, the elastic
gang's shrink to the live bundles and its regrow watcher, and the
backend setup hooks that join a group of worker processes
(``setup_jax`` / ``setup_torch``).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core.object_ref import ActorError, TaskError
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    CudaConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.util import goodput as _goodput
from ray_tpu_torch.util.placement_group import (
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.queue import Empty, Queue
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)


@dataclass
class Result:
    metrics: Optional[dict]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException] = None
    metrics_history: List[dict] = field(default_factory=list)
    # Downtime-ledger rollup for the whole fit(): wall_s, downtime_s,
    # by_cause, restarts, goodput_pct, per-rank last step seconds + skew.
    goodput: Optional[dict] = None


class _TrainWorker:
    """Actor hosting one training worker (rank)."""

    def __init__(self, rank: int):
        self.rank = rank

    def node_id(self) -> str:
        """Which node this worker landed on (for rank layout)."""
        from ray_tpu_torch._private import worker as worker_mod

        return getattr(worker_mod.backend(), "node_id", "local")

    def run(self, train_fn, config, session_kwargs):
        session_mod.init_session(**session_kwargs)
        try:
            train_fn(config)
        finally:
            q = session_kwargs["results_queue"]
            q.put({"type": "finished", "rank": self.rank})
            session_mod.shutdown_session()
        return self.rank


class WorkerGroup:
    """N worker actors inside one placement group
    (``train/_internal/worker_group.py:92``).

    Default (fixed gang): owns a fresh group sized for the full
    ``scaling.num_workers``. Elastic: the trainer passes the ONE
    long-lived group it holds across attempts and the bundle indices
    this attempt runs on."""

    def __init__(self, scaling: ScalingConfig,
                 num_workers: Optional[int] = None,
                 pg=None, bundle_indices: Optional[List[int]] = None):
        self.scaling = scaling
        self.owns_pg = pg is None
        self.num_workers = num_workers or scaling.num_workers
        if pg is None:
            bundles = scaling.as_placement_group_bundles()
            pg = placement_group(
                bundles, strategy=scaling.placement_strategy)
            ray_tpu_torch.get(pg.ready(), timeout=120)
        self.pg = pg
        if bundle_indices is None:
            bundle_indices = list(range(self.num_workers))
        self.bundle_indices = list(bundle_indices)[: self.num_workers]
        worker_cls = ray_tpu_torch.remote(_TrainWorker)
        self.workers = [
            worker_cls.options(
                num_cpus=0,
                scheduling_strategy=PlacementGroupSchedulingStrategy(
                    placement_group=self.pg,
                    placement_group_bundle_index=self.bundle_indices[i],
                ),
            ).remote(i)
            for i in range(self.num_workers)
        ]

    def run_all(self, train_fn, config, session_kwargs_per_worker) -> list:
        return [
            w.run.remote(train_fn, config, kw)
            for w, kw in zip(self.workers, session_kwargs_per_worker)
        ]

    def shutdown(self):
        for w in self.workers:
            ray_tpu_torch.kill(w)
        if self.owns_pg:
            remove_placement_group(self.pg)


class _CheckpointManager:
    """Track reported checkpoints, keep top-K (``CheckpointConfig``,
    ``tune/execution/checkpoint_manager.py`` analog)."""

    def __init__(self, config: CheckpointConfig):
        self.config = config
        self.checkpoints: List[tuple] = []  # (score, iteration, Checkpoint)
        self.latest: Optional[Checkpoint] = None

    def register(self, checkpoint: Checkpoint, metrics: dict, iteration: int):
        self.latest = checkpoint
        attr = self.config.checkpoint_score_attribute
        score = metrics.get(attr) if attr else iteration
        if score is None:
            score = iteration
        sign = 1 if self.config.checkpoint_score_order == "max" else -1
        self.checkpoints.append((sign * score, iteration, checkpoint))
        self.checkpoints.sort(key=lambda t: (-t[0], -t[1]))
        if self.config.num_to_keep is not None:
            del self.checkpoints[self.config.num_to_keep :]

    @property
    def best(self) -> Optional[Checkpoint]:
        return self.checkpoints[0][2] if self.checkpoints else self.latest


def _shard_dataset(ds, n: int, equal: bool = True):
    """Per-worker shards: datasets via split(); arrays/lists striped."""
    if ds is None:
        return [None] * n
    if hasattr(ds, "split"):
        return ds.split(n, equal=equal)
    try:
        return [ds[i::n] for i in range(n)]
    except TypeError:
        return [ds] * n


class DataParallelTrainer:
    def __init__(
        self,
        train_loop_per_worker: Callable,
        *,
        train_loop_config: Optional[dict] = None,
        scaling_config: Optional[ScalingConfig] = None,
        run_config: Optional[RunConfig] = None,
        datasets: Optional[Dict[str, Any]] = None,
        resume_from_checkpoint: Optional[Checkpoint] = None,
    ):
        self.train_fn = train_loop_per_worker
        self.config = dict(train_loop_config or {})
        self.scaling = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self.resume_checkpoint = resume_from_checkpoint

    # -- one attempt ------------------------------------------------------

    def _run_attempt(
        self, ckpt_mgr: _CheckpointManager, metrics_history: List[dict],
        ledger: Optional[_goodput.GoodputLedger] = None,
        pg=None,
    ) -> Optional[dict]:
        """Run the worker group to completion; returns last metrics.
        Raises on worker failure (caller handles elasticity). With ``pg``
        (the elastic path's long-lived group) the attempt runs on the
        bundles that are ready."""
        n = self.scaling.num_workers
        bundle_indices: Optional[List[int]] = None
        if pg is not None:
            bundle_indices = self._wait_live_bundles(pg)[:n]
            n = len(bundle_indices)
        group = WorkerGroup(self.scaling, num_workers=n, pg=pg,
                            bundle_indices=bundle_indices)
        queue = Queue()
        try:
            shards = {
                name: _shard_dataset(ds, n) for name, ds in self.datasets.items()
            }
            start_ckpt = ckpt_mgr.latest or self.resume_checkpoint
            node_ranks, local_ranks = self._compute_ranks(group)
            self._on_group_start(group, node_ranks, local_ranks)
            session_kwargs = [
                {
                    "world_rank": i,
                    "world_size": n,
                    "local_rank": local_ranks[i],
                    "node_rank": node_ranks[i],
                    "results_queue": queue,
                    "checkpoint": start_ckpt,
                    "dataset_shards": {
                        name: sh[i] for name, sh in shards.items()
                    },
                    "device": self._worker_device(),
                }
                for i in range(n)
            ]
            run_refs = group.run_all(self.train_fn, self.config, session_kwargs)
            return self._consume_results(
                queue, run_refs, n, ckpt_mgr, metrics_history, ledger=ledger)
        finally:
            queue.shutdown()
            group.shutdown()

    def _compute_ranks(self, group: WorkerGroup) -> tuple[list, list]:
        """node_rank + local_rank per worker, from actual actor placement
        (``backend_executor.py:339-404`` init_session rank layout)."""
        node_ids = ray_tpu_torch.get(
            [w.node_id.remote() for w in group.workers], timeout=60
        )
        node_order: list[str] = []
        counts: dict[str, int] = {}
        node_ranks, local_ranks = [], []
        for nid in node_ids:
            if nid not in counts:
                counts[nid] = 0
                node_order.append(nid)
            node_ranks.append(node_order.index(nid))
            local_ranks.append(counts[nid])
            counts[nid] += 1
        return node_ranks, local_ranks

    def _live_bundles(self, pg) -> List[int]:
        """Bundle indices ready to host a worker: every bundle once the
        group is CREATED (the local backend has no per-bundle liveness;
        the cluster's shrunk world sizes are ROADMAP A4b)."""
        table = placement_group_table(pg) or {}
        if table.get("state") == "CREATED":
            return list(range(len(table.get("bundles") or
                                  [None] * self.scaling.num_workers)))
        return []

    def _wait_live_bundles(self, pg, timeout: float = 300.0) -> List[int]:
        """Block until at least ``min_workers`` bundles are ready (the
        elastic floor)."""
        floor = max(1, self.scaling.min_workers or self.scaling.num_workers)
        deadline = time.monotonic() + timeout
        while True:
            live = self._live_bundles(pg)
            if len(live) >= floor:
                return sorted(live)
            state = (placement_group_table(pg) or {}).get("state")
            if state in ("REMOVED", "INFEASIBLE"):
                raise RuntimeError(
                    f"elastic gang placement group is {state}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic gang never reached min_workers={floor} "
                    f"live bundles within {timeout}s (live={live})")
            time.sleep(0.25)

    def _on_group_start(self, group, node_ranks, local_ranks) -> None:
        """Framework-backend hook run before the training loops start
        (``Backend.on_start`` analog). Default: nothing."""

    def _worker_device(self):
        """The device every worker's session names (``session.
        get_device()``): None here, a CUDA device under ``CudaTrainer``."""
        return None

    def _consume_results(
        self, queue, run_refs, n, ckpt_mgr, metrics_history,
        ledger: Optional[_goodput.GoodputLedger] = None,
    ) -> Optional[dict]:
        """TrainingIterator: drain worker reports; rank-0 metrics win
        (``train/trainer.py:155 _fetch_next_result``)."""
        finished: set[int] = set()
        last_metrics: Optional[dict] = None
        while len(finished) < n:
            # Fail fast if a worker actor died (its queue would stay silent).
            ready, _ = ray_tpu_torch.wait(run_refs, num_returns=n, timeout=0.0)
            for r in ready:
                ray_tpu_torch.get(r)  # raises ActorError/TaskError on failure
            try:
                msg = queue.get(timeout=1.0)
            except Empty:
                continue
            if msg["type"] == "finished":
                finished.add(msg["rank"])
                continue
            if msg["type"] == "report":
                if ledger is not None:
                    ledger.observe_report(msg)
                if msg["checkpoint"] is not None and msg["rank"] == 0:
                    ckpt_mgr.register(
                        msg["checkpoint"], msg["metrics"], msg["iteration"]
                    )
                if msg["rank"] == 0:
                    last_metrics = msg["metrics"]
                    metrics_history.append(msg["metrics"])
        for r in run_refs:
            ray_tpu_torch.get(r, timeout=60)
        return last_metrics

    # -- public -----------------------------------------------------------

    def fit(self) -> Result:
        ckpt_mgr = _CheckpointManager(self.run_config.checkpoint_config)
        metrics_history: List[dict] = []
        max_failures = self.run_config.failure_config.max_failures
        ledger = _goodput.GoodputLedger()
        attempt = 0
        pg = None
        if self.scaling.min_workers is not None:
            # Elastic: ONE long-lived reservation for the whole fit(),
            # reused by every attempt.
            bundles = self.scaling.as_placement_group_bundles()
            pg = placement_group(
                bundles, strategy=self.scaling.placement_strategy)
            ray_tpu_torch.get(pg.ready(), timeout=120)
        try:
            while True:
                try:
                    last_metrics = self._run_attempt(
                        ckpt_mgr, metrics_history, ledger, pg=pg)
                    return Result(
                        metrics=last_metrics,
                        checkpoint=ckpt_mgr.best,
                        metrics_history=metrics_history,
                        goodput=ledger.summary(),
                    )
                except (ActorError, TaskError) as e:
                    ledger.mark_down("failure")
                    attempt += 1
                    if max_failures >= 0 and attempt > max_failures:
                        return Result(
                            metrics=metrics_history[-1]
                            if metrics_history else None,
                            checkpoint=ckpt_mgr.best,
                            error=e,
                            metrics_history=metrics_history,
                            goodput=ledger.summary(),
                        )
                    # Elastic restart: new group resumes from latest
                    # checkpoint.
                    time.sleep(0.2)
        finally:
            # Session stop: the trial's per-rank gauge series (step
            # time, MFU, anatomy phases) must not outlive the trial on
            # the scrape -- the local backend's worker threads never die
            # to retract them.
            _goodput.retract_trial(ledger.trial)
            if pg is not None:
                remove_placement_group(pg)


class CudaTrainer(DataParallelTrainer):
    """DataParallelTrainer whose workers run on a CUDA device: ``cuda``
    unless ``device`` names another (``"cpu"`` for the CPU tests); without
    a GPU the constructor raises, and nothing falls back to the CPU. The
    loop reads its device with ``session.get_device()``.

    The counterpart of ``JaxTrainer``: before the loops start, workers
    that are separate processes would join one ``torch.distributed``
    group (NCCL), as JaxTrainer's join one ``jax.distributed`` runtime.
    On the local backend the workers are threads of one process, which
    already shares its devices, so ``_on_group_start`` returns at once,
    as ``JaxTrainer._on_group_start`` does there; the group of worker
    processes comes with the cluster backend (ROADMAP A4b).
    """

    def __init__(self, *args, cuda_config: Optional[CudaConfig] = None,
                 device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.cuda_config = cuda_config or CudaConfig()
        self.device = resolve_device(device)

    def _worker_device(self):
        return self.device

    def _on_group_start(self, group, node_ranks, local_ranks) -> None:
        if not self.cuda_config.distributed:
            return
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.core.local_backend import LocalBackend

        if isinstance(worker_mod.backend(), LocalBackend):
            return
        raise NotImplementedError(
            "a process group over worker processes needs the cluster "
            "backend (ROADMAP A4b)")
