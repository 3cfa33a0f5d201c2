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

On the local backend the workers are threads of this process. On the
cluster backend (``ray_tpu_torch.init(address=...)``) each rank is a
worker process, and before the loops start ``CudaTrainer`` joins them
into one ``torch.distributed`` group: rank 0 publishes a coordinator
address through the cluster KV and every rank connects
(``_TrainWorker.setup_cuda``, the counterpart of ``setup_jax`` and
``setup_torch``), NCCL on ``cuda`` and gloo on the CPU; rank r runs on
``cuda:{local_rank}``. Left out (ROADMAP A4c): the drain watcher and its
proactive restart on a preemption notice, the elastic gang's shrink to
the live bundles and its regrow watcher, and the reference's
``setup_torch`` hook of ``TorchTrainer``.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import ids
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
from ray_tpu_torch.util.queue import Empty, Queue, driver_node_options
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
        # Set by setup_cuda: the group this worker joined is the one its
        # run() destroys (on the local backend the workers are threads of
        # the driver, and a group there is the caller's, not the trainer's).
        self.joined_group = False

    def node_id(self) -> str:
        """Which node this worker landed on (for rank layout)."""
        from ray_tpu_torch._private import worker as worker_mod

        return getattr(worker_mod.backend(), "node_id", "local")

    def setup_cuda(self, group: str, rank: int, world_size: int,
                   local_rank: int, local_world_size: int, cuda_config,
                   device) -> bool:
        """Join the group's ``torch.distributed`` process group (the
        counterpart of ``setup_jax`` / ``setup_torch``, Backend.on_start,
        ``train/torch/config.py:129-181``). Rank 0 publishes
        ``node_ip:free_port`` through the cluster KV (its node's address
        as the cluster reaches it; the reference publishes ``host_ip()``,
        which asks the routing table); the others wait for it under
        ``cuda_config.init_timeout``. Every rank then calls
        ``parallel.distributed.initialize`` — NCCL on ``cuda`` (this
        rank's device is ``cuda:{local_rank}``), gloo on the CPU — which
        blocks until all ranks connect, so the trainer must call it on
        all workers concurrently."""
        import torch

        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.parallel import distributed as dist

        if rank == 0:
            addr = dist.publish_coordinator(
                group, f"{worker_mod.backend().node_ip}:{dist.free_port()}")
        else:
            addr = dist.wait_coordinator(group, cuda_config.init_timeout)
        os.environ["RAY_TPU_TORCH_LOCAL_RANK"] = str(local_rank)
        # Torch-ecosystem conventions (libraries read these even when the
        # process group is already initialized).
        host, _, port = addr.rpartition(":")
        os.environ.update(
            MASTER_ADDR=host, MASTER_PORT=port, RANK=str(rank),
            WORLD_SIZE=str(world_size), LOCAL_RANK=str(local_rank),
            LOCAL_WORLD_SIZE=str(local_world_size))
        dev = torch.device(device)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_rank)
        self.joined_group = True
        dist.initialize(group, rank, world_size, device=dev,
                        coordinator_address=addr,
                        timeout=cuda_config.init_timeout)
        return True

    def run(self, train_fn, config, session_kwargs):
        device = session_kwargs.get("device")
        if device is not None and device.type == "cuda" \
                and device.index is not None:
            # Values that arrive on CUDA land on this rank's device
            # (core/serialization.py), and so do tensors the loop makes
            # with device="cuda".
            import torch

            torch.cuda.set_device(device)
        session_mod.init_session(**session_kwargs)
        try:
            train_fn(config)
        finally:
            q = session_kwargs["results_queue"]
            q.put({"type": "finished", "rank": self.rank})
            session_mod.shutdown_session()
            if self.joined_group:
                _destroy_process_group()
        return self.rank


def _destroy_process_group(timeout: float = 10.0) -> None:
    """Destroy the group ``setup_cuda`` joined, on every path. After a
    failure a peer may be gone mid-collective, and a destroy can then
    block: it runs on a thread and is given up on after ``timeout`` (the
    trainer kills the worker process next, which ends the group)."""
    import torch.distributed

    if not torch.distributed.is_initialized():
        return
    from ray_tpu_torch.parallel import distributed

    t = threading.Thread(target=distributed.shutdown, daemon=True)
    t.start()
    t.join(timeout)


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
    """Per-worker shards: a ``ray_tpu_torch.data.Dataset`` through
    ``Dataset.split(n, equal=True)`` (each rank ``count() // n`` rows, the
    remainder dropped; a rank reads its shard with
    ``session.get_dataset_shard(name).iter_device_batches(...)``); arrays
    and lists striped (``ds[i::n]``); anything else handed to every
    rank whole."""
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
        # The results queue sits on the driver's node (the one node the
        # consumer cannot outlive).
        queue = Queue(actor_options=driver_node_options())
        try:
            if self._worker_processes():
                # The queue's actor process unpickles every report; the
                # first checkpoint would make it import the train modules
                # (torch, seconds) inside a step. It loads them now,
                # while the workers start (not waited on: the actor runs
                # its calls in order, so the first put waits for it).
                queue.actor.preload.remote(["ray_tpu_torch.train.checkpoint"])
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
                    "device": self._worker_device(local_ranks[i]),
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
        group is CREATED (the shrunk world sizes of the reference's
        elastic gang are ROADMAP A4c)."""
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

    def _worker_processes(self) -> bool:
        """Whether the workers run in processes of their own (the cluster
        backend) rather than as threads of this one (the local backend)."""
        from ray_tpu_torch._private import worker as worker_mod
        from ray_tpu_torch.core.local_backend import LocalBackend

        return not isinstance(worker_mod.backend(), LocalBackend)

    def _on_group_start(self, group, node_ranks, local_ranks) -> None:
        """Framework-backend hook run before the training loops start
        (``Backend.on_start`` analog). Default: nothing."""

    def _worker_device(self, local_rank: int):
        """The device the worker of ``local_rank`` names in its session
        (``session.get_device()``): None here, a CUDA device under
        ``CudaTrainer``."""
        return None

    def _consume_results(
        self, queue, run_refs, n, ckpt_mgr, metrics_history,
        ledger: Optional[_goodput.GoodputLedger] = None,
    ) -> Optional[dict]:
        """TrainingIterator: drain worker reports; rank-0 metrics win
        (``train/trainer.py:155 _fetch_next_result``).

        Unlike the reference, which raises on a failed rank before it
        reads the reports already sent, a failure first drains the queue
        until it is empty. ``session.report`` returns only once the queue
        holds the report, so every report made before the failure (in
        the order a collective or a barrier sets between ranks) is read
        first, and a checkpoint rank 0 reported before another rank
        failed is the one the restart resumes from (ROADMAP R5)."""
        finished: set[int] = set()
        last = {"metrics": None}

        def handle(msg) -> None:
            if msg["type"] == "finished":
                finished.add(msg["rank"])
                return
            if msg["type"] != "report":
                raise ValueError(f"unknown results message {msg['type']!r}")
            if ledger is not None:
                ledger.observe_report(msg)
            if msg["checkpoint"] is not None and msg["rank"] == 0:
                ckpt_mgr.register(
                    msg["checkpoint"], msg["metrics"], msg["iteration"]
                )
            if msg["rank"] == 0:
                last["metrics"] = msg["metrics"]
                metrics_history.append(msg["metrics"])

        while len(finished) < n:
            # Fail fast if a worker actor died (its queue would stay silent).
            ready, _ = ray_tpu_torch.wait(run_refs, num_returns=n, timeout=0.0)
            for r in ready:
                try:
                    ray_tpu_torch.get(r)  # raises ActorError/TaskError
                except (ActorError, TaskError):
                    while True:
                        try:
                            msg = queue.get(block=False)
                        except Empty:
                            break
                        handle(msg)
                    raise
            try:
                msg = queue.get(timeout=1.0)
            except Empty:
                continue
            handle(msg)
        for r in run_refs:
            ray_tpu_torch.get(r, timeout=60)
        return last["metrics"]

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

    The counterpart of ``JaxTrainer``. On ``cuda`` a worker takes one GPU
    unless ``scaling_config.resources_per_worker`` says otherwise (the
    reference's default is the host's chip count); on the CPU, CPUs only.
    On the cluster backend, before the loops start, every worker joins
    ONE ``torch.distributed`` group: all the ``setup_cuda`` calls are in
    flight together (the rendezvous blocks until every rank connects),
    the first rank to fail — or the group not forming within
    ``cuda_config.init_timeout`` — ends the attempt as an error, and the
    coordinator key is cleared on every path. Rank r runs on
    ``cuda:{local_rank}``, and ``CUDA_VISIBLE_DEVICES`` is not masked per
    worker (the reference masks no chips per worker either). On the local
    backend the workers are threads of one process, which already shares
    its devices, so ``_on_group_start`` returns at once, as
    ``JaxTrainer._on_group_start`` does there.
    """

    def __init__(self, *args, cuda_config: Optional[CudaConfig] = None,
                 device=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.cuda_config = cuda_config or CudaConfig()
        self.device = resolve_device(device)
        if self.device.type == "cuda" and \
                self.scaling.resources_per_worker is None:
            self.scaling = dataclasses.replace(
                self.scaling, resources_per_worker={"GPU": 1.0})

    def _worker_device(self, local_rank: int):
        import torch

        if self.device.type == "cuda" and self._worker_processes():
            return torch.device("cuda", local_rank)
        return self.device

    def _on_group_start(self, group, node_ranks, local_ranks) -> None:
        if not self.cuda_config.distributed or not self._worker_processes():
            return
        from ray_tpu_torch.parallel import distributed as dist

        group_name = f"train-{ids.new_task_id()[:12]}"
        n = len(group.workers)
        local_world: dict = {}
        for nr in node_ranks:
            local_world[nr] = local_world.get(nr, 0) + 1
        timeout = self.cuda_config.init_timeout
        # All setup calls must be in flight together: initialize() blocks
        # until every rank has connected to the coordinator.
        refs = [
            w.setup_cuda.remote(
                group_name, i, n, local_ranks[i],
                local_world[node_ranks[i]], self.cuda_config, self.device)
            for i, w in enumerate(group.workers)
        ]
        try:
            # The first rank to fail ends the wait (a rank that died
            # before connecting is an ActorError now, not rank 0's
            # timeout later).
            deadline = time.monotonic() + timeout + 30.0
            pending = refs
            while pending:
                left = deadline - time.monotonic()
                ready, pending = ray_tpu_torch.wait(
                    pending, num_returns=1, timeout=max(0.0, left))
                if not ready:
                    raise ActorError(
                        f"process group {group_name} did not form within "
                        f"{timeout:.0f}s ({len(pending)} of {n} ranks "
                        f"pending)")
                ray_tpu_torch.get(ready)  # raises the failed rank's error
        finally:
            dist.clear_group(group_name)
