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
``cuda:{local_rank}``.

Surviving the loss of a node (the reference's drain and elastic gang):
an attempt's drain watcher long-polls the head's ``NODES`` feed, and when
a node hosting the group enters DRAINING (a preemption notice, a
scale-down) the attempt raises ``TrainingWorkerPreempted`` and restarts
from the latest checkpoint on healthy nodes, before the node dies. That
restart, a loss whose cause names a drain (``_lost_to_drain``) and an
elastic gang's loss the head is already rescheduling
(``_gang_migrating``) are exempt from ``FailureConfig.max_failures``.
With ``ScalingConfig.min_workers`` the trainer keeps one placement group
for the whole ``fit``: an attempt runs on its live bundles (a shrunk
world, down to ``min_workers``) and its regrow watcher raises
``TrainingGroupResized`` once the head has placed the lost bundles
again, to restart at the full size. Downtime goes to the ledger under
``drain:<reason>`` / ``preemption`` / ``reschedule`` / ``failure``, and
each restart, with the rule that classified it, to
``self.restart_history``. On
the local backend there is no head: the watchers do nothing. Left out
(ROADMAP A22): the reference's ``setup_torch`` hook of ``TorchTrainer``.
"""

from __future__ import annotations

import dataclasses
import os
import re
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
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util.placement_group import (
    get_current_placement_group,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.queue import Empty, Queue, driver_node_options
from ray_tpu_torch.util.scheduling_strategies import (
    PlacementGroupSchedulingStrategy,
)


def _lost_to_drain(exc: BaseException) -> bool:
    """Did this failure come from the cluster's drain/preemption path?
    Matched against the HEAD-generated cause formats only ("node <id>
    died: drained: …" / "node <id> draining: …"), so an application
    error that merely mentions draining can never loop the trainer."""
    return re.search(
        r"node \S+ (died: drained:|draining:)", str(exc)) is not None


class TrainingWorkerPreempted(ActorError):
    """A node hosting training workers entered DRAINING (preemption
    notice / scale-down): the attempt restarts from the latest checkpoint
    PROACTIVELY — before the node dies — instead of waiting out a
    heartbeat timeout, and the restart does not consume
    ``FailureConfig.max_failures`` (the trainer-level analog of the
    task retry-budget preemption exemption)."""


class TrainingGroupResized(ActorError):
    """An elastic gang's placement group reports restored capacity
    (the head finished rescheduling lost bundles onto healthy nodes)
    while the current attempt runs at a SHRUNK world size: restart from
    the latest checkpoint at the larger size. A planned regrow, not a
    failure — exempt from ``FailureConfig.max_failures``; its downtime
    is attributed to the ``reschedule`` cause."""


# How long the consume loop waits on the results queue before it looks at
# the drain, regrow and failure signals again.
RESULTS_POLL_S = 0.25
# How long an elastic gang's unexplained failure waits for the head to
# name it a node loss (the group RESCHEDULING) before it counts against
# max_failures: a rank whose peer's node died often fails first (its
# collective errors out), seconds before the head's heartbeat timeout
# declares the node dead. The head's ``DEAD_AFTER_S`` (5 s,
# ``cluster/head.py``) and 2 s more; a constant here, so that the trainer
# does not import the head's server module.
GANG_LOSS_GRACE_S = 7.0


@dataclass
class Result:
    metrics: Optional[dict]
    checkpoint: Optional[Checkpoint]
    error: Optional[BaseException] = None
    metrics_history: List[dict] = field(default_factory=list)
    # Downtime-ledger rollup for the whole fit(): wall_s, downtime_s,
    # by_cause (drain:<reason> / preemption / reschedule / failure),
    # restarts, goodput_pct, per-rank last step seconds + skew.
    goodput: Optional[dict] = None


class _TrainWorker:
    """Actor hosting one training worker (rank)."""

    def __init__(self, rank: int):
        self.rank = rank
        # Set by setup_cuda: the group this worker joined is the one its
        # run() destroys (on the local backend the workers are threads of
        # the driver, and a group there is the caller's, not the trainer's).
        self.joined_group = False
        # Wall times of this worker's start (``session.get_startup``).
        self.startup = {"actor": time.time()}

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
        self.startup["group"] = time.time()
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
        session_mod.init_session(
            **session_kwargs, startup={**self.startup, "run": time.time()})
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


def _captured_bundles(pg, scaling: ScalingConfig,
                      num_workers: int) -> List[int]:
    """The bundles of a captured group (a Tune trial's gang) the workers
    take: those after bundle 0 (the trial's own, as Ray Tune's
    ``PlacementGroupFactory`` puts the trainable first) that hold a
    worker's resources, in order. Raises when fewer than ``num_workers``
    do: the workers never leave the gang for other resources."""
    need = scaling.worker_resources()
    fit = [i for i, b in enumerate(pg.bundle_specs)
           if i > 0 and all(b.get(k, 0.0) >= v for k, v in need.items())]
    if len(fit) < num_workers:
        raise ValueError(
            f"the placement group {pg.id} this trainer runs in has "
            f"{len(fit)} bundles past its first for {num_workers} workers "
            f"of {need}: {pg.bundle_specs}")
    return fit[:num_workers]


class WorkerGroup:
    """N worker actors inside one placement group
    (``train/_internal/worker_group.py:92``).

    Default (fixed gang): owns a fresh group sized for the full
    ``scaling.num_workers`` -- unless the trainer runs inside a group that
    captures its children (a Tune trial's gang): then the workers take
    that group's bundles past the first (``_captured_bundles``), and the
    group stays its owner's, as in Ray Train's ``BackendExecutor``; the
    reference always makes its own group, which a trial's gang holding
    the node's only GPU would leave unplaceable (ROADMAP D36). Elastic:
    the trainer passes the ONE long-lived group it holds across attempts
    and the bundle indices this attempt runs on."""

    def __init__(self, scaling: ScalingConfig,
                 num_workers: Optional[int] = None,
                 pg=None, bundle_indices: Optional[List[int]] = None):
        self.scaling = scaling
        self.num_workers = num_workers or scaling.num_workers
        if pg is None and bundle_indices is None:
            pg = get_current_placement_group()
            if pg is not None:
                bundle_indices = _captured_bundles(pg, scaling,
                                                   self.num_workers)
        self.owns_pg = pg is None
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
        """Kill every worker (a rank stuck in a collective with a lost
        peer dies here; nothing waits on its task) and, for a fixed gang,
        remove the group. Best-effort a worker: the node of a rank may
        already be gone."""
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        if self.owns_pg:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass


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
        drain_stop = threading.Event()
        drained_nodes: set = set()
        # Subscribe to drain events BEFORE placing anything: a preemption
        # notice for a node hosting this group triggers a checkpoint-
        # restore restart while the node is still up, not after a
        # heartbeat timeout. (The watcher records every draining node;
        # the consume loop intersects with the group's nodes.)
        threading.Thread(
            target=self._watch_drains,
            args=(drained_nodes, drain_stop), daemon=True,
        ).start()
        regrow_evt: Optional[threading.Event] = None
        if pg is not None and n < self.scaling.num_workers:
            regrow_evt = threading.Event()
            threading.Thread(
                target=self._watch_regrow,
                args=(pg, n, regrow_evt, drain_stop), daemon=True,
            ).start()
        group = WorkerGroup(self.scaling, num_workers=n, pg=pg,
                            bundle_indices=bundle_indices)
        # The results queue sits on the driver's node (the one node the
        # consumer cannot outlive): a queue riding a node a preemption
        # takes would read as a budget-consuming failure.
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
            node_ranks, local_ranks, node_ids = self._compute_ranks(group)
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
                queue, run_refs, n, ckpt_mgr, metrics_history,
                drained_nodes=drained_nodes, group_nodes=set(node_ids),
                ledger=ledger, regrow_evt=regrow_evt)
        finally:
            drain_stop.set()
            queue.shutdown()
            group.shutdown()

    def _compute_ranks(self, group: WorkerGroup) -> tuple[list, list, list]:
        """node_rank + local_rank (+ raw node id) per worker, from actual
        actor placement (``backend_executor.py:339-404`` init_session
        rank layout)."""
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
        return node_ranks, local_ranks, node_ids

    def _watch_drains(self, drained_nodes: set,
                      stop_evt: threading.Event) -> None:
        """Long-poll the head's NODES pubsub feed and record every node
        that enters DRAINING, with the wall time the watcher saw it first
        (``self.drains_seen``). The local backend has no head: the watcher
        is a no-op there. The poll runs on this thread's own connection
        (``RpcClient`` keeps one a calling thread), so it never holds up
        the trainer's other head calls."""
        from ray_tpu_torch._private import worker as worker_mod

        head = getattr(worker_mod.backend(), "head", None)
        if head is None:
            return
        sub_id = f"train-drain:{ids.new_task_id()[:12]}"
        try:
            head.call("pubsub_subscribe", sub_id, "NODES")
            while not stop_evt.is_set():
                try:
                    got = head.call("pubsub_poll", sub_id, 1.0,
                                    timeout=10.0)
                except Exception:
                    return  # backend shutting down / head gone
                if got is None:
                    # Subscription TTL'd away: poll returns None
                    # instantly for an unknown sub, so re-subscribe (not
                    # re-poll) or this would hot-spin.
                    time.sleep(0.5)
                    try:
                        head.call("pubsub_subscribe", sub_id, "NODES")
                    except Exception:
                        return
                    continue
                for m in got[0]:
                    data = m.get("data") or {}
                    nid = data.get("node_id")
                    if data.get("state") == "DRAINING" and nid:
                        self.drains_seen.setdefault(nid, time.time())
                        drained_nodes.add(nid)
        finally:
            try:
                head.call("pubsub_unsubscribe", sub_id)
            except Exception:
                pass

    @staticmethod
    def _pg_table(pg) -> dict:
        return placement_group_table(pg) or {}

    def _live_bundles(self, pg) -> List[int]:
        """Bundle indices whose node is alive and schedulable right now
        (the head's table carries them; the local backend, without
        per-bundle liveness, reports all bundles once the group is
        CREATED)."""
        table = self._pg_table(pg)
        live = table.get("live_bundles")
        if live is None:
            if table.get("state") == "CREATED":
                return list(range(len(table.get("bundles") or
                                      [None] * self.scaling.num_workers)))
            return []
        return list(live)

    def _wait_live_bundles(self, pg, timeout: float = 300.0) -> List[int]:
        """Block until at least ``min_workers`` bundles have live nodes
        (the elastic floor): a gang that lost everything waits for the
        head's reschedule coordinator to land replacements rather than
        burning an attempt on an unplaceable world."""
        floor = max(1, self.scaling.min_workers or self.scaling.num_workers)
        deadline = time.monotonic() + timeout
        while True:
            live = self._live_bundles(pg)
            if len(live) >= floor:
                return sorted(live)
            state = self._pg_table(pg).get("state")
            if state in ("REMOVED", "INFEASIBLE"):
                raise RuntimeError(
                    f"elastic gang placement group is {state}")
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"elastic gang never reached min_workers={floor} "
                    f"live bundles within {timeout}s (live={live})")
            time.sleep(0.25)

    def _watch_regrow(self, pg, current_n: int,
                      regrow_evt: threading.Event,
                      stop_evt: threading.Event) -> None:
        """Poll the group's table while an attempt runs SHRUNK: the
        moment more bundles are live than the attempt is using (the
        head finished rescheduling onto a replacement node), signal the
        consume loop to restart at the larger world size."""
        while not stop_evt.is_set():
            try:
                if len(self._live_bundles(pg)) > current_n:
                    regrow_evt.set()
                    return
            except Exception:
                return  # backend shutting down
            stop_evt.wait(0.5)

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
        drained_nodes: Optional[set] = None,
        group_nodes: Optional[set] = None,
        ledger: Optional[_goodput.GoodputLedger] = None,
        regrow_evt: Optional[threading.Event] = None,
    ) -> Optional[dict]:
        """TrainingIterator: drain worker reports; rank-0 metrics win
        (``train/trainer.py:155 _fetch_next_result``). Raises
        ``TrainingWorkerPreempted`` once a node of the group is draining
        and ``TrainingGroupResized`` once a shrunk gang can regrow.

        Unlike the reference, which raises on a failed rank (or a drain,
        or a regrow) before it reads the reports already sent, the queue
        is first drained until it is empty. ``session.report`` returns
        only once the queue holds the report, so every report made before
        the failure (in the order a collective or a barrier sets between
        ranks) is read first, and a checkpoint rank 0 reported before
        another rank failed is the one the restart resumes from (ROADMAP
        R5)."""
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

        def drain_queue() -> None:
            while True:
                try:
                    msg = queue.get(block=False)
                except Empty:
                    return
                handle(msg)

        # The polls are cadence traffic: with tracing on they would make
        # spans every RESULTS_POLL_S (the reference traces no actor call,
        # the port does: ROADMAP D10), so they run suppressed.
        with _tracing.suppressed():
            while len(finished) < n:
                if drained_nodes and group_nodes and \
                        (drained_nodes & group_nodes):
                    # A worker's node is leaving (preemption/scale-down):
                    # restart from the latest checkpoint NOW, while that
                    # node still serves its objects, instead of discovering
                    # the loss via heartbeat timeout mid-step.
                    drain_queue()
                    raise TrainingWorkerPreempted(
                        "a training worker's node is draining; restarting "
                        "the group from the latest checkpoint")
                if regrow_evt is not None and regrow_evt.is_set():
                    # Capacity restored while running shrunk: re-form the
                    # collective at the larger world size from the latest
                    # checkpoint (planned, budget-exempt).
                    drain_queue()
                    raise TrainingGroupResized(
                        "gang capacity restored; regrowing the group from "
                        "the latest checkpoint")
                # Fail fast if a worker actor died (its queue would stay silent).
                ready, _ = ray_tpu_torch.wait(run_refs, num_returns=n, timeout=0.0)
                for r in ready:
                    try:
                        ray_tpu_torch.get(r)  # raises ActorError/TaskError
                    except (ActorError, TaskError):
                        drain_queue()
                        raise
                try:
                    msg = queue.get(timeout=RESULTS_POLL_S)
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
        elastic = self.scaling.min_workers is not None
        pg = None
        # The first wall time the drain watcher saw each node DRAINING.
        self.drains_seen: Dict[str, float] = {}
        # One entry a restart, in order: the wall time it was decided,
        # the exception that ended the attempt, the rule that classified
        # it ("drain_watcher" -- the watcher saw the node DRAINING before
        # the loop saw a rank die --, "regrow", "lost_to_drain",
        # "gang_migrating" or "failure"), its downtime cause and whether
        # it spared the failure budget.
        self.restart_history: List[dict] = []

        def restart(e: BaseException, via: str, cause: str) -> None:
            ledger.mark_down(cause)
            self.restart_history.append({
                "wall": time.time(), "error": type(e).__name__,
                "via": via, "cause": cause, "exempt": via != "failure"})
        # Terminal snapshot of the elastic gang's PG table (state /
        # placement / reschedule count), captured before the group is
        # released.
        self.final_pg_state: Optional[dict] = None
        if elastic:
            # ONE long-lived reservation for the whole fit(): bundle
            # loss moves it to RESCHEDULING (the head migrates bundles
            # to healthy nodes) instead of killing it — attempts shrink
            # to the live bundles and regrow when capacity returns.
            bundles = self.scaling.as_placement_group_bundles()
            pg = placement_group(
                bundles, strategy=self.scaling.placement_strategy)
            ray_tpu_torch.get(pg.ready(), timeout=120)
        try:
            while True:
                resched_before = (self._pg_table(pg).get("reschedules", 0)
                                  if pg is not None else 0)
                try:
                    last_metrics = self._run_attempt(
                        ckpt_mgr, metrics_history, ledger, pg=pg)
                    return Result(
                        metrics=last_metrics,
                        checkpoint=ckpt_mgr.best,
                        metrics_history=metrics_history,
                        goodput=ledger.summary(),
                    )
                except TrainingWorkerPreempted as e:
                    # Preemption exemption: a planned node departure
                    # restarts the group (from the latest checkpoint)
                    # WITHOUT consuming the failure budget.
                    restart(e, "drain_watcher", _goodput.downtime_cause(e))
                    time.sleep(0.2)
                except TrainingGroupResized as e:
                    # Planned regrow to restored capacity: exempt, and
                    # the restart cost is the reschedule's to carry.
                    restart(e, "regrow", "reschedule")
                    time.sleep(0.2)
                except (ActorError, TaskError) as e:
                    if _lost_to_drain(e):
                        # A group actor died WITH a draining/preempted
                        # node before the drain watcher could classify
                        # it: same exemption, same restart.
                        restart(e, "lost_to_drain",
                                _goodput.downtime_cause(e))
                        time.sleep(0.2)
                        continue
                    if elastic and self._gang_migrating(
                            pg, resched_before, GANG_LOSS_GRACE_S):
                        # A gang bundle's node died outright (a hard
                        # preemption, no notice): the reservation is
                        # RESCHEDULING, not dead. Restart shrunk from
                        # the latest checkpoint, budget intact.
                        restart(e, "gang_migrating", "preemption")
                        time.sleep(0.2)
                        continue
                    restart(e, "failure", "failure")
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
                table = self._pg_table(pg)
                if table.get("state") == "RESCHEDULING":
                    # The trial finished shrunk while the head was still
                    # migrating the lost bundles: let the reservation
                    # settle (bounded) so the terminal snapshot reflects
                    # the migration's outcome, not its midpoint.
                    settle = time.monotonic() + 20.0
                    while time.monotonic() < settle and \
                            table.get("state") == "RESCHEDULING":
                        time.sleep(0.25)
                        table = self._pg_table(pg)
                self.final_pg_state = table
                remove_placement_group(pg)

    def _gang_migrating(self, pg, resched_before: int,
                        wait_s: float = 0.0) -> bool:
        """Is this attempt's loss a gang-bundle node loss the head is
        already migrating (PG RESCHEDULING now, or a reschedule completed
        since the attempt started)? Asked again for up to ``wait_s``:
        the reference asks once, and so counts a surviving rank's
        collective error that beats the head's death verdict as a
        failure."""
        if pg is None:
            return False
        deadline = time.monotonic() + wait_s
        while True:
            table = self._pg_table(pg)
            if (table.get("state") == "RESCHEDULING"
                    or table.get("reschedules", 0) > resched_before):
                return True
            if time.monotonic() >= deadline:
                return False
            time.sleep(0.25)


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
