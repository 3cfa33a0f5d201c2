"""Worker-facing session API: report / get_checkpoint / ranks / shards, and
the step anatomy with MFU (port of ``ray_tpu/train/session.py``).

Reference parity: ``python/ray/air/session.py:41,94,220,345`` and the
per-worker ``_TrainSession`` (``python/ray/train/_internal/session.py:61``)
-- results flow worker -> trainer through a queue; the trainer consumes them
in ``TrainingIterator`` order.

Goodput accounting: every ``report()`` closes one STEP and decomposes the
wall time since the previous report into phases -- ``data_wait`` (accrued
by :func:`add_data_wait`), ``checkpoint_restore`` (time spent
materializing the session's start checkpoint, measured where
``to_dict``/``to_directory`` actually run), ``checkpoint_save`` /
``report`` (the synchronous hand-off inside ``report()`` itself), and
``step`` (the residual: the user's compute). Phases land in this process's
registry through ``util/goodput``, the per-rank step time feeds the
straggler gauge, and when tracing is enabled each step is a
``cat="train"`` span.

Step anatomy: a train_fn that runs its step through :func:`timed_step`
(or accrues via :func:`add_step_anatomy`) gets each report's step wall
partitioned exactly into ``data_wait`` / ``host`` (until the step function
returns: in eager PyTorch, the launches, with the device running behind
them) / ``compute`` (from there to a device sync) / ``sync`` (the
residual: this rank's wait for the slowest rank), as per-rank
``ray_tpu_step_phase_seconds`` gauges; attach the step's cost via
:func:`set_step_cost` and ``ray_tpu_mfu_percent`` is exported too.

What differs from the JAX module, and why:

* MFU divides the step's FLOPs by its synced wall, ``host + compute``,
  where the reference divides by ``compute`` alone. A jitted step is one
  dispatch and the device runs it after the dispatch returns; an eager
  step launches its kernels one by one while the device runs them, so the
  device's share of the step starts with the first launch, in ``host``.
* ``_block_sync`` synchronises every CUDA device of the step's outputs
  and lets a failed sync raise; the reference swallows its exceptions.
* The session carries the trainer's ``device`` (:func:`get_device`).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Optional

import torch

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.util import goodput as _goodput
from ray_tpu_torch.util import tracing as _tracing
from ray_tpu_torch.util import xla_cost as _xla_cost

_local = threading.local()


def _instrument_restore(ckpt: Optional[Checkpoint]):
    """Time the checkpoint's materialization calls into the ACTIVE
    session's restore accumulator (resolved at call time, so a
    checkpoint shared across local-backend worker threads attributes
    each restore to the rank that performed it)."""
    if ckpt is None or getattr(ckpt, "_rt_restore_timed", False):
        return ckpt
    for name in ("to_dict", "to_directory"):
        orig = getattr(ckpt, name)

        def timed(*a, _orig=orig, **k):
            # Reentrancy guard: to_directory calls to_dict internally --
            # the restore must count once, not nested-twice.
            if getattr(_local, "_in_restore", False):
                return _orig(*a, **k)
            _local._in_restore = True
            s = getattr(_local, "session", None)
            sp = _tracing.start_span(
                "train.checkpoint_restore",
                {"trial": s.trial, "rank": s.world_rank}
                if s is not None else None,
                cat="train")
            t0 = time.perf_counter()
            try:
                return _orig(*a, **k)
            finally:
                _local._in_restore = False
                _tracing.finish_span(sp)
                s = getattr(_local, "session", None)
                if s is not None:
                    s._restore_s += time.perf_counter() - t0

        setattr(ckpt, name, timed)
    ckpt._rt_restore_timed = True
    return ckpt


class _Session:
    def __init__(self, world_rank, world_size, local_rank, node_rank,
                 results_queue, checkpoint, dataset_shards, trial_info=None,
                 device=None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.node_rank = node_rank
        self.results_queue = results_queue
        self.checkpoint = _instrument_restore(checkpoint)
        self.dataset_shards = dataset_shards or {}
        self.trial_info = trial_info
        self.device = device
        self.trial = (trial_info or {}).get("trial_id") or "train"
        self.iteration = 0
        self._phase_t0 = time.perf_counter()
        self._data_wait_s = 0.0
        self._restore_s = 0.0
        # Step-anatomy accruals (only populated by the instrumented
        # step path -- timed_step / add_step_anatomy; a plain train_fn
        # keeps the classic data_wait/step residual accounting).
        self._host_s = 0.0
        self._compute_s = 0.0
        self._anat_steps = 0
        self._anat_recorded = False
        # Cost model attached via set_step_cost: per-step FLOPs for
        # this rank (util/xla_cost).
        self._step_flops = 0.0
        self._cost_kind: Optional[str] = None
        self._cost_devs = 1
        self._step_span = None
        self._open_step_span()

    def _open_step_span(self):
        self._step_span = _tracing.start_span(
            "train.step",
            {"trial": self.trial, "rank": self.world_rank,
             "iteration": self.iteration + 1},
            cat="train")

    def report(self, metrics: dict, checkpoint: Optional[Checkpoint] = None):
        now = time.perf_counter()
        self.iteration += 1
        interval = max(0.0, now - self._phase_t0)
        data_wait = min(self._data_wait_s, interval)
        self._data_wait_s = 0.0
        restore = min(self._restore_s, max(0.0, interval - data_wait))
        self._restore_s = 0.0
        step = max(0.0, interval - data_wait - restore)
        payload = {
            "type": "report",
            "rank": self.world_rank,
            "iteration": self.iteration,
            "metrics": dict(metrics),
            "checkpoint": checkpoint,
            "trial_info": self.trial_info,
            "ts": time.time(),
            "phases": {"data_wait": data_wait, "step": step,
                       "checkpoint_restore": restore},
        }
        ckpt_span = _tracing.start_span(
            "train.checkpoint_save",
            {"trial": self.trial, "rank": self.world_rank,
             "iteration": self.iteration},
            cat="train") if checkpoint is not None else None
        try:
            self.results_queue.put(payload)
        finally:
            _tracing.finish_span(ckpt_span)
        # The synchronous hand-off (the queue put, checkpoint attached).
        hand_off = max(0.0, time.perf_counter() - now)
        phases = {"step": step}
        if data_wait > 0:
            phases["data_wait"] = data_wait
        if restore > 0:
            phases["checkpoint_restore"] = restore
        if checkpoint is not None:
            phases["checkpoint_save"] = hand_off
        else:
            phases["report"] = hand_off
        _goodput.record_step(self.trial, self.world_rank, phases)
        if self._anat_recorded:
            # Anatomy partition of the step wall (interval minus the
            # checkpoint-restore traffic): data_wait + host + compute
            # + sync == wall exactly -- sync is the residual, i.e. the
            # wall time not attributable to this rank's own input/
            # dispatch/device work: its wait for the slowest rank.
            wall = max(0.0, interval - restore)
            host = min(self._host_s, max(0.0, wall - data_wait))
            compute = min(self._compute_s,
                          max(0.0, wall - data_wait - host))
            sync = max(0.0, wall - data_wait - host - compute)
            mfu = None
            if self._step_flops > 0 and host + compute > 0:
                mfu = _xla_cost.mfu_percent(
                    self._step_flops * max(1, self._anat_steps),
                    host + compute, device_kind=self._cost_kind,
                    n_devices=self._cost_devs)
            _goodput.record_anatomy(
                self.trial, self.world_rank,
                {"data_wait": data_wait, "host": host,
                 "compute": compute, "sync": sync}, mfu=mfu)
        self._host_s = 0.0
        self._compute_s = 0.0
        self._anat_steps = 0
        self._anat_recorded = False
        _tracing.finish_span(self._step_span)
        self._open_step_span()
        self._phase_t0 = time.perf_counter()


def init_session(**kwargs) -> None:
    _local.session = _Session(**kwargs)


def shutdown_session() -> None:
    _local.session = None


def _session() -> _Session:
    s = getattr(_local, "session", None)
    if s is None:
        raise RuntimeError(
            "No train session active: this API must be called inside "
            "train_loop_per_worker."
        )
    return s


def report(metrics: dict, checkpoint: Optional[Checkpoint] = None) -> None:
    _session().report(metrics, checkpoint)


def get_checkpoint() -> Optional[Checkpoint]:
    return _session().checkpoint


def get_world_rank() -> int:
    return _session().world_rank


def get_world_size() -> int:
    return _session().world_size


def get_local_rank() -> int:
    return _session().local_rank


def get_node_rank() -> int:
    return _session().node_rank


def get_dataset_shard(name: str = "train"):
    return _session().dataset_shards.get(name)


def get_trial_info():
    return _session().trial_info


def get_device() -> Optional[torch.device]:
    """The device the trainer runs this worker on (``CudaTrainer``: cuda
    unless it was given ``device="cpu"``); None under a trainer that names
    no device."""
    return _session().device


def in_session() -> bool:
    return getattr(_local, "session", None) is not None


def add_data_wait(seconds: float) -> None:
    """Accrue consumer data-wait seconds to the active session's current
    step (a no-op outside a train session)."""
    s = getattr(_local, "session", None)
    if s is not None and seconds > 0:
        s._data_wait_s += seconds


def _cuda_devices(out: Any, found: set) -> set:
    if isinstance(out, torch.Tensor):
        if out.is_cuda:
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _block_sync(out: Any) -> Any:
    """Force device completion of a step's outputs: the anatomy compute
    phase must end at a real sync, never at async dispatch. Synchronises
    every CUDA device that holds a tensor of ``out`` (nested dicts, lists
    and tuples); a no-op when ``out`` holds no CUDA tensor. A failed sync
    raises."""
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out


def add_step_anatomy(host_s: float, compute_s: float) -> None:
    """Accrue one instrumented step's host (until the step function
    returns) and compute (from there to a device sync) seconds to the
    active session's current report interval. ``report()`` then
    partitions the step wall into data_wait / host / compute / sync --
    sync is the residual, this rank's wait for the slowest rank. A no-op
    outside a train session."""
    s = getattr(_local, "session", None)
    if s is None:
        return
    s._host_s += max(0.0, float(host_s))
    s._compute_s += max(0.0, float(compute_s))
    s._anat_steps += 1
    s._anat_recorded = True


def timed_step(step_fn, *args: Any, **kwargs: Any):  # step-timed
    """Run one training-step call with anatomy timing: host = wall until
    the step function returns, compute = wall from there until a real
    device sync completes. Returns the step's outputs (synced)."""
    t0 = time.perf_counter()
    out = step_fn(*args, **kwargs)
    host = time.perf_counter() - t0
    _block_sync(out)
    compute = time.perf_counter() - t0 - host
    add_step_anatomy(host, compute)
    return out


def set_step_cost(cost, device_kind: Optional[str] = None,
                  n_devices: int = 1) -> None:
    """Attach the per-step cost model for this rank so ``report()`` can
    export MFU: ``cost`` is either FLOPs per step (a number) or the dict
    returned by ``xla_cost.step_cost`` on the step function. A no-op
    outside a train session or when the cost dict is a stub."""
    s = getattr(_local, "session", None)
    if s is None:
        return
    if isinstance(cost, dict):
        if not cost.get("available"):
            return
        if device_kind is None:
            device_kind = cost.get("device_kind")
        cost = cost.get("flops", 0.0)
    s._step_flops = max(0.0, float(cost or 0.0))
    s._cost_kind = device_kind
    s._cost_devs = max(1, int(n_devices))
