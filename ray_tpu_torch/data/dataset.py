"""Dataset: lazy distributed data over object-store blocks (port of
``ray_tpu/data/dataset.py``).

Reference parity (``python/ray/data/dataset.py:139``):
  * blocks live in the object store as ObjectRefs; transformations are
    ``@remote`` tasks over blocks (``_internal/remote_fn.py`` invariant);
  * the plan is LAZY with stage fusion -- consecutive one-to-one stages run
    as a single task per block (``_internal/plan.py:288``);
  * all-to-all ops (shuffle / sort / repartition) follow the two-phase
    map+reduce shape of the push-based shuffle
    (``_internal/push_based_shuffle.py``);
  * ``split(equal=True)`` yields row-balanced per-worker shards
    (``_internal/equalize.py``) for Train ingestion;
  * compute strategies: task pool (default) or an actor pool
    (``_internal/compute.py:58,173``).

``iter_device_batches`` feeds a device: batch i+1's host->device copy is
in flight on a copy stream of its own while the consumer's step uses
batch i.

What differs from the JAX module, and why:

* Every function the library itself sends to a task or an actor is a
  top-level function of this module (or of ``block.py``), bound to its
  arguments with ``functools.partial``, where the reference sends
  closures. The port sends functions by reference
  (``core/serialization.py``), so a plan whose user functions are
  importable runs on a ``Cluster`` as on the local backend; a user lambda
  fails at submit there with the port's ``PicklingError``. The local
  backend runs tasks in this process and takes lambdas, as the
  reference does.
* Dynamic block splitting: the port has no streaming returns, so a stage
  task returns its whole output block and the row boundaries of its
  pieces, and one slicing task per piece stores each piece as an object
  of its own. The blocks, their rows and the stage's stats are the
  reference's; the oversized block lives in the store until its pieces
  are made.
* ``map_batches`` also takes a callable class with an
  ``ActorPoolStrategy`` (``fn_constructor_args``): each actor of the pool
  builds one instance and calls it on every batch, as the upstream
  project's callable classes do. ``BatchPredictor`` builds its predictor
  once per actor this way.
* A shuffle or sort into one output block returns that block's rows; the
  JAX package's nests them one level too deep there (its map task's one
  return is the list of its one part), so its one row is the whole
  block.
* The iterators accrue their data waits to the port's own train session
  (``ray_tpu_torch.train.session``; a copy of the reference's lookup
  would name the JAX package's module and accrue nothing).
* ``iter_device_batches`` takes ``device`` (``cuda`` unless told
  otherwise; without CUDA it raises) and the port's ``NamedSharding``.
"""

from __future__ import annotations

import bisect
import functools
import itertools
import sys
import threading
import time
from typing import Any, Callable, Iterable, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data import block as B
from ray_tpu_torch.util import goodput as _goodput

_py_range = range  # the builtin; the public range() API below shadows it

# The module the iterators accrue their waits to (the session's data_wait
# phase). Looked up, never imported: the data path does not load the
# train package, and when it is not loaded no session can be active.
_SESSION_MODULE = "ray_tpu_torch.train.session"


def _remote_apply_split(name, fns, blk, target):
    """One task: run the fused chain of block fns, measure it, and find
    where an output bigger than ``target`` bytes splits (dynamic block
    splitting). Returns ``[block, meta]`` (two object refs via
    ``num_returns=2``: the stats never ride the block itself); the meta's
    ``cuts`` are the row boundaries of the pieces, ``[0, rows]`` for a
    block that stays whole."""
    t0 = time.perf_counter()
    for fn in fns:
        blk = fn(blk)
    cuts = B.split_cuts(blk, target)
    meta = {
        "duration_s": time.perf_counter() - t0,
        "rows": B.num_rows(blk),
        "bytes": B.size_bytes(blk),
        "splits": len(cuts) - 2,
        "cuts": cuts,
    }
    _goodput.record_block_split(name, len(cuts) - 2)
    return [blk, meta]


# -- the library's block functions (module level: they reach workers by
# reference) ----------------------------------------------------------------


def _map_rows(fn, blk):
    return B.from_rows([fn(r) for r in B.rows_of(blk)], blk)


def _flat_map_rows(fn, blk):
    rows: list = []
    for r in B.rows_of(blk):
        rows.extend(fn(r))
    return B.from_rows(rows, blk)


def _filter_rows(fn, blk):
    return B.from_rows([r for r in B.rows_of(blk) if fn(r)], blk)


def _map_batches_block(fn, batch_size, batch_format, blk):
    n = B.num_rows(blk)
    size = n if batch_size is None else batch_size
    outs = []
    for s in _py_range(0, max(n, 1), max(size, 1)):
        batch = B.to_batch(B.slice_block(blk, s, min(s + size, n)),
                           batch_format)
        outs.append(B.from_batch(fn(batch)))
        if n == 0:
            break
    return B.concat_blocks(outs) if outs else blk


def _concat_parts(*parts):
    return B.concat_blocks(list(parts))


def _repartition_split(blk, n_out):
    n = B.num_rows(blk)
    cuts = [round(i * n / n_out) for i in _py_range(n_out + 1)]
    return [B.slice_block(blk, cuts[i], cuts[i + 1])
            for i in _py_range(n_out)]


def _parts(blocks: list):
    """A map task's ``num_returns=len(blocks)`` returns: one block alone
    (a task of one return stores its value whole)."""
    return blocks if len(blocks) > 1 else blocks[0]


def _shuffle_map(blk, i, n, seed):
    rng = np.random.default_rng(None if seed is None else seed + i)
    rows = list(B.rows_of(blk))
    perm = rng.permutation(len(rows))
    parts: list = [[] for _ in _py_range(n)]
    for j, pi in enumerate(perm):
        parts[j % n].append(rows[pi])
    return _parts([B.from_rows(p, blk) for p in parts])


def _shuffle_reduce(seed, j, *parts):
    blk = B.concat_blocks(list(parts))
    rows = list(B.rows_of(blk))
    rng = np.random.default_rng(None if seed is None else seed * 7919 + j)
    rng.shuffle(rows)
    return B.from_rows(rows, blk)


def _identity(r):
    return r


class _ColumnKey:
    """The key function of a column name (``sort(key="k")``)."""

    def __init__(self, column):
        self.column = column

    def __call__(self, r):
        return r[self.column]


def _sort_sample(keyfn, blk):
    step = max(1, B.num_rows(blk) // 20)
    return [keyfn(r) for r in list(B.rows_of(blk))[::step]]


def _sort_part_map(keyfn, bounds, blk):
    parts: list = [[] for _ in _py_range(len(bounds) + 1)]
    for r in B.rows_of(blk):
        parts[bisect.bisect_right(bounds, keyfn(r))].append(r)
    return _parts([B.from_rows(p, blk) for p in parts])


def _sort_part_reduce(keyfn, descending, *parts):
    blk = B.concat_blocks(list(parts))
    rows = sorted(B.rows_of(blk), key=keyfn, reverse=descending)
    return B.from_rows(rows, blk)


def _zip_blocks(x, y):
    return [(r1, r2) for r1, r2 in zip(B.rows_of(x), B.rows_of(y))]


class _BlockWorker:
    """One actor of a ``map_batches`` actor pool. With a callable class
    (``udf_cls``) the actor builds its one instance here and every block
    it maps calls that instance."""

    def __init__(self, udf_cls=None, udf_args=()):
        self._udf = None if udf_cls is None else udf_cls(*udf_args)

    def apply(self, fn, batch_size, batch_format, blk):
        out = _map_batches_block(self._udf if fn is None else fn,
                                 batch_size, batch_format, blk)
        # (rows, bytes) rides as a tiny second return, computed where the
        # block is local: the stats probe costs no extra task.
        return [out, (B.num_rows(out), B.size_bytes(out))]


def _submit_block(pool_args, meta_by_ref, actor, blk):
    blk_ref, meta_ref = actor.apply.options(num_returns=2).remote(
        *pool_args, blk)
    meta_by_ref[blk_ref.id] = meta_ref
    return blk_ref


class _Stage:
    """One-to-one stage: fuseable block -> block function."""

    def __init__(self, name: str, fn: Callable):
        self.name = name
        self.fn = fn


class StageStats:
    """One executed stage: total wall time plus per-block duration and
    size (rows/bytes) distributions. Block samples are BOUNDED
    (``DatasetStats.MAX_BLOCK_SAMPLES``); totals stay exact."""

    __slots__ = ("name", "wall_s", "n_blocks", "block_seconds",
                 "block_rows", "block_bytes", "rows_total",
                 "bytes_total", "sampled", "extra")

    def __init__(self, name: str, wall_s: float, n_blocks: int,
                 blocks: Optional[list] = None, max_samples: int = 256,
                 extra: Optional[dict] = None):
        self.name = name
        self.wall_s = float(wall_s)
        self.n_blocks = int(n_blocks)
        # Stage-shape facts that aren't per-block samples: dynamic split
        # count, autoscaling-pool peak size / scale events.
        self.extra: dict = dict(extra or {})
        self.block_seconds: List[float] = []
        self.block_rows: List[int] = []
        self.block_bytes: List[int] = []
        self.rows_total = 0
        self.bytes_total = 0
        self.sampled = False  # True when samples were clipped
        for i, (dur, rows, nbytes) in enumerate(blocks or ()):
            self.rows_total += int(rows)
            self.bytes_total += int(nbytes)
            if i < max_samples:
                if dur is not None:  # None = duration unknown (pool)
                    self.block_seconds.append(float(dur))
                self.block_rows.append(int(rows))
                self.block_bytes.append(int(nbytes))
            else:
                self.sampled = True

    @property
    def rows_per_s(self) -> float:
        return self.rows_total / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def bytes_per_s(self) -> float:
        return self.bytes_total / self.wall_s if self.wall_s > 0 else 0.0

    def _dist(self, vals: list) -> Optional[dict]:
        if not vals:
            return None
        from ray_tpu_torch.util.metrics import percentile

        s = sorted(vals)
        return {"min": s[0], "p50": percentile(s, 0.5),
                "max": s[-1], "mean": sum(s) / len(s)}

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "wall_s": round(self.wall_s, 6),
            "n_blocks": self.n_blocks,
            "rows_total": self.rows_total,
            "bytes_total": self.bytes_total,
            "rows_per_s": round(self.rows_per_s, 1),
            "bytes_per_s": round(self.bytes_per_s, 1),
            "sampled": self.sampled,
        }
        if self.extra:
            out.update(self.extra)
        for key, vals in (("block_seconds", self.block_seconds),
                          ("block_rows", self.block_rows),
                          ("block_bytes", self.block_bytes)):
            d = self._dist(vals)
            if d:
                out[key] = d
        return out

    def summary_lines(self, index: int) -> List[str]:
        lines = [f"stage {index}: {self.name} — {self.wall_s * 1000:.1f}"
                 f" ms over {self.n_blocks} blocks"]
        if self.rows_total or self.bytes_total:
            lines.append(
                f"    {self.rows_total} rows, {self.bytes_total} bytes "
                f"({self.rows_per_s:,.0f} rows/s, "
                f"{self.bytes_per_s / 1e6:,.1f} MB/s)")
        d = self._dist(self.block_seconds)
        if d:
            clipped = " (sampled)" if self.sampled else ""
            lines.append(
                f"    per-block: min {d['min'] * 1e3:.2f} / p50 "
                f"{d['p50'] * 1e3:.2f} / max {d['max'] * 1e3:.2f} ms"
                f"{clipped}")
        if self.extra:
            lines.append("    " + ", ".join(
                f"{k}={v}" for k, v in sorted(self.extra.items())))
        return lines


class IterationStats:
    """One consumer loop over ``iter_batches``/``iter_device_batches``:
    data-wait vs consumer time, host->device transfer seconds, prefetch
    occupancy, and the derived stall fraction."""

    __slots__ = ("batches", "wait_s", "user_s", "transfer_s",
                 "occupancy", "device")

    def __init__(self, device: bool = False):
        self.batches = 0
        self.wait_s = 0.0
        self.user_s = 0.0
        self.transfer_s = 0.0
        self.occupancy: List[int] = []
        self.device = device

    @property
    def stall_fraction(self) -> float:
        denom = self.wait_s + self.user_s
        return self.wait_s / denom if denom > 0 else 0.0

    def to_dict(self) -> dict:
        out = {
            "batches": self.batches,
            "wait_s": round(self.wait_s, 6),
            "user_s": round(self.user_s, 6),
            "stall_fraction": round(self.stall_fraction, 4),
        }
        if self.device:
            out["transfer_s"] = round(self.transfer_s, 6)
        if self.occupancy:
            out["mean_occupancy"] = round(
                sum(self.occupancy) / len(self.occupancy), 2)
        return out

    def summary_line(self) -> str:
        extra = (f", transfer {self.transfer_s * 1e3:.1f} ms"
                 if self.device else "")
        return (f"iterator: {self.batches} batches, stall "
                f"{self.stall_fraction:.1%} (wait "
                f"{self.wait_s * 1e3:.1f} ms / user "
                f"{self.user_s * 1e3:.1f} ms{extra})")


class DatasetStats:
    """Structured execution stats. Derived datasets hold a parent-LINKED
    child, never a shared mutable object, so one branch's stage records
    never pollute its siblings.

    ``Dataset.stats()`` returns this object; ``summary()`` (also
    ``str()``/``in``) keeps the per-stage string format as its first line
    per stage."""

    MAX_BLOCK_SAMPLES = 256
    MAX_STAGES = 64
    MAX_ITERATIONS = 16

    def __init__(self, parents: Optional[List["DatasetStats"]] = None):
        self.stages: List[StageStats] = []
        self.parents: List["DatasetStats"] = list(parents or [])
        self.dropped_stages = 0
        self.iterations: List[IterationStats] = []

    def child(self, *extra_parents: "DatasetStats") -> "DatasetStats":
        return DatasetStats(parents=[self, *extra_parents])

    def record(self, name, seconds, n_blocks, blocks=None, extra=None):
        self.stages.append(StageStats(
            name, seconds, n_blocks, blocks,
            max_samples=self.MAX_BLOCK_SAMPLES, extra=extra))
        if len(self.stages) > self.MAX_STAGES:
            del self.stages[0]
            self.dropped_stages += 1
        _goodput.record_stage(name, seconds, blocks)

    def start_iteration(self, device: bool = False) -> IterationStats:
        it = IterationStats(device=device)
        self.iterations.append(it)
        if len(self.iterations) > self.MAX_ITERATIONS:
            del self.iterations[0]
        return it

    def lineage(self) -> List[StageStats]:
        """Stages of this dataset AND its ancestry, execution order, each
        ancestor visited once (a ``union`` of two branches of one root
        must not double-report the root)."""
        out: List[StageStats] = []
        seen: set = set()

        def walk(st: "DatasetStats"):
            if id(st) in seen:
                return
            seen.add(id(st))
            for p in st.parents:
                walk(p)
            out.extend(st.stages)

        walk(self)
        return out

    def to_dict(self) -> dict:
        out: dict = {
            "stages": [s.to_dict() for s in self.lineage()],
        }
        if self.dropped_stages:
            out["dropped_stages"] = self.dropped_stages
        if self.iterations:
            out["iterations"] = [it.to_dict() for it in self.iterations]
        return out

    def summary(self) -> str:
        lines: List[str] = []
        for i, stage in enumerate(self.lineage()):
            lines.extend(stage.summary_lines(i))
        if self.dropped_stages:
            lines.append(f"({self.dropped_stages} older stage record(s) "
                         f"dropped at the {self.MAX_STAGES}-stage cap)")
        for it in self.iterations:
            lines.append(it.summary_line())
        return "\n".join(lines) or "(no stages executed)"

    def __str__(self) -> str:
        return self.summary()

    def __contains__(self, item) -> bool:
        return item in self.summary()

    def __repr__(self) -> str:
        return (f"DatasetStats(stages={len(self.stages)}, "
                f"parents={len(self.parents)}, "
                f"iterations={len(self.iterations)})")


def _accrue_data_wait(wait: float) -> None:
    """Add consumer data-wait seconds to the active train session's
    current step, when the session module is loaded at all."""
    session = sys.modules.get(_SESSION_MODULE)
    if session is not None:
        session.add_data_wait(wait)


class _Recorder:
    """One consumer loop's per-batch accounting: ``wait`` (starved inside
    ``next()``; also the active session's ``data_wait``), ``user`` (the
    consumer's own time between batches) and the prefetch occupancy, into
    the loop's ``IterationStats`` and ``ray_tpu_data_iter_seconds``."""

    def __init__(self, it_stats: IterationStats):
        self.it = it_stats

    def wait(self, seconds: float, occupancy: Optional[int] = None) -> None:
        # Recorded BEFORE the yield so the wait lands in the step the
        # consumer is actually starved in.
        self.it.wait_s += seconds
        if occupancy is not None:
            self.it.occupancy.append(occupancy)
        _goodput.record_iter_batch(wait_s=seconds, occupancy=occupancy)
        _accrue_data_wait(seconds)

    def user(self, seconds: float) -> None:
        self.it.batches += 1
        self.it.user_s += seconds
        _goodput.record_iter_batch(user_s=seconds)


class _OccupancyRecorder(_Recorder):
    """The host batches under ``iter_device_batches``: their prefetch
    occupancy only. The consumer sees the device batches, so their wait
    and user are recorded there."""

    def wait(self, seconds: float, occupancy: Optional[int] = None) -> None:
        self.it.occupancy.append(occupancy)
        _goodput.record_iter_batch(occupancy=occupancy)

    def user(self, seconds: float) -> None:
        pass


def _contiguous_strides(shape) -> tuple:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return tuple(reversed(strides))


class _DeviceCopier:
    """Host batches -> tensors on ``device``. On a CUDA device each batch
    is written once into pinned host memory (timed with the transfer,
    it is a host copy) and copied with ``non_blocking=True`` on a stream
    of the copier's own, so the copy overlaps the consumer's kernels
    instead of queueing behind them on its stream; an event recorded
    after the copies is what ``ready`` makes the consumer's stream wait
    on, and each tensor is recorded on that stream so the caching
    allocator does not hand its memory to the copy stream while the
    consumer still reads it. On the CPU a batch is a plain copy.

    With a ``NamedSharding`` each rank copies only its own slice of the
    global batch (its coordinate on the mesh, the first mesh dimension of
    a tensor dimension the outermost, as DTensor and JAX shard) and wraps
    it with ``DTensor.from_local``, with no collective; on a mesh of one
    the slice is the whole batch."""

    def __init__(self, device, sharding, dtype):
        import torch

        self.torch = torch
        self.device = device
        self.sharding = sharding
        self.dtype = dtype
        self.stream = (torch.cuda.Stream(device) if device.type == "cuda"
                       else None)

    def _local(self, x: np.ndarray) -> np.ndarray:
        from torch.distributed.tensor import Shard

        mesh = self.sharding.mesh
        coord = mesh.get_coordinate()
        if coord is None:
            raise ValueError("this rank is not on the sharding's mesh")
        index = []
        for d in _py_range(x.ndim):
            dims = [i for i, p in enumerate(self.sharding.placements)
                    if isinstance(p, Shard) and p.dim == d]
            n, pos = 1, 0
            for i in dims:
                n *= mesh.size(i)
                pos = pos * mesh.size(i) + coord[i]
            if x.shape[d] % n:
                raise ValueError(
                    f"dimension {d} of a batch of shape {x.shape} does not "
                    f"divide over {n} ranks of {self.sharding.spec}")
            size = x.shape[d] // n
            index.append(slice(pos * size, (pos + 1) * size))
        return x[tuple(index)]

    def put(self, batch):
        """Start the copy of one host batch (a dict of columns or one
        array); returns ``(tensors, event)``, the event None on the CPU."""
        if isinstance(batch, dict):
            out = {k: self._put_one(v) for k, v in batch.items()}
        else:
            out = self._put_one(batch)
        event = None
        if self.stream is not None:
            event = self.torch.cuda.Event()
            event.record(self.stream)
        return out, event

    def _put_one(self, x):
        torch = self.torch
        x = np.asarray(x)
        if self.dtype is not None:
            x = x.astype(self.dtype)
        local = self._local(x) if self.sharding is not None else x
        if self.stream is None:
            t = torch.from_numpy(np.array(local))  # a writable copy
        else:
            dtype = torch.from_numpy(np.empty(0, local.dtype)).dtype
            host = torch.empty(local.shape, dtype=dtype, pin_memory=True)
            np.copyto(host.numpy(), local)
            with torch.cuda.stream(self.stream):
                t = host.to(self.device, non_blocking=True)
        if self.sharding is None:
            return t
        from torch.distributed.tensor import DTensor

        return DTensor.from_local(
            t, self.sharding.mesh, self.sharding.placements,
            run_check=False, shape=torch.Size(x.shape),
            stride=_contiguous_strides(x.shape))

    def ready(self, item):
        """Make the consumer's current stream wait for a batch's copy and
        return the batch."""
        tensors, event = item
        if event is None:
            return tensors
        stream = self.torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in (tensors.values() if isinstance(tensors, dict)
                  else (tensors,)):
            local = t.to_local() if self.sharding is not None else t
            local.record_stream(stream)
        return tensors


class Dataset:
    def __init__(self, blocks: List, stages: Optional[List[_Stage]] = None,
                 stats: Optional[DatasetStats] = None,
                 block_rows: Optional[List[int]] = None):
        self._blocks = blocks  # list[ObjectRef]
        self._stages: List[_Stage] = list(stages or [])
        self._stats = stats or DatasetStats()
        self._computed: Optional[List] = None if self._stages else blocks
        # Per-block row counts when the producing stage reported them
        # (task metas / pool probes): count() and split(equal=True) read
        # this instead of fanning out one num_rows task per block.
        self._block_rows = block_rows if (
            block_rows is not None and len(block_rows) == len(blocks)
        ) else None

    # -- plan execution (lazy, with stage fusion) -------------------------

    def _execute(self) -> List:
        if self._computed is not None:
            return self._computed
        fns = [s.fn for s in self._stages]
        name = "+".join(s.name for s in self._stages)
        from ray_tpu_torch.core.config import config as _config
        from ray_tpu_torch.util import tracing

        target = _config.target_block_size_bytes
        start = time.perf_counter()
        with tracing.span(f"data:{name}",
                          {"blocks": len(self._blocks)}, cat="data"):
            out, metas = self._execute_split(name, fns, target)
            wall = time.perf_counter() - start
        blocks_meta = [(m["duration_s"], m["rows"], m["bytes"])
                       for m in metas]
        splits = sum(m["splits"] for m in metas)
        block_rows = [b - a for m in metas
                      for a, b in zip(m["cuts"], m["cuts"][1:])]
        self._stats.record(name, wall, len(out), blocks=blocks_meta,
                           extra={"splits": splits} if splits else None)
        self._computed = out
        self._blocks, self._stages = out, []
        self._block_rows = block_rows
        return out

    def _execute_split(self, name: str, fns: list, target: int):
        """Run the fused chain, one task a block, and store each output
        bigger than ``target`` bytes as its pieces: one slicing task a
        piece (the port has no streaming returns). Returns
        ``(block_refs, metas)``; a failed task raises here -- the same
        user call (count/take/iter) that would have surfaced it at fetch
        time."""
        apply_task = ray_tpu_torch.remote(_remote_apply_split).options(
            num_returns=2)
        pairs = [apply_task.remote(name, fns, b, target)
                 for b in self._blocks]
        metas = ray_tpu_torch.get([p[1] for p in pairs])
        slice_task = ray_tpu_torch.remote(B.slice_block)
        out: List = []
        for (ref, _), m in zip(pairs, metas):
            cuts = m["cuts"]
            if len(cuts) == 2:
                out.append(ref)
            else:
                out.extend(slice_task.remote(ref, a, b)
                           for a, b in zip(cuts, cuts[1:]))
        if out:
            ray_tpu_torch.wait(out, num_returns=len(out), timeout=None)
        return out, metas

    def _with_stage(self, name: str, fn: Callable) -> "Dataset":
        return Dataset(self._blocks, self._stages + [_Stage(name, fn)],
                       self._stats.child())

    def materialize(self) -> "Dataset":
        self._execute()
        return self

    def stats(self) -> "DatasetStats":
        """Structured execution stats; ``str(ds.stats())`` (or substring
        ``in``) keeps the summary-string contract."""
        return self._stats

    @property
    def num_blocks(self) -> int:
        return len(self._blocks)

    # -- one-to-one transformations ---------------------------------------

    def map(self, fn: Callable) -> "Dataset":
        return self._with_stage("map", functools.partial(_map_rows, fn))

    def flat_map(self, fn: Callable) -> "Dataset":
        return self._with_stage("flat_map",
                                functools.partial(_flat_map_rows, fn))

    def filter(self, fn: Callable) -> "Dataset":
        return self._with_stage("filter", functools.partial(_filter_rows, fn))

    def map_batches(
        self,
        fn: Callable,
        *,
        batch_size: Optional[int] = None,
        batch_format: str = "numpy",
        compute: Optional["ActorPoolStrategy"] = None,
        fn_constructor_args: tuple = (),
        **_kw,
    ) -> "Dataset":
        """``fn(batch) -> batch`` over batches of ``batch_size`` rows of
        each block (the whole block when None). With ``compute`` the
        blocks stream through an autoscaling actor pool; ``fn`` may then
        be a class, of which each actor builds one instance with
        ``fn_constructor_args`` and calls it on every batch."""
        if isinstance(fn, type):
            if compute is None:
                raise ValueError("a callable class runs on an actor pool: "
                                 "pass compute=ActorPoolStrategy(...)")
            return self._map_with_actor_pool(
                (None, batch_size, batch_format), compute,
                (fn, tuple(fn_constructor_args)))
        if compute is not None:
            return self._map_with_actor_pool(
                (fn, batch_size, batch_format), compute, ())
        return self._with_stage("map_batches", functools.partial(
            _map_batches_block, fn, batch_size, batch_format))

    def _map_with_actor_pool(self, pool_args: tuple, compute,
                             worker_args: tuple) -> "Dataset":
        """ActorPoolStrategy: blocks stream through an AUTOSCALING pool of
        worker actors (``_internal/compute.py:173``) -- the pool grows on
        queue depth up to ``max_size`` and shrinks back to ``min_size`` on
        idle. Results stay in the object store as the actors' return
        refs."""
        from ray_tpu_torch.util.actor_pool import AutoscalingActorPool

        blocks = self._execute()
        worker_cls = ray_tpu_torch.remote(_BlockWorker)
        pool = AutoscalingActorPool(
            functools.partial(worker_cls.remote, *worker_args),
            min_size=min(compute.min_size, max(1, len(blocks))),
            max_size=compute.max_size,
            scale_up_queue_depth=compute.scale_up_queue_depth,
            name="map_batches(actors)")
        start = time.perf_counter()
        meta_by_ref: dict = {}
        submit = functools.partial(_submit_block, pool_args, meta_by_ref)
        try:
            for blk in blocks:
                pool.submit(submit, blk)
            out = []
            while pool.has_next():
                out.append(pool.get_next_ref())
        finally:
            wall = time.perf_counter() - start
            peak = pool.peak_size
            scale_ups = sum(1 for d, _s in pool.scale_events if d == "up")
            scale_downs = len(pool.scale_events) - scale_ups
            pool.shutdown()
        stats = self._stats.child()
        # Per-block durations are unknown on the pool path (the pool
        # interleaves blocks across actors); sizes rode along as the
        # apply calls' second returns. A failed apply raises here.
        sizes = ray_tpu_torch.get([meta_by_ref[r.id] for r in out])
        stats.record("map_batches(actors)", wall, len(out),
                     blocks=[(None, rows, nbytes) for rows, nbytes in sizes],
                     extra={"pool_peak": peak,
                            "pool_scale_ups": scale_ups,
                            "pool_scale_downs": scale_downs})
        return Dataset(out, [], stats, block_rows=[r for r, _ in sizes])

    def limit(self, n: int) -> "Dataset":
        blocks = self._execute()
        out, used = [], 0
        for ref in blocks:
            if used >= n:
                break
            blk = ray_tpu_torch.get(ref)
            take = min(n - used, B.num_rows(blk))
            out.append(ray_tpu_torch.put(B.slice_block(blk, 0, take)))
            used += take
        return Dataset(out, [], self._stats.child())

    # -- all-to-all operations --------------------------------------------

    def repartition(self, num_blocks: int) -> "Dataset":
        blocks = self._execute()
        split_task = ray_tpu_torch.remote(_repartition_split).options(
            num_returns=num_blocks)
        concat_task = ray_tpu_torch.remote(_concat_parts)
        start = time.perf_counter()
        if num_blocks == 1:
            parts_per_block = [[ref] for ref in blocks]
        else:
            parts_per_block = [split_task.remote(ref, num_blocks)
                               for ref in blocks]
        out = [concat_task.remote(*[p[j] for p in parts_per_block])
               for j in _py_range(num_blocks)]
        ray_tpu_torch.wait(out, num_returns=len(out), timeout=None)
        stats = self._stats.child()
        stats.record("repartition", time.perf_counter() - start, num_blocks)
        return Dataset(out, [], stats)

    def random_shuffle(self, *, seed: Optional[int] = None) -> "Dataset":
        """Two-phase all-to-all shuffle (push-based shuffle shape). With a
        seed, block i's map draws from ``default_rng(seed + i)`` and output
        j's reduce from ``default_rng(seed * 7919 + j)``, as in the JAX
        package, so one seed gives the same order in both."""
        blocks = self._execute()
        n_out = len(blocks)
        map_task = ray_tpu_torch.remote(_shuffle_map).options(
            num_returns=n_out)
        reduce_task = ray_tpu_torch.remote(_shuffle_reduce)
        start = time.perf_counter()
        parts = [map_task.remote(ref, i, n_out, seed)
                 for i, ref in enumerate(blocks)]
        if n_out == 1:
            parts = [[p] for p in parts]
        out = [reduce_task.remote(seed, j, *[p[j] for p in parts])
               for j in _py_range(n_out)]
        ray_tpu_torch.wait(out, num_returns=len(out), timeout=None)
        stats = self._stats.child()
        stats.record("random_shuffle", time.perf_counter() - start, n_out)
        return Dataset(out, [], stats)

    def sort(self, key: Optional[Any] = None,
             descending: bool = False) -> "Dataset":
        """Sample-partition-sort (range-partitioned distributed sort)."""
        blocks = self._execute()
        n_out = len(blocks)
        keyfn = self._make_keyfn(key)
        sample_task = ray_tpu_torch.remote(_sort_sample)
        samples = sorted(
            x for s in ray_tpu_torch.get(
                [sample_task.remote(keyfn, b) for b in blocks])
            for x in s
        )
        if not samples:
            return self
        bounds = [
            samples[int(len(samples) * (i + 1) / n_out)]
            for i in _py_range(n_out - 1)
            if int(len(samples) * (i + 1) / n_out) < len(samples)
        ]
        n_parts = len(bounds) + 1
        map_task = ray_tpu_torch.remote(_sort_part_map).options(
            num_returns=n_parts)
        reduce_task = ray_tpu_torch.remote(_sort_part_reduce)
        start = time.perf_counter()
        parts = [map_task.remote(keyfn, bounds, b) for b in blocks]
        if n_parts == 1:
            parts = [[p] for p in parts]
        out = [reduce_task.remote(keyfn, descending, *[p[j] for p in parts])
               for j in _py_range(n_parts)]
        if descending:
            out = out[::-1]
        ray_tpu_torch.wait(out, num_returns=len(out), timeout=None)
        stats = self._stats.child()
        stats.record("sort", time.perf_counter() - start, len(out))
        return Dataset(out, [], stats)

    @staticmethod
    def _make_keyfn(key):
        if key is None:
            return _identity
        if isinstance(key, str):
            return _ColumnKey(key)
        return key

    def groupby(self, key) -> "GroupedData":
        return GroupedData(self, key)

    # -- combining --------------------------------------------------------

    def union(self, other: "Dataset") -> "Dataset":
        return Dataset(self._execute() + other._execute(), [],
                       self._stats.child(other._stats))

    def zip(self, other: "Dataset") -> "Dataset":
        a, b = self._execute(), other._execute()
        if len(a) != len(b):
            return from_items(list(zip(self.take_all(), other.take_all())))
        zip_task = ray_tpu_torch.remote(_zip_blocks)
        return Dataset([zip_task.remote(x, y) for x, y in zip(a, b)], [],
                       self._stats.child(other._stats))

    def window(self, *, blocks_per_window: int = 10) -> "DatasetPipeline":
        """Windowed pipeline over this dataset's blocks: each window's plan
        executes while the previous window is consumed
        (``dataset_pipeline.py``; reference ``Dataset.window``)."""
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        return DatasetPipeline.from_dataset(self, blocks_per_window)

    def repeat(self, times: int = 2) -> "DatasetPipeline":
        """Multi-epoch pipeline (reference ``Dataset.repeat``)."""
        return self.window(blocks_per_window=max(1, len(self._blocks))
                           ).repeat(times)

    def split(self, n: int, *, equal: bool = False,
              locality_hints=None) -> List["Dataset"]:
        """N sub-datasets; ``equal=True`` balances rows exactly (Train
        per-worker shards, ``_internal/equalize.py``): each shard holds
        ``count() // n`` rows, the remainder dropped."""
        blocks = self._execute()
        if not equal:
            return [
                Dataset(blocks[i::n], [], self._stats.child(),
                        block_rows=None if self._block_rows is None
                        else self._block_rows[i::n])
                for i in _py_range(n)
            ]
        if self._block_rows is not None:
            counts = list(self._block_rows)
        else:
            rows_task = ray_tpu_torch.remote(B.num_rows)
            counts = ray_tpu_torch.get([rows_task.remote(b) for b in blocks])
        per = sum(counts) // n
        slice_task = ray_tpu_torch.remote(B.slice_block)
        shards: List[List] = [[] for _ in _py_range(n)]
        shard_rows: List[List[int]] = [[] for _ in _py_range(n)]
        shard_idx, filled = 0, 0
        for ref, cnt in zip(blocks, counts):
            offset = 0
            while offset < cnt and shard_idx < n:
                take = min(per - filled, cnt - offset)
                if take > 0:
                    shards[shard_idx].append(
                        slice_task.remote(ref, offset, offset + take))
                    shard_rows[shard_idx].append(take)
                offset += take
                filled += take
                if filled >= per:
                    shard_idx += 1
                    filled = 0
        return [Dataset(s, [], self._stats.child(), block_rows=rows)
                for s, rows in zip(shards, shard_rows)]

    # -- consumption ------------------------------------------------------

    def count(self) -> int:
        self._execute()
        if self._block_rows is not None:
            return sum(self._block_rows)
        rows_task = ray_tpu_torch.remote(B.num_rows)
        return sum(ray_tpu_torch.get(
            [rows_task.remote(b) for b in self._blocks]))

    def take(self, n: int = 20) -> list:
        out: list = []
        for ref in self._execute():
            for r in B.rows_of(ray_tpu_torch.get(ref)):
                out.append(r)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> list:
        return self.take(float("inf"))  # type: ignore[arg-type]

    def show(self, n: int = 20) -> None:
        for r in self.take(n):
            print(r)

    def schema(self):
        for ref in self._execute():
            blk = ray_tpu_torch.get(ref)
            if B.num_rows(blk):
                return B.schema_of(blk)
        return None

    def iter_rows(self) -> Iterable:
        for ref in self._execute():
            yield from B.rows_of(ray_tpu_torch.get(ref))

    def iter_batches(
        self,
        *,
        batch_size: int = 256,
        batch_format: str = "numpy",
        prefetch_blocks: int = 1,
        drop_last: bool = False,
        _recorder: Optional[_Recorder] = None,
    ) -> Iterable:
        """Batches with background block prefetch (the pipelined-ingest
        analog of ``DatasetPipeline`` windows).

        Instrumented for the goodput plane: per yielded batch the loop
        records consumer data-wait (time starved inside ``next()``) vs
        consumer time (between batches), and the prefetch-buffer occupancy
        it observed -- the derived stall fraction is the input-pipeline
        health number (``goodput.data_stats()``). Waits also accrue to the
        active train session's ``data_wait`` step phase."""
        refs = self._execute()
        rec = _recorder if _recorder is not None \
            else _Recorder(self._stats.start_iteration())
        fetched: "dict[int, Any]" = {}
        cv = threading.Condition()

        def prefetcher():
            for i, ref in enumerate(refs):
                blk = ray_tpu_torch.get(ref)
                with cv:
                    fetched[i] = blk
                    cv.notify_all()
                    while len(fetched) > prefetch_blocks + 1:
                        cv.wait(0.1)

        threading.Thread(target=prefetcher, daemon=True).start()

        # t_request marks when the consumer asked for the next batch
        # (generator resume); wait = produce-ready - t_request, user =
        # next resume - yield. Both this recorder and an outside client
        # timing next() count one wait + one user sample per yielded batch.
        t_request = time.perf_counter()
        carry: Optional[B.Block] = None
        for i in _py_range(len(refs)):
            with cv:
                while i not in fetched:
                    cv.wait(0.1)
                blk = fetched.pop(i)
                # Occupancy AFTER taking the current block: blocks the
                # producer is ahead by (0 = every batch starves).
                occ = len(fetched)
                cv.notify_all()
            if carry is not None and B.num_rows(carry):
                blk = B.concat_blocks([carry, blk])
                carry = None
            n = B.num_rows(blk)
            pos = 0
            while n - pos >= batch_size:
                batch = B.to_batch(
                    B.slice_block(blk, pos, pos + batch_size), batch_format)
                produced = time.perf_counter()
                rec.wait(produced - t_request, occ)
                yield batch
                resumed = time.perf_counter()
                rec.user(resumed - produced)
                t_request = resumed
                pos += batch_size
            if pos < n:
                carry = B.slice_block(blk, pos, n)
        if carry is not None and B.num_rows(carry) and not drop_last:
            batch = B.to_batch(carry, batch_format)
            produced = time.perf_counter()
            rec.wait(produced - t_request, 0)
            yield batch
            rec.user(time.perf_counter() - produced)

    def iter_torch_batches(
        self,
        *,
        batch_size: int = 256,
        dtypes: Optional[dict] = None,
        device: Optional[str] = None,
        prefetch_blocks: int = 1,
        drop_last: bool = False,
    ) -> Iterable:
        """Batches as torch tensors (reference ``iter_torch_batches``):
        numpy batches converted zero-copy via ``torch.as_tensor``, moved to
        ``device`` when one is named (CPU tensors otherwise). A columnar
        batch yields a dict of tensors; a plain array batch yields one
        tensor. ``dtypes``: optional per-column torch dtypes. The overlapped
        device feed is ``iter_device_batches``."""
        import torch

        def convert(name, arr):
            t = torch.as_tensor(arr)
            if dtypes and name in dtypes:
                t = t.to(dtypes[name])
            if device:
                t = t.to(device)
            return t

        for batch in self.iter_batches(
                batch_size=batch_size, batch_format="numpy",
                prefetch_blocks=prefetch_blocks, drop_last=drop_last):
            if isinstance(batch, dict):
                yield {k: convert(k, v) for k, v in batch.items()}
            else:
                yield convert(None, batch)

    def iter_device_batches(self, *, batch_size: int, sharding=None,
                            dtype=None, drop_last: bool = True,
                            device=None) -> Iterable:
        """Double-buffered host->device feeding: batch i+1's copy is in
        flight while the consumer uses batch i (see ``_DeviceCopier``).
        ``device``: ``cuda`` (this process's current CUDA device) unless
        another is named; without CUDA it raises. ``sharding``: a
        ``parallel.sharding.NamedSharding``; each rank then gets its own
        slice of every global batch as a DTensor on that mesh. ``dtype``:
        a numpy dtype every column is cast to on the host first.

        Goodput instrumentation: the host seconds of each batch's copy
        (the pinned-memory write and the dispatch) land in the
        ``transfer`` phase of ``ray_tpu_data_iter_seconds``; the
        consumer's time inside ``next()`` -- the next host batch and the
        copy's host seconds -- lands in ``wait`` and in the active train
        session's ``data_wait``, its time between batches in ``user`` (the
        copy itself is asynchronous: when the overlap works, the
        consumer's wait stays near the copy's host seconds). The device is
        resolved, and a missing CUDA raises, at the call, not at the first
        batch."""
        from ray_tpu_torch._device import resolve_device

        device = resolve_device(device)
        if device.type == "cuda" and device.index is None:
            import torch

            device = torch.device("cuda", torch.cuda.current_device())
        if sharding is not None and sharding.mesh.device_type != device.type:
            raise ValueError(f"a {sharding.mesh.device_type} mesh for batches "
                             f"on {device}")
        return self._device_batches(_DeviceCopier(device, sharding, dtype),
                                    batch_size, drop_last)

    def _device_batches(self, copier: _DeviceCopier, batch_size: int,
                        drop_last: bool) -> Iterable:
        it_stats = self._stats.start_iteration(device=True)
        rec = _Recorder(it_stats)

        def to_device(batch):
            t0 = time.perf_counter()
            try:
                return copier.put(batch)
            finally:
                dt = time.perf_counter() - t0
                it_stats.transfer_s += dt
                _goodput.record_iter_batch(transfer_s=dt)

        it = self.iter_batches(batch_size=batch_size, batch_format="numpy",
                               drop_last=drop_last,
                               _recorder=_OccupancyRecorder(it_stats))
        t_request = time.perf_counter()
        prev = None
        for batch in itertools.chain(it, [None]):
            nxt = None if batch is None else to_device(batch)  # copy starts
            if prev is not None:
                out = copier.ready(prev)
                produced = time.perf_counter()
                rec.wait(produced - t_request)
                yield out
                t_request = time.perf_counter()
                rec.user(t_request - produced)
            prev = nxt

    # -- writes -----------------------------------------------------------

    def write_parquet(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            df = B.to_batch(ray_tpu_torch.get(ref), "pandas")
            df.to_parquet(f"{path}/part-{i:05d}.parquet")

    def write_csv(self, path: str) -> None:
        import os

        os.makedirs(path, exist_ok=True)
        for i, ref in enumerate(self._execute()):
            df = B.to_batch(ray_tpu_torch.get(ref), "pandas")
            df.to_csv(f"{path}/part-{i:05d}.csv", index=False)

    def to_pandas(self):
        import pandas as pd

        dfs = [B.to_batch(ray_tpu_torch.get(r), "pandas")
               for r in self._execute()]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_arrow(self):
        """Materialize as one ``pyarrow.Table`` (reference
        ``to_arrow_refs`` flattened -- the driver-side convenience form)."""
        import pyarrow as pa

        tables = [B.to_batch(ray_tpu_torch.get(r), "pyarrow")
                  for r in self._execute()]
        tables = [t for t in tables if t.num_rows]
        return pa.concat_tables(tables) if tables else pa.table({})

    def __repr__(self) -> str:
        return (f"Dataset(num_blocks={self.num_blocks}, "
                f"stages={len(self._stages)})")


# -- hash aggregation (``Dataset.groupby``) ----------------------------------


class _Count:
    def init(self):
        return 0

    def acc(self, s, r):
        return s + 1

    def merge(self, a, b):
        return a + b

    def final(self, s):
        return s


class _On:
    """An aggregation over column ``on`` of each row (the row itself when
    None)."""

    def __init__(self, on: Optional[str]):
        self.on = on

    def val(self, r):
        return r[self.on] if self.on else r

    def final(self, s):
        return s


class _Sum(_On):
    def init(self):
        return 0

    def acc(self, s, r):
        return s + self.val(r)

    def merge(self, a, b):
        return a + b


class _Min(_On):
    def init(self):
        return None

    def acc(self, s, r):
        return self.val(r) if s is None else min(s, self.val(r))

    def merge(self, a, b):
        return min(a, b)


class _Max(_On):
    def init(self):
        return None

    def acc(self, s, r):
        return self.val(r) if s is None else max(s, self.val(r))

    def merge(self, a, b):
        return max(a, b)


class _Mean(_On):
    def init(self):
        return (0.0, 0)

    def acc(self, s, r):
        return (s[0] + self.val(r), s[1] + 1)

    def merge(self, a, b):
        return (a[0] + b[0], a[1] + b[1])

    def final(self, s):
        return s[0] / s[1]


def _agg_partial(keyfn, agg, blk):
    groups: dict = {}
    for r in B.rows_of(blk):
        k = keyfn(r)
        groups[k] = agg.acc(groups.get(k, agg.init()), r)
    return groups


def _agg_combine(agg, *partials):
    total: dict = {}
    for p in partials:
        for k, v in p.items():
            total[k] = agg.merge(total[k], v) if k in total else v
    return [{"key": k, "value": agg.final(v)}
            for k, v in sorted(total.items())]


class GroupedData:
    """Hash-aggregation over a key (``Dataset.groupby`` parity)."""

    def __init__(self, ds: Dataset, key):
        self.ds = ds
        self.keyfn = Dataset._make_keyfn(key)
        self.key = key

    def _aggregate(self, agg) -> Dataset:
        blocks = self.ds._execute()
        partial_task = ray_tpu_torch.remote(_agg_partial)
        combine_task = ray_tpu_torch.remote(_agg_combine)
        out = combine_task.remote(
            agg, *[partial_task.remote(self.keyfn, agg, b) for b in blocks])
        return Dataset([out], [], self.ds._stats.child())

    def count(self) -> Dataset:
        return self._aggregate(_Count())

    def sum(self, on: Optional[str] = None) -> Dataset:
        return self._aggregate(_Sum(on))

    def min(self, on: Optional[str] = None) -> Dataset:
        return self._aggregate(_Min(on))

    def max(self, on: Optional[str] = None) -> Dataset:
        return self._aggregate(_Max(on))

    def mean(self, on: Optional[str] = None) -> Dataset:
        return self._aggregate(_Mean(on))


class ActorPoolStrategy:
    """Compute strategy: run map stages on an AUTOSCALING pool of
    long-lived actors (``_internal/compute.py:173``): the pool starts at
    ``min_size``, adds an actor whenever a block queues behind
    ``scale_up_queue_depth`` pending blocks with no idle actor (up to
    ``max_size``), and retires surplus actors on idle."""

    def __init__(self, min_size: int = 1, max_size: int = 4, *,
                 scale_up_queue_depth: int = 2):
        self.min_size = min_size
        self.max_size = max_size
        self.scale_up_queue_depth = scale_up_queue_depth


# -- read API (``python/ray/data/read_api.py``) ------------------------------


def _to_blocks(items: list, parallelism: int) -> List:
    n = max(1, min(parallelism, len(items) or 1))
    cuts = [round(i * len(items) / n) for i in _py_range(n + 1)]
    return [ray_tpu_torch.put(items[cuts[i]:cuts[i + 1]])
            for i in _py_range(n)]


def from_items(items: list, *, parallelism: int = 8) -> Dataset:
    return Dataset(_to_blocks(list(items), parallelism))


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    return from_items(list(_py_range(n)), parallelism=parallelism)


def range_tensor(n: int, *, shape=(1,), parallelism: int = 8) -> Dataset:
    items = [np.full(shape, i) for i in _py_range(n)]
    return from_items(items, parallelism=parallelism)


def from_numpy(arr: np.ndarray, *, parallelism: int = 8) -> Dataset:
    n = max(1, min(parallelism, len(arr)))
    cuts = [round(i * len(arr) / n) for i in _py_range(n + 1)]
    return Dataset([ray_tpu_torch.put({"data": arr[cuts[i]:cuts[i + 1]]})
                    for i in _py_range(n)])


def from_arrow(tables) -> Dataset:
    """One or more ``pyarrow.Table``s -> Dataset of Arrow blocks
    (reference ``from_arrow``)."""
    if not isinstance(tables, (list, tuple)):
        tables = [tables]
    return Dataset([ray_tpu_torch.put(t) for t in tables])


def from_pandas(df, *, parallelism: int = 8) -> Dataset:
    n = max(1, min(parallelism, len(df)))
    cuts = [round(i * len(df) / n) for i in _py_range(n + 1)]
    return Dataset([
        ray_tpu_torch.put(
            {k: df[k].to_numpy()[cuts[i]:cuts[i + 1]] for k in df.columns})
        for i in _py_range(n)
    ])


def _read_dataset(name: str, load_fn: Callable, specs: list) -> Dataset:
    """Lazy read: each shard spec (path / byte range / row groups) becomes
    a tiny spec-block and the actual I/O is a fused STAGE -- so reads
    execute lazily (a windowed pipeline reads one window at a time),
    downstream maps fuse into the read task, and an oversized read output
    splits like any map output (``target_block_size_bytes``)."""
    return Dataset([ray_tpu_torch.put(spec) for spec in specs],
                   [_Stage(name, load_fn)])


def _expand_paths(paths) -> list:
    import glob
    import os

    if isinstance(paths, str):
        paths = [paths]
    out: list = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob.glob(os.path.join(p, "*"))))
        else:
            out.extend(sorted(glob.glob(p)) or [p])
    return out


def _rg_splits(files: list, parallelism: int) -> list:
    """Split parquet files into ~parallelism read tasks at ROW-GROUP
    granularity (reference: ``_internal/datasource/parquet_datasource.py``
    fragment splitting) -- a single big file still parallelizes."""
    import pyarrow.parquet as pq

    shards: list = []  # (path, row_group_index)
    for path in files:
        n = pq.ParquetFile(path).metadata.num_row_groups
        shards.extend((path, rg) for rg in _py_range(n))
    per_task = max(1, len(shards) // max(1, parallelism))
    tasks: list = []
    i = 0
    while i < len(shards):
        group = [shards[i]]
        i += 1
        # Grow the group with CONTIGUOUS row groups of the same file so
        # one task does one sequential read.
        while (len(group) < per_task and i < len(shards)
               and shards[i][0] == group[0][0]):
            group.append(shards[i])
            i += 1
        tasks.append((group[0][0], [rg for _p, rg in group]))
    return tasks


def _load_parquet(columns, spec):
    import pyarrow.parquet as pq

    path, row_groups = spec
    return pq.ParquetFile(path).read_row_groups(row_groups, columns=columns)


def read_parquet(paths, *, parallelism: int = 8,
                 columns: Optional[list] = None) -> Dataset:
    """Parquet -> ARROW blocks (the reference's default block type):
    row-group-split read tasks each return a ``pyarrow.Table``."""
    files = _expand_paths(paths)
    return _read_dataset("read_parquet",
                         functools.partial(_load_parquet, columns),
                         _rg_splits(files, parallelism))


def _byte_ranges(files: list, parallelism: int) -> list:
    """(path, start, end) splits totaling ~parallelism tasks across the
    byte span of all files; line-oriented readers snap to newline
    boundaries at read time (start seeks past its first partial line, end
    reads through the end of its last full line)."""
    import os

    sizes = [(p, os.path.getsize(p)) for p in files]
    total = sum(s for _p, s in sizes) or 1
    target = max(1, total // max(1, parallelism))
    ranges: list = []
    for path, size in sizes:
        if size == 0:
            continue
        n = max(1, min(size, round(size / target)))
        step = size / n
        for i in _py_range(n):
            start = int(i * step)
            end = int((i + 1) * step) if i < n - 1 else size
            ranges.append((path, start, end))
    return ranges


def _read_lines_range(path: str, start: int, end: int) -> list:
    """Lines whose FIRST byte lies in [start, end) -- each line is owned
    by exactly one range, so concatenating ranges reproduces the file."""
    lines = []
    with open(path, "rb") as f:
        if start > 0:
            # Only skip ahead if ``start`` lands MID-line (the line is
            # owned by the previous range).
            f.seek(start - 1)
            if f.read(1) != b"\n":
                f.readline()
        else:
            f.seek(0)
        while f.tell() < end:
            line = f.readline()
            if not line:
                break
            lines.append(line.rstrip(b"\n").decode())
    return lines


def _load_csv_file(path):
    import pandas as pd

    df = pd.read_csv(path)
    return {k: df[k].to_numpy() for k in df.columns}


def _load_csv_range(spec):
    import io

    import pandas as pd

    path, start, end, header = spec
    body = _read_lines_range(path, start, end)
    if start == 0 and body:
        body = body[1:]  # drop the header line from the data
    if not body:
        return {name: np.empty(0, dtype=object) for name in header}
    df = pd.read_csv(io.StringIO("\n".join(body)), names=header, header=None)
    return {k: df[k].to_numpy() for k in df.columns}


def _csv_header(path):
    import csv

    with open(path) as f:
        return next(csv.reader([f.readline()]))


def read_csv(paths, *, parallelism: int = 8,
             quoted_newlines: bool = False) -> Dataset:
    """Byte-range splitting assumes one record per physical line. CSVs
    with newlines INSIDE quoted fields would be mis-split -- pass
    ``quoted_newlines=True`` to fall back to one (sound) task per file for
    such data."""
    files = _expand_paths(paths)
    if quoted_newlines:
        return _read_dataset("read_csv", _load_csv_file, list(files))
    headers = {p: _csv_header(p) for p in files}
    return _read_dataset("read_csv", _load_csv_range, [
        (path, start, end, headers[path])
        for path, start, end in _byte_ranges(files, parallelism)
    ])


def _load_json(spec):
    import json

    path, start, end = spec
    return [json.loads(ln) for ln in _read_lines_range(path, start, end)
            if ln.strip()]


def read_json(paths, *, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths)
    return _read_dataset("read_json", _load_json,
                         _byte_ranges(files, parallelism))


def _load_text(spec):
    return _read_lines_range(*spec)


def read_text(paths, *, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths)
    return _read_dataset("read_text", _load_text,
                         _byte_ranges(files, parallelism))


def _load_binary(path):
    with open(path, "rb") as f:
        return [f.read()]


def read_binary_files(paths, *, parallelism: int = 8) -> Dataset:
    files = _expand_paths(paths)
    return _read_dataset("read_binary_files", _load_binary, list(files))
