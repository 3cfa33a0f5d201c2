"""Resource accounting: pools, demands, and blocking acquisition (port of
``ray_tpu/core/resources.py``).

Reference parity: the fixed-point resource arithmetic and per-node resource
views of ``src/ray/raylet/scheduling/cluster_resource_scheduler.cc`` and
``local_resource_manager``. We use plain floats (demands are small and
human-entered); atomicity comes from a condition variable rather than an
event loop.

The node advertises CPUs only. The reference's TPU chips have no
counterpart here, and the GPU resource (``{"GPU": n}`` per node) is not
ported yet (ROADMAP A5): a ``num_gpus`` demand is infeasible until then,
unless ``init(resources=...)`` names GPUs.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Mapping

_EPS = 1e-9


def default_node_resources(num_cpus: float | None = None) -> dict[str, float]:
    cpus = float(num_cpus if num_cpus is not None else (os.cpu_count() or 8))
    return {"CPU": cpus}


def demand_of(options: Mapping, *, is_actor: bool = False) -> dict[str, float]:
    """Resolve @remote options into a resource demand dict.

    Defaults mirror the reference (``ray_option_utils.py``): tasks take 1 CPU,
    actors take 0 (their creation cost is transient and we don't model it
    separately in-process).
    """
    demand: dict[str, float] = {}
    ncpu = options.get("num_cpus")
    if ncpu is None:
        ncpu = 0 if is_actor else 1
    if ncpu:
        demand["CPU"] = float(ncpu)
    if options.get("num_gpus"):
        demand["GPU"] = float(options["num_gpus"])
    for k, v in (options.get("resources") or {}).items():
        if v:
            demand[k] = float(v)
    return demand


class ResourcePool:
    """A named pool of fractional resources with blocking acquire.

    Used for the node's own capacity and for each placement-group bundle
    (which is capacity carved out of a node pool).
    """

    def __init__(self, total: Mapping[str, float]):
        self._total = {k: float(v) for k, v in total.items() if v > 0}
        self._avail = dict(self._total)
        self._cv = threading.Condition()

    @property
    def total(self) -> dict[str, float]:
        return dict(self._total)

    def available(self) -> dict[str, float]:
        with self._cv:
            return dict(self._avail)

    def feasible(self, demand: Mapping[str, float]) -> bool:
        return all(self._total.get(k, 0.0) + _EPS >= v for k, v in demand.items())

    def _fits(self, demand: Mapping[str, float]) -> bool:
        return all(self._avail.get(k, 0.0) + _EPS >= v for k, v in demand.items())

    def try_acquire(self, demand: Mapping[str, float]) -> bool:
        with self._cv:
            if not self._fits(demand):
                return False
            for k, v in demand.items():
                self._avail[k] = self._avail.get(k, 0.0) - v
            return True

    def acquire(self, demand: Mapping[str, float], timeout: float | None = None) -> bool:
        """Block until the demand fits, then take it. False on timeout or if
        the demand can never fit this pool (infeasible)."""
        if not demand:
            return True
        if not self.feasible(demand):
            return False
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while not self._fits(demand):
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return False
                self._cv.wait(remaining)
            for k, v in demand.items():
                self._avail[k] = self._avail.get(k, 0.0) - v
            return True

    def release(self, demand: Mapping[str, float]) -> None:
        if not demand:
            return
        with self._cv:
            for k, v in demand.items():
                self._avail[k] = min(self._total.get(k, 0.0), self._avail.get(k, 0.0) + v)
            self._cv.notify_all()
