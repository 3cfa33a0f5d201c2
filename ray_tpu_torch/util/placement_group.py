"""Placement groups: atomic gang reservation of resource bundles (port of
``ray_tpu/util/placement_group.py``).

Reference parity: ``python/ray/util/placement_group.py:128`` (user API) and
the GCS placement-group manager's 2-phase commit across raylets
(``src/ray/gcs/gcs_server/gcs_placement_group_scheduler.h:265``) with the
PACK/SPREAD/STRICT_PACK/STRICT_SPREAD bundle-packing policies
(``src/ray/raylet/scheduling/policy/bundle_scheduling_policy.h``).

On the local backend (one node) a group of more than one bundle under
``"STRICT_SPREAD"`` is infeasible, since it needs that many nodes.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ray_tpu_torch._private import worker as _worker

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


@dataclass
class PlacementGroup:
    """Handle to a (possibly still-pending) placement group."""

    id: str
    bundles: List[Dict[str, float]] = field(default_factory=list)
    strategy: str = "PACK"
    name: str = ""

    def ready(self):
        """ObjectRef that resolves (to this PG's id) once all bundles are
        reserved — awaitable with ray_tpu_torch.get, like the reference's
        ``PlacementGroup.ready()``."""
        return _worker.backend().placement_group_ready(self.id)

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        deadline = time.monotonic() + timeout_seconds
        while time.monotonic() < deadline:
            state = _worker.backend().placement_group_table(self.id)
            if state and state["state"] == "CREATED":
                return True
            if state and state["state"] == "INFEASIBLE":
                return False
            time.sleep(0.01)
        return False

    @property
    def bundle_specs(self) -> List[Dict[str, float]]:
        return self.bundles

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)


def placement_group(
    bundles: List[Dict[str, float]],
    strategy: str = "PACK",
    name: str = "",
    lifetime: Optional[str] = None,
    spot: bool = True,
) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}, got {strategy!r}")
    if not bundles:
        raise ValueError("placement group requires at least one bundle")
    for b in bundles:
        if not isinstance(b, dict) or not b:
            raise ValueError(f"each bundle must be a non-empty dict, got {b!r}")
        if any(v < 0 for v in b.values()):
            raise ValueError(f"bundle resources must be >= 0: {b!r}")
    pg_id = _worker.backend().create_placement_group(
        [dict(b) for b in bundles], strategy, name, lifetime, spot=spot
    )
    return PlacementGroup(pg_id, [dict(b) for b in bundles], strategy, name)


def remove_placement_group(pg: PlacementGroup) -> None:
    _worker.backend().remove_placement_group(pg.id)


def placement_group_table(pg: Optional[PlacementGroup] = None):
    """State of one PG (dict) or all PGs (dict of dicts)."""
    return _worker.backend().placement_group_table(pg.id if pg else None)


def get_current_placement_group() -> Optional[PlacementGroup]:
    """The PG capturing the current task/actor, if any (set by the runtime
    when a task runs with capture_child_tasks)."""
    info = _worker.backend().current_placement_group()
    if info is None:
        return None
    return PlacementGroup(info["id"], info["bundles"], info["strategy"], info["name"])
