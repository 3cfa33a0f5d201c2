"""Scheduling strategies (port of ``ray_tpu/util/scheduling_strategies.py``;
reference: ``python/ray/util/scheduling_strategies.py:15,41``).

A task/actor's ``scheduling_strategy`` option is either:
  * ``"DEFAULT"`` — hybrid policy (prefer local node, spill when saturated);
  * ``"SPREAD"`` — round-robin over feasible nodes;
  * ``PlacementGroupSchedulingStrategy`` — run inside a reserved bundle;
  * ``NodeAffinitySchedulingStrategy`` — pin to a node id (soft or hard).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

DEFAULT = "DEFAULT"
SPREAD = "SPREAD"


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "object"  # PlacementGroup (avoid import cycle)
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str
    soft: bool = False

    def __post_init__(self):
        if not isinstance(self.node_id, str):
            raise TypeError("node_id must be a string")


VALID_STRING_STRATEGIES = (DEFAULT, SPREAD)


def validate_strategy(strategy) -> None:
    if strategy is None:
        return
    if isinstance(strategy, str):
        if strategy not in VALID_STRING_STRATEGIES:
            raise ValueError(
                f"invalid scheduling_strategy {strategy!r}; "
                f"expected one of {VALID_STRING_STRATEGIES} or a strategy object"
            )
        return
    if isinstance(
        strategy, (PlacementGroupSchedulingStrategy, NodeAffinitySchedulingStrategy)
    ):
        return
    raise TypeError(f"invalid scheduling_strategy: {strategy!r}")
