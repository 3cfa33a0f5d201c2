"""Binary IDs for objects/tasks/actors/nodes/jobs (port of
``ray_tpu/core/ids.py``).

Reference parity: ``src/ray/common/id.h`` — Ray embeds lineage (task id +
return index) in object IDs; we keep that property so ownership and lineage
reconstruction (M-later) can recover an object's creating task from its ID
alone.

Layout (hex strings over random bytes):
  TaskID   = 16 random bytes
  ObjectID = task_id (16B) + 4B big-endian return index
  ActorID / NodeID / JobID / PlacementGroupID = 12 random bytes, prefixed.
"""

from __future__ import annotations

import os

_TASK_LEN = 16
_INDEX_LEN = 4


def new_task_id() -> str:
    return os.urandom(_TASK_LEN).hex()


def object_id_for(task_id: str, index: int) -> str:
    return task_id + index.to_bytes(_INDEX_LEN, "big").hex()


def new_object_id() -> str:
    """For ray.put — synthesizes a fresh 'put task' id with index 0."""
    return object_id_for(new_task_id(), 0)


def task_of_object(object_id: str) -> tuple[str, int]:
    tid = object_id[: _TASK_LEN * 2]
    idx = int(object_id[_TASK_LEN * 2 :], 16)
    return tid, idx


def new_actor_id() -> str:
    return "act-" + os.urandom(12).hex()


def new_node_id() -> str:
    return "node-" + os.urandom(12).hex()


def new_job_id() -> str:
    return "job-" + os.urandom(12).hex()


def new_placement_group_id() -> str:
    return "pg-" + os.urandom(12).hex()
