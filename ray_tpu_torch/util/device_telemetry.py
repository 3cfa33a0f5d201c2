"""Device telemetry: the CUDA devices this process uses, with their
caching allocator's memory (port of ``snapshot`` in
``ray_tpu/util/device_telemetry.py``).

What replaces XLA: the reference lists ``jax.local_devices()`` with each
device's ``memory_stats()`` and counts JAX compiles through
``jax.monitoring``. Here ``snapshot`` lists the CUDA devices by
``torch.cuda.get_device_name`` with ``torch.cuda.memory_stats`` (bytes in
use and their peak, the live allocation count) and the
device's total memory as the limit. There is no compiler to count: the
port's kernels are built by nvcc at their first use. The reference's
profiler capture (``capture`` / ``capture_to_dir``) is not ported.

As the reference never imports jax itself, ``snapshot`` never creates a
CUDA context: until something in this process has initialised CUDA it
returns a stub with no devices. The CPU is never reported as a device.
"""

from __future__ import annotations

import os
import time
from typing import Any, Dict

import torch

# memory_stats() key -> the reference's key for the same quantity.
_MEM_KEYS = {
    "allocated_bytes.all.current": "bytes_in_use",
    "allocated_bytes.all.peak": "peak_bytes_in_use",
    "allocation.all.current": "num_allocs",
}


def _stub(ts: float) -> Dict[str, Any]:
    return {"available": False, "platform": None, "devices": [], "ts": ts,
            "pid": os.getpid()}


def snapshot() -> Dict[str, Any]:
    """This process's CUDA devices: per device its index, name and memory
    (see the module docstring); a stub while CUDA is uninitialised."""
    ts = time.time()
    if not torch.cuda.is_initialized():
        return _stub(ts)
    devices = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        rec: Dict[str, Any] = {
            "id": i,
            "platform": "gpu",
            "device_kind": torch.cuda.get_device_name(i),
            "process_index": 0,
            "memory_stats": bool(stats),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
        for key, name in _MEM_KEYS.items():
            if key in stats:
                rec[name] = stats[key]
        devices.append(rec)
    return {"available": True, "platform": "gpu", "devices": devices,
            "ts": ts, "pid": os.getpid()}
