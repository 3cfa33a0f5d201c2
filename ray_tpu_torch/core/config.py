"""The settings that are set from outside the code (port of
``ray_tpu/core/config.py``; reference: ``src/ray/common/ray_config_def.h``).

``head_reconnect_window_s`` (how long a client retries a head it cannot
reach), ``cluster_token`` and ``target_block_size_bytes`` (the data
library's dynamic block splitting: a stage output larger than this is
stored as several blocks; 0 disables) each read an override from
``RAY_TPU_TORCH_<NAME>`` (the port's own prefix, so a process that runs
both packages' clusters never hands one package's token to the other)
at first access; ``config.override(name, value)`` and ``config.reset()``
set and drop values in this process. Every other setting of the
reference is a constant of the module that reads it (the worker pool's
in ``cluster/node_agent.py``, the heartbeat's in ``cluster/head.py``,
the tasks' and the object pulls' in ``cluster/client.py``); the rest
left with their subsystems (ROADMAP A4c).

Usage:
    from ray_tpu_torch.core.config import config
    window = config.head_reconnect_window_s
"""

from __future__ import annotations

import os
import threading
from typing import Any

_ENV_PREFIX = "RAY_TPU_TORCH_"

# name -> (type, default).
_DEFS: dict[str, tuple[type, Any]] = {
    "head_reconnect_window_s": (float, 15.0),
    "cluster_token": (str, ""),
    "target_block_size_bytes": (int, 128 * 1024 * 1024),
}


class _Config:
    def __init__(self):
        self._lock = threading.Lock()
        self._cache: dict[str, Any] = {}

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return self.get(name)

    def get(self, name: str):
        if name not in _DEFS:
            raise AttributeError(f"unknown config {name!r}; known: "
                                 f"{sorted(_DEFS)}")
        with self._lock:
            if name in self._cache:
                return self._cache[name]
            typ, default = _DEFS[name]
            raw = os.environ.get(_ENV_PREFIX + name.upper())
            value = default if raw is None else typ(raw)
            self._cache[name] = value
            return value

    def override(self, name: str, value) -> None:
        if name not in _DEFS:
            raise AttributeError(f"unknown config {name!r}")
        with self._lock:
            self._cache[name] = value

    def reset(self, name: str | None = None) -> None:
        with self._lock:
            if name is None:
                self._cache.clear()
            else:
                self._cache.pop(name, None)


config = _Config()
