"""Global worker/driver state (port of ``ray_tpu/_private/worker.py``).

Holds the process-wide backend connection. ``init`` wires the local
in-process backend; the cluster backend (several processes over a control
plane) is not ported, and an address that names one raises.
"""

from __future__ import annotations

import threading
from typing import Any

_lock = threading.Lock()
_backend = None
_address: str | None = None
_init_kwargs: dict[str, Any] = {}


def init(address: str | None = None, **kwargs):
    global _backend, _address, _init_kwargs
    with _lock:
        if _backend is not None:
            if address is not None and address != _address:
                raise RuntimeError(
                    f"ray_tpu_torch is already initialized "
                    f"(address={_address!r}); call shutdown() before "
                    f"init(address={address!r})"
                )
            return _backend
        if address is not None and address != "local":
            raise NotImplementedError(
                f"address={address!r}: the cluster backend (several "
                "processes over a control plane) is not ported (ROADMAP "
                "A4b); use address=None or 'local'")
        from ray_tpu_torch.core.local_backend import LocalBackend

        _backend = LocalBackend(
            num_cpus=kwargs.get("num_cpus"),
            resources=kwargs.get("resources"),
        )
        _address = address
        _init_kwargs = kwargs
        return _backend


def backend():
    if _backend is None:
        # Auto-init, matching the reference's implicit ray.init() on first use.
        init()
    return _backend


def is_initialized() -> bool:
    return _backend is not None


def shutdown():
    global _backend
    with _lock:
        if _backend is not None:
            _backend.shutdown()
            _backend = None
