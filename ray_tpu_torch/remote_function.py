"""@remote functions (port of ``ray_tpu/remote_function.py``; reference:
``python/ray/remote_function.py:35``)."""

from __future__ import annotations

import functools
from typing import Any, Callable

from ray_tpu_torch._private import worker as _worker
from ray_tpu_torch._private.options import validate_task_options


class RemoteFunction:
    def __init__(self, func: Callable, options: dict[str, Any] | None = None):
        self._func = func
        self._options = validate_task_options(options or {})
        functools.update_wrapper(self, func)

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Remote function {self._func.__name__}() cannot be called directly; "
            f"use {self._func.__name__}.remote()."
        )

    def remote(self, *args, **kwargs):
        return self._remote(args, kwargs, self._options)

    def options(self, **new_options) -> "RemoteFunction":
        merged = {**self._options, **validate_task_options(new_options)}
        return RemoteFunction(self._func, merged)

    def _remote(self, args, kwargs, options):
        refs = _worker.backend().submit_task(
            self._func, args, kwargs, **options
        )
        return refs[0] if options.get("num_returns", 1) == 1 else refs

    @property
    def func(self) -> Callable:
        return self._func
