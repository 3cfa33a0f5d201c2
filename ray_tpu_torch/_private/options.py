"""Central option validation (port of ``ray_tpu/_private/options.py``; the
TPU resource option and streaming returns are left out)."""

from __future__ import annotations

from typing import Any

_COMMON = {
    "num_cpus": (int, float, type(None)),
    "num_gpus": (int, float, type(None)),
    "resources": (dict, type(None)),
    "num_returns": (int,),
    "max_retries": (int,),
    "retry_exceptions": (bool, tuple),
    "name": (str, type(None)),
    "runtime_env": (dict, type(None)),
    "scheduling_strategy": (object,),
    "placement_group": (object,),
    "placement_group_bundle_index": (int,),
}

_TASK_ONLY: dict[str, tuple] = {}

_ACTOR_ONLY = {
    "max_concurrency": (int,),
    "concurrency_groups": (dict, type(None)),
    "max_restarts": (int,),
    "max_task_retries": (int,),
    "lifetime": (str, type(None)),
    "namespace": (str, type(None)),
}


def _validate(options: dict[str, Any], allowed: dict[str, tuple], kind: str):
    out = {}
    for k, v in options.items():
        if v is None and k not in ("name", "lifetime", "namespace"):
            continue
        if k not in allowed:
            raise ValueError(
                f"Invalid option {k!r} for {kind}. Allowed: {sorted(allowed)}"
            )
        if not isinstance(v, allowed[k]):
            raise TypeError(f"Option {k!r} expects {allowed[k]}, got {type(v)}")
        out[k] = v
    return out


def validate_task_options(options: dict[str, Any]) -> dict[str, Any]:
    return _validate(options, {**_COMMON, **_TASK_ONLY}, "task")


def validate_actor_options(options: dict[str, Any]) -> dict[str, Any]:
    out = _validate(options, {**_COMMON, **_ACTOR_ONLY}, "actor")
    groups = out.get("concurrency_groups")
    if groups:
        for gname, n in groups.items():
            if not isinstance(gname, str) or not gname:
                raise ValueError(
                    f"concurrency_groups keys must be non-empty strings, "
                    f"got {gname!r}"
                )
            if not isinstance(n, int) or isinstance(n, bool) or n < 1:
                raise ValueError(
                    f"concurrency_groups[{gname!r}] must be a positive int "
                    f"thread count, got {n!r}"
                )
    return out
