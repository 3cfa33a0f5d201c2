"""Usage stats (port of ``ray_tpu/_private/usage.py``; reference:
``python/ray/_private/usage/usage_lib.py``).

A report of cluster shape + which libraries were imported. Differences
from the reference, deliberately: a report is only ever written to a
local JSONL file under the temp dir (the reference POSTs to a usage
endpoint); writing is DISABLED by default here -- ``write_report`` writes
only when ``RAY_TPU_TORCH_USAGE_STATS_ENABLED=1`` (the port's env prefix,
see ``core/config.py``; the reference ships enabled-by-default with an
opt-out env); and the reference's periodic reporter thread is not
ported. The report's ``source`` names this package.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from typing import Any, Dict, Set

_lock = threading.Lock()
_library_usages: Set[str] = set()
_extra_tags: Dict[str, str] = {}


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "0") == "1"


def record_library_usage(library: str) -> None:
    """Called by library entry points (train/data/serve)."""
    with _lock:
        _library_usages.add(library)


def record_extra_usage_tag(key: str, value: str) -> None:
    with _lock:
        _extra_tags[str(key)] = str(value)


def _report_path() -> str:
    return os.path.join(
        tempfile.gettempdir(), f"ray_tpu_torch_usage_{os.getuid()}.jsonl")


def generate_report() -> Dict[str, Any]:
    """The reference's UsageStatsToReport shape, trimmed to what exists."""
    import sys

    report: Dict[str, Any] = {
        "schema_version": "0.1",
        "source": "ray_tpu_torch",
        "collect_timestamp_ms": int(time.time() * 1000),
        "os": os.uname().sysname.lower(),
        "python_version": ".".join(map(str, sys.version_info[:3])),
    }
    with _lock:
        report["library_usages"] = sorted(_library_usages)
        report["extra_usage_tags"] = dict(_extra_tags)
    try:
        import ray_tpu_torch

        if ray_tpu_torch.is_initialized():
            report["total_num_nodes"] = len(ray_tpu_torch.nodes())
            report["cluster_resources"] = {
                k: float(v)
                for k, v in ray_tpu_torch.cluster_resources().items()
            }
    except Exception:
        pass
    return report


def write_report() -> str | None:
    """Append one report line locally (the zero-egress 'ping'). Returns
    the path, or None when disabled."""
    if not usage_stats_enabled():
        return None
    path = _report_path()
    try:
        with open(path, "a") as f:
            f.write(json.dumps(generate_report()) + "\n")
        return path
    except OSError:
        return None

