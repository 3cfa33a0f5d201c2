"""Spans, OTel-shaped (the parts of ``ray_tpu/util/tracing.py`` the
serving engine calls; the OpenTelemetry export is left out).

A span is a dict: hex ``trace_id``/``span_id``/``parent_id``, name, start
and end in ns, attributes, status. Finished spans collect in this
process's bounded buffer, read with ``collect`` or ``drain``.

    from ray_tpu_torch.util import tracing
    tracing.enable()                  # or RAY_TPU_TRACING_ENABLED=1
    with tracing.span("my-step", {"k": "v"}):
        ...
    spans = tracing.collect()
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

_lock = threading.Lock()
_enabled = os.environ.get("RAY_TPU_TRACING_ENABLED", "").lower() in (
    "1", "true", "yes", "on")
_finished: List[dict] = []
_MAX_SPANS = 100_000
_current = threading.local()  # .span = the thread's active span dict


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def is_enabled() -> bool:
    return _enabled


def _record(span: dict) -> None:
    with _lock:
        _finished.append(span)
        overflow = len(_finished) - _MAX_SPANS
        if overflow > 0:
            del _finished[:overflow]
    if overflow > 0:
        # No silent cap: the truncation is a counter on the scrape.
        from ray_tpu_torch.util import metrics as _metrics

        _metrics.TRACING_DROPPED_SPANS.inc(overflow,
                                           tags={"node_id": "local"})


def _current_context() -> Optional[dict]:
    s = getattr(_current, "span", None)
    if s is None:
        return None
    return {"trace_id": s["trace_id"], "span_id": s["span_id"]}


def _make_span(name: str, attributes: Optional[Dict[str, Any]],
               parent: Optional[dict], cat: Optional[str]) -> dict:
    s = {
        "trace_id": (parent or {}).get("trace_id") or os.urandom(16).hex(),
        "span_id": os.urandom(8).hex(),
        "parent_id": (parent or {}).get("span_id"),
        "name": name,
        "start_ns": time.time_ns(),
        "end_ns": None,
        "attributes": dict(attributes or {}),
        "status": "OK",
        "pid": os.getpid(),
    }
    if cat:
        s["cat"] = cat
    return s


def start_span(name: str, attributes: Optional[Dict[str, Any]] = None,
               parent: Optional[dict] = None,
               cat: Optional[str] = None) -> Optional[dict]:
    """A manually managed span (None when tracing is off): it never
    touches the thread's current span, so it can stay open across
    threads. ``parent`` None nests under this thread's active span;
    ``{}`` forces a new root. Close it with ``finish_span``."""
    if not _enabled:
        return None
    if parent is None:
        parent = _current_context()
    return _make_span(name, attributes, parent, cat)


def finish_span(s: Optional[dict], status: str = "OK") -> None:
    """End and record a ``start_span`` span."""
    if s is None:
        return
    s["end_ns"] = time.time_ns()
    if status != "OK":
        s["status"] = status
    _record(s)


@contextmanager
def span(name: str, attributes: Optional[Dict[str, Any]] = None,
         parent: Optional[dict] = None, cat: Optional[str] = None):
    """A span around the block, this thread's active span inside it;
    ``parent`` as for ``start_span``. Yields None when tracing is off."""
    if not _enabled:
        yield None
        return
    if parent is None:
        parent = _current_context()
    s = _make_span(name, attributes, parent, cat)
    prev = getattr(_current, "span", None)
    _current.span = s
    try:
        yield s
    except BaseException as e:
        s["status"] = f"ERROR: {type(e).__name__}"
        raise
    finally:
        s["end_ns"] = time.time_ns()
        _current.span = prev
        _record(s)


def collect(clear: bool = False) -> List[dict]:
    """This process's finished spans (and empty the buffer if ``clear``)."""
    with _lock:
        out = list(_finished)
        if clear:
            del _finished[:]
    return out


def drain() -> List[dict]:
    """Pop this process's finished spans."""
    return collect(clear=True)
