"""The serving engine's observability plane (the parts of
``ray_tpu/serve/_observability.py`` the engine and its tests call).

Each ``record_*`` call applies its observation to this process's
registry (``util/metrics.py``) at once; there is no cluster ship buffer.
Also here: the per-request context that carries a deadline and the
caller's span context to the engine, ``RequestShedError``, and the
parsed-exposition readers (re-exported from ``util/metrics.py``).
"""

from __future__ import annotations

import contextvars
from contextlib import contextmanager
from typing import Optional

from ray_tpu_torch.util import metrics as _metrics
from ray_tpu_torch.util.metrics import (  # noqa: F401  (re-exported)
    diff_parsed,
    histogram_dist,
    parse_prometheus,
    quantile_from_buckets,
    sum_counter,
)

_NODE = "local"


class RequestShedError(Exception):
    """A request whose deadline expired (or that found the queue full):
    shed instead of run, with the site's ``reason``."""

    def __init__(self, message: str, reason: str = "deadline"):
        super().__init__(message)
        self.reason = reason


_request_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "ray_tpu_torch_serve_request", default=None)


@contextmanager
def request_scope(deployment: str, deadline_ts: Optional[float],
                  trace_ctx: Optional[dict] = None):
    """Active while a request's caller runs: the engine's admission path
    reads the absolute deadline and the caller's span context from it."""
    token = _request_ctx.set({"deployment": deployment,
                              "deadline_ts": deadline_ts,
                              "trace_ctx": trace_ctx})
    try:
        yield
    finally:
        _request_ctx.reset(token)


def current_request() -> Optional[dict]:
    return _request_ctx.get()


def _tags(deployment: str, **extra) -> dict:
    return {"node_id": _NODE, "deployment": deployment, **extra}


def record_shed(deployment: str, reason: str) -> None:
    """Count one shed at the site that shed it."""
    _metrics.SERVE_SHED_TOTAL.inc(tags=_tags(deployment, reason=reason))


def record_ttft(deployment: str, seconds: float) -> None:
    """Time to first token for one admitted stream."""
    _metrics.SERVE_DECODE_TTFT_SECONDS.observe(float(seconds),
                                               tags=_tags(deployment))


def record_decode_step(deployment: str, seconds: float, occupancy: int,
                       tokens: int) -> None:
    """One decode iteration: its wall time, active slots and tokens."""
    tags = _tags(deployment)
    _metrics.SERVE_DECODE_STEP_SECONDS.observe(float(seconds), tags=tags)
    _metrics.SERVE_DECODE_BATCH_OCCUPANCY.observe(float(occupancy),
                                                  tags=tags)
    if tokens > 0:
        _metrics.SERVE_DECODE_TOKENS_TOTAL.inc(float(tokens), tags=tags)


def record_decode_itl(deployment: str, seconds: float, tokens: int) -> None:
    """Inter-token latency for one decode step: every token it produced
    arrived ``seconds`` after its stream's previous one (the slots move
    in lockstep), one observation a token."""
    if tokens > 0 and seconds >= 0:
        tags = _tags(deployment)
        for _ in range(int(tokens)):
            _metrics.SERVE_DECODE_ITL_SECONDS.observe(float(seconds),
                                                      tags=tags)


def record_decode_tokens(deployment: str, tokens: int) -> None:
    """Tokens produced outside a decode step (each admitted stream's
    first token, from the prefill lane)."""
    if tokens > 0:
        _metrics.SERVE_DECODE_TOKENS_TOTAL.inc(float(tokens),
                                               tags=_tags(deployment))


def decode_stats(parsed: dict, deployment: str) -> dict:
    """One deployment's decode rollup from a parsed exposition (empty
    when it runs no engine): TTFT quantiles, ITL median, steps, mean
    occupancy, tokens."""
    def ms(dist, q):
        v = quantile_from_buckets(dist, q)
        return round(v * 1e3, 3) if v is not None else None

    out: dict = {}
    ttft = histogram_dist(parsed, "ray_tpu_serve_decode_ttft_seconds",
                          deployment=deployment)
    if ttft:
        out["streams"] = int(ttft["count"])
        out["ttft_p50_ms"] = ms(ttft, 0.50)
        out["ttft_p99_ms"] = ms(ttft, 0.99)
    itl = histogram_dist(parsed, "ray_tpu_serve_decode_itl_seconds",
                         deployment=deployment)
    if itl:
        out["itl_p50_ms"] = ms(itl, 0.50)
    steps = histogram_dist(parsed, "ray_tpu_serve_decode_step_seconds",
                           deployment=deployment)
    if steps:
        out["steps"] = int(steps["count"])
        out["step_mean_ms"] = round(steps["sum"] / steps["count"] * 1e3, 3)
    occ = histogram_dist(parsed, "ray_tpu_serve_decode_batch_occupancy",
                         deployment=deployment)
    if occ:
        out["mean_occupancy"] = round(occ["sum"] / occ["count"], 3)
    tokens = sum_counter(parsed, "ray_tpu_serve_decode_tokens_total",
                         "deployment", deployment=deployment)
    if tokens:
        out["tokens"] = int(sum(tokens.values()))
    return out
