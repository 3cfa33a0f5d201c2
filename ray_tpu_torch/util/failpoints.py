"""Deterministic failpoints: named fault-injection sites (the parts of
``ray_tpu/util/failpoints.py`` the serving engine and its tests call).

Code on a load-bearing path calls ``failpoints.hit("<site>")``, which is
one dict check while nothing is armed. A test arms a site with a spec::

    <action>[:<arg>][,<selector>...]

actions: ``raise[:message]`` (raise ``FailpointError``), ``delay:<s>``
(sleep, then go on), ``hang[:<s>]`` (block until disarmed, at most <s>,
default 60), ``off``. Selectors: ``p=<float>`` (fire with this
probability a hit, from ``seeded_rng``), ``nth=<int>`` (fire on the N-th
hit only), ``once`` (disarm after the first firing).

Chaos randomness seeds from ``RAY_TPU_CHAOS_SEED`` in the environment.
"""

from __future__ import annotations

import os
import random
import threading
import time
from typing import Optional

# Every site a code path of this package hits.
SITES = frozenset({
    # serve LLM engine: admission and the decode step
    "serve.llm.before_admit",
    "serve.llm.before_step",
})

# site -> _Failpoint; ``hit`` reads it without a lock while it is empty.
_ARMED: dict = {}
_lock = threading.Lock()


class FailpointError(RuntimeError):
    """The error a ``raise`` failpoint injects."""


def seeded_rng(salt: str = "") -> random.Random:
    """A ``random.Random`` for chaos decisions: deterministic from
    ``RAY_TPU_CHAOS_SEED`` (plus a per-consumer salt), OS entropy when it
    is unset."""
    seed = os.environ.get("RAY_TPU_CHAOS_SEED", "")
    if not seed:
        return random.Random()
    return random.Random(f"{int(seed)}:{salt}")


class _Failpoint:
    __slots__ = ("site", "action", "arg", "prob", "nth", "once", "hits",
                 "rng")

    def __init__(self, site: str, spec: str):
        self.site = site
        head, *selectors = [p.strip() for p in spec.split(",")]
        action, _, arg = head.partition(":")
        action = action.strip().lower()
        if action not in ("raise", "delay", "hang", "off"):
            raise ValueError(f"failpoint {site!r}: unknown action {action!r} "
                             "(want raise|delay|hang|off)")
        self.action = action
        self.arg = arg
        if action == "delay":
            self.arg = float(arg or 0.05)
        elif action == "hang":
            self.arg = float(arg or 60.0)
        self.prob: Optional[float] = None
        self.nth: Optional[int] = None
        self.once = False
        for sel in selectors:
            if sel == "once":
                self.once = True
            elif sel.startswith("p="):
                self.prob = float(sel[2:])
            elif sel.startswith("nth="):
                self.nth = int(sel[4:])
            elif sel:
                raise ValueError(f"failpoint {site!r}: unknown selector "
                                 f"{sel!r}")
        self.hits = 0
        self.rng = seeded_rng("failpoint:" + site)

    def should_fire(self) -> bool:
        """Caller holds _lock."""
        self.hits += 1
        if self.nth is not None and self.hits != self.nth:
            return False
        return self.prob is None or self.rng.random() < self.prob


def hit(site: str) -> None:
    """Fault-injection site: a no-op unless armed."""
    if not _ARMED:
        return
    with _lock:
        fp = _ARMED.get(site)
        if fp is None or not fp.should_fire():
            return
        if fp.once and fp.action != "hang":
            _ARMED.pop(site, None)
    if fp.action == "raise":
        raise FailpointError(fp.arg or f"failpoint {site}")
    if fp.action == "delay":
        time.sleep(fp.arg)
    elif fp.action == "hang":
        # A hang ends when the site is disarmed or its time runs out;
        # ``hang,once`` disarms after it.
        deadline = time.monotonic() + fp.arg
        while time.monotonic() < deadline and _ARMED.get(site) is fp:
            time.sleep(0.05)
        if fp.once:
            with _lock:
                if _ARMED.get(site) is fp:
                    _ARMED.pop(site, None)


def arm(site: str, spec: str) -> None:
    """Arm (or re-arm) one site; a bad spec raises here, not at the site."""
    fp = _Failpoint(site, spec)
    with _lock:
        _ARMED[site] = fp


def disarm(site: str) -> bool:
    with _lock:
        return _ARMED.pop(site, None) is not None


def reset() -> None:
    """Disarm every site."""
    with _lock:
        _ARMED.clear()
