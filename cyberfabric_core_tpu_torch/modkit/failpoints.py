"""Named failpoints, off by default (the port's copy of the part of
``modkit/failpoints.py`` its replica pools and PD handoff call).

A call site names a point (``failpoint("replicas.submit")``); a test arms it
with a spec and the next evaluations act: ``"raise"`` (every hit raises
:class:`FaultInjected`) · ``"2*raise"`` (the first two hits) · ``"off"``.
Disarmed, :func:`failpoint` costs one empty-dict check. Only the points of
:data:`FAILPOINT_CATALOG` may be armed. JAX's other actions (delays, chosen
exceptions, probabilities) and its recovery-time metrics come with the
observability slice.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator, Optional

__all__ = ["FAILPOINT_CATALOG", "FaultInjected", "arm", "disarm", "failpoint",
           "scoped", "stats"]


class FaultInjected(RuntimeError):
    """What an armed point raises."""


#: name → what the point guards
FAILPOINT_CATALOG: dict[str, str] = {
    "replicas.submit": "pool submit before routing; a raise rejects the request "
                       "before any replica sees it",
    "replicas.failover": "each failover resubmission attempt; a raise consumes one "
                         "retry (backoff, then the next)",
    "replicas.rebuild": "a lifecycle rebuild of a replica or a supervised engine; a "
                        "raise is a rebuild that fails (backoff, strikes, bench)",
    "scheduler.handoff": "a prefill-role engine's export at a stream's first token; "
                         "a raise breaks the engine and the stream fails over",
}


@dataclass
class _Armed:
    #: raise on the first ``times`` hits only (None: every hit)
    times: Optional[int] = None
    hits: int = 0
    injected: int = 0


_lock = threading.Lock()
_armed: dict[str, _Armed] = {}


def _parse(spec: str) -> Optional[_Armed]:
    text, times = spec.strip(), None
    if "*" in text:
        head, text = text.split("*", 1)
        times = int(head)
    if text == "off":
        return None
    if text != "raise":
        raise ValueError(f"unknown failpoint action {text!r} (raise, off)")
    return _Armed(times=times)


def arm(name: str, spec: str) -> None:
    if name not in FAILPOINT_CATALOG:
        raise KeyError(f"unknown failpoint {name!r}; catalog: {sorted(FAILPOINT_CATALOG)}")
    rec = _parse(spec)
    with _lock:
        if rec is None:
            _armed.pop(name, None)
        else:
            _armed[name] = rec


def disarm(name: str) -> bool:
    with _lock:
        return _armed.pop(name, None) is not None


def stats() -> dict[str, Any]:
    with _lock:
        return {"armed": {name: {"hits": r.hits, "injected": r.injected}
                          for name, r in _armed.items()}}


def failpoint(name: str) -> None:
    """Evaluate a point: nothing unless armed; armed, it may raise."""
    if not _armed:
        return
    with _lock:
        rec = _armed.get(name)
        if rec is None:
            return
        rec.hits += 1
        if rec.times is not None and rec.injected >= rec.times:
            return
        rec.injected += 1
    raise FaultInjected(f"failpoint {name!r} injected a fault")


@contextmanager
def scoped(name: str, spec: str) -> Iterator[None]:
    """Armed for the duration of a block."""
    arm(name, spec)
    try:
        yield
    finally:
        disarm(name)
