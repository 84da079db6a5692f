"""Named failpoints — fail-crate-style fault injection, off by default (the
port's copy of ``modkit/failpoints.py``).

In the spirit of the Rust ``fail`` crate: call sites declare a *named* point
(``failpoint("scheduler.readback")``) and a runtime policy — disarmed by
default and near-zero-cost while disarmed — can arm an :class:`Action` per
point: raise a chosen exception, inject a delay, return an error value, or
fire once / every-Nth / with-probability under a seeded RNG (deterministic
chaos: same seed → same injection schedule).

Design constraints this module owes the rest of the stack:

- **Disabled is free.** ``failpoint()``'s fast path is one empty-dict
  truthiness check; no locks, no allocation, no logging.
- **Deterministic.** Probability decisions come from one ``random.Random``
  seeded via :func:`configure`; count-based modes are pure arithmetic on the
  per-point hit counter.
- **Catalogued.** Every name must appear in :data:`FAILPOINT_CATALOG`, and
  each name owns one call site. The reference's points whose module the port
  does not serve yet are in :data:`UNPORTED_FAILPOINTS`: arming one raises
  unknown-failpoint naming the ROADMAP item that brings its module.
- **Observable.** Injections increment ``fault_injected_total{point}`` and
  recoveries feed ``fault_recovery_seconds{point}`` in the shared metrics
  registry; :func:`stats` exposes the same numbers host-side.

The async variant :func:`failpoint_async` awaits delay actions instead of
blocking the event loop; serving-tier call sites inside ``async def`` use it.
"""

from __future__ import annotations

import random
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Iterator, Optional

__all__ = [
    "Action", "FAILPOINT_CATALOG", "FaultInjected", "UNPORTED_FAILPOINTS", "arm", "armed",
    "configure", "disarm", "failpoint", "failpoint_async", "parse_action",
    "record_recovery", "register_exception", "reset", "scoped", "stats",
]


class FaultInjected(RuntimeError):
    """Default exception an armed ``raise`` action throws."""


#: the failpoint catalog: name -> (layer, description); every
#: ``failpoint("name")`` call site uses exactly one of these names.
FAILPOINT_CATALOG: dict[str, tuple[str, str]] = {
    # -- runtime ----------------------------------------------------------
    "scheduler.readback": (
        "runtime", "decode-chunk readback at the lookahead ring's drain (the "
        "scheduler's one sync point); a raise breaks the engine and "
        "error-terminates every stream, a delay stalls every round"),
    "scheduler.prefill": (
        "runtime", "single-request prefill dispatch; exercises the "
        "failed-admission slot/page reclaim path"),
    "scheduler.admit": (
        "runtime", "admission loop entry; delay throttles admission, raise "
        "breaks the engine"),
    "scheduler.page_alloc": (
        "runtime", "KV page-chain extension; an injected MemoryError forces "
        "the preempt-to-host path without real pool pressure"),
    "scheduler.prefill_chunk": (
        "runtime", "mixed-batch prefill-chunk page growth; an injected "
        "MemoryError preempts the request MID-chunked-prefill (resume "
        "continues chunking from the saved position)"),
    "scheduler.resume": (
        "runtime", "suspended-request resume; a raise error-terminates the "
        "engine mid-recovery"),
    "scheduler.handoff": (
        "runtime", "PD-disaggregation KV export on a prefill-role engine "
        "(right before the page copy); a raise breaks the prefill replica "
        "mid-handoff so the pool's failover must re-prefill the stream on "
        "a survivor"),
    "replicas.submit": (
        "runtime", "serving-pool request routing; a raise rejects the "
        "request before any replica sees it"),
    "replicas.failover": (
        "runtime", "mid-stream failover resubmission (each retry attempt); "
        "a persistent raise exhausts the jittered-backoff retries so the "
        "client sees the original error"),
    "replicas.rebuild": (
        "runtime", "lifecycle replica rebuild (pool manager and the "
        "single-engine supervisor); an armed raise models a device still "
        "too sick to rebuild on — strikes accumulate through exponential "
        "backoff until the replica is benched"),
    "federation.route": (
        "runtime", "federated host placement (prefix > load > random) in "
        "the cross-host serving pool; a raise rejects the request before "
        "any worker host is dialed — armed once, it also exercises the "
        "route-retry inside mid-stream failover"),
    # -- gateway ----------------------------------------------------------
    "gateway.request": (
        "gateway", "per-request middleware entry (inside the error-mapping "
        "layer); raise → RFC-9457 5xx, delay → timeout layer"),
    # -- modules ----------------------------------------------------------
    "llm_gateway.worker_stream": (
        "modules", "local torch worker stream entry (chat/completion job); a "
        "raise crashes the job before the engine sees it"),
    "grpc_hub.evict": (
        "modules", "directory staleness eviction tick; the evict loop must "
        "survive a failing tick"),
}


#: the reference's points whose module the port does not serve yet, by the
#: ROADMAP queue 1 item that brings it
UNPORTED_FAILPOINTS: dict[str, str] = {
    "http_client.request": "17 (the other host modules)",
    "db_engine.commit": "17 (the other host modules)",
    "oagw.upstream": "17 (the other host modules)",
    "serverless.invoke": "17 (the other host modules)",
    "serverless.tick": "17 (the other host modules)",
}


@dataclass
class Action:
    """What an armed failpoint does when it fires.

    kind:  "raise" | "delay" | "return" | "off"
    mode:  "always" | "once" (fire the first ``n`` eligible hits, then off)
           | "every_nth" (every ``n``-th hit) | "prob" (probability ``p``
           under the seeded RNG)
    after: skip this many hits before the action becomes eligible.
    """

    kind: str = "raise"
    exc: str = "FaultInjected"
    message: str = ""
    value: Any = None
    delay_s: float = 0.0
    mode: str = "always"
    n: int = 1
    p: float = 1.0
    after: int = 0

    def validate(self) -> None:
        if self.kind not in ("raise", "delay", "return", "off"):
            raise ValueError(f"unknown action kind {self.kind!r}")
        if self.mode not in ("always", "once", "every_nth", "prob"):
            raise ValueError(f"unknown action mode {self.mode!r}")
        if self.kind == "raise" and self.exc not in _EXCEPTIONS:
            raise ValueError(
                f"unknown exception {self.exc!r}; registered: "
                f"{sorted(_EXCEPTIONS)}")
        if self.n < 1:
            raise ValueError("n must be >= 1")
        if not 0.0 <= self.p <= 1.0:
            raise ValueError("p must be in [0, 1]")
        if self.after < 0:
            raise ValueError("after must be >= 0")


@dataclass
class _Armed:
    action: Action
    hits: int = 0       # evaluations since arming
    injected: int = 0   # times the action actually fired


#: exceptions an armed "raise" may throw — an allowlist, not arbitrary code:
#: the REST arming endpoint takes names, never callables. Modules register
#: their domain exceptions at import time (see http_client's ClientError).
_EXCEPTIONS: dict[str, type] = {
    "FaultInjected": FaultInjected,
    "RuntimeError": RuntimeError,
    "MemoryError": MemoryError,
    "TimeoutError": TimeoutError,
    "ConnectionError": ConnectionError,
    "OSError": OSError,
    "ValueError": ValueError,
}

_lock = threading.Lock()
_armed: dict[str, _Armed] = {}
_seed = 0
_rng = random.Random(0)
#: recovery-latency samples per point (bounded) — surfaced by stats()
_recoveries: dict[str, "deque[float]"] = {}


def register_exception(name: str, exc_type: type) -> None:
    """Allowlist a domain exception type for ``raise`` actions."""
    _EXCEPTIONS[name] = exc_type


def configure(seed: int) -> None:
    """Seed the probability RNG — same seed, same injection schedule."""
    global _seed
    with _lock:
        _seed = int(seed)
        _rng.seed(_seed)


def parse_action(spec: Any) -> Action:
    """Build an Action from an Action, a dict, or a fail-crate-style string:

    ``"off"`` · ``"raise"`` · ``"raise(MemoryError)"`` · ``"delay(0.05)"`` ·
    ``"return(503)"`` · ``"2*raise"`` (first two hits) · ``"25%raise"``
    (probability) · ``"3:raise"`` (every 3rd hit).
    """
    if isinstance(spec, Action):
        spec.validate()
        return spec
    if isinstance(spec, dict):
        action = Action(**spec)
        action.validate()
        return action
    if not isinstance(spec, str):
        raise ValueError(f"cannot parse action from {type(spec).__name__}")
    text = spec.strip()
    mode, n, p = "always", 1, 1.0
    if "%" in text:
        head, text = text.split("%", 1)
        mode, p = "prob", float(head) / 100.0
    elif "*" in text:
        head, text = text.split("*", 1)
        mode, n = "once", int(head)
    elif ":" in text and text.split(":", 1)[0].isdigit():
        head, text = text.split(":", 1)
        mode, n = "every_nth", int(head)
    kind, arg = text, ""
    if "(" in text and text.endswith(")"):
        kind, arg = text[: text.index("(")], text[text.index("(") + 1: -1]
    action = Action(kind=kind or "raise", mode=mode, n=n, p=p)
    if kind == "raise" and arg:
        action.exc = arg
    elif kind == "delay":
        action.delay_s = float(arg or 0.01)
    elif kind == "return":
        try:
            action.value = int(arg)
        except ValueError:
            action.value = arg
    action.validate()
    return action


def arm(name: str, spec: Any) -> None:
    """Arm a catalog failpoint with an action (Action | dict | string spec)."""
    if name in UNPORTED_FAILPOINTS:
        raise KeyError(f"unknown failpoint {name!r}: its module is not served by the "
                       f"port yet (ROADMAP queue 1 item {UNPORTED_FAILPOINTS[name]})")
    if name not in FAILPOINT_CATALOG:
        raise KeyError(f"unknown failpoint {name!r}; catalog: "
                       f"{sorted(FAILPOINT_CATALOG)}")
    action = parse_action(spec)
    with _lock:
        if action.kind == "off":
            _armed.pop(name, None)
        else:
            _armed[name] = _Armed(action)


def disarm(name: str) -> bool:
    with _lock:
        return _armed.pop(name, None) is not None


def reset() -> None:
    """Disarm everything and clear counters (scenario teardown)."""
    with _lock:
        _armed.clear()
        _recoveries.clear()
        _rng.seed(_seed)


def armed() -> dict[str, Action]:
    with _lock:
        return {name: rec.action for name, rec in _armed.items()}


def stats() -> dict[str, Any]:
    """Host-side telemetry mirror of the fault metrics."""
    with _lock:
        points = {
            name: {"hits": rec.hits, "injected": rec.injected,
                   "kind": rec.action.kind, "mode": rec.action.mode}
            for name, rec in _armed.items()
        }
        recoveries = {
            name: {"count": len(samples),
                   "last_s": round(samples[-1], 6) if samples else None}
            for name, samples in _recoveries.items()
        }
    return {"seed": _seed, "armed": points, "recoveries": recoveries}


def record_recovery(point: str, seconds: float) -> None:
    """Record how long a recovery path took (preempt→resume, failover, …).

    Feeds both stats() and the ``fault_recovery_seconds{point}`` histogram —
    recorded unconditionally (real recoveries count too, not only injected
    ones), so the metric doubles as steady-state recovery observability.
    """
    with _lock:
        _recoveries.setdefault(point, deque(maxlen=512)).append(seconds)
    try:
        from .metrics import default_registry

        default_registry.histogram(
            "fault_recovery_seconds",
            "Recovery-path latency (preempt/resume, failover) in seconds",
        ).observe(seconds, point=point)
    except Exception:  # noqa: BLE001 — telemetry must never fail the path
        pass


def _decide(rec: _Armed) -> bool:
    """Under _lock: advance the hit counter and decide whether to fire."""
    rec.hits += 1
    action = rec.action
    eligible = rec.hits - action.after
    if eligible <= 0:
        return False
    if action.mode == "always":
        fire = True
    elif action.mode == "once":
        fire = rec.injected < action.n
    elif action.mode == "every_nth":
        fire = eligible % action.n == 0
    else:  # prob
        fire = _rng.random() < action.p
    if fire:
        rec.injected += 1
    return fire


def _fire_prepare(name: str) -> Optional[Action]:
    """Decide + count one evaluation; returns the action iff it fires."""
    with _lock:
        rec = _armed.get(name)
        if rec is None or not _decide(rec):
            return None
        action = rec.action
    from .metrics import bump_counter

    bump_counter("fault_injected_total", point=name)
    return action


def _raise_for(name: str, action: Action) -> None:
    exc_type = _EXCEPTIONS[action.exc]
    raise exc_type(action.message
                   or f"failpoint {name!r} injected {action.exc}")


def failpoint(name: str) -> Any:
    """Evaluate a failpoint (sync call sites).

    Disarmed: returns None at the cost of one dict truthiness check. Armed:
    may raise the configured exception, sleep the configured delay, or
    return the configured value (the call site decides what a non-None
    return means).
    """
    if not _armed:  # fast path: nothing armed anywhere
        return None
    action = _fire_prepare(name)
    if action is None:
        return None
    if action.kind == "raise":
        _raise_for(name, action)
    elif action.kind == "delay":
        # fires only while explicitly armed, from a chaos rehearsal
        time.sleep(action.delay_s)
    elif action.kind == "return":
        return action.value
    return None


async def failpoint_async(name: str) -> Any:
    """Async twin of :func:`failpoint`: delay actions await instead of
    blocking the event loop."""
    if not _armed:
        return None
    action = _fire_prepare(name)
    if action is None:
        return None
    if action.kind == "raise":
        _raise_for(name, action)
    elif action.kind == "delay":
        import asyncio

        await asyncio.sleep(action.delay_s)
    elif action.kind == "return":
        return action.value
    return None


@contextmanager
def scoped(name: str, spec: Any) -> Iterator[None]:
    """Arm for the duration of a block (test ergonomics)."""
    arm(name, spec)
    try:
        yield
    finally:
        disarm(name)
