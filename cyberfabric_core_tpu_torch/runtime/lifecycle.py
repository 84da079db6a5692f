"""Single-engine supervision (the port's copy of ``runtime/lifecycle.py``
``LifecycleConfig``, ``ReplicaUnavailable`` and ``EngineSupervisor``).

The worker wraps each model's one engine in an :class:`EngineSupervisor`:
when the engine breaks (its scheduler loop failed) or was closed, the next
request rebuilds it in place from the spent engine's weights under the
shared strikes / exponential-backoff / bench policy, and the first clean
stream clears the strikes. On CUDA a rebuild captures the decode graphs
anew (they belong to the engine). The replica-pool supervisor
(``ReplicaLifecycleManager``) comes with the replica pools (ROADMAP queue 1
item 5).
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import dataclass, fields
from typing import Any, Callable, Optional

logger = logging.getLogger("lifecycle")


class ReplicaUnavailable(RuntimeError):
    """The supervised engine cannot serve now (rebuild backoff, or benched
    after repeated strikes). ``retry_after_s`` is None when only an operator
    restart can help."""

    def __init__(self, msg: str, retry_after_s: Optional[float] = None):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


@dataclass
class LifecycleConfig:
    """Supervision knobs (``engine_options.lifecycle``; unknown keys raise)."""

    enabled: bool = True
    check_interval_s: float = 0.2
    #: backoff before rebuild attempt N: base · 2^(N-1), capped, ± jitter
    rebuild_backoff_s: float = 0.5
    rebuild_backoff_max_s: float = 30.0
    backoff_jitter: float = 0.25
    #: consecutive failures before the engine is benched
    max_strikes: int = 3
    probation_successes: int = 2
    probation_max_inflight: int = 1
    drain_deadline_s: float = 30.0
    seed: int = 0

    @classmethod
    def from_config(cls, raw: Any) -> "LifecycleConfig":
        if isinstance(raw, LifecycleConfig):
            return raw
        if raw is True or raw is None:
            return cls()
        if raw is False:
            return cls(enabled=False)
        if isinstance(raw, str):
            # registry options can arrive as strings: parse the words
            return cls(enabled=raw.strip().lower() not in ("0", "false", "no", "off"))
        raw = dict(raw)
        known = {f.name for f in fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(f"lifecycle: unknown fields {sorted(unknown)} "
                             f"(allowed: {sorted(known)})")
        return cls(**raw)


class _BackoffPolicy:
    def __init__(self, cfg: LifecycleConfig) -> None:
        self.cfg = cfg
        self._rng = random.Random(cfg.seed)

    def backoff(self, strikes: int) -> float:
        base = min(self.cfg.rebuild_backoff_s * (2.0 ** max(0, strikes - 1)),
                   self.cfg.rebuild_backoff_max_s)
        j = self.cfg.backoff_jitter
        return base * (1.0 + j * (2.0 * self._rng.random() - 1.0))


class EngineSupervisor:
    """Rebuild one engine in place when it breaks. Thread-safe;
    :meth:`ensure` blocks on the rebuild (callers run it off the event
    loop)."""

    def __init__(self, build: Callable[[Any], Any],
                 config: Optional[LifecycleConfig] = None, name: str = "engine") -> None:
        self._build = build
        self.config = config or LifecycleConfig()
        self.name = name
        self._lock = threading.Lock()
        self._policy = _BackoffPolicy(self.config)
        self._rebuilding = False
        self.strikes = 0
        self.benched = False
        self.backoff_until = 0.0
        self.rebuilds_ok = 0
        self.rebuilds_failed = 0
        self.last_error = ""

    def ensure(self, engine: Any) -> Any:
        """``engine`` itself when healthy, else a fresh rebuild. Raises
        :class:`ReplicaUnavailable` while benched or backing off."""
        try:
            st = engine.stats()
            broken, closed = st.get("broken"), st.get("closed")
        except Exception as e:  # noqa: BLE001 — a dead engine's stats may fail too
            broken, closed = f"stats() failed: {type(e).__name__}", False
        if not broken and not closed:
            return engine
        if not self.config.enabled:
            raise ReplicaUnavailable(
                f"engine {self.name} is broken and supervision is disabled: {broken}")
        now = time.monotonic()
        with self._lock:
            if self.benched:
                raise ReplicaUnavailable(
                    f"engine {self.name} is benched after {self.strikes} strikes; "
                    "operator restart required")
            if self._rebuilding:
                raise ReplicaUnavailable(f"engine {self.name} rebuild already in progress",
                                         retry_after_s=1.0)
            if now < self.backoff_until:
                raise ReplicaUnavailable(
                    f"engine {self.name} rebuild backing off "
                    f"({self.backoff_until - now:.2f}s left): {self.last_error}",
                    retry_after_s=round(self.backoff_until - now, 2) + 0.01)
            # claim the rebuild before releasing the lock: concurrent callers
            # back off instead of stacking rebuilds
            self.strikes += 1
            strikes = self.strikes
            self.last_error = str(broken)[:200]
            self.backoff_until = now + self._policy.backoff(strikes)
            if strikes > self.config.max_strikes:
                self.benched = True
                raise ReplicaUnavailable(
                    f"engine {self.name} benched after {strikes} strikes (crash loop: "
                    f"{self.last_error}); operator restart required")
            self._rebuilding = True
        try:
            engine.close(timeout=5.0)
        except Exception:  # noqa: BLE001 — the spent engine's close must not block the rebuild
            logger.exception("supervisor %s: close failed", self.name)
        t0 = time.monotonic()
        try:
            fresh = self._build(engine)
            fresh.start()
        except Exception as e:  # noqa: BLE001 — any build fault is one strike
            with self._lock:
                self._rebuilding = False
                self.rebuilds_failed += 1
                self.last_error = str(e)[:200]
            raise ReplicaUnavailable(
                f"engine {self.name} rebuild failed: {e}",
                retry_after_s=round(max(0.0, self.backoff_until - time.monotonic()), 2))
        with self._lock:
            self._rebuilding = False
            self.rebuilds_ok += 1
        logger.info("supervisor %s: engine rebuilt in %.2fs", self.name,
                    time.monotonic() - t0)
        return fresh

    def note_ok(self) -> None:
        """A stream served by the (possibly rebuilt) engine finished cleanly."""
        with self._lock:
            self.strikes = 0
            self.last_error = ""
