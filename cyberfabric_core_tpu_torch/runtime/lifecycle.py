"""Replica supervision (the port's copy of ``runtime/lifecycle.py``):
self-healing serving capacity.

- :class:`ReplicaLifecycleManager` supervises a replica pool
  (:mod:`.replicas`, :mod:`.pd`). A daemon thread (or a test calling
  :meth:`~ReplicaLifecycleManager.tick`) walks every replica on a short
  cadence and drives its state machine::

      healthy ──break──▶ quarantined ──backoff──▶ rebuilding ──ok──▶ probation
         ▲                    ▲                        │                 │
         │                    └──── rebuild failed ────┘                 │
         │                    └──── canary errored ──────────────────────┤
         └──────────────────────── probation successes ──────────────────┘
      healthy ──drain──▶ draining ──idle/deadline──▶ drained ──restart──▶ …
      quarantined ── strikes > max ──▶ benched ──operator restart──▶ …

  A rebuild builds a fresh engine on the same device from the spent
  engine's params (``pool.build_replica``): no weight load, and on CUDA the
  new engine captures its own decode graphs. A rebuilt replica takes at
  most ``probation_max_inflight`` canary requests at a time until
  ``probation_successes`` clean terminals promote it; a canary error or a
  new break quarantines it again with exponential, jittered backoff, and
  ``max_strikes`` consecutive failures bench it until an operator
  ``restart``. ``drain`` takes a replica out of routing and lets its
  requests finish; past the deadline its engine is closed and the
  stragglers fail over in the pool. ``undrain`` returns a still-draining
  replica; ``restart`` closes and rebuilds from any state.

- :class:`EngineSupervisor`: the single engine of a worker entry rebuilt in
  place under the same strikes / backoff / bench policy, the first clean
  stream clearing the strikes.

The tick never raises out, and engine close / build / start run outside
the manager's lock. Drains and rebuilds land in the flight recorder under
JAX's episode ids (``pool1/replica0/drain-2``: ``drain_begin`` …
``drain_end``; ``replica_rebuilt``), rebuild outcomes in
``llm_replica_rebuilds_total``; :meth:`ReplicaLifecycleManager.status`
keeps the counts.
"""

from __future__ import annotations

import itertools
import logging
import random
import threading
import time
import weakref
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Optional

from ..modkit.failpoints import failpoint, record_recovery
from ..modkit.flight_recorder import record_event
from ..modkit.metrics import bump_counter

__all__ = ["STATES", "EngineSupervisor", "LifecycleConfig", "LifecycleStateError",
           "ReplicaLifecycleManager", "ReplicaUnavailable"]

logger = logging.getLogger("lifecycle")

#: the per-replica states (the status() / counts() vocabulary)
STATES = ("healthy", "quarantined", "rebuilding", "probation",
          "draining", "drained", "benched")

#: tells the pools of one process apart in their names
_POOL_SEQ = itertools.count(1)


class LifecycleStateError(RuntimeError):
    """A control-plane action illegal from the replica's current state."""


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


@dataclass
class _ReplicaRecord:
    state: str = "healthy"
    strikes: int = 0
    backoff_until: float = 0.0
    last_error: str = ""
    rebuilds: int = 0
    probation_ok: int = 0
    probation_inflight: int = 0
    drain_deadline: float = 0.0
    #: flight-recorder episode ids (``pool1/replica0/drain-2``): a drain is
    #: a live row from drain_begin to drain_end, a rebuild one closed record
    drain_episode: int = 0
    rebuild_episode: int = 0
    drain_eid: Optional[str] = None
    #: a bounded (state, time) walk
    history: list = field(default_factory=list)

    def walk(self, state: str) -> None:
        self.state = state
        self.history.append((state, round(time.time(), 3)))
        del self.history[:-32]


class ReplicaLifecycleManager:
    """Supervises one replica pool. The pool gives ``pool.replicas`` (item
    assignment commits a rebuild) and ``pool.build_replica(idx)``; it calls
    the routing hooks (:meth:`admit_allowed`, :meth:`canary_wanted`,
    :meth:`note_dispatch`, :meth:`on_terminal`, :meth:`on_departed`) from
    its submit and emit paths, O(1) under the lock."""

    def __init__(self, pool: Any, config: Optional[LifecycleConfig] = None,
                 name: Optional[str] = None) -> None:
        # the pool owns this manager: a weak reference keeps the two out of a
        # reference cycle, so a closed pool's replicas (their KV pools and
        # graphs) are freed as soon as the pool is dropped, not at the next
        # cycle collection
        self._pool = weakref.ref(pool)
        self.config = config or LifecycleConfig()
        self.name = name or f"pool{next(_POOL_SEQ)}"
        self._lock = threading.Lock()
        self._backoff = _BackoffPolicy(self.config)
        self._recs = [_ReplicaRecord() for _ in pool.replicas]
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.rebuilds_ok = 0
        self.rebuilds_failed = 0
        self.benched_total = 0
        self.drains_clean = 0
        self.drains_killed = 0
        self.probation_promotions = 0

    # ---------------------------------------------------------------- thread
    def start(self) -> None:
        if not self.config.enabled:
            return
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, name=f"lifecycle-{self.name}",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(self.config.check_interval_s * 10 + 1.0)

    @property
    def pool(self) -> Any:
        """The supervised pool; None once it has been dropped."""
        return self._pool()

    def _loop(self) -> None:
        while not self._stop.wait(self.config.check_interval_s):
            if self.pool is None:
                return
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — the healer must not die
                logger.exception("lifecycle tick failed")

    # ------------------------------------------------------- routing surface
    def admit_allowed(self, idx: int) -> bool:
        """Healthy: always; probation: within the canary budget; any other
        state: no."""
        rec = self._recs[idx]
        if rec.state == "healthy":
            return True
        if rec.state == "probation":
            return rec.probation_inflight < self.config.probation_max_inflight
        return False

    def canary_wanted(self, idx: int) -> bool:
        """On probation with canary budget left: the router breaks load ties
        toward it, so an idle canary target gets its canaries."""
        rec = self._recs[idx]
        return (rec.state == "probation"
                and rec.probation_inflight < self.config.probation_max_inflight)

    def note_dispatch(self, idx: int) -> None:
        with self._lock:
            rec = self._recs[idx]
            if rec.state == "probation":
                rec.probation_inflight += 1

    def on_departed(self, idx: int) -> None:
        """A request left replica ``idx`` without a client terminal (failed
        over, handed off): its canary slot frees, nothing is credited."""
        with self._lock:
            rec = self._recs[idx]
            if rec.state == "probation":
                rec.probation_inflight = max(0, rec.probation_inflight - 1)

    def on_terminal(self, idx: int, ok: bool) -> None:
        """A request served by ``idx`` reached its client terminal; on
        probation a clean one counts toward promotion and an error
        re-quarantines at once. Cancels and deadlines arrive as ``ok``."""
        with self._lock:
            rec = self._recs[idx]
            if rec.state != "probation":
                return
            rec.probation_inflight = max(0, rec.probation_inflight - 1)
            if ok:
                rec.probation_ok += 1
                if rec.probation_ok >= self.config.probation_successes:
                    rec.walk("healthy")
                    rec.strikes = 0
                    rec.last_error = ""
                    self.probation_promotions += 1
                    logger.info("lifecycle %s: replica %d promoted to healthy after %d "
                                "clean canaries", self.name, idx, rec.probation_ok)
            else:
                self._quarantine_locked(idx, rec, "probation canary errored")

    # ----------------------------------------------------------- supervision
    def tick(self, now: Optional[float] = None) -> None:
        """One supervision pass: engine probes before the lock, the state
        decisions under it, engine close / build / start after it."""
        if not self.config.enabled:
            return
        now = time.monotonic() if now is None else now
        snaps = [(idx, *self._probe(eng)) for idx, eng in enumerate(list(self.pool.replicas))]
        actions: list[tuple[str, int]] = []
        with self._lock:
            for idx, broken, idle in snaps:
                if idx >= len(self._recs):
                    continue
                rec = self._recs[idx]
                if rec.state in ("healthy", "probation") and broken:
                    self._quarantine_locked(idx, rec, broken)
                elif rec.state == "quarantined" and now >= rec.backoff_until:
                    rec.walk("rebuilding")
                    actions.append(("rebuild", idx))
                elif rec.state == "draining":
                    if broken:
                        self._end_drain_locked(idx, rec, "broke")
                        self._quarantine_locked(idx, rec, broken)
                    elif idle:
                        actions.append(("drain_close", idx))
                    elif now >= rec.drain_deadline:
                        actions.append(("drain_kill", idx))
        for kind, idx in actions:
            if kind == "rebuild":
                self._do_rebuild(idx)
            else:
                self._do_drain_close(idx, killed=kind == "drain_kill")

    @staticmethod
    def _probe(eng: Any) -> tuple[Optional[str], bool]:
        """(broken reason, idle) from one stats() read. A closed engine
        whose record says serving reads as broken: that heals an undrain
        that raced the drain's close."""
        try:
            st = eng.stats()
        except Exception as e:  # noqa: BLE001 — a dying engine IS broken
            return f"stats() failed: {type(e).__name__}", False
        broken = st.get("broken") or ("engine closed" if st.get("closed") else None)
        idle = not (st.get("active") or st.get("pending") or st.get("prefilling")
                    or st.get("suspended"))
        return broken, idle

    def _quarantine_locked(self, idx: int, rec: _ReplicaRecord, why: Any) -> None:
        """Under the lock: one strike; quarantine with backoff, or bench
        past ``max_strikes``."""
        rec.strikes += 1
        rec.last_error = str(why)[:200]
        rec.probation_ok = 0
        rec.probation_inflight = 0
        if rec.strikes > self.config.max_strikes:
            rec.walk("benched")
            self.benched_total += 1
            logger.error("lifecycle %s: replica %d BENCHED after %d strikes (%s); operator "
                         "restart required", self.name, idx, rec.strikes, rec.last_error)
            return
        backoff = self._backoff.backoff(rec.strikes)
        rec.backoff_until = time.monotonic() + backoff
        rec.walk("quarantined")
        logger.warning("lifecycle %s: replica %d quarantined (strike %d/%d, rebuild in "
                       "%.2fs): %s", self.name, idx, rec.strikes, self.config.max_strikes,
                       backoff, rec.last_error)

    def _eid(self, idx: int, kind: str, episode: int) -> str:
        return f"{self.name}/replica{idx}/{kind}-{episode}"

    def _do_rebuild(self, idx: int) -> bool:
        """Close the spent engine, build and start a fresh one on the same
        device from its params, and commit it; never under the lock."""
        with self._lock:
            rec = self._recs[idx]
            rec.rebuild_episode += 1
            eid = self._eid(idx, "rebuild", rec.rebuild_episode)
        old = self.pool.replicas[idx]
        try:
            old.close(timeout=5.0)
        except Exception:  # noqa: BLE001 — the corpse must not block the rebuild
            logger.exception("lifecycle %s: closing replica %d failed", self.name, idx)
        t0 = time.monotonic()
        try:
            failpoint("replicas.rebuild")  # an armed raise: the rebuild fails
            eng = self.pool.build_replica(idx)
            eng.start()
        except Exception as e:  # noqa: BLE001 — any build fault is one strike
            self.rebuilds_failed += 1
            bump_counter("llm_replica_rebuilds_total", outcome="failed")
            record_event(eid, "replica_rebuilt", replica=idx, outcome="failed",
                         error=str(e)[:200])
            with self._lock:
                self._quarantine_locked(idx, self._recs[idx], f"rebuild failed: {e}")
            return False
        dt = time.monotonic() - t0
        self.pool.replicas[idx] = eng
        with self._lock:
            rec = self._recs[idx]
            rec.rebuilds += 1
            rec.probation_ok = 0
            rec.probation_inflight = 0
            rec.walk("probation")
        self.rebuilds_ok += 1
        record_recovery("replicas.rebuild", dt)
        bump_counter("llm_replica_rebuilds_total", outcome="ok")
        record_event(eid, "replica_rebuilt", replica=idx, outcome="ok",
                     rebuild_ms=round(dt * 1000.0, 3))
        logger.info("lifecycle %s: replica %d rebuilt in %.2fs; on probation (%d clean "
                    "canaries to promote)", self.name, idx, dt,
                    self.config.probation_successes)
        return True

    def _do_drain_close(self, idx: int, killed: bool) -> None:
        eng = self.pool.replicas[idx]
        inflight = 0
        if killed:
            try:
                st = eng.stats()
                inflight = int(st.get("active", 0)) + int(st.get("pending", 0)) \
                    + int(st.get("prefilling", 0)) + int(st.get("suspended", 0))
            except Exception:  # noqa: BLE001
                pass
        try:
            # close() ends stragglers with error; the pool fails them over
            eng.close(timeout=5.0)
        except Exception:  # noqa: BLE001
            logger.exception("lifecycle %s: drain close of replica %d failed", self.name, idx)
        with self._lock:
            rec = self._recs[idx]
            if rec.state != "draining":
                return  # an undrain or restart raced the tick and owns the state
            self._end_drain_locked(idx, rec, "killed" if killed else "clean",
                                   failed_over=inflight)
            rec.walk("drained")
        if killed:
            self.drains_killed += 1
        else:
            self.drains_clean += 1

    def _end_drain_locked(self, idx: int, rec: _ReplicaRecord, outcome: str,
                          **attrs: Any) -> None:
        if rec.drain_eid is not None:
            record_event(rec.drain_eid, "drain_end", replica=idx, outcome=outcome, **attrs)
            rec.drain_eid = None

    # ---------------------------------------------------------- control plane
    def _check_idx(self, idx: int) -> None:
        if not 0 <= idx < len(self._recs):
            raise IndexError(f"replica index {idx} out of range (pool has "
                             f"{len(self._recs)})")

    def drain(self, idx: int, deadline_s: Optional[float] = None) -> dict[str, Any]:
        """Take ``idx`` out of routing and let its requests finish; past
        ``deadline_s`` the tick closes it and the stragglers fail over.
        From healthy or probation only."""
        self._check_idx(idx)
        deadline = (self.config.drain_deadline_s if deadline_s is None
                    else max(0.0, float(deadline_s)))
        with self._lock:
            rec = self._recs[idx]
            if rec.state not in ("healthy", "probation"):
                raise LifecycleStateError(f"cannot drain replica {idx} from state "
                                          f"{rec.state!r}")
            rec.drain_episode += 1
            rec.drain_eid = self._eid(idx, "drain", rec.drain_episode)
            rec.drain_deadline = time.monotonic() + deadline
            # under the lock: the tick must not close the episode before its
            # begin exists
            record_event(rec.drain_eid, "drain_begin", replica=idx, deadline_s=deadline)
            rec.walk("draining")
        logger.info("lifecycle %s: draining replica %d (deadline %.1fs)", self.name, idx,
                    deadline)
        return self.status_row(idx)

    def undrain(self, idx: int) -> dict[str, Any]:
        """Return a still-draining replica to rotation; a drained one needs
        :meth:`restart`."""
        self._check_idx(idx)
        with self._lock:
            rec = self._recs[idx]
            if rec.state != "draining":
                raise LifecycleStateError(
                    f"cannot undrain replica {idx} from state {rec.state!r} (only "
                    "'draining'; a drained replica needs restart)")
            self._end_drain_locked(idx, rec, "undrained")
            rec.walk("healthy")
        return self.status_row(idx)

    def restart(self, idx: int) -> dict[str, Any]:
        """Clear strikes and backoff and hand the replica to the next tick
        for a close and rebuild, from any state but rebuilding."""
        self._check_idx(idx)
        with self._lock:
            rec = self._recs[idx]
            if rec.state == "rebuilding":
                raise LifecycleStateError(f"replica {idx} is already rebuilding")
            if rec.state == "draining":
                self._end_drain_locked(idx, rec, "restarted")
            rec.strikes = 0
            rec.backoff_until = 0.0
            rec.probation_ok = 0
            rec.probation_inflight = 0
            rec.walk("quarantined")
        logger.info("lifecycle %s: replica %d restart requested", self.name, idx)
        return self.status_row(idx)

    # --------------------------------------------------------------- surface
    def counts(self) -> dict[str, Any]:
        """State census; ``serving`` is what routing can use (healthy, and
        probation with canary budget)."""
        with self._lock:
            by_state = {s: 0 for s in STATES}
            serving = 0
            for rec in self._recs:
                by_state[rec.state] += 1
                if rec.state == "healthy" or (
                        rec.state == "probation"
                        and rec.probation_inflight < self.config.probation_max_inflight):
                    serving += 1
            return {"replicas": len(self._recs), "serving": serving, **by_state}

    def status_row(self, idx: int) -> dict[str, Any]:
        with self._lock:
            rec = self._recs[idx]
            now = time.monotonic()
            return {
                "index": idx, "state": rec.state, "strikes": rec.strikes,
                "backoff_remaining_s": round(max(0.0, rec.backoff_until - now), 3)
                if rec.state == "quarantined" else None,
                "rebuilds": rec.rebuilds, "probation_ok": rec.probation_ok,
                "probation_inflight": rec.probation_inflight,
                "last_error": rec.last_error or None,
                "history": [{"state": st, "ts": ts} for st, ts in rec.history[-8:]],
            }

    def status(self) -> dict[str, Any]:
        return {
            "name": self.name, "counts": self.counts(),
            "rebuilds_ok": self.rebuilds_ok, "rebuilds_failed": self.rebuilds_failed,
            "benched_total": self.benched_total, "drains_clean": self.drains_clean,
            "drains_killed": self.drains_killed,
            "probation_promotions": self.probation_promotions,
            "replicas": [self.status_row(i) for i in range(len(self._recs))],
        }


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
            failpoint("replicas.rebuild")  # an armed raise: the rebuild fails
            fresh = self._build(engine)
            fresh.start()
        except Exception as e:  # noqa: BLE001 — any build fault is one strike
            with self._lock:
                self._rebuilding = False
                self.rebuilds_failed += 1
                self.last_error = str(e)[:200]
            bump_counter("llm_replica_rebuilds_total", outcome="failed")
            record_event(f"{self.name}/rebuild-{self.rebuilds_failed}", "replica_rebuilt",
                         outcome="failed", error=str(e)[:200])
            raise ReplicaUnavailable(
                f"engine {self.name} rebuild failed: {e}",
                retry_after_s=round(max(0.0, self.backoff_until - time.monotonic()), 2))
        dt = time.monotonic() - t0
        with self._lock:
            self._rebuilding = False
            self.rebuilds_ok += 1
            n = self.rebuilds_ok
        record_recovery("replicas.rebuild", dt)
        bump_counter("llm_replica_rebuilds_total", outcome="ok")
        record_event(f"{self.name}/rebuild-ok-{n}", "replica_rebuilt", outcome="ok",
                     rebuild_ms=round(dt * 1000.0, 3))
        logger.info("supervisor %s: engine rebuilt in %.2fs", self.name, dt)
        return fresh

    def note_ok(self) -> None:
        """A stream served by the (possibly rebuilt) engine finished cleanly."""
        with self._lock:
            self.strikes = 0
            self.last_error = ""

    def status(self) -> dict[str, Any]:
        with self._lock:
            return {"name": self.name, "strikes": self.strikes, "benched": self.benched,
                    "backoff_remaining_s": round(
                        max(0.0, self.backoff_until - time.monotonic()), 3),
                    "rebuilds_ok": self.rebuilds_ok,
                    "rebuilds_failed": self.rebuilds_failed,
                    "last_error": self.last_error or None}
