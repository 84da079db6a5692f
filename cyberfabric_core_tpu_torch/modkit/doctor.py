"""fabric-doctor — continuous serving health: SLO burn rates, stall
watchdogs, and a degradation state machine (the port's copy of
``modkit/doctor.py``), and the federation's :class:`FleetDoctor`.

The flight recorder makes every request legible (timelines, derived
ttft/queue-wait/itl figures); the doctor consumes those signals
continuously, in three parts:

- **SLO engine.** Declarative objectives (:data:`DEFAULT_OBJECTIVES`:
  ttft p95, itl p99, queue-wait p95, error rate — config-overridable, plus
  per-model overrides) evaluated as SRE-style multi-window **burn rates**:
  for each objective the fraction of requests outside the threshold in a
  fast (1m) and a slow (30m) window, divided by the objective's error
  budget. ``burn == 1`` means "spending budget exactly as fast as allowed";
  the verdict is ``critical`` when BOTH windows burn at ≥ ``critical_burn``
  (the fast window reacts, the slow window de-flaps), ``warning`` when
  either window is ≥ ``warning_burn``. Samples come from the flight
  recorder's terminal records via a listener — the same timeline the REST
  surface and Prometheus histograms derive from, so the doctor can never
  disagree with the dashboards. (Expressing "ttft p95 < T" as "≤ 5% of
  requests over T" is the standard budget-fraction framing — identical
  objective, burn-rate evaluable.)

- **Stall watchdogs.** A scheduler-round watchdog (no round completed in
  N× the p95 round time while work is pending), a per-stream stall detector
  (a live decoding request with no event for ``stream_stall_s``), and a
  queue-age watchdog (oldest pending request older than its deadline
  class). Each trip bumps ``watchdog_trips_total{watchdog=…}``, records a
  flight-recorder ``stalled`` event (per-stream), and logs the offending
  request/round ids. Trips are cooldown-limited per target so a wedged
  round does not melt the log.

- **Degradation state machine.** ``healthy → degraded → shedding →
  recovering → healthy`` with hysteresis on both edges (``shed_after``
  consecutive bad evaluations to escalate, ``recover_after`` consecutive
  clean ones per recovery edge). Exported via the gateway's public
  ``GET /healthz`` (liveness: process + event-loop heartbeat) and
  ``GET /readyz`` (readiness: 503 + reasons while ``shedding``), the
  guarded ``GET /v1/monitoring/slo`` (full objective table + state
  history), and the llm-gateway admission layer, which in ``shedding``
  returns ``llm.load_shed`` 429 + Retry-After *before* enqueue.

Design constraints (the failpoints/flight-recorder discipline):

- **Evaluators never block and never raise.** ``evaluate()`` runs on a
  dedicated daemon thread on a fixed cadence; it touches only in-process
  state (sample deques, scheduler heartbeats, recorder summaries) — no
  network, no DB, no device sync, no ``await``. All emits route through the
  never-raises helpers (``record_event`` / ``bump_counter`` /
  :func:`_gauge_set`).
- **Idle is cheap.** With no listener attached and no thread started (the
  default for a bare ``import``), the doctor costs nothing.
"""

from __future__ import annotations

import logging
import threading
import time
from collections import deque
from dataclasses import dataclass, field, fields
from typing import Any, Callable, Iterable, Optional

from .flight_recorder import default_recorder
from .metrics import bump_counter, default_registry

__all__ = [
    "DEFAULT_OBJECTIVES", "Doctor", "DoctorConfig", "FleetDoctor",
    "SloObjective", "default_doctor", "shed_retry_after",
]

logger = logging.getLogger("doctor")

#: the declarative objective table (config: ``monitoring.doctor.objectives``
#: overrides per key; ``per_model`` clones an objective for one model).
#: ``budget`` is the allowed bad fraction — p95 ⇔ budget 0.05, p99 ⇔ 0.01.
DEFAULT_OBJECTIVES: dict[str, dict[str, Any]] = {
    "ttft_p95": {"kind": "latency", "figure": "ttft_ms",
                 "threshold_ms": 2000.0, "budget": 0.05},
    "itl_p99": {"kind": "latency", "figure": "itl_ms",
                "threshold_ms": 200.0, "budget": 0.01},
    "queue_wait_p95": {"kind": "latency", "figure": "queue_wait_ms",
                       "threshold_ms": 1000.0, "budget": 0.05},
    "error_rate": {"kind": "error_rate", "budget": 0.01},
}

_STATES = ("healthy", "degraded", "shedding", "recovering")
_STATE_NUM = {s: i for i, s in enumerate(_STATES)}


@dataclass(frozen=True)
class SloObjective:
    """One objective row: a figure, a threshold, and an error budget."""

    name: str
    kind: str = "latency"          # "latency" | "error_rate"
    figure: str = ""               # derived-figure key (latency objectives)
    threshold_ms: float = 0.0
    budget: float = 0.05           # allowed bad fraction of requests
    model: Optional[str] = None    # None = all models

    def validate(self) -> None:
        if self.kind not in ("latency", "error_rate"):
            raise ValueError(f"objective {self.name}: unknown kind {self.kind!r}")
        if self.kind == "latency" and not self.figure:
            raise ValueError(f"objective {self.name}: latency needs a figure")
        if not 0.0 < self.budget <= 1.0:
            raise ValueError(f"objective {self.name}: budget must be in (0, 1]")


@dataclass
class DoctorConfig:
    """Knobs for the SLO engine, the watchdogs, and the state machine.
    Built from ``modules.monitoring.config.doctor`` via :meth:`from_config`
    (unknown keys are rejected — deny-unknown-fields, like AppConfig)."""

    enabled: bool = True
    eval_interval_s: float = 1.0
    # burn-rate windows (SRE multi-window: fast reacts, slow de-flaps)
    fast_window_s: float = 60.0
    slow_window_s: float = 1800.0
    min_samples: int = 5            # below this, an objective reads "ok"
    warning_burn: float = 1.0
    critical_burn: float = 2.0
    # state machine hysteresis
    shed_after: int = 3             # consecutive bad evals in degraded → shed
    recover_after: int = 3          # consecutive clean evals per recovery edge
    shed_retry_after_s: float = 2.0
    # watchdogs
    round_stall_mult: float = 8.0   # × p95 round time
    round_stall_floor_s: float = 10.0
    stream_stall_s: float = 30.0
    queue_deadline_s: float = 60.0
    watchdog_cooldown_s: float = 10.0
    # tenant-selective shedding: while an evaluation is bad, tenants whose
    # recent token rate (or pending-queue share) exceeds ``over_share`` ×
    # their weighted fair share are shed FIRST — the gateway 429s only
    # them; global shedding (the state machine reaching ``shedding``)
    # stays the last resort. Needs ≥ 2 active tenants and at least
    # ``tenant_min_activity`` tokens/requests of recent activity to
    # attribute — below that, blame is noise.
    tenant_shed_enabled: bool = True
    tenant_over_share: float = 2.0
    tenant_shed_retry_after_s: float = 2.0
    tenant_min_activity: int = 32
    #: how long a shed mark outlives the pass that last found the tenant
    #: over-share WHILE the burn continues. Being shed suppresses the very
    #: activity that made a tenant "over", so requiring over-share every
    #: pass would flap shed→clear→flood→shed; but a mark must not outlive
    #: its evidence either — a tenant that backs off is exonerated after
    #: this hold even if the burn persists for unrelated reasons.
    tenant_shed_hold_s: float = 5.0
    # liveness
    loop_stall_s: float = 10.0
    max_samples: int = 4096         # per-figure sample-deque bound
    objectives: dict[str, dict[str, Any]] = field(default_factory=dict)
    per_model: dict[str, dict[str, dict[str, Any]]] = field(
        default_factory=dict)

    @classmethod
    def from_config(cls, raw: Optional[dict[str, Any]]) -> "DoctorConfig":
        raw = dict(raw or {})
        known = {f.name for f in fields(cls)}
        unknown = set(raw) - known
        if unknown:
            raise ValueError(
                f"monitoring.doctor: unknown fields {sorted(unknown)} "
                f"(allowed: {sorted(known)})")
        return cls(**raw)

    def build_objectives(self) -> list[SloObjective]:
        """The effective objective table: defaults ← config overrides, plus
        per-model clones (evaluated over that model's samples only)."""
        # deny-unknown-fields INSIDE each spec too, or a typo'd key
        # (threshold vs threshold_ms) dies as a bare TypeError at boot
        allowed = {f.name for f in fields(SloObjective)} - {"name", "model"}

        def _check_keys(spec: dict[str, Any], path: str) -> None:
            unknown = set(spec) - allowed
            if unknown:
                raise ValueError(
                    f"monitoring.doctor.{path}: unknown fields "
                    f"{sorted(unknown)} (allowed: {sorted(allowed)})")

        table: dict[str, dict[str, Any]] = {
            name: dict(spec) for name, spec in DEFAULT_OBJECTIVES.items()}
        for name, spec in self.objectives.items():
            _check_keys(spec or {}, f"objectives[{name!r}]")
            table.setdefault(name, {})
            table[name].update(spec or {})
        out: list[SloObjective] = []
        for name, spec in table.items():
            obj = SloObjective(name=name, **spec)
            obj.validate()
            out.append(obj)
        for model, overrides in self.per_model.items():
            for name, spec in (overrides or {}).items():
                base = table.get(name)
                if base is None:
                    raise ValueError(
                        f"monitoring.doctor.per_model[{model!r}]: unknown "
                        f"objective {name!r}")
                _check_keys(spec or {}, f"per_model[{model!r}][{name!r}]")
                merged = {**base, **(spec or {})}
                obj = SloObjective(name=f"{name}[{model}]", model=model,
                                   **merged)
                obj.validate()
                out.append(obj)
        return out


def _gauge_set(name: str, help: str, value: float, **labels: str) -> None:
    """Fire-and-forget gauge set on the default registry — the ``set``
    sibling of ``bump_counter`` (observability must never fail the doctor's
    evaluation pass; evaluator emits route through never-raises
    helpers)."""
    try:
        default_registry.gauge(name, help).set(value, **labels)
    except Exception:  # noqa: BLE001
        pass


class _SampleWindow:
    """Bounded (ts, value, model) samples; windowed bad-fraction reads.
    Mutated only under the doctor's lock."""

    __slots__ = ("samples",)

    def __init__(self, maxlen: int) -> None:
        self.samples: "deque[tuple[float, float, Optional[str]]]" = deque(
            maxlen=maxlen)

    def add(self, ts: float, value: float, model: Optional[str]) -> None:
        self.samples.append((ts, value, model))

    def prune(self, cutoff: float) -> None:
        while self.samples and self.samples[0][0] < cutoff:
            self.samples.popleft()

    def stats(self, now: float, window_s: float, threshold: float,
              model: Optional[str]) -> tuple[int, int]:
        """(total, over-threshold) inside the window, optionally per model."""
        cutoff = now - window_s
        total = bad = 0
        for ts, value, m in self.samples:
            if ts < cutoff or (model is not None and m != model):
                continue
            total += 1
            if value > threshold:
                bad += 1
        return total, bad


class _StateMachine:
    """healthy → degraded → shedding → recovering, hysteresis on both edges.

    One :meth:`step` per evaluation. Escalation: any bad evaluation leaves
    ``healthy`` immediately; ``shed_after`` consecutive bad evaluations in
    ``degraded`` escalate to ``shedding``. De-escalation: ``recover_after``
    consecutive clean evaluations per edge (shedding → recovering →
    healthy), and a bad evaluation during ``recovering`` falls back to
    ``degraded`` — a single clean blip can never flap the readiness gate."""

    def __init__(self, history: int = 64) -> None:
        self.state = "healthy"
        self.entered_at = time.time()
        self.consecutive_bad = 0
        self.consecutive_clean = 0
        self.history: "deque[dict[str, Any]]" = deque(maxlen=history)

    def _transition(self, to: str, reasons: list[str]) -> None:
        self.history.append({
            "ts": round(time.time(), 3), "from": self.state, "to": to,
            "reasons": list(reasons)[:8]})
        self.state = to
        self.entered_at = time.time()
        self.consecutive_bad = 0
        self.consecutive_clean = 0

    def step(self, bad: bool, reasons: list[str], shed_after: int,
             recover_after: int) -> str:
        if bad:
            self.consecutive_bad += 1
            self.consecutive_clean = 0
        else:
            self.consecutive_clean += 1
            self.consecutive_bad = 0
        if self.state == "healthy":
            if bad:
                self._transition("degraded", reasons)
        elif self.state == "degraded":
            if bad and self.consecutive_bad >= shed_after:
                self._transition("shedding", reasons)
            elif not bad and self.consecutive_clean >= recover_after:
                self._transition("healthy", ["recovered"])
        elif self.state == "shedding":
            if not bad and self.consecutive_clean >= recover_after:
                self._transition("recovering", ["burn subsided"])
        elif self.state == "recovering":
            if bad:
                self._transition("degraded", reasons)
            elif self.consecutive_clean >= recover_after:
                self._transition("healthy", ["recovered"])
        return self.state


class Doctor:
    """The continuous health evaluator. One instance is process-global
    (:data:`default_doctor`, configured by the monitoring module); fault
    scenarios and tests build their own."""

    def __init__(self, config: Optional[DoctorConfig] = None,
                 recorder=default_recorder) -> None:
        self._lock = threading.Lock()
        self._recorder = recorder
        self._listener_attached = False
        self._scheduler_provider: Optional[
            Callable[[], Iterable[tuple[str, Any]]]] = None
        self._capacity_provider: Optional[
            Callable[[], dict[str, Any]]] = None
        #: the federated gateway's fleet feed: host-level reasons for /readyz
        self._fleet_provider: Optional[Callable[[], Iterable[str]]] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started_at = time.monotonic()
        self._loop_heartbeat: Optional[float] = None  # monotonic of last touch
        self.configure(config or DoctorConfig())

    # ------------------------------------------------------------ configure
    def configure(self, config: DoctorConfig) -> None:
        """(Re)configure and reset: samples, watchdog state, and the state
        machine restart from ``healthy`` — each server boot begins with a
        clean bill. The evaluation thread (if running) picks up the new
        config on its next tick."""
        objectives = config.build_objectives()  # validate before mutating
        with self._lock:
            self.config = config
            self.objectives = objectives
            self._windows: dict[str, _SampleWindow] = {}
            self._machine = _StateMachine()
            self._watchdog_trips: dict[str, int] = {}
            self._cooldowns: dict[tuple[str, str], float] = {}
            self._last_report: Optional[dict[str, Any]] = None
            self._evals = 0
            #: tenant-selective shedding state: over-fair-share tenants the
            #: gateway should 429 first (cleared on a clean evaluation)
            self._shed_tenants: dict[str, float] = {}
            self._tenant_prev_charged: dict[str, int] = {}
            self._tenant_doc: Optional[dict[str, Any]] = None
            #: tenants whose llm_tenant_shed gauge was last set to 1 — so a
            #: recovery can push the 0
            self._shed_gauge_tenants: set = set()
            #: per-model tenants whose queue-depth gauge was last nonzero —
            #: a drained tenant vanishes from depths(), so its gauge needs
            #: an explicit 0 or it sticks at the last backlog forever
            self._queue_gauge_tenants: dict[str, set] = {}

    def attach_recorder(self) -> None:
        """Subscribe to the flight recorder's terminal events (idempotent)."""
        if not self._listener_attached:
            self._recorder.add_listener(self.on_record)
            self._listener_attached = True

    def detach_recorder(self) -> None:
        """Unsubscribe (idempotent) — the stack-teardown twin of
        :meth:`attach_recorder`, so a stopped doctor costs the serving path
        nothing and accumulates no stale samples."""
        if self._listener_attached:
            self._recorder.remove_listener(self.on_record)
            self._listener_attached = False

    def set_scheduler_provider(
            self, fn: Optional[Callable[[], Iterable[tuple[str, Any]]]],
    ) -> None:
        """``fn()`` yields ``(model_name, scheduler)`` pairs — the watchdog
        and queue-gauge surface. The monitoring module wires the live worker
        pool (and clears it with ``None`` on stack teardown); scenarios wire
        a single engine."""
        self._scheduler_provider = fn

    def set_capacity_provider(
            self, fn: Optional[Callable[[], dict[str, Any]]]) -> None:
        """``fn()`` returns the replica census (``replicas`` / ``serving`` /
        ``healthy`` / ``benched`` / … — the worker's ``replica_capacity()``
        shape). The doctor folds it into every evaluation: ZERO serving
        replicas is itself a degradation reason, and the shedding threshold
        scales with surviving capacity — a pool running at half strength
        escalates to shedding after proportionally fewer bad evaluations,
        because the survivors absorb the dead replicas' load on top of the
        burn that is already visible. Cleared with ``None`` at teardown."""
        self._capacity_provider = fn

    def set_fleet_provider(
            self, fn: Optional[Callable[[], Iterable[str]]]) -> None:
        """``fn()`` returns host-level health reason strings (``"host
        worker-1 shedding: slo:itl_p99"``) from the gateway's FleetView,
        folded into :meth:`readiness` so /readyz tells the truth about the
        whole fleet. The local state still owns the 200/503 verdict (routing
        steers around sick hosts; the gateway itself keeps serving).
        Cleared with ``None`` at teardown."""
        self._fleet_provider = fn

    def ensure_started(self) -> None:
        """Attach the sample listener and start the evaluation thread
        (idempotent; daemon — dies with the process, like the scheduler
        thread). Attachment happens HERE rather than in ``configure`` so a
        bare import (``default_doctor`` exists in every module stack) costs
        nothing on the serving path until something actually arms the
        doctor."""
        if not self.config.enabled:
            return
        self.attach_recorder()
        with self._lock:
            # un-cancel FIRST: an alive-but-stopping thread that sees the
            # cleared event just keeps running (same effect as a restart)
            self._stop.clear()
            if self._thread is not None and self._thread.is_alive():
                return
            self._thread = threading.Thread(
                target=self._loop, name="fabric-doctor", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def _loop(self) -> None:
        while True:
            if self._stop.wait(self.config.eval_interval_s):
                with self._lock:
                    # stop()→ensure_started() race: if the event was
                    # re-cleared after our wake-up, keep serving as the
                    # doctor thread; otherwise clear the slot under the
                    # lock so a concurrent ensure_started() spawns a fresh
                    # thread instead of early-returning on a dying one.
                    if self._stop.is_set():
                        if self._thread is threading.current_thread():
                            self._thread = None
                        return
                continue
            try:
                self.evaluate()
            except Exception:  # noqa: BLE001
                # this thread is the only thing that can ever walk the state
                # machine back — a hostile schedulers()/heartbeat()
                # implementation must not silently kill it and freeze health
                # at its last state (a frozen `shedding` 503s forever)
                logger.exception("doctor evaluation pass failed")

    # --------------------------------------------------------------- ingest
    def on_record(self, payload: dict[str, Any]) -> None:
        """Flight-recorder terminal listener: fold one finished/errored
        request into the objective sample windows. Called outside the
        recorder's lock; must never raise (the recorder wraps it anyway)."""
        kind = payload.get("kind")
        if kind not in ("finished", "error", "cancelled",
                        "deadline_exceeded"):
            return  # evictions are a recorder-bound artifact, not a signal
        now = time.time()
        model = payload.get("model")
        derived = payload.get("derived") or {}
        cancelled = kind in ("cancelled", "deadline_exceeded")
        with self._lock:
            maxlen = self.config.max_samples
            # cancellations are EXCLUDED from the error-rate burn entirely
            # (numerator and denominator): a disconnect storm is client
            # behavior, not an SLO violation — it must neither trip the
            # error objective nor dilute a real error burn. They feed their
            # own rate signal instead (llm_cancellation_rate + report doc).
            cw = self._windows.setdefault("cancel", _SampleWindow(maxlen))
            cw.add(now, 1.0 if cancelled else 0.0, model)
            if cancelled:
                return
            err = self._windows.setdefault("error", _SampleWindow(maxlen))
            err.add(now, 1.0 if kind == "error" else 0.0, model)
            if kind == "finished":
                for figure in ("ttft_ms", "itl_ms", "queue_wait_ms"):
                    value = derived.get(figure)
                    if value is None:
                        continue
                    self._windows.setdefault(
                        figure, _SampleWindow(maxlen)).add(
                        now, float(value), model)

    # ------------------------------------------------------------- evaluate
    def evaluate(self, now: Optional[float] = None) -> dict[str, Any]:
        """One evaluation pass: burn rates → verdicts, watchdog checks,
        state-machine step, gauge export. Non-blocking and never-raising by
        contract; runs on the doctor thread each
        ``eval_interval_s``, or synchronously from tests/scenarios."""
        now = time.time() if now is None else now
        cfg = self.config
        reasons: list[str] = []
        table: list[dict[str, Any]] = []
        with self._lock:
            horizon = now - cfg.slow_window_s
            for window in self._windows.values():
                window.prune(horizon)
            for obj in self.objectives:
                row = self._evaluate_objective(obj, now)
                table.append(row)
                if row["verdict"] == "critical":
                    reasons.append(f"slo:{obj.name}")
            # cancellation-rate signal (observability, never a degradation
            # reason: cancels are client decisions — 0.5 splits the 0/1
            # samples into cancelled vs served)
            cancel_doc = None
            cw = self._windows.get("cancel")
            if cw is not None:
                c_total, c_bad = cw.stats(now, cfg.fast_window_s, 0.5, None)
                if c_total:
                    cancel_doc = {
                        "rate_fast": round(c_bad / c_total, 3),
                        "cancelled_fast": c_bad,
                        "terminals_fast": c_total,
                    }
        trips = self._check_watchdogs(now)
        # dedupe: several schedulers tripping the same watchdog is one
        # reason on /readyz (per-scheduler detail lives in the log lines)
        reasons.extend(f"watchdog:{name}" for name in dict.fromkeys(trips))
        # replica capacity (lifecycle census): zero serving capacity is a
        # degradation reason in itself, and a partially-dead pool lowers the
        # shedding hysteresis — survivors carry the dead replicas' load, so
        # the same burn justifies shedding sooner
        capacity = self._read_capacity()
        shed_after = cfg.shed_after
        capacity_doc: Optional[dict[str, Any]] = None
        if capacity:
            replicas = int(capacity.get("replicas") or 0)
            serving = int(capacity.get("serving") or 0)
            if replicas > 0:
                frac = serving / replicas
                if serving == 0:
                    reasons.append("capacity:no_serving_replicas")
                elif frac < 1.0:
                    shed_after = max(1, -(-cfg.shed_after * serving
                                          // replicas))
                capacity_doc = {**capacity,
                                "capacity_frac": round(frac, 3),
                                "effective_shed_after": shed_after}
                _gauge_set("llm_replicas_healthy",
                           "Replicas in lifecycle state healthy",
                           float(capacity.get("healthy", 0)))
                _gauge_set("llm_replicas_benched",
                           "Replicas benched after repeated strikes",
                           float(capacity.get("benched", 0)))
        # tenant-selective shedding: attribute the burn/queue pressure to
        # over-fair-share tenants BEFORE the state machine escalates — the
        # gateway sheds only them while the machine is still degraded, and
        # global shedding engages only if the burn persists regardless
        tenant_doc = self._evaluate_tenants(bool(reasons), now)
        with self._lock:
            state = self._machine.step(
                bool(reasons), reasons, shed_after, cfg.recover_after)
            self._evals += 1
            report = {
                "ts": round(now, 3),
                "state": state,
                "state_since": round(self._machine.entered_at, 3),
                "reasons": reasons,
                "objectives": table,
                "watchdog_trips": dict(self._watchdog_trips),
                "capacity": capacity_doc,
                "cancellation": cancel_doc,
                "tenants": tenant_doc,
                "evals": self._evals,
            }
            self._last_report = report
        if cancel_doc is not None:
            _gauge_set("llm_cancellation_rate",
                       "Fraction of recent terminals that were "
                       "cancelled/deadline-lapsed (fast window)",
                       cancel_doc["rate_fast"])
        for row in table:
            _gauge_set("slo_burn_rate",
                       "SLO error-budget burn rate per objective and window",
                       row["burn_fast"], objective=row["name"], window="fast")
            _gauge_set("slo_burn_rate",
                       "SLO error-budget burn rate per objective and window",
                       row["burn_slow"], objective=row["name"], window="slow")
        _gauge_set("serving_state",
                   "Degradation state (0 healthy, 1 degraded, 2 shedding, "
                   "3 recovering)", float(_STATE_NUM[state]))
        self._export_queue_gauges()
        return report

    def _evaluate_objective(self, obj: SloObjective,
                            now: float) -> dict[str, Any]:
        """Under lock: burn rates for one objective over both windows."""
        cfg = self.config
        if obj.kind == "error_rate":
            window, threshold = self._windows.get("error"), 0.5
        else:
            window, threshold = self._windows.get(obj.figure), obj.threshold_ms

        def burn(window_s: float) -> tuple[float, int]:
            if window is None:
                return 0.0, 0
            total, bad = window.stats(now, window_s, threshold, obj.model)
            if total < cfg.min_samples:
                return 0.0, total
            return (bad / total) / obj.budget, total

        burn_fast, n_fast = burn(cfg.fast_window_s)
        burn_slow, n_slow = burn(cfg.slow_window_s)
        if min(burn_fast, burn_slow) >= cfg.critical_burn:
            verdict = "critical"
        elif max(burn_fast, burn_slow) >= cfg.warning_burn:
            verdict = "warning"
        else:
            verdict = "ok"
        return {
            "name": obj.name, "kind": obj.kind, "figure": obj.figure or None,
            "model": obj.model, "threshold_ms": obj.threshold_ms or None,
            "budget": obj.budget, "burn_fast": round(burn_fast, 3),
            "burn_slow": round(burn_slow, 3), "samples_fast": n_fast,
            "samples_slow": n_slow, "verdict": verdict,
        }

    # ------------------------------------------------- tenant attribution
    def _tenant_totals(self) -> dict[str, dict[str, Any]]:
        """Aggregate per-tenant live figures across the scheduler pool
        (charged tokens, weight, pending depth, slots). Never raises; the
        provider and snapshots are public contracts."""
        provider = self._scheduler_provider
        if provider is None:
            return {}
        try:
            pairs = list(provider())
        except Exception:  # noqa: BLE001
            return {}
        totals: dict[str, dict[str, Any]] = {}
        for _name, sched in pairs:
            snap_fn = getattr(sched, "tenant_snapshot", None)
            if snap_fn is None:
                continue
            try:
                rows = snap_fn()
            except Exception:  # noqa: BLE001 — a dying engine
                continue
            if not isinstance(rows, dict):
                continue
            for tenant, row in rows.items():
                agg = totals.setdefault(tenant, {
                    "charged": 0, "weight": 0.0, "pending": 0, "slots": 0})
                agg["charged"] += int(row.get("charged_tokens", 0))
                agg["weight"] = max(agg["weight"],
                                    float(row.get("weight", 1.0)))
                agg["pending"] += int(row.get("pending", 0))
                agg["slots"] += int(row.get("active_slots", 0))
        return totals

    def _evaluate_tenants(self, burning: bool,
                          now: float) -> Optional[dict[str, Any]]:
        """Attribute SLO burn / queue pressure per tenant and maintain the
        selective-shed set. A tenant is OVER-FAIR-SHARE when its recent
        token rate (charged-token delta since the last pass) or its share
        of the pending queue exceeds ``tenant_over_share`` × its weighted
        entitlement while at least one other tenant is active. Marks are
        refreshed each bad pass the tenant is still over-share and expire
        after ``tenant_shed_hold_s`` otherwise (being shed suppresses the
        very activity that made the tenant "over", so a strict per-pass
        rebuild would flap shed→clear→flood→shed); the whole set clears on
        a clean evaluation.
        Non-blocking, never-raises (WD01 — this runs inside evaluate())."""
        cfg = self.config
        if not cfg.tenant_shed_enabled:
            return None
        totals = self._tenant_totals()
        if not totals:
            return None
        with self._lock:
            prev = self._tenant_prev_charged
            deltas = {t: max(0, agg["charged"] - prev.get(t, agg["charged"]))
                      for t, agg in totals.items()}
            self._tenant_prev_charged = {
                t: agg["charged"] for t, agg in totals.items()}
        sum_delta = sum(deltas.values())
        sum_weight = sum(agg["weight"] for agg in totals.values()) or 1.0
        total_pending = sum(agg["pending"] for agg in totals.values())
        shares: dict[str, dict[str, Any]] = {}
        over: list[str] = []
        multi = len(totals) >= 2
        for tenant, agg in totals.items():
            fair = agg["weight"] / sum_weight
            token_share = (deltas[tenant] / sum_delta) if sum_delta else 0.0
            queue_share = (agg["pending"] / total_pending) \
                if total_pending else 0.0
            token_over = (multi and sum_delta >= cfg.tenant_min_activity
                          and token_share > cfg.tenant_over_share * fair)
            queue_over = (multi and total_pending >= cfg.tenant_min_activity
                          and queue_share > cfg.tenant_over_share * fair)
            if token_over or queue_over:
                over.append(tenant)
            shares[tenant] = {
                "fair_share": round(fair, 3),
                "token_share": round(token_share, 3),
                "queue_share": round(queue_share, 3),
                "charged_tokens": agg["charged"],
                "pending": agg["pending"],
                "slots": agg["slots"],
                "over_share": token_over or queue_over,
            }
        with self._lock:
            if burning:
                # refresh marks for tenants still over-share; marks not
                # refreshed expire after the hold window even while the
                # burn persists — a shed tenant's 429s suppress exactly the
                # activity that made it "over", so it could otherwise never
                # be exonerated until the burn fully cleared
                kept = {t: ts for t, ts in self._shed_tenants.items()
                        if now - ts < cfg.tenant_shed_hold_s}
                kept.update({t: now for t in over})
                self._shed_tenants = kept
            else:
                self._shed_tenants = {}
            shed = sorted(self._shed_tenants)
        # gauge export: 1 for shed tenants, an explicit 0 for tenants shed
        # last pass but clear now (a stuck 1 would read as a forever-shed)
        for tenant in shed:
            _gauge_set("llm_tenant_shed",
                       "1 while this tenant is selectively shed", 1.0,
                       tenant=tenant)
        for tenant in self._shed_gauge_tenants - set(shed):
            _gauge_set("llm_tenant_shed",
                       "1 while this tenant is selectively shed", 0.0,
                       tenant=tenant)
        self._shed_gauge_tenants = set(shed)
        for tenant, row in shares.items():
            _gauge_set("llm_tenant_token_share",
                       "Tenant share of recently consumed tokens (0..1)",
                       row["token_share"], tenant=tenant)
        return {"shares": shares, "shed": shed,
                "over_share_factor": cfg.tenant_over_share}

    def tenant_shed_retry_after(self, tenant: str) -> Optional[float]:
        """Retry-After seconds while ``tenant`` is selectively shed, else
        None — the llm-gateway admission layer's per-tenant gate (the
        tenant-scoped twin of :meth:`shed_retry_after`). Never raises."""
        try:
            if not self.config.enabled or \
                    not self.config.tenant_shed_enabled:
                return None
            with self._lock:
                if tenant in self._shed_tenants:
                    return self.config.tenant_shed_retry_after_s
        except Exception:  # noqa: BLE001
            pass
        return None

    # ------------------------------------------------------------ watchdogs
    #
    # Each ``_check_*`` answers "is the condition ACTIVE right now?" — that
    # verdict gates the state machine every pass, so a persistently wedged
    # round keeps the evaluation bad until it actually unwedges (no
    # degraded→healthy flapping while the stall continues). ``_trip`` only
    # rate-limits the *emissions* (counter bump, log line, stalled event)
    # per target so a wedged round does not melt the log.
    def _trip(self, watchdog: str, target: str, now: float,
              detail: str) -> bool:
        """Record one watchdog trip unless ``target`` is inside its
        cooldown. Returns True when the trip was recorded (emission
        rate-limit only — callers judge the condition separately)."""
        key = (watchdog, target)
        with self._lock:
            last = self._cooldowns.get(key)
            if last is not None and now - last < self.config.watchdog_cooldown_s:
                return False
            self._cooldowns[key] = now
            if len(self._cooldowns) > 4096:  # bound the per-target map
                oldest = min(self._cooldowns, key=self._cooldowns.get)
                del self._cooldowns[oldest]
            self._watchdog_trips[watchdog] = \
                self._watchdog_trips.get(watchdog, 0) + 1
        bump_counter("watchdog_trips_total", watchdog=watchdog)
        logger.warning("watchdog %s tripped: %s", watchdog, detail)
        return True

    def _read_capacity(self) -> Optional[dict[str, Any]]:
        """Never-raises capacity probe (the provider is a public contract —
        a hostile implementation must not kill the evaluation pass)."""
        provider = self._capacity_provider
        if provider is None:
            return None
        try:
            capacity = provider()
        except Exception:  # noqa: BLE001
            return None
        return capacity if isinstance(capacity, dict) else None

    def _check_watchdogs(self, now: float) -> list[str]:
        """All three watchdogs; returns the names that tripped this pass."""
        tripped: list[str] = []
        if self._check_stream_stall(now):
            tripped.append("stream_stall")
        provider = self._scheduler_provider
        if provider is not None:
            try:
                pairs = list(provider())
            except Exception:  # noqa: BLE001 — a dying worker pool is not
                pairs = []     # the doctor's failure
            for name, sched in pairs:
                if self._check_scheduler_round(name, sched, now):
                    tripped.append("scheduler_round")
                if self._check_queue_age(name, sched, now):
                    tripped.append("queue_age")
        return tripped

    def _check_stream_stall(self, now: float) -> bool:
        """A live request in a decoding phase with no event for
        ``stream_stall_s`` — the silently-stalled-stream case nothing else
        catches (the client just sees no chunks)."""
        cfg = self.config
        try:
            rows = self._recorder.inflight()
        except Exception:  # noqa: BLE001
            return False
        active = False
        for row in rows:
            rid = row["request_id"]
            if row.get("stalled") and row.get("phase") == "stalled":
                # Already flagged and no progress event since (a decode
                # chunk clears the mark): the stall PERSISTS. The ``stalled``
                # emit below reset last_event_at/phase, so re-deriving from
                # age would read the condition as cleared and let the state
                # machine recover around a wedged stream. The phase gate
                # matters too: a stalled stream the scheduler then PREEMPTS
                # is legitimately suspended (normal backpressure), not an
                # active stall — it keeps its triage mark but must not pin
                # the state machine degraded until it happens to resume.
                self._trip("stream_stall", rid, now,
                           f"request {rid} (slot {row.get('slot')}) is "
                           f"still stalled")
                active = True
                continue
            if row.get("phase") not in ("decode", "prefill"):
                continue
            age = row.get("last_event_age_s")
            if age is None or age < cfg.stream_stall_s:
                continue
            self._trip("stream_stall", rid, now,
                       f"request {rid} (slot {row.get('slot')}) has had "
                       f"no event for {age:.1f}s")
            self._emit_stalled(rid, watchdog="stream_stall",
                               stalled_for_s=round(age, 3))
            active = True
        return active

    def _emit_stalled(self, request_id: str, **attrs: Any) -> None:
        """Never-raises ``stalled`` emit on THIS doctor's recorder — the
        instance twin of :func:`record_event` (which is pinned to the
        process-global recorder; scenario doctors carry their own)."""
        try:
            self._recorder.record(request_id, "stalled", **attrs)
        except Exception:  # noqa: BLE001
            pass

    def _check_scheduler_round(self, name: str, sched: Any,
                               now: float) -> bool:
        """No scheduler round completed in N× the p95 round time while work
        is pending — a wedged decode loop (device hang, poisoned program)."""
        cfg = self.config
        hb = getattr(sched, "heartbeat", None)
        if hb is None:
            return False
        try:
            beat = hb()
        except Exception:  # noqa: BLE001
            return False
        if not isinstance(beat, dict):
            return False  # schedulers() is a public contract; stay up
        busy = beat.get("active", 0) or beat.get("pending", 0) \
            or beat.get("suspended", 0)
        if not busy:
            return False
        # rounds == 0 is NOT exempt: last_round_at is initialized at
        # scheduler construction, so a device wedged inside its first-ever
        # prefill (no round will ever complete) trips at the floor —
        # exactly the case this watchdog exists for. With no p95 yet the
        # limit degrades to round_stall_floor_s.
        age = beat.get("last_round_age_s", 0.0)
        limit = max(cfg.round_stall_floor_s,
                    cfg.round_stall_mult * beat.get("round_p95_ms", 0.0)
                    / 1000.0)
        if age <= limit:
            return False
        self._trip(
            "scheduler_round", name, now,
            f"scheduler {name}: no round for {age:.1f}s after round "
            f"{beat.get('rounds')} (limit {limit:.1f}s, p95 round "
            f"{beat.get('round_p95_ms', 0.0):.1f}ms, "
            f"{beat.get('active')} active / {beat.get('pending')} pending)")
        return True

    def _check_queue_age(self, name: str, sched: Any, now: float) -> bool:
        """Oldest pending request older than its deadline class — requests
        are aging out in the queue faster than admission can drain it."""
        fn = getattr(sched, "pending_oldest_age_s", None)
        if fn is None:
            return False
        try:
            age = fn()
        except Exception:  # noqa: BLE001
            return False
        if age is None or age <= self.config.queue_deadline_s:
            return False
        self._trip(
            "queue_age", name, now,
            f"scheduler {name}: oldest pending request is {age:.1f}s old "
            f"(deadline {self.config.queue_deadline_s:.1f}s)")
        return True

    def _export_queue_gauges(self) -> None:
        """Per-model pending-queue depth/age gauges — pushed on the doctor
        cadence (the scheduler pool is dynamic, so scrape-time label
        registration cannot enumerate it)."""
        provider = self._scheduler_provider
        if provider is None:
            return
        try:
            pairs = list(provider())
        except Exception:  # noqa: BLE001
            return
        for name, sched in pairs:
            try:
                depth = float(sched.pending_depth())
                age = sched.pending_oldest_age_s()
            except Exception:  # noqa: BLE001
                continue
            _gauge_set("llm_queue_depth",
                       "Pending scheduler queue depth", depth, model=name)
            _gauge_set("llm_queue_oldest_age_seconds",
                       "Age of the oldest pending request",
                       float(age or 0.0), model=name)
            # per-tenant pending depth: saturation is attributable — which
            # tenant's backlog is aging the queue. Reads the PUBLIC
            # tenant_snapshot() (the same surface _tenant_totals uses);
            # tenants seen last pass but drained now get an explicit 0 so
            # the gauge cannot stick at a stale backlog.
            snap_fn = getattr(sched, "tenant_snapshot", None)
            try:
                rows = snap_fn() if snap_fn is not None else {}
            except Exception:  # noqa: BLE001
                rows = {}
            per_tenant = {t: int(row.get("pending", 0))
                          for t, row in rows.items()} \
                if isinstance(rows, dict) else {}
            # the seen-set RMW runs under the doctor lock: configure() can
            # rebind/reset the dict from another thread mid-eval, and an
            # unlocked read-modify-write here would resurrect the stale
            # seen-set it read
            with self._lock:
                seen = self._queue_gauge_tenants.get(name, set())
            for tenant in seen - set(per_tenant):
                per_tenant[tenant] = 0
            for tenant, n in per_tenant.items():
                _gauge_set("llm_tenant_queue_depth",
                           "Pending scheduler queue depth per tenant",
                           float(n), model=name, tenant=tenant)
            with self._lock:
                self._queue_gauge_tenants[name] = {
                    t for t, n in per_tenant.items() if n > 0}

    # ------------------------------------------------------------- surfaces
    @property
    def state(self) -> str:
        with self._lock:
            return self._machine.state

    def state_sequence(self) -> list[str]:
        """The states visited so far, in order (scenario fingerprints)."""
        with self._lock:
            return ["healthy"] + [h["to"] for h in self._machine.history]

    def readiness(self) -> tuple[bool, str, list[str]]:
        """(ready, state, reasons) — the /readyz contract. Only ``shedding``
        is not-ready: a degraded server still serves (load balancers should
        not mass-evict a fleet that is merely slow)."""
        with self._lock:
            state = self._machine.state
            report = self._last_report or {}
            reasons = list(report.get("reasons", ()))
            if not reasons and state != "healthy":
                # between evals, surface what drove the last transition
                for entry in reversed(self._machine.history):
                    if entry["to"] == state:
                        reasons = list(entry["reasons"])
                        break
            fleet_fn = self._fleet_provider
        if fleet_fn is not None:
            # host-level reasons ride along (informational: a sick worker
            # host does not flip this gateway's verdict), bounded so a
            # hostile feed cannot bloat the probe body
            try:
                reasons = reasons + [str(r) for r in (fleet_fn() or ())][:8]
            except Exception:  # noqa: BLE001 — the probe must not 500
                pass
        return state != "shedding", state, reasons

    def touch_event_loop(self) -> None:
        """Called by the gateway's heartbeat task each second — the
        liveness probe's evidence that the asyncio loop still schedules."""
        self._loop_heartbeat = time.monotonic()

    def liveness(self) -> tuple[bool, dict[str, Any]]:
        """(live, detail) — the /healthz contract: the process is up and
        the event loop heartbeats. Never touched (no gateway running, or
        early boot) reads as live — liveness must not flap during start."""
        lag = None
        if self._loop_heartbeat is not None:
            lag = max(0.0, time.monotonic() - self._loop_heartbeat)
        live = lag is None or lag < self.config.loop_stall_s
        return live, {
            "status": "ok" if live else "stalled",
            "uptime_s": round(time.monotonic() - self._started_at, 1),
            "event_loop_lag_s": round(lag, 3) if lag is not None else None,
        }

    def shed_retry_after(self) -> Optional[float]:
        """Retry-After seconds while shedding, else None — the admission
        layer's one-call gate (never raises; a broken doctor must not take
        admission down with it)."""
        try:
            if self.config.enabled and self.state == "shedding":
                return self.config.shed_retry_after_s
        except Exception:  # noqa: BLE001
            pass
        return None

    def report(self) -> dict[str, Any]:
        """The /v1/monitoring/slo document: last evaluation + objective
        table + state history ring + watchdog counters."""
        with self._lock:
            machine = self._machine
            last = self._last_report
            doc = {
                "state": machine.state,
                "state_since": round(machine.entered_at, 3),
                "consecutive_bad": machine.consecutive_bad,
                "consecutive_clean": machine.consecutive_clean,
                "state_history": list(machine.history),
                "watchdog_trips": dict(self._watchdog_trips),
                "shed_tenants": sorted(self._shed_tenants),
                "evals": self._evals,
                "config": {
                    "eval_interval_s": self.config.eval_interval_s,
                    "fast_window_s": self.config.fast_window_s,
                    "slow_window_s": self.config.slow_window_s,
                    "shed_after": self.config.shed_after,
                    "recover_after": self.config.recover_after,
                },
                "last_eval": last,
            }
        return doc


#: fleet host-state severity order: merge() reports the WORST fresh host
_HOST_STATE_RANK = {"unknown": 0, "healthy": 0, "recovering": 1,
                    "degraded": 2, "shedding": 3}


class FleetDoctor:
    """Fleet-level fold of per-host doctor reports.

    Each federated worker runs its own :class:`Doctor` and piggybacks a
    compact report on its heartbeat census; the gateway's FleetView hands
    every host's payload to :meth:`on_report` and reads the fleet document
    off :meth:`merge` — burn rates per objective×model×host, host health
    states, and the worst-of fleet state that /v1/monitoring/fleet and the
    router's health rung consume.

    Both callbacks are held to the evaluator discipline: synchronous,
    non-blocking, never raising — they run on the heartbeat service path and
    the monitoring scrape path, and a hostile or malformed worker payload
    must degrade to an ``unknown`` row, never to a 500."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._hosts: dict[str, dict[str, Any]] = {}

    @staticmethod
    def _empty_row(host: str, stale: bool) -> dict[str, Any]:
        return {"host": host, "state": "unknown", "stale": bool(stale),
                "reasons": [], "objectives": [], "watchdog_trips": {},
                "shed_tenants": [], "evals": 0, "terminals": 0,
                "state_since": None}

    def on_report(self, host: str, payload: Any,
                  stale: bool = False) -> dict[str, Any]:
        """Normalize ONE worker's observability payload into a host health
        row (never raises; non-dict / hostile shapes degrade to state
        ``unknown``). ``stale`` marks a report older than its lease — it
        stays visible in the table but stops feeding fleet state."""
        row = self._empty_row(str(host), stale)
        try:
            doc = (payload or {}).get("doctor") \
                if isinstance(payload, dict) else None
            if isinstance(doc, dict):
                state = str(doc.get("state") or "unknown")
                row["state"] = state if state in _HOST_STATE_RANK \
                    else "unknown"
                if isinstance(doc.get("reasons"), list):
                    row["reasons"] = [str(r) for r in doc["reasons"]][:8]
                if isinstance(doc.get("objectives"), list):
                    row["objectives"] = [dict(o) for o in doc["objectives"]
                                         if isinstance(o, dict)]
                if isinstance(doc.get("watchdog_trips"), dict):
                    row["watchdog_trips"] = {
                        str(k): int(v) for k, v
                        in doc["watchdog_trips"].items()}
                if isinstance(doc.get("shed_tenants"), list):
                    row["shed_tenants"] = [str(t)
                                           for t in doc["shed_tenants"]][:32]
                row["evals"] = int(doc.get("evals") or 0)
                if doc.get("state_since") is not None:
                    row["state_since"] = float(doc["state_since"])
            terminals = payload.get("terminals") \
                if isinstance(payload, dict) else None
            if isinstance(terminals, list):
                row["terminals"] = len(terminals)
        except Exception:  # noqa: BLE001 — hostile payloads degrade, never raise
            row = self._empty_row(str(host), stale)
        with self._lock:
            self._hosts[str(host)] = row
        return row

    def forget(self, host: str) -> None:
        """Drop a departed host's row (lease eviction already removed its
        census; this clears the fold so the row cannot pin fleet state)."""
        with self._lock:
            self._hosts.pop(str(host), None)

    def retain(self, hosts: Iterable[str]) -> None:
        """Keep only ``hosts`` — the FleetView calls this after a refresh so
        evicted workers' rows expire with their lease."""
        keep = {str(h) for h in hosts}
        with self._lock:
            for h in [h for h in self._hosts if h not in keep]:
                del self._hosts[h]

    def host_states(self) -> dict[str, str]:
        """host → degradation state for FRESH reports only (the router's
        health-rung feed; a stale report never steers routing)."""
        with self._lock:
            return {h: row["state"] for h, row in self._hosts.items()
                    if not row.get("stale") and row["state"] != "unknown"}

    def merge(self, rows: Optional[Iterable[dict[str, Any]]] = None,
              ) -> dict[str, Any]:
        """The fleet document: worst-of fleet state over fresh hosts,
        host-level reasons, and the objective table flattened per
        objective×model×host. Stale rows are listed (with a staleness
        reason) but NEVER pin the fleet state — a silent worker's report
        expires with its lease. Never raises."""
        if rows is None:
            with self._lock:
                rows = [dict(r) for r in self._hosts.values()]
        fleet_state, rank = "unknown", -1
        reasons: list[str] = []
        objectives: list[dict[str, Any]] = []
        hosts: list[dict[str, Any]] = []
        for row in sorted(rows, key=lambda r: str(r.get("host", ""))):
            try:
                host = str(row.get("host", ""))
                state = str(row.get("state", "unknown"))
                hosts.append(row)
                if row.get("stale"):
                    reasons.append(f"host {host}: report stale "
                                   "(lease expiring)")
                    continue
                r = _HOST_STATE_RANK.get(state, 0)
                if r > rank or fleet_state == "unknown":
                    fleet_state, rank = (state if state in _HOST_STATE_RANK
                                         else "unknown"), max(rank, r)
                if state in ("degraded", "shedding", "recovering"):
                    why = ", ".join(row.get("reasons") or ()) or "burn"
                    reasons.append(f"host {host} {state}: {why}")
                for o in row.get("objectives") or ():
                    if isinstance(o, dict):
                        objectives.append({**o, "host": host})
            except Exception:  # noqa: BLE001 — one bad row must not kill the doc
                continue
        return {"state": fleet_state, "reasons": reasons,
                "objectives": objectives, "hosts": hosts}


#: process-global doctor — configured by the monitoring module at boot, read
#: by the gateway (/healthz, /readyz) and the llm-gateway admission layer
default_doctor = Doctor()


def shed_retry_after() -> Optional[float]:
    """Module-level admission gate on the default doctor: Retry-After
    seconds while the serving state is ``shedding``, else None. Never
    raises."""
    try:
        return default_doctor.shed_retry_after()
    except Exception:  # noqa: BLE001
        return None
