"""The monitoring module (the port's counterpart of ``modules/monitoring.py``).

It owns the process-global metrics registry's families, the doctor's
configuration and lifetime, and the operator surface:

- ``GET /metrics`` (public): the Prometheus text exposition. The families
  JAX pre-registers are registered here under the same names and help
  (the federation counters included: a non-federated stack scrapes 0), the
  scheduler gauges read the port's engines at scrape time, and the device
  gauges read the serving CUDA card through ``torch.cuda``'s allocator
  counters, which are host-side: a scrape never synchronises the card. The
  device families keep JAX's ``tpu_`` names so scrapers and dashboards built
  on the JAX exposition keep working; their help text names the card. A
  federated gateway merges its worker hosts' heartbeat snapshots into the
  exposition, labelled ``host``, with one ``llm_remote_workers_healthy``
  sample a host.
- ``POST /v1/monitoring/profiler/start`` and ``/stop``: a ``torch.profiler``
  trace (CPU, and CUDA with a card) of everything the process runs between
  the two, written as a chrome trace into ``<home_dir>/profiles/trace-<ts>/``.
- ``GET/PUT/DELETE /v1/monitoring/failpoints[/{name}]``: the failpoint
  catalog, arming and disarming (403 unless ``allow_fault_injection``); a
  ``host`` in the body (``?host=`` on DELETE) arms or disarms the point on
  that federated worker host.
- ``GET /v1/monitoring/requests`` (``?stalled=``, ``?recent=``),
  ``/requests/{request_id}`` and ``/rounds`` (``?format=chrome-trace``,
  ``?limit=``): the flight recorder and the engines' round timings. In a
  federated stack a request's timeline stitches in the segments of the
  worker hosts that served it.
- ``GET /v1/monitoring/slo``: the doctor's report.
- ``GET /v1/monitoring/replicas`` and ``POST
  /v1/monitoring/replicas/{index}/drain|undrain|restart`` (``?model=``: 409
  when the index now names another model).
- ``GET /v1/monitoring/tenants[/{tenant_id}]``.
- ``GET /v1/monitoring/workers[/{instance_id}]``: the federation's worker
  census (leases, load, prefix index, recent evictions).
- ``GET /v1/monitoring/fleet`` (``?host=``): the fleet's health fold over
  the worker hosts' heartbeats.

Each route is a thin adapter over a plain method that returns a dict (or
raises a problem), so the HTTP tier can change under them.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Any, Callable, Iterator, Optional

import torch

from ..gateway.http import Request, Response
from ..gateway.router import RestRouter
from ..gateway.validation import read_json
from ..modkit import failpoints as fp
from ..modkit.doctor import Doctor, DoctorConfig, default_doctor
from ..modkit.errcat import ERR
from ..modkit.flight_recorder import FlightRecorder, default_recorder
from ..modkit.metrics import MetricsRegistry, default_registry
from ..runtime.federation import stitch_timelines
from ..runtime.lifecycle import LifecycleStateError
from ..runtime.scheduler import _snapshot

logger = logging.getLogger("monitoring")

CONFIG_KEYS = frozenset({"allow_fault_injection", "doctor"})

#: the four stages of one scheduler round, one chrome-trace track each
_ROUND_STAGES = ("admit", "dispatch", "sync_wait", "host_emit")


def _chrome_trace(per_model: dict[str, list[dict]]) -> dict:
    """Round timings → Chrome trace-event JSON (Perfetto and
    chrome://tracing load it): one process per engine, one thread track per
    stage, "X" complete events in µs."""
    events: list[dict] = []
    for pid, name in enumerate(sorted(per_model), start=1):
        events.append({"ph": "M", "pid": pid, "name": "process_name",
                       "args": {"name": f"scheduler {name}"}})
        for tid, stage in enumerate(_ROUND_STAGES, start=1):
            events.append({"ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
                           "args": {"name": stage}})
        for r in per_model[name]:
            round_us = r["ts"] * 1e6
            # admission ran just before the round; the rest follow its start
            starts_us = (round_us - r["admit_ms"] * 1000.0, round_us,
                         round_us + r["dispatch_ms"] * 1000.0,
                         round_us + (r["dispatch_ms"] + r["sync_wait_ms"]) * 1000.0)
            durs_ms = (r["admit_ms"], r["dispatch_ms"], r["sync_wait_ms"], r["host_emit_ms"])
            for tid, (stage, start_us, dur_ms) in enumerate(
                    zip(_ROUND_STAGES, starts_us, durs_ms), start=1):
                events.append({"name": stage, "ph": "X", "pid": pid, "tid": tid,
                               "ts": round(start_us, 1),
                               "dur": round(max(0.0, dur_ms) * 1000.0, 1),
                               "args": {"lookahead": bool(r.get("lookahead")),
                                        "active_slots": r.get("active")}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def _mesh_info(sched: Any) -> dict:
    """An engine's ``mesh_info()``, or {} (a test double without it, a
    dying engine): a scrape never fails on it."""
    fn = getattr(sched, "mesh_info", None)
    if fn is None:
        return {}
    try:
        return fn() or {}
    except Exception:  # noqa: BLE001
        return {}


def _rank_devices(sched: Any) -> list[torch.device]:
    """Every device an engine's ranks run on (its own device without tp)."""
    mesh = getattr(sched, "mesh", None)
    return list(mesh.devices) if mesh is not None else [sched.device]


def _all_threads() -> Optional[Any]:
    """The profiler's option to record every thread's operators (the
    scheduler's and the worker's, not only the one that starts it), where
    this torch has it; kernels on the card are recorded either way."""
    try:
        from torch._C._profiler import _ExperimentalConfig

        return _ExperimentalConfig(profile_all_threads=True)
    except (ImportError, TypeError):
        return None


def pre_register(registry: MetricsRegistry) -> None:
    """The families JAX's ``MonitoringModule.init`` registers before any
    traffic, with its help text, so dashboards alert from the first scrape."""
    c, g, h = registry.counter, registry.gauge, registry.histogram
    c("watchdog_trips_total",
      "Stall-watchdog trips (scheduler_round/stream_stall/queue_age)").inc(0.0)
    g("slo_burn_rate", "SLO error-budget burn rate per objective and window")
    g("serving_state", "Degradation state (0 healthy, 1 degraded, 2 shedding, "
      "3 recovering)").set(0.0)
    g("llm_queue_depth", "Pending scheduler queue depth")
    g("llm_queue_oldest_age_seconds", "Age of the oldest pending request")
    c("fault_injected_total", "Faults injected via armed failpoints").inc(0.0)
    h("fault_recovery_seconds", "Recovery-path latency (preempt/resume, failover) in seconds")
    c("llm_replica_failovers_total",
      "Mid-stream requests resubmitted to another replica").inc(0.0)
    c("llm_cache_aware_placements_total",
      "Requests routed by the prefix-cache affinity hint").inc(0.0)
    c("llm_pd_handoffs_total", "Streams handed prefill→decode across PD role groups").inc(0.0)
    c("llm_cancellations_total",
      "Requests cancelled end-to-end, by reason (client_disconnect/deadline/…)").inc(0.0)
    c("llm_cancel_reclaimed_tokens_total",
      "max_tokens budget NOT generated thanks to cancellation "
      "(reclaimed decode capacity)").inc(0.0)
    c("llm_client_disconnects_total",
      "SSE consumers that vanished mid-response (socket-level disconnects at the "
      "gateway writer; gateway-timeout aborts count only under "
      "llm_cancellations_total)").inc(0.0)
    g("llm_cancellation_rate", "Fraction of recent terminals that were cancelled/deadline-"
      "lapsed (fast window)").set(0.0)
    c("llm_tenant_rejections_total",
      "Per-tenant scheduler rejections by reason (pending/quota)").inc(0.0)
    c("llm_tenant_budget_rejections_total",
      "Requests rejected at the gateway because the tenant's token budget is "
      "exhausted").inc(0.0)
    c("llm_tenant_soft_yields_total",
      "Slots preempted to host by the tenant soft page-quota sweep under "
      "contention").inc(0.0)
    g("llm_tenant_queue_depth", "Pending scheduler queue depth per tenant")
    g("llm_tenant_token_share", "Tenant share of recently consumed tokens (0..1)")
    g("llm_tenant_shed", "1 while this tenant is selectively shed (over fair share "
      "during SLO burn)")
    # the federation's families: a stack without it scrapes 0, as in JAX
    c("llm_remote_worker_announcements_total",
      "Worker processes announced to the federation registry").inc(0.0)
    c("llm_remote_worker_heartbeats_total",
      "Worker lease renewals (heartbeats with gossip census)").inc(0.0)
    c("llm_remote_worker_evictions_total",
      "Worker hosts evicted by reason (lease_expired/crash/withdrawn)").inc(0.0)
    c("llm_federated_placements_total",
      "Federated host placements by routing reason (prefix/health/load/random)").inc(0.0)
    c("llm_federated_failovers_total",
      "Mid-stream requests re-prefilled on a surviving host").inc(0.0)
    c("llm_replica_rebuilds_total", "Replica rebuilds by outcome (ok/failed)").inc(0.0)
    g("llm_replicas_healthy", "Replicas in lifecycle state healthy").set(0.0)
    g("llm_replicas_benched", "Replicas benched after repeated strikes").set(0.0)
    c("llm_spec_tokens_proposed_total",
      "Draft tokens proposed to the scheduler's ragged verify spans").inc(0.0)
    c("llm_spec_tokens_accepted_total",
      "Draft tokens the on-device greedy verify accepted").inc(0.0)


class MonitoringModule:
    """``config`` is the ``monitoring`` module's ``config`` section;
    ``worker`` the llm worker whose engines the gauges, the doctor and the
    routes read (in a federated stack, the federated pool); ``home_dir``
    where device traces go; ``workers`` resolves the grpc hub's worker
    registry (None, or resolving None: not a federated stack)."""

    def __init__(self, config: Optional[dict[str, Any]], worker: Any, home_dir: Path,
                 registry: Optional[MetricsRegistry] = None,
                 doctor: Doctor = default_doctor,
                 recorder: FlightRecorder = default_recorder,
                 workers: Optional[Callable[[], Any]] = None) -> None:
        config = dict(config or {})
        unknown = sorted(set(config) - CONFIG_KEYS)
        if unknown:
            raise ValueError(f"monitoring config: unknown keys {unknown}")
        self.worker = worker
        self._workers = workers or (lambda: None)
        self.home_dir = Path(home_dir)
        self.registry = registry or default_registry
        self.recorder = recorder
        #: arming failpoints over REST is opt-in per deployment
        self.allow_fault_injection = bool(config.get("allow_fault_injection", False))
        # configure() resets the state machine: every boot starts healthy
        doctor.configure(DoctorConfig.from_config(config.get("doctor")))
        doctor.set_scheduler_provider(self.worker.schedulers)
        doctor.set_capacity_provider(self.worker.replica_capacity)
        self.doctor = doctor
        self._profiler: Optional[Any] = None
        self._profile_dir: Optional[Path] = None
        #: a stop that raised after the state was cleared: the profiler may
        #: still be live, and the next start stops it first
        self._profiler_maybe_live: Optional[Any] = None
        pre_register(self.registry)
        self._register_gauges()

    # ------------------------------------------------------------ lifecycle
    def start(self) -> None:
        self.doctor.ensure_started()

    def stop(self) -> None:
        """The doctor's thread and its providers must not outlive the host:
        a leaked evaluator would watch a dead worker's engines."""
        self.doctor.stop()
        self.doctor.set_scheduler_provider(None)
        self.doctor.set_capacity_provider(None)
        self.doctor.detach_recorder()
        if self._profiler is not None:
            try:
                self._profiler.stop()
            except Exception:  # noqa: BLE001 — teardown must not raise
                pass
            self._profiler = self._profile_dir = None

    # ---------------------------------------------------------------- gauges
    def _schedulers(self) -> Iterator[Any]:
        for _, sched in self.worker.schedulers():
            yield sched

    def _cuda_devices(self) -> list[torch.device]:
        """The CUDA cards the engines serve on (none when they run on the
        CPU or none is built yet)."""
        devs = {d for s in self._schedulers() for d in _rank_devices(s) if d.type == "cuda"}
        return sorted(devs, key=lambda d: d.index or 0)

    def _register_gauges(self) -> None:
        g = self.registry.gauge

        def device_count() -> float:
            # a federated gateway holds no engine: its cards are the hosts'
            on_card = str(getattr(self.worker, "device", "cpu")) != "cpu"
            return float(torch.cuda.device_count()) if on_card and \
                torch.cuda.is_available() else 0.0

        def hbm_in_use() -> float:
            devs = self._cuda_devices()
            # the allocator's own counters: host-side, no device sync
            return float(torch.cuda.memory_allocated(devs[0])) if devs else 0.0

        def hbm_utilization_per_device() -> float:
            worst = max((torch.cuda.memory_allocated(d)
                         / torch.cuda.get_device_properties(d).total_memory
                         for d in self._cuda_devices()), default=0.0)
            if worst > 0.0:
                return worst
            # off the card: the engines' plans, and only enforced ones (an
            # unenforced plan's budget is no device this host has)
            for sched in self._schedulers():
                plan = _mesh_info(sched).get("plan") or {}
                if plan.get("enforced"):
                    worst = max(worst, float(plan.get("hbm_utilization", 0.0)))
            return worst

        def mesh_devices() -> float:
            width = 1 if any(True for _ in self._schedulers()) else 0
            for sched in self._schedulers():
                width = max(width, int(_mesh_info(sched).get("devices", 1)))
            return float(width)

        g("tpu_devices", "Accelerator devices visible to this host (CUDA cards when the "
          "engines serve on the card, else 0)").set_function(device_count)
        g("tpu_hbm_bytes_in_use", "Device memory in use on the serving CUDA card (the "
          "allocator's bytes in use; 0 off the card)").set_function(hbm_in_use)
        g("llm_mesh_devices", "Devices in the widest serving mesh (tp degree; 1 = "
          "unsharded)").set_function(mesh_devices)
        g("llm_hbm_utilization_per_device", "Worst per-card device-memory utilization "
          "(the allocator's bytes in use over the CUDA card's total memory; off the "
          "card, the worst enforced feasibility plan's)"
          ).set_function(hbm_utilization_per_device)
        def remote_workers_healthy() -> float:
            reg = self._workers()
            return float(reg.healthy()) if reg is not None else 0.0

        g("llm_remote_workers_healthy", "Worker hosts holding a live federation lease"
          ).set_function(remote_workers_healthy)
        g("llm_batch_active_slots", "Active continuous-batching slots").set_function(
            lambda: float(sum(s.active_slots for s in self._schedulers())))

        def decode_overlap_ratio() -> float:
            rounds = ahead = 0
            for s in self._schedulers():
                rounds += s.rounds["decode"]
                ahead += s.lookahead["used"]
            return ahead / rounds if rounds else 0.0

        g("llm_decode_overlap_ratio", "Decode rounds served by a lookahead-dispatched chunk "
          "(0..1)").set_function(decode_overlap_ratio)

        def lookahead_depth() -> float:
            weighted = total = 0
            for s in self._schedulers():
                for d, n in _snapshot(lambda: list(s.depth_hist.items())):
                    weighted += int(d) * n
                    total += n
            return weighted / total if total else 0.0

        g("llm_lookahead_depth", "Mean lookahead-ring depth still in flight at chunk drain "
          "time").set_function(lookahead_depth)

        def lookahead_discard_ratio() -> float:
            dispatched = discarded = 0
            for s in self._schedulers():
                dispatched += s.lookahead["dispatched"]
                discarded += s.lookahead["discarded"]
            return discarded / dispatched if dispatched else 0.0

        g("llm_lookahead_discard_ratio", "Speculative decode chunks discarded as stale / "
          "dispatched (0..1)").set_function(lookahead_discard_ratio)

        def round_dispatch_ms(kind: str, q: float) -> Callable[[], float]:
            def read() -> float:
                samples = sorted(t["dispatch_ms"] for s in self._schedulers()
                                 for t in _snapshot(lambda: list(s.round_timings))
                                 if t["kind"] == kind)
                return float(samples[min(len(samples) - 1, int(q * len(samples)))]) \
                    if samples else 0.0
            return read

        dispatch = g("llm_round_dispatch_ms", "Scheduler round dispatch time by round kind "
                     "(decode/mixed/prefill) and quantile")
        for kind in ("decode", "mixed", "prefill"):
            for q, qname in ((0.50, "p50"), (0.99, "p99")):
                dispatch.set_function(round_dispatch_ms(kind, q), kind=kind, quantile=qname)

        def spec_accept_len() -> float:
            weighted = total = 0
            for s in self._schedulers():
                for a, n in _snapshot(lambda: list(s._spec_accept_hist.items())):
                    weighted += int(a) * n
                    total += n
            return weighted / total if total else 0.0

        g("llm_spec_accept_len", "Mean accepted draft length per speculative verify span"
          ).set_function(spec_accept_len)

        def pool_stats() -> Iterator[dict]:
            for s in self._schedulers():
                if s.pool is not None:
                    yield s.pool.stats()

        def prefix_hit_rate() -> float:
            saved = total = 0
            for st in pool_stats():
                saved += st["prefill_tokens_saved"]
                total += st["prefill_tokens_total"]
            return saved / total if total else 0.0

        g("llm_prefix_cache_hit_rate", "Cached vs total prefill tokens across paged pools "
          "(0..1)").set_function(prefix_hit_rate)
        g("llm_prefill_tokens_saved_total", "Prefill tokens skipped via prefix-cache hits "
          "(cumulative)").set_function(
            lambda: float(sum(st["prefill_tokens_saved"] for st in pool_stats())))
        g("llm_prefill_chunk_tokens_total", "Prompt tokens prefilled via mixed-batch chunks "
          "piggybacked into decode rounds (cumulative)").set_function(
            lambda: float(sum(s.chunked_prefill_tokens for s in self._schedulers())))

        def queue_wait_p50_ms() -> float:
            waits = sorted(w for s in self._schedulers()
                           for w in _snapshot(lambda: list(s.queue_wait_samples)))
            return float(waits[len(waits) // 2]) if waits else 0.0

        g("llm_queue_wait_p50_ms", "p50 pending-queue wait of admitted requests (ms)"
          ).set_function(queue_wait_p50_ms)

    # ------------------------------------------------------------ surfaces
    def metrics_text(self) -> str:
        """The exposition; a federated gateway's merges the worker hosts'
        snapshots, host-labelled (a failing fold falls back to the plain
        render, never to a scrape error)."""
        fleet = getattr(self.worker, "fleet", None)
        if fleet is not None:
            try:
                return fleet.render_with(self.registry)
            except Exception:  # noqa: BLE001
                logger.exception("fleet metrics fold failed")
        return self.registry.render()

    def profiler_start(self) -> dict[str, Any]:
        if self._profiler is not None:
            raise ERR.monitoring.profiler_running.error(
                f"trace already running at {self._profile_dir}")
        from torch.profiler import ProfilerActivity, profile

        out = self.home_dir / "profiles" / f"trace-{int(time.time())}"
        out.mkdir(parents=True, exist_ok=True)
        if self._profiler_maybe_live is not None:
            try:
                self._profiler_maybe_live.stop()
            except Exception:  # noqa: BLE001 — best effort: it may be stopped
                pass
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(ProfilerActivity.CUDA)
        prof = profile(activities=activities, experimental_config=_all_threads())
        prof.start()
        # only a started profiler proves the stale one is gone
        self._profiler_maybe_live = None
        self._profiler, self._profile_dir = prof, out
        return {"status": "started", "dir": str(out)}

    def profiler_stop(self) -> dict[str, Any]:
        if self._profiler is None:
            raise ERR.monitoring.profiler_not_running.error("no trace running")
        # state cleared first: a failing stop must not wedge the endpoints
        prof, out = self._profiler, self._profile_dir
        self._profiler = self._profile_dir = None
        try:
            prof.stop()
            prof.export_chrome_trace(str(out / "trace.json"))
        except Exception as e:  # noqa: BLE001
            self._profiler_maybe_live = prof
            raise ERR.monitoring.profiler_stop_failed.error(str(e)[:200])
        files = sorted(str(p.relative_to(out)) for p in out.rglob("*") if p.is_file())
        return {"status": "stopped", "dir": str(out), "files": files}

    def _require_faultlab(self) -> None:
        if not self.allow_fault_injection:
            raise ERR.monitoring.faultlab_disabled.error(
                "fault injection is disabled; set monitoring.allow_fault_injection: true "
                "for chaos rehearsals")

    def list_failpoints(self) -> dict[str, Any]:
        return {"enabled": self.allow_fault_injection,
                "catalog": {name: {"layer": layer, "description": desc}
                            for name, (layer, desc) in sorted(fp.FAILPOINT_CATALOG.items())},
                "armed": {name: action.__dict__ for name, action in fp.armed().items()},
                "stats": fp.stats()}

    async def _remote_failpoint(self, host: str, action: str, name: str, spec: Any,
                                seed: Optional[int]) -> dict[str, Any]:
        """A failpoint armed or disarmed on a federated worker host over its
        observability service; its refusals map onto the local problems."""
        remote = getattr(self.worker, "remote_failpoint", None)
        if remote is None:
            raise ERR.monitoring.unknown_host.error(
                f"unknown worker host {host!r} (not a federated stack)")
        try:
            resp = await remote(host, action, name, spec, seed=seed)
        except KeyError:
            raise ERR.monitoring.unknown_host.error(f"unknown worker host {host!r}")
        if not resp.get("ok"):
            err = str(resp.get("error") or "remote refusal")
            if "unknown failpoint" in err:
                raise ERR.monitoring.unknown_failpoint.error(err)
            if "disabled" in err:
                raise ERR.monitoring.faultlab_disabled.error(f"worker host {host!r}: {err}")
            raise ERR.monitoring.bad_failpoint_spec.error(err[:200])
        return resp

    async def arm_failpoint(self, name: str, body: dict[str, Any]) -> dict[str, Any]:
        self._require_faultlab()
        if body.get("host"):
            # the point fires in the worker host's process, not here
            await self._remote_failpoint(body["host"], "arm", name,
                                         body.get("spec", "raise"), body.get("seed"))
            return {"armed": name, "host": body["host"]}
        if "seed" in body:
            fp.configure(int(body["seed"]))
        try:
            fp.arm(name, body.get("spec", "raise"))
        except KeyError as e:
            raise ERR.monitoring.unknown_failpoint.error(str(e).strip("'\""))
        except (ValueError, TypeError) as e:
            raise ERR.monitoring.bad_failpoint_spec.error(str(e)[:200])
        return {"armed": name, "stats": fp.stats()}

    async def disarm_failpoint(self, name: str, host: Optional[str] = None) -> dict[str, Any]:
        self._require_faultlab()
        if host:
            await self._remote_failpoint(host, "disarm", name, "off", None)
            return {"disarmed": True, "host": host}
        if name not in fp.FAILPOINT_CATALOG:
            raise ERR.monitoring.unknown_failpoint.error(f"unknown failpoint {name!r}")
        return {"disarmed": fp.disarm(name)}

    def reset_failpoints(self) -> dict[str, Any]:
        self._require_faultlab()
        fp.reset()
        return {"reset": True}

    def list_requests(self, stalled_only: bool = False, recent: int = 20) -> dict[str, Any]:
        rows = self.recorder.inflight(stalled_only=stalled_only)
        rows.sort(key=lambda r: -r["age_s"])
        return {"in_flight": rows, "recent": self.recorder.recent(recent),
                "recorder": self.recorder.stats()}

    async def request_timeline(self, request_id: str) -> dict[str, Any]:
        """The request's flight record; in a federated stack, stitched with
        the segment of every worker host its gateway events name (the
        serving host, a failover's host), pulled over the observability
        wire. A dead host's segment is just absent."""
        rec = self.recorder.lookup(request_id)
        if rec is None:
            raise ERR.monitoring.unknown_request.error(
                f"no flight record for request {request_id!r} (live table + finished "
                "ring miss — it may have aged out)")
        fetch = getattr(self.worker, "fetch_remote_timeline", None)
        if fetch is None:
            return rec
        hosts: list[str] = []
        for ev in rec.get("timeline") or ():
            for key in ("worker_host", "from_host"):
                h = ev.get(key)
                if h and h not in hosts:
                    hosts.append(h)
        segments = {}
        for h in hosts:
            seg = await fetch(h, request_id)
            if seg is not None:
                segments[h] = seg
        return stitch_timelines(rec, segments) if segments else rec

    def rounds(self, fmt: str = "json", limit: int = 512) -> dict[str, Any]:
        if fmt not in ("json", "chrome-trace"):
            raise ERR.monitoring.bad_export_format.error(
                f"format {fmt!r} not supported; use json or chrome-trace")
        per_model: dict[str, list[dict]] = {}
        for name, sched in self.worker.schedulers():
            rounds = _snapshot(lambda: list(sched.round_timings))
            per_model[name] = rounds[-limit:] if limit else []
        return {"rounds": per_model} if fmt == "json" else _chrome_trace(per_model)

    def slo(self) -> dict[str, Any]:
        return self.doctor.report()

    def replicas(self) -> dict[str, Any]:
        return {"replicas": self.worker.replicas_view(),
                "capacity": self.worker.replica_capacity()}

    def replica_action(self, index: int, action: str, expect_model: Optional[str] = None,
                       deadline_s: Optional[float] = None) -> dict[str, Any]:
        try:
            return self.worker.replica_control(index, action, deadline_s=deadline_s,
                                               expect_model=expect_model)
        except (KeyError, IndexError) as e:
            raise ERR.monitoring.unknown_replica.error(str(e).strip("'\""))
        except LifecycleStateError as e:
            raise ERR.monitoring.replica_conflict.error(str(e))

    def _tenant_rows(self) -> dict[str, dict]:
        usage = self.worker.tenant_usage()
        shed = set(self.doctor.report().get("shed_tenants", ()))
        for tenant, row in usage.items():
            row["shed"] = tenant in shed
        return usage

    def tenants(self) -> dict[str, Any]:
        rows = self._tenant_rows()
        return {"tenants": [rows[t] for t in sorted(rows)], "count": len(rows)}

    def workers(self) -> dict[str, Any]:
        """The federation's worker census (an empty table off federation)."""
        reg = self._workers()
        if reg is None:
            return {"workers": [], "evicted": [], "lease_ttl_s": 0.0,
                    "prefix_index_size": 0, "federation": False}
        return {**reg.rows(), "federation": True}

    def worker_row(self, instance_id: str) -> dict[str, Any]:
        reg = self._workers()
        w = reg.lookup(instance_id) if reg is not None else None
        if w is None:
            raise ERR.monitoring.unknown_worker.error(
                f"no live federation lease for worker {instance_id!r} (never announced, "
                "withdrawn, or evicted)")
        return w.row(lease_ttl_s=reg.lease_ttl_s)

    def fleet(self, host: Optional[str] = None) -> dict[str, Any]:
        """The fleet's health fold (``host``: that host's row only; 404 for a
        host no live lease carries)."""
        fleet = getattr(self.worker, "fleet", None)
        if fleet is None:
            if host:
                raise ERR.monitoring.unknown_host.error(
                    f"unknown worker host {host!r} (not a federated stack)")
            return {"federation": False, "state": "unknown", "reasons": [], "hosts": [],
                    "objectives": [], "workers": 0, "stale": 0, "lease_ttl_s": 0.0}
        doc = fleet.report()
        if host:
            rows = [r for r in doc["hosts"] if host in (r.get("host"), r.get("instance_id"))]
            if not rows:
                raise ERR.monitoring.unknown_host.error(
                    f"unknown worker host {host!r} (no live lease carries that host name "
                    "or instance id)")
            doc = {**doc, "hosts": rows}
        return doc

    def tenant(self, tenant_id: str) -> dict[str, Any]:
        row = self._tenant_rows().get(tenant_id)
        if row is None:
            raise ERR.monitoring.unknown_tenant.error(
                f"no live scheduler state for tenant {tenant_id!r} (it has no pending, "
                "active, or previously charged work on this node)")
        return row

    # ---------------------------------------------------------------- REST
    def register_rest(self, router: RestRouter) -> None:
        m, mon = "monitoring", "/v1/monitoring"

        def int_param(request: Request, name: str, default: int) -> int:
            raw = request.query.get(name)
            if raw is None:
                return default
            try:
                value = int(raw)
            except ValueError:
                raise ERR.core.bad_request.error(
                    f"query parameter {name!r} must be an integer, got {raw!r}")
            if value < 0:
                raise ERR.core.bad_request.error(f"query parameter {name!r} must be >= 0")
            return value

        async def metrics(request: Request) -> Response:
            return Response(self.metrics_text().encode(), 200,
                            "text/plain; version=0.0.4; charset=utf-8")

        async def list_requests(request: Request) -> dict:
            raw = request.query.get("stalled", "").lower()
            if raw not in ("", "true", "false", "1", "0"):
                raise ERR.core.bad_request.error(
                    f"query parameter 'stalled' must be true or false, got {raw!r}")
            return self.list_requests(raw in ("true", "1"), int_param(request, "recent", 20))

        async def rounds(request: Request) -> Any:
            fmt = request.query.get("format", "json")
            doc = self.rounds(fmt, int_param(request, "limit", 512))
            if fmt == "json":
                return doc
            resp = Response.json(doc)
            resp.headers["Content-Disposition"] = \
                'attachment; filename="scheduler-rounds.json"'
            return resp

        async def arm(request: Request) -> dict:
            self._require_faultlab()
            body = read_json(await request.read(), {
                "type": "object",
                "properties": {"spec": {"type": ["string", "object"]},
                               "seed": {"type": "integer"}, "host": {"type": "string"}},
                "additionalProperties": False})
            return await self.arm_failpoint(request.match_info["name"], body)

        def replica_index(request: Request) -> int:
            raw = request.match_info["index"]
            try:
                return int(raw)
            except ValueError:
                raise ERR.core.bad_request.error(
                    f"replica index must be an integer, got {raw!r}")

        def replica_route(action: str):
            async def handler(request: Request) -> dict:
                deadline_s = None
                if action == "drain" and request.content_length:
                    body = read_json(await request.read(), {
                        "type": "object",
                        "properties": {"deadline_s": {"type": "number", "minimum": 0}},
                        "additionalProperties": False})
                    deadline_s = body.get("deadline_s")
                return self.replica_action(replica_index(request), action,
                                           request.query.get("model"), deadline_s)
            return handler

        async def profiler_start(request: Request) -> dict:
            return self.profiler_start()

        async def profiler_stop(request: Request) -> dict:
            return self.profiler_stop()

        async def list_failpoints(request: Request) -> dict:
            return self.list_failpoints()

        async def disarm(request: Request) -> dict:
            return await self.disarm_failpoint(request.match_info["name"],
                                               request.query.get("host"))

        async def reset(request: Request) -> dict:
            return self.reset_failpoints()

        async def timeline(request: Request) -> dict:
            return await self.request_timeline(request.match_info["request_id"])

        async def slo(request: Request) -> dict:
            return self.slo()

        async def replicas(request: Request) -> dict:
            return self.replicas()

        async def tenants(request: Request) -> dict:
            return self.tenants()

        async def tenant(request: Request) -> dict:
            return self.tenant(request.match_info["tenant_id"])

        async def workers(request: Request) -> dict:
            return self.workers()

        async def worker_row(request: Request) -> dict:
            return self.worker_row(request.match_info["instance_id"])

        async def fleet(request: Request) -> dict:
            return self.fleet(request.query.get("host"))

        for method, path, handler in (
                ("GET", "/metrics", metrics),
                ("POST", f"{mon}/profiler/start", profiler_start),
                ("POST", f"{mon}/profiler/stop", profiler_stop),
                ("GET", f"{mon}/failpoints", list_failpoints),
                ("PUT", f"{mon}/failpoints/{{name}}", arm),
                ("DELETE", f"{mon}/failpoints/{{name}}", disarm),
                ("DELETE", f"{mon}/failpoints", reset),
                ("GET", f"{mon}/requests", list_requests),
                ("GET", f"{mon}/requests/{{request_id}}", timeline),
                ("GET", f"{mon}/rounds", rounds),
                ("GET", f"{mon}/slo", slo),
                ("GET", f"{mon}/replicas", replicas),
                ("POST", f"{mon}/replicas/{{index}}/drain", replica_route("drain")),
                ("POST", f"{mon}/replicas/{{index}}/undrain", replica_route("undrain")),
                ("POST", f"{mon}/replicas/{{index}}/restart", replica_route("restart")),
                ("GET", f"{mon}/tenants", tenants),
                ("GET", f"{mon}/tenants/{{tenant_id}}", tenant),
                ("GET", f"{mon}/workers", workers),
                ("GET", f"{mon}/workers/{{instance_id}}", worker_row),
                ("GET", f"{mon}/fleet", fleet)):
            router.route(method, path, handler, module=m)
