"""Cross-host federation: the remote-worker data plane (the port's copy of
``runtime/federation.py``).

Two pieces, both transport-free (the gateway injects a gRPC client factory;
this tier never imports grpc):

* :class:`WorkerRegistry` — the gateway-side census of worker processes.
  Workers **announce** themselves, then **heartbeat** with a capacity /
  role / model census plus radix-tree prefix digests; a missed lease
  window evicts the host (``grpc_hub._evict_tick`` drives the sweep).
  Lease expiry and crash reports fire ``on_lease_expired`` — the doctor's
  "lost host = lost capacity" feed.

* :class:`FederatedServingPool` — an ``LlmWorkerApi``-shaped router that
  places each request on the best host: longest gossiped-prefix match
  within a load slack (the RTP-LLM recipe, generalized from the
  in-process ``DataParallelServingPool._pick``), else least-loaded, else
  a seeded random tie-break — routing precedence **prefix > load >
  random**. Mid-stream host crashes fail over to a survivor with the
  emitted tokens carried as a continuation (``_resume_token_ids`` /
  ``_resume_sent_text``), mirroring ``replicas._failover``: streams stay
  bit-identical and exactly one terminal reaches the client.

The **gossip payload** a worker piggybacks on each heartbeat::

    {"load": 3, "capacity": {...replica_capacity()...},
     "models": ["local::tiny-llama"], "roles": ["chat"],
     "requests_served": 17,
     "prefix": {"local::tiny-llama": [["ab12..", "9f0e..", ...], ...]},
     "recent_traces": {"req-1": "4bf9..."}}

``prefix`` maps model → digest *chains*: position ``i`` holds the chained
hash of the first ``i+1`` text blocks of a prompt whose KV prefix is still
resident in that worker's radix tree (the worker probes
``peek_prefix_len`` at census time, so evicted prefixes age out of the
gossip within one heartbeat). The router hashes the incoming prompt the
same way and scores hosts by longest common chain prefix — a text-block
approximation of token-level ``peek_prefix_len``, which is exactly enough
for a placement *hint* (a wrong hint costs a prefill, never correctness).
"""

from __future__ import annotations

import asyncio
import hashlib
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterable, Optional

from ..modkit.failpoints import failpoint, record_recovery
from ..modkit.flight_recorder import annotate_request, record_event
from ..modkit.metrics import bump_counter

logger = logging.getLogger("federation")

__all__ = ["FederatedServingPool", "FederationConfig", "FleetView",
           "HostShedError", "WorkerInfo", "WorkerRegistry", "digest_chain",
           "prompt_text", "stitch_timelines"]


class HostShedError(RuntimeError):
    """Every routable worker host is in doctor state ``shedding`` — the
    fleet-scoped analogue of the local admission gate's load shed. The
    router raises it instead of placing work a sick host would shed anyway;
    the stream layer maps it to ``ERR.llm.load_shed`` (429 + Retry-After),
    NOT to the 503 capacity hole of a truly empty fleet."""

    def __init__(self, message: str, retry_after_s: float = 2.0) -> None:
        super().__init__(message)
        self.retry_after_s = float(retry_after_s)


# ------------------------------------------------------------- prefix digests

def prompt_text(messages: Optional[list] = None,
                prompt: Optional[str] = None) -> str:
    """The canonical text both sides of the wire digest: the raw completion
    prompt, or every text part of the chat messages in order. Router and
    worker must agree byte-for-byte, so neither renders the chat template."""
    if prompt is not None:
        return prompt
    parts: list[str] = []
    for m in messages or ():
        content = m.get("content")
        if isinstance(content, str):
            parts.append(content)
            continue
        for p in content or ():
            if isinstance(p, dict) and p.get("type") == "text":
                parts.append(str(p.get("text", "")))
    return "\x1f".join(parts)


def digest_chain(text: str, block_chars: int = 48,
                 max_blocks: int = 64) -> list[str]:
    """Chained block hashes of ``text``: position ``i`` digests blocks
    ``0..i``, so two chains share a prefix exactly when the texts share
    those leading blocks (a hash-chain radix path). Short tails (< one
    block) are dropped — they cannot carry a reusable KV page anyway."""
    chain: list[str] = []
    h = hashlib.sha1()
    for i in range(0, min(len(text), block_chars * max_blocks), block_chars):
        block = text[i:i + block_chars]
        if len(block) < block_chars:
            break
        h.update(block.encode("utf-8", "replace"))
        chain.append(h.hexdigest()[:12])
    return chain


def match_depth(chain: list[str], candidates: Iterable[list[str]]) -> int:
    """Longest common chain prefix between ``chain`` and any candidate —
    the ``peek_prefix_len`` analogue over gossiped digests."""
    best = 0
    for cand in candidates:
        d = 0
        for a, b in zip(chain, cand):
            if a != b:
                break
            d += 1
        if d > best:
            best = d
    return best


# ------------------------------------------------------------------ registry

@dataclass
class WorkerInfo:
    """One announced worker process (a host in the federation)."""

    instance_id: str
    host: str                      # display name ("worker-0", a hostname)
    endpoint: str                  # host:port the gateway dials back
    roles: tuple[str, ...] = ()
    models: tuple[str, ...] = ()
    pid: int = 0
    registered_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.time)
    census: dict[str, Any] = field(default_factory=dict)
    heartbeats: int = 0

    def row(self, now: Optional[float] = None,
            lease_ttl_s: float = 0.0) -> dict[str, Any]:
        now = time.time() if now is None else now
        prefix = self.census.get("prefix") or {}
        return {
            "instance_id": self.instance_id,
            "host": self.host,
            "endpoint": self.endpoint,
            "roles": list(self.roles),
            "models": list(self.models) or sorted(
                self.census.get("models") or []),
            "pid": self.pid,
            "lease_age_s": round(now - self.last_heartbeat, 3),
            "expires_in_s": round(
                max(0.0, lease_ttl_s - (now - self.last_heartbeat)), 3),
            "heartbeats": self.heartbeats,
            "load": int(self.census.get("load") or 0),
            "capacity": self.census.get("capacity") or {},
            "requests_served": int(self.census.get("requests_served") or 0),
            "prefix_index": {m: len(chains) for m, chains in prefix.items()},
            "recent_traces": self.census.get("recent_traces") or {},
        }


class WorkerRegistry:
    """Gateway-side worker census: announce → heartbeat → lease-expiry evict.

    The single ``_lock`` guards the worker table
    and is never held across I/O or listener calls — every mutator snapshots
    under the lock and notifies outside it, so the registry can sit on the
    hub's evict tick and the router's submit path at once."""

    def __init__(self, lease_ttl_s: float = 10.0) -> None:
        self.lease_ttl_s = float(lease_ttl_s)
        self._lock = threading.Lock()
        self._workers: dict[str, WorkerInfo] = {}
        #: bounded memory of departed hosts: monitoring shows *why* capacity
        #: shrank, and replica_capacity() counts them as lost replicas
        self._evicted: list[dict[str, Any]] = []
        self._listeners: list[Callable[[WorkerInfo, str], None]] = []
        self._seq = 0

    # ------------------------------------------------------------- mutators
    def announce(self, info: dict[str, Any]) -> dict[str, Any]:
        """Register (or re-register) a worker. Idempotent on instance_id —
        a worker that missed heartbeats and got evicted re-announces with
        the same id and simply reappears."""
        with self._lock:
            self._seq += 1
            instance_id = str(info.get("instance_id") or
                              f"fedw-{self._seq}-{random.getrandbits(32):08x}")
            w = WorkerInfo(
                instance_id=instance_id,
                host=str(info.get("host") or instance_id),
                endpoint=str(info["endpoint"]),
                roles=tuple(info.get("roles") or ()),
                models=tuple(info.get("models") or ()),
                pid=int(info.get("pid") or 0),
            )
            self._workers[instance_id] = w
        bump_counter("llm_remote_worker_announcements_total")
        return {"instance_id": instance_id, "lease_ttl_s": self.lease_ttl_s}

    def heartbeat(self, instance_id: str,
                  census: Optional[dict[str, Any]] = None) -> bool:
        """Refresh a lease and merge the gossip payload. Returns False for
        an unknown id (evicted / never announced) — the worker re-announces.
        Non-blocking, never-raises emits only."""
        with self._lock:
            w = self._workers.get(instance_id)
            if w is None:
                return False
            w.last_heartbeat = time.time()
            w.heartbeats += 1
            if census:
                w.census = census
        bump_counter("llm_remote_worker_heartbeats_total")
        return True

    def withdraw(self, instance_id: str) -> bool:
        """Graceful departure (SIGTERM path) — no failure accounting."""
        return self._remove(instance_id, "withdrawn") is not None

    def report_failure(self, instance_id: str, reason: str = "crash") -> None:
        """A router saw the host die mid-stream: evict NOW instead of
        waiting out the lease (lost host = lost capacity, immediately)."""
        self._remove(instance_id, reason)

    def evict_expired(self, now: Optional[float] = None) -> list[str]:
        """Lease sweep (called from grpc_hub's evict tick)."""
        now = time.time() if now is None else now
        cutoff = now - self.lease_ttl_s
        with self._lock:
            stale = [k for k, w in self._workers.items()
                     if w.last_heartbeat < cutoff]
        evicted = []
        for k in stale:
            if self._remove(k, "lease_expired") is not None:
                evicted.append(k)
        return evicted

    def _remove(self, instance_id: str, reason: str) -> Optional[WorkerInfo]:
        with self._lock:
            w = self._workers.pop(instance_id, None)
            if w is None:
                return None
            self._evicted.append({
                "instance_id": w.instance_id, "host": w.host,
                "endpoint": w.endpoint, "reason": reason,
                "evicted_at": time.time()})
            del self._evicted[:-16]
        self.on_lease_expired(w, reason)
        return w

    # ------------------------------------------------------------ listeners
    def add_lease_listener(self,
                           fn: Callable[[WorkerInfo, str], None]) -> None:
        """Subscribe to departures: ``fn(worker, reason)`` with reason in
        {lease_expired, crash, withdrawn}. Idempotent."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def on_lease_expired(self, worker: WorkerInfo, reason: str) -> None:
        """Departure fan-out — called OUTSIDE the lock; every emit is a
        never-raises helper and every listener is wrapped (the hub's evict
        tick must survive a bad observer)."""
        bump_counter("llm_remote_worker_evictions_total", reason=reason)
        record_event(f"fed/{worker.host}", "evicted", reason=reason,
                     endpoint=worker.endpoint)
        for fn in list(self._listeners):
            try:
                fn(worker, reason)
            except Exception:  # noqa: BLE001 — observers never break eviction
                pass

    # ---------------------------------------------------------------- reads
    def alive(self, model: Optional[str] = None,
              role: Optional[str] = None) -> list[WorkerInfo]:
        """Live workers, optionally filtered to those serving ``model`` /
        ``role`` (a worker that advertises no model census serves any)."""
        with self._lock:
            out = list(self._workers.values())
        if model:
            out = [w for w in out
                   if not (w.models or w.census.get("models"))
                   or model in w.models
                   or model in (w.census.get("models") or ())]
        if role:
            out = [w for w in out if not w.roles or role in w.roles]
        return sorted(out, key=lambda w: w.instance_id)

    def lookup(self, instance_id: str) -> Optional[WorkerInfo]:
        with self._lock:
            return self._workers.get(instance_id)

    def healthy(self) -> int:
        with self._lock:
            return len(self._workers)

    def index_size(self) -> int:
        """Total gossiped prefix chains across live workers — the global
        prefix index's footprint gauge."""
        with self._lock:
            return sum(len(chains)
                       for w in self._workers.values()
                       for chains in (w.census.get("prefix") or {}).values())

    def rows(self) -> dict[str, Any]:
        now = time.time()
        with self._lock:
            workers = [w.row(now, self.lease_ttl_s)
                       for w in sorted(self._workers.values(),
                                       key=lambda w: w.instance_id)]
            evicted = list(self._evicted)
        return {"workers": workers, "evicted": evicted,
                "lease_ttl_s": self.lease_ttl_s,
                "prefix_index_size": self.index_size()}


# ------------------------------------------------------------- fleet view

def _render_sample(name: str, kind: str, labels: dict[str, str],
                   value: Any) -> list[str]:
    """One snapshot sample → Prometheus exposition lines. Histogram values
    arrive as the ``{buckets, sum, count}`` wire shape; anything that will
    not coerce to a float renders as nothing (hostile payload discipline)."""
    from ..modkit.metrics import _fmt_labels

    if kind == "histogram" and isinstance(value, dict):
        out: list[str] = []
        buckets = value.get("buckets") or {}
        try:
            bounds = sorted(buckets, key=float)
        except (TypeError, ValueError):
            bounds = sorted(str(b) for b in buckets)
        try:
            for b in bounds:
                out.append(f"{name}_bucket"
                           f"{_fmt_labels({**labels, 'le': str(b)})} "
                           f"{int(buckets[b])}")
            count = int(value.get("count") or 0)
            out.append(f"{name}_bucket{_fmt_labels({**labels, 'le': '+Inf'})} "
                       f"{count}")
            out.append(f"{name}_sum{_fmt_labels(labels)} "
                       f"{float(value.get('sum') or 0.0)}")
            out.append(f"{name}_count{_fmt_labels(labels)} {count}")
        except (TypeError, ValueError):
            return []
        return out
    try:
        return [f"{name}{_fmt_labels(labels)} {float(value)}"]
    except (TypeError, ValueError):
        return []


def stitch_timelines(gateway_record: dict[str, Any],
                     segments: dict[str, dict[str, Any]]) -> dict[str, Any]:
    """Merge the gateway-side flight record with per-host worker segments
    into ONE timeline under one request id. Every event keeps its host of
    origin (``origin``: "gateway" or the worker host name); global order is
    by wall-clock ``ts`` — both sides stamp ``time.time()`` precisely so
    cross-process merge sorts (flight_recorder docstring contract). A
    cross-host failover thus reads as one story: gateway enqueue, host A's
    tokens, the failover marker, host B's continuation. Pure + defensive:
    worker segments are remote input, malformed events are dropped."""
    out = dict(gateway_record)
    merged: list[dict[str, Any]] = []
    for ev in gateway_record.get("timeline") or ():
        if isinstance(ev, dict):
            merged.append({**ev, "origin": "gateway"})
    seg_meta: dict[str, dict[str, Any]] = {}
    for host in sorted(str(h) for h in segments):
        seg = segments[host]
        if not isinstance(seg, dict):
            continue
        n = 0
        for ev in seg.get("timeline") or ():
            if isinstance(ev, dict):
                merged.append({**ev, "origin": host})
                n += 1
        seg_meta[host] = {"events": n, "state": seg.get("state"),
                          "trace_id": seg.get("trace_id")}

    def _ts(ev: dict[str, Any]) -> float:
        try:
            return float(ev.get("ts") or 0.0)
        except (TypeError, ValueError):
            return 0.0

    merged.sort(key=_ts)
    out["timeline"] = merged
    out["stitched"] = True
    out["origins"] = ["gateway"] + sorted(seg_meta)
    out["segments"] = seg_meta
    return out


class FleetView:
    """Gateway-side fold of the observability payloads workers piggyback on
    their heartbeat census.

    Reads ``census["observability"]`` — metrics snapshot + compact doctor
    report + flight-recorder terminal count — straight off the
    :class:`WorkerRegistry`, so aggregation costs zero extra wire traffic.
    Staleness is LEASE semantics, not a second clock: a report older than
    the registry's ``lease_ttl_s`` is marked stale and stops feeding fleet
    state (it may still render, flagged), and a host that leaves the
    registry takes its rows with it (:meth:`FleetDoctor.retain`). Every
    read path is never-raises: worker payloads are remote input."""

    def __init__(self, registry: Any, host_metrics: bool = True) -> None:
        from ..modkit.doctor import FleetDoctor

        #: WorkerRegistry or a zero-arg resolver (same deferred-init dance
        #: as the pool: gateway module may build this before grpc_hub runs)
        self._registry_ref = registry
        self.doctor = FleetDoctor()
        #: ``federation.observability.host_metrics: false`` keeps worker
        #: series off the gateway scrape (fleet/health folds unaffected)
        self.host_metrics = bool(host_metrics)

    def registry(self) -> Any:
        reg = self._registry_ref
        if callable(reg) and not hasattr(reg, "alive"):
            reg = reg()
            if reg is not None:
                self._registry_ref = reg
        return reg

    # ------------------------------------------------------------- refresh
    def hosts(self) -> list[dict[str, Any]]:
        """Refresh the fold from the live census and return per-host rows
        (doctor fields + registry lease/load fields)."""
        reg = self.registry()
        if reg is None or not hasattr(reg, "alive"):
            return []
        now = time.time()
        ttl = float(getattr(reg, "lease_ttl_s", 0.0) or 0.0)
        rows: list[dict[str, Any]] = []
        seen: list[str] = []
        for w in reg.alive():
            lease_age = now - w.last_heartbeat
            stale = bool(ttl) and lease_age > ttl
            census = w.census if isinstance(w.census, dict) else {}
            row = self.doctor.on_report(w.host, census.get("observability"),
                                        stale=stale)
            try:
                load = int(census.get("load") or 0)
            except (TypeError, ValueError):
                load = 0
            row.update({"instance_id": w.instance_id, "endpoint": w.endpoint,
                        "lease_age_s": round(lease_age, 3), "load": load,
                        "heartbeats": w.heartbeats})
            seen.append(w.host)
            rows.append(row)
        # rows of departed hosts decay WITH the lease, never pinning state
        self.doctor.retain(seen)
        return rows

    def host_states(self) -> dict[str, str]:
        """instance_id → doctor state, fresh known-state rows only — the
        router's health-rung feed. Never raises."""
        try:
            return {row["instance_id"]: row["state"] for row in self.hosts()
                    if not row.get("stale") and row.get("state") != "unknown"}
        except Exception:  # noqa: BLE001 — health data must not break routing
            return {}

    def report(self) -> dict[str, Any]:
        """The ``GET /v1/monitoring/fleet`` document."""
        rows = self.hosts()
        doc = self.doctor.merge(rows)
        reg = self.registry()
        return {
            "federation": True,
            "state": doc["state"],
            "reasons": doc["reasons"],
            "hosts": doc["hosts"],
            "objectives": doc["objectives"],
            "workers": len(rows),
            "stale": sum(1 for r in rows if r.get("stale")),
            "lease_ttl_s": float(getattr(reg, "lease_ttl_s", 0.0) or 0.0),
        }

    def readiness_reasons(self) -> list[str]:
        """Host-level reason strings for the gateway's /readyz (feeds
        ``Doctor.set_fleet_provider``). Never raises, never blocks."""
        try:
            return list(self.doctor.merge(self.hosts())["reasons"])
        except Exception:  # noqa: BLE001 — the readiness probe must not 500
            return []

    # ------------------------------------------------------------- metrics
    def metric_snapshots(self) -> dict[str, dict[str, Any]]:
        """host → metrics snapshot, FRESH heartbeat payloads only."""
        if not self.host_metrics:
            return {}
        reg = self.registry()
        if reg is None or not hasattr(reg, "alive"):
            return {}
        now = time.time()
        ttl = float(getattr(reg, "lease_ttl_s", 0.0) or 0.0)
        out: dict[str, dict[str, Any]] = {}
        for w in reg.alive():
            if ttl and now - w.last_heartbeat > ttl:
                continue
            census = w.census if isinstance(w.census, dict) else {}
            obs = census.get("observability")
            snap = obs.get("metrics") if isinstance(obs, dict) else None
            if isinstance(snap, dict):
                out[str(w.host)] = snap
        return out

    @staticmethod
    def merge_metric_samples(
            host_snaps: dict[str, dict[str, Any]]) -> dict[str, dict]:
        """Merge per-host snapshots into one host-labeled family table
        (``{name: {type, help, samples}}``). Conservation by construction:
        every worker sample appears exactly once with its ``host`` label —
        nothing is summed away, so per-host totals survive aggregation.
        Hostile shapes are dropped per sample, never raised."""
        merged: dict[str, dict] = {}
        for host in sorted(str(h) for h in host_snaps):
            snap = host_snaps[host]
            if not isinstance(snap, dict):
                continue
            for name in sorted(str(n) for n in snap):
                fam = snap[name]
                if not isinstance(fam, dict):
                    continue
                entry = merged.setdefault(name, {
                    "type": str(fam.get("type") or "gauge"),
                    "help": str(fam.get("help") or ""),
                    "samples": []})
                for pair in fam.get("samples") or ():
                    try:
                        labels, value = pair
                        labels = {str(k): str(v)
                                  for k, v in dict(labels).items()}
                        labels["host"] = host  # the fleet label wins
                        entry["samples"].append([labels, value])
                    except (TypeError, ValueError):
                        continue
        return merged

    def render_with(self, registry: Any) -> str:
        """The federated /metrics exposition: gateway families and worker
        families merged into ONE ``HELP``/``TYPE`` block per name (a valid
        exposition never repeats a family header) — gateway samples bare,
        worker samples host-labeled — plus the per-host
        ``llm_remote_workers_healthy{host=...}`` 0/1 rung next to the
        registry's existing unlabeled total."""
        gw = registry.snapshot() if registry is not None else {}
        fleet = self.merge_metric_samples(self.metric_snapshots())
        healthy_samples: list[list] = []
        try:
            for row in self.hosts():
                healthy_samples.append([{"host": row["host"]},
                                        0.0 if row.get("stale") else 1.0])
        except Exception:  # noqa: BLE001 — the scrape must not fail
            pass
        if healthy_samples:
            fam = fleet.setdefault("llm_remote_workers_healthy", {
                "type": "gauge",
                "help": "Remote federated workers holding a live lease",
                "samples": []})
            fam["samples"].extend(healthy_samples)
        lines: list[str] = []
        for name in sorted(set(gw) | set(fleet)):
            ref = gw.get(name) or fleet[name]
            lines.append(f"# HELP {name} {ref['help']}")
            lines.append(f"# TYPE {name} {ref['type']}")
            for fam in (gw.get(name), fleet.get(name)):
                if not fam:
                    continue
                for labels, value in fam["samples"]:
                    lines.extend(_render_sample(name, ref["type"],
                                                dict(labels), value))
        return "\n".join(lines) + "\n"


# ---------------------------------------------------------------- federation

@dataclass
class FederationConfig:
    """Router policy knobs (the gateway's ``federation:`` config block)."""

    #: a prefix-hint host may carry this many more in-flight requests than
    #: the least-loaded host and still win (the cache_affinity_slack
    #: analogue at host granularity)
    prefix_slack: int = 2
    #: mid-stream crash failovers per request before the error surfaces
    max_failovers: int = 2
    failover_backoff_s: float = 0.05
    #: text-block geometry — MUST match what workers hash into their gossip
    block_chars: int = 48
    max_blocks: int = 64
    #: seeded tie-break RNG (deterministic scenarios)
    seed: int = 0
    #: per-host budget for pulling a remote timeline segment when stitching
    #: (``federation.observability.stitch_timeout_s``) — a slow host costs
    #: this much latency, never a hang
    stitch_timeout_s: float = 2.0
    #: merge worker ``llm_*`` snapshots host-labeled into /metrics
    #: (``federation.observability.host_metrics``)
    host_metrics: bool = True


class FederatedServingPool:
    """LlmWorkerApi-shaped router over remote worker hosts.

    ``client_factory(worker_info)`` returns an LlmWorkerApi-speaking client
    for one host (the gateway injects ``GrpcLlmWorkerClient``); clients are
    cached per instance and dropped when the host departs.
    ``make_chunk(**fields)`` builds a stream chunk (the gateway injects
    ``ChatStreamChunk``) for synthesized terminals."""

    def __init__(self, registry: Any, client_factory: Callable[[WorkerInfo], Any],
                 make_chunk: Callable[..., Any],
                 config: Optional[FederationConfig] = None,
                 obs_client_factory: Optional[
                     Callable[[WorkerInfo], Any]] = None) -> None:
        #: WorkerRegistry or a zero-arg resolver for it (module init order:
        #: the gateway may init before grpc_hub has registered the registry)
        self._registry_ref = registry
        self._factory = client_factory
        self._make_chunk = make_chunk
        self.config = config or FederationConfig()
        self._clients: dict[str, Any] = {}
        #: observability-plane clients (timeline pull / remote failpoints) —
        #: cached separately so tearing one down never touches a live stream
        self._obs_factory = obs_client_factory
        self._obs_clients: dict[str, Any] = {}
        self._inflight: dict[str, int] = {}
        #: client closes in flight (the loop holds tasks weakly)
        self._closing: set[asyncio.Task] = set()
        self._lock = threading.Lock()
        self._rng = random.Random(self.config.seed)
        self.placements = {"prefix": 0, "health": 0, "load": 0, "random": 0}
        self.failovers = 0
        self.failovers_failed = 0
        self.requests = 0
        #: fleet observability fold over the same registry — the router's
        #: health rung and the monitoring module's fleet endpoint both read it
        self.fleet = FleetView(lambda: self._registry_ref
                               if not callable(self._registry_ref)
                               else self._registry_ref(),
                               host_metrics=self.config.host_metrics)

    # ------------------------------------------------------------- plumbing
    def registry(self) -> Any:
        reg = self._registry_ref
        if callable(reg) and not hasattr(reg, "alive"):
            reg = reg()
            if reg is not None:
                self._registry_ref = reg
        if reg is None:
            raise RuntimeError("federation: no WorkerRegistry (is the "
                               "grpc_hub module enabled?)")
        return reg

    def _client_for(self, w: WorkerInfo) -> Any:
        with self._lock:
            client = self._clients.get(w.instance_id)
            if client is None:
                client = self._factory(w)
                self._clients[w.instance_id] = client
        return client

    def _drop_client(self, instance_id: str) -> None:
        with self._lock:
            client = self._clients.pop(instance_id, None)
        if client is not None and hasattr(client, "close"):
            try:
                task = asyncio.get_running_loop().create_task(client.close())
                self._closing.add(task)
                task.add_done_callback(self._closed)
            except Exception:  # noqa: BLE001 — teardown must not fail routing
                pass

    def _closed(self, task: "asyncio.Task") -> None:
        """A dropped client's close ended: its failure is logged, not lost."""
        self._closing.discard(task)
        if not task.cancelled() and task.exception() is not None:
            logger.warning("closing a dropped worker client failed: %s", task.exception())

    def _bump_inflight(self, instance_id: str, d: int) -> None:
        with self._lock:
            self._inflight[instance_id] = \
                max(0, self._inflight.get(instance_id, 0) + d)

    # -------------------------------------------------------------- routing
    def _host_states(self) -> dict[str, str]:
        """instance_id → doctor state off the fleet view (sync, in-memory
        census reads only; {} when the view is broken — health
        data degrades to no opinion, never to a routing failure)."""
        try:
            return self.fleet.host_states()
        except Exception:  # noqa: BLE001
            return {}

    def _select(self, workers: list[WorkerInfo], loads: dict[str, int],
                chain: list[str], model_key: str) -> tuple[WorkerInfo, str]:
        """The prefix > load > random rungs over one candidate set."""
        by_id = {w.instance_id: w for w in workers}
        best = min(loads, key=lambda k: (loads[k], k))
        reason = "load"
        pick = best
        if chain:
            hint, hint_depth = None, 0
            for w in workers:
                chains = (w.census.get("prefix") or {}).get(model_key) or ()
                d = match_depth(chain, chains)
                if d > hint_depth:
                    hint, hint_depth = w.instance_id, d
            if hint is not None and \
                    loads[hint] - loads[best] <= self.config.prefix_slack:
                pick, reason = hint, "prefix"
        if reason != "prefix" and len(workers) > 1 and \
                len(set(loads.values())) == 1:
            # every host equally idle and no cache hint: spread, seeded
            pick = self._rng.choice(sorted(loads))
            reason = "random"
        return by_id[pick], reason

    def route(self, model_key: str, chain: list[str],
              exclude: tuple[str, ...] = ()) -> tuple[WorkerInfo, str]:
        """Pick the serving host: **prefix > health > load > random** (sync,
        non-blocking, never-raises emits only). The health rung sits
        between prefix-affinity and least-loaded: hosts the fleet doctor
        marks degraded/shedding are filtered out before the load/prefix
        rungs see them — a prefix hint on a sick host loses, and the
        placement reason becomes ``health``. When the only survivors are
        degraded they stay routable (degraded capacity beats none); when
        EVERY routable host is shedding, raise :class:`HostShedError` so
        the caller sheds host-scoped (429 + Retry-After) instead of placing
        doomed work. Raises RuntimeError when no live host serves the
        model at all."""
        failpoint("federation.route")
        workers = [w for w in self.registry().alive(model=model_key)
                   if w.instance_id not in exclude]
        if not workers:
            raise RuntimeError(
                f"federation: no live worker host for {model_key!r}")
        states = self._host_states()
        shed = {w.instance_id for w in workers
                if states.get(w.instance_id) == "shedding"}
        sick = {w.instance_id for w in workers
                if states.get(w.instance_id) in ("degraded", "shedding")}
        candidates = [w for w in workers if w.instance_id not in sick] \
            or [w for w in workers if w.instance_id not in shed]
        if not candidates:
            raise HostShedError(
                f"federation: every live worker host for {model_key!r} "
                f"is shedding ({len(workers)} host(s))")
        with self._lock:
            local = dict(self._inflight)

        def _loads(ws: list[WorkerInfo]) -> dict[str, int]:
            return {w.instance_id: int(w.census.get("load") or 0)
                    + local.get(w.instance_id, 0) for w in ws}

        picked, reason = self._select(candidates, _loads(candidates),
                                      chain, model_key)
        if len(candidates) < len(workers):
            # the health rung actually bit: attribute the placement to it
            # when the host the prefix/load rungs would have chosen over
            # the FULL set is sick and differs from the real pick
            virtual, _ = self._select(workers, _loads(workers), chain,
                                      model_key)
            if virtual.instance_id in sick and \
                    virtual.instance_id != picked.instance_id:
                reason = "health"
        self.placements[reason] += 1
        bump_counter("llm_federated_placements_total", reason=reason)
        return picked, reason

    # ---------------------------------------------------------- LlmWorkerApi
    async def chat_stream(self, model: Any, messages: list[dict],
                          params: dict):
        async for chunk in self._stream("chat", model, messages, None,
                                        params):
            yield chunk

    async def completion_stream(self, model: Any, prompt: str, params: dict):
        async for chunk in self._stream("completion", model, None, prompt,
                                        params):
            yield chunk

    async def _stream(self, mode: str, model: Any,
                      messages: Optional[list[dict]], prompt: Optional[str],
                      params: dict):
        """One federated stream: route → proxy → (on host crash) fail over
        with the emitted tokens as a continuation. Exactly one terminal
        reaches the consumer."""
        from ..modkit.errors import ProblemError

        cfg = self.config
        model_key = getattr(model, "canonical_id", str(model))
        params = dict(params or {})
        rid = params.get("_request_id") or f"fed-{self._rng.getrandbits(48):012x}"
        params["_request_id"] = rid
        #: workers emit one chunk per token (token_id on each) so the carry
        #: ledger below is exact; empty-text token chunks are swallowed here
        params["_fed_token_stream"] = True
        chain = digest_chain(prompt_text(messages, prompt),
                             cfg.block_chars, cfg.max_blocks)
        max_total = int(params.get("max_tokens", 256))
        deadline_ms = params.get("_deadline_ms")
        t0 = time.monotonic()
        carried: list[int] = []      # token ids already delivered downstream
        sent_text = ""
        tried: list[str] = []
        failovers_left = cfg.max_failovers
        self.requests += 1
        # surface the HTTP span's trace id on the gateway-side record: the
        # worker processes join the same trace via the traceparent gRPC
        # metadata, so ONE id covers both hosts' tokens
        tp_parts = str(params.get("_traceparent") or "").split("-")
        record_event(rid, "enqueued", tenant=params.get("_tenant_id"),
                     federated=True,
                     trace_id=tp_parts[1] if len(tp_parts) >= 3 else None)
        while True:
            try:
                w, reason = self.route(model_key, chain, exclude=tuple(tried))
            except HostShedError as e:
                # every host is shedding: host-scoped load shed — 429 +
                # Retry-After, the fleet analogue of the local admission
                # gate, NOT the 503 capacity hole of an empty fleet
                record_event(rid, "error", error=f"fleet_shed: {e}")
                from ..modkit.errcat import ERR

                raise ERR.llm.load_shed.error(
                    str(e), retry_after_s=e.retry_after_s)
            except RuntimeError as e:
                # no live host (or an armed federation.route failpoint):
                # a transient capacity hole, not a server bug — 503 +
                # Retry-After, same mapping as the in-process pool's
                # "no healthy replicas"
                record_event(rid, "error", error=f"no_worker_host: {e}")
                from ..modkit.errcat import ERR

                raise ERR.llm.replica_unavailable.error(
                    str(e), retry_after_s=1.0)
            annotate_request(rid, model=model_key, worker_host=w.host)
            record_event(rid, "admitted", worker_host=w.host,
                         placement=reason, endpoint=w.endpoint)
            client = self._client_for(w)
            call_params = dict(params)
            if carried:
                call_params["_resume_token_ids"] = list(carried)
                call_params["_resume_sent_text"] = sent_text
                call_params["max_tokens"] = max_total - len(carried)
            if deadline_ms:
                left = float(deadline_ms) - (time.monotonic() - t0) * 1000.0
                if left <= 0.0:
                    record_event(rid, "deadline_exceeded",
                                 worker_host=w.host)
                    yield self._make_chunk(
                        request_id=rid, finish_reason="deadline_exceeded",
                        usage={"input_tokens": 0,
                               "output_tokens": len(carried)})
                    return
                call_params["_deadline_ms"] = left
            self._bump_inflight(w.instance_id, +1)
            saw_terminal = False
            t_attempt = time.monotonic()
            try:
                if mode == "completion":
                    agen = client.completion_stream(model, prompt,
                                                    call_params)
                else:
                    agen = client.chat_stream(model, messages, call_params)
                try:
                    async for chunk in agen:
                        if chunk.token_id is not None:
                            carried.append(int(chunk.token_id))
                            record_event(rid, "decode_chunk", tokens=1,
                                         worker_host=w.host)
                        if chunk.text:
                            sent_text += chunk.text
                        if chunk.finish_reason:
                            saw_terminal = True
                            if tried and chunk.usage and carried:
                                # honest accounting across the failover: the
                                # carried tokens were GENERATED work the
                                # survivor re-prefilled as "prompt" — move
                                # them back to the output column
                                n_prev = len(carried) - int(
                                    chunk.usage.get("output_tokens", 0))
                                if n_prev > 0:
                                    chunk.usage = {
                                        "input_tokens": max(
                                            0, int(chunk.usage.get(
                                                "input_tokens", 0)) - n_prev),
                                        "output_tokens": int(chunk.usage.get(
                                            "output_tokens", 0)) + n_prev,
                                    }
                            record_event(rid, "finished" if chunk.finish_reason
                                         not in ("error",) else "error",
                                         worker_host=w.host,
                                         finish_reason=chunk.finish_reason)
                        if chunk.text or chunk.finish_reason \
                                or chunk.usage is not None:
                            yield chunk
                    if saw_terminal:
                        return
                    # stream closed with no terminal: the host died between
                    # chunks without an exception — treat as a crash
                    raise ConnectionError(
                        f"worker {w.host} stream ended without a terminal")
                finally:
                    aclose = getattr(agen, "aclose", None)
                    if aclose is not None:
                        await aclose()
            except (asyncio.CancelledError, GeneratorExit):
                raise
            except ProblemError:
                # a typed remote problem (422/429/404…) is the WORKER
                # answering, not the worker dying — no failover, no evict
                record_event(rid, "error", worker_host=w.host,
                             error="remote_problem")
                raise
            except Exception as e:  # noqa: BLE001 — transport/host failure
                reg = self.registry()
                reg.report_failure(w.instance_id, reason="crash")
                self._drop_client(w.instance_id)
                tried.append(w.instance_id)
                if failovers_left <= 0:
                    self.failovers_failed += 1
                    record_event(rid, "error", worker_host=w.host,
                                 error=f"failover_exhausted: {e}")
                    raise
                failovers_left -= 1
                self.failovers += 1
                bump_counter("llm_federated_failovers_total")
                record_event(rid, "failover", from_host=w.host,
                             carried_tokens=len(carried),
                             retries_left=failovers_left)
                if len(carried) >= max_total:
                    # the budget was already served — synthesize the length
                    # terminal instead of re-prefilling for zero tokens
                    record_event(rid, "finished", worker_host=w.host,
                                 synthesized_terminal=True)
                    yield self._make_chunk(
                        request_id=rid, finish_reason="length",
                        usage={"input_tokens": 0,
                               "output_tokens": len(carried)})
                    return
                record_recovery("federation.failover",
                                time.monotonic() - t_attempt)
                await asyncio.sleep(
                    cfg.failover_backoff_s * (0.5 + self._rng.random()))
            finally:
                self._bump_inflight(w.instance_id, -1)

    async def embed(self, model: Any, inputs: list[str],
                    params: dict) -> tuple[list[list[float]], int]:
        model_key = getattr(model, "canonical_id", str(model))
        w, _reason = self.route(model_key, [])
        return await self._client_for(w).embed(model, inputs, params)

    async def health(self) -> dict[str, Any]:
        reg = self.registry()
        rows = reg.rows()
        return {
            "status": "ok" if rows["workers"] else "degraded",
            "federated": True,
            "workers": [{k: r[k] for k in
                         ("instance_id", "host", "endpoint", "load",
                          "lease_age_s")} for r in rows["workers"]],
            "requests_served": self.requests,
        }

    # --------------------------------------------- doctor/monitoring surface
    def schedulers(self) -> list[tuple[str, Any]]:
        return []  # schedulers live in the worker processes

    def replicas_view(self) -> list[dict[str, Any]]:
        """Host-level rows for /v1/monitoring/replicas: in a federated
        stack a "replica" is a worker host."""
        rows = []
        for r in self.registry().rows()["workers"]:
            rows.append({
                "index": len(rows), "model": ",".join(r["models"]) or "*",
                "replica": r["host"], "pool": True, "controllable": False,
                "state": "healthy", "federated": True,
                "engine": {"active": r["load"],
                           "requests_served": r["requests_served"]},
            })
        return rows

    def replica_capacity(self) -> dict[str, Any]:
        """Host census for the doctor: every evicted host is LOST capacity
        (counted under ``quarantined``), so shedding hysteresis scales with
        surviving hosts exactly like the in-process pool's replica feed."""
        reg = self.registry()
        rows = reg.rows()
        alive = len(rows["workers"])
        lost = len(rows["evicted"])
        counts = {"replicas": alive + lost, "serving": alive,
                  "healthy": alive, "probation": 0, "draining": 0,
                  "drained": 0, "quarantined": lost, "rebuilding": 0,
                  "benched": 0, "federated_hosts": alive}
        return counts

    def tenant_usage(self) -> dict[str, dict[str, Any]]:
        """Merge the per-tenant census every worker gossips on heartbeat —
        the gateway's budget hook sees one cross-host truth."""
        out: dict[str, dict[str, Any]] = {}
        for r in self.registry().rows()["workers"]:
            for tenant, row in (r.get("capacity") or {}).get(
                    "tenants", {}).items():
                agg = out.setdefault(tenant, {
                    "tenant": tenant, "charged_tokens": 0,
                    "active_slots": 0, "pages": 0, "pending": 0})
                for k in ("charged_tokens", "active_slots", "pages",
                          "pending"):
                    agg[k] += int(row.get(k, 0))
        return out

    def stats(self) -> dict[str, Any]:
        reg = self.registry()
        with self._lock:
            placements = dict(self.placements)
        return {
            "federated": True,
            "hosts": reg.healthy(),
            "requests": self.requests,
            "failovers": self.failovers,
            "failovers_failed": self.failovers_failed,
            "placements": placements,
            "prefix_index_size": reg.index_size(),
        }

    # ------------------------------------------------- observability plane
    def _worker_by_host(self, host: str) -> WorkerInfo:
        """Resolve a host name OR instance id to its live WorkerInfo.
        Raises KeyError (→ the monitoring layer's 404 problem) on a miss."""
        for w in self.registry().alive():
            if host in (w.host, w.instance_id):
                return w
        raise KeyError(host)

    def _obs_client_for(self, w: WorkerInfo) -> Any:
        if self._obs_factory is None:
            raise KeyError(w.host)
        with self._lock:
            client = self._obs_clients.get(w.instance_id)
            if client is None:
                client = self._obs_factory(w)
                self._obs_clients[w.instance_id] = client
        return client

    async def fetch_remote_timeline(self, host: str,
                                    request_id: str) -> Optional[dict]:
        """Pull one request's flight record off a worker host over the
        observability service. Never raises — a dead/slow host degrades the
        stitched timeline to the gateway-side half, not to a 500."""
        try:
            w = self._worker_by_host(host)
            resp = await asyncio.wait_for(
                self._obs_client_for(w).timeline(request_id),
                timeout=max(0.05, self.config.stitch_timeout_s))
        except Exception:  # noqa: BLE001 — remote segment is best-effort
            return None
        if isinstance(resp, dict) and resp.get("found"):
            rec = resp.get("record")
            return rec if isinstance(rec, dict) else None
        return None

    async def remote_failpoint(self, host: str, action: str, name: str,
                               spec: str = "raise",
                               seed: Optional[int] = None) -> dict[str, Any]:
        """Arm/disarm a failpoint ON a worker host (faultlab's cross-host
        arm path). KeyError on unknown host propagates to the 404 problem;
        worker-side refusals come back as ``{"ok": False, "error": ...}``."""
        w = self._worker_by_host(host)
        client = self._obs_client_for(w)
        if action == "disarm":
            resp = await client.disarm_failpoint(name)
        else:
            resp = await client.arm_failpoint(name, spec, seed=seed)
        return resp if isinstance(resp, dict) else {"ok": False,
                                                    "error": "bad response"}

    async def close(self) -> None:
        with self._lock:
            clients = list(self._clients.values()) \
                + list(self._obs_clients.values())
            self._clients.clear()
            self._obs_clients.clear()
        for c in clients:
            if hasattr(c, "close"):
                try:
                    await c.close()
                except Exception:  # noqa: BLE001 — teardown best-effort
                    pass
