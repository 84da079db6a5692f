"""Per-request flight recorder — bounded ring of request lifecycle timelines
(the port's copy of ``modkit/flight_recorder.py``).

The serving path (gateway → llm_gateway worker → replicas pool → continuous
scheduler) emits one event per lifecycle transition, keyed by ``request_id``:

    enqueued → admitted → prefill → decode_chunk* → (preempted → resumed)*
             → (failover)* → finished | error

Each event is ``(unix_ts, kind, attrs)``. From the timeline the recorder
derives the figures aggregate ``stats()`` p50s cannot answer per request:
ttft_ms, queue_wait_ms, itl_ms (mean inter-chunk gap / chunk size),
recovery_ms (preempt→resume pauses), e2e_ms. RTP-LLM treats exactly this
per-request phase timeline as a first-class serving primitive; APEX makes the
same point for host/device overlap — aggregates can't localize a stall.

Design constraints (mirrors modkit/failpoints.py):

- **Hot-loop cheap.** The decode loop emits one ``decode_chunk`` event per
  active slot per *chunk* (k fused tokens), never per token; ``record_event``
  is the bump_counter-style never-raises helper (every runtime/ call site
  uses it) and one lock acquire per event.
- **Bounded.** Live table capped at ``max_live`` (oldest live record is
  force-finished as ``evicted`` — a leak in the emitting layer must not
  become unbounded host memory); finished ring capped at ``max_finished``;
  per-record event list capped at ``max_events`` (the middle of a very long
  decode is dropped, first/last events always survive).
- **Prometheus-fed.** Terminal events observe the ``llm_ttft_seconds``,
  ``llm_itl_seconds`` and ``llm_queue_wait_seconds`` histograms, so the
  dashboards derive from the same timeline the REST surface shows
  (no ad-hoc sampling drift).

REST surface (monitoring module): ``GET /v1/monitoring/requests`` (live
in-flight table), ``GET /v1/monitoring/requests/{id}`` (full timeline, incl.
recently finished).
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, Optional

__all__ = ["FlightRecorder", "RequestRecord", "annotate_request",
           "default_recorder", "record_event"]

#: event kinds → the phase a request is in after the event
_PHASE_AFTER = {
    "enqueued": "queued",
    "admitted": "prefill",
    #: one per piggybacked mixed-batch prompt chunk (mirrors decode_chunk):
    #: the live table shows interleaved prefill progress, phase stays prefill
    "prefill_chunk": "prefill",
    "prefill": "decode",
    "first_token": "decode",
    "decode_chunk": "decode",
    "preempted": "preempted",
    "resumed": "decode",
    "failover": "failover",
    "finished": "finished",
    "error": "error",
    "evicted": "evicted",
    #: end-to-end cancellation terminals: a client vanished (or an operator
    #: cancelled) vs a request deadline lapsing — kept distinct from
    #: ``error`` so dashboards and the doctor's error-rate burn never read
    #: a disconnect storm as a server fault
    "cancelled": "cancelled",
    "deadline_exceeded": "deadline_exceeded",
    #: a watchdog marked the stream stalled (doctor); the next progress
    #: event (decode_chunk/resumed/…) clears the phase back
    "stalled": "stalled",
    #: replica lifecycle episodes (runtime/lifecycle.py) ride the recorder
    #: under per-episode ids (``pool1/replica0/drain-2``): a drain shows as
    #: a live "draining" row until its drain_end closes it, and a rebuild is
    #: a single-shot closed record — the surface that explains a request
    #: explains a replica too
    "drain_begin": "draining",
    "drain_end": "drained",
    "replica_rebuilt": "rebuilt",
}

#: events that prove the stream is moving again — they clear a watchdog's
#: ``stalled`` mark (and phase) so the live table reflects recovery
_PROGRESS = frozenset({"admitted", "prefill", "prefill_chunk", "first_token",
                       "decode_chunk", "resumed", "finished"})

#: drain_end / replica_rebuilt close their episode records like request
#: terminals do (only ``finished`` feeds the latency histograms, and the
#: doctor's listener ignores kinds it does not ingest). ``cancelled`` /
#: ``deadline_exceeded`` are request terminals too — they close the record
#: but stay out of the latency histograms (a half-served stream would skew
#: the percentiles exactly when cancel storms make dashboards matter).
_TERMINAL = frozenset({"finished", "error", "evicted",
                       "drain_end", "replica_rebuilt",
                       "cancelled", "deadline_exceeded"})


class RequestRecord:
    """One request's timeline. Mutated only under the recorder's lock."""

    __slots__ = ("request_id", "trace_id", "created_at", "phase", "slot",
                 "tokens", "prompt_tokens", "events", "_dropped",
                 "finished_at", "model", "tenant", "stalled",
                 "last_event_at", "worker_host")

    def __init__(self, request_id: str) -> None:
        self.request_id = request_id
        self.trace_id: Optional[str] = None
        self.created_at = time.time()
        self.phase = "queued"
        self.slot: Optional[int] = None
        self.tokens = 0
        self.prompt_tokens = 0
        self.events: list[tuple[float, str, dict]] = []
        self._dropped = 0  # mid-timeline events dropped by the per-record cap
        self.finished_at: Optional[float] = None
        self.model: Optional[str] = None  # set by annotate() at the worker
        #: owning tenant: stamped by the scheduler's ``enqueued`` event (or
        #: annotate()) — per-tenant dashboards and the doctor's selective-
        #: shedding attribution read this column
        self.tenant: Optional[str] = None
        self.stalled = False  # a stall watchdog flagged this stream
        self.last_event_at = self.created_at
        #: federated serving: which worker HOST served (or is serving) this
        #: request — stamped by the FederatedServingPool's placement, and
        #: re-stamped on failover so the column always names the live host
        self.worker_host: Optional[str] = None

    # ------------------------------------------------------------- derived
    def _first(self, kind: str) -> Optional[float]:
        for ts, k, _ in self.events:
            if k == kind:
                return ts
        return None

    def derived(self) -> dict[str, Any]:
        """ttft/queue-wait/itl/recovery/e2e in ms, None where not reached."""
        enq = self._first("enqueued") or self.created_at
        adm = self._first("admitted")
        # the first token is emitted at the end of prefill (the prefill
        # program samples it) — ttft anchors there
        first_tok = self._first("prefill") or self._first("first_token")
        out: dict[str, Any] = {
            "queue_wait_ms": _ms(enq, adm),
            "ttft_ms": _ms(enq, first_tok),
            "e2e_ms": _ms(enq, self.finished_at),
        }
        # mean inter-token latency from decode_chunk events: each event
        # carries the chunk's token count; gaps between consecutive chunk
        # timestamps average out to per-token latency
        chunk_ts = [(ts, ev.get("tokens", 1)) for ts, k, ev in self.events
                    if k == "decode_chunk"]
        if len(chunk_ts) >= 2:
            span = chunk_ts[-1][0] - chunk_ts[0][0]
            toks = sum(n for _, n in chunk_ts[1:])
            out["itl_ms"] = round(span / max(1, toks) * 1000.0, 3)
        else:
            out["itl_ms"] = None
        pauses = [ev.get("pause_ms") for ts, k, ev in self.events
                  if k == "resumed" and ev.get("pause_ms") is not None]
        out["recovery_ms"] = round(sum(pauses), 3) if pauses else None
        return out

    def summary(self) -> dict[str, Any]:
        """One row of the live in-flight table."""
        now = time.time()
        return {
            "request_id": self.request_id,
            "trace_id": self.trace_id,
            "model": self.model,
            "tenant": self.tenant,
            "worker_host": self.worker_host,
            "phase": self.phase,
            "slot": self.slot,
            "age_s": round(now - self.created_at, 3),
            "last_event_age_s": round(now - self.last_event_at, 3),
            "stalled": self.stalled,
            "tokens": self.tokens,
            "prompt_tokens": self.prompt_tokens,
            "events": len(self.events) + self._dropped,
        }

    def timeline(self) -> dict[str, Any]:
        """The full record: every retained event + derived figures."""
        return {
            **self.summary(),
            "dropped_events": self._dropped,
            "derived": self.derived(),
            "timeline": [
                {"ts": round(ts, 6), "event": kind, **attrs}
                for ts, kind, attrs in self.events
            ],
        }


def _ms(a: Optional[float], b: Optional[float]) -> Optional[float]:
    if a is None or b is None:
        return None
    return round((b - a) * 1000.0, 3)


class FlightRecorder:
    """Bounded live table + finished ring of :class:`RequestRecord`."""

    def __init__(self, max_live: int = 4096, max_finished: int = 256,
                 max_events: int = 512) -> None:
        self.max_live = max_live
        self.max_finished = max_finished
        self.max_events = max_events
        self._lock = threading.Lock()
        #: insertion-ordered so eviction drops the oldest live record
        self._live: "OrderedDict[str, RequestRecord]" = OrderedDict()
        self._finished: "OrderedDict[str, RequestRecord]" = OrderedDict()
        self.evicted_live = 0  # live records force-closed by the bound
        #: terminal-event subscribers (the doctor's SLO sample feed) —
        #: called OUTSIDE the lock, each wrapped never-raises
        self._listeners: list = []

    # -------------------------------------------------------------- record
    def record(self, request_id: str, kind: str, **attrs: Any) -> None:
        """Append one event; creates the record on first sight (so a layer
        that never saw ``enqueued`` — e.g. a failover wrapper — still lands
        its events somewhere visible)."""
        now = time.time()
        with self._lock:
            rec = self._live.get(request_id)
            if rec is None and kind == "stalled":
                # A watchdog annotation racing a terminal: the stream
                # finished between the doctor's inflight() snapshot and this
                # emit. Creating a record here would leave a phase='stalled'
                # ghost nothing ever closes — which reads as a permanent
                # stall and pins the state machine degraded. Stalled marks
                # go on LIVE records only.
                return
            if rec is None:
                closed = self._finished.get(request_id)
                if closed is not None and kind in _TERMINAL:
                    return  # duplicate terminal for a closed record
                if closed is not None and kind == "failover":
                    # REOPEN — only for the failover continuation: the
                    # replica pool resubmits under the original request_id,
                    # so the timeline reads error → failover → enqueued → …
                    # as ONE story. Any other post-terminal event (e.g. a
                    # client retry reusing a finished X-Request-Id) starts a
                    # FRESH record — merging two requests would corrupt the
                    # derived figures.
                    self._finished.pop(request_id)
                    closed.finished_at = None
                    rec = closed
                    self._live[request_id] = rec
                else:
                    rec = RequestRecord(request_id)
                    rec.created_at = now
                    self._live[request_id] = rec
                while len(self._live) > self.max_live:
                    _, old = self._live.popitem(last=False)
                    self._close(old, now, "evicted", {})
                    self.evicted_live += 1
            self._append(rec, now, kind, attrs)
            # denormalized columns the live table sorts/filters on
            rec.phase = _PHASE_AFTER.get(kind, rec.phase)
            rec.last_event_at = now
            if kind == "stalled":
                rec.stalled = True
            elif kind in _PROGRESS:
                rec.stalled = False  # the stream moved again
            if "slot" in attrs:
                rec.slot = attrs["slot"]
            if "trace_id" in attrs and attrs["trace_id"]:
                rec.trace_id = attrs["trace_id"]
            if "prompt_tokens" in attrs:
                rec.prompt_tokens = int(attrs["prompt_tokens"])
            if attrs.get("tenant"):
                rec.tenant = attrs["tenant"]
            if attrs.get("worker_host"):
                rec.worker_host = attrs["worker_host"]
            if kind in ("prefill", "first_token"):
                rec.tokens += 1
            elif kind == "decode_chunk":
                rec.tokens += int(attrs.get("tokens", 1))
            payload = None
            if kind in _TERMINAL:
                self._live.pop(request_id, None)
                self._close(rec, now, None, None)
                # snapshot the derived figures UNDER the lock: a failover
                # reopen on another thread may start appending to this very
                # record's events list the moment we release it
                derived = rec.derived()
                if self._listeners:
                    payload = {
                        "request_id": rec.request_id, "kind": kind,
                        "model": rec.model, "tenant": rec.tenant,
                        "tokens": rec.tokens,
                        "prompt_tokens": rec.prompt_tokens,
                        "derived": derived,
                    }
        # only CLEAN completions feed the latency histograms: an 'error'
        # terminal may be followed by a failover reopen (same derived values
        # would be observed twice), and failed/evicted requests would skew
        # the percentiles exactly when dashboards matter most
        if kind == "finished":
            self._observe_histograms(derived)
        if payload is not None:
            # listener CALLS stay outside the lock — observers must not be
            # able to deadlock or slow the serving path's next record()
            for listener in list(self._listeners):
                try:
                    listener(payload)
                except Exception:  # noqa: BLE001 — observers never fail serving
                    pass

    def _append(self, rec: RequestRecord, now: float, kind: str,
                attrs: dict) -> None:
        if len(rec.events) >= self.max_events:
            # drop from the MIDDLE: the enqueue/admit/prefill head and the
            # most recent tail both matter more than chunk #250
            del rec.events[self.max_events // 2]
            rec._dropped += 1
        rec.events.append((now, kind, attrs))

    def _close(self, rec: RequestRecord, now: float,
               extra_kind: Optional[str], extra_attrs: Optional[dict]) -> None:
        """Under lock: move a record to the finished ring."""
        if extra_kind is not None:
            self._append(rec, now, extra_kind, extra_attrs or {})
            rec.phase = _PHASE_AFTER.get(extra_kind, rec.phase)
        rec.finished_at = now
        self._finished[rec.request_id] = rec
        while len(self._finished) > self.max_finished:
            self._finished.popitem(last=False)

    def _observe_histograms(self, d: dict) -> None:
        """Terminal event → feed the Prometheus latency histograms from the
        derived figures (snapshotted under the record lock). TTFT is observed
        by the llm_gateway at first chunk (labeled by model, derived from
        THIS record's timeline when managed) — observing it here too would
        double-count the series."""
        try:
            from .metrics import default_registry

            if d["queue_wait_ms"] is not None:
                default_registry.histogram(
                    "llm_queue_wait_seconds",
                    "Pending-queue wait before admission"
                ).observe(d["queue_wait_ms"] / 1000.0)
            if d["itl_ms"] is not None:
                default_registry.histogram(
                    "llm_itl_seconds", "Mean inter-token latency per request",
                    buckets=(0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                             0.25, 0.5, 1.0),
                ).observe(d["itl_ms"] / 1000.0)
        except Exception:  # noqa: BLE001 — telemetry must never fail serving
            pass

    # ----------------------------------------------------------- observers
    def add_listener(self, fn) -> None:
        """Subscribe to terminal events: ``fn(payload)`` with request_id,
        kind, model, tokens, and the derived figures. Idempotent."""
        if fn not in self._listeners:
            self._listeners.append(fn)

    def remove_listener(self, fn) -> None:
        try:
            self._listeners.remove(fn)
        except ValueError:
            pass

    def annotate(self, request_id: str, model: Optional[str] = None,
                 tenant: Optional[str] = None,
                 worker_host: Optional[str] = None) -> None:
        """Set denormalized columns on an EXISTING record (live or recently
        finished) without appending an event. The worker stamps the model
        (and, for external-provider paths, the tenant) here after submit —
        the scheduler, which emits the lifecycle events, does not know
        which model entry owns it. A miss is a no-op: annotation must never
        create a record the scheduler will not close."""
        with self._lock:
            rec = self._live.get(request_id) or self._finished.get(request_id)
            if rec is None:
                return
            if model is not None:
                rec.model = model
            if tenant is not None:
                rec.tenant = tenant
            if worker_host is not None:
                rec.worker_host = worker_host

    # --------------------------------------------------------------- reads
    def is_live(self, request_id: str) -> bool:
        """True while a record with this id is in flight — admission layers
        use it to de-collide client-supplied request ids."""
        with self._lock:
            return request_id in self._live

    def inflight(self, stalled_only: bool = False) -> list[dict[str, Any]]:
        """Live-table rows; ``stalled_only`` filters to streams a stall
        watchdog flagged (the ``?stalled=true`` triage view)."""
        with self._lock:
            recs = [rec for rec in self._live.values()
                    if not stalled_only or rec.stalled]
            return [rec.summary() for rec in recs]

    def lookup(self, request_id: str) -> Optional[dict[str, Any]]:
        with self._lock:
            rec = self._live.get(request_id) or self._finished.get(request_id)
            return rec.timeline() if rec is not None else None

    def recent(self, limit: int = 50) -> list[dict[str, Any]]:
        """Most recently finished records, newest first. ``limit<=0`` means
        none (the ``[-0:]`` slice would mean ALL — same zero semantics as the
        rounds export)."""
        if limit <= 0:
            return []
        with self._lock:
            recs = list(self._finished.values())[-limit:]
        return [rec.summary() for rec in reversed(recs)]

    def stats(self) -> dict[str, Any]:
        with self._lock:
            return {"live": len(self._live), "finished": len(self._finished),
                    "evicted_live": self.evicted_live}

    def reset(self) -> None:
        """Test ergonomics — drop everything."""
        with self._lock:
            self._live.clear()
            self._finished.clear()
            self.evicted_live = 0


#: process-global recorder (the monitoring module reads it; serving layers
#: write through record_event)
default_recorder = FlightRecorder()


def record_event(request_id: str, kind: str, **attrs: Any) -> None:
    """Fire-and-forget flight-recorder emit on the default recorder: never
    raises (observability must not fail a serving/recovery path). runtime/
    emit sites use this helper, mirroring ``bump_counter`` for metrics."""
    try:
        default_recorder.record(request_id, kind, **attrs)
    except Exception:  # noqa: BLE001
        pass


def annotate_request(request_id: str, model: Optional[str] = None,
                     tenant: Optional[str] = None,
                     worker_host: Optional[str] = None) -> None:
    """Never-raises :meth:`FlightRecorder.annotate` on the default recorder
    (the worker's model/tenant stamp sits on the serving path)."""
    try:
        default_recorder.annotate(request_id, model=model, tenant=tenant,
                                  worker_host=worker_host)
    except Exception:  # noqa: BLE001
        pass
