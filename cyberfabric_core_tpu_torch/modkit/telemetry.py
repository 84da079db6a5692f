"""Tracing: spans, W3C trace-context propagation, and profiler hooks (the
port's copy of ``modkit/telemetry.py``).

Reference: libs/modkit/src/telemetry/init.rs (OTel tracing init, samplers, OTLP
exporters), tower-http TraceLayer per request
(modules/system/api-gateway/src/module.rs:276-281), W3C propagation.

Host spans carry request_id/trace_id through the middleware stack and are
exported to structured logs or, with an ``otlp_endpoint``, to an OTLP/HTTP
collector. Device-side profiling runs on ``torch.profiler`` (CPU and CUDA
activities) when enabled. XLA's cost analysis has no counterpart here: the
engine counts a decode chunk's flops and bytes from the model's shapes
(``runtime/engine.py InferenceEngine.decode_cost_analysis``). Includes the
throttled-log helper (telemetry/throttled_log.rs).
"""

from __future__ import annotations

import contextvars
import logging
import os
import random
import re
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Any, Optional

logger = logging.getLogger("telemetry")

_TRACEPARENT_RE = re.compile(r"^00-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$")

_current_span: contextvars.ContextVar[Optional["Span"]] = contextvars.ContextVar(
    "current_span", default=None
)


@dataclass
class Span:
    name: str
    trace_id: str
    span_id: str
    parent_id: Optional[str] = None
    attributes: dict[str, Any] = field(default_factory=dict)
    start_ns: int = field(default_factory=time.monotonic_ns)
    start_unix_ns: int = field(default_factory=time.time_ns)
    status: str = "ok"
    sampled: bool = True

    def set_attribute(self, key: str, value: Any) -> None:
        self.attributes[key] = value

    def traceparent(self) -> str:
        # the flags byte carries the sampling decision downstream: a worker
        # thread holding only this string can decide "emit nothing" without
        # consulting the tracer (W3C trace-context §3.2.3.3)
        return (f"00-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")


class SpanExporter:
    """Export finished spans; default sink is the structured log stream."""

    def export(self, span: Span, duration_ms: float) -> None:
        logger.debug(
            "span %s trace=%s dur=%.2fms status=%s %s",
            span.name, span.trace_id, duration_ms, span.status, span.attributes,
        )


class _SpanScope:
    """Class-based span context manager — the per-request hot path avoids the
    generator + contextlib machinery of ``@contextmanager`` (~20 µs/request
    in the gateway overhead profile)."""

    __slots__ = ("_tracer", "span", "_token")

    def __init__(self, tracer: "Tracer", span: Span) -> None:
        self._tracer = tracer
        self.span = span

    def __enter__(self) -> Span:
        self._token = _current_span.set(self.span)
        return self.span

    def __exit__(self, exc_type, exc, tb) -> bool:
        span = self.span
        if exc_type is not None:
            span.status = "error"
        _current_span.reset(self._token)
        tracer = self._tracer
        if tracer.enabled and span.sampled:
            tracer.exporter.export(
                span, (time.monotonic_ns() - span.start_ns) / 1e6)
        return False


class Tracer:
    """Sampling tracer (parent-based ratio sampler parity, telemetry/config.rs)."""

    def __init__(self, *, enabled: bool = True, sample_ratio: float = 1.0,
                 exporter: Optional[SpanExporter] = None) -> None:
        self.enabled = enabled
        self.sample_ratio = sample_ratio
        self.exporter = exporter or SpanExporter()

    def span(self, name: str, *, traceparent: Optional[str] = None,
             **attributes: Any) -> _SpanScope:
        parent = _current_span.get()
        trace_id, parent_id = None, None
        flag_sampled: Optional[bool] = None
        if traceparent:
            m = _TRACEPARENT_RE.match(traceparent.strip())
            if m:
                trace_id, parent_id = m.group(1), m.group(2)
                flag_sampled = bool(int(m.group(3), 16) & 1)
        if trace_id is None and parent is not None:
            trace_id, parent_id = parent.trace_id, parent.span_id
        if trace_id is None:
            # os.urandom over uuid4: same 128 random bits without UUID object
            # construction (~3x faster; spans are per-request hot-path)
            trace_id = os.urandom(16).hex()
        # parent-based sampling: children inherit the parent's decision — the
        # in-context parent's bit, else the traceparent flags byte (a remote
        # or cross-thread parent); only true roots roll the dice, so an
        # unsampled trace emits nothing at all
        if parent is not None:
            sampled = parent.sampled
        elif flag_sampled is not None:
            sampled = flag_sampled
        else:
            sampled = random.random() < self.sample_ratio
        return _SpanScope(self, Span(
            name=name,
            trace_id=trace_id,
            span_id=os.urandom(8).hex(),
            parent_id=parent_id,
            attributes=dict(attributes),
            sampled=sampled,
        ))

    def emit_span(self, name: str, *, traceparent: Optional[str] = None,
                  start_unix_ns: Optional[int] = None, duration_ms: float = 0.0,
                  status: str = "ok", **attributes: Any) -> Optional[Span]:
        """Export one retrospective span without touching the contextvar.

        Built for the scheduler thread: device work is timed first, then the
        span is emitted after the fact with explicit timestamps (the same
        backdating trick as the gateway's unmatched-route epilogue). The
        sampling decision comes from the traceparent flags byte — an
        unsampled parent means this returns None before allocating anything.
        """
        if not self.enabled:
            return None
        trace_id = parent_id = None
        sampled = True
        if traceparent:
            m = _TRACEPARENT_RE.match(traceparent.strip())
            if m:
                trace_id, parent_id = m.group(1), m.group(2)
                sampled = bool(int(m.group(3), 16) & 1)
        if trace_id is None:
            trace_id = os.urandom(16).hex()
            sampled = random.random() < self.sample_ratio
        if not sampled:
            return None
        span = Span(name=name, trace_id=trace_id,
                    span_id=os.urandom(8).hex(), parent_id=parent_id,
                    attributes=dict(attributes), status=status)
        if start_unix_ns is not None:
            span.start_unix_ns = int(start_unix_ns)
        self.exporter.export(span, duration_ms)
        return span

    @staticmethod
    def current() -> Optional[Span]:
        return _current_span.get()


#: process-global tracer: the gateway installs its configured tracer here at
#: init so off-loop layers (scheduler thread, replicas pool) export child
#: spans through the SAME exporter pipeline as the HTTP spans — one OTLP
#: trace covers gateway → prefill → decode chunks. Defaults to a log-exporter
#: tracer so library use without a gateway still works.
_global_tracer = Tracer()


def set_global_tracer(tracer: Tracer) -> Tracer:
    global _global_tracer
    _global_tracer = tracer
    return tracer


def get_global_tracer() -> Tracer:
    return _global_tracer


class OtlpHttpExporter(SpanExporter):
    """OTLP/HTTP JSON span exporter (reference: telemetry/init.rs builds OTLP
    gRPC/HTTP exporters; this speaks the standard OTLP/HTTP JSON encoding to
    any collector's 4318 endpoint).

    Spans are buffered and shipped from a daemon thread — span exit never
    blocks on the network; a dead collector drops batches with a throttled
    warning (availability over telemetry)."""

    def __init__(self, endpoint: str, service_name: str = "tpu-fabric",
                 flush_interval_s: float = 2.0, max_batch: int = 256,
                 max_buffer: int = 4096) -> None:
        import queue
        import threading

        self.endpoint = endpoint.rstrip("/")
        if not self.endpoint.endswith("/v1/traces"):
            self.endpoint += "/v1/traces"
        self.service_name = service_name
        self.flush_interval_s = flush_interval_s
        self.max_batch = max_batch
        self._queue: "queue.Queue[dict]" = queue.Queue(maxsize=max_buffer)
        self._throttle = ThrottledLog(30.0)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="otlp-exporter")
        self._thread.start()

    # -------------------------------------------------------------- encoding
    @staticmethod
    def _attr(key: str, value: Any) -> dict:
        if isinstance(value, bool):
            return {"key": key, "value": {"boolValue": value}}
        if isinstance(value, int):
            return {"key": key, "value": {"intValue": str(value)}}
        if isinstance(value, float):
            return {"key": key, "value": {"doubleValue": value}}
        return {"key": key, "value": {"stringValue": str(value)}}

    def _encode(self, span: Span, duration_ms: float) -> dict:
        end_ns = span.start_unix_ns + int(duration_ms * 1e6)
        out = {
            "traceId": span.trace_id,
            "spanId": span.span_id,
            "name": span.name,
            "kind": 2,  # SERVER
            "startTimeUnixNano": str(span.start_unix_ns),
            "endTimeUnixNano": str(end_ns),
            "attributes": [self._attr(k, v) for k, v in span.attributes.items()],
            "status": {"code": 2 if span.status == "error" else 1},
        }
        if span.parent_id:
            out["parentSpanId"] = span.parent_id
        return out

    def export(self, span: Span, duration_ms: float) -> None:
        try:
            self._queue.put_nowait(self._encode(span, duration_ms))
        except Exception:  # noqa: BLE001 — full buffer: drop, never block
            if self._throttle.should_log("buffer_full"):
                logger.warning("OTLP span buffer full; dropping spans")

    # -------------------------------------------------------------- shipping
    def _drain(self) -> list[dict]:
        import queue

        batch: list[dict] = []
        while len(batch) < self.max_batch:
            try:
                batch.append(self._queue.get_nowait())
            except queue.Empty:
                break
        return batch

    def _post(self, batch: list[dict], timeout_s: float = 10.0) -> None:
        import json as _json
        import urllib.request

        payload = _json.dumps({"resourceSpans": [{
            "resource": {"attributes": [
                self._attr("service.name", self.service_name)]},
            "scopeSpans": [{"scope": {"name": "cyberfabric_core_tpu_torch"},
                            "spans": batch}],
        }]}).encode()
        req = urllib.request.Request(
            self.endpoint, data=payload,
            headers={"Content-Type": "application/json"}, method="POST")
        urllib.request.urlopen(req, timeout=max(0.1, timeout_s))  # noqa: S310

    def _run(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(self.flush_interval_s)
            batch = self._drain()
            if not batch:
                continue
            try:
                self._post(batch)
            except Exception as e:  # noqa: BLE001 — collector down
                if self._throttle.should_log("post_failed"):
                    logger.warning("OTLP export failed (%d spans dropped): %s",
                                   len(batch), e)

    def flush(self, timeout_s: float = 5.0) -> None:
        """Synchronously ship whatever is buffered (tests/shutdown). The
        network timeout is bounded by the remaining flush budget so flush can
        never overrun its deadline on a blackholed collector."""
        deadline = time.monotonic() + timeout_s
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return
            batch = self._drain()
            if not batch:
                return
            try:
                self._post(batch, timeout_s=remaining)
            except Exception:  # noqa: BLE001
                return

    def shutdown(self) -> None:
        self._stop.set()
        self.flush(timeout_s=2.0)


def tracer_from_config(cfg: dict) -> Tracer:
    """Build the tracer from the app-level ``tracing`` config section:
    {enabled, sample_ratio, otlp_endpoint?, service_name?}. Without an
    otlp_endpoint, spans export to the structured log stream."""
    exporter: Optional[SpanExporter] = None
    endpoint = cfg.get("otlp_endpoint")
    if endpoint:
        exporter = OtlpHttpExporter(
            endpoint, service_name=cfg.get("service_name", "tpu-fabric"))
    return Tracer(enabled=bool(cfg.get("enabled", True)),
                  sample_ratio=float(cfg.get("sample_ratio", 1.0)),
                  exporter=exporter)


def traceparent_ids(traceparent: Optional[str]) -> tuple[Optional[str], bool]:
    """(trace_id, sampled) from a W3C traceparent; (None, False) if invalid.
    Parsed ONCE at request submission so the decode hot loop's span guard is
    a single bool attribute check, never a regex."""
    if not traceparent:
        return None, False
    m = _TRACEPARENT_RE.match(traceparent.strip())
    if not m:
        return None, False
    return m.group(1), bool(int(m.group(3), 16) & 1)


#: (request_id, trace_id) for log correlation. A contextvar covers BOTH
#: worlds: asyncio handlers inherit it through task context, and the
#: scheduler/worker threads each see their own default — set_log_context
#: scopes it around per-request operations on those threads.
_log_ctx: contextvars.ContextVar[tuple[str, str]] = contextvars.ContextVar(
    "log_request_ctx", default=("-", "-"))


def set_log_context(request_id: Optional[str],
                    trace_id: Optional[str]) -> contextvars.Token:
    """Bind request/trace ids for log records emitted by this context; returns
    the token for ``reset_log_context``. Never raises."""
    return _log_ctx.set((request_id or "-", trace_id or "-"))


def reset_log_context(token: contextvars.Token) -> None:
    try:
        _log_ctx.reset(token)
    except Exception:  # noqa: BLE001 — cross-context reset: leave as-is
        pass


class TraceContextFilter(logging.Filter):
    """Injects ``%(request_id)s`` / ``%(trace_id)s`` into every log record so
    scheduler and worker lines become greppable by trace. Installed on the
    logging-host handlers (modkit/logging_host.py); always passes the record
    through — it annotates, never filters."""

    def filter(self, record: logging.LogRecord) -> bool:
        rid, tid = _log_ctx.get()
        record.request_id = rid
        record.trace_id = tid
        return True


class ThrottledLog:
    """Log at most once per ``interval`` seconds per key (throttled_log.rs)."""

    def __init__(self, interval: float = 5.0) -> None:
        self.interval = interval
        self._last: dict[str, float] = {}

    def should_log(self, key: str) -> bool:
        now = time.monotonic()
        if now - self._last.get(key, -1e9) >= self.interval:
            self._last[key] = now
            return True
        return False


@contextmanager
def device_profile(name: str, enabled: bool = False, logdir: Optional[str] = None):
    """Wrap a region in a ``torch.profiler`` trace (CPU and, with a card,
    CUDA activities) under ``record_function(name)`` when enabled; with a
    ``logdir`` the trace is written there as a chrome trace on exit. Yields
    the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(name):
            yield prof
    if logdir:
        os.makedirs(logdir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(logdir, f"{name}.trace.json"))
