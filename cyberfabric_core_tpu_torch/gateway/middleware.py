"""The gateway's layers around each route (the port's copy of
``gateway/middleware.py:117-400``), composed once per route when the host
is built, in the reference's order:

  request id → trace (the HTTP span, the request counter and latency)
  → timeout (not for SSE routes) → body limit (413) → MIME (415)
  → rate limit (token bucket, then in-flight cap: 429 + Retry-After)
  → error mapping (``application/problem+json``; the ``gateway.request``
  failpoint) → auth → handler

The trace layer opens the request's HTTP span from the client's
``traceparent`` (parent-based sampling) and binds the request and trace ids
to the log context; the llm-gateway passes the span's traceparent on to the
worker, so the scheduler's spans join the same trace. The port serves with
``auth_disabled`` only: the auth layer gives every request the anonymous
context of the configured tenant. The JAX layers the port leaves out (CORS,
policy, license) come with ROADMAP queue 1 item 15.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Awaitable, Callable, Optional

from ..modkit.errcat import ERR
from ..modkit.errors import Problem, ProblemError
from ..modkit.failpoints import failpoint_async
from ..modkit.metrics import default_registry
from ..modkit.security import SecurityContext
from ..modkit.telemetry import Tracer, reset_log_context, set_log_context
from .http import BodyTooLarge, ClientDisconnected, Request, Response
from .router import OperationSpec

logger = logging.getLogger("gateway")

REQUEST_ID_HEADER = "x-request-id"
SECURITY_CONTEXT_KEY = "security_context"
REQUEST_ID_KEY = "request_id"
TRACE_ID_KEY = "trace_id"

Handler = Callable[[Request], Awaitable[Response]]


class _TokenBucket:
    def __init__(self, rps: float, burst: int) -> None:
        self.rate = rps
        self.capacity = float(max(burst, 1))
        self.tokens = self.capacity
        self.last = time.monotonic()

    def try_acquire(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.capacity, self.tokens + (now - self.last) * self.rate)
        self.last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def problem_response(problem: Problem, request_id: Optional[str] = None) -> Response:
    """A problem document; a 429 carries ``Retry-After`` from the problem's
    ``retry_after_s`` (at least 1 s)."""
    if request_id and problem.trace_id is None:
        problem.trace_id = request_id
    resp = Response.json(problem.to_dict(), problem.status, Problem.CONTENT_TYPE)
    if problem.status == 429:
        retry_after = problem.extensions.get("retry_after_s", 1)
        try:
            resp.headers["Retry-After"] = str(max(1, int(float(retry_after))))
        except (TypeError, ValueError):
            resp.headers["Retry-After"] = "1"
    return resp


class RouteStackBuilder:
    """Composes the layers around one route's handler at build time."""

    def __init__(self, *, timeout_secs: float = 30.0, max_body_bytes: int = 64 * 1024 * 1024,
                 tenant: str = "default", tracer: Optional[Tracer] = None) -> None:
        self.timeout_secs = timeout_secs
        self.max_body_bytes = max_body_bytes
        self.tenant = tenant
        self.tracer = tracer or Tracer(enabled=False)
        # metric objects held here, off the per-request path
        self._req_counter = default_registry.counter(
            "http_requests_total", "HTTP requests served")
        self._req_latency = default_registry.histogram(
            "http_request_duration_seconds", "Request latency")

    def compose(self, spec: Optional[OperationSpec], endpoint: Handler,
                route: Optional[str] = None) -> Handler:
        """``spec=None`` composes the host's own public endpoints (``route``
        names them in the request metrics)."""
        h = self._auth_layer(endpoint)
        h = self._error_layer(spec, h)
        h = self._rate_layer(spec, h)
        h = self._mime_layer(spec, h)
        h = self._body_layer(h)
        h = self._timeout_layer(spec, h)
        h = self._trace_layer(spec.path if spec is not None else route, h)
        return self._request_id_layer(spec, h)

    def _request_id_layer(self, spec: Optional[OperationSpec], inner: Handler) -> Handler:
        async def request_id(request: Request) -> Response:
            rid = request.headers.get(REQUEST_ID_HEADER) or os.urandom(16).hex()
            request[REQUEST_ID_KEY] = rid
            resp = await inner(request)
            if not request.streamed:
                resp.headers[REQUEST_ID_HEADER] = rid
            return resp

        return request_id

    def _trace_layer(self, route: Optional[str], inner: Handler) -> Handler:
        tracer, counter, latency = self.tracer, self._req_counter, self._req_latency

        async def trace(request: Request) -> Response:
            start = time.monotonic()
            with tracer.span(f"http {request.method} {request.path}",
                             traceparent=request.headers.get("traceparent"),
                             method=request.method, path=request.path,
                             request_id=request.get(REQUEST_ID_KEY)) as span:
                request[TRACE_ID_KEY] = span.trace_id
                log_token = set_log_context(request.get(REQUEST_ID_KEY), span.trace_id)
                try:
                    resp = await inner(request)
                finally:
                    reset_log_context(log_token)
                span.set_attribute("status", resp.status)
                label = route if route is not None else request.path
                counter.inc(route=label, method=request.method, status=str(resp.status))
                latency.observe(time.monotonic() - start, route=label)
                return resp

        return trace

    def _timeout_layer(self, spec: Optional[OperationSpec], inner: Handler) -> Handler:
        # SSE routes are exempt: the timeout guards handler completion, and a
        # streaming handler completes when its stream does
        if spec is not None and spec.sse:
            return inner
        timeout_secs = self.timeout_secs

        async def timeout(request: Request) -> Response:
            try:
                async with asyncio.timeout(timeout_secs):
                    return await inner(request)
            except TimeoutError:
                return problem_response(
                    ERR.core.timeout.problem(f"request exceeded {timeout_secs}s"),
                    request.get(REQUEST_ID_KEY))

        return timeout

    def _body_layer(self, inner: Handler) -> Handler:
        max_body_bytes = self.max_body_bytes

        async def body_limit(request: Request) -> Response:
            cl = request.content_length
            if cl is not None and cl > max_body_bytes:
                return problem_response(
                    ERR.core.body_too_large.problem(f"body exceeds {max_body_bytes} bytes"),
                    request.get(REQUEST_ID_KEY))
            try:
                return await inner(request)
            except BodyTooLarge as e:
                return problem_response(ERR.core.body_too_large.problem(str(e)),
                                        request.get(REQUEST_ID_KEY))

        return body_limit

    def _mime_layer(self, spec: Optional[OperationSpec], inner: Handler) -> Handler:
        # every route of the port takes JSON bodies
        if spec is None or spec.method not in ("POST", "PUT", "PATCH"):
            return inner

        async def mime(request: Request) -> Response:
            if request.content_length or request.chunked:
                ctype = request.content_type
                if ctype != "application/json":
                    return problem_response(
                        ERR.core.unsupported_media_type.problem(
                            f"expected one of ['application/json'], got {ctype!r}"),
                        request.get(REQUEST_ID_KEY))
            return await inner(request)

        return mime

    def _rate_layer(self, spec: Optional[OperationSpec], inner: Handler) -> Handler:
        if spec is None or spec.rate_limit is None:
            return inner
        rl = spec.rate_limit
        bucket, sem = _TokenBucket(rl.rps, rl.burst), asyncio.Semaphore(rl.max_in_flight)

        async def rate_limit(request: Request) -> Response:
            if not bucket.try_acquire():
                return problem_response(
                    ERR.core.rate_limited.problem("per-route rate limit exceeded"),
                    request.get(REQUEST_ID_KEY))
            if sem.locked():
                return problem_response(
                    ERR.core.too_many_in_flight.problem("per-route in-flight limit reached"),
                    request.get(REQUEST_ID_KEY))
            async with sem:
                return await inner(request)

        return rate_limit

    def _error_layer(self, spec: Optional[OperationSpec], inner: Handler) -> Handler:
        # the failpoint control plane is exempt from its own injection: an
        # always-raise on gateway.request must not brick the disarm route
        faultable = not (spec is not None
                         and spec.path.startswith("/v1/monitoring/failpoints"))

        async def error_mapping(request: Request) -> Response:
            try:
                if faultable:
                    # inside the error boundary: an injected raise comes back
                    # as a problem, an injected delay meets the timeout layer
                    await failpoint_async("gateway.request")
                return await inner(request)
            except ProblemError as e:
                if request.streamed:  # the stream's head is out: nothing to re-status
                    raise ClientDisconnected("stream ended by a problem") from e
                return problem_response(e.problem, request.get(REQUEST_ID_KEY))
            except (asyncio.CancelledError, ClientDisconnected, BodyTooLarge):
                raise
            except Exception:
                logger.exception("unhandled error in %s", request.path)
                if request.streamed:
                    raise
                return problem_response(ERR.core.internal_error.problem(),
                                        request.get(REQUEST_ID_KEY))

        return error_mapping

    def _auth_layer(self, inner: Handler) -> Handler:
        tenant = self.tenant

        async def anonymous(request: Request) -> Response:
            request[SECURITY_CONTEXT_KEY] = SecurityContext.anonymous(tenant)
            return await inner(request)

        return anonymous
