"""The gateway's layers around each route (the port's copy of
``gateway/middleware.py:117-400``), composed once per route when the host
is built, in the reference's order:

  request id → timeout (not for SSE routes) → body limit (413) → MIME (415)
  → rate limit (token bucket, then in-flight cap: 429 + Retry-After)
  → error mapping (``application/problem+json``) → auth → handler

The port serves with ``auth_disabled`` only: the auth layer gives every
request the anonymous context of the configured tenant. The JAX layers the
port leaves out (tracing, CORS, policy, license) come with ROADMAP queue 1
items 15 and 16.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from typing import Awaitable, Callable, Optional

from ..modkit.errcat import ERR
from ..modkit.errors import Problem, ProblemError
from ..modkit.security import SecurityContext
from .http import BodyTooLarge, ClientDisconnected, Request, Response
from .router import OperationSpec

logger = logging.getLogger("gateway")

REQUEST_ID_HEADER = "x-request-id"
SECURITY_CONTEXT_KEY = "security_context"
REQUEST_ID_KEY = "request_id"

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
                 tenant: str = "default") -> None:
        self.timeout_secs = timeout_secs
        self.max_body_bytes = max_body_bytes
        self.tenant = tenant

    def compose(self, spec: Optional[OperationSpec], endpoint: Handler) -> Handler:
        """``spec=None`` composes the host's own public endpoints."""
        h = self._auth_layer(endpoint)
        h = self._error_layer(h)
        h = self._rate_layer(spec, h)
        h = self._mime_layer(spec, h)
        h = self._body_layer(h)
        h = self._timeout_layer(spec, h)
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

    def _error_layer(self, inner: Handler) -> Handler:
        async def error_mapping(request: Request) -> Response:
            try:
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
