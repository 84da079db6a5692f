"""The api-gateway: the port's one HTTP host (counterpart of
``gateway/module.py``), an HTTP/1.1 server on ``asyncio.start_server``.

Each connection is served by one task: it parses a request's head, routes
it by method and path (a ``{name}`` segment of a route matches one path
segment; 404 / 405 problems otherwise), runs the route's composed layers
(:mod:`.middleware`) and writes the response, keeping the connection alive
unless the peer or the response ends it. An SSE handler writes its own
frames (:class:`.http.StreamResponse`) and the connection closes when it
returns. :meth:`ApiGateway.stop` stops accepting, lets requests in progress
finish for a grace period and then cancels them, and ships the tracer's
buffered spans.

Built-in public paths: ``GET /health`` (the worker's health document),
``GET /healthz`` (liveness: the process is up and the event loop, touched
every second by a heartbeat task, still schedules; 503 past the doctor's
``loop_stall_s``) and ``GET /readyz`` (readiness: 503 ``monitoring.not_ready``
with the doctor's reasons while it sheds, else 200).
"""

from __future__ import annotations

import asyncio
import logging
import os
import re
from dataclasses import dataclass, fields
from typing import Any, Awaitable, Callable, Optional
from urllib.parse import unquote

from ..modkit.doctor import default_doctor
from ..modkit.errcat import ERR
from ..modkit.errors import Problem
from ..modkit.telemetry import Tracer
from .http import BadHttpRequest, ClientDisconnected, Request, Response
from .middleware import RouteStackBuilder, problem_response
from .router import OperationSpec, RateLimitSpec, RestRouter

logger = logging.getLogger("gateway")

#: largest request head (request line + headers)
MAX_HEAD_BYTES = 64 * 1024


@dataclass
class GatewayConfig:
    """The ``api_gateway`` section (the JAX ``GatewayConfig``). The port
    serves ``auth_disabled: true`` only, and no CORS."""

    bind_addr: str = "127.0.0.1:8086"
    reuse_port: bool = False
    timeout_secs: float = 30.0
    max_body_bytes: int = 64 * 1024 * 1024
    cors_allow_origin: Optional[str] = None
    auth_disabled: bool = False
    default_tenant: str = "default"
    default_rps: float = 1000.0
    default_burst: int = 200
    default_in_flight: int = 64

    @classmethod
    def from_config(cls, raw: dict[str, Any]) -> "GatewayConfig":
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ValueError(f"api_gateway config: unknown keys {unknown}")
        cfg = cls(**raw)
        if not cfg.auth_disabled:
            raise ValueError(
                "api_gateway config: the port serves with auth_disabled: true only; "
                "authentication comes with ROADMAP queue 1 item 15 (auth modes)")
        if cfg.cors_allow_origin is not None:
            raise ValueError("api_gateway config: cors_allow_origin is not ported yet "
                             "(ROADMAP queue 1 item 15: CORS)")
        return cfg


def _to_response(result: Any) -> Any:
    """A handler's result as a response: a dict becomes JSON; a response or
    a stream (already written) passes through."""
    return Response.json(result) if isinstance(result, dict) else result


Route = Callable[[Request], Awaitable[Response]]

#: the host's own public paths (no route of a module may take them)
BUILTIN_PUBLIC_PATHS = frozenset({"/health", "/healthz", "/readyz"})


class ApiGateway:
    """Routes ``router``'s operations and the host's built-in public paths.
    ``tracer`` opens each request's HTTP span (None: tracing off)."""

    def __init__(self, config: GatewayConfig, router: RestRouter, tenant: str,
                 health: Callable[[], Awaitable[dict]],
                 tracer: Optional[Tracer] = None) -> None:
        self.config = config
        self._health = health
        self.tracer = tracer or Tracer(enabled=False)
        stack = RouteStackBuilder(timeout_secs=config.timeout_secs,
                                  max_body_bytes=config.max_body_bytes, tenant=tenant,
                                  tracer=self.tracer)
        self._routes: dict[tuple[str, str], Route] = {}
        #: routes with ``{name}`` segments: (method, matcher, route)
        self._templates: list[tuple[str, re.Pattern[str], Route]] = []
        for spec in router.operations:
            if spec.path in BUILTIN_PUBLIC_PATHS:
                raise ValueError(f"route {spec.path} is a built-in public path")
            if spec.rate_limit is None:
                spec.rate_limit = RateLimitSpec(rps=config.default_rps,
                                                burst=config.default_burst,
                                                max_in_flight=config.default_in_flight)
            composed = stack.compose(spec, self._wrap(spec))
            pattern = spec.pattern()
            if pattern is None:
                self._routes[(spec.method, spec.path)] = composed
            else:
                self._templates.append((spec.method, pattern, composed))
        for path, endpoint in (("/health", self._serve_health),
                               ("/healthz", self._serve_healthz),
                               ("/readyz", self._serve_readyz)):
            self._routes[("GET", path)] = stack.compose(None, endpoint, route=path)
        self._server: Optional[asyncio.base_events.Server] = None
        self._conns: dict[asyncio.Task, bool] = {}  # task → serving a request now
        self._heartbeat: Optional[asyncio.Task] = None
        self.bound_port: Optional[int] = None

    def _match(self, request: Request) -> Optional[Route]:
        route = self._routes.get((request.method, request.path))
        if route is not None:
            return route
        for method, pattern, route in self._templates:
            m = pattern.match(request.path) if method == request.method else None
            if m is not None:
                request.match_info = {k: unquote(v) for k, v in m.groupdict().items()}
                return route
        return None

    def _methods_for(self, path: str) -> set[str]:
        return ({m for m, p in self._routes if p == path}
                | {m for m, pattern, _ in self._templates if pattern.match(path)})

    @staticmethod
    def _wrap(spec: OperationSpec):
        async def handler(request: Request) -> Response:
            return _to_response(await spec.handler(request))

        return handler

    async def _serve_health(self, request: Request) -> Response:
        return Response.json(await self._health())

    async def _serve_healthz(self, request: Request) -> Response:
        # liveness: the lag is read BEFORE this request touches the
        # heartbeat, so a stale loop shows; serving it then counts as fresh
        # evidence. A shedding server is still live.
        live, detail = default_doctor.liveness()
        default_doctor.touch_event_loop()
        return Response.json(detail, 200 if live else 503)

    async def _serve_readyz(self, request: Request) -> Response:
        # readiness: 503 with the violated objectives and tripped watchdogs
        # while the doctor sheds; degraded and recovering stay 200
        ready, state, reasons = default_doctor.readiness()
        if not ready:
            raise ERR.monitoring.not_ready.error(f"serving state is {state!r}",
                                                 state=state, reasons=reasons)
        return Response.json({"status": "ready", "state": state, "reasons": reasons})

    def _unmatched(self, request: Request) -> Response:
        methods = self._methods_for(request.path)
        status = 405 if methods else 404
        rid = request.headers.get("x-request-id") or os.urandom(16).hex()
        reason = "Method Not Allowed" if methods else "Not Found"
        resp = problem_response(Problem(status=status, title=reason,
                                        code=reason.lower().replace(" ", "_")), rid)
        resp.headers["x-request-id"] = rid
        if methods:
            resp.headers["Allow"] = ",".join(sorted(methods))
        return resp

    # ------------------------------------------------------------- serving
    async def start(self) -> None:
        host, _, port = self.config.bind_addr.rpartition(":")
        self._server = await asyncio.start_server(
            self._serve_connection, host or "127.0.0.1", int(port),
            limit=MAX_HEAD_BYTES, reuse_port=self.config.reuse_port or None)
        self.bound_port = self._server.sockets[0].getsockname()[1]

        async def heartbeat() -> None:
            # /healthz reads the age of the last touch: a wedged loop shows as
            # a stale heartbeat before requests visibly hang
            while True:
                default_doctor.touch_event_loop()
                await asyncio.sleep(1.0)

        self._heartbeat = asyncio.ensure_future(heartbeat())

    async def stop(self, grace_s: float = 5.0) -> None:
        if self._heartbeat is not None:
            self._heartbeat.cancel()
            self._heartbeat = None
        shutdown = getattr(self.tracer.exporter, "shutdown", None)
        if callable(shutdown):
            # ship the buffered spans before the exporter's thread dies
            await asyncio.get_running_loop().run_in_executor(None, shutdown)
        if self._server is None:
            return
        self._server.close()
        for task, busy in list(self._conns.items()):
            if not busy:
                task.cancel()
        busy = [t for t, b in self._conns.items() if b]
        if busy:
            _, late = await asyncio.wait(busy, timeout=grace_s)
            for task in late:
                task.cancel()
        if self._conns:
            await asyncio.wait(list(self._conns), timeout=grace_s)
        await self._server.wait_closed()
        self._server = None

    async def _read_request(self, reader: asyncio.StreamReader,
                            writer: asyncio.StreamWriter) -> Optional[Request]:
        try:
            head = await reader.readuntil(b"\r\n\r\n")
        except asyncio.IncompleteReadError as e:
            if e.partial.strip():
                raise BadHttpRequest("truncated request head") from None
            return None
        except asyncio.LimitOverrunError:
            raise BadHttpRequest("request head too large") from None
        lines = head.decode("latin-1").split("\r\n")
        parts = lines[0].split(" ")
        if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
            raise BadHttpRequest(f"bad request line {lines[0][:80]!r}")
        headers: dict[str, str] = {}
        for line in lines[1:]:
            if not line:
                continue
            name, sep, value = line.partition(":")
            if not sep:
                raise BadHttpRequest(f"bad header line {line[:80]!r}")
            key = name.strip().lower()
            headers[key] = (headers[key] + ", " if key in headers else "") + value.strip()
        return Request(parts[0].upper(), parts[1], parts[2], headers, reader, writer,
                       self.config.max_body_bytes)

    async def _serve_connection(self, reader: asyncio.StreamReader,
                                writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conns[task] = False
        try:
            while True:
                request = await self._read_request(reader, writer)
                if request is None:
                    return
                self._conns[task] = True
                route = self._match(request)
                try:
                    resp = (await route(request) if route is not None
                            else self._unmatched(request))
                finally:
                    request.stop_watching()
                if request.streamed:
                    return
                keep = request.keep_alive and request.body_consumed
                writer.write(resp.encode(keep))
                await writer.drain()
                self._conns[task] = False
                if not keep:
                    return
        except BadHttpRequest as e:
            try:
                writer.write(problem_response(Problem(
                    status=400, title="Bad Request", code="bad_request",
                    detail=str(e))).encode(False))
                await writer.drain()
            except (ConnectionError, OSError):
                pass
        except (ClientDisconnected, ConnectionError, OSError, asyncio.IncompleteReadError):
            pass
        finally:
            self._conns.pop(task, None)
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError, asyncio.CancelledError):
                pass

