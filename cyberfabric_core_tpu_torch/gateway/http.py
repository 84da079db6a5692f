"""HTTP/1.1 on ``asyncio`` streams: the request and response objects the
port's host hands to its layers and handlers (what ``aiohttp.web`` gives the
JAX package's gateway).

A :class:`Request` is parsed up to its headers; its body is read on demand
(:meth:`Request.read`), after the body-limit layer has looked at its
length. A handler returns a :class:`Response` (or a dict, a list, a
``(body, status)`` pair or None, which the host turns into one), or streams
through a :class:`StreamResponse`, which it prepares, writes frame by frame
and finishes itself. A peer that went away shows as :class:`ClientDisconnected`
when a frame is written, or through :meth:`Request.wait_disconnected`, which
watches the connection for EOF while the handler waits for something else.
"""

from __future__ import annotations

import asyncio
import json
from http import HTTPStatus
from typing import Any, Optional
from urllib.parse import parse_qsl

_REASONS = {499: "Client Closed Request"}


def reason_phrase(status: int) -> str:
    if status in _REASONS:
        return _REASONS[status]
    try:
        return HTTPStatus(status).phrase
    except ValueError:
        return "Unknown"


class ClientDisconnected(ConnectionError):
    """The peer closed the connection while its response was being served."""


class BadHttpRequest(ValueError):
    """Bytes on the socket that are not an HTTP/1.1 request; the connection
    gets a 400 and is closed."""


class BodyTooLarge(ValueError):
    """A chunked body grew past the host's limit."""


class Request:
    """One parsed request. ``request[key]`` is the per-request store the
    layers fill (request id, security context, route spec)."""

    def __init__(self, method: str, target: str, version: str,
                 headers: dict[str, str], reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, max_body: int) -> None:
        self.method = method
        path, _, query = target.partition("?")
        self.path = path
        #: the query string's parameters (the first value of a repeated name)
        self.query: dict[str, str] = {}
        for key, value in parse_qsl(query, keep_blank_values=True):
            self.query.setdefault(key, value)
        #: the route template's path parameters (``{request_id}``)
        self.match_info: dict[str, str] = {}
        self.version = version
        #: header names lower-cased; repeated headers joined by ", "
        self.headers = headers
        self._reader = reader
        self._writer = writer
        self._max_body = max_body
        self._body: Optional[bytes] = None
        self._store: dict[str, Any] = {}
        self._eof: Optional[asyncio.Task] = None
        #: set once a StreamResponse wrote its head: the host then writes
        #: nothing more on this connection and closes it
        self.streamed = False

    def __getitem__(self, key: str) -> Any:
        return self._store[key]

    def __setitem__(self, key: str, value: Any) -> None:
        self._store[key] = value

    def get(self, key: str, default: Any = None) -> Any:
        return self._store.get(key, default)

    @property
    def content_length(self) -> Optional[int]:
        raw = self.headers.get("content-length")
        if raw is None:
            return None
        try:
            n = int(raw)
        except ValueError:
            raise BadHttpRequest(f"bad Content-Length {raw!r}") from None
        if n < 0:
            raise BadHttpRequest(f"bad Content-Length {raw!r}")
        return n

    @property
    def content_type(self) -> str:
        return self.headers.get("content-type", "").split(";")[0].strip().lower()

    @property
    def chunked(self) -> bool:
        return "chunked" in self.headers.get("transfer-encoding", "").lower()

    @property
    def keep_alive(self) -> bool:
        conn = self.headers.get("connection", "").lower()
        if self.version == "HTTP/1.0":
            return "keep-alive" in conn
        return "close" not in conn

    @property
    def body_consumed(self) -> bool:
        return self._body is not None or (not self.chunked and not self.content_length)

    async def read(self) -> bytes:
        """The whole body (read once, then cached)."""
        if self._body is None:
            if self.headers.get("expect", "").lower() == "100-continue":
                self._writer.write(b"HTTP/1.1 100 Continue\r\n\r\n")
                await self._writer.drain()
            if self.chunked:
                self._body = await self._read_chunked()
            else:
                n = self.content_length or 0
                self._body = await self._reader.readexactly(n) if n else b""
        return self._body

    async def _read_chunked(self) -> bytes:
        parts, total = [], 0
        while True:
            line = await self._reader.readline()
            try:
                size = int(line.split(b";")[0].strip(), 16)
            except ValueError:
                raise BadHttpRequest("bad chunk size") from None
            if size == 0:
                while (await self._reader.readline()) not in (b"\r\n", b"\n", b""):
                    pass  # trailers
                return b"".join(parts)
            total += size
            if total > self._max_body:
                raise BodyTooLarge(f"body exceeds {self._max_body} bytes")
            parts.append(await self._reader.readexactly(size))
            await self._reader.readexactly(2)

    def wait_disconnected(self) -> "asyncio.Future[None]":
        """A future that completes when the peer closes the connection (EOF
        or a reset on the reader). Only for a response that ends the
        connection: the watcher consumes whatever else the peer sends."""
        if self._eof is None:
            self._eof = asyncio.ensure_future(self._watch_eof())
        return asyncio.shield(self._eof)

    async def _watch_eof(self) -> None:
        try:
            while await self._reader.read(4096):
                pass
        except (ConnectionError, OSError):
            pass

    def stop_watching(self) -> None:
        if self._eof is not None and not self._eof.done():
            self._eof.cancel()


class Response:
    """A complete response: status, headers and body."""

    def __init__(self, body: bytes = b"", status: int = 200,
                 content_type: Optional[str] = "application/json",
                 headers: Optional[dict[str, str]] = None) -> None:
        self.status = status
        self.body = body
        self.headers: dict[str, str] = dict(headers or {})
        if content_type is not None and body:
            self.headers.setdefault("Content-Type", content_type)

    @classmethod
    def json(cls, obj: Any, status: int = 200,
             content_type: str = "application/json") -> "Response":
        return cls(json.dumps(obj).encode(), status, content_type)

    def encode(self, keep_alive: bool) -> bytes:
        head = [f"HTTP/1.1 {self.status} {reason_phrase(self.status)}"]
        head += [f"{k}: {v}" for k, v in self.headers.items()]
        head.append(f"Content-Length: {len(self.body)}")
        head.append("Connection: keep-alive" if keep_alive else "Connection: close")
        return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + self.body


class StreamResponse:
    """A response written frame by frame (SSE). Its head carries no length
    and ``Connection: close``: the stream ends when the host closes the
    connection. Every write waits for the socket to drain, so a slow or
    vanished peer is seen at the frame it could not take."""

    def __init__(self, request: Request, status: int = 200,
                 headers: Optional[dict[str, str]] = None) -> None:
        self.status = status
        self.headers: dict[str, str] = dict(headers or {})
        self._request = request
        self._writer = request._writer

    async def prepare(self) -> None:
        head = [f"HTTP/1.1 {self.status} {reason_phrase(self.status)}"]
        head += [f"{k}: {v}" for k, v in self.headers.items()]
        head.append("Connection: close")
        self._request.streamed = True
        await self._send(("\r\n".join(head) + "\r\n\r\n").encode("latin-1"))

    async def write(self, data: bytes) -> None:
        await self._send(data)

    async def _send(self, data: bytes) -> None:
        if self._writer.is_closing():
            raise ClientDisconnected("the connection is closed")
        try:
            self._writer.write(data)
            await self._writer.drain()
        except (ConnectionError, OSError) as e:
            raise ClientDisconnected(str(e)) from e
