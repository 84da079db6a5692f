"""Typed error codes (the port's copy of ``modkit/errcat.py``).

The JAX package compiles ``modkit/catalogs/errors.json`` at import. The port
carries only the entries its chat path raises, with the same status, title
and GTS ``type``, plus ``llm.not_ported`` (501) for a request or an option
that reaches a part of the JAX package the port does not have yet::

    from ..modkit.errcat import ERR
    raise ERR.model_registry.model_not_found.error(f"model {name!r} not found")
"""

from __future__ import annotations

from typing import Any, Iterator, Optional

from .errors import Problem, ProblemError

_TITLES = {400: "Bad Request", 403: "Forbidden", 404: "Not Found", 408: "Request Timeout",
           409: "Conflict", 413: "Payload Too Large", 415: "Unsupported Media Type",
           422: "Unprocessable Entity", 429: "Too Many Requests",
           499: "Client Closed Request", 500: "Internal Server Error",
           501: "Not Implemented", 503: "Service Unavailable", 504: "Gateway Timeout",
           507: "Insufficient Storage"}

#: namespace → code → HTTP status
_CATALOG: dict[str, dict[str, int]] = {
    "core": {
        "bad_request": 400, "malformed_json": 400, "forbidden": 403, "not_found": 404,
        "body_too_large": 413, "unsupported_media_type": 415, "validation_failed": 422,
        "rate_limited": 429, "too_many_in_flight": 429, "internal_error": 500,
        "unavailable": 503, "timeout": 504,
    },
    "model_registry": {"model_not_found": 404, "alias_cycle": 409},
    "llm": {
        "model_not_found": 404, "ttft_timeout": 504, "total_timeout": 504,
        "deadline_exceeded": 504, "request_timeout": 408, "client_closed_request": 499,
        "context_length_exceeded": 422, "unsupported_param": 400,
        "scheduler_saturated": 429, "tenant_saturated": 429,
        "tenant_quota_exceeded": 429, "replica_unavailable": 503,
        "load_shed": 429, "tenant_shed": 429, "not_ported": 501,
        "infeasible_plan": 507,
    },
    "monitoring": {
        "profiler_running": 409, "profiler_not_running": 400,
        "profiler_stop_failed": 500, "faultlab_disabled": 403,
        "unknown_failpoint": 404, "bad_failpoint_spec": 400,
        "unknown_request": 404, "bad_export_format": 400, "not_ready": 503,
        "unknown_replica": 404, "replica_conflict": 409, "unknown_tenant": 404,
        "unknown_worker": 404, "unknown_host": 404,
    },
}


class ErrorCode:
    """One catalog entry — a typed constant, not a string."""

    __slots__ = ("namespace", "code", "status", "title")

    def __init__(self, namespace: str, code: str, status: int) -> None:
        self.namespace = namespace
        self.code = code
        self.status = status
        self.title = _TITLES[status]

    @property
    def gts_type(self) -> str:
        return f"gts://gts.x.core.{self.namespace}.err.{self.code}.v1~"

    def problem(self, detail: Optional[str] = None, *,
                errors: Optional[list[dict[str, Any]]] = None,
                **extensions: Any) -> Problem:
        return Problem(status=self.status, title=self.title, code=self.code,
                       type=self.gts_type, detail=detail, errors=errors or [],
                       extensions=extensions)

    def error(self, detail: Optional[str] = None, *,
              errors: Optional[list[dict[str, Any]]] = None,
              **extensions: Any) -> ProblemError:
        return ProblemError(self.problem(detail, errors=errors, **extensions))

    def __repr__(self) -> str:
        return f"<ErrorCode {self.namespace}.{self.code} {self.status}>"


class Catalog:
    """One namespace of the catalog; codes are attributes."""

    def __init__(self, name: str, codes: dict[str, ErrorCode]) -> None:
        self._name = name
        self._codes = codes

    def __getattr__(self, key: str) -> ErrorCode:
        try:
            return self._codes[key]
        except KeyError:
            raise AttributeError(f"unknown error code {self._name}.{key!r} "
                                 f"(known: {sorted(self._codes)})") from None

    def __iter__(self) -> Iterator[ErrorCode]:
        return iter(self._codes.values())


class _Root:
    def __init__(self) -> None:
        self._namespaces = {
            ns: Catalog(ns, {code: ErrorCode(ns, code, status)
                             for code, status in codes.items()})
            for ns, codes in _CATALOG.items()}

    def __getattr__(self, name: str) -> Catalog:
        try:
            return self._namespaces[name]
        except KeyError:
            raise AttributeError(f"unknown error namespace {name!r}") from None

    def __iter__(self) -> Iterator[Catalog]:
        return iter(self._namespaces.values())


ERR = _Root()
