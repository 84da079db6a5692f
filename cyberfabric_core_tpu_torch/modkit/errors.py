"""RFC 9457 problem documents (the port's copy of ``modkit/errors.py``).

:class:`Problem` renders ``application/problem+json``; :class:`ProblemError`
carries one from anywhere below the gateway to its error-mapping layer,
which renders it. :func:`declare_errors` builds a named catalog of codes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass
class Problem:
    """An RFC-9457 problem document."""

    status: int
    title: str
    code: str = "internal_error"
    type: str = "about:blank"
    detail: Optional[str] = None
    instance: Optional[str] = None
    trace_id: Optional[str] = None
    errors: list[dict[str, Any]] = field(default_factory=list)
    extensions: dict[str, Any] = field(default_factory=dict)

    CONTENT_TYPE = "application/problem+json"

    def to_dict(self) -> dict[str, Any]:
        doc: dict[str, Any] = {
            "type": self.type,
            "status": self.status,
            "title": self.title,
            "code": self.code,
        }
        if self.detail is not None:
            doc["detail"] = self.detail
        if self.instance is not None:
            doc["instance"] = self.instance
        if self.trace_id is not None:
            doc["trace_id"] = self.trace_id
        if self.errors:
            doc["errors"] = self.errors
        doc.update(self.extensions)
        return doc

    @classmethod
    def from_dict(cls, doc: dict[str, Any]) -> "Problem":
        """Inverse of :meth:`to_dict` (the gRPC transport re-raises a remote
        worker's problem as the same problem)."""
        known = {"type", "status", "title", "code", "detail", "instance",
                 "trace_id", "errors"}
        return cls(
            status=int(doc.get("status", 500)),
            title=doc.get("title", "Internal Server Error"),
            code=doc.get("code", "internal_error"),
            type=doc.get("type", "about:blank"),
            detail=doc.get("detail"),
            instance=doc.get("instance"),
            trace_id=doc.get("trace_id"),
            errors=list(doc.get("errors") or []),
            extensions={k: v for k, v in doc.items() if k not in known},
        )


class ProblemError(Exception):
    """Raise anywhere below the gateway; the error-mapping layer renders it."""

    def __init__(self, problem: Problem) -> None:
        super().__init__(f"{problem.status} {problem.code}: {problem.title}")
        self.problem = problem

    @classmethod
    def _core(cls, key: str, detail: Optional[str],
              errors: Optional[list[dict[str, Any]]] = None) -> "ProblemError":
        from .errcat import ERR

        return getattr(ERR.core, key).error(detail, errors=errors)

    @classmethod
    def bad_request(cls, detail: str) -> "ProblemError":
        return cls._core("bad_request", detail)

    @classmethod
    def forbidden(cls, detail: str = "access denied") -> "ProblemError":
        return cls._core("forbidden", detail)

    @classmethod
    def not_found(cls, detail: str) -> "ProblemError":
        return cls._core("not_found", detail)

    @classmethod
    def unprocessable(cls, detail: str,
                      errors: Optional[list[dict[str, Any]]] = None) -> "ProblemError":
        return cls._core("validation_failed", detail, errors)

    @classmethod
    def service_unavailable(cls, detail: str) -> "ProblemError":
        return cls._core("unavailable", detail)

    @classmethod
    def internal(cls, detail: str = "internal error") -> "ProblemError":
        return cls._core("internal_error", detail)


class ErrorCatalog:
    """A named set of error codes → Problem factories, built by
    :func:`declare_errors`. Each entry: ``code -> {status, title, gts_type}``."""

    def __init__(self, namespace: str, entries: dict[str, dict[str, Any]]) -> None:
        self.namespace = namespace
        self.entries = entries

    def problem(self, code: str, detail: Optional[str] = None, **ext: Any) -> Problem:
        spec = self.entries[code]
        return Problem(
            status=spec["status"],
            title=spec["title"],
            code=code,
            type=spec.get("gts_type", f"gts://gts.x.{self.namespace}.err.{code}.v1~"),
            detail=detail,
            extensions=ext,
        )

    def error(self, code: str, detail: Optional[str] = None, **ext: Any) -> ProblemError:
        return ProblemError(self.problem(code, detail, **ext))


def declare_errors(namespace: str, entries: dict[str, dict[str, Any]]) -> ErrorCatalog:
    return ErrorCatalog(namespace, entries)
