"""Route registration (the port's counterpart of ``gateway/router.py``): the
modules declare their operations on a :class:`RestRouter`, which refuses a
duplicate route; the host composes each one's layers once. A path may hold
``{name}`` segments (``/v1/monitoring/requests/{request_id}``): each matches
one path segment and lands in ``request.match_info``."""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Optional

Handler = Callable[..., Awaitable[Any]]


@dataclass
class RateLimitSpec:
    """Per-route RPS bucket + in-flight cap."""

    rps: float = 1000.0
    burst: int = 200
    max_in_flight: int = 64


@dataclass
class OperationSpec:
    method: str
    path: str
    handler: Handler
    #: a streaming route: exempt from the handler timeout (it completes when
    #: its stream does)
    sse: bool = False
    module: str = ""
    rate_limit: Optional[RateLimitSpec] = None

    def pattern(self) -> Optional["re.Pattern[str]"]:
        """The path's matcher when it holds ``{name}`` segments, else None."""
        if "{" not in self.path:
            return None
        return re.compile("^" + re.sub(r"\\\{(\w+)\\\}", r"(?P<\1>[^/]+)",
                                       re.escape(self.path)) + "$")


class RestRouter:
    """Collects the modules' operations; the host composes and serves them."""

    def __init__(self) -> None:
        self.operations: list[OperationSpec] = []

    def route(self, method: str, path: str, handler: Handler, *, sse: bool = False,
              module: str = "") -> OperationSpec:
        spec = OperationSpec(method.upper(), path, handler, sse=sse, module=module)
        for existing in self.operations:
            if existing.method == spec.method and existing.path == spec.path:
                raise ValueError(f"duplicate route {spec.method} {spec.path} "
                                 f"({existing.module} vs {spec.module})")
        self.operations.append(spec)
        return spec
