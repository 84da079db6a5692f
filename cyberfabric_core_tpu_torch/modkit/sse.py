"""Server-sent event framing (the port's copy of ``modkit/sse.py:17-32``):
``data: <json>\n\n`` frames, terminated by ``data: [DONE]\n\n``."""

from __future__ import annotations

import json
from typing import Any, Optional


def format_sse_event(data: str, *, event: Optional[str] = None,
                     id: Optional[str] = None) -> bytes:
    lines = []
    if id is not None:
        lines.append(f"id: {id}")
    if event is not None:
        lines.append(f"event: {event}")
    for chunk in data.split("\n"):
        lines.append(f"data: {chunk}")
    return ("\n".join(lines) + "\n\n").encode()


def format_sse_json(obj: Any, **kw: Any) -> bytes:
    return format_sse_event(json.dumps(obj, separators=(",", ":")), **kw)


SSE_DONE = b"data: [DONE]\n\n"
