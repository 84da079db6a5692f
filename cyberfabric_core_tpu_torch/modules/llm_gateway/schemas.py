"""The llm-gateway wire contract as JSON Schemas (the port's copy of
``modules/llm_gateway/schemas.py``: the chat, completion and embedding
requests, the response and the stream chunk, with every sub-schema they
reference).

Draft 2020-12, ``additionalProperties: false``, ``$id`` of the form
gts://gts.x.llmgw.<group>.<name>.v1~. Messages' content is always an array
of parts, never a bare string.
"""

from __future__ import annotations

from typing import Any


def _schema(group: str, name: str, body: dict[str, Any]) -> dict[str, Any]:
    return {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "$id": f"gts://gts.x.llmgw.{group}.{name}.v1~",
        "additionalProperties": False,
        **body,
    }


ROLE = _schema("core", "role", {"type": "string",
                                "enum": ["system", "user", "assistant", "tool"]})

TEXT_CONTENT = _schema("content", "text", {
    "type": "object",
    "required": ["type", "text"],
    "properties": {"type": {"const": "text"}, "text": {"type": "string"}},
})

IMAGE_CONTENT = _schema("content", "image", {
    "type": "object",
    "required": ["type", "url"],
    "properties": {"type": {"const": "image"}, "url": {"type": "string"},
                   "detail": {"type": "string", "enum": ["low", "high", "auto"]}},
})

AUDIO_CONTENT = _schema("content", "audio", {
    "type": "object", "required": ["type", "url"],
    "properties": {"type": {"const": "audio"}, "url": {"type": "string"},
                   "format": {"type": "string"}},
})

VIDEO_CONTENT = _schema("content", "video", {
    "type": "object", "required": ["type", "url"],
    "properties": {"type": {"const": "video"}, "url": {"type": "string"}},
})

DOCUMENT_CONTENT = _schema("content", "document", {
    "type": "object", "required": ["type", "url"],
    "properties": {"type": {"const": "document"}, "url": {"type": "string"},
                   "mime_type": {"type": "string"}},
})

TOOL_RESULT_CONTENT = _schema("content", "tool_result", {
    "type": "object", "required": ["type", "tool_call_id", "result"],
    "properties": {"type": {"const": "tool_result"},
                   "tool_call_id": {"type": "string"},
                   "result": {}},
})

CONTENT_PART = {"oneOf": [TEXT_CONTENT, IMAGE_CONTENT, AUDIO_CONTENT,
                          VIDEO_CONTENT, DOCUMENT_CONTENT, TOOL_RESULT_CONTENT]}

MESSAGE = _schema("core", "message", {
    "type": "object",
    "required": ["role", "content"],
    "properties": {
        "role": {"enum": ["system", "user", "assistant", "tool"]},
        "content": {"type": "array", "minItems": 1, "items": CONTENT_PART},
        "tool_calls": {"type": "array", "items": {"type": "object"}},
        "name": {"type": "string"},
    },
})

# three tool encodings (SURVEY §8.1 tools/)
TOOL_REFERENCE = _schema("tools", "tool_reference", {
    "type": "object", "required": ["type", "schema_id"],
    "properties": {"type": {"const": "reference"}, "schema_id": {"type": "string"}},
})
TOOL_INLINE_GTS = _schema("tools", "tool_inline_gts", {
    "type": "object", "required": ["type", "schema"],
    "properties": {"type": {"const": "inline_gts"}, "schema": {"type": "object"}},
})
TOOL_UNIFIED = _schema("tools", "tool_unified", {
    "type": "object", "required": ["type", "name"],
    "properties": {"type": {"const": "unified"}, "name": {"type": "string"},
                   "description": {"type": "string"},
                   "parameters": {"type": "object"}},
})
TOOL = {"oneOf": [TOOL_REFERENCE, TOOL_INLINE_GTS, TOOL_UNIFIED]}

FALLBACK_CONFIG = _schema("core", "fallback", {
    "type": "object",
    "properties": {
        "models": {"type": "array", "items": {"type": "string"}, "minItems": 1},
        "max_attempts": {"type": "integer", "minimum": 1, "maximum": 8},
    },
})

REQUEST = _schema("core", "request", {
    "type": "object",
    "required": ["model", "messages"],
    "properties": {
        "model": {"type": "string"},
        "messages": {"type": "array", "minItems": 1, "items": MESSAGE},
        "tools": {"type": "array", "items": TOOL},
        "stream": {"type": "boolean", "default": False},
        "async": {"type": "boolean", "default": False},
        "response_schema": {"type": "object"},
        "fallback": FALLBACK_CONFIG,
        "max_tokens": {"type": "integer", "minimum": 1},
        "temperature": {"type": "number", "minimum": 0},
        "top_p": {"type": "number", "exclusiveMinimum": 0, "maximum": 1},
        "top_k": {"type": "integer", "minimum": 0},
        "seed": {"type": "integer"},
        "stop": {"type": "array", "items": {"type": "string"}, "maxItems": 8},
    },
})

COMPLETION_REQUEST = _schema("core", "completion_request", {
    # raw text completion (BASELINE metric surface: POST /v1/completions) —
    # the prompt is tokenized verbatim, no chat template
    "type": "object",
    "required": ["model", "prompt"],
    "properties": {
        "model": {"type": "string"},
        "prompt": {"type": "string", "minLength": 1},
        "stream": {"type": "boolean", "default": False},
        "fallback": FALLBACK_CONFIG,
        "max_tokens": {"type": "integer", "minimum": 1},
        "temperature": {"type": "number", "minimum": 0},
        "top_p": {"type": "number", "exclusiveMinimum": 0, "maximum": 1},
        "top_k": {"type": "integer", "minimum": 0},
        "seed": {"type": "integer"},
        "stop": {"type": "array", "items": {"type": "string"}, "maxItems": 8},
    },
})

USAGE = _schema("core", "usage", {
    "type": "object",
    "required": ["input_tokens", "output_tokens"],
    "properties": {
        "input_tokens": {"type": "integer", "minimum": 0},
        "output_tokens": {"type": "integer", "minimum": 0},
        "cost_estimate": {"type": "number", "minimum": 0},
    },
})

RESPONSE = _schema("core", "response", {
    "type": "object",
    "required": ["usage", "model_used"],
    "properties": {
        "content": {"type": "array", "items": CONTENT_PART},
        "tool_calls": {"type": "array", "items": {"type": "object"}},
        "usage": USAGE,
        "fallback_used": {"type": "boolean"},
        "model_used": {"type": "string"},
        "finish_reason": {"type": "string",
                          "enum": ["stop", "length", "tool_calls",
                                   "content_filter", "deadline_exceeded",
                                   "cancelled"]},
    },
})

STREAM_CHUNK = _schema("core", "stream_chunk", {
    "type": "object",
    "required": ["id", "model", "delta"],
    "properties": {
        "id": {"type": "string"},
        "model": {"type": "string"},
        "delta": {
            "type": "object",
            "additionalProperties": False,
            "properties": {
                "role": {"type": "string"},       # first chunk only
                "content": {"type": "string"},
                "tool_calls": {"type": "array", "items": {
                    "type": "object",
                    "required": ["index"],
                    "properties": {"index": {"type": "integer"},
                                   "id": {"type": "string"},
                                   "function": {"type": "object",
                                                "properties": {"name": {"type": "string"},
                                                               "arguments": {"type": "string"}}}},
                }},
            },
        },
        "finish_reason": {"type": ["string", "null"],
                          "enum": ["stop", "length", "tool_calls",
                                   "content_filter", "deadline_exceeded",
                                   "cancelled", None]},
        "usage": USAGE,   # final chunk only
    },
})

EMBEDDING_REQUEST = _schema("core", "embedding_request", {
    "type": "object",
    "required": ["model", "input"],
    "properties": {
        "model": {"type": "string"},
        "input": {"oneOf": [{"type": "string"},
                            {"type": "array", "minItems": 1,
                             "items": {"type": "string"}}]},
        "dimensions": {"type": "integer", "minimum": 1},
        "encoding_format": {"type": "string", "enum": ["float", "base64"],
                            "default": "float"},
    },
})
