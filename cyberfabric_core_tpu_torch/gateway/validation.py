"""Request-body JSON Schema validation (the port's copy of
``gateway/validation.py:26-56``) on the port's own checker.

:class:`SchemaChecker` implements the draft 2020-12 keywords the llm-gateway
schemas use (``type``, ``enum``, ``const``, ``required``, ``properties``,
``additionalProperties``, ``items``, ``minItems``, ``maxItems``,
``minLength``, ``minimum``, ``maximum``, ``exclusiveMinimum``, ``oneOf``;
``$schema``, ``$id`` and ``default`` are annotations). It walks a schema's
keywords in their order and reports each error at its instance path with
``jsonschema``'s message, so :func:`validate_against` raises the same 422
problem: ``errors[]`` of ``field`` and ``message``, sorted by path and
capped at 16. A schema with any other keyword is refused when the checker is
built, never skipped.
"""

from __future__ import annotations

import json
from collections.abc import Mapping, Sequence
from typing import Any, Iterator, Optional

from ..modkit.errcat import ERR
from ..modkit.errors import ProblemError

_ANNOTATIONS = frozenset({"$schema", "$id", "default"})
_SUBSCHEMA_KEYWORDS = ("properties", "items", "oneOf", "additionalProperties")


def _is_type(instance: Any, name: str) -> bool:
    if name == "object":
        return isinstance(instance, dict)
    if name == "array":
        return isinstance(instance, list)
    if name == "string":
        return isinstance(instance, str)
    if name == "boolean":
        return isinstance(instance, bool)
    if name == "null":
        return instance is None
    if isinstance(instance, bool):
        return False
    if name == "number":
        return isinstance(instance, (int, float))
    if name == "integer":
        return isinstance(instance, int) or (isinstance(instance, float)
                                             and instance.is_integer())
    raise ValueError(f"unknown JSON type {name!r}")


def _unbool(x: Any) -> Any:
    return ("\0bool", x) if isinstance(x, bool) else x


def _equal(a: Any, b: Any) -> bool:
    """JSON equality: booleans are not numbers, recursively."""
    if a is b:
        return True
    if isinstance(a, str) or isinstance(b, str):
        return a == b
    if isinstance(a, Sequence) and isinstance(b, Sequence):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, Mapping) and isinstance(b, Mapping):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    return _unbool(a) == _unbool(b)


class SchemaChecker:
    """Validates instances against one schema; built once per schema."""

    _KEYWORDS = frozenset({"type", "enum", "const", "required", "properties",
                           "additionalProperties", "items", "minItems", "maxItems",
                           "minLength", "minimum", "maximum", "exclusiveMinimum", "oneOf"})

    def __init__(self, schema: dict) -> None:
        self._check_keywords(schema)
        self.schema = schema

    def _check_keywords(self, schema: Any) -> None:
        if isinstance(schema, bool):
            return
        unknown = set(schema) - self._KEYWORDS - _ANNOTATIONS
        if unknown:
            raise ValueError(f"schema keywords not supported: {sorted(unknown)}")
        for sub in (schema.get("properties") or {}).values():
            self._check_keywords(sub)
        for key in ("items", "additionalProperties"):
            if isinstance(schema.get(key), dict):
                self._check_keywords(schema[key])
        for sub in schema.get("oneOf") or []:
            self._check_keywords(sub)

    def is_valid(self, instance: Any) -> bool:
        return next(self.iter_errors(instance), None) is None

    def iter_errors(self, instance: Any) -> Iterator[tuple[list, str]]:
        """(instance path, message) for every error, in keyword order."""
        yield from self._errors(instance, self.schema, [])

    def _errors(self, inst: Any, schema: Any, path: list) -> Iterator[tuple[list, str]]:
        if schema is True:
            return
        if schema is False:
            yield path, f"False schema does not allow {inst!r}"
            return
        for key, val in schema.items():
            if key in _ANNOTATIONS:
                continue
            yield from getattr(self, "_k_" + key)(inst, val, schema, path)

    # -- keywords, each with jsonschema's message
    def _k_type(self, inst, types, schema, path):
        types = types if isinstance(types, list) else [types]
        if not any(_is_type(inst, t) for t in types):
            yield path, f"{inst!r} is not of type {', '.join(repr(t) for t in types)}"

    def _k_enum(self, inst, enums, schema, path):
        if all(not _equal(e, inst) for e in enums):
            yield path, f"{inst!r} is not one of {enums!r}"

    def _k_const(self, inst, const, schema, path):
        if not _equal(inst, const):
            yield path, f"{const!r} was expected"

    def _k_required(self, inst, required, schema, path):
        if isinstance(inst, dict):
            for prop in required:
                if prop not in inst:
                    yield path, f"{prop!r} is a required property"

    def _k_properties(self, inst, props, schema, path):
        if isinstance(inst, dict):
            for prop, sub in props.items():
                if prop in inst:
                    yield from self._errors(inst[prop], sub, path + [prop])

    def _k_additionalProperties(self, inst, ap, schema, path):
        if not isinstance(inst, dict):
            return
        known = schema.get("properties") or {}
        extras = [k for k in inst if k not in known]
        if isinstance(ap, dict):
            for extra in extras:
                yield from self._errors(inst[extra], ap, path + [extra])
        elif not ap and extras:
            extras = sorted(set(extras), key=str)
            verb = "was" if len(extras) == 1 else "were"
            yield path, (f"Additional properties are not allowed "
                         f"({', '.join(repr(e) for e in extras)} {verb} unexpected)")

    def _k_items(self, inst, items, schema, path):
        if isinstance(inst, list):
            for i, item in enumerate(inst):
                yield from self._errors(item, items, path + [i])

    def _k_minItems(self, inst, n, schema, path):
        if isinstance(inst, list) and len(inst) < n:
            yield path, f"{inst!r} {'should be non-empty' if n == 1 else 'is too short'}"

    def _k_maxItems(self, inst, n, schema, path):
        if isinstance(inst, list) and len(inst) > n:
            yield path, f"{inst!r} {'is expected to be empty' if n == 0 else 'is too long'}"

    def _k_minLength(self, inst, n, schema, path):
        if isinstance(inst, str) and len(inst) < n:
            yield path, f"{inst!r} {'should be non-empty' if n == 1 else 'is too short'}"

    def _k_minimum(self, inst, m, schema, path):
        if _is_type(inst, "number") and inst < m:
            yield path, f"{inst!r} is less than the minimum of {m!r}"

    def _k_maximum(self, inst, m, schema, path):
        if _is_type(inst, "number") and inst > m:
            yield path, f"{inst!r} is greater than the maximum of {m!r}"

    def _k_exclusiveMinimum(self, inst, m, schema, path):
        if _is_type(inst, "number") and inst <= m:
            yield path, f"{inst!r} is less than or equal to the minimum of {m!r}"

    def _k_oneOf(self, inst, subs, schema, path):
        valid = [sub for sub in subs if next(self._errors(inst, sub, path), None) is None]
        if not valid:
            yield path, f"{inst!r} is not valid under any of the given schemas"
        elif len(valid) > 1:
            reprs = ", ".join(repr(s) for s in valid[1:] + valid[:1])
            yield path, f"{inst!r} is valid under each of {reprs}"


#: schema id → (schema, checker): the route schemas are static
_CHECKERS: dict[int, tuple[dict, SchemaChecker]] = {}


def checker_for(schema: dict) -> SchemaChecker:
    entry = _CHECKERS.get(id(schema))
    if entry is None or entry[0] is not schema:
        entry = (schema, SchemaChecker(schema))
        _CHECKERS[id(schema)] = entry
    return entry[1]


def validate_against(schema: dict, payload: Any) -> None:
    """Raises a 422 problem with an ``errors[]`` field list."""
    errors = sorted(checker_for(schema).iter_errors(payload), key=lambda e: e[0])
    if errors:
        raise ProblemError.unprocessable(
            "request body failed schema validation",
            errors=[{"field": "/".join(str(p) for p in path) or "<root>",
                     "message": message[:300]}
                    for path, message in errors[:16]])


def read_json(body: bytes, schema: Optional[dict] = None) -> Any:
    """The request body as JSON (400 ``malformed_json`` when it is not),
    validated against ``schema``."""
    try:
        payload = json.loads(body.decode("utf-8"))
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise ERR.core.malformed_json.error(f"malformed JSON body: {e}")
    if schema is not None:
        validate_against(schema, payload)
    return payload
