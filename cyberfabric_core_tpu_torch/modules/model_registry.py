"""The model registry, seeded from config (the port's copy of the read side
of ``modules/model_registry.py:209-324``).

Models are keyed by their canonical id ``slug::id``; names resolve through
the alias chain (cycle-guarded, at most 8 hops), then by canonical id, then
by a bare ``provider_model_id`` when it is unambiguous. A model that is not
approved is refused (403), one retired or disabled is not found (404).
There is no database and no tenant hierarchy: every tenant sees the one
seeded catalog, and a config key that needs more raises at boot.
"""

from __future__ import annotations

from typing import Any

from ..modkit.errcat import ERR
from ..modkit.errors import ProblemError
from ..modkit.security import SecurityContext
from .sdk import ModelInfo, ModelRegistryApi

#: model keys a seeded entry may carry (the JAX registry's row fields)
MODEL_KEYS = frozenset({
    "provider_slug", "provider_model_id", "display_name", "capabilities", "limits",
    "cost", "lifecycle_status", "approval_state", "managed", "architecture",
    "size_bytes", "format", "checkpoint_path", "engine_options"})
#: registry keys of the JAX module the port leaves out, and where they come
_UNPORTED = {
    "seed_tenant": "ROADMAP queue 1 item 15 (tenant hierarchy and auth modes)",
    "auto_approval_rules": "ROADMAP queue 1 item 15 (registry store and approval rules)",
    "shadowable": "ROADMAP queue 1 item 15 (tenant hierarchy and auth modes)",
}


def _unported(where: str, key: str) -> ValueError:
    item = _UNPORTED.get(key, "no ROADMAP item: not a key of the JAX registry")
    return ValueError(f"{where}: {key!r} is not served by the port ({item})")


class ModelRegistry(ModelRegistryApi):
    """Resolution over the models and aliases of the config section."""

    def __init__(self, config: dict[str, Any]) -> None:
        for key in config:
            if key not in ("models", "aliases"):
                raise _unported("model_registry config", key)
        self._models: dict[str, dict[str, Any]] = {}
        for spec in config.get("models") or []:
            self.register(dict(spec))
        self._aliases: dict[str, str] = {str(k): str(v)
                                         for k, v in (config.get("aliases") or {}).items()}

    def register(self, spec: dict[str, Any]) -> ModelInfo:
        for key in spec:
            if key not in MODEL_KEYS:
                raise _unported("model_registry model", key)
        missing = [k for k in ("provider_slug", "provider_model_id") if not spec.get(k)]
        if missing:
            raise ValueError(f"model_registry model: missing fields {missing}")
        canonical = f"{spec['provider_slug']}::{spec['provider_model_id']}"
        if canonical in self._models:
            raise ValueError(f"model {canonical} already registered")
        row = {
            "provider_slug": spec["provider_slug"],
            "provider_model_id": spec["provider_model_id"],
            "canonical_id": canonical,
            "display_name": spec.get("display_name", canonical),
            "capabilities": spec.get("capabilities", {}),
            "limits": spec.get("limits", {}),
            "cost": spec.get("cost", {}),
            "lifecycle_status": spec.get("lifecycle_status", "active"),
            "approval_state": spec.get("approval_state", "pending"),
            "managed": bool(spec.get("managed", False)),
            "architecture": spec.get("architecture"),
            "size_bytes": spec.get("size_bytes"),
            "format": spec.get("format"),
            "checkpoint_path": spec.get("checkpoint_path"),
            "engine_options": spec.get("engine_options", {}),
        }
        self._models[canonical] = row
        return self._to_info(row)

    async def resolve(self, ctx: SecurityContext, name: str) -> ModelInfo:
        seen: set[str] = set()
        target = name
        for _ in range(8):
            if target in seen:
                raise ERR.model_registry.alias_cycle.error(f"alias cycle at {target!r}")
            seen.add(target)
            if target not in self._aliases:
                break
            target = self._aliases[target]
        row = self._models.get(target)
        if row is None:
            candidates = [r for r in self._models.values()
                          if r["provider_model_id"] == target]
            if len(candidates) == 1:
                row = candidates[0]
        if row is None:
            raise ERR.model_registry.model_not_found.error(f"model {name!r} not found")
        if row["approval_state"] != "approved":
            raise ProblemError.forbidden(
                f"model {row['canonical_id']} is not approved "
                f"(state: {row['approval_state']})")
        if row["lifecycle_status"] in ("retired", "disabled"):
            raise ProblemError.not_found(
                f"model {row['canonical_id']} is {row['lifecycle_status']}")
        return self._to_info(row)

    async def list_models(self, ctx: SecurityContext) -> list[ModelInfo]:
        return [self._to_info(self._models[k]) for k in sorted(self._models)]

    @staticmethod
    def _to_info(row: dict[str, Any]) -> ModelInfo:
        return ModelInfo(
            canonical_id=row["canonical_id"],
            provider_slug=row["provider_slug"],
            provider_model_id=row["provider_model_id"],
            display_name=row.get("display_name") or row["canonical_id"],
            capabilities=row.get("capabilities") or {},
            limits=row.get("limits") or {},
            cost=row.get("cost") or {},
            lifecycle_status=row.get("lifecycle_status", "active"),
            approval_state=row.get("approval_state", "pending"),
            managed=bool(row.get("managed")),
            architecture=row.get("architecture"),
            size_bytes=row.get("size_bytes"),
            format=row.get("format"),
            checkpoint_path=row.get("checkpoint_path"),
            engine_options=dict(row.get("engine_options") or {}),
        )
