"""The security context a request carries (the port's copy of the part of
``modkit/security.py`` its chat path reads): the tenant that keys the
engine's fair queue. The port serves with authentication disabled, so every
context is the anonymous one of the configured single tenant."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class SecurityContext:
    tenant_id: str

    @classmethod
    def anonymous(cls, tenant_id: str = "default") -> "SecurityContext":
        return cls(tenant_id=tenant_id)
