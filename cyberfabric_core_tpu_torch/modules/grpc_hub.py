"""grpc-hub: the host's one gRPC server, serving the directory and the
federation's worker registry (the port's copy of ``modules/grpc_hub.py``).

Remote worker processes announce themselves over
``fabricfed.v1.WorkerRegistry`` (JSON over gRPC: the census is an
open-world gossip dict), heartbeat a capacity / model / prefix census, and
are evicted by the same tick that sweeps stale directory instances
(``eviction_interval_s``; a worker silent for ``worker_lease_ttl_s`` loses
its lease). The gateway's :class:`..runtime.federation.FederatedServingPool`
routes over :attr:`GrpcHubModule.registry`. ``worker_auth_token`` makes the
registry require ``authorization: Bearer <token>``.

The port's :class:`..server.Host` starts the hub before the gateway and
stops it after (and on a boot that fails after it started).
"""

from __future__ import annotations

import asyncio
import dataclasses
import logging
from dataclasses import dataclass
from typing import Any, Optional

from ..modkit.failpoints import failpoint
from ..modkit.transport_grpc import (DIRECTORY_SERVICE, DirectoryService, JsonGrpcClient,
                                     JsonGrpcServer, directory_codecs)
from ..runtime.federation import WorkerRegistry

logger = logging.getLogger("grpc_hub")

#: the federation's worker-plane control service
WORKER_REGISTRY_SERVICE = "fabricfed.v1.WorkerRegistry"


@dataclass
class GrpcHubConfig:
    bind_addr: str = "127.0.0.1:0"
    heartbeat_ttl_s: float = 15.0
    eviction_interval_s: float = 5.0
    #: a worker that misses heartbeats this long is evicted from the registry
    worker_lease_ttl_s: float = 10.0


def register_worker_registry_service(server: JsonGrpcServer, registry: WorkerRegistry,
                                     auth_token: Optional[str] = None) -> None:
    """Expose ``registry`` as fabricfed.v1.WorkerRegistry: Announce /
    Heartbeat / Withdraw / ListWorkers. Heartbeat answers ``registered:
    false`` for an unknown instance (evicted, or the hub restarted), and the
    worker announces again."""

    async def announce(req: dict) -> dict:
        return registry.announce(req)

    async def heartbeat(req: dict) -> dict:
        ok = registry.heartbeat(str(req.get("instance_id", "")), req.get("census") or None)
        return {"registered": ok}

    async def withdraw(req: dict) -> dict:
        return {"ok": registry.withdraw(str(req.get("instance_id", "")))}

    async def list_workers(_req: dict) -> dict:
        return registry.rows()

    server.add_service(WORKER_REGISTRY_SERVICE, {
        "Announce": announce, "Heartbeat": heartbeat,
        "Withdraw": withdraw, "ListWorkers": list_workers,
    }, auth_token=auth_token)


class WorkerRegistryClient:
    """The worker's half of the lease protocol: what a
    ``python -m ...llm_gateway.worker`` process dials back to the hub."""

    def __init__(self, endpoint: str, auth_token: Optional[str] = None) -> None:
        self._client = JsonGrpcClient(endpoint, auth_token=auth_token)

    async def announce(self, info: dict[str, Any]) -> dict[str, Any]:
        return await self._client.call(WORKER_REGISTRY_SERVICE, "Announce", info)

    async def heartbeat(self, instance_id: str,
                        census: Optional[dict[str, Any]] = None) -> bool:
        resp = await self._client.call(WORKER_REGISTRY_SERVICE, "Heartbeat",
                                       {"instance_id": instance_id, "census": census or {}})
        return bool(resp.get("registered"))

    async def withdraw(self, instance_id: str) -> bool:
        resp = await self._client.call(WORKER_REGISTRY_SERVICE, "Withdraw",
                                       {"instance_id": instance_id})
        return bool(resp.get("ok"))

    async def list_workers(self) -> dict[str, Any]:
        return await self._client.call(WORKER_REGISTRY_SERVICE, "ListWorkers", {})

    async def close(self) -> None:
        await self._client.close()


class GrpcHubModule:
    """``config`` is the ``grpc_hub`` module's ``config`` section. The
    server, the directory and the registry exist from construction, so the
    llm-gateway can register its worker service before :meth:`start`."""

    def __init__(self, config: Optional[dict[str, Any]] = None) -> None:
        raw = dict(config or {})
        worker_auth = raw.pop("worker_auth_token", None)
        known = {f.name for f in dataclasses.fields(GrpcHubConfig)}
        unknown = sorted(set(raw) - known)
        if unknown:
            raise ValueError(f"grpc_hub config: unknown keys {unknown}")
        self.config = GrpcHubConfig(**raw)
        self.server = JsonGrpcServer()
        self.directory = DirectoryService(self.config.heartbeat_ttl_s)
        self.registry = WorkerRegistry(lease_ttl_s=self.config.worker_lease_ttl_s)
        self.server.add_service(DIRECTORY_SERVICE, self.directory.rpc_handlers(),
                                codecs=directory_codecs())
        register_worker_registry_service(self.server, self.registry, auth_token=worker_auth)
        self.bound_port: Optional[int] = None
        #: where workers dial the hub (``host:port``, or the unix socket)
        self.endpoint: Optional[str] = None
        self._evict_task: Optional[asyncio.Task] = None

    async def start(self) -> None:
        self.bound_port = await self.server.start(self.config.bind_addr)
        if self.config.bind_addr.startswith(("unix:", "unix-abstract:")):
            self.endpoint = self.config.bind_addr
        else:
            host = self.config.bind_addr.rsplit(":", 1)[0] or "127.0.0.1"
            self.endpoint = f"{host}:{self.bound_port}"
        self._evict_task = asyncio.ensure_future(self._evict_loop())

    async def _evict_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.eviction_interval_s)
            try:
                self._evict_tick()
            except Exception:  # noqa: BLE001 — a bad tick must not end eviction
                logger.exception("evict tick failed")

    def _evict_tick(self) -> None:
        """One sweep: stale directory instances and expired worker leases
        (a lost host is lost capacity, visible to the doctor and
        /v1/monitoring/workers within one tick)."""
        failpoint("grpc_hub.evict")
        self.directory.evict_stale()
        self.registry.evict_expired()

    async def stop(self) -> None:
        if self._evict_task is not None:
            self._evict_task.cancel()
            try:
                await self._evict_task
            except asyncio.CancelledError:
                pass
            self._evict_task = None
        await self.server.stop()
