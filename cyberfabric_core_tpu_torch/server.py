"""The port's serving entry point (counterpart of ``server.py:27-123``).

    python -m cyberfabric_core_tpu_torch.server run --config cyberfabric_core_tpu_torch/config/quickstart.json

boots one HTTP host serving ``POST /v1/chat/completions``,
``POST /v1/completions`` (sync and SSE), ``POST /v1/embeddings``,
``GET /v1/models``, ``GET /health``, ``/healthz`` and ``/readyz``, and with
the ``monitoring`` module ``GET /metrics`` and ``/v1/monitoring/*``; prints
``listening on http://HOST:PORT`` once it accepts connections, and stops
gracefully on SIGINT or SIGTERM (exit code 0).

The config is JSON: ``server`` (``home_dir`` only: where device traces
go), ``logging``, ``tracing`` (``enabled``, ``sample_ratio``,
``otlp_endpoint``, ``service_name``; without the section tracing is off) and
``modules`` with the quickstart's ``api_gateway``, ``tenant_resolver``,
``authn_resolver``, ``model_registry``, ``llm_gateway``, ``monitoring`` and
``grpc_hub`` sections (:class:`Host` checks them). Engines run on the CUDA
card unless ``llm_gateway.config.worker.device`` says ``cpu``; without a
card the first engine build raises. Any other module or key raises at boot,
naming the ROADMAP item that brings it.

A federated gateway runs ``grpc_hub`` with
``llm_gateway.config.federation.enabled`` and holds no engine: worker hosts
(``python -m cyberfabric_core_tpu_torch.modules.llm_gateway.worker`` with
``FED_WORKER_CONFIG``) announce themselves to the hub's endpoint
(``Host.hub.endpoint``) and serve the requests the gateway routes to them.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import signal
import sys
import threading
from pathlib import Path
from typing import Any, Optional, Sequence

from .gateway.module import ApiGateway, GatewayConfig
from .gateway.router import RestRouter
from .modkit.telemetry import Tracer, set_global_tracer, tracer_from_config
from .modules.grpc_hub import GrpcHubModule
from .modules.llm_gateway.module import LlmGatewayModule, build_worker
from .modules.model_registry import ModelRegistry
from .modules.monitoring import MonitoringModule

logger = logging.getLogger("server")

QUICKSTART = Path(__file__).parent / "config" / "quickstart.json"

#: modules of the JAX host's configs the port does not serve, by ROADMAP item
_UNPORTED_MODULES = {
    "authz_resolver": "15 (auth modes)",
    "types_registry": "17 (the other host modules)",
    "types": "17 (the other host modules)",
    "module_orchestrator": "17 (the other host modules)",
    "nodes_registry": "17 (the other host modules)",
    "file_storage": "17 (the other host modules)",
    "credstore": "17 (the other host modules)",
    "oagw": "17 (the other host modules)",
    "file_parser": "17 (the other host modules)",
    "serverless_runtime": "17 (the other host modules)",
    "user_settings": "17 (the other host modules)",
}
TRACING_KEYS = frozenset({"enabled", "sample_ratio", "otlp_endpoint", "service_name"})


def _home_dir(raw: Any) -> Path:
    """``server.home_dir`` (default ``~/.tpu-fabric``); its other keys
    configure the host modules the port does not serve yet."""
    raw = dict(raw or {})
    for key in raw:
        if key != "home_dir":
            raise ValueError(f"server config: {key!r} is not served by the port yet "
                             "(ROADMAP queue 1 item 17: the other host modules)")
    return Path(raw.get("home_dir", "~/.tpu-fabric")).expanduser()


def _tracer(raw: Any) -> Tracer:
    """The ``tracing`` section's tracer; no section at all is tracing off
    (an unconfigured ratio-1.0 tracer would sample every request and pay
    the decode loop's span emits for no exporter)."""
    if not raw:
        return Tracer(enabled=False)
    unknown = sorted(set(raw) - TRACING_KEYS)
    if unknown:
        raise ValueError(f"tracing config: unknown keys {unknown}")
    return tracer_from_config(dict(raw))


def _section(modules: dict[str, Any], name: str) -> dict[str, Any]:
    raw = modules.get(name) or {}
    unknown = sorted(set(raw) - {"config"})
    if unknown:
        raise ValueError(f"modules.{name}: unknown keys {unknown}")
    return dict(raw.get("config") or {})


def _tenant(modules: dict[str, Any], gateway: GatewayConfig) -> str:
    """The one tenant every request runs as: ``tenant_resolver.single_tenant``
    (else the gateway's ``default_tenant``)."""
    tr = _section(modules, "tenant_resolver")
    for key in tr:
        if key != "single_tenant":
            raise ValueError(f"tenant_resolver config: {key!r} is not ported yet "
                             "(ROADMAP queue 1 item 15: tenant hierarchy and auth modes)")
    authn = _section(modules, "authn_resolver")
    for key, value in authn.items():
        if key not in ("mode", "default_tenant") or (key == "mode" and value != "accept_all"):
            raise ValueError(f"authn_resolver config: {key}={value!r} is not ported yet "
                             "(ROADMAP queue 1 item 15: auth modes)")
    return str(tr.get("single_tenant", gateway.default_tenant))


class Host:
    """The assembled host: registry, worker, llm-gateway handlers, the HTTP
    server and, with ``grpc_hub``, the gRPC hub. Raises on a module or key the
    port does not serve; nothing is bound or built until :meth:`start` and
    the first request."""

    def __init__(self, config: dict[str, Any]) -> None:
        for key in config:
            if key not in ("server", "logging", "tracing", "modules"):
                raise ValueError(f"unknown config section {key!r}")
        modules = dict(config.get("modules") or {})
        for name in modules:
            if name in _UNPORTED_MODULES:
                raise ValueError(f"module {name!r} is not served by the port yet "
                                 f"(ROADMAP queue 1 item {_UNPORTED_MODULES[name]})")
            if name not in ("api_gateway", "tenant_resolver", "authn_resolver",
                            "model_registry", "llm_gateway", "monitoring", "grpc_hub"):
                raise ValueError(f"unknown module {name!r}")
        home_dir = _home_dir(config.get("server"))
        gw_cfg = GatewayConfig.from_config(_section(modules, "api_gateway"))
        tenant = _tenant(modules, gw_cfg)
        # the scheduler threads and pools emit their llm.* spans through the
        # global tracer: one exporter covers HTTP → tokens
        self.tracer = set_global_tracer(_tracer(config.get("tracing")))
        self.registry = ModelRegistry(_section(modules, "model_registry"))
        self.hub: Optional[GrpcHubModule] = None
        if "grpc_hub" in modules:
            self.hub = GrpcHubModule(_section(modules, "grpc_hub"))
        workers = self._worker_registry
        llm_cfg = _section(modules, "llm_gateway")
        if (llm_cfg.get("worker_service") or {}).get("expose") and self.hub is None:
            raise ValueError("llm_gateway config: worker_service.expose needs the grpc_hub "
                             "module")
        self.worker = build_worker(llm_cfg, workers)
        self.llm = LlmGatewayModule(llm_cfg, self.registry, self.worker)
        if self.hub is not None:
            self.llm.register_grpc(self.hub.server, llm_cfg)
        router = RestRouter()
        self.llm.register_rest(router)
        self.monitoring: Optional[MonitoringModule] = None
        if "monitoring" in modules:
            self.monitoring = MonitoringModule(_section(modules, "monitoring"),
                                               self.worker, home_dir, workers=workers)
            self.monitoring.register_rest(router)
            # only a host that runs the doctor sheds
            self.llm.doctor = self.monitoring.doctor
        self.gateway = ApiGateway(gw_cfg, router, tenant, self._health, self.tracer)

    async def _health(self) -> dict[str, Any]:
        return {"status": "ok", "worker": await self.worker.health()}

    def _worker_registry(self) -> Any:
        """The federation's worker registry (None without the hub)."""
        return self.hub.registry if self.hub is not None else None

    @property
    def port(self) -> Optional[int]:
        return self.gateway.bound_port

    async def start(self) -> None:
        """The hub first (workers dial it; the pool routes over it), then the
        HTTP server; a boot that fails after the hub started stops it."""
        if self.hub is not None:
            await self.hub.start()
        try:
            await self.gateway.start()
        except BaseException:
            if self.hub is not None:
                await self.hub.stop()
            raise
        if self.monitoring is not None:
            self.monitoring.start()

    async def stop(self) -> None:
        """Stop accepting, let requests in progress finish (a few seconds),
        then retire the doctor, the engines (or the remote workers'
        clients) and the hub."""
        await self.gateway.stop()
        if self.monitoring is not None:
            self.monitoring.stop()
        self.llm.stop()
        close = self.worker.close
        if asyncio.iscoroutinefunction(close):
            await close()
        else:
            await asyncio.get_running_loop().run_in_executor(None, close)
        if self.hub is not None:
            await self.hub.stop()


class BackgroundServer:
    """A host on an event loop of its own, in a daemon thread: for callers
    that are not async (scripts, tests). ``port`` once started;
    :meth:`stop` stops the host and the loop."""

    def __init__(self, config: dict[str, Any]) -> None:
        self.host = Host(config)
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(target=self._loop.run_forever,
                                        name="http-host", daemon=True)

    def start(self, timeout: float = 30.0) -> "BackgroundServer":
        self._thread.start()
        asyncio.run_coroutine_threadsafe(self.host.start(), self._loop).result(timeout)
        return self

    @property
    def port(self) -> int:
        return int(self.host.port)

    def stop(self, timeout: float = 60.0) -> None:
        try:
            asyncio.run_coroutine_threadsafe(self.host.stop(), self._loop).result(timeout)
        finally:
            self._loop.call_soon_threadsafe(self._loop.stop)
            self._thread.join(timeout)
            self._loop.close()


async def serve(host: Host) -> None:
    """Run ``host`` until SIGINT or SIGTERM, then stop it."""
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGINT, signal.SIGTERM):
        loop.add_signal_handler(sig, stop.set)
    await host.start()
    print(f"listening on http://{host.gateway.config.bind_addr.rpartition(':')[0]}:"
          f"{host.port}", flush=True)
    try:
        await stop.wait()
    finally:
        logger.info("stopping")
        await host.stop()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m cyberfabric_core_tpu_torch.server",
                                description="The PyTorch/CUDA port's serving host")
    p.add_argument("command", choices=["run"], nargs="?", default="run")
    p.add_argument("--config", "-c", default=str(QUICKSTART), help="JSON config path")
    p.add_argument("--log-level", default=None)
    return p


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        config = json.loads(Path(args.config).read_text())
        host = Host(config)  # checks the whole config before anything starts
    except (OSError, ValueError) as e:
        print(f"config error: {e}", file=sys.stderr)
        return 2
    level = args.log_level or (config.get("logging") or {}).get("level", "info")
    logging.basicConfig(level=str(level).upper(),
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(serve(host))
    return 0


if __name__ == "__main__":
    sys.exit(main())
