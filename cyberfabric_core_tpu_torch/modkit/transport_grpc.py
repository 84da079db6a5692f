"""gRPC transport (the port's copy of ``modkit/transport_grpc.py``).

Module services speak JSON over gRPC through generic handlers registered at
run time; the directory plane and the llm-worker plane speak protobuf from
the committed stubs under :mod:`.gen` (``directory.v1`` and
``llmworker.v1``, byte-identical to the JAX package's, so a JAX gateway and
a port worker share one wire). Handlers keep their dict signatures: a
per-method :class:`ProtoCodec` converts protobuf and dicts at the wire.
Servers and clients are ``grpc.aio``.

A handler's :class:`..errors.ProblemError` aborts the call with a status
mapped from its HTTP status and the problem serialized in the details, and
the client re-raises it as the same problem (:func:`raise_remote_problem`):
a remote worker's 422 reads as a 422, not as a transport failure. The
``x-request-id`` and ``traceparent`` metadata reach a handler as
``req["_grpc_metadata"]``.
"""

from __future__ import annotations

import asyncio
import hmac
import json
import logging
import time
import uuid
from dataclasses import dataclass, field
from typing import Any, Awaitable, Callable, Optional

import grpc
from grpc import aio as grpc_aio

from .errors import Problem, ProblemError

logger = logging.getLogger("transport_grpc")

Handler = Callable[[dict], Awaitable[dict]]
#: server-streaming handler: request dict → async iterator of chunk dicts
StreamHandler = Callable[[dict], Any]

#: tracing metadata keys the server hands to handlers
_TRACE_METADATA_KEYS = ("x-request-id", "traceparent")

#: the abort details' prefix that marks a serialized RFC-9457 problem
_PROBLEM_MARK = "problem+json:"

_STATUS_TO_GRPC = {
    400: grpc.StatusCode.INVALID_ARGUMENT,
    401: grpc.StatusCode.UNAUTHENTICATED,
    403: grpc.StatusCode.PERMISSION_DENIED,
    404: grpc.StatusCode.NOT_FOUND,
    409: grpc.StatusCode.ABORTED,
    422: grpc.StatusCode.INVALID_ARGUMENT,
    429: grpc.StatusCode.RESOURCE_EXHAUSTED,
    503: grpc.StatusCode.UNAVAILABLE,
    504: grpc.StatusCode.DEADLINE_EXCEEDED,
}


async def _abort_problem(context: Any, exc: ProblemError) -> None:
    problem = exc.problem
    await context.abort(_STATUS_TO_GRPC.get(problem.status, grpc.StatusCode.INTERNAL),
                        _PROBLEM_MARK + json.dumps(problem.to_dict()))


def raise_remote_problem(e: grpc_aio.AioRpcError) -> None:
    """Re-raise a serialized server problem as a :class:`ProblemError`;
    return for any other failure (the caller re-raises the RPC error)."""
    details = e.details() or ""
    if details.startswith(_PROBLEM_MARK):
        raise ProblemError(Problem.from_dict(json.loads(details[len(_PROBLEM_MARK):]))) from e


def _inject_trace_metadata(req: dict, context: Any) -> None:
    """The tracing headers into ``req["_grpc_metadata"]``; never raises
    (tracing metadata must not fail an RPC)."""
    try:
        meta = dict(context.invocation_metadata() or ())
        picked = {k: meta[k] for k in _TRACE_METADATA_KEYS if meta.get(k)}
        if picked:
            req["_grpc_metadata"] = picked
    except Exception:  # noqa: BLE001
        pass


def _ser(obj: dict) -> bytes:
    return json.dumps(obj, separators=(",", ":")).encode()


def _de(data: bytes) -> dict:
    return json.loads(data.decode()) if data else {}


@dataclass(frozen=True)
class ProtoCodec:
    """Per-method protobuf codec: handlers stay dict-shaped, the wire is the
    generated message types (snake_case field names both ways)."""

    request_cls: Any
    response_cls: Any

    @staticmethod
    def _to_dict(msg: Any) -> dict:
        from google.protobuf.json_format import MessageToDict

        # defaults materialize (ok=false, empty lists): callers index them
        return MessageToDict(msg, preserving_proto_field_name=True,
                             always_print_fields_with_no_presence=True)

    @staticmethod
    def _encode(obj: dict, cls: Any) -> bytes:
        from google.protobuf.json_format import ParseDict

        return ParseDict({k: v for k, v in obj.items() if v is not None},
                         cls()).SerializeToString()

    def decode_request(self, data: bytes) -> dict:
        return self._to_dict(self.request_cls.FromString(data))

    def encode_request(self, obj: dict) -> bytes:
        return self._encode(obj, self.request_cls)

    def decode_response(self, data: bytes) -> dict:
        return self._to_dict(self.response_cls.FromString(data))

    def encode_response(self, obj: dict) -> bytes:
        return self._encode(obj, self.response_cls)


def directory_codecs() -> dict[str, ProtoCodec]:
    """Codecs for the five DirectoryService methods."""
    from .gen.directory.v1 import directory_pb2 as pb

    return {
        "RegisterInstance": ProtoCodec(pb.RegisterInstanceRequest, pb.RegisterInstanceResponse),
        "DeregisterInstance": ProtoCodec(pb.InstanceRef, pb.Ack),
        "Heartbeat": ProtoCodec(pb.InstanceRef, pb.Ack),
        "ResolveGrpcService": ProtoCodec(pb.ResolveRequest, pb.InstanceInfo),
        "ListInstances": ProtoCodec(pb.ListRequest, pb.ListResponse),
    }


def llm_worker_codecs() -> dict[str, ProtoCodec]:
    """LlmWorkerService codecs; a streaming method's response class encodes
    each chunk."""
    from .gen.llmworker.v1 import llm_worker_pb2 as pb

    return {
        "ChatStream": ProtoCodec(pb.ChatRequest, pb.StreamChunk),
        "Completion": ProtoCodec(pb.CompletionRequest, pb.StreamChunk),
        "Embed": ProtoCodec(pb.EmbedRequest, pb.EmbedResponse),
        "Health": ProtoCodec(pb.HealthRequest, pb.HealthResponse),
    }


class JsonGrpcServer:
    """A ``grpc.aio`` server hosting services registered at run time."""

    def __init__(self) -> None:
        self._services: dict[str, dict[str, Handler]] = {}
        self._streams: dict[str, dict[str, StreamHandler]] = {}
        self._codecs: dict[str, dict[str, ProtoCodec]] = {}
        self._auth_tokens: dict[str, str] = {}
        self._server: Optional[grpc_aio.Server] = None
        self.bound_port: Optional[int] = None

    async def _check_auth(self, service_name: str, context: Any) -> None:
        want = self._auth_tokens.get(service_name)
        if want is None:
            return
        meta = dict(context.invocation_metadata() or ())
        # constant-time: the worker plane may bind beyond loopback
        if not hmac.compare_digest(meta.get("authorization", ""), f"Bearer {want}"):
            await context.abort(grpc.StatusCode.UNAUTHENTICATED,
                                f"{service_name} requires a bearer token")

    def service_names(self) -> list[str]:
        return sorted(set(self._services) | set(self._streams))

    def add_service(self, service_name: str, methods: dict[str, Handler],
                    codecs: Optional[dict[str, ProtoCodec]] = None,
                    streams: Optional[dict[str, StreamHandler]] = None,
                    auth_token: Optional[str] = None) -> None:
        """``streams``: server-streaming methods (async generators of chunk
        dicts). ``auth_token``: every call needs ``authorization: Bearer
        <token>`` metadata (UNAUTHENTICATED otherwise)."""
        self._services.setdefault(service_name, {}).update(methods)
        if streams:
            self._streams.setdefault(service_name, {}).update(streams)
        if codecs:
            self._codecs.setdefault(service_name, {}).update(codecs)
        if auth_token:
            self._auth_tokens[service_name] = auth_token

    async def _abort_for(self, context: Any, e: Exception, where: str) -> None:
        """A handler's exception as the call's status: a problem keeps its
        document, KeyError is NOT_FOUND, ValueError INVALID_ARGUMENT, the rest
        INTERNAL (logged)."""
        if isinstance(e, ProblemError):
            await _abort_problem(context, e)
        elif isinstance(e, KeyError):
            await context.abort(grpc.StatusCode.NOT_FOUND, str(e))
        elif isinstance(e, ValueError):
            await context.abort(grpc.StatusCode.INVALID_ARGUMENT, str(e))
        else:
            logger.exception("rpc %s failed", where)
            await context.abort(grpc.StatusCode.INTERNAL, str(e)[:300])

    def _build(self) -> grpc_aio.Server:
        server = grpc_aio.server()
        for service_name in self.service_names():
            handlers = {}
            codecs = self._codecs.get(service_name, {})
            for method_name, fn in self._services.get(service_name, {}).items():
                async def unary(request: bytes, context: Any, _fn=fn,
                                _codec=codecs.get(method_name), _sn=service_name,
                                _mn=method_name) -> bytes:
                    try:
                        await self._check_auth(_sn, context)
                        req = _codec.decode_request(request) if _codec else _de(request)
                        _inject_trace_metadata(req, context)
                        out = await _fn(req)
                        return _codec.encode_response(out) if _codec else _ser(out)
                    except grpc_aio.AbortError:
                        raise  # auth (or a nested abort) already ended the call
                    except Exception as e:  # noqa: BLE001 — mapped to the call's status
                        await self._abort_for(context, e, f"{_sn}/{_mn}")

                handlers[method_name] = grpc.unary_unary_rpc_method_handler(
                    unary, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)
            for method_name, gen in self._streams.get(service_name, {}).items():
                async def stream(request: bytes, context: Any, _gen=gen,
                                 _codec=codecs.get(method_name), _sn=service_name,
                                 _mn=method_name):
                    try:
                        await self._check_auth(_sn, context)
                        req = _codec.decode_request(request) if _codec else _de(request)
                        _inject_trace_metadata(req, context)
                        async for chunk in _gen(req):
                            yield _codec.encode_response(chunk) if _codec else _ser(chunk)
                    except grpc_aio.AbortError:
                        raise
                    except Exception as e:  # noqa: BLE001 — mapped to the call's status
                        await self._abort_for(context, e, f"{_sn}/{_mn} (stream)")

                handlers[method_name] = grpc.unary_stream_rpc_method_handler(
                    stream, request_deserializer=lambda b: b,
                    response_serializer=lambda b: b)
            server.add_generic_rpc_handlers(
                (grpc.method_handlers_generic_handler(service_name, handlers),))
        return server

    async def start(self, bind_addr: str = "127.0.0.1:0") -> int:
        """Bind ``host:port`` (or a ``unix:`` socket, whose endpoint is the
        address itself) and serve; returns the bound port."""
        self._server = self._build()
        self.bound_port = self._server.add_insecure_port(bind_addr)
        if self.bound_port == 0:
            raise RuntimeError(f"failed to bind gRPC on {bind_addr}")
        await self._server.start()
        return self.bound_port

    async def stop(self, grace: float = 3.0) -> None:
        if self._server is not None:
            await self._server.stop(grace)
            self._server = None


@dataclass
class GrpcClientConfig:
    """Connect and call policy."""

    connect_timeout_s: float = 5.0
    call_timeout_s: float = 30.0
    #: a server stream's deadline covers the whole stream, so it must
    #: outlast the longest generation; None: no deadline
    stream_timeout_s: Optional[float] = 900.0
    max_retries: int = 3
    retry_backoff_s: float = 0.1
    backoff_multiplier: float = 2.0


class JsonGrpcClient:
    """A channel with unary calls retried on UNAVAILABLE and
    DEADLINE_EXCEEDED (with backoff) and server-streaming calls (never
    retried: a replayed half-consumed stream would duplicate output)."""

    _RETRYABLE = {grpc.StatusCode.UNAVAILABLE, grpc.StatusCode.DEADLINE_EXCEEDED}

    def __init__(self, target: str, config: Optional[GrpcClientConfig] = None,
                 auth_token: Optional[str] = None) -> None:
        self.target = target
        self.config = config or GrpcClientConfig()
        self._channel: Optional[grpc_aio.Channel] = None
        self._metadata = ((("authorization", f"Bearer {auth_token}"),)
                          if auth_token else None)

    def _ensure_channel(self) -> grpc_aio.Channel:
        if self._channel is None:
            self._channel = grpc_aio.insecure_channel(self.target)
        return self._channel

    def _merged_metadata(self, extra: Optional[tuple]) -> Optional[tuple]:
        if not extra:
            return self._metadata
        return tuple(self._metadata or ()) + tuple(extra)

    async def call(self, service: str, method: str, payload: dict,
                   codec: Optional[ProtoCodec] = None,
                   metadata: Optional[tuple] = None) -> dict:
        rpc = self._ensure_channel().unary_unary(
            f"/{service}/{method}", request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        wire = codec.encode_request(payload) if codec else _ser(payload)
        md = self._merged_metadata(metadata)
        delay = self.config.retry_backoff_s
        for attempt in range(self.config.max_retries + 1):
            try:
                resp = await rpc(wire, timeout=self.config.call_timeout_s, metadata=md)
                return codec.decode_response(resp) if codec else _de(resp)
            except grpc_aio.AioRpcError as e:
                raise_remote_problem(e)
                if e.code() not in self._RETRYABLE or attempt == self.config.max_retries:
                    raise
                await asyncio.sleep(delay)
                delay *= self.config.backoff_multiplier
        raise AssertionError("unreachable")  # the last attempt returns or raises

    async def call_stream(self, service: str, method: str, payload: dict,
                          codec: Optional[ProtoCodec] = None,
                          metadata: Optional[tuple] = None):
        """A server-streaming call: an async generator of chunk dicts."""
        rpc = self._ensure_channel().unary_stream(
            f"/{service}/{method}", request_serializer=lambda b: b,
            response_deserializer=lambda b: b)
        wire = codec.encode_request(payload) if codec else _ser(payload)
        md = self._merged_metadata(metadata)

        async def gen():
            try:
                async for resp in rpc(wire, timeout=self.config.stream_timeout_s,
                                      metadata=md):
                    yield codec.decode_response(resp) if codec else _de(resp)
            except grpc_aio.AioRpcError as e:
                raise_remote_problem(e)
                raise

        return gen()

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None


# --------------------------------------------------------------------- directory
DIRECTORY_SERVICE = "directory.v1.DirectoryService"


@dataclass
class ServiceInstance:
    """One registered service instance."""

    instance_id: str
    service_name: str
    endpoint: str  # host:port
    module_name: str = ""
    registered_at: float = field(default_factory=time.time)
    last_heartbeat: float = field(default_factory=time.time)

    def to_dict(self) -> dict:
        return {"instance_id": self.instance_id, "service_name": self.service_name,
                "endpoint": self.endpoint, "module_name": self.module_name}


class DirectoryService:
    """Service discovery: register, resolve, heartbeat, deregister, and the
    eviction of instances whose heartbeat is older than the TTL."""

    def __init__(self, heartbeat_ttl_s: float = 15.0) -> None:
        self.ttl = heartbeat_ttl_s
        self._instances: dict[str, ServiceInstance] = {}

    def register(self, info: dict) -> dict:
        instance_id = info.get("instance_id") or str(uuid.uuid4())
        inst = ServiceInstance(instance_id=instance_id, service_name=info["service_name"],
                               endpoint=info["endpoint"],
                               module_name=info.get("module_name", ""))
        self._instances[instance_id] = inst
        logger.info("directory: registered %s at %s", inst.service_name, inst.endpoint)
        return {"instance_id": instance_id}

    def deregister(self, instance_id: str) -> bool:
        return self._instances.pop(instance_id, None) is not None

    def heartbeat(self, instance_id: str) -> bool:
        inst = self._instances.get(instance_id)
        if inst is None:
            return False
        inst.last_heartbeat = time.time()
        return True

    def resolve(self, service_name: str) -> Optional[ServiceInstance]:
        cutoff = time.time() - self.ttl
        alive = [i for i in self._instances.values()
                 if i.service_name == service_name and i.last_heartbeat >= cutoff]
        return alive[0] if alive else None

    def list_instances(self) -> list[ServiceInstance]:
        return list(self._instances.values())

    def evict_stale(self) -> int:
        cutoff = time.time() - self.ttl
        stale = [k for k, v in self._instances.items() if v.last_heartbeat < cutoff]
        for k in stale:
            inst = self._instances.pop(k)
            logger.warning("directory: evicted stale %s (%s)", inst.service_name,
                           inst.endpoint)
        return len(stale)

    def rpc_handlers(self) -> dict[str, Handler]:
        async def register(req: dict) -> dict:
            return self.register(req)

        async def deregister(req: dict) -> dict:
            return {"ok": self.deregister(req["instance_id"])}

        async def heartbeat(req: dict) -> dict:
            return {"ok": self.heartbeat(req["instance_id"])}

        async def resolve(req: dict) -> dict:
            inst = self.resolve(req["service_name"])
            if inst is None:
                raise KeyError(f"no live instance of {req['service_name']}")
            return inst.to_dict()

        async def list_instances(req: dict) -> dict:
            return {"instances": [i.to_dict() for i in self.list_instances()]}

        return {"RegisterInstance": register, "DeregisterInstance": deregister,
                "Heartbeat": heartbeat, "ResolveGrpcService": resolve,
                "ListInstances": list_instances}


class DirectoryClient:
    """The directory over the wire, in ``directory.v1`` protobuf."""

    def __init__(self, endpoint: str) -> None:
        self._client = JsonGrpcClient(endpoint)
        self._codecs = directory_codecs()

    async def register(self, service_name: str, endpoint: str, module_name: str = "",
                       instance_id: Optional[str] = None) -> str:
        resp = await self._client.call(DIRECTORY_SERVICE, "RegisterInstance", {
            "service_name": service_name, "endpoint": endpoint,
            "module_name": module_name, "instance_id": instance_id},
            codec=self._codecs["RegisterInstance"])
        return resp["instance_id"]

    async def deregister(self, instance_id: str) -> bool:
        resp = await self._client.call(DIRECTORY_SERVICE, "DeregisterInstance",
                                       {"instance_id": instance_id},
                                       codec=self._codecs["DeregisterInstance"])
        return resp["ok"]

    async def heartbeat(self, instance_id: str) -> bool:
        resp = await self._client.call(DIRECTORY_SERVICE, "Heartbeat",
                                       {"instance_id": instance_id},
                                       codec=self._codecs["Heartbeat"])
        return resp["ok"]

    async def resolve(self, service_name: str) -> dict:
        return await self._client.call(DIRECTORY_SERVICE, "ResolveGrpcService",
                                       {"service_name": service_name},
                                       codec=self._codecs["ResolveGrpcService"])

    async def close(self) -> None:
        await self._client.close()
