"""LlmWorkerService over gRPC: the worker SDK surface as a typed wire
contract (the port's copy of ``modules/llm_gateway/grpc_service.py``).

In process the gateway calls its worker directly; this module is the
out-of-process leg: a host runs the port's worker in another process (or on
another machine) and the llm-gateway consumes it through the committed IDL
(``proto/llmworker/v1/llm_worker.proto``, the stubs under
``modkit/gen/``). Token streams ride gRPC server-streaming; open-world
option maps ride ``google.protobuf.Struct``. The wire is the JAX package's,
byte for byte: a JAX gateway can route to a port worker and back.
"""

from __future__ import annotations

from typing import Any, AsyncIterator, Optional

from ...modkit.transport_grpc import (DirectoryService, JsonGrpcClient,
                                      llm_worker_codecs)
from ..sdk import ChatStreamChunk, LlmWorkerApi, ModelInfo

#: canonical proto service path (proto/llmworker/v1/llm_worker.proto)
LLM_WORKER_SERVICE = "llmworker.v1.LlmWorkerService"


# ------------------------------------------------------------ conversions

def _destruct(value: Any) -> Any:
    """Normalize google.protobuf.Struct decoding artifacts: Struct stores all
    numbers as doubles, so integral floats come back as ints (max_tokens=2.0
    → 2 — what the JSON path and in-process path deliver); containers recurse."""
    if isinstance(value, float) and value.is_integer():
        return int(value)
    if isinstance(value, dict):
        return {k: _destruct(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_destruct(v) for v in value]
    return value


def _normalize_messages(messages: list[dict]) -> list[dict]:
    """Wire → in-process shape: content parts are Structs (full fidelity for
    every schema variant incl. tool_result/base64 data), so only proto3
    envelope defaults need dropping (name=""/tool_calls=[] on messages that
    never carried them) plus Struct number normalization."""
    out = []
    for m in messages:
        msg: dict[str, Any] = {"role": m.get("role", ""),
                               "content": _destruct(list(m.get("content", [])))}
        if m.get("name"):
            msg["name"] = m["name"]
        if m.get("tool_calls"):
            msg["tool_calls"] = _destruct(list(m["tool_calls"]))
        out.append(msg)
    return out

def model_ref_dict(model: ModelInfo) -> dict:
    """ModelInfo → ModelRef proto-dict (the fields a remote worker needs to
    build an engine; registry-plane metadata like cost stays home)."""
    return {
        "canonical_id": model.canonical_id,
        "provider_slug": model.provider_slug,
        "provider_model_id": model.provider_model_id,
        "managed": model.managed,
        "architecture": model.architecture or "",
        "checkpoint_path": model.checkpoint_path or "",
        "engine_options": model.engine_options or {},
        "limits": model.limits or {},
        "capabilities": model.capabilities or {},
    }


def model_from_ref(ref: dict) -> ModelInfo:
    return ModelInfo(
        canonical_id=ref["canonical_id"],
        provider_slug=ref.get("provider_slug", ""),
        provider_model_id=ref.get("provider_model_id", ""),
        managed=bool(ref.get("managed")),
        architecture=ref.get("architecture") or None,
        checkpoint_path=ref.get("checkpoint_path") or None,
        engine_options=_destruct(ref.get("engine_options") or {}),
        limits=_destruct(ref.get("limits") or {}),
        capabilities=_destruct(ref.get("capabilities") or {}),
    )


def chunk_dict(c: ChatStreamChunk) -> dict:
    """ChatStreamChunk → StreamChunk proto-dict. token_id=0 is a real id, so
    presence rides the has_token_id flag (proto3 scalar defaults)."""
    out: dict[str, Any] = {
        "request_id": c.request_id,
        "text": c.text,
        "token_id": c.token_id or 0,
        "has_token_id": c.token_id is not None,
        "finish_reason": c.finish_reason or "",
    }
    if c.usage:
        out["usage"] = {"input_tokens": int(c.usage.get("input_tokens", 0)),
                        "output_tokens": int(c.usage.get("output_tokens", 0))}
    return out


def chunk_from_dict(d: dict) -> ChatStreamChunk:
    usage = d.get("usage") or None
    if usage is not None:
        usage = {"input_tokens": int(usage.get("input_tokens", 0)),
                 "output_tokens": int(usage.get("output_tokens", 0))}
    return ChatStreamChunk(
        request_id=d.get("request_id", ""),
        text=d.get("text", ""),
        token_id=int(d["token_id"]) if d.get("has_token_id") else None,
        finish_reason=d.get("finish_reason") or None,
        usage=usage,
    )


# ---------------------------------------------------------------- server

def register_llm_worker_service(server: Any, worker: LlmWorkerApi,
                                auth_token: Optional[str] = None) -> None:
    """Expose ``worker`` as llmworker.v1.LlmWorkerService on a JsonGrpcServer
    with the typed codecs — ChatStream/Completion are server-streaming.

    TRUST BOUNDARY: this is the intra-cluster worker plane, not a user
    surface — tenant auth/budgets are enforced by the CONSUMING gateway's
    REST stack before any call lands here. Pass ``auth_token`` whenever the
    grpc hub binds beyond loopback so arbitrary peers cannot run unmetered
    inference."""

    def _model(req: dict) -> ModelInfo:
        if "model" not in req or not req["model"].get("canonical_id"):
            # ValueError → INVALID_ARGUMENT (a malformed request must not
            # read as NOT_FOUND routing noise)
            raise ValueError("request requires model.canonical_id")
        return model_from_ref(req["model"])

    def _params(req: dict) -> dict:
        """Decode the params Struct and fold in the wire's tracing metadata
        (x-request-id / traceparent gRPC headers, injected by the transport
        as ``_grpc_metadata``): one X-Request-Id and one OTLP trace span
        gateway-host → worker-host → tokens. Explicit params win — metadata
        is the fallback for callers that only speak standard headers."""
        params = _destruct(dict(req.get("params") or {}))
        meta = req.get("_grpc_metadata") or {}
        if meta.get("x-request-id") and not params.get("_request_id"):
            params["_request_id"] = meta["x-request-id"]
        if meta.get("traceparent") and not params.get("_traceparent"):
            params["_traceparent"] = meta["traceparent"]
        return params

    async def chat_stream(req: dict) -> AsyncIterator[dict]:
        model = _model(req)
        async for chunk in worker.chat_stream(
                model, _normalize_messages(req.get("messages", [])),
                _params(req)):
            yield chunk_dict(chunk)

    async def completion(req: dict) -> AsyncIterator[dict]:
        model = _model(req)
        async for chunk in worker.completion_stream(
                model, req.get("prompt", ""), _params(req)):
            yield chunk_dict(chunk)

    async def embed(req: dict) -> dict:
        model = _model(req)
        vectors, total = await worker.embed(model, list(req.get("inputs", [])),
                                            _destruct(dict(req.get("params") or {})))
        return {"embeddings": [{"values": [float(x) for x in v]}
                               for v in vectors],
                "total_tokens": int(total)}

    async def health(_req: dict) -> dict:
        detail = await worker.health()
        return {"status": str(detail.get("status", "ok")), "detail": detail}

    server.add_service(
        LLM_WORKER_SERVICE,
        {"Embed": embed, "Health": health},
        streams={"ChatStream": chat_stream, "Completion": completion},
        codecs=llm_worker_codecs(),
        auth_token=auth_token,
    )


# ---------------------------------------------------------------- client

class GrpcLlmWorkerClient(LlmWorkerApi):
    """LlmWorkerApi over the typed wire — resolves the worker endpoint via
    the directory (or takes it explicitly) and speaks llmworker.v1
    protobuf. Drop-in for ClientHub: the llm-gateway cannot
    tell a remote worker from the in-process one."""

    def __init__(self, directory: Optional[DirectoryService] = None,
                 endpoint: Optional[str] = None,
                 auth_token: Optional[str] = None) -> None:
        if directory is None and endpoint is None:
            raise ValueError("need a directory or an explicit endpoint")
        self._directory = directory
        self._endpoint = endpoint
        self._auth_token = auth_token
        self._client: Optional[JsonGrpcClient] = None
        self._codecs = llm_worker_codecs()

    async def _ensure(self) -> JsonGrpcClient:
        if self._client is None:
            endpoint = self._endpoint
            if endpoint is None:
                inst = self._directory.resolve(LLM_WORKER_SERVICE)
                if inst is None:
                    raise ConnectionError(
                        f"no live instance of {LLM_WORKER_SERVICE}")
                endpoint = inst.endpoint
            self._client = JsonGrpcClient(endpoint,
                                          auth_token=self._auth_token)
        return self._client

    @staticmethod
    def _wire_params(params: Optional[dict]) -> dict:
        """Strip the request fields that already travel as typed proto
        (messages, model) — otherwise multimodal payloads (inlined document
        text / base64 images) would cross the wire TWICE per call inside the
        params Struct."""
        return {k: v for k, v in (params or {}).items()
                if k not in ("messages", "model", "prompt")}

    @staticmethod
    def _wire_metadata(params: Optional[dict]) -> Optional[tuple]:
        """X-Request-Id + W3C traceparent as real gRPC metadata, so the
        worker-host joins the gateway's trace even through header-only
        middleboxes (and the worker's flight recorder keys on the same id
        the client holds)."""
        meta = []
        p = params or {}
        if p.get("_request_id"):
            meta.append(("x-request-id", str(p["_request_id"])))
        if p.get("_traceparent"):
            meta.append(("traceparent", str(p["_traceparent"])))
        return tuple(meta) or None

    async def chat_stream(self, model: ModelInfo, messages: list[dict],
                          params: dict) -> AsyncIterator[ChatStreamChunk]:
        client = await self._ensure()
        stream = await client.call_stream(
            LLM_WORKER_SERVICE, "ChatStream",
            {"model": model_ref_dict(model), "messages": messages,
             "params": self._wire_params(params)},
            codec=self._codecs["ChatStream"],
            metadata=self._wire_metadata(params))
        async for d in stream:
            yield chunk_from_dict(d)

    async def completion_stream(self, model: ModelInfo, prompt: str,
                                params: dict) -> AsyncIterator[ChatStreamChunk]:
        client = await self._ensure()
        stream = await client.call_stream(
            LLM_WORKER_SERVICE, "Completion",
            {"model": model_ref_dict(model), "prompt": prompt,
             "params": self._wire_params(params)},
            codec=self._codecs["Completion"],
            metadata=self._wire_metadata(params))
        async for d in stream:
            yield chunk_from_dict(d)

    async def embed(self, model: ModelInfo, inputs: list[str],
                    params: dict) -> tuple[list[list[float]], int]:
        client = await self._ensure()
        out = await client.call(
            LLM_WORKER_SERVICE, "Embed",
            {"model": model_ref_dict(model), "inputs": inputs,
             "params": self._wire_params(params)},
            codec=self._codecs["Embed"])
        vectors = [[float(x) for x in e.get("values", [])]
                   for e in out.get("embeddings", [])]
        return vectors, int(out.get("total_tokens", 0))

    async def health(self) -> dict[str, Any]:
        client = await self._ensure()
        out = await client.call(LLM_WORKER_SERVICE, "Health", {},
                                codec=self._codecs["Health"])
        return _destruct(
            dict(out.get("detail") or {"status": out.get("status", "ok")}))

    async def close(self) -> None:
        if self._client is not None:
            await self._client.close()
            self._client = None


# ------------------------------------------------- observability service

#: fleet observability pull plane: full per-request flight-recorder
#: timelines on demand + the cross-host failpoint arm path. JSON-over-gRPC like the registry service — observability
#: payloads are open-world dicts, a fixed IDL would fight every new field.
WORKER_OBS_SERVICE = "fabricobs.v1.WorkerObservability"


def register_worker_observability_service(
        server: Any, *, allow_fault_injection: bool = False,
        auth_token: Optional[str] = None) -> None:
    """Expose the worker process's flight recorder (and, when fault
    injection is enabled for the stack, its failpoint registry) over gRPC.

    Same trust boundary as the worker service: intra-cluster plane. The
    failpoint methods are additionally gated on ``allow_fault_injection``
    mirroring the REST layer's fault-injection guard — a production worker refuses
    them even from an authenticated gateway."""
    from ...modkit import failpoints as fp
    from ...modkit.flight_recorder import default_recorder

    async def timeline(req: dict) -> dict:
        rec = default_recorder.lookup(str(req.get("request_id") or ""))
        if rec is None:
            return {"found": False}
        return {"found": True, "record": rec}

    def _gate() -> Optional[dict]:
        if not allow_fault_injection:
            return {"ok": False, "error": "fault_injection_disabled"}
        return None

    async def arm_failpoint(req: dict) -> dict:
        refused = _gate()
        if refused:
            return refused
        name = str(req.get("name") or "")
        if name not in fp.FAILPOINT_CATALOG:
            return {"ok": False, "error": f"unknown failpoint {name!r}"}
        if req.get("seed") is not None:
            fp.configure(seed=int(req["seed"]))
        try:
            fp.arm(name, req.get("spec") or "raise")
        except (TypeError, ValueError) as e:
            return {"ok": False, "error": f"bad spec: {e}"}
        return {"ok": True, "name": name}

    async def disarm_failpoint(req: dict) -> dict:
        refused = _gate()
        if refused:
            return refused
        name = str(req.get("name") or "")
        if name not in fp.FAILPOINT_CATALOG:
            return {"ok": False, "error": f"unknown failpoint {name!r}"}
        fp.disarm(name)
        return {"ok": True, "name": name}

    server.add_service(
        WORKER_OBS_SERVICE,
        {"Timeline": timeline, "ArmFailpoint": arm_failpoint,
         "DisarmFailpoint": disarm_failpoint},
        auth_token=auth_token,
    )


class WorkerObservabilityClient:
    """Gateway-side client for one worker host's observability plane."""

    def __init__(self, endpoint: str,
                 auth_token: Optional[str] = None) -> None:
        self._client = JsonGrpcClient(endpoint, auth_token=auth_token)

    async def timeline(self, request_id: str) -> dict:
        return await self._client.call(WORKER_OBS_SERVICE, "Timeline",
                                       {"request_id": request_id})

    async def arm_failpoint(self, name: str, spec: Any = "raise",
                            seed: Optional[int] = None) -> dict:
        req: dict[str, Any] = {"name": name, "spec": spec}
        if seed is not None:
            req["seed"] = seed
        return await self._client.call(WORKER_OBS_SERVICE, "ArmFailpoint",
                                       req)

    async def disarm_failpoint(self, name: str) -> dict:
        return await self._client.call(WORKER_OBS_SERVICE, "DisarmFailpoint",
                                       {"name": name})

    async def close(self) -> None:
        await self._client.close()
