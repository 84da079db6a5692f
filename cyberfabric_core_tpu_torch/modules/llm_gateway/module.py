"""The llm-gateway handlers (the port's copy of the chat and embeddings
paths of ``modules/llm_gateway/module.py``): ``POST /v1/chat/completions``
and ``POST /v1/completions``, sync and SSE, and ``POST /v1/embeddings``.

validate against the wire schema → the doctor's shedding gate (429
``llm.load_shed`` / ``llm.tenant_shed`` with ``Retry-After``, before
enqueue, only in a host that runs the monitoring module) → refuse what the
port does not serve → request id, the HTTP span's traceparent and the
tenant into the worker params → deadline →
resolve the model and its fallback chain → one attempt per model under the
TTFT and total timeouts → a JSON response, or an SSE stream of chunks (a
role-bearing first delta, content deltas, a final chunk with
``finish_reason`` and ``usage``, then ``data: [DONE]``; a failure after the
stream started is an ``error`` event). At a model's first chunk,
``llm_ttft_seconds{model}`` observes the flight record's derived ttft (the
engine's enqueued → prefill), else the gateway's wall clock.

A client that leaves an SSE stream, before its first token or after, is
seen on the connection (EOF while waiting, a reset at a write); the stream's
generators are closed, the worker cancels the request in the engine, and
``llm_client_disconnects_total`` counts it.
Request fields and config keys of the JAX module that the port does not
serve (async jobs, tools, structured output, media parts, budgets, hooks)
raise, naming their ROADMAP item.

The worker behind the handlers (:func:`build_worker`): with
``federation.enabled``, a :class:`..runtime.federation.FederatedServingPool`
that places each request on a remote worker host announced to the host's
``grpc_hub`` (prefix > health > load > random) over the ``llmworker.v1``
wire, and fails a stream over to a survivor when its host dies; else, with
``remote_worker_endpoint``, one remote worker over that wire; else the
in-process :class:`.worker.LocalTorchWorker`. ``worker_service.expose``
serves the local worker on the hub as ``llmworker.v1.LlmWorkerService``
(``worker_service.token``: its bearer) for other hosts' gateways.
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from typing import Any, AsyncIterator, Callable, Optional

from ...gateway.http import ClientDisconnected, Request, StreamResponse
from ...gateway.middleware import REQUEST_ID_KEY, SECURITY_CONTEXT_KEY
from ...gateway.router import RestRouter
from ...gateway.validation import read_json, validate_against
from ...modkit.errcat import ERR
from ...modkit.doctor import default_doctor
from ...modkit.errors import ProblemError
from ...modkit.flight_recorder import default_recorder
from ...modkit.metrics import bump_counter, default_registry
from ...modkit.security import SecurityContext
from ...modkit.sse import SSE_DONE, format_sse_json
from ...modkit.telemetry import Tracer
from ...runtime.federation import FederatedServingPool, FederationConfig, WorkerRegistry
from ..sdk import ChatStreamChunk, LlmWorkerApi, ModelInfo, ModelRegistryApi
from . import schemas
from .grpc_service import (GrpcLlmWorkerClient, WorkerObservabilityClient,
                           register_llm_worker_service)
from .worker import LocalTorchWorker

logger = logging.getLogger("llm_gateway")

#: config keys of the JAX module; ``budget_retry_after_s`` only paces
#: budget rejections, so without ``budgets`` it is inert in both packages
CONFIG_KEYS = frozenset({"ttft_timeout_s", "total_timeout_s", "default_deadline_ms",
                         "budget_retry_after_s", "worker", "federation",
                         "remote_worker_endpoint", "worker_service"})
#: the keys of the ``federation`` block and of its ``observability`` block
FEDERATION_KEYS = frozenset({"enabled", "prefix_slack", "max_failovers", "failover_backoff_s",
                             "block_chars", "max_blocks", "seed", "worker_auth_token",
                             "observability"})
FEDERATION_OBS_KEYS = frozenset({"stitch_timeout_s", "host_metrics"})
WORKER_SERVICE_KEYS = frozenset({"expose", "token"})
_UNPORTED_CONFIG = {
    "budgets": "14 (usage budgets)",
    "video_poll_interval_s": "13 (media)",
    "video_poll_timeout_s": "13 (media)",
}
#: request fields the port does not serve yet
_UNPORTED_FIELDS = {
    "async": "11 (async jobs and batches)",
    "tools": "12 (tools and structured output)",
    "response_schema": "12 (tools and structured output)",
}


def check_config(cfg: dict[str, Any]) -> None:
    for key in cfg:
        if key in _UNPORTED_CONFIG:
            raise ValueError(f"llm_gateway config: {key!r} is not ported yet "
                             f"(ROADMAP queue 1 item {_UNPORTED_CONFIG[key]})")
        if key not in CONFIG_KEYS:
            raise ValueError(f"llm_gateway config: unknown key {key!r}")
    for block, raw, known in (
            ("federation", cfg.get("federation"), FEDERATION_KEYS),
            ("federation.observability", (cfg.get("federation") or {}).get("observability"),
             FEDERATION_OBS_KEYS),
            ("worker_service", cfg.get("worker_service"), WORKER_SERVICE_KEYS)):
        unknown = sorted(set(raw or {}) - known)
        if unknown:
            raise ValueError(f"llm_gateway config: unknown {block} keys {unknown}")


def build_federated_pool(cfg: dict[str, Any],
                         registry: Callable[[], Optional[WorkerRegistry]]
                         ) -> FederatedServingPool:
    """The federated pool over the hub's worker registry (resolved at each
    use, so the hub may come up after the gateway): a cached
    :class:`GrpcLlmWorkerClient` per placed host, an observability client per
    host for stitched timelines and remote failpoints, and the fleet's
    reasons on the doctor's /readyz (:meth:`LlmGatewayModule.stop` detaches
    them)."""
    fed = dict(cfg.get("federation") or {})
    auth = fed.get("worker_auth_token") or (cfg.get("worker_service") or {}).get("token")
    obs = dict(fed.get("observability") or {})
    config = FederationConfig(
        prefix_slack=int(fed.get("prefix_slack", 2)),
        max_failovers=int(fed.get("max_failovers", 2)),
        failover_backoff_s=float(fed.get("failover_backoff_s", 0.05)),
        block_chars=int(fed.get("block_chars", 48)),
        max_blocks=int(fed.get("max_blocks", 64)),
        seed=int(fed.get("seed", 0)),
        stitch_timeout_s=float(obs.get("stitch_timeout_s", 2.0)),
        host_metrics=bool(obs.get("host_metrics", True)),
    )
    pool = FederatedServingPool(
        registry, lambda w: GrpcLlmWorkerClient(endpoint=w.endpoint, auth_token=auth),
        ChatStreamChunk, config,
        obs_client_factory=lambda w: WorkerObservabilityClient(w.endpoint, auth_token=auth))
    default_doctor.set_fleet_provider(pool.fleet.readiness_reasons)
    return pool


def build_worker(cfg: dict[str, Any],
                 registry: Callable[[], Optional[WorkerRegistry]]) -> Any:
    """The worker the handlers serve through: the federated pool (before a
    remote worker, before the local one), as the JAX module picks it."""
    check_config(cfg)
    if (cfg.get("federation") or {}).get("enabled"):
        return build_federated_pool(cfg, registry)
    if cfg.get("remote_worker_endpoint"):
        return GrpcLlmWorkerClient(endpoint=str(cfg["remote_worker_endpoint"]),
                                   auth_token=(cfg.get("worker_service") or {}).get("token"))
    return LocalTorchWorker(cfg.get("worker"))


class LlmGatewayModule:
    def __init__(self, config: dict[str, Any], registry: ModelRegistryApi,
                 worker: LlmWorkerApi) -> None:
        check_config(config)
        self.registry = registry
        self.worker = worker
        self.ttft_timeout_s = float(config.get("ttft_timeout_s", 120.0))
        self.total_timeout_s = float(config.get("total_timeout_s", 600.0))
        #: default per-request TTL (ms) threaded into the engine as a
        #: deadline when the client sends no X-Request-Deadline-Ms; 0 = off
        self.default_deadline_ms = float(config.get("default_deadline_ms", 0.0))
        #: SSE consumers that left mid-stream
        self.client_disconnects = 0
        #: the doctor the shedding gate reads: set by a host that runs the
        #: monitoring module (None: this host never sheds)
        self.doctor: Any = None

    # ------------------------------------------------------------- application layer
    async def _resolve_with_fallback(self, ctx: SecurityContext,
                                     body: dict) -> list[tuple[bool, ModelInfo]]:
        """Primary + fallback chain as (is_primary, model) pairs; resolution
        errors are skipped so a dead primary still falls through."""
        names = [body["model"]]
        fb = body.get("fallback") or {}
        names += [n for n in fb.get("models", []) if n not in names]
        max_attempts = int(fb.get("max_attempts", len(names)))
        resolved: list[tuple[bool, ModelInfo]] = []
        errors: list[str] = []
        for pos, name in enumerate(names[:max_attempts]):
            try:
                resolved.append((pos == 0, await self.registry.resolve(ctx, name)))
            except ProblemError as e:
                errors.append(f"{name}: {e.problem.detail or e.problem.title}")
        if not resolved:
            raise ERR.llm.model_not_found.error(
                "no usable model in request chain: " + "; ".join(errors))
        return resolved

    async def _chat_once(self, model: ModelInfo, body: dict,
                         mode: str = "chat") -> AsyncIterator[ChatStreamChunk]:
        """One model attempt under the TTFT and total timeouts; the worker's
        generator is closed on every exit, so its teardown cancels the
        engine-side work of a consumer that is gone."""
        if mode == "completion":
            agen = self.worker.completion_stream(model, body["prompt"], body)
        else:
            agen = self.worker.chat_stream(model, body["messages"], body)
        loop = asyncio.get_running_loop()
        t_start = loop.time()
        deadline = t_start + self.total_timeout_s
        first = True
        try:
            while True:
                timeout = self.ttft_timeout_s if first else max(0.05, deadline - loop.time())
                try:
                    chunk = await asyncio.wait_for(agen.__anext__(), timeout)
                except StopAsyncIteration:
                    return
                except asyncio.TimeoutError:
                    raise (ERR.llm.ttft_timeout if first else ERR.llm.total_timeout).error(
                        f"model {model.canonical_id} {'TTFT' if first else 'total'} timeout")
                if first:
                    self._observe_ttft(model, body, loop.time() - t_start)
                first = False
                yield chunk
        finally:
            await agen.aclose()

    @staticmethod
    def _observe_ttft(model: ModelInfo, body: dict, wall_s: float) -> None:
        """``llm_ttft_seconds{model}``: the flight record's derived ttft
        (enqueued → prefill, the engine's truth) when the request has one,
        else the gateway's wall clock."""
        ttft_s = wall_s
        rid = body.get("_request_id")
        if model.managed and rid:
            try:
                derived = ((default_recorder.lookup(rid) or {}).get("derived", {})
                           .get("ttft_ms"))
                if derived is not None:
                    ttft_s = derived / 1000.0
            except Exception:  # noqa: BLE001 — telemetry must not fail serving
                pass
        default_registry.histogram("llm_ttft_seconds", "Time to first token").observe(
            ttft_s, model=model.canonical_id)

    # ------------------------------------------------------------- REST handlers
    def _check_load_shed(self, ctx: Optional[SecurityContext] = None) -> None:
        """The doctor's admission gate, tenant-selective first: while it
        attributes the burn to an over-fair-share tenant, only that tenant's
        new requests get 429 ``llm.tenant_shed``; in the ``shedding`` state
        everyone's get 429 ``llm.load_shed``. Before enqueue: streams in
        flight decode on untouched."""
        doctor = self.doctor
        if doctor is None:
            return
        retry_after = doctor.shed_retry_after()
        if retry_after is not None:
            raise ERR.llm.load_shed.error(
                "serving is load-shedding (SLO burn/stall watchdogs); retry later",
                retry_after_s=retry_after, state="shedding")
        if ctx is None:
            return
        tenant_retry = doctor.tenant_shed_retry_after(ctx.tenant_id)
        if tenant_retry is not None:
            raise ERR.llm.tenant_shed.error(
                f"tenant {ctx.tenant_id!r} is consuming over its fair share while "
                "serving burns SLO budget; this tenant's new requests are shed first "
                "(compliant tenants keep serving)",
                retry_after_s=tenant_retry, tenant=ctx.tenant_id)

    @staticmethod
    def _reject_unported(body: dict) -> None:
        for key, item in _UNPORTED_FIELDS.items():
            if body.get(key):
                raise ERR.llm.not_ported.error(
                    f"request field {key!r} is not served by the port yet "
                    f"(ROADMAP queue 1 item {item})")
        for msg in body.get("messages") or ():
            for part in msg.get("content") or ():
                if part.get("type") != "text":
                    raise ERR.llm.not_ported.error(
                        f"content parts of type {part.get('type')!r} are not served by the "
                        "port yet (ROADMAP queue 1 item 13: media)")

    async def handle_chat(self, request: Request):
        body = read_json(await request.read(), schemas.REQUEST)
        return await self._handle(request, body, "chat")

    async def handle_completions(self, request: Request):
        """Raw text completion: no chat template, prompt tokens in verbatim."""
        body = read_json(await request.read(), schemas.COMPLETION_REQUEST)
        return await self._handle(request, body, "completion")

    async def _handle(self, request: Request, body: dict, mode: str):
        ctx: SecurityContext = request[SECURITY_CONTEXT_KEY]
        self._check_load_shed(ctx)
        self._reject_unported(body)
        self._inject_observability(request, body, ctx)
        self._inject_deadline(request, body)
        models = await self._resolve_with_fallback(ctx, body)
        if body.get("stream"):
            return await self._stream_response(request, body, models, mode)
        return await self._sync_response(body, models, mode)

    @staticmethod
    def _inject_observability(request: Request, body: dict,
                              ctx: Optional[SecurityContext] = None) -> None:
        """The gateway's request id, the live HTTP span's traceparent (else
        the client's) and the authenticated tenant into the worker params:
        the engine keys the request by the id the client holds, its spans
        join the HTTP trace, and its fair queue keys by the tenant."""
        rid = request.get(REQUEST_ID_KEY)
        if rid and "_request_id" not in body:
            body["_request_id"] = rid
        span = Tracer.current()
        if span is not None:
            body["_traceparent"] = span.traceparent()
        elif request.headers.get("traceparent"):
            body["_traceparent"] = request.headers["traceparent"]
        if ctx is not None:
            body["_tenant_id"] = ctx.tenant_id

    def _inject_deadline(self, request: Request, body: dict) -> None:
        """``X-Request-Deadline-Ms`` (the client's budget in ms) over the
        config's ``default_deadline_ms`` (0 = off); it rides to the worker
        as ``_deadline_ms`` and becomes an engine deadline at submit."""
        hdr = request.headers.get("x-request-deadline-ms")
        if hdr is not None:
            try:
                ms = float(hdr)
            except ValueError:
                ms = float("nan")
            if not ms > 0 or ms != ms or ms == float("inf"):
                raise ProblemError.bad_request(
                    "X-Request-Deadline-Ms must be a positive, finite number of "
                    "milliseconds")
            body["_deadline_ms"] = ms
        elif self.default_deadline_ms > 0:
            body["_deadline_ms"] = self.default_deadline_ms

    async def _sync_response(self, body: dict, models: list[tuple[bool, ModelInfo]],
                             mode: str = "chat") -> dict:
        last_err: Optional[ProblemError] = None
        for is_primary, model in models:
            pieces: list[str] = []
            usage: dict[str, Any] = {"input_tokens": 0, "output_tokens": 0}
            finish = "stop"
            try:
                async for chunk in self._chat_once(model, body, mode):
                    if chunk.text:
                        pieces.append(chunk.text)
                    if chunk.finish_reason:
                        finish = chunk.finish_reason
                        usage = chunk.usage or usage
                cost = self._cost(model, usage)
                if cost is not None:
                    usage["cost_estimate"] = cost
                self._count_tokens(body, usage)
                resp = {"usage": usage, "model_used": model.canonical_id,
                        "fallback_used": not is_primary, "finish_reason": finish,
                        "content": [{"type": "text", "text": "".join(pieces)}]}
                validate_against(schemas.RESPONSE, resp)
                return resp
            except ProblemError as e:
                last_err = e
                if e.problem.code in ("request_timeout", "deadline_exceeded"):
                    # the clock failed, not the model: a fallback inherits the
                    # same lapsed budget
                    break
                continue
        assert last_err is not None
        raise last_err

    async def _stream_response(self, request: Request, body: dict,
                               models: list[tuple[bool, ModelInfo]],
                               mode: str = "chat") -> StreamResponse:
        """SSE per the chunk contract. The connection is watched from the
        start: a client gone before its first token is seen too."""
        completion_id = (f"chatcmpl-{uuid.uuid4().hex[:20]}" if mode == "chat"
                         else f"cmpl-{uuid.uuid4().hex[:20]}")
        gone = request.wait_disconnected()
        last_err: Optional[ProblemError] = None
        try:
            for is_primary, model in models:
                agen = self._chat_once(model, body, mode)
                try:
                    first_chunk = await self._next(agen, gone)
                except StopAsyncIteration:
                    await agen.aclose()
                    continue
                except ProblemError as e:
                    await agen.aclose()
                    last_err = e
                    if e.problem.code in ("request_timeout", "deadline_exceeded"):
                        break  # a lapsed deadline lapses on every fallback too
                    continue  # fall back before the stream starts; committed after
                except ClientDisconnected:
                    await agen.aclose()
                    raise
                headers = {"Content-Type": "text/event-stream", "Cache-Control": "no-cache",
                           "X-Model-Used": model.canonical_id}
                rid = request.get(REQUEST_ID_KEY)
                if rid:
                    headers["X-Request-Id"] = rid
                resp = StreamResponse(request, headers=headers)
                try:
                    await resp.prepare()
                    await self._stream_chunks(resp, agen, first_chunk, completion_id,
                                              model, gone, body)
                    await resp.write(SSE_DONE)
                finally:
                    # closing the stream's generators on every exit: the
                    # worker's teardown cancels an abandoned request
                    await agen.aclose()
                return resp
            raise last_err or ProblemError.service_unavailable(
                "no model produced a stream")
        except ClientDisconnected:
            self.client_disconnects += 1
            bump_counter("llm_client_disconnects_total")
            raise
        finally:
            gone.cancel()

    @staticmethod
    async def _next(agen: AsyncIterator[ChatStreamChunk],
                    gone: "asyncio.Future[None]") -> ChatStreamChunk:
        """The stream's next chunk, or :class:`ClientDisconnected` if the
        peer leaves first."""
        step = asyncio.ensure_future(agen.__anext__())
        await asyncio.wait({step, gone}, return_when=asyncio.FIRST_COMPLETED)
        if step.done():
            return step.result()
        step.cancel()
        try:
            await step
        except (asyncio.CancelledError, StopAsyncIteration, ProblemError):
            pass
        raise ClientDisconnected("the client closed the stream")

    async def _stream_chunks(self, resp: StreamResponse, agen, first_chunk,
                             completion_id: str, model: ModelInfo, gone,
                             body: dict) -> None:
        role_sent = False

        async def emit(chunk: ChatStreamChunk) -> None:
            nonlocal role_sent
            delta: dict[str, Any] = {}
            if not role_sent:
                delta["role"] = "assistant"
                role_sent = True
            if chunk.text:
                delta["content"] = chunk.text
            payload: dict[str, Any] = {"id": completion_id, "model": model.canonical_id,
                                       "delta": delta}
            if chunk.finish_reason:
                payload["finish_reason"] = chunk.finish_reason
                usage = dict(chunk.usage or {})
                cost = self._cost(model, usage)
                if cost is not None:
                    usage["cost_estimate"] = cost
                payload["usage"] = usage
                self._count_tokens(body, usage)
            validate_against(schemas.STREAM_CHUNK, payload)
            await resp.write(format_sse_json(payload))

        try:
            await emit(first_chunk)
            while True:
                try:
                    chunk = await self._next(agen, gone)
                except StopAsyncIteration:
                    return
                await emit(chunk)
        except ProblemError as e:
            # a failure after the stream started: a terminal error event
            await resp.write(format_sse_json({"error": e.problem.to_dict()}, event="error"))

    @staticmethod
    def _count_tokens(body: dict, usage: dict[str, Any]) -> None:
        """``llm_tokens_total{direction, tenant}`` for one finished request."""
        tenant = str(body.get("_tenant_id") or "default")
        bump_counter("llm_tokens_total", "LLM tokens processed",
                     n=usage.get("input_tokens", 0), direction="input", tenant=tenant)
        bump_counter("llm_tokens_total", "LLM tokens processed",
                     n=usage.get("output_tokens", 0), direction="output", tenant=tenant)

    @staticmethod
    def _cost(model: ModelInfo, usage: dict[str, int]) -> Optional[float]:
        if not model.cost:
            return None
        cin = model.cost.get("input_per_1k", 0.0) * usage.get("input_tokens", 0) / 1000.0
        cout = model.cost.get("output_per_1k", 0.0) * usage.get("output_tokens", 0) / 1000.0
        return round(cin + cout, 8)

    async def handle_embeddings(self, request: Request):
        """One vector per input, in order; usage counts the inputs' tokens.
        ``dimensions`` and ``encoding_format`` are checked by the schema and
        otherwise unused, as in JAX (vectors are always full floats)."""
        body = read_json(await request.read(), schemas.EMBEDDING_REQUEST)
        ctx: SecurityContext = request[SECURITY_CONTEXT_KEY]
        model = await self.registry.resolve(ctx, body["model"])
        inputs = body["input"] if isinstance(body["input"], list) else [body["input"]]
        vectors, input_tokens = await self.worker.embed(model, inputs, body)
        return {"data": [{"index": i, "embedding": v} for i, v in enumerate(vectors)],
                "model": model.canonical_id,
                "usage": {"input_tokens": input_tokens, "output_tokens": 0}}

    async def handle_models(self, request: Request):
        """The registry's models (the JAX registry's list shape)."""
        models = await self.registry.list_models(request[SECURITY_CONTEXT_KEY])
        return {"items": [m.to_dict() for m in models],
                "page_info": {"next_cursor": None, "prev_cursor": None,
                              "limit": len(models)}}

    # ------------------------------------------------------------- registration
    def register_grpc(self, server: Any, config: dict[str, Any]) -> None:
        """With ``worker_service.expose``, serve the worker on ``server`` as
        llmworker.v1.LlmWorkerService. A remote worker or the federated pool
        is never served again: a proxy of other hosts' engines adds a hop a
        call, and two hosts pointing at each other would recurse."""
        ws = config.get("worker_service") or {}
        if ws.get("expose") and not isinstance(self.worker, (GrpcLlmWorkerClient,
                                                             FederatedServingPool)):
            register_llm_worker_service(server, self.worker, auth_token=ws.get("token"))

    def stop(self) -> None:
        """Detach the fleet's /readyz feed: a stopped federated stack's hosts
        must not colour the next stack's readiness."""
        if getattr(self.worker, "fleet", None) is not None:
            default_doctor.set_fleet_provider(None)

    def register_rest(self, router: RestRouter) -> None:
        m = "llm_gateway"
        router.route("POST", "/v1/chat/completions", self.handle_chat, sse=True, module=m)
        router.route("POST", "/v1/completions", self.handle_completions, sse=True, module=m)
        router.route("POST", "/v1/embeddings", self.handle_embeddings, module=m)
        router.route("GET", "/v1/models", self.handle_models, module=m)
