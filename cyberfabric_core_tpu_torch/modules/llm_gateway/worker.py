"""LocalTorchWorker: the llm-gateway's worker on the port's engines (the
port's copy of ``modules/llm_gateway/worker.py`` ``LocalTpuWorker``).

With the worker config's ``scheduler`` at ``"continuous"`` (the default),
one :class:`..runtime.scheduler.ContinuousBatchingEngine` per model,
built on first use off the event loop from the registry entry's
``engine_options``, mapped exactly as the JAX worker maps them
(:func:`plan_engine`), and wrapped in an
:class:`..runtime.lifecycle.EngineSupervisor` that rebuilds it in place if
it breaks. The engine runs on the worker config's ``device`` (default the
CUDA card; ``"cpu"`` runs the kernels' plain versions). ``quantization``
("int8" / "int4") quantizes the checkpoint as it loads, or the random
weights as they are drawn. ``dp_replicas`` > 1 serves the model through a
:class:`..runtime.replicas.DataParallelServingPool`, and
``pd_prefill_replicas`` with ``pd_decode_replicas`` through a
:class:`..runtime.pd.PDServingPool`, each supervised by a
``ReplicaLifecycleManager`` unless ``lifecycle`` is off; the replicas take
one visible CUDA card each (so a one-card host refuses two, as a one-chip
TPU host does), or all sit on the worker's ``device`` when it is ``"cpu"``
or names one card. :meth:`LocalTorchWorker.replicas_view` and
:meth:`LocalTorchWorker.replica_control` are the replica census and its
drain / undrain / restart.

Engine → event loop: the engine calls ``emit`` on its scheduler thread; the
worker hands each event over with ``loop.call_soon_threadsafe`` and does
nothing else there. A stream's generator turns events into text through an
incremental detokenizer, applies stop strings, maps every terminal, and,
when its consumer lets go before the engine ended the request (a client
disconnect, a gateway timeout), cancels the request in the engine with
``reason="client_disconnect"``.

With ``scheduler: "lockstep"``, one :class:`..runtime.engine.InferenceEngine`
per model behind a :class:`_DynamicBatcher`: requests that arrive within
``batch_window_ms`` (up to ``max_batch``) run as one lockstep batch on an
executor thread, prefilled through the flash kernel on the card; a bs=1
batch speculates when ``speculative`` is ``"ngram"`` (greedy) or
``"draft"`` (``draft_model``, ``draft_checkpoint``, ``spec_k``). The
lockstep engine has no cancellation, deadlines or tenants, as in JAX: a
stream whose client left runs to its end, and its events are dropped.
Under the continuous scheduler ``speculative`` is inert: the worker logs
JAX's warning and the scheduler's own rounds (``scheduler_spec_k``,
``spec_min_accept``, ``spec_max_ngram``, ``spec_min_ngram``) are what
speculate.

Tensor parallelism: ``tp`` > 1 builds one continuous engine over ``tp``
ranks: the first ``tp`` CUDA cards by default, or ``tp`` times the worker's
``device`` when the config names one (``"cpu"``, or ``"cuda:0"`` to put
every rank on one card). ``hbm_bytes_per_device`` > 0 arms the engine's
feasibility gate; a plan over that budget is the ``llm.infeasible_plan``
problem (507) at the model's first request, and no entry is kept, so a
retry gates again. The lockstep scheduler reads no ``tp``, as in JAX. The
combinations the JAX worker refuses (a one-sided PD split, PD with dp or
tp, dp with tp) raise its ``ValueError``s.

Observability: the worker stamps each continuous request's model and
tenant on its flight record at submit (the scheduler emits the lifecycle
events), tells a 408 from a 504 by the recorder's phase of the request's
``deadline_exceeded`` terminal, and gives the monitoring module and the
doctor :meth:`LocalTorchWorker.schedulers`,
:meth:`LocalTorchWorker.replica_capacity` and
:meth:`LocalTorchWorker.tenant_usage`.

Embeddings (:meth:`LocalTorchWorker.embed`): one bert encoder per model,
built once on first use (a named checkpoint that is missing raises; no
checkpoint serves random weights, with a warning), run in fixed batches of
8 × ``min(max_position, 128)`` tokens on an executor thread; the token
count comes from the model's tokenizer.

Federation: :meth:`LocalTorchWorker.federation_census` is the heartbeat's
gossip (load, capacity and tenants, models, the digest chains of prompts
whose KV prefix is still resident, recent request → trace ids, and
:meth:`LocalTorchWorker.observability_census`: the ``llm_*`` metrics, a
compact doctor report and recent terminals; the worker config's
``observability.enabled: false`` leaves that part out). A federated stream
(``_fed_token_stream``) yields one chunk a token, text or not, so the
gateway keeps an exact token ledger; a failover continuation
(``_resume_token_ids``, ``_resume_sent_text``) prefills the prompt and the
tokens already delivered as one prompt and emits only the text not yet
sent. :func:`serve` (``python -m
cyberfabric_core_tpu_torch.modules.llm_gateway.worker`` with
``FED_WORKER_CONFIG``) runs the worker as a federation host.
"""

from __future__ import annotations

import asyncio
import gc
import json
import logging
import os
import signal
import sys
import threading
import time
import uuid
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path
from typing import Any, AsyncIterator, Callable, Optional, Sequence

import numpy as np
import torch

from ...device import resolve_device, to_device
from ...modkit.doctor import DoctorConfig, default_doctor
from ...modkit.errcat import ERR
from ...modkit.errors import ProblemError
from ...modkit.failpoints import failpoint_async
from ...modkit.flight_recorder import annotate_request, default_recorder
from ...modkit.metrics import default_registry
from ...modkit.telemetry import traceparent_ids
from ...models import bert
from ...models.configs import ModelConfig, get_config
from ...parallel.feasibility import InfeasiblePlanError
from ...device import on_card
from ...runtime.federation import digest_chain, prompt_text
from ...runtime.engine import (EngineConfig, InferenceEngine, SamplingParams,
                               SchedulerSaturated, StepEvent, TenantQuotaExceeded,
                               TenantSaturated)
from ...runtime.lifecycle import (EngineSupervisor, LifecycleConfig, LifecycleStateError,
                                  ReplicaUnavailable)
from ...runtime.pd import PDServingPool
from ...runtime.quant import quant_bits
from ...runtime.replicas import DataParallelServingPool
from ...runtime.scheduler import ContinuousBatchingEngine
from ...runtime.tokenizer import (CHAT_FAMILIES, ByteTokenizer, Tokenizer,
                                  chat_family_for, load_tokenizer, render_chat)
from ..sdk import ChatStreamChunk, LlmWorkerApi, ModelInfo

logger = logging.getLogger("llm_worker")

#: the worker config's ``scheduler`` words
SCHEDULERS = ("continuous", "lockstep")

#: the worker config keys (``llm_gateway.config.worker``); ``batch_window_ms``
#: paces the lockstep batcher only; ``observability`` (``enabled``) gates the
#: census's observability payload
WORKER_KEYS = frozenset({"device", "scheduler", "max_engine_threads", "batch_window_ms",
                         "max_loaded_models", "hbm_bytes", "hbm_headroom_frac",
                         "observability"})


def _parse_lookahead(raw: Any) -> int:
    """Registry ``decode_lookahead`` → ring depth: digits are a depth, bool
    words map to 0 / the default, unset keeps the default; an unparseable
    string falls back to the default with a warning (as in JAX)."""
    default = EngineConfig.decode_lookahead
    if raw is None:
        return default
    if isinstance(raw, bool):
        return default if raw else 0
    word = str(raw).strip().lower()
    if word in ("0", "false", "no", "off"):
        return 0
    if word in ("true", "yes", "on", ""):
        return default
    try:
        return max(0, int(float(word)))
    except ValueError:
        logger.warning("engine_options.decode_lookahead=%r is not a depth or bool word; "
                       "using the default depth %d", raw, default)
        return default


def _flag(raw: Any) -> bool:
    """Registry options can arrive as strings: parse the words, not truthiness."""
    return str(raw).strip().lower() not in ("0", "false", "no", "off")


@dataclass
class EnginePlan:
    """What the worker builds for one registry entry."""

    config: EngineConfig
    chat_family: str
    lifecycle: LifecycleConfig
    #: the checkpoint directory, when the entry names one that exists
    checkpoint: Optional[Path]
    #: replicas of a data-parallel pool (1: one engine)
    dp_replicas: int = 1
    #: replicas of each role of a PD pool (0: no split)
    pd_prefill: int = 0
    pd_decode: int = 0
    #: the worker config's scheduler: "continuous" or "lockstep"
    scheduler: str = "continuous"


def plan_engine(model: ModelInfo, scheduler: str = "continuous") -> EnginePlan:
    """``engine_options`` → :class:`EngineConfig`, field for field as
    ``worker.py:312-397`` maps them (the same defaults and the same default
    page count), then the chat family, the lifecycle knobs and the
    checkpoint. Raises a ``not_ported`` problem for an option the JAX worker
    does not know, and ``ValueError``
    for a ``scheduler`` that is not in :data:`SCHEDULERS`. Under the
    lockstep scheduler the pool and lifecycle options are inert (the JAX
    worker reads them only for the continuous one); ``speculative`` is inert
    under the continuous one, with JAX's warning."""
    if scheduler not in SCHEDULERS:
        raise ValueError(f"llm_gateway worker config: scheduler must be one of "
                         f"{SCHEDULERS}, got {scheduler!r}")
    opts = dict(model.engine_options or {})
    arch_config = opts.pop("model_config", None) or model.provider_model_id
    chat_family = opts.pop("chat_family", None) or chat_family_for(arch_config)
    if chat_family not in CHAT_FAMILIES:
        raise ValueError(f"unknown engine_options.chat_family {chat_family!r} for "
                         f"{model.canonical_id}; known: {CHAT_FAMILIES}")
    max_seq_len = int(opts.pop("max_seq_len", 2048))
    max_batch = int(opts.pop("max_batch", 8))
    page_size = int(opts.pop("prefix_page_size", 64))
    default_pages = max_batch * (-(-max_seq_len // page_size)) * 5 // 4 + 1
    cfg = EngineConfig(
        model=arch_config,
        max_seq_len=max_seq_len,
        max_batch=max_batch,
        dtype=opts.pop("dtype", "bfloat16"),
        eos_token_ids=tuple(opts.pop("eos_token_ids", ()) or ()),
        decode_chunk=int(opts.pop("decode_chunk", 8)),
        quantization=opts.pop("quantization", "none"),
        prefix_cache_pages=int(opts.pop("prefix_cache_pages", default_pages)),
        prefix_page_size=page_size,
        decode_lookahead=_parse_lookahead(opts.pop("decode_lookahead", None)),
        prefill_budget_tokens=int(opts.pop("prefill_budget_tokens", 512)),
        prefill_coalesce=int(opts.pop("prefill_coalesce", 4)),
        mixed_batch=_flag(opts.pop("mixed_batch", True)),
        max_pending=int(opts.pop("max_pending", 2048)),
        tenant_fair=_flag(opts.pop("tenant_fair", True)),
        tenant_default_weight=float(opts.pop("tenant_default_weight", 1.0)),
        tenant_weights={str(k): float(v) for k, v in
                        (opts.pop("tenant_weights", None) or {}).items()},
        tenant_max_slots=int(opts.pop("tenant_max_slots", 0)),
        tenant_soft_pages=int(opts.pop("tenant_soft_pages", 0)),
        tenant_max_pages=int(opts.pop("tenant_max_pages", 0)),
        tenant_max_pending=int(opts.pop("tenant_max_pending", 0)),
        speculative=opts.pop("speculative", "off"),
        spec_k=int(opts.pop("spec_k", 8)),
        draft_model=opts.pop("draft_model", ""),
        draft_checkpoint=opts.pop("draft_checkpoint", ""),
        scheduler_spec_k=int(opts.pop("scheduler_spec_k", 0)),
        spec_min_accept=float(opts.pop("spec_min_accept", 0.0)),
        spec_max_ngram=int(opts.pop("spec_max_ngram", 3)),
        spec_min_ngram=int(opts.pop("spec_min_ngram", 1)),
        tp=int(opts.pop("tp", 1)),
        hbm_bytes_per_device=int(opts.pop("hbm_bytes_per_device", 0)),
    )
    dp_replicas = int(opts.pop("dp_replicas", 1))
    lifecycle = LifecycleConfig.from_config(opts.pop("lifecycle", True))
    pd_prefill = int(opts.pop("pd_prefill_replicas", 0))
    pd_decode = int(opts.pop("pd_decode_replicas", 0))
    # the combinations the JAX worker refuses, with its errors
    if (pd_prefill > 0) != (pd_decode > 0):
        raise ValueError(
            f"engine_options for {model.canonical_id}: pd_prefill_replicas={pd_prefill} "
            f"and pd_decode_replicas={pd_decode} must be set together (each PD role "
            "needs at least one replica)")
    if pd_prefill > 0 and dp_replicas > 1:
        raise ValueError(
            f"engine_options for {model.canonical_id}: the PD split cannot combine with "
            f"dp_replicas={dp_replicas} (the PD pool IS the replica pool; size it with "
            "the pd_*_replicas knobs)")
    if pd_prefill > 0 and cfg.tp > 1:
        raise ValueError(
            f"engine_options for {model.canonical_id}: the PD split cannot combine with "
            f"tp={cfg.tp} (PD replicas pin one device each; tp'd PD groups are a future "
            "rung)")
    if dp_replicas > 1 and cfg.tp > 1:
        raise ValueError(
            f"engine_options for {model.canonical_id}: dp_replicas={dp_replicas} cannot "
            f"combine with tp={cfg.tp} (a dp pool pins one device per replica; "
            "tensor-parallel pools are a future rung)")
    quant_bits(cfg.quantization)  # an unknown word raises here
    if cfg.speculative not in ("off", "ngram", "draft"):
        raise ValueError(f"engine_options for {model.canonical_id}: speculative must be "
                         f"'off', 'ngram' or 'draft', got {cfg.speculative!r}")
    if cfg.speculative != "off" and scheduler == "continuous":
        logger.warning(
            "engine_options.speculative=%r is inert under the continuous scheduler (that "
            "field drives the lockstep bs=1 path); set engine_options.scheduler_spec_k "
            "for batched speculative decoding in the continuous scheduler, or scheduler: "
            "lockstep for this model", cfg.speculative)
    if opts:
        raise ERR.llm.not_ported.error(
            f"engine_options for {model.canonical_id}: {sorted(opts)} are not options "
            "of the JAX worker either")
    ckpt = Path(model.checkpoint_path) if model.checkpoint_path else None
    if ckpt is not None and not ckpt.exists():
        ckpt = None
    if ckpt is None and not cfg.eos_token_ids:
        # synthetic weights: the byte tokenizer's end of sequence
        cfg = EngineConfig(**{**cfg.__dict__, "eos_token_ids": (
            ByteTokenizer(get_config(arch_config).vocab_size).eos_id,)})
    if scheduler == "lockstep":
        return EnginePlan(cfg, chat_family, lifecycle, ckpt, scheduler=scheduler)
    return EnginePlan(cfg, chat_family, lifecycle, ckpt, dp_replicas=dp_replicas,
                      pd_prefill=pd_prefill, pd_decode=pd_decode)


class IncrementalDetokenizer:
    """Streaming detokenization: only the unstable tail (tokens whose text
    a later token may still change, through BPE or UTF-8 merges) is decoded
    again; it moves into the stable text once it decodes cleanly and holds
    at least 8 tokens. O(n) in all, as in JAX.

    Unlike the JAX worker, the text offered for sending holds back a
    trailing run of U+FFFD until the stream ends: a multi-byte character
    split across tokens decodes to U+FFFD until its last byte arrives, and
    a replacement character once sent cannot be taken back. So the streamed
    text is the one-shot decode of the stream's tokens."""

    def __init__(self, tokenizer: Tokenizer, carried: Sequence[int] = ()) -> None:
        self._tok = tokenizer
        #: ``carried``: a failover continuation's tokens, whose text was
        #: already generated; they start the unstable tail, so a character
        #: split across the carried and the new tokens decodes whole
        self._tail: list[int] = list(carried)
        self._stable = ""

    def push(self, token_id: Optional[int], final: bool = False) -> str:
        """Add a token (None adds nothing); returns the text that may be
        sent so far: all of it when ``final``."""
        if token_id is not None:
            self._tail.append(token_id)
        tail_text = self._tok.decode(self._tail)
        if tail_text and not tail_text.endswith("\ufffd") and len(self._tail) >= 8:
            self._stable += tail_text
            self._tail = []
            tail_text = ""
        text = self._stable + tail_text
        return text if final else text.rstrip("\ufffd")


@dataclass
class _EmbedEntry:
    tokenizer: Tokenizer
    params: bert.BertModel
    cfg: ModelConfig


#: the batcher's end of one request's events (after its terminal event, or
#: after the exception that ended its batch)
_STREAM_END = object()


@dataclass
class _Request:
    prompt_ids: list[int]
    sampling: SamplingParams
    queue: asyncio.Queue


class _DynamicBatcher:
    """Collects lockstep requests for up to ``window_ms`` and runs up to
    ``max_batch`` of them as one :meth:`InferenceEngine.generate_stream` on
    the executor, one batch at a time (JAX ``worker.py:119-183``). Each
    request's queue gets its events, then :data:`_STREAM_END`; a failed
    batch puts the exception in every request's queue before the end, so a
    consumer reports the failure and never an empty stream."""

    def __init__(self, engine: InferenceEngine, executor: ThreadPoolExecutor,
                 window_ms: float = 4.0) -> None:
        self._engine = engine
        self._executor = executor
        self._window = window_ms / 1000.0
        self._pending: list[_Request] = []
        #: requests of the batch on the executor now
        self.running = 0
        self._wakeup = asyncio.Event()
        self._task: Optional[asyncio.Task] = None
        self._closed = False

    @property
    def pending(self) -> int:
        return len(self._pending)

    def submit(self, req: _Request) -> None:
        if self._closed:
            raise RuntimeError("the lockstep engine is closed; build a fresh one")
        self._pending.append(req)
        self._wakeup.set()
        if self._task is None or self._task.done():
            self._task = asyncio.ensure_future(self._run())

    def close(self) -> None:
        """No new request; the batch on the executor runs to its end."""
        self._closed = True
        self._wakeup.set()

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        while not self._closed:
            if not self._pending:
                self._wakeup.clear()
                try:
                    await asyncio.wait_for(self._wakeup.wait(), timeout=5.0)
                except asyncio.TimeoutError:
                    if not self._pending:
                        return  # idle exit; the next submit starts a new task
                continue
            await asyncio.sleep(self._window)  # the batching window
            batch = self._pending[:self._engine.config.max_batch]
            del self._pending[:len(batch)]
            self.running = len(batch)
            try:
                await loop.run_in_executor(self._executor, self._drive, loop, batch)
            finally:
                self.running = 0

    def _drive(self, loop: asyncio.AbstractEventLoop, batch: list[_Request]) -> None:
        """The executor thread: the blocking lockstep generation."""

        def put(req: _Request, item: Any) -> None:
            try:
                loop.call_soon_threadsafe(req.queue.put_nowait, item)
            except RuntimeError:  # the event loop closed: nobody is listening
                pass

        try:
            with on_card(self._engine.device):
                for ev in self._engine.generate_stream([r.prompt_ids for r in batch],
                                                       [r.sampling for r in batch]):
                    put(batch[ev.request_index], ev)
        except Exception as e:  # noqa: BLE001 — handed to every consumer of the batch
            logger.exception("lockstep batch generation failed")
            for req in batch:
                put(req, e)
        finally:
            for req in batch:
                put(req, _STREAM_END)


@dataclass
class _EngineEntry:
    config: EngineConfig
    tokenizer: Tokenizer
    #: one continuous engine, or None when a replica pool or the lockstep
    #: engine serves the model
    scheduler: Optional[ContinuousBatchingEngine]
    supervisor: Optional[EngineSupervisor] = None
    model_family: str = "llama"
    last_used: float = 0.0
    est_bytes: int = 0
    #: worker streams open on this engine, from the entry lookup on (a
    #: request is counted before it reaches the engine's queue)
    streams: int = 0
    #: dp_replicas > 1 or a PD split: the pool is the request router
    pool: Optional[DataParallelServingPool] = None
    #: the lockstep scheduler: the engine and the batcher in front of it
    engine: Optional[InferenceEngine] = None
    batcher: Optional[_DynamicBatcher] = None

    @property
    def target(self) -> Any:
        """What continuous requests are submitted to and cancelled at (None
        for the lockstep engine, which takes no cancellation)."""
        return self.pool if self.pool is not None else self.scheduler

    @property
    def idle(self) -> bool:
        if self.streams:
            return False
        if self.batcher is not None:
            return self.batcher.pending == 0 and self.batcher.running == 0
        return self.target.in_flight() == 0

    def close(self, timeout: float = 5.0) -> None:
        if self.batcher is not None:
            self.batcher.close()
        else:
            self.target.close(timeout=timeout)


class LocalTorchWorker(LlmWorkerApi):
    """Engines keyed by canonical model id, built lazily from
    ``ModelInfo.engine_options`` (+ the checkpoint when there is one)."""

    def __init__(self, worker_config: Optional[dict[str, Any]] = None) -> None:
        self._config = dict(worker_config or {})
        unknown = sorted(set(self._config) - WORKER_KEYS)
        if unknown:
            raise ValueError(f"llm_gateway worker config: unknown keys {unknown}")
        self._device = self._config.get("device")
        self._entries: dict[str, _EngineEntry] = {}
        self._embed_entries: dict[str, _EmbedEntry] = {}
        self._embed_build_lock = threading.Lock()
        self._entry_locks: dict[str, asyncio.Lock] = {}
        self._executor = ThreadPoolExecutor(
            max_workers=int(self._config.get("max_engine_threads", 4)),
            thread_name_prefix="torch-worker")
        self._started_at = time.monotonic()
        self._requests_served = 0
        self._tokens_out = 0
        #: request ids with a stream open (a reused client id gets a suffix)
        self._live: set[str] = set()
        #: the federation census's bounded logs: request id → (model, digest
        #: chain, prompt ids) and request id → trace id
        self._prefix_log: OrderedDict[str, tuple[str, list[str], list[int]]] = OrderedDict()
        self._recent_traces: OrderedDict[str, str] = OrderedDict()
        self._census_lock = threading.Lock()

    @property
    def device(self) -> str:
        """Where the engines run: the config's ``device``, else the card."""
        return str(self._device or "cuda")

    # ------------------------------------------------------------------ engines
    def engine(self, canonical_id: str) -> Any:
        """The model's engine (its replica pool, or its lockstep engine),
        once built."""
        entry = self._entries.get(canonical_id)
        if entry is None:
            return None
        return entry.engine if entry.engine is not None else entry.target

    async def _entry_for(self, model: ModelInfo) -> _EngineEntry:
        key = model.canonical_id
        entry = self._entries.get(key)
        if entry is not None:
            entry.last_used = time.monotonic()
            return entry
        lock = self._entry_locks.setdefault(key, asyncio.Lock())
        async with lock:
            entry = self._entries.get(key)
            if entry is not None:
                entry.last_used = time.monotonic()
                return entry
            self._maybe_evict_for(model)
            try:
                entry = await asyncio.get_running_loop().run_in_executor(
                    self._executor, self._build_entry, model)
            except InfeasiblePlanError as e:
                # the engine's gate refused the plan before allocating: a
                # typed 507, never an out-of-memory error mid-build
                raise ERR.llm.infeasible_plan.error(str(e)) from e
            entry.last_used = time.monotonic()
            entry.est_bytes = self._estimate_bytes(model)
            self._entries[key] = entry
            return entry

    def _estimate_bytes(self, model: ModelInfo) -> int:
        """Weights at bf16 plus a dense cache of the engine's slots (the JAX
        formula, used for hot-swap accounting only)."""
        opts = dict(model.engine_options or {})
        arch = opts.get("model_config") or model.provider_model_id
        try:
            cfg = get_config(arch)
        except KeyError:
            return 0
        weights = cfg.param_count() * 2
        max_seq = int(opts.get("max_seq", opts.get("max_seq_len", 2048)))
        slots = int(opts.get("max_batch", 8))
        cache = cfg.num_layers * slots * max_seq * cfg.num_kv_heads * cfg.head_dim * 2 * 2
        return weights + cache

    def _hbm_budget(self) -> Optional[int]:
        """The card's memory; None on the CPU (count-capped eviction only)."""
        dev = resolve_device(self._device)
        if dev.type != "cuda":
            return None
        try:
            return int(torch.cuda.mem_get_info(dev)[1])
        except RuntimeError:
            return int(self._config.get("hbm_bytes", 16 * 1024**3))

    def _maybe_evict_for(self, model: ModelInfo) -> None:
        """Evict idle least-recently-used engines until the incoming model's
        estimated footprint fits: the engine is closed, its graphs and pool
        dropped, and the allocator's cache returned before the next build."""
        max_models = int(self._config.get("max_loaded_models", 0))
        need = self._estimate_bytes(model)

        def must_evict() -> bool:
            if max_models and len(self._entries) >= max_models:
                return True
            budget = self._hbm_budget()
            if budget is not None and need:
                headroom = float(self._config.get("hbm_headroom_frac", 0.1))
                in_use = sum(e.est_bytes for e in self._entries.values())
                return in_use + need > budget * (1.0 - headroom)
            return False

        while self._entries and must_evict():
            idle = [(k, e) for k, e in self._entries.items() if e.idle]
            if not idle:
                logger.warning("hot-swap needed but no idle engine to evict")
                return
            victim_key, victim = min(idle, key=lambda kv: kv[1].last_used)
            logger.info("hot-swap: evicting engine %s (idle %.1fs)", victim_key,
                        time.monotonic() - victim.last_used)
            victim.close(timeout=5.0)
            del self._entries[victim_key]
            del victim
            gc.collect()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()

    def _build_entry(self, model: ModelInfo) -> _EngineEntry:
        """Runs on an executor thread: on CUDA the engine captures its decode
        graphs here and replays them on its scheduler thread."""
        plan = plan_engine(model, str(self._config.get("scheduler", "continuous")))
        cfg = plan.config
        params = None
        tokenizer: Tokenizer
        if plan.checkpoint is not None:
            from ...runtime.weights import load_llama_params

            bits = quant_bits(cfg.quantization)
            params = load_llama_params(plan.checkpoint, get_config(cfg.model),
                                       dtype=getattr(torch, cfg.dtype), device=self._device,
                                       quantize=bits is not None, quant_bits=bits or 8)
            tokenizer = load_tokenizer(plan.checkpoint)
        else:
            tokenizer = ByteTokenizer(get_config(cfg.model).vocab_size)
        if plan.scheduler == "lockstep":
            engine = InferenceEngine(cfg, params=params, device=self._device)
            logger.info("lockstep engine ready for %s (%s on %s, max_batch=%d, max_seq=%d, "
                        "speculative=%s)", model.canonical_id, cfg.model, engine.device,
                        cfg.max_batch, cfg.max_seq_len, cfg.speculative)
            return _EngineEntry(
                config=cfg, tokenizer=tokenizer, scheduler=None, engine=engine,
                model_family=plan.chat_family,
                batcher=_DynamicBatcher(engine, self._executor, window_ms=float(
                    self._config.get("batch_window_ms", 4.0))))
        lifecycle = plan.lifecycle if plan.lifecycle.enabled else None
        if plan.pd_prefill > 0 or plan.dp_replicas > 1:
            n = plan.pd_prefill + plan.pd_decode if plan.pd_prefill > 0 else plan.dp_replicas
            devices = self._pool_devices(n)
            if plan.pd_prefill > 0:
                pool: DataParallelServingPool = PDServingPool(
                    cfg, n_prefill=plan.pd_prefill, n_decode=plan.pd_decode,
                    devices=devices, params=params, lifecycle=lifecycle)
            else:
                pool = DataParallelServingPool(cfg, n_replicas=plan.dp_replicas,
                                               devices=devices, params=params,
                                               lifecycle=lifecycle)
            logger.info("continuous pool ready for %s (%s, %s, slots=%d each, max_seq=%d)",
                        model.canonical_id, cfg.model,
                        f"{plan.pd_prefill} prefill + {plan.pd_decode} decode"
                        if plan.pd_prefill else f"{plan.dp_replicas} replicas",
                        cfg.max_batch, cfg.max_seq_len)
            return _EngineEntry(config=cfg, tokenizer=tokenizer, scheduler=None, pool=pool,
                                model_family=plan.chat_family)
        placement = ({"rank_devices": self._pool_devices(cfg.tp)} if cfg.tp > 1
                     else {"device": self._device})
        scheduler = ContinuousBatchingEngine(cfg, params=params, **placement)
        supervisor = None
        if plan.lifecycle.enabled:
            def _rebuild(old: ContinuousBatchingEngine) -> ContinuousBatchingEngine:
                # a fresh engine off the spent one's weights (under tp, its
                # rank slices)
                return ContinuousBatchingEngine(cfg, params=old.params, **placement)

            supervisor = EngineSupervisor(_rebuild, plan.lifecycle, name=model.canonical_id)
        logger.info("continuous engine ready for %s (%s on %s, slots=%d, max_seq=%d)",
                    model.canonical_id, cfg.model, scheduler.device, cfg.max_batch,
                    cfg.max_seq_len)
        return _EngineEntry(config=cfg, tokenizer=tokenizer, scheduler=scheduler,
                            supervisor=supervisor, model_family=plan.chat_family)

    def _pool_devices(self, n: int) -> Optional[list[Any]]:
        """A pool's (or a tp engine's rank) devices: the visible CUDA cards
        (None) for the default device, else ``n`` times the worker's device
        (the CPU, or the one card it names)."""
        dev = resolve_device(self._device)
        if dev.type == "cuda" and dev.index is None:
            return None
        return [dev] * n

    # ------------------------------------------------------------------ streams
    def chat_stream(self, model: ModelInfo, messages: list[dict],
                    params: dict) -> AsyncIterator[ChatStreamChunk]:
        # the rendered template carries bos and specials literally: encoding
        # must not add a second bos. The census digests the raw message text,
        # as the federated router does on its side of the wire
        return self._stream(model, params, lambda entry: entry.tokenizer.encode(
            render_chat(messages, entry.model_family), add_specials=False),
            prompt_text(messages=messages))

    def completion_stream(self, model: ModelInfo, prompt: str,
                          params: dict) -> AsyncIterator[ChatStreamChunk]:
        """Raw text completion: the prompt tokenized verbatim, no template."""
        return self._stream(model, params, lambda entry: entry.tokenizer.encode(prompt),
                            prompt_text(prompt=prompt))

    async def _stream(self, model: ModelInfo, params: dict,
                      encode: Callable[[_EngineEntry], list[int]],
                      census_text: str) -> AsyncIterator[ChatStreamChunk]:
        """One request: the model's engine (built on first use), the prompt's
        ids, and :meth:`_generate_from_ids`, with the stream counted on the
        entry from the lookup on, with no await between, so hot-swap never
        closes an engine a stream is about to use. Closing this generator
        does not close the inner one by itself, hence the explicit aclose."""
        entry = await self._entry_for(model)
        prompt_ids = encode(entry)
        entry.streams += 1
        agen = self._generate_from_ids(entry, model, prompt_ids, params, census_text)
        try:
            async for chunk in agen:
                yield chunk
        finally:
            try:
                await agen.aclose()
            finally:
                entry.streams -= 1

    def _submit(self, entry: _EngineEntry, prompt_ids: Sequence[int],
                sampling: SamplingParams, queue: asyncio.Queue, request_id: str,
                params: dict, model_id: str) -> None:
        loop = asyncio.get_running_loop()

        def emit(ev: StepEvent) -> None:
            # the scheduler thread: hand over, nothing else
            try:
                loop.call_soon_threadsafe(queue.put_nowait, ev)
            except RuntimeError:  # the event loop closed: nobody is listening
                pass

        deadline: Optional[float] = None
        raw_deadline = params.get("_deadline_ms")
        if raw_deadline:
            try:
                deadline = time.monotonic() + float(raw_deadline) / 1000.0
            except (TypeError, ValueError):
                deadline = None
        tenant = str(params.get("_tenant_id") or "default")
        try:
            entry.target.submit(list(prompt_ids), sampling, emit=emit,
                                request_id=request_id, trace=params.get("_traceparent"),
                                deadline=deadline, tenant=tenant)
        except TenantSaturated as e:
            raise ERR.llm.tenant_saturated.error(str(e), retry_after_s=e.retry_after_s,
                                                 tenant=e.tenant)
        except TenantQuotaExceeded as e:
            raise ERR.llm.tenant_quota_exceeded.error(str(e), retry_after_s=e.retry_after_s,
                                                      tenant=e.tenant)
        except SchedulerSaturated as e:
            raise ERR.llm.scheduler_saturated.error(str(e), retry_after_s=e.retry_after_s)
        except ValueError as e:
            raise ERR.llm.unsupported_param.error(str(e))
        except RuntimeError as e:
            # a break or close racing the servable() probe (the supervisor
            # rebuilds on the next request), or a pool with no healthy
            # replica while the lifecycle manager rebuilds
            raise ERR.llm.replica_unavailable.error(str(e), retry_after_s=1.0)
        # the owning model on the flight record (the scheduler does not know
        # which registry entry owns it): the doctor's per-model objectives
        # and the live table's model column read it
        annotate_request(request_id, model=model_id, tenant=tenant)

    async def _generate_from_ids(self, entry: _EngineEntry, model: ModelInfo,
                                 prompt_ids: list[int], params: dict,
                                 census_text: str) -> AsyncIterator[ChatStreamChunk]:
        # an armed raise crashes the job at the worker boundary, before the
        # engine sees it
        await failpoint_async("llm_gateway.worker_stream")
        limits = model.limits or {}
        limits_max = int(limits.get("max_output_tokens", 1024))
        sampling = SamplingParams(
            max_tokens=min(int(params.get("max_tokens", 256)), limits_max),
            temperature=float(params.get("temperature", 0.0)),
            top_p=float(params.get("top_p", 1.0)),
            top_k=int(params.get("top_k", 0)),
            seed=params.get("seed"),
        )
        max_input = int(limits.get("max_input_tokens", 0))
        if max_input and len(prompt_ids) > max_input:
            raise ERR.llm.context_length_exceeded.error(
                f"prompt of {len(prompt_ids)} tokens exceeds model limit {max_input}")
        if len(prompt_ids) >= entry.config.max_seq_len:
            raise ERR.llm.context_length_exceeded.error(
                f"prompt of {len(prompt_ids)} tokens exceeds engine window "
                f"{entry.config.max_seq_len}")
        # a federated failover's continuation: the surviving host prefills
        # the prompt and the tokens already delivered, so the client's stream
        # goes on as if the host had not changed
        n_prompt = len(prompt_ids)
        resume_ids = [int(t) for t in (params.get("_resume_token_ids") or ())]
        if resume_ids:
            prompt_ids = list(prompt_ids) + resume_ids
            if len(prompt_ids) >= entry.config.max_seq_len:
                raise ERR.llm.context_length_exceeded.error(
                    f"prompt of {n_prompt} tokens + {len(resume_ids)} carried failover "
                    f"tokens exceeds engine window {entry.config.max_seq_len}")
        request_id = params.get("_request_id") or f"chat-{uuid.uuid4().hex[:20]}"
        if request_id in self._live:
            request_id = f"{request_id}-{uuid.uuid4().hex[:8]}"
        self._note_census(request_id, model.canonical_id, census_text, prompt_ids[:n_prompt],
                          params.get("_traceparent"))
        if entry.scheduler is not None and not entry.scheduler.servable() \
                and entry.supervisor is not None:
            # rebuild in place off the event loop before admitting
            try:
                entry.scheduler = await asyncio.get_running_loop().run_in_executor(
                    self._executor, entry.supervisor.ensure, entry.scheduler)
            except ReplicaUnavailable as e:
                raise ERR.llm.replica_unavailable.error(str(e), retry_after_s=e.retry_after_s)
        #: where the request is cancelled (None: the lockstep engine)
        engine = entry.target
        queue: asyncio.Queue = asyncio.Queue()
        if entry.batcher is not None:
            entry.batcher.submit(_Request(list(prompt_ids), sampling, queue))
        else:
            self._submit(entry, prompt_ids, sampling, queue, request_id, params,
                         model.canonical_id)
        self._live.add(request_id)
        stop_strings = tuple(params.get("stop", ()) or ())
        max_stop_len = max((len(s) for s in stop_strings), default=0)
        detok = IncrementalDetokenizer(entry.tokenizer, resume_ids)
        #: what the client already holds (a continuation's carried text)
        sent_text = str(params.get("_resume_sent_text") or "") if resume_ids else ""
        #: federated: one chunk a token event, text or not (the gateway keeps
        #: an exact token ledger for failover and drops empty chunks)
        fed_stream = bool(params.get("_fed_token_stream"))
        stop_hit = False
        n_tokens = 0
        #: flips once the engine ended the request: the finally below
        #: cancels engine work only for true abandonment
        stream_done = False
        try:
            while True:
                item = await queue.get()
                if item is _STREAM_END:
                    # the lockstep batch ended without this request's terminal
                    stream_done = True
                    raise ProblemError.internal("generation ended without a finish event")
                if isinstance(item, Exception):
                    stream_done = True
                    raise ProblemError.internal(f"generation failed: {item}")
                ev: StepEvent = item
                if ev.finished == "error":
                    stream_done = True
                    raise ProblemError.internal("generation failed in scheduler")
                if ev.finished == "cancelled":
                    stream_done = True
                    raise ERR.llm.client_closed_request.error("request was cancelled")
                if ev.finished == "deadline":
                    stream_done = True
                    if entry.supervisor is not None and n_tokens > 0:
                        entry.supervisor.note_ok()
                    if n_tokens == 0:
                        # 408 when it lapsed while still queued (it never took
                        # a slot), 504 when it lapsed after admission: the
                        # phase on the flight record's terminal event
                        rec = default_recorder.lookup(request_id) or {}
                        if (rec.get("timeline") or [{}])[-1].get("phase") == "queued":
                            raise ERR.llm.request_timeout.error(
                                "request deadline lapsed before admission "
                                "(X-Request-Deadline-Ms / gateway default TTL); it never "
                                "occupied a slot")
                        raise ERR.llm.deadline_exceeded.error(
                            "request deadline lapsed before any output "
                            "(X-Request-Deadline-Ms / gateway default TTL)")
                    # mid-stream lapse: the held-back text, then the finish
                    # reason (no re-status once the stream flows)
                    rest = detok.push(None, final=True)[len(sent_text):]
                    if rest and not stop_hit:
                        yield ChatStreamChunk(request_id=request_id, text=rest)
                    self._requests_served += 1
                    self._tokens_out += n_tokens
                    yield ChatStreamChunk(request_id=request_id,
                                          finish_reason="deadline_exceeded",
                                          usage={"input_tokens": len(prompt_ids),
                                                 "output_tokens": n_tokens})
                    return
                if ev.token_id >= 0:
                    n_tokens += 1
                full_text = detok.push(ev.token_id if ev.token_id >= 0
                                       and ev.finished != "stop" else None,
                                       final=ev.finished is not None)
                delta = full_text[len(sent_text):]
                if stop_strings and not stop_hit:
                    # stop-string scan over the recent window only
                    window_start = max(0, len(sent_text) - max_stop_len)
                    window = full_text[window_start:]
                    hit_rel = min((window.find(s) for s in stop_strings
                                   if window.find(s) >= 0), default=-1)
                    if hit_rel >= 0:
                        delta = full_text[len(sent_text):window_start + hit_rel]
                        stop_hit = True
                if delta:
                    sent_text += delta
                if delta or (fed_stream and ev.token_id >= 0):
                    yield ChatStreamChunk(request_id=request_id, text=delta,
                                          token_id=ev.token_id if ev.token_id >= 0 else None)
                if ev.finished or stop_hit:
                    stream_done = True
                    self._requests_served += 1
                    self._tokens_out += n_tokens
                    if entry.supervisor is not None and (
                            stop_hit or ev.finished in ("stop", "length")):
                        entry.supervisor.note_ok()
                    reason = "stop" if (stop_hit or ev.finished == "stop") else ev.finished
                    yield ChatStreamChunk(request_id=request_id, finish_reason=reason,
                                          usage={"input_tokens": len(prompt_ids),
                                                 "output_tokens": n_tokens})
                    if stop_hit and not ev.finished:
                        # let the engine finish the request; drop its events
                        while True:
                            tail = await queue.get()
                            if tail is _STREAM_END or isinstance(tail, Exception) \
                                    or tail.finished:
                                break
                    return
        finally:
            self._live.discard(request_id)
            if not stream_done and engine is not None:
                # the consumer let go first (client disconnect, gateway
                # timeout, half-consumed stream): free the slot, pages and
                # pins within one round instead of decoding for nobody
                try:
                    engine.cancel(request_id, reason="client_disconnect")
                except Exception:  # noqa: BLE001 — teardown must not raise
                    logger.exception("cancel-on-teardown failed for %s", request_id)

    # ------------------------------------------------------------------ embeddings
    async def embed(self, model: ModelInfo, inputs: list[str],
                    params: dict) -> tuple[list[list[float]], int]:
        """(one L2-normalised vector per input, the inputs' token count by
        the model's tokenizer), computed on an executor thread."""
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, self._embed_blocking, model, inputs, params)

    def _embed_blocking(self, model: ModelInfo, inputs: list[str],
                        params: dict) -> tuple[list[list[float]], int]:
        key = f"embed::{model.canonical_id}"
        with self._embed_build_lock:  # single-flight: one build a model
            entry = self._embed_entries.get(key)
            if entry is None:
                entry = self._build_embed_entry(key, model)
        cfg, dev = entry.cfg, entry.params.device
        max_len = min(cfg.max_position, 128)
        out: list[list[float]] = []
        total_tokens = 0
        # fixed batches of 8 rows, padded to max_len
        for i in range(0, len(inputs), 8):
            chunk = inputs[i:i + 8]
            ids = np.zeros((8, max_len), np.int32)
            mask = np.zeros((8, max_len), np.int32)
            for j, text in enumerate(chunk):
                toks = entry.tokenizer.encode(text)[:max_len]
                total_tokens += len(toks)
                ids[j, :len(toks)] = toks
                mask[j, :len(toks)] = 1
            with torch.inference_mode():
                emb = bert.embed_pooled(entry.params, cfg, to_device(ids, dev),
                                        to_device(mask, dev))
            out.extend(emb[:len(chunk)].cpu().tolist())  # sync-point: the batch's one read
        return out, total_tokens

    def _build_embed_entry(self, key: str, model: ModelInfo) -> _EmbedEntry:
        cfg = get_config(dict(model.engine_options or {}).get("model_config")
                         or model.provider_model_id)
        dev = resolve_device(self._device)
        if model.checkpoint_path:
            if not Path(model.checkpoint_path).exists():
                # random vectors for a model that names its weights would
                # poison the caller's vector store: fail instead
                raise FileNotFoundError(f"checkpoint_path {model.checkpoint_path!r} for "
                                        f"{model.canonical_id} does not exist")
            from ...runtime.weights import load_bert_params

            params = bert.from_state_dict(load_bert_params(model.checkpoint_path, cfg,
                                                           device=dev), cfg, dev)
            tokenizer = load_tokenizer(model.checkpoint_path, cfg.vocab_size)
            if isinstance(tokenizer, ByteTokenizer):
                logger.warning("checkpoint %s has no tokenizer.json: falling back to byte "
                               "tokenization, embeddings will NOT match the original model",
                               model.checkpoint_path)
        else:
            logger.warning("embedding model %s has no checkpoint_path: serving "
                           "RANDOM-WEIGHT embeddings (dev/synthetic mode only)",
                           model.canonical_id)
            params = bert.init_params(cfg, 0, device=dev)
            tokenizer = ByteTokenizer(cfg.vocab_size)
        entry = _EmbedEntry(tokenizer=tokenizer, params=params, cfg=cfg)
        self._embed_entries[key] = entry
        return entry

    # ---------------------------------------------------------- observability
    def schedulers(self) -> list[tuple[str, Any]]:
        """(name, continuous engine) pairs, pool replicas as ``name[i]``:
        the doctor's watchdogs and the monitoring gauges read each one. A
        snapshot: the doctor's thread calls it while the event loop builds
        or evicts entries."""
        out: list[tuple[str, Any]] = []
        for name, e in dict(self._entries).items():
            if e.scheduler is not None:
                out.append((name, e.scheduler))
            elif e.pool is not None:
                out.extend((f"{name}[{i}]", eng) for i, eng in enumerate(list(e.pool.replicas)))
        return out

    def replica_capacity(self) -> dict[str, Any]:
        """The replica census the doctor scales its shedding with, and the
        ``llm_replicas_healthy`` / ``llm_replicas_benched`` source. A single
        engine is one replica: serving while servable, benched when its
        supervisor benched it."""
        counts = {"replicas": 0, "serving": 0, "healthy": 0, "probation": 0,
                  "draining": 0, "drained": 0, "quarantined": 0,
                  "rebuilding": 0, "benched": 0}
        for entry in dict(self._entries).values():
            if entry.pool is not None and entry.pool.lifecycle is not None:
                c = entry.pool.lifecycle.counts()
                counts["replicas"] += c["replicas"]
                counts["serving"] += c["serving"]
                for k in ("healthy", "probation", "draining", "drained",
                          "quarantined", "rebuilding", "benched"):
                    counts[k] += c[k]
            elif entry.pool is not None:
                per = entry.pool.stats()
                counts["replicas"] += per["replicas"]
                counts["serving"] += per["healthy"]
                counts["healthy"] += per["healthy"]
            elif entry.scheduler is not None:
                counts["replicas"] += 1
                sup = entry.supervisor
                if sup is not None and sup.benched:
                    counts["benched"] += 1
                elif entry.scheduler.servable():
                    counts["serving"] += 1
                    counts["healthy"] += 1
                else:
                    counts["quarantined"] += 1
        return counts

    def tenant_usage(self) -> dict[str, dict[str, Any]]:
        """Per-tenant live accounting summed over every continuous engine
        (pool replicas included), with the per-model rows: the
        ``/v1/monitoring/tenants`` source."""
        out: dict[str, dict[str, Any]] = {}
        for name, sched in self.schedulers():
            try:
                rows = sched.tenant_snapshot()
            except Exception:  # noqa: BLE001 — a dying engine
                continue
            for tenant, row in rows.items():
                agg = out.setdefault(tenant, {
                    "tenant": tenant, "charged_tokens": 0, "active_slots": 0, "pages": 0,
                    "pending": 0, "soft_yields": 0, "virtual_counter": 0.0,
                    "rejections": {}, "per_model": {}})
                for key in ("charged_tokens", "active_slots", "pages", "pending",
                            "soft_yields"):
                    agg[key] += row.get(key, 0)
                agg["virtual_counter"] = round(
                    agg["virtual_counter"] + row.get("virtual_counter", 0.0), 3)
                for reason, n in (row.get("rejections") or {}).items():
                    agg["rejections"][reason] = agg["rejections"].get(reason, 0) + n
                agg["per_model"][name] = row
        return out

    # -------------------------------------------------- replica control plane
    def _replica_rows(self) -> list[tuple[dict[str, Any], _EngineEntry, int]]:
        """(row, entry, replica index) over every entry: pool replicas
        (controllable with a lifecycle manager) and single engines (listed
        with their supervisor's state). The flat index is what
        :meth:`replica_control` addresses."""
        rows: list[tuple[dict[str, Any], _EngineEntry, int]] = []

        def engine_row(eng: Any) -> dict[str, Any]:
            try:
                st = eng.stats()
                return {k: st.get(k) for k in ("broken", "closed", "active", "pending",
                                                "prefilling", "suspended", "device")}
            except Exception:  # noqa: BLE001 — a dying engine
                return {"broken": "stats() failed"}

        for name, entry in sorted(dict(self._entries).items()):
            if entry.pool is not None:
                lc = entry.pool.lifecycle
                roles = getattr(entry.pool, "_roles", None)
                for i, eng in enumerate(list(entry.pool.replicas)):
                    engine = engine_row(eng)
                    sr = lc.status_row(i) if lc is not None else None
                    rows.append(({
                        "index": len(rows), "model": name, "replica": i, "pool": True,
                        "controllable": lc is not None,
                        "state": sr["state"] if sr is not None else (
                            "broken" if engine.get("broken") else "healthy"),
                        "role": roles[i] if roles is not None else None,
                        "lifecycle": sr, "engine": engine, "mesh": self._mesh_of(eng),
                    }, entry, i))
            elif entry.scheduler is not None:
                engine = engine_row(entry.scheduler)
                sup = entry.supervisor
                rows.append(({
                    "index": len(rows), "model": name, "replica": 0, "pool": False,
                    "controllable": False,
                    "state": ("benched" if sup is not None and sup.benched
                              else "drained" if engine.get("closed")
                              else "broken" if engine.get("broken") else "healthy"),
                    "role": None,
                    "supervisor": sup.status() if sup is not None else None,
                    "engine": engine, "mesh": self._mesh_of(entry.scheduler),
                }, entry, 0))
        return rows

    @staticmethod
    def _mesh_of(engine: Any) -> Optional[dict[str, Any]]:
        """A replica's serving-mesh block (tp degree, rank devices, sharded
        page bytes, the feasibility plan) from ``mesh_info()``; None for an
        engine without it or one that fails to answer."""
        fn = getattr(engine, "mesh_info", None)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:  # noqa: BLE001 — monitoring must not fail on a dying engine
            return None

    def replicas_view(self) -> list[dict[str, Any]]:
        """One row a replica (pool replicas and single engines)."""
        return [row for row, _, _ in self._replica_rows()]

    def replica_control(self, index: int, action: str, deadline_s: Optional[float] = None,
                        expect_model: Optional[str] = None) -> dict[str, Any]:
        """drain / undrain / restart replica ``index`` of the flat view.
        Raises KeyError (no such index), LifecycleStateError (illegal from
        its state, not a supervised pool replica, or ``expect_model`` no
        longer the row's model) and ValueError (an unknown action)."""
        rows = self._replica_rows()
        if not 0 <= index < len(rows):
            raise KeyError(f"replica index {index} out of range ({len(rows)} replicas)")
        row, entry, i = rows[index]
        if expect_model is not None and expect_model != row["model"]:
            raise LifecycleStateError(
                f"replica index {index} now resolves to {row['model']!r}, not "
                f"{expect_model!r}: the entry table changed since the listing")
        lc = entry.pool.lifecycle if entry.pool is not None else None
        if lc is None:
            raise LifecycleStateError(
                f"replica {index} ({row['model']}) is not a supervised pool replica; "
                "drain/undrain/restart need dp_replicas > 1 or a PD split with "
                "lifecycle enabled")
        if action == "drain":
            result = lc.drain(i, deadline_s=deadline_s)
        elif action == "undrain":
            result = lc.undrain(i)
        elif action == "restart":
            result = lc.restart(i)
        else:
            raise ValueError(f"unknown replica action {action!r}")
        return {"index": index, "model": row["model"], "replica": i, "action": action,
                "lifecycle": result}

    # ------------------------------------------------------- federation census
    def _note_census(self, request_id: str, model_key: str, census_text: str,
                     prompt_ids: list[int], trace: Optional[str]) -> None:
        """Bounded gossip bookkeeping on the serving path: this prompt's
        digest chain and ids (probed against the live prefix pools at census
        time) and the request → trace join. Never raises."""
        try:
            chain = digest_chain(census_text) if census_text else []
            with self._census_lock:
                if chain:
                    self._prefix_log[request_id] = (model_key, chain, list(prompt_ids))
                    while len(self._prefix_log) > 64:
                        self._prefix_log.popitem(last=False)
                if trace:
                    trace_id, _ = traceparent_ids(trace)
                    if trace_id:
                        self._recent_traces[request_id] = trace_id
                        while len(self._recent_traces) > 64:
                            self._recent_traces.popitem(last=False)
        except Exception:  # noqa: BLE001 — gossip must not fail serving
            pass

    def _prefix_gossip(self) -> dict[str, list[list[str]]]:
        """model → digest chains of the prefixes resident in KV now: each
        logged prompt is probed with ``peek_prefix_len`` against the model's
        live prefix pools and its chain cut to the covered fraction, so an
        evicted prefix leaves the gossip within one heartbeat. A stale hint
        costs one prefill on the wrong host, never correctness."""
        with self._census_lock:
            logged = list(self._prefix_log.values())
        out: dict[str, list[list[str]]] = {}
        for model_key, chain, ids in logged:
            entry = self._entries.get(model_key)
            if entry is None or not ids:
                continue
            pools = []
            if entry.scheduler is not None:
                pools.append(entry.scheduler.pool)
            if entry.pool is not None:
                pools.extend(getattr(r, "pool", None) for r in list(entry.pool.replicas))
            best = 0
            for pool in pools:
                if pool is None:
                    continue
                try:
                    best = max(best, int(pool.peek_prefix_len(list(ids))))
                except Exception:  # noqa: BLE001 — a dying engine
                    continue
            if best <= 0:
                continue
            trimmed = chain[:min(len(chain), max(1, (len(chain) * best) // len(ids)))]
            chains = out.setdefault(model_key, [])
            if trimmed not in chains:
                chains.append(trimmed)
        return out

    def federation_census(self) -> dict[str, Any]:
        """The heartbeat's gossip: live load, capacity and tenants, loaded
        models, KV-resident prefix digests, recent request → trace ids, and
        the observability payload."""
        load = 0
        for _name, sched in self.schedulers():
            try:
                st = sched.stats()
                load += int(st.get("active", 0)) + int(st.get("pending", 0)) \
                    + int(st.get("prefilling", 0))
            except Exception:  # noqa: BLE001 — a dying engine
                continue
        with self._census_lock:
            traces = dict(self._recent_traces)
        census = {
            "load": load,
            "capacity": {**self.replica_capacity(), "tenants": self.tenant_usage()},
            "models": sorted(self._entries),
            "requests_served": self._requests_served,
            "prefix": self._prefix_gossip(),
            "recent_traces": traces,
        }
        obs = self.observability_census()
        if obs is not None:
            census["observability"] = obs
        return census

    def observability_census(self) -> Optional[dict[str, Any]]:
        """The census's observability payload: the ``llm_*`` metrics
        snapshot, a compact doctor report (state, the last evaluation's
        reasons and objective rows, trips, shed tenants) and the recent
        terminals; None when the worker config's ``observability.enabled``
        is false. Never raises: a broken export leaves a bare heartbeat."""
        if not bool((self._config.get("observability") or {}).get("enabled", True)):
            return None
        try:
            doc = default_doctor.report()
            last = doc.get("last_eval") or {}
            return {
                "metrics": default_registry.snapshot("llm_"),
                "doctor": {
                    "state": doc.get("state"),
                    "state_since": doc.get("state_since"),
                    "reasons": list(last.get("reasons") or ()),
                    "objectives": list(last.get("objectives") or ()),
                    "watchdog_trips": doc.get("watchdog_trips") or {},
                    "shed_tenants": doc.get("shed_tenants") or [],
                    "evals": doc.get("evals", 0),
                },
                "terminals": default_recorder.recent(8),
                "ts": time.time(),
            }
        except Exception:  # noqa: BLE001 — the heartbeat must still go out
            return None

    # ------------------------------------------------------------------ health
    async def health(self) -> dict[str, Any]:
        return {
            "status": "ok",
            "devices": [str(torch.device(self._device or "cuda"))],
            "loaded_models": sorted(self._entries) + sorted(self._embed_entries),
            "schedulers": {k: {key: v for key, v in e.scheduler.stats().items()
                               if key != "round_timings"}
                           for k, e in self._entries.items() if e.scheduler is not None},
            "pools": {k: {key: v for key, v in e.pool.stats().items()
                          if key != "per_replica"}
                      for k, e in self._entries.items() if e.pool is not None},
            "requests_served": self._requests_served,
            "tokens_out": self._tokens_out,
            "uptime_s": round(time.monotonic() - self._started_at, 1),
        }

    def close(self) -> None:
        """Retire every engine (ending whatever is in flight) and the
        executor."""
        for entry in list(self._entries.values()):
            entry.close(timeout=5.0)
        self._entries.clear()
        self._embed_entries.clear()
        self._executor.shutdown(wait=False, cancel_futures=True)


# ------------------------------------------------------------- serve mode
#
# ``python -m cyberfabric_core_tpu_torch.modules.llm_gateway.worker`` with a
# FED_WORKER_CONFIG env JSON runs this worker as a federation host:
#
#   {"hub_endpoint": "127.0.0.1:PORT",      # the gateway's grpc_hub
#    "host": "worker-0",                    # display name in the registry
#    "auth_token": "...",                   # bearer for this LlmWorkerService
#    "hub_auth_token": "...",               # bearer for the hub's registry
#    "worker": {...LocalTorchWorker config...},
#    "observability": {"enabled", "allow_fault_injection", "doctor"},
#    "models": [...model_ref dicts, built at boot...],
#    "roles": ["chat"], "heartbeat_interval_s": 1.0,
#    "bind_addr": "127.0.0.1:0", "advertise_host": "127.0.0.1"}
#
# Boot: build the engines → bind LlmWorkerService → announce → print the
# READY line → heartbeat the census (announcing again when evicted) →
# SIGTERM withdraws.

async def serve(cfg: dict[str, Any]) -> None:
    from ..grpc_hub import WorkerRegistryClient
    from ...modkit.transport_grpc import JsonGrpcServer
    from .grpc_service import (model_from_ref, register_llm_worker_service,
                               register_worker_observability_service)

    worker_cfg = dict(cfg.get("worker") or {})
    obs_cfg = dict(cfg.get("observability") or {})
    # the worker-level flag is what observability_census() reads
    worker_cfg.setdefault("observability", {"enabled": obs_cfg.get("enabled", True)})
    obs_enabled = bool(obs_cfg.get("enabled", True))

    worker = LocalTorchWorker(worker_cfg)
    if obs_enabled:
        # this process's own doctor: burn rates over its own terminals, fed
        # back to the gateway on every heartbeat
        default_doctor.configure(DoctorConfig.from_config(obs_cfg.get("doctor") or {}))
        default_doctor.set_scheduler_provider(worker.schedulers)
        default_doctor.set_capacity_provider(worker.replica_capacity)
        default_doctor.ensure_started()
    server = JsonGrpcServer()
    registry: Optional[WorkerRegistryClient] = None
    instance_id: Optional[str] = None
    try:
        models = [model_from_ref(m) for m in (cfg.get("models") or [])]
        for m in models:
            # pay the engine build (and on the card its graph capture) at
            # boot, not on the first routed request
            await worker._entry_for(m)
        register_llm_worker_service(server, worker, auth_token=cfg.get("auth_token"))
        if obs_enabled:
            register_worker_observability_service(
                server, allow_fault_injection=bool(obs_cfg.get("allow_fault_injection")),
                auth_token=cfg.get("auth_token"))
        port = await server.start(str(cfg.get("bind_addr", "127.0.0.1:0")))
        endpoint = f"{cfg.get('advertise_host', '127.0.0.1')}:{port}"
        host_label = str(cfg.get("host") or f"worker-{os.getpid()}")
        registry = WorkerRegistryClient(str(cfg["hub_endpoint"]),
                                        auth_token=cfg.get("hub_auth_token"))
        info = {"host": host_label, "endpoint": endpoint, "pid": os.getpid(),
                "models": [m.canonical_id for m in models],
                "roles": list(cfg.get("roles") or ())}
        instance_id = str((await registry.announce(info))["instance_id"])
        await registry.heartbeat(instance_id, worker.federation_census())
        # the parent blocks on this line before it routes to the host
        print(json.dumps({"ready": True, "endpoint": endpoint, "instance_id": instance_id,
                          "host": host_label, "pid": os.getpid()}), flush=True)

        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        interval = float(cfg.get("heartbeat_interval_s", 1.0))
        while not stop.is_set():
            try:
                await asyncio.wait_for(stop.wait(), timeout=interval)
                break
            except asyncio.TimeoutError:
                pass
            try:
                if not await registry.heartbeat(instance_id, worker.federation_census()):
                    # evicted (a hub restart or a missed lease window):
                    # announce again under a fresh lease
                    instance_id = str((await registry.announce(info))["instance_id"])
            except Exception:  # noqa: BLE001 — a hub outage must not end the host
                logger.exception("federation heartbeat failed")
    finally:
        if registry is not None:
            if instance_id is not None:
                try:
                    await registry.withdraw(instance_id)  # graceful departure
                except Exception:  # noqa: BLE001 — the hub may be gone already
                    pass
            await registry.close()
        await server.stop()
        if obs_enabled:
            default_doctor.stop()
            default_doctor.detach_recorder()
            default_doctor.set_scheduler_provider(None)
            default_doctor.set_capacity_provider(None)
        await asyncio.get_running_loop().run_in_executor(None, worker.close)


def main() -> int:
    raw = os.environ.get("FED_WORKER_CONFIG")
    if not raw:
        print("worker serve mode requires the FED_WORKER_CONFIG env var (JSON: "
              "hub_endpoint, host, worker, models, ...)", file=sys.stderr)
        return 2
    logging.basicConfig(level=logging.WARNING,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    asyncio.run(serve(json.loads(raw)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
