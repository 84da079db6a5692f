"""Continuous batching over a paged KV pool or a dense cache (counterpart of
``runtime/scheduler.py``).

The JAX ``ContinuousBatchingEngine`` on one CUDA device, on three paths:

- **Mixed** (the default: paged pool, ``mixed_batch=True``). ``submit``
  enqueues a request from any thread; a scheduler thread admits it into a
  free slot in PREFILL phase with no device work (``_admit_mixed``): the
  prompt is matched against the radix prefix cache and the slot's chain
  starts with the matched pages, so only the uncached suffix is prefilled.
  Every round that carries prompt chunks is a ragged MIXED round
  (``_decode_round_mixed``): prompt chunks, FIFO across prefilling slots and
  within ``prefill_budget_tokens``, ride in the same forward as the decode
  rows (q_len 1) through :func:`ops.paged_attention.ragged_paged_attention`,
  which reads a hit's cached history through the shared pages. The span
  width ``q_max`` is the prefill bucket of the largest chunk rounded up to
  8, as in JAX. A request's first token is sampled in the dispatch that
  runs its final chunk; the slot flips to decode and its prompt's full
  pages are published to the tree (``PrefixKVPool.commit_chain``).
- **Phase-separated** (paged pool, ``mixed_batch=False``). Admission
  (``_admit_phase_separated``) takes pending requests FIFO, paced by
  ``prefill_budget_tokens`` (at least one per round), and prefills them
  before the next decode round. With ``prefill_coalesce`` > 1 each request
  is matched once up front: cold requests of one bucket coalesce into one
  ``batch_prefill`` dispatch of up to ``prefill_coalesce`` rows (padded to a
  power of two), prefix hits and the rest prefill alone. A cold prefill is
  :func:`models.llama.prefill_collect` (flash kernel when
  ``resolve_use_flash``); a hit runs :func:`suffix_prefill` over the cached
  pages gathered into a fresh cache (plain attention, as the JAX program
  does). The collected KV goes into pool pages (``PrefixKVPool.admit_slot``)
  and the first token is sampled in the same dispatch from the slot's own
  generator.
- **Dense** (``prefix_cache_pages=0``). The same cold prefill, one request
  per dispatch, into a dense cache ``[L, max_batch, max_seq_len, Hkv, D]``
  (:func:`models.llama.insert_slot_kv`); decode rounds run
  :func:`.engine.build_decode_chunk_fn` over it, synchronously, as in JAX.
  Sampling shares one stream across the batch, so ``submit`` rejects a
  per-request seed.

On the paged paths, rounds with no prompt chunks run ``decode_chunk`` fused
decode steps through :func:`ops.paged_attention.paged_decode_attention`: on
CUDA one replay of a CUDA graph captured when the engine is built
(:class:`.programs.PagedDecodeChunk`), on the CPU the same body called
eagerly. They run through the **lookahead ring** (``decode_lookahead``
deep): a round drains the oldest in-flight chunk while up to ``depth``
later chunks, each chained off the device outputs of the one before, are
already queued, so the host's emit loop overlaps the device. Dispatch commits nothing: a chunk's outputs
become the engine's state only when it is drained. An admission, an
activation or a stop the device could not see bumps the epoch and the
stale ring suffix is discarded; since a ``torch.Generator`` advances when a
draw is enqueued, a discard also puts back each drawing slot's generator
state recorded before the oldest discarded chunk. Streams are therefore the
same at every depth. When a mixed round consumes the last prompt chunks,
the ring chains straight off its outputs (``_mixed_ring_span``).

Termination is decided on the device as in JAX: per-slot stop-id rows,
``limit_lens`` (the max-tokens bound) and the window bound fold into a
finished mask, and a finished row freezes (its KV writes park on scratch page
0 or an unread position, its length and last token stop advancing, it emits
-1). The host mirrors the same rules to close each stream with one terminal
event. Each round (and each phase-separated prefill dispatch) makes ONE
blocking device→host read: on CUDA each dispatch copies its tokens into one
of a fixed set of pinned buffers (one per ring slot, taken back at the
drain) without blocking and records an event, and the round waits on the
event of the chunk it drains. Host→device patches go
through pinned staging buffers of their own (:func:`device.to_device`), so
nothing else in a round waits for the device.

Randomness on the paged paths: each sampling slot draws from its own
``torch.Generator`` on the engine's device, seeded from
``SamplingParams.seed`` or else from the engine seed and the request's
admission number, and advanced once per sampled token — a seed reproduces
its tokens whatever shares the batch, whichever path prefills it, and at
every lookahead depth.

The request's life around the rounds, as in JAX:

- **Tenants.** Pending requests wait in a :class:`TenantFairQueue`: one
  FIFO per tenant, drained by token-weighted fair order (each tenant's
  virtual counter is charged with the prefill and decode tokens it
  consumed); ``tenant_fair=False`` makes it one FIFO. A request's sampling
  seed is fixed when it is taken from the queue, so a seeded stream does
  not depend on the tenant mix. ``tenant_max_slots`` and
  ``tenant_max_pages`` make admission skip a tenant at its cap,
  ``tenant_max_pending`` and the hard page quota raise at ``submit``
  (:class:`.engine.TenantSaturated`, :class:`.engine.TenantQuotaExceeded`),
  and ``tenant_soft_pages`` makes an over-quota tenant yield its youngest
  decode slot to host while another tenant waits.
- **Cancellation and deadlines.** ``cancel`` registers from any thread;
  at every round boundary (:meth:`_service_cancellations`) a cancelled or
  lapsed request leaves the queue, its prefilling or decoding slot, or the
  suspended list, with exactly one ``cancelled`` or ``deadline`` event. A
  queued request whose remaining budget cannot cover its estimated prefill
  (the best recent prefill rate) lapses instead of taking a slot. A slot
  removed while the ring is in flight first discards the ring (which puts
  the slots' generator states back): chunks chained off the ring's tail
  reuse its device active mask, so they would run the removed row on.
- **Preemption to host.** When a slot's chain cannot grow to cover its
  next chunk (a ``MemoryError`` from the pool), the slot is preempted: its
  pages are copied to host (:meth:`.paged.PrefixKVPool.save_chain_to_host`,
  a non-blocking copy on CUDA), freed, and the request is parked with its
  length, last token and generator state; :meth:`_resume_suspended` puts
  it back, ahead of new admissions, once the pool has room, and the stream
  continues with the same tokens. A slot that covers its next chunk is
  never preempted for the ring's deeper horizon (that only caps the ring).
  Mid-prefill preemption keeps ``prefill_pos``. A request even an idle pool
  cannot hold ends with ``length``.

Quantization (``quantization`` "int8" / "int4", :mod:`.quant`): with no
params the engine draws its random weights quantized leaf by leaf on the
device; an unquantized tree passed in is quantized, never served in bf16.
Every path runs the quantized forward, and the decode chunk's CUDA graphs
capture it (its dequantization transients live in the graph's pool).

Prefill/decode disaggregation (``pd_role``, :mod:`.pd`): a ``"prefill"``
engine (paged and mixed only) runs each request's chunked prefill, emits
its first token and then exports the stream (:meth:`_export_handoff`): the
chain's pages go to host (``PrefixKVPool.export_pages``: tree pages stay
cached here, the rest free), the slot frees, and a :class:`_Suspended`
record marked ``handoff`` goes to ``_handoff_sink`` (set by the pool). A
``"decode"`` engine takes such records through :meth:`submit_handoff` into
its suspended list, and the resume path imports the pages
(``import_pages``, cast to this pool's dtype) and decodes on with no
prefill, without counting a preemption. So a prefill engine runs only
prefill and mixed-kind rounds and a decode engine only decode rounds.

Tensor parallelism (``tp`` > 1, :mod:`..parallel`): one engine and one
scheduler thread hold ``tp`` rank shard sets, as the JAX engine lifts itself
onto a mesh. The weights are cut Megatron-style
(:func:`..parallel.sharding.shard_llama_params`), the paged pool (or the
dense cache) on its kv-head axis, one tensor pair a rank (all heads on every
rank when tp does not divide the kv heads), and every forward runs each
rank's projections and kernels on its own slice, the partial sums reduced in
rank order on rank 0, where the hidden stream, the logits, the sampler and
every control row live. Page allocation, the radix tree and the page table
stay host bookkeeping shared by the ranks. By default the ranks take the
first ``tp`` CUDA cards; ``rank_devices`` places them explicitly and may
repeat a device (``["cpu"] * tp`` off the card, ``["cuda:0"] * tp`` on one
card). A pinned ``device`` refuses tp, as in JAX. Before anything is
allocated, :func:`..parallel.feasibility.gate_engine_plan` plans the
per-device bytes at the engine's real page count; with
``hbm_bytes_per_device`` > 0 an over-budget plan raises
:class:`..parallel.feasibility.InfeasiblePlanError`. :meth:`mesh_info` (and
``stats()["mesh"]``) reports the degree, the devices, whether the kv heads
shard, the per-device page bytes and the plan. When the ranks share one card
the decode chunk is one CUDA graph holding all of them; ranks on several
cards run it eagerly (capture across cards is unverified):
``stats()["pipeline"]`` then shows ``decode_graphs`` False and counts
``decode_eager_chunks``.

``prefill_coalesce`` where no phase-separated paged prefill runs is
accepted and ignored (it only changes speed).

Observability, at JAX's sites and with JAX's kinds and attributes: every
lifecycle transition lands in the flight recorder under the request's id
(``enqueued``, ``admitted``, ``prefill``, ``prefill_chunk``,
``decode_chunk``, ``preempted``, ``resumed``, ``finished``, ``error``,
``cancelled``, ``deadline_exceeded``, ...), and a request whose
``trace`` (a W3C traceparent) is sampled gets retrospective spans through
the global tracer (``llm.prefill``, ``llm.prefill_chunk``,
``llm.decode_chunk``, ``llm.preempt``, ``llm.cancel``). No emit reads the
device: a decode chunk's event and span are stamped at its drain from the
host values the drain read, and a chunk discarded from the ring emits
nothing. Counters (cancellations, tenant rejections and yields, speculative
tokens) go to the metrics registry.
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, on_card, resolve_device, same_device, to_device
from ..modkit.failpoints import failpoint, record_recovery
from ..modkit.flight_recorder import record_event
from ..modkit.metrics import bump_counter
from ..modkit.telemetry import get_global_tracer, traceparent_ids
from ..models import llama
from ..models.configs import ModelConfig, get_config
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa
from ..ops.rope import rope_frequencies
from ..ops.sampling import (make_slot_generator, sample_token, sample_token_per_slot,
                            split_keys_per_slot)
from ..parallel.feasibility import gate_engine_plan
from ..parallel.mesh import RankMesh, cuda_rank_devices
from ..parallel.sharding import shard_llama_params
from .engine import (EngineConfig, SamplingParams, SchedulerSaturated, StepEvent,
                     TenantQuotaExceeded, TenantSaturated, build_decode_chunk_fn)
from .paged import PrefixKVPool
from .programs import PagedDecodeChunk
from .quant import is_quantized, quant_bits, quantize_llama_params
from .speculative import NgramProposer, greedy_accept_counts
from .weights import model_from_state_dict

logger = logging.getLogger("scheduler")

_SEED_MASK = 0x7FFF_FFFF_FFFF_FFFF
_ROUND_KINDS = ("mixed", "prefill", "decode")


def _check_pd_role(config: EngineConfig) -> str:
    """The PD role, validated before anything is allocated (JAX
    ``scheduler.py:455-477``)."""
    role = str(config.pd_role or "")
    if role not in ("", "prefill", "decode"):
        raise ValueError(f"pd_role must be '', 'prefill' or 'decode', got {config.pd_role!r}")
    if role and config.prefix_cache_pages <= 0:
        raise ValueError(f"pd_role={role!r} requires the paged pool "
                         "(prefix_cache_pages > 0) — KV handoff moves pool pages")
    if role == "prefill" and not config.mixed_batch:
        raise ValueError("pd_role='prefill' requires mixed_batch=True (prefill-role "
                         "engines run chunked prefill through the ragged dispatch)")
    return role


def _ignored_options(config: EngineConfig) -> list[str]:
    """Speed-only options this engine accepts and does not act on."""
    out = []
    paged = config.prefix_cache_pages > 0
    if config.prefill_coalesce > 1 and paged and config.mixed_batch:
        out.append(f"prefill_coalesce={config.prefill_coalesce} (mixed rounds "
                   "chunk prompts instead)")
    if config.prefill_coalesce > 1 and not paged:
        out.append(f"prefill_coalesce={config.prefill_coalesce} (dense mode "
                   "prefills one request per dispatch)")
    if config.mixed_batch and not paged:
        out.append("mixed_batch (dense mode is phase-separated)")
    return out


def _snapshot(read: Callable[[], list]) -> list:
    """``read()`` of a collection the scheduler thread may be resizing (an
    advisory metric: retried, empty if it keeps changing)."""
    for _ in range(8):
        try:
            return read()
        except RuntimeError:
            continue
    return []


def suffix_prefill(params: llama.LlamaModel, cfg: ModelConfig, ids: torch.Tensor,
                   suffix_len: torch.Tensor, cached_len: int, cache: llama.KVCache,
                   rope_tables: tuple[torch.Tensor, torch.Tensor]
                   ) -> tuple[torch.Tensor, llama.KVCache]:
    """Prefill only the uncached suffix ``ids`` [B, T] (real lengths
    ``suffix_len``) at positions ``cached_len ..`` against the history
    gathered at the head of ``cache`` [L, B, S, Hkv, D], which the suffix's
    KV is written into. Plain attention over the cache (the JAX program's
    ``attention_with_cache``; flash sees no history). Returns (the last
    suffix position's logits [B, V], the cache)."""
    B, T = ids.shape
    dev = ids.device
    positions = (cached_len + torch.arange(T, dtype=torch.int32, device=dev))[None, :]
    start = torch.full((B,), cached_len, dtype=torch.int32, device=dev)
    hidden, kv = llama.forward(params, cfg, ids, positions.expand(B, T), cache, start,
                               rope_tables, use_flash=False)
    logits = llama.lm_head_logits(params, cfg, llama.gather_last_hidden(hidden, suffix_len))
    return logits, kv


@dataclass
class _SlotState:
    request_id: str
    emit: Callable[[StepEvent], None]  # called from the scheduler thread
    sampling: SamplingParams
    stops: frozenset[int]
    prompt_ids: list[int]
    chain: list[int]
    generator: Optional[torch.Generator]
    emitted: int = 0
    prefill_pos: int = 0  # prompt tokens already in the chain
    cached_len: int = 0   # of those, taken from the prefix cache
    #: "prefill" while mixed rounds consume the prompt, then "decode"
    phase: str = "decode"
    #: the last token emitted (the committed device last token of an active
    #: slot whenever the ring is empty: what a preemption saves)
    last_token: int = -1
    trace: Optional[str] = None
    #: the traceparent's sampled flag, parsed once at admission: the span
    #: guard of the hot loop is this one bool
    trace_sampled: bool = False
    #: absolute ``time.monotonic()`` instant; None = unbounded
    deadline: Optional[float] = None
    tenant: str = "default"
    prefill_t0: float = 0.0
    #: wall clock at admission (the backdated ``llm.prefill`` span's start)
    prefill_wall: float = 0.0
    #: mixed-round prompt chunks run so far
    prefill_chunks: int = 0
    #: speculative rounds (``scheduler_spec_k`` > 0): the stream's
    #: prompt-lookup proposer, fed every emitted token; armed at decode
    #: activation for greedy, limit-bound requests only (:meth:`_arm_spec`).
    #: None: this stream does not propose (also the sticky state the
    #: ``spec_min_accept`` gate leaves)
    proposer: Optional[NgramProposer] = None
    #: acceptance evidence the ``spec_min_accept`` gate reads
    spec_proposed: int = 0
    spec_accepted: int = 0


@dataclass
class _Pending:
    request_id: str
    prompt_ids: list[int]
    sampling: SamplingParams
    emit: Callable[[StepEvent], None]
    enqueued_at: float = field(default_factory=time.monotonic)
    trace: Optional[str] = None
    deadline: Optional[float] = None
    tenant: str = "default"


@dataclass
class _Suspended:
    """A preempted request: its chain's KV lives on the host until the pool
    has room again; resume restores the pages and the stream continues with
    no recompute. ``length`` is the valid KV length (decode) or
    ``prefill_pos`` (prefill phase); ``gen_state`` the sampling generator's
    state at the preemption."""

    state: _SlotState
    host_kv: tuple
    length: int
    last_token: int
    gen_state: Optional[torch.Tensor]
    #: a tenant soft-quota yield (not pool pressure): resume waits while
    #: another tenant has pending work and this tenant is still over its cap
    soft_yielded: bool = False
    suspended_at: float = field(default_factory=time.monotonic)
    #: wall clock of the same instant (the ``llm.preempt`` span's start)
    suspended_wall: float = field(default_factory=time.time)
    #: a PD handoff from a prefill-role engine, not a local preemption: the
    #: resume imports the pages and counts no preemption or recovery
    handoff: bool = False
    #: host ms the export took (the pages' copy to host, waited for)
    export_ms: float = 0.0


@dataclass
class _InflightChunk:
    """A dispatched, not yet drained dispatch: one entry of the lookahead
    ring (or a mixed round's own record). Its device tensors are outputs the
    engine adopts only at the drain. ``active_dev`` is the mask it was
    dispatched with; a chained chunk reuses it, and it is never committed
    from a decode chunk (the host's finishes since must stand). ``host`` and
    ``ready`` are the tokens' pinned readback buffer (the engine's, given
    back at the drain or discard) and the event that marks the copy done
    (None on the CPU); ``gen_states`` the drawing slots' generator states
    before this dispatch, put back on a discard."""

    chunk_dev: torch.Tensor   # [N, k] tokens, -1 for frozen rows ([N] for mixed)
    last: torch.Tensor        # [N] last tokens after the dispatch
    lengths_dev: torch.Tensor
    finished_dev: torch.Tensor
    active_dev: torch.Tensor
    epoch: int
    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    gen_states: list = field(default_factory=list)


class TenantFairQueue:
    """Per-tenant FIFO pending queues drained by token-weighted fair order
    (the JAX package's ``TenantFairQueue``, copied).

    :meth:`pop_fair` serves the backlogged tenant with the smallest virtual
    counter: the prefill and decode tokens it consumed divided by its weight
    (:meth:`charge`); ties break on the head's arrival time, then the tenant
    id. A tenant going from idle to backlogged has its counter lifted to the
    least counter among backlogged tenants, so idleness banks no credit.
    Order within a tenant is FIFO. ``fair=False`` is one global FIFO.

    ``put``, ``remove_if`` and ``drain_all`` may run on any thread;
    ``pop_fair`` and ``charge`` on the scheduler thread. Every method is
    bookkeeping under one lock: no sleeps, no device work."""

    def __init__(self, fair: bool = True) -> None:
        self.fair = fair
        self._lock = threading.Lock()
        self._queues: dict[str, deque] = {}
        self._count = 0
        #: virtual counters (charged tokens / weight), never reset
        self._vtc: dict[str, float] = {}
        #: raw charged tokens per tenant
        self._charged: dict[str, int] = {}

    def _key(self, tenant: str) -> str:
        return tenant if self.fair else "default"

    def put(self, req: _Pending) -> None:
        with self._lock:
            key = self._key(req.tenant)
            q = self._queues.setdefault(key, deque())
            if not q:
                # idle → backlogged: lift the counter to the backlogged least
                backlogged = [self._vtc.get(t, 0.0) for t, other in self._queues.items()
                              if other and t != key]
                if backlogged:
                    self._vtc[key] = max(self._vtc.get(key, 0.0), min(backlogged))
            q.append(req)
            self._count += 1

    def put_front(self, req: _Pending) -> None:
        """Return a just-popped request to the head of its tenant's queue."""
        with self._lock:
            self._queues.setdefault(self._key(req.tenant), deque()).appendleft(req)
            self._count += 1

    def pop_fair(self, blocked: Optional[set] = None) -> Optional[_Pending]:
        """The next request: least (virtual counter, head arrival, tenant id)
        among backlogged tenants not in ``blocked``."""
        with self._lock:
            best_key, best = None, (0.0, 0.0, "")
            for key, q in self._queues.items():
                if not q or (blocked and key in blocked):
                    continue
                cand = (self._vtc.get(key, 0.0), q[0].enqueued_at, key)
                if best_key is None or cand < best:
                    best_key, best = key, cand
            if best_key is None:
                return None
            self._count -= 1
            return self._queues[best_key].popleft()

    def charge(self, tenant: str, tokens: int, weight: float) -> None:
        if tokens <= 0:
            return
        key = self._key(tenant)
        with self._lock:
            self._vtc[key] = self._vtc.get(key, 0.0) + tokens / max(weight, 1e-9)
            self._charged[key] = self._charged.get(key, 0) + tokens

    def qsize(self) -> int:
        return self._count

    def empty(self) -> bool:
        return self._count == 0

    def tenant_depth(self, tenant: str) -> int:
        with self._lock:
            q = self._queues.get(self._key(tenant))
            return len(q) if q else 0

    def depths(self) -> dict[str, int]:
        with self._lock:
            return {t: len(q) for t, q in self._queues.items() if q}

    def snapshot(self) -> list[_Pending]:
        with self._lock:
            return [req for q in self._queues.values() for req in q]

    def oldest_age(self) -> Optional[float]:
        with self._lock:
            heads = [q[0].enqueued_at for q in self._queues.values() if q]
        return time.monotonic() - min(heads) if heads else None

    def remove_if(self, pred: Callable[[_Pending], bool]) -> list[_Pending]:
        """Remove and return every pending request matching ``pred``; the
        survivors keep their order."""
        removed: list[_Pending] = []
        with self._lock:
            for q in self._queues.values():
                if not any(pred(r) for r in q):
                    continue
                kept = [r for r in q if not pred(r)]
                removed.extend(r for r in q if pred(r))
                q.clear()
                q.extend(kept)
            self._count -= len(removed)
        return removed

    def drain_all(self) -> list[_Pending]:
        with self._lock:
            out = [req for q in self._queues.values() for req in q]
            for q in self._queues.values():
                q.clear()
            self._count = 0
        return out

    def vtc_snapshot(self) -> dict[str, float]:
        with self._lock:
            return dict(self._vtc)

    def charged_snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._charged)


class ContinuousBatchingEngine:
    """Runs a scheduler thread driving the device; submission is
    thread-safe. ``emit`` callbacks fire on the scheduler thread.

    ``rank_devices`` (tp > 1 only): rank r's device, one a rank, repeats
    allowed; None takes the first ``tp`` CUDA cards.

    ``_eager_decode`` (private, not an ``EngineConfig`` option): on CUDA,
    enqueue the paged decode chunk launch by launch instead of replaying its
    CUDA graph; a comparison run's switch, nothing a deployment sets."""

    def __init__(self, config: EngineConfig, params: Any = None, seed: int = 0,
                 device: DeviceLike = None, *,
                 rank_devices: Optional[Sequence[DeviceLike]] = None,
                 _eager_decode: bool = False) -> None:
        self.config = config
        self.model_config = get_config(config.model)
        self.pd_role = _check_pd_role(config)
        self.tp = max(1, int(config.tp))
        if self.tp > 1 and device is not None:
            raise ValueError("tp > 1 cannot combine with a pinned device (dp replica pools "
                             "own one device per engine; shard OR replicate, not both)")
        if rank_devices is not None and len(rank_devices) != self.tp:
            raise ValueError(f"rank_devices names {len(rank_devices)} devices for tp={self.tp}")
        #: the paged pool's pages (None: dense mode): every slot must be able
        #: to hold a full-window chain; tree pages past that are evicted on
        #: demand. The gate budgets this count and the pool allocates it.
        self._num_pages: Optional[int] = None
        if config.prefix_cache_pages > 0:
            pmax = -(-config.max_seq_len // config.prefix_page_size)
            self._num_pages = max(config.prefix_cache_pages, config.max_batch * pmax + 1)
        self.feasibility: Optional[dict] = None
        if self.tp > 1 or config.hbm_bytes_per_device > 0:
            # the gate runs before anything is allocated: an over-budget plan
            # raises here, typed, never as an out-of-memory error later
            self.feasibility = gate_engine_plan(
                self.model_config, self.tp, quantization=config.quantization,
                dtype=getattr(torch, config.dtype), max_batch=config.max_batch,
                max_seq_len=config.max_seq_len, page_size=config.prefix_page_size,
                num_pages=self._num_pages, hbm_bytes=config.hbm_bytes_per_device or None,
                device=(rank_devices[0] if rank_devices else device))
            self.feasibility.pop("leaves", None)
            self.feasibility.pop("read_plan", None)
        self.mesh: Optional[RankMesh] = (
            RankMesh(rank_devices or cuda_rank_devices(self.tp)) if self.tp > 1 else None)
        self.device = self.mesh.devices[0] if self.mesh is not None else resolve_device(device)
        #: set by the PD pool on prefill-role engines: called on the scheduler
        #: thread with each stream's handoff record after its first token
        self._handoff_sink: Optional[Callable[[_Suspended], None]] = None
        # the build (allocations, graph capture) lands on this card, and the
        # building thread's current card is what it was after it: a pool built
        # over several cards from one thread must not leave it on the last
        with on_card(self.device):
            self._build(config, params, seed, _eager_decode)

    def _build(self, config: EngineConfig, params: Any, seed: int,
               _eager_decode: bool) -> None:
        """The constructor's work past validation, on the engine's card."""
        ignored = _ignored_options(config)
        if ignored:
            logger.info("speed-only options ignored by this engine: %s",
                        "; ".join(ignored))
        cfg = self.model_config
        self.dtype = getattr(torch, config.dtype)
        bits = quant_bits(config.quantization)
        if isinstance(params, llama.ShardedLlama):
            # a tp engine's own weights, passed on to its rebuild
            if params.tp != self.tp or [str(d) for d in params.mesh.devices] != \
                    [str(d) for d in self.mesh.devices]:
                raise ValueError(f"params are cut for {params.mesh}, the engine runs "
                                 f"{self.mesh}")
        else:
            if params is None:
                params = llama.init_params(cfg, seed, self.dtype, self.device, quant_bits=bits)
            elif isinstance(params, Mapping):
                params = model_from_state_dict(params, cfg, self.device, self.dtype)
            elif not same_device(params.device, self.device) and self.mesh is None:
                raise ValueError(f"params live on {params.device}, engine on {self.device}")
            if bits is not None and not is_quantized(params):
                # a tree passed in unquantized is quantized, never served in bf16
                params = quantize_llama_params(params, bits)
            if self.mesh is not None:
                # each rank's slices are copies of their own; the tree passed
                # in (or drawn here) is left to its owner (or dropped)
                params = shard_llama_params(params, self.mesh)
        self.params = params
        #: the heads, intermediate and vocab slice one rank runs
        self.rank_config = params.rank_cfg if self.mesh is not None else cfg
        self.seed = seed
        self.rope_tables = rope_frequencies(
            cfg.head_dim, max(cfg.max_position, config.max_seq_len),
            cfg.rope_theta, device=self.device)
        self.n_slots = n = config.max_batch
        self._k_steps = max(1, config.decode_chunk)
        self.paged = config.prefix_cache_pages > 0
        self.mixed = self.paged and config.mixed_batch
        self.use_flash = config.resolve_use_flash(self.device)
        if self.device.type == "cuda":  # a model the kernels cannot take fails here
            rc = self.rank_config  # each rank's kernels see its own heads
            if self.use_flash:
                fa.check_kernel_supports(rc.head_dim, rc.num_heads, rc.num_kv_heads,
                                         self.dtype)
            if self.paged:
                pa.check_kernel_supports(rc.head_dim, rc.num_heads, rc.num_kv_heads,
                                         self.dtype, config.prefix_page_size)
        page = config.prefix_page_size
        self.pmax = -(-config.max_seq_len // page)
        self.pool: Optional[PrefixKVPool] = None
        self.cache: Optional[llama.KVCache] = None
        if self.paged:
            self.pool = PrefixKVPool(cfg, num_pages=self._num_pages, page_size=page,
                                     dtype=self.dtype, device=self.device, mesh=self.mesh)
        else:
            self.cache = llama.init_model_cache(self.params, cfg, n, config.max_seq_len)
            # dense mode: ONE sampling stream shared by the batch
            self._generator = make_slot_generator(seed, self.device)
            self._dense_decode_fn = build_decode_chunk_fn(
                cfg, self._k_steps, self.rope_tables, max_seq=config.max_seq_len,
                device_term=True)

        # host mirrors
        self.slots: list[Optional[_SlotState]] = [None] * n
        self.lengths = np.zeros(n, np.int32)
        self.active = np.zeros(n, bool)
        self.page_table = np.zeros((n, self.pmax), np.int32)
        self._pt_dirty = True
        self._free_slots: deque[int] = deque(range(n))
        self._prefill_slots: deque[int] = deque()
        #: per slot: its whole stop set fits the device stop row, so the
        #: device freezes the row on a stop (else the host alone sees it)
        self._dev_term = [True] * n

        # device-resident per-slot rows, patched row-wise on change
        dev = self.device
        self._stop_width = max(1, config.device_stop_width)
        self._page_table_dev = torch.zeros((n, self.pmax), dtype=torch.int32, device=dev)
        self._last_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        self._lengths_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        self._active_dev = torch.zeros(n, dtype=torch.bool, device=dev)
        self._finished_dev = torch.zeros(n, dtype=torch.bool, device=dev)
        self._stops_dev = torch.full((n, self._stop_width), -1, dtype=torch.int32,
                                     device=dev)
        self._limit_dev = torch.zeros(n, dtype=torch.int32, device=dev)
        self._temp_dev = torch.zeros(n, dtype=torch.float32, device=dev)
        self._top_p_dev = torch.ones(n, dtype=torch.float32, device=dev)
        self._top_k_dev = torch.zeros(n, dtype=torch.int32, device=dev)

        # speculative rounds: up to spec_k drafts a speculating slot, verified
        # as one ragged span of spec_w = spec_k + 1 positions (paged only: the
        # span rides the ragged kernel); 0 keeps every round as it was
        self.spec_k = max(0, int(config.scheduler_spec_k)) if self.paged else 0
        if config.scheduler_spec_k > 0 and not self.paged:
            logger.info("scheduler_spec_k=%d needs the paged scheduler "
                        "(prefix_cache_pages > 0); speculation disabled",
                        config.scheduler_spec_k)
        self._spec_w = self.spec_k + 1
        #: rounds that carried a draft span (and of those, the ones that also
        #: carried prompt chunks), drafts proposed and accepted, tokens the
        #: speculating rows emitted, streams the spec_min_accept gate closed
        self.spec_stats = {"rounds": 0, "mixed_rounds": 0, "proposed": 0,
                           "accepted": 0, "emitted": 0, "slots_disabled": 0}
        #: accepted drafts of a span → spans
        self._spec_accept_hist: dict[int, int] = {}

        # the lookahead ring (paged decode rounds)
        self._depth = config.resolve_lookahead_depth() if self.paged else 0
        self._ring: deque[_InflightChunk] = deque()
        #: pinned readback buffers by shape: one per ring slot for decode
        #: chunks, one for the mixed round; a dispatch takes one, its drain or
        #: discard gives it back
        self._pinned: dict[tuple, list[torch.Tensor]] = {}
        self._chunk: Optional[PagedDecodeChunk] = None
        self._step = None
        #: decode chunks as CUDA graphs: on the card, unless the comparison
        #: switch is set or the ranks span several cards
        self._graphs = (dev.type == "cuda" and not _eager_decode
                        and (self.mesh is None or self.mesh.shared))
        if self.paged:
            if dev.type == "cuda":
                self._pinned = {
                    (n, self._k_steps): [torch.empty((n, self._k_steps), dtype=torch.int32,
                                                     pin_memory=True)
                                         for _ in range(self._depth + 1)],
                    (n,): [torch.empty((n,), dtype=torch.int32, pin_memory=True)]}
                if self.spec_k:  # a speculative round's emit matrix + accepts
                    self._pinned.setdefault((n, self._spec_w + 1), []).append(torch.empty(
                        (n, self._spec_w + 1), dtype=torch.int32, pin_memory=True))
            rows = {"page_table": self._page_table_dev, "stops": self._stops_dev,
                    "limit": self._limit_dev, "temperature": self._temp_dev,
                    "top_p": self._top_p_dev, "top_k": self._top_k_dev}
            self._chunk = PagedDecodeChunk(
                self.params, cfg, self.pool.pools, rows,
                self.rope_tables, n, self._k_steps, config.max_seq_len, graphs=self._graphs)
            #: a speculative round's first pass: one decode step over every
            #: slot, the same program as a chunk's step (its termination
            #: outputs unused), so a row that does not speculate gets a
            #: decode step's bits (see :meth:`_dispatch_verify`)
            self._step: Optional[PagedDecodeChunk] = PagedDecodeChunk(
                self.params, cfg, self.pool.pools, rows,
                self.rope_tables, n, 1, config.max_seq_len,
                graphs=self._graphs) if self.spec_k else None
        #: bumped by every change the in-flight ring cannot have seen
        self._epoch = 0

        self._pending = TenantFairQueue(fair=config.tenant_fair)
        self._tenant_weights: dict[str, float] = dict(config.tenant_weights or {})
        caps = bool(config.tenant_max_slots or config.tenant_soft_pages
                    or config.tenant_max_pages or config.tenant_max_pending)
        #: the tenant-blind queue keys every tenant alike, so caps cannot be
        #: attributed there: they are disarmed (as in JAX)
        self._tenant_caps_armed = caps and config.tenant_fair
        if caps and not config.tenant_fair:
            logger.warning("per-tenant caps configured with tenant_fair=False; "
                           "caps are DISARMED (the tenant-blind queue cannot attribute "
                           "work to tenants)")
        #: slots the cap sweep marked for a soft-quota yield (preempted by the
        #: next capacity pass)
        self._soft_yield: set[int] = set()
        self.tenant_rejections: dict[str, dict[str, int]] = {}
        self.tenant_soft_yields: dict[str, int] = {}
        #: (time, requests that left the queue): the drain rate behind
        #: ``retry_after_s``
        self._admit_events: deque[tuple[float, int]] = deque(maxlen=256)
        #: request id → reason, registered from any thread, applied at the
        #: next round boundary
        self._cancel_lock = threading.Lock()
        self._cancel_requests: dict[str, str] = {}
        self._has_deadlines = False
        #: recent prefill rates (tokens/s) behind the admission estimate
        self._prefill_rates: deque[float] = deque(maxlen=32)
        self._suspended: deque[_Suspended] = deque()
        #: phase-separated admissions taken off the queue and not yet in a
        #: slot (a failing prefill must still close their streams)
        self._admitting: list[_SlotState] = []
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._broken: Optional[str] = None
        #: set by close(): retired on purpose, never restarted in place
        self._closed = False
        self._admitted = 0

        self.rounds = {kind: 0 for kind in _ROUND_KINDS}
        #: host wall time per round kind (dispatch, wait and emit)
        self.round_ms = {kind: 0.0 for kind in _ROUND_KINDS}
        #: per round kind: summed dispatch, sync-wait and host-emit ms (the
        #: JAX ``_record_round`` split); the newest rounds one by one
        self.round_split_ms = {kind: {"dispatch_ms": 0.0, "sync_wait_ms": 0.0,
                                      "host_emit_ms": 0.0} for kind in _ROUND_KINDS}
        self.round_timings: deque[dict] = deque(maxlen=4096)
        self.lookahead = {"used": 0, "dispatched": 0, "discarded": 0}
        self.depth_hist: dict[int, int] = {}
        self.prefill_chunks = 0
        self.chunked_prefill_tokens = 0
        #: phase-separated prefill dispatches, those with more than one
        #: request, those over a prefix hit, and their host wall time (each
        #: ends in its one read)
        self.prefill_dispatches = 0
        self.coalesced_prefills = 0
        self.suffix_prefills = 0
        self.prefill_ms = 0.0
        #: the most pages two live chains shared at a dispatch
        self.max_shared_chain_pages = 0
        self.tokens_emitted = 0
        self.requests_completed = 0
        self.rejected_saturated = 0
        self.preemptions = 0
        #: PD handoffs: streams exported (prefill role) and imported (decode
        #: role), and each import's export + import host ms
        self.handoffs_exported = 0
        self.handoffs_imported = 0
        self.handoff_ms_samples: deque[float] = deque(maxlen=2048)
        #: terminal counts by cancel reason, and the max_tokens not generated
        self.cancellations: dict[str, int] = {}
        self.reclaimed_tokens = 0
        self.resume_latency_samples: deque[float] = deque(maxlen=512)
        self.queue_wait_samples: deque[float] = deque(maxlen=2048)
        #: host ms of the last admission pass (the rounds' chrome trace)
        self._last_admit_ms = 0.0
        #: when the last round ended (the doctor's round watchdog)
        self.last_round_at = time.monotonic()

    # ------------------------------------------------------------------ public api
    def start(self) -> None:
        with self._thread_lock:
            if self._broken:
                raise RuntimeError(f"scheduler is broken: {self._broken}")
            if self._closed:
                raise RuntimeError("scheduler is closed; build a fresh engine")
            if self._thread is None or not self._thread.is_alive():
                self._stop.clear()
                self._thread = threading.Thread(target=self._run_loop,
                                                name="cb-scheduler", daemon=True)
                self._thread.start()

    def shutdown(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def close(self, timeout: float = 10.0) -> None:
        """Retire the engine: stop the scheduler thread, then end everything
        still in flight, suspended or queued with ``error``. Unlike a loop
        fault this leaves ``broken`` unset: a fresh engine may reuse
        ``.params``; this one never restarts. Idempotent."""
        if self._closed:
            return
        self._closed = True
        self.shutdown(timeout)
        self._fail_all_inflight("replica closed")

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               emit: Callable[[StepEvent], None],
               request_id: Optional[str] = None, trace: Optional[str] = None,
               deadline: Optional[float] = None, tenant: Optional[str] = None) -> str:
        """Enqueue a request; ``emit`` receives one StepEvent per token, the
        last one carrying the finish reason. ``deadline`` is an absolute
        ``time.monotonic()`` instant: past it the request ends with
        ``deadline`` wherever it is. ``tenant`` keys the fair queue and the
        per-tenant caps (None: ``"default"``); ``trace`` (a W3C traceparent)
        rides along. Raises :class:`SchedulerSaturated` at ``max_pending``
        queued requests, :class:`TenantSaturated` at ``tenant_max_pending``
        of the tenant's, and :class:`TenantQuotaExceeded` when the request's
        worst case (prompt + max_tokens) needs more pages than
        ``tenant_max_pages``."""
        if not prompt_ids:
            raise ValueError("prompt_ids must hold at least one token")
        rid = request_id or f"req-{uuid.uuid4().hex[:16]}"
        tenant = tenant or "default"
        self.config.bucket_for(len(prompt_ids))  # validate in caller context
        if self.paged and self._tenant_caps_armed and self.config.tenant_max_pages > 0:
            need = self.pool.pages_for(min(len(prompt_ids) + sampling.max_tokens,
                                           self.config.max_seq_len))
            if need > self.config.tenant_max_pages:
                self._bump_tenant_rejection(tenant, "quota")
                raise TenantQuotaExceeded(
                    f"request needs {need} KV pages > tenant hard quota "
                    f"{self.config.tenant_max_pages} (prompt {len(prompt_ids)} + "
                    f"max_tokens {sampling.max_tokens})", tenant=tenant)
        if not self.paged and sampling.seed is not None:
            raise ValueError(
                "SamplingParams.seed requires the paged scheduler "
                "(prefix_cache_pages > 0); dense mode shares one sampling stream")
        if not self.active_slots and not self._suspended and not self._prefill_slots \
                and self._pending.empty():
            # idle → busy: the round watchdog measures time with work
            self.last_round_at = time.monotonic()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("scheduler is closed; build a fresh engine")
            if self._broken:
                raise RuntimeError(f"scheduler is broken: {self._broken}")
            cap = self.config.tenant_max_pending
            if self._tenant_caps_armed and cap and self._pending.tenant_depth(tenant) >= cap:
                self.rejected_saturated += 1
                self._bump_tenant_rejection(tenant, "pending")
                raise TenantSaturated(
                    f"tenant {tenant!r} pending queue full ({cap} requests); retry later",
                    retry_after_s=self._saturation_retry_after(
                        self._pending.tenant_depth(tenant)), tenant=tenant)
            if self.config.max_pending and self._pending.qsize() >= self.config.max_pending:
                self.rejected_saturated += 1
                raise SchedulerSaturated(
                    f"pending queue full ({self.config.max_pending} requests); "
                    "retry later",
                    retry_after_s=self._saturation_retry_after(self._pending.qsize()))
            # recorded BEFORE the put: once visible to the scheduler thread the
            # request may be admitted (and finished) at once, and a late
            # 'enqueued' would reopen a ghost record
            extra = {}
            if deadline is not None:
                self._has_deadlines = True
                extra["deadline_ms"] = round((deadline - time.monotonic()) * 1000.0, 1)
            record_event(rid, "enqueued", prompt_tokens=len(prompt_ids),
                         trace_id=traceparent_ids(trace)[0], tenant=tenant, **extra)
            self._pending.put(_Pending(rid, list(prompt_ids), sampling, emit, trace=trace,
                                       deadline=deadline, tenant=tenant))
        self._wake.set()
        self._start_owned()
        return rid

    def _start_owned(self) -> None:
        """:meth:`start` once a request is queued: a break or close since the
        locked check cannot lose it (the teardown drains the queue and ends it
        with ``error``), so the caller must not see a refusal and submit the
        request elsewhere too (its client would get two terminals)."""
        try:
            self.start()
        except RuntimeError:
            if not (self._broken or self._closed):
                raise

    def submit_handoff(self, rec: _Suspended) -> None:
        """Take a stream a prefill-role engine handed off (prefill done
        there, KV on host, first token emitted) for decode here: the record
        joins the suspended list, which admission serves first, and the
        resume path imports its pages. Runs on the SOURCE engine's
        scheduler thread (the pool's handoff sink): bookkeeping only.
        Speculation is armed under this engine's config, its proposer fed
        the prompt and the first token, as a unified engine's would be."""
        if self.pd_role == "prefill":
            raise RuntimeError("handoff target must be a decode-role or unified engine")
        if not self.paged:
            raise RuntimeError("handoff needs the paged pool (prefix_cache_pages > 0)")
        state = rec.state
        state.proposer = None
        self._arm_spec(state)
        if state.proposer is not None:
            state.proposer.extend([rec.last_token])
        if state.generator is not None and not same_device(state.generator.device,
                                                           self.device):
            # the stream's own generator, carried to this card by its state
            gen = torch.Generator(device=self.device)
            gen.set_state(rec.gen_state)
            state.generator = gen
        if not self.active_slots and not self._suspended and not self._prefill_slots \
                and self._pending.empty():
            self.last_round_at = time.monotonic()
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("scheduler is closed; build a fresh engine")
            if self._broken:
                raise RuntimeError(f"scheduler is broken: {self._broken}")
            if state.deadline is not None:
                self._has_deadlines = True
            self._suspended.append(rec)
        self._wake.set()
        self._start_owned()

    @property
    def active_slots(self) -> int:
        return int(self.active.sum())

    def servable(self) -> bool:
        """False once the loop failed or ``close()`` retired the engine."""
        return self._broken is None and not self._closed

    # ------------------------------------------------------------ cancellation
    def cancel(self, request_id: str, reason: str = "cancelled") -> bool:
        """Ask for ``request_id`` to end, from any thread, without blocking:
        the scheduler thread applies it at the next round boundary, with one
        ``cancelled`` event. Idempotent; a finished or unknown id is a no-op.
        Returns whether the id was visible in this engine at call time
        (advisory)."""
        found = self._cancel_known(request_id)
        with self._cancel_lock:
            self._cancel_requests[request_id] = reason
        self._wake.set()
        return found

    def _cancel_known(self, request_id: str) -> bool:
        if any(st is not None and st.request_id == request_id for st in self.slots):
            return True
        if any(rec.state.request_id == request_id
               for rec in _snapshot(lambda: list(self._suspended))):
            return True
        return any(req.request_id == request_id for req in self._pending.snapshot())

    def _service_cancellations(self) -> None:
        """Apply registered cancels and lapse passed deadlines: queued,
        suspended, prefilling and decoding requests (round boundary,
        scheduler thread). An id that matched nothing raced its own terminal
        and is consumed without effect."""
        with self._cancel_lock:
            cancels, self._cancel_requests = self._cancel_requests, {}
        if not cancels and not self._has_deadlines:
            return
        now = time.monotonic()
        self._cancel_filter_pending(cancels, now)
        self._cancel_suspended(cancels, now)
        for slot in range(self.n_slots):
            state = self.slots[slot]
            if state is None:
                continue
            reason, kind = cancels.pop(state.request_id, None), "cancelled"
            if reason is None and state.deadline is not None and now >= state.deadline:
                reason, kind = "deadline", "deadline_exceeded"
            if reason is not None:
                self._cancel_slot(slot, state, reason, kind)

    def _cancel_filter_pending(self, cancels: dict[str, str], now: float) -> None:
        def doomed(req: _Pending) -> bool:
            return req.request_id in cancels or (req.deadline is not None
                                                 and now >= req.deadline)

        if not any(doomed(req) for req in self._pending.snapshot()):
            return
        with self._submit_lock:
            removed = self._pending.remove_if(doomed)
        for req in removed:
            reason = cancels.pop(req.request_id, None)
            self._cancel_finalize(req.emit, reason or "deadline",
                                  "cancelled" if reason else "deadline_exceeded",
                                  reclaimed=req.sampling.max_tokens,
                                  request_id=req.request_id, phase="queued",
                                  trace=req.trace, tenant=req.tenant)

    def _cancel_suspended(self, cancels: dict[str, str], now: float) -> None:
        if not self._suspended:
            return
        kept, victims = [], []
        with self._submit_lock:
            while self._suspended:
                rec = self._suspended.popleft()
                reason, kind = cancels.pop(rec.state.request_id, None), "cancelled"
                if reason is None and rec.state.deadline is not None \
                        and now >= rec.state.deadline:
                    reason, kind = "deadline", "deadline_exceeded"
                (kept if reason is None else victims).append((rec, reason, kind))
            self._suspended.extend(rec for rec, _, _ in kept)
        for rec, reason, kind in victims:
            st = rec.state
            self._cancel_finalize(st.emit, reason, kind,
                                  reclaimed=st.sampling.max_tokens - st.emitted,
                                  request_id=st.request_id, phase="suspended",
                                  emitted=st.emitted, trace=st.trace, tenant=st.tenant)

    def _cancel_slot(self, slot: int, state: _SlotState, reason: str, kind: str) -> None:
        """Free one occupied slot (prefill or decode phase): its chain, its
        device rows (frozen, page-table row zeroed) and the slot. A decode
        row in flight in the ring first discards the ring, which puts the
        generator states back: a chunk chained later would reuse the tail's
        device active mask and run the row on. No epoch bump, as in JAX."""
        if self._ring and self.active[slot]:
            self._discard_ring()
        if state.phase == "prefill":
            self._prefill_slots.remove(slot)
        self.active[slot] = False
        self.slots[slot] = None
        self._release_free_slot(slot)
        self._deactivate_slot_device(slot)
        if self.paged:
            self.pool.release_slot(state.chain)
            self.page_table[slot, :] = 0
            self._pt_dirty = True
        self._cancel_finalize(state.emit, reason, kind,
                              reclaimed=state.sampling.max_tokens - state.emitted,
                              request_id=state.request_id, phase=state.phase,
                              emitted=state.emitted, slot=slot, trace=state.trace,
                              tenant=state.tenant)

    def _cancel_finalize(self, emit: Callable[[StepEvent], None], reason: str,
                         kind: str, *, reclaimed: int, request_id: str, phase: str,
                         emitted: int = 0, slot: Optional[int] = None,
                         trace: Optional[str] = None, tenant: str = "default") -> None:
        """One terminal per cancellation: the count by reason, the budget
        reclaimed, the flight-recorder terminal (``cancelled`` /
        ``deadline_exceeded``, whose ``phase`` the worker's 408 / 504 choice
        reads), the counters, an ``llm.cancel`` span for a sampled trace, and
        the client's event (a raising emit belongs to a client that is
        gone)."""
        self.cancellations[reason] = self.cancellations.get(reason, 0) + 1
        self.reclaimed_tokens += max(0, int(reclaimed))
        attrs: dict[str, Any] = {"reason": reason, "phase": phase, "tokens": emitted,
                                 "tenant": tenant}
        if slot is not None:
            attrs["slot"] = slot
        record_event(request_id, kind, **attrs)
        bump_counter("llm_cancellations_total", reason=reason)
        if reclaimed > 0:
            bump_counter("llm_cancel_reclaimed_tokens_total", n=int(reclaimed))
        if traceparent_ids(trace)[1]:
            # the trace ends with why the request ended
            get_global_tracer().emit_span(
                "llm.cancel", traceparent=trace, start_unix_ns=int(time.time() * 1e9),
                duration_ms=0.0, request_id=request_id, reason=reason, kind=kind,
                phase=phase, tokens=emitted, tenant=tenant)
        try:
            emit(StepEvent(0, -1, "deadline" if kind == "deadline_exceeded" else "cancelled"))
        except Exception:  # noqa: BLE001 — the client is gone by definition
            pass

    def _note_prefill_rate(self, tokens: int, dur_s: float) -> None:
        if tokens > 0 and dur_s > 0:
            self._prefill_rates.append(tokens / dur_s)

    def _estimate_prefill_s(self, tokens: int) -> float:
        """Seconds to prefill ``tokens`` at the best recent rate; 0 with no
        observation yet (admit, and let the sweep judge)."""
        rate = max(_snapshot(lambda: list(self._prefill_rates)), default=0.0)
        return tokens / rate if rate > 0 else 0.0

    # ------------------------------------------------------------ tenants
    def _weight(self, tenant: str) -> float:
        return float(self._tenant_weights.get(tenant, self.config.tenant_default_weight))

    def _charge_tenant(self, tenant: str, tokens: int) -> None:
        self._pending.charge(tenant, tokens, self._weight(tenant))

    def _bump_tenant_rejection(self, tenant: str, reason: str) -> None:
        per = self.tenant_rejections.setdefault(tenant, {})
        per[reason] = per.get(reason, 0) + 1
        bump_counter("llm_tenant_rejections_total", tenant=tenant, reason=reason)

    #: drain-rate observations older than this are stale
    _DRAIN_RATE_WINDOW_S = 60.0

    def _drain_rate_per_s(self) -> float:
        """Requests that left the queue per second over the recent window;
        the first event anchors the span without counting."""
        cutoff = time.monotonic() - self._DRAIN_RATE_WINDOW_S
        events = [e for e in _snapshot(lambda: list(self._admit_events)) if e[0] >= cutoff]
        if len(events) < 2 or events[-1][0] <= events[0][0]:
            return 0.0
        return sum(n for _, n in events[1:]) / (events[-1][0] - events[0][0])

    def _saturation_retry_after(self, depth: int) -> float:
        """``depth`` over the drain rate, clamped to [1, 30] s (1 s when the
        rate is unknown)."""
        rate = self._drain_rate_per_s()
        return 1.0 if rate <= 0 else float(min(30.0, max(1.0, depth / rate)))

    def _tenant_slot_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for state in list(self.slots):
            if state is not None:
                counts[state.tenant] = counts.get(state.tenant, 0) + 1
        return counts

    def _tenant_page_counts(self) -> dict[str, int]:
        """Pool pages held by each tenant's slots (suspended requests hold
        host memory, not pages)."""
        counts: dict[str, int] = {}
        for state in list(self.slots):
            if state is not None:
                counts[state.tenant] = counts.get(state.tenant, 0) + len(state.chain)
        return counts

    def _blocked_tenants(self) -> set:
        """Tenants admission skips: at their slot cap, or holding their hard
        page quota."""
        blocked: set = set()
        if not self._tenant_caps_armed:
            return blocked
        max_slots, max_pages = self.config.tenant_max_slots, self.config.tenant_max_pages
        if max_slots:
            blocked |= {t for t, n in self._tenant_slot_counts().items() if n >= max_slots}
        if self.paged and max_pages:
            blocked |= {t for t, n in self._tenant_page_counts().items() if n >= max_pages}
        return blocked

    def _service_tenant_caps(self) -> None:
        """Round-boundary soft-quota sweep (bookkeeping only): a tenant over
        ``tenant_soft_pages`` while another tenant waits in the queue (or a
        request is suspended) has its youngest decode slot marked; the next
        capacity pass yields it to host. One mark at a time."""
        soft = self.config.tenant_soft_pages
        if not self._tenant_caps_armed or not self.paged or soft <= 0 or self._soft_yield:
            return
        over = {t: n for t, n in self._tenant_page_counts().items() if n > soft}
        if not over:
            return
        contention = bool(self._suspended) or any(
            d > 0 for t, d in self._pending.depths().items() if t not in over)
        if not contention:
            return
        victim = max(over, key=over.get)
        best_slot, best_len = None, None
        for slot in range(self.n_slots):
            state = self.slots[slot]
            if state is None or state.tenant != victim or not self.active[slot]:
                continue
            if best_len is None or int(self.lengths[slot]) < best_len:
                best_slot, best_len = slot, int(self.lengths[slot])
        if best_slot is None:
            return
        self._soft_yield.add(best_slot)
        self.tenant_soft_yields[victim] = self.tenant_soft_yields.get(victim, 0) + 1
        bump_counter("llm_tenant_soft_yields_total", tenant=victim)
        record_event(self.slots[best_slot].request_id, "soft_yield_marked", slot=best_slot,
                     tenant=victim, pages=over[victim], soft_cap=soft)

    def tenant_snapshot(self) -> dict[str, dict[str, Any]]:
        """Per-tenant live figures (advisory; any thread)."""
        slots, pages = self._tenant_slot_counts(), self._tenant_page_counts()
        depths = self._pending.depths()
        vtc, charged = self._pending.vtc_snapshot(), self._pending.charged_snapshot()
        rejections = {t: dict(per) for t, per in
                      _snapshot(lambda: list(self.tenant_rejections.items()))}
        yields = dict(_snapshot(lambda: list(self.tenant_soft_yields.items())))
        tenants = set(slots) | set(pages) | set(depths) | set(charged) | set(rejections)
        return {t: {"weight": self._weight(t), "active_slots": slots.get(t, 0),
                    "pages": pages.get(t, 0), "pending": depths.get(t, 0),
                    "virtual_counter": round(vtc.get(t, 0.0), 3),
                    "charged_tokens": charged.get(t, 0),
                    "soft_yields": yields.get(t, 0),
                    "rejections": rejections.get(t, {})} for t in tenants}

    # ------------------------------------------------------------ health surface
    def pending_depth(self) -> int:
        return self._pending.qsize()

    def in_flight(self) -> int:
        """Requests the engine holds: in a slot (decoding or prefilling),
        preempted to host, taken for admission, or queued. 0 means the
        engine may be closed without ending anyone's stream."""
        return (len(self.slots) - len(self._free_slots) + len(self._suspended)
                + len(self._admitting) + self._pending.qsize())

    def pending_oldest_age_s(self) -> Optional[float]:
        return self._pending.oldest_age()

    def heartbeat(self) -> dict[str, Any]:
        """Round liveness for the doctor's watchdogs."""
        durations = sorted(t["dispatch_ms"] + t["sync_wait_ms"] + t["host_emit_ms"]
                           for t in _snapshot(lambda: list(self.round_timings)))
        p95 = durations[int(0.95 * (len(durations) - 1))] if durations else 0.0
        return {"last_round_age_s": round(time.monotonic() - self.last_round_at, 3),
                "round_p95_ms": round(p95, 3), "rounds": sum(self.rounds.values()),
                "active": self.active_slots, "prefilling": len(self._prefill_slots),
                "pending": self._pending.qsize(), "suspended": len(self._suspended),
                "oldest_pending_age_s": self.pending_oldest_age_s(),
                "broken": self._broken}

    def stats(self) -> dict[str, Any]:
        pool = self.pool.stats() if self.pool is not None else None
        la = dict(self.lookahead)
        n_rounds = sum(self.rounds.values())
        timings = _snapshot(lambda: list(self.round_timings))
        depth_hist = _snapshot(lambda: sorted(self.depth_hist.items()))
        waits = _snapshot(lambda: list(self.queue_wait_samples))
        resumes = _snapshot(lambda: list(self.resume_latency_samples))
        handoffs = _snapshot(lambda: list(self.handoff_ms_samples))

        def p50_of(samples: list) -> float:
            vals = sorted(samples)
            return vals[len(vals) // 2] if vals else 0.0

        def p50(key: str) -> float:
            return p50_of([t[key] for t in timings])

        pipeline = {
            "depth": self._depth,
            "rounds": n_rounds,
            "mixed_rounds": self.rounds["mixed"] + self.rounds["prefill"],
            "lookahead_rounds": la["used"],
            "overlap_ratio": round(la["used"] / max(1, n_rounds), 3),
            "lookahead": la,
            "discard_ratio": round(la["discarded"] / max(1, la["dispatched"]), 3),
            "depth_hist": {str(d): c for d, c in depth_hist},
            "prefill_chunks": self.prefill_chunks,
            "chunked_prefill_tokens": self.chunked_prefill_tokens,
            "dispatch_ms_p50": p50("dispatch_ms"),
            "sync_wait_ms_p50": p50("sync_wait_ms"),
            "host_emit_ms_p50": p50("host_emit_ms"),
            "ms_by_kind": {kind: {"count": self.rounds[kind], **self.round_split_ms[kind]}
                           for kind in _ROUND_KINDS},
            "decode_graphs": bool(self._chunk and self._chunk.graphs),
            "decode_graph_replays": self._chunk.replays if self._chunk else 0,
            "decode_eager_chunks": self._chunk.eager_runs if self._chunk else 0,
            # a speculative round's decode step (:meth:`_dispatch_verify`)
            "verify_step_graph_replays": self._step.replays if self._step else 0,
            "verify_step_eager_runs": self._step.eager_runs if self._step else 0,
        }
        return {
            "mode": "mixed" if self.mixed else
                    "phase_separated" if self.paged else "dense",
            "use_flash": self.use_flash,
            "rounds": dict(self.rounds),
            "round_ms": dict(self.round_ms),
            "pipeline": pipeline,
            "prefix_cache": pool,
            "max_shared_chain_pages": self.max_shared_chain_pages,
            "prefill_chunks": self.prefill_chunks,
            "chunked_prefill_tokens": self.chunked_prefill_tokens,
            "prefill_dispatches": self.prefill_dispatches,
            "coalesced_prefills": self.coalesced_prefills,
            "suffix_prefills": self.suffix_prefills,
            "prefill_ms": self.prefill_ms,
            "tokens_emitted": self.tokens_emitted,
            "requests_completed": self.requests_completed,
            "rejected_saturated": self.rejected_saturated,
            "round_timings": timings,
            "slots": self.n_slots,
            "active_slots": self.active_slots,
            "active": self.active_slots,
            "prefilling": len(self._prefill_slots),
            "pending": self._pending.qsize(),
            "suspended": len(self._suspended),
            "preemptions": self.preemptions,
            "queue_wait_ms": {"p50": round(p50_of(waits), 3),
                              "max": round(max(waits), 3) if waits else 0.0,
                              "count": len(waits)},
            "queue": {"pending": self._pending.qsize(),
                      "per_tenant": self._pending.depths(),
                      "drain_rate_per_s": round(self._drain_rate_per_s(), 3),
                      "retry_after_s": round(self._saturation_retry_after(
                          self._pending.qsize()), 1)},
            "tenants": self.tenant_snapshot(),
            "cancellations": dict(_snapshot(lambda: list(self.cancellations.items()))),
            "reclaimed_tokens": self.reclaimed_tokens,
            "resume_recovery_ms": {"p50": round(p50_of(resumes) * 1e3, 3),
                                   "count": len(resumes)},
            "pd": {"role": self.pd_role, "exported": self.handoffs_exported,
                   "imported": self.handoffs_imported,
                   "handoff_ms": {"p50": round(p50_of(handoffs), 3),
                                  "max": round(max(handoffs), 3) if handoffs else 0.0,
                                  "count": len(handoffs)}},
            "closed": self._closed,
            "pages_in_use": pool["pages_in_use"] if pool else 0,
            "pages_free": pool["pages_free"] if pool else 0,
            "pages_total": pool["pages_total"] if pool else 0,
            "pages_referenced": pool["pages_referenced"] if pool else 0,
            "orphan_pages": pool["orphan_pages"] if pool else 0,
            "cached_pages": pool["cached_pages"] if pool else 0,
            "kernel_launches": {
                "ragged_paged_attention": pa.ragged_paged_attention.launches,
                "paged_decode_attention": pa.paged_decode_attention.launches,
                "flash_self_attention": fa.flash_self_attention.launches,
            },
            "speculative": self._spec_snapshot(),
            "mesh": self.mesh_info(),
            "device": str(self.device),
            "broken": self._broken,
        }

    def mesh_info(self) -> dict[str, Any]:
        """The serving-mesh block (JAX ``mesh_info``; ``stats()["mesh"]``,
        ``/v1/monitoring/replicas``, the ``llm_mesh_*`` gauges): tp degree,
        rank devices (ranks sharing a card each count), whether the kv heads
        shard, the page-pool bytes a device holds and the feasibility plan.
        Attribute reads only."""
        devices = self.mesh.devices if self.mesh is not None else (self.device,)
        kv_sharded = self.mesh is not None and self.params.kv_sharded
        info: dict[str, Any] = {
            "tp": self.tp,
            "devices": len(devices),
            "distinct_devices": len({str(d) for d in devices}),
            "rank_devices": [str(d) for d in devices],
            "topology": f"{self.device.type}:{self.tp}",
            "kv_heads_sharded": kv_sharded,
        }
        if self.pool is not None:
            info["sharded_page_bytes_per_device"] = self.pool.rank_bytes()[0]
        if self.feasibility is not None:
            info["plan"] = {k: self.feasibility.get(k) for k in (
                "param_bytes_per_device", "param_bytes_per_rank", "kv_bytes_per_device",
                "total_bytes_per_device", "hbm_bytes", "hbm_utilization", "fits", "enforced", "quantization")}
        return info

    def _spec_snapshot(self) -> dict[str, Any]:
        """``stats()["speculative"]``: the counts, the accept rate and the
        accept-length histogram (accepted drafts of a span → spans)."""
        spec = dict(self.spec_stats)
        hist = _snapshot(lambda: sorted(self._spec_accept_hist.items()))
        return {"k": self.spec_k, **spec,
                "accept_rate": round(spec["accepted"] / max(1, spec["proposed"]), 3),
                "accept_hist": {str(a): c for a, c in hist}}

    # ------------------------------------------------------------------ loop
    def _run_loop(self) -> None:
        logger.info("continuous scheduler up on %s: %d slots, chunk %d, lookahead %d",
                    self.device, self.n_slots, self._k_steps, self._depth)
        if self.device.type == "cuda" and self.device.index is not None:
            torch.cuda.set_device(self.device)
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    # cancels and deadlines apply before admission: a lapsed
                    # request must not take the slot this pass hands out
                    self._service_cancellations()
                    self._service_tenant_caps()
                    admitted = self._admit()
                    if not self.active.any() and not self._prefill_slots:
                        if admitted == 0:
                            self._wake.wait(timeout=0.1)
                            self._wake.clear()
                        continue
                    self._decode_round()
                except Exception as e:  # noqa: BLE001 — device faults must not hang clients
                    logger.exception("scheduler loop failed; failing in-flight requests")
                    self._broken = str(e)[:500]
                    self._fail_all_inflight("scheduler loop failed")
                    return

    def _fail_all_inflight(self, why: str) -> None:
        """End every occupied, suspended, admitting and queued request with
        ``error``: the loop-fault path and :meth:`close`. The queue and the
        suspended list are drained under the submit lock (a racing submit
        either lands before the drain or sees the engine dead); the emits
        run after it."""
        logger.warning("failing every request in flight: %s", why)
        self._ring.clear()
        with self._cancel_lock:
            self._cancel_requests.clear()
        stranded = [(st.request_id, st.emit, why) for st in self.slots if st is not None]
        self.slots = [None] * self.n_slots
        self.active[:] = False
        self._prefill_slots.clear()
        self._soft_yield.clear()
        with self._submit_lock:
            stranded += [(rec.state.request_id, rec.state.emit, f"{why} while suspended")
                         for rec in self._suspended]
            self._suspended.clear()
            stranded += [(req.request_id, req.emit, f"{why} while queued")
                         for req in self._pending.drain_all()]
        stranded += [(st.request_id, st.emit, why) for st in self._admitting]
        self._admitting = []
        for request_id, emit, detail in stranded:
            # recorded BEFORE the emit: a pool's failover resubmits inside it,
            # and the terminal must close this attempt's record
            record_event(request_id, "error", detail=detail)
            try:
                emit(StepEvent(0, -1, "error"))
            except Exception:  # noqa: BLE001 — one client's fault must not strand the rest
                pass

    # ------------------------------------------------------------------ admission
    def _admit(self) -> int:
        """Resume suspended requests first (paged), then take pending ones
        by fair order and place them (:meth:`_take_pending`)."""
        t0 = time.perf_counter()
        failpoint("scheduler.admit")
        admitted = self._resume_suspended() if self.paged else 0
        if self.mixed:
            admitted += len(self._take_pending(place=self._admit_prefill_slot))
        else:
            admitted += self._admit_phase_separated()
        self._last_admit_ms = (time.perf_counter() - t0) * 1e3
        return admitted

    def _take_pending(self, place: Optional[Callable[[_Pending], None]] = None
                      ) -> list[_Pending]:
        """Pop requests by weighted-fair order (tenants at a cap skipped)
        while slots are free; phase-separated, also while this round's
        ``prefill_budget_tokens`` are not spent (always at least one). A
        request whose deadline passed, or whose remaining budget cannot
        cover its estimated prefill while the engine is busy, ends with
        ``deadline`` and never takes a slot. ``place`` (mixed mode) puts
        each request into its slot as it is taken, so a request that
        arrives meanwhile still joins this pass; the order and the seeds
        are those of taking all first."""
        budget = self.config.prefill_budget_tokens
        taken: list[_Pending] = []
        spent = popped = 0
        blocked = self._blocked_tenants()
        max_slots = self.config.tenant_max_slots if self._tenant_caps_armed else 0
        tenant_taken = self._tenant_slot_counts() if max_slots else {}
        while len(self._free_slots) > (0 if place else len(taken)):
            if not self.mixed and budget > 0 and spent >= budget and taken:
                break
            req = self._pending.pop_fair(blocked)
            if req is None:
                break
            popped += 1
            if req.deadline is not None:
                now = time.monotonic()
                busy = self.active.any() or bool(self._prefill_slots)
                if now >= req.deadline or (busy and req.deadline - now <
                                           self._estimate_prefill_s(len(req.prompt_ids))):
                    self._cancel_finalize(req.emit, "deadline", "deadline_exceeded",
                                          reclaimed=req.sampling.max_tokens,
                                          request_id=req.request_id, phase="queued",
                                          trace=req.trace, tenant=req.tenant)
                    continue
            taken.append(req)
            spent += len(req.prompt_ids)
            if max_slots:
                tenant_taken[req.tenant] = tenant_taken.get(req.tenant, 0) + 1
                if tenant_taken[req.tenant] >= max_slots:
                    blocked.add(req.tenant)
            wait_ms = (time.monotonic() - req.enqueued_at) * 1e3
            self.queue_wait_samples.append(wait_ms)
            record_event(req.request_id, "admitted", tenant=req.tenant,
                         queue_wait_ms=round(wait_ms, 3))
            if place is not None:
                place(req)
        if popped:
            self._admit_events.append((time.monotonic(), popped))
        return taken

    def _new_state(self, req: _Pending) -> _SlotState:
        """Host state of an admitted request; its stream's seed is fixed here,
        in the order requests leave the queue, whatever path prefills it."""
        s = req.sampling
        seed = s.seed if s.seed is not None else \
            (self.seed * 1_000_003 + self._admitted) & _SEED_MASK
        self._admitted += 1
        return _SlotState(
            request_id=req.request_id, emit=req.emit, sampling=s,
            stops=frozenset(s.stop_token_ids) | frozenset(self.config.eos_token_ids),
            prompt_ids=list(req.prompt_ids), chain=[],
            generator=make_slot_generator(seed, self.device)
            if self.paged and s.temperature > 0 else None,
            trace=req.trace, trace_sampled=traceparent_ids(req.trace)[1],
            deadline=req.deadline, tenant=req.tenant, prefill_wall=time.time())

    def _admit_prefill_slot(self, req: _Pending) -> None:
        """Claim a free slot in prefill phase with no device work: the round
        loop consumes the prompt chunk by chunk, from the end of the
        prefix-cache match on."""
        slot = self._free_slots.popleft()
        state = self._new_state(req)
        state.phase, state.prefill_t0 = "prefill", time.monotonic()
        cached_pages, cached_len = self.pool.match_prefix(req.prompt_ids)
        if cached_pages:
            # references, not the radix pin, hold the pages from here on
            self.pool.ref_pages(cached_pages)
        # load-bearing also when the match was trimmed to empty (a fully
        # cached prompt): this is the only unpin of the matched nodes
        self.pool.release(req.prompt_ids)
        state.chain = list(cached_pages)
        state.prefill_pos = state.cached_len = cached_len
        self.slots[slot] = state
        self.lengths[slot] = 0
        self.page_table[slot, :] = 0
        self.page_table[slot, :len(state.chain)] = state.chain
        self._pt_dirty = True
        self._patch_slot_device(slot, state, length=0, active=False,
                                limit=len(state.prompt_ids) + req.sampling.max_tokens - 1)
        self._prefill_slots.append(slot)
        self._epoch += 1

    def _resume_suspended(self) -> int:
        """Put preempted requests back (FIFO) while slots and pool space
        allow; they outrank new admissions. A soft-quota yield waits while
        another tenant has pending work and its tenant is still over the
        cap. A request that cannot fit an idle pool (or the whole pool) ends
        with ``length`` instead of waiting for ever."""
        resumed = 0
        deferred: list[_Suspended] = []
        while self._suspended and self._free_slots:
            rec = self._suspended[0]
            if rec.soft_yielded and self._defer_soft_yield(rec.state.tenant):
                with self._submit_lock:
                    deferred.append(self._suspended.popleft())
                continue
            # an armed raise breaks the engine mid-recovery: every client
            # still gets exactly one terminal
            failpoint("scheduler.resume")
            try:
                t_import = time.perf_counter()
                # a PD handoff lands through the import half of the pair
                chain = (self.pool.import_pages(rec.host_kv) if rec.handoff
                         else self.pool.restore_chain_from_host(rec.host_kv))
                try:
                    self.pool.extend_chain(chain, rec.length + self._k_steps)
                except MemoryError:
                    self.pool.release_slot(chain)  # a half-resume must not leak
                    raise
            except MemoryError:
                need = self.pool.pages_for(rec.length + self._k_steps)
                if need > self.pool.capacity_pages or not self.active.any():
                    with self._submit_lock:
                        self._suspended.popleft()
                    logger.warning("request %s (len=%d) cannot fit the pool; finishing "
                                   "with 'length'", rec.state.request_id, rec.length)
                    self.requests_completed += 1
                    record_event(rec.state.request_id, "finished", reason="length",
                                 shed=True, tokens=rec.state.emitted)
                    rec.state.emit(StepEvent(0, -1, "length"))
                    continue
                break  # no room yet; stay suspended
            with self._submit_lock:
                self._suspended.popleft()
            slot = self._free_slots.popleft()
            state = rec.state
            state.chain = chain
            # a decode-phase request resumes with the proposer it was armed
            # with at its activation (its history and gate evidence ride in
            # the parked state, as in JAX); a prefill-phase one is armed when
            # its last chunk flips it
            self.slots[slot] = state
            if state.generator is not None and rec.gen_state is not None:
                state.generator.set_state(rec.gen_state)
            s = state.sampling
            if state.phase == "prefill":
                # chunking continues from prefill_pos; nothing was drawn yet
                self.active[slot] = False
                self.lengths[slot] = 0
                self._patch_slot_device(slot, state, length=0, active=False,
                                        limit=len(state.prompt_ids) + s.max_tokens - 1)
                self._prefill_slots.append(slot)
            else:
                self.active[slot] = True
                self.lengths[slot] = rec.length
                # L - emitted + max_tokens is the original T + max_tokens - 1
                self._patch_slot_device(slot, state, length=rec.length, active=True,
                                        limit=rec.length - state.emitted + s.max_tokens)
                self._last_dev[slot].fill_(rec.last_token)
            # the new page ids reach the device rows (and a decode graph's
            # static page table) at the next dispatch's flush
            self.page_table[slot, :] = 0
            self.page_table[slot, :len(chain)] = chain
            self._pt_dirty = True
            self._epoch += 1
            resumed += 1
            pause_s = time.monotonic() - rec.suspended_at
            if rec.handoff:
                # routing, not pool pressure: no preemption or recovery sample
                self.handoffs_imported += 1
                self.handoff_ms_samples.append(
                    rec.export_ms + (time.perf_counter() - t_import) * 1e3)
                record_event(state.request_id, "handoff_import", slot=slot,
                             length=rec.length, pages=len(chain),
                             pause_ms=round(pause_s * 1000.0, 3))
            else:
                self.resume_latency_samples.append(pause_s)
                record_recovery("scheduler.resume", pause_s)
                record_event(state.request_id, "resumed", slot=slot, phase=state.phase,
                             pause_ms=round(pause_s * 1000.0, 3))
                if state.trace_sampled:
                    # the pause the stream saw, backdated to the preemption
                    get_global_tracer().emit_span(
                        "llm.preempt", traceparent=state.trace,
                        start_unix_ns=int(rec.suspended_wall * 1e9),
                        duration_ms=pause_s * 1000.0, request_id=state.request_id,
                        slot=slot)
        if deferred:
            with self._submit_lock:
                self._suspended.extendleft(reversed(deferred))
        return resumed

    def _defer_soft_yield(self, tenant: str) -> bool:
        """Keep a soft-quota yield parked while another tenant has pending
        work and ``tenant`` still holds more than its soft cap."""
        key = self._pending._key(tenant)
        if not any(t != key and d > 0 for t, d in self._pending.depths().items()):
            return False
        soft = self.config.tenant_soft_pages
        return soft > 0 and self._tenant_page_counts().get(tenant, 0) > soft

    def _admit_phase_separated(self) -> int:
        """Take pending requests (:meth:`_take_pending`), then prefill them.
        With coalescing (paged mode) each request is matched once here, its
        pin held until its prefill: cold requests of one bucket share a
        dispatch in groups of up to ``prefill_coalesce``, prefix hits and
        the rest prefill alone. Each request is in its slot, first token
        emitted, when this returns."""
        self._admitting = [self._new_state(req) for req in self._take_pending()]
        taken = list(self._admitting)
        coalesce = max(1, self.config.prefill_coalesce) if self.paged else 1
        singles: list[tuple[_SlotState, Optional[tuple[list[int], int]]]] = []
        groups: dict[int, list[_SlotState]] = {}
        for state in taken:
            if coalesce > 1:
                match = self.pool.match_prefix(state.prompt_ids)
                if match[0]:
                    singles.append((state, match))
                    continue
                # load-bearing: a fully cached prompt pinned nodes its trimmed
                # match does not return; the cold path never releases them
                self.pool.release(state.prompt_ids)
                groups.setdefault(self.config.bucket_for(len(state.prompt_ids)),
                                  []).append(state)
            else:
                singles.append((state, None))
        for bucket in sorted(groups):
            group = groups[bucket]
            while group:
                batch, group = group[:coalesce], group[coalesce:]
                if len(batch) == 1:
                    singles.append((batch[0], ([], 0)))
                else:
                    self._prefill(batch, bucket)
        for state, match in singles:
            self._prefill_single(state, match)
        return len(taken)

    def _prefill_single(self, state: _SlotState,
                        prematched: Optional[tuple[list[int], int]]) -> None:
        """Prefill one request: over its cached prefix when it has one (JAX
        ``_prefill_into_slot``). ``prematched`` is the admission's match
        (its pin still held on a hit); None matches here. Exactly one
        release per held pin. An armed ``scheduler.prefill`` raise ends only
        this request (its pin released), as JAX's failed-admission path."""
        try:
            failpoint("scheduler.prefill")
        except Exception:  # noqa: BLE001 — injected before any work
            logger.exception("prefill failed for %s", state.request_id)
            if prematched is not None and prematched[0]:
                self.pool.release(state.prompt_ids)
            self._admitting.remove(state)
            record_event(state.request_id, "error", detail="prefill failed")
            try:
                state.emit(StepEvent(0, -1, "error"))
            except Exception:  # noqa: BLE001 — the emit may be the fault
                pass
            return
        T = len(state.prompt_ids)
        bucket = self.config.bucket_for(T)
        if self.pool is None:
            self._prefill([state], bucket)
            return
        if prematched is None:
            cached_pages, cached_len = self.pool.match_prefix(state.prompt_ids)
            pin_held = True
        else:
            (cached_pages, cached_len), pin_held = prematched, bool(prematched[0])
        if cached_pages:
            # the suffix lands at cached_len in a fresh cache, which must hold
            # it whole: grow the bucket, or prefill cold near the window edge
            suf_bucket = self.config.bucket_for(T - cached_len)
            if cached_len + suf_bucket <= self.config.max_seq_len:
                bucket = max(bucket, next(b for b in self.config.buckets()
                                          if b >= cached_len + suf_bucket))
                try:
                    self._prefill_hit(state, cached_pages, cached_len, bucket, suf_bucket)
                finally:
                    self.pool.release(state.prompt_ids)
                return
            self.pool.release(state.prompt_ids)
            pin_held = False
        try:
            self._prefill([state], bucket)
        finally:
            if pin_held:
                self.pool.release(state.prompt_ids)

    def _prefill(self, states: list[_SlotState], bucket: int) -> None:
        """One cold prefill dispatch (JAX ``prefill`` for one request,
        ``batch_prefill`` for a coalesced group): rows pad to a power-of-two
        batch that replays row 0; the first token of each request is sampled
        in the same dispatch, and each request is placed into a free slot."""
        t0, wall0 = time.perf_counter(), time.time()
        dev, cfg = self.device, self.model_config
        B = len(states)
        Bp = 1 << (B - 1).bit_length()
        ids = np.zeros((Bp, bucket), np.int32)
        lengths = np.zeros(Bp, np.int32)
        for i, st in enumerate(states):
            T = len(st.prompt_ids)
            ids[i, :T] = st.prompt_ids
            lengths[i] = T
        ids[B:], lengths[B:] = ids[0], lengths[0]
        last_h, kv = llama.prefill_collect(self.params, cfg, to_device(ids, dev),
                                           to_device(lengths, dev), self.rope_tables,
                                           use_flash=self.use_flash)
        logits = llama.lm_head_logits(self.params, cfg, last_h)
        if self.paged:  # each request's own stream: one draw
            first = self._sample_rows(logits, states + [None] * (Bp - B))
        else:
            st = states[0]
            warp = self._warp_rows([st])
            first = sample_token(logits, self._generator, *warp,
                                 all_greedy=not st.sampling.temperature > 0)
        self._place_prefilled(states, kv, [[] for _ in states], first, t0, wall0)
        self.coalesced_prefills += int(B > 1)
        self.prefill_ms += (time.perf_counter() - t0) * 1e3
        self._note_prefill_rate(sum(len(st.prompt_ids) for st in states),
                                time.perf_counter() - t0)
        for st in states:
            self._charge_tenant(st.tenant, len(st.prompt_ids))

    def _prefill_hit(self, state: _SlotState, cached_pages: list[int], cached_len: int,
                     bucket: int, suf_bucket: int) -> None:
        """Prefill a prefix hit: gather the cached pages into a fresh cache of
        ``bucket`` positions, run :func:`suffix_prefill` over the suffix,
        sample the first token, and place the request (JAX's hit branch of
        ``_prefill_into_slot``). The caller holds the radix pin."""
        t0, wall0 = time.perf_counter(), time.time()
        dev = self.device
        suffix = state.prompt_ids[cached_len:]
        ids = np.zeros((1, suf_bucket), np.int32)
        ids[0, :len(suffix)] = suffix
        cache = llama.init_model_cache(self.params, self.model_config, 1, bucket)
        cache = self.pool.gather_for_prefill(cached_pages, bucket, cache)
        logits, kv = suffix_prefill(self.params, self.model_config, to_device(ids, dev),
                                    to_device(np.asarray([len(suffix)], np.int32), dev),
                                    cached_len, cache, self.rope_tables)
        state.cached_len = cached_len
        self._place_prefilled([state], kv, [cached_pages], self._sample_rows(logits, [state]),
                              t0, wall0)
        self.suffix_prefills += 1
        self.prefill_ms += (time.perf_counter() - t0) * 1e3
        # only the uncached suffix is prefilled, and charged
        self._note_prefill_rate(len(suffix), time.perf_counter() - t0)
        self._charge_tenant(state.tenant, len(suffix))

    def _place_prefilled(self, states: list[_SlotState], kv: llama.KVCache,
                         cached: list[list[int]], first: torch.Tensor, t0: float,
                         wall0: float) -> None:
        """Put each prefilled request's KV row into its pool pages (or dense
        cache row), read the first tokens — the dispatch's one sync — and
        activate the slots, each after its ``prefill`` event and span (the
        first token may finish the request, and the terminal comes last).
        ``t0`` / ``wall0``: the dispatch's start on the two clocks."""
        slots = []
        for i, st in enumerate(states):
            slot = self._free_slots.popleft()
            row = llama.kv_row(kv, i)
            if self.paged:
                st.chain = self.pool.admit_slot(st.prompt_ids, cached[i], row)
            else:
                llama.insert_slot_kv(self.cache, row, slot)
            slots.append(slot)
        first_host = first.cpu().numpy()  # sync-point: the prefill dispatch's one read
        self.prefill_dispatches += 1
        dur_ms = (time.perf_counter() - t0) * 1e3
        B = len(states)
        for i, (st, slot) in enumerate(zip(states, slots)):
            self._admitting.remove(st)
            T = len(st.prompt_ids)
            attrs = ({"coalesced": True, "batch": B, "cached_len": 0} if B > 1
                     else {"coalesced": False, "cached_len": st.cached_len})
            record_event(st.request_id, "prefill", slot=slot, prompt_tokens=T,
                         dur_ms=round(dur_ms, 3), **attrs)
            if st.trace:
                get_global_tracer().emit_span(
                    "llm.prefill", traceparent=st.trace, start_unix_ns=int(wall0 * 1e9),
                    duration_ms=dur_ms, request_id=st.request_id, slot=slot,
                    prompt_tokens=T, tenant=st.tenant,
                    **({"coalesced": True, "batch": B} if B > 1
                       else {"cached_len": st.cached_len}))
            self._activate_slot(slot, st, int(first_host[i]))

    def _activate_slot(self, slot: int, state: _SlotState, tok: int) -> None:
        """Commit a prefilled request into its slot (host mirrors, device rows,
        page-table row) and emit its first token."""
        T = len(state.prompt_ids)
        if self.paged:
            self.page_table[slot, :] = 0
            self.page_table[slot, :len(state.chain)] = state.chain
            self._pt_dirty = True
        self.slots[slot] = state
        self.lengths[slot] = T
        self.active[slot] = True
        self._patch_slot_device(slot, state, length=T, active=True,
                                limit=T + state.sampling.max_tokens - 1)
        self._last_dev[slot].fill_(tok)
        self._epoch += 1
        self._arm_spec(state)
        self._emit_token(slot, tok, force_length=T + self._k_steps > self.config.max_seq_len)

    def _patch_slot_device(self, slot: int, state: _SlotState, length: int,
                           active: bool, limit: int) -> None:
        """Write one slot's device rows, in place (queued after every
        in-flight dispatch, so none of them sees it). Scalars go in as
        ``fill_`` arguments: ``t[slot] = x`` would copy a host scalar and
        wait for the device."""
        s = state.sampling
        for t, value in ((self._temp_dev, float(s.temperature)),
                         (self._top_p_dev, float(s.top_p)), (self._top_k_dev, int(s.top_k)),
                         (self._lengths_dev, length), (self._active_dev, active),
                         (self._finished_dev, False), (self._limit_dev, max(0, limit))):
            t[slot].fill_(value)
        row = np.full((self._stop_width,), -1, np.int32)
        ids = sorted(state.stops)[: self._stop_width]
        row[: len(ids)] = ids
        self._stops_dev[slot].copy_(to_device(row, self.device))
        self._dev_term[slot] = len(state.stops) <= self._stop_width

    def _deactivate_slot_device(self, slot: int) -> None:
        self._lengths_dev[slot].fill_(0)
        self._active_dev[slot].fill_(False)
        self._finished_dev[slot].fill_(True)

    def _flush_page_table(self) -> None:
        if self._pt_dirty:
            self._page_table_dev.copy_(to_device(self.page_table, self.device))
            self._pt_dirty = False

    def _extend_chain_to(self, slot: int, state: _SlotState, target: int) -> None:
        """Grow one slot's chain to cover ``target`` tokens and patch its
        page-table row; raises MemoryError when the pool cannot (nothing
        allocated)."""
        before = len(state.chain)
        if self.pool.pages_for(target) <= before:
            return
        self.pool.extend_chain(state.chain, target)
        self.page_table[slot, before: len(state.chain)] = state.chain[before:]
        self._pt_dirty = True

    def _grow_chain(self, slot: int, state: _SlotState, horizon: int) -> None:
        """Cover length + ``horizon`` for a decode slot. The horizon past the
        next chunk is optional: a slot that still covers its next chunk is
        never preempted for it (that would livelock: resume restores length
        + k, the next round asks for the deeper horizon again, and the KV
        round-trips for ever). Raises MemoryError only when even the next
        chunk cannot be covered."""
        L, max_seq = int(self.lengths[slot]), self.config.max_seq_len
        try:
            self._extend_chain_to(slot, state, min(L + horizon, max_seq))
            return
        except MemoryError:
            mandatory = min(L + self._k_steps, max_seq)
            if self.pool.pages_for(mandatory) <= len(state.chain):
                return
        self._extend_chain_to(slot, state, mandatory)

    def _ensure_chunk_capacity(self, horizon: int) -> None:
        """Before a dispatch from committed state (the ring is empty): every
        active chain covers length + ``horizon``; a slot the pool cannot
        serve is preempted to host, and so is a slot the cap sweep marked
        for a soft-quota yield while its tenant is still over the cap."""
        soft = self.config.tenant_soft_pages
        for slot in range(self.n_slots):
            state = self.slots[slot]
            if state is None or not self.active[slot]:
                continue
            if slot in self._soft_yield:
                self._soft_yield.discard(slot)
                if soft > 0 and self._tenant_page_counts().get(state.tenant, 0) > soft:
                    self._preempt_slot(slot, state, soft_yielded=True)
                    continue
            try:
                # an armed MemoryError forces the preempt-to-host path
                # without real pool pressure
                self._chain_pressure_check()
                self._grow_chain(slot, state, horizon)
            except MemoryError:
                self._preempt_slot(slot, state)

    @staticmethod
    def _chain_pressure_check() -> None:
        """The ``scheduler.page_alloc`` failpoint, shared by every decode
        chain growth: the capacity pass, ring extension and the mixed ring
        span."""
        failpoint("scheduler.page_alloc")

    def _preempt_slot(self, slot: int, state: _SlotState, soft_yielded: bool = False) -> None:
        """Preempt to host, never shed: copy the chain's KV to host, free its
        pages and the slot, and park the request with what resuming needs —
        the valid length (``prefill_pos`` in prefill phase), the last token
        and the generator's state. Only called with the ring empty, so the
        committed state is the emitted one and the generator states are
        put back."""
        is_prefill = state.phase == "prefill"
        length = state.prefill_pos if is_prefill else int(self.lengths[slot])
        record_event(state.request_id, "preempted", slot=slot, phase=state.phase,
                     length=length)
        logger.info("preempting %s to host (%s, len=%d, %d pages)%s", state.request_id,
                    state.phase, length, len(state.chain),
                    " (tenant soft-quota yield)" if soft_yielded else "")
        host_kv = self.pool.save_chain_to_host(state.chain)
        gen_state = state.generator.get_state() if state.generator is not None else None
        with self._submit_lock:
            self._suspended.append(_Suspended(
                state=state, host_kv=host_kv, length=length,
                last_token=0 if is_prefill else state.last_token, gen_state=gen_state,
                soft_yielded=soft_yielded))
        self.preemptions += 1
        if is_prefill:
            self._prefill_slots.remove(slot)
        self.active[slot] = False
        self.slots[slot] = None
        self._release_free_slot(slot)
        self._deactivate_slot_device(slot)
        self._epoch += 1
        self.pool.release_slot(state.chain)
        state.chain = []
        self.page_table[slot, :] = 0
        self._pt_dirty = True

    def _release_free_slot(self, slot: int) -> None:
        # a soft-yield mark dies with the occupancy: the next owner must not
        # inherit it
        self._soft_yield.discard(slot)
        self._free_slots.append(slot)

    def _warp_rows(self, states: list) -> tuple[torch.Tensor, ...]:
        """(temperature, top_p, top_k) device rows for prefill rows."""
        temp = np.zeros(len(states), np.float32)
        top_p = np.ones(len(states), np.float32)
        top_k = np.zeros(len(states), np.int32)
        for i, st in enumerate(states):
            if st is not None:
                temp[i], top_p[i], top_k[i] = (st.sampling.temperature,
                                               st.sampling.top_p, st.sampling.top_k)
        return tuple(to_device(a, self.device) for a in (temp, top_p, top_k))

    def _sample_rows(self, logits: torch.Tensor, states: list) -> torch.Tensor:
        """A prefill dispatch's first tokens: one draw from each sampling
        row's own generator (None rows are padding)."""
        gens = [st.generator if st is not None else None for st in states]
        all_greedy = not any(st is not None and st.sampling.temperature > 0
                             for st in states)
        return self._sample(logits, gens, all_greedy,
                            None if all_greedy else self._warp_rows(states))

    def _sampling_rows(self, mask: np.ndarray) -> tuple[list, bool]:
        """Per-row generators for rows in ``mask`` that sample (paged mode),
        and whether the whole round is greedy (then nothing is drawn or
        sorted)."""
        rows = [st if (st is not None and m) else None for st, m in zip(self.slots, mask)]
        return ([st.generator if st is not None else None for st in rows],
                not any(st is not None and st.sampling.temperature > 0 for st in rows))

    def _sample(self, logits: torch.Tensor, gens: list, all_greedy: bool,
                warp: Optional[tuple] = None) -> torch.Tensor:
        """Per-slot sampling: one draw from each row's own generator.
        ``warp`` is (temperature, top_p, top_k) per row; default: the slots'
        device rows."""
        if all_greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        temp, top_p, top_k = warp or (self._temp_dev, self._top_p_dev, self._top_k_dev)
        u = split_keys_per_slot(gens, [g is not None for g in gens], self.device)
        return sample_token_per_slot(logits, u, temp, top_p, top_k, all_greedy=False)

    # ------------------------------------------------------------------ emission
    def _emit_token(self, slot: int, tok: int, force_length: bool = False) -> None:
        state = self.slots[slot]
        if tok < 0:
            raise RuntimeError(f"slot {slot}: the device froze a row the host "
                               "still runs (termination rules disagree)")
        if state.proposer is not None:
            # the next round's drafts come from the live history
            state.proposer.extend([tok])
        state.emitted += 1
        state.last_token = tok
        self._charge_tenant(state.tenant, 1)
        if tok in state.stops:
            fin: Optional[str] = "stop"
        elif state.emitted >= state.sampling.max_tokens or force_length:
            fin = "length"
        else:
            fin = None
        self.tokens_emitted += 1
        if fin is not None:
            record_event(state.request_id, "finished", reason=fin, tokens=state.emitted)
            self.active[slot] = False
            self.slots[slot] = None
            self.requests_completed += 1
            self._release_free_slot(slot)
            if fin == "stop" and not self._dev_term[slot]:
                # a stop outside the device's stop row: the device ran the
                # row on, so every in-flight chunk is stale
                self._epoch += 1
            self._deactivate_slot_device(slot)
            if self.paged:
                self.pool.release_slot(state.chain)
                self.page_table[slot, :] = 0
                self._pt_dirty = True
        state.emit(StepEvent(0, tok, fin))

    # ------------------------------------------------------------------ rounds
    def _decode_round(self) -> None:
        """One round; a round whose slots were all preempted before its
        dispatch dispatches nothing and is not counted."""
        t0 = time.perf_counter()
        if not self.paged:
            kind = self._decode_round_dense()
        elif self._prefill_slots:
            kind = self._decode_round_mixed()
        else:
            kind = None
            if self.spec_k and not self._ring and self._spec_round_safe() \
                    and self._spec_candidates():
                # draft spans through the ragged dispatch, only off a drained
                # ring (in-flight chunks are valid and drain first; the ring
                # stops growing while drafts are live); the plain chunk round
                # runs when no draft survives planning
                kind = self._decode_round_mixed(spec_only=True)
            if kind is None:
                kind = self._decode_round_chunk()
        if kind is not None:
            self.round_ms[kind] += (time.perf_counter() - t0) * 1e3
            self.last_round_at = time.monotonic()

    def _record_round(self, kind: str, dispatch_ms: float, sync_wait_ms: float,
                      host_emit_ms: float, lookahead: bool, depth: int, ts: float,
                      spec_tokens: int = 0) -> None:
        """Count a finished round (with ``lookahead``: served by the ring)
        and its dispatch / sync-wait / host-emit split; ``ts`` is its start
        on the wall clock, and the admission pass before it rides along
        (the rounds' chrome trace draws the four stages)."""
        self.rounds[kind] += 1
        if lookahead:
            self.lookahead["used"] += 1
        split = self.round_split_ms[kind]
        split["dispatch_ms"] += dispatch_ms
        split["sync_wait_ms"] += sync_wait_ms
        split["host_emit_ms"] += host_emit_ms
        self.round_timings.append({"kind": kind, "dispatch_ms": dispatch_ms,
                                   "sync_wait_ms": sync_wait_ms,
                                   "host_emit_ms": host_emit_ms,
                                   "lookahead": lookahead, "depth": depth,
                                   "spec_tokens": spec_tokens, "ts": ts,
                                   "admit_ms": self._last_admit_ms,
                                   "active": self.active_slots})

    def _note_sharing(self) -> None:
        """Track the most pages two live chains share (read at dispatch, on
        this thread, so the reading does not depend on when another thread
        looks)."""
        chains = [set(st.chain) for st in self.slots if st is not None and st.chain]
        for i, a in enumerate(chains):
            for b in chains[i + 1:]:
                shared = len(a & b)
                if shared > self.max_shared_chain_pages:
                    self.max_shared_chain_pages = shared

    def _readback(self, tokens: torch.Tensor) -> tuple[torch.Tensor, Optional[Any]]:
        """Start the tokens' copy to the host without blocking: on CUDA into
        a free pinned buffer of the engine's (a ring slot's, or the mixed
        round's), marked done by an event. A buffer a discarded dispatch
        still copies into is safe to take: the copies run in stream order."""
        if self.device.type != "cuda":
            return tokens, None
        free = self._pinned[tuple(tokens.shape)]
        if not free:
            raise RuntimeError(f"no free pinned readback buffer of shape {tuple(tokens.shape)}: "
                               "more dispatches in flight than the ring holds")
        host = free.pop()
        host.copy_(tokens, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host, ready

    def _give_back(self, rec: _InflightChunk) -> None:
        if rec.ready is not None:
            self._pinned[tuple(rec.host.shape)].append(rec.host)

    def _discard_ring(self) -> None:
        """Drop every undrained ring entry and put back the generator states
        recorded before the oldest of them: their draws were enqueued but
        never committed. Their KV writes lie past every committed length and
        are rewritten before anything reads them."""
        for rec in reversed(self._ring):
            for gen, saved in rec.gen_states:
                gen.set_state(saved)
            self._give_back(rec)
        self.lookahead["discarded"] += len(self._ring)
        self._ring.clear()

    def _commit_chunk(self, rec: _InflightChunk) -> np.ndarray:
        """Adopt a drained chunk's outputs as the engine's state (the active
        mask excepted), in place, and advance the host lengths; returns the
        lengths before the chunk."""
        self._last_dev.copy_(rec.last)
        self._lengths_dev.copy_(rec.lengths_dev)
        self._finished_dev.copy_(rec.finished_dev)
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + self._k_steps, 0).astype(np.int32)
        return old_lengths

    def _dispatch_chunk(self, after: Optional[_InflightChunk],
                        draw_mask: np.ndarray) -> _InflightChunk:
        """Enqueue ``decode_chunk`` fused decode steps over all slots
        (:class:`.programs.PagedDecodeChunk`: a graph replay on CUDA), from
        the committed state or chained off ``after``'s outputs; rows that hit
        a stop id, their limit or the window bound freeze on the device.
        ``draw_mask``: the rows whose generators draw. Commits nothing."""
        self._flush_page_table()
        self._note_sharing()
        if after is None:
            toks, lens, fin, active = (self._last_dev, self._lengths_dev,
                                       self._finished_dev, self._active_dev)
        else:
            toks, lens, fin, active = after.last, after.lengths_dev, after.finished_dev, \
                after.active_dev
        gens, all_greedy = self._sampling_rows(draw_mask)
        saved = [(g, g.get_state()) for g in gens if g is not None]
        chunk, last, lengths, finished = self._chunk(toks, lens, fin, active, gens, all_greedy)
        host, ready = self._readback(chunk)
        return _InflightChunk(chunk, last, lengths, finished, active, self._epoch, host, ready,
                              saved)

    def _can_extend_ring(self) -> bool:
        """Chain one more chunk off the ring's tail only while it is likely to
        be used: nothing changed since the ring's dispatches, no prompt chunk
        is waiting (the next round would be mixed), no admission or resume
        is due, no soft-quota yield is marked (it waits for a synchronous
        round), and every active chain covers the deeper horizon (a
        MemoryError only caps the ring; the next synchronous round
        preempts)."""
        if self._stop.is_set() or not self._ring or self._ring[-1].epoch != self._epoch:
            return False
        if self._prefill_slots or self._soft_yield or (
                self._free_slots and (self._suspended or not self._pending.empty())):
            return False
        if self.spec_k and self._spec_round_safe() and self._spec_candidates():
            # live drafts: let the ring drain so that the next dispatch
            # verifies them (one weight pass for up to k+1 tokens a row)
            return False
        horizon = (len(self._ring) + 1) * self._k_steps
        for slot in np.flatnonzero(self.active):
            try:
                self._chain_pressure_check()
                self._extend_chain_to(int(slot), self.slots[slot],
                                      min(int(self.lengths[slot]) + horizon,
                                          self.config.max_seq_len))
            except MemoryError:
                return False
        return True

    def _drain(self, rec: _InflightChunk) -> np.ndarray:
        # an armed raise models a device fault at the readback (the engine
        # breaks and every stream ends with error); a delay stalls every round
        failpoint("scheduler.readback")
        if rec.ready is not None:
            rec.ready.synchronize()  # sync-point: the round's one blocking read
        tokens = rec.host.numpy().copy()
        self._give_back(rec)
        return tokens

    def _decode_round_chunk(self) -> str:
        """A pure-decode round through the ring: drop a stale ring, dispatch
        from committed state if the ring is empty, top the ring up to
        ``depth`` chunks beyond the one drained, drain the oldest, commit it
        and emit its tokens."""
        t0, wall0 = time.perf_counter(), time.time()
        k, depth = self._k_steps, self._depth
        if self._ring and self._ring[0].epoch != self._epoch:
            self._discard_ring()
        used = bool(self._ring)
        if not used:
            self._ensure_chunk_capacity(k * (depth + 1))
            if not self.active.any():
                return None  # every slot was preempted
            self._ring.append(self._dispatch_chunk(None, self.active))
        while len(self._ring) <= depth and self._can_extend_ring():
            self._ring.append(self._dispatch_chunk(self._ring[-1], self.active))
            self.lookahead["dispatched"] += 1
        t1 = time.perf_counter()
        rec = self._ring.popleft()
        ring_depth = len(self._ring)
        chunk = self._drain(rec)
        t2 = time.perf_counter()
        self.depth_hist[ring_depth] = self.depth_hist.get(ring_depth, 0) + 1
        old_lengths = self._commit_chunk(rec)
        self._emit_decode_spans(wall0, (t2 - t0) * 1e3, used, depth=ring_depth)
        self._emit_chunk(chunk, old_lengths, depth=ring_depth)
        if self._ring and self._ring[0].epoch != self._epoch:
            self._discard_ring()
        self._record_round("decode", (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (time.perf_counter() - t2) * 1e3, used, ring_depth, wall0)
        return "decode"

    def _emit_decode_spans(self, wall0: float, dur_ms: float, lookahead: bool,
                           rows: Optional[list[int]] = None, tokens: Optional[int] = None,
                           depth: int = 0, row_tokens: Optional[dict] = None,
                           row_attrs: Optional[dict] = None) -> None:
        """``llm.decode_chunk`` spans of the sampled requests a drained round
        served, before its emit loop (a finish clears the slot's state): one
        bool a slot for the rest. Mixed rounds pass their decode ``rows``
        and ``tokens=1``; speculative ones the per-row advance
        (``row_tokens``) and acceptance (``row_attrs``)."""
        k = tokens if tokens is not None else self._k_steps
        start_ns = int(wall0 * 1e9)
        for slot in (rows if rows is not None else range(self.n_slots)):
            state = self.slots[slot]
            if state is None or not state.trace_sampled or not self.active[slot]:
                continue
            extra = row_attrs.get(slot, {}) if row_attrs else {}
            get_global_tracer().emit_span(
                "llm.decode_chunk", traceparent=state.trace, start_unix_ns=start_ns,
                duration_ms=dur_ms, request_id=state.request_id, slot=slot,
                tokens=row_tokens.get(slot, k) if row_tokens else k,
                lookahead=lookahead, depth=depth, **extra)

    def _plan_prefill_chunks(self) -> list[tuple[int, _SlotState, int]]:
        """This round's prompt chunks: ``prefill_budget_tokens`` filled FIFO
        across prefilling slots (0 = one whole-prompt chunk each)."""
        budget = self.config.prefill_budget_tokens
        left = budget if budget > 0 else float("inf")
        plan = []
        for slot in self._prefill_slots:
            if left <= 0:
                break
            state = self.slots[slot]
            remaining = len(state.prompt_ids) - state.prefill_pos
            chunk = int(min(remaining, left))
            if chunk <= 0:
                continue
            plan.append((slot, state, chunk))
            left -= chunk
        return plan

    # ------------------------------------------------------------------ speculation
    def _arm_spec(self, state: _SlotState) -> None:
        """At decode activation, give a greedy request whose token limit
        fires before the window bound could (prompt + max_tokens - 1 +
        decode_chunk ≤ max_seq_len) a proposer seeded with its prompt. A
        window-bound stream's 'length' finish lands on a chunk boundary,
        which a speculative round's variable advance would move, so those
        streams never speculate; nor do sampled ones (acceptance is argmax
        equality)."""
        s = state.sampling
        if not self.spec_k or s.temperature != 0.0:
            return
        if len(state.prompt_ids) + s.max_tokens - 1 + self._k_steps > self.config.max_seq_len:
            return
        state.proposer = NgramProposer(self.config.spec_max_ngram,
                                       self.config.spec_min_ngram, self.spec_k)
        state.proposer.extend(state.prompt_ids)

    def _spec_candidates(self) -> bool:
        """Some active row's proposer has a draft now."""
        return any(state is not None and self.active[slot] and state.proposer is not None
                   and state.proposer.propose() for slot, state in enumerate(self.slots))

    def _spec_round_safe(self) -> bool:
        """A pure-decode round may speculate only while every active row is
        limit-bound (see :meth:`_arm_spec`): such a stream ends at exactly
        max_tokens however rounds chunk its advance."""
        max_seq = self.config.max_seq_len
        for slot in np.flatnonzero(self.active):
            state = self.slots[slot]
            limit = int(self.lengths[slot]) - state.emitted + state.sampling.max_tokens
            if limit + self._k_steps > max_seq:
                return False
        return True

    def _spec_gate_closed(self, state: _SlotState) -> bool:
        """``spec_min_accept``: after 4·k proposed drafts, a stream accepting
        less than that share stops proposing for good."""
        floor = self.config.spec_min_accept
        if floor <= 0.0 or state.spec_proposed < 4 * self.spec_k:
            return False
        if state.spec_accepted < floor * state.spec_proposed:
            state.proposer = None
            self.spec_stats["slots_disabled"] += 1
            record_event(state.request_id, "spec_disabled", proposed=state.spec_proposed,
                         accepted=state.spec_accepted)
            return True
        return False

    def _plan_spec(self, budget_left: float) -> list[tuple[int, _SlotState, list[int]]]:
        """This round's draft spans: one proposal per armed active row,
        trimmed to what is left of the shared ragged token budget, to the
        row's remaining tokens (a draft past max_tokens can never commit)
        and the window; a row whose chain cannot grow to cover its span is
        skipped this round, never preempted (the capacity pass already
        covered its next chunk)."""
        plan: list[tuple[int, _SlotState, list[int]]] = []
        max_seq = self.config.max_seq_len
        for slot, state in enumerate(self.slots):
            if budget_left <= 0:
                break
            if state is None or not self.active[slot] or state.proposer is None \
                    or self._spec_gate_closed(state):
                continue
            L = int(self.lengths[slot])
            if L + self._spec_w + self._k_steps > max_seq:
                continue
            cap = int(min(self.spec_k, state.sampling.max_tokens - state.emitted - 1,
                          budget_left))
            drafts = state.proposer.propose() if cap > 0 else None
            if not drafts:
                continue
            drafts = drafts[:cap]
            try:
                self._extend_chain_to(slot, state, min(L + 1 + len(drafts), max_seq))
            except MemoryError:
                continue
            plan.append((slot, state, drafts))
            budget_left -= len(drafts)
        return plan

    def _spec_outputs(self, outs: torch.Tensor, drafts: torch.Tensor,
                      spec_lens: torch.Tensor, run: torch.Tensor, sampled: torch.Tensor,
                      final: torch.Tensor, final_lens: torch.Tensor
                      ) -> tuple[torch.Tensor, ...]:
        """The accept and commit of a speculative round (the tail of JAX
        ``spec_mixed_step``), on the device. ``outs`` [N, spec_w]: the
        model's token after each span position (column 0: each row's next
        token, sampled or greedy); ``drafts`` [N, spec_w - 1]. Commits the
        accepted drafts' continuation, cut at the first stop, limit or
        window hit, and advances the lengths. Returns (the [N, spec_w] emit
        matrix, -1 past each row's commit, with the accept counts in one
        more column, -1 for rows that did not speculate; last tokens;
        lengths; finished)."""
        W, k = self._spec_w, self._k_steps
        lengths, last = self._lengths_dev, self._last_dev
        spec = (spec_lens > 0) & run
        accepts = greedy_accept_counts(outs, drafts, spec_lens)
        idx = torch.arange(W, dtype=torch.int32, device=outs.device)[None, :]
        in_commit = idx < torch.where(spec, accepts + 1, torch.ones_like(accepts))[:, None]
        is_stop = (outs[:, :, None] == self._stops_dev[:, None, :]).any(dim=2)
        # a final-chunk row's device length is 0: its length after the first
        # token is final_lens, as in the mixed round
        eff = torch.where(run, lengths, torch.where(final, final_lens - 1, lengths))
        after = eff[:, None] + idx + 1
        hit = (after >= self._limit_dev[:, None]) | (after + k > self.config.max_seq_len)
        fin_at = (is_stop | hit) & in_commit
        # token i commits while nothing fired before it
        alive = (torch.cumsum(fin_at.to(torch.int32), dim=1) - fin_at.to(torch.int32)) == 0
        emit = in_commit & alive
        n_emit = emit.sum(dim=1, dtype=torch.int32)
        toks = torch.where(emit & sampled[:, None], outs, torch.full_like(outs, -1))
        at_last = torch.clamp_min(n_emit - 1, 0).long()[:, None]
        new_last = torch.where(sampled, outs.gather(1, at_last)[:, 0], last)
        new_lens = torch.where(run, lengths + n_emit,
                               torch.where(final, final_lens,
                                           torch.where(self._active_dev, lengths,
                                                       torch.zeros_like(lengths))))
        fin = self._finished_dev | (sampled & (fin_at & emit).any(dim=1))
        acc_col = torch.where(spec, accepts, torch.full_like(accepts, -1))
        return (torch.cat([toks, acc_col[:, None]], dim=1), new_last,
                new_lens.to(torch.int32), fin)

    def _greedy_span(self, hidden: torch.Tensor, width: int) -> torch.Tensor:
        """The argmax after each of the first ``width`` positions of every
        row's span: [N, width] int32."""
        N, H = hidden.shape[0], hidden.shape[-1]
        logits = llama.lm_head_logits(self.params, self.model_config,
                                      hidden[:, :width].reshape(N * width, H))
        return torch.argmax(logits, dim=-1).to(torch.int32).reshape(N, width)

    def _dispatch_verify(self, spec_plan: list[tuple[int, _SlotState, list[int]]]
                         ) -> _InflightChunk:
        """A speculative round with no prompt chunk, in two passes. First a
        decode step over every slot (:attr:`_step`, the program a decode
        chunk's step runs; a graph replay on CUDA) gives each row its next
        token and writes its KV: a row that does not speculate, a sampled
        one included, computes exactly what a decode chunk would, whatever
        rows speculate beside it. (On the card bf16 products depend on the
        row count, so a single ragged pass over every row's span would give
        such a row other bits than the plain round k=0 runs there.) Then the
        speculating rows' drafts run as ragged spans at positions L+1..L+d,
        and :meth:`_spec_outputs` accepts and commits. Nothing is read back
        here."""
        n, dev, W = self.n_slots, self.device, self._spec_w
        drafts = np.zeros((n, -(-(W - 1) // 8) * 8), np.int32)
        spec_lens = np.zeros(n, np.int32)
        for slot, _, d in spec_plan:
            drafts[slot, :len(d)] = d
            spec_lens[slot] = len(d)
        self._flush_page_table()
        self._note_sharing()
        active, fin, lengths = self._active_dev, self._finished_dev, self._lengths_dev
        step, _, _, _ = self._step(self._last_dev, lengths, fin, active,
                                   *self._sampling_rows(self.active))
        drafts_d, lens_d = to_device(drafts, dev), to_device(spec_lens, dev)
        run = active & ~fin
        spec = (lens_d > 0) & run
        hidden, _ = llama.forward_paged_mixed(
            self.params, self.model_config, drafts_d, self.pool.pools,
            self._page_table_dev, lengths + 1, torch.where(spec, lens_d, 0), self.rope_tables,
            write_mask=spec, moe_tokens=int(spec_lens.sum()))
        outs = torch.cat([step[:, :1], self._greedy_span(hidden, W - 1)], dim=1)
        none = torch.zeros_like(active)
        toks, new_last, new_lens, new_fin = self._spec_outputs(
            outs, drafts_d[:, :W - 1], lens_d, run, run, none, torch.zeros_like(lengths))
        host, ready = self._readback(toks)
        return _InflightChunk(toks, new_last, new_lens, new_fin, active, self._epoch,
                              host, ready)

    def _dispatch_mixed(self, plan: list[tuple[int, _SlotState, int]],
                        spec_plan: list[tuple[int, _SlotState, list[int]]]
                        ) -> tuple[_InflightChunk, list[tuple[int, _SlotState]]]:
        """Enqueue a round with prompt chunks: decode rows (q_len 1), this
        round's chunks and any draft spans (1 + d positions: the last token,
        then the drafts) in one ragged forward, as JAX ``mixed_step`` /
        ``spec_mixed_step``. Returns the round's record and the rows whose
        final chunk ran (they flip to decode on the device)."""
        n, dev, k = self.n_slots, self.device, self._k_steps
        q_need = self.config.bucket_for(max(c for _, _, c in plan))
        if spec_plan:
            q_need = max(q_need, self._spec_w)
        q_max = -(-q_need // 8) * 8
        q_ids = np.zeros((n, q_max), np.int32)
        q_lens = np.zeros(n, np.int32)
        hist = np.zeros(n, np.int32)
        spec_lens = np.zeros(n, np.int32)
        q_lens[self.active] = 1  # decode rows
        sample = self.active.copy()
        final_mask = np.zeros(n, bool)
        final_lens = np.zeros(n, np.int32)
        finals = []
        for slot, state, chunk in plan:
            pos = state.prefill_pos
            q_ids[slot, :chunk] = state.prompt_ids[pos: pos + chunk]
            q_lens[slot] = chunk
            hist[slot] = pos
            if pos + chunk == len(state.prompt_ids):
                finals.append((slot, state))
                sample[slot] = final_mask[slot] = True
                final_lens[slot] = len(state.prompt_ids)
        for slot, _, drafts in spec_plan:
            # position 0 (the last token) is filled on the device
            q_ids[slot, 1:1 + len(drafts)] = drafts
            q_lens[slot] = 1 + len(drafts)
            spec_lens[slot] = len(drafts)
        self._flush_page_table()
        self._note_sharing()
        q_ids_d, q_lens_d, hist_d, sample_d, final_d, final_lens_d = (
            to_device(a, dev) for a in (q_ids, q_lens, hist, sample, final_mask, final_lens))
        active, fin, lengths = self._active_dev, self._finished_dev, self._lengths_dev

        run = active & ~fin
        q_ids_d[:, 0] = torch.where(active, self._last_dev, q_ids_d[:, 0])
        hist_d = torch.where(active, lengths, hist_d)
        hidden, _ = llama.forward_paged_mixed(
            self.params, self.model_config, q_ids_d,
            self.pool.pools, self._page_table_dev,
            hist_d, q_lens_d, self.rope_tables, write_mask=run | ~active,
            moe_tokens=int(q_lens.sum()))
        logits = llama.lm_head_logits(self.params, self.model_config,
                                      llama.gather_last_hidden(hidden, q_lens_d))
        nxt = self._sample(logits, *self._sampling_rows(sample))
        sampled = sample_d & ~fin
        if spec_plan:
            # the speculating rows (greedy) commit the argmax after each span
            # position; the others the round's next token, as a mixed round
            spec_lens_d = to_device(spec_lens, dev)
            outs = self._greedy_span(hidden, self._spec_w)
            outs[:, 0] = torch.where((spec_lens_d > 0) & run, outs[:, 0], nxt)
            toks, new_last, new_lens, new_fin = self._spec_outputs(
                outs, q_ids_d[:, 1:self._spec_w], spec_lens_d, run, sampled, final_d,
                final_lens_d)
        else:
            new_lens = torch.where(run, lengths + 1,
                                   torch.where(final_d, final_lens_d,
                                               torch.where(active, lengths,
                                                           torch.zeros_like(lengths))))
            is_stop = (nxt[:, None] == self._stops_dev).any(dim=1)
            hit = (new_lens >= self._limit_dev) | (new_lens + k > self.config.max_seq_len)
            toks = torch.where(sampled, nxt, torch.full_like(nxt, -1))
            new_last = torch.where(sampled, nxt, self._last_dev)
            new_lens, new_fin = new_lens.to(torch.int32), fin | (sampled & (is_stop | hit))
        host, ready = self._readback(toks)
        rec = _InflightChunk(toks, new_last, new_lens, new_fin, active | final_d,
                             self._epoch, host, ready)
        return rec, finals

    def _decode_round_mixed(self, spec_only: bool = False) -> Optional[str]:
        """One ragged mixed round: decode rows take their next token while
        this round's prompt chunks run in the same forward. A ring in flight
        is stale (the admission bumped the epoch) and is discarded; when this
        round consumes the last prompt chunks, the ring chains straight off
        its outputs (:meth:`_mixed_ring_span`).

        Speculative rounds (``scheduler_spec_k`` > 0): armed rows with a
        draft verify it, sharing the round's token budget with the prompt
        chunks (chunks first; drafts get what is left, at least k): in the
        round's one ragged forward when it carries prompt chunks
        (:meth:`_dispatch_mixed`), else as a decode step and a ragged pass
        over the drafts (:meth:`_dispatch_verify`). Accept and commit run on
        the device (:meth:`_spec_outputs`), and the round keeps its one
        read. ``spec_only``: the pure-decode entry (no prompt chunk);
        returns None without dispatching when no draft survives planning. A
        speculative dispatch never chains the ring."""
        t0, wall0 = time.perf_counter(), time.time()
        n, k = self.n_slots, self._k_steps
        if self._ring:
            self._discard_ring()
        # decode rows keep a chunk of headroom, prompt rows cover their
        # chunk; a slot the pool cannot serve is preempted to host
        self._ensure_chunk_capacity(k)
        plan = []
        if not spec_only:
            for slot, state, chunk in self._plan_prefill_chunks():
                try:
                    # an armed MemoryError preempts mid-chunked-prefill
                    failpoint("scheduler.prefill_chunk")
                    self._extend_chain_to(slot, state, state.prefill_pos + chunk)
                    plan.append((slot, state, chunk))
                except MemoryError:
                    self._preempt_slot(slot, state)
        spec_plan = []
        if self.spec_k:
            budget = self.config.prefill_budget_tokens
            spec_plan = self._plan_spec(
                max(budget - sum(c for _, _, c in plan), self.spec_k) if budget > 0
                else float("inf"))
        if not plan and not spec_plan:
            return None  # every planned slot was preempted: the next pass decodes
        if plan:
            rec, finals = self._dispatch_mixed(plan, spec_plan)
        else:
            rec, finals = self._dispatch_verify(spec_plan), []
        spanned = 0 if spec_plan else self._mixed_ring_span(rec, finals)
        t1 = time.perf_counter()
        toks_host = self._drain(rec)
        t2 = time.perf_counter()
        # the mixed dispatch flipped its final rows on the device: adopt its
        # active mask with the rest, in place
        for mine, new in ((self._last_dev, rec.last), (self._lengths_dev, rec.lengths_dev),
                          (self._finished_dev, rec.finished_dev),
                          (self._active_dev, rec.active_dev)):
            mine.copy_(new)

        # one emit loop for both: a speculative round's rows are -1-terminated
        # token lists (accept counts in the last column), a plain one's one token
        if spec_plan:
            toks2d, accepts = toks_host[:, :-1], toks_host[:, -1]
        else:
            toks2d, accepts = toks_host[:, None], None
        emitted = (toks2d >= 0).sum(axis=1).astype(np.int32)
        decode_rows = [s for s in range(n) if self.active[s]]
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + emitted,
                                self.lengths).astype(np.int32)
        dur_ms = (t2 - t0) * 1e3
        row_attrs = {slot: {"spec_proposed": len(drafts), "spec_accepted": int(accepts[slot])}
                     for slot, _, drafts in spec_plan} if spec_plan else None
        self._emit_decode_spans(
            wall0, dur_ms, lookahead=False, rows=decode_rows, tokens=1, depth=spanned,
            row_tokens={s: int(emitted[s]) for s in decode_rows} if spec_plan else None,
            row_attrs=row_attrs)
        if spec_plan:
            # before the emit loop: a finish clears the slot's state
            self.spec_stats["rounds"] += 1
            self.spec_stats["mixed_rounds"] += int(bool(plan))
            round_proposed = round_accepted = 0
            for slot, state, drafts in spec_plan:
                a = int(accepts[slot])
                round_proposed += len(drafts)
                round_accepted += a
                self.spec_stats["proposed"] += len(drafts)
                self.spec_stats["accepted"] += a
                self.spec_stats["emitted"] += int(emitted[slot])
                self._spec_accept_hist[a] = self._spec_accept_hist.get(a, 0) + 1
                state.spec_proposed += len(drafts)
                state.spec_accepted += a
            bump_counter("llm_spec_tokens_proposed_total", n=round_proposed)
            bump_counter("llm_spec_tokens_accepted_total", n=round_accepted)
        for slot, state, chunk in plan:
            state.prefill_pos += chunk
            state.prefill_chunks += 1
            self.prefill_chunks += 1
            self.chunked_prefill_tokens += chunk
            self._charge_tenant(state.tenant, chunk)
            # one event per piggybacked chunk (as decode_chunk)
            record_event(state.request_id, "prefill_chunk", slot=slot, tokens=chunk,
                         pos=state.prefill_pos, of=len(state.prompt_ids))
            if state.trace_sampled:
                get_global_tracer().emit_span(
                    "llm.prefill_chunk", traceparent=state.trace,
                    start_unix_ns=int(wall0 * 1e9), duration_ms=dur_ms,
                    request_id=state.request_id, slot=slot, tokens=chunk)
        for slot, state in finals:
            self._finish_prefill(slot, state, int(toks2d[slot, 0]), bump_epoch=spanned == 0)
        for slot in decode_rows:
            state = self.slots[slot]
            if state is None or not self.active[slot]:
                continue
            record_event(state.request_id, "decode_chunk", slot=slot,
                         tokens=max(1, int(emitted[slot])), depth=spanned,
                         **(row_attrs.get(slot, {}) if row_attrs else {}))
            # an active row always commits one token at least: a -1 here (the
            # device froze a row the host runs) raises in _emit_token
            for j in range(max(1, int(emitted[slot]))):
                if not self.active[slot]:
                    break  # a finish on the host ends the row's list
                no_room = int(old_lengths[slot]) + j + 1 + k > self.config.max_seq_len
                self._emit_token(slot, int(toks2d[slot, j]), force_length=no_room)
        if self._ring and self._ring[0].epoch != self._epoch:
            self._discard_ring()
        kind = ("mixed" if decode_rows else "prefill") if plan else "decode"
        self._record_round(kind, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (time.perf_counter() - t2) * 1e3, False, spanned, wall0,
                           spec_tokens=sum(len(d) for _, _, d in spec_plan))
        return kind

    def _mixed_ring_span(self, rec: _InflightChunk,
                         finals: list[tuple[int, _SlotState]]) -> int:
        """When this mixed dispatch consumes the last prompt chunks, its
        outputs already hold the flipped state (active mask, first tokens,
        lengths), so decode chunks chain straight off it instead of waiting
        for a synchronous round. Chains grow first; a MemoryError caps the
        span. Returns the chunks chained."""
        if (self._depth <= 0 or len(finals) != len(self._prefill_slots)
                or self._suspended or not self._pending.empty() or self._stop.is_set()):
            return 0
        k, max_seq = self._k_steps, self.config.max_seq_len
        flipping = np.zeros(self.n_slots, bool)
        for slot, _ in finals:
            flipping[slot] = True
        draw = self.active | flipping
        tail, chained = rec, 0
        for h in range(self._depth):
            horizon = 1 + (h + 1) * k  # the mixed token, then h+1 chunks
            try:
                self._chain_pressure_check()
                for slot in np.flatnonzero(draw):
                    state = self.slots[slot]
                    L = int(self.lengths[slot]) if self.active[slot] else len(state.prompt_ids)
                    self._extend_chain_to(int(slot), state, min(L + horizon, max_seq))
            except MemoryError:
                break
            tail = self._dispatch_chunk(tail, draw)
            self._ring.append(tail)
            self.lookahead["dispatched"] += 1
            chained += 1
        return chained

    def _finish_prefill(self, slot: int, state: _SlotState, tok: int,
                        bump_epoch: bool = True) -> None:
        """Flip a fully prefilled slot to decode (the device flipped its rows
        in the same dispatch), publish its prompt's full pages to the radix
        tree and emit its first token. ``bump_epoch=False`` when the ring
        chained off that dispatch and so already holds the flip."""
        T = len(state.prompt_ids)
        self.pool.commit_chain(state.prompt_ids, state.chain)
        self._prefill_slots.remove(slot)
        state.phase = "decode"
        self._arm_spec(state)
        self.lengths[slot] = T
        self.active[slot] = True
        if bump_epoch:
            self._epoch += 1
        dur_ms = (time.monotonic() - state.prefill_t0) * 1e3
        self._note_prefill_rate(T - state.cached_len, dur_ms / 1e3)
        # the terminal "prefill" event (ttft anchors here; the progress is in
        # the prefill_chunk events), recorded before the first token's emit
        record_event(state.request_id, "prefill", slot=slot, mixed=True,
                     cached_len=state.cached_len, prompt_tokens=T,
                     chunks=state.prefill_chunks, dur_ms=round(dur_ms, 3))
        if state.trace:
            get_global_tracer().emit_span(
                "llm.prefill", traceparent=state.trace,
                start_unix_ns=int(state.prefill_wall * 1e9), duration_ms=dur_ms,
                request_id=state.request_id, slot=slot, prompt_tokens=T,
                cached_len=state.cached_len, mixed=True, chunks=state.prefill_chunks,
                tenant=state.tenant)
        self._emit_token(slot, tok, force_length=T + self._k_steps > self.config.max_seq_len)
        # a prefill-role engine's work ends at the first token; a stream the
        # emit just finished (stop or length on token one) has nothing to move
        if self.pd_role == "prefill" and self._handoff_sink is not None \
                and self.slots[slot] is state:
            self._export_handoff(slot, state, tok)

    def _export_handoff(self, slot: int, state: _SlotState, tok: int) -> None:
        """Move a just-prefilled stream off this prefill-role engine: its
        chain's pages to host (tree pages stay cached here, private ones
        free), the slot freed as a preemption frees it, and a handoff record
        (length, first token, the generator's state after its first draw)
        to the pool's sink. A raise here (the ``scheduler.handoff``
        failpoint, a copy fault) breaks the engine, whose streams then end
        with ``error`` and fail over in the pool."""
        failpoint("scheduler.handoff")
        t0 = time.perf_counter()
        T = int(self.lengths[slot])
        n_pages = len(state.chain)
        host_kv = self.pool.export_pages(state.chain)
        if host_kv[0].is_pinned():
            # the decode engine may live on another card or stream: the
            # bytes must be on the host before the record leaves
            torch.cuda.current_stream(self.device).synchronize()  # sync-point: the export's one wait
        state.chain = []
        gen_state = state.generator.get_state() if state.generator is not None else None
        rec = _Suspended(state=state, host_kv=host_kv, length=T, last_token=tok,
                         gen_state=gen_state, handoff=True,
                         export_ms=(time.perf_counter() - t0) * 1e3)
        self.active[slot] = False
        self.slots[slot] = None
        self._release_free_slot(slot)
        self._deactivate_slot_device(slot)
        self._epoch += 1
        self.page_table[slot, :] = 0
        self._pt_dirty = True
        self.handoffs_exported += 1
        record_event(state.request_id, "handoff_export", slot=slot, length=T,
                     pages=n_pages, tokens_emitted=state.emitted)
        self._handoff_sink(rec)

    def _decode_round_dense(self) -> str:
        """``decode_chunk`` fused decode steps over the dense cache
        (:func:`.engine.build_decode_chunk_fn`, device-side termination);
        synchronous, as in JAX."""
        t0, wall0 = time.perf_counter(), time.time()
        _, all_greedy = self._sampling_rows(self.active)
        chunk, k_cache, v_cache, last, _, lens, fin = self._dense_decode_fn(
            self.params, self.cache[0], self.cache[1], self._last_dev,
            self._lengths_dev, self._generator, self._temp_dev, self._top_p_dev,
            self._top_k_dev, self._active_dev, self._finished_dev, self._stops_dev,
            self._limit_dev, all_greedy=all_greedy)
        t1 = time.perf_counter()
        chunk_host = chunk.cpu().numpy()  # sync-point: the dense round's one read
        t2 = time.perf_counter()
        self.cache = (k_cache, v_cache)
        self._last_dev, self._lengths_dev, self._finished_dev = last, lens, fin
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + self._k_steps, 0).astype(np.int32)
        self._emit_decode_spans(wall0, (t2 - t0) * 1e3, lookahead=False)
        self._emit_chunk(chunk_host, old_lengths)
        self._record_round("decode", (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (time.perf_counter() - t2) * 1e3, False, 0, wall0)
        return "decode"

    def _emit_chunk(self, chunk: np.ndarray, old_lengths: np.ndarray,
                    depth: int = 0) -> None:
        """Emit a fused chunk's tokens [n_slots, k] step by step; a stream
        that cannot fit the next chunk ends with 'length' at this one's end.
        First, one ``decode_chunk`` event a slot (``depth``: the ring chunks
        still in flight at this drain), never one a token."""
        k = self._k_steps
        for slot in range(self.n_slots):
            state = self.slots[slot]
            if state is not None and self.active[slot]:
                record_event(state.request_id, "decode_chunk", slot=slot, tokens=k,
                             depth=depth)
        for j in range(k):
            last_of_chunk = j == k - 1
            for slot in range(self.n_slots):
                if not self.active[slot]:
                    continue
                overflow = int(old_lengths[slot]) + 2 * k > self.config.max_seq_len
                self._emit_token(slot, int(chunk[slot, j]),
                                 force_length=last_of_chunk and overflow)
