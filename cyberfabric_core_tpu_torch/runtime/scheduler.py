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
decode steps through :func:`ops.paged_attention.paged_decode_attention`,
through the **lookahead ring** (``decode_lookahead`` deep): a round drains
the oldest in-flight chunk while up to ``depth`` later chunks, each chained
off the device outputs of the one before, are already queued, so the host's
emit loop overlaps the device. Dispatch commits nothing: a chunk's outputs
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
blocking device→host read: on CUDA each dispatch copies its tokens into a
pinned buffer of its own without blocking and records an event, and the
round waits on the event of the chunk it drains. Host→device patches go
through pinned staging buffers of their own (:func:`device.to_device`), so
nothing else in a round waits for the device.

Randomness on the paged paths: each sampling slot draws from its own
``torch.Generator`` on the engine's device, seeded from
``SamplingParams.seed`` or else from the engine seed and the request's
admission number, and advanced once per sampled token — a seed reproduces
its tokens whatever shares the batch, whichever path prefills it, and at
every lookahead depth.

Options that only change speed (tenant fairness, and ``prefill_coalesce``
where no phase-separated paged prefill runs) are accepted and ignored; the
JAX contract makes streams identical across those settings. Options that
change what is computed or which path runs and are not ported raise
``NotImplementedError`` naming the slice that brings them (see
:func:`_reject_unported`).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..models import llama
from ..models.configs import ModelConfig, get_config
from ..ops import flash_attention as fa
from ..ops import paged_attention as pa
from ..ops.rope import rope_frequencies
from ..ops.sampling import (make_slot_generator, sample_token, sample_token_per_slot,
                            split_keys_per_slot)
from .engine import (EngineConfig, SamplingParams, SchedulerSaturated, StepEvent,
                     build_decode_chunk_fn)
from .paged import PrefixKVPool
from .weights import model_from_state_dict

logger = logging.getLogger("scheduler")

_SEED_MASK = 0x7FFF_FFFF_FFFF_FFFF
_ROUND_KINDS = ("mixed", "prefill", "decode")


def _reject_unported(config: EngineConfig, cfg: ModelConfig) -> None:
    """Options that change what is computed or which path runs, and are not
    in this slice of the port."""
    checks = [
        (config.quantization != "none", f"quantization={config.quantization!r} "
         "(weight quantization slice)"),
        (config.scheduler_spec_k > 0, "scheduler_spec_k>0 (speculative "
         "rounds slice)"),
        (config.tp > 1, "tp>1 (multi-GPU slice)"),
        (bool(config.pd_role), f"pd_role={config.pd_role!r} (replica pools "
         "and PD slice)"),
        (cfg.num_experts > 0, f"{cfg.name} is a mixture-of-experts config "
         "(MoE slice)"),
        (bool(config.tenant_max_slots or config.tenant_soft_pages
              or config.tenant_max_pages or config.tenant_max_pending),
         "per-tenant caps (preemption, cancellation and tenant caps slice)"),
    ]
    for bad, what in checks:
        if bad:
            raise NotImplementedError(f"not ported yet: {what}")


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
    if config.tenant_fair:
        out.append("tenant_fair (admission is FIFO)")
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


@dataclass
class _Pending:
    request_id: str
    prompt_ids: list[int]
    sampling: SamplingParams
    emit: Callable[[StepEvent], None]


@dataclass
class _InflightChunk:
    """A dispatched, not yet drained dispatch: one entry of the lookahead
    ring (or a mixed round's own record). Its device tensors are outputs the
    engine adopts only at the drain. ``active_dev`` is the mask it was
    dispatched with; a chained chunk reuses it, and it is never committed
    from a decode chunk (the host's finishes since must stand). ``host`` and
    ``ready`` are the tokens' pinned readback buffer and the event that
    marks the copy done (None on the CPU); ``gen_states`` the drawing
    slots' generator states before this dispatch, put back on a discard."""

    chunk_dev: torch.Tensor   # [N, k] tokens, -1 for frozen rows ([N] for mixed)
    last: torch.Tensor        # [N] last tokens after the dispatch
    lengths_dev: torch.Tensor
    finished_dev: torch.Tensor
    active_dev: torch.Tensor
    epoch: int
    host: torch.Tensor
    ready: Optional[torch.cuda.Event]
    gen_states: list = field(default_factory=list)


class ContinuousBatchingEngine:
    """Runs a scheduler thread driving the device; submission is
    thread-safe. ``emit`` callbacks fire on the scheduler thread."""

    def __init__(self, config: EngineConfig, params: Any = None, seed: int = 0,
                 device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.model_config = get_config(config.model)
        _reject_unported(config, self.model_config)
        ignored = _ignored_options(config)
        if ignored:
            logger.info("speed-only options ignored by this engine: %s",
                        "; ".join(ignored))
        cfg = self.model_config
        self.dtype = getattr(torch, config.dtype)
        if params is None:
            params = llama.init_params(cfg, seed, self.dtype, self.device)
        elif isinstance(params, Mapping):
            params = model_from_state_dict(params, cfg, self.device, self.dtype)
        elif params.device != self.device and not (
                params.device.type == self.device.type == "cuda"):
            raise ValueError(f"params live on {params.device}, engine on {self.device}")
        self.params = params
        self.seed = seed
        self.rope_tables = rope_frequencies(
            cfg.head_dim, max(cfg.max_position, config.max_seq_len),
            cfg.rope_theta, device=self.device)
        self.n_slots = n = config.max_batch
        self._k_steps = max(1, config.decode_chunk)
        self.paged = config.prefix_cache_pages > 0
        self.mixed = self.paged and config.mixed_batch
        self.use_flash = config.resolve_use_flash(self.device)
        if self.use_flash and self.device.type == "cuda":
            fa.check_kernel_supports(cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                                     self.dtype)
        page = config.prefix_page_size
        self.pmax = -(-config.max_seq_len // page)
        self.pool: Optional[PrefixKVPool] = None
        self.cache: Optional[llama.KVCache] = None
        if self.paged:
            # every slot must be able to hold a full-window chain; tree pages
            # past that are evicted on demand
            num_pages = max(config.prefix_cache_pages, n * self.pmax + 1)
            self.pool = PrefixKVPool(cfg, num_pages=num_pages, page_size=page,
                                     dtype=self.dtype, device=self.device)
        else:
            self.cache = llama.init_cache(cfg, n, config.max_seq_len, self.dtype,
                                          device=self.device)
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

        # the lookahead ring (paged decode rounds)
        self._depth = config.resolve_lookahead_depth() if self.paged else 0
        self._ring: deque[_InflightChunk] = deque()
        #: bumped by every change the in-flight ring cannot have seen
        self._epoch = 0

        self._pending: deque[_Pending] = deque()
        #: phase-separated admissions taken off the queue and not yet in a
        #: slot (a failing prefill must still close their streams)
        self._admitting: list[_SlotState] = []
        self._submit_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._thread_lock = threading.Lock()
        self._broken: Optional[str] = None
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

    # ------------------------------------------------------------------ public api
    def start(self) -> None:
        with self._thread_lock:
            if self._broken:
                raise RuntimeError(f"scheduler is broken: {self._broken}")
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

    def submit(self, prompt_ids: list[int], sampling: SamplingParams,
               emit: Callable[[StepEvent], None],
               request_id: Optional[str] = None) -> str:
        """Enqueue a request; ``emit`` receives one StepEvent per token, the
        last one carrying the finish reason. Raises :class:`SchedulerSaturated`
        at ``max_pending`` queued requests."""
        if not prompt_ids:
            raise ValueError("prompt_ids must hold at least one token")
        self.config.bucket_for(len(prompt_ids))  # validate in caller context
        if not self.paged and sampling.seed is not None:
            raise ValueError(
                "SamplingParams.seed requires the paged scheduler "
                "(prefix_cache_pages > 0); dense mode shares one sampling stream")
        rid = request_id or f"req-{uuid.uuid4().hex[:16]}"
        with self._submit_lock:
            if self._broken:
                raise RuntimeError(f"scheduler is broken: {self._broken}")
            if self.config.max_pending and len(self._pending) >= self.config.max_pending:
                self.rejected_saturated += 1
                raise SchedulerSaturated(
                    f"pending queue full ({self.config.max_pending} requests); "
                    "retry later")
            self._pending.append(_Pending(rid, list(prompt_ids), sampling, emit))
        self._wake.set()
        self.start()
        return rid

    @property
    def active_slots(self) -> int:
        return int(self.active.sum())

    def stats(self) -> dict[str, Any]:
        pool = self.pool.stats() if self.pool is not None else None
        la = dict(self.lookahead)
        n_rounds = sum(self.rounds.values())
        timings = _snapshot(lambda: list(self.round_timings))
        depth_hist = _snapshot(lambda: sorted(self.depth_hist.items()))

        def p50(key: str) -> float:
            vals = sorted(t[key] for t in timings)
            return vals[len(vals) // 2] if vals else 0.0

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
            "active_slots": self.active_slots,
            "pending": len(self._pending),
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
            "device": str(self.device),
            "broken": self._broken,
        }

    # ------------------------------------------------------------------ loop
    def _run_loop(self) -> None:
        logger.info("continuous scheduler up on %s: %d slots, chunk %d, lookahead %d",
                    self.device, self.n_slots, self._k_steps, self._depth)
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
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
                    self._fail_all_inflight()
                    return

    def _fail_all_inflight(self) -> None:
        self._ring.clear()
        for slot, state in enumerate(self.slots):
            if state is not None:
                self.slots[slot] = None
                state.emit(StepEvent(0, -1, "error"))
        self.active[:] = False
        self._prefill_slots.clear()
        with self._submit_lock:
            stranded = list(self._pending)
            self._pending.clear()
        stranded += self._admitting
        self._admitting = []
        for req in stranded:
            req.emit(StepEvent(0, -1, "error"))

    # ------------------------------------------------------------------ admission
    def _admit(self) -> int:
        return self._admit_mixed() if self.mixed else self._admit_phase_separated()

    def _pop_pending(self) -> Optional[_Pending]:
        with self._submit_lock:
            return self._pending.popleft() if self._pending else None

    def _new_state(self, req: _Pending) -> _SlotState:
        """Host state of an admitted request; its stream's seed is fixed here,
        in admission (FIFO) order, whatever path prefills it."""
        s = req.sampling
        seed = s.seed if s.seed is not None else \
            (self.seed * 1_000_003 + self._admitted) & _SEED_MASK
        self._admitted += 1
        return _SlotState(
            request_id=req.request_id, emit=req.emit, sampling=s,
            stops=frozenset(s.stop_token_ids) | frozenset(self.config.eos_token_ids),
            prompt_ids=list(req.prompt_ids), chain=[],
            generator=make_slot_generator(seed, self.device)
            if self.paged and s.temperature > 0 else None)

    def _admit_mixed(self) -> int:
        """Claim free slots for pending requests, FIFO, in prefill phase: no
        device work here — the round loop consumes their prompts chunk by
        chunk, from the end of the prefix-cache match on."""
        admitted = 0
        while self._free_slots:
            req = self._pop_pending()
            if req is None:
                break
            slot = self._free_slots.popleft()
            state = self._new_state(req)
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
            admitted += 1
        return admitted

    def _admit_phase_separated(self) -> int:
        """Take pending requests FIFO while slots are free and this round's
        ``prefill_budget_tokens`` are not spent (always at least one), then
        prefill them. With coalescing (paged mode) each request is matched
        once here, its pin held until its prefill: cold requests of one
        bucket share a dispatch in groups of up to ``prefill_coalesce``,
        prefix hits and the rest prefill alone. Each request is in its slot,
        first token emitted, when this returns."""
        budget = self.config.prefill_budget_tokens
        spent = 0
        while len(self._admitting) < len(self._free_slots):
            if budget > 0 and spent >= budget and self._admitting:
                break
            req = self._pop_pending()
            if req is None:
                break
            self._admitting.append(self._new_state(req))
            spent += len(req.prompt_ids)
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
        release per held pin."""
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
        t0 = time.perf_counter()
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
        self._place_prefilled(states, kv, [[] for _ in states], first)
        self.coalesced_prefills += int(B > 1)
        self.prefill_ms += (time.perf_counter() - t0) * 1e3

    def _prefill_hit(self, state: _SlotState, cached_pages: list[int], cached_len: int,
                     bucket: int, suf_bucket: int) -> None:
        """Prefill a prefix hit: gather the cached pages into a fresh cache of
        ``bucket`` positions, run :func:`suffix_prefill` over the suffix,
        sample the first token, and place the request (JAX's hit branch of
        ``_prefill_into_slot``). The caller holds the radix pin."""
        t0 = time.perf_counter()
        dev = self.device
        suffix = state.prompt_ids[cached_len:]
        ids = np.zeros((1, suf_bucket), np.int32)
        ids[0, :len(suffix)] = suffix
        cache = llama.init_cache(self.model_config, 1, bucket, self.dtype, device=dev)
        cache = self.pool.gather_for_prefill(cached_pages, bucket, cache)
        logits, kv = suffix_prefill(self.params, self.model_config, to_device(ids, dev),
                                    to_device(np.asarray([len(suffix)], np.int32), dev),
                                    cached_len, cache, self.rope_tables)
        state.cached_len = cached_len
        self._place_prefilled([state], kv, [cached_pages], self._sample_rows(logits, [state]))
        self.suffix_prefills += 1
        self.prefill_ms += (time.perf_counter() - t0) * 1e3

    def _place_prefilled(self, states: list[_SlotState], kv: llama.KVCache,
                         cached: list[list[int]], first: torch.Tensor) -> None:
        """Put each prefilled request's KV row into its pool pages (or dense
        cache row), read the first tokens — the dispatch's one sync — and
        activate the slots."""
        slots = []
        for i, st in enumerate(states):
            slot = self._free_slots.popleft()
            row = (kv[0][:, i:i + 1], kv[1][:, i:i + 1])
            if self.paged:
                st.chain = self.pool.admit_slot(st.prompt_ids, cached[i], row)
            else:
                llama.insert_slot_kv(self.cache, row, slot)
            slots.append(slot)
        first_host = first.cpu().numpy()  # sync-point: the prefill dispatch's one read
        self.prefill_dispatches += 1
        for i, (st, slot) in enumerate(zip(states, slots)):
            self._admitting.remove(st)
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

    def _grow_chain(self, slot: int, state: _SlotState, needed: int) -> None:
        """Extend a slot's chain to cover ``needed`` tokens. The pool holds a
        full-window chain for every slot beside what only the tree holds, so
        the horizon of the current chunk cannot run dry; a MemoryError past
        it caps the ring (preemption to host comes with a later slice)."""
        before = len(state.chain)
        if self.pool.pages_for(needed) <= before:
            return
        self.pool.extend_chain(state.chain, needed)
        self.page_table[slot, before: len(state.chain)] = state.chain[before:]
        self._pt_dirty = True

    def _ensure_chunk_capacity(self, horizon: int) -> None:
        for slot in np.flatnonzero(self.active):
            self._grow_chain(int(slot), self.slots[slot],
                             min(int(self.lengths[slot]) + horizon, self.config.max_seq_len))

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
        state.emitted += 1
        if tok in state.stops:
            fin: Optional[str] = "stop"
        elif state.emitted >= state.sampling.max_tokens or force_length:
            fin = "length"
        else:
            fin = None
        self.tokens_emitted += 1
        if fin is not None:
            self.active[slot] = False
            self.slots[slot] = None
            self.requests_completed += 1
            self._free_slots.append(slot)
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
        t0 = time.perf_counter()
        if not self.paged:
            kind = self._decode_round_dense()
        elif self._prefill_slots:
            kind = self._decode_round_mixed()
        else:
            kind = self._decode_round_chunk()
        self.round_ms[kind] += (time.perf_counter() - t0) * 1e3

    def _record_round(self, kind: str, dispatch_ms: float, sync_wait_ms: float,
                      host_emit_ms: float, lookahead: bool, depth: int) -> None:
        """Count a finished round (with ``lookahead``: served by the ring)
        and its dispatch / sync-wait / host-emit split."""
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
                                   "lookahead": lookahead, "depth": depth})

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
        a pinned buffer of their own, marked done by an event."""
        if self.device.type != "cuda":
            return tokens, None
        host = torch.empty(tokens.shape, dtype=tokens.dtype, pin_memory=True)
        host.copy_(tokens, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return host, ready

    def _discard_ring(self) -> None:
        """Drop every undrained ring entry and put back the generator states
        recorded before the oldest of them: their draws were enqueued but
        never committed. Their KV writes lie past every committed length and
        are rewritten before anything reads them."""
        for rec in reversed(self._ring):
            for gen, saved in rec.gen_states:
                gen.set_state(saved)
        self.lookahead["discarded"] += len(self._ring)
        self._ring.clear()

    def _commit_chunk(self, rec: _InflightChunk) -> np.ndarray:
        """Adopt a drained chunk's outputs as the engine's state (the active
        mask excepted) and advance the host lengths; returns the lengths
        before the chunk."""
        self._last_dev = rec.last
        self._lengths_dev = rec.lengths_dev
        self._finished_dev = rec.finished_dev
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + self._k_steps, 0).astype(np.int32)
        return old_lengths

    def _dispatch_chunk(self, after: Optional[_InflightChunk],
                        draw_mask: np.ndarray) -> _InflightChunk:
        """Enqueue ``decode_chunk`` fused decode steps over all slots, from
        the committed state or chained off ``after``'s outputs; rows that hit
        a stop id, their limit or the window bound freeze on the device.
        ``draw_mask``: the rows whose generators draw. Commits nothing."""
        k, cfg = self._k_steps, self.model_config
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
        emits = []
        for j in range(k):
            run = active & ~fin
            hidden, _ = llama.forward_paged_decode(
                self.params, cfg, toks[:, None], (self.pool.k_pool, self.pool.v_pool),
                self._page_table_dev, lens, self.rope_tables, write_mask=run)
            logits = llama.lm_head_logits(self.params, cfg, hidden[:, 0])
            nxt = self._sample(logits, gens, all_greedy)
            new_lens = lens + 1
            is_stop = (nxt[:, None] == self._stops_dev).any(dim=1)
            hit = new_lens >= self._limit_dev
            if j == k - 1:
                hit = hit | (new_lens + k > self.config.max_seq_len)
            emits.append(torch.where(run, nxt, torch.full_like(nxt, -1)))
            toks = torch.where(run, nxt, toks)
            lens = torch.where(run, new_lens, lens)
            fin = fin | (run & (is_stop | hit))
        chunk = torch.stack(emits, dim=1)
        host, ready = self._readback(chunk)
        return _InflightChunk(chunk, toks, torch.where(active, lens, torch.zeros_like(lens)),
                              fin, active, self._epoch, host, ready, saved)

    def _can_extend_ring(self) -> bool:
        """Chain one more chunk off the ring's tail only while it is likely to
        be used: nothing changed since the ring's dispatches, no prompt chunk
        is waiting (the next round would be mixed), no admission is due, and
        every active chain covers the deeper horizon (a MemoryError only
        caps the ring)."""
        if self._stop.is_set() or not self._ring or self._ring[-1].epoch != self._epoch:
            return False
        if self._prefill_slots or (self._free_slots and self._pending):
            return False
        horizon = (len(self._ring) + 1) * self._k_steps
        try:
            self._ensure_chunk_capacity(horizon)
        except MemoryError:
            return False
        return True

    def _drain(self, rec: _InflightChunk) -> np.ndarray:
        if rec.ready is not None:
            rec.ready.synchronize()  # sync-point: the round's one blocking read
        return rec.host.numpy()

    def _decode_round_chunk(self) -> str:
        """A pure-decode round through the ring: drop a stale ring, dispatch
        from committed state if the ring is empty, top the ring up to
        ``depth`` chunks beyond the one drained, drain the oldest, commit it
        and emit its tokens."""
        t0 = time.perf_counter()
        k, depth = self._k_steps, self._depth
        if self._ring and self._ring[0].epoch != self._epoch:
            self._discard_ring()
        used = bool(self._ring)
        if not used:
            self._ensure_chunk_capacity(k * (depth + 1))
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
        self._emit_chunk(chunk, self._commit_chunk(rec))
        if self._ring and self._ring[0].epoch != self._epoch:
            self._discard_ring()
        self._record_round("decode", (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (time.perf_counter() - t2) * 1e3, used, ring_depth)
        return "decode"

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

    def _decode_round_mixed(self) -> str:
        """One ragged mixed round: decode rows take their next token while
        this round's prompt chunks run in the same forward. A ring in flight
        is stale (the admission bumped the epoch) and is discarded; when this
        round consumes the last prompt chunks, the ring chains straight off
        its outputs (:meth:`_mixed_ring_span`)."""
        t0 = time.perf_counter()
        n, dev, k = self.n_slots, self.device, self._k_steps
        if self._ring:
            self._discard_ring()
        self._ensure_chunk_capacity(k)
        plan = self._plan_prefill_chunks()
        for slot, state, chunk in plan:
            self._grow_chain(slot, state, state.prefill_pos + chunk)
        q_need = self.config.bucket_for(max(c for _, _, c in plan))
        q_max = -(-q_need // 8) * 8
        q_ids = np.zeros((n, q_max), np.int32)
        q_lens = np.zeros(n, np.int32)
        hist = np.zeros(n, np.int32)
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
            (self.pool.k_pool, self.pool.v_pool), self._page_table_dev,
            hist_d, q_lens_d, self.rope_tables, write_mask=run | ~active)
        logits = llama.lm_head_logits(self.params, self.model_config,
                                      llama.gather_last_hidden(hidden, q_lens_d))
        nxt = self._sample(logits, *self._sampling_rows(sample))
        sampled = sample_d & ~fin
        new_lens = torch.where(run, lengths + 1,
                               torch.where(final_d, final_lens_d,
                                           torch.where(active, lengths,
                                                       torch.zeros_like(lengths))))
        is_stop = (nxt[:, None] == self._stops_dev).any(dim=1)
        hit = (new_lens >= self._limit_dev) | (new_lens + k > self.config.max_seq_len)
        toks = torch.where(sampled, nxt, torch.full_like(nxt, -1))
        host, ready = self._readback(toks)
        rec = _InflightChunk(toks, torch.where(sampled, nxt, self._last_dev),
                             new_lens.to(torch.int32), fin | (sampled & (is_stop | hit)),
                             active | final_d, self._epoch, host, ready)
        spanned = self._mixed_ring_span(rec, finals)
        t1 = time.perf_counter()
        toks_host = self._drain(rec)
        t2 = time.perf_counter()
        # the mixed dispatch flipped its final rows on the device: adopt its
        # active mask with the rest
        self._last_dev, self._lengths_dev = rec.last, rec.lengths_dev
        self._finished_dev, self._active_dev = rec.finished_dev, rec.active_dev

        decode_rows = [s for s in range(n) if self.active[s]]
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + 1, self.lengths).astype(np.int32)
        for slot, state, chunk in plan:
            state.prefill_pos += chunk
            self.prefill_chunks += 1
            self.chunked_prefill_tokens += chunk
        for slot, state in finals:
            self._finish_prefill(slot, state, int(toks_host[slot]), bump_epoch=spanned == 0)
        for slot in decode_rows:
            if self.active[slot]:
                no_room = int(old_lengths[slot]) + 1 + k > self.config.max_seq_len
                self._emit_token(slot, int(toks_host[slot]), force_length=no_room)
        if self._ring and self._ring[0].epoch != self._epoch:
            self._discard_ring()
        kind = "mixed" if decode_rows else "prefill"
        self._record_round(kind, (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (time.perf_counter() - t2) * 1e3, False, spanned)
        return kind

    def _mixed_ring_span(self, rec: _InflightChunk,
                         finals: list[tuple[int, _SlotState]]) -> int:
        """When this mixed dispatch consumes the last prompt chunks, its
        outputs already hold the flipped state (active mask, first tokens,
        lengths), so decode chunks chain straight off it instead of waiting
        for a synchronous round. Chains grow first; a MemoryError caps the
        span. Returns the chunks chained."""
        if (self._depth <= 0 or len(finals) != len(self._prefill_slots)
                or self._pending or self._stop.is_set()):
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
                for slot in np.flatnonzero(draw):
                    state = self.slots[slot]
                    L = int(self.lengths[slot]) if self.active[slot] else len(state.prompt_ids)
                    self._grow_chain(int(slot), state, min(L + horizon, max_seq))
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
        self.lengths[slot] = T
        self.active[slot] = True
        if bump_epoch:
            self._epoch += 1
        self._emit_token(slot, tok, force_length=T + self._k_steps > self.config.max_seq_len)

    def _decode_round_dense(self) -> str:
        """``decode_chunk`` fused decode steps over the dense cache
        (:func:`.engine.build_decode_chunk_fn`, device-side termination);
        synchronous, as in JAX."""
        t0 = time.perf_counter()
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
        self._emit_chunk(chunk_host, old_lengths)
        self._record_round("decode", (t1 - t0) * 1e3, (t2 - t1) * 1e3,
                           (time.perf_counter() - t2) * 1e3, False, 0)
        return "decode"

    def _emit_chunk(self, chunk: np.ndarray, old_lengths: np.ndarray) -> None:
        """Emit a fused chunk's tokens [n_slots, k] step by step; a stream
        that cannot fit the next chunk ends with 'length' at this one's end."""
        k = self._k_steps
        for j in range(k):
            last_of_chunk = j == k - 1
            for slot in range(self.n_slots):
                if not self.active[slot]:
                    continue
                overflow = int(old_lengths[slot]) + 2 * k > self.config.max_seq_len
                self._emit_token(slot, int(chunk[slot, j]),
                                 force_length=last_of_chunk and overflow)
