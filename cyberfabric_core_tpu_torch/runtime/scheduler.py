"""Continuous batching over a paged KV pool or a dense cache (counterpart of
``runtime/scheduler.py``).

The JAX ``ContinuousBatchingEngine`` on one CUDA device, on three paths:

- **Mixed** (the default: paged pool, ``mixed_batch=True``). ``submit``
  enqueues a request from any thread; a scheduler thread admits it into a
  free slot in PREFILL phase with no device work (``_admit_mixed``). Every
  round that carries prompt chunks is a ragged MIXED round
  (``_decode_round_mixed``): prompt chunks, FIFO across prefilling slots and
  within ``prefill_budget_tokens``, ride in the same forward as the decode
  rows (q_len 1) through :func:`ops.paged_attention.ragged_paged_attention`.
  The span width ``q_max`` is the prefill bucket of the largest chunk
  rounded up to 8, as in JAX. A request's first token is sampled in the
  dispatch that runs its final chunk, and the slot flips to decode.
- **Phase-separated** (paged pool, ``mixed_batch=False``). Admission
  (``_admit_phase_separated``) takes pending requests FIFO, paced by
  ``prefill_budget_tokens`` (at least one per round), and prefills them
  before the next decode round: same-bucket requests coalesce into one
  ``batch_prefill`` dispatch of up to ``prefill_coalesce`` rows (padded to a
  power of two), the rest prefill alone. Prefill is
  :func:`models.llama.prefill_collect` (flash kernel when
  ``resolve_use_flash``); the collected KV goes into fresh pool pages
  (``PrefixKVPool.admit_slot``) and the first token is sampled in the same
  dispatch from the slot's own generator. A prefix hit would take the
  ``suffix_prefill`` program, which comes with the radix prefix cache: until
  then every prompt is cold.
- **Dense** (``prefix_cache_pages=0``). The same prefill, one request per
  dispatch, into a dense cache ``[L, max_batch, max_seq_len, Hkv, D]``
  (:func:`models.llama.insert_slot_kv`); decode rounds run
  :func:`.engine.build_decode_chunk_fn` over it. Sampling shares one stream
  across the batch, so ``submit`` rejects a per-request seed.

On the paged paths, rounds with no prompt chunks run ``decode_chunk`` fused
decode steps (``_decode_round_chunk``) through
:func:`ops.paged_attention.paged_decode_attention`.

Termination is decided on the device as in JAX: per-slot stop-id rows,
``limit_lens`` (the max-tokens bound) and the window bound fold into a
finished mask, and a finished row freezes (its KV writes park on scratch page
0 or an unread position, its length and last token stop advancing, it emits
-1). The host mirrors the same rules to close each stream with one terminal
event. Each round (and each phase-separated prefill dispatch) ends with ONE
device→host read: its sampled tokens.

Randomness on the paged paths: each sampling slot draws from its own
``torch.Generator`` on the engine's device, seeded from
``SamplingParams.seed`` or else from the engine seed and the request's
admission number, and advanced once per sampled token — a seed reproduces
its tokens whatever shares the batch, and whether its prompt was chunked,
coalesced or prefilled alone.

Options that only change speed (``decode_lookahead``, tenant fairness, and
``prefill_coalesce`` where no phase-separated paged prefill runs) are
accepted and ignored — the engine runs synchronously, one round at a time,
admitting FIFO; the JAX contract makes streams identical across those
settings. Options that change what is computed or which path runs and are
not ported raise ``NotImplementedError`` naming the slice that brings them
(see :func:`_reject_unported`).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
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
    if config.resolve_lookahead_depth() > 0:
        out.append(f"decode_lookahead={config.decode_lookahead} (rounds run "
                   "synchronously)")
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


@dataclass
class _Pending:
    request_id: str
    prompt_ids: list[int]
    sampling: SamplingParams
    emit: Callable[[StepEvent], None]


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
            # every slot must be able to hold a full-window chain
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

        self.rounds = {"mixed": 0, "prefill": 0, "decode": 0}
        #: host wall time per round kind; every round ends in its one
        #: device→host read, so this is device-inclusive time
        self.round_ms = {"mixed": 0.0, "prefill": 0.0, "decode": 0.0}
        self.prefill_chunks = 0
        self.chunked_prefill_tokens = 0
        #: phase-separated prefill dispatches, those with more than one
        #: request, and their host wall time (each ends in its one read)
        self.prefill_dispatches = 0
        self.coalesced_prefills = 0
        self.prefill_ms = 0.0
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
        pool = self.pool.stats() if self.pool is not None else \
            {"pages_in_use": 0, "pages_free": 0, "pages_total": 0}
        return {
            "mode": "mixed" if self.mixed else
                    "phase_separated" if self.paged else "dense",
            "use_flash": self.use_flash,
            "rounds": dict(self.rounds),
            "round_ms": dict(self.round_ms),
            "prefill_chunks": self.prefill_chunks,
            "chunked_prefill_tokens": self.chunked_prefill_tokens,
            "prefill_dispatches": self.prefill_dispatches,
            "coalesced_prefills": self.coalesced_prefills,
            "prefill_ms": self.prefill_ms,
            "tokens_emitted": self.tokens_emitted,
            "requests_completed": self.requests_completed,
            "rejected_saturated": self.rejected_saturated,
            "active_slots": self.active_slots,
            "pending": len(self._pending),
            "pages_in_use": pool["pages_in_use"],
            "pages_free": pool["pages_free"],
            "pages_total": pool["pages_total"],
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
        logger.info("continuous scheduler up on %s: %d slots, chunk %d",
                    self.device, self.n_slots, self._k_steps)
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
        chunk."""
        admitted = 0
        while self._free_slots:
            req = self._pop_pending()
            if req is None:
                break
            slot = self._free_slots.popleft()
            state = self._new_state(req)
            state.chain = self.pool.admit_chain(req.prompt_ids)
            self.slots[slot] = state
            self.lengths[slot] = 0
            self.page_table[slot, :] = 0
            self._pt_dirty = True
            self._patch_slot_device(slot, state, length=0, active=False,
                                    limit=len(state.prompt_ids) + req.sampling.max_tokens - 1)
            self._prefill_slots.append(slot)
            admitted += 1
        return admitted

    def _admit_phase_separated(self) -> int:
        """Take pending requests FIFO while slots are free and this round's
        ``prefill_budget_tokens`` are not spent (always at least one), then
        prefill them: same-bucket requests in groups of up to
        ``prefill_coalesce`` share one dispatch (paged mode), the others
        prefill alone. Each request is in its slot, first token emitted,
        when this returns."""
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
        groups: dict[int, list[_SlotState]] = {}
        for state in taken:
            groups.setdefault(self.config.bucket_for(len(state.prompt_ids)), []).append(state)
        singles = []
        for bucket in sorted(groups):
            group = groups[bucket]
            while group:
                batch, group = group[:coalesce], group[coalesce:]
                if len(batch) == 1:
                    singles.append((bucket, batch))
                else:
                    self._prefill(batch, bucket)
        for bucket, batch in singles:
            self._prefill(batch, bucket)
        return len(taken)

    def _prefill(self, states: list[_SlotState], bucket: int) -> None:
        """One prefill dispatch (JAX ``prefill`` for one request,
        ``batch_prefill`` for a coalesced group): rows pad to a power-of-two
        batch that replays row 0; the first token of each request is sampled
        in the same dispatch, and each request is placed into a free slot."""
        t0 = time.perf_counter()
        dev, cfg = self.device, self.model_config
        B = len(states)
        Bp = 1 << (B - 1).bit_length()
        ids = np.zeros((Bp, bucket), np.int32)
        lengths = np.zeros(Bp, np.int32)
        temp = np.zeros(Bp, np.float32)
        top_p = np.ones(Bp, np.float32)
        top_k = np.zeros(Bp, np.int32)
        for i, st in enumerate(states):
            T = len(st.prompt_ids)
            ids[i, :T] = st.prompt_ids
            lengths[i] = T
            temp[i], top_p[i], top_k[i] = (st.sampling.temperature, st.sampling.top_p,
                                           st.sampling.top_k)
        ids[B:], lengths[B:] = ids[0], lengths[0]
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        last_h, kv = llama.prefill_collect(self.params, cfg, up(ids), up(lengths),
                                           self.rope_tables, use_flash=self.use_flash)
        logits = llama.lm_head_logits(self.params, cfg, last_h)
        all_greedy = not any(st.sampling.temperature > 0 for st in states)
        if self.paged:  # each request's own stream: one draw
            gens = [st.generator for st in states] + [None] * (Bp - B)
            first = self._sample(logits, gens, all_greedy,
                                 (up(temp), up(top_p), up(top_k)))
        else:
            first = sample_token(logits, self._generator, up(temp), up(top_p), up(top_k),
                                 all_greedy=all_greedy)
        first_host = first.cpu().numpy()  # the dispatch's one sync
        self.prefill_dispatches += 1
        self.coalesced_prefills += int(B > 1)
        for i, st in enumerate(states):
            slot = self._free_slots.popleft()
            row = (kv[0][:, i:i + 1], kv[1][:, i:i + 1])
            if self.paged:
                st.chain = self.pool.admit_slot(st.prompt_ids, row)
            else:
                llama.insert_slot_kv(self.cache, row, slot)
            self._admitting.remove(st)
            self._activate_slot(slot, st, int(first_host[i]))
        self.prefill_ms += (time.perf_counter() - t0) * 1e3

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
        self._last_dev[slot] = tok
        self._emit_token(slot, tok, force_length=T + self._k_steps > self.config.max_seq_len)

    def _patch_slot_device(self, slot: int, state: _SlotState, length: int,
                           active: bool, limit: int) -> None:
        s = state.sampling
        self._temp_dev[slot] = float(s.temperature)
        self._top_p_dev[slot] = float(s.top_p)
        self._top_k_dev[slot] = int(s.top_k)
        self._lengths_dev[slot] = length
        self._active_dev[slot] = active
        self._finished_dev[slot] = False
        row = np.full((self._stop_width,), -1, np.int32)
        ids = sorted(state.stops)[: self._stop_width]
        row[: len(ids)] = ids
        self._stops_dev[slot] = torch.from_numpy(row).to(self.device)
        self._limit_dev[slot] = max(0, limit)

    def _deactivate_slot_device(self, slot: int) -> None:
        self._lengths_dev[slot] = 0
        self._active_dev[slot] = False
        self._finished_dev[slot] = True

    def _flush_page_table(self) -> None:
        if self._pt_dirty:
            self._page_table_dev.copy_(torch.from_numpy(self.page_table))
            self._pt_dirty = False

    def _grow_chain(self, slot: int, state: _SlotState, needed: int) -> None:
        """Extend a slot's chain to cover ``needed`` tokens. The pool holds a
        full-window chain for every slot, so this cannot run dry; preemption
        to host comes with a later slice."""
        before = len(state.chain)
        if self.pool.pages_for(needed) <= before:
            return
        self.pool.extend_chain(state.chain, needed)
        self.page_table[slot, before: len(state.chain)] = state.chain[before:]
        self._pt_dirty = True

    def _ensure_chunk_capacity(self) -> None:
        for slot in np.flatnonzero(self.active):
            state = self.slots[slot]
            self._grow_chain(int(slot), state,
                             min(int(self.lengths[slot]) + self._k_steps,
                                 self.config.max_seq_len))

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
        self.rounds[kind] += 1
        self.round_ms[kind] += (time.perf_counter() - t0) * 1e3

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
        this round's prompt chunks run in the same forward."""
        n, dev, k = self.n_slots, self.device, self._k_steps
        self._ensure_chunk_capacity()
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
        up = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        q_ids_d, q_lens_d, hist_d = up(q_ids), up(q_lens), up(hist)
        sample_d, final_d, final_lens_d = up(sample), up(final_mask), up(final_lens)
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
        self._finished_dev = fin | (sampled & (is_stop | hit))
        self._last_dev = torch.where(sampled, nxt, self._last_dev)
        self._lengths_dev = new_lens.to(torch.int32)
        self._active_dev = active | final_d
        toks = torch.where(sampled, nxt, torch.full_like(nxt, -1)).cpu().numpy()  # the round's one sync

        decode_rows = [s for s in range(n) if self.active[s]]
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + 1, self.lengths).astype(np.int32)
        for slot, state, chunk in plan:
            state.prefill_pos += chunk
            self.prefill_chunks += 1
            self.chunked_prefill_tokens += chunk
        for slot, state in finals:
            self._finish_prefill(slot, state, int(toks[slot]))
        for slot in decode_rows:
            if self.active[slot]:
                no_room = int(old_lengths[slot]) + 1 + k > self.config.max_seq_len
                self._emit_token(slot, int(toks[slot]), force_length=no_room)
        return "mixed" if decode_rows else "prefill"

    def _finish_prefill(self, slot: int, state: _SlotState, tok: int) -> None:
        """Flip a fully prefilled slot to decode (the device flipped its rows
        in the same dispatch) and emit its first token."""
        T = len(state.prompt_ids)
        self.pool.commit_chain(state.prompt_ids, state.chain)
        self._prefill_slots.remove(slot)
        self.lengths[slot] = T
        self.active[slot] = True
        self._emit_token(slot, tok, force_length=T + self._k_steps > self.config.max_seq_len)

    def _decode_round_chunk(self) -> str:
        """``decode_chunk`` fused decode steps over all slots; rows that hit
        a stop id, their limit or the window bound freeze on the device."""
        k, cfg = self._k_steps, self.model_config
        self._ensure_chunk_capacity()
        self._flush_page_table()
        gens, all_greedy = self._sampling_rows(self.active)
        active = self._active_dev
        toks, lens, fin = self._last_dev, self._lengths_dev, self._finished_dev
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
        self._last_dev = toks
        self._lengths_dev = torch.where(active, lens, torch.zeros_like(lens))
        self._finished_dev = fin
        self._emit_chunk(torch.stack(emits, dim=1).cpu().numpy())  # the round's one sync
        return "decode"

    def _decode_round_dense(self) -> str:
        """``decode_chunk`` fused decode steps over the dense cache
        (:func:`.engine.build_decode_chunk_fn`, device-side termination)."""
        _, all_greedy = self._sampling_rows(self.active)
        chunk, k_cache, v_cache, last, _, lens, fin = self._dense_decode_fn(
            self.params, self.cache[0], self.cache[1], self._last_dev,
            self._lengths_dev, self._generator, self._temp_dev, self._top_p_dev,
            self._top_k_dev, self._active_dev, self._finished_dev, self._stops_dev,
            self._limit_dev, all_greedy=all_greedy)
        self.cache = (k_cache, v_cache)
        self._last_dev, self._lengths_dev, self._finished_dev = last, lens, fin
        self._emit_chunk(chunk.cpu().numpy())  # the round's one sync
        return "decode"

    def _emit_chunk(self, chunk: np.ndarray) -> None:
        """Emit a fused chunk's tokens [n_slots, k] step by step; a stream
        that cannot fit the next chunk ends with 'length' at this one's end."""
        k = self._k_steps
        old_lengths = self.lengths.copy()
        self.lengths = np.where(self.active, self.lengths + k, 0).astype(np.int32)
        for j in range(k):
            last_of_chunk = j == k - 1
            for slot in range(self.n_slots):
                if not self.active[slot]:
                    continue
                overflow = int(old_lengths[slot]) + 2 * k > self.config.max_seq_len
                self._emit_token(slot, int(chunk[slot, j]),
                                 force_length=last_of_chunk and overflow)
