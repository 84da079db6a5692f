"""Engine configuration, request/event types, the fused dense decode body
and the lockstep engine (counterpart of ``runtime/engine.py``).

``EngineConfig`` is the JAX package's dataclass field for field, so the
worker's ``engine_options`` parse the same way for both packages. Which of
its options the port's continuous scheduler honours, ignores or rejects is
decided in :mod:`.scheduler`. :func:`build_decode_chunk_fn` is the decode
body both engines run: the dense scheduler its ``device_term`` form, the
lockstep :class:`InferenceEngine` its plain form.

:class:`InferenceEngine` is the batch-synchronous engine: one prefill of
the whole batch (padded to a bucket) into a dense cache
``[L, B, max_seq_len, Hkv, D]`` it allocates per call, through the flash
kernel wherever the engine runs on CUDA, then ``decode_chunk`` fused decode
steps per device round trip over that cache, a single-step tail to the
window's brim, and a token-less ``length`` epilogue, as JAX does. A bs=1
greedy request can speculate by prompt lookup (``speculative="ngram"``) and
a bs=1 request at any temperature through a draft model
(``speculative="draft"``, :mod:`.speculative`).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Iterator, Mapping, Optional, Sequence

import numpy as np
import torch

from ..device import DeviceLike, on_card, resolve_device, same_device, to_device
from ..models import llama
from ..models.configs import ModelConfig, get_config
from ..ops import flash_attention as fa
from ..ops.rope import rope_frequencies
from ..ops.sampling import make_slot_generator, sample_token


class SchedulerSaturated(RuntimeError):
    """``submit()`` rejected: the pending queue is at ``max_pending``.

    Serving layers map this to HTTP 429 + ``Retry-After`` — backpressure at
    admission instead of unbounded host memory growth under an arrival storm.
    """

    def __init__(self, detail: str, retry_after_s: float = 1.0) -> None:
        super().__init__(detail)
        self.retry_after_s = retry_after_s


class TenantSaturated(SchedulerSaturated):
    """``submit()`` rejected: the caller's tenant is at its own pending
    bound (``tenant_max_pending``) while the global queue may have room.
    Serving layers map it to its own 429 + ``Retry-After``, so one tenant's
    retry storm reads as that tenant's saturation."""

    def __init__(self, detail: str, retry_after_s: float = 1.0,
                 tenant: str = "default") -> None:
        super().__init__(detail, retry_after_s)
        self.tenant = tenant


class TenantQuotaExceeded(RuntimeError):
    """``submit()`` rejected: the request's worst case needs more KV pages
    than its tenant's hard quota (``tenant_max_pages``)."""

    def __init__(self, detail: str, tenant: str = "default",
                 retry_after_s: float = 1.0) -> None:
        super().__init__(detail)
        self.tenant = tenant
        self.retry_after_s = retry_after_s


@dataclass
class SamplingParams:
    """Per-request decode parameters (llm-gateway request schema surface)."""

    max_tokens: int = 128
    temperature: float = 0.0  # 0 → greedy
    top_p: float = 1.0
    top_k: int = 0
    stop_token_ids: tuple[int, ...] = ()
    seed: Optional[int] = None


@dataclass
class EngineConfig:
    model: str = "tiny-llama"
    max_seq_len: int = 256
    max_batch: int = 4
    dtype: str = "bfloat16"
    prefill_buckets: tuple[int, ...] = ()  # default: powers of 2 up to max_seq_len
    donate_cache: bool = True
    #: model-level end-of-sequence ids (from the tokenizer/checkpoint config);
    #: per-request stop_token_ids extend these. No implicit guessing.
    eos_token_ids: tuple[int, ...] = ()
    #: decode steps fused into ONE device program via lax.scan. Each host→device
    #: dispatch costs ~1-70ms depending on transport; fusing k steps amortizes it
    #: k-fold. Tokens past a row's EOS within a chunk are discarded host-side.
    decode_chunk: int = 8
    #: Pallas flash kernel for prefill attention. None = auto (on for TPU).
    use_flash: Optional[bool] = None
    #: prefix-cache pool size in pages (0 = disabled). Continuous scheduler only.
    prefix_cache_pages: int = 0
    prefix_page_size: int = 64
    #: weight-only quantization: "none" | "int8" | "int4" (each rung ~halves
    #: HBM + decode traffic; int4 is per-channel — the bandwidth experiment,
    #: int8 the accuracy default — see runtime/quant.py)
    quantization: str = "none"
    #: speculative decoding: "off" | "ngram" (prompt-lookup drafting + one
    #: fused [1, k+1] verify forward; greedy bs=1 only, lossless) | "draft"
    #: (a small draft MODEL proposes k tokens; fused verify with Leviathan
    #: acceptance sampling — distribution-preserving at any temperature,
    #: bit-lossless at temperature 0 — see runtime/speculative.py).
    #: Non-eligible requests fall back silently.
    speculative: str = "off"
    spec_k: int = 8
    spec_max_ngram: int = 3
    spec_min_ngram: int = 1
    #: draft mode: config name of the proposer model (must share the target's
    #: vocab/tokenizer) + optional checkpoint dir for its weights
    draft_model: str = ""
    draft_checkpoint: str = ""
    #: batched speculative decoding in the CONTINUOUS scheduler (paged mode):
    #: up to this many ngram-proposed draft tokens per speculating slot per
    #: round, verified as ONE q_len=k+1 ragged span inside the mixed-batch
    #: dispatch with accept/reject, accepted-length and rollback computed on
    #: device (a rejected suffix's KV is rewritten before any later read —
    #: runtime/scheduler.py "speculative rounds"). Greedy-only per slot
    #: (temperature 0) and lossless: greedy streams are byte-identical to
    #: ``scheduler_spec_k=0`` — speculation changes speed, never text.
    #: 0 = off (the default: streams bit-identical to the pre-speculation
    #: scheduler). Drafts come from each stream's own emitted-token history
    #: (prompt-lookup / NgramProposer). The legacy ``speculative``/``spec_k``
    #: fields keep driving only the lockstep InferenceEngine path.
    #: On the card, a verify span of k+1 ≤ 8 positions (``scheduler_spec_k``
    #: ≤ 7) takes the ragged kernel's short-span path, which computes each
    #: position bitwise as decoding it alone; a larger k is served through
    #: the kernel's chunk path, whose attention bits differ. Either way the
    #: card's bf16 products depend on the row count (a verify round runs
    #: N×(k+1) positions, a decode chunk N), so greedy streams there equal
    #: k=0's except at near-ties; the exact identity is pinned on the CPU.
    scheduler_spec_k: int = 0
    #: adaptive per-stream speculation gate (continuous scheduler): after a
    #: probation window of 4*scheduler_spec_k proposed drafts, a stream whose
    #: rolling acceptance rate sits below this floor stops proposing for the
    #: rest of its life — its verify width was pure waste on that text.
    #: 0.0 = never disable. Deterministic per stream and acceptance-checked,
    #: so the gate can only ever change speed, never token values.
    spec_min_accept: float = 0.0
    #: continuous scheduler (paged mode only): lookahead DEPTH — up to this
    #: many decode chunks are kept in flight beyond the one being drained
    #: (an epoch ring). Each chunk chains off device-resident state, so the
    #: host emit loop overlaps N device chunks instead of alternating.
    #: Termination (stop tokens / max-tokens / window) is detected INSIDE
    #: the decode program via a device-resident finished mask, so a finish
    #: freezes its row on-device and the ring survives it; admissions,
    #: resumes and preemptions still discard the stale ring suffix and fall
    #: back to a synchronous round, so emitted streams are byte-identical
    #: across any depth (0 = fully synchronous; legacy bools still parse:
    #: True ≡ the default depth, False ≡ 0).
    decode_lookahead: int = 2
    #: device-side stop-token matching width: per-slot stop ids live in a
    #: [n_slots, device_stop_width] device array (-1 padded). A request whose
    #: stop set exceeds this falls back to host-side stop detection for that
    #: slot (its stop finishes discard the in-flight ring, exactly the
    #: pre-device-termination behavior); max-tokens/window bounds are always
    #: device-resident regardless.
    device_stop_width: int = 8
    #: continuous scheduler: per-round prefill admission budget in prompt
    #: tokens (Sarathi-style interleave). A burst of arrivals no longer drains
    #: the whole queue with back-to-back prefills before decode resumes; at
    #: least one request is always admitted per round so big prompts cannot
    #: starve. 0 = unbounded drain (pre-pipeline behavior).
    prefill_budget_tokens: int = 512
    #: continuous scheduler: coalesce up to this many COLD (no prefix hit)
    #: same-bucket pending requests into one multi-row prefill dispatch.
    #: 1 = off (every prefill is its own batch-1 dispatch).
    prefill_coalesce: int = 4
    #: continuous scheduler (paged mode): Sarathi-style mixed-batch rounds —
    #: pending prompts are split into prefill chunks (sized by
    #: ``prefill_budget_tokens``) that piggyback INTO decode rounds through
    #: the ragged paged-attention kernel (one dispatch serves decode rows at
    #: q_len=1 and prefill-chunk rows at q_len=chunk), instead of running a
    #: blocking phase-separated cold prefill that stalls every decode stream.
    #: False restores the phase-separated path (the A/B baseline; also what
    #: dense mode always uses).
    mixed_batch: bool = True
    #: continuous scheduler: bound on the pending (not-yet-admitted) queue.
    #: ``submit`` raises :class:`SchedulerSaturated` at the bound — the
    #: gateway maps it to 429 + Retry-After — instead of queueing without
    #: limit (unbounded host memory + unbounded queue latency under a
    #: storm). 0 = unbounded (pre-faultlab behavior).
    max_pending: int = 2048
    #: tenant isolation (continuous scheduler): when True the pending queue
    #: is a set of PER-TENANT FIFO queues drained by token-weighted fair
    #: scheduling — each tenant carries a virtual token counter (VTC)
    #: charged with the prefill + decode tokens it actually consumed, and
    #: admission always serves the backlogged tenant with the smallest
    #: weighted counter (FIFO preserved *within* a tenant). False restores
    #: the tenant-blind global FIFO (the A/B baseline for
    #: ``bench.py --fairness-guard``). Fairness reorders ADMISSION only —
    #: tokens within a stream are byte-identical either way.
    tenant_fair: bool = True
    #: weight of any tenant not named in ``tenant_weights`` (the default
    #: class). A tenant with weight 2 is entitled to twice the token share
    #: of a weight-1 tenant while both are backlogged.
    tenant_default_weight: float = 1.0
    #: per-tenant weight overrides, ``{tenant_id: weight}``
    tenant_weights: Optional[dict] = None
    #: per-tenant cap on concurrently OCCUPIED slots (decode + chunked
    #: prefill); a tenant at its cap is skipped by admission until one of
    #: its slots frees — its requests stay queued, nobody else waits behind
    #: them. 0 = uncapped.
    tenant_max_slots: int = 0
    #: per-tenant SOFT cap on held KV pages: exceeding it only matters under
    #: contention (another tenant backlogged / requests suspended), where
    #: the round-boundary cap sweep YIELDS the over-cap tenant's youngest
    #: slot via the existing preempt-to-host path. 0 = uncapped.
    tenant_soft_pages: int = 0
    #: per-tenant HARD cap on held KV pages: a submit whose worst-case page
    #: need can never fit the quota is rejected outright
    #: (:class:`TenantQuotaExceeded` → 429), and admission skips a tenant
    #: already holding its quota. 0 = uncapped.
    tenant_max_pages: int = 0
    #: per-tenant bound on PENDING (not-yet-admitted) requests: overflow
    #: raises :class:`TenantSaturated` (its own 429 + Retry-After) so one
    #: tenant's retry storm saturates that tenant, not the global queue.
    #: 0 = unbounded (the global ``max_pending`` still applies).
    tenant_max_pending: int = 0
    #: tensor parallelism (continuous scheduler): shard the engine over the
    #: first ``tp`` visible devices as a NamedSharding mesh — Megatron-style
    #: weight shardings (parallel/sharding.py), the paged KV pool split on
    #: the kv-head axis, host-control rows (tokens/lengths/stops/page-table/
    #: sampling) explicitly replicated, and XLA GSPMD inserting the
    #: collectives inside the existing dispatch families. 1 (default) keeps
    #: the single-device engine byte-identical to pre-tp builds; tp=N on the
    #: forced-host CPU mesh produces bit-identical streams to tp=1 (pinned
    #: by tests/test_tp_engine.py). The 70B-class path is tp=8 (+int8) per
    #: FEASIBILITY_70B.json.
    tp: int = 1
    #: per-device HBM byte budget for the feasibility gate: engine
    #: construction derives the per-device plan (params + KV pool +
    #: activations via parallel/feasibility.py — the same shard math the AOT
    #: compiler lowers) and raises InfeasiblePlanError when the budget
    #: cannot hold it, so an over-HBM config (bf16@tp=8 on v5e) dies with a
    #: typed, explainable error at BUILD time instead of a device OOM at
    #: request time. 0 = plan without enforcing (CPU hosts / forced-host
    #: meshes have no HBM to protect; the plan still lands in
    #: stats()["mesh"]).
    hbm_bytes_per_device: int = 0
    #: prefill/decode disaggregation role. "" (default) = unified engine
    #: serving both phases. "prefill" = this engine runs ONLY chunked
    #: prefill (mixed-batch machinery with no decode rows) and exports each
    #: request's committed KV pages + resume state to a handoff sink after
    #: the first token; requires the paged pool + mixed batching. "decode" =
    #: this engine admits handed-off streams in a handoff phase that skips
    #: prefill entirely (deep ring + speculation intact); requires the paged
    #: pool. Set by PDServingPool (runtime/pd.py) via
    #: engine_options.pd_prefill_replicas / pd_decode_replicas.
    pd_role: str = ""

    def resolve_lookahead_depth(self) -> int:
        """Lookahead ring depth as an int ≥ 0. Legacy bool configs parse as
        on/off: True → the class default depth, False → 0 (synchronous) —
        ONE rule for every entry path (direct EngineConfig, registry
        engine_options via the worker), so the same legacy value can never
        select different pipeline depths depending on which layer parsed
        it."""
        if isinstance(self.decode_lookahead, bool):
            return EngineConfig.decode_lookahead if self.decode_lookahead \
                else 0
        return max(0, int(self.decode_lookahead))

    def resolve_use_flash(self, device: DeviceLike = None) -> bool:
        """Whether prefill attends through the flash kernel. ``None`` means
        on wherever the engine runs on CUDA (the port's default device) and
        off on the CPU, where the kernel would run its plain version."""
        if self.use_flash is not None:
            return self.use_flash
        return torch.device("cuda" if device is None else device).type == "cuda"

    def buckets(self) -> tuple[int, ...]:
        if self.prefill_buckets:
            return self.prefill_buckets
        out, b = [], 16
        while b < self.max_seq_len:
            out.append(b)
            b *= 2
        out.append(self.max_seq_len)
        return tuple(out)

    def bucket_for(self, length: int) -> int:
        """Smallest prefill bucket covering ``length``; rejects prompts that
        leave no decode room (a clamped first write would corrupt the cache)."""
        if length >= self.max_seq_len:
            raise ValueError(
                f"prompt length {length} leaves no decode room (max_seq_len "
                f"{self.max_seq_len}; prompts must be strictly shorter)"
            )
        for b in self.buckets():
            if length <= b:
                return b
        raise AssertionError("unreachable: buckets() always covers max_seq_len")


def build_decode_chunk_fn(model_config: ModelConfig, k_steps: int, rope_tables,
                          *, max_seq: Optional[int] = None,
                          device_term: bool = False) -> Callable:
    """The shared fused decode body: k (forward T=1 over the dense cache →
    lm_head → sample) steps, a Python loop where JAX runs ``lax.scan``. The
    cache is written in place; the function returns it for signature parity.

    Sampling shares ONE ``torch.Generator`` across the batch
    (:func:`ops.sampling.sample_token`). ``all_greedy`` is the caller's
    host-side knowledge that no row samples (then nothing is drawn; None
    reads it from ``temperature``, a host synchronisation).

    The plain form (the lockstep engine's) returns ``(tokens [B, k],
    k_cache, v_cache, last tokens, generator)``. ``device_term=True`` (dense
    mode's) adds inputs (active, finished, stop_ids, limit_lens) and outputs
    (lengths, finished): a step matches the sampled token against the row's
    stop ids and length limit (and, at the chunk's last step, the window
    bound ``len + k > max_seq``); a finished row freezes (its last token and
    length stop advancing) and emits -1. Running rows compute as the plain
    form does."""

    def decode_chunk(params, k_cache, v_cache, last_tokens, lengths, generator,
                     temperature, top_p, top_k, all_greedy=None):
        cache, toks, lens, out = (k_cache, v_cache), last_tokens, lengths, []
        for _ in range(k_steps):
            hidden, cache = llama.forward(params, model_config, toks[:, None],
                                          lens[:, None], cache, lens, rope_tables)
            logits = llama.lm_head_logits(params, model_config, hidden[:, 0])
            toks = sample_token(logits, generator, temperature, top_p, top_k,
                                all_greedy=all_greedy)
            lens = lens + 1
            out.append(toks)
        return torch.stack(out, dim=1), cache[0], cache[1], toks, generator

    def decode_chunk_term(params, k_cache, v_cache, last_tokens, lengths, generator,
                          temperature, top_p, top_k, active, finished, stop_ids,
                          limit_lens, all_greedy=None):
        cache, toks, lens, fin, out = (k_cache, v_cache), last_tokens, lengths, finished, []
        for j in range(k_steps):
            run = active & ~fin
            hidden, cache = llama.forward(params, model_config, toks[:, None],
                                          lens[:, None], cache, lens, rope_tables)
            logits = llama.lm_head_logits(params, model_config, hidden[:, 0])
            nxt = sample_token(logits, generator, temperature, top_p, top_k,
                               all_greedy=all_greedy)
            new_lens = lens + 1
            is_stop = (nxt[:, None] == stop_ids).any(dim=1)
            hit = new_lens >= limit_lens
            if max_seq is not None and j == k_steps - 1:
                hit = hit | (new_lens + k_steps > max_seq)
            out.append(torch.where(run, nxt, torch.full_like(nxt, -1)))
            toks = torch.where(run, nxt, toks)
            lens = torch.where(run, new_lens, lens)
            fin = fin | (run & (is_stop | hit))
        lens = torch.where(active, lens, torch.zeros_like(lens))
        return torch.stack(out, dim=1), cache[0], cache[1], toks, generator, lens, fin

    return decode_chunk_term if device_term else decode_chunk


@dataclass
class StepEvent:
    """One emitted token for one active request slot."""

    request_index: int
    token_id: int
    #: terminal reason when this is the final event: stop | length (clean
    #: finishes), error (engine fault — the replica pool fails it over),
    #: cancelled (client/gateway let go), deadline (the request's
    #: deadline lapsed — scheduler-side expiry sweep)
    finished: Optional[str] = None



@dataclass
class GenerationResult:
    token_ids: list[int]
    finish_reason: str  # stop | length
    prompt_tokens: int
    completion_tokens: int
    ttft_ms: float = 0.0
    total_ms: float = 0.0


_SEED_MASK = 0x7FFF_FFFF_FFFF_FFFF


class InferenceEngine:
    """Batch-synchronous engine: prefill a batch, then lockstep decode (JAX
    ``InferenceEngine``), on ``device`` (default the CUDA card; ``"cpu"``
    runs the kernels' plain versions).

    ``params``: None draws random weights from ``seed`` (quantized leaf by
    leaf as drawn when ``config.quantization`` asks); a state_dict or a
    :class:`..models.llama.LlamaModel` on the engine's device is taken as
    is, and quantized when the config asks and it is not. Sampling shares
    one ``torch.Generator`` seeded from ``seed``; a call whose requests all
    carry the same explicit seed reseeds it, so such a call reproduces its
    tokens. Not thread-safe: one call at a time (the worker's batcher
    serialises them)."""

    def __init__(self, config: EngineConfig, model_config: Optional[ModelConfig] = None,
                 params: Any = None, seed: int = 0, device: DeviceLike = None) -> None:
        self.device = resolve_device(device)
        self.config = config
        self.model_config = model_config or get_config(config.model)
        if self.model_config.architecture != "llama":
            raise ValueError("InferenceEngine drives decoder models, got "
                             f"{self.model_config.architecture}")
        with on_card(self.device):
            self._build(params, seed)

    def _build(self, params: Any, seed: int) -> None:
        from .quant import is_quantized, quant_bits, quantize_llama_params
        from .weights import model_from_state_dict

        config, cfg = self.config, self.model_config
        self.dtype = getattr(torch, config.dtype)
        bits = quant_bits(config.quantization)
        if params is None:
            params = llama.init_params(cfg, seed, self.dtype, self.device, quant_bits=bits)
        elif isinstance(params, Mapping):
            params = model_from_state_dict(params, cfg, self.device, self.dtype)
        elif not same_device(params.device, self.device):
            raise ValueError(f"params live on {params.device}, engine on {self.device}")
        if bits is not None and not is_quantized(params):
            params = quantize_llama_params(params, bits)
        self.params = params
        self.rope_tables = rope_frequencies(
            cfg.head_dim, max(cfg.max_position, config.max_seq_len), cfg.rope_theta,
            device=self.device)
        self.use_flash = config.resolve_use_flash(self.device)
        if self.use_flash and self.device.type == "cuda":
            fa.check_kernel_supports(cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                                     self.dtype)
        self._generator = make_slot_generator(seed, self.device)
        self._decode_fn = build_decode_chunk_fn(cfg, max(1, config.decode_chunk),
                                                self.rope_tables)
        self._decode_tail_fn: Optional[Callable] = None  # k=1, built on demand
        self._verify_fn: Optional[Callable] = None  # ngram speculation, on demand
        self._verify_accept_fn: Optional[Callable] = None  # draft speculation
        self._draft = None  # DraftModel, built by the first draft-mode request
        #: speculation counters; accept_hist[a] counts verify rounds that
        #: accepted exactly a drafts
        self.spec_stats = {"verify_calls": 0, "drafted": 0, "accepted": 0,
                           "spec_tokens": 0, "fallback_steps": 0, "accept_hist": {}}
        self._last_timing = {"ttft_ms": 0.0, "total_ms": 0.0}

    def _record_spec_round(self, a: int, spec_k: int, committed: int) -> None:
        """One verify round's evidence, shared by the ngram and draft loops."""
        s = self.spec_stats
        s["verify_calls"] += 1
        s["drafted"] += spec_k
        s["accepted"] += a
        s["spec_tokens"] += committed
        s["accept_hist"][a] = s["accept_hist"].get(a, 0) + 1

    def _bucket_for(self, length: int) -> int:
        return self.config.bucket_for(length)

    def decode_cost_analysis(self, batch: Optional[int] = None,
                             lengths: Optional[Sequence[int]] = None) -> dict:
        """The flops and bytes of one fused decode chunk, counted from the
        model's shapes (JAX's keys: ``flops``, ``bytes_accessed``,
        ``flops_per_token``, ``bytes_per_token``, ``batch``,
        ``decode_chunk``; and the first step's ``flops_per_step`` and
        ``bytes_per_step``): the roofline inputs for tokens/s work.

        A step does, for each of ``batch`` rows, every layer's projections
        and MLP (the routed experts only, for MoE) and the head: 2 flops a
        weight; and attention over the row's keys: 4·Hq·D flops a key a
        layer. It reads every weight once (the embedding's ``batch`` rows
        only, unless the head shares it), each row's K and V at its length,
        and writes each row's new K and V and its f32 logits. ``lengths``
        are the rows' attended lengths at the chunk's first step (default:
        the dense cache's whole span, which the lockstep step attends);
        step j attends one key more per row.

        JAX reads XLA's cost analysis of the chunk program instead, which
        counts one iteration of its scan, so its ``flops`` is one step's and
        its per-token figures are 1/k of the truth (ROADMAP departure 8)."""
        cfg = self.model_config
        B = batch or self.config.max_batch
        k = max(1, self.config.decode_chunk)
        S = self.config.max_seq_len
        L0 = [min(S, int(n)) for n in lengths] if lengths is not None else [S] * B
        if len(L0) != B:
            raise ValueError(f"lengths has {len(L0)} rows, batch is {B}")
        H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
        Hq, Hkv, D, n_layers = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
        mlp = 6 * H * I * (cfg.experts_per_token if cfg.num_experts else 1) \
            + (2 * H * cfg.num_experts if cfg.num_experts else 0)
        per_row = n_layers * (2 * H * (Hq + 2 * Hkv) * D + 2 * Hq * D * H + mlp) + 2 * H * V
        state = self.params.state_dict()
        embed_bytes = sum(t.numel() * t.element_size() for name, t in state.items()
                          if name == "embed" or name.startswith("embed."))
        weight_bytes = sum(t.numel() * t.element_size() for t in state.values())
        if not cfg.tie_embeddings:  # the head reads its own matrix: B rows of the table
            weight_bytes -= embed_bytes - embed_bytes * B // V
        kv_elt = torch.finfo(self.dtype).bits // 8
        kv_row = 2 * n_layers * Hkv * D * kv_elt  # K and V of one position, every layer

        def step(j: int) -> tuple[int, int]:
            keys = sum(min(S, n + j) for n in L0)
            flops = B * per_row + 4 * n_layers * Hq * D * keys
            nbytes = weight_bytes + kv_row * (keys + B) + 4 * B * V
            return flops, nbytes

        steps = [step(j) for j in range(k)]
        flops, nbytes = sum(f for f, _ in steps), sum(b for _, b in steps)
        return {"flops": float(flops), "bytes_accessed": float(nbytes),
                "flops_per_token": flops / (B * k), "bytes_per_token": nbytes / (B * k),
                "flops_per_step": float(steps[0][0]), "bytes_per_step": float(steps[0][1]),
                "batch": B, "decode_chunk": k}

    # ------------------------------------------------------------------ device calls
    @torch.inference_mode()
    def _prefill(self, ids: np.ndarray, lengths: list[int], warp: tuple,
                 all_greedy: bool) -> tuple[torch.Tensor, llama.KVCache]:
        """The batch's prefill into a dense cache allocated here (JAX builds
        it inside its prefill program), and each row's first token."""
        cfg, dev = self.model_config, self.device
        B, T = ids.shape
        cache = llama.init_cache(cfg, B, self.config.max_seq_len, self.dtype, device=dev)
        positions = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
        hidden, cache = llama.forward(self.params, cfg, to_device(ids, dev), positions,
                                      cache, torch.zeros(B, dtype=torch.int32, device=dev),
                                      self.rope_tables, use_flash=self.use_flash)
        last_h = llama.gather_last_hidden(hidden, to_device(np.asarray(lengths, np.int32),
                                                            dev))
        logits = llama.lm_head_logits(self.params, cfg, last_h)
        first = sample_token(logits, self._generator, *warp, all_greedy=all_greedy)
        return first, cache

    def _tail_fn(self) -> Callable:
        if self._decode_tail_fn is None:
            self._decode_tail_fn = build_decode_chunk_fn(self.model_config, 1,
                                                         self.rope_tables)
        return self._decode_tail_fn

    @torch.inference_mode()
    def _single_step(self, cache: llama.KVCache, last_tok: int, length: int, warp: tuple,
                     all_greedy: bool) -> int:
        """One decode step of a bs=1 stream (the speculative loops'
        fallback); returns its token."""
        dev = self.device
        chunk, _, _, _, _ = self._tail_fn()(
            self.params, cache[0], cache[1], to_device(np.asarray([last_tok], np.int32), dev),
            to_device(np.asarray([length], np.int32), dev), self._generator, *warp,
            all_greedy=all_greedy)
        return int(chunk.cpu()[0, 0])  # sync-point: the step's one read

    # ------------------------------------------------------------------ generation
    def generate(self, prompts: list[list[int]],
                 sampling: "SamplingParams | list[SamplingParams]", *,
                 on_token: Optional[Callable[[StepEvent], None]] = None
                 ) -> list[GenerationResult]:
        """Lockstep batched generation; ``on_token`` sees every event."""
        collected: dict[int, list[int]] = {i: [] for i in range(len(prompts))}
        finish: dict[int, str] = {}
        for ev in self.generate_stream(prompts, sampling):
            if ev.token_id >= 0:  # token-less finish events carry -1
                collected[ev.request_index].append(ev.token_id)
            if on_token:
                on_token(ev)
            if ev.finished:
                finish[ev.request_index] = ev.finished
        timing = self._last_timing
        results = []
        for i, prompt in enumerate(prompts):
            toks, fin = collected[i], finish.get(i, "length")
            if fin == "stop" and toks:
                toks = toks[:-1]  # the stop token is not visible output
            results.append(GenerationResult(
                token_ids=toks, finish_reason=fin, prompt_tokens=len(prompt),
                completion_tokens=len(toks), ttft_ms=timing["ttft_ms"],
                total_ms=timing["total_ms"]))
        return results

    def _ensure_draft(self, spec_k: int):
        """The draft model, built once per engine: weights from
        ``draft_checkpoint`` when given (a missing path raises: a random
        draft would stay lossless and hide the lost speed), else seeded
        synthetic weights. Its vocabulary must be the target's."""
        if self._draft is None:
            from .speculative import DraftModel

            dcfg = get_config(self.config.draft_model)
            if dcfg.vocab_size != self.model_config.vocab_size:
                raise ValueError(
                    f"draft model {self.config.draft_model!r} vocab {dcfg.vocab_size} != "
                    f"target vocab {self.model_config.vocab_size} — speculation needs a "
                    "shared tokenizer")
            ckpt = self.config.draft_checkpoint
            if ckpt:
                if not Path(ckpt).exists():
                    raise ValueError(
                        f"draft_checkpoint {ckpt!r} does not exist; unset it to run with "
                        "synthetic draft weights (test mode)")
                from .weights import load_llama_params, model_from_state_dict

                dparams = model_from_state_dict(
                    load_llama_params(ckpt, dcfg, dtype=self.dtype, device=self.device),
                    dcfg, self.device)
            else:
                dparams = llama.init_params(dcfg, 7, self.dtype, self.device)
            self._draft = DraftModel(dcfg, dparams, max_seq=self.config.max_seq_len,
                                     dtype=self.dtype, k=spec_k, device=self.device,
                                     use_flash=self.use_flash)
        return self._draft

    def generate_stream(self, prompts: list[list[int]],
                        sampling: "SamplingParams | list[SamplingParams]"
                        ) -> Iterator[StepEvent]:
        """Yields StepEvents, ``decode_chunk`` tokens per device round trip;
        every stream ends with exactly one finish event."""
        B = len(prompts)
        if B == 0:
            self._last_timing = {"ttft_ms": 0.0, "total_ms": 0.0}
            return
        if B > self.config.max_batch:
            raise ValueError(f"batch {B} exceeds max_batch {self.config.max_batch}")
        per_req = sampling if isinstance(sampling, list) else [sampling] * B
        # a batch sharing one explicit seed reproduces its tokens across calls
        seeds = {s.seed for s in per_req}
        if len(seeds) == 1 and (seed_val := next(iter(seeds))) is not None:
            self._generator.manual_seed(int(seed_val) & _SEED_MASK)
        t_start = time.monotonic()
        dev, max_seq = self.device, self.config.max_seq_len

        lengths_list = [len(p) for p in prompts]
        bucket = self._bucket_for(max(lengths_list))
        ids = np.zeros((B, bucket), np.int32)
        for i, p in enumerate(prompts):
            ids[i, :len(p)] = p
        warp = (to_device(np.asarray([s.temperature for s in per_req], np.float32), dev),
                to_device(np.asarray([s.top_p for s in per_req], np.float32), dev),
                to_device(np.asarray([s.top_k for s in per_req], np.int32), dev))
        all_greedy = not any(s.temperature > 0 for s in per_req)

        with on_card(dev):
            first_dev, cache = self._prefill(ids, lengths_list, warp, all_greedy)
            cur = first_dev.cpu().numpy()  # sync-point: the prefill's one read
        ttft_ms = (time.monotonic() - t_start) * 1000.0

        stops = [set(s.stop_token_ids) | set(self.config.eos_token_ids) for s in per_req]
        max_new = [s.max_tokens for s in per_req]
        done = [False] * B
        emitted = [0] * B

        def classify(i: int, tok: int) -> Optional[str]:
            if tok in stops[i]:
                return "stop"
            if emitted[i] >= max_new[i]:
                return "length"
            return None

        lengths_np = np.asarray(lengths_list, np.int32)
        state = {"last": first_dev, "lengths": to_device(lengths_np, dev), "steps": 0}

        for i in range(B):
            emitted[i] += 1
            fin = classify(i, int(cur[i]))
            done[i] = fin is not None
            yield StepEvent(i, int(cur[i]), fin)

        k_steps = max(1, self.config.decode_chunk)
        max_steps = max(max_new) if max_new else 0

        def run_chunk(fn: Callable, k: int) -> np.ndarray:
            nonlocal lengths_np
            with on_card(dev), torch.inference_mode():
                chunk_dev, _, _, last, _ = fn(
                    self.params, cache[0], cache[1], state["last"], state["lengths"],
                    self._generator, *warp, all_greedy=all_greedy)
                state["last"], state["lengths"] = last, state["lengths"] + k
                out = chunk_dev.cpu().numpy()  # sync-point: one [B, k] read
            lengths_np = lengths_np + k
            state["steps"] += k
            return out

        def emit_chunk(chunk: np.ndarray, k: int, next_fits: bool) -> Iterator[StepEvent]:
            # rows that cannot continue finish with "length" on their final
            # emitted token (one event per token)
            last_dispatchable = not next_fits or state["steps"] >= max_steps
            for j in range(k):
                for i in range(B):
                    if done[i]:
                        continue
                    emitted[i] += 1
                    tok = int(chunk[i, j])
                    fin = classify(i, tok)
                    if fin is None and last_dispatchable and j == k - 1:
                        fin = "length"
                    done[i] = fin is not None
                    yield StepEvent(i, tok, fin)

        def emit_committed(toks: list[int], L: int) -> Iterator[StepEvent]:
            """A speculative round's committed tokens for the bs=1 stream;
            tokens past a finish are discarded."""
            for j, tok in enumerate(toks):
                if done[0]:
                    break
                emitted[0] += 1
                fin = classify(0, tok)
                if fin is None and j == len(toks) - 1 and L >= max_seq:
                    fin = "length"  # window exhausted on this token
                done[0] = fin is not None
                yield StepEvent(0, tok, fin)

        def spec_loop() -> Iterator[StepEvent]:
            """Prompt-lookup speculation (greedy bs=1, lossless): each round
            commits 1..spec_k+1 tokens for one device round trip."""
            nonlocal lengths_np
            from .speculative import NgramProposer, accept_length, build_verify_fn

            spec_k = max(1, self.config.spec_k)
            if self._verify_fn is None:
                self._verify_fn = build_verify_fn(self.model_config, spec_k,
                                                  self.rope_tables)
            proposer = NgramProposer(self.config.spec_max_ngram, self.config.spec_min_ngram,
                                     spec_k)
            last_tok = int(cur[0])
            proposer.extend(list(prompts[0]) + [last_tok])
            L = int(lengths_np[0])
            while not done[0] and emitted[0] < max_new[0] and L < max_seq:
                drafts = proposer.propose() if L + spec_k + 1 <= max_seq else None
                if drafts is None:
                    # no recurring n-gram (or the window's tail): one plain step
                    self.spec_stats["fallback_steps"] += 1
                    with on_card(dev):
                        toks = [self._single_step(cache, last_tok, L, warp, all_greedy)]
                    L += 1
                else:
                    # padded to the static draft width: a pad is accepted only
                    # where it IS the greedy argmax, so padding never changes
                    # the output
                    drafts = (drafts + [drafts[-1]] * spec_k)[:spec_k]
                    with on_card(dev), torch.inference_mode():
                        outs_dev, _, _ = self._verify_fn(
                            self.params, cache[0], cache[1],
                            to_device(np.asarray([[last_tok] + drafts], np.int32), dev),
                            to_device(np.asarray([L], np.int32), dev))
                        outs = outs_dev.cpu()[0].tolist()  # sync-point: the verify's read
                    a = accept_length(drafts, outs)
                    toks = drafts[:a] + [outs[a]]
                    self._record_spec_round(a, spec_k, len(toks))
                    L += a + 1
                proposer.extend(toks)
                last_tok = toks[-1]
                yield from emit_committed(toks, L)
            lengths_np[0] = L

        def draft_spec_loop() -> Iterator[StepEvent]:
            """Draft-model speculation (bs=1, any temperature): the draft
            proposes k sampled tokens, the target runs one verify +
            acceptance-sampling pass (distribution-preserving; lossless at
            temperature 0); each round commits 1..k+1 tokens."""
            nonlocal lengths_np
            spec_k = max(1, self.config.spec_k)
            with on_card(dev):
                draft = self._ensure_draft(spec_k)
                if self._verify_accept_fn is None:
                    from .speculative import build_verify_accept_fn

                    self._verify_accept_fn = build_verify_accept_fn(
                        self.model_config, spec_k, self.rope_tables)
                # the draft's stream, split off the engine's (a host read)
                draft_seed = int(torch.randint(0, 2 ** 62, (1,), generator=self._generator,
                                               device=dev).item())
                draft.reset(list(prompts[0]), draft_seed)
            last_tok = int(cur[0])
            L = int(lengths_np[0])
            warp1 = tuple(w[:1] for w in warp)
            while not done[0] and emitted[0] < max_new[0] and L < max_seq:
                window_ok = (L + spec_k + 1 <= max_seq
                             and draft.len + spec_k + 1 <= draft.max_seq)
                if not window_ok:
                    self.spec_stats["fallback_steps"] += 1
                    with on_card(dev):
                        toks = [self._single_step(cache, last_tok, L, warp, all_greedy)]
                    L += 1
                else:
                    with on_card(dev), torch.inference_mode():
                        drafts_dev, dists = draft.propose(last_tok, *warp1)
                        tokens = torch.cat([to_device(np.asarray([last_tok], np.int32), dev),
                                            drafts_dev])[None, :]
                        a_dev, nxt_dev, _, _, _ = self._verify_accept_fn(
                            self.params, cache[0], cache[1], tokens,
                            to_device(np.asarray([L], np.int32), dev), dists,
                            self._generator, *warp1)
                        # sync-point: the round's one read (drafts, a, next)
                        host = torch.cat([drafts_dev, a_dev.reshape(1),
                                          nxt_dev.reshape(1)]).cpu().tolist()
                    drafts, a, nxt = host[:spec_k], host[spec_k], host[spec_k + 1]
                    toks = drafts[:a] + [nxt]
                    # the draft's cache: drafting wrote KV for (last_tok,
                    # d1..d_{k-1}); the bonus or resampled token stays pending
                    # (its KV lands when the next round consumes it), and on
                    # full acceptance d_k still needs consuming first
                    if a < spec_k:
                        draft.len += a + 1
                    else:
                        draft.len += spec_k
                        with on_card(dev):
                            draft.consume([drafts[-1]], *warp1)
                    self._record_spec_round(a, spec_k, len(toks))
                    L += a + 1
                last_tok = toks[-1]
                yield from emit_committed(toks, L)
            lengths_np[0] = L

        if (self.config.speculative == "draft" and B == 1 and self.config.draft_model
                and not all(done)):
            yield from draft_spec_loop()
        elif (self.config.speculative == "ngram" and B == 1
              and all(s.temperature == 0.0 for s in per_req) and not all(done)):
            yield from spec_loop()
        else:
            # the window is read at every chunk, as JAX reads its config
            while not all(done) and state["steps"] < max_steps:
                # a chunk writes k cache slots from the current length; it must
                # fit whole (chunks are fixed-shape, as JAX's programs are)
                if int(lengths_np.max()) + k_steps > self.config.max_seq_len:
                    break
                chunk = run_chunk(self._decode_fn, k_steps)
                next_fits = int(lengths_np.max()) + k_steps <= self.config.max_seq_len
                # once full chunks stop fitting, the k=1 tail continues
                tail_will_run = (not next_fits
                                 and int(lengths_np.max()) < self.config.max_seq_len)
                yield from emit_chunk(chunk, k_steps, next_fits or tail_will_run)
            # the tail: single steps fill the last < decode_chunk slots of the
            # window, so near-capacity prompts still decode to the brim
            while not all(done) and state["steps"] < max_steps \
                    and int(lengths_np.max()) < self.config.max_seq_len:
                chunk = run_chunk(self._tail_fn(), 1)
                yield from emit_chunk(chunk, 1,
                                      int(lengths_np.max()) < self.config.max_seq_len)

        # every still-active row gets a token-less finish event
        for i in range(B):
            if not done[i]:
                done[i] = True
                yield StepEvent(i, -1, "length")
        self._last_timing = {"ttft_ms": ttft_ms,
                             "total_ms": (time.monotonic() - t_start) * 1000.0}

    def warmup(self, lengths: tuple[int, ...] = ()) -> None:
        """Run each given prefill bucket (default the smallest) and the
        decode chunk once, so kernels are built before the first request."""
        for bucket in lengths or (self.config.buckets()[0],):
            self.generate([[1] * min(bucket, 8)], SamplingParams(max_tokens=2))
