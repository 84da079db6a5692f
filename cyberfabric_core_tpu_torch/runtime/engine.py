"""Engine configuration, request/event types and the fused dense decode body
(counterpart of ``runtime/engine.py``).

``EngineConfig`` is the JAX package's dataclass field for field, so the
worker's ``engine_options`` parse the same way for both packages. Which of
its options the port's scheduler honours, ignores or rejects is decided in
:mod:`.scheduler`. :func:`build_decode_chunk_fn` is the decode body the dense
scheduler runs; the lockstep ``InferenceEngine`` around it comes with a later
slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..device import DeviceLike
from ..models import llama
from ..models.configs import ModelConfig
from ..ops.sampling import sample_token


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
    host-side knowledge that no row samples (then nothing is drawn).

    Only the ``device_term=True`` form is ported (dense mode runs it; the
    plain form comes with the lockstep ``InferenceEngine``): inputs add
    (active, finished, stop_ids, limit_lens), outputs add (lengths,
    finished). A step matches the sampled token against the row's stop ids
    and length limit (and, at the chunk's last step, the window bound
    ``len + k > max_seq``); a finished row freezes (its last token and length
    stop advancing) and emits -1."""
    if not device_term:
        raise NotImplementedError("not ported yet: build_decode_chunk_fn without "
                                  "device_term (lockstep InferenceEngine slice)")

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

    return decode_chunk_term


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

