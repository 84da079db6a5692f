"""Speculative decoding: prompt-lookup and draft-model drafting, verified
in one forward (counterpart of ``runtime/speculative.py``).

- :class:`NgramProposer` drafts from a stream's own history: the tail
  n-gram (longest n first) is looked up where it occurred before, and the
  tokens that followed it there are proposed. Host-side, no device work.
  The continuous scheduler's speculative rounds and the lockstep engine's
  ``speculative="ngram"`` both use it.
- :func:`greedy_accept_counts` is the device-side accept of a verify span:
  the number of leading drafts equal to the model's own argmax
  continuation. :func:`accept_length` is its host twin.
- :func:`span_verify_logits` is the lockstep verify forward: a [B, k+1]
  span (the last committed token, then the drafts) over the dense cache,
  every position's logits. :func:`build_verify_fn` takes their argmax
  (greedy verify); :func:`build_verify_accept_fn` runs Leviathan
  acceptance sampling on the device against a draft model's distributions
  (lossless at temperature 0, distribution-preserving above it), and only
  (accepted count, next token) leave it.
- :class:`DraftModel` is a small model with its own dense cache and its own
  ``torch.Generator`` that samples k drafts a round from its warped
  distribution (:func:`..ops.sampling.warped_probs`).

Rejected positions' KV sits past the committed length in both caches,
masked by attention and overwritten by the next round: rollback is free.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from ..models import llama
from ..models.configs import ModelConfig
from ..ops.rope import rope_frequencies
from ..ops.sampling import categorical, categorical_from_uniform, warped_probs


class NgramProposer:
    """Incremental n-gram index over one sequence's tokens.

    For each n in [min_n, max_n], remembers the position right after the most
    recent occurrence of every n-gram. ``propose`` matches the current tail
    n-gram (longest n first) and copies up to k tokens that followed its
    previous occurrence."""

    def __init__(self, max_n: int = 3, min_n: int = 1, k: int = 8) -> None:
        if not 1 <= min_n <= max_n:
            raise ValueError(f"bad n-gram range [{min_n}, {max_n}]")
        self.max_n = max_n
        self.min_n = min_n
        self.k = k
        self.tokens: list[int] = []
        #: ngram -> (end of latest occurrence, end of previous occurrence).
        #: The sequence tail is always its own latest occurrence, so
        #: propose() reads the previous one.
        self._index: dict[tuple[int, ...], tuple[int, Optional[int]]] = {}
        #: propose() memo keyed by the sequence length it was computed at:
        #: the scheduler probes several times a round against one tail
        self._memo: tuple[int, Optional[list[int]]] = (-1, None)

    def extend(self, tokens: list[int]) -> None:
        for tok in tokens:
            self.tokens.append(tok)
            end = len(self.tokens)
            for n in range(self.min_n, self.max_n + 1):
                if end >= n:
                    gram = tuple(self.tokens[end - n:end])
                    prev = self._index.get(gram)
                    self._index[gram] = (end, prev[0] if prev else None)

    def propose(self) -> Optional[list[int]]:
        """Up to k draft tokens, or None when no tail n-gram has recurred."""
        end = len(self.tokens)
        if self._memo[0] == end:
            return self._memo[1]
        result: Optional[list[int]] = None
        for n in range(self.max_n, self.min_n - 1, -1):
            if end < n:
                continue
            hit = self._index.get(tuple(self.tokens[end - n:end]))
            if hit is None:
                continue
            latest, prev = hit
            pos = prev if latest == end else latest
            if pos is not None:
                drafts = self.tokens[pos:pos + self.k]
                if drafts:
                    result = drafts
                    break
        self._memo = (end, result)
        return result


def greedy_accept_counts(outs: torch.Tensor, drafts: torch.Tensor,
                         draft_lens: torch.Tensor) -> torch.Tensor:
    """``outs`` [N, S]: the per-position argmax of a verify span (S = k+1);
    ``drafts`` [N, S-1]: the proposed tokens; ``draft_lens`` [N]: how many
    are real. Returns [N] int32: the number of leading drafts equal to the
    model's own continuation (:func:`accept_length`, row by row)."""
    S = outs.shape[1]
    pos = torch.arange(S - 1, dtype=torch.int32, device=outs.device)[None, :]
    match = (drafts == outs[:, :-1]) & (pos < draft_lens[:, None])
    return torch.cumprod(match.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)


def accept_length(drafts: list[int], outs: list[int]) -> int:
    """Greedy acceptance: the number of leading drafts equal to the model's
    own argmax continuation (``outs[i]`` is its token after draft prefix i)."""
    a = 0
    for i, d in enumerate(drafts):
        if d != outs[i]:
            break
        a += 1
    return a


def span_verify_logits(params: llama.LlamaModel, model_config: ModelConfig,
                       cache: llama.KVCache, tokens: torch.Tensor, lengths: torch.Tensor,
                       rope_tables: tuple[torch.Tensor, torch.Tensor]
                       ) -> tuple[torch.Tensor, llama.KVCache]:
    """Run a [B, T] span (``tokens[:, 0]`` the last committed token, whose
    KV is not yet in the cache; ``tokens[:, 1:]`` the drafts) at positions
    ``lengths .. lengths+T-1`` against the dense cache, writing its KV there
    in place. Returns (logits [B*T, V] f32, cache): row ``b*T + i`` is the
    model's next-token distribution after ``tokens[b, :i+1]``."""
    B, T = tokens.shape
    positions = lengths[:, None] + torch.arange(T, dtype=lengths.dtype,
                                                device=tokens.device)[None, :]
    hidden, cache = llama.forward(params, model_config, tokens, positions, cache, lengths,
                                  rope_tables)
    logits = llama.lm_head_logits(params, model_config,
                                  hidden.reshape(B * T, hidden.shape[-1]))
    return logits, cache


def build_verify_fn(model_config: ModelConfig, k: int, rope_tables) -> Callable:
    """The [B, k+1] greedy verify: ``verify(params, k_cache, v_cache,
    tokens, lengths)`` → (per-position argmax [B, k+1] int32, k_cache,
    v_cache); ``out[:, i]`` is the model's token after ``tokens[:, :i+1]``.
    The caller accepts the longest matching draft prefix."""

    @torch.inference_mode()
    def verify(params, k_cache, v_cache, tokens, lengths):
        B, T = tokens.shape
        logits, cache = span_verify_logits(params, model_config, (k_cache, v_cache),
                                           tokens, lengths, rope_tables)
        out = torch.argmax(logits, dim=-1).to(torch.int32).reshape(B, T)
        return out, cache[0], cache[1]

    return verify


class DraftModel:
    """A small model proposing k tokens a round for a big target to verify.

    It keeps its own dense cache [L, 1, max_seq, Hkv, D] aligned with the
    COMMITTED sequence (``len`` positions): drafting writes KV for each
    consumed token, so after the target accepts ``a`` drafts the cache is
    already valid through ``len + a``; rejected entries sit past ``len``,
    masked and later overwritten. Drafts are draws from the warped draft
    distribution (acceptance sampling preserves the target's distribution
    only for draws, not argmax picks), from the draft's own generator. The
    k steps chain on the device: a round reads nothing on the host."""

    def __init__(self, cfg: ModelConfig, params: llama.LlamaModel, *, max_seq: int,
                 dtype: torch.dtype = torch.float32, k: int = 8,
                 device: DeviceLike = None, use_flash: bool = False) -> None:
        self.cfg, self.params, self.k, self.max_seq = cfg, params, k, max_seq
        self.dtype = dtype
        self.device = resolve_device(device)
        self.use_flash = use_flash
        self.rope = rope_frequencies(cfg.head_dim, max(cfg.max_position, max_seq),
                                     cfg.rope_theta, device=self.device)
        self.cache = llama.init_cache(cfg, 1, max_seq, dtype, device=self.device)
        self.len = 0  # committed positions present in the draft cache
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(0)

    @torch.inference_mode()
    def _step(self, token: torch.Tensor, pos: torch.Tensor, temp, top_p, top_k
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Consume ``token`` [1] at ``pos`` [1]: (the next draft token [1],
        sampled from the warped draft distribution, and that row [V])."""
        hidden, _ = llama.forward(self.params, self.cfg, token[None, :], pos[None, :],
                                  self.cache, pos, self.rope)
        logits = llama.lm_head_logits(self.params, self.cfg, hidden[:, -1, :])
        probs = warped_probs(logits, temp, top_p, top_k)
        return categorical(probs, self.generator), probs[0]

    @torch.inference_mode()
    def reset(self, prompt_ids: list[int], seed: int) -> None:
        """A new request: the cache cleared, the generator reseeded, the
        prompt prefilled."""
        for c in self.cache:
            c.zero_()
        self.len = 0
        self.generator.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
        self.prefill(prompt_ids)

    @torch.inference_mode()
    def prefill(self, prompt_ids: list[int]) -> None:
        """The prompt, padded to a power-of-two bucket (16 up, at most
        ``max_seq``), straight into the persistent cache from position 0
        (through the flash kernel when ``use_flash``); padded positions
        write KV past ``len``, masked until consume steps overwrite them."""
        if len(prompt_ids) > self.max_seq:
            raise ValueError(f"prompt of {len(prompt_ids)} tokens exceeds the draft "
                             f"model's max_seq {self.max_seq}")
        n = max(1, len(prompt_ids))
        bucket = 16
        while bucket < n:
            bucket *= 2
        bucket = min(bucket, self.max_seq)
        ids = np.zeros((1, bucket), np.int32)
        ids[0, :len(prompt_ids)] = prompt_ids
        dev = self.device
        positions = torch.arange(bucket, dtype=torch.int32, device=dev)[None, :]
        llama.forward(self.params, self.cfg, to_device(ids, dev), positions, self.cache,
                      torch.zeros(1, dtype=torch.int32, device=dev), self.rope,
                      use_flash=self.use_flash)
        self.len = len(prompt_ids)

    def consume(self, tokens: list[int], temp, top_p, top_k) -> None:
        """Advance the cache over committed tokens without drafting (on full
        acceptance, the last draft)."""
        for tok in tokens:
            self._step(to_device(np.asarray([tok], np.int32), self.device),
                       to_device(np.asarray([self.len], np.int32), self.device),
                       temp, top_p, top_k)
            self.len += 1

    @torch.inference_mode()
    def propose(self, last_tok: int, temp, top_p, top_k
                ) -> tuple[torch.Tensor, torch.Tensor]:
        """k drafts [k] int32 on the device, and each one's draft
        distribution row [k, V]. Consumes ``last_tok`` and the first k-1
        drafts; ``len`` advances only as the caller commits."""
        dev = self.device
        tok = to_device(np.asarray([last_tok], np.int32), dev)
        pos = to_device(np.arange(self.len, self.len + self.k, dtype=np.int32), dev)
        drafts, dists = [], []
        for i in range(self.k):
            tok, dist = self._step(tok, pos[i:i + 1], temp, top_p, top_k)
            drafts.append(tok)
            dists.append(dist)
        return torch.cat(drafts), torch.stack(dists)


def build_verify_accept_fn(model_config: ModelConfig, k: int, rope_tables) -> Callable:
    """The fused verify + acceptance-sampling pass (Leviathan et al.):
    ``verify(params, k_cache, v_cache, tokens [1, k+1], lengths [1],
    draft_dists [k, V], generator, temp, top_p, top_k)`` → (accepted count
    a, next token, generator, k_cache, v_cache), both 0-d int32 on the
    device.

    The target's k+1 rows are warped with the request's sampling params;
    draft i is accepted with probability min(1, p_t(d_i) / p_d(d_i)) (k
    uniforms from ``generator``); the first rejection resamples from the
    normalised residual (p_t − p_d)+ (the target row where the residual has
    no mass), and full acceptance draws the bonus token from row k, both by
    inverse CDF of one more uniform. At temperature 0 every row is a
    one-hot, so acceptance is argmax equality and the pass is lossless."""

    @torch.inference_mode()
    def verify(params, k_cache, v_cache, tokens, lengths, draft_dists, generator,
               temp, top_p, top_k):
        T = tokens.shape[1]  # k + 1
        logits, cache = span_verify_logits(params, model_config, (k_cache, v_cache),
                                           tokens, lengths, rope_tables)
        t_probs = warped_probs(logits, temp.expand(T), top_p.expand(T), top_k.expand(T))
        drafts = tokens[0, 1:].long()
        rows = torch.arange(k, device=tokens.device)
        p_t = t_probs[rows, drafts]
        p_d = draft_dists[rows, drafts]
        u = torch.rand(k, generator=generator, device=tokens.device)
        ok = u < torch.clamp_max(p_t / torch.clamp_min(p_d, 1e-20), 1.0)
        a = torch.cumprod(ok.to(torch.int32), 0).sum().to(torch.int32)   # 0..k
        at = torch.clamp_max(a, k - 1).long()
        res_row = torch.clamp_min(t_probs[:k] - draft_dists, 0.0).index_select(
            0, at.reshape(1))
        res_mass = res_row.sum()
        target_row = t_probs.index_select(0, at.reshape(1))
        safe_row = torch.where(res_mass > 1e-12,
                               res_row / torch.clamp_min(res_mass, 1e-20), target_row)
        r = torch.rand(1, generator=generator, device=tokens.device)
        rej_tok = categorical_from_uniform(safe_row, r)[0]
        bonus_tok = categorical_from_uniform(t_probs[k:], r)[0]
        nxt = torch.where(a == k, bonus_tok, rej_tok).to(torch.int32)
        return a, nxt, generator, cache[0], cache[1]

    return verify
