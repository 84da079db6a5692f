"""Token sampling: greedy / temperature / top-k / top-p, per-slot streams.

Counterpart of ``cyberfabric_core_tpu/ops/sampling.py``. JAX threads one
PRNG key per slot through the device program; the port gives every slot its
own ``torch.Generator`` on the slot's device. The contract of the JAX
function stays: a seed reproduces its tokens whatever else shares the batch,
because a slot's stream advances only when that slot draws.

JAX's ``split_keys_per_slot`` advances each key and hands out a subkey; the
port's :func:`split_keys_per_slot` advances each drawing slot's generator by
exactly one uniform draw and hands out that draw. :func:`sample_token_per_slot`
then turns each row's draw into a token by inverse-CDF over the warped,
sorted distribution — a pure function of logits and draws, so the tests can
feed both packages' warps the same numbers.

:func:`sample_token` is the shared-stream form dense mode and the lockstep
engine use (JAX ``sample_token`` with one key for the batch): one generator,
one uniform per row per sampling step.

:func:`warped_probs` renders the same warp as explicit probabilities in
vocabulary order (the greedy one-hot at temperature 0), what speculative
acceptance sampling needs in closed form, and :func:`categorical` draws from
such rows by inverse CDF on an explicit generator (JAX's
``jax.random.categorical`` on a threefry key; the port's generator is
Philox on CUDA, so sampled streams agree with JAX's in distribution, not
token for token).

Every running sum here goes through :func:`cumsum_rows`, so a seed gives the
same tokens on every run of the same inputs, on the card too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def make_slot_generator(seed: int, device: torch.device) -> torch.Generator:
    """A fresh per-slot stream on ``device`` seeded from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0x7FFF_FFFF_FFFF_FFFF)
    return g


def cumsum_rows(x: torch.Tensor) -> torch.Tensor:
    """``torch.cumsum(x, dim=-1)`` of [B, V] rows, summed in the same order
    on every call. CUDA scans a tensor of one row with a single-pass scan
    whose float sums depend on the order its tiles finish, so one row's CDF
    could differ in its last bits from run to run, and a seeded draw with
    it; a tensor of two rows or more is scanned row by row in a fixed order.
    One row therefore gets a zero row beside it."""
    if x.shape[0] != 1:
        return torch.cumsum(x, dim=-1)
    return torch.cumsum(torch.cat([x, torch.zeros_like(x)]), dim=-1)[:1]


def _warp_sorted(
    logits: torch.Tensor,       # [B, V] f32
    temperature: torch.Tensor,  # [B] f32 (>0 rows only meaningful)
    top_p: torch.Tensor,        # [B] f32; 1 → disabled
    top_k: torch.Tensor,        # [B] int; 0 → disabled
) -> tuple[torch.Tensor, torch.Tensor]:
    """The temperature/top-p/top-k warp in sorted order: returns
    (masked_sorted_logits, sorted_idx), masked entries at -inf. Descending
    stable sort, so ties keep vocabulary order as ``jnp.argsort(-x)`` does."""
    B, V = logits.shape
    safe_t = torch.where(temperature > 0, temperature,
                         torch.ones_like(temperature))
    scaled = logits / safe_t[:, None]
    sorted_logits, sorted_idx = torch.sort(scaled, dim=-1, descending=True,
                                           stable=True)
    probs_sorted = torch.softmax(sorted_logits, dim=-1)
    cumsum = cumsum_rows(probs_sorted)
    # top-p: keep the smallest prefix with cumulative mass >= top_p
    keep_p = (cumsum - probs_sorted) < top_p[:, None]
    rank = torch.arange(V, device=logits.device)[None, :]
    keep_k = torch.where(top_k[:, None] > 0, rank < top_k[:, None],
                         torch.ones_like(keep_p))
    keep = keep_p & keep_k
    keep[:, 0] = True  # never mask every token
    return (torch.where(keep, sorted_logits,
                        torch.full_like(sorted_logits, float("-inf"))),
            sorted_idx)


def split_keys_per_slot(generators: Sequence[Optional[torch.Generator]],
                        draw_mask: Sequence[bool],
                        device: torch.device) -> torch.Tensor:
    """Advance each drawing slot's stream by one uniform draw.

    Returns [B] f32 uniforms in [0, 1) on ``device``; rows not in
    ``draw_mask`` (or without a generator) get 0 and their stream is left
    untouched. No host synchronisation: the draws stay on the device."""
    out = torch.zeros(len(draw_mask), dtype=torch.float32, device=device)
    for i, (g, draw) in enumerate(zip(generators, draw_mask)):
        if draw and g is not None:
            out[i:i + 1] = torch.rand(1, generator=g, device=device)
    return out


def sample_token_per_slot(
    logits: torch.Tensor,       # [B, V] f32
    uniforms: torch.Tensor,     # [B] f32 draws from split_keys_per_slot
    temperature: torch.Tensor,  # [B] f32; 0 → greedy
    top_p: torch.Tensor,        # [B] f32
    top_k: torch.Tensor,        # [B] int
    all_greedy: Optional[bool] = None,
) -> torch.Tensor:
    """Returns [B] int32 tokens: argmax for rows with temperature 0, else the
    inverse-CDF draw of that row's uniform over its warped distribution.

    ``all_greedy`` is the caller's host-side knowledge that no row samples:
    the sort is then skipped entirely (the JAX package's ``lax.cond`` fast
    path). ``None`` derives it from ``temperature``, which synchronises with
    the device."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    if all_greedy is None:
        all_greedy = not bool((temperature > 0).any())
    if all_greedy:
        return greedy
    masked_sorted, sorted_idx = _warp_sorted(logits, temperature, top_p, top_k)
    probs = torch.softmax(masked_sorted, dim=-1)
    cdf = cumsum_rows(probs)
    target = (uniforms * cdf[:, -1]).unsqueeze(-1).contiguous()
    pos = torch.searchsorted(cdf, target, right=True)[:, 0]
    n_kept = torch.isfinite(masked_sorted).sum(dim=-1)
    pos = torch.minimum(pos, n_kept - 1)
    sampled = torch.gather(sorted_idx, 1, pos[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def sample_token(
    logits: torch.Tensor,       # [B, V] f32
    generator: torch.Generator,
    temperature: torch.Tensor,  # [B] f32; 0 → greedy
    top_p: torch.Tensor,        # [B] f32
    top_k: torch.Tensor,        # [B] int
    all_greedy: Optional[bool] = None,
) -> torch.Tensor:
    """Returns [B] int32 tokens from ONE stream shared by the batch: the
    generator advances by one uniform per row at every step that samples
    (none when the whole batch is greedy). ``all_greedy`` as in
    :func:`sample_token_per_slot`."""
    if all_greedy is None:
        all_greedy = not bool((temperature > 0).any())
    if all_greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    u = torch.rand(logits.shape[0], generator=generator, device=logits.device)
    return sample_token_per_slot(logits, u, temperature, top_p, top_k,
                                 all_greedy=False)


def warped_probs(
    logits: torch.Tensor,       # [B, V] f32
    temperature: torch.Tensor,  # [B] f32; 0 → delta on the argmax
    top_p: torch.Tensor,        # [B] f32; 1 → disabled
    top_k: torch.Tensor,        # [B] int; 0 → disabled
) -> torch.Tensor:
    """The sampling distribution as explicit probabilities [B, V] f32: the
    warp :func:`sample_token` draws from, unsorted back to vocabulary order;
    rows at temperature 0 are the one-hot of their argmax."""
    B, V = logits.shape
    greedy = torch.zeros_like(logits, dtype=torch.float32)
    greedy.scatter_(1, torch.argmax(logits, dim=-1, keepdim=True), 1.0)
    masked_sorted, sorted_idx = _warp_sorted(logits, temperature, top_p, top_k)
    probs_sorted = torch.softmax(masked_sorted, dim=-1)
    warped = torch.empty_like(probs_sorted).scatter_(1, sorted_idx, probs_sorted)
    return torch.where((temperature > 0)[:, None], warped, greedy)


def categorical(probs: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """One draw per row of ``probs`` [B, V] (rows need not sum to one; zero
    entries are never drawn) from ``generator``: one uniform a row, inverse
    CDF. Returns [B] int32; nothing is read on the host."""
    u = torch.rand(probs.shape[0], generator=generator, device=probs.device)
    return categorical_from_uniform(probs, u)


def categorical_from_uniform(probs: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """:func:`categorical` for given uniforms ``u`` [B] in [0, 1)."""
    cdf = cumsum_rows(probs)
    target = (u * cdf[:, -1]).unsqueeze(-1).contiguous()
    pos = torch.searchsorted(cdf, target, right=True)[:, 0]
    # rounding can put the target at the total: take the last nonzero entry
    V = probs.shape[-1]
    ranks = torch.arange(V, device=probs.device)
    last = torch.where(probs > 0, ranks, torch.zeros_like(ranks)).amax(dim=-1)
    return torch.minimum(pos, last).to(torch.int32)
