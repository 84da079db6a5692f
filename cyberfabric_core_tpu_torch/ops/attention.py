"""Dense attention (counterpart of ``ops/attention.py``).

:func:`attention_with_cache` is the dense oracle: GQA, causal,
length-masked, optional sliding window. The serving path never calls it
(it goes through the paged kernels); the tests and ``chip_smoke.py`` hold
the paged paths against it. :func:`encoder_attention` is the bert
encoder's bidirectional attention, which the JAX package also computes
outside any kernel."""

from __future__ import annotations

from typing import Optional

import torch

_NEG_INF = -1e30


def attention_with_cache(
    q: torch.Tensor,            # [B, T, Hq, D] — current-step queries
    k_cache: torch.Tensor,      # [B, S, Hkv, D] — cache AFTER inserting current k
    v_cache: torch.Tensor,      # [B, S, Hkv, D]
    q_positions: torch.Tensor,  # [B, T] — absolute position of each query
    kv_len: torch.Tensor,       # [B] — valid cache length per sequence
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, T, Hq, D]. Query at position p attends cache slots s <= p
    with s < kv_len (and s > p - window when windowed). Scores and softmax
    in f32; probabilities are cast to the cache dtype before P·V, as in the
    JAX function."""
    B, T, Hq, D = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv

    qg = q.reshape(B, T, Hkv, G, D).float()
    scores = torch.einsum("bthgd,bshd->bhgts", qg, k_cache.float())
    scores = scores * (1.0 / D ** 0.5)

    slot = torch.arange(S, device=q.device)
    qp = q_positions.long()
    mask = (slot[None, None, :] <= qp[:, :, None]) \
        & (slot[None, None, :] < kv_len.long()[:, None, None])   # [B, T, S]
    if sliding_window is not None:
        mask = mask & (slot[None, None, :] > qp[:, :, None] - sliding_window)
    scores = torch.where(mask[:, None, None], scores, _NEG_INF)

    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgts,bshd->bthgd", probs.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def encoder_attention(
    q: torch.Tensor,               # [B, T, H, D]
    k: torch.Tensor,               # [B, T, H, D]
    v: torch.Tensor,               # [B, T, H, D]
    attention_mask: torch.Tensor,  # [B, T] 1 = token, 0 = padding
) -> torch.Tensor:
    """Bidirectional attention over every unpadded key. Scores and softmax
    in f32; probabilities are cast to v's dtype before P·V, which
    accumulates in f32 and rounds once to q's dtype."""
    D = q.shape[-1]
    scores = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * (1.0 / D ** 0.5)
    mask = attention_mask[:, None, None, :].bool()
    probs = torch.softmax(torch.where(mask, scores, _NEG_INF), dim=-1)
    out = torch.einsum("bhts,bshd->bthd", probs.to(v.dtype).float(), v.float())
    return out.to(q.dtype)
