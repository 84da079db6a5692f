"""Ring attention: sequence-parallel causal attention over ``sp`` ranks
(counterpart of ``parallel/ring_attention.py``).

The sequence axis is cut into ``sp`` equal blocks, rank i holding block i
of q, k and v on its device. The k/v blocks rotate around the ring (rank i
hands its block to rank i+1 as ``.to(device)``, a no-op between ranks on
one device) while every rank accumulates attention for its own queries
with an online softmax in f32. One controller runs the ranks in turn
(ROADMAP departure 17); a rank's scores are [T/sp, T/sp] a step, not
[T, T].

Causality is decided by global positions, so the result is single-device
causal attention within rounding. Masked scores take the finite fill
-1e30: with -inf, a block masked whole would give NaN gradients."""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from ..device import DeviceLike
from .mesh import RankMesh

_NEG_INF = -1e30


def _ring_attention_local(
    q: list[torch.Tensor],   # rank i: [B, Tl, Hq, D], its query block
    k: list[torch.Tensor],   # rank i: [B, Tl, Hkv, D], the key block it starts with
    v: list[torch.Tensor],   # [B, Tl, Hkv, D]
    mesh: RankMesh,
    lengths: Optional[torch.Tensor] = None,  # [B] global valid lengths
) -> list[torch.Tensor]:
    """Every rank's output block [B, Tl, Hq, D], on its device."""
    n = len(mesh.devices)
    B, Tl, Hq, D = q[0].shape
    Hkv = k[0].shape[2]
    G = Hq // Hkv
    lens = mesh.scatter(lengths)
    acc, m, l, q_pos, qg = [], [], [], [], []
    for i, dev in enumerate(mesh.devices):
        qg.append(q[i].float().reshape(B, Tl, Hkv, G, D))
        q_pos.append(i * Tl + torch.arange(Tl, dtype=torch.int32, device=dev))
        acc.append(torch.zeros((B, Tl, Hkv, G, D), dtype=torch.float32, device=dev))
        m.append(torch.full((B, Tl, Hkv, G), _NEG_INF, dtype=torch.float32, device=dev))
        l.append(torch.zeros((B, Tl, Hkv, G), dtype=torch.float32, device=dev))
    k_cur, v_cur = list(k), list(v)
    for step in range(n):
        for i, dev in enumerate(mesh.devices):
            src = (i - step) % n  # the block rank i holds now started at rank src
            k_pos = src * Tl + torch.arange(Tl, dtype=torch.int32, device=dev)
            scores = torch.einsum("bthgd,bshd->bthgs", qg[i], k_cur[i].float())
            scores = scores * (1.0 / math.sqrt(D))
            mask = k_pos[None, None, :] <= q_pos[i][None, :, None]  # [1, Tl, Tl]
            if lens[i] is not None:
                mask = mask & (k_pos[None, None, :] < lens[i][:, None, None])
            mask = mask[:, :, None, None, :]
            scores = torch.where(mask, scores, _NEG_INF)
            m_new = torch.maximum(m[i], scores.amax(dim=-1))
            # a block masked whole leaves the accumulators as they were
            correction = torch.exp(m[i] - m_new)
            p = torch.where(mask, torch.exp(scores - m_new[..., None]), 0.0)
            l[i] = l[i] * correction + p.sum(dim=-1)
            acc[i] = acc[i] * correction[..., None] + torch.einsum(
                "bthgs,bshd->bthgd", p, v_cur[i].float())
            m[i] = m_new
        # the ring rotation: rank i takes rank i-1's block
        k_cur = [k_cur[i - 1].to(dev) for i, dev in enumerate(mesh.devices)]
        v_cur = [v_cur[i - 1].to(dev) for i, dev in enumerate(mesh.devices)]
    return [(a / torch.clamp_min(s[..., None], 1e-30)).reshape(B, Tl, Hq, D).to(qi.dtype)
            for a, s, qi in zip(acc, l, q)]


def ring_attention(
    q: torch.Tensor,  # [B, T, Hq, D]
    k: torch.Tensor,  # [B, T, Hkv, D]
    v: torch.Tensor,
    devices: Sequence[DeviceLike],
    lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Global [B, T, H, D] in and out, T cut over the ``devices`` (one ring
    rank each; they may repeat). The output is gathered on the first
    rank's device."""
    mesh = RankMesh(devices)
    n, T = len(mesh.devices), q.shape[1]
    if T % n:
        raise ValueError(f"sequence length {T} does not split into {n} ring ranks")

    def blocks(x: torch.Tensor) -> list[torch.Tensor]:
        return [b.to(dev) for b, dev in zip(x.chunk(n, dim=1), mesh.devices)]

    return mesh.all_gather(_ring_attention_local(blocks(q), blocks(k), blocks(v), mesh, lengths),
                           dim=1)
