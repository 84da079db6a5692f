"""Normalization ops (counterpart of ``cyberfabric_core_tpu/ops/norms.py``).

Statistics in f32 regardless of the activation dtype; the result is cast back
to the input dtype."""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             weight_offset: float = 0.0) -> torch.Tensor:
    """``weight_offset``: gemma-family checkpoints store w where the norm
    applies (1 + w) — pass 1.0 there, 0.0 for the llama family."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    normed = xf * torch.rsqrt(var + eps)
    return (normed * (weight_offset + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-12) -> torch.Tensor:
    """LayerNorm with the mean and the (biased) variance in f32."""
    xf = x.float()
    mean = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * weight.float() + bias.float()).to(x.dtype)
