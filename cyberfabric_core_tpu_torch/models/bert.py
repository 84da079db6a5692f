"""The bert encoder family (bge-base-en embeddings) in PyTorch (counterpart
of ``models/bert.py``).

The JAX package stacks the layers' leaves and scans them; the port keeps a
:class:`BertModel` ``nn.Module`` with a ``ModuleList`` of layers and a
Python loop. Weight matrices keep the JAX package's ``[in, out]`` layout, so
:func:`runtime.weights.bert_params_from_jax` needs no transposes.

Each product follows the JAX einsums with ``preferred_element_type=f32``:
the product in f32, the f32 bias added, then one rounding to the activation
dtype (:func:`models.llama._mm_f32`, one f32-output GEMM on the card). The
GELU is the exact one, applied to the f32 sum. LayerNorm statistics and the
attention softmax are f32. The JAX package computes all of this outside any
Pallas kernel, so plain PyTorch ops are its form here too.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import encoder_attention
from ..ops.norms import layer_norm
from .configs import ModelConfig
from .llama import _mm_f32


def check_supported(cfg: ModelConfig) -> None:
    if cfg.architecture != "bert":
        raise ValueError(f"the bert forward drives encoder models, got {cfg.architecture!r}")


def leaf_shapes(cfg: ModelConfig) -> tuple[dict[str, tuple[int, ...]],
                                           dict[str, tuple[int, ...]]]:
    """(the embedding leaves, one layer's leaves), in the JAX package's
    [in, out] layout."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    top = {"word_embed": (cfg.vocab_size, H), "pos_embed": (cfg.max_position, H),
           "type_embed": (cfg.type_vocab_size, H), "embed_ln_w": (H,), "embed_ln_b": (H,)}
    layer = {"wq": (H, H), "bq": (H,), "wk": (H, H), "bk": (H,), "wv": (H, H), "bv": (H,),
             "wo": (H, H), "bo": (H,), "attn_ln_w": (H,), "attn_ln_b": (H,),
             "ffn_in": (H, I), "ffn_in_b": (I,), "ffn_out": (I, H), "ffn_out_b": (H,),
             "ffn_ln_w": (H,), "ffn_ln_b": (H,)}
    return top, layer


class BertLayer(nn.Module):
    """One encoder layer's weights (read by :func:`forward`)."""

    def __init__(self, leaves: Mapping[str, torch.Tensor]) -> None:
        super().__init__()
        for name, t in leaves.items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))


class BertModel(nn.Module):
    """The parameter tree: the embedding leaves and ``layers``."""

    def __init__(self, cfg: ModelConfig, embeddings: Mapping[str, torch.Tensor],
                 layers: list[Mapping[str, torch.Tensor]]) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        for name, t in embeddings.items():
            setattr(self, name, nn.Parameter(t, requires_grad=False))
        self.layers = nn.ModuleList(BertLayer(lv) for lv in layers)

    @property
    def dtype(self) -> torch.dtype:
        return self.word_embed.dtype

    @property
    def device(self) -> torch.device:
        return self.word_embed.device


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device: DeviceLike = None) -> BertModel:
    """Random weights at the JAX package's scales (normal · 0.02, biases 0,
    norms 1), drawn by a seeded generator directly on ``device``."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def leaf(name: str, shape: tuple[int, ...]) -> torch.Tensor:
        if name.endswith("_w") and len(shape) == 1:
            return torch.ones(shape, dtype=dtype, device=dev)
        if len(shape) == 1:
            return torch.zeros(shape, dtype=dtype, device=dev)
        t = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32) * 0.02
        return t.to(dtype)

    top, layer = leaf_shapes(cfg)
    return BertModel(cfg, {n: leaf(n, s) for n, s in top.items()},
                     [{n: leaf(n, s) for n, s in layer.items()}
                      for _ in range(cfg.num_layers)])


def from_state_dict(state: Mapping[str, torch.Tensor], cfg: ModelConfig,
                    device: DeviceLike = None, dtype: Optional[torch.dtype] = None) -> BertModel:
    """A :class:`BertModel` on ``device`` from a state_dict (cast to
    ``dtype`` when given)."""
    dev = resolve_device(device)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=dtype or t.dtype)

    top, layer = leaf_shapes(cfg)
    return BertModel(cfg, {n: put(state[n]) for n in top},
                     [{n: put(state[f"layers.{i}.{n}"]) for n in layer}
                      for i in range(cfg.num_layers)])


def _dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in f32 (not rounded)."""
    return _mm_f32(x, w) + b.float()


def forward(params: BertModel, cfg: ModelConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor) -> torch.Tensor:
    """input_ids, attention_mask [B, T] (1 = token, 0 = padding) → the
    token-level hidden states [B, T, H]."""
    B, T = input_ids.shape
    Hh, D = cfg.num_heads, cfg.head_dim
    dt = params.dtype
    ids = input_ids.long()
    h = params.word_embed[ids] + params.pos_embed[:T][None] + params.type_embed[0]
    h = layer_norm(h, params.embed_ln_w, params.embed_ln_b, cfg.layer_norm_eps)
    for lp in params.layers:
        q = _dense(h, lp.wq, lp.bq).to(dt).reshape(B, T, Hh, D)
        k = _dense(h, lp.wk, lp.bk).to(dt).reshape(B, T, Hh, D)
        v = _dense(h, lp.wv, lp.bv).to(dt).reshape(B, T, Hh, D)
        attn = encoder_attention(q, k, v, attention_mask).reshape(B, T, Hh * D)
        h = layer_norm(h + _dense(attn, lp.wo, lp.bo).to(dt), lp.attn_ln_w, lp.attn_ln_b,
                       cfg.layer_norm_eps)
        ffn = torch.nn.functional.gelu(_dense(h, lp.ffn_in, lp.ffn_in_b)).to(dt)
        h = layer_norm(h + _dense(ffn, lp.ffn_out, lp.ffn_out_b).to(dt), lp.ffn_ln_w,
                       lp.ffn_ln_b, cfg.layer_norm_eps)
    return h


def embed_pooled(params: BertModel, cfg: ModelConfig, input_ids: torch.Tensor,
                 attention_mask: torch.Tensor) -> torch.Tensor:
    """The sentence embedding: the CLS token's state (or the mean over the
    unpadded tokens, ``pooling == "mean"``), L2-normalised, f32 [B, H]."""
    h = forward(params, cfg, input_ids, attention_mask)
    if cfg.pooling == "mean":
        maskf = attention_mask[:, :, None].float()
        pooled = (h.float() * maskf).sum(1) / torch.clamp_min(maskf.sum(1), 1.0)
    else:
        pooled = h[:, 0, :].float()
    return pooled / torch.clamp_min(torch.linalg.norm(pooled, dim=-1, keepdim=True), 1e-9)
