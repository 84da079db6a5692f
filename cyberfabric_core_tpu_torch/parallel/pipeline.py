"""GPipe microbatch pipelining and its training step (counterpart of
``parallel/pipeline.py``).

The JAX package puts 1/pp of the stacked layers on each device of a mesh
axis under ``shard_map``, runs one ``lax.scan`` over M+P-1 ticks with a
``ppermute`` hand-off per tick, and gets the backward pipeline from
``jax.grad``. The port runs the same schedule from one controller over a
:class:`..parallel.mesh.StageMesh`, an explicit device list that may repeat
(ROADMAP departure 17):

- stage p holds layers ``[p·L/pp, (p+1)·L/pp)`` on its own device, the
  embedding lives on stage 0's and the final norm and head on the last
  stage's (:func:`place_pipeline_params`);
- tick t runs microbatch t-p on stage p for every stage, each dp row on its
  device; the hand-off to the next stage is ``.to(device)``, a no-op where
  both stages share a device (``["cuda:0"] * n`` on a one-card machine);
- the backward pipeline is autograd's: a stage leaf used by several dp rows
  or microbatches gets the sum of their gradients. With every entry of the
  mesh on one device, autograd runs one queue in a fixed order, so a run
  repeats bit for bit;
- the loss is the mean next-token cross-entropy over every token, the sum
  of the last stage's rows added in (microbatch, row) order.

Attention is plain GQA attention with f32 scores (:func:`_causal_attention`),
as the JAX package trains: the flash kernel has no backward and stays on the
serving path. Training runs in f32 (:func:`trainable`).

:func:`make_train_step` is AdamW at optax's defaults (``b1`` 0.9, ``b2``
0.999, ``eps`` 1e-8, ``weight_decay`` 1e-4 on every leaf), set explicitly:
``torch.optim.AdamW`` defaults to a weight decay of 1e-2."""

from __future__ import annotations

import math
import types
from typing import Callable

import torch
from torch import nn

from ..models import llama
from ..models.configs import ModelConfig
from ..ops.norms import rms_norm
from ..ops.rope import rope_frequencies
from ..runtime.quant import is_quantized
from .mesh import StageMesh

LossFn = Callable[[llama.LlamaModel, torch.Tensor, torch.Tensor], torch.Tensor]


def _causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal attention for training (no KV cache): [B, T, H*,
    D] GQA with f32 scores, probabilities rounded to q's dtype before P·V,
    which accumulates in f32."""
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, T, Hkv, Hq // Hkv, D)
    scores = torch.einsum("bthgd,bshd->bhgts", qg.float(), k.float()) * (1.0 / math.sqrt(D))
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    scores = torch.where(mask, scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bhgts,bshd->bthgd", probs.float(), v.float())
    return out.reshape(B, T, Hq, D).to(q.dtype)


def _stage_block(layers, h: torch.Tensor, cfg: ModelConfig, rope_tables) -> torch.Tensor:
    """One stage's layers over h [B, T, H], with the pipeline's attention."""
    cos_t, sin_t = rope_tables
    B, T = h.shape[0], h.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=h.device)[None].expand(B, T)
    for lp in layers:
        q, k, v = llama._qkv_proj(lp, llama._input_norm(lp, h, cfg), cfg, positions,
                                  cos_t, sin_t)
        attn = _causal_attention(q, k, v).reshape(B, T, -1)
        h = h + llama._linear(attn, lp.wo).to(h.dtype)
        h = llama._mlp_residual(lp, h, cfg)
    return h


def _layer_tree(cfg: ModelConfig) -> list[str]:
    """The leaf names of one layer."""
    return list(llama._leaf_shapes(cfg))


def _layer_on(lp: llama.LlamaLayer, names: list[str], dev: torch.device):
    """``lp`` itself where it lives on ``dev``, else its leaves moved there
    (differentiably: their gradients flow back to ``lp``)."""
    if lp.wq.device == dev:
        return lp
    return types.SimpleNamespace(**{n: getattr(lp, n).to(dev) for n in names})


def _rope_tables(cfg: ModelConfig):
    """rope_on(device): the config's rope tables there, made once a device."""
    ropes: dict[torch.device, tuple[torch.Tensor, torch.Tensor]] = {}

    def rope_on(dev: torch.device):
        if dev not in ropes:
            ropes[dev] = rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta, dev)
        return ropes[dev]

    return rope_on


def _stage_layers(cfg: ModelConfig, pp: int, p: int) -> range:
    per = cfg.num_layers // pp
    return range(p * per, (p + 1) * per)


def _check_stages(cfg: ModelConfig, pp: int) -> None:
    if cfg.num_layers % pp:
        raise ValueError(f"{cfg.num_layers} layers do not split into {pp} stages")


def pipelined_loss_fn(cfg: ModelConfig, mesh: StageMesh, num_microbatches: int) -> LossFn:
    """Build loss(params, ids, targets) with GPipe microbatching over the
    mesh's stages. ids/targets: [B, T] with B = num_microbatches ×
    microbatch rows, each microbatch's rows cut into ``mesh.dp`` equal
    parts. Returns the mean next-token cross-entropy (an f32 scalar on the
    last stage's device), differentiable in ``params``."""
    _check_stages(cfg, mesh.pp)
    PP, DP, M = mesh.pp, mesh.dp, num_microbatches
    names = _layer_tree(cfg)
    rope_on = _rope_tables(cfg)

    def loss_fn(params: llama.LlamaModel, ids: torch.Tensor, targets: torch.Tensor):
        B, T = ids.shape
        if B % M or (B // M) % DP:
            raise ValueError(f"batch {B} does not split into {M} microbatches of {DP} "
                             "data-parallel rows")
        rows = B // M // DP

        def row_of(x: torch.Tensor, m: int, d: int, dev: torch.device) -> torch.Tensor:
            start = (m * DP + d) * rows
            return x[start:start + rows].to(dev)

        stages = [[_layer_on(params.layers[i], names, mesh.device(p, d))
                   for i in _stage_layers(cfg, PP, p)] for p in range(PP) for d in range(DP)]
        last = PP - 1
        final_norm = [params.final_norm.to(mesh.device(last, d)) for d in range(DP)]
        head = [(params.embed.t() if cfg.tie_embeddings else params.lm_head).to(
            mesh.device(last, d)) for d in range(DP)]
        home = mesh.device(last)
        total = torch.zeros((), dtype=torch.float32, device=home)
        # state[p][d]: the activation waiting for stage p's row d
        state: list[list] = [[None] * DP for _ in range(PP)]
        for t in range(M + PP - 1):
            for p in reversed(range(PP)):  # a stage reads its hand-off before it is replaced
                m = t - p
                if not 0 <= m < M:
                    continue
                for d in range(DP):
                    dev = mesh.device(p, d)
                    if p == 0:
                        h = llama._embed_scale(llama.embed_lookup(
                            params.embed.to(dev), row_of(ids, m, d, dev), params.dtype), cfg)
                    else:
                        h = state[p][d]
                    out = _stage_block(stages[p * DP + d], h, cfg, rope_on(dev))
                    if p < last:
                        state[p + 1][d] = out.to(mesh.device(p + 1, d))
                        continue
                    hidden = rms_norm(out, final_norm[d], cfg.rms_norm_eps,
                                      cfg.norm_weight_offset)
                    logits = llama._softcap(llama._mm_f32(hidden, head[d]), cfg)
                    nll = torch.nn.functional.cross_entropy(
                        logits.reshape(-1, logits.shape[-1]),
                        row_of(targets, m, d, dev).reshape(-1).long(), reduction="sum")
                    total = total + nll.to(home)
        return total / (B * T)

    return loss_fn


def reference_loss_fn(cfg: ModelConfig) -> LossFn:
    """Single-device cross-entropy through :func:`..models.llama.forward`:
    the parity oracle for the pipeline, and :mod:`..models.toytrain`'s
    loss."""
    rope_on = _rope_tables(cfg)

    def loss_fn(params: llama.LlamaModel, ids: torch.Tensor, targets: torch.Tensor):
        B, T = ids.shape
        dev = params.device
        positions = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T)
        cache = llama.init_cache(cfg, B, T, params.dtype, device=dev)
        hidden, _ = llama.forward(params, cfg, ids, positions, cache,
                                  torch.zeros(B, dtype=torch.int32, device=dev), rope_on(dev))
        logits = llama.lm_head_logits(params, cfg, hidden)
        return torch.nn.functional.cross_entropy(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1).long())

    return loss_fn


def trainable(params: llama.LlamaModel) -> list[nn.Parameter]:
    """Turn on gradients for every leaf of an f32 tree and return the
    leaves. Serving trees are made with frozen leaves; a training run makes
    its own tree trainable. The port trains in f32 only: on CUDA a bf16
    product is an f32-result GEMM (:func:`..models.llama._mm_f32`) that no
    backward here relies on, and bf16 optimizer noise swamps small widths."""
    if is_quantized(params):
        raise ValueError("a quantized tree cannot be trained")
    leaves = list(params.parameters())
    bad = {str(p.dtype) for p in leaves if p.dtype != torch.float32}
    if bad:
        raise ValueError(f"the port trains in float32, the tree holds {sorted(bad)}")
    for p in leaves:
        p.requires_grad_(True)
    return leaves


def adamw(leaves: list[nn.Parameter], learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``: the same defaults, decay on every
    leaf. Its moments are made beside each leaf, on the leaf's device."""
    return torch.optim.AdamW(leaves, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=1e-4)


def make_train_step(cfg: ModelConfig, mesh: StageMesh, num_microbatches: int,
                    learning_rate: float = 1e-3):
    """(train_step, init_opt_state). ``init_opt_state(params)`` makes the
    tree trainable and returns its AdamW; ``train_step(params, opt_state,
    ids, targets)`` takes one step on the pipelined loss, updating both in
    place, and returns ``(params, opt_state, loss)``."""
    loss_fn = pipelined_loss_fn(cfg, mesh, num_microbatches)

    def init_opt_state(params: llama.LlamaModel) -> torch.optim.AdamW:
        return adamw(trainable(params), learning_rate)

    def train_step(params, opt_state, ids, targets):
        opt_state.zero_grad(set_to_none=True)
        loss = loss_fn(params, ids, targets)
        loss.backward()
        opt_state.step()
        return params, opt_state, loss.detach()

    return train_step, init_opt_state


def place_pipeline_params(params: llama.LlamaModel, mesh: StageMesh) -> llama.LlamaModel:
    """Move ``params`` (in place) to the training layout: stage p's layers
    on its device, the embedding on stage 0's, the final norm and an
    untied head on the last stage's. Returns ``params``."""
    _check_stages(params.cfg, mesh.pp)
    for p in range(mesh.pp):
        for i in _stage_layers(params.cfg, mesh.pp, p):
            params.layers[i].to(mesh.device(p))
    last = mesh.device(mesh.pp - 1)
    params.embed.data = params.embed.data.to(mesh.device(0))
    params.final_norm.data = params.final_norm.data.to(last)
    if params.lm_head is not None:
        params.lm_head.data = params.lm_head.data.to(last)
    return params
