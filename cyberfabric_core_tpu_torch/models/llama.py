"""The llama decoder family in PyTorch (counterpart of ``models/llama.py``).

Where the JAX package stacks every layer's leaves into ``[L, ...]`` arrays and
runs ``lax.scan``, the port keeps a :class:`LlamaModel` ``nn.Module`` with a
``ModuleList`` of layers and a Python loop. Weight matrices keep the JAX
package's ``[in, out]`` layout, so :func:`runtime.weights.params_from_jax`
needs no transposes and both packages compute the same function.

Paged forwards update the KV pools IN PLACE (``index_put_`` into the pool
tensors) where the JAX package donates the pools to XLA; they return the same
pool tensors for signature parity.

Matrix products follow the JAX package's ``preferred_element_type=f32``
einsums. Where JAX casts the f32 product straight to the activation dtype
(q/k/v), a product in the activation dtype computes the same (the GEMM
accumulates in f32 and rounds once); so do ``wo`` and ``down`` of an
unsharded model. Where JAX works on the f32 product first (the logits;
``act(gate) * up``; the qwen2 q/k/v bias), and for the ``wo`` / ``down``
partial sums that tensor parallelism adds, the port asks for an f32 result
too (:func:`_mm_f32`) and rounds where JAX rounds.

Every forward runs one layer loop, :func:`_tp_stack`, over the ranks of a
:class:`ShardedLlama`; an unsharded :class:`LlamaModel` runs it as a mesh of
one rank on its own device (:func:`_as_ranks`), whose one partial sum the
collectives hand through.

Mixture-of-experts configs run the routed MLP (:func:`_moe_mlp`, with
:func:`_moe_mlp_dense` as its oracle); it reads no device value on the host,
so it runs inside the paged decode chunk's CUDA graph.

Quantized leaves (:mod:`..runtime.quant`: a :class:`QuantWeight` per matmul
leaf and head, a :class:`QuantEmbed` embedding) go through the same
products: the int values are converted to the activation dtype (exact for
|q| ≤ 127 in bf16), the product is taken in f32 (:func:`_linear_f32`),
multiplied by the per-channel scale in f32 and only then rounded, as JAX's
``_wmat`` / ``_scaled`` do. So a quantized product is an f32-result product
wherever the bf16 one rounds once (q/k/v, ``wo``, ``down``), and the f32
points keep their meaning. On CUDA a product makes a transient copy of the
weight in the activation dtype (``torch.mm(..., out_dtype=f32)`` takes bf16
operands), and the MoE expert products widen all E experts to f32 (one
transient per projection); in the decode chunk these live in the graph's
pool. The routed MoE scales each expert's product by that expert's scales
(``s[:, None, :]``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from ..ops.attention import attention_with_cache
from ..ops.flash_attention import flash_self_attention
from ..ops.norms import rms_norm
from ..ops.paged_attention import paged_decode_attention, ragged_paged_attention
from ..ops.rope import apply_rope
from ..parallel.mesh import RankMesh
from ..runtime.quant import QuantEmbed, QuantWeight, quantize_leaf
from .configs import ModelConfig

KVCache = tuple[torch.Tensor, torch.Tensor]    # (k, v): [L, B, S, Hkv, D]
PagedPools = tuple[torch.Tensor, torch.Tensor]  # (k, v): [L, N, page, Hkv, D]


def check_supported(cfg: ModelConfig) -> None:
    if cfg.architecture != "llama":
        raise ValueError(f"the llama forward drives decoder models, got "
                         f"{cfg.architecture!r}")


def _leaf_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """Per-layer leaf shapes, in the JAX package's [in, out] layout."""
    H, I = cfg.hidden_size, cfg.intermediate_size
    Dq, Dkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    shapes = {"attn_norm": (H,), "wq": (H, Dq), "wk": (H, Dkv), "wv": (H, Dkv),
              "wo": (Dq, H), "mlp_norm": (H,)}
    if cfg.attention_bias:
        shapes.update({"bq": (Dq,), "bk": (Dkv,), "bv": (Dkv,)})
    if cfg.num_experts > 0:
        E = cfg.num_experts
        shapes.update({"router": (H, E), "moe_gate": (E, H, I), "moe_up": (E, H, I),
                       "moe_down": (E, I, H)})
    else:
        shapes.update({"gate": (H, I), "up": (H, I), "down": (I, H)})
    return shapes


class LlamaLayer(nn.Module):
    """One decoder layer's weights (no forward of its own: the functional
    forwards below read them, as the JAX forwards read a layer's leaves)."""

    def __init__(self, leaves: dict[str, torch.Tensor]) -> None:
        super().__init__()
        for name, t in leaves.items():
            setattr(self, name, _leaf(t))


def _leaf(t):
    """A tensor becomes a frozen parameter; a quantized leaf stays the
    module it is."""
    return t if isinstance(t, (QuantWeight, QuantEmbed)) else nn.Parameter(
        t, requires_grad=False)


class LlamaModel(nn.Module):
    """The parameter tree: ``embed [V, H]``, ``final_norm [H]``, ``layers``
    and, for untied configs, ``lm_head [H, V]``; quantized trees hold a
    :class:`QuantEmbed` and :class:`QuantWeight` leaves in their place. A
    rank of a :class:`ShardedLlama` past the first holds no embedding and
    no norms (``embed`` and ``final_norm`` None): rank 0 runs them."""

    def __init__(self, cfg: ModelConfig, embed: Optional[torch.Tensor],
                 final_norm: Optional[torch.Tensor], layers: list[dict[str, torch.Tensor]],
                 lm_head: Optional[torch.Tensor] = None) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = None if embed is None else _leaf(embed)
        self.final_norm = None if final_norm is None else nn.Parameter(
            final_norm, requires_grad=False)
        self.layers = nn.ModuleList(LlamaLayer(lv) for lv in layers)
        if cfg.tie_embeddings:
            self.lm_head = None
        else:
            if lm_head is None:
                raise ValueError(f"{cfg.name} has an untied head: lm_head is required")
            self.lm_head = _leaf(lm_head)

    @property
    def dtype(self) -> torch.dtype:
        return self.final_norm.dtype

    @property
    def device(self) -> torch.device:
        return self.final_norm.device


class ShardedLlama:
    """A model cut ``tp`` ways (:func:`..parallel.sharding.shard_llama_params`):
    ``ranks[r]`` is rank r's :class:`LlamaModel` on ``mesh.devices[r]``,
    holding its Megatron slices under the rank config (its attention heads,
    intermediate and vocab slices). Every forward of this module takes it
    where it takes a :class:`LlamaModel`, with the KV tensors of its caches
    and pools given as lists, one tensor a rank (:func:`init_model_cache`).
    ``embed``, ``final_norm`` and the layer norms are rank 0's, the only
    copies; the hidden stream, the logits and every control row live on
    rank 0's device."""

    def __init__(self, cfg: ModelConfig, mesh, ranks: list[LlamaModel],
                 kv_sharded: bool, rank_cfg: Optional[ModelConfig] = None) -> None:
        check_supported(cfg)
        self.cfg, self.mesh, self.ranks, self.kv_sharded = cfg, mesh, ranks, kv_sharded
        self.rank_cfg = rank_cfg if rank_cfg is not None else ranks[0].cfg

    @property
    def tp(self) -> int:
        return len(self.ranks)

    @property
    def embed(self):
        return self.ranks[0].embed

    @property
    def final_norm(self) -> torch.Tensor:
        return self.ranks[0].final_norm

    @property
    def dtype(self) -> torch.dtype:
        return self.ranks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.ranks[0].device


def _ranks(x) -> list:
    """A KV leaf as a list of rank tensors (one tensor: one rank)."""
    return x if isinstance(x, list) else [x]


def _as_ranks(params, cfg: ModelConfig) -> ShardedLlama:
    """``params`` as ranks: a :class:`ShardedLlama` as it is, an unsharded
    model as one rank, on its device, that runs ``cfg``."""
    if isinstance(params, ShardedLlama):
        return params
    return ShardedLlama(cfg, RankMesh([params.device]), [params], kv_sharded=True,
                        rank_cfg=cfg)


def init_params(cfg: ModelConfig, seed: int = 0, dtype=torch.bfloat16,
                device: DeviceLike = None, quant_bits: Optional[int] = None) -> LlamaModel:
    """Random weights at the JAX package's scales (normal · 1/sqrt(fan-in),
    norms at one), drawn by a seeded generator directly on ``device`` in
    ``dtype`` — an 8B model never passes through host memory. With
    ``quant_bits`` (8 or 4) each leaf is quantized as soon as it is drawn
    (:func:`..runtime.quant.quantize_leaf`), from the same draws."""
    check_supported(cfg)
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def w(name: str, *shape: int):
        scale = 1.0 / (shape[-2] if len(shape) > 1 else shape[-1]) ** 0.5
        t = torch.randn(shape, generator=gen, device=dev, dtype=dtype).mul_(scale)
        return t if quant_bits is None else quantize_leaf(name, t, quant_bits)

    layers = []
    for _ in range(cfg.num_layers):
        leaves = {}
        for name, shape in _leaf_shapes(cfg).items():
            leaves[name] = (torch.ones(shape, dtype=dtype, device=dev)
                            if name.endswith("norm") else w(name, *shape))
        layers.append(leaves)
    H, V = cfg.hidden_size, cfg.vocab_size
    embed = w("embed", V, H)
    lm_head = None if cfg.tie_embeddings else w("lm_head", H, V)
    return LlamaModel(cfg, embed, torch.ones(H, dtype=dtype, device=dev),
                      layers, lm_head)


def _act(x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.hidden_act in ("gelu", "gelu_pytorch_tanh"):
        return torch.nn.functional.gelu(x, approximate="tanh")
    return torch.nn.functional.silu(x)


def _embed_scale(h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``h`` times the multiplier rounded to h's dtype, as JAX scales it.
    The scalar is filled on h's device: a host tensor would be a copy,
    which a CUDA graph capture refuses."""
    if cfg.embedding_multiplier != 1.0:
        return h * torch.full((), cfg.embedding_multiplier, dtype=h.dtype, device=h.device)
    return h


def embed_lookup(embed, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Rows of the table; int8 rows are rescaled in f32 and rounded to
    ``dtype`` (the tree's activation dtype)."""
    if isinstance(embed, QuantEmbed):
        return embed.lookup(ids, dtype)
    return embed[ids.long()]


def _mm_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` as an f32 result that nothing has rounded:
    JAX's einsum with ``preferred_element_type=f32``. On CUDA, bf16 operands
    go to one GEMM that accumulates in f32 and writes f32
    (``aten::mm.dtype``), so no f32 copy of the weight is made. That operator
    has no CPU kernel: on the CPU the operands are widened first (a product
    of two bf16 values is exact in f32), a transient copy at the CPU's test
    sizes."""
    if x.dtype == torch.float32:
        return x @ w
    flat = x.reshape(-1, x.shape[-1])
    if x.device.type == "cuda":
        out = torch.mm(flat, w, out_dtype=torch.float32)
    else:
        out = flat.float() @ w.float()
    return out.reshape(*x.shape[:-1], w.shape[-1])


def _linear_f32(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` as an unrounded f32 result; a quantized ``w`` is converted
    to x's dtype inside the product and the product scaled in f32 (JAX's
    ``_scaled(einsum(x, _wmat(w)), s)``)."""
    if isinstance(w, QuantWeight):
        return _mm_f32(x, w.values().to(x.dtype)) * w.s
    return _mm_f32(x, w)


def _linear(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w`` rounded once to x's dtype."""
    if isinstance(w, QuantWeight):
        return _linear_f32(x, w).to(x.dtype)
    return x @ w


def _qkv_cols(lp: LlamaLayer, x: torch.Tensor, cfg: ModelConfig):
    """A layer's q/k/v projections ``[B, T, width]`` in x's dtype; the qwen2
    bias is added to the f32 product and rounded once with it."""
    if cfg.attention_bias:
        return tuple((_linear_f32(x, w) + b).to(x.dtype)
                     for w, b in ((lp.wq, lp.bq), (lp.wk, lp.bk), (lp.wv, lp.bv)))
    return _linear(x, lp.wq), _linear(x, lp.wk), _linear(x, lp.wv)


def _qkv_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, cfg: ModelConfig,
               positions: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor):
    """Projections → heads ``[B, T, H, D]``, q and k roped."""
    B, T = q.shape[0], q.shape[1]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = apply_rope(q.reshape(B, T, Hq, D), positions, cos_t, sin_t)
    k = apply_rope(k.reshape(B, T, Hkv, D), positions, cos_t, sin_t)
    return q, k, v.reshape(B, T, Hkv, D)


def _qkv_proj(lp: LlamaLayer, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor):
    """Shared q/k/v projection + reshape + rope for one layer (any T)."""
    return _qkv_heads(*_qkv_cols(lp, x, cfg), cfg, positions, cos_t, sin_t)


def _bmm_f32(a: torch.Tensor, b) -> torch.Tensor:
    """Batched ``a [E, M, K] @ b [E, K, N]`` as an f32 result nothing has
    rounded (JAX's batched einsum with ``preferred_element_type=f32``): the
    operands are widened first (a product of two bf16 values is exact in
    f32, and so is an int8 value), a transient f32 copy of all E experts'
    weights, bf16 or int. A quantized ``b`` is widened from its int values
    and the product scaled per expert and output channel."""
    if isinstance(b, QuantWeight):
        return torch.bmm(a.float(), b.values().float()) * b.s[:, None, :]
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.bmm(a, b)
    return torch.bmm(a.float(), b.float())


def _experts_f32(w) -> tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An expert stack widened to f32, and its scales [E, out] (None when
    unquantized)."""
    if isinstance(w, QuantWeight):
        return w.values().float(), w.s
    return w.float(), None


def _moe_mlp_dense(x: torch.Tensor, lp: LlamaLayer, cfg: ModelConfig,
                   keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The MoE oracle: every expert computes, and a top-k mask softmaxes the
    router logits over the selected experts (Mixtral). E times the routed
    FLOPs; the routed form is held against it. ``keep`` [B, T, E] bool: the
    experts each token takes in place of its own top k (an oracle routed as
    another forward routed). Returns f32 [B, T, H]."""
    K = cfg.experts_per_token
    router_logits = _mm_f32(x, lp.router)                     # [B, T, E]
    if keep is None:
        threshold = torch.topk(router_logits, K, dim=-1).values[..., K - 1:K]
        keep = router_logits >= threshold
    masked = torch.where(keep, router_logits, torch.full_like(router_logits, -1e30))
    weights = torch.softmax(masked, dim=-1)                    # zeros off the top k
    xf = x.float()

    def expert_product(spec: str, a: torch.Tensor, w) -> torch.Tensor:
        m, s = _experts_f32(w)
        y = torch.einsum(spec, a, m)
        return y if s is None else y * s  # [..., E, out] * [E, out]

    gate = expert_product("bth,ehi->btei", xf, lp.moe_gate)
    up = expert_product("bth,ehi->btei", xf, lp.moe_up)
    act = (_act(gate, cfg) * up).to(x.dtype)
    expert_out = expert_product("btei,eih->bteh", act.float(), lp.moe_down)
    return torch.einsum("bteh,bte->bth", expert_out, weights)


def moe_capacity(cfg: ModelConfig, N: int, n: int) -> int:
    """Slots of each expert's bucket in a routed MoE call over N rows of
    which n are real tokens: JAX's capacity for the N rows,
    max(ceil(N·k/E)·``moe_capacity_factor``, min(N, 256), 1), capped at n.
    A token picks k distinct experts, so no bucket receives more than n
    real assignments: the cap drops nothing that JAX's buckets keep, and
    the buffer is no larger than the real tokens can fill."""
    E, K = cfg.num_experts, cfg.experts_per_token
    jax_capacity = max(int(-(-N * K // E) * cfg.moe_capacity_factor), min(N, 256), 1)
    return min(jax_capacity, max(1, int(n)))


def _moe_mlp(x: torch.Tensor, lp: LlamaLayer, cfg: ModelConfig,
             valid: Optional[torch.Tensor] = None, n_tokens: Optional[int] = None
             ) -> torch.Tensor:
    """The routed MoE MLP (the JAX ``_moe_mlp``): each token's top-k
    experts by router logit, gates softmaxed over those k; the N·k
    assignments sorted by expert (stable) land in an ``[E, C, H]`` dispatch
    buffer of capacity C = :func:`moe_capacity` (JAX's for the N rows,
    capped at the real count); overflow assignments lose that expert's
    contribution (they land in a sacrificial row E). One
    batched product per projection runs every expert's bucket, and a
    weighted scatter-add combines them. Every shape is static and nothing is
    read on the host (the bucket counts are a ``scatter_add_`` into a zero
    count; no ``bincount``, ``nonzero`` or boolean-mask indexing), so it
    runs inside a CUDA graph. Returns f32 [B, T, H].

    ``valid`` [B, T] (a padded batch's real tokens): the other positions'
    assignments sort past every expert and take no capacity, and their rows
    get no MLP output. JAX routes a mixed round's padding like real tokens:
    identical padding rows all pick the same k experts and, at mixtral's 8
    experts, fill those buckets before later rows' real tokens, which are
    then dropped. ``n_tokens`` (the real token count, known on the host)
    caps the buckets at what the real tokens can fill."""
    E, K = cfg.num_experts, cfg.experts_per_token
    B, T, H = x.shape
    N = B * T
    dev = x.device
    flat = x.reshape(N, H)
    router_logits = _mm_f32(flat, lp.router)                  # [N, E]
    top_vals, top_idx = torch.topk(router_logits, K, dim=-1)
    weights = torch.softmax(top_vals, dim=-1)                 # [N, K]
    NK = N * K
    expert_of = top_idx.reshape(NK)
    if valid is not None:
        real = valid.reshape(N, 1).expand(N, K).reshape(NK)
        expert_of = torch.where(real, expert_of, torch.full_like(expert_of, E))
    token_of = torch.arange(NK, device=dev) // K  # repeat_interleave would read its size back
    order = torch.argsort(expert_of, stable=True)
    se, st, sg = expert_of[order], token_of[order], weights.reshape(NK)[order]
    counts = torch.zeros(E + 1, dtype=torch.long, device=dev).scatter_add_(
        0, se, torch.ones_like(se))
    offsets = torch.cumsum(counts, 0) - counts
    pos = torch.arange(NK, device=dev) - offsets[se]          # slot in its bucket
    capacity = moe_capacity(cfg, N, N if n_tokens is None else n_tokens)
    keep = (pos < capacity) & (se < E)
    safe_e = torch.where(keep, se, torch.full_like(se, E))
    safe_p = torch.where(keep, pos, torch.zeros_like(pos))
    dispatch = torch.zeros((E + 1, capacity, H), dtype=x.dtype, device=dev)
    dispatch[safe_e, safe_p] = flat[st]
    xb = dispatch[:E]                                         # [E, C, H]
    act = (_act(_bmm_f32(xb, lp.moe_gate), cfg) * _bmm_f32(xb, lp.moe_up)).to(x.dtype)
    expert_out = _bmm_f32(act, lp.moe_down)                   # [E, C, H] f32
    # dropped assignments read a clamped row and are zeroed (JAX's gather
    # clamps the sacrificial index the same way)
    contrib = expert_out[safe_e.clamp_max(E - 1), safe_p] * sg[:, None]
    contrib = torch.where(keep[:, None], contrib, torch.zeros_like(contrib))
    out = torch.zeros((N, H), dtype=torch.float32, device=dev).index_add_(0, st, contrib)
    return out.reshape(B, T, H)


def _mlp(lp: LlamaLayer, x: torch.Tensor, cfg: ModelConfig, down=_linear,
         valid: Optional[torch.Tensor] = None,
         n_tokens: Optional[int] = None) -> torch.Tensor:
    """The (routed MoE or dense gated) MLP of the normed ``x``: ``down``
    (:func:`_linear`, or :func:`_linear_f32` for a rank's partial sum) over
    ``act(gate) * up``, whose gate and up stay f32 until the product is
    rounded; the routed MoE's f32 combine. ``valid`` and ``n_tokens`` reach
    the routed MoE (see :func:`_moe_mlp`)."""
    if cfg.num_experts > 0:
        return _moe_mlp(x, lp, cfg, valid, n_tokens)
    return down(_gated(lp, x, cfg), lp.down)


def _mlp_residual(lp: LlamaLayer, h: torch.Tensor, cfg: ModelConfig,
                  valid: Optional[torch.Tensor] = None,
                  n_tokens: Optional[int] = None) -> torch.Tensor:
    """Post-attention norm + MLP + residual of one unsharded layer: what
    :func:`_tp_stack` computes on one rank."""
    x = rms_norm(h, lp.mlp_norm, cfg.rms_norm_eps, cfg.norm_weight_offset)
    return h + _mlp(lp, x, cfg, _linear, valid, n_tokens).to(h.dtype)


def _gated(lp: LlamaLayer, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """``act(x @ gate) * (x @ up)`` from f32 products, rounded to x's dtype."""
    return (_act(_linear_f32(x, lp.gate), cfg) * _linear_f32(x, lp.up)).to(x.dtype)


def _input_norm(lp: LlamaLayer, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(h, lp.attn_norm, cfg.rms_norm_eps, cfg.norm_weight_offset)


def _final_norm(params: LlamaModel, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return rms_norm(h, params.final_norm, cfg.rms_norm_eps, cfg.norm_weight_offset)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype=torch.bfloat16,
               device: DeviceLike = None) -> KVCache:
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, max_seq, cfg.num_kv_heads, cfg.head_dim)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def init_model_cache(params, cfg: ModelConfig, batch: int, max_seq: int,
                     device: DeviceLike = None) -> KVCache:
    """A zeroed dense cache for ``params``: :func:`init_cache` on ``device``
    (else the model's), or under tp one cache a rank with its kv heads, on
    its device, as ``([k_r], [v_r])``."""
    if isinstance(params, ShardedLlama):
        caches = [init_cache(params.rank_cfg, batch, max_seq, params.dtype, d)
                  for d in params.mesh.devices]
        return [c[0] for c in caches], [c[1] for c in caches]
    return init_cache(cfg, batch, max_seq, params.dtype,
                      device=params.device if device is None else device)


def kv_row(kv: KVCache, i: int) -> KVCache:
    """Row ``i`` (kept as a batch of one) of a collected ``[L, B, ...]`` KV,
    every rank's."""
    def row(x):
        return [t[:, i:i + 1] for t in x] if isinstance(x, list) else x[:, i:i + 1]
    return row(kv[0]), row(kv[1])


def forward(params: LlamaModel, cfg: ModelConfig, input_ids: torch.Tensor,
            positions: torch.Tensor, cache: KVCache, cache_start: torch.Tensor,
            rope_tables: tuple[torch.Tensor, torch.Tensor], use_flash: bool = False,
            valid: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, KVCache]:
    """Dense forward (prefill T>1 or decode T=1) over a dense cache, written
    in place at ``cache_start``. Returns (hidden [B, T, H], cache).

    ``use_flash`` attends with :func:`ops.flash_attention.flash_self_attention`
    over this step's own k/v with ``cache_start + T`` as the lengths, as the
    JAX forward does: ONLY valid for a fresh cache (cache_start all zero),
    since the kernel sees the new tokens, not the cache history. ``valid``
    [B, T]: a padded batch's real tokens, for the routed MoE."""
    B, T = input_ids.shape
    h = _embed_scale(embed_lookup(params.embed, input_ids, params.dtype), cfg)
    kv_len_after = cache_start + T
    flash_lens = kv_len_after.to(torch.int32).contiguous() if use_flash else None
    b_idx = torch.arange(B, device=h.device)[:, None]
    t_idx = cache_start.long()[:, None] + torch.arange(T, device=h.device)[None, :]
    return _tp_dense(_as_ranks(params, cfg), h, positions, rope_tables, cache, b_idx, t_idx,
                     kv_len_after, flash_lens, valid), cache


def prefill_collect(params: LlamaModel, cfg: ModelConfig, input_ids: torch.Tensor,
                    lengths: torch.Tensor, rope_tables: tuple[torch.Tensor, torch.Tensor],
                    use_flash: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Prefill that RETURNS the new per-layer k/v ``[L, B, T, Hkv, D]``
    instead of writing a persistent cache; the scheduler places them into a
    slot (pool pages or a dense cache row). Returns (last_h [B, H], kv).
    The same function as :func:`forward` on a fresh cache of S = T."""
    B, T = input_ids.shape
    dev = input_ids.device
    positions = torch.arange(T, dtype=torch.int32, device=dev)[None, :].expand(B, T)
    cache = init_model_cache(params, cfg, B, T, device=dev)
    valid = positions < lengths.to(positions.dtype)[:, None] if cfg.num_experts else None
    hidden, kv = forward(params, cfg, input_ids, positions, cache,
                         torch.zeros(B, dtype=torch.int32, device=dev), rope_tables,
                         use_flash=use_flash, valid=valid)
    return gather_last_hidden(hidden, lengths), kv


def insert_slot_kv(cache: KVCache, new_kv: KVCache, slot: int) -> KVCache:
    """Write one request's collected kv ``[L, 1, T, Hkv, D]`` into positions
    ``0 .. T-1`` of its dense cache row ``slot``, in place (the JAX function
    donates the cache to a dynamic_update_slice). Returns the cache."""
    for c, new in zip(cache, new_kv):
        for c_r, new_r in zip(_ranks(c), _ranks(new)):
            c_r[:, int(slot), :new_r.shape[2]] = new_r[:, 0].to(c_r.dtype)
    return cache


def forward_paged_decode(
    params: LlamaModel,
    cfg: ModelConfig,
    input_ids: torch.Tensor,    # [B, 1] — one token per slot
    pools: PagedPools,
    page_table: torch.Tensor,   # [B, Pmax] int32 physical page ids per slot
    lengths: torch.Tensor,      # [B] int32 valid length BEFORE this token
    rope_tables: tuple[torch.Tensor, torch.Tensor],
    write_mask: Optional[torch.Tensor] = None,  # [B] bool; False rows → scratch
) -> tuple[torch.Tensor, PagedPools]:
    """One decode step over the paged pool. Returns (hidden [B, 1, H], pools).

    Each slot's new k/v lands at (page_table[b, len//page], len%page), in
    place; rows with ``write_mask`` False write to scratch page 0 instead.
    Attention runs :func:`paged_decode_attention` over ``lengths + 1`` keys."""
    cos_t = rope_tables[0]
    page = _ranks(pools[0])[0].shape[2]
    lengths = lengths.to(torch.int32)
    # a frozen row may sit at the window (length == Pmax * page): its write
    # goes to scratch and its output is dropped, but its indices must stay
    # in range (JAX's gathers clamp them)
    positions = torch.clamp_max(lengths, cos_t.shape[0] - 1)[:, None]
    idx_page = torch.clamp_max(lengths // page, page_table.shape[1] - 1).long()
    pid = torch.gather(page_table, 1, idx_page[:, None])[:, 0].long()
    off = (lengths % page).long()
    if write_mask is not None:
        pid = torch.where(write_mask, pid, torch.zeros_like(pid))
        off = torch.where(write_mask, off, torch.zeros_like(off))
    kv_len = (lengths + 1).contiguous()
    h = _embed_scale(embed_lookup(params.embed, input_ids, params.dtype), cfg)

    def decode(q, kp, vp, pt, n_kv):
        return paged_decode_attention(q[:, 0].contiguous(), kp, vp, pt, n_kv,
                                      sliding_window=cfg.sliding_window)
    # inactive slots all target scratch page 0: duplicate writes there are
    # harmless
    return _tp_paged(_as_ranks(params, cfg), h, positions, rope_tables, pools, pid[:, None],
                     off[:, None], decode, (page_table, kv_len)), pools


def forward_paged_mixed(
    params: LlamaModel,
    cfg: ModelConfig,
    input_ids: torch.Tensor,    # [B, Qmax] — per-row query span, padded
    pools: PagedPools,
    page_table: torch.Tensor,   # [B, Pmax] int32
    hist: torch.Tensor,         # [B] int32 kv tokens BEFORE each row's span
    q_lens: torch.Tensor,       # [B] int32 span length (0 = idle row)
    rope_tables: tuple[torch.Tensor, torch.Tensor],
    write_mask: Optional[torch.Tensor] = None,  # [B] bool; False rows → scratch
    moe_tokens: Optional[int] = None,  # the span tokens, counted on the host
) -> tuple[torch.Tensor, PagedPools]:
    """One ragged mixed-batch step: decode rows (q_len=1) and prefill-chunk
    rows (q_len=chunk) in one pass. Returns (hidden [B, Qmax, H], pools).
    A MoE config routes only the span tokens, its buckets sized by
    ``moe_tokens`` (see :func:`_moe_mlp`).

    Row b's span lands at positions hist[b] .. hist[b]+q_len-1 of its chain
    (in place, before attending, so the span reads its own earlier tokens);
    padding positions and ``write_mask`` False rows write to scratch page 0
    and give hidden states nothing downstream reads."""
    Qmax = input_ids.shape[1]
    page = _ranks(pools[0])[0].shape[2]
    hist = hist.to(torch.int32).contiguous()
    q_lens = q_lens.to(torch.int32).contiguous()
    offs = torch.arange(Qmax, device=input_ids.device)[None, :]
    valid = offs < q_lens[:, None]
    if write_mask is not None:
        valid = valid & write_mask[:, None]
    positions = torch.where(valid, hist[:, None] + offs, torch.zeros_like(offs))
    pid = torch.gather(page_table, 1, (positions // page).long()).long()
    pid = torch.where(valid, pid, torch.zeros_like(pid))
    off = torch.where(valid, positions % page, torch.zeros_like(positions)).long()
    h = _embed_scale(embed_lookup(params.embed, input_ids, params.dtype), cfg)

    def ragged(q, kp, vp, pt, hist_r, q_lens_r):
        return ragged_paged_attention(q.contiguous(), kp, vp, pt, hist_r, q_lens_r,
                                      sliding_window=cfg.sliding_window)
    return _tp_paged(_as_ranks(params, cfg), h, positions, rope_tables, pools, pid, off,
                     ragged, (page_table, hist, q_lens), valid, moe_tokens), pools


def _softcap(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        return cap * torch.tanh(logits / cap)
    return logits


def lm_head_logits(params: LlamaModel, cfg: ModelConfig,
                   hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, H] (or [B, T, H]) → logits in f32 (tied or untied head,
    gemma-2 softcap). A tied int8 head multiplies the rows' int values and
    then each vocab column by its row scale. Under tp an untied head is
    vocab-sharded: each rank's logits slice, gathered in rank order on rank
    0 (a tied head is the replicated table, on rank 0)."""
    if isinstance(params, ShardedLlama) and not cfg.tie_embeddings:
        mesh = params.mesh
        logits = mesh.all_gather([_linear_f32(x, m.lm_head) for x, m in
                                  zip(mesh.scatter(hidden), params.ranks)])
        return _softcap(logits, cfg)
    if cfg.tie_embeddings:
        embed = params.embed
        if isinstance(embed, QuantEmbed):
            logits = _mm_f32(hidden, embed.qe.to(hidden.dtype).t()) * embed.se
        else:
            logits = _mm_f32(hidden, embed.t())
    else:
        logits = _linear_f32(hidden, params.lm_head)
    return _softcap(logits, cfg)


def gather_last_hidden(hidden: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """hidden [B, T, H], lengths [B] → [B, H] at index lengths-1 per row."""
    idx = torch.clamp_min(lengths.long() - 1, 0)
    return hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]


# ---------------------------------------------------------------- tensor parallelism
def _tp_stack(params: ShardedLlama, h: torch.Tensor, positions: torch.Tensor,
              rope_tables: tuple[torch.Tensor, torch.Tensor], attend,
              valid: Optional[torch.Tensor] = None,
              moe_tokens: Optional[int] = None) -> torch.Tensor:
    """The decoder layers over the hidden stream ``h`` [B, T, H] (on rank 0),
    then the final norm: every forward's layer loop (an unsharded model is
    one rank). Per layer: every rank projects its
    q/k/v columns and ``attend(r, layer, q, k, v)`` runs its attention
    ([B, T, heads, D]); its rows of ``wo`` give an f32 partial sum, and the
    partials are added in rank order and rounded where the unsharded product
    rounds; the MLP likewise (``gate`` / ``up`` columns, ``down`` rows; a
    MoE rank routes every token, as the router is replicated, and runs its
    intermediate slice of each expert). One rank's ``wo`` and ``down``
    products are its sums: they round once either way, and in the
    activation dtype the GEMM writes no f32 result to cast (a cast kernel
    each, 1% of llama-3-8b's bf16 decode step).

    When tp does not divide the kv heads (a replicated pool), a rank's
    columns are not whole heads: the ranks' q/k/v columns are gathered into
    all heads, every rank attends over all heads on its own pool replica,
    and keeps its columns of the output for its rows of ``wo``."""
    cfg, mesh, rc, tp = params.cfg, params.mesh, params.rank_cfg, params.tp
    row = _linear if tp == 1 else _linear_f32
    B, T = h.shape[0], h.shape[1]
    pos, cos, sin = (mesh.scatter(t) for t in (positions, *rope_tables))
    valids = mesh.scatter(valid)
    for layer in range(cfg.num_layers):
        lps = [m.layers[layer] for m in params.ranks]
        cols = [_qkv_cols(lp, x, cfg) for lp, x in
                zip(lps, mesh.scatter(_input_norm(lps[0], h, cfg)))]
        if not params.kv_sharded:
            full = [mesh.scatter(mesh.all_gather([c[i] for c in cols])) for i in range(3)]
            cols = list(zip(*full))
        parts = []
        for r, (lp, (q, k, v)) in enumerate(zip(lps, cols)):
            q, k, v = _qkv_heads(q, k, v, rc, pos[r], cos[r], sin[r])
            attn = attend(r, layer, q, k, v).reshape(B, T, -1)
            if not params.kv_sharded:
                w = attn.shape[-1] // tp
                attn = attn[..., r * w:(r + 1) * w]
            parts.append(row(attn, lp.wo))
        h = h + mesh.all_reduce_sum(parts).to(h.dtype)
        xs = mesh.scatter(rms_norm(h, lps[0].mlp_norm, cfg.rms_norm_eps, cfg.norm_weight_offset))
        parts = [_mlp(lp, x, rc, row, vr, moe_tokens) for lp, x, vr in zip(lps, xs, valids)]
        h = h + mesh.all_reduce_sum(parts).to(h.dtype)
    return _final_norm(params, h, cfg)


def _tp_dense(params: ShardedLlama, h: torch.Tensor, positions: torch.Tensor,
              rope_tables, cache: KVCache, b_idx: torch.Tensor, t_idx: torch.Tensor,
              kv_len_after: torch.Tensor, flash_lens: Optional[torch.Tensor],
              valid: Optional[torch.Tensor]) -> torch.Tensor:
    """:func:`forward`'s layers: each rank writes its k/v heads into its
    cache and attends (flash over the step's own k/v, or plain attention
    over its cache)."""
    mesh, window = params.mesh, params.cfg.sliding_window
    k_caches, v_caches = (_ranks(c) for c in cache)
    b_r, t_r, pos_r, len_r, flash_r = (mesh.scatter(t) for t in
                                       (b_idx, t_idx, positions, kv_len_after, flash_lens))

    def attend(r, layer, q, k, v):
        k_caches[r][layer, b_r[r], t_r[r]] = k.to(k_caches[r].dtype)
        v_caches[r][layer, b_r[r], t_r[r]] = v.to(v_caches[r].dtype)
        if flash_r[r] is not None:
            return flash_self_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                        flash_r[r], sliding_window=window)
        keys, values = k_caches[r][layer], v_caches[r][layer]
        if k.requires_grad:
            # a training forward: autograd keeps what attention reads, and
            # the next layer's write into the same cache would invalidate a
            # view of it
            keys, values = keys.clone(), values.clone()
        return attention_with_cache(q, keys, values, pos_r[r], len_r[r], sliding_window=window)
    return _tp_stack(params, h, positions, rope_tables, attend, valid)


def _tp_paged(params: ShardedLlama, h: torch.Tensor, positions: torch.Tensor,
              rope_tables, pools: PagedPools, pid: torch.Tensor, off: torch.Tensor,
              kernel, kernel_args: tuple, valid: Optional[torch.Tensor] = None,
              moe_tokens: Optional[int] = None) -> torch.Tensor:
    """The paged forwards' layers: each rank writes its k/v heads at
    (``pid``, ``off``) [B, T] of its pool, in place, then runs ``kernel(q,
    k_pool[layer], v_pool[layer], *kernel_args)`` on its own pool slice,
    with ``kernel_args`` (page table, lengths) on its device."""
    mesh = params.mesh
    k_pools, v_pools = (_ranks(p) for p in pools)
    pid_r, off_r = mesh.scatter(pid), mesh.scatter(off)
    args_r = list(zip(*(mesh.scatter(a) for a in kernel_args)))

    def attend(r, layer, q, k, v):
        kp, vp = k_pools[r], v_pools[r]
        kp[layer].index_put_((pid_r[r], off_r[r]), k.to(kp.dtype))
        vp[layer].index_put_((pid_r[r], off_r[r]), v.to(vp.dtype))
        return kernel(q, kp[layer], vp[layer], *args_r[r])
    return _tp_stack(params, h, positions, rope_tables, attend, valid, moe_tokens)
