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
(``wo``, ``down``), a product in the activation dtype computes the same (the
GEMM accumulates in f32 and rounds once). Where JAX works on the f32 product
first (the logits; ``act(gate) * up``; the qwen2 q/k/v bias), the port asks for
an f32 result too (:func:`_mm_f32`) and rounds where JAX rounds.

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
    :class:`QuantEmbed` and :class:`QuantWeight` leaves in their place."""

    def __init__(self, cfg: ModelConfig, embed: torch.Tensor,
                 final_norm: torch.Tensor, layers: list[dict[str, torch.Tensor]],
                 lm_head: Optional[torch.Tensor] = None) -> None:
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        self.embed = _leaf(embed)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
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


def _qkv_proj(lp: LlamaLayer, x: torch.Tensor, cfg: ModelConfig,
              positions: torch.Tensor, cos_t: torch.Tensor, sin_t: torch.Tensor):
    """Shared q/k/v projection + reshape + rope for one layer (any T). The
    qwen2 bias is added to the f32 product and rounded once with it."""
    B, T = x.shape[0], x.shape[1]
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if cfg.attention_bias:
        q, k, v = ((_linear_f32(x, w) + b).to(x.dtype)
                   for w, b in ((lp.wq, lp.bq), (lp.wk, lp.bk), (lp.wv, lp.bv)))
    else:
        q, k, v = _linear(x, lp.wq), _linear(x, lp.wk), _linear(x, lp.wv)
    q = apply_rope(q.reshape(B, T, Hq, D), positions, cos_t, sin_t)
    k = apply_rope(k.reshape(B, T, Hkv, D), positions, cos_t, sin_t)
    return q, k, v.reshape(B, T, Hkv, D)


def _attn_out(lp: LlamaLayer, h: torch.Tensor, attn_flat: torch.Tensor) -> torch.Tensor:
    return h + _linear(attn_flat, lp.wo).to(h.dtype)


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


def _mlp_residual(lp: LlamaLayer, h: torch.Tensor, cfg: ModelConfig,
                  valid: Optional[torch.Tensor] = None,
                  n_tokens: Optional[int] = None) -> torch.Tensor:
    """Post-attention norm + (routed MoE or dense gated) MLP + residual;
    gate and up stay f32 until ``act(gate) * up`` is rounded. ``valid`` and
    ``n_tokens`` reach the routed MoE (see :func:`_moe_mlp`)."""
    x = rms_norm(h, lp.mlp_norm, cfg.rms_norm_eps, cfg.norm_weight_offset)
    if cfg.num_experts > 0:
        return h + _moe_mlp(x, lp, cfg, valid, n_tokens).to(h.dtype)
    act = (_act(_linear_f32(x, lp.gate), cfg) * _linear_f32(x, lp.up)).to(h.dtype)
    return h + _linear(act, lp.down).to(h.dtype)


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
    cos_t, sin_t = rope_tables
    B, T = input_ids.shape
    Hq, D = cfg.num_heads, cfg.head_dim
    h = _embed_scale(embed_lookup(params.embed, input_ids, params.dtype), cfg)
    kv_len_after = cache_start + T
    flash_lens = kv_len_after.to(torch.int32).contiguous() if use_flash else None
    b_idx = torch.arange(B, device=h.device)[:, None]
    t_idx = cache_start.long()[:, None] + torch.arange(T, device=h.device)[None, :]
    k_cache, v_cache = cache
    for layer, lp in enumerate(params.layers):
        x = _input_norm(lp, h, cfg)
        q, k, v = _qkv_proj(lp, x, cfg, positions, cos_t, sin_t)
        k_cache[layer, b_idx, t_idx] = k.to(k_cache.dtype)
        v_cache[layer, b_idx, t_idx] = v.to(v_cache.dtype)
        if use_flash:
            attn = flash_self_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                        flash_lens, sliding_window=cfg.sliding_window)
        else:
            attn = attention_with_cache(q, k_cache[layer], v_cache[layer], positions,
                                        kv_len_after, sliding_window=cfg.sliding_window)
        h = _attn_out(lp, h, attn.reshape(B, T, Hq * D))
        h = _mlp_residual(lp, h, cfg, valid)
    return _final_norm(params, h, cfg), (k_cache, v_cache)


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
    cache = init_cache(cfg, B, T, params.dtype, device=dev)
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
        c[:, int(slot), :new.shape[2]] = new[:, 0].to(c.dtype)
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
    cos_t, sin_t = rope_tables
    B = input_ids.shape[0]
    Hq, D = cfg.num_heads, cfg.head_dim
    k_pool, v_pool = pools
    page = k_pool.shape[2]
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
    for layer, lp in enumerate(params.layers):
        x = _input_norm(lp, h, cfg)
        q, k, v = _qkv_proj(lp, x, cfg, positions, cos_t, sin_t)
        # inactive slots all target scratch page 0: duplicate writes there
        # are harmless
        k_pool[layer].index_put_((pid, off), k[:, 0].to(k_pool.dtype))
        v_pool[layer].index_put_((pid, off), v[:, 0].to(v_pool.dtype))
        attn = paged_decode_attention(q[:, 0].contiguous(), k_pool[layer],
                                      v_pool[layer], page_table, kv_len,
                                      sliding_window=cfg.sliding_window)
        h = _attn_out(lp, h, attn.reshape(B, 1, Hq * D))
        h = _mlp_residual(lp, h, cfg)
    return _final_norm(params, h, cfg), pools


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
    cos_t, sin_t = rope_tables
    B, Qmax = input_ids.shape
    Hq, D = cfg.num_heads, cfg.head_dim
    k_pool, v_pool = pools
    page = k_pool.shape[2]
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
    for layer, lp in enumerate(params.layers):
        x = _input_norm(lp, h, cfg)
        q, k, v = _qkv_proj(lp, x, cfg, positions, cos_t, sin_t)
        k_pool[layer].index_put_((pid, off), k.to(k_pool.dtype))
        v_pool[layer].index_put_((pid, off), v.to(v_pool.dtype))
        attn = ragged_paged_attention(q.contiguous(), k_pool[layer], v_pool[layer],
                                      page_table, hist, q_lens,
                                      sliding_window=cfg.sliding_window)
        h = _attn_out(lp, h, attn.reshape(B, Qmax, Hq * D))
        h = _mlp_residual(lp, h, cfg, valid, moe_tokens)
    return _final_norm(params, h, cfg), pools


def _softcap(logits: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    if cfg.final_logit_softcap > 0.0:
        cap = cfg.final_logit_softcap
        return cap * torch.tanh(logits / cap)
    return logits


def lm_head_logits(params: LlamaModel, cfg: ModelConfig,
                   hidden: torch.Tensor) -> torch.Tensor:
    """hidden [B, H] (or [B, T, H]) → logits in f32 (tied or untied head,
    gemma-2 softcap). A tied int8 head multiplies the rows' int values and
    then each vocab column by its row scale."""
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
