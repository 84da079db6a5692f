"""Megatron sharding rules for the llama family (counterpart of
``parallel/sharding.py``).

The JAX package expresses the layout as ``NamedSharding`` specs and lets
GSPMD cut the arrays. The port keeps the same specs (:func:`llama_param_specs`,
over the JAX package's stacked ``[L, ...]`` leaf shapes) and cuts a
:class:`..models.llama.LlamaModel` into one rank model per device by them
(:func:`shard_llama_params`):

- ``wq`` / ``wk`` / ``wv`` (and the qwen2 ``bq`` / ``bk`` / ``bv``),
  ``gate``, ``up``: column-parallel, cut on their output axis;
- ``wo``, ``down``: row-parallel, cut on their input axis;
- ``lm_head``: cut on the vocabulary; ``embed`` and the norms replicated
  (JAX's layout, and the plan's per-device bytes). The single controller
  reads them on rank 0 alone (the hidden stream, its norms and a tied head
  live there), so only rank 0 holds them: the ranks past it hold
  :func:`rank0_only_bytes` less than the plan's per-device figure;
- MoE: ``moe_gate`` / ``moe_up`` / ``moe_down`` cut on their intermediate
  axis (the tp axis of JAX's ``(ep, ..., tp)`` specs; the port has no
  expert-parallel axis, every rank holds every expert), the router
  replicated;
- quantized leaves follow :func:`spec_for_quant_leaf`: ``q`` keeps the
  weight's cut, the per-output-channel ``s`` drops the contraction axis (so
  a row-parallel leaf's scales are replicated, a column-parallel leaf's are
  cut with its columns), the int8 embedding's ``qe`` / ``se`` replicate.

Packed int4: ``q`` holds rows 2j and 2j+1 of the contraction axis in one
byte. Column-parallel leaves are cut on the output axis, which the packing
does not touch. Row-parallel leaves (``wo``, ``down``, ``moe_down``) are cut
on the contraction axis itself: rank r takes packed rows
``[r·in/(2·tp), (r+1)·in/(2·tp))``, which are the unpacked rows
``[r·in/tp, (r+1)·in/tp)``; a contraction length that does not divide by
``2·tp`` would split a byte and raises.

The paged pool ``[L, N, page, Hkv, D]`` is cut on its kv-head axis when
``tp`` divides the kv heads (:func:`kv_heads_sharded`); otherwise every rank
holds all heads (JAX's replicated fallback, ``sharding.py:86``). Rank r
then attends over all heads on its own replica and keeps its columns of the
attention output (see :mod:`..models.llama`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from ..models.configs import ModelConfig
from ..models.llama import LlamaModel, ShardedLlama, _leaf_shapes
from ..runtime.quant import QuantEmbed, QuantWeight
from .mesh import RankMesh

Spec = tuple[Optional[str], ...]

#: per-layer leaf → its spec over the stacked [L, ...] shape (JAX
#: ``llama_param_shardings`` with no layer axis)
_LAYER_SPECS: dict[str, Spec] = {
    "attn_norm": (None, None),
    "wq": (None, None, "tp"), "wk": (None, None, "tp"), "wv": (None, None, "tp"),
    "wo": (None, "tp", None),
    "mlp_norm": (None, None),
    "gate": (None, None, "tp"), "up": (None, None, "tp"), "down": (None, "tp", None),
    "bq": (None, "tp"), "bk": (None, "tp"), "bv": (None, "tp"),
    "router": (None, None, None),
    "moe_gate": (None, None, None, "tp"), "moe_up": (None, None, None, "tp"),
    "moe_down": (None, None, "tp", None),
}


#: the replicated leaves that only rank 0 reads, so only rank 0 holds (the
#: router is replicated too, but every rank routes its own MoE slice)
_RANK0_ONLY = ("embed", "final_norm", "attn_norm", "mlp_norm")


def rank0_only(path: str) -> bool:
    """Whether a leaf path of the plan (``embed``, ``embed.qe``,
    ``layers.attn_norm``, ...) is held by rank 0 alone."""
    return path.removeprefix("layers.").split(".")[0] in _RANK0_ONLY


def llama_param_specs(cfg: ModelConfig) -> dict[str, Spec]:
    """Leaf path (``embed``, ``final_norm``, ``lm_head``, ``layers.<leaf>``)
    → mesh axis per dimension of the JAX package's stacked leaf."""
    specs: dict[str, Spec] = {"embed": (None, None), "final_norm": (None,)}
    for name in _leaf_shapes(cfg):
        specs[f"layers.{name}"] = _LAYER_SPECS[name]
    if not cfg.tie_embeddings:
        specs["lm_head"] = (None, "tp")
    return specs


def spec_for_quant_leaf(spec: Spec, leaf_key: str) -> Spec:
    """A quantized sub-leaf's spec from its weight's: ``q`` / ``qe`` keep
    it, ``s`` ([..., out]) drops the contraction axis (-2), ``se`` ([V])
    keeps the row axis only."""
    if leaf_key in ("q", "qe"):
        return spec
    if leaf_key == "s":
        return spec[:-2] + spec[-1:] if len(spec) >= 2 else spec
    if leaf_key == "se":
        return spec[:1]
    raise ValueError(f"unknown quant leaf {leaf_key!r}")


def kv_heads_sharded(cfg: ModelConfig, tp: int) -> bool:
    """Whether the KV pool (and each rank's attention) splits on the
    kv-head axis: ``tp`` divides the kv heads. Otherwise every rank holds
    all kv heads (JAX ``_kv_head_axis``)."""
    return tp > 1 and cfg.num_kv_heads % tp == 0


def check_tp_layout(cfg: ModelConfig, tp: int) -> None:
    """Raise ValueError when the model cannot be cut ``tp`` ways: kv heads
    and tp must divide one way or the other (JAX ``tp_plan``), and every cut
    axis must divide evenly."""
    if tp < 1:
        raise ValueError(f"tp must be at least 1, got {tp}")
    if cfg.num_kv_heads % tp and tp % cfg.num_kv_heads:
        raise ValueError(f"{cfg.name}: num_kv_heads={cfg.num_kv_heads} and tp={tp} divide "
                         "neither way — the KV cache cannot shard")
    Dq, Dkv = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    for what, n in (("query width", Dq), ("kv width", Dkv),
                    ("intermediate_size", cfg.intermediate_size),
                    ("vocab_size", cfg.vocab_size)):
        if n % tp:
            raise ValueError(f"{cfg.name}: {what} {n} does not divide by tp={tp}")


def rank_config(cfg: ModelConfig, tp: int) -> ModelConfig:
    """What one rank runs: its attention heads (a kv-head slice when they
    shard, else all heads), its intermediate and vocab slices."""
    if tp == 1:
        return cfg
    sharded = kv_heads_sharded(cfg, tp)
    return dataclasses.replace(
        cfg,
        num_heads=cfg.num_heads // tp if sharded else cfg.num_heads,
        num_kv_heads=cfg.num_kv_heads // tp if sharded else cfg.num_kv_heads,
        intermediate_size=cfg.intermediate_size // tp,
        vocab_size=cfg.vocab_size // tp)


def _owned(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    """A contiguous copy of ``t`` of its own on ``device``: a rank's leaf
    never aliases the source model, so its bytes are what the plan counts."""
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    out.copy_(t)
    return out


def _cut(t: torch.Tensor, axis: Optional[int], rank: int, tp: int,
         device: torch.device, name: str, packed: bool = False) -> torch.Tensor:
    if axis is None:
        return _owned(t, device)
    n = t.shape[axis]
    if n % tp:
        why = (" (packed int4 rows: each rank's cut must fall on whole bytes, so the "
               "contraction length must divide by 2·tp)"
               if packed and axis == t.dim() - 2 else "")
        raise ValueError(f"{name}: axis {axis} of {tuple(t.shape)} does not divide by "
                         f"tp={tp}{why}")
    per = n // tp
    return _owned(t.narrow(axis, rank * per, per), device)


def _tp_axis(spec: Spec, stacked: bool) -> Optional[int]:
    """The per-rank cut axis of a leaf held without the stacked L axis."""
    if "tp" not in spec:
        return None
    axis = spec.index("tp")
    return axis - 1 if stacked else axis


def _shard_leaf(leaf: Any, spec: Spec, stacked: bool, rank: int, tp: int,
                device: torch.device, name: str) -> Any:
    if isinstance(leaf, QuantWeight):
        q = _cut(leaf.q, _tp_axis(spec_for_quant_leaf(spec, "q"), stacked), rank, tp, device,
                 name, packed=leaf.bits == 4)
        s = _cut(leaf.s, _tp_axis(spec_for_quant_leaf(spec, "s"), stacked), rank, tp, device,
                 name)
        return QuantWeight(q, s, leaf.bits)
    if isinstance(leaf, QuantEmbed):  # replicated
        return QuantEmbed(_owned(leaf.qe, device), _owned(leaf.se, device))
    return _cut(leaf.data, _tp_axis(spec, stacked), rank, tp, device, name)


def shard_llama_params(params: LlamaModel, mesh: RankMesh) -> ShardedLlama:
    """Cut ``params`` into one rank model per mesh device (each a copy of
    its own; ``params`` is left as it is). Rank 0 alone holds the embedding
    and the norms (:func:`rank0_only`)."""
    cfg, tp = params.cfg, mesh.tp
    check_tp_layout(cfg, tp)
    specs = llama_param_specs(cfg)
    rcfg = rank_config(cfg, tp)
    ranks = []
    for r, dev in enumerate(mesh.devices):
        names = [n for n in _leaf_shapes(cfg) if r == 0 or not rank0_only(n)]
        layers = []
        for i, lp in enumerate(params.layers):
            layers.append({name: _shard_leaf(getattr(lp, name), specs[f"layers.{name}"], True,
                                             r, tp, dev, f"layers.{i}.{name}")
                           for name in names})
        embed = _shard_leaf(params.embed, specs["embed"], False, r, tp, dev, "embed") \
            if r == 0 else None
        norm = _owned(params.final_norm.data, dev) if r == 0 else None
        head = None if cfg.tie_embeddings else _shard_leaf(
            params.lm_head, specs["lm_head"], False, r, tp, dev, "lm_head")
        ranks.append(LlamaModel(rcfg, embed, norm, layers, head))
    return ShardedLlama(cfg, mesh, ranks, kv_heads_sharded(cfg, tp))


def rank_bytes(params: ShardedLlama) -> list[int]:
    """Bytes of every tensor each rank holds."""
    return [sum(t.numel() * t.element_size()
                for t in list(m.parameters()) + list(m.buffers())) for m in params.ranks]


__all__ = ["check_tp_layout", "kv_heads_sharded", "llama_param_specs", "rank0_only",
           "rank_bytes", "rank_config", "shard_llama_params", "spec_for_quant_leaf"]
