"""Per-device byte plans for tensor-parallel serving, and the gate that
refuses an over-budget engine before it allocates (counterpart of
``parallel/feasibility.py``).

The JAX package derives its plan from ``jax.eval_shape`` over the serving
builders and ``NamedSharding.shard_shape``. The port takes the same shapes
from its own sources: :func:`..models.llama._leaf_shapes` (stacked over the
layers, as the JAX tree is), the quantized layout of :mod:`..runtime.quant`
and the specs of :mod:`.sharding`, and cuts each axis the spec names by its
mesh size. For bf16 and int8 the plan's bytes equal the JAX package's; at
int4 the port counts what it allocates, two values a byte, where JAX's
``int4`` arrays count one byte a value. ``param_bytes_per_device`` is JAX's
figure, every replicated leaf on every device; ``param_bytes_per_rank`` lists
what each rank of the port holds: rank 0 that figure, the others less the
embedding and norms that rank 0 alone holds (:func:`.sharding.rank0_only`).

The default budget is the card's memory:
``torch.cuda.get_device_properties(d).total_memory`` on the card, and
:data:`H100_HBM_BYTES` for a plan made off the card. As in JAX, an engine
enforces the budget only when ``hbm_bytes_per_device > 0``.

CLI: ``python -m cyberfabric_core_tpu_torch.parallel.feasibility --model
llama-3-70b --tp 8 --quant int8``
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Any, Optional

import torch

from ..device import DeviceLike
from ..models.configs import ModelConfig, get_config
from ..models.llama import _leaf_shapes
from ..runtime.quant import _MATMUL_LEAVES, quant_bits
from ..runtime.weights import _LLAMA_MAP
from .sharding import Spec, llama_param_specs, rank0_only, spec_for_quant_leaf

#: the H100 SXM's 80 GB of HBM3 (decimal, as sold): the budget of a plan made
#: off the card. On the card the plan takes the card's own ``total_memory``.
H100_HBM_BYTES = 80 * 10**9

#: the prefill length JAX's activation estimate budgets for
_PREFILL_BUCKET = 2048


class InfeasiblePlanError(ValueError):
    """A serving configuration whose per-device bytes exceed the budget,
    raised by :func:`gate_engine_plan` when an engine is built, before it
    allocates anything. Carries the plan (without its per-leaf tables)."""

    def __init__(self, message: str, plan: dict[str, Any]):
        super().__init__(message)
        self.plan = plan


def card_hbm_bytes(device: DeviceLike = None) -> int:
    """The budget of one rank: the CUDA card's total memory (``device``, or
    card 0 when None and a card is visible), else :data:`H100_HBM_BYTES`."""
    dev = torch.device(device) if device is not None else (
        torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu"))
    if dev.type != "cuda":
        return H100_HBM_BYTES
    return int(torch.cuda.get_device_properties(dev).total_memory)


def _itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _leaves(cfg: ModelConfig, dtype, quantization: str) -> list[tuple[str, tuple, Any, Spec]]:
    """(leaf path, stacked shape, dtype, spec) of every tensor the serving
    tree holds, quantized sub-leaves as ``<path>.q`` / ``.s`` / ``.qe`` /
    ``.se``, in the JAX tree's order."""
    bits = quant_bits(quantization)
    specs = llama_param_specs(cfg)
    H, V, L = cfg.hidden_size, cfg.vocab_size, cfg.num_layers
    shapes: dict[str, tuple] = {"embed": (V, H), "final_norm": (H,)}
    if not cfg.tie_embeddings:
        shapes["lm_head"] = (H, V)
    for name, shape in _leaf_shapes(cfg).items():
        shapes[f"layers.{name}"] = (L, *shape)
    out = []
    for path, shape in shapes.items():
        spec = specs[path]
        leaf = path.split(".")[-1]
        if bits is not None and path == "embed":
            out.append((f"{path}.qe", shape, torch.int8, spec_for_quant_leaf(spec, "qe")))
            out.append((f"{path}.se", shape[:1], torch.float32, spec_for_quant_leaf(spec, "se")))
        elif bits is not None and (leaf in _MATMUL_LEAVES or path == "lm_head"):
            q_shape = shape if bits == 8 else (*shape[:-2], shape[-2] // 2, shape[-1])
            out.append((f"{path}.q", q_shape, torch.int8, spec_for_quant_leaf(spec, "q")))
            out.append((f"{path}.s", shape[:-2] + shape[-1:], torch.float32,
                        spec_for_quant_leaf(spec, "s")))
        else:
            out.append((path, shape, dtype, spec))
    return out


def _shard_shape(shape: tuple, spec: Spec, tp: int, leaf: str) -> tuple:
    out = []
    for n, axis in zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))):
        parts = tp if axis == "tp" else 1
        if n % parts:
            raise ValueError(f"{leaf}: dimension {n} does not divide by tp={parts}")
        out.append(n // parts)
    return tuple(out)


def gate_engine_plan(
    model: "str | ModelConfig",
    tp: int,
    *,
    quantization: str = "none",
    dtype=torch.bfloat16,
    max_batch: int = 8,
    max_seq_len: int = 8192,
    page_size: int = 64,
    num_pages: Optional[int] = None,
    hbm_bytes: Optional[int] = None,
    device: DeviceLike = None,
) -> dict[str, Any]:
    """The engine's gate: the per-device plan for its exact geometry (the
    engine passes its real page count as ``num_pages``), raising
    :class:`InfeasiblePlanError` when ``hbm_bytes`` is given and cannot hold
    it. ``hbm_bytes=None`` plans against :func:`card_hbm_bytes` of
    ``device`` without enforcing; the plan still lands in
    ``stats()["mesh"]``."""
    cfg = model if isinstance(model, ModelConfig) else get_config(model)
    plan = tp_plan(cfg, max(1, tp), quantization=quantization, dtype=dtype,
                   max_batch=max_batch, max_seq_len=max_seq_len, page_size=page_size,
                   num_pages=num_pages,
                   hbm_bytes=hbm_bytes or card_hbm_bytes(device),
                   # the engine's pool replicates when tp does not divide the
                   # kv heads: budget what it allocates
                   kv_replicated=tp > 1 and cfg.num_kv_heads % tp != 0)
    plan["enforced"] = hbm_bytes is not None
    if hbm_bytes is not None and not plan["fits"]:
        raise InfeasiblePlanError(
            f"{plan['model']} @ tp={plan['tp']} quant={quantization} needs "
            f"{plan['total_bytes_per_device']} bytes/device "
            f"(params {plan['param_bytes_per_device']} + KV "
            f"{plan['kv_bytes_per_device']} + activations "
            f"{plan['activation_bytes_estimate']}) > HBM budget {hbm_bytes} "
            f"({plan['hbm_utilization']:.2f}x the budget); "
            "raise tp, quantize, or shrink max_batch/max_seq_len",
            plan={k: v for k, v in plan.items() if k not in ("leaves", "read_plan")})
    return plan


def tp_plan(
    model: "str | ModelConfig",
    tp: int,
    *,
    quantization: str = "none",
    dtype=torch.bfloat16,
    max_batch: int = 8,
    max_seq_len: int = 8192,
    page_size: int = 64,
    hbm_bytes: int = H100_HBM_BYTES,
    num_pages: Optional[int] = None,
    kv_replicated: bool = False,
) -> dict[str, Any]:
    """Per-device byte budget and per-shard read plan for ``model`` at tp=N
    (JAX ``tp_plan``): every leaf's shard shape from its spec, the KV pool
    ``[L, pages, page, heads, D]`` (pages: ``num_pages`` or a full window a
    slot plus scratch), a coarse activation estimate for one prefill bucket
    of :data:`_PREFILL_BUCKET` tokens, and the verdict against ``hbm_bytes``.
    JAX's ``ep`` (an expert-parallel axis) has no counterpart: the port's
    serving mesh is tensor-parallel only."""
    cfg = model if isinstance(model, ModelConfig) else get_config(model)
    if cfg.num_kv_heads % tp and tp % cfg.num_kv_heads:
        raise ValueError(
            f"{cfg.name}: num_kv_heads={cfg.num_kv_heads} and tp={tp} divide "
            "neither way — the KV cache cannot shard")
    leaves = []
    param_bytes_device = param_bytes_total = rank0_bytes = 0
    for path, shape, dt, spec in _leaves(cfg, dtype, quantization):
        shard = _shard_shape(shape, spec, tp, path)
        size = _itemsize(dt)
        per_dev = math.prod(shard) * size
        leaves.append({"leaf": path, "shape": list(shape), "dtype": _dtype_name(dt),
                       "spec": str(spec), "shard_shape": list(shard),
                       "bytes_per_device": per_dev})
        param_bytes_device += per_dev
        param_bytes_total += math.prod(shape) * size
        if rank0_only(path):
            rank0_bytes += per_dev

    pages = num_pages if num_pages is not None \
        else max_batch * (-(-max_seq_len // page_size)) + 1
    kv_heads_dev = cfg.num_kv_heads if kv_replicated else max(1, cfg.num_kv_heads // tp)
    kv_bytes_device = (2 * cfg.num_layers * pages * page_size * kv_heads_dev
                       * cfg.head_dim * _itemsize(dtype))
    # activation high-water estimate for one prefill bucket (JAX's, coarse
    # over on purpose)
    act_bytes = int(_PREFILL_BUCKET * cfg.hidden_size * 2 * 8)
    total_device = param_bytes_device + kv_bytes_device + act_bytes
    return {
        "model": cfg.name, "tp": tp, "quantization": quantization,
        "dtype": _dtype_name(dtype), "max_batch": max_batch,
        "max_seq_len": max_seq_len, "page_size": page_size,
        "param_bytes_total": param_bytes_total,
        "param_bytes_per_device": param_bytes_device,
        # what each rank of the port holds: rank 0 the per-device figure,
        # the others all but the leaves only rank 0 reads
        "param_bytes_per_rank": [param_bytes_device] + [param_bytes_device - rank0_bytes]
        * (tp - 1),
        "kv_bytes_per_device": kv_bytes_device,
        "activation_bytes_estimate": act_bytes,
        "total_bytes_per_device": total_device,
        "hbm_bytes": hbm_bytes,
        "hbm_utilization": round(total_device / hbm_bytes, 4),
        "fits": total_device < hbm_bytes,
        "leaves": leaves,
        "read_plan": _read_plan(cfg, tp),
    }


def _read_plan(cfg: ModelConfig, tp: int) -> list[dict]:
    """Per-shard safetensors read plan (JAX ``_read_plan`` at ep=1): for each
    HF tensor, the axis each tp rank slices and the per-rank extent along
    it; every rank reads every expert."""
    specs = llama_param_specs(cfg)
    shapes = {name: shape for name, shape in _leaf_shapes(cfg).items()}
    shapes.update({"embed": (cfg.vocab_size, cfg.hidden_size),
                   "final_norm": (cfg.hidden_size,),
                   "lm_head": (cfg.hidden_size, cfg.vocab_size)})
    plan = []
    for leaf, (tmpl, transpose) in _LLAMA_MAP.items():
        if leaf == "lm_head" and cfg.tie_embeddings:
            continue
        if leaf in ("bq", "bk", "bv") and not cfg.attention_bias:
            continue
        if leaf.startswith("moe") or leaf == "router":
            if cfg.num_experts == 0:
                continue
        elif leaf in ("gate", "up", "down") and cfg.num_experts > 0:
            continue
        spec = specs[leaf if leaf in ("embed", "final_norm", "lm_head") else f"layers.{leaf}"]
        entry: dict[str, Any] = {"tensor": tmpl}
        if "{e}" in tmpl:
            entry["experts_per_rank"] = cfg.num_experts
            entry["ep_ranks"] = 1
        ours = [i for i, s in enumerate(spec) if s == "tp"]
        if not ours:
            entry["sharded"] = False
            plan.append(entry)
            continue
        (axis,) = ours
        # our axes → HF axes: the stacked L (and E) axes vanish, transpose
        # swaps the matrix axes
        mat_rank = 1 if leaf in ("bq", "bk", "bv", "final_norm") else 2
        mat_axis = axis - (len(spec) - mat_rank)
        hf_axis = (mat_rank - 1 - mat_axis) if transpose else mat_axis
        mat_dims = tuple(shapes[leaf][-mat_rank:])
        hf_dims = tuple(reversed(mat_dims)) if transpose else mat_dims
        entry.update({"sharded": True, "hf_slice_axis": int(hf_axis),
                      "hf_shape": list(hf_dims),
                      "per_rank_extent": int(hf_dims[hf_axis]) // tp, "ranks": tp})
        plan.append(entry)
    return plan


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--model", default="llama-3-70b")
    ap.add_argument("--tp", type=int, default=8)
    ap.add_argument("--quant", default="int8")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq-len", type=int, default=8192)
    ap.add_argument("--hbm-bytes", type=int, default=H100_HBM_BYTES,
                    help="per-device budget (default: an H100's 80 GB)")
    ap.add_argument("--full", action="store_true", help="include the per-leaf table")
    args = ap.parse_args(argv)
    report = tp_plan(args.model, args.tp, quantization=args.quant,
                     max_batch=args.max_batch, max_seq_len=args.max_seq_len,
                     hbm_bytes=args.hbm_bytes)
    if not args.full:
        report = {k: v for k, v in report.items() if k != "leaves"}
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
