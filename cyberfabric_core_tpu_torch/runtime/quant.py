"""Weight-only quantization, int8 (W8) and int4 (W4) (the port's copy of
``runtime/quant.py``).

Symmetric per-output-channel scales over the contraction axis (-2): for a
weight ``w [..., in, out]``, ``s = max(absmax_in(w) / qmax, 1e-12)`` in f32
and ``q = clip(round(w / s), -qmax, qmax)`` with qmax 127 (int8) or 7
(int4); ``round`` is half to even, as ``jnp.round`` is. The embedding table
stays int8 even at 4 bits, with one scale per ROW (``qe``, ``se``: a gather
then a rescale). Norms, the MoE router and the qwen2 q/k/v biases stay
unquantized.

How a quantized leaf lives in a :class:`..models.llama.LlamaModel`: a small
module per leaf, so the leaf keeps its name and the tree its layout.

- :class:`QuantWeight` holds the buffers ``q`` (int8) and ``s`` (f32
  ``[..., out]``); a layer's ``wq`` becomes ``layers.<i>.wq.q`` and
  ``layers.<i>.wq.s`` in the ``state_dict``, the head ``lm_head.q`` /
  ``lm_head.s``. At 4 bits ``q`` packs two values a byte along the
  contraction axis (``[..., in/2, out]``: row 2j in the low nibble,
  row 2j+1 in the high one), so the card holds W4's bytes; torch has no
  int4 dtype a product takes. :meth:`QuantWeight.values` unpacks with torch
  ops only (mask, xor, subtract: a sign extension), so a CUDA graph can
  capture it: nothing is read back to the host.
- :class:`QuantEmbed` holds ``qe`` (int8 ``[V, H]``) and ``se`` (f32
  ``[V]``): ``embed.qe`` / ``embed.se``.

Buffers carry no gradient. The forwards (:mod:`..models.llama`) convert
``q`` to the activation dtype inside each product (exact for |q| ≤ 127 in
bf16), accumulate in f32, multiply the f32 product by ``s`` and only then
round, where the JAX einsums do.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional, Union

import torch
from torch import nn

#: layer leaves that are matmul weights (contraction on axis -2)
_MATMUL_LEAVES = {"wq", "wk", "wv", "wo", "gate", "up", "down",
                  "moe_gate", "moe_up", "moe_down"}

_QMAX = {8: 127, 4: 7}


def quant_bits(quantization: str) -> Optional[int]:
    """``EngineConfig.quantization`` → bit width (None = unquantized);
    an unknown string raises instead of serving bf16."""
    table = {"none": None, "": None, "int8": 8, "int4": 4}
    if quantization not in table:
        raise ValueError(f"unknown quantization {quantization!r} "
                         f"(supported: {sorted(k for k in table if k)})")
    return table[quantization]


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 values (int8 tensor, each in [-8, 7]) ``[..., in, out]`` → bytes
    ``[..., in/2, out]``, two values a byte along axis -2 (row 2j low
    nibble, row 2j+1 high nibble). Every contraction length of the registry
    is even; an odd one raises."""
    if q.shape[-2] % 2:
        raise ValueError(f"int4 packing needs an even contraction length, got {q.shape[-2]}")
    u = q.to(torch.int16) & 15
    pairs = u.reshape(*q.shape[:-2], q.shape[-2] // 2, 2, q.shape[-1])
    packed = pairs[..., 0, :] | (pairs[..., 1, :] << 4)       # 0 .. 255
    return (packed - ((packed & 128) << 1)).to(torch.int8)   # as a signed byte


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: int8 values ``[..., 2·rows, out]``.
    Torch ops only, no host read."""
    lo = ((packed & 15) ^ 8) - 8
    hi = (((packed >> 4) & 15) ^ 8) - 8
    return torch.stack([lo, hi], dim=-2).reshape(*packed.shape[:-2], -1, packed.shape[-1])


class QuantWeight(nn.Module):
    """One quantized matmul leaf: ``q`` (int8; packed at 4 bits) and ``s``
    (f32 ``[..., out]``)."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, bits: int) -> None:
        super().__init__()
        if bits not in _QMAX:
            raise ValueError(f"bits must be 8 or 4, got {bits}")
        self.bits = bits
        self.register_buffer("q", q)
        self.register_buffer("s", s)

    def values(self) -> torch.Tensor:
        """The int8 values ``[..., in, out]`` (unpacked at 4 bits)."""
        return self.q if self.bits == 8 else unpack_int4(self.q)

    def dequantize(self, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
        return (self.values().float() * self.s[..., None, :]).to(dtype)

    def extra_repr(self) -> str:
        return f"int{self.bits}, out={self.s.shape[-1]}"


class QuantEmbed(nn.Module):
    """The int8 embedding table with one scale per row: ``qe [V, H]``,
    ``se [V]``."""

    def __init__(self, qe: torch.Tensor, se: torch.Tensor) -> None:
        super().__init__()
        self.register_buffer("qe", qe)
        self.register_buffer("se", se)

    def lookup(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        ids = ids.long()
        return (self.qe[ids].float() * self.se[ids][..., None]).to(dtype)


QuantLeaf = Union[QuantWeight, QuantEmbed]


def quantize_weight(w: torch.Tensor, bits: int = 8) -> QuantWeight:
    """Symmetric per-output-channel intN over axis -2. One f32 transient
    the size of ``w`` (worked on in place)."""
    qmax = _QMAX[bits]
    wf = w.to(torch.float32, copy=True)
    scale = torch.clamp_min(wf.abs().amax(dim=-2, keepdim=True) / qmax, 1e-12)
    q = wf.div_(scale).round_().clamp_(-qmax, qmax).to(torch.int8)
    del wf
    return QuantWeight(q if bits == 8 else pack_int4(q), scale[..., 0, :], bits)


def quantize_embed(embed: torch.Tensor) -> QuantEmbed:
    """Embedding rows: int8 with per-ROW scales."""
    ef = embed.to(torch.float32, copy=True)
    scale = torch.clamp_min(ef.abs().amax(dim=-1, keepdim=True) / 127.0, 1e-12)
    qe = ef.div_(scale).round_().clamp_(-127, 127).to(torch.int8)
    return QuantEmbed(qe, scale[:, 0])


def quantize_leaf(name: str, t: torch.Tensor, bits: int) -> Union[torch.Tensor, QuantLeaf]:
    """A tree leaf by its name: matmul leaves and the head → intN, the
    embedding → int8 rows, anything else unchanged."""
    if name == "embed":
        return quantize_embed(t)
    if name in _MATMUL_LEAVES or name == "lm_head":
        return quantize_weight(t, bits)
    return t


def is_quantized(params: Any) -> bool:
    """Whether a :class:`LlamaModel` (or a state_dict) holds quantized
    leaves."""
    if isinstance(params, Mapping):
        return "embed.qe" in params
    return isinstance(getattr(params, "embed", None), QuantEmbed)


def quantize_llama_params(params: Any, bits: int = 8) -> Any:
    """Quantize every matmul weight, the head and the embedding of a
    :class:`LlamaModel` (returned as a new model on the same device; the
    original's unquantized tensors are not kept), norms and the router
    unchanged."""
    from ..models.llama import LlamaModel, _leaf_shapes

    if not isinstance(params, LlamaModel):
        raise TypeError(f"quantize_llama_params takes a LlamaModel, got {type(params)}")
    cfg = params.cfg
    layers = [{name: quantize_leaf(name, getattr(lp, name), bits) for name in _leaf_shapes(cfg)}
              for lp in params.layers]
    return LlamaModel(cfg, quantize_embed(params.embed), params.final_norm, layers,
                      quantize_weight(params.lm_head, bits) if params.lm_head is not None
                      else None)


def init_params_quantized(cfg, seed: int = 0, dtype=torch.bfloat16, bits: int = 8,
                          device=None):
    """Random weights drawn as :func:`..models.llama.init_params` draws them
    (the same generator, the same order) and quantized leaf by leaf as each
    is drawn: peak memory is the intN tree plus one layer's leaf and its f32
    transient, so mixtral-8x7b initialises int8 on one 80 GB card. Equal to
    ``quantize_llama_params(init_params(cfg, seed, dtype))``."""
    from ..models.llama import init_params

    return init_params(cfg, seed, dtype, device, quant_bits=bits)


def quantized_bytes(params: Any) -> int:
    """Bytes of every tensor (parameters and buffers) of a model, or of a
    state_dict's tensors."""
    if isinstance(params, Mapping):
        tensors = list(params.values())
    else:
        tensors = list(params.parameters()) + list(params.buffers())
    return sum(t.numel() * t.element_size() for t in tensors)
