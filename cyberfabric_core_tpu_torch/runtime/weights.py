"""Parameter loading and conversion (counterpart of ``runtime/weights.py``).

:func:`load_llama_params` reads a HF llama-family safetensors checkpoint
(llama, qwen2 with its q/k/v bias, gemma, mixtral's experts) into the port's
``state_dict``, and :func:`save_llama_params` writes one back in the HF
layout. The format is read and written here (:class:`SafetensorsIndex`): an
8-byte little-endian header length, a JSON header of name → dtype, shape and
byte offsets, then the raw bytes; the port needs no ``safetensors`` package.
F32, F16 and BF16 tensors are read; another dtype or a missing tensor
raises.

:func:`params_from_jax` turns the JAX package's parameter tree — handed over
as numpy arrays, so this module never touches JAX — into the same
``state_dict``: the stacked ``[L, ...]`` layer leaves are unstacked into
``layers.<i>.<name>``. Both packages keep weight matrices ``[in, out]``, so no
transpose is needed and both compute the same function.

Quantized trees (:mod:`.quant`): ``load_llama_params(..., quantize=True,
quant_bits=8|4)`` quantizes each tensor as it is loaded, on the device, so
the peak is the intN tree plus one tensor; its ``state_dict`` names a
matmul leaf's buffers ``<leaf>.q`` / ``<leaf>.s`` and the embedding's
``embed.qe`` / ``embed.se``, and at 4 bits ``q`` is packed two values a
byte along the contraction axis. :func:`params_from_jax` carries the JAX
package's ``{"q", "s"}`` / ``{"qe", "se"}`` leaves across, packing its
``int4`` arrays. A quantized tree cannot be saved as a HF checkpoint:
:func:`save_llama_params` raises, as the JAX function does.

The bert encoder has the same three: :func:`load_bert_params` (HF
``BertModel`` names, with or without the ``bert.`` prefix of a wrapping
head), :func:`save_bert_params` and :func:`bert_params_from_jax`.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Mapping, Optional, Union

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, same_device
from ..models import bert
from ..models.configs import ModelConfig
from ..models.llama import LlamaModel, _leaf_shapes, check_supported
from .quant import (_MATMUL_LEAVES, QuantEmbed, QuantWeight, is_quantized, pack_int4,
                    quantize_leaf)

# state_dict leaf → (HF name template, transpose?); {i} = layer, {e} = expert
_LLAMA_MAP: dict[str, tuple[str, bool]] = {
    "embed": ("model.embed_tokens.weight", False),
    "final_norm": ("model.norm.weight", False),
    "lm_head": ("lm_head.weight", True),
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", False),
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", True),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", True),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", True),
    # qwen2-family attention biases (only when cfg.attention_bias)
    "bq": ("model.layers.{i}.self_attn.q_proj.bias", False),
    "bk": ("model.layers.{i}.self_attn.k_proj.bias", False),
    "bv": ("model.layers.{i}.self_attn.v_proj.bias", False),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", True),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", False),
    "gate": ("model.layers.{i}.mlp.gate_proj.weight", True),
    "up": ("model.layers.{i}.mlp.up_proj.weight", True),
    "down": ("model.layers.{i}.mlp.down_proj.weight", True),
    # mixtral-family MoE (only when cfg.num_experts > 0): HF w1 = gate [I, H],
    # w3 = up [I, H], w2 = down [H, I]; the router gate is [E, H]
    "router": ("model.layers.{i}.block_sparse_moe.gate.weight", True),
    "moe_gate": ("model.layers.{i}.block_sparse_moe.experts.{e}.w1.weight", True),
    "moe_up": ("model.layers.{i}.block_sparse_moe.experts.{e}.w3.weight", True),
    "moe_down": ("model.layers.{i}.block_sparse_moe.experts.{e}.w2.weight", True),
}

# bert state_dict leaf → (HF BertModel name template, transpose?); {i} = layer
_BERT_MAP: dict[str, tuple[str, bool]] = {
    "word_embed": ("embeddings.word_embeddings.weight", False),
    "pos_embed": ("embeddings.position_embeddings.weight", False),
    "type_embed": ("embeddings.token_type_embeddings.weight", False),
    "embed_ln_w": ("embeddings.LayerNorm.weight", False),
    "embed_ln_b": ("embeddings.LayerNorm.bias", False),
    "wq": ("encoder.layer.{i}.attention.self.query.weight", True),
    "bq": ("encoder.layer.{i}.attention.self.query.bias", False),
    "wk": ("encoder.layer.{i}.attention.self.key.weight", True),
    "bk": ("encoder.layer.{i}.attention.self.key.bias", False),
    "wv": ("encoder.layer.{i}.attention.self.value.weight", True),
    "bv": ("encoder.layer.{i}.attention.self.value.bias", False),
    "wo": ("encoder.layer.{i}.attention.output.dense.weight", True),
    "bo": ("encoder.layer.{i}.attention.output.dense.bias", False),
    "attn_ln_w": ("encoder.layer.{i}.attention.output.LayerNorm.weight", False),
    "attn_ln_b": ("encoder.layer.{i}.attention.output.LayerNorm.bias", False),
    "ffn_in": ("encoder.layer.{i}.intermediate.dense.weight", True),
    "ffn_in_b": ("encoder.layer.{i}.intermediate.dense.bias", False),
    "ffn_out": ("encoder.layer.{i}.output.dense.weight", True),
    "ffn_out_b": ("encoder.layer.{i}.output.dense.bias", False),
    "ffn_ln_w": ("encoder.layer.{i}.output.LayerNorm.weight", False),
    "ffn_ln_b": ("encoder.layer.{i}.output.LayerNorm.bias", False),
}

_DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16}
_DTYPE_NAMES = {v: k for k, v in _DTYPES.items()}

PathLike = Union[str, Path]


class SafetensorsIndex:
    """Tensor name → file across one checkpoint directory's safetensors
    files (sharded through ``model.safetensors.index.json``, or every
    ``*.safetensors`` file)."""

    def __init__(self, model_dir: PathLike) -> None:
        self.model_dir = Path(model_dir)
        self.name_to_file: dict[str, Path] = {}
        self._headers: dict[Path, tuple[dict, int]] = {}
        index_file = self.model_dir / "model.safetensors.index.json"
        if index_file.exists():
            for name, fname in json.loads(index_file.read_text())["weight_map"].items():
                self.name_to_file[name] = self.model_dir / fname
        else:
            for f in sorted(self.model_dir.glob("*.safetensors")):
                for name in self._header(f)[0]:
                    self.name_to_file[name] = f

    def _header(self, f: Path) -> tuple[dict, int]:
        """(tensor entries, byte offset of the data) of one file."""
        if f not in self._headers:
            with open(f, "rb") as fh:
                (n,) = struct.unpack("<Q", fh.read(8))
                header = json.loads(fh.read(n))
            header.pop("__metadata__", None)
            self._headers[f] = (header, 8 + n)
        return self._headers[f]

    def has(self, name: str) -> bool:
        return name in self.name_to_file

    def load(self, name: str) -> torch.Tensor:
        """One tensor as a CPU tensor of its stored dtype."""
        f = self.name_to_file.get(name)
        if f is None:
            raise KeyError(f"tensor {name!r} not found in {self.model_dir}")
        header, base = self._header(f)
        meta = header[name]
        dtype = _DTYPES.get(meta["dtype"])
        if dtype is None:
            raise ValueError(f"tensor {name!r} has dtype {meta['dtype']}; the loader "
                             f"reads {sorted(_DTYPES)}")
        start, end = meta["data_offsets"]
        shape = tuple(meta["shape"])
        itemsize = torch.empty((), dtype=dtype).element_size()
        if end - start != int(np.prod(shape, dtype=np.int64)) * itemsize:
            raise ValueError(f"tensor {name!r}: {end - start} bytes for shape {shape} "
                             f"of {meta['dtype']}")
        with open(f, "rb") as fh:
            fh.seek(base + start)
            buf = bytearray(fh.read(end - start))  # writable, as frombuffer wants
        if not buf:
            return torch.empty(shape, dtype=dtype)
        # safetensors is little-endian, as the hosts this runs on are
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)


    def slice_array(self, name: str, axis: int, lo: int, hi: int) -> np.ndarray:
        """Rows (``axis`` 0) or columns (``axis`` 1, a 2-D tensor) ``lo ..
        hi-1`` of one tensor, read through a memory map, so only the pages
        holding the slice leave the disk. BF16 comes back as its raw
        ``uint16`` bits (numpy has no bfloat16)."""
        f = self.name_to_file.get(name)
        if f is None:
            raise KeyError(f"tensor {name!r} not found in {self.model_dir}")
        header, base = self._header(f)
        meta = header[name]
        np_dtype = {"F32": np.float32, "F16": np.float16, "BF16": np.uint16}.get(meta["dtype"])
        if np_dtype is None:
            raise ValueError(f"tensor {name!r} has dtype {meta['dtype']}")
        shape = tuple(meta["shape"])
        arr = np.memmap(f, dtype=np_dtype, mode="r", offset=base + meta["data_offsets"][0],
                        shape=shape)
        index = (slice(lo, hi),) if axis == 0 else (slice(None), slice(lo, hi))
        return np.array(arr[index])


def write_safetensors(tensors: Mapping[str, torch.Tensor], path: PathLike) -> Path:
    """Write ``tensors`` (CPU, F32 / F16 / BF16) as one safetensors file."""
    header, offset, blobs = {}, 0, []
    for name in sorted(tensors):
        t = tensors[name].detach().contiguous().cpu()
        data = t.reshape(-1).view(torch.uint8).numpy().tobytes() if t.numel() else b""
        header[name] = {"dtype": _DTYPE_NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + len(data)]}
        offset += len(data)
        blobs.append(data)
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)  # the data starts 8-byte aligned
    path = Path(path)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<Q", len(raw)))
        fh.write(raw)
        for data in blobs:
            fh.write(data)
    return path


def _wanted(leaf: str, cfg: ModelConfig) -> bool:
    if leaf in ("bq", "bk", "bv"):
        return cfg.attention_bias
    if leaf in ("router", "moe_gate", "moe_up", "moe_down"):
        return cfg.num_experts > 0
    if leaf in ("gate", "up", "down"):
        return cfg.num_experts == 0
    return True


def load_llama_params(model_dir: PathLike, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                      device: DeviceLike = None, quantize: bool = False,
                      quant_bits: int = 8) -> dict[str, torch.Tensor]:
    """A HF llama-family checkpoint → the port's state_dict on ``device`` in
    ``dtype`` (default the CUDA device): HF ``[out, in]`` matrices
    transposed to ``[in, out]``, the qwen2 q/k/v bias when the config has
    one, no ``lm_head`` for tied configs, and per layer the expert stacks
    ``[E, ...]`` of a MoE config. ``quantize``: each matmul leaf, the head
    and the embedding are quantized (``quant_bits`` 8 or 4; the embedding
    int8 rows) as they load, after the cast to ``dtype``, as the JAX loader
    does."""
    check_supported(cfg)
    dev = resolve_device(device)
    idx = SafetensorsIndex(model_dir)

    def put(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        t = t.t() if transpose else t
        return t.to(device=dev, dtype=dtype).contiguous()

    out: dict[str, torch.Tensor] = {}

    def store(key: str, leaf: str, t: torch.Tensor) -> None:
        if quantize and (leaf in _MATMUL_LEAVES or leaf in ("embed", "lm_head")):
            for buf, value in quantize_leaf(leaf, t, quant_bits).state_dict().items():
                out[f"{key}.{buf}"] = value
        else:
            out[key] = t

    for leaf, (tmpl, transpose) in _LLAMA_MAP.items():
        if not _wanted(leaf, cfg):
            continue
        if leaf == "lm_head":
            if not cfg.tie_embeddings:
                store(leaf, leaf, put(idx.load(tmpl), transpose))
        elif "{i}" not in tmpl:
            store(leaf, leaf, put(idx.load(tmpl), transpose))
        else:
            for i in range(cfg.num_layers):
                if "{e}" in tmpl:
                    t = torch.stack([put(idx.load(tmpl.format(i=i, e=e)), transpose)
                                     for e in range(cfg.num_experts)])
                else:
                    t = put(idx.load(tmpl.format(i=i)), transpose)
                store(f"layers.{i}.{leaf}", leaf, t)
    return out


def save_llama_params(params: Union[LlamaModel, Mapping[str, torch.Tensor]],
                      cfg: ModelConfig, out_dir: PathLike) -> Path:
    """Write a state_dict (or a :class:`LlamaModel`) as a HF-layout
    ``model.safetensors`` in f32: every tensor of the checkpoint the loader
    reads, the experts fanned out per expert. A quantized tree raises
    ``ValueError``."""
    if is_quantized(params):
        raise ValueError("cannot save a quantized param tree to HF safetensors layout; "
                         "save the fp tree, or dequantize first (runtime/quant.py)")
    state = params.state_dict() if isinstance(params, LlamaModel) else params
    tensors: dict[str, torch.Tensor] = {}

    def hf(t: torch.Tensor, transpose: bool) -> torch.Tensor:
        t = t.detach().float().cpu()
        return (t.t() if transpose else t).contiguous()

    for leaf, (tmpl, transpose) in _LLAMA_MAP.items():
        if "{i}" not in tmpl:
            if leaf in state:
                tensors[tmpl] = hf(state[leaf], transpose)
            continue
        for i in range(cfg.num_layers):
            key = f"layers.{i}.{leaf}"
            if key not in state:
                continue
            if "{e}" in tmpl:
                for e in range(cfg.num_experts):
                    tensors[tmpl.format(i=i, e=e)] = hf(state[key][e], transpose)
            else:
                tensors[tmpl.format(i=i)] = hf(state[key], transpose)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return write_safetensors(tensors, out_dir / "model.safetensors")


def params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX llama tree of numpy arrays → the port's state_dict (CPU tensors).

    Quantized leaves carry across: ``{"q", "s"}`` → ``<leaf>.q`` /
    ``<leaf>.s`` (an ``int4`` ``q`` packed two values a byte), ``{"qe",
    "se"}`` → ``embed.qe`` / ``embed.se``."""
    check_supported(cfg)

    def tensor(a: Any) -> torch.Tensor:
        return torch.from_numpy(np.array(a, copy=True))

    out: dict[str, torch.Tensor] = {}

    def put(key: str, a: Any) -> None:
        if not isinstance(a, Mapping):
            out[key] = tensor(a)
        elif "qe" in a:
            out[f"{key}.qe"], out[f"{key}.se"] = tensor(a["qe"]), tensor(a["se"])
        else:
            q = np.asarray(a["q"])
            values = torch.from_numpy(q.astype(np.int8))
            out[f"{key}.q"] = pack_int4(values) if str(q.dtype) == "int4" else values
            out[f"{key}.s"] = tensor(a["s"])

    for name in ("embed", "final_norm") + (() if cfg.tie_embeddings else ("lm_head",)):
        put(name, tree[name])
    layers = tree["layers"]
    for name in _leaf_shapes(cfg):
        stacked = layers[name]
        n = (stacked["q"] if isinstance(stacked, Mapping) else stacked).shape[0]
        if n != cfg.num_layers:
            raise ValueError(f"layer leaf {name!r} has {n} layers, config has "
                             f"{cfg.num_layers}")
        for i in range(cfg.num_layers):
            put(f"layers.{i}.{name}", {k: v[i] for k, v in stacked.items()}
                if isinstance(stacked, Mapping) else stacked[i])
    return out


def model_from_state_dict(state: Mapping[str, torch.Tensor], cfg: ModelConfig,
                          device: DeviceLike = None,
                          dtype: Optional[torch.dtype] = None) -> LlamaModel:
    """Build a :class:`LlamaModel` on ``device`` from a state_dict (float
    leaves cast to ``dtype`` when given; quantized leaves keep their int8
    values and f32 scales, a 4-bit leaf told by its packed row count)."""
    dev = resolve_device(device)

    def put(t: torch.Tensor) -> torch.Tensor:
        return t.to(device=dev, dtype=dtype or t.dtype)

    def leaf(key: str, rows: int):
        if f"{key}.qe" in state:
            return QuantEmbed(state[f"{key}.qe"].to(dev), state[f"{key}.se"].to(dev))
        if f"{key}.q" in state:
            q = state[f"{key}.q"].to(dev)
            return QuantWeight(q, state[f"{key}.s"].to(dev), 8 if q.shape[-2] == rows else 4)
        return put(state[key])

    shapes = _leaf_shapes(cfg)
    H = cfg.hidden_size
    layers = [{name: leaf(f"layers.{i}.{name}", shape[-2] if len(shape) > 1 else 0)
               for name, shape in shapes.items()} for i in range(cfg.num_layers)]
    has_head = "lm_head" in state or "lm_head.q" in state
    return LlamaModel(cfg, leaf("embed", 0), put(state["final_norm"]), layers,
                      leaf("lm_head", H) if has_head else None)


def params_on(params: LlamaModel, device: DeviceLike) -> LlamaModel:
    """``params`` itself when it lives on ``device``, else a copy there
    (through its state_dict; the original is untouched)."""
    dev = resolve_device(device)
    if same_device(params.device, dev):
        return params
    return model_from_state_dict(params.state_dict(), params.cfg, dev)


def load_bert_params(model_dir: PathLike, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
                     device: DeviceLike = None) -> dict[str, torch.Tensor]:
    """A HF bert-family checkpoint (``BertModel`` layout, bge-base-en et
    al.; a ``bert.`` prefix is detected and stripped) → the port's bert
    state_dict on ``device`` in ``dtype``, HF ``[out, in]`` matrices
    transposed to ``[in, out]``."""
    bert.check_supported(cfg)
    dev = resolve_device(device)
    idx = SafetensorsIndex(model_dir)
    prefix = "bert." if idx.has("bert.embeddings.word_embeddings.weight") else ""
    out: dict[str, torch.Tensor] = {}
    for leaf, (tmpl, transpose) in _BERT_MAP.items():
        names = ([(leaf, tmpl)] if "{i}" not in tmpl else
                 [(f"layers.{i}.{leaf}", tmpl.format(i=i)) for i in range(cfg.num_layers)])
        for key, name in names:
            t = idx.load(prefix + name)
            out[key] = (t.t() if transpose else t).to(device=dev, dtype=dtype).contiguous()
    return out


def save_bert_params(params: Union["bert.BertModel", Mapping[str, torch.Tensor]],
                     cfg: ModelConfig, out_dir: PathLike) -> Path:
    """Write a bert state_dict (or a :class:`models.bert.BertModel`) as a
    HF-layout ``model.safetensors`` in f32."""
    state = params.state_dict() if isinstance(params, bert.BertModel) else params
    tensors: dict[str, torch.Tensor] = {}
    for leaf, (tmpl, transpose) in _BERT_MAP.items():
        names = ([(leaf, tmpl)] if "{i}" not in tmpl else
                 [(f"layers.{i}.{leaf}", tmpl.format(i=i)) for i in range(cfg.num_layers)])
        for key, name in names:
            t = state[key].detach().float().cpu()
            tensors[name] = (t.t() if transpose else t).contiguous()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    return write_safetensors(tensors, out_dir / "model.safetensors")


def bert_params_from_jax(tree: Mapping[str, Any], cfg: ModelConfig) -> dict[str, torch.Tensor]:
    """JAX bert tree of numpy arrays → the port's bert state_dict (CPU
    tensors): the stacked ``[L, ...]`` layer leaves unstacked, no
    transposes."""
    bert.check_supported(cfg)
    top, layer = bert.leaf_shapes(cfg)
    out = {name: torch.from_numpy(np.array(tree[name], copy=True)) for name in top}
    for name in layer:
        stacked = tree["layers"][name]
        if stacked.shape[0] != cfg.num_layers:
            raise ValueError(f"layer leaf {name!r} has {stacked.shape[0]} layers, "
                             f"config has {cfg.num_layers}")
        for i in range(cfg.num_layers):
            out[f"layers.{i}.{name}"] = torch.from_numpy(np.array(stacked[i], copy=True))
    return out


def checkpoint_size_bytes(model_dir: PathLike) -> int:
    """Bytes of every safetensors file of a checkpoint directory."""
    return sum(f.stat().st_size for f in Path(model_dir).glob("*.safetensors"))
