"""Sharded checkpoint loading by the feasibility read plan (the port's copy
of ``runtime/shard_loader.py``).

:func:`..parallel.feasibility.tp_plan` says which slice of every HF tensor
each tp rank needs; :func:`execute_read_plan` reads exactly that: every
(tensor, rank) item reads only its rows or columns (a memory map of the
safetensors file, :meth:`.weights.SafetensorsIndex.slice_array`), items run
on a thread pool, each completed item is appended to a durable manifest, and
a load killed part way resumes from the manifest without reading completed
items again. Staged slices land as ``.npy`` files under ``stage_dir/rank<r>/``.

The JAX package reads through the ``safetensors`` package; the port uses its
own reader and writer (:mod:`.weights`), so it needs no such package.
"""

from __future__ import annotations

import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..models.configs import ModelConfig
from .weights import SafetensorsIndex, write_safetensors

__all__ = ["hf_tensor_shapes", "synthesize_hf_checkpoint", "expected_rank_bytes",
           "execute_read_plan", "staged_rank_bytes"]


def hf_tensor_shapes(cfg: ModelConfig) -> dict[str, tuple[int, ...]]:
    """HF llama checkpoint tensor name → shape (dense MLP family)."""
    H = cfg.hidden_size
    Dq = cfg.num_heads * cfg.head_dim
    Dkv = cfg.num_kv_heads * cfg.head_dim
    inter = cfg.intermediate_size
    V = cfg.vocab_size
    shapes: dict[str, tuple[int, ...]] = {
        "model.embed_tokens.weight": (V, H),
        "model.norm.weight": (H,),
    }
    if not cfg.tie_embeddings:
        shapes["lm_head.weight"] = (V, H)
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        shapes[p + "input_layernorm.weight"] = (H,)
        shapes[p + "post_attention_layernorm.weight"] = (H,)
        shapes[p + "self_attn.q_proj.weight"] = (Dq, H)
        shapes[p + "self_attn.k_proj.weight"] = (Dkv, H)
        shapes[p + "self_attn.v_proj.weight"] = (Dkv, H)
        shapes[p + "self_attn.o_proj.weight"] = (H, Dq)
        shapes[p + "mlp.gate_proj.weight"] = (inter, H)
        shapes[p + "mlp.up_proj.weight"] = (inter, H)
        shapes[p + "mlp.down_proj.weight"] = (H, inter)
    return shapes


def synthesize_hf_checkpoint(cfg: ModelConfig, out_dir: str | Path,
                             max_shard_bytes: int = 1 << 30,
                             seed: Optional[int] = None) -> Path:
    """Write a HF-style sharded checkpoint (``model-0000x-of-0000N.safetensors``
    and ``model.safetensors.index.json``) of fp16 tensors: zeros, as the JAX
    function writes, or seeded normal values when ``seed`` is given (so the
    ranks' slices differ)."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator().manual_seed(seed) if seed is not None else None
    shards: list[dict[str, torch.Tensor]] = [{}]
    sizes = [0]
    for name, shape in hf_tensor_shapes(cfg).items():
        nbytes = int(np.prod(shape)) * 2
        if sizes[-1] and sizes[-1] + nbytes > max_shard_bytes:
            shards.append({})
            sizes.append(0)
        shards[-1][name] = (torch.zeros(shape, dtype=torch.float16) if gen is None else
                            torch.randn(shape, generator=gen).to(torch.float16))
        sizes[-1] += nbytes
    n = len(shards)
    weight_map: dict[str, str] = {}
    for idx, tensors in enumerate(shards, start=1):
        fname = f"model-{idx:05d}-of-{n:05d}.safetensors"
        write_safetensors(tensors, out / fname)
        for name in tensors:
            weight_map[name] = fname
    (out / "model.safetensors.index.json").write_text(json.dumps({
        "metadata": {"total_size": sum(sizes)},
        "weight_map": weight_map,
    }))
    return out


def _expand_plan(plan: list[dict], num_layers: int) -> list[dict]:
    """Template entries ({i}) → one entry per concrete HF tensor."""
    out = []
    for entry in plan:
        tmpl = entry["tensor"]
        if "{i}" in tmpl:
            for i in range(num_layers):
                out.append({**entry, "tensor": tmpl.format(i=i)})
        else:
            out.append(entry)
    return out


def expected_rank_bytes(plan: list[dict], cfg: ModelConfig, tp: int,
                        itemsize: int = 2) -> int:
    """Bytes ONE tp rank must read under the plan: its slice of every
    sharded tensor plus each replicated tensor in full."""
    shapes = hf_tensor_shapes(cfg)
    total = 0
    for entry in _expand_plan(plan, cfg.num_layers):
        shape = shapes.get(entry["tensor"])
        if shape is None:
            continue  # bias / MoE entries absent from this family
        per = list(shape)
        if entry.get("sharded"):
            per[entry["hf_slice_axis"]] //= tp
        total += int(np.prod(per)) * itemsize
    return total


def execute_read_plan(
    model_dir: str | Path,
    plan: list[dict],
    cfg: ModelConfig,
    tp: int,
    stage_dir: str | Path,
    *,
    workers: int = 4,
    interrupt_after_items: Optional[int] = None,
) -> dict[str, Any]:
    """Run the per-rank sharded read: every (tensor, rank) item reads only
    that rank's slice, stages it under ``stage_dir/rank<r>/`` and appends a
    durable manifest line. A manifest from an earlier run resumes the load:
    its items are skipped without touching the checkpoint.

    ``interrupt_after_items``: end the PROCESS (``os._exit(41)``) after N
    completed items, the crash half of the resume rehearsal; the manifest
    written so far must survive it."""
    index = SafetensorsIndex(model_dir)
    stage = Path(stage_dir)
    stage.mkdir(parents=True, exist_ok=True)
    manifest_path = stage / "manifest.jsonl"
    done: set[tuple[str, int]] = set()
    if manifest_path.exists():
        for ln in manifest_path.read_text().splitlines():
            try:
                row = json.loads(ln)
                done.add((row["tensor"], row["rank"]))
            except ValueError:
                continue  # a line the crash cut short: that item runs again

    items = [{**entry, "rank": rank} for entry in _expand_plan(plan, cfg.num_layers)
             if index.has(entry["tensor"]) for rank in range(tp)]
    lock = threading.Lock()
    manifest_f = open(manifest_path, "a")
    state = {"bytes": 0, "items": 0, "skipped": 0, "rank_bytes": [0] * tp,
             "interrupted": False}
    for r in range(tp):
        (stage / f"rank{r}").mkdir(exist_ok=True)

    def run_item(item: dict) -> None:
        name, rank = item["tensor"], item["rank"]
        if (name, rank) in done:
            with lock:
                state["skipped"] += 1
            return
        if state["interrupted"]:
            return
        if item.get("sharded"):
            axis = item["hf_slice_axis"]
            per = item["hf_shape"][axis] // tp
            arr = index.slice_array(name, axis, rank * per, (rank + 1) * per)
        else:
            arr = index.slice_array(name, 0, 0, None)
        np.save(stage / f"rank{rank}" / (name + ".npy"), arr)
        with lock:
            state["bytes"] += arr.nbytes
            state["rank_bytes"][rank] += arr.nbytes
            state["items"] += 1
            manifest_f.write(json.dumps({"tensor": name, "rank": rank,
                                         "bytes": arr.nbytes}) + "\n")
            manifest_f.flush()
            os.fsync(manifest_f.fileno())
            if interrupt_after_items is not None and state["items"] >= interrupt_after_items:
                state["interrupted"] = True
                manifest_f.close()
                os._exit(41)  # the simulated crash: no cleanup, the manifest stands

    t0 = time.monotonic()
    try:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(run_item, items))
    finally:
        try:
            manifest_f.close()
        except ValueError:
            pass  # closed by the interrupt path
    wall = time.monotonic() - t0
    return {
        "items_total": len(items),
        "items_read": state["items"],
        "items_skipped_resume": state["skipped"],
        "bytes_read": state["bytes"],
        "rank_bytes_this_run": state["rank_bytes"],
        "seconds": round(wall, 2),
        "mb_per_s": round(state["bytes"] / max(wall, 1e-9) / 1e6, 1),
        "workers": workers,
    }


def staged_rank_bytes(stage_dir: str | Path, tp: int) -> list[int]:
    """Bytes landed per rank across every run (resumes included), to hold
    against :func:`expected_rank_bytes`."""
    out = []
    for r in range(tp):
        out.append(sum(np.load(p, mmap_mode="r").nbytes
                       for p in (Path(stage_dir) / f"rank{r}").glob("*.npy")))
    return out
