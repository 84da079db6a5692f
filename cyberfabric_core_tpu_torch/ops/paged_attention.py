"""Paged attention over a page pool: ragged mixed-batch and decode.

Counterpart of ``cyberfabric_core_tpu/ops/paged_attention.py``, with the same
signatures and layouts:

- :func:`ragged_paged_attention` — row b's span of ``q_lens[b]`` queries sits
  at positions ``hist[b] .. hist[b]+q_len-1`` and attends causally over the
  row's page chain, which already holds the span's own K/V. Rows past q_len
  are exactly 0. Replaces the Pallas kernel ``ragged_paged_attention`` (:421).
- :func:`paged_decode_attention` — one query per row over ``lengths[b]`` keys
  (the current token included). Replaces ``paged_decode_attention`` (:188).

Each wrapper launches the hand-written Hopper kernels of
``ops/csrc/paged_attention.cu`` for CUDA tensors, and runs its plain PyTorch
version (``*_plain``) only for CPU tensors. There is no fallback from the
kernel to the plain version. Each wrapper counts its calls that launch the
kernels in its ``launches`` attribute. On the card the kernels take the head
dims of the model registry (:data:`HEAD_DIMS`), up to 8 query heads per kv
head, and bf16 (the tensor-core kernels) or f32 (a CUDA-core kernel, f32
throughout) inputs; the wrappers raise on anything else.

On the card, decode is split-KV: each row's keys are cut every
:func:`split_pages` pages from key 0, one block per (row, kv head, split)
writes a partial softmax to scratch, and a second kernel merges the
partials in split order. The ragged entry sends every position of a span
of at most :data:`SHORT_SPAN` tokens through that same decode path (so
ragged q_len=1 is bitwise equal to decode, and each such position to
decoding its token alone) and longer spans through a tensor-core kernel.

The plain versions walk the pages in order with the kernels' per-page
online-softmax update (scores scaled after the dot, -1e30 mask, floored
correction, denominator floored at 1e-30), accumulating in float64: they
are the reference the kernels are held to within one bf16 ulp, and an f32
reference's own rounding would approach that bar at near-zero outputs. They
do not copy the splits or the tensor-core path. Every query row's arithmetic
is independent of the rows beside it, so a ragged row with q_len=1 is
bitwise equal to the decode row.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_NEG_INF = -1e30
#: the head dims the CUDA kernels are built for (those of models/configs.py)
HEAD_DIMS = (16, 64, 96, 128, 256)
_DTYPES = (torch.bfloat16, torch.float32)
_MAX_PAGE = 64      # the CUDA kernel's largest page
_MAX_GROUP = 8      # the CUDA kernel's most query heads per kv head
#: ragged spans of at most this many positions take the decode (split-KV)
#: path on the card; longer spans the tensor-core chunk path
SHORT_SPAN = 8


# ---------------------------------------------------------------- plain versions
def _online_softmax_pages(qrows: torch.Tensor, q_abs: torch.Tensor,
                          valid: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, page_table: torch.Tensor,
                          sliding_window: Optional[int]) -> torch.Tensor:
    """qrows [B, Hkv, R, D] (any float dtype), q_abs/valid [B, R] → float64
    [B, Hkv, R, D]. Pages are walked in order; a page no query of a row can
    see is an exact no-op of the update (correction 1, zero mass), so walking
    every page up to the last one any row needs gives each row the value it
    has alone."""
    B, Hkv, R, D = qrows.shape
    page = k_pool.shape[1]
    Pmax = page_table.shape[1]
    dev = qrows.device
    f64 = torch.float64
    scale = 1.0 / D ** 0.5
    q = qrows.to(f64)
    q_abs = q_abs.long()
    m = torch.full((B, Hkv, R), _NEG_INF, dtype=f64, device=dev)
    l = torch.zeros((B, Hkv, R), dtype=f64, device=dev)
    acc = torch.zeros((B, Hkv, R, D), dtype=f64, device=dev)
    last = int(torch.where(valid, q_abs, -1).max()) if valid.numel() else -1
    n_pages = min(last // page + 1, Pmax) if last >= 0 else 0
    k_off = torch.arange(page, device=dev)
    for j in range(n_pages):
        pid = page_table[:, j].long()
        k = k_pool[pid].to(f64).permute(0, 2, 1, 3)    # [B, Hkv, page, D]
        v = v_pool[pid].to(f64).permute(0, 2, 1, 3)
        kpos = j * page + k_off                        # [page]
        mask = valid[:, :, None] & (kpos[None, None, :] <= q_abs[:, :, None])
        if sliding_window is not None:
            mask = mask & (kpos[None, None, :] > q_abs[:, :, None] - sliding_window)
        for h in range(Hkv):  # one kv head at a time bounds the temporaries
            # elementwise product + sum over D: each row's reduction is the
            # same whatever the row count (a GEMM's blocking is not)
            s = (q[:, h, :, None, :] * k[:, h, None, :, :]).sum(-1) * scale
            s = torch.where(mask, s, _NEG_INF)         # [B, R, page]
            m_prev = m[:, h]
            m_new = torch.maximum(m_prev, s.amax(-1))
            corr = torch.where(m_new > _NEG_INF * 0.5, torch.exp(m_prev - m_new),
                               torch.zeros_like(m_new))
            p = torch.where(mask, torch.exp(s - m_new[..., None]),
                            torch.zeros_like(s))
            l[:, h] = l[:, h] * corr + p.sum(-1)
            pv = (p[..., None] * v[:, h, None, :, :]).sum(-2)   # [B, R, D]
            acc[:, h] = acc[:, h] * corr[..., None] + pv
            m[:, h] = m_new
    return acc / torch.clamp_min(l, 1e-30)[..., None]


def paged_decode_attention_plain(q, k_pool, v_pool, page_table, lengths,
                                 sliding_window: Optional[int] = None):
    """Plain PyTorch version of :func:`paged_decode_attention`."""
    B, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    G = Hq // Hkv
    qrows = q.reshape(B, Hkv, G, D)                    # head-major h = kv*G + g
    q_abs = (lengths.long() - 1)[:, None].expand(B, G)
    valid = torch.ones((B, G), dtype=torch.bool, device=q.device)
    out = _online_softmax_pages(qrows, q_abs, valid, k_pool, v_pool,
                                page_table, sliding_window)
    return out.reshape(B, Hq, D).to(q.dtype)


def ragged_paged_attention_plain(q, k_pool, v_pool, page_table, hist, q_lens,
                                 sliding_window: Optional[int] = None):
    """Plain PyTorch version of :func:`ragged_paged_attention`."""
    B, Qmax, Hq, D = q.shape
    Hkv = k_pool.shape[2]
    G = Hq // Hkv
    # rows r = g*Qmax + qi inside each kv head (head-major, as the kernels)
    qrows = q.permute(0, 2, 1, 3).reshape(B, Hkv, G * Qmax, D)
    qi = torch.arange(Qmax, device=q.device).repeat(G)            # [R]
    q_abs = hist.long()[:, None] + qi[None, :]
    valid = qi[None, :] < q_lens.long()[:, None]
    out = _online_softmax_pages(qrows, q_abs, valid, k_pool, v_pool,
                                page_table, sliding_window)
    return out.reshape(B, Hq, Qmax, D).permute(0, 2, 1, 3).contiguous().to(q.dtype)


def paged_gather_dense(k_pool: torch.Tensor, v_pool: torch.Tensor,
                       page_table: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Reference helper: each row's paged KV as a dense cache
    [B, Pmax*page, Hkv, D] (tests and the dense oracle only)."""
    pid = page_table.long()
    k = k_pool[pid]                                    # [B, Pmax, page, Hkv, D]
    v = v_pool[pid]
    B, Pmax, page, Hkv, D = k.shape
    return (k.reshape(B, Pmax * page, Hkv, D), v.reshape(B, Pmax * page, Hkv, D))


# ---------------------------------------------------------------- CUDA launches
_LIB_SIGNATURES = {
    "ragged_paged_attention_bf16": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    "paged_decode_attention_bf16": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    "ragged_paged_attention_f32": [ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
    + [ctypes.c_float, ctypes.c_void_p],
    "paged_decode_attention_f32": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    "paged_attention_split_pages": [],
    "paged_attention_short_span": [],
}


@functools.cache
def _lib():
    """The kernel library with its entry points' C signatures set (once)."""
    from ._build import load_library

    lib = load_library("paged_attention")
    for name, argtypes in _LIB_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    if lib.paged_attention_short_span() != SHORT_SPAN:
        raise RuntimeError(f"the kernel library routes spans of up to "
                           f"{lib.paged_attention_short_span()} positions to the "
                           f"decode path, this module expects {SHORT_SPAN}")
    return lib


def split_pages() -> int:
    """Pages per split of the card's decode path (a constant of the kernel
    library, so it needs the library built)."""
    return _lib().paged_attention_split_pages()


def _scratch(items: int, Hkv: int, G: int, Pmax: int, D: int, dev) -> torch.Tensor:
    """f32 scratch of the bf16 decode path's partials: (m, l, acc[D]) for
    each (item, kv head, split, head)."""
    n_split = -(-Pmax // split_pages())
    return torch.empty(items * Hkv * n_split * G * (D + 2),
                       dtype=torch.float32, device=dev)


def check_kernel_supports(head_dim: int, num_heads: int, num_kv_heads: int,
                          dtype: torch.dtype, page: int) -> None:
    """Raise ValueError naming what the CUDA kernels do not take (an engine
    checks its model here once, before any request reaches a kernel)."""
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA paged kernels take bfloat16 or float32, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the CUDA paged kernels take head_dim in {HEAD_DIMS}, "
                         f"got {head_dim}")
    if page > _MAX_PAGE:
        raise ValueError(f"page size {page} exceeds the kernel's {_MAX_PAGE}")
    if num_heads % num_kv_heads or num_heads // num_kv_heads > _MAX_GROUP:
        raise ValueError(f"{num_heads} query heads over {num_kv_heads} kv heads: the CUDA "
                         f"kernels take groups of at most {_MAX_GROUP}")


def _check_cuda_inputs(q, k_pool, v_pool, tables) -> None:
    dev = q.device
    for name, t in (("q", q), ("k_pool", k_pool), ("v_pool", v_pool)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q is on {dev}")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"q and the pools must all be bfloat16 or all float32 for "
                            f"the CUDA kernels, got {name} {t.dtype} with q {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    for name, t in tables.items():
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor on {dev}")
    if k_pool.shape != v_pool.shape or k_pool.dim() != 4:
        raise ValueError(f"pools must match and be [N, page, Hkv, D], got "
                         f"{tuple(k_pool.shape)} / {tuple(v_pool.shape)}")
    _, page, Hkv, D = k_pool.shape
    if q.shape[-1] != D:
        raise ValueError(f"q has head_dim {q.shape[-1]}, the pools {D}")
    check_kernel_supports(D, q.shape[-2], Hkv, q.dtype, page)


def _window_arg(sliding_window: Optional[int]) -> int:
    if sliding_window is None:
        return 0
    if sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    return int(sliding_window)


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with cudaError {rc}")


def paged_decode_attention(
    q: torch.Tensor,           # [B, Hq, D] — one query token per row
    k_pool: torch.Tensor,      # [N, page, Hkv, D] — one layer's page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, Pmax] int32 physical page ids
    lengths: torch.Tensor,     # [B] int32 valid kv length (incl. current token)
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, Hq, D] attention over each row's paged history."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, page_table,
                                            lengths, sliding_window)
    if q.device.type != "cuda":
        raise RuntimeError(f"paged_decode_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k_pool, v_pool,
                       {"page_table": page_table, "lengths": lengths})
    B, Hq, D = q.shape
    N, page, Hkv, _ = k_pool.shape
    Pmax = page_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    window, scale = _window_arg(sliding_window), 1.0 / D ** 0.5
    if q.dtype == torch.float32:
        rc = _lib().paged_decode_attention_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            lengths.data_ptr(), out.data_ptr(), B, Hq, Hkv, N, page, Pmax, D, window,
            scale, stream)
    else:
        scratch = _scratch(B, Hkv, Hq // Hkv, Pmax, D, q.device)
        rc = _lib().paged_decode_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, Hq, Hkv, N, page, Pmax, D, window, scale, stream)
    _raise_on(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


def ragged_paged_attention(
    q: torch.Tensor,           # [B, Qmax, Hq, D] — per-row query span, padded
    k_pool: torch.Tensor,      # [N, page, Hkv, D] — one layer's page pool
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # [B, Pmax] int32 physical page ids
    hist: torch.Tensor,        # [B] int32 kv tokens BEFORE the span
    q_lens: torch.Tensor,      # [B] int32 span length (0 = idle row)
    q_block: int = 8,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, Qmax, Hq, D]; positions past a row's q_len are zeros. The
    span's own K/V must already be in the pool. ``q_block`` is the JAX
    kernel's block of span positions (Qmax must be a multiple of it); the
    CUDA kernels tile by their own fixed sizes."""
    B, Qmax, Hq, D = q.shape
    if Qmax % q_block:
        raise ValueError(f"Qmax {Qmax} must be a multiple of q_block {q_block}")
    if q.device.type == "cpu":
        return ragged_paged_attention_plain(q, k_pool, v_pool, page_table, hist,
                                            q_lens, sliding_window)
    if q.device.type != "cuda":
        raise RuntimeError(f"ragged_paged_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k_pool, v_pool, {"page_table": page_table,
                                           "hist": hist, "q_lens": q_lens})
    N, page, Hkv, _ = k_pool.shape
    Pmax = page_table.shape[1]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    window, scale = _window_arg(sliding_window), 1.0 / D ** 0.5
    if q.dtype == torch.float32:
        rc = _lib().ragged_paged_attention_f32(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), page_table.data_ptr(),
            hist.data_ptr(), q_lens.data_ptr(), out.data_ptr(), B, Qmax, Hq, Hkv, N, page,
            Pmax, D, window, scale, stream)
    else:
        scratch = _scratch(B * min(Qmax, SHORT_SPAN), Hkv, Hq // Hkv, Pmax, D, q.device)
        rc = _lib().ragged_paged_attention_bf16(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            page_table.data_ptr(), hist.data_ptr(), q_lens.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, Qmax, Hq, Hkv, N, page, Pmax, D, window, scale, stream)
    _raise_on(rc, "ragged_paged_attention")
    ragged_paged_attention.launches += 1
    return out


ragged_paged_attention.launches = 0
