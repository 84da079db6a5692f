"""Causal self-attention over a fresh prompt (prefill; no cache history).

Counterpart of ``cyberfabric_core_tpu/ops/flash_attention.py``, with the same
signature and the same ``[B, T, H, D]`` layout. :func:`flash_self_attention`
replaces the Pallas kernel ``flash_self_attention`` (:125, body
``_flash_kernel`` :45): query position t of row b attends keys s <= t with
s < ``lengths[b]`` (and s > t - window when windowed); GQA maps query head h
to kv head h // G.

The wrapper launches the hand-written Hopper kernel of
``ops/csrc/flash_attention.cu`` for CUDA tensors, and runs
:func:`flash_self_attention_plain` only for CPU tensors. There is no fallback
from the kernel to the plain version. Launches are counted in
``flash_self_attention.launches``. On the card the kernel takes the head
dims of the model registry (:data:`HEAD_DIMS`), 1 to 8 query heads per kv
head, and bf16 (the wgmma kernel) or f32 (a CUDA-core kernel, f32
throughout) inputs; the wrapper raises on anything else.

Query positions at or past ``lengths[b]`` come out as zeros in both versions
(the JAX kernel leaves them undefined).

The plain version walks key blocks of the JAX kernel's normalized size (the
``_block`` rule on T padded to 128) with the same per-block update: Q·K from
the input dtype, scale after the dot, -1e30 mask, p zeroed where masked,
``acc * exp(m_prev - m_new) + P·V``, denominator floored at 1e-30. A block
the JAX kernel skips is an exact no-op of that update for every row it
skips, so walking every block up to the last visible key gives the same
numbers. It accumulates in float64: it is the reference the kernel is held
to, and an f32 reference's own rounding (a few 1e-6 on outputs where O(1)
terms cancel) would exceed the check's bar at near-zero outputs.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

_NEG_INF = -1e30
_LANES = 128
#: the head dims the CUDA kernel is built for (those of models/configs.py)
HEAD_DIMS = (16, 64, 96, 128, 256)
_MAX_GROUP = 8                  # q heads per kv head the CUDA kernel takes, from 1
_DTYPES = (torch.bfloat16, torch.float32)


def _block(requested: int, Tp: int) -> int:
    """The JAX kernel's block normalization: a power of two, at most
    ``requested`` and ``Tp``, that divides ``Tp``."""
    b = 1
    while b * 2 <= min(requested, Tp):
        b *= 2
    while Tp % b:
        b //= 2
    return b


def flash_self_attention_plain(q, k, v, lengths, block_q: int = 256,
                               block_k: int = 512,
                               sliding_window: Optional[int] = None):
    """Plain PyTorch version of :func:`flash_self_attention`. ``block_q``
    only decides which key blocks the JAX kernel skips, which are no-ops of
    the update here, so only ``block_k`` shapes the arithmetic."""
    del block_q
    B, T, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    dev = q.device
    bk = _block(block_k, -(-T // _LANES) * _LANES)
    scale = 1.0 / D ** 0.5
    lens = lengths.long().clamp(max=T)
    f64 = torch.float64
    qh = q.to(f64).reshape(B, T, Hkv, G, D).permute(0, 2, 3, 1, 4)  # [B,Hkv,G,T,D]
    kh = k.to(f64).permute(0, 2, 1, 3)                              # [B,Hkv,T,D]
    vh = v.to(f64).permute(0, 2, 1, 3)
    qpos = torch.arange(T, device=dev)
    m = torch.full((B, Hkv, G, T), _NEG_INF, dtype=f64, device=dev)
    l = torch.zeros((B, Hkv, G, T), dtype=f64, device=dev)
    acc = torch.zeros((B, Hkv, G, T, D), dtype=f64, device=dev)
    last = int(lens.max()) if B else 0
    for k0 in range(0, last, bk):
        k1 = min(k0 + bk, T)
        kpos = torch.arange(k0, k1, device=dev)
        mask = (kpos[None, None, :] <= qpos[None, :, None]) \
            & (kpos[None, None, :] < lens[:, None, None])            # [B, T, bk]
        if sliding_window is not None:
            mask = mask & (kpos[None, None, :] > qpos[None, :, None] - sliding_window)
        mask = mask[:, None, None]                                   # [B,1,1,T,bk]
        s = torch.matmul(qh, kh[:, :, None, k0:k1].transpose(-1, -2)) * scale
        s = torch.where(mask, s, _NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.where(mask, torch.exp(s - m_new[..., None]), torch.zeros_like(s))
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.matmul(p, vh[:, :, None, k0:k1])
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    out = torch.where((qpos[None, :] < lens[:, None])[:, None, None, :, None], out,
                      torch.zeros_like(out))
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, Hq, D).to(q.dtype)


# ---------------------------------------------------------------- CUDA launch
@functools.cache
def _lib():
    from ._build import load_library

    lib = load_library("flash_attention")
    for fn in (lib.flash_self_attention_bf16, lib.flash_self_attention_f32):
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def check_kernel_supports(head_dim: int, num_heads: int, num_kv_heads: int,
                          dtype: torch.dtype) -> None:
    """Raise ValueError naming what the CUDA kernel does not take (an engine
    checks its model here once, before any prompt reaches the kernel)."""
    if dtype not in _DTYPES:
        raise ValueError(f"the CUDA flash kernel takes bfloat16 or float32, got {dtype}")
    if head_dim not in HEAD_DIMS:
        raise ValueError(f"the CUDA flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {head_dim}")
    if num_heads % num_kv_heads or num_heads // num_kv_heads > _MAX_GROUP:
        raise ValueError(f"the CUDA flash kernel takes 1 to {_MAX_GROUP} query heads per "
                         f"kv head, got Hq {num_heads} over Hkv {num_kv_heads}")


def _check_cuda_inputs(q, k, v, lengths) -> None:
    dev = q.device
    B, T, Hq, D = q.shape
    if k.shape != v.shape or k.dim() != 4 or k.shape[:2] != (B, T) or k.shape[3] != D:
        raise ValueError(f"k/v must be [B, T, Hkv, D] matching q {tuple(q.shape)}, "
                         f"got {tuple(k.shape)} / {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, q is on {dev}")
        check_kernel_supports(D, Hq, k.shape[2], t.dtype)
        if t.dtype != q.dtype:
            raise ValueError(f"q, k and v must share a dtype, got {name} {t.dtype} "
                             f"with q {q.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if lengths.device != dev or lengths.dtype != torch.int32 \
            or not lengths.is_contiguous() or lengths.shape != (B,):
        raise ValueError(f"lengths must be a contiguous [B] int32 tensor on {dev}")


def flash_self_attention(
    q: torch.Tensor,        # [B, T, Hq, D]
    k: torch.Tensor,        # [B, T, Hkv, D]
    v: torch.Tensor,        # [B, T, Hkv, D]
    lengths: torch.Tensor,  # [B] int32 valid lengths
    block_q: int = 256,
    block_k: int = 512,
    sliding_window: Optional[int] = None,
) -> torch.Tensor:
    """Returns [B, T, Hq, D]; positions at or past ``lengths[b]`` are zeros.
    ``block_q``/``block_k`` are the JAX kernel's block requests: they shape
    the plain version's walk; the CUDA kernel tiles by its own fixed sizes."""
    if q.device.type == "cpu":
        return flash_self_attention_plain(q, k, v, lengths, block_q, block_k,
                                          sliding_window)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash_self_attention: unsupported device {q.device}")
    _check_cuda_inputs(q, k, v, lengths)
    if sliding_window is not None and sliding_window <= 0:
        raise ValueError(f"sliding_window must be positive, got {sliding_window}")
    B, T, Hq, D = q.shape
    out = torch.empty_like(q)
    launch = (_lib().flash_self_attention_f32 if q.dtype == torch.float32
              else _lib().flash_self_attention_bf16)
    rc = launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        B, T, Hq, k.shape[2], D, int(sliding_window or 0), 1.0 / D ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream)
    if rc < 0:
        raise RuntimeError(f"flash_self_attention: a TMA tensor map could not be made "
                           f"(CUresult {-rc})")
    if rc != 0:
        raise RuntimeError(f"flash_self_attention: kernel launch failed with "
                           f"cudaError {rc}")
    flash_self_attention.launches += 1
    return out


flash_self_attention.launches = 0


def flash_available() -> bool:
    """True where the CUDA kernel runs: a CUDA device is present."""
    return torch.cuda.is_available()
