"""Device resolution: the port's counterpart of ``ops/platform.py``.

The JAX package picks Pallas interpret mode off-TPU. The port has no such
mode for its CUDA kernels, so it never falls back silently: an entry point
runs on the CUDA device unless the caller asks for the CPU explicitly, and
raises when no GPU is present and the CPU was not asked for.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` → ``cuda``; ``"cpu"`` → the CPU (plain PyTorch paths).

    Raises :class:`RuntimeError` when CUDA is requested (explicitly or by
    default) but no CUDA device is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the GPU by "
            "default — pass device='cpu' to run the plain PyTorch paths")
    if dev.type not in ("cuda", "cpu"):
        raise RuntimeError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev


def to_device(host, device: torch.device) -> torch.Tensor:
    """Copy a host array (numpy array, CPU tensor or list) to ``device``
    without blocking the host. On CUDA the bytes go through a pinned staging
    buffer of their own, so the caller may change its array at once and the
    copy waits for nothing queued before it; PyTorch's pinned allocator
    keeps the buffer until the copy has run. On the CPU this is a plain
    tensor view of ``host``."""
    t = host if isinstance(host, torch.Tensor) else torch.as_tensor(host)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
