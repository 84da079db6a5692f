"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface, loaded with ``ctypes``. Libraries land in
``build/kernels/`` at the repository root, named by a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so a changed source or
header rebuilds and an unchanged one is reused. All sources compile in
parallel (one ``nvcc`` each, started together). The build runs at first
use, never at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "from ops/csrc at first use and need the CUDA toolkit")


def _target(src: Path) -> Path:
    """The library path for ``src``, keyed by the source, every shared header
    of ``csrc/`` (any source may include any of them) and the flags."""
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Compile every stale source, all at once. Returns {stem: library path}
    and writes each compiler log (registers, spills) next to its library."""
    sources = sorted(CSRC.glob("*.cu"))
    targets = {src.stem: _target(src) for src in sources}
    todo = [src for src in sources if not targets[src.stem].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in todo:
        tmp = targets[src.stem].with_suffix(f".{os.getpid()}.tmp")
        procs.append((src, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        targets[src.stem].with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{log}")
            continue
        os.replace(tmp, targets[src.stem])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return targets


def load_library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu`` (built on first use)."""
    with _lock:
        lib = _libs.get(stem)
        if lib is None:
            lib = ctypes.CDLL(str(build_all()[stem]))
            _libs[stem] = lib
        return lib
