"""Time the flash kernel's precision variants on the card and count their misses.

    python -m cyberfabric_core_tpu_torch.ops.flash_sweep

Builds ``ops/csrc/flash_attention.cu`` once per variant (all at once, into
``build/kernels/sweep/``):

- ``3 terms``: what the port loads, P as three bf16 terms that sum to it
  exactly, every product chained in the tensor cores;
- ``1 term``: P rounded once to bf16 (``-DFLASH_P_TERMS=1``), as the JAX
  kernel computes (``p.astype(v.dtype)``).

For each it prints the static instruction mix of the kernel's main loop
(``cuobjdump -sass``), counts the output elements beyond one bf16 ulp of the
float64 plain version and those that differ from it at all, and checks that
rows past the length are zeros, at the flash shapes of ``chip_smoke.py`` and
of the card tests, and at the main-path shape (llama-3-8b heads, B=2,
T=2048, lengths [1300, 1500]); then it prints each variant's device time at
the main shape (CUDA-graph replay), in turns (v1, v2, .., v2, v1) so that a
drift of the card's clock shows. The library the port loads keeps its
compiled-in default; this script only measures the choice. Needs one CUDA
card and ``nvcc``.
"""

from __future__ import annotations

import collections
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from . import _build
from . import flash_attention as fa
from .timing import graph_ms

VARIANTS = {"3 terms": (), "1 term": ("-DFLASH_P_TERMS=1",)}
#: (T, Hq, Hkv, lengths, window): chip_smoke.py's small shapes, then the card
#: tests' edges, then the main-path shape (last)
SHAPES = [
    (200, 4, 4, [200, 1], None), (130, 8, 4, [77, 130], 33), (64, 8, 2, [64, 40], None),
    (300, 32, 4, [299, 150], 100), (97, 32, 8, [1, 96], 16),
    (100, 32, 8, [71, 100], None), (256, 8, 2, [256, 200], 7), (160, 16, 4, [150, 1], None),
    (2048, 32, 8, [1300, 1500], None),
]


def loop_mix(lib: Path) -> str:
    """The static instruction mix of the kernel's main loop: the shortest
    body of a backward branch that holds both products' wgmma (HGMMA 64x64
    and 64x128), from ``cuobjdump -sass`` of the library. Both of the
    softmax's forms (masked, unmasked) lie in it; a tile runs one."""
    tool = Path(_build._nvcc()).with_name("cuobjdump")
    try:
        sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"main loop not measured ({type(exc).__name__})"
    ins = [(int(a, 16), t) for a, t in re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = [(int(dst, 16), a) for a, t in ins
             for dst in re.findall(r"BRA\s+0x([0-9a-f]+)", t) if int(dst, 16) < a]
    loops = [(lo, hi) for lo, hi in loops
             if all(any(k in t for a, t in ins if lo <= a <= hi) for k in ("64x64x", "64x128x"))]
    if not loops:
        return "main loop not found"
    lo, hi = min(loops, key=lambda r: r[1] - r[0])
    ops = collections.Counter(re.sub(r"^@!?U?P\w+\s+", "", t).split()[0]
                              for a, t in ins if lo <= a <= hi)
    return (f"main loop {sum(ops.values())} instructions a warp (static): "
            + ", ".join(f"{k} {n}" for k, n in ops.most_common(14)))


def build_variants(variants: dict[str, tuple]) -> dict[str, ctypes.CDLL]:
    """{name: nvcc flags} → {name: library}, all built at once."""
    src = _build.CSRC / "flash_attention.cu"
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    paths = {name: out_dir / f"flash_attention-{i}.so" for i, name in enumerate(variants)}
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, *flags, "-o", str(paths[name]), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, flags in variants.items()}
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"flash_sweep {name}: ptxas {' | '.join(regs)}; {loop_mix(paths[name])}",
              flush=True)
        lib = ctypes.CDLL(str(paths[name]))
        lib.flash_self_attention_bf16.argtypes = fa._lib().flash_self_attention_bf16.argtypes
        lib.flash_self_attention_bf16.restype = ctypes.c_int
        libs[name] = lib
    return libs


def misses(out: torch.Tensor, ref: torch.Tensor) -> tuple[int, int]:
    """Elements of ``out`` beyond chip_smoke.py's bar (one bf16 ulp of ref's
    magnitude, plus 1e-6) from ``ref``, non-finite ones included; and those
    that differ from ``ref`` at all (both are bf16: a difference within the
    bar is a final rounding that fell the other way)."""
    o, r = out.float(), ref.float()
    bar = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -20))) - 7) + 1e-6
    return int((~((o - r).abs() <= bar)).sum()), int((o != r).sum())


def run(libs: dict[str, ctypes.CDLL]) -> None:
    """Checks and times each library in ``libs`` in place of the port's."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    cases = []
    for T, Hq, Hkv, lengths, window in SHAPES:
        q, k, v = (torch.randn((len(lengths), T, h, 128), generator=gen, device=dev)
                   .to(torch.bfloat16) for h in (Hq, Hkv, Hkv))
        lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
        ref = fa.flash_self_attention_plain(q, k, v, lens, sliding_window=window)
        cases.append(((q, k, v, lens, window), ref, lengths))

    default_lib = fa._lib
    times: dict[str, list[float]] = {}
    try:
        for name in libs:
            fa._lib = lambda name=name: libs[name]
            found = []
            for (q, k, v, lens, window), ref, lengths in cases:
                out = fa.flash_self_attention(q, k, v, lens, sliding_window=window)
                if any(bool((out[b, L:] != 0).any()) for b, L in enumerate(lengths)):
                    raise AssertionError(f"{name}: rows past the length are not zero")
                found.append(misses(out, ref))
            print(f"flash_sweep {name}: elements beyond one bf16 ulp of the plain version "
                  f"{found[-1][0]} of {cases[-1][1].numel()} at the main shape ({found[-1][1]} "
                  f"differ at all); at the small shapes (beyond, differ) "
                  f"{dict(zip(map(str, SHAPES[:-1]), found[:-1]))}", flush=True)
        (q, k, v, lens, _), _, _ = cases[-1]
        for name in list(libs) + list(reversed(libs)):
            fa._lib = lambda name=name: libs[name]
            times.setdefault(name, []).append(graph_ms(lambda: fa.flash_self_attention(q, k, v,
                                                                                        lens)))
    finally:
        fa._lib = default_lib
    for name, ms in times.items():
        print(f"flash_sweep {name}: main shape device ms {ms} (in turns)", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_sweep: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    run(build_variants(VARIANTS))
    return 0


if __name__ == "__main__":
    sys.exit(main())
