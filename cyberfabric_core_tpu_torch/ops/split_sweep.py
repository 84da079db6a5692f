"""Time the paged decode kernel at several split sizes on the card.

    python -m cyberfabric_core_tpu_torch.ops.split_sweep [--pages 1 2 4 8]

Builds ``ops/csrc/paged_attention.cu`` once per split size (``-D
PAGED_SPLIT_PAGES=S``, all at once, into ``build/kernels/sweep/``), checks
each build against the plain version at the main-path decode shape of
``chip_smoke.py`` (llama-3-8b heads, 8 rows at lengths 128..2048, 64-token
pages) and at its mixed-round ragged shape, and prints the device time of
each (CUDA-graph replay), in turns (S1, S2, .., S2, S1) so that a drift of
the card's clock shows. The library the port loads keeps its compiled-in
default; this script only measures the choice. Needs one CUDA card and
``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from . import _build
from . import paged_attention as pa
from .timing import graph_ms


def build_variants(pages: list[int]) -> dict[int, ctypes.CDLL]:
    src = _build.CSRC / "paged_attention.cu"
    out_dir = _build.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {S: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, f"-DPAGED_SPLIT_PAGES={S}",
         "-o", str(out_dir / f"paged_attention-S{S}.so"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for S in pages}
    libs = {}
    for S, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {S} pages per split:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"paged_attention-S{S}.so"))
        for name, argtypes in pa._LIB_SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        libs[S] = lib
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pages", type=int, nargs="+", default=[1, 2, 4, 8])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("split_sweep: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    libs = build_variants(args.pages)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    B, Hq, Hkv, D, page, Pmax, n_pages = 8, 32, 8, 128, 64, 32, 321
    k = torch.randn((n_pages, page, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((n_pages, page, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    rng = np.random.default_rng(2)
    pt = torch.from_numpy((rng.permutation(n_pages - 1)[: B * Pmax] + 1)
                          .reshape(B, Pmax).astype(np.int32)).to(dev)
    lens = torch.tensor([128, 384, 640, 896, 1152, 1408, 1664, 2048],
                        dtype=torch.int32, device=dev)
    q1 = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    q = torch.randn((B, 512, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    hist = torch.tensor([1024, 383, 639, 895, 0, 1407, 1663, 2047],
                        dtype=torch.int32, device=dev)
    q_lens = torch.tensor([512, 1, 1, 1, 0, 1, 1, 1], dtype=torch.int32, device=dev)

    calls = {
        "decode": (lambda: pa.paged_decode_attention(q1, k, v, pt, lens),
                   lambda: pa.paged_decode_attention_plain(q1, k, v, pt, lens)),
        "ragged": (lambda: pa.ragged_paged_attention(q, k, v, pt, hist, q_lens),
                   lambda: pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens)),
    }
    default_lib = pa._lib
    refs = {name: plain() for name, (_, plain) in calls.items()}
    times: dict[tuple[str, int], list[float]] = {}
    try:
        order = list(args.pages) + list(reversed(args.pages))
        for S in order:
            pa._lib = lambda S=S: libs[S]
            for name, (kern, _) in calls.items():
                out = kern()
                err = (out.float() - refs[name].float()).abs()
                ulp = torch.exp2(torch.floor(torch.log2(
                    refs[name].float().abs().clamp_min(2.0 ** -20))) - 7)
                if bool((err > ulp + 1e-6).any()):
                    raise AssertionError(f"{name} at {S} pages per split misses one bf16 ulp")
                times.setdefault((name, S), []).append(graph_ms(kern))
    finally:
        pa._lib = default_lib
    for (name, S), ms in sorted(times.items()):
        print(f"split_sweep {name} pages_per_split={S} ms={ms} "
              f"(within one bf16 ulp of the plain version)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
