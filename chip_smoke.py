"""GPU smoke run of the PyTorch/CUDA port (``cyberfabric_core_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and ``nvcc``;
exits non-zero without printing a result when there is no card. Phases, each
fatal on failure:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build the CUDA kernels from ``cyberfabric_core_tpu_torch/ops/csrc``, all
   sources at once;
3. kernels: each kernel held against its plain PyTorch version on the card,
   at small shapes (window, idle rows, shared pages, GQA groups, rows of
   length 1; decode lengths on both sides of split boundaries, windows that
   empty whole splits) and at the llama-3-8b main-path shapes in bf16;
   ragged at q_len=1 bitwise equal to decode, every position of a span of
   up to SHORT_SPAN tokens bitwise equal to decoding it alone, a prompt-chunk
   row's bits independent of where its span starts; flash rows past the
   length exactly zero; device times (CUDA-graph replay) of each kernel and
   of PyTorch SDPA calls over dense inputs prepared outside the timed call
   (yardsticks only, never used by the port: masked SDPA, and for flash
   also ``is_causal``; the faster is ``library_ms``), CUDA-event times of
   the plain version, beside each kernel's bound, with the kernels' blocks,
   splits or walked tiles and achieved rates;
4. serving, three runs of ``ContinuousBatchingEngine`` at llama-3-8b full
   width (random weights from a seed, built once and shared), each from
   quickstart-shaped ``engine_options`` as the llm-gateway worker maps them:
   (a) mixed batching (the default path), 8 requests from 3 threads;
   (b) phase-separated (``mixed_batch`` off, ``prefill_coalesce`` 4), the
   same 8 requests; (c) dense mode (``prefix_cache_pages`` 0), 4 greedy
   requests. Every stream gets one terminal event with the right reason, the
   path's kernels were launched (and, phase-separated, the ragged kernel
   never), no page leaks, and every greedy token lies within a bf16 margin
   of the max of the dense forward's logits (teacher-forced);
5. a ``{"kernels": [...]}`` line, then ``{"ok": true, "device": {...}}`` last.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops import _build
from cyberfabric_core_tpu_torch.ops import flash_attention as fa
from cyberfabric_core_tpu_torch.ops import paged_attention as pa
from cyberfabric_core_tpu_torch.ops.timing import graph_ms
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.tokenizer import ByteTokenizer

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
KERNELS = {  # name → (source, the TPU kernel it replaces, wrapper)
    "ragged_paged_attention": ("cyberfabric_core_tpu_torch/ops/csrc/paged_attention.cu",
                               "cyberfabric_core_tpu/ops/paged_attention.py:421",
                               pa.ragged_paged_attention),
    "paged_decode_attention": ("cyberfabric_core_tpu_torch/ops/csrc/paged_attention.cu",
                               "cyberfabric_core_tpu/ops/paged_attention.py:188",
                               pa.paged_decode_attention),
    "flash_self_attention": ("cyberfabric_core_tpu_torch/ops/csrc/flash_attention.cu",
                             "cyberfabric_core_tpu/ops/flash_attention.py:125",
                             fa.flash_self_attention),
}
#: dense-oracle margin: a greedy token's dense logit may sit this far below
#: the dense row's max. The paged path and the dense oracle round bf16
#: activations at different points over 32 layers; at V = 128k near-ties
#: within that rounding are real, so exact argmax equality is not required.
#: The margin sits above the worst gap a sound run reads and below most rows'
#: top-1/top-2 gap, so the runner-up token fails it at most rows; the serving
#: phase prints both readings and fails if the runner-up passes at too many.
LOGIT_MARGIN = 0.1
#: least share of greedy rows at which the dense runner-up token would fail
#: the margin (the oracle's power to see a wrong token)
MIN_RUNNER_UP_CAUGHT = 0.5


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------------ helpers
def bf16_ulp_close(out: torch.Tensor, ref: torch.Tensor) -> float:
    """Max |out - ref|; raises unless every element is within one bf16 ulp
    of ref's magnitude (the two differ only in f32 summation order before
    the final bf16 rounding)."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(2.0 ** -20))) - 7)
    bad = int((err > ulp + 1e-6).sum())
    if bad or not torch.isfinite(o).all():
        raise AssertionError(f"{bad} elements beyond one bf16 ulp "
                             f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """CUDA-event time per call of ``iters`` back-to-back calls. Where the
    host enqueues a call more slowly than the card runs it, this reads the
    host's rate, not the card's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn, iters: int = 50) -> float:
    """Host wall time per call to enqueue ``iters`` calls (no sync inside)."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    ms = (time.perf_counter() - t) / iters * 1e3
    torch.cuda.synchronize()
    return ms


def device_breakdown(fn, iters: int = 20) -> str:
    """Device time per call of each CUDA kernel ``fn`` launches, from a
    torch.profiler window (informational)."""
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key.split("::")[-1].split("(")[0] if "::" in e.key else e.key[:40],
                 e.device_time_total / iters / 1e3)
                for e in prof.key_averages() if e.device_time_total > 0]
    except Exception as exc:  # the breakdown is information, not a gate
        return f"not measured ({type(exc).__name__}: {exc})"
    return ", ".join(f"{k} {v:.4f} ms" for k, v in sorted(rows, key=lambda r: -r[1]))


def make_pools(gen, N, page, Hkv, D, dev):
    k = torch.randn((N, page, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    v = torch.randn((N, page, Hkv, D), generator=gen, device=dev).to(torch.bfloat16)
    return k, v


def make_table(B, Pmax, N, seed, dev, share=False):
    rng = np.random.default_rng(seed)
    pt = (rng.permutation(N - 1)[: B * Pmax] + 1).reshape(B, Pmax).astype(np.int32)
    if share:
        pt[1, :2] = pt[0, :2]  # prefix pages shared by rows 0 and 1
    return torch.from_numpy(pt).to(dev)


def i32(xs, dev):
    return torch.tensor(xs, dtype=torch.int32, device=dev)


def bound(nbytes, flops):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the bf16 tensor-core rate, in ms."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / BF16_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def paged_geometry(Hq, Hkv, page, Pmax, B, Qmax, split_rows, chunks) -> dict:
    """What the paged kernels launch for one call of B rows, from its inputs
    as the kernels read them (no window). ``split_rows``: for each row that
    takes the decode path, the key counts of its positions (a decode row's
    length; each position of a short ragged span); ``chunks``: the (hist,
    q_len) of ragged rows longer than SHORT_SPAN, None for decode (Qmax 1).
    Blocks launched per kernel, the blocks that load K/V, the decode path's
    (position, split) partials, and the chunk path's tensor-core operations
    (64x64 tiles walked, Q.K once and P.V three times)."""
    S, G = pa.split_pages(), Hq // Hkv
    P = 64 // G

    def n_split(L):
        return -(-min(L, Pmax * page) // (S * page))

    geo = {"split_blocks": B * Hkv * -(-Pmax // S),
           "split_working": sum(max(map(n_split, row)) for row in split_rows) * Hkv,
           "partials": sum(n_split(L) for row in split_rows for L in row) * Hkv,
           "combine_blocks": B * Hkv}
    if chunks is not None:
        tiles = sum((h + min(ql, t + P) - 1) // 64 + 1
                    for h, ql in chunks for t in range(0, ql, P))
        geo.update(chunk_blocks=-(-Qmax // P) * Hkv * B,
                   chunk_working=sum(-(-ql // P) for _, ql in chunks) * Hkv,
                   chunk_tiles=tiles * Hkv,
                   chunk_tc_flops=tiles * Hkv * 64 * 64 * 128 * 2 * 4)
    return geo


def time_kernel(name, kern, plain, libs, nbytes, flops, err) -> dict:
    """Times of the kernel and of each library yardstick in ``libs`` ({label:
    call}) on the card (CUDA-graph replay: device time, no host gaps) and of
    the plain version (CUDA events), beside the bound; also back-to-back event
    times, the host's enqueue time per call and the device time of each
    kernel the wrapper launches. ``library_ms`` is the fastest yardstick.
    These launches are not the main path's: the serving phases reset the
    counters before they run."""
    ms = graph_ms(kern)
    plain_ms = cuda_ms(plain, 3, warmup=1)
    lib_ms = {label: graph_ms(lib) for label, lib in libs.items()}
    library_ms = min(lib_ms.values())
    b_ms, b_by = bound(nbytes, flops)
    log(f"kernel {name} main shapes: ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"max_abs_err={err:.3e} (tolerance: one bf16 ulp of the plain value)")
    log(f"kernel {name} library yardsticks (device ms): "
        + ", ".join(f"{label} {t:.4f}" for label, t in lib_ms.items()))
    first_lib = next(iter(libs.values()))
    log(f"kernel {name} main shapes, back-to-back calls: events {cuda_ms(kern, 50):.4f} "
        f"ms a call (library {cuda_ms(first_lib, 50):.4f}), host enqueue {host_ms(kern):.4f} ms "
        f"a call; device time by kernel: {device_breakdown(kern)}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=library_ms)


# ------------------------------------------------------------------ kernel phase
def ragged_one(q1, k, v, pt, lens, window):
    """Each row's decode query as a ragged span of one token at lens-1."""
    B, Hq, D = q1.shape
    qr = torch.zeros((B, 8, Hq, D), dtype=torch.bfloat16, device=q1.device)
    qr[:, 0] = q1
    ones = torch.ones(B, dtype=torch.int32, device=q1.device)
    return pa.ragged_paged_attention(qr, k, v, pt, lens - 1, ones,
                                     sliding_window=window)[:, 0]


def kernel_small_shapes(dev, gen) -> None:
    """Window, idle rows, shared pages, G=2 and G=4, page 16 and 64."""
    for Hq, Hkv, page, Pmax, window in [(4, 2, 16, 6, None), (8, 2, 16, 6, 21),
                                        (32, 8, 64, 4, None)]:
        B, D = 4, 128
        N = B * Pmax + 2
        k, v = make_pools(gen, N, page, Hkv, D, dev)
        pt = make_table(B, Pmax, N, 1, dev, share=True)
        lens = i32([0, 17, Pmax * page, 5], dev)  # row 0 inactive (length 0)
        q1 = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        dec = pa.paged_decode_attention(q1, k, v, pt, lens, sliding_window=window)
        ref = pa.paged_decode_attention_plain(q1, k, v, pt, lens, window)
        bf16_ulp_close(dec, ref)
        Qmax = 16
        q = torch.randn((B, Qmax, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        hist, q_lens = i32([0, 3, 40, 7], dev), i32([0, 16, 9, 1], dev)
        rag = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens, sliding_window=window)
        ref = pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens, window)
        bf16_ulp_close(rag, ref)
        for b in range(B):
            if not bool((rag[b, int(q_lens[b]):] == 0).all()):
                raise AssertionError(f"ragged padding rows of row {b} are not zero")
        # a decode row's value cannot depend on its round's kind
        lens1 = torch.clamp_min(lens, 1)
        dec1 = pa.paged_decode_attention(q1, k, v, pt, lens1, sliding_window=window)
        if not torch.equal(ragged_one(q1, k, v, pt, lens1, window), dec1):
            raise AssertionError("ragged q_len=1 differs from decode")
    torch.cuda.synchronize()
    log("kernels small shapes: decode and ragged within one bf16 ulp of their "
        "plain versions; padding rows zero; ragged q_len=1 == decode bitwise")


def kernel_split_cases(dev, gen) -> None:
    """The decode path's splits, short spans and chunk rows, at G=2 with
    16-token pages and at the llama-3-8b head shape with 64-token pages."""
    S = pa.split_pages()
    for Hq, Hkv, page in [(4, 2, 16), (32, 8, 64)]:
        span = S * page
        # lengths on both sides of split boundaries; windows that leave every
        # split but the last one or two empty
        lengths = [span - 1, span, span + 1, 2 * span + 1, 3 * span - 1, 1]
        B, Pmax = len(lengths), 3 * span // page + 1
        N = (pa.SHORT_SPAN + 1) * Pmax + 2  # room for the short-span rows' tables
        k, v = make_pools(gen, N, page, Hkv, 128, dev)
        pt = make_table(B, Pmax, N, 3, dev, share=True)
        lens = i32(lengths, dev)
        q1 = torch.randn((B, Hq, 128), generator=gen, device=dev).to(torch.bfloat16)
        for window in (None, span - page // 2, 2 * span - page // 2):
            dec = pa.paged_decode_attention(q1, k, v, pt, lens, sliding_window=window)
            bf16_ulp_close(dec, pa.paged_decode_attention_plain(q1, k, v, pt, lens, window))
            if not torch.equal(ragged_one(q1, k, v, pt, lens, window), dec):
                raise AssertionError(f"split lengths {lengths} window {window}: "
                                     "ragged q_len=1 differs from decode")

        # spans of 2..SHORT_SPAN tokens decode position by position
        q_lens_l = list(range(2, pa.SHORT_SPAN + 1))
        Bs, Qmax = len(q_lens_l), 16
        hist_l = [span - 3 + 5 * b for b in range(Bs)]
        pts = make_table(Bs, Pmax, N, 4, dev)
        hist, q_lens = i32(hist_l, dev), i32(q_lens_l, dev)
        q = torch.randn((Bs, Qmax, Hq, 128), generator=gen, device=dev).to(torch.bfloat16)
        for window in (None, page + 5):
            rag = pa.ragged_paged_attention(q, k, v, pts, hist, q_lens, sliding_window=window)
            bf16_ulp_close(rag, pa.ragged_paged_attention_plain(q, k, v, pts, hist,
                                                                 q_lens, window))
            for i in range(pa.SHORT_SPAN):
                rows = [b for b in range(Bs) if i < q_lens_l[b]]
                dec = pa.paged_decode_attention(q[rows, i].contiguous(), k, v,
                                                pts[rows].contiguous(), hist[rows] + i + 1,
                                                sliding_window=window)
                if not torch.equal(rag[rows, i], dec):
                    raise AssertionError(f"short span position {i} differs from decode")
            for b in range(Bs):
                if not bool((rag[b, q_lens_l[b]:] == 0).all()):
                    raise AssertionError(f"short span padding of row {b} is not zero")

        # one chunk row at absolute position pos, inside spans that start
        # elsewhere and are cut at other boundaries: the same bits
        pos = span + 22
        qrow = torch.randn((Hq, 128), generator=gen, device=dev).to(torch.bfloat16)
        for window in (None, 45):
            outs = []
            for start, qlen in [(pos - 50, 60), (pos - 30, 45),
                                (pos - pa.SHORT_SPAN, pa.SHORT_SPAN + 1)]:
                qc = torch.randn((1, 64, Hq, 128), generator=gen, device=dev).to(torch.bfloat16)
                qc[0, pos - start] = qrow
                hist, q_lens = i32([start], dev), i32([qlen], dev)
                out = pa.ragged_paged_attention(qc, k, v, pt[:1].contiguous(), hist, q_lens,
                                                sliding_window=window)
                bf16_ulp_close(out, pa.ragged_paged_attention_plain(
                    qc, k, v, pt[:1], hist, q_lens, window))
                outs.append(out[0, pos - start])
            if not all(torch.equal(o, outs[0]) for o in outs[1:]):
                raise AssertionError(f"chunk row at {pos} depends on its span's start")
    torch.cuda.synchronize()
    log(f"kernels split cases ({S} pages per split): decode across split boundaries "
        "and emptying windows within one bf16 ulp, ragged q_len=1 == decode; spans of "
        f"2..{pa.SHORT_SPAN} == decode position by position; a chunk row's bits "
        "independent of its span's start")


def kernel_main_shapes(dev, gen, cfg, page, Pmax, n_pages) -> dict[str, dict]:
    """llama-3-8b serving shapes: 8 rows, lengths 128..2048, 64-token pages."""
    B, Hq, Hkv, D = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    k, v = make_pools(gen, n_pages, page, Hkv, D, dev)
    pt = make_table(B, Pmax, n_pages, 2, dev)
    lengths = [128, 384, 640, 896, 1152, 1408, 1664, 2048]
    lens = i32(lengths, dev)
    q1 = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
    # a mixed round: one 512-token prompt chunk, six decode rows, one idle row
    Qmax = 512
    hist_l = [1024, 383, 639, 895, 0, 1407, 1663, 2047]
    qlen_l = [512, 1, 1, 1, 0, 1, 1, 1]
    hist, q_lens = i32(hist_l, dev), i32(qlen_l, dev)
    q = torch.randn((B, Qmax, Hq, D), generator=gen, device=dev).to(torch.bfloat16)

    results = {}
    short = pa.SHORT_SPAN
    geometry = {
        "paged_decode_attention": paged_geometry(Hq, Hkv, page, Pmax, B, 1,
                                                 [[L] for L in lengths], None),
        "ragged_paged_attention": paged_geometry(
            Hq, Hkv, page, Pmax, B, Qmax,
            [[h + i + 1 for i in range(ql)] for h, ql in zip(hist_l, qlen_l)
             if 0 < ql <= short],
            [(h, ql) for h, ql in zip(hist_l, qlen_l) if ql > short]),
    }
    dec = pa.paged_decode_attention(q1, k, v, pt, lens)
    err_dec = bf16_ulp_close(dec, pa.paged_decode_attention_plain(q1, k, v, pt, lens))
    rag = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens)
    err_rag = bf16_ulp_close(rag, pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens))
    if not torch.equal(ragged_one(q1, k, v, pt, lens, None), dec):
        raise AssertionError("main shapes: ragged q_len=1 differs from decode")

    # library yardstick: SDPA over the dense K/V gathered (and GQA-expanded)
    # outside the timed call, masked to the same visible keys
    kd, vd = pa.paged_gather_dense(k, v, pt)            # [B, S, Hkv, D]
    S = kd.shape[1]
    kd = kd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vd = vd.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1).contiguous()
    key = torch.arange(S, device=dev)
    mask_dec = (key[None, :] < lens[:, None])[:, None, None, :]
    qd = q1[:, :, None, :]
    qpos = hist[:, None] + torch.arange(Qmax, device=dev)[None, :]
    mask_rag = (key[None, None, :] <= qpos[:, :, None])[:, None]
    qq = q.permute(0, 2, 1, 3).contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention

    tokens_dec = sum(lengths)
    kv_row_bytes = Hkv * D * 2 * 2                       # K and V, bf16
    dec_bytes = tokens_dec * kv_row_bytes + 2 * B * Hq * D * 2 + B * (Pmax + 1) * 4
    dec_flops = 4 * Hq * D * tokens_dec
    rag_tokens = sum(h + ql for h, ql in zip(hist_l, qlen_l) if ql > 0)
    rag_pairs = sum(sum(h + i + 1 for i in range(ql)) for h, ql in zip(hist_l, qlen_l))
    # q is read only at valid span positions; the whole out tensor is
    # written (padding positions are zeros by contract)
    rag_bytes = (rag_tokens * kv_row_bytes + sum(qlen_l) * Hq * D * 2
                 + B * Qmax * Hq * D * 2 + B * (Pmax + 2) * 4)
    rag_flops = 4 * Hq * D * rag_pairs

    for name, kern, plain, libs, nbytes, flops, err in [
        ("paged_decode_attention",
         lambda: pa.paged_decode_attention(q1, k, v, pt, lens),
         lambda: pa.paged_decode_attention_plain(q1, k, v, pt, lens),
         {"SDPA masked": lambda: sdpa(qd, kd, vd, attn_mask=mask_dec)},
         dec_bytes, dec_flops, err_dec),
        ("ragged_paged_attention",
         lambda: pa.ragged_paged_attention(q, k, v, pt, hist, q_lens),
         lambda: pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens),
         {"SDPA masked": lambda: sdpa(qq, kd, vd, attn_mask=mask_rag)},
         rag_bytes, rag_flops, err_rag),
    ]:
        results[name] = time_kernel(name, kern, plain, libs, nbytes, flops, err)
        ms, geo = results[name]["ms"], geometry[name]
        rate = (f" (chunk path: {geo['chunk_tc_flops'] / 1e9:.2f} GFLOP of tensor-core "
                f"work over {geo['chunk_tiles']} tiles, "
                f"{geo['chunk_tc_flops'] / ms / 1e9:.1f} TFLOP/s if it took the whole call)"
                if "chunk_tiles" in geo else "")
        log(f"kernel {name} main shapes: blocks {geo}; achieved "
            f"{nbytes / ms / 1e6:.1f} GB/s and {flops / ms / 1e9:.2f} TFLOP/s of the "
            f"counted work against bound {results[name]['bound_ms']:.4f} ms and library "
            f"{results[name]['library_ms']:.4f} ms{rate}")
    return results


def flash_case(dev, gen, T, Hq, Hkv, lengths, window, D=128):
    B = len(lengths)
    q, k, v = (torch.randn((B, T, h, D), generator=gen, device=dev).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    lens = i32(lengths, dev)
    out = fa.flash_self_attention(q, k, v, lens, sliding_window=window)
    err = bf16_ulp_close(out, fa.flash_self_attention_plain(q, k, v, lens,
                                                            sliding_window=window))
    for b, L in enumerate(lengths):
        if not bool((out[b, L:] == 0).all()):
            raise AssertionError(f"flash rows past length {L} of row {b} are not zero")
    return (q, k, v, lens), err


def flash_small_shapes(dev, gen) -> None:
    """G = 1, 2, 4, 8; windows, one shorter than a 64-key tile; lengths below
    T; T not a multiple of the tile, also in the last batch row (its keys past
    T arrive as TMA's zeros); rows of length 1, also the last batch row."""
    for T, Hq, Hkv, lengths, window in [(200, 4, 4, [200, 1], None),
                                        (130, 8, 4, [77, 130], 33),
                                        (64, 8, 2, [64, 40], None),
                                        (300, 32, 4, [299, 150], 100),
                                        (97, 32, 8, [1, 96], 16),
                                        (100, 32, 8, [71, 100], None),
                                        (256, 8, 2, [256, 200], 7),
                                        (160, 16, 4, [150, 1], None)]:
        flash_case(dev, gen, T, Hq, Hkv, lengths, window)
    torch.cuda.synchronize()
    log("kernel flash small shapes: within one bf16 ulp of the plain version; "
        "rows past the length zero")


def flash_geometry(T, Hq, Hkv, lengths, window=None) -> dict:
    """What the flash kernel walks for one call, from its inputs as the kernel
    reads them: blocks of 128 (position, head) rows (128/G positions), those
    that load (first position below the length), the 64-key K/V tiles they
    load, and the (64-row warpgroup, 64-key tile) products they compute: Q.K
    once and P.V three times (P as three bf16 terms) on the tensor cores."""
    G = Hq // Hkv
    P, PW = 128 // G, 64 // G

    def tiles(p0, n, L):   # tiles of positions p0..p0+n-1 that see a key
        first = max(0, p0 - window + 1) if window else 0
        return min(p0 + n - 1, L - 1) // 64 - first // 64 + 1

    working = loaded = wg_tiles = 0
    for L in lengths:
        for p0 in range(0, min(L, T), P):
            working += 1
            loaded += tiles(p0, P, L)
            wg_tiles += sum(tiles(p0 + w * PW, PW, L) for w in range(2) if p0 + w * PW < L)
    return {"blocks": -(-T // P) * Hkv * len(lengths), "working": working * Hkv,
            "kv_tiles": loaded * Hkv, "wg_tiles": wg_tiles * Hkv,
            "tc_flops": wg_tiles * Hkv * 64 * 64 * 128 * 2 * 4}


def flash_main_shape(dev, gen, cfg) -> dict:
    """The coalesced batch_prefill group of the serving storm's two longest
    prompts at bucket 2048: B=2, T=2048, lengths [1300, 1500]."""
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lengths, T = [1300, 1500], 2048
    (q, k, v, lens), err = flash_case(dev, gen, T, Hq, Hkv, lengths, None)
    # library yardsticks on [B, H, T, D]: (a) GQA expanded and the mask
    # (k <= q) & (k < len) built outside the timed call; (b) is_causal, which
    # computes the same rows below each length (their visible keys all lie
    # below it) and may take PyTorch's flash backend, with GQA inside the call
    # where the installed PyTorch takes enable_gqa, else expanded outside
    qq = q.permute(0, 2, 1, 3).contiguous()
    kk = k.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1).contiguous()
    vv = v.permute(0, 2, 1, 3).repeat_interleave(Hq // Hkv, dim=1).contiguous()
    kg, vg = k.permute(0, 2, 1, 3).contiguous(), v.permute(0, 2, 1, 3).contiguous()
    pos = torch.arange(T, device=dev)
    mask = ((pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lens[:, None, None]))[:, None]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    try:
        causal_out = sdpa(qq, kg, vg, is_causal=True, enable_gqa=True)
        causal, causal_label = (lambda: sdpa(qq, kg, vg, is_causal=True, enable_gqa=True),
                                "SDPA is_causal enable_gqa")
    except TypeError:
        causal_out = sdpa(qq, kk, vv, is_causal=True)
        causal, causal_label = (lambda: sdpa(qq, kk, vv, is_causal=True),
                                "SDPA is_causal (heads expanded)")
    out = fa.flash_self_attention(q, k, v, lens).permute(0, 2, 1, 3)
    diff = max(float((causal_out[b, :, :L] - out[b, :, :L]).float().abs().max())
               for b, L in enumerate(lengths))
    log(f"kernel flash_self_attention main shapes: {causal_label} agrees with the kernel "
        f"below each length within {diff:.3e} (a yardstick's own bf16 arithmetic)")
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    tokens = sum(lengths)
    # q read at valid positions, K+V of the valid tokens, the whole output
    # written (rows past the length are zeros by contract), the lengths
    nbytes = (tokens * Hq * D * 2 + tokens * Hkv * D * 2 * 2
              + len(lengths) * T * Hq * D * 2 + len(lengths) * 4)
    result = time_kernel(
        "flash_self_attention",
        lambda: fa.flash_self_attention(q, k, v, lens),
        lambda: fa.flash_self_attention_plain(q, k, v, lens),
        {"SDPA masked": lambda: sdpa(qq, kk, vv, attn_mask=mask), causal_label: causal},
        nbytes, 4 * Hq * D * pairs, err)
    geo, ms = flash_geometry(T, Hq, Hkv, lengths), result["ms"]
    log(f"kernel flash_self_attention main shapes: blocks {geo}; "
        f"{geo['tc_flops'] / 1e9:.2f} GFLOP of tensor-core work over {geo['wg_tiles']} "
        f"(64-row, 64-key) tiles, {geo['tc_flops'] / ms / 1e9:.1f} TFLOP/s; "
        f"{4 * Hq * D * pairs / ms / 1e9:.2f} TFLOP/s of the counted work")
    return result


# ------------------------------------------------------------------ serving phase
def engine_config_from_options(opts: dict) -> EngineConfig:
    """The llm-gateway worker's engine_options → EngineConfig mapping for the
    main-path keys (same defaults, same default page count)."""
    opts = dict(opts)
    model = opts.pop("model_config")
    max_seq_len = int(opts.pop("max_seq_len", 2048))
    max_batch = int(opts.pop("max_batch", 8))
    page = int(opts.pop("prefix_page_size", 64))
    default_pages = max_batch * (-(-max_seq_len // page)) * 5 // 4 + 1
    vocab = get_config(model).vocab_size
    return EngineConfig(
        model=model, max_seq_len=max_seq_len, max_batch=max_batch,
        dtype=opts.pop("dtype", "bfloat16"),
        eos_token_ids=(ByteTokenizer(vocab).eos_id,),  # synthetic weights
        decode_chunk=int(opts.pop("decode_chunk", 8)),
        prefix_cache_pages=int(opts.pop("prefix_cache_pages", default_pages)),
        prefix_page_size=page,
        prefill_budget_tokens=int(opts.pop("prefill_budget_tokens", 512)),
        prefill_coalesce=int(opts.pop("prefill_coalesce", 4)),
        mixed_batch=str(opts.pop("mixed_batch", True)).lower()
        not in ("0", "false", "no", "off"))


def serve(engine, requests, n_threads=3, timeout=600.0):
    """Submit (prompt, SamplingParams) from ``n_threads`` threads; wait for
    every terminal event. Returns per request (tokens, reasons, submit_t,
    first_t)."""
    recs = [{"toks": [], "fins": [], "t0": None, "t1": None} for _ in requests]
    lock, done, left = threading.Lock(), threading.Event(), [len(requests)]

    def emit_for(i):
        def emit(ev):
            r = recs[i]
            if r["t1"] is None:
                r["t1"] = time.perf_counter()
            r["toks"].append(ev.token_id)
            r["fins"].append(ev.finished)
            if ev.finished is not None:
                with lock:
                    left[0] -= 1
                    if left[0] == 0:
                        done.set()
        return emit

    def submitter(idx):
        for i in idx:
            recs[i]["t0"] = time.perf_counter()
            engine.submit(requests[i][0], requests[i][1], emit_for(i))

    threads = [threading.Thread(target=submitter, args=(range(t, len(requests), n_threads),))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    if not done.wait(timeout):
        raise AssertionError(f"requests did not finish: {engine.stats()}")
    return recs


def check_streams(recs, requests, stops_of) -> None:
    for i, (r, (prompt, sp)) in enumerate(zip(recs, requests)):
        fins = r["fins"]
        if sum(f is not None for f in fins) != 1 or fins[-1] is None:
            raise AssertionError(f"request {i}: terminal events {fins}")
        toks, stops = r["toks"], stops_of(sp)
        hit = [j for j, t in enumerate(toks) if t in stops]
        if hit:
            if hit[0] != len(toks) - 1 or fins[-1] != "stop":
                raise AssertionError(f"request {i}: stop token at {hit[0]} of "
                                     f"{len(toks)}, reason {fins[-1]}")
        elif fins[-1] != "length" or len(toks) != sp.max_tokens:
            raise AssertionError(f"request {i}: {len(toks)} tokens, reason {fins[-1]}")


def dense_margin(params, cfg, rope, prompt, toks) -> tuple[float, torch.Tensor]:
    """Of the dense forward, teacher-forced over prompt + output, at every
    emitted token's row: the largest (row max - emitted token's logit), and
    each row's top-1/top-2 gap (what the runner-up token would read)."""
    T, n = len(prompt), len(toks)
    ids = torch.tensor([prompt + toks[:-1]], dtype=torch.int32, device=params.device)
    L = ids.shape[1]
    pos = torch.arange(L, device=ids.device, dtype=torch.int32)[None]
    cache = llama.init_cache(cfg, 1, L, params.dtype, device=ids.device)
    hidden, _ = llama.forward(params, cfg, ids, pos, cache,
                              torch.zeros(1, dtype=torch.int32, device=ids.device), rope)
    logits = llama.lm_head_logits(params, cfg, hidden[0, T - 1: T - 1 + n])
    got = logits.gather(1, torch.tensor(toks, device=ids.device)[:, None])[:, 0]
    top2 = logits.float().topk(2, dim=1).values
    return float((logits.max(dim=1).values - got).max()), top2[:, 0] - top2[:, 1]


QUICKSTART = {"model_config": "llama-3-8b", "max_seq_len": 2048, "max_batch": 8,
              "prefix_page_size": 64, "decode_chunk": 8,
              "prefill_budget_tokens": 512, "mixed_batch": True}


def build_engine(label: str, opts: dict, params=None):
    ecfg = engine_config_from_options(opts)
    t = time.perf_counter()
    engine = ContinuousBatchingEngine(ecfg, params=params, seed=0)  # on the card
    log(f"serving engine [{label}] built: llama-3-8b full width, "
        f"{engine.stats()['mode']}, {engine.stats()['pages_total']} pages, "
        f"use_flash={engine.use_flash}, {time.perf_counter() - t:.1f} s")
    return engine, ecfg


def storm_requests(engine, ecfg) -> list:
    """8 prompts of 16..1500 tokens, 32 output tokens each; request 3 stops
    on a token it emits greedily (learned by a probe), request 5 samples with
    a seed."""
    rng = np.random.default_rng(0)
    lens = [16, 96, 250, 511, 700, 1000, 1300, 1500]
    prompts = [rng.integers(3, engine.model_config.vocab_size, n).tolist() for n in lens]
    probe = serve(engine, [(prompts[3], SamplingParams(max_tokens=12))], 1)[0]["toks"]
    fresh = [t for j, t in enumerate(probe)
             if t not in probe[:j] and t not in ecfg.eos_token_ids]
    stop_id = fresh[-1] if fresh else probe[0]
    requests = [(p, SamplingParams(max_tokens=32)) for p in prompts]
    requests[3] = (prompts[3], SamplingParams(max_tokens=32, stop_token_ids=(stop_id,)))
    requests[5] = (prompts[5], SamplingParams(max_tokens=32, temperature=0.8, seed=42))
    return requests


def serving_phase(card: str, label: str, engine, ecfg, requests,
                  launched: tuple, never: tuple = ()) -> dict[str, int]:
    """Serve ``requests`` with every kernel count set to 0 just before and
    read just after; the kernels in ``launched`` must have run and those in
    ``never`` must not. Checks streams, pages and the dense oracle; prints
    ttft and tokens/s. Returns this run's launch counts."""
    cfg = engine.model_config
    try:
        pages_total = engine.stats()["pages_total"]
        for _, _, wrapper in KERNELS.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        recs = serve(engine, requests)
        wall = time.perf_counter() - t0
        launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
        stats = engine.stats()
    finally:
        engine.shutdown()
    check_streams(recs, requests, lambda sp: set(sp.stop_token_ids) | set(ecfg.eos_token_ids))
    if any(launches[n] <= 0 for n in launched) or any(launches[n] for n in never):
        raise AssertionError(f"[{label}] launches {launches}: expected {launched} "
                             f"to run and {never} never")
    if stats["pages_in_use"] != 0 or stats["pages_free"] != pages_total:
        raise AssertionError(f"[{label}] pages leaked: {stats}")
    log(f"serving [{label}]: {len(requests)} requests done, reasons "
        f"{[r['fins'][-1] for r in recs]}, rounds {stats['rounds']}, prefill chunks "
        f"{stats['prefill_chunks']}, prefill dispatches {stats['prefill_dispatches']} "
        f"(coalesced {stats['coalesced_prefills']}), launches {launches}, pages leaked 0")
    log(f"serving [{label}] wall ms by round kind (engine lifetime): {stats['round_ms']}; "
        f"phase-separated prefill ms {stats['prefill_ms']:.1f}")

    with torch.inference_mode():
        worst, runner_up = 0.0, []
        for i, (r, (prompt, sp)) in enumerate(zip(recs, requests)):
            if sp.temperature > 0:
                continue
            gap, ru = dense_margin(engine.params, cfg, engine.rope_tables, prompt, r["toks"])
            worst = max(worst, gap)
            runner_up.append(ru)
            if gap > LOGIT_MARGIN:
                raise AssertionError(f"[{label}] request {i}: a greedy token sits "
                                     f"{gap:.3f} below the dense max (margin {LOGIT_MARGIN})")
        ru = torch.cat(runner_up).cpu()
        caught = float((ru > LOGIT_MARGIN).float().mean())
        q = torch.quantile(ru, torch.tensor([0.1, 0.5, 0.9])).tolist()
    log(f"serving [{label}] oracle: every greedy token within {worst:.4f} of the dense "
        f"forward's max logit (margin {LOGIT_MARGIN})")
    log(f"serving [{label}] oracle power: dense top-1/top-2 gap over {ru.numel()} greedy "
        f"rows min={float(ru.min()):.4f} p10={q[0]:.4f} p50={q[1]:.4f} p90={q[2]:.4f}; "
        f"the runner-up token would fail the margin at {caught:.3f} of rows "
        f"(least allowed {MIN_RUNNER_UP_CAUGHT})")
    if caught < MIN_RUNNER_UP_CAUGHT:
        raise AssertionError(f"[{label}] the margin {LOGIT_MARGIN} admits the runner-up "
                             f"token at {1 - caught:.3f} of rows: the oracle cannot see "
                             "a wrong token")
    ttft = sorted((r["t1"] - r["t0"]) * 1e3 for r in recs)
    n_tok = sum(len(r["toks"]) for r in recs)
    log(f"info [{card}] serving [{label}]: ttft_ms p50={ttft[len(ttft) // 2]:.1f} "
        f"max={ttft[-1]:.1f}; {n_tok} tokens in {wall:.2f} s = {n_tok / wall:.1f} tokens/s")
    return launches


def serving_phases(card: str) -> dict[str, int]:
    """The three serving runs on one set of weights. Returns the kernels'
    main-path launch counts: the paged kernels from the mixed run, flash from
    the phase-separated run."""
    engine, ecfg = build_engine("mixed", QUICKSTART)
    requests = storm_requests(engine, ecfg)
    mixed = serving_phase(card, "mixed", engine, ecfg, requests,
                          launched=("ragged_paged_attention", "paged_decode_attention"),
                          never=("flash_self_attention",))
    params = engine.params
    del engine
    torch.cuda.empty_cache()

    # an unbounded round budget lets the storm's same-bucket prompts (700 and
    # 1000 at 1024, 1300 and 1500 at 2048) meet in one admission pass and
    # coalesce; at 512 the budget admits each long prompt alone
    opts = dict(QUICKSTART, mixed_batch=False, prefill_coalesce=4, prefill_budget_tokens=0)
    engine, ecfg = build_engine("phase-separated", opts, params)
    phase = serving_phase(card, "phase-separated", engine, ecfg, requests,
                          launched=("flash_self_attention", "paged_decode_attention"),
                          never=("ragged_paged_attention",))
    del engine
    torch.cuda.empty_cache()

    engine, ecfg = build_engine("dense", dict(QUICKSTART, prefix_cache_pages=0), params)
    dense_requests = [(p, SamplingParams(max_tokens=16)) for p, _ in requests[:4]]
    serving_phase(card, "dense", engine, ecfg, dense_requests,
                  launched=("flash_self_attention",),
                  never=("ragged_paged_attention", "paged_decode_attention"))
    del engine
    torch.cuda.empty_cache()
    return {"ragged_paged_attention": mixed["ragged_paged_attention"],
            "paged_decode_attention": mixed["paged_decode_attention"],
            "flash_self_attention": phase["flash_self_attention"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip().splitlines()[0]
    log(smi)
    dev = torch.device("cuda")
    card = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {card}")

    t = time.perf_counter()
    built = _build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t:.1f} s")
    for stem, path in built.items():
        ptx = [ln for ln in path.with_suffix(".log").read_text().splitlines()
               if "registers" in ln or "spill" in ln]
        log(f"ptxas {stem}: " + " | ".join(ptx))

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    with torch.inference_mode():
        kernel_small_shapes(dev, gen)
        kernel_split_cases(dev, gen)
        flash_small_shapes(dev, gen)
        cfg = get_config("llama-3-8b")
        kern = kernel_main_shapes(dev, gen, cfg, page=64, Pmax=32, n_pages=321)
        kern["flash_self_attention"] = flash_main_shape(dev, gen, cfg)
    torch.cuda.empty_cache()

    launches = serving_phases(card)

    line = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": replaces,
         "launches": launches[name], **kern[name]}
        for name, (src, replaces, _) in KERNELS.items()]}
    for entry in line["kernels"]:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"):
            if not math.isfinite(entry[key]):
                raise AssertionError(f"{entry['name']}: {key} is {entry[key]}")
    log(json.dumps(line))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
