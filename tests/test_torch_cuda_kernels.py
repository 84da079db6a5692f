"""The port's CUDA attention kernels against their plain versions.

Needs a CUDA card (Hopper: the kernels are built for sm_90a) and skips
without one. Run on the card with

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda --noconftest

(``--noconftest``: the repo's conftest pins JAX to the CPU, and the card's
machine runs the port without JAX). Tolerance: every bf16 output element
within one bf16 ulp of the plain version's (same f32 arithmetic, another
summation order before the final rounding); q_len=1 ragged rows bitwise
equal to decode, and every position of a span of up to SHORT_SPAN tokens
bitwise equal to decoding its token alone; a prompt-chunk row's bits
independent of where its span starts; flash rows past the length exactly
zero. The same at every head dim the kernels are built for (16, 64, 96,
128, 256) and, for flash, at every group size 1..8. f32 inputs (the CUDA-core
kernels): every element within rtol = atol = 2e-5 of the float64 plain
version, the JAX flash kernel's own f32 bar."""

import pytest
import torch

from cyberfabric_core_tpu_torch.ops import flash_attention as fa
from cyberfabric_core_tpu_torch.ops import paged_attention as pa

pytestmark = pytest.mark.cuda


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _one_ulp(out, ref):
    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(2.0 ** -20))) - 7)
    return bool(((out.float() - ref).abs() <= ulp + 1e-6).all())


def _inputs(dev, B, Qmax, Hq, Hkv, page, Pmax, seed, D=128, dtype=torch.bfloat16):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    N = B * Pmax + 1
    k = torch.randn((N, page, Hkv, D), generator=g, device=dev).to(dtype)
    v = torch.randn((N, page, Hkv, D), generator=g, device=dev).to(dtype)
    pt = (torch.randperm(N - 1, generator=g, device=dev)[: B * Pmax] + 1)
    pt = pt.reshape(B, Pmax).to(torch.int32)
    pt[1, :2] = pt[0, :2]  # shared prefix pages
    q = torch.randn((B, Qmax, Hq, D), generator=g, device=dev).to(dtype)
    return q, k, v, pt


def _f32_close(out, ref):
    return bool(((out.double() - ref.double()).abs() <= 2e-5 + 2e-5 * ref.double().abs()).all())


@pytest.mark.parametrize("window", [None, 19])
@pytest.mark.parametrize("Hq,Hkv,page", [(4, 2, 16), (32, 8, 64)])
def test_cuda_kernels_match_plain(dev, window, Hq, Hkv, page):
    B, Qmax, Pmax = 4, 16, 4
    q, k, v, pt = _inputs(dev, B, Qmax, Hq, Hkv, page, Pmax, seed=Hq + page)
    hist = torch.tensor([0, 5, 2 * page, 9], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([0, 16, 7, 1], dtype=torch.int32, device=dev)
    before = pa.ragged_paged_attention.launches
    out = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens, sliding_window=window)
    ref = pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens, window)
    assert pa.ragged_paged_attention.launches == before + 1
    assert _one_ulp(out, ref)
    for b in range(B):
        assert bool((out[b, int(q_lens[b]):] == 0).all())

    lens = torch.tensor([0, 3, Pmax * page, 2 * page + 1], dtype=torch.int32, device=dev)
    dec = pa.paged_decode_attention(q[:, 0].contiguous(), k, v, pt, lens,
                                    sliding_window=window)
    assert _one_ulp(dec, pa.paged_decode_attention_plain(q[:, 0], k, v, pt, lens, window))

    lens1 = lens.clamp_min(1)
    qr = torch.zeros((B, 8, Hq, 128), dtype=torch.bfloat16, device=dev)
    qr[:, 0] = q[:, 0]
    rag1 = pa.ragged_paged_attention(qr, k, v, pt, lens1 - 1,
                                     torch.ones(B, dtype=torch.int32, device=dev),
                                     sliding_window=window)
    dec1 = pa.paged_decode_attention(q[:, 0].contiguous(), k, v, pt, lens1,
                                     sliding_window=window)
    assert torch.equal(rag1[:, 0], dec1)


def _ragged_one(q1, k, v, pt, lens, window):
    """Each row's query as a ragged span of one token at lens-1."""
    B, Hq, D = q1.shape
    qr = torch.zeros((B, 8, Hq, D), dtype=q1.dtype, device=q1.device)
    qr[:, 0] = q1
    return pa.ragged_paged_attention(qr, k, v, pt, lens - 1,
                                     torch.ones(B, dtype=torch.int32, device=q1.device),
                                     sliding_window=window)[:, 0]


@pytest.mark.parametrize("Hq,Hkv,page", [(4, 2, 16), (32, 8, 64)])
@pytest.mark.parametrize("window_splits", [None, 1, 2])
def test_cuda_decode_split_boundaries(dev, Hq, Hkv, page, window_splits):
    """Lengths at S*page - 1, S*page and S*page + 1 (S = pages per split),
    two and three splits long; windows of none, and of lengths that leave
    every split but the last one or two empty."""
    span = pa.split_pages() * page
    lengths = [span - 1, span, span + 1, 2 * span + 1, 3 * span - 1, 1]
    window = None if window_splits is None else window_splits * span - page // 2
    B = len(lengths)
    Pmax = -(-max(lengths) // page) + 1
    q, k, v, pt = _inputs(dev, B, 1, Hq, Hkv, page, Pmax, seed=page + (window or 0))
    q1 = q[:, 0].contiguous()
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = pa.paged_decode_attention.launches
    dec = pa.paged_decode_attention(q1, k, v, pt, lens, sliding_window=window)
    assert pa.paged_decode_attention.launches == before + 1
    assert _one_ulp(dec, pa.paged_decode_attention_plain(q1, k, v, pt, lens, window))
    assert torch.equal(_ragged_one(q1, k, v, pt, lens, window), dec)


@pytest.mark.parametrize("window", [None, 37])
@pytest.mark.parametrize("Hq,Hkv,page", [(8, 2, 16), (32, 8, 64)])
def test_cuda_short_spans_are_decode_position_by_position(dev, window, Hq, Hkv, page):
    """Spans of 2..SHORT_SPAN tokens: position i of row b equals decoding
    its query alone at length hist[b]+i+1, bitwise."""
    q_lens = list(range(2, pa.SHORT_SPAN + 1))
    B, Qmax = len(q_lens), 16
    hist_l = [3 * page + 5 * b for b in range(B)]
    Pmax = -(-(max(hist_l) + Qmax) // page) + 1
    q, k, v, pt = _inputs(dev, B, Qmax, Hq, Hkv, page, Pmax, seed=Hq * page)
    hist = torch.tensor(hist_l, dtype=torch.int32, device=dev)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    rag = pa.ragged_paged_attention(q, k, v, pt, hist, ql, sliding_window=window)
    assert _one_ulp(rag, pa.ragged_paged_attention_plain(q, k, v, pt, hist, ql, window))
    for i in range(pa.SHORT_SPAN):
        rows = [b for b in range(B) if i < q_lens[b]]
        dec = pa.paged_decode_attention(q[rows, i].contiguous(), k, v, pt[rows].contiguous(),
                                        hist[rows] + i + 1, sliding_window=window)
        assert torch.equal(rag[rows, i], dec)
    for b in range(B):
        assert bool((rag[b, q_lens[b]:] == 0).all())


@pytest.mark.parametrize("window", [None, 45])
@pytest.mark.parametrize("Hq,Hkv,page", [(8, 2, 16), (32, 8, 64)])
def test_cuda_chunk_row_independent_of_span_start(dev, window, Hq, Hkv, page):
    """One query at absolute position 150 of a row, inside a span that
    starts at 100 (60 tokens), 120 (45) or 142 (9, just past the short-span
    route): the same bits each time."""
    pos, Pmax = 150, 256 // page
    q, k, v, pt = _inputs(dev, 2, 64, Hq, Hkv, page, Pmax, seed=7)
    pt = pt[:1].contiguous()
    outs = []
    for start, qlen in [(100, 60), (120, 45), (142, 9)]:
        assert qlen > pa.SHORT_SPAN and start <= pos < start + qlen
        qs = torch.randn((1, 64, Hq, 128), device=dev).to(torch.bfloat16)
        qs[0, pos - start] = q[0, 0]
        hist = torch.tensor([start], dtype=torch.int32, device=dev)
        ql = torch.tensor([qlen], dtype=torch.int32, device=dev)
        out = pa.ragged_paged_attention(qs, k, v, pt, hist, ql, sliding_window=window)
        ref = pa.ragged_paged_attention_plain(qs, k, v, pt, hist, ql, window)
        assert _one_ulp(out, ref)
        assert bool((out[0, qlen:] == 0).all())
        outs.append(out[0, pos - start])
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take(dev):
    q, k, v, pt = _inputs(dev, 2, 8, 4, 2, 16, 2, seed=0)
    lens = torch.tensor([3, 4], dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        pa.paged_decode_attention(q[:, 0].float(), k, v, pt, lens)
    with pytest.raises(ValueError):
        pa.paged_decode_attention(q[:, 0].contiguous(), k, v, pt, lens.long())
    with pytest.raises(ValueError, match="head_dim"):
        pa.paged_decode_attention(q[:, 0, :, :32].contiguous(), k[..., :32].contiguous(),
                                  v[..., :32].contiguous(), pt, lens)


@pytest.mark.parametrize("D", [16, 64, 96, 256])
@pytest.mark.parametrize("Hq,Hkv,page", [(4, 2, 16), (28, 4, 64)])
def test_cuda_paged_kernels_at_every_head_dim(dev, D, Hq, Hkv, page):
    """At the head dims beside 128, also at qwen2-7b's G=7: decode and ragged
    (a chunk row, a short span, a decode row, an idle row) within one bf16
    ulp; ragged q_len=1 and each short-span position equal decode bitwise."""
    B, Qmax, Pmax = 4, 16, 4
    q, k, v, pt = _inputs(dev, B, Qmax, Hq, Hkv, page, Pmax, seed=D + Hq, D=D)
    hist = torch.tensor([0, 5, 2 * page, 9], dtype=torch.int32, device=dev)
    q_lens = torch.tensor([0, 16, 7, 1], dtype=torch.int32, device=dev)
    for window in (None, 19):
        out = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens, sliding_window=window)
        assert _one_ulp(out, pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens,
                                                             window))
        for b in range(B):
            assert bool((out[b, int(q_lens[b]):] == 0).all())
        for i in range(7):  # row 2's short span, position by position
            dec = pa.paged_decode_attention(q[2:3, i].contiguous(), k, v, pt[2:3].contiguous(),
                                            hist[2:3] + i + 1, sliding_window=window)
            assert torch.equal(out[2:3, i], dec)
        lens = torch.tensor([1, 3, Pmax * page, 2 * page + 1], dtype=torch.int32, device=dev)
        dec = pa.paged_decode_attention(q[:, 0].contiguous(), k, v, pt, lens,
                                        sliding_window=window)
        assert _one_ulp(dec, pa.paged_decode_attention_plain(q[:, 0], k, v, pt, lens, window))
        assert torch.equal(_ragged_one(q[:, 0].contiguous(), k, v, pt, lens, window), dec)


@pytest.mark.parametrize("D", [16, 64, 96, 128, 256])
def test_cuda_f32_kernels_match_plain(dev, D):
    """The f32 entry points of all three kernels, GQA G=2 and G=7, a window."""
    for Hq, Hkv in ((4, 2), (7, 1)):
        B, Qmax, page, Pmax = 3, 16, 16, 4
        q, k, v, pt = _inputs(dev, B, Qmax, Hq, Hkv, page, Pmax, seed=D, D=D,
                              dtype=torch.float32)
        hist = torch.tensor([0, 5, 30], dtype=torch.int32, device=dev)
        q_lens = torch.tensor([16, 3, 1], dtype=torch.int32, device=dev)
        lens = torch.tensor([1, 17, 64], dtype=torch.int32, device=dev)
        for window in (None, 11):
            rag = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens, sliding_window=window)
            assert rag.dtype == torch.float32
            assert _f32_close(rag, pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens,
                                                                   window))
            assert bool((rag[1, 3:] == 0).all())
            dec = pa.paged_decode_attention(q[:, 0].contiguous(), k, v, pt, lens,
                                            sliding_window=window)
            assert _f32_close(dec, pa.paged_decode_attention_plain(q[:, 0], k, v, pt, lens,
                                                                   window))
        g = torch.Generator(device=dev)
        g.manual_seed(D)
        T = 80
        fq, fk, fv = (torch.randn((2, T, h, D), generator=g, device=dev) for h in (Hq, Hkv, Hkv))
        flens = torch.tensor([80, 33], dtype=torch.int32, device=dev)
        for window in (None, 21):
            out = fa.flash_self_attention(fq, fk, fv, flens, sliding_window=window)
            assert out.dtype == torch.float32
            assert _f32_close(out, fa.flash_self_attention_plain(fq, fk, fv, flens,
                                                                 sliding_window=window))
            assert bool((out[1, 33:] == 0).all())


@pytest.mark.parametrize("T,Hq,Hkv,lengths,window", [
    (200, 4, 4, [200, 1], None),      # G=1, T not a tile multiple, a length-1 row
    (130, 8, 4, [77, 130], 33),       # G=2, window
    (64, 8, 2, [64, 40], None),       # G=4
    (300, 32, 4, [299, 150], 100),    # G=8, window
    (2048, 32, 8, [1300, 1500], None),  # the main path's coalesced prefill (llama-3-8b heads)
    (100, 32, 8, [71, 100], None),    # T not a tile multiple, B > 1: the last row's keys
                                      # past T arrive as TMA's zeros
    (256, 8, 2, [256, 200], 7),       # a window shorter than one tile
    (160, 16, 4, [150, 1], None),     # a length-1 row in the last batch row
])
def test_cuda_flash_matches_plain(dev, T, Hq, Hkv, lengths, window):
    g = torch.Generator(device=dev)
    g.manual_seed(T)
    B = len(lengths)
    q, k, v = (torch.randn((B, T, h, 128), generator=g, device=dev).to(torch.bfloat16)
               for h in (Hq, Hkv, Hkv))
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    before = fa.flash_self_attention.launches
    out = fa.flash_self_attention(q, k, v, lens, sliding_window=window)
    ref = fa.flash_self_attention_plain(q, k, v, lens, sliding_window=window)
    assert fa.flash_self_attention.launches == before + 1
    assert _one_ulp(out, ref)
    for b, L in enumerate(lengths):
        assert bool((out[b, L:] == 0).all())


def test_cuda_flash_refuses_what_the_kernel_does_not_take(dev):
    q = torch.zeros((1, 16, 36, 128), dtype=torch.bfloat16, device=dev)
    k = torch.zeros((1, 16, 4, 128), dtype=torch.bfloat16, device=dev)
    lens = torch.tensor([16], dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="query heads per kv head"):
        fa.flash_self_attention(q, k, k, lens)                      # G=9
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        fa.flash_self_attention(q[:, :, :4].half(), k.half(), k.half(), lens)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_self_attention(q[:, :, :4, :32].contiguous(), k[..., :32].contiguous(),
                                k[..., :32].contiguous(), lens)


@pytest.mark.parametrize("D", [16, 64, 96, 128, 256])
@pytest.mark.parametrize("G", range(1, 9))
def test_cuda_flash_every_group_and_head_dim(dev, D, G):
    """Every group size at every head dim: T not a multiple of the block's
    positions (128 // G), a short row in the last batch row, a window."""
    g = torch.Generator(device=dev)
    g.manual_seed(D * 10 + G)
    Hkv, T = 2, 150
    q = torch.randn((2, T, G * Hkv, D), generator=g, device=dev).to(torch.bfloat16)
    k, v = (torch.randn((2, T, Hkv, D), generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    lens = torch.tensor([150, 41], dtype=torch.int32, device=dev)
    for window in (None, 37):
        out = fa.flash_self_attention(q, k, v, lens, sliding_window=window)
        assert _one_ulp(out, fa.flash_self_attention_plain(q, k, v, lens,
                                                           sliding_window=window))
        assert bool((out[1, 41:] == 0).all())


def test_cuda_draws_are_each_slots_rand_calls(dev):
    """The decode chunk's uniforms on CUDA generators: slot i's column holds
    what k ``torch.rand(1)`` calls of its generator return, and the generator
    ends where those calls leave it (the Philox offset moves per call)."""
    from cyberfabric_core_tpu_torch.runtime.programs import PagedDecodeChunk

    prog = PagedDecodeChunk.__new__(PagedDecodeChunk)
    prog.k = 6
    prog.uniforms = torch.full((6, 3), 9.0, device=dev)
    gens, twins = [], []
    for seed in (4, 5):
        g, t = torch.Generator(device=dev), torch.Generator(device=dev)
        g.manual_seed(seed)
        t.manual_seed(seed)
        gens.append(g)
        twins.append(t)
    prog._draw([gens[0], None, gens[1]])
    for col, g, t in ((0, gens[0], twins[0]), (2, gens[1], twins[1])):
        want = torch.cat([torch.rand(1, generator=t, device=dev) for _ in range(6)])
        assert torch.equal(prog.uniforms[:, col], want)
        assert torch.equal(g.get_state(), t.get_state())
    assert bool((prog.uniforms[:, 1] == 0).all())


@pytest.mark.parametrize("depth", [0, 2])
def test_cuda_graph_replays_give_the_eager_streams(dev, depth):
    """tiny-llama in bf16 (D 16, G 2) on the card: the engine that replays
    its decode chunks as CUDA graphs and the one with the private eager
    switch serve the same greedy and seeded streams, every request pending
    before the first admission; the graph engine's launch counts move by
    replay."""
    import threading

    import numpy as np

    from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
    from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

    cfg = EngineConfig(model="tiny-llama", max_seq_len=512, max_batch=4, decode_chunk=4,
                       prefix_cache_pages=80, prefix_page_size=16,
                       prefill_budget_tokens=48, decode_lookahead=depth)
    rng = np.random.default_rng(depth)
    requests = [(rng.integers(3, 500, n).tolist(), sp) for n, sp in (
        (20, SamplingParams(max_tokens=21)),
        (70, SamplingParams(max_tokens=18, temperature=0.9, seed=7)),
        (33, SamplingParams(max_tokens=25, temperature=0.7, top_k=30, seed=1)),
        (9, SamplingParams(max_tokens=15)))]
    streams, stats = {}, {}
    for eager in (False, True):
        engine = ContinuousBatchingEngine(cfg, seed=0, device=dev, _eager_decode=eager)
        toks = {i: [] for i in range(len(requests))}
        done, lock = threading.Event(), threading.Lock()
        left = [len(requests)]

        def emit_for(i):
            def emit(ev):
                with lock:
                    toks[i].append((ev.token_id, ev.finished))
                    if ev.finished:
                        left[0] -= 1
                        if left[0] == 0:
                            done.set()
            return emit

        engine.start = lambda: None  # every request pending before the first admission
        for i, (prompt, sp) in enumerate(requests):
            engine.submit(prompt, sp, emit_for(i))
        del engine.start
        before = pa.paged_decode_attention.launches
        try:
            engine.start()
            assert done.wait(120), engine.stats()
        finally:
            engine.shutdown()
        streams[eager], stats[eager] = toks, engine.stats()
        stats[eager]["decode_launches"] = pa.paged_decode_attention.launches - before
    assert streams[False] == streams[True]
    graph, eager = stats[False]["pipeline"], stats[True]["pipeline"]
    assert graph["decode_graphs"] and graph["decode_graph_replays"] > 0
    assert graph["decode_eager_chunks"] == 0
    assert not eager["decode_graphs"] and eager["decode_graph_replays"] == 0
    assert eager["decode_eager_chunks"] > 0
    # each decode chunk launches the decode kernel once a step a layer
    per_chunk = cfg.decode_chunk * 2  # tiny-llama has 2 layers
    assert stats[False]["decode_launches"] == graph["decode_graph_replays"] * per_chunk
    assert stats[True]["decode_launches"] == eager["decode_eager_chunks"] * per_chunk
