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
   empty whole splits) at every head dim the kernels are built for (16, 64,
   96, 128, 256), flash also at every group size 1..8, and at the
   llama-3-8b main-path shapes in bf16: one bf16 ulp of the float64 plain
   value; ragged at q_len=1 bitwise equal to decode, every position of a
   span of up to SHORT_SPAN tokens bitwise equal to decoding it alone, a
   prompt-chunk row's bits independent of where its span starts, at every
   head dim; flash rows past the length exactly zero; the f32 entry points
   of all three at every head dim within rtol = atol = 2e-5; device times
   (CUDA-graph replay) of each kernel and of PyTorch SDPA calls over dense
   inputs prepared outside the timed call (yardsticks only, never used by
   the port: masked SDPA, and for flash also ``is_causal``; the faster is
   ``library_ms``), CUDA-event times of the plain version, beside each
   kernel's bound, with the kernels' blocks, splits or walked tiles and
   achieved rates; the same timings at tiny-llama's (D 16), phi-3-mini's
   (D 96) and gemma-7b's (D 256) heads;
3'. training, outside inference mode and before any serving phase: (a) the
   GPipe pipeline at llama-3-8b widths cut to 4 layers, f32, TF32 off, B=8,
   T=256, every stage and data-parallel row on the one card: the pipelined
   loss equal to ``reference_loss_fn``'s within rtol = atol = 2e-5 at (pp,
   dp, M) = (2, 1, 4), (4, 1, 4) and (2, 2, 2); at (2, 2, 2) the gradients
   of ``embed``, ``lm_head`` and layer 0's ``wq`` and ``down`` within rtol
   5e-4, atol 5e-5; over 5 ``make_train_step`` steps on one Markov batch
   the last loss below the first; the step's ms, training tokens/s and
   peak memory beside a reference-loss step's ms; (b) ring attention at
   llama-3-8b's heads, B=1, T=4096 over 4 ranks on the card, f32: the
   output equal to the plain ``attention_with_cache`` within 2e-5, also
   with a length, and at T=512 the q, k and v gradients too; (c) the
   trained pair of ``bench.py --spec-cross``: ``train_lm`` on tiny-llama-8l
   and tiny-llama (parameter seeds 0 and 99, 300 steps), both losses
   falling, cast to bf16, the draft saved and served as the lockstep
   engine's ``draft_checkpoint``: the greedy stream with draft speculation
   equal to spec off's, acceptance strictly between 0 and 100% at
   temperature 0 and 0.8, flash launched (counted into the kernels line)
   and no paged kernel; acceptance, tokens per round, the histogram and
   tokens/s printed. After each phase here and below, the card's memory as
   the phase returned and after a cycle collection;
4. serving, runs of ``ContinuousBatchingEngine`` at llama-3-8b full width
   (random weights from a seed, built once and shared), each from
   quickstart-shaped ``engine_options`` through the llm-gateway worker's own
   mapping (``plan_engine``),
   paged decode chunks replayed as CUDA graphs: (a) mixed batching (the
   default path, lookahead ring at the worker's depth 2), 8 requests from 3
   threads, with no synchronising CUDA call flagged by
   ``torch.cuda.set_sync_debug_mode`` besides each round's one event wait,
   and the ring used; then the cost of keeping f32 at the reference's three
   points (decode step and mixed round, device time, against the bf16
   products widened after); (b) the same storm at ``decode_lookahead`` 0;
   (c) at depths 2 and 0, the storm on an engine replaying graphs and on
   one with the private eager switch, every request pending before the
   first admission: the same streams, greedy and seeded; (d)
   phase-separated (``mixed_batch`` off, ``prefill_coalesce`` 4), the same
   8 requests; (e) dense mode (``prefix_cache_pages`` 0), 4 greedy
   requests; (f, g) prefix reuse, mixed and phase-separated: a 1024-token
   head (16 pages), request 0 the head + 200 tokens served alone, then 7
   requests behind the head from 3 threads — 7 hits saving 1024 tokens
   each, only suffixes chunked (mixed), 7 suffix prefills and flash only
   for request 0 (phase-separated), two live chains sharing the 16 head
   pages; (h) the quickstart's default-chat model, tiny-llama, with the
   quickstart's engine options. Every stream gets one terminal event with
   the right reason, the path's kernels were launched (and,
   phase-separated, the ragged kernel never), decode chunks ran as graph
   replays (or eagerly, with the switch), the pool conserves its pages
   (nothing referenced or orphaned, every page free or cached), and every
   greedy token lies within a bf16 margin of the max of the dense forward's
   logits (teacher-forced). At llama-3-8b width also: (i) cancellation and
   deadlines (cancelled while queued, after a 1500-token prompt's first
   512-token chunk, mid-decode from the emit callback with the ring in
   flight, twice; lapses in the queue and mid-decode; an unknown id): one
   terminal event a stream with the JAX reason, the counts, a freed slot
   serving a later request; (ii) preemption to host, forced by wrapping
   ``pool.extend_chain`` here: greedy and seeded streams preempted
   mid-decode and one mid chunked prefill equal their undisturbed runs;
   (iii) tenants: fair admission, ``tenant_max_slots`` held at every round,
   a soft-quota yield that resumes, the hard limits raising at ``submit``;
   (iv) the speculative storm: the quickstart's options at
   ``scheduler_spec_k`` 4 and at 0, two engines over the same weights, 8
   greedy requests (a random 32-token pattern repeated to 256 tokens, 128
   out) and one seeded sampled one from 3 threads, under the sync gate:
   drafts proposed and accepted, the sampled request never armed and equal
   to its k=0 twin, every greedy token through the oracle (on the card a
   greedy stream may part from k=0 at a near-tie: how many are identical,
   and where the others part, is printed), ttft, inter-token latency and
   tokens/s of both; (v') the lockstep engine (``InferenceEngine``, the
   worker's ``scheduler: lockstep``) on the storm's 8 requests as one
   batch: one terminal event a stream, its one prefill through flash (one
   launch a layer) and no paged kernel, the oracle, each greedy first token
   of the padded bucket within the margin of its prompt prefilled alone;
   ttft, inter-token latency and tokens/s beside the mixed storm's, and its
   decode step's device time beside the paged step's; (v'') lockstep
   speculation at bs=1 (a 32-token pattern repeated to 256 tokens, 128 out,
   ``spec_k`` 8): spec off, ``ngram`` and llama-3-8b drafting for itself
   (a perfect draft) at bf16 and at f32 (TF32 off), and a seeded
   independent llama-3-8b draft at bf16: at f32 the speculative streams
   equal spec off token for token, at bf16 every token passes the oracle, a
   sampled draft run (temperature 0.8, seed 42) repeats itself and accepts
   drafts, and the sampler's one-row CDF is the same bits on 200 calls;
   acceptance, its length histogram, tokens/s and the verify round's device
   time beside a decode step's;
5. HTTP, the slice's main path: the port's server built in this process by
   ``server.Host`` (what ``server.main`` runs), serving
   ``local::llama-3-8b`` (random bf16 weights from seed 0, byte tokenizer)
   with the quickstart worker's options (mixed, ring depth 2, decode
   graphs) and a one-slot tiny-llama with ``max_pending: 1``: (a) the
   storm over HTTP, 8 SSE ``/v1/completions`` from 3 client threads
   (``http.client``), prompts of 16..1500 tokens, 32 tokens each, kernel
   counts set to 0 just before and read just after: the SSE contract of
   ``tests/test_e2e_server.py:224-249`` on every stream, usage equal to the
   engine's token count, each stream's token ids (recorded at the engine's
   ``submit``) held to the dense forward by the oracle and its text equal
   to their ``decode``, ragged and decode launched and flash not, decode
   chunks replayed as graphs, I1; client-side ttft, inter-token latency and
   tokens/s printed beside the bare storm's; (b) one greedy request served
   alone: the server's engine emits a fresh engine's token ids for the same
   prompt, and the served text is their ``decode``; (b') the storm's gates
   again on a decode-heavy storm (8 prompts of 32 tokens, 256 tokens each),
   its numbers beside the bare engine's on the same prompts; (c)
   an SSE stream closed after 3 deltas: one ``client_disconnect``
   cancellation within two rounds, a later request served, I1; (d) a
   garbage ``X-Request-Deadline-Ms`` → 400, a lapse while queued behind 8
   busy slots → 408, a lapse mid-stream → ``deadline_exceeded``, a burst on
   the ``max_pending: 1`` model → 429 with ``Retry-After``; (e) one chat
   completion on the tiny-llama quickstart at ``scheduler_spec_k`` 4; (f)
   ``/v1/embeddings`` on bge-base-en (random bf16 weights from a seeded
   generator), 6 requests of 8 inputs of up to 128 tokens: unit norms,
   cosine ≥ 0.999 to an f32 forward of the same weights on the card, usage
   equal to the tokenizer's count, ms per request and vectors/s at the
   socket and bare; (f') a second server with the worker at ``scheduler:
   lockstep`` on llama-3-8b: the HTTP storm's 8 SSE completions from 3
   threads, batched by the worker's window, usage equal to the ids recorded
   at the engine, text their decode, the oracle, flash launched and no
   paged kernel, its numbers at the socket beside the continuous storm's;
   (g) ``python3 -m
   cyberfabric_core_tpu_torch.server run --config`` on the port's
   quickstart at port 0 as a child process: ``/health``, one SSE chat
   completion to ``data: [DONE]``, ``default-embed`` answering, exit code 0
   on SIGTERM; (h) observability, on a host booted from the port's
   quickstart with llama-3-8b added, ``monitoring`` (fault injection
   allowed) and ``tracing`` at ``sample_ratio`` 1.0 to an OTLP collector on
   loopback in this process: the http storm's 8 SSE completions, each with
   its own ``x-request-id`` and sampled ``traceparent``, while a side thread
   scrapes ``/metrics`` every 100 ms, kernel counts set to 0 just before and
   read just after, under the sync gate: each stream's timeline in
   ``/v1/monitoring/requests/{id}`` reads enqueued → admitted →
   prefill_chunk+ → prefill → decode_chunk+ → finished, its chunks' tokens
   sum to the uncached prompt, its derived ttft is at most the client's;
   its ``llm.prefill_chunk`` and ``llm.decode_chunk`` spans reached the
   collector under its trace id; ``tpu_devices`` the card count,
   ``tpu_hbm_bytes_in_use`` between the weights' bytes and the card's
   memory, ``llm_hbm_utilization_per_device`` in (0, 1],
   ``llm_ttft_seconds_count`` +8; the http storm's gates; tokens/s and
   inter-token p50 / p99 at the socket beside the plain http storm's; (i)
   ``POST /v1/monitoring/profiler/start``, two completions, ``.../stop``:
   the chrome trace listed names the ragged kernel (``chunk_kernel``) and
   the decode kernel (``combine_kernel`` less the ragged launches), their
   counts beside the wrappers' launches over the window, and the window's
   ten device ops by time; (j) the doctor's shedding cycle on the
   quickstart's tiny-llama with short windows: ``/readyz`` 200, then
   ``scheduler.readback`` armed over REST as a delay, ``/readyz`` 503
   naming ``slo:itl_p99`` and a new chat 429 ``llm.load_shed`` with
   ``Retry-After`` while a stream is in flight, disarmed: every stream
   through the oracle, ``/readyz`` 200, a chat served; (k) federation, after
   the earlier phases freed their engines: a gateway in this process with
   ``grpc_hub``, ``llm_gateway`` (federation on, no engine) and
   ``monitoring``, serving two worker host processes (``python -m
   cyberfabric_core_tpu_torch.modules.llm_gateway.worker``, ``fedhost-0`` and
   ``fedhost-1``) on ``cuda:0``, each llama-3-8b (random bf16 weights from
   seed 0) at the quickstart worker's options, which load the kernels built
   in phase 2: both announce and ``/v1/monitoring/workers`` lists them, one
   greedy prompt gives the same ids on each host (the same weights); the
   federated storm (the http storm's 8 SSE completions from 3 threads with its
   SSE and usage gates, each stream's token ids, kept at the gateway's pool,
   through the oracle; ttft, inter-token latency and tokens/s at the socket
   beside the one-host http storm's, and each host's rounds); by each host's
   Health RPC, read before and after the storm: its engine on ``cuda``, the
   ragged and decode kernels launched in the host process and flash not,
   mixed rounds and decode graph replays, no eager chunk; one storm
   request's timeline stitched from the gateway and its host;
   ``/v1/monitoring/fleet`` and the hosts' ``llm_*`` series in ``/metrics``
   labelled ``host``; a 1024-token head then 7 requests behind it, all placed
   by ``prefix`` on the head's host, 7 radix hits; SIGKILL of the host serving
   a 256-token greedy stream after 4 deltas: one terminal,
   ``llm_federated_failovers_total`` +1, the continuation through the oracle,
   I1 on the survivor, where the stream parts from the undisturbed one (and
   the dense forward's row there); the storm again on the survivor alone
   (the gRPC hop without a second process on the card; the same host
   gates); then two hosts of a
   4-layer cut at llama-3-8b widths in f32, TF32 off (``--fed-f32-host``):
   the same kill, and the continued stream equal to the undisturbed one token
   for token;
   At llama-3-8b width also: (v) quant-8b, the storm on int8 and
   on int4 engines (random weights quantized as drawn on the card) with
   the storm's gates, the oracle over the same quantized tree, the trees'
   bytes, peak memory, and the decode step's device time of bf16, int8 and
   int4 in turns; (vi) dp, a ``DataParallelServingPool`` of two bf16
   replicas on ``[cuda:0, cuda:0]`` sharing one params tree: a 16-request
   storm (beside one engine on the same requests), a stream whose replica
   breaks after its first token failing over with its full count through
   the oracle, and the lifecycle manager rebuilding the replica into
   probation and promoting it; (vii) pd, a ``PDServingPool`` of 1 prefill
   + 1 decode replica on the storm: one handoff a stream, role-pure rounds,
   I1 on both, the oracle, the handoff ms and the streams identical to the
   unified engine's. Then (viii) mixtral-8x7b int8 at full width (random
   weights from seed 0, quantized as drawn; 43.5 GiB) at the worker's
   options: in bf16 the storm's gates, its numbers, the decode step's
   device time and the peak memory; then the same requests again (decode
   chunks eager) with every eager routed-MoE call within one bf16 ulp of
   the output's scale of its plain per-expert version at the same routing
   and capacity, the bucket drops and the dense-MoE oracle's distances
   printed, each greedy stream's routing flips against the oracle forward
   (top-2 sets per position and layer; the router margin at each flip in
   bf16 ulps beside how far rounding moved the logits there), every token
   before a stream's first flip within the margin, and every greedy token
   within the margin of the dense-MoE oracle routed as the served forward
   routed; in f32 the
   same per-call check, no bucket drop and every greedy token within the
   margin of the dense forward with the dense MoE oracle. Before mixtral, (ix)
   tensor parallelism on the one card (every rank on ``cuda:0``): the storm
   at tp=2 (4 kv heads a rank) on the mixed run's weights with the storm's
   gates (one terminal a stream, I1 on the pool the ranks share, decode
   chunks replayed as graphs, no flagged synchronising call at depth 2), its
   greedy tokens within the margin of the unsharded dense forward, ragged
   launches a mixed round and decode launches a decode chunk exactly tp
   times the mixed run's, and the plan's ``param_bytes_per_rank`` and
   ``kv_bytes_per_device`` equal to each rank's allocated bytes (rank 0's
   weights the plan's ``param_bytes_per_device``); the decode
   step's device time at tp=2 and tp=1 and the share of its rank-order
   reductions; three requests at tp=8 (1 kv head a rank) with the same
   gates, beside tp=1 on them; at llama-3-8b widths and 4 layers in f32,
   TF32 off, every greedy stream at tp=2 equal to tp=1's, graph and eager
   decode streams equal at each degree, and the seeded stream equal to
   tp=1's up to its first difference, where both engines drew the seed's
   uniform, each token follows from its engine's logits and the draw lies
   within the two CDFs' difference of the boundary between the two tokens
   (logits within TP_F32_LOGIT_TOL); llama-3-70b bf16 at tp=1 over the card's
   memory refused by the gate with ``memory_allocated`` unchanged, and 70b
   int8 at tp=8 planned within 80 GB; a host serving llama-3-8b at tp=2
   over HTTP with monitoring: ``llm_mesh_devices`` 2 and the replicas' mesh
   block. Tokens/s, ttft and inter-token latency of tp=2 and tp=8 are
   printed beside tp=1's;
6. golden parity: the five committed HF checkpoints (llama, qwen2, gemma,
   mixtral MoE, outlier llama) through the port's loader at f32 on the
   card, TF32 off: logits through the f32 flash kernel within rtol = atol
   = 1e-4 of transformers' and the greedy continuation through a paged
   mixed engine at f32 (mixtral's routed MoE inside the decode graph)
   equal to transformers'; the f32 entry points and D 64 timed at the
   main-path shapes; then the quantization bounds: the llama,
   qwen2 and outlier fixtures through the quantizing loader at 8 and 4
   bits, mean |Δlogit| against transformers' under 0.02 / 0.12, W8 below
   W4, and the outlier fixture's CE moved less than 0.01 / 0.05 nats;
7. a ``{"kernels": [...]}`` line (the paged kernels' launches from the HTTP
   storm, the speculative storm at k=4 and the federated storm, each read
   just after its run, the federated storm's in its hosts over Health;
   flash's from the phase-separated run, the lockstep storm and the trained
   pair), then
   ``{"ok": true, "device": {...}}`` last.

``python3 chip_smoke.py --tp`` runs the mixed storm at tp=1 and phase (ix)
alone, and prints no result line; ``--federation`` runs the one-host HTTP
storm (with its gates) and phase 5(k) alone, and prints no result line either;
``--train`` runs the training section (3') alone, with no result line.
"""

from __future__ import annotations

import asyncio
import collections
import contextlib
import dataclasses
import gc
import http.client
import http.server
import json
import math
import os
import re
import selectors
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
import types
import warnings
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from cyberfabric_core_tpu_torch import server
from cyberfabric_core_tpu_torch.modkit import failpoints
from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models import toytrain
from cyberfabric_core_tpu_torch.models.configs import MODEL_CONFIGS, get_config
from cyberfabric_core_tpu_torch.ops import _build
from cyberfabric_core_tpu_torch.ops import flash_attention as fa
from cyberfabric_core_tpu_torch.ops import paged_attention as pa
from cyberfabric_core_tpu_torch.ops import sampling
from cyberfabric_core_tpu_torch.ops.attention import attention_with_cache
from cyberfabric_core_tpu_torch.modules.llm_gateway import worker as worker_module
from cyberfabric_core_tpu_torch.modules.llm_gateway.grpc_service import (GrpcLlmWorkerClient,
                                                                       model_ref_dict)
from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import plan_engine
from cyberfabric_core_tpu_torch.modules.sdk import ModelInfo
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.ops.timing import graph_ms
from cyberfabric_core_tpu_torch.parallel.feasibility import (H100_HBM_BYTES,
                                                             InfeasiblePlanError,
                                                             card_hbm_bytes, gate_engine_plan)
from cyberfabric_core_tpu_torch.parallel import pipeline
from cyberfabric_core_tpu_torch.parallel.mesh import StageMesh
from cyberfabric_core_tpu_torch.parallel.ring_attention import ring_attention
from cyberfabric_core_tpu_torch.parallel.sharding import rank_bytes
from cyberfabric_core_tpu_torch.runtime.federation import digest_chain, match_depth
from cyberfabric_core_tpu_torch.runtime.engine import (EngineConfig, InferenceEngine,
                                                       SamplingParams, build_decode_chunk_fn)
from cyberfabric_core_tpu_torch.runtime.lifecycle import LifecycleConfig
from cyberfabric_core_tpu_torch.runtime.pd import PDServingPool
from cyberfabric_core_tpu_torch.runtime.quant import QuantWeight, quantized_bytes
from cyberfabric_core_tpu_torch.runtime.replicas import DataParallelServingPool
from cyberfabric_core_tpu_torch.runtime import programs as programs_module
from cyberfabric_core_tpu_torch.runtime import scheduler as scheduler_module
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.speculative import (DraftModel, build_verify_fn,
                                                           span_verify_logits)
from cyberfabric_core_tpu_torch.runtime.tokenizer import ByteTokenizer
from cyberfabric_core_tpu_torch.runtime.weights import save_llama_params
from cyberfabric_core_tpu_torch.server import BackgroundServer

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12      # dense bf16 tensor-core peak, same source
F32_FLOPS_PER_S = 67e12        # float32 outside the tensor cores, same source
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


#: f32 kernels against their float64 plain versions: rtol = atol = 2e-5 (the
#: JAX flash kernel's own f32 bar); the f32 kernels round only in f32
F32_TOL = 2e-5


def f32_close(out: torch.Tensor, ref: torch.Tensor, rtol: float = F32_TOL,
              atol: float = F32_TOL) -> float:
    """Max |out - ref|; raises unless every element is within atol + rtol *
    |ref| (F32_TOL * (1 + |ref|) by default)."""
    err = (out.double() - ref.double()).abs()
    bad = int((err > atol + rtol * ref.double().abs()).sum())
    if bad or not torch.isfinite(out).all():
        raise AssertionError(f"{bad} f32 elements beyond rtol {rtol}, atol {atol} "
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


def make_pools(gen, N, page, Hkv, D, dev, dtype=torch.bfloat16):
    k = torch.randn((N, page, Hkv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((N, page, Hkv, D), generator=gen, device=dev).to(dtype)
    return k, v


def make_table(B, Pmax, N, seed, dev, share=False):
    rng = np.random.default_rng(seed)
    pt = (rng.permutation(N - 1)[: B * Pmax] + 1).reshape(B, Pmax).astype(np.int32)
    if share:
        pt[1, :2] = pt[0, :2]  # prefix pages shared by rows 0 and 1
    return torch.from_numpy(pt).to(dev)


def i32(xs, dev):
    return torch.tensor(xs, dtype=torch.int32, device=dev)


def bound(nbytes, flops, dtype=torch.bfloat16):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the operations over the peak rate of ``dtype`` (bf16 on the
    tensor cores; f32 on the CUDA cores, where the f32 kernels run), in ms."""
    peak = F32_FLOPS_PER_S if dtype == torch.float32 else BF16_FLOPS_PER_S
    t_b, t_f = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def paged_geometry(Hq, Hkv, page, Pmax, B, Qmax, split_rows, chunks, D=128) -> dict:
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
                   chunk_tc_flops=tiles * Hkv * 64 * 64 * D * 2 * 4)
    return geo


def time_kernel(name, kern, plain, libs, nbytes, flops, err, dtype=torch.bfloat16) -> dict:
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
    b_ms, b_by = bound(nbytes, flops, dtype)
    tol = (f"rtol = atol = {F32_TOL}" if dtype == torch.float32
           else "one bf16 ulp of the plain value")
    log(f"kernel {name} main shapes: ms={ms:.4f} plain_ms={plain_ms:.3f} "
        f"library_ms={library_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
        f"max_abs_err={err:.3e} (tolerance: {tol})")
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
    qr = torch.zeros((B, 8, Hq, D), dtype=q1.dtype, device=q1.device)
    qr[:, 0] = q1
    ones = torch.ones(B, dtype=torch.int32, device=q1.device)
    return pa.ragged_paged_attention(qr, k, v, pt, lens - 1, ones,
                                     sliding_window=window)[:, 0]


def kernel_small_shapes(dev, gen, D=128) -> None:
    """Window, idle rows, shared pages, G=2, 4 and 7, page 16 and 64."""
    for Hq, Hkv, page, Pmax, window in [(4, 2, 16, 6, None), (8, 2, 16, 6, 21),
                                        (32, 8, 64, 4, None), (28, 4, 64, 4, 19)]:
        B = 4
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
    log(f"kernels small shapes, D {D}: decode and ragged within one bf16 ulp of their "
        "plain versions; padding rows zero; ragged q_len=1 == decode bitwise")


def kernel_split_cases(dev, gen, D=128) -> None:
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
        k, v = make_pools(gen, N, page, Hkv, D, dev)
        pt = make_table(B, Pmax, N, 3, dev, share=True)
        lens = i32(lengths, dev)
        q1 = torch.randn((B, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
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
        q = torch.randn((Bs, Qmax, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
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
        qrow = torch.randn((Hq, D), generator=gen, device=dev).to(torch.bfloat16)
        for window in (None, 45):
            outs = []
            for start, qlen in [(pos - 50, 60), (pos - 30, 45),
                                (pos - pa.SHORT_SPAN, pa.SHORT_SPAN + 1)]:
                qc = torch.randn((1, 64, Hq, D), generator=gen, device=dev).to(torch.bfloat16)
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
    log(f"kernels split cases, D {D} ({S} pages per split): decode across split boundaries "
        "and emptying windows within one bf16 ulp, ragged q_len=1 == decode; spans of "
        f"2..{pa.SHORT_SPAN} == decode position by position; a chunk row's bits "
        "independent of its span's start")


def kernel_main_shapes(dev, gen, cfg, page, Pmax, n_pages,
                       dtype=torch.bfloat16) -> dict[str, dict]:
    """Serving shapes of ``cfg``'s heads (the main path's: llama-3-8b): 8
    rows, lengths 128..2048, 64-token pages; bf16, or the f32 entry points
    (held to rtol = atol = F32_TOL, bound by the f32 CUDA-core peak)."""
    B, Hq, Hkv, D = 8, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    esize = torch.empty((), dtype=dtype).element_size()
    close = f32_close if dtype == torch.float32 else bf16_ulp_close
    k, v = make_pools(gen, n_pages, page, Hkv, D, dev, dtype)
    pt = make_table(B, Pmax, n_pages, 2, dev)
    lengths = [128, 384, 640, 896, 1152, 1408, 1664, 2048]
    lens = i32(lengths, dev)
    q1 = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    # a mixed round: one 512-token prompt chunk, six decode rows, one idle row
    Qmax = 512
    hist_l = [1024, 383, 639, 895, 0, 1407, 1663, 2047]
    qlen_l = [512, 1, 1, 1, 0, 1, 1, 1]
    hist, q_lens = i32(hist_l, dev), i32(qlen_l, dev)
    q = torch.randn((B, Qmax, Hq, D), generator=gen, device=dev).to(dtype)

    results = {}
    short = pa.SHORT_SPAN
    geometry = {
        "paged_decode_attention": paged_geometry(Hq, Hkv, page, Pmax, B, 1,
                                                 [[L] for L in lengths], None, D),
        "ragged_paged_attention": paged_geometry(
            Hq, Hkv, page, Pmax, B, Qmax,
            [[h + i + 1 for i in range(ql)] for h, ql in zip(hist_l, qlen_l)
             if 0 < ql <= short],
            [(h, ql) for h, ql in zip(hist_l, qlen_l) if ql > short], D),
    }
    dec = pa.paged_decode_attention(q1, k, v, pt, lens)
    err_dec = close(dec, pa.paged_decode_attention_plain(q1, k, v, pt, lens))
    rag = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens)
    err_rag = close(rag, pa.ragged_paged_attention_plain(q, k, v, pt, hist, q_lens))
    if dtype == torch.bfloat16 and not torch.equal(ragged_one(q1, k, v, pt, lens, None), dec):
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
    kv_row_bytes = Hkv * D * 2 * esize                   # K and V
    dec_bytes = tokens_dec * kv_row_bytes + 2 * B * Hq * D * esize + B * (Pmax + 1) * 4
    dec_flops = 4 * Hq * D * tokens_dec
    rag_tokens = sum(h + ql for h, ql in zip(hist_l, qlen_l) if ql > 0)
    rag_pairs = sum(sum(h + i + 1 for i in range(ql)) for h, ql in zip(hist_l, qlen_l))
    # q is read only at valid span positions; the whole out tensor is
    # written (padding positions are zeros by contract)
    rag_bytes = (rag_tokens * kv_row_bytes + sum(qlen_l) * Hq * D * esize
                 + B * Qmax * Hq * D * esize + B * (Pmax + 2) * 4)
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
        results[name] = time_kernel(f"{name} [{cfg.name}]", kern, plain, libs, nbytes, flops,
                                    err, dtype)
        ms, geo = results[name]["ms"], geometry[name]
        rate = (f" (chunk path: {geo['chunk_tc_flops'] / 1e9:.2f} GFLOP of tensor-core "
                f"work over {geo['chunk_tiles']} tiles, "
                f"{geo['chunk_tc_flops'] / ms / 1e9:.1f} TFLOP/s if it took the whole call)"
                if "chunk_tiles" in geo and dtype == torch.bfloat16 else "")
        log(f"kernel {name} [{cfg.name}] main shapes: blocks {geo}; achieved "
            f"{nbytes / ms / 1e6:.1f} GB/s and {flops / ms / 1e9:.2f} TFLOP/s of the "
            f"counted work against bound {results[name]['bound_ms']:.4f} ms and library "
            f"{results[name]['library_ms']:.4f} ms{rate}")
    return results


def flash_case(dev, gen, T, Hq, Hkv, lengths, window, D=128, dtype=torch.bfloat16):
    B = len(lengths)
    q, k, v = (torch.randn((B, T, h, D), generator=gen, device=dev).to(dtype)
               for h in (Hq, Hkv, Hkv))
    lens = i32(lengths, dev)
    out = fa.flash_self_attention(q, k, v, lens, sliding_window=window)
    close = f32_close if dtype == torch.float32 else bf16_ulp_close
    err = close(out, fa.flash_self_attention_plain(q, k, v, lens, sliding_window=window))
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


def flash_groups_and_dims(dev, gen) -> None:
    """Every group size 1..8 at every head dim: 2 kv heads, T = 150 (not a
    multiple of a block's 128 // G positions), a 41-token row, a window at
    odd G."""
    for D in fa.HEAD_DIMS:
        for G in range(1, 9):
            flash_case(dev, gen, 150, 2 * G, 2, [150, 41], 37 if G % 2 else None, D)
    torch.cuda.synchronize()
    log(f"kernel flash at D {fa.HEAD_DIMS} x G 1..8: within one bf16 ulp of the plain "
        "version; rows past the length zero")


def kernel_f32(dev, gen) -> None:
    """The f32 entry points of the three kernels at every head dim, G=2 and
    G=7, a window, an idle ragged row's padding, flash rows past the length:
    within rtol = atol = F32_TOL of the float64 plain versions."""
    worst = 0.0
    for D in pa.HEAD_DIMS:
        for Hq, Hkv in ((4, 2), (7, 1)):
            B, Qmax, page, Pmax = 3, 16, 16, 4
            N = B * Pmax + 2
            k, v = make_pools(gen, N, page, Hkv, D, dev, torch.float32)
            pt = make_table(B, Pmax, N, 5, dev, share=True)
            q = torch.randn((B, Qmax, Hq, D), generator=gen, device=dev)
            hist, q_lens, lens = i32([0, 5, 30], dev), i32([16, 3, 0], dev), i32([1, 17, 64], dev)
            for window in (None, 11):
                rag = pa.ragged_paged_attention(q, k, v, pt, hist, q_lens, sliding_window=window)
                worst = max(worst, f32_close(rag, pa.ragged_paged_attention_plain(
                    q, k, v, pt, hist, q_lens, window)))
                if not bool((rag[1, 3:] == 0).all() and (rag[2] == 0).all()):
                    raise AssertionError(f"f32 ragged padding rows are not zero (D {D})")
                q1 = q[:, 0].contiguous()
                dec = pa.paged_decode_attention(q1, k, v, pt, lens, sliding_window=window)
                worst = max(worst, f32_close(dec, pa.paged_decode_attention_plain(
                    q1, k, v, pt, lens, window)))
                _, err = flash_case(dev, gen, 80, Hq, Hkv, [80, 33], window, D, torch.float32)
                worst = max(worst, err)
    torch.cuda.synchronize()
    log(f"kernels f32 at D {pa.HEAD_DIMS}, G 2 and 7: decode, ragged and flash within "
        f"rtol = atol = {F32_TOL} of their float64 plain versions (max abs err {worst:.3e})")


def flash_geometry(T, Hq, Hkv, lengths, window=None, D=128) -> dict:
    """What the flash kernel walks for one call, from its inputs as the kernel
    reads them: blocks of 128 (position, head) rows (128 // G positions),
    those that load (first position below the length), the K/V tiles of bk
    keys they load (64, or 32 at D 256), and the (64-row warpgroup, tile)
    products they compute: Q.K once and P.V three times (P as three bf16
    terms) on the tensor cores."""
    G = Hq // Hkv
    P, bk = 128 // G, (32 if D > 128 else 64)
    R = P * G

    def tiles(p0, p1, L):   # tiles of positions p0..p1 that see a key
        first = max(0, p0 - window + 1) if window else 0
        return min(p1, L - 1) // bk - first // bk + 1

    working = loaded = wg_tiles = 0
    for L in lengths:
        for p0 in range(0, min(L, T), P):
            working += 1
            loaded += tiles(p0, p0 + P - 1, L)
            for w in range(2):
                w0, w1 = p0 + w * 64 // G, p0 + min(w * 64 + 63, R - 1) // G
                if w0 < L:
                    wg_tiles += tiles(w0, w1, L)
    return {"blocks": -(-T // P) * Hkv * len(lengths), "working": working * Hkv,
            "kv_tiles": loaded * Hkv, "wg_tiles": wg_tiles * Hkv, "bk": bk,
            "tc_flops": wg_tiles * Hkv * 64 * bk * D * 2 * 4}


def flash_main_shape(dev, gen, cfg, dtype=torch.bfloat16) -> dict:
    """The coalesced batch_prefill group of the serving storm's two longest
    prompts at bucket 2048: B=2, T=2048, lengths [1300, 1500], at ``cfg``'s
    heads, in ``dtype``."""
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    esize = torch.empty((), dtype=dtype).element_size()
    lengths, T = [1300, 1500], 2048
    (q, k, v, lens), err = flash_case(dev, gen, T, Hq, Hkv, lengths, None, D, dtype)
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
    log(f"kernel flash_self_attention [{cfg.name}] main shapes: {causal_label} agrees with "
        f"the kernel below each length within {diff:.3e} (a yardstick's own bf16 arithmetic)")
    pairs = sum(n * (n + 1) // 2 for n in lengths)
    tokens = sum(lengths)
    # q read at valid positions, K+V of the valid tokens, the whole output
    # written (rows past the length are zeros by contract), the lengths
    nbytes = (tokens * Hq * D * esize + tokens * Hkv * D * 2 * esize
              + len(lengths) * T * Hq * D * esize + len(lengths) * 4)
    result = time_kernel(
        f"flash_self_attention [{cfg.name}]",
        lambda: fa.flash_self_attention(q, k, v, lens),
        lambda: fa.flash_self_attention_plain(q, k, v, lens),
        {"SDPA masked": lambda: sdpa(qq, kk, vv, attn_mask=mask), causal_label: causal},
        nbytes, 4 * Hq * D * pairs, err, dtype)
    if dtype == torch.float32:  # a CUDA-core kernel: no tensor-core tiles to count
        return result
    geo, ms = flash_geometry(T, Hq, Hkv, lengths, D=D), result["ms"]
    log(f"kernel flash_self_attention [{cfg.name}] main shapes: blocks {geo}; "
        f"{geo['tc_flops'] / 1e9:.2f} GFLOP of tensor-core work over {geo['wg_tiles']} "
        f"(64-row, {geo['bk']}-key) tiles, {geo['tc_flops'] / ms / 1e9:.1f} TFLOP/s; "
        f"{4 * Hq * D * pairs / ms / 1e9:.2f} TFLOP/s of the counted work")
    return result


# ------------------------------------------------------------------ serving phase
def engine_config_from_options(opts: dict) -> EngineConfig:
    """The llm-gateway worker's mapping (``plan_engine``) of a registry entry
    with these ``engine_options`` and no checkpoint: the engine the server
    builds for it (synthetic weights, the byte tokenizer's end of
    sequence)."""
    name = opts["model_config"]
    return plan_engine(ModelInfo(canonical_id=f"local::{name}", provider_slug="local",
                                 provider_model_id=name, engine_options=dict(opts))).config


def serve(engine, requests, n_threads=3, timeout=600.0, at_once=False, last_alone=False):
    """Submit (prompt, SamplingParams) from ``n_threads`` threads; wait for
    every terminal event. Returns per request (tokens, reasons, submit_t,
    first_t). ``at_once``: one thread submits every request while the
    engine's scheduler thread is stopped (a running one would admit them as
    they arrive; ``submit`` restarts it, and that start is held back until
    the last submit), so the first admission sees them all and two engines
    run the same rounds. ``last_alone``: the scheduler is held the same
    way while ``n_threads`` threads submit all requests but the last, which
    goes in after them: it is the last one taken from the queue."""
    recs = [{"toks": [], "fins": [], "t0": None, "t1": None, "ts": []} for _ in requests]
    lock, done, left = threading.Lock(), threading.Event(), [len(requests)]

    def emit_for(i):
        def emit(ev):
            r = recs[i]
            now = time.perf_counter()
            if r["t1"] is None:
                r["t1"] = now
            r["ts"].append(now)
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

    def threaded(n):
        threads = [threading.Thread(target=submitter, args=(range(t, n, n_threads),))
                   for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout)

    if at_once or last_alone:
        engine.shutdown()  # the scheduler thread an earlier request started
        engine.start = lambda: None  # shadows the method until every request is in
        try:
            if at_once:
                submitter(range(len(requests)))
            else:
                threaded(len(requests) - 1)
                submitter([len(requests) - 1])
        finally:
            del engine.start
        engine.start()
    else:
        threaded(len(requests))
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
    gaps, runner_up = dense_gaps(params, cfg, rope, prompt, toks)
    return float(gaps.max()), runner_up


def dense_gaps(params, cfg, rope, prompt, toks) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`dense_margin` per emitted token: (row max - the token's logit)
    [n], and each row's top-1/top-2 gap [n]."""
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
    return logits.max(dim=1).values - got, top2[:, 0] - top2[:, 1]


QUICKSTART = {"model_config": "llama-3-8b", "max_seq_len": 2048, "max_batch": 8,
              "prefix_page_size": 64, "decode_chunk": 8,
              "prefill_budget_tokens": 512, "mixed_batch": True}


def build_engine(label: str, opts: dict, params=None, eager_decode: bool = False):
    """An engine on the card from worker-shaped ``opts``; ``eager_decode``
    sets the engine's private switch (decode chunks enqueued launch by
    launch, no CUDA graph) for a comparison run."""
    ecfg = engine_config_from_options(opts)
    t = time.perf_counter()
    engine = ContinuousBatchingEngine(ecfg, params=params, seed=0,  # on the card
                                      _eager_decode=eager_decode)
    log(f"serving engine [{label}] built: {ecfg.model}, {engine.stats()['mode']}, "
        f"{engine.stats()['pages_total']} pages, use_flash={engine.use_flash}, decode "
        f"graphs={engine.stats()['pipeline']['decode_graphs']}, "
        f"{time.perf_counter() - t:.1f} s (graph capture included)")
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


def check_pool(label: str, stats: dict) -> None:
    """The pool's conservation invariant (I1) once every stream is done:
    nothing referenced or orphaned, every page free or held by the tree."""
    if (stats["pages_referenced"] or stats["orphan_pages"]
            or stats["pages_free"] + stats["cached_pages"] != stats["pages_total"]):
        raise AssertionError(f"[{label}] pages not conserved: {stats}")


def oracle(label: str, engine, recs, requests, min_caught=MIN_RUNNER_UP_CAUGHT) -> None:
    """Every greedy token within LOGIT_MARGIN of the dense forward's max
    logit (teacher-forced), and the margin able to see a wrong token at
    ``min_caught`` of the greedy rows (None: printed, not required)."""
    cfg = engine.model_config
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
        f"(least allowed {min_caught})")
    if min_caught is not None and caught < min_caught:
        raise AssertionError(f"[{label}] the margin {LOGIT_MARGIN} admits the runner-up "
                             f"token at {1 - caught:.3f} of rows: the oracle cannot see "
                             "a wrong token")


def pipeline_line(card: str, label: str, stats: dict) -> None:
    """The ring's use and each round kind's mean dispatch, sync-wait and
    host-emit ms (engine lifetime)."""
    pipe = stats["pipeline"]
    kinds = "; ".join(
        f"{kind} x{v['count']}: dispatch {v['dispatch_ms'] / v['count']:.2f} "
        f"sync-wait {v['sync_wait_ms'] / v['count']:.2f} "
        f"host-emit {v['host_emit_ms'] / v['count']:.2f}"
        for kind, v in pipe["ms_by_kind"].items() if v["count"])
    log(f"info [{card}] serving [{label}] pipeline: depth {pipe['depth']}, lookahead "
        f"{pipe['lookahead']}, depth at drain {pipe['depth_hist']}; mean ms a round: {kinds}")
    # each round in order: kind, ring entries left at its drain (a mixed
    # round: chunks it chained), dispatch / sync-wait / host-emit ms
    timeline = " ".join(f"{t['kind'][0]}{t['depth']}:{t['dispatch_ms']:.0f}/"
                        f"{t['sync_wait_ms']:.0f}/{t['host_emit_ms']:.1f}"
                        for t in stats["round_timings"][-40:])
    log(f"info [{card}] serving [{label}] rounds (last 40, engine lifetime): {timeline}")


@contextlib.contextmanager
def watch_syncs():
    """PyTorch's sync debug mode set to warn while the block runs; yields a
    list that receives, by the line of Python that made it, every flagged
    call (a blocking copy, ``.item()``, a stream sync; an event wait is not
    one of them) from every thread."""
    flagged: list[str] = []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            yield flagged
        finally:
            torch.cuda.set_sync_debug_mode("default")
            flagged += [f"{w.filename}:{w.lineno}" for w in caught
                        if "called a synchronizing CUDA operation" in str(w.message)]


def serving_phase(card: str, label: str, engine, ecfg, requests,
                  launched: tuple, never: tuple = (), sync_free: bool = False,
                  at_once: bool = False, last_alone: bool = False,
                  min_caught=MIN_RUNNER_UP_CAUGHT,
                  check_oracle: bool = True,
                  graphs_required: bool = True) -> tuple[dict[str, int], dict, list]:
    """Serve ``requests`` with every kernel count set to 0 just before and
    read just after; the kernels in ``launched`` must have run and those in
    ``never`` must not. Checks streams, pages and the dense oracle; prints
    ttft, tokens/s and the pipeline split. ``sync_free``: no synchronising
    CUDA call may be flagged while it serves. A paged engine's decode chunks
    must have run as it was built to (graph replays, or eager with its
    private switch; ``graphs_required=False``: none need have run, as in a
    speculative storm whose rounds may all verify drafts). Returns this
    run's launch counts, the engine's stats and the streams."""
    before = engine.stats()
    try:
        for _, _, wrapper in KERNELS.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        with watch_syncs() if sync_free else contextlib.nullcontext() as flagged:
            recs = serve(engine, requests, at_once=at_once, last_alone=last_alone)
        wall = time.perf_counter() - t0
    finally:
        engine.shutdown()
    # read once the scheduler thread has stopped (its last round included)
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    stats = engine.stats()
    # this run's ragged rounds (mixed and prefill kinds) and decode chunks
    # (the counts above are this run's)
    stats["run"] = {key: sum(stats["pipeline"][k] - before["pipeline"][k] for k in keys)
                    for key, keys in (("mixed_rounds", ("mixed_rounds",)),
                                      ("decode_chunks", ("decode_graph_replays",
                                                         "decode_eager_chunks")))}
    check_streams(recs, requests, lambda sp: set(sp.stop_token_ids) | set(ecfg.eos_token_ids))
    if any(launches[n] <= 0 for n in launched) or any(launches[n] for n in never):
        raise AssertionError(f"[{label}] launches {launches}: expected {launched} "
                             f"to run and {never} never")
    check_pool(label, stats)
    pipe = stats["pipeline"]
    if stats["mode"] != "dense":
        graphs = pipe["decode_graphs"]
        ran = pipe["decode_graph_replays"] if graphs else pipe["decode_eager_chunks"]
        other = pipe["decode_eager_chunks"] if graphs else pipe["decode_graph_replays"]
        if (ran <= 0 and graphs_required) or other:
            raise AssertionError(f"[{label}] decode chunks: graphs={graphs}, replays "
                                 f"{pipe['decode_graph_replays']}, eager "
                                 f"{pipe['decode_eager_chunks']}")
    log(f"serving [{label}]: {len(requests)} requests done, reasons "
        f"{[r['fins'][-1] for r in recs]}, rounds {stats['rounds']}, decode chunks: "
        f"{pipe['decode_graph_replays']} graph replays, {pipe['decode_eager_chunks']} "
        f"eager; prefill chunks "
        f"{stats['prefill_chunks']}, prefill dispatches {stats['prefill_dispatches']} "
        f"(coalesced {stats['coalesced_prefills']}), launches {launches}, pages "
        f"conserved ({stats['pages_free']} free + {stats['cached_pages']} cached of "
        f"{stats['pages_total']})")
    log(f"serving [{label}] wall ms by round kind (engine lifetime): {stats['round_ms']}; "
        f"phase-separated prefill ms {stats['prefill_ms']:.1f}")
    if sync_free:
        log(f"serving [{label}] synchronising CUDA calls flagged while serving: "
            f"{len(flagged)} {sorted(set(flagged))}")
        if flagged:
            raise AssertionError(f"[{label}] a round waited on the device outside its "
                                 f"drain: {sorted(set(flagged))}")
    if check_oracle:
        oracle(label, engine, recs, requests, min_caught)
    pipeline_line(card, label, stats)
    numbers = latency_numbers([r["t0"] for r in recs], [r["ts"] for r in recs],
                              sum(len(r["toks"]) for r in recs), wall)
    STORM_NUMBERS[label] = numbers
    log(f"info [{card}] serving [{label}]: {format_latency(numbers)}")
    return launches, stats, recs


#: label → the latency numbers of a serving run (read by the HTTP phase)
STORM_NUMBERS: dict[str, dict] = {}
#: each HTTP storm's rounds by kind (:func:`round_split`), by label
STORM_SPLITS: dict[str, dict] = {}
#: the speculative storm's kernel launches (k=4), for the kernels line
SPEC_LAUNCHES: dict[str, int] = {}


def latency_numbers(starts, stamps, n_tokens: int, wall: float) -> dict:
    """ttft (first event after the start) p50 / max and the gaps between a
    stream's consecutive events p50 / p99, in ms; tokens per second of
    wall time."""
    ttft = sorted((ts[0] - t0) * 1e3 for t0, ts in zip(starts, stamps))
    gaps = sorted((b - a) * 1e3 for ts in stamps for a, b in zip(ts, ts[1:]))

    def q(vals, p):
        return vals[min(len(vals) - 1, int(p * len(vals)))] if vals else float("nan")

    return {"ttft_p50_ms": q(ttft, 0.5), "ttft_max_ms": ttft[-1], "itl_p50_ms": q(gaps, 0.5),
            "itl_p99_ms": q(gaps, 0.99), "tokens": n_tokens, "wall_s": wall,
            "tokens_per_s": n_tokens / wall}


def format_latency(n: dict) -> str:
    return (f"ttft_ms p50={n['ttft_p50_ms']:.1f} max={n['ttft_max_ms']:.1f}; inter-token ms "
            f"p50={n['itl_p50_ms']:.2f} p99={n['itl_p99_ms']:.2f}; {n['tokens']} tokens in "
            f"{n['wall_s']:.2f} s = {n['tokens_per_s']:.1f} tokens/s")


HEAD, HEAD_SUFFIXES = 1024, [200, 16, 64, 128, 200, 256, 333, 400]


def prefix_requests(vocab: int) -> list:
    """Requests behind one 1024-token head (16 pages of 64): request 0 the
    head + 200 tokens, then the head + 16..400 tokens; 32 output tokens
    each, request 5 sampled with a seed."""
    rng = np.random.default_rng(11)
    head = rng.integers(3, vocab, HEAD).tolist()
    requests = [(head + rng.integers(3, vocab, n).tolist(), SamplingParams(max_tokens=32))
                for n in HEAD_SUFFIXES]
    requests[5] = (requests[5][0], SamplingParams(max_tokens=32, temperature=0.8, seed=42))
    return requests


def prefix_phase(card: str, label: str, engine, ecfg, mixed: bool) -> dict[str, int]:
    """Serve request 0 alone (its prompt's full pages reach the radix tree
    when its prefill is done), then requests 1-7 from 3 threads, with every
    kernel count set to 0 before request 0 and read after the last. Gates:
    7 hits saving 1024 tokens each; mixed: only the suffixes chunked;
    phase-separated: 7 suffix prefills and flash launched for request 0
    alone; two live chains sharing the 16 head pages; the decode kernel
    launched; streams, pages and the oracle."""
    requests = prefix_requests(engine.model_config.vocab_size)
    head_pages = HEAD // ecfg.prefix_page_size
    try:
        for _, _, wrapper in KERNELS.values():
            wrapper.launches = 0
        t0 = time.perf_counter()
        recs = serve(engine, requests[:1], n_threads=1)
        flash_cold = fa.flash_self_attention.launches
        recs += serve(engine, requests[1:])
        wall = time.perf_counter() - t0
    finally:
        engine.shutdown()
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    stats = engine.stats()
    check_streams(recs, requests, lambda sp: set(sp.stop_token_ids) | set(ecfg.eos_token_ids))
    check_pool(label, stats)
    pc = stats["prefix_cache"]
    hits = len(requests) - 1
    failures = []
    if pc["hits"] < hits or pc["prefill_tokens_saved"] < hits * HEAD:
        failures.append(f"hits {pc['hits']}, tokens saved {pc['prefill_tokens_saved']}")
    if stats["max_shared_chain_pages"] < head_pages:
        failures.append(f"max shared chain pages {stats['max_shared_chain_pages']}")
    if launches["paged_decode_attention"] <= 0:
        failures.append("the decode kernel never ran")
    if mixed:
        suffix_only = len(requests[0][0]) + sum(len(p) - HEAD for p, _ in requests[1:])
        if stats["chunked_prefill_tokens"] > suffix_only or launches["ragged_paged_attention"] <= 0:
            failures.append(f"chunked prefill tokens {stats['chunked_prefill_tokens']} "
                            f"(suffixes only: {suffix_only}), launches {launches}")
    elif (stats["suffix_prefills"] != hits or flash_cold <= 0
          or launches["flash_self_attention"] != flash_cold
          or launches["ragged_paged_attention"]):
        failures.append(f"suffix prefills {stats['suffix_prefills']}, flash launches "
                        f"{flash_cold} for request 0 and {launches['flash_self_attention']} "
                        f"in all, launches {launches}")
    if failures:
        raise AssertionError(f"[{label}] " + "; ".join(failures) + f": {stats}")
    log(f"serving [{label}]: {len(requests)} requests done, reasons "
        f"{[r['fins'][-1] for r in recs]}; prefix cache {pc}; max shared chain pages "
        f"{stats['max_shared_chain_pages']}; chunked prefill tokens "
        f"{stats['chunked_prefill_tokens']}, suffix prefills {stats['suffix_prefills']}, "
        f"launches {launches} (flash {flash_cold} for request 0)")
    oracle(label, engine, recs, requests)
    pipeline_line(card, label, stats)
    ttft = [(r["t1"] - r["t0"]) * 1e3 for r in recs]
    hit_ttft = sorted(ttft[1:])
    n_tok = sum(len(r["toks"]) for r in recs)
    log(f"info [{card}] serving [{label}]: ttft_ms request 0 (cold, {len(requests[0][0])} "
        f"tokens)={ttft[0]:.1f}; hits p50={hit_ttft[len(hit_ttft) // 2]:.1f} "
        f"max={hit_ttft[-1]:.1f} (suffixes {HEAD_SUFFIXES[1:]}); {n_tok} tokens in "
        f"{wall:.2f} s = {n_tok / wall:.1f} tokens/s")
    return launches


def repair_a_cost(card: str, engine) -> None:
    """Device time (CUDA-graph replay) at llama-3-8b of one decode step (8
    rows: forward_paged_decode and the head) and of one mixed round's forward
    (8 rows x 512 positions, a 512-token chunk beside six decode rows, and
    the head on each row's last), with the f32 products the reference keeps
    (this tree's ``_mm_f32``) and with the rounding before them (each product
    in bf16, widened after; llama-3-8b has no q/k/v bias), in turns."""
    params, cfg, pools = engine.params, engine.model_config, (engine.pool.k_pool,
                                                              engine.pool.v_pool)
    dev, rope = params.device, engine.rope_tables
    B, Qmax, Pmax = 8, 512, engine.pmax
    pt = make_table(B, Pmax, engine.pool.k_pool.shape[1], 9, dev)
    rng = np.random.default_rng(9)
    ids1 = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, 1)).astype(np.int32)).to(dev)
    ids = torch.from_numpy(rng.integers(3, cfg.vocab_size, (B, Qmax)).astype(np.int32)).to(dev)
    lens = i32([127, 383, 639, 895, 1151, 1407, 1663, 2046], dev)
    hist, q_lens = i32([1024, 383, 639, 895, 0, 1407, 1663, 2046], dev), \
        i32([512, 1, 1, 1, 0, 1, 1, 1], dev)

    def decode():
        h, _ = llama.forward_paged_decode(params, cfg, ids1, pools, pt, lens, rope)
        llama.lm_head_logits(params, cfg, h[:, 0])

    def mixed():
        h, _ = llama.forward_paged_mixed(params, cfg, ids, pools, pt, hist, q_lens, rope)
        llama.lm_head_logits(params, cfg, llama.gather_last_hidden(h, q_lens))

    f32_points = llama._mm_f32
    variants = {"f32 points": f32_points,
                "bf16 products widened after": lambda x, w: (x @ w).float()}
    times = {label: [] for label in variants}
    try:
        with torch.inference_mode():
            for label in list(variants) + list(variants)[::-1]:
                llama._mm_f32 = variants[label]
                times[label].append((graph_ms(decode, iters=10, reps=5),
                                     graph_ms(mixed, iters=2, reps=3)))
    finally:
        llama._mm_f32 = f32_points
    for label, ts in times.items():
        log(f"info [{card}] repair A cost [{label}]: decode step "
            + ", ".join(f"{d:.4f}" for d, _ in ts) + " ms; mixed round forward "
            + ", ".join(f"{m:.3f}" for _, m in ts) + " ms (device time, in turns)")


def compare_streams(label: str, a: list, b: list) -> None:
    """Two runs' streams, token for token and reason for reason."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x["toks"] != y["toks"] or x["fins"] != y["fins"]:
            raise AssertionError(f"[{label}] request {i}: {x['toks']} {x['fins'][-1]} against "
                                 f"{y['toks']} {y['fins'][-1]}")


def graphs_against_eager(card: str, params, requests, depth: int) -> None:
    """The storm at ``depth`` on two engines over the same weights, one
    replaying its decode chunks as CUDA graphs, one with the private eager
    switch, every request pending before the first admission (the same
    rounds on both): greedy and seeded streams must be equal; the graph run
    must make no synchronising call beside its drains."""
    opts = dict(QUICKSTART, decode_lookahead=depth)
    runs = {}
    for eager in (False, True):
        label = f"mixed, depth {depth}, {'eager' if eager else 'graphs'}, at once"
        engine, ecfg = build_engine(label, opts, params, eager_decode=eager)
        serve(engine, [(requests[3][0], SamplingParams(max_tokens=12))], 1)
        _, _, runs[eager] = serving_phase(
            card, label, engine, ecfg, requests,
            launched=("ragged_paged_attention", "paged_decode_attention"),
            never=("flash_self_attention",), sync_free=not eager, at_once=True,
            check_oracle=not eager)
        del engine
        torch.cuda.empty_cache()
    compare_streams(f"depth {depth}, graphs against eager", runs[False], runs[True])
    log(f"serving [depth {depth}]: graph-replayed and eager decode chunks give the same "
        f"{len(requests)} streams (greedy and seeded), token for token")


TINY_QUICKSTART = {"model_config": "tiny-llama", "max_seq_len": 2048, "max_batch": 8}


def tiny_quickstart_run(card: str) -> None:
    """The quickstart's default-chat model, tiny-llama (D 16, G 2), with the
    quickstart's engine options as the worker maps them (mixed, ring depth
    2, decode graphs): 8 requests of 16..1500 tokens from 3 threads, one
    sampled with a seed."""
    engine, ecfg = build_engine("tiny-llama quickstart", TINY_QUICKSTART)
    rng = np.random.default_rng(3)
    vocab = engine.model_config.vocab_size
    requests = [(rng.integers(3, vocab, n).tolist(), SamplingParams(max_tokens=32))
                for n in (16, 96, 250, 511, 700, 1000, 1300, 1500)]
    requests[5] = (requests[5][0], SamplingParams(max_tokens=32, temperature=0.8, seed=42))
    serving_phase(card, "tiny-llama quickstart", engine, ecfg, requests,
                  launched=("ragged_paged_attention", "paged_decode_attention"),
                  never=("flash_self_attention",), min_caught=None)
    del engine
    torch.cuda.empty_cache()


class Streams:
    """Per-request records of a run driven case by case: tokens, terminal
    reasons, submit and terminal times, and an optional hook per request
    called with each event on the scheduler thread."""

    def __init__(self) -> None:
        self.recs: dict[str, dict] = {}
        self._lock = threading.Lock()
        self._open = 0
        self.done = threading.Event()

    def emit_for(self, rid: str, hook=None):
        rec = self.recs[rid] = {"toks": [], "fins": [], "t0": time.perf_counter(),
                                "t_end": None}
        with self._lock:
            self._open += 1
            self.done.clear()

        def emit(ev):
            if ev.token_id >= 0:
                rec["toks"].append(ev.token_id)
            if hook is not None:
                hook(ev, rec)
            if ev.finished is not None:
                rec["fins"].append(ev.finished)
                rec["t_end"] = time.monotonic()
                with self._lock:
                    self._open -= 1
                    if self._open == 0:
                        self.done.set()
        return emit

    def wait(self, engine, timeout=600.0) -> None:
        if not self.done.wait(timeout):
            raise AssertionError(f"requests did not finish: {engine.stats()}")


@contextlib.contextmanager
def held(engine):
    """Hold the engine's scheduler thread while requests go in, so the first
    admission sees them all (the same rounds every run)."""
    engine.shutdown()
    engine.start = lambda: None  # shadows the method until the block ends
    try:
        yield
    finally:
        del engine.start
    engine.start()


def one_terminal(label: str, streams: Streams, want: dict[str, str]) -> None:
    for rid, reason in want.items():
        fins = streams.recs[rid]["fins"]
        if fins != [reason]:
            raise AssertionError(f"[{label}] {rid}: terminal events {fins}, want [{reason!r}]")


def flush_prefix_cache(engine) -> None:
    """Evict every page the radix tree holds, the engine idle (no chain
    references a page), so the next run prefills cold: the pool's own
    allocator evicts them, and the pages go straight back."""
    pool = engine.pool
    if pool._refs:
        raise AssertionError("flush_prefix_cache needs an idle pool")
    ids = pool._alloc(pool.capacity_pages)
    pool.allocator.free([p - pool._page_offset for p in ids])
    check_pool("flush", engine.stats())


def cancel_phase(card: str, params) -> None:
    """Cancellation and deadlines at llama-3-8b width, quickstart options
    (mixed, ring depth 2, decode graphs), seven requests in at once:
    cancelled while queued; a 1500-token prompt cancelled after its first
    512-token chunk; a decode cancelled from its own emit callback at its
    20th token (the ring in flight), then cancelled again (a no-op); a
    deadline that lapses in the queue; a deadline that lapses mid-decode;
    two survivors (one greedy, one seeded). Also a cancel of an unknown id
    (False). Gates: one terminal event a stream with the JAX reason, the
    greedy survivor within the teacher-forced margin, the cancellation
    counts, pages conserved, and a freed slot serving a later request."""
    label = "cancel and deadlines"
    engine, ecfg = build_engine(label, QUICKSTART, params)
    vocab = engine.model_config.vocab_size
    rng = np.random.default_rng(21)
    prompt = {rid: rng.integers(3, vocab, n).tolist() for rid, n in
              (("queued", 300), ("prefill", 1500), ("decode", 250), ("lapse-queued", 200),
               ("lapse-decode", 100), ("survivor", 700), ("survivor-seeded", 96))}
    sp = {rid: SamplingParams(max_tokens=32) for rid in prompt}
    sp["decode"] = SamplingParams(max_tokens=64)
    sp["lapse-decode"] = SamplingParams(max_tokens=1500)
    sp["survivor-seeded"] = SamplingParams(max_tokens=32, temperature=0.8, seed=5)
    streams, second = Streams(), []

    def cancel_at_20(ev, rec):
        if len(rec["toks"]) == 20 and not rec["fins"]:
            engine.cancel("decode", "client_disconnect")
            second.append(engine.cancel("decode", "client_disconnect"))

    mixed_round = engine._decode_round_mixed

    def round_hook():  # after each mixed round: cut the long prompt after 512
        kind = mixed_round()
        st = next((st for st in engine.slots if st is not None and st.request_id == "prefill"),
                  None)
        if st is not None and st.phase == "prefill" and st.prefill_pos >= 512:
            engine.cancel("prefill", "client_disconnect")
        return kind

    engine._decode_round_mixed = round_hook
    lapse_at = None
    try:
        with held(engine):
            for rid in ("prefill", "queued", "decode", "lapse-queued", "lapse-decode",
                        "survivor", "survivor-seeded"):
                deadline = None
                if rid == "lapse-queued":
                    deadline = time.monotonic()
                elif rid == "lapse-decode":
                    deadline = lapse_at = time.monotonic() + 4.0
                engine.submit(prompt[rid], sp[rid],
                              streams.emit_for(rid, cancel_at_20 if rid == "decode" else None),
                              request_id=rid, deadline=deadline)
            if not engine.cancel("queued", "client_disconnect"):
                raise AssertionError(f"[{label}] the queued request was not visible")
        if engine.cancel("no-such-request"):
            raise AssertionError(f"[{label}] cancel of an unknown id returned True")
        streams.wait(engine)
        engine.cancel("decode", "client_disconnect")  # after its terminal: a no-op
        later = Streams()
        engine.submit(rng.integers(3, vocab, 64).tolist(), SamplingParams(max_tokens=16),
                      later.emit_for("later"), request_id="later")
        later.wait(engine)
    finally:
        engine.shutdown()
    stats = engine.stats()
    one_terminal(label, streams, {"queued": "cancelled", "prefill": "cancelled",
                                  "decode": "cancelled", "lapse-queued": "deadline",
                                  "lapse-decode": "deadline", "survivor": "length",
                                  "survivor-seeded": "length"})
    one_terminal(label, later, {"later": "length"})
    rec = streams.recs
    checks = {
        "queued and lapsed-in-queue requests emit nothing":
            not rec["queued"]["toks"] and not rec["lapse-queued"]["toks"],
        "the long prompt is cancelled before its first token": not rec["prefill"]["toks"],
        "the decode is cancelled within a round of its 20th token":
            20 <= len(rec["decode"]["toks"]) < 64,
        "the second cancel found the request (still in its slot)": second == [True],
        "the mid-decode lapse emitted tokens first": 0 < len(rec["lapse-decode"]["toks"]) < 1500,
        "survivors complete": len(rec["survivor"]["toks"]) == 32
        and len(rec["survivor-seeded"]["toks"]) == 32 and len(later.recs["later"]["toks"]) == 16,
        "cancellation counts": stats["cancellations"] == {"client_disconnect": 3,
                                                          "deadline": 2},
    }
    bad = [name for name, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(f"[{label}] failed: {bad}; stats {stats['cancellations']}, "
                             f"tokens { {r: len(v['toks']) for r, v in rec.items()} }")
    check_pool(label, stats)
    oracle(label, engine, [rec["survivor"]], [(prompt["survivor"], sp["survivor"])],
           min_caught=None)
    overshoot = (rec["lapse-decode"]["t_end"] - lapse_at) * 1e3
    log(f"serving [{label}]: one terminal event a stream, reasons "
        f"{ {r: v['fins'][0] for r, v in rec.items()} }; decode cancelled at token "
        f"{len(rec['decode']['toks'])} (asked at 20), mid-decode lapse after "
        f"{len(rec['lapse-decode']['toks'])} tokens, {overshoot:.1f} ms past its deadline; "
        f"cancellations {stats['cancellations']}, reclaimed tokens {stats['reclaimed_tokens']}; "
        f"a later request served in a freed slot; pages conserved")
    pipeline_line(card, label, stats)
    del engine
    torch.cuda.empty_cache()


def preempt_phase(card: str, params) -> None:
    """Preemption to host at llama-3-8b width (quickstart options, ring depth
    2), forced by wrapping ``pool.extend_chain`` in this script (no engine
    switch): a greedy and a seeded (temperature 0.8) request, 1000-token
    prompts and 64 output tokens, in at once. From each one's first token
    on (the ring running at depth 2), its chain growth fails until it has
    been preempted once: the ring caps, and the preemption lands where its
    next chunk needs a new page (position 1024), mid-decode. Then the greedy
    one alone, preempted at its chunk boundary (prefill_pos 512). Each is
    held against its undisturbed run on the same engine; every run starts
    with a cold prefix cache, so the runs compared have the same rounds up
    to the preemption. Gates: streams equal token for token, the
    preemptions counted (two mid-decode, one mid-prefill), pages conserved.
    Prints the suspend-to-resume time."""
    label = "preemption"
    engine, ecfg = build_engine(label, QUICKSTART, params)
    vocab = engine.model_config.vocab_size
    rng = np.random.default_rng(31)
    cases = {"greedy": (rng.integers(3, vocab, 1000).tolist(), SamplingParams(max_tokens=64)),
             "seeded": (rng.integers(3, vocab, 1000).tolist(),
                        SamplingParams(max_tokens=64, temperature=0.8, seed=42))}
    orig_extend, orig_preempt = engine.pool.extend_chain, engine._preempt_slot
    armed: dict[str, object] = {}  # request id → predicate on its slot state
    preempted: list[tuple[str, str, int]] = []  # (request id, phase, position)

    def flaky(chain, needed):
        for st in engine.slots:
            if st is not None and st.chain is chain and st.request_id in armed \
                    and st.request_id not in {rid for rid, _, _ in preempted} \
                    and armed[st.request_id](st):
                raise MemoryError("injected pool pressure")
        return orig_extend(chain, needed)

    def preempt(slot, state, soft_yielded=False):
        pos = state.prefill_pos if state.phase == "prefill" else int(engine.lengths[slot])
        preempted.append((state.request_id, state.phase, pos))
        return orig_preempt(slot, state, soft_yielded)

    def run(rids, arm=None, at_first_token=True):
        """Serve ``rids`` at once from a cold cache; ``arm``: request id →
        predicate on its slot state under which its chain growth fails
        (from its first token on, or from the start)."""
        flush_prefix_cache(engine)
        armed.clear()
        preempted.clear()
        streams = Streams()

        def hook(ev, rec, rid):
            if arm and rid in arm and rid not in armed:
                armed[rid] = arm[rid]

        with held(engine):
            for rid in rids:
                prompt, sp = cases[rid]
                engine.submit(prompt, sp, streams.emit_for(
                    rid, (lambda ev, rec, rid=rid: hook(ev, rec, rid)) if at_first_token
                    else None), request_id=rid)
            if arm and not at_first_token:
                armed.update(arm)
        streams.wait(engine)
        engine.shutdown()
        check_pool(label, engine.stats())
        return streams, list(preempted)

    engine.pool.extend_chain, engine._preempt_slot = flaky, preempt
    try:
        ref, _ = run(["greedy", "seeded"])
        hit, mid_decode = run(["greedy", "seeded"], {"greedy": lambda st: True,
                                                     "seeded": lambda st: True})
        ref_alone, _ = run(["greedy"])
        at_boundary, mid_prefill = run(
            ["greedy"], {"greedy": lambda st: st.phase == "prefill" and st.prefill_pos == 512},
            at_first_token=False)
    finally:
        engine.pool.extend_chain = orig_extend
        del engine._preempt_slot
        engine.shutdown()
    stats = engine.stats()
    for name, a, b in (("mid-decode", ref, hit), ("mid-prefill", ref_alone, at_boundary)):
        for rid in b.recs:
            x, y = a.recs[rid], b.recs[rid]
            if x["toks"] != y["toks"] or x["fins"] != y["fins"] or x["fins"] != ["length"]:
                raise AssertionError(f"[{label}] {name} {rid}: {y['toks']} {y['fins']} against "
                                     f"the undisturbed {x['toks']} {x['fins']}")
    if sorted((r, ph) for r, ph, _ in mid_decode) != [("greedy", "decode"), ("seeded", "decode")] \
            or [(r, ph, pos) for r, ph, pos in mid_prefill] != [("greedy", "prefill", 512)] \
            or stats["suspended"]:
        raise AssertionError(f"[{label}] preemptions: mid-decode {mid_decode}, mid-prefill "
                             f"{mid_prefill}; suspended {stats['suspended']}")
    log(f"serving [{label}]: greedy and seeded streams preempted once each mid-decode "
        f"{mid_decode} (request, phase, position; ring depth {stats['pipeline']['depth']}) and "
        f"the greedy one at its chunk boundary {mid_prefill} equal their undisturbed runs "
        f"token for token; preemptions {stats['preemptions']}; pages conserved")
    log(f"info [{card}] serving [{label}]: suspend-to-resume ms p50 "
        f"{stats['resume_recovery_ms']['p50']:.3f} over {stats['resume_recovery_ms']['count']}")
    pipeline_line(card, label, stats)
    del engine
    torch.cuda.empty_cache()


def tenant_flood(engine, vocab: int, hook=None, lengths: tuple[int, int] = (200, 400),
                 a_slots: int = 0) -> tuple[Streams, dict[str, float]]:
    """Tenant a floods 12 requests (prompts of ``lengths`` tokens, 32
    tokens out); once a holds every slot (or ``a_slots`` of them) and the
    rest of a's wait in the queue, tenant b submits 2 (150 tokens). Returns
    the streams and each request's queue wait in ms (submit to leaving the
    queue, read where the engine fixes the seed)."""
    rng = np.random.default_rng(41)
    waits, t_submit = {}, {}
    new_state = engine._new_state

    def timed(req):
        waits[req.request_id] = (time.perf_counter() - t_submit[req.request_id]) * 1e3
        return new_state(req)

    engine._new_state = timed
    streams = Streams()
    try:
        for i in range(12):
            rid = f"a{i}"
            t_submit[rid] = time.perf_counter()
            engine.submit(rng.integers(3, vocab, int(rng.integers(*lengths))).tolist(),
                          SamplingParams(max_tokens=32), streams.emit_for(rid, hook),
                          request_id=rid, tenant="a")
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and not (
                engine.pending_depth() > 0 and (
                    engine.tenant_snapshot().get("a", {}).get("active_slots", 0)
                    >= (a_slots or engine.n_slots))):
            time.sleep(0.001)
        for j in range(2):
            rid = f"b{j}"
            t_submit[rid] = time.perf_counter()
            engine.submit(rng.integers(3, vocab, 150).tolist(), SamplingParams(max_tokens=32),
                          streams.emit_for(rid, hook), request_id=rid, tenant="b")
        streams.wait(engine)
    finally:
        engine.shutdown()
        del engine._new_state
    reasons = {r["fins"][0] if len(r["fins"]) == 1 else r["fins"] for r in streams.recs.values()}
    if reasons != {"length"} or any(len(r["toks"]) != 32 for r in streams.recs.values()):
        raise AssertionError(f"tenant flood: reasons {reasons}")
    check_pool("tenant flood", engine.stats())
    return streams, waits


def tenants_phase(card: str, params) -> None:
    """Tenants at llama-3-8b width: tenant a floods 12 requests, tenant b
    sends 2 once a's are all in. (1) Fairness, at max_batch 4 so that a's
    backlog is most of its requests: with ``tenant_fair`` on, each of b's
    queue waits below the median of a's; off, both printed. (2) Slot cap:
    ``tenant_max_slots=4`` at max_batch 8, a's slots read from
    ``tenant_snapshot()`` at every emit (every round) never above 4. (3)
    Soft pages: ``tenant_soft_pages=16`` at max_batch 8: a yields a slot to
    host while b waits, the yielded stream resumes and ends normally. (4)
    Hard limits: ``tenant_max_pages`` and ``tenant_max_pending`` raise
    their exceptions at ``submit``."""
    from cyberfabric_core_tpu_torch.runtime.engine import TenantQuotaExceeded, TenantSaturated

    label = "tenants"
    vocab = get_config(QUICKSTART["model_config"]).vocab_size
    medians = {}
    for fair in (True, False):
        opts = dict(QUICKSTART, max_batch=4)
        ecfg = engine_config_from_options(opts)
        ecfg.tenant_fair = fair
        engine = ContinuousBatchingEngine(ecfg, params=params, seed=0)
        _, waits = tenant_flood(engine, vocab)
        a = sorted(w for r, w in waits.items() if r.startswith("a"))
        b = [waits["b0"], waits["b1"]]
        medians[fair] = (a[len(a) // 2 - 1] + a[len(a) // 2]) / 2
        log(f"info [{card}] serving [{label}, tenant_fair={fair}, max_batch 4]: queue wait ms "
            f"b {b[0]:.1f}, {b[1]:.1f}; a median {medians[fair]:.1f} "
            f"(a: {', '.join(f'{w:.1f}' for w in a)})")
        if fair and not max(b) < medians[fair]:
            raise AssertionError(f"[{label}] with tenant_fair on, b waited {b} ms against a's "
                                 f"median {medians[fair]:.1f}")
        del engine
        torch.cuda.empty_cache()

    # a's prompts of 100..200 tokens hold at most 4 pages a slot (ring
    # horizon included), so the 24-page quota never blocks a's 4 slots
    ecfg = engine_config_from_options(QUICKSTART)
    ecfg.tenant_max_slots, ecfg.tenant_max_pages, ecfg.tenant_max_pending = 4, 24, 12
    engine = ContinuousBatchingEngine(ecfg, params=params, seed=0)
    seen: list[int] = []
    tenant_flood(engine, vocab, lambda ev, rec: seen.append(
        engine.tenant_snapshot().get("a", {}).get("active_slots", 0)), lengths=(100, 200),
        a_slots=4)
    if max(seen, default=0) != 4:
        raise AssertionError(f"[{label}] tenant a held up to {max(seen, default=None)} slots "
                             "under tenant_max_slots=4 (want the cap reached, never passed)")
    rng = np.random.default_rng(43)
    try:
        engine.submit(rng.integers(3, vocab, 1600).tolist(), SamplingParams(max_tokens=32),
                      lambda ev: None, tenant="c")
        raise AssertionError(f"[{label}] a 26-page request passed tenant_max_pages=24")
    except TenantQuotaExceeded:
        pass
    engine.start = lambda: None  # park what follows in the queue
    try:
        for i in range(12):
            engine.submit([5, 6, 7], SamplingParams(max_tokens=2), lambda ev: None, tenant="c")
        try:
            engine.submit([5, 6, 7], SamplingParams(max_tokens=2), lambda ev: None, tenant="c")
            raise AssertionError(f"[{label}] a 13th pending request passed tenant_max_pending=12")
        except TenantSaturated as e:
            retry = e.retry_after_s
    finally:
        del engine.start
    engine.close()  # the 12 parked requests end with 'error'
    log(f"serving [{label}]: tenant_max_slots=4 held at every one of {len(seen)} emits (a's "
        f"slots at most {max(seen)}); tenant_max_pages=24 raised TenantQuotaExceeded for a "
        f"26-page request; tenant_max_pending=12 raised TenantSaturated (retry after "
        f"{retry:.1f} s)")
    del engine
    torch.cuda.empty_cache()

    ecfg = engine_config_from_options(QUICKSTART)
    ecfg.tenant_soft_pages = 16
    engine = ContinuousBatchingEngine(ecfg, params=params, seed=0)
    tenant_flood(engine, vocab)
    stats = engine.stats()
    if stats["tenants"]["a"]["soft_yields"] < 1 or stats["preemptions"] < 1:
        raise AssertionError(f"[{label}] no soft-quota yield: {stats['tenants']}")
    log(f"serving [{label}]: tenant_soft_pages=16: a yielded {stats['tenants']['a']['soft_yields']} "
        f"slot(s) to host while b waited ({stats['preemptions']} preemptions); every stream "
        f"ended with 'length' after 32 tokens; pages conserved")
    del engine
    torch.cuda.empty_cache()


GOLDEN = ("tiny-llama-golden", "tiny-qwen2-golden", "tiny-gemma-golden",
          "tiny-mixtral-golden", "tiny-llama-outlier")
GOLDEN_DIR = "tests/golden/fixtures"


def golden_phase(card: str) -> dict[str, int]:
    """The five committed HF checkpoints loaded with the port's own loader,
    at f32 on the card, TF32 off: full-prompt logits through the dense
    forward and the f32 flash kernel within rtol = atol = 1e-4 of
    transformers' (``golden.npz``) with every argmax equal; the 16-token
    greedy continuation through a paged mixed engine at f32 (ragged and
    decode f32 kernels, decode graphs; tiny-mixtral's routed MoE inside the
    graph) equal to ``greedy_ids``. At bf16 the continuation's agreement is
    printed. Returns the f32 kernels' launches over these runs."""
    from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
    from cyberfabric_core_tpu_torch.runtime.weights import load_llama_params, model_from_state_dict

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 parity would not be f32")
    launches = {name: 0 for name in KERNELS}

    def counted(fn):  # run fn, adding the launches it makes to the f32 count
        for _, _, wrapper in KERNELS.values():
            wrapper.launches = 0
        out = fn()
        for name, (_, _, wrapper) in KERNELS.items():
            launches[name] += wrapper.launches
        return out

    agree_bf16 = {}
    for fam in GOLDEN:
        cfg = get_config(fam)
        golden = np.load(f"{GOLDEN_DIR}/{fam}/golden.npz")
        state = load_llama_params(f"{GOLDEN_DIR}/{fam}", cfg, torch.float32)  # on the card
        params = model_from_state_dict(state, cfg)
        ids = torch.from_numpy(golden["input_ids"].astype(np.int32)).cuda()
        B, T = ids.shape
        rope = rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta)
        with torch.inference_mode():
            hidden, _ = counted(lambda: llama.forward(
                params, cfg, ids, torch.arange(T, dtype=torch.int32, device="cuda")[None]
                .expand(B, T), llama.init_cache(cfg, B, T, torch.float32),
                torch.zeros(B, dtype=torch.int32, device="cuda"), rope, use_flash=True))
            logits = llama.lm_head_logits(params, cfg, hidden).cpu().numpy()
        ref = golden["logits"]
        err = float(np.abs(logits - ref).max())
        if not np.allclose(logits, ref, rtol=1e-4, atol=1e-4) or \
                not (logits.argmax(-1) == ref.argmax(-1)).all():
            raise AssertionError(f"[golden {fam}] logits off transformers' by up to {err:.3e}")
        prompt, want = golden["greedy_ids"][:12].tolist(), golden["greedy_ids"][12:].tolist()
        got = {}
        for dtype in ("float32", "bfloat16"):
            engine = ContinuousBatchingEngine(
                EngineConfig(model=fam, max_seq_len=64, max_batch=2, decode_chunk=4,
                             prefix_cache_pages=32, prefix_page_size=16, dtype=dtype,
                             prefill_budget_tokens=8), params=state, seed=0)
            streams = Streams()

            def serve_one():
                try:
                    engine.submit(prompt, SamplingParams(max_tokens=len(want)),
                                  streams.emit_for("g"))
                    streams.wait(engine, 120)
                finally:
                    engine.shutdown()

            counted(serve_one) if dtype == "float32" else serve_one()
            pipe = engine.stats()["pipeline"]
            if not pipe["decode_graphs"] or pipe["decode_graph_replays"] <= 0:
                raise AssertionError(f"[golden {fam}] decode chunks did not replay graphs: {pipe}")
            got[dtype] = streams.recs["g"]["toks"]
            del engine
        if got["float32"] != want:
            raise AssertionError(f"[golden {fam}] f32 greedy {got['float32']} against "
                                 f"transformers' {want}")
        agree_bf16[fam] = sum(a == b for a, b in zip(got["bfloat16"], want))
        log(f"golden [{fam}]: f32 logits within {err:.3e} of transformers' (rtol = atol = "
            f"1e-4, argmax equal); f32 greedy continuation through the paged mixed engine "
            f"(decode graphs) equals greedy_ids ({len(want)} tokens)")
    if any(n <= 0 for n in launches.values()):
        raise AssertionError(f"[golden] an f32 kernel never ran: {launches}")
    log(f"info [{card}] golden at bf16 (printed, not required): greedy tokens equal to "
        f"transformers' f32 continuation {agree_bf16} of 16")
    log(f"info [{card}] golden f32 kernel launches (dense forward + f32 engines, all five "
        f"fixtures): {launches}")
    return launches


SPEC_K = 4


def spec_requests(vocab: int) -> list:
    """8 greedy requests whose prompts are a random 32-token pattern
    repeated to 256 tokens, 128 output tokens each, and one such request
    sampled (temperature 0.8, seeded): repetitive prompts, as code edits and
    templated documents send."""
    rng = np.random.default_rng(17)
    prompts = [rng.integers(3, vocab, 32).tolist() * 8 for _ in range(9)]
    requests = [(p, SamplingParams(max_tokens=128)) for p in prompts]
    requests[8] = (prompts[8], SamplingParams(max_tokens=128, temperature=0.8, seed=42))
    return requests


def first_divergence(a: list[int], b: list[int]) -> int | None:
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y),
                None if len(a) == len(b) else min(len(a), len(b)))


def spec_phase(card: str, params) -> dict[str, int]:
    """The speculative storm at llama-3-8b width: the quickstart's options
    with ``scheduler_spec_k`` 4 (mixed, ring depth 2) and with k=0, two
    engines over the same weights, the same :func:`spec_requests` (the 8
    greedy ones from 3 threads, the scheduler held until they and then the
    sampled one are in, so that both engines admit the same 8 first and the
    sampled one when a slot frees), kernel counts set to 0 just before each
    and read just after. Gates, on both: one terminal event a stream, every greedy token
    through the oracle, ragged launched and flash not, no synchronising call
    flagged, I1. At k=4 also: speculative rounds with drafts proposed and
    accepted, the sampled request never armed a proposer, and its ids equal
    its k=0 twin's. Greedy streams may part from k=0 at a near-tie on the
    card (bf16 GEMM bits depend on the row count: a verify round runs 8
    positions a row), so the oracle gates them; how many are identical, and
    where the others part, is printed. Returns the k=4 run's launches."""
    runs = {}
    for k in (0, SPEC_K):
        label = f"spec storm, k={k}"
        engine, ecfg = build_engine(label, dict(QUICKSTART, scheduler_spec_k=k), params)
        requests = spec_requests(engine.model_config.vocab_size)
        armed: dict[str, bool] = {}
        arm = engine._arm_spec

        def arm_and_record(state, arm=arm, armed=armed):
            arm(state)
            armed[state.request_id] = state.proposer is not None

        engine._arm_spec = arm_and_record
        launches, stats, recs = serving_phase(
            card, label, engine, ecfg, requests, launched=("ragged_paged_attention",),
            never=("flash_self_attention",), sync_free=True, last_alone=True,
            graphs_required=k == 0)
        runs[k] = (launches, stats, recs, armed)
        del engine
        torch.cuda.empty_cache()
    launches, stats, recs, armed = runs[SPEC_K]
    spec, pipe = stats["speculative"], stats["pipeline"]
    if pipe["verify_step_graph_replays"] <= 0 or pipe["verify_step_eager_runs"]:
        raise AssertionError(f"[spec storm] the verify rounds' decode step: "
                             f"{pipe['verify_step_graph_replays']} graph replays, "
                             f"{pipe['verify_step_eager_runs']} eager")
    if spec["k"] != SPEC_K or spec["rounds"] <= 0 or spec["proposed"] <= 0 \
            or spec["accepted"] <= 0:
        raise AssertionError(f"[spec storm] no draft was proposed and accepted: {spec}")
    if len(armed) != len(recs) or sum(armed.values()) != 8:
        raise AssertionError(f"[spec storm] proposers armed {armed}: want the 8 greedy "
                             "requests and not the sampled one")
    base = runs[0][2]
    if recs[8]["toks"] != base[8]["toks"]:
        raise AssertionError(f"[spec storm] the sampled request's ids left its k=0 twin's at "
                             f"token {first_divergence(recs[8]['toks'], base[8]['toks'])}")
    parted = {i: first_divergence(recs[i]["toks"], base[i]["toks"]) for i in range(8)}
    same = sum(d is None for d in parted.values())
    log(f"serving [spec storm]: k={SPEC_K} {spec['rounds']} speculative rounds "
        f"({spec['mixed_rounds']} with prompt chunks), {spec['proposed']} drafts proposed, "
        f"{spec['accepted']} accepted (rate {spec['accept_rate']}), {spec['emitted']} tokens "
        f"emitted by speculating rows; accept-length histogram {spec['accept_hist']}; "
        f"{pipe['verify_step_graph_replays']} verify-round decode steps replayed as graphs; "
        f"{sum(armed.values())} of 9 requests armed (the sampled one not); the sampled "
        f"request's {len(recs[8]['toks'])} ids equal its k=0 twin's; greedy streams "
        f"identical to k=0: {same} of 8, the others part at token "
        f"{ {i: d for i, d in parted.items() if d is not None} }")
    for k in (0, SPEC_K):
        log(f"info [{card}] serving [spec storm, k={k}]: "
            f"{format_latency(STORM_NUMBERS[f'spec storm, k={k}'])}")
    return launches


# ------------------------------------------------------------------ lockstep
def lockstep_run(engine, requests) -> tuple[list, float]:
    """``requests`` as one :meth:`InferenceEngine.generate_stream` batch:
    per request its events' tokens, reasons and host times (as
    :func:`serve` records them), and the wall seconds."""
    t0 = time.perf_counter()
    recs = [{"toks": [], "fins": [], "t0": t0, "t1": None, "ts": []} for _ in requests]
    for ev in engine.generate_stream([p for p, _ in requests], [sp for _, sp in requests]):
        r, now = recs[ev.request_index], time.perf_counter()
        r["t1"] = r["t1"] or now
        r["ts"].append(now)
        r["toks"].append(ev.token_id)
        r["fins"].append(ev.finished)
    return recs, time.perf_counter() - t0


def lockstep_step_ms(engine, lengths, k: int = 1) -> float:
    """Device time (graph replay) of one greedy decode step of the lockstep
    engine (the plain decode body at k=1 over a dense cache of
    ``len(lengths)`` rows at ``lengths``), or with ``k`` > 1 of a [1, k]
    greedy verify span at ``lengths[0]``."""
    cfg, dev = engine.model_config, engine.device
    B = len(lengths)
    cache = llama.init_cache(cfg, B, engine.config.max_seq_len, engine.dtype, device=dev)
    lens = i32(lengths, dev)
    toks = torch.randint(3, cfg.vocab_size, (B, k), device=dev, dtype=torch.int32,
                         generator=torch.Generator(device=dev).manual_seed(9))
    if k == 1:
        fn = build_decode_chunk_fn(cfg, 1, engine.rope_tables)
        warp = (torch.zeros(B, device=dev), torch.ones(B, device=dev),
                torch.zeros(B, dtype=torch.int32, device=dev))

        def call():
            fn(engine.params, cache[0], cache[1], toks[:, 0], lens, engine._generator, *warp,
               all_greedy=True)
    else:
        verify = build_verify_fn(cfg, k - 1, engine.rope_tables)

        def call():
            verify(engine.params, cache[0], cache[1], toks, lens)

    with torch.inference_mode():
        ms = graph_ms(call, iters=4, reps=3)
    del cache
    return ms


def eager_step_profile(engine, length: int, steps: int = 4) -> str:
    """A bs=1 greedy decode step enqueued eagerly (as the lockstep engine
    runs it) ``steps`` times under ``torch.profiler``: host ms a step
    against device ms a step, and the six operators with the most host
    time."""
    cfg, dev = engine.model_config, engine.device
    cache = llama.init_cache(cfg, 1, engine.config.max_seq_len, engine.dtype, device=dev)
    fn = build_decode_chunk_fn(cfg, 1, engine.rope_tables)
    args = (engine.params, cache[0], cache[1], i32([5], dev), i32([length], dev),
            engine._generator, torch.zeros(1, device=dev), torch.ones(1, device=dev),
            torch.zeros(1, dtype=torch.int32, device=dev))
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        fn(*args, all_greedy=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(steps):
                fn(*args, all_greedy=True)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3 / steps
    rows = prof.key_averages()
    device_us = sum(r.self_device_time_total for r in rows)
    top = sorted(rows, key=lambda r: r.self_cpu_time_total, reverse=True)[:6]
    return (f"wall {wall:.2f} ms a step under the profiler, device {device_us / 1e3 / steps:.2f} "
            "ms a step; most host time: " + ", ".join(
                f"{r.key} {r.self_cpu_time_total / 1e3 / steps:.2f} ms x{r.count // steps}"
                for r in top))


def lockstep_storm_phase(card: str, smi: str, params, requests) -> int:
    """The lockstep engine (``InferenceEngine``, the worker's ``scheduler:
    lockstep``) at llama-3-8b width on the quickstart's options, the storm's
    8 requests (16..1500 random ids, 32 out, request 3 on a stop id,
    request 5 sampled with a seed) as one batch, kernel counts set to 0
    just before and read just after. Gates: one terminal event a stream;
    the one prefill ran through flash (one launch a layer) and no paged
    kernel ran; every greedy token within the margin of the dense forward;
    each greedy first token of the padded bucket within the margin of the
    same prompt prefilled alone, unpadded. Printed: ttft, inter-token latency,
    tokens/s beside the continuous engine's mixed storm on the same
    requests, and the decode step's device ms beside the paged step's.
    Returns the flash launches."""
    label = "lockstep storm"
    ecfg = engine_config_from_options(QUICKSTART)
    engine = InferenceEngine(ecfg, params=params, seed=0)
    if not engine.use_flash:
        raise AssertionError(f"[{label}] the engine's prefill does not use flash")
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    recs, wall = lockstep_run(engine, requests)
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    check_streams(recs, requests, lambda sp: set(sp.stop_token_ids) | set(ecfg.eos_token_ids))
    if launches["flash_self_attention"] != engine.model_config.num_layers or \
            launches["ragged_paged_attention"] or launches["paged_decode_attention"]:
        raise AssertionError(f"[{label}] launches {launches}: want flash once a layer for the "
                             "one prefill, no paged kernel")
    oracle(label, engine, recs, requests)
    cfg, dev = engine.model_config, engine.device
    worst = 0.0
    with torch.inference_mode():
        for (prompt, sp), r in zip(requests, recs):
            if sp.temperature > 0:
                continue
            T = len(prompt)
            ids = i32(prompt, dev)[None]
            hidden, _ = llama.forward(
                params, cfg, ids, torch.arange(T, dtype=torch.int32, device=dev)[None],
                llama.init_cache(cfg, 1, T, engine.dtype, device=dev),
                torch.zeros(1, dtype=torch.int32, device=dev), engine.rope_tables,
                use_flash=True)
            logits = llama.lm_head_logits(params, cfg, hidden[:, -1])[0]
            worst = max(worst, float(logits.max() - logits[r["toks"][0]]))
    log(f"serving [{label}]: every first token of the padded bucket "
        f"({ecfg.bucket_for(max(len(p) for p, _ in requests))}) within {worst:.4f} of the "
        f"unpadded prefill's max logit (margin {LOGIT_MARGIN})")
    if worst > LOGIT_MARGIN:
        raise AssertionError(f"[{label}] a padded first token sits {worst:.3f} below the "
                             "unpadded prefill's max")
    numbers = latency_numbers([r["t0"] for r in recs], [r["ts"] for r in recs],
                              sum(len(r["toks"]) for r in recs), wall)
    STORM_NUMBERS[label] = numbers
    log(f"serving [{label}]: 8 requests in one batch, reasons "
        f"{[r['fins'][-1] for r in recs]}, launches {launches}")
    log(f"info [{smi}] serving [{label}]: {format_latency(numbers)}; the continuous "
        f"engine's mixed storm on the same requests, same call: "
        f"{format_latency(STORM_NUMBERS['mixed'])}")
    del engine
    free_card()
    lock = InferenceEngine(ecfg, params=params, seed=0)
    lock_ms = lockstep_step_ms(lock, DECODE_LENS)
    rope = lock.rope_tables
    del lock
    shape = (cfg.num_layers, 321, 64, cfg.num_kv_heads, cfg.head_dim)
    pools = (torch.zeros(shape, dtype=torch.bfloat16, device=dev),
             torch.zeros(shape, dtype=torch.bfloat16, device=dev))
    paged_ms = decode_step_ms(params, rope, pools)
    log(f"info [{smi}] {label} decode step (8 rows at lengths 127..2046 and the head, device "
        f"ms, graph replay): lockstep (dense cache, plain attention) {lock_ms:.3f}; paged "
        f"(the decode kernel) {paged_ms:.3f}")
    del pools
    free_card()
    return launches["flash_self_attention"]


LOCKSTEP_SPEC_OUT = 128


def lockstep_spec_prompt(vocab: int) -> list[int]:
    """A random 32-token pattern repeated to 256 tokens."""
    return np.random.default_rng(23).integers(3, vocab, 32).tolist() * 8


def lockstep_spec_run(label: str, engine, prompt, sp) -> dict:
    """One bs=1 request through ``engine``: its tokens and finish reason
    (one terminal event), tokens/s, and the engine's speculation counters
    over this run."""
    before = {k: (dict(v) if isinstance(v, dict) else v) for k, v in engine.spec_stats.items()}
    recs, wall = lockstep_run(engine, [(prompt, sp)])
    check_streams(recs, [(prompt, sp)], lambda s: set(s.stop_token_ids)
                  | set(engine.config.eos_token_ids))
    stats = {k: v - before[k] for k, v in engine.spec_stats.items() if k != "accept_hist"}
    hist = {a: n - before["accept_hist"].get(a, 0)
            for a, n in engine.spec_stats["accept_hist"].items()
            if n - before["accept_hist"].get(a, 0)}
    toks = [t for t in recs[0]["toks"] if t >= 0]
    out = {"label": label, "toks": toks, "reason": recs[0]["fins"][-1],
           "tokens_per_s": len(toks) / wall, "stats": stats, "accept_hist": hist,
           "accept_rate": stats["accepted"] / stats["drafted"] if stats["drafted"] else None}
    log(f"serving [{label}]: {len(toks)} tokens ({out['reason']}) in {wall:.2f} s = "
        f"{out['tokens_per_s']:.1f} tokens/s; verify rounds {stats['verify_calls']}, "
        f"drafts {stats['drafted']}, accepted {stats['accepted']} (rate "
        f"{out['accept_rate']}), fallback steps {stats['fallback_steps']}; accept-length "
        f"histogram {hist}")
    return out


def one_row_cdf(vocab: int, calls: int = 200) -> None:
    """The CDF of one sampled row, as a bs=1 draw reads it, 200 times over:
    ``sampling.cumsum_rows`` must give the first call's bits every time, or
    a seed would not repeat its tokens. Printed: how many plain
    ``torch.cumsum`` calls on the same row leave their first call's bits,
    and each one's device time a call."""
    g = torch.Generator(device=CARD).manual_seed(0)
    probs = torch.softmax(torch.randn(1, vocab, generator=g, device=CARD) * 2.5, dim=-1)
    counts, ms = {}, {}
    for name, fn in (("cumsum_rows", sampling.cumsum_rows),
                     ("torch.cumsum", lambda x: torch.cumsum(x, dim=-1))):
        first = fn(probs).clone()
        counts[name] = sum(not torch.equal(fn(probs), first) for _ in range(calls))
        ms[name] = cuda_ms(lambda: fn(probs), iters=calls)
    if counts["cumsum_rows"]:
        raise AssertionError(f"[sampling cdf] cumsum_rows of one row of {vocab} left its first "
                             f"call's bits on {counts['cumsum_rows']} of {calls} calls")
    log(f"serving [sampling cdf]: one row of {vocab}: cumsum_rows the same bits on {calls} "
        f"calls ({ms['cumsum_rows']:.4f} ms a call); plain torch.cumsum left its first "
        f"call's bits on {counts['torch.cumsum']} ({ms['torch.cumsum']:.4f} ms a call)")


def lockstep_spec_phase(card: str, smi: str, params) -> None:
    """Lockstep speculation at llama-3-8b width, bs=1 (the engine speculates
    only then), a 32-token pattern repeated to 256 tokens, 128 out,
    ``spec_k`` 8 (the worker's default): spec off, ``ngram`` and ``draft``
    with llama-3-8b drafting for itself (a ``DraftModel`` over the target's
    own tree, set as the engine's draft: a perfect draft).

    bf16 (the worker's dtype): every greedy token of each run within the
    margin of the dense forward, and a fourth run with a seeded independent
    llama-3-8b draft (the engine's own synthetic draft; 16 GB more): lossless
    through the oracle, acceptance ~0. A seeded sampled draft run
    (temperature 0.8, seed 42) twice: the same tokens, drafts accepted.
    Before the runs, the CDF such a draw reads (``sampling.cumsum_rows`` of
    one vocabulary-wide row) gives the same bits on 200 calls; how many of
    200 plain ``torch.cumsum`` calls leave the first one's bits is printed.

    f32 (random weights from seed 0 in f32, one 32 GB tree for the three
    runs, TF32 off): ngram's and the perfect draft's streams equal spec
    off's token for token.

    Printed: acceptance and its length histogram, tokens/s beside spec off,
    and the verify round's device ms beside a decode step's (bs=1)."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the f32 runs would not be f32")
    base = engine_config_from_options(QUICKSTART)
    cfg = get_config(base.model)
    one_row_cdf(cfg.vocab_size)
    prompt = lockstep_spec_prompt(cfg.vocab_size)
    greedy = SamplingParams(max_tokens=LOCKSTEP_SPEC_OUT)
    for dtype in ("bfloat16", "float32"):
        ecfg = dataclasses.replace(base, dtype=dtype)
        tree = params if dtype == "bfloat16" else llama.init_params(cfg, 0, torch.float32, CARD)
        runs = {}
        for mode in ("off", "ngram", "draft"):
            label = f"lockstep spec {mode}, {dtype}"
            engine = InferenceEngine(dataclasses.replace(ecfg, speculative=mode,
                                                         draft_model=ecfg.model),
                                     params=tree, seed=0)
            if mode == "draft":  # the target drafting for itself
                engine._draft = DraftModel(cfg, tree, max_seq=ecfg.max_seq_len,
                                           dtype=engine.dtype, k=ecfg.spec_k, device=CARD,
                                           use_flash=engine.use_flash)
            runs[mode] = lockstep_spec_run(label, engine, prompt, greedy)
            if mode == "draft" and dtype == "bfloat16":
                sampled = [lockstep_spec_run(f"lockstep spec draft, bf16, sampled ({n})", engine,
                                             prompt, SamplingParams(
                                                 max_tokens=LOCKSTEP_SPEC_OUT, temperature=0.8,
                                                 seed=42)) for n in (1, 2)]
                if sampled[0]["toks"] != sampled[1]["toks"] or not sampled[0]["stats"]["accepted"]:
                    raise AssertionError(f"[lockstep spec sampled] seed 42 twice: equal "
                                         f"{sampled[0]['toks'] == sampled[1]['toks']}, accepted "
                                         f"{sampled[0]['stats']['accepted']}")
                log("serving [lockstep spec draft, bf16, sampled]: temperature 0.8 seed 42 "
                    f"twice: the same {len(sampled[0]['toks'])} tokens, "
                    f"{sampled[0]['stats']['accepted']} drafts accepted")
            if mode != "off" and not runs[mode]["stats"]["verify_calls"]:
                raise AssertionError(f"[{label}] no verify round ran")
            del engine
        if dtype == "bfloat16":
            engine = InferenceEngine(dataclasses.replace(ecfg, speculative="draft",
                                                         draft_model=ecfg.model),
                                     params=tree, seed=0)
            runs["independent draft"] = lockstep_spec_run(
                "lockstep spec draft, bf16, independent seeded draft", engine, prompt, greedy)
            del engine
            free_card()
            probe = InferenceEngine(ecfg, params=tree)
            for mode, run in runs.items():
                oracle(f"lockstep spec {mode}, bf16", probe, [{"toks": run["toks"]}],
                       [(prompt, greedy)], None)
            step = lockstep_step_ms(probe, [len(prompt) + 64])
            verify = lockstep_step_ms(probe, [len(prompt) + 64], k=ecfg.spec_k + 1)
            del probe
            log(f"info [{smi}] lockstep spec, bf16, bs=1 (device ms, graph replay): decode "
                f"step {step:.3f}; verify round [1, {ecfg.spec_k + 1}] {verify:.3f}")
        else:
            for mode in ("ngram", "draft"):
                d = first_divergence(runs[mode]["toks"], runs["off"]["toks"])
                if d is not None or runs[mode]["reason"] != runs["off"]["reason"]:
                    raise AssertionError(f"[lockstep spec {mode}, f32] the stream leaves spec "
                                         f"off's at token {d}")
            log(f"serving [lockstep spec, f32]: ngram and the perfect draft give spec off's "
                f"{len(runs['off']['toks'])} tokens, token for token")
        probe = InferenceEngine(ecfg, params=tree)
        log(f"info [{smi}] lockstep spec, {dtype}, a bs=1 decode step enqueued eagerly: "
            + eager_step_profile(probe, len(prompt) + 64))
        del probe
        log(f"info [{smi}] lockstep spec, {dtype} (tokens/s; acceptance): " + "; ".join(
            f"{mode} {run['tokens_per_s']:.1f} ({run['accept_rate']})"
            for mode, run in runs.items()))
        del tree, runs
        free_card()


# ------------------------------------------------- quantization, pools and PD
QUANT_GOLDEN = ("tiny-llama-golden", "tiny-qwen2-golden", "tiny-llama-outlier")
#: (bits → max allowed mean |Δlogit| against transformers'), the bounds of
#: tests/test_golden_parity.py
QUANT_BOUNDS = {8: 0.02, 4: 0.12}
#: next-token CE budgets on the outlier fixture (nats)
CE_BUDGETS = {8: 0.01, 4: 0.05}
DECODE_LENS = [127, 383, 639, 895, 1151, 1407, 1663, 2046]
#: the one card every replica of the pool phases sits on
CARD = torch.device("cuda:0")


def gib(n: float) -> str:
    return f"{n / 1024 ** 3:.2f} GiB"


def free_card() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def card_memory(label: str) -> int:
    """Card memory once a phase has stopped its engines and returned: what
    the allocator holds at that moment, then after a cycle collection (an
    engine that only a reference cycle keeps alive is freed there), then
    with PyTorch's cuBLAS workspaces cleared (one cached per handle and
    stream), with the CUDA tensors still reachable and the largest of them.
    The cache is emptied after. Returns the bytes left at the end."""
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    gc.set_debug(gc.DEBUG_SAVEALL)  # keep what the collection finds, to name it
    gc.collect()
    gc.set_debug(0)
    cycles = collections.Counter(type(o).__qualname__ for o in gc.garbage
                                 if type(o).__module__.startswith(("cyberfabric", "__main__"))
                                 or isinstance(o, (types.TracebackType, types.FrameType)))
    gc.garbage.clear()
    gc.collect()
    left = torch.cuda.memory_allocated()
    torch._C._cuda_clearCublasWorkspaces()
    bare = torch.cuda.memory_allocated()
    torch.cuda.empty_cache()
    live: dict[int, tuple[int, tuple, torch.dtype]] = {}
    with warnings.catch_warnings():  # isinstance reads deprecated torch attributes
        warnings.simplefilter("ignore")
        for obj in gc.get_objects():
            if isinstance(obj, torch.Tensor) and obj.is_cuda and obj.layout == torch.strided:
                storage = obj.untyped_storage()
                live[storage.data_ptr()] = (storage.nbytes(), tuple(obj.shape), obj.dtype)
    top = sorted(live.values(), key=lambda t: -t[0])[:4]
    log(f"memory [{label}]: allocated {gib(held)} as the phase returned, {gib(left)} after a "
        f"cycle collection, {gib(bare)} without the cuBLAS workspaces; {len(live)} reachable "
        f"CUDA storages of "
        f"{gib(sum(t[0] for t in live.values()))}, largest "
        + ", ".join(f"{gib(n)} {list(shape)} {str(dt).replace('torch.', '')}"
                    for n, shape, dt in top))
    if held - left > 2 ** 28:
        log(f"memory [{label}]: the collection freed {gib(held - left)}; the cycles held "
            f"(port and script objects, tracebacks, frames): {dict(cycles.most_common(12))}")
    return bare


def decode_step(params, rope, pools):
    """One decode step at 8 rows of lengths 127..2046 through ``pools`` and
    the head: what a replayed decode chunk runs ``decode_chunk`` times."""
    cfg, dev = params.cfg, params.device
    k_pool = pools[0][0] if isinstance(pools[0], list) else pools[0]  # a list under tp
    pt = make_table(8, 32, k_pool.shape[1], 9, dev)
    ids = torch.from_numpy(np.random.default_rng(9).integers(
        3, cfg.vocab_size, (8, 1)).astype(np.int32)).to(dev)
    lens = i32(DECODE_LENS, dev)

    def step():
        h, _ = llama.forward_paged_decode(params, cfg, ids, pools, pt, lens, rope)
        llama.lm_head_logits(params, cfg, h[:, 0])

    return step


def decode_step_ms(params, rope, pools, iters: int = 4, reps: int = 3) -> float:
    """Device time (CUDA-graph replay) of :func:`decode_step`."""
    with torch.inference_mode():
        return graph_ms(decode_step(params, rope, pools), iters=iters, reps=reps)


@contextlib.contextmanager
def dense_moe():
    """The dense MoE oracle (every expert, top-k mask) in place of the routed
    form while the oracle's dense forward runs."""
    routed = llama._moe_mlp
    llama._moe_mlp = lambda x, lp, cfg, *_: llama._moe_mlp_dense(x, lp, cfg)
    try:
        yield
    finally:
        llama._moe_mlp = routed


def quant_phase(card: str, smi: str, bf16) -> None:
    """quant-8b: llama-3-8b at full width, int8 and int4 (random weights from
    seed 0, quantized as drawn on the card), each on the mixed storm with
    the storm's gates (one terminal a stream, ragged and decode launched and
    flash not, decode graphs replayed, I1, every greedy token within the
    margin of the dense forward over the SAME quantized tree); then the
    decode step's device time of bf16, int8 and int4 in turns, and the
    trees' bytes."""
    trees, rope = {}, None
    for bits in (8, 4):
        label = f"quant-8b int{bits}"
        torch.cuda.reset_peak_memory_stats()
        engine, ecfg = build_engine(label, dict(QUICKSTART, quantization=f"int{bits}"))
        built_peak = torch.cuda.max_memory_allocated()
        wq = engine.params.layers[0].wq
        if not isinstance(wq, QuantWeight) or wq.bits != bits:
            raise AssertionError(f"[{label}] the engine's tree is not int{bits}: {wq}")
        requests = storm_requests(engine, ecfg)
        serving_phase(card, label, engine, ecfg, requests,
                      launched=("ragged_paged_attention", "paged_decode_attention"),
                      never=("flash_self_attention",))
        trees[bits], rope = engine.params, engine.rope_tables
        log(f"info [{smi}] {label}: tree {gib(quantized_bytes(engine.params))} (bf16 "
            f"{gib(quantized_bytes(bf16))}); peak allocated {gib(built_peak)} after the build, "
            f"{gib(torch.cuda.max_memory_allocated())} over the storm; "
            f"{format_latency(STORM_NUMBERS[label])} (bf16 mixed storm: "
            f"{format_latency(STORM_NUMBERS['mixed'])})")
        del engine
        free_card()
    cfg = bf16.cfg
    shape = (cfg.num_layers, 321, 64, cfg.num_kv_heads, cfg.head_dim)
    pools = (torch.zeros(shape, dtype=torch.bfloat16, device=CARD),
             torch.zeros(shape, dtype=torch.bfloat16, device=CARD))
    trees["bf16"] = bf16
    order = ["bf16", 8, 4, 4, 8, "bf16"]
    times = {k: [] for k in ("bf16", 8, 4)}
    for key in order:
        times[key].append(decode_step_ms(trees[key], rope, pools))
    log(f"info [{smi}] quant-8b decode step (8 rows at lengths 127..2046 and the head, "
        f"device ms, graph replay, in turns): " + "; ".join(
            f"{'bf16' if k == 'bf16' else f'int{k}'} "
            + ", ".join(f"{t:.3f}" for t in v) for k, v in times.items()))
    del trees, pools
    free_card()


def golden_quant_phase(card: str, smi: str) -> None:
    """The quantization bounds of ``tests/test_golden_parity.py`` at f32 on
    the card, TF32 off: each fixture loaded by the port's quantizing loader
    at 8 and 4 bits, its logits' mean |Δ| against transformers' under
    QUANT_BOUNDS and W8 below W4; on the outlier fixture the next-token CE
    moves less than CE_BUDGETS, W8 less than W4."""
    from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
    from cyberfabric_core_tpu_torch.runtime.weights import load_llama_params, model_from_state_dict

    def ce(logits, targets):
        lp = torch.log_softmax(torch.from_numpy(logits[:, :-1]).double(), dim=-1)
        return float(-lp.gather(-1, torch.from_numpy(targets).long()[..., None]).mean())

    out = {}
    for fam in QUANT_GOLDEN:
        cfg = get_config(fam)
        golden = np.load(f"{GOLDEN_DIR}/{fam}/golden.npz")
        ids = torch.from_numpy(golden["input_ids"].astype(np.int32)).to(CARD)
        B, T = ids.shape
        rope = rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta, device=CARD)
        errs, ces = {}, {}
        for bits in (8, 4):
            params = model_from_state_dict(load_llama_params(
                f"{GOLDEN_DIR}/{fam}", cfg, torch.float32, CARD, quantize=True,
                quant_bits=bits), cfg, CARD)
            with torch.inference_mode():
                hidden, _ = llama.forward(
                    params, cfg, ids, torch.arange(T, dtype=torch.int32, device=CARD)[None]
                    .expand(B, T), llama.init_cache(cfg, B, T, torch.float32, device=CARD),
                    torch.zeros(B, dtype=torch.int32, device=CARD), rope)
                logits = llama.lm_head_logits(params, cfg, hidden).cpu().numpy()
            errs[bits] = float(np.abs(logits - golden["logits"]).mean())
            targets = golden["input_ids"][:, 1:]
            ces[bits] = abs(ce(logits, targets) - ce(golden["logits"], targets))
            if errs[bits] >= QUANT_BOUNDS[bits]:
                raise AssertionError(f"[golden quant {fam}] int{bits} mean |dlogit| "
                                     f"{errs[bits]:.5f} >= {QUANT_BOUNDS[bits]}")
            if fam == "tiny-llama-outlier" and ces[bits] >= CE_BUDGETS[bits]:
                raise AssertionError(f"[golden quant {fam}] int{bits} CE moved {ces[bits]:.5f}")
        if not errs[8] < errs[4]:
            raise AssertionError(f"[golden quant {fam}] W8 not below W4: {errs}")
        out[fam] = {"mean_abs_dlogit": errs, "ce_delta": ces}
    if not out["tiny-llama-outlier"]["ce_delta"][8] < out["tiny-llama-outlier"]["ce_delta"][4]:
        raise AssertionError(f"[golden quant] outlier CE: W8 not below W4: {out}")
    log(f"golden quant (f32 on the card, bounds {QUANT_BOUNDS}, CE budgets {CE_BUDGETS}): "
        + json.dumps(out))


MIXTRAL = {"model_config": "mixtral-8x7b", "max_seq_len": 2048, "max_batch": 8,
           "prefix_page_size": 64, "decode_chunk": 8, "prefill_budget_tokens": 512,
           "mixed_batch": True, "quantization": "int8"}
MIXTRAL_LENS = (16, 64, 100, 180, 256, 333, 420, 512)


def routed_moe_plain(x, lp, cfg, valid=None, n_tokens=None):
    """The routed MoE one expert at a time, as plainly as it can be said:
    each real token's top-k experts (the router product of the served
    call), gates softmaxed over those k; each expert's real tokens in token
    order, the first ``llama.moe_capacity`` of them kept; their gated MLP on
    the widened weights in f32, rounded to the activation dtype where the
    served form rounds, then scaled and summed in f32. Returns (the f32
    output [B, T, H], real assignments, dropped assignments)."""
    K = cfg.experts_per_token
    B, T, H = x.shape
    N = B * T
    flat = x.reshape(N, H)
    real = torch.ones(N, dtype=torch.bool, device=x.device) if valid is None \
        else valid.reshape(N)
    capacity = llama.moe_capacity(cfg, N, N if n_tokens is None else n_tokens)
    top_vals, top_idx = torch.topk(llama._mm_f32(flat, lp.router), K, dim=-1)
    gates = torch.softmax(top_vals, dim=-1)

    def product(a, w, e):
        if isinstance(w, QuantWeight):
            return (a @ w.values()[e].float()) * w.s[e]
        return a @ w[e].float()

    out = torch.zeros((N, H), dtype=torch.float32, device=x.device)
    assigned = dropped = 0
    for e in range(cfg.num_experts):
        hit = (top_idx == e) & real[:, None]                  # [N, K]
        rows = hit.any(dim=1).nonzero()[:, 0]                 # token order
        keep = rows[:capacity]
        assigned, dropped = assigned + rows.numel(), dropped + rows.numel() - keep.numel()
        if not keep.numel():
            continue
        xe = flat[keep].float()
        act = (llama._act(product(xe, lp.moe_gate, e), cfg)
               * product(xe, lp.moe_up, e)).to(x.dtype)
        gate = (gates * hit).sum(dim=1)[keep]
        out[keep] += product(act.float(), lp.moe_down, e) * gate[:, None]
    return out.reshape(B, T, H), assigned, dropped


#: the served routed MoE against its plain version, a call at a time: within
#: one bf16 ulp of the call's largest output (the two differ in f32 sum order
#: and, rarely, in a bf16 rounding of the activation; a dropped or misrouted
#: assignment moves its row by its whole contribution)
MOE_TOL = 2.0 ** -8


@contextlib.contextmanager
def moe_checked():
    """Hold every eager routed-MoE call while the block runs (the mixed
    rounds; a decode chunk's graph replays no Python) against
    :func:`routed_moe_plain` on the same inputs, within MOE_TOL of the
    output's scale, padding rows zero; count the real tokens' expert
    assignments and those the bucket capacity drops. Its reference and host
    reads sit on the served path: a run inside it is not timed. Yields
    ``{"assigned", "dropped", "calls", "max_rel_err"}``."""
    routed, out = llama._moe_mlp, {"assigned": 0, "dropped": 0, "calls": 0,
                                   "max_rel_err": 0.0}

    def checked(x, lp, cfg, valid=None, n_tokens=None):
        got = routed(x, lp, cfg, valid, n_tokens)
        ref, assigned, dropped = routed_moe_plain(x, lp, cfg, valid, n_tokens)
        rel = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
        if rel > MOE_TOL or not torch.isfinite(got).all():
            raise AssertionError(f"routed MoE call {out['calls']}: {rel:.3e} of the "
                                 f"output's scale from its plain version (tolerance "
                                 f"{MOE_TOL:.3e})")
        out["assigned"] += assigned
        out["dropped"] += dropped
        out["calls"] += 1
        out["max_rel_err"] = max(out["max_rel_err"], rel)
        return got

    llama._moe_mlp = checked
    try:
        yield out
    finally:
        llama._moe_mlp = routed


def oracle_spread(label: str, engine, recs, requests) -> None:
    """Printed, not a gate: each greedy stream's largest distance below the
    dense forward's max logit."""
    cfg = engine.model_config
    with torch.inference_mode():
        gaps = [round(dense_margin(engine.params, cfg, engine.rope_tables, p, r["toks"])[0], 4)
                for r, (p, sp) in zip(recs, requests) if sp.temperature == 0]
    log(f"serving [{label}] dense-oracle distance by greedy stream (printed): {gaps}; "
        f"{sum(g <= LOGIT_MARGIN for g in gaps)} of {len(gaps)} within {LOGIT_MARGIN}")


#: (request index, position) of each flattened row of the routed-MoE call
#: running now, None where a row carries no real token (set by the forwards
#: :func:`routes_recorded` wraps)
_ROUTE_ROWS: list = [None]


def _record_routes(store: dict, x, lp, cfg, layer_of: dict) -> None:
    """Each real row's top-k expert set and its k+1 largest router logits by
    expert, from the same router product the routed MoE takes."""
    rows = _ROUTE_ROWS[0]
    if rows is None:
        return
    K = cfg.experts_per_token
    logits = llama._mm_f32(x.reshape(-1, x.shape[-1]), lp.router).float()
    top = torch.topk(logits, K + 1, dim=-1)
    idx, vals = top.indices.cpu().tolist(), top.values.cpu().tolist()
    layer = layer_of[id(lp)]
    for r, key in enumerate(rows):
        if key is not None:
            store[(key[0], key[1], layer)] = (frozenset(idx[r][:K]), vals[r],
                                              dict(zip(idx[r], vals[r])))


@contextlib.contextmanager
def routes_recorded(engine, requests):
    """While the block serves ``requests`` on ``engine`` (decode chunks run
    eagerly: a graph replays no Python), record every real token's top-k
    expert set per layer in the served forwards, keyed (request index,
    position, layer); a re-dispatched position keeps its last, committed
    computation. Host reads sit on the path: a run inside is not timed.
    Yields the store."""
    key_of = {tuple(p): i for i, (p, _) in enumerate(requests)}
    layer_of = {id(lp): i for i, lp in enumerate(engine.params.layers)}
    store: dict = {}
    mixed, decode, routed = llama.forward_paged_mixed, llama.forward_paged_decode, llama._moe_mlp
    graphs = engine._chunk._graphs

    def slot_requests():
        return [key_of.get(tuple(st.prompt_ids)) if st is not None else None
                for st in engine.slots]

    def mixed_rec(params, cfg, input_ids, pools, page_table, hist, q_lens, rope,
                  write_mask=None, moe_tokens=None):
        B, Q = input_ids.shape
        h, ql = hist.tolist(), q_lens.tolist()
        wm = write_mask.tolist() if write_mask is not None else [True] * B
        reqs = slot_requests()
        _ROUTE_ROWS[0] = [(reqs[b], h[b] + t) if reqs[b] is not None and wm[b]
                          and t < ql[b] else None for b in range(B) for t in range(Q)]
        try:
            return mixed(params, cfg, input_ids, pools, page_table, hist, q_lens, rope,
                         write_mask, moe_tokens)
        finally:
            _ROUTE_ROWS[0] = None

    def decode_rec(params, cfg, input_ids, pools, page_table, lengths, rope, write_mask=None):
        B = input_ids.shape[0]
        ln = lengths.tolist()
        wm = write_mask.tolist() if write_mask is not None else [True] * B
        reqs = slot_requests()
        _ROUTE_ROWS[0] = [(reqs[b], ln[b]) if reqs[b] is not None and wm[b] else None
                          for b in range(B)]
        try:
            return decode(params, cfg, input_ids, pools, page_table, lengths, rope, write_mask)
        finally:
            _ROUTE_ROWS[0] = None

    def routed_rec(x, lp, cfg, valid=None, n_tokens=None):
        _record_routes(store, x, lp, cfg, layer_of)
        return routed(x, lp, cfg, valid, n_tokens)

    llama.forward_paged_mixed, llama.forward_paged_decode = mixed_rec, decode_rec
    llama._moe_mlp = routed_rec
    engine._chunk._graphs = {}
    try:
        yield store
    finally:
        llama.forward_paged_mixed, llama.forward_paged_decode = mixed, decode
        llama._moe_mlp = routed
        engine._chunk._graphs = graphs


def bf16_ulp(v: float) -> float:
    """One bf16 ulp at |v| (8 significand bits)."""
    return 2.0 ** (math.floor(math.log2(max(abs(v), 1e-30))) - 7)


def routing_flips(label: str, engine, recs, requests, served: dict) -> None:
    """The bf16 dense-MoE oracle's distances explained by routing. For each
    greedy stream: the dense forward with the dense MoE oracle over prompt +
    output, its top-k expert set per (position, layer) against the served
    forward's (``served``, :func:`routes_recorded`), over every position
    the emitted tokens read. A flip is a position and layer where the sets
    differ; its margin is the oracle's gap between the k-th and the (k+1)-th
    router logit, against one bf16 ulp there, beside how far the two
    forwards' logits of the same experts lie apart there (what rounding
    moved). Printed: each stream's flips, its first flip's margin, its
    distance, and whether its first flip sits below one bf16 ulp. Gates:
    every stream more than LOGIT_MARGIN off has a flip at a margin below
    one bf16 ulp (rounding can decide it); every token emitted before a
    stream's first flip lies within LOGIT_MARGIN of the oracle; and every
    greedy token lies within LOGIT_MARGIN of the dense-MoE oracle routed as
    the served forward routed (each position and layer's served top-k set):
    what is left once routing agrees is the rest of the forward's
    rounding."""
    cfg = engine.model_config
    K = cfg.experts_per_token
    layer_of = {id(lp): i for i, lp in enumerate(engine.params.layers)}
    dense = llama._moe_mlp_dense
    report, faults = [], []
    with torch.inference_mode(), dense_moe():
        for i, (r, (prompt, sp)) in enumerate(zip(recs, requests)):
            if sp.temperature > 0:
                continue
            toks = [t for t in r["toks"] if t >= 0]
            oracle_routes: dict = {}
            n_pos = len(prompt) + len(toks) - 1

            def dense_rec(x, lp, cfg_, i=i, oracle_routes=oracle_routes, n_pos=n_pos):
                _ROUTE_ROWS[0] = [(i, p) for p in range(x.shape[1])]
                try:
                    _record_routes(oracle_routes, x, lp, cfg_, layer_of)
                finally:
                    _ROUTE_ROWS[0] = None
                return dense(x, lp, cfg_)

            llama._moe_mlp_dense = dense_rec
            try:
                gaps, _ = dense_gaps(engine.params, cfg, engine.rope_tables, prompt, toks)
            finally:
                llama._moe_mlp_dense = dense
            gaps = gaps.float().cpu().tolist()
            keep_by_layer = []
            for layer in range(cfg.num_layers):
                keep = np.zeros((1, n_pos, cfg.num_experts), bool)
                for p in range(n_pos):
                    keep[0, p, list(served[(i, p, layer)][0])] = True
                keep_by_layer.append(torch.from_numpy(keep).to(engine.params.device))

            def dense_as_served(x, lp, cfg_, keep_by_layer=keep_by_layer):
                return dense(x, lp, cfg_, keep=keep_by_layer[layer_of[id(lp)]])

            llama._moe_mlp_dense = dense_as_served
            try:
                as_served, _ = dense_gaps(engine.params, cfg, engine.rope_tables, prompt, toks)
            finally:
                llama._moe_mlp_dense = dense
            as_served = float(as_served.max())
            flips = []
            for p in range(n_pos):
                for layer in range(cfg.num_layers):
                    key = (i, p, layer)
                    if key not in served:
                        raise AssertionError(f"[{label}] no served routing at request {i}, "
                                             f"position {p}, layer {layer}")
                    want_set, vals, by_expert = oracle_routes[key]
                    if served[key][0] != want_set:
                        margin = vals[K - 1] - vals[K]
                        # how far rounding moved the logits both forwards saw
                        shared = set(by_expert) & set(served[key][2])
                        moved = max((abs(by_expert[e] - served[key][2][e]) for e in shared),
                                    default=float("nan"))
                        flips.append((p, layer, margin, bf16_ulp(vals[K - 1]), moved))
            first = flips[0] if flips else None
            # token j is read from row len(prompt)-1+j
            before = [g for j, g in enumerate(gaps)
                      if first is None or len(prompt) - 1 + j < first[0]]
            worst = max(gaps)
            report.append({
                "request": i, "distance": round(worst, 4),
                "distance_routed_as_served": round(as_served, 4), "flips": len(flips),
                "positions": n_pos, "first_flip": None if first is None else {
                    "position": first[0], "in_prompt": first[0] < len(prompt),
                    "layer": first[1], "margin": first[2], "ulp": first[3],
                    "margin_in_ulps": round(first[2] / first[3], 3),
                    "logits_moved_in_ulps": round(first[4] / first[3], 3)},
                "tokens_before_first_flip": len(before),
                "their_distance": round(max(before), 4) if before else None,
                "flip_margins_in_ulps": [round(m / u, 2) for _, _, m, u, _ in flips[:12]],
                "least_flip_margin_in_ulps": round(min(m / u for _, _, m, u, _ in flips), 3)
                if flips else None})
            if as_served > LOGIT_MARGIN:
                faults.append(f"request {i}: {as_served:.3f} off the oracle routed as served")
            if worst > LOGIT_MARGIN and not any(m < u for _, _, m, u, _ in flips):
                faults.append(f"request {i}: {worst:.3f} off the oracle with no flip at a "
                              "margin below one bf16 ulp")
            if before and max(before) > LOGIT_MARGIN:
                faults.append(f"request {i}: a token before the first flip sits "
                              f"{max(before):.3f} off the oracle")
    log(f"serving [{label}] routing, served against the dense-MoE oracle forward "
        f"(flip: another top-{K} set at a position and layer; margin: the oracle's "
        f"k-th minus (k+1)-th router logit): " + json.dumps(report))
    off = [e for e in report if e["distance"] > LOGIT_MARGIN]
    log(f"serving [{label}] routing verdict: {len(off)} of {len(report)} greedy streams "
        f"more than {LOGIT_MARGIN} off the oracle; each has a flip below one bf16 ulp: "
        f"{not any('no flip' in f for f in faults)}; each has its first flip "
        f"below one bf16 ulp: "
        f"{all(e['first_flip'] and e['first_flip']['margin_in_ulps'] < 1 for e in off)}; "
        f"every first flip's margin within twice what rounding moved the logits there: "
        f"{all(e['first_flip']['margin_in_ulps'] < 2 * e['first_flip']['logits_moved_in_ulps'] for e in off if e['first_flip'])}; "
        f"every token before a stream's first flip within {LOGIT_MARGIN}: "
        f"{not any('before' in f for f in faults)}; every greedy token within "
        f"{LOGIT_MARGIN} of the oracle routed as served: "
        f"{not any('as served' in f for f in faults)} (largest "
        f"{max(e['distance_routed_as_served'] for e in report):.4f})")
    if faults:
        raise AssertionError(f"[{label}] routing: " + "; ".join(faults))


def mixtral_phase(card: str, smi: str) -> None:
    """mixtral-8x7b at full width (H 4096, 32 layers, 8 experts top-2, I
    14336, V 32000), random weights from seed 0 quantized int8 as drawn,
    the worker's options (512-token rounds, its pages): 8 requests of
    16..512 tokens, 32 out, one seeded sample, with the storm's gates (the
    routed MoE inside the decode graphs). The buckets keep JAX's capacity
    for a round's padded rows, capped at its real tokens
    (``llama.moe_capacity``), so a round of these prompts drops nothing.

    (a) bf16 (what the worker serves): the storm timed; then, cold again and
    with decode chunks eager, the same requests with every eager routed-MoE
    call held against its plain version at the same routing and capacity
    (:func:`moe_checked`), the drops counted, the dense-MoE oracle's
    distances printed (with no drop they stay far above 0.1 at bf16: a
    near-tie between experts, decided by the two forwards' bf16 rounding,
    routes a token to another expert, and a whole expert moves its row),
    and every served routing recorded (:func:`routes_recorded`) for
    :func:`routing_flips`, whose gates hold bf16 per token. The decode
    step's routed MoE once eagerly under the same check, the tree's bytes,
    the peak allocated and the decode step's device time.

    (b) f32 at the same options, served once inside :func:`moe_checked`:
    no assignment may drop, and every greedy token lies within the margin
    of the dense forward with the dense MoE oracle over the same (f32-drawn)
    int8 tree."""
    for dtype in ("bfloat16", "float32"):
        label = f"mixtral-8x7b int8, {dtype}"
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        engine, ecfg = build_engine(label, dict(MIXTRAL, dtype=dtype))
        build_s, built_peak = time.perf_counter() - t, torch.cuda.max_memory_allocated()
        rng = np.random.default_rng(5)
        vocab = engine.model_config.vocab_size
        requests = [(rng.integers(3, vocab, n).tolist(), SamplingParams(max_tokens=32))
                    for n in MIXTRAL_LENS]
        requests[6] = (requests[6][0], SamplingParams(max_tokens=32, temperature=0.8, seed=42))
        gates = dict(launched=("ragged_paged_attention", "paged_decode_attention"),
                     never=("flash_self_attention",), check_oracle=False)
        if dtype == "bfloat16":
            serving_phase(card, label, engine, ecfg, requests, **gates)
            serve_peak = torch.cuda.max_memory_allocated()
            flush_prefix_cache(engine)
            with moe_checked() as moe, routes_recorded(engine, requests) as served:
                recs = serve(engine, requests)
            engine.shutdown()
            check_streams(recs, requests,
                          lambda sp: set(sp.stop_token_ids) | set(ecfg.eos_token_ids))
            check_pool(label + ", checked", engine.stats())
        else:
            with moe_checked() as moe:
                _, _, recs = serving_phase(card, label + ", MoE checked a call at a time",
                                           engine, ecfg, requests, **gates)
            serve_peak = torch.cuda.max_memory_allocated()
        log(f"serving [{label}] routed MoE against its plain version over {moe['calls']} "
            f"eager layer calls: within {moe['max_rel_err']:.3e} of the output's scale "
            f"(tolerance {MOE_TOL:.3e}); {moe['dropped']} of {moe['assigned']} expert "
            f"assignments dropped by the bucket capacity (budget "
            f"{ecfg.prefill_budget_tokens})")
        if not moe["calls"]:
            raise AssertionError(f"[{label}] no eager routed-MoE call was checked")
        with dense_moe():
            if dtype == "float32":
                if moe["dropped"]:
                    raise AssertionError(f"[{label}] {moe['dropped']} assignments dropped")
                oracle(label + ", dense MoE oracle", engine, recs, requests)
            else:
                oracle_spread(label + ", dense MoE oracle", engine, recs, requests)
        if dtype == "bfloat16":
            routing_flips(label, engine, recs, requests, served)
        pools = (engine.pool.k_pool, engine.pool.v_pool)
        # the decode chunk's routed MoE (8 rows, inside a graph when served)
        # called eagerly once at its shape under the same check
        with moe_checked() as dec, torch.inference_mode():
            decode_step(engine.params, engine.rope_tables, pools)()
        log(f"serving [{label}] routed MoE at the decode step's shape (eager, once): "
            f"{dec['calls']} layer calls within {dec['max_rel_err']:.3e} of the output's "
            f"scale, {dec['dropped']} of {dec['assigned']} assignments dropped")
        if dec["calls"] != engine.model_config.num_layers or dec["dropped"]:
            raise AssertionError(f"[{label}] decode-shape MoE check: {dec}")
        step = [decode_step_ms(engine.params, engine.rope_tables, pools, iters=2, reps=2)
                for _ in range(2 if dtype == "bfloat16" else 1)]
        timed = label if dtype == "bfloat16" else label + ", MoE checked a call at a time"
        log(f"info [{smi}] {label}: tree {gib(quantized_bytes(engine.params))}; built in "
            f"{build_s:.1f} s (init, quantization and graph capture), peak allocated "
            f"{gib(built_peak)} after the build, {gib(serve_peak)} over the storm, "
            f"{gib(torch.cuda.max_memory_allocated())} with the checks, the oracle and the "
            f"timing; decode step (8 rows, head included, device ms) "
            f"{', '.join(f'{x:.2f}' for x in step)}; [{timed}] "
            f"{format_latency(STORM_NUMBERS[timed])}")
        del engine, pools
        free_card()


DP_LENS = (16, 96, 250, 511, 700, 1000, 1300, 1500)


def dp_requests(vocab: int) -> list:
    """16 greedy prompts of 16..1500 tokens (the storm's lengths twice), 32
    out each."""
    rng = np.random.default_rng(11)
    return [(rng.integers(3, vocab, n).tolist(), SamplingParams(max_tokens=32))
            for n in DP_LENS * 2]


def pool_storm(card: str, label: str, pool, requests, eos) -> tuple[list, dict]:
    """Serve ``requests`` through a pool with the kernel counts set to 0
    just before and read just after; the storm's gates over its replicas."""
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    recs = serve(pool, requests)
    wall = time.perf_counter() - t0
    for r in pool.replicas:
        r.shutdown()
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    check_streams(recs, requests, lambda sp: set(sp.stop_token_ids) | set(eos))
    if launches["ragged_paged_attention"] <= 0 or launches["paged_decode_attention"] <= 0 \
            or launches["flash_self_attention"]:
        raise AssertionError(f"[{label}] launches {launches}")
    for i, r in enumerate(pool.replicas):
        st = r.stats()
        check_pool(f"{label} replica {i}", st)
        if st["pipeline"]["decode_graphs"] and st["pipeline"]["decode_eager_chunks"]:
            raise AssertionError(f"[{label}] replica {i} ran eager decode chunks")
    numbers = latency_numbers([r["t0"] for r in recs], [r["ts"] for r in recs],
                              sum(len(r["toks"]) for r in recs), wall)
    STORM_NUMBERS[label] = numbers
    return recs, launches


def dp_phase(card: str, smi: str, params) -> None:
    """dp: a DataParallelServingPool of two bf16 llama-3-8b replicas on
    ``[cuda:0, cuda:0]`` sharing one params tree, lifecycle on: a 16-request
    storm (its tokens/s beside one engine's on the same requests,
    information only) with the storm's gates on each replica and the
    oracle; then a stream whose replica breaks after its first token fails
    over and ends with its full count through the oracle, and the census
    returns to two healthy through rebuild and probation."""
    label = "dp, 2 replicas"
    ecfg = engine_config_from_options(QUICKSTART)
    dev = CARD
    requests = dp_requests(params.cfg.vocab_size)
    one, _ = build_engine("dp baseline, one engine", QUICKSTART, params)
    serving_phase(card, "dp baseline, one engine", one, ecfg, requests,
                  launched=("ragged_paged_attention", "paged_decode_attention"),
                  never=("flash_self_attention",), check_oracle=False)
    del one
    free_card()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pool = DataParallelServingPool(ecfg, n_replicas=2, devices=[dev, dev], seed=0,
                                   params=params, lifecycle=LifecycleConfig(
                                       check_interval_s=0.05, rebuild_backoff_s=0.05,
                                       probation_successes=1))
    build_s = time.perf_counter() - t
    try:
        if not pool.replicas[0].params is pool.replicas[1].params is params:
            raise AssertionError("[dp] the replicas do not share the one params tree")
        recs, launches = pool_storm(card, label, pool, requests, ecfg.eos_token_ids)
        served = [r.stats()["requests_completed"] for r in pool.replicas]
        if min(served) <= 0:
            raise AssertionError(f"[dp] a replica served nothing: {served}")
        oracle(label, pool.replicas[0], recs, requests)
        log(f"serving [{label}]: built in {build_s:.1f} s, {len(requests)} requests "
            f"({served} a replica), launches {launches}, pages conserved on both")
        log(f"info [{smi}] serving [{label}]: {format_latency(STORM_NUMBERS[label])}; one "
            f"engine on the same requests: "
            f"{format_latency(STORM_NUMBERS['dp baseline, one engine'])}; tree "
            f"{gib(quantized_bytes(params))} shared by both replicas, peak allocated "
            f"{gib(torch.cuda.max_memory_allocated())}")
        # failover: the serving replica breaks after the stream's first token
        rid, prompt = "dp-failover", requests[4][0]
        broke = []

        def hook(ev, rec):
            if ev.token_id >= 0 and len(rec["toks"]) == 1:
                victim = pool._requests[rid].replica
                pool.replicas[victim]._decode_round = _boom
                broke.append(victim)

        streams = Streams()
        t_fail = time.perf_counter()
        pool.submit(prompt, SamplingParams(max_tokens=32), streams.emit_for(rid, hook), rid)
        streams.wait(pool.replicas[0], 120)
        stream_s = time.perf_counter() - t_fail
        rec = streams.recs[rid]
        if rec["fins"] not in (["length"], ["stop"]) or (
                rec["fins"] == ["length"] and len(rec["toks"]) != 32):
            raise AssertionError(f"[dp failover] {len(rec['toks'])} tokens, {rec['fins']}")
        if pool.failovers != 1 or not broke:
            raise AssertionError(f"[dp failover] failovers {pool.failovers}, broke {broke}")
        survivor = pool.replicas[1 - broke[0]]
        oracle("dp failover", survivor, [{"toks": rec["toks"]}],
               [(prompt, SamplingParams(max_tokens=32))], min_caught=None)
        # self-heal: quarantine, rebuild (a fresh engine and its graphs on
        # the shared params), probation, promotion by canaries
        lc, t_heal = pool.lifecycle, time.monotonic()
        deadline = t_heal + 120
        while lc.counts()["probation"] + lc.counts()["healthy"] < 2:
            if time.monotonic() > deadline:
                raise AssertionError(f"[dp self-heal] no rebuild: {lc.status()}")
            time.sleep(0.05)
        rebuilt_s = time.monotonic() - t_heal
        canaries = 0
        while lc.counts()["healthy"] < 2 and canaries < 4:
            serve(pool, [(requests[0][0], SamplingParams(max_tokens=8))], 1)
            canaries += 1
        if lc.counts()["healthy"] != 2 or pool.stats()["healthy"] != 2:
            raise AssertionError(f"[dp self-heal] census {lc.counts()}")
        if pool.replicas[broke[0]].params is not params:
            raise AssertionError("[dp self-heal] the rebuilt replica did not reuse the params")
        log(f"serving [dp failover and self-heal]: replica {broke[0]} broke after the "
            f"stream's first token; the stream failed over and ended "
            f"{rec['fins'][0]} with {len(rec['toks'])} tokens in {stream_s:.2f} s through "
            f"the oracle; the census "
            f"came back to 2 healthy: rebuilt into probation {rebuilt_s:.2f} s after the "
            f"break, promoted after {canaries} canary request(s); lifecycle "
            f"{json.dumps({k: v for k, v in lc.status().items() if k != 'replicas'})}")
        for r in pool.replicas:
            r.shutdown()
        check_pool("dp after self-heal", pool.replicas[broke[0]].stats())
    finally:
        pool.close()
    del pool
    free_card()


def _boom():
    raise RuntimeError("injected device fault")


def pd_phase(card: str, smi: str, params, requests, unified: list) -> None:
    """pd: a PDServingPool of 1 prefill + 1 decode bf16 llama-3-8b replica
    on ``[cuda:0, cuda:0]`` on the mixed storm: every stream handed off
    exactly once, the prefill engine's rounds only prefill / mixed and the
    decode engine's only decode (its chunks graph replays), I1 on both,
    every greedy token through the oracle. Prints how many streams equal
    the unified engine's, the handoff ms (export to pinned host, waited
    for, plus the import's enqueue) and ttft beside the unified storm."""
    label = "pd, 1 prefill + 1 decode"
    ecfg = engine_config_from_options(QUICKSTART)
    dev = CARD
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pool = PDServingPool(ecfg, n_prefill=1, n_decode=1, devices=[dev, dev], seed=0,
                         params=params)
    build_s = time.perf_counter() - t
    try:
        recs, launches = pool_storm(card, label, pool, requests, ecfg.eos_token_ids)
        st = pool.stats()
        pre, dec = st["per_replica"]
        if st["pd"]["handoffs"] != len(requests) or st["pd"]["handoffs_failed"] \
                or pre["pd"]["exported"] != len(requests) \
                or dec["pd"]["imported"] != len(requests):
            raise AssertionError(f"[pd] handoffs {st['pd']}, {pre['pd']}, {dec['pd']}")
        if pre["rounds"]["decode"] or not pre["rounds"]["prefill"] + pre["rounds"]["mixed"] \
                or dec["rounds"]["mixed"] or dec["rounds"]["prefill"] \
                or not dec["rounds"]["decode"]:
            raise AssertionError(f"[pd] rounds not role-pure: prefill {pre['rounds']}, "
                                 f"decode {dec['rounds']}")
        pipe = dec["pipeline"]
        if (pipe["decode_graph_replays"] if pipe["decode_graphs"]
                else pipe["decode_eager_chunks"]) <= 0 or dec["preemptions"]:
            raise AssertionError(f"[pd] decode engine: {dec['pipeline']}, preemptions "
                                 f"{dec['preemptions']}")
        oracle(label, pool.replicas[1], recs, requests)
        same = sum(a["toks"] == b["toks"] for a, b in zip(recs, unified))
        hand = dec["pd"]["handoff_ms"]
        log(f"serving [{label}]: built in {build_s:.1f} s; {st['pd']['handoffs']} handoffs, "
            f"rounds prefill engine {pre['rounds']}, decode engine {dec['rounds']}, "
            f"{dec['pipeline']['decode_graph_replays']} decode graph replays, launches "
            f"{launches}, pages conserved on both")
        log(f"info [{smi}] serving [{label}]: {format_latency(STORM_NUMBERS[label])}; "
            f"unified mixed storm: {format_latency(STORM_NUMBERS['mixed'])}; handoff ms "
            f"p50={hand['p50']:.3f} max={hand['max']:.3f} over {hand['count']}; streams "
            f"identical to the unified engine's: {same} of {len(requests)}; tree "
            f"{gib(quantized_bytes(params))} shared by both engines, peak allocated "
            f"{gib(torch.cuda.max_memory_allocated())}")
    finally:
        pool.close()
    del pool
    free_card()


# ------------------------------------------------------------------ tensor parallelism
#: the tp storm's degree: both ranks on the one card (4 kv heads a rank at
#: llama-3-8b)
TP = 2
#: tp=8's requests (prompt lengths, 32 tokens out): 1 kv head a rank
TP8_LENS = (16, 250, 700)
#: llama-3-8b's widths at 4 layers, for the f32 identity (registered here)
TP_F32_MODEL = "llama-3-8b-4l"
#: f32, TF32 off: the most tp=2's logits may differ from tp=1's where a
#: seeded stream first parts from tp=1's (a rank-order reduction moves last
#: bits only)
TP_F32_LOGIT_TOL = 1e-3


@dataclasses.dataclass
class DenseOracle:
    """What :func:`oracle` reads of an engine, pointed at the unsharded
    weights a tp engine was cut from (its dense forward is the reference)."""

    params: object
    model_config: object
    rope_tables: tuple


def tp_engine(label: str, opts: dict, params, tp: int, eager_decode: bool = False):
    """A tp engine from worker-shaped ``opts`` over ``params`` (cut into tp
    rank copies), every rank on the card; ``eager_decode`` as for
    :func:`build_engine`."""
    ecfg = engine_config_from_options(dict(opts, tp=tp))
    t = time.perf_counter()
    engine = ContinuousBatchingEngine(ecfg, params=params, seed=0, rank_devices=[CARD] * tp,
                                      _eager_decode=eager_decode)
    st = engine.stats()
    log(f"serving engine [{label}] built: {ecfg.model}, tp={tp} on {st['mesh']['rank_devices']}, "
        f"kv heads sharded {st['mesh']['kv_heads_sharded']}, {st['mode']}, "
        f"{st['pages_total']} pages, decode graphs={st['pipeline']['decode_graphs']}, "
        f"{time.perf_counter() - t:.1f} s (the cut and graph capture included)")
    return engine, ecfg


def per_round(launches: dict, stats: dict) -> tuple[float, float]:
    """Ragged launches a mixed round and decode launches a decode chunk, of
    one serving run (``stats["run"]`` from :func:`serving_phase`)."""
    run = stats["run"]
    return (launches["ragged_paged_attention"] / max(1, run["mixed_rounds"]),
            launches["paged_decode_attention"] / max(1, run["decode_chunks"]))


def plan_against_allocation(label: str, engine) -> dict:
    """The gate's plan equals what each rank allocated, to the byte: its
    weights the plan's per-rank figure (rank 0 the per-device one, the
    others less the embedding and norms only rank 0 holds), its pool the
    per-device kv bytes."""
    mesh = engine.mesh_info()
    plan = mesh["plan"]
    weights, pool = rank_bytes(engine.params), engine.pool.rank_bytes()
    if (weights != plan["param_bytes_per_rank"]
            or weights[0] != plan["param_bytes_per_device"]
            or pool != [plan["kv_bytes_per_device"]] * engine.tp):
        raise AssertionError(f"[{label}] plan {plan} against ranks' weights {weights}, "
                             f"pools {pool}")
    log(f"serving [{label}] plan against allocation: the {engine.tp} ranks hold {weights} "
        f"weight bytes (rank 0 the plan's param_bytes_per_device, the others its "
        f"param_bytes_per_rank without the embedding and norms) and {pool[0]} pool bytes "
        f"each, the plan's kv_bytes_per_device, exactly ({gib(weights[0])} + "
        f"{gib(pool[0])} on rank 0, {gib(weights[-1])} + {gib(pool[0])} on the others)")
    return mesh


def tp_storm(card: str, label: str, engine, ecfg, requests, want_round: tuple,
             dense: DenseOracle, min_caught=MIN_RUNNER_UP_CAUGHT):
    """The storm's gates on a tp engine (one terminal a stream, ragged and
    decode launched and flash not, decode chunks replayed as graphs, I1 on
    the pool the ranks share, no flagged synchronising call), greedy tokens
    through the dense oracle of the unsharded weights, and the launches a
    round equal to ``want_round``."""
    launches, stats, recs = serving_phase(
        card, label, engine, ecfg, requests,
        launched=("ragged_paged_attention", "paged_decode_attention"),
        never=("flash_self_attention",), sync_free=True, check_oracle=False)
    oracle(label, dense, recs, requests, min_caught)
    got = per_round(launches, stats)
    if got != want_round:
        raise AssertionError(f"[{label}] launches a mixed round / a decode chunk {got}, "
                             f"want {want_round}")
    log(f"serving [{label}] launches: {got[0]:.0f} ragged a mixed round and {got[1]:.0f} "
        f"decode a decode chunk ({stats['run']}), tp times tp=1's")
    plan_against_allocation(label, engine)
    return launches, stats, recs


def reduction_share(card: str, engine, tp1_params, rope) -> None:
    """Device time of a decode step (8 rows) at tp and at tp=1, and of the
    step's reductions alone (two rank-order f32 sums a layer of [8, 1, H]
    partials): the reduction's share of the step."""
    cfg = engine.model_config
    mesh = engine.mesh
    n_pages = engine.pool.num_pages
    tp_ms = decode_step_ms(engine.params, rope, engine.pool.pools)
    k1 = torch.zeros((cfg.num_layers, n_pages, engine.pool.page_size, cfg.num_kv_heads,
                      cfg.head_dim), dtype=tp1_params.dtype, device=CARD)
    one_ms = decode_step_ms(tp1_params, rope, (k1, torch.zeros_like(k1)))
    del k1
    parts = [torch.randn((8, 1, cfg.hidden_size), device=CARD) for _ in range(mesh.tp)]

    def reductions():
        for _ in range(2 * cfg.num_layers):
            mesh.all_reduce_sum(parts)

    with torch.inference_mode():
        red_ms = graph_ms(reductions, iters=4, reps=3)
    free_card()
    log(f"info [{card}] tp decode step (8 rows, lengths {DECODE_LENS[0]}..{DECODE_LENS[-1]}, "
        f"device time): tp={mesh.tp} {tp_ms:.3f} ms, tp=1 {one_ms:.3f} ms; the step's "
        f"{2 * cfg.num_layers} rank-order reductions {red_ms:.3f} ms = "
        f"{red_ms / tp_ms:.3f} of the tp step")


@contextlib.contextmanager
def recording_samples():
    """Every sampler call of a scheduler round or an eager decode chunk
    records, for each row that samples, its logits, its uniform and the
    token it drew (a replayed graph calls nothing: run the engine with
    eager decode)."""
    mods = (scheduler_module, programs_module)
    orig = sampling.sample_token_per_slot
    calls: list[dict] = []

    def recording(logits, uniforms, temperature, top_p, top_k, all_greedy=None):
        out = orig(logits, uniforms, temperature, top_p, top_k, all_greedy)
        for i in torch.nonzero(temperature > 0).flatten().tolist():
            calls.append({"logits": logits[i].clone(), "u": float(uniforms[i]),
                          "tok": int(out[i]), "warp": (float(temperature[i]),
                                                       float(top_p[i]), int(top_k[i]))})
        return out

    for m in mods:
        m.sample_token_per_slot = recording
    try:
        yield calls
    finally:
        for m in mods:
            m.sample_token_per_slot = orig


def seeded_witness(sp, j: int, streams: dict, calls: dict) -> dict:
    """Where tp=2's seeded stream first parts from tp=1's (token ``j``):
    both engines drew the seed's own ``j``-th uniform u, each engine's token
    follows from its own logits and u by the sampler's inverse CDF, the two
    logits rows agree within TP_F32_LOGIT_TOL, and the parting is explained
    by their difference: where the draw lands at two positions, u lies
    within the two CDFs' difference of the boundary between them (each
    engine's own CDF: the sampler's warp, sort and f32 running sum); where
    it lands at one position that the two sorts fill with different tokens
    (a near-tie ordered apart), the two tokens' logits lie within twice the
    rows' difference of each other in both engines."""
    if sp.seed is None or j >= min(len(t) for t in streams.values()):
        raise AssertionError(f"[tp f32] a sampled stream without a seed, or one that ends "
                             f"first at token {j}: {sp}")
    g = sampling.make_slot_generator(sp.seed, CARD)
    u = [float(torch.rand(1, generator=g, device=CARD)) for _ in range(j + 1)][j]
    seen = {}
    for tp, toks in streams.items():
        hit = [c for c in calls[tp] if c["u"] == u and c["tok"] == toks[j]]
        if not hit:
            raise AssertionError(f"[tp f32] tp={tp}: no sampled row drew the seed's uniform "
                                 f"{j} ({u}) and emitted {toks[j]}")
        c = hit[0]
        temp, top_p, top_k = (torch.tensor([x], device=CARD) for x in c["warp"])
        masked, idx = sampling._warp_sorted(c["logits"][None], temp, top_p, top_k)
        cdf = sampling.cumsum_rows(torch.softmax(masked, dim=-1))[0]
        pos = min(int(torch.searchsorted(cdf, (u * cdf[-1]).reshape(1), right=True)),
                  int(torch.isfinite(masked).sum()) - 1)
        if int(idx[0, pos]) != toks[j]:
            raise AssertionError(f"[tp f32] tp={tp}: the inverse CDF of u={u} gives "
                                 f"{int(idx[0, pos])}, the engine emitted {toks[j]}")
        seen[tp] = (c["logits"].double(), cdf.double() / float(cdf[-1]), pos, idx[0])
    (l1, c1, p1, i1), (l2, c2, p2, i2) = seen[1], seen[TP]
    d_logit = float((l1 - l2).abs().max())
    a, b = int(i1[p1]), int(i2[p2])
    out = {"token": j, "u": u, "tp1": [a, p1], f"tp{TP}": [b, p2],
           "max_logit_difference": d_logit}
    if p1 == p2:
        # the draw lands at one position of both sorts, which order a
        # near-tie apart: the two tokens' logits lie within the rows'
        # difference of each other in both engines
        gaps = [abs(float(l[a] - l[b])) for l in (l1, l2)]
        out.update(kind="sort order", logit_gaps=gaps, bound=2 * d_logit,
                   b_in_tp1_sort=int(torch.nonzero(i1 == b)[0, 0]),
                   a_in_tp2_sort=int(torch.nonzero(i2 == a)[0, 0]))
        held = max(gaps) <= 2 * d_logit
    else:
        # the last position both CDFs put below the draw
        k = min(p1, p2)
        dist, diff = abs(u - float(c1[k])), abs(float(c1[k]) - float(c2[k]))
        out.update(kind="cdf", boundary=k, draw_to_boundary=dist, cdf_difference=diff)
        held = dist <= diff + 1e-7
    if not held or d_logit > TP_F32_LOGIT_TOL:
        raise AssertionError(f"[tp f32] the seeded stream parts from tp=1's unexplained "
                             f"(logit tolerance {TP_F32_LOGIT_TOL}): {json.dumps(out)}")
    return out


def f32_identity(card: str, requests) -> None:
    """At llama-3-8b widths and 4 layers, f32, TF32 off, every request
    pending before the first admission so both engines run the same rounds:
    every greedy stream at tp=2 equals tp=1's token for token. Each engine
    serves twice, with decode graphs and with eager decode, and the two
    runs' streams are equal (the graph draws each seeded stream's uniforms
    as eager decode does). A seeded sampled stream equals tp=1's up to its
    first difference, and there :func:`seeded_witness` holds on the eager
    runs' recorded logits: its inverse-CDF draw sums 128256 probabilities,
    so logits that differ in their last bits (the rank-order reduction,
    ROADMAP departure 12) move its CDF, and a draw that lands within that
    move of a boundary takes the next token."""
    MODEL_CONFIGS[TP_F32_MODEL] = dataclasses.replace(
        get_config("llama-3-8b"), name=TP_F32_MODEL, num_layers=4)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    opts = dict(QUICKSTART, model_config=TP_F32_MODEL, dtype="float32")
    try:
        params = llama.init_params(get_config(TP_F32_MODEL), 0, torch.float32, CARD)
        runs, calls = {}, {}
        for tp in (1, TP):
            for eager in (False, True):
                label = f"tp f32, tp={tp}" + (", eager decode" if eager else "")
                if tp == 1:
                    engine, ecfg = build_engine(label, opts, params, eager_decode=eager)
                else:
                    engine, ecfg = tp_engine(label, opts, params, tp, eager_decode=eager)
                with recording_samples() if eager else contextlib.nullcontext([]) as rec:
                    _, _, recs = serving_phase(
                        card, label, engine, ecfg, requests,
                        launched=("ragged_paged_attention", "paged_decode_attention"),
                        never=("flash_self_attention",), at_once=True, check_oracle=False)
                runs[tp, eager] = [(r["toks"], r["fins"]) for r in recs]
                if eager:
                    calls[tp] = rec
                del engine
                free_card()
            if runs[tp, False] != runs[tp, True]:
                raise AssertionError(f"[tp f32] tp={tp}: graph and eager decode streams differ "
                                     f"at requests {[i for i, (x, y) in enumerate(zip(runs[tp, False], runs[tp, True])) if x != y]}")
        greedy = [i for i, (_, sp) in enumerate(requests) if sp.temperature == 0]
        differ = [i for i in greedy if runs[1, False][i] != runs[TP, False][i]]
        if differ:
            raise AssertionError(f"[tp f32] tp={TP} greedy streams differ from tp=1's at "
                                 f"requests {differ}")
        sampled = {}
        for i, (_, sp) in enumerate(requests):
            if i in greedy:
                continue
            streams = {tp: runs[tp, True][i][0] for tp in (1, TP)}
            j = first_divergence(streams[1], streams[TP])
            sampled[i] = None if j is None else seeded_witness(sp, j, streams, calls)
        log(f"serving [tp f32]: {TP_F32_MODEL} (llama-3-8b widths, 4 layers) at f32, TF32 "
            f"off: the {len(greedy)} greedy streams at tp={TP} equal tp=1's token for token "
            f"({sum(len(runs[1, False][i][0]) for i in greedy)} tokens), graph and eager "
            f"decode streams equal at both degrees; seeded sampled streams (None: equal to "
            f"tp=1's throughout; else where they part, and the witness there): "
            f"{json.dumps(sampled)}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
        MODEL_CONFIGS.pop(TP_F32_MODEL, None)
        free_card()


def gate_phase(card: str) -> None:
    """The gate refuses without allocating: llama-3-70b bf16 at tp=1 over the
    card's memory raises InfeasiblePlanError and ``memory_allocated`` does
    not move; llama-3-70b int8 at tp=8 plans as fitting 80 GB (and the
    card)."""
    total = card_hbm_bytes(CARD)
    ecfg = EngineConfig(model="llama-3-70b", max_seq_len=2048, max_batch=8,
                        prefix_cache_pages=321, prefix_page_size=64,
                        hbm_bytes_per_device=total)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated(CARD)
    try:
        ContinuousBatchingEngine(ecfg)
    except InfeasiblePlanError as e:
        refused = e
    else:
        raise AssertionError("[tp gate] llama-3-70b bf16 at tp=1 was built on one card")
    after = torch.cuda.memory_allocated(CARD)
    if after != before:
        raise AssertionError(f"[tp gate] the refused build allocated {after - before} bytes")
    fits = {budget: gate_engine_plan("llama-3-70b", 8, quantization="int8", hbm_bytes=budget)
            for budget in (H100_HBM_BYTES, total)}
    if not all(p["fits"] and p["enforced"] for p in fits.values()):
        raise AssertionError(f"[tp gate] llama-3-70b int8 tp=8 does not fit: {fits}")
    p = refused.plan
    log(f"serving [tp gate] on {card} (total_memory {total} bytes): llama-3-70b bf16 tp=1 "
        f"refused before allocating (memory_allocated {before} before and after): needs "
        f"{p['total_bytes_per_device']} bytes/device = {p['hbm_utilization']}x; llama-3-70b "
        f"int8 tp=8 fits: {fits[H100_HBM_BYTES]['total_bytes_per_device']} bytes/device = "
        f"{fits[H100_HBM_BYTES]['hbm_utilization']} of 80 GB, "
        f"{fits[total]['hbm_utilization']} of the card")


def tp_gauge_phase(card: str) -> None:
    """A host serving llama-3-8b at tp=2 over HTTP (both ranks on the card:
    the worker's ``device`` names it), with monitoring: a completion, then
    ``llm_mesh_devices`` reads 2 and ``/v1/monitoring/replicas`` carries the
    mesh block."""
    cfg = http_config()
    entry = next(m for m in cfg["modules"]["model_registry"]["config"]["models"]
                 if m["provider_model_id"] == "llama-3-8b")
    entry["engine_options"] = dict(QUICKSTART, tp=TP)
    cfg["modules"]["model_registry"]["config"]["models"] = [entry]
    cfg["modules"]["llm_gateway"]["config"]["worker"] = {"device": str(CARD)}
    cfg["modules"]["monitoring"] = {"config": {}}
    cfg["server"] = {"home_dir": str(Path(__file__).resolve().parent / "build" / "chip_smoke"
                                     / "home-tp")}
    srv = BackgroundServer(cfg).start()
    try:
        t = time.perf_counter()
        status, _, body = http_json(srv.port, "/v1/completions",
                                    {"model": HTTP_MODEL, "prompt": "tensor parallel",
                                     "max_tokens": 8})
        if status != 200 or body["usage"]["output_tokens"] != 8:
            raise AssertionError(f"[tp http] completion: {status} {body}")
        status, _, text = http_call(srv.port, "GET", "/metrics")
        gauges = parse_metrics(text)
        mesh_devices = gauges.get("llm_mesh_devices", {}).get("")
        status_r, _, rows = http_call(srv.port, "GET", "/v1/monitoring/replicas")
        rows = rows["replicas"] if isinstance(rows, dict) else rows
        mesh = rows[0].get("mesh") or {}
        if status != 200 or mesh_devices != float(TP) or status_r != 200 or \
                mesh.get("tp") != TP or not mesh.get("kv_heads_sharded"):
            raise AssertionError(f"[tp http] llm_mesh_devices {mesh_devices}, replicas "
                                 f"{status_r} {rows}")
        log(f"serving [tp http]: llama-3-8b at tp={TP} on {mesh['rank_devices']} served a "
            f"completion in {time.perf_counter() - t:.1f} s (build included); "
            f"llm_mesh_devices {mesh_devices:.0f}, replicas mesh block {json.dumps(mesh)}")
    finally:
        srv.stop()
    del srv
    free_card()


def tp_phase(card: str, smi: str, params, requests, tp1_launches: dict, tp1_stats: dict) -> None:
    """Tensor-parallel serving on the one card: the storm at tp=2 (both
    ranks on the card) beside tp=1's on the same weights (the mixed run
    above), three requests at tp=8, the f32 identity, the reduction's share
    of a decode step, the plan against allocation, the gate, and the
    ``llm_mesh_devices`` gauge over HTTP. ``smi`` labels every number."""
    t_phase = time.perf_counter()
    free_card()
    cfg = get_config("llama-3-8b")
    rope = rope_frequencies(cfg.head_dim, max(cfg.max_position, QUICKSTART["max_seq_len"]),
                            cfg.rope_theta, device=CARD)
    dense = DenseOracle(params, cfg, rope)
    tp1_round = per_round(tp1_launches, tp1_stats)
    if tp1_round != (cfg.num_layers, cfg.num_layers * QUICKSTART["decode_chunk"]):
        raise AssertionError(f"[tp] tp=1 launches a round {tp1_round} ({tp1_stats['run']})")

    engine, ecfg = tp_engine(f"tp={TP}", QUICKSTART, params, TP)
    serve(engine, [(requests[3][0], SamplingParams(max_tokens=12))], 1)  # the probe, as tp=1
    tp_storm(card, f"tp={TP}", engine, ecfg, requests, tuple(TP * x for x in tp1_round), dense)
    reduction_share(smi, engine, params, rope)
    del engine
    free_card()

    rng = np.random.default_rng(8)
    few = [(rng.integers(3, cfg.vocab_size, n).tolist(), SamplingParams(max_tokens=32))
           for n in TP8_LENS]
    engine, ecfg = build_engine("tp=1, three requests", QUICKSTART, params)
    serving_phase(card, "tp=1, three requests", engine, ecfg, few,
                  launched=("ragged_paged_attention", "paged_decode_attention"),
                  never=("flash_self_attention",), check_oracle=False)
    del engine
    free_card()
    engine, ecfg = tp_engine("tp=8", QUICKSTART, params, 8)
    tp_storm(card, "tp=8", engine, ecfg, few, tuple(8 * x for x in tp1_round), dense,
             min_caught=None)
    del engine
    free_card()
    for label in ("mixed", f"tp={TP}", "tp=1, three requests", "tp=8"):
        log(f"info [{smi}] serving [{label}]: {format_latency(STORM_NUMBERS[label])}")

    f32_identity(card, requests)
    gate_phase(card)
    tp_gauge_phase(card)
    log(f"serving [tp] phase done in {time.perf_counter() - t_phase:.1f} s")


def tp_only(card: str, smi: str) -> None:
    """``--tp``: the mixed storm at tp=1 (the tp phase's reference), then the
    tp phase alone, for a check of that phase without the whole script."""
    with torch.inference_mode():
        engine, ecfg = build_engine("mixed", QUICKSTART)
        requests = storm_requests(engine, ecfg)
        mixed, stats, _ = serving_phase(
            card, "mixed", engine, ecfg, requests,
            launched=("ragged_paged_attention", "paged_decode_attention"),
            never=("flash_self_attention",), sync_free=True)
        params = engine.params
        del engine
        free_card()
        tp_phase(card, smi, params, requests, mixed, stats)


def serving_phases(card: str, smi: str) -> dict[str, int]:
    """The serving runs on one set of weights. Returns the kernels'
    main-path launch counts: the paged kernels from the mixed run, flash
    from the phase-separated run and the lockstep storm."""
    engine, ecfg = build_engine("mixed", QUICKSTART)
    requests = storm_requests(engine, ecfg)
    mixed, stats, unified = serving_phase(card, "mixed", engine, ecfg, requests,
                                    launched=("ragged_paged_attention", "paged_decode_attention"),
                                    never=("flash_self_attention",), sync_free=True)
    if stats["pipeline"]["lookahead_rounds"] <= 0:
        raise AssertionError(f"[mixed] the lookahead ring was never used: {stats['pipeline']}")
    params = engine.params
    repair_a_cost(card, engine)
    del engine
    card_memory("mixed")

    # the same storm with the ring off; the probe request of storm_requests
    # warms this engine the same way (and caches the same prompt)
    engine, ecfg = build_engine("mixed, depth 0", dict(QUICKSTART, decode_lookahead=0), params)
    serve(engine, [(requests[3][0], SamplingParams(max_tokens=12))], 1)
    serving_phase(card, "mixed, depth 0", engine, ecfg, requests,
                  launched=("ragged_paged_attention", "paged_decode_attention"),
                  never=("flash_self_attention",))
    del engine
    card_memory("mixed, depth 0")

    for depth in (2, 0):
        graphs_against_eager(card, params, requests, depth)
    card_memory("graphs against eager")

    # an unbounded round budget lets the storm's same-bucket prompts (700 and
    # 1000 at 1024, 1300 and 1500 at 2048) meet in one admission pass and
    # coalesce; at 512 the budget admits each long prompt alone
    phase_opts = dict(QUICKSTART, mixed_batch=False, prefill_coalesce=4,
                      prefill_budget_tokens=0)
    engine, ecfg = build_engine("phase-separated", phase_opts, params)
    phase, _, _ = serving_phase(card, "phase-separated", engine, ecfg, requests,
                                launched=("flash_self_attention", "paged_decode_attention"),
                                never=("ragged_paged_attention",))
    del engine
    card_memory("phase-separated")

    engine, ecfg = build_engine("dense", dict(QUICKSTART, prefix_cache_pages=0), params)
    dense_requests = [(p, SamplingParams(max_tokens=16)) for p, _ in requests[:4]]
    serving_phase(card, "dense", engine, ecfg, dense_requests,
                  launched=("flash_self_attention",),
                  never=("ragged_paged_attention", "paged_decode_attention"))
    del engine
    card_memory("dense")

    for label, opts, is_mixed in [("prefix-mixed", QUICKSTART, True),
                                  ("prefix-phase-separated", phase_opts, False)]:
        engine, ecfg = build_engine(label, opts, params)
        prefix_phase(card, label, engine, ecfg, is_mixed)
        del engine
        card_memory(label)
    cancel_phase(card, params)
    card_memory("cancel")
    preempt_phase(card, params)
    card_memory("preemption")
    tenants_phase(card, params)
    card_memory("tenants")
    SPEC_LAUNCHES.update(spec_phase(card, params))
    card_memory("spec storm")
    lockstep_flash = lockstep_storm_phase(card, smi, params, requests)
    card_memory("lockstep storm")
    lockstep_spec_phase(card, smi, params)
    card_memory("lockstep speculation")
    quant_phase(card, smi, params)
    card_memory("quant-8b")
    dp_phase(card, smi, params)
    card_memory("dp")
    pd_phase(card, smi, params, requests, unified)
    card_memory("pd")
    tp_phase(card, smi, params, requests, mixed, stats)
    card_memory("tp")
    del params
    card_memory("serving weights dropped")
    mixtral_phase(card, smi)
    card_memory("mixtral")
    tiny_quickstart_run(card)
    card_memory("tiny-llama quickstart")
    return {"ragged_paged_attention": mixed["ragged_paged_attention"],
            "paged_decode_attention": mixed["paged_decode_attention"],
            "flash_self_attention": phase["flash_self_attention"] + lockstep_flash}


# ------------------------------------------------------------------ HTTP phases
HTTP_MODEL = "local::llama-3-8b"
HTTP_ONE_SLOT = "local::tiny-llama-one-slot"
HTTP_TINY_SPEC = "local::tiny-llama-spec"
EMBED_MODEL = "local::bge-base-en"
HTTP_STORM_LENS = (16, 96, 250, 511, 700, 1000, 1300, 1500)


def http_config() -> dict:
    """The quickstart's sections serving llama-3-8b with the quickstart
    worker's options (random bf16 weights from seed 0, the byte tokenizer),
    a one-slot tiny-llama with ``max_pending: 1``, the tiny-llama quickstart
    with ``scheduler_spec_k`` 4, and bge-base-en embeddings; port 0."""
    llama_entry = {"provider_slug": "local", "provider_model_id": "llama-3-8b",
                   "approval_state": "approved", "managed": True, "architecture": "llama",
                   "capabilities": {"chat": True, "streaming": True},
                   "limits": {"max_input_tokens": 2000, "max_output_tokens": 2048},
                   "engine_options": dict(QUICKSTART)}
    one_slot = {"provider_slug": "local", "provider_model_id": "tiny-llama-one-slot",
                "approval_state": "approved", "managed": True,
                "engine_options": {"model_config": "tiny-llama", "max_seq_len": 2048,
                                   "max_batch": 1, "max_pending": 1}}
    # the tiny-llama quickstart with speculative rounds; bge-base-en
    # embeddings (random weights from a seed: no checkpoint)
    tiny_spec = {"provider_slug": "local", "provider_model_id": "tiny-llama-spec",
                 "approval_state": "approved", "managed": True,
                 "engine_options": dict(TINY_QUICKSTART, scheduler_spec_k=SPEC_K)}
    bge = {"provider_slug": "local", "provider_model_id": "bge-base-en",
           "approval_state": "approved", "managed": True, "architecture": "bert",
           "capabilities": {"embeddings": True}, "engine_options": {"model_config": "bge-base-en"}}
    return {"modules": {
        "api_gateway": {"config": {"bind_addr": "127.0.0.1:0", "auth_disabled": True}},
        "tenant_resolver": {"config": {"single_tenant": "default"}},
        "model_registry": {"config": {"models": [llama_entry, one_slot, tiny_spec, bge]}},
        "llm_gateway": {"config": {"worker": {}}}}}


def letters(rng, n: int) -> str:
    """n random lower-case letters: n byte tokens (plus bos) of the prompt."""
    return "".join(chr(c) for c in rng.integers(97, 123, n))


def http_json(port: int, path: str, body: dict, headers: dict | None = None,
              timeout: float = 600.0) -> tuple[int, dict, dict]:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request("POST", path, body=json.dumps(body),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        return (resp.status, {k.lower(): v for k, v in resp.getheaders()},
                json.loads(resp.read()))
    finally:
        conn.close()


def sse_streams(port: int, bodies: list[dict], headers: dict | None = None,
                headers_each: list[dict] | None = None) -> list[dict]:
    """SSE ``/v1/completions`` requests all in flight at once from this
    thread: each is sent on its own connection as soon as the one before is
    sent (as an engine ``submit`` returns at once), then every stream is read
    as its bytes arrive (one selector), each frame stamped on arrival. Per
    request: ``t0`` (sent), the status and headers, and each frame as
    (arrival time, event name, data) in order (or the problem ``body``).
    ``headers_each``: one more header dict for each body."""
    sel = selectors.DefaultSelector()
    recs = []
    try:
        for n, body in enumerate(bodies):
            extra = "".join(f"{k}: {v}\r\n" for k, v in
                            {**(headers or {}), **(headers_each[n] if headers_each else {})
                             }.items())
            raw = json.dumps({**body, "stream": True}).encode()
            sock = socket.create_connection(("127.0.0.1", port), timeout=600)
            rec = {"t0": time.perf_counter(), "status": None, "headers": {}, "frames": [],
                   "buf": b"", "head": False}
            sock.sendall(f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\nConnection: "
                         f"close\r\nContent-Type: application/json\r\nContent-Length: "
                         f"{len(raw)}\r\n{extra}\r\n".encode() + raw)
            sock.setblocking(False)
            sel.register(sock, selectors.EVENT_READ, rec)
            recs.append(rec)
        left = len(recs)
        while left:
            ready = sel.select(timeout=600)
            if not ready:
                raise AssertionError("[sse] no stream made progress for 600 s")
            for key, _ in ready:
                data, rec = key.fileobj.recv(65536), key.data
                now = time.perf_counter()
                if not data:
                    sel.unregister(key.fileobj)
                    key.fileobj.close()
                    left -= 1
                    if rec["status"] != 200:
                        rec["body"] = json.loads(rec["buf"] or b"null")
                    continue
                rec["buf"] += data
                if not rec["head"] and b"\r\n\r\n" in rec["buf"]:
                    head, rec["buf"] = rec["buf"].split(b"\r\n\r\n", 1)
                    lines = head.decode("latin-1").split("\r\n")
                    rec["status"], rec["head"] = int(lines[0].split()[1]), True
                    rec["headers"] = {k.strip().lower(): v.strip() for k, _, v in
                                      (ln.partition(":") for ln in lines[1:])}
                while rec["head"] and rec["status"] == 200 and b"\n\n" in rec["buf"]:
                    frame, rec["buf"] = rec["buf"].split(b"\n\n", 1)
                    fields = dict(ln.split(": ", 1) for ln in frame.decode().split("\n"))
                    rec["frames"].append((now, fields.get("event"), fields.get("data")))
    finally:
        for key in list(sel.get_map().values()):
            key.fileobj.close()
        sel.close()
    return recs


def sse_chunks(label: str, rec: dict) -> list[dict]:
    """The SSE contract of ``tests/test_e2e_server.py:224-249``: 200, an
    event stream, ``data: [DONE]`` last, the role in the first delta only,
    id / model / delta in every chunk, a final chunk with finish_reason and
    usage (and usage nowhere else), no error event. Returns the chunks."""
    if rec["status"] != 200 or not rec["headers"].get("content-type", "").startswith(
            "text/event-stream"):
        raise AssertionError(f"[{label}] status {rec['status']}: {rec.get('body')}")
    if any(ev is not None for _, ev, _ in rec["frames"]):
        raise AssertionError(f"[{label}] an event frame: {rec['frames'][-3:]}")
    datas = [d for _, _, d in rec["frames"]]
    if not datas or datas[-1] != "[DONE]":
        raise AssertionError(f"[{label}] the stream did not end with [DONE]: {datas[-2:]}")
    chunks = [json.loads(d) for d in datas[:-1]]
    final = chunks[-1] if chunks else {}
    if (not chunks or chunks[0]["delta"].get("role") != "assistant"
            or any("role" in c["delta"] for c in chunks[1:])
            or not all("id" in c and "model" in c and "delta" in c for c in chunks)
            or "usage" not in final or any("usage" in c for c in chunks[:-1])
            or final["usage"]["output_tokens"] <= 0):
        raise AssertionError(f"[{label}] SSE contract broken: {chunks[:2]} ... {chunks[-2:]}")
    return chunks


def wait_idle(engine, timeout: float = 120.0) -> None:
    """Until the engine holds no request (``in_flight``: decoding,
    prefilling, preempted, taken for admission or queued)."""
    deadline = time.monotonic() + timeout
    while engine.in_flight():
        if time.monotonic() > deadline:
            raise AssertionError(f"the engine did not go idle: {engine.heartbeat()}")
        time.sleep(0.02)


def record_tokens(engine) -> list[dict]:
    """Wraps ``engine.submit``, the worker's way into the engine, so that
    each request's prompt ids and emitted token ids are kept (in submit
    order) beside what the worker's ``emit`` gets: the token values the
    server turned into text, for the checks the text cannot make (the byte
    tokenizer decodes every id past 258 to the same '?')."""
    got: list[dict] = []
    submit = engine.submit

    def recording(prompt_ids, sampling, emit, **kw):
        rec = {"prompt": list(prompt_ids), "toks": []}

        def tee(ev):
            if ev.token_id >= 0:
                rec["toks"].append(ev.token_id)
            emit(ev)

        rid = submit(prompt_ids, sampling, tee, **kw)
        got.append(rec)
        return rid

    engine.submit = recording
    return got


def recorded_for(label: str, recorded: list[dict], prompt_ids: list[int]) -> list[int]:
    """The token ids the engine emitted for the one request with this prompt."""
    hits = [r for r in recorded if r["prompt"] == prompt_ids]
    if len(hits) != 1:
        raise AssertionError(f"[{label}] {len(hits)} recorded requests with this prompt")
    return hits[0]["toks"]


def streamed_text(chunks: list[dict]) -> str:
    return "".join(c["delta"].get("content", "") for c in chunks)


def open_stream(port: int, body: dict, headers: dict | None = None) -> socket.socket:
    """An SSE ``/v1/completions`` on a raw socket (the caller reads and closes)."""
    raw = json.dumps({**body, "stream": True}).encode()
    head = "".join(f"{k}: {v}\r\n" for k, v in (headers or {}).items())
    sock = socket.create_connection(("127.0.0.1", port), timeout=120)
    sock.sendall(f"POST /v1/completions HTTP/1.1\r\nHost: smoke\r\nContent-Type: "
                 f"application/json\r\nContent-Length: {len(raw)}\r\n{head}\r\n".encode() + raw)
    return sock


def storm_prompts(seed: int = 5, lens: tuple[int, ...] = HTTP_STORM_LENS) -> list[str]:
    """One prompt of each length in ``lens`` tokens (bos + n - 1 letters),
    drawn from ``seed``: by default the http storm's."""
    rng = np.random.default_rng(seed)
    return [letters(rng, n - 1) for n in lens]


def request_ids(tag: str, n: int) -> list[dict]:
    """``X-Request-Id: {tag}-{i}`` for request ``i`` of a storm."""
    return [{"X-Request-Id": f"{tag}-{i}"} for i in range(n)]


def socket_storm(port: int, model: str, prompts: list[str],
                 headers_each: list[dict] | None = None,
                 max_tokens: int = 32) -> tuple[list[dict], float]:
    """The prompts as SSE completions from 3 client threads, all in flight
    at once (thread ``k`` sends prompts k, k + 3, ... through
    :func:`sse_streams`), request ``i`` with the headers ``headers_each[i]``.
    Returns each stream's record in prompt order and the wall time."""
    recs: list = [None] * len(prompts)

    def client(idx):
        got = sse_streams(port, [{"model": model, "prompt": prompts[i],
                                  "max_tokens": max_tokens} for i in idx],
                          headers_each=[headers_each[i] for i in idx] if headers_each else None)
        for i, rec in zip(idx, got):
            recs[i] = rec

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(range(k, len(prompts), 3),))
               for k in range(3)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(600)
    return recs, time.perf_counter() - t0


def socket_numbers(recs: list[dict], served: int, wall: float) -> dict:
    """:func:`latency_numbers` of SSE records, each data frame stamped on arrival."""
    return latency_numbers([r["t0"] for r in recs],
                           [[t for t, _, d in r["frames"] if d != "[DONE]"] for r in recs],
                           served, wall)


def storm_gates(label: str, recs: list[dict], wall: float, prompts: list[str],
                ids: list[list[int]], tok, reference,
                max_tokens: int = 32) -> tuple[list[list[dict]], dict]:
    """The gates every SSE storm holds: each stream's SSE contract
    (:func:`sse_chunks`); its usage: the input tokens its prompt's, the
    output tokens its token ids ``ids[i]`` (the serving engine's record or
    the federated pool's ledger: the values its text cannot show), fewer
    than ``max_tokens`` only at a stop; its text the decode of those ids;
    every id through :func:`oracle` against ``reference`` (the serving
    engine or a :class:`DenseOracle`). Returns the chunks and the numbers at
    the socket, kept under ``label`` in ``STORM_NUMBERS``."""
    chunks = [sse_chunks(f"{label} {i}", rec) for i, rec in enumerate(recs)]
    requests = [(tok.encode(p), SamplingParams(max_tokens=max_tokens)) for p in prompts]
    for i, (c, got, (prompt, _)) in enumerate(zip(chunks, ids, requests)):
        u = c[-1]["usage"]
        if u["input_tokens"] != len(prompt) or u["output_tokens"] != len(got) or (
                u["output_tokens"] != max_tokens and c[-1]["finish_reason"] != "stop"):
            raise AssertionError(f"[{label}] request {i}: usage {u} against {len(prompt)} "
                                 f"prompt tokens and {len(got)} token ids, finish "
                                 f"{c[-1]['finish_reason']}")
        if streamed_text(c) != tok.decode(got):
            raise AssertionError(f"[{label}] request {i}: the streamed text is not the "
                                 f"decode of its {len(got)} token ids")
    # the oracle's power is printed, not required: the letters of these
    # prompts leave narrower top-1/top-2 gaps (p50 ~0.10 at llama-3-8b) than
    # the bare storms' random ids, which require it on the same weights
    oracle(label, reference, [{"toks": t} for t in ids], requests, None)
    numbers = socket_numbers(recs, sum(len(t) for t in ids), wall)
    STORM_NUMBERS[label] = numbers
    return chunks, numbers


def http_storm(card: str, port: int, engine, bare, recorded: list[dict],
               label: str = "http storm", lens: tuple[int, ...] = HTTP_STORM_LENS,
               max_tokens: int = 32, seed: int = 5) -> dict[str, int]:
    """8 SSE completions from 3 client threads, all in flight at once as in
    the bare storm, prompts of ``lens`` tokens (by default 16..1500, as the
    bare storm's), ``max_tokens`` each, with every kernel count set to 0
    just before and read just after; :func:`storm_gates` on each request's
    token ids (``recorded``, see :func:`record_tokens`), the ids the engine
    emitted over the storm, the paged kernels and graph replays, I1 and the
    sync gate; then, unless ``bare`` is None, the same prompts' token ids
    submitted to ``bare`` (a fresh engine with the same weights and config)
    from 3 threads, for the engine's side of the same work."""
    prompts = storm_prompts(seed, lens)
    tokens0 = engine.tokens_emitted
    pipe0 = engine.stats()["pipeline"]
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    with watch_syncs() as flagged:
        recs, wall = socket_storm(port, HTTP_MODEL, prompts,
                                  request_ids(label.replace(" ", "-"), len(prompts)),
                                  max_tokens)
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    wait_idle(engine)
    stats = engine.stats()
    tok = ByteTokenizer(engine.model_config.vocab_size)
    ids = [recorded_for(label, recorded, tok.encode(p)) for p in prompts]
    chunks, numbers = storm_gates(label, recs, wall, prompts, ids, tok, engine, max_tokens)
    served = numbers["tokens"]
    if served != engine.tokens_emitted - tokens0:
        raise AssertionError(f"[{label}] usage counts {served} output tokens, the engine "
                             f"emitted {engine.tokens_emitted - tokens0}")
    if launches["ragged_paged_attention"] <= 0 or launches["paged_decode_attention"] <= 0 \
            or launches["flash_self_attention"]:
        raise AssertionError(f"[{label}] launches {launches}: expected ragged and decode, "
                             "never flash")
    replays = stats["pipeline"]["decode_graph_replays"] - pipe0["decode_graph_replays"]
    eager = stats["pipeline"]["decode_eager_chunks"] - pipe0["decode_eager_chunks"]
    if replays <= 0 or eager:
        raise AssertionError(f"[{label}] decode chunks: {replays} graph replays, "
                             f"{eager} eager")
    check_pool(label, stats)
    if flagged:
        # the engine was built (and its graphs captured) on the worker's
        # executor thread: its rounds must still wait only at their drains
        raise AssertionError(f"[{label}] a round waited on the device outside its "
                             f"drain: {sorted(set(flagged))}")
    STORM_SPLITS[label] = round_split(pipe0, stats["pipeline"])
    log(f"serving [{label}]: 8 SSE streams, SSE contract held, finish "
        f"{[c[-1]['finish_reason'] for c in chunks]}, usage = engine tokens ({served}), "
        "each stream's text = decode of its engine token ids (oracle above), "
        f"launches {launches}, {replays} decode graph replays, no synchronising CUDA call "
        "flagged, pages conserved")
    log(f"info [{card}] serving [{label}] (client side, at the socket): "
        f"{format_latency(numbers)}")
    if bare is not None:
        # the engine's side of the same work: the prompts' ids on a fresh engine
        requests = [(tok.encode(p), SamplingParams(max_tokens=max_tokens)) for p in prompts]
        t1 = time.perf_counter()
        bare_recs = serve(bare, requests)
        bare_numbers = latency_numbers([r["t0"] for r in bare_recs],
                                       [r["ts"] for r in bare_recs],
                                       sum(len(r["toks"]) for r in bare_recs),
                                       time.perf_counter() - t1)
        log(f"info [{card}] serving [{label} prompts, bare engine] (the same prompts' ids "
            f"submitted to a fresh engine, same weights and config): "
            f"{format_latency(bare_numbers)}")
    return launches


def http_served_equals_bare(port: int, engine, bare, recorded: list[dict]) -> None:
    """One greedy request served alone over HTTP: the token ids the server's
    engine emitted for it (``recorded``) equal those ``bare`` (an engine
    with the same weights and config) gives for the same prompt alone, and
    the served text is their ``decode``. The prompt shares no full page
    with earlier ones of either engine, so both run the same rounds."""
    prompt = letters(np.random.default_rng(11), 299)
    status, _, body = http_json(port, "/v1/completions",
                                {"model": HTTP_MODEL, "prompt": prompt, "max_tokens": 32})
    if status != 200:
        raise AssertionError(f"[served = bare] status {status}: {body}")
    tok = ByteTokenizer(engine.model_config.vocab_size)
    rec = serve(bare, [(tok.encode(prompt), SamplingParams(max_tokens=32))], 1)[0]
    toks = [t for t in rec["toks"] if t >= 0]
    got = recorded_for("served = bare", recorded, tok.encode(prompt))
    if got != toks:
        raise AssertionError(f"[served = bare] the server's engine emitted {got} against the "
                             f"bare engine's {toks}")
    served = body["content"][0]["text"]
    if served != tok.decode(toks) or body["usage"]["output_tokens"] != len(toks):
        raise AssertionError(f"[served = bare] served {served!r} ({body['usage']}) against "
                             f"{tok.decode(toks)!r} ({len(toks)} tokens)")
    log(f"serving [served = bare]: one greedy request over HTTP: the server's engine emitted "
        f"the bare engine's {len(toks)} token ids, served as their text")


def http_disconnect(port: int, engine) -> int:
    """An SSE stream closed after 3 deltas: one ``client_disconnect``
    cancellation, within two rounds of the close; a later request is
    served, and the pool conserves its pages. Returns the rounds between."""
    before = engine.cancellations.get("client_disconnect", 0)
    sock = open_stream(port, {"model": HTTP_MODEL, "max_tokens": 1500,
                              "prompt": letters(np.random.default_rng(12), 99)})
    got = b""
    while got.count(b"data: ") < 3:
        got += sock.recv(65536)
    rounds_at_close = sum(engine.rounds.values())
    sock.close()
    deadline = time.monotonic() + 60
    while engine.cancellations.get("client_disconnect", 0) == before:
        if time.monotonic() > deadline:
            raise AssertionError("[disconnect] no client_disconnect cancellation")
        time.sleep(0.002)
    rounds = sum(engine.rounds.values()) - rounds_at_close
    wait_idle(engine)
    if engine.cancellations["client_disconnect"] != before + 1 or rounds > 2:
        raise AssertionError(f"[disconnect] cancellations {engine.cancellations}, "
                             f"{rounds} rounds after the close")
    status, _, body = http_json(port, "/v1/completions",
                                {"model": HTTP_MODEL, "prompt": "after", "max_tokens": 8})
    if status != 200 or body["usage"]["output_tokens"] != 8:
        raise AssertionError(f"[disconnect] the next request: {status} {body}")
    wait_idle(engine)
    check_pool("disconnect", engine.stats())
    log(f"serving [disconnect]: one client_disconnect cancellation {rounds} round(s) after "
        "the close; the next request served 8 tokens; pages conserved")
    return rounds


def http_deadlines(port: int, engine) -> None:
    """X-Request-Deadline-Ms garbage → 400; a lapse while queued behind 8
    busy slots → 408; a lapse mid-stream ends the stream with
    ``deadline_exceeded``; a burst on the one-slot ``max_pending: 1`` model
    → 429 with Retry-After."""
    body = {"model": HTTP_MODEL, "prompt": "deadline", "max_tokens": 8}
    status, _, prob = http_json(port, "/v1/completions", body,
                                {"X-Request-Deadline-Ms": "soon"})
    if (status, prob.get("code")) != (400, "bad_request"):
        raise AssertionError(f"[deadlines] garbage header: {status} {prob}")
    rng = np.random.default_rng(13)
    fillers = [open_stream(port, {"model": HTTP_MODEL, "max_tokens": 1500,
                                  "prompt": letters(rng, 49)}) for _ in range(8)]
    try:
        deadline = time.monotonic() + 120
        while engine.active_slots < 8:
            if time.monotonic() > deadline:
                raise AssertionError(f"[deadlines] slots never filled: {engine.heartbeat()}")
            time.sleep(0.01)
        status, _, prob = http_json(port, "/v1/completions", body,
                                    {"X-Request-Deadline-Ms": "250"})
        if (status, prob.get("code")) != (408, "request_timeout"):
            raise AssertionError(f"[deadlines] queued lapse: {status} {prob}")
    finally:
        for sock in fillers:
            sock.close()
    wait_idle(engine)
    rec = sse_streams(port, [{"model": HTTP_MODEL, "max_tokens": 1500,
                              "prompt": letters(rng, 39)}], {"X-Request-Deadline-Ms": "1500"})[0]
    chunks = sse_chunks("deadline mid-stream", rec)
    final = chunks[-1]
    if final.get("finish_reason") != "deadline_exceeded" or not (
            0 < final["usage"]["output_tokens"] < 1500):
        raise AssertionError(f"[deadlines] mid-stream lapse: {final}")
    wait_idle(engine)
    http_json(port, "/v1/completions", {"model": HTTP_ONE_SLOT, "prompt": "warm",
                                        "max_tokens": 2})  # builds the engine
    with ThreadPoolExecutor(6) as pool:
        burst = list(pool.map(lambda _: http_json(
            port, "/v1/completions", {"model": HTTP_ONE_SLOT, "prompt": "burst",
                                      "max_tokens": 1000}), range(6)))
    statuses = sorted(b[0] for b in burst)
    refused = [b for b in burst if b[0] == 429]
    if 200 not in statuses or not refused or any(
            b[2].get("code") != "scheduler_saturated" or int(b[1]["retry-after"]) < 1
            for b in refused):
        raise AssertionError(f"[deadlines] max_pending burst: {burst}")
    check_pool("deadlines", engine.stats())
    log(f"serving [deadlines]: garbage header 400, queued lapse 408, mid-stream lapse "
        f"deadline_exceeded after {final['usage']['output_tokens']} tokens; max_pending 1 "
        f"burst statuses {statuses}, Retry-After {[b[1]['retry-after'] for b in refused]}")


def http_spec_chat(port: int, srv) -> None:
    """One chat completion on the tiny-llama quickstart with
    ``scheduler_spec_k`` 4, over HTTP: 200, the usage its engine emitted,
    the engine at k=4, pages conserved; the speculation it did is printed."""
    body = {"model": HTTP_TINY_SPEC, "max_tokens": 256, "temperature": 0.0, "messages": [
        {"role": "user", "content": [{"type": "text", "text": "repeat after me: " * 12}]}]}
    status, _, resp = http_json(port, "/v1/chat/completions", body)
    engine = srv.host.worker.engine(HTTP_TINY_SPEC)
    wait_idle(engine)
    stats = engine.stats()
    spec = stats["speculative"]
    if status != 200 or resp["usage"]["output_tokens"] != stats["tokens_emitted"] \
            or spec["k"] != SPEC_K:
        raise AssertionError(f"[http spec chat] {status} {resp} {spec}")
    check_pool("http spec chat", stats)
    log(f"serving [http spec chat]: tiny-llama quickstart, scheduler_spec_k {SPEC_K}, one "
        f"chat completion over HTTP, {resp['usage']['output_tokens']} tokens "
        f"({resp['finish_reason']}); {spec['rounds']} speculative rounds, "
        f"{spec['proposed']} drafts proposed, {spec['accepted']} accepted; pages conserved")


EMBED_TOL_COS = 0.999


def embeddings_phase(card: str, port: int, srv) -> None:
    """``/v1/embeddings`` on bge-base-en (random bf16 weights from a seeded
    generator, the byte tokenizer): a first request builds the encoder, then
    6 requests of 8 inputs of 16..127 letters (17..128 tokens). Each vector
    has unit norm and lies within cosine EMBED_TOL_COS of an f32 forward of
    the same weights on the card (TF32 off); usage counts the tokenizer's
    tokens. Prints ms per request and vectors/s at the socket and for the
    bare ``embed_pooled`` of one batch (CUDA events)."""
    from cyberfabric_core_tpu_torch.models import bert

    rng = np.random.default_rng(23)
    t = time.perf_counter()
    status, _, body = http_json(port, "/v1/embeddings", {"model": EMBED_MODEL, "input": "warm"})
    if status != 200:
        raise AssertionError(f"[embeddings] first request: {status} {body}")
    build_s = time.perf_counter() - t
    entry = srv.host.worker._embed_entries[f"embed::{EMBED_MODEL}"]
    cfg, tok, params = entry.cfg, entry.tokenizer, entry.params
    f32 = bert.from_state_dict(params.state_dict(), cfg, params.device, torch.float32)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    worst, ms, batch = 1.0, [], None
    try:
        for _ in range(6):
            inputs = [letters(rng, int(n)) for n in rng.integers(16, 128, 8)]
            t = time.perf_counter()
            status, _, body = http_json(port, "/v1/embeddings",
                                        {"model": EMBED_MODEL, "input": inputs})
            ms.append((time.perf_counter() - t) * 1e3)
            ids = [tok.encode(x)[:128] for x in inputs]
            if status != 200 or len(body["data"]) != 8 or body["usage"] != {
                    "input_tokens": sum(map(len, ids)), "output_tokens": 0}:
                raise AssertionError(f"[embeddings] {status} usage {body.get('usage')}")
            got = torch.tensor([d["embedding"] for d in body["data"]], dtype=torch.float64)
            norms = torch.linalg.norm(got, dim=1)
            if (norms - 1).abs().max() > 1e-5:
                raise AssertionError(f"[embeddings] norms {norms.tolist()}")
            batch = (torch.zeros((8, 128), dtype=torch.int32),
                     torch.zeros((8, 128), dtype=torch.int32))
            for j, row in enumerate(ids):
                batch[0][j, :len(row)] = torch.tensor(row)
                batch[1][j, :len(row)] = 1
            batch = tuple(b.to(params.device) for b in batch)
            with torch.inference_mode():
                ref = bert.embed_pooled(f32, cfg, *batch).double().cpu()
            cos = (got * ref).sum(1) / torch.linalg.norm(ref, dim=1)
            worst = min(worst, float(cos.min()))
            if cos.min() < EMBED_TOL_COS:
                raise AssertionError(f"[embeddings] cosine to the f32 forward {cos.tolist()}")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    with torch.inference_mode():
        bare = cuda_ms(lambda: bert.embed_pooled(params, cfg, *batch), 20)
    del f32
    ms.sort()
    log(f"serving [embeddings]: {EMBED_MODEL} built on first request in {build_s:.1f} s; "
        f"6 requests of 8 inputs (17..128 tokens): unit norm, usage = tokenizer count, "
        f"cosine to the f32 forward of the same weights >= {worst:.6f} (least allowed "
        f"{EMBED_TOL_COS})")
    log(f"info [{card}] serving [embeddings] at the socket: ms per request p50 "
        f"{ms[len(ms) // 2]:.2f} max {ms[-1]:.2f}, {8e3 / ms[len(ms) // 2]:.1f} vectors/s; "
        f"bare embed_pooled [8, 128] bf16: {bare:.3f} ms, {8e3 / bare:.1f} vectors/s "
        "(CUDA events)")


def http_phase(card: str) -> dict[str, int]:
    """The port's server, built in this process as ``server.main`` builds it,
    serving llama-3-8b over HTTP (see :func:`http_config`); ``card`` labels
    its numbers (the ``nvidia-smi`` name and power limit). Returns the
    storm's kernel launches."""
    srv = BackgroundServer(http_config()).start()
    try:
        t = time.perf_counter()
        status, _, body = http_json(srv.port, "/v1/completions",
                                    {"model": HTTP_MODEL, "prompt": "warm", "max_tokens": 2})
        if status != 200:
            raise AssertionError(f"[http] first request: {status} {body}")
        engine = srv.host.worker.engine(HTTP_MODEL)
        log(f"serving [http]: {HTTP_MODEL} engine built by the worker on first request "
            f"(weights, pool, decode graphs) and served in {time.perf_counter() - t:.1f} s; "
            f"{engine.stats()['mode']}, {engine.stats()['pages_total']} pages, depth "
            f"{engine.stats()['pipeline']['depth']}, graphs "
            f"{engine.stats()['pipeline']['decode_graphs']}")
        recorded = record_tokens(engine)
        bare = ContinuousBatchingEngine(engine.config, params=engine.params, seed=0)
        try:
            launches = http_storm(card, srv.port, engine, bare, recorded)
            http_served_equals_bare(srv.port, engine, bare, recorded)
            # decode-heavy: short prompts, every slot streaming 256 tokens, so
            # that the tier's per-frame cost is most of what it adds
            http_storm(card, srv.port, engine, bare, recorded, "http decode storm",
                       lens=(32,) * 8, max_tokens=256, seed=6)
        finally:
            bare.close()
        del bare
        for label in ("mixed", "mixed, depth 0"):
            if label in STORM_NUMBERS:
                log(f"info [{card}] serving [{label}] (bare engine, same call): "
                    f"{format_latency(STORM_NUMBERS[label])}")
        http_disconnect(srv.port, engine)
        http_deadlines(srv.port, engine)
        http_spec_chat(srv.port, srv)
        embeddings_phase(card, srv.port, srv)
    finally:
        srv.stop()
    del srv
    torch.cuda.empty_cache()
    return launches

# ------------------------------------------------------------ observability
class OtlpCollector:
    """An OTLP/HTTP JSON collector on loopback in this process: keeps every
    span posted to it."""

    def __init__(self) -> None:
        spans: list[dict] = []
        lock = threading.Lock()

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 — the handler protocol's name
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                with lock:
                    for rs in body["resourceSpans"]:
                        for ss in rs["scopeSpans"]:
                            spans.extend(ss["spans"])
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.spans, self.lock = spans, lock
        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    @property
    def endpoint(self) -> str:
        return f"http://127.0.0.1:{self.server.server_port}"

    def by_trace(self, trace_id: str) -> list[dict]:
        with self.lock:
            return [s for s in self.spans if s["traceId"] == trace_id]

    def close(self) -> None:
        self.server.shutdown()
        self.server.server_close()


def http_call(port: int, method: str, path: str, body: dict | None = None,
              timeout: float = 120.0) -> tuple[int, dict, object]:
    """One request; the body parsed as JSON, else text."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body),
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        data = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    try:
        return resp.status, hdrs, json.loads(data)
    except ValueError:
        return resp.status, hdrs, data.decode()


def parse_metrics(text: str) -> dict[str, dict[str, float]]:
    """Prometheus text → {sample name: {label set: value}}."""
    out: dict[str, dict[str, float]] = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, value = line.rpartition(" ")
        name, brace, labels = key.partition("{")
        out.setdefault(name, {})[brace + labels] = float(value)
    return out


class Scraper(threading.Thread):
    """GET /metrics every ``period`` s until stopped; every answer must be 200."""

    def __init__(self, port: int, period: float = 0.1) -> None:
        super().__init__(daemon=True)
        self.port, self.period = port, period
        self.halt = threading.Event()
        self.count, self.failures, self.last = 0, [], ""

    def run(self) -> None:
        while not self.halt.is_set():
            try:
                status, _, text = http_call(self.port, "GET", "/metrics")
                if status == 200:
                    self.count, self.last = self.count + 1, text
                else:
                    self.failures.append(status)
            except Exception as e:  # noqa: BLE001 — a failed scrape fails the phase
                self.failures.append(repr(e))
            self.halt.wait(self.period)


def observability_config(home: Path, otlp_endpoint: str) -> dict:
    """The port's quickstart with llama-3-8b beside its models (the http
    storm's entry), fault injection allowed and every request traced to
    ``otlp_endpoint``; device traces under ``home``."""
    cfg = json.loads(server.QUICKSTART.read_text())
    cfg["server"] = {"home_dir": str(home)}
    cfg["tracing"] = {"enabled": True, "sample_ratio": 1.0, "otlp_endpoint": otlp_endpoint,
                      "service_name": "chip-smoke"}
    cfg["modules"]["api_gateway"]["config"]["bind_addr"] = "127.0.0.1:0"
    llama_entry = next(m for m in http_config()["modules"]["model_registry"]["config"]["models"]
                       if m["provider_model_id"] == "llama-3-8b")
    cfg["modules"]["model_registry"]["config"]["models"].append(llama_entry)
    cfg["modules"]["monitoring"] = {"config": {"allow_fault_injection": True}}
    return cfg


def traced_prompts(seed: int, tag: str) -> tuple[list[str], list[str], list[dict]]:
    """The http storm's prompt lengths drawn from ``seed``, each with its own
    ``x-request-id`` and sampled ``traceparent`` (and the trace ids)."""
    prompts = storm_prompts(seed)
    traces = [os.urandom(16).hex() for _ in prompts]
    headers = [{"x-request-id": f"{tag}-{i}", "traceparent": f"00-{t}-{os.urandom(8).hex()}-01"}
               for i, t in enumerate(traces)]
    return prompts, traces, headers


TIMELINE = re.compile(r"^enqueued admitted( prefill_chunk)+ prefill( decode_chunk)+ finished$")


def ttft_count(text: str, model: str) -> float:
    return parse_metrics(text).get("llm_ttft_seconds_count", {}).get(
        f'{{model="{model}"}}', 0.0)


def observability_storm(smi: str, port: int, srv, engine, collector: OtlpCollector,
                        recorded: list[dict]) -> None:
    """The http storm's 8 SSE completions (prompts of 16..1500 tokens, 32
    out, 3 client threads) on the traced and monitored host, each with its
    own ``x-request-id`` and sampled ``traceparent``, while a side thread
    scrapes ``/metrics`` every 100 ms, all under the sync gate. Gates: each
    stream's flight record reads enqueued → admitted → prefill_chunk+ →
    prefill → decode_chunk+ → finished, its chunks' tokens sum to the
    uncached prompt, its derived ttft is at most the client's; its
    ``llm.prefill_chunk`` and ``llm.decode_chunk`` spans reached the
    collector under its trace id; the device gauges; ttft counted once a
    stream; the http storm's gates (SSE contract, usage, the oracle, the
    paged kernels and graph replays, I1)."""
    label = "observability storm"
    prompts, traces, headers = traced_prompts(5, "obs")  # the http storm's prompts
    before = ttft_count(http_call(port, "GET", "/metrics")[2], HTTP_MODEL)
    tokens0 = engine.tokens_emitted
    pipe0 = engine.stats()["pipeline"]
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    scraper = Scraper(port)
    with watch_syncs() as flagged:
        scraper.start()
        recs, wall = socket_storm(port, HTTP_MODEL, prompts, headers)
        wait_idle(engine)
        scraper.halt.set()
        scraper.join(30)
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    stats = engine.stats()
    if scraper.failures or not scraper.count:
        raise AssertionError(f"[{label}] /metrics scrapes: {scraper.count} answered, failures "
                             f"{scraper.failures[:5]}")
    tok = ByteTokenizer(engine.model_config.vocab_size)
    ids = [recorded_for(label, recorded, tok.encode(p)) for p in prompts]
    _, numbers = storm_gates(label, recs, wall, prompts, ids, tok, engine)
    if numbers["tokens"] != engine.tokens_emitted - tokens0:
        raise AssertionError(f"[{label}] usage counts {numbers['tokens']} output tokens, the "
                             f"engine emitted {engine.tokens_emitted - tokens0}")
    if launches["ragged_paged_attention"] <= 0 or launches["paged_decode_attention"] <= 0 \
            or launches["flash_self_attention"]:
        raise AssertionError(f"[{label}] launches {launches}: expected ragged and decode, "
                             "never flash")
    replays = stats["pipeline"]["decode_graph_replays"] - pipe0["decode_graph_replays"]
    if replays <= 0 or stats["pipeline"]["decode_eager_chunks"] != pipe0["decode_eager_chunks"]:
        raise AssertionError(f"[{label}] decode chunks: {replays} graph replays")
    check_pool(label, stats)
    if flagged:
        raise AssertionError(f"[{label}] a synchronising CUDA call was flagged over the "
                             f"storm and the scrapes: {sorted(set(flagged))}")
    # each stream's flight record and spans
    srv.host.tracer.exporter.flush(timeout_s=10.0)
    span_counts = []
    for i, (rec, hdr) in enumerate(zip(recs, headers)):
        status, _, doc = http_call(port, "GET", f"/v1/monitoring/requests/{hdr['x-request-id']}")
        if status != 200:
            raise AssertionError(f"[{label}] request {i}: timeline {status} {doc}")
        events = doc["timeline"]
        kinds = " ".join(e["event"] for e in events)
        if not TIMELINE.match(kinds):
            raise AssertionError(f"[{label}] request {i}: timeline {kinds}")
        prefill = next(e for e in events if e["event"] == "prefill")
        chunked = sum(e["tokens"] for e in events if e["event"] == "prefill_chunk")
        if chunked != HTTP_STORM_LENS[i] - prefill["cached_len"] or \
                doc["prompt_tokens"] != HTTP_STORM_LENS[i]:
            raise AssertionError(f"[{label}] request {i}: {chunked} tokens in prefill chunks "
                                 f"for a {doc['prompt_tokens']}-token prompt, "
                                 f"{prefill['cached_len']} cached")
        client_ttft = (rec["frames"][0][0] - rec["t0"]) * 1e3
        if doc["derived"]["ttft_ms"] is None or doc["derived"]["ttft_ms"] > client_ttft:
            raise AssertionError(f"[{label}] request {i}: derived ttft "
                                 f"{doc['derived']['ttft_ms']} ms past the client's "
                                 f"{client_ttft:.1f} ms")
        if doc["trace_id"] != traces[i]:
            raise AssertionError(f"[{label}] request {i}: recorded trace {doc['trace_id']}")
        names = {}
        for sp in collector.by_trace(traces[i]):
            names[sp["name"]] = names.get(sp["name"], 0) + 1
        if not names.get("llm.prefill_chunk") or not names.get("llm.decode_chunk") \
                or names.get("llm.prefill") != 1:
            raise AssertionError(f"[{label}] request {i}: spans under its trace id {names}")
        span_counts.append(names)
    # the device gauges, and ttft once a stream
    text = http_call(port, "GET", "/metrics")[2]
    gauges = parse_metrics(text)
    in_use = gauges["tpu_hbm_bytes_in_use"][""]
    util = gauges["llm_hbm_utilization_per_device"][""]
    params_bytes = sum(t.numel() * t.element_size() for t in engine.params.state_dict().values())
    total = torch.cuda.get_device_properties(engine.device).total_memory
    counted = ttft_count(text, HTTP_MODEL) - before
    if gauges["tpu_devices"][""] != torch.cuda.device_count() or \
            not params_bytes <= in_use <= total or not 0 < util <= 1 or counted != len(prompts):
        raise AssertionError(f"[{label}] gauges: tpu_devices {gauges['tpu_devices']}, "
                             f"tpu_hbm_bytes_in_use {in_use} (params {params_bytes}, card "
                             f"{total}), utilization {util}, ttft counted {counted}")
    log(f"serving [{label}]: 8 SSE streams traced (sample_ratio 1.0, OTLP to a loopback "
        f"collector) with /metrics scraped {scraper.count} times every 100 ms: every timeline "
        f"enqueued → admitted → prefill_chunk+ → prefill → decode_chunk+ → finished, chunk "
        f"tokens = uncached prompt, derived ttft ≤ the client's; spans per stream "
        f"{span_counts}; launches {launches}, {replays} decode graph replays, no synchronising "
        f"CUDA call flagged, the oracle, pages conserved")
    log(f"info [{smi}] serving [{label}] gauges: tpu_devices {gauges['tpu_devices']['']:.0f}, "
        f"tpu_hbm_bytes_in_use {in_use:.0f} (params {params_bytes}, card {total}), "
        f"llm_hbm_utilization_per_device {util:.4f}, llm_ttft_seconds_count +{counted:.0f}, "
        f"llm_lookahead_depth {gauges['llm_lookahead_depth']['']:.3f}, "
        f"llm_decode_overlap_ratio {gauges['llm_decode_overlap_ratio']['']:.3f}")
    log(f"info [{smi}] serving [{label}] (client side, at the socket): "
        f"{format_latency(numbers)}")
    plain = STORM_NUMBERS.get("http storm")
    if plain is not None:
        log(f"info [{smi}] serving [http storm] (untraced host, same call): "
            f"{format_latency(plain)}; traced / untraced tokens/s "
            f"{numbers['tokens_per_s'] / plain['tokens_per_s']:.4f}")


def short_kernel_name(name: str) -> str:
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("(")[0][:90]


def kernel_family(name: str) -> str:
    """A device op's family: the GEMMs (cuBLAS's ``nvjet`` / CUTLASS), the
    port's paged kernels, PyTorch's elementwise and copy kernels, the rest."""
    if name.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in name.lower():
        return "gemm"
    if any(k in name for k in ("split_kernel", "combine_kernel", "chunk_kernel")):
        return "paged attention"
    if "elementwise" in name or "copy" in name.lower():
        return "elementwise and copies"
    return "other"


def profiler_window(smi: str, port: int, engine) -> None:
    """``POST /v1/monitoring/profiler/start``, two SSE completions (300 and
    700 tokens, 32 out), ``POST .../stop``: the files listed hold a chrome
    trace that names the ragged kernel (``chunk_kernel``: one a ragged
    launch) and the decode kernel (``combine_kernel`` closes every decode
    and every ragged launch); their counts beside the wrappers' launches
    over the same window, and the window's ten device ops by time."""
    label = "profiler"
    wait_idle(engine)
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    decode0 = engine.rounds["decode"]
    status, _, doc = http_call(port, "POST", "/v1/monitoring/profiler/start")
    if status != 200 or doc.get("status") != "started":
        raise AssertionError(f"[{label}] start: {status} {doc}")
    rng = np.random.default_rng(9)
    recs = sse_streams(port, [{"model": HTTP_MODEL, "prompt": letters(rng, n - 1),
                               "max_tokens": 32} for n in (300, 700)])
    for i, rec in enumerate(recs):
        sse_chunks(f"{label} {i}", rec)
    wait_idle(engine)
    status, _, doc = http_call(port, "POST", "/v1/monitoring/profiler/stop", timeout=300)
    if status != 200 or doc.get("status") != "stopped" or not doc.get("files"):
        raise AssertionError(f"[{label}] stop: {status} {doc}")
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    decode_steps = (engine.rounds["decode"] - decode0) * engine.config.decode_chunk
    path = Path(doc["dir"]) / doc["files"][0]
    events = json.loads(path.read_text())["traceEvents"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    names = [e["name"] for e in device if e.get("cat") == "kernel"]
    chunk = sum("chunk_kernel" in n for n in names)
    combine = sum("combine_kernel" in n for n in names)
    in_trace = {"ragged_paged_attention": chunk, "paged_decode_attention": combine - chunk}
    if in_trace["ragged_paged_attention"] <= 0 or in_trace["paged_decode_attention"] <= 0:
        raise AssertionError(f"[{label}] the trace ({path.stat().st_size} bytes, "
                             f"{len(device)} device ops) names ragged {chunk} / decode "
                             f"{combine - chunk} times")
    by_name: dict[str, list[float]] = {}
    # after the window's last prompt chunk only decode chunks run: their
    # kernels, over the steps they ran (one combine a layer a step)
    last_chunk = max(float(e["ts"]) for e in device if "chunk_kernel" in e["name"])
    tail_ms: dict[str, float] = {}
    tail_steps = 0
    for e in device:
        name, ms = short_kernel_name(e["name"]), float(e.get("dur", 0.0)) / 1e3
        row = by_name.setdefault(name, [0, 0.0])
        row[0] += 1
        row[1] += ms
        if float(e["ts"]) > last_chunk:
            tail_ms[kernel_family(name)] = tail_ms.get(kernel_family(name), 0.0) + ms
            tail_steps += "combine_kernel" in name
    tail_steps //= engine.model_config.num_layers
    total_ms = sum(ms for _, ms in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    families: dict[str, float] = {}
    for name, (_, ms) in by_name.items():
        families[kernel_family(name)] = families.get(kernel_family(name), 0.0) + ms
    log(f"serving [{label}]: the device trace {doc['files']} ({path.stat().st_size} bytes) "
        f"names the paged kernels: in the trace {in_trace}, the wrappers' launches over the "
        f"same window {launches}")
    if any(in_trace[name] != launches[name] for name in in_trace):
        # the profiler dropped kernel records: its times are not a decode step's
        log(f"info [{smi}] {label}: the trace lost kernel records (counts above); its device "
            "times are printed but not split by decode step")
        tail_steps = 0
    log(f"info [{smi}] {label} window: {len(device)} device ops, {total_ms:.3f} ms of device "
        f"time, {decode_steps} decode steps committed; by family "
        + ", ".join(f"{f} {ms:.3f} ms" for f, ms in sorted(families.items(), key=lambda kv: -kv[1]))
        + "; top ten by device time: "
        + "; ".join(f"{n} x{c} {ms:.3f} ms" for n, (c, ms) in top))
    if tail_steps:
        log(f"info [{smi}] {label} decode step by kernel family (the {tail_steps} steps "
            "after the last prompt chunk, ring chunks a discard dropped included): "
            + ", ".join(f"{f} {ms / tail_steps:.3f} ms" for f, ms in
                        sorted(tail_ms.items(), key=lambda kv: -kv[1]))
            + f"; {sum(tail_ms.values()) / tail_steps:.3f} ms a step")


SHED_DOCTOR = {"eval_interval_s": 0.1, "fast_window_s": 3.0, "slow_window_s": 5.0,
               "min_samples": 2, "shed_after": 1, "recover_after": 2,
               "objectives": {"itl_p99": {"threshold_ms": 20.0}}}


def wait_for(cond, timeout: float, what: str, label: str = "shedding") -> None:
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"[{label}] timed out waiting for {what}")
        time.sleep(0.05)


def shedding_cycle(smi: str) -> None:
    """The doctor's cycle on the quickstart's tiny-llama on the card, with
    short windows: ``/readyz`` 200; ``scheduler.readback`` armed over REST
    as a 0.5 s delay at every drain while three streams run (two short, one
    long); the short ones finish slowly, the itl objective burns,
    ``/readyz`` turns 503 naming it, a new chat gets 429 ``llm.load_shed``
    with ``Retry-After`` while the long stream is still in flight; disarmed,
    every stream ends through the oracle, ``/readyz`` is 200 again and a
    chat is served."""
    label = "shedding"
    cfg = json.loads(server.QUICKSTART.read_text())
    cfg["server"] = {"home_dir": str(Path(__file__).resolve().parent / "build" / "chip_smoke"
                                     / "home-shed")}
    cfg["modules"]["api_gateway"]["config"]["bind_addr"] = "127.0.0.1:0"
    cfg["modules"]["monitoring"] = {"config": {"allow_fault_injection": True,
                                               "doctor": SHED_DOCTOR}}
    srv = BackgroundServer(cfg).start()
    port = srv.port
    t0 = time.perf_counter()
    try:
        status, _, body = http_json(port, "/v1/completions",
                                    {"model": "default-chat", "prompt": "warm", "max_tokens": 2})
        if status != 200:
            raise AssertionError(f"[{label}] first request: {status} {body}")
        engine = srv.host.worker.engine("local::tiny-llama")
        recorded = record_tokens(engine)
        if http_call(port, "GET", "/readyz")[0] != 200:
            raise AssertionError(f"[{label}] /readyz before the fault")
        status, _, body = http_call(port, "PUT", "/v1/monitoring/failpoints/scheduler.readback",
                                    {"spec": "delay(0.5)"})
        if status != 200:
            raise AssertionError(f"[{label}] arming: {status} {body}")
        rng = np.random.default_rng(13)
        prompts = [letters(rng, n) for n in (40, 64, 100)]
        outs = [(p, m) for p, m in zip(prompts, (24, 24, 160))]
        recs: list = []
        streams = threading.Thread(target=lambda: recs.extend(sse_streams(
            port, [{"model": "default-chat", "prompt": p, "max_tokens": m} for p, m in outs])))
        streams.start()
        wait_for(lambda: http_call(port, "GET", "/readyz")[0] == 503, 30, "/readyz 503")
        status, _, ready = http_call(port, "GET", "/readyz")
        status, hdrs, shed = http_json(port, "/v1/chat/completions", {
            "model": "default-chat", "max_tokens": 8,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "shed?"}]}]})
        t_shed = time.perf_counter()
        if ready.get("code") != "not_ready" or "slo:itl_p99" not in ready.get("reasons", ()):
            raise AssertionError(f"[{label}] /readyz while shedding: {ready}")
        if status != 429 or shed.get("code") != "load_shed" or int(hdrs["retry-after"]) < 1:
            raise AssertionError(f"[{label}] a chat while shedding: {status} {hdrs} {shed}")
        status, _, body = http_call(port, "DELETE",
                                    "/v1/monitoring/failpoints/scheduler.readback")
        if status != 200 or not body.get("disarmed"):
            raise AssertionError(f"[{label}] disarming: {status} {body}")
        streams.join(120)
        tok = ByteTokenizer(engine.model_config.vocab_size)
        for i, rec in enumerate(recs):
            sse_chunks(f"{label} {i}", rec)
        if recs[2]["frames"][-1][0] <= t_shed:
            raise AssertionError(f"[{label}] the long stream ended before the shed chat")
        requests = [(tok.encode(p), SamplingParams(max_tokens=m)) for p, m in outs]
        oracle(label, engine, [{"toks": recorded_for(label, recorded, r[0])} for r in requests],
               requests, None)
        wait_for(lambda: http_call(port, "GET", "/readyz")[0] == 200, 30, "/readyz 200")
        status, _, body = http_json(port, "/v1/chat/completions", {
            "model": "default-chat", "max_tokens": 8,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "back?"}]}]})
        if status != 200:
            raise AssertionError(f"[{label}] a chat after recovery: {status} {body}")
        slo = http_call(port, "GET", "/v1/monitoring/slo")[2]
    finally:
        failpoints.reset()
        srv.stop()
    log(f"serving [{label}]: /readyz 200 → scheduler.readback armed as delay(0.5) over REST → "
        f"/readyz 503 {ready['reasons']} and a new chat 429 load_shed (Retry-After "
        f"{hdrs['retry-after']}) while a stream was in flight → disarmed: every stream ended "
        f"through the oracle, /readyz 200, a chat served; states "
        f"{[h['to'] for h in slo['state_history']]} in {time.perf_counter() - t0:.1f} s")


def observability_phase(smi: str) -> None:
    """The observability storm and the profiler window on a host booted from
    the port's quickstart serving llama-3-8b with monitoring and tracing
    on, then the shedding cycle on tiny-llama."""
    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    collector = OtlpCollector()
    srv = BackgroundServer(observability_config(root / "home-obs", collector.endpoint)).start()
    try:
        status, _, body = http_json(srv.port, "/v1/completions",
                                    {"model": HTTP_MODEL, "prompt": "warm", "max_tokens": 2})
        if status != 200:
            raise AssertionError(f"[observability] first request: {status} {body}")
        engine = srv.host.worker.engine(HTTP_MODEL)
        recorded = record_tokens(engine)
        observability_storm(smi, srv.port, srv, engine, collector, recorded)
        profiler_window(smi, srv.port, engine)
    finally:
        srv.stop()
        collector.close()
    del srv
    torch.cuda.empty_cache()
    shedding_cycle(smi)


def record_lockstep_ids(engine) -> list[dict]:
    """Wraps ``engine.generate_stream`` (the lockstep batcher's way into the
    engine) so that each request's prompt ids and emitted token ids are
    kept, as :func:`record_tokens` does at a continuous engine's submit."""
    got: list[dict] = []
    stream = engine.generate_stream

    def recording(prompts, sampling):
        recs = [{"prompt": list(p), "toks": []} for p in prompts]
        got.extend(recs)
        for ev in stream(prompts, sampling):
            if ev.token_id >= 0:
                recs[ev.request_index]["toks"].append(ev.token_id)
            yield ev

    engine.generate_stream = recording
    return got


def http_lockstep_phase(card: str) -> int:
    """The port's server with the worker at ``scheduler: lockstep`` serving
    llama-3-8b (the quickstart's options, random bf16 weights from seed 0):
    the HTTP storm's 8 SSE ``/v1/completions`` (16..1500 tokens, 32 out)
    from 3 client threads, batched by the worker's 4 ms window, kernel
    counts set to 0 just before and read just after. Gates: the SSE
    contract, each stream's usage equal to the token ids recorded at the
    engine and its text their decode, those ids through the dense oracle,
    flash launched and the paged kernels not. Printed: ttft, inter-token
    latency and tokens/s at the socket beside the continuous HTTP storm's.
    Returns the flash launches."""
    label = "http lockstep storm"
    cfg = http_config()
    llama_entry = cfg["modules"]["model_registry"]["config"]["models"][0]
    cfg["modules"]["model_registry"]["config"]["models"] = [llama_entry]
    cfg["modules"]["llm_gateway"]["config"]["worker"] = {"scheduler": "lockstep"}
    srv = BackgroundServer(cfg).start()
    try:
        t = time.perf_counter()
        status, _, body = http_json(srv.port, "/v1/completions",
                                    {"model": HTTP_MODEL, "prompt": "warm", "max_tokens": 2})
        if status != 200:
            raise AssertionError(f"[{label}] first request: {status} {body}")
        engine = srv.host.worker.engine(HTTP_MODEL)
        if not isinstance(engine, InferenceEngine) or not engine.use_flash:
            raise AssertionError(f"[{label}] the worker built {engine!r}")
        log(f"serving [{label}]: {HTTP_MODEL} lockstep engine built by the worker on first "
            f"request and served in {time.perf_counter() - t:.1f} s")
        recorded = record_lockstep_ids(engine)
        prompts = storm_prompts()
        for _, _, wrapper in KERNELS.values():
            wrapper.launches = 0
        recs, wall = socket_storm(srv.port, HTTP_MODEL, prompts)
        launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
        tok = ByteTokenizer(engine.model_config.vocab_size)
        ids = [recorded_for(label, recorded, tok.encode(p)) for p in prompts]
        chunks, numbers = storm_gates(label, recs, wall, prompts, ids, tok, engine)
        if launches["flash_self_attention"] <= 0 or launches["ragged_paged_attention"] \
                or launches["paged_decode_attention"]:
            raise AssertionError(f"[{label}] launches {launches}: want flash, no paged kernel")
        log(f"serving [{label}]: 8 SSE streams, SSE contract held, finish "
            f"{[c[-1]['finish_reason'] for c in chunks]}, usage = engine tokens, each "
            f"stream's text = decode of its engine token ids (oracle above), launches "
            f"{launches} ({launches['flash_self_attention'] // engine.model_config.num_layers} "
            f"prefill batches for {len(recorded)} requests)")
        log(f"info [{card}] serving [{label}] (client side, at the socket): "
            f"{format_latency(numbers)}; the continuous http storm, same call: "
            f"{format_latency(STORM_NUMBERS['http storm'])}")
    finally:
        srv.stop()
    del srv
    free_card()
    return launches["flash_self_attention"]


def boot_phase() -> None:
    """``python3 -m cyberfabric_core_tpu_torch.server run --config`` on the
    port's quickstart config at port 0, as a child process: /health within
    a bounded time, one SSE chat completion ending in ``data: [DONE]``,
    exit code 0 on SIGTERM."""
    cfg = json.loads(server.QUICKSTART.read_text())
    cfg["modules"]["api_gateway"]["config"]["bind_addr"] = "127.0.0.1:0"
    root = Path(__file__).resolve().parent
    path = root / "build" / "chip_smoke" / "quickstart-port0.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(cfg))
    t = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "cyberfabric_core_tpu_torch.server", "run",
                             "--config", str(path)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, cwd=root)
    lines: list[str] = []
    reader = threading.Thread(target=lambda: lines.extend(iter(proc.stdout.readline, "")),
                              daemon=True)
    reader.start()
    try:
        port = None
        deadline = time.monotonic() + 120
        while port is None:
            found = [ln for ln in list(lines) if ln.startswith("listening on http://")]
            if found:
                port = int(found[0].strip().rsplit(":", 1)[1])
            elif proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError("[boot] the server did not start: " + "".join(lines[-20:]))
            else:
                time.sleep(0.05)
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/health")
        health = conn.getresponse()
        if health.status != 200 or json.loads(health.read())["status"] != "ok":
            raise AssertionError(f"[boot] /health: {health.status}")
        conn.close()
        up = time.perf_counter() - t
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
        conn.request("POST", "/v1/chat/completions", body=json.dumps({
            "model": "default-chat", "max_tokens": 16, "stream": True,
            "messages": [{"role": "user", "content": [{"type": "text", "text": "hello"}]}]}),
            headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        text = resp.read().decode()
        conn.close()
        frames = [f for f in text.split("\n\n") if f.startswith("data: ")]
        if resp.status != 200 or not frames or frames[-1] != "data: [DONE]":
            raise AssertionError(f"[boot] chat stream: {resp.status} {text[-300:]}")
        status, _, emb = http_json(port, "/v1/embeddings",
                                   {"model": "default-embed", "input": ["hello", "world"]})
        norms = [math.hypot(*d["embedding"]) for d in emb.get("data", [])]
        if status != 200 or emb["model"] != "local::tiny-bert" or len(norms) != 2 \
                or max(abs(n - 1) for n in norms) > 1e-5:
            raise AssertionError(f"[boot] default-embed: {status} {emb}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(60)
        if rc != 0:
            raise AssertionError(f"[boot] exit code {rc} on SIGTERM: " + "".join(lines[-20:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        reader.join(10)
    log(f"serving [boot]: python3 -m cyberfabric_core_tpu_torch.server run --config "
        f"(quickstart, port 0) answered /health {up:.1f} s after start, streamed a chat "
        f"completion of {len(frames) - 1} chunks to data: [DONE], embedded 2 inputs with "
        f"default-embed (local::tiny-bert), exit 0 on SIGTERM "
        f"({time.perf_counter() - t:.1f} s in all)")


# ------------------------------------------------------------------ federation
#: the federation phase's worker hosts: each a ``python -m
#: cyberfabric_core_tpu_torch.modules.llm_gateway.worker`` process on the card
FED_HOSTS = ("fedhost-0", "fedhost-1")
FED_DEVICE = "cuda:0"
#: the f32 identity's model: llama-3-8b widths, 4 layers (two full-width f32
#: hosts would not fit the card), registered by ``--fed-f32-host`` processes
FED_F32_CONFIG = "llama-3-8b-4-layers"
FED_F32_MODEL = f"local::{FED_F32_CONFIG}-f32"
FED_KILL_TOKENS = 256
FED_F32_TOKENS = 96
#: the worker hosts' doctors: their objectives cannot trip on this phase's
#: prompts (its own faults are kills, not slow rounds)
FED_WORKER_OBS = {"allow_fault_injection": True, "doctor": {
    "objectives": {"itl_p99": {"threshold_ms": 600000.0},
                   "ttft_p95": {"threshold_ms": 600000.0},
                   "queue_wait_p95": {"threshold_ms": 600000.0},
                   "error_rate": {"budget": 1.0}},
    "stream_stall_s": 600.0, "round_stall_floor_s": 600.0, "queue_deadline_s": 600.0}}


def fed_entries() -> tuple[dict, dict]:
    """The registry entries of the federated gateway: llama-3-8b at the
    quickstart worker's options (bf16), and the f32 4-layer model."""
    entry = {"provider_slug": "local", "provider_model_id": HTTP_MODEL.split("::")[1],
             "approval_state": "approved", "managed": True, "architecture": "llama",
             "capabilities": {"chat": True, "streaming": True},
             "limits": {"max_input_tokens": 2000, "max_output_tokens": 2048},
             "engine_options": dict(QUICKSTART)}
    f32 = {**entry, "provider_model_id": FED_F32_MODEL.split("::")[1],
           "engine_options": dict(QUICKSTART, model_config=FED_F32_CONFIG, dtype="float32")}
    return entry, f32


def fed_config() -> dict:
    """The federated gateway: grpc_hub (short leases), llm_gateway with
    federation on and no engine of its own, monitoring with fault injection
    (the f32 hosts' pacing) and a doctor that the kills cannot make shed."""
    return {"modules": {
        "api_gateway": {"config": {"bind_addr": "127.0.0.1:0", "auth_disabled": True}},
        "tenant_resolver": {"config": {"single_tenant": "default"}},
        "model_registry": {"config": {"models": list(fed_entries())}},
        "grpc_hub": {"config": {"bind_addr": "127.0.0.1:0", "worker_lease_ttl_s": 5.0,
                                "eviction_interval_s": 0.5}},
        "llm_gateway": {"config": {"federation": {"enabled": True, "seed": 0,
                                                  "failover_backoff_s": 0.01}}},
        "monitoring": {"config": {"allow_fault_injection": True, "doctor": {
            "objectives": {"ttft_p95": {"threshold_ms": 600000.0, "budget": 0.5}},
            "stream_stall_s": 600.0, "round_stall_floor_s": 600.0,
            "queue_deadline_s": 600.0, "shed_after": 100000}}}}}


def fed_model_info(entry: dict) -> ModelInfo:
    return ModelInfo(canonical_id=f"{entry['provider_slug']}::{entry['provider_model_id']}",
                     provider_slug=entry["provider_slug"],
                     provider_model_id=entry["provider_model_id"], managed=True,
                     architecture="llama", limits=dict(entry["limits"]),
                     engine_options=dict(entry["engine_options"]))


def fed_spawn(hub: str, host: str, entry: dict, f32: bool = False) -> subprocess.Popen:
    """One worker host announcing ``entry``'s model to ``hub``: the port's
    worker entry point (``--fed-f32-host``: through this script, which
    registers the 4-layer model and turns TF32 off first). Its log goes to
    ``build/chip_smoke/fed/<host>.log``."""
    root = Path(__file__).resolve().parent
    logs = root / "build" / "chip_smoke" / "fed"
    logs.mkdir(parents=True, exist_ok=True)
    cfg = {"hub_endpoint": hub, "host": host, "worker": {"device": FED_DEVICE},
           "observability": FED_WORKER_OBS, "heartbeat_interval_s": 0.5,
           "models": [model_ref_dict(fed_model_info(entry))]}
    cmd = ([sys.executable, str(Path(__file__).resolve()), "--fed-f32-host"] if f32 else
           [sys.executable, "-m", "cyberfabric_core_tpu_torch.modules.llm_gateway.worker"])
    with open(logs / f"{host}.log", "w") as err:
        return subprocess.Popen(cmd, cwd=root, stdout=subprocess.PIPE, stderr=err, text=True,
                                env={**os.environ, "FED_WORKER_CONFIG": json.dumps(cfg)})


def fed_f32_host() -> int:
    """``--fed-f32-host``: a worker host serving the f32 identity's model
    (this script's 4-layer cut of llama-3-8b, TF32 off)."""
    MODEL_CONFIGS[FED_F32_CONFIG] = dataclasses.replace(
        get_config("llama-3-8b"), name=FED_F32_CONFIG, num_layers=4)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return worker_module.main()


def fed_ready(procs: dict[str, subprocess.Popen], timeout: float = 300.0) -> dict[str, dict]:
    """Each host's READY line (its engines built, announced), read together."""
    lines: dict[str, str] = {}

    def read(host, proc):
        lines[host] = proc.stdout.readline()

    readers = [threading.Thread(target=read, args=item, daemon=True) for item in procs.items()]
    for r in readers:
        r.start()
    for r in readers:
        r.join(timeout)
    bad = {h: p.poll() for h, p in procs.items() if not lines.get(h)}
    if bad:
        raise AssertionError(f"[federation] hosts gave no READY line (exit codes {bad}); "
                             "their logs are in build/chip_smoke/fed/")
    return {h: json.loads(line) for h, line in lines.items()}


def fed_stop(procs: dict[str, subprocess.Popen]) -> None:
    """SIGTERM (the host withdraws), SIGKILL past 30 s."""
    for p in procs.values():
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs.values():
        try:
            p.wait(30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait(10)
        p.stdout.close()


#: the gateway's event loop: this script's own gRPC calls run there too
#: (grpc.aio binds its poller to the first loop that uses it)
FED_LOOP: list = []


def fed_run(coro):
    return asyncio.run_coroutine_threadsafe(coro, FED_LOOP[0]).result(600)


def fed_health(endpoint: str) -> dict:
    async def go():
        client = GrpcLlmWorkerClient(endpoint=endpoint)
        try:
            return await client.health()
        finally:
            await client.close()
    return fed_run(go())


def fed_ids(endpoint: str, model: ModelInfo, prompt: str, max_tokens: int) -> list[int]:
    """One greedy completion's token ids straight from one host's
    LlmWorkerService (no routing)."""
    async def go():
        client = GrpcLlmWorkerClient(endpoint=endpoint)
        try:
            return [c.token_id async for c in client.completion_stream(
                model, prompt, {"max_tokens": max_tokens, "_fed_token_stream": True})
                if c.token_id is not None]
        finally:
            await client.close()
    return fed_run(go())


def fed_idle_stats(endpoint: str, model: str, label: str, timeout: float = 60.0) -> dict:
    """The host's scheduler stats once it holds no request (over Health)."""
    deadline = time.monotonic() + timeout
    while True:
        st = fed_health(endpoint)["schedulers"][model]
        if not (st["active"] or st["pending"] or st["prefilling"] or st["suspended"]):
            return st
        if time.monotonic() > deadline:
            raise AssertionError(f"[{label}] the host did not go idle: {st}")
        time.sleep(0.1)


def fed_ledgers(pool) -> dict[str, list[int]]:
    """Wraps the federated pool's client factory so that the token ids each
    placed host streams are kept by request id (the pool's own ledger, in
    arrival order): the gates' view of the tokens the text cannot show."""
    ledgers: dict[str, list[int]] = {}
    make = pool._factory

    def recording(w):
        client = make(w)
        inner = client.completion_stream

        async def completion_stream(model, prompt, params):
            async for chunk in inner(model, prompt, params):
                if chunk.token_id is not None:
                    ledgers.setdefault(params["_request_id"], []).append(chunk.token_id)
                yield chunk

        client.completion_stream = completion_stream
        return client

    pool._factory = recording
    return ledgers


def fed_kill_stream(port: int, body: dict, rid: str, ready: dict[str, dict],
                    after_deltas: int = 4) -> tuple[list[dict], str]:
    """An SSE completion whose serving host is SIGKILLed after
    ``after_deltas`` content deltas. Returns (the chunks, the killed host)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    chunks, killed, deltas = [], None, 0
    try:
        conn.request("POST", "/v1/completions", body=json.dumps({**body, "stream": True}),
                     headers={"Content-Type": "application/json", "X-Request-Id": rid})
        resp = conn.getresponse()
        if resp.status != 200:
            raise AssertionError(f"[federation kill] {resp.status}: {resp.read()[:300]}")
        frames = []
        for raw in resp:
            line = raw.decode().rstrip("\n")
            if not line.startswith("data: "):
                if line.startswith("event:"):
                    raise AssertionError(f"[federation kill] an event frame: {line}")
                continue
            frames.append(line[len("data: "):])
            if frames[-1] == "[DONE]":
                continue
            chunks.append(json.loads(frames[-1]))
            deltas += bool(chunks[-1]["delta"].get("content"))
            if killed is None and deltas >= after_deltas:
                host = http_call(port, "GET", f"/v1/monitoring/requests/{rid}")[2][
                    "worker_host"]
                os.kill(ready[host]["pid"], signal.SIGKILL)
                killed = host
        if frames[-1:] != ["[DONE]"]:
            raise AssertionError("[federation kill] the stream did not end with [DONE]")
    finally:
        conn.close()
    if killed is None:
        raise AssertionError(f"[federation kill] the stream ended after {deltas} deltas, "
                             "before the kill")
    return chunks, killed


def round_split(p0: dict, p1: dict) -> dict:
    """An engine's rounds between two ``stats()["pipeline"]`` readings, by
    kind: the count and the mean dispatch / sync-wait / host-emit ms."""
    out = {}
    for kind, after in p1["ms_by_kind"].items():
        before = p0["ms_by_kind"][kind]
        n = after["count"] - before["count"]
        if n:
            out[kind] = {"rounds": n, **{k: round((after[k] - before[k]) / n, 2)
                                         for k in ("dispatch_ms", "sync_wait_ms",
                                                   "host_emit_ms")}}
    return out


def fed_only(smi: str) -> None:
    """``--federation``: the http storm on one host (the port's server in
    this process, as phase 5(a) serves it, with its gates: the federated
    storm's reference in the same call), then the federation phase alone."""
    srv = BackgroundServer(http_config()).start()
    try:
        if http_json(srv.port, "/v1/completions",
                     {"model": HTTP_MODEL, "prompt": "warm", "max_tokens": 2})[0] != 200:
            raise AssertionError("[http storm] the warm-up request failed")
        engine = srv.host.worker.engine(HTTP_MODEL)
        http_storm(smi, srv.port, engine, None, record_tokens(engine))
        del engine  # the weights go with the server
    finally:
        srv.stop()
    del srv
    free_card()
    federation_phase(smi)


def fed_schedulers(ready: dict[str, dict], model: str) -> dict[str, dict]:
    """Each host's scheduler stats for ``model`` over its Health RPC."""
    return {h: fed_health(r["endpoint"])["schedulers"][model] for h, r in ready.items()}


def fed_host_gates(label: str, ready: dict[str, dict], model: str,
                   before: dict[str, dict]) -> dict[str, dict]:
    """Each host's part in a storm, from its scheduler's stats over Health
    before it (``before``, by host) and once the host is idle after it: the
    launches its kernel wrappers counted in the host process, its mixed
    rounds (the ragged kernel) and decode chunks (graph replays of the
    decode kernel). Gates, on each host: the engine's device is CUDA, the
    ragged and decode kernels launched and flash did not, mixed rounds and
    graph replays ran, no decode chunk ran eager. Returns by host the
    device, the launches, the round counts and the rounds by kind."""
    out = {}
    for h, b in before.items():
        st = fed_idle_stats(ready[h]["endpoint"], model, label)
        launched = {k: int(st["kernel_launches"][k] - b["kernel_launches"][k]) for k in KERNELS}
        rounds = {k: int(st["pipeline"][k] - b["pipeline"][k])
                  for k in ("mixed_rounds", "decode_graph_replays", "decode_eager_chunks")}
        if not st["device"].startswith("cuda") or launched["ragged_paged_attention"] <= 0 or \
                launched["paged_decode_attention"] <= 0 or launched["flash_self_attention"] or \
                rounds["mixed_rounds"] <= 0 or rounds["decode_graph_replays"] <= 0 or \
                rounds["decode_eager_chunks"]:
            raise AssertionError(f"[{label}] {h}: engine on {st['device']}, launches "
                                 f"{launched}, rounds {rounds}")
        out[h] = {"device": st["device"], "launches": launched, **rounds,
                  "by_kind": round_split(b["pipeline"], st["pipeline"])}
    return out


def fed_failovers(port: int) -> float:
    return parse_metrics(http_call(port, "GET", "/metrics")[2])[
        "llm_federated_failovers_total"][""]


def federation_phase(smi: str) -> dict[str, int]:
    """The federated-worker entry on the card (phase 5(k)): the port's gateway
    (``grpc_hub``, ``llm_gateway`` with federation on and no engine,
    ``monitoring``) in this process, serving two worker host processes on
    the card, each with llama-3-8b (random bf16 weights from seed 0) at the
    quickstart worker's options. ``smi`` labels every number. Returns the
    federated storm's kernel launches, counted in the hosts and summed."""
    t_phase = time.perf_counter()
    fed_launches = {name: 0 for name in KERNELS}
    free_card()
    entry, f32_entry = fed_entries()
    model = fed_model_info(entry)
    cfg = get_config("llama-3-8b")
    tok = ByteTokenizer(cfg.vocab_size)
    srv = BackgroundServer(fed_config()).start()
    FED_LOOP[:] = [srv._loop]
    procs: dict[str, subprocess.Popen] = {}
    try:
        pool = srv.host.worker
        ledgers = fed_ledgers(pool)
        hub = srv.host.hub.endpoint
        t = time.perf_counter()
        procs = {h: fed_spawn(hub, h, entry) for h in FED_HOSTS}
        ready = fed_ready(procs)
        boot_s = time.perf_counter() - t
        # (a) both hosts announced and listed
        table = http_call(srv.port, "GET", "/v1/monitoring/workers")[2]
        if sorted(w["host"] for w in table["workers"]) != list(FED_HOSTS) or \
                any(w["models"] != [model.canonical_id] for w in table["workers"]):
            raise AssertionError(f"[federation] workers table: {table}")
        # the two hosts drew the same weights: one greedy prompt, each host alone
        probe = letters(np.random.default_rng(11), 95)
        same = {h: fed_ids(r["endpoint"], model, probe, 24) for h, r in ready.items()}
        if len({tuple(v) for v in same.values()}) != 1:
            raise AssertionError(f"[federation] the hosts' weights differ: {same}")
        log(f"serving [federation]: {len(FED_HOSTS)} worker hosts on {FED_DEVICE} built "
            f"llama-3-8b (bf16, seed 0), announced and READY in {boot_s:.1f} s; "
            "/v1/monitoring/workers lists both; one greedy prompt gives the same 24 token "
            "ids on each host")
        rope = rope_frequencies(cfg.head_dim, max(cfg.max_position, QUICKSTART["max_seq_len"]),
                                cfg.rope_theta, device=CARD)
        dense = DenseOracle(llama.init_params(cfg, 0, torch.bfloat16, CARD), cfg, rope)

        # (b) the federated storm: the http storm's 8 SSE completions from 3
        # threads, every SSE and usage gate, and the oracle
        prompts = storm_prompts()
        before = fed_schedulers(ready, model.canonical_id)
        recs, wall = socket_storm(srv.port, model.canonical_id, prompts,
                                  request_ids("fed-storm", len(prompts)))
        chunks, numbers = storm_gates("federated storm", recs, wall, prompts,
                                      [ledgers[f"fed-storm-{i}"] for i in range(len(prompts))],
                                      tok, dense)
        placed = {}
        for i in range(len(prompts)):
            host = http_call(srv.port, "GET", f"/v1/monitoring/requests/fed-storm-{i}")[2][
                "worker_host"]
            placed[host] = placed.get(host, 0) + 1
        log(f"serving [federated storm]: 8 SSE streams, SSE contract held, finish "
            f"{[c[-1]['finish_reason'] for c in chunks]}, usage = the pool's ledger of "
            f"streamed token ids ({numbers['tokens']}), each text = decode of its ids "
            "(oracle above)")
        log(f"info [{smi}] serving [federated storm] (client side, at the socket, 2 hosts "
            f"on one card, placed {placed}): {format_latency(numbers)}")
        if "http storm" in STORM_NUMBERS:
            log(f"info [{smi}] serving [http storm] (one host, in process, same call): "
                f"{format_latency(STORM_NUMBERS['http storm'])}; its rounds: "
                f"{json.dumps(STORM_SPLITS.get('http storm'))}")

        # (g) each host's Health RPC: its engine's device, and the kernel
        # launches its wrappers counted over the storm, by host
        hosts = fed_host_gates("federation health", ready, model.canonical_id, before)
        for name in KERNELS:
            fed_launches[name] = sum(row["launches"][name] for row in hosts.values())
        counted = {h: {k: v for k, v in row.items() if k != "by_kind"}
                   for h, row in hosts.items()}
        log(f"serving [federation health]: by each host's Health RPC, its engine's device, "
            f"the storm's kernel launches counted in the host process (ragged and decode "
            f"> 0, flash 0), mixed rounds and decode graph replays (> 0), no eager decode "
            f"chunk: {json.dumps(counted)}")
        log(f"info [{smi}] serving [federated storm] each host's rounds in the storm: "
            f"{json.dumps({h: row['by_kind'] for h, row in hosts.items()})}")

        # (d) one storm request's stitched timeline
        tl = http_call(srv.port, "GET", "/v1/monitoring/requests/fed-storm-3")[2]
        host = tl.get("worker_host")
        if not tl.get("stitched") or tl.get("origins") != ["gateway", host] or not any(
                e.get("origin") == host and e["event"] == "finished" for e in tl["timeline"]):
            raise AssertionError(f"[federation timeline] {tl.get('origins')} "
                                 f"{[e.get('event') for e in tl.get('timeline', [])]}")
        log(f"serving [federation timeline]: fed-storm-3's timeline stitches the gateway's "
            f"{sum(e['origin'] == 'gateway' for e in tl['timeline'])} events and {host}'s "
            f"{tl['segments'][host]['events']} under one request id")

        # (e) the fleet document and the host-labelled series
        fleet = http_call(srv.port, "GET", "/v1/monitoring/fleet")[2]
        metrics = http_call(srv.port, "GET", "/metrics")[2]
        labelled = sorted({ln.split("{")[0] for ln in metrics.splitlines()
                           if ln.startswith("llm_") and 'host="fedhost-' in ln})
        if sorted(r["host"] for r in fleet["hosts"]) != list(FED_HOSTS) or not all(
                f'llm_remote_workers_healthy{{host="{h}"}} 1.0' in metrics for h in FED_HOSTS) \
                or len(labelled) < 3:
            raise AssertionError(f"[federation fleet] {fleet} / {labelled}")
        log(f"serving [federation fleet]: /v1/monitoring/fleet state {fleet['state']} over "
            f"{[(r['host'], r['state']) for r in fleet['hosts']]}; /metrics carries "
            f"{len(labelled)} host-labelled llm_* families")

        # (c) prefix affinity: the head served once, 7 requests behind it
        rng = np.random.default_rng(7)
        head = letters(rng, HEAD - 1)
        hosts0 = {h: fed_health(r["endpoint"])["schedulers"][model.canonical_id][
            "prefix_cache"] for h, r in ready.items()}
        placements0 = dict(pool.placements)
        assert http_json(srv.port, "/v1/completions",
                         {"model": model.canonical_id, "prompt": head + letters(rng, 200),
                          "max_tokens": 16}, {"X-Request-Id": "fed-head"})[0] == 200
        head_host = http_call(srv.port, "GET", "/v1/monitoring/requests/fed-head")[2][
            "worker_host"]
        chain = digest_chain(head)
        wait_for(lambda: any(w.host == head_host and match_depth(
            chain, w.census.get("prefix", {}).get(model.canonical_id, ())) >= len(chain)
            for w in srv.host.hub.registry.alive()), 30, "the head's gossiped prefix",
            "federation prefix")
        for n, s in enumerate(HEAD_SUFFIXES[1:]):
            rid = f"fed-prefix-{n}"
            status, _, body = http_json(srv.port, "/v1/completions",
                                        {"model": model.canonical_id,
                                         "prompt": head + letters(rng, s), "max_tokens": 16},
                                        {"X-Request-Id": rid})
            t_rec = http_call(srv.port, "GET", f"/v1/monitoring/requests/{rid}")[2]
            placement = [e.get("placement") for e in t_rec["timeline"]
                         if e["event"] == "admitted" and "placement" in e]
            if status != 200 or t_rec["worker_host"] != head_host or placement != ["prefix"]:
                raise AssertionError(f"[federation prefix] {rid}: {status}, host "
                                     f"{t_rec['worker_host']} (head on {head_host}), "
                                     f"placement {placement}")
        pc = fed_health(ready[head_host]["endpoint"])["schedulers"][model.canonical_id][
            "prefix_cache"]
        hits = pc["hits"] - hosts0[head_host]["hits"]
        saved = pc["prefill_tokens_saved"] - hosts0[head_host]["prefill_tokens_saved"]
        if pool.placements["prefix"] - placements0["prefix"] < 7 or hits < 7 or \
                saved < 7 * HEAD:
            raise AssertionError(f"[federation prefix] placements {pool.placements}, hits "
                                 f"{hits}, tokens saved {saved}")
        log(f"serving [federation prefix]: a {HEAD}-token head on {head_host}, then 7 "
            f"requests behind it: all 7 placed by prefix on {head_host}, its radix cache "
            f"hit {hits} times saving {saved} prompt tokens")

        # (f) SIGKILL of the serving host mid-stream, bf16
        prompt = letters(np.random.default_rng(9), 399)
        body = {"model": model.canonical_id, "prompt": prompt, "max_tokens": FED_KILL_TOKENS}
        assert http_json(srv.port, "/v1/completions", body, {"X-Request-Id": "fed-kill-base"}
                         )[0] == 200
        failovers0 = fed_failovers(srv.port)
        kchunks, killed = fed_kill_stream(srv.port, body, "fed-kill", ready)
        survivor = next(h for h in FED_HOSTS if h != killed)
        got, base = ledgers["fed-kill"], ledgers["fed-kill-base"]
        finals = [c for c in kchunks if c.get("finish_reason")]
        if len(finals) != 1 or finals[0]["usage"]["output_tokens"] != len(got) or \
                fed_failovers(srv.port) != failovers0 + 1 or \
                streamed_text(kchunks) != tok.decode(got):
            raise AssertionError(f"[federation kill] terminals {finals}, {len(got)} ids, "
                                 f"failovers {fed_failovers(srv.port) - failovers0}")
        oracle("federation kill", dense, [{"toks": got}],
               [(tok.encode(prompt), SamplingParams(max_tokens=FED_KILL_TOKENS))], None)
        check_pool("federation kill, survivor",
                   fed_idle_stats(ready[survivor]["endpoint"], model.canonical_id,
                                  "federation kill"))
        ktl = http_call(srv.port, "GET", "/v1/monitoring/requests/fed-kill")[2]
        fo = [e for e in ktl["timeline"] if e["event"] == "failover"]
        j = first_divergence(base, got)
        tie = ""
        if j is not None:
            # where the streams part: both tokens against the dense forward's
            # row over their shared prefix (a near-tie, if rounding decided it)
            with torch.inference_mode():
                ids = tok.encode(prompt)
                g_got, top2 = dense_gaps(dense.params, cfg, rope, ids, got[:j + 1])
                g_base, _ = dense_gaps(dense.params, cfg, rope, ids, base[:j + 1])
            tie = (f"; at token {j} the dense forward puts the served token "
                   f"{float(g_got[j]):.4f} and the undisturbed one {float(g_base[j]):.4f} "
                   f"below its max (top-1/top-2 gap {float(top2[j]):.4f})")
        log(f"serving [federation kill]: {killed} SIGKILLed after 4 deltas of a "
            f"{FED_KILL_TOKENS}-token greedy stream; one terminal "
            f"({finals[0]['finish_reason']}), llm_federated_failovers_total +1, "
            f"{fo[0]['carried_tokens'] if fo else '?'} tokens carried to {survivor}, which "
            f"re-prefilled them; every token through the oracle; I1 on {survivor}; the stream "
            + ("equals the undisturbed one token for token" if j is None else
               f"parts from the undisturbed one at token {j} of {len(got)} (bf16: the "
               "carried tokens prefill as one chunk where they decoded one by one)" + tie))
        # the storm on the survivor alone: the gRPC hop's cost without a second
        # process on the card (prompts of the same lengths, another seed: the
        # survivor's radix cache holds the storm's)
        prompts = storm_prompts(15)
        before = fed_schedulers({survivor: ready[survivor]}, model.canonical_id)
        recs, wall = socket_storm(srv.port, model.canonical_id, prompts,
                                  request_ids("fed-solo", len(prompts)))
        _, numbers = storm_gates("federated storm, one host", recs, wall, prompts,
                                 [ledgers[f"fed-solo-{i}"] for i in range(len(prompts))],
                                 tok, dense)
        solo = fed_host_gates("federated storm, one host", ready, model.canonical_id, before)
        log(f"info [{smi}] serving [federated storm, one host] (the survivor alone, the "
            f"storm's lengths at seed 15, at the socket): {format_latency(numbers)}; its "
            f"launches {solo[survivor]['launches']}, rounds "
            f"{json.dumps(solo[survivor]['by_kind'])}")
        fed_stop(procs)
        procs = {}
        del dense
        free_card()

        # the f32 identity: the same kill at llama-3-8b widths, 4 layers, f32,
        # TF32 off, where the continuation must equal the undisturbed stream
        model32 = fed_model_info(f32_entry)
        procs = {f"{h}-f32": fed_spawn(hub, f"{h}-f32", f32_entry, f32=True)
                 for h in FED_HOSTS}
        ready = fed_ready(procs)
        for h in ready:  # pace decode so the kill lands mid-stream
            status, _, doc = http_call(srv.port, "PUT",
                                       "/v1/monitoring/failpoints/scheduler.readback",
                                       {"spec": "delay(0.02)", "host": h})
            if status != 200:
                raise AssertionError(f"[federation f32] arming {h}: {status} {doc}")
        body32 = {"model": model32.canonical_id, "prompt": prompt,
                  "max_tokens": FED_F32_TOKENS}
        assert http_json(srv.port, "/v1/completions", body32,
                         {"X-Request-Id": "fed-f32-base"})[0] == 200
        kchunks, killed = fed_kill_stream(srv.port, body32, "fed-f32-kill", ready)
        got, base = ledgers["fed-f32-kill"], ledgers["fed-f32-base"]
        if got != base or len([c for c in kchunks if c.get("finish_reason")]) != 1:
            raise AssertionError(f"[federation f32] the failover stream parts from the "
                                 f"undisturbed one at token {first_divergence(base, got)}")
        log(f"serving [federation f32]: {FED_F32_CONFIG} (llama-3-8b widths, 4 layers) at "
            f"f32, TF32 off, on two hosts: {killed} SIGKILLed mid-stream, the "
            f"{len(got)}-token stream continued on the other host equals the undisturbed "
            "one token for token, one terminal")
    finally:
        fed_stop(procs)
        srv.stop()
        free_card()
    log(f"info [{smi}] federation phase: {time.perf_counter() - t_phase:.1f} s")
    return fed_launches


def trace_cost(smi: str) -> None:
    """``--trace-cost``: what observability costs the storm. Two hosts on the
    card, each serving llama-3-8b: one from the port's quickstart with
    monitoring and tracing (sample ratio 1.0, OTLP to a loopback collector),
    one from the http storm's sections (no monitoring, no tracing section).
    The http storm's shape on fresh prompts each run, in turns ABCDEF
    FEDCBA: A traced with ``/metrics`` scraped every 100 ms, B traced, C
    scraped, D neither (the tracer disabled, as without a ``tracing``
    section), E the plain host, F the monitored host neither traced nor
    scraped with its doctor stopped. Tokens/s, ttft and inter-token latency
    at the socket. A diagnosis, not a gate; prints no result line."""
    from statistics import median

    root = Path(__file__).resolve().parent / "build" / "chip_smoke"
    collector = OtlpCollector()
    # the plain host first: the last host built installs the global tracer
    # the engines' spans go through
    plain = BackgroundServer(http_config()).start()
    srv = BackgroundServer(observability_config(root / "home-cost", collector.endpoint)).start()
    # (host, traced, scraped, doctor running)
    variants = {"A traced + scraped": (srv, True, True, True),
                "B traced": (srv, True, False, True),
                "C scraped": (srv, False, True, True), "D neither": (srv, False, False, True),
                "E plain host": (plain, False, False, False),
                "F neither, doctor stopped": (srv, False, False, False)}
    runs: dict[str, list[dict]] = {name: [] for name in variants}
    try:
        engines = {}
        for host in (srv, plain):
            status, _, body = http_json(host.port, "/v1/completions",
                                        {"model": HTTP_MODEL, "prompt": "warm", "max_tokens": 2})
            if status != 200:
                raise AssertionError(f"[trace cost] first request: {status} {body}")
            engines[host] = host.host.worker.engine(HTTP_MODEL)
        doctor = srv.host.monitoring.doctor
        order = list(variants) + list(reversed(variants))
        for n, name in enumerate(order):
            host, traced, scraped, doctoring = variants[name]
            srv.host.tracer.enabled = traced
            if doctoring:
                doctor.ensure_started()
            else:
                doctor.stop()
            prompts, _, headers = traced_prompts(100 + n, f"cost{n}")
            scraper = Scraper(host.port)
            if scraped:
                scraper.start()
            recs, wall = socket_storm(host.port, HTTP_MODEL, prompts, headers)
            scraper.halt.set()
            if scraped:
                scraper.join(30)
            wait_idle(engines[host])
            chunks = [sse_chunks(f"trace cost {name}", rec) for rec in recs]
            numbers = socket_numbers(
                recs, sum(c[-1]["usage"]["output_tokens"] for c in chunks), wall)
            runs[name].append(numbers)
            log(f"info [{smi}] trace cost [{name}] run {n + 1}: {format_latency(numbers)}"
                + (f" ({scraper.count} scrapes)" if scraped else ""))
    finally:
        plain.stop()
        srv.stop()
        collector.close()
    for name, got in runs.items():
        log(f"info [{smi}] trace cost [{name}] medians of {len(got)}: tokens/s "
            f"{median(r['tokens_per_s'] for r in got):.1f}, ttft p50 "
            f"{median(r['ttft_p50_ms'] for r in got):.1f} ms, inter-token p50 "
            f"{median(r['itl_p50_ms'] for r in got):.2f} / p99 "
            f"{median(r['itl_p99_ms'] for r in got):.2f} ms; runs "
            f"{[round(r['tokens_per_s'], 1) for r in got]}")


def profile_ring(card: str) -> None:
    """``--profile-ring``: the mixed storm at depth 2 under torch.profiler
    (CPU and CUDA activity): the host's CUDA runtime calls by total time (a
    call that waits for the card shows here), then the round timeline. A
    diagnosis, not a gate; prints no result line."""
    from torch.profiler import ProfilerActivity, profile

    engine, ecfg = build_engine("mixed, profiled", QUICKSTART)
    requests = storm_requests(engine, ecfg)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            serve(engine, requests)
    finally:
        engine.shutdown()
    rows = sorted((e for e in prof.key_averages() if e.key.startswith("cuda")),
                  key=lambda e: -e.cpu_time_total)[:15]
    for e in rows:
        log(f"info [{card}] profile-ring host call {e.key}: count {e.count}, total "
            f"{e.cpu_time_total / 1e3:.2f} ms, max {e.cpu_time_total / max(1, e.count) / 1e3:.3f} "
            "ms mean")
    pipeline_line(card, "mixed, profiled", engine.stats())


def sampling_determinism(smi: str, reps: int = 60, runs: int = 8) -> None:
    """``--sampling-determinism``: the lockstep sampled self-draft path
    (llama-3-8b bf16, bs=1, the lockstep speculation phase's prompt) with
    the sampler's CDF through ``sampling.cumsum_rows`` and through plain
    ``torch.cumsum``. For each: how many of ``reps`` recomputations from the
    same inputs leave the first one's bits (the prefill's logits and cache,
    the draft's k drafts and their distributions under one seed, the verify
    logits), then ``runs`` sampled runs (temperature 0.8, seed 42) and how
    many distinct streams they give. A diagnosis, not a gate; prints no
    result line."""
    base = dataclasses.replace(engine_config_from_options(QUICKSTART), dtype="bfloat16")
    cfg = get_config(base.model)
    tree = llama.init_params(cfg, 0, torch.bfloat16, CARD)
    engine = InferenceEngine(dataclasses.replace(base, speculative="draft",
                                                 draft_model=base.model),
                             params=tree, seed=0, device=CARD)
    draft = DraftModel(cfg, tree, max_seq=base.max_seq_len, dtype=engine.dtype, k=base.spec_k,
                       device=CARD, use_flash=engine.use_flash)
    engine._draft = draft
    prompt = lockstep_spec_prompt(cfg.vocab_size)
    warp = (torch.tensor([0.8], device=CARD), torch.tensor([1.0], device=CARD),
            torch.tensor([0], dtype=torch.int32, device=CARD))
    ids = np.zeros((1, engine._bucket_for(len(prompt))), np.int32)
    ids[0, :len(prompt)] = prompt

    def prefill():
        """The prompt's logits and K and V caches."""
        cache = llama.init_cache(cfg, 1, base.max_seq_len, engine.dtype, device=CARD)
        hidden, cache = llama.forward(
            engine.params, cfg, torch.from_numpy(ids).to(CARD),
            torch.arange(ids.shape[1], dtype=torch.int32, device=CARD)[None, :], cache,
            i32([0], CARD), engine.rope_tables, use_flash=engine.use_flash)
        last = llama.gather_last_hidden(hidden, i32([len(prompt)], CARD))
        return llama.lm_head_logits(engine.params, cfg, last), cache[0], cache[1]

    def proposal():
        """The k drafts and their distributions under one seed."""
        draft.generator.manual_seed(5)
        return tuple(t.clone() for t in draft.propose(prompt[-1], *warp))

    def differing(make) -> int:
        first = make()
        return sum(not all(torch.equal(a, b) for a, b in zip(make(), first))
                   for _ in range(reps))

    rows_cumsum = sampling.cumsum_rows
    sampled = SamplingParams(max_tokens=LOCKSTEP_SPEC_OUT, temperature=0.8, seed=42)
    lockstep_spec_run("sampling determinism, warm", engine, prompt,
                      SamplingParams(max_tokens=16))
    try:
        for variant in ("torch.cumsum", "cumsum_rows"):
            sampling.cumsum_rows = rows_cumsum if variant == "cumsum_rows" else (
                lambda x: torch.cumsum(x, dim=-1))
            with torch.inference_mode():
                n_prefill = differing(prefill)
                _, k_cache, v_cache = prefill()
                draft.reset(prompt, 5)
                n_draft = differing(proposal)
                tokens = torch.cat([i32([prompt[-1]], CARD), proposal()[0]])[None]
                n_verify = differing(lambda: (span_verify_logits(
                    engine.params, cfg, (k_cache, v_cache), tokens, i32([len(prompt)], CARD),
                    engine.rope_tables)[0].clone(),))
                del k_cache, v_cache
            streams = [tuple(lockstep_spec_run(f"sampling determinism, {variant} ({n})", engine,
                                               prompt, sampled)["toks"]) for n in range(runs)]
            log(f"info [{smi}] sampling determinism, {variant}: of {reps} recomputations, "
                f"{n_prefill} prefills, {n_draft} draft proposals (drafts and distributions) "
                f"and {n_verify} verify passes left the first one's bits; {runs} sampled runs "
                f"(temperature 0.8, seed 42) gave {len(set(streams))} distinct streams")
    finally:
        sampling.cumsum_rows = rows_cumsum


# ------------------------------------------------------------------- training
#: the pipeline's cell: llama-3-8b widths cut to 4 layers, f32, TF32 off
TRAIN_LAYERS = 4
TRAIN_B, TRAIN_T = 8, 256
#: (pp, dp, M), every stage and row on the one card
TRAIN_GRID = ((2, 1, 4), (4, 1, 4), (2, 2, 2))
#: (rtol, atol) of the gradients, as tests/test_pipeline.py:67; the loss
#: takes F32_TOL, as :50
TRAIN_GRAD_TOL = (5e-4, 5e-5)
TRAIN_GRAD_LEAVES = ("embed", "lm_head", "layers.0.wq", "layers.0.down")
TRAIN_STEPS = 5
TRAIN_LR = 1e-4
#: ring attention at llama-3-8b's heads: one sequence of RING_T over 4 ranks
RING_T, RING_SP, RING_GRAD_T = 4096, 4, 512
RING_LENGTH = 3000
#: the trained pair of bench.py --spec-cross: (config, parameter seed)
PAIR_TARGET, PAIR_DRAFT = ("tiny-llama-8l", 0), ("tiny-llama", 99)
PAIR_STEPS, PAIR_BATCH, PAIR_SEQ, PAIR_LR, PAIR_DATA_SEED = 300, 64, 64, 3e-3, 1234
PAIR_TOKENS = 256


def timed_ms(fn) -> tuple[float, object]:
    """Host ms of ``fn()`` between two synchronisations, and its result."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) * 1e3, out


def pipeline_train_phase(smi: str) -> None:
    """GPipe at llama-3-8b widths, 4 layers, f32, TF32 off, B=8, T=256,
    every stage and data-parallel row on the one card. Gates: the
    pipelined loss at each (pp, dp, M) of TRAIN_GRID equal to
    ``reference_loss_fn``'s within F32_TOL (random ids from a seed);
    at (2, 2, 2) the gradients of TRAIN_GRAD_LEAVES within TRAIN_GRAD_TOL;
    over TRAIN_STEPS ``make_train_step`` steps on one Markov batch, the last
    loss below the first. Printed: the step's ms and training tokens/s, the
    peak of ``max_memory_allocated``, beside a reference-loss step's ms in
    the same call. The stages share one card and run one after another, so
    no bubble or speed-up is read from these numbers."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the training phases would not be f32")
    cfg = dataclasses.replace(get_config("llama-3-8b"), name="llama-3-8b, 4 layers",
                              num_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    params = llama.init_params(cfg, 0, torch.float32, CARD)
    ids = torch.from_numpy(np.random.default_rng(17).integers(
        0, cfg.vocab_size, (TRAIN_B, TRAIN_T)).astype(np.int32)).to(CARD)
    targets = torch.roll(ids, -1, dims=1)
    reference = pipeline.reference_loss_fn(cfg)
    with torch.no_grad():
        ref = reference(params, ids, targets)
        for pp, dp, M in TRAIN_GRID:
            mesh = StageMesh(pp, dp, [CARD] * (pp * dp))
            loss = pipeline.pipelined_loss_fn(cfg, mesh, M)(params, ids, targets)
            log(f"training [pipeline loss (pp, dp, M) = {(pp, dp, M)}]: {loss.item():.7f} "
                f"against the reference's {ref.item():.7f}")
            f32_close(loss, ref)
    leaves = dict(zip(params.state_dict(), pipeline.trainable(params)))
    wanted = [leaves[n] for n in TRAIN_GRAD_LEAVES]
    mesh = StageMesh(2, 2, [CARD] * 4)
    piped = pipeline.pipelined_loss_fn(cfg, mesh, 2)
    g_ref = torch.autograd.grad(reference(params, ids, targets), wanted)
    g_pipe = torch.autograd.grad(piped(params, ids, targets), wanted)
    errs = {n: f32_close(p, r, *TRAIN_GRAD_TOL)
            for n, p, r in zip(TRAIN_GRAD_LEAVES, g_pipe, g_ref)}
    log(f"training [pipeline gradients (2, 2, 2)]: within rtol {TRAIN_GRAD_TOL[0]}, atol "
        f"{TRAIN_GRAD_TOL[1]}; max |difference| by leaf {errs}, max |g| "
        f"{ {n: float(r.abs().max()) for n, r in zip(TRAIN_GRAD_LEAVES, g_ref)} }")
    del g_ref, g_pipe, wanted

    seqs = torch.from_numpy(toytrain.markov_sampler(cfg.vocab_size, seed=PAIR_DATA_SEED)(
        TRAIN_B, TRAIN_T + 1, np.random.default_rng(PAIR_DATA_SEED + 1))).to(CARD)
    ids, targets = seqs[:, :-1], seqs[:, 1:]
    train_step, init_opt = pipeline.make_train_step(cfg, mesh, 2, learning_rate=TRAIN_LR)
    opt = init_opt(params)
    losses, step_ms = [], []
    for _ in range(TRAIN_STEPS):
        ms, (params, opt, loss) = timed_ms(lambda: train_step(params, opt, ids, targets))
        losses.append(loss.item())
        step_ms.append(ms)
    if not losses[-1] < losses[0]:
        raise AssertionError(f"[pipeline train step] losses {losses}")

    def reference_step():
        opt.zero_grad(set_to_none=True)
        reference(params, ids, targets).backward()
        opt.step()

    ref_ms = [timed_ms(reference_step)[0] for _ in range(2)]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    log(f"training [pipeline train step (2, 2, 2)]: losses {[round(x, 5) for x in losses]} "
        f"(lr {TRAIN_LR}, one Markov batch)")
    log(f"info [{smi}] training [pipeline, llama-3-8b widths, {TRAIN_LAYERS} layers, f32, B "
        f"{TRAIN_B}, T {TRAIN_T}, (pp, dp, M) (2, 2, 2) on one card]: step ms "
        f"{[round(x, 1) for x in step_ms]} (median after the first {steady:.1f}; "
        f"{TRAIN_B * TRAIN_T / steady * 1e3:.0f} training tokens/s); reference-loss step ms "
        f"{[round(x, 1) for x in ref_ms]}; max_memory_allocated "
        f"{gib(torch.cuda.max_memory_allocated())}")
    del params, opt, leaves


def ring_phase(smi: str) -> None:
    """Ring attention at llama-3-8b's heads (32 / 8, D 128), f32, B=1,
    RING_SP ranks on the one card: at T=RING_T the output equal to the
    plain ``attention_with_cache`` within F32_TOL, without lengths and
    with one of RING_LENGTH (its valid rows); at T=RING_GRAD_T the q, k and
    v gradients of a seeded weighting of the output equal the plain
    attention's. Printed: both functions' device ms at T=RING_T."""
    cfg = get_config("llama-3-8b")
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    gen = torch.Generator(device=CARD).manual_seed(5)
    ranks = [CARD] * RING_SP

    def qkv(T):
        return tuple(torch.randn((1, T, h, D), generator=gen, device=CARD) for h in (Hq, Hkv, Hkv))

    def plain(q, k, v, lengths):
        T = q.shape[1]
        positions = torch.arange(T, dtype=torch.int32, device=CARD)[None]
        return attention_with_cache(q, k, v, positions, lengths)

    q, k, v = qkv(RING_T)
    with torch.no_grad():
        for length in (RING_T, RING_LENGTH):
            lens = torch.tensor([length], dtype=torch.int32, device=CARD)
            out = ring_attention(q, k, v, ranks, lengths=None if length == RING_T else lens)
            err = f32_close(out[:, :length], plain(q, k, v, lens)[:, :length])
            log(f"training [ring attention T {RING_T}, sp {RING_SP}, length {length}]: within "
                f"rtol = atol = {F32_TOL}, max |difference| {err:.3g}")
        full = torch.tensor([RING_T], dtype=torch.int32, device=CARD)
        ring_ms = cuda_ms(lambda: ring_attention(q, k, v, ranks), iters=5)
        plain_ms = cuda_ms(lambda: plain(q, k, v, full), iters=5)
    q, k, v = (t.requires_grad_() for t in qkv(RING_GRAD_T))
    lens = torch.tensor([RING_GRAD_T], dtype=torch.int32, device=CARD)
    out = ring_attention(q, k, v, ranks)
    w = torch.randn(out.shape, generator=gen, device=CARD)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    want = torch.autograd.grad((plain(q, k, v, lens) * w).sum(), (q, k, v))
    errs = {n: f32_close(g, r) for n, g, r in zip("qkv", grads, want)}
    log(f"training [ring attention gradients T {RING_GRAD_T}]: within rtol = atol = {F32_TOL}, "
        f"max |difference| by input {errs}")
    log(f"info [{smi}] training [ring attention, 32 / 8 heads, D 128, f32, B 1, T {RING_T}, "
        f"sp {RING_SP} on one card]: ring {ring_ms:.3f} ms, plain attention {plain_ms:.3f} ms "
        "(device ms a call; the ranks run one after another)")


def trained_pair_phase(smi: str) -> int:
    """The trained draft/target pair of ``bench.py --spec-cross``, on the
    card: ``train_lm`` on tiny-llama-8l (parameter seed 0) and tiny-llama
    (99), PAIR_STEPS steps at batch PAIR_BATCH, seq PAIR_SEQ, lr PAIR_LR,
    data seed PAIR_DATA_SEED; both cast to bf16, the draft saved with
    ``save_llama_params`` and loaded by the engine as ``draft_checkpoint``;
    a lockstep ``InferenceEngine`` (max_seq_len 512, max_batch 1,
    decode_chunk 4, flash on its prefill) with speculation off and with
    ``speculative="draft"`` at ``spec_k`` 8, PAIR_TOKENS tokens from a
    32-token Markov prompt (``prompt_rng`` seed 7), kernel counts set to 0
    just before and read just after. Gates: each training loss ends below
    the initial tree's loss on the first batch; the greedy stream with
    speculation equals the stream without; at temperature 0 and 0.8,
    verify rounds ran and acceptance lies strictly between 0 and 100%;
    flash launched and no paged kernel. Printed: the losses, acceptance,
    tokens per round, the acceptance histogram and tokens/s with
    speculation off and on at both temperatures. Returns the flash
    launches."""
    trees = {}
    for name, seed in (PAIR_TARGET, PAIR_DRAFT):
        cfg = get_config(name)
        t = time.perf_counter()
        params, final = toytrain.train_lm(cfg, steps=PAIR_STEPS, batch=PAIR_BATCH,
                                          seq_len=PAIR_SEQ, param_seed=seed,
                                          data_seed=PAIR_DATA_SEED, lr=PAIR_LR, device=CARD,
                                          log=log)
        train_s = time.perf_counter() - t
        seqs = torch.from_numpy(toytrain.markov_sampler(cfg.vocab_size, seed=PAIR_DATA_SEED)(
            PAIR_BATCH, PAIR_SEQ + 1, np.random.default_rng(PAIR_DATA_SEED + 1))).to(CARD)
        with torch.no_grad():
            first = pipeline.reference_loss_fn(cfg)(
                llama.init_params(cfg, seed, torch.float32, CARD), seqs[:, :-1],
                seqs[:, 1:]).item()
        log(f"info [{smi}] training [{name}, parameter seed {seed}]: loss {first:.4f} on the "
            f"first batch before training, {final:.4f} after {PAIR_STEPS} steps, "
            f"{train_s:.1f} s ({train_s / PAIR_STEPS * 1e3:.1f} ms a step)")
        if not final < first:
            raise AssertionError(f"[{name}] training loss {first} -> {final}")
        trees[name] = toytrain.cast_params(params, torch.bfloat16)
        del params
    target, draft = PAIR_TARGET[0], PAIR_DRAFT[0]
    ddir = Path(__file__).resolve().parent / "build" / "chip_smoke" / "trained-draft"
    save_llama_params(trees[draft], get_config(draft), ddir)
    prompt = toytrain.markov_sampler(get_config(target).vocab_size, seed=PAIR_DATA_SEED)(
        1, 32, np.random.default_rng(7))[0].tolist()
    plain_cfg = EngineConfig(model=target, max_seq_len=512, max_batch=1, decode_chunk=4)
    spec_cfg = dataclasses.replace(plain_cfg, speculative="draft", draft_model=draft,
                                   draft_checkpoint=str(ddir), spec_k=8)
    for _, _, wrapper in KERNELS.values():
        wrapper.launches = 0
    runs = {}
    for mode, ecfg in (("off", plain_cfg), ("draft", spec_cfg)):
        for temp in (0.0, 0.8):
            engine = InferenceEngine(ecfg, params=trees[target], seed=3)
            sp = SamplingParams(max_tokens=PAIR_TOKENS, temperature=temp, seed=11)
            engine.generate([prompt], dataclasses.replace(sp, max_tokens=8))  # warm-up
            runs[mode, temp] = lockstep_spec_run(f"trained pair, spec {mode}, temperature "
                                                 f"{temp}", engine, prompt, sp)
            del engine
    launches = {name: wrapper.launches for name, (_, _, wrapper) in KERNELS.items()}
    if runs["draft", 0.0]["toks"] != runs["off", 0.0]["toks"]:
        raise AssertionError(f"[trained pair] greedy speculation leaves spec off's stream at "
                             f"token {first_divergence(runs['draft', 0.0]['toks'], runs['off', 0.0]['toks'])}")
    for temp in (0.0, 0.8):
        st = runs["draft", temp]["stats"]
        if not (st["verify_calls"] > 0 and 0 < st["accepted"] < st["drafted"]):
            raise AssertionError(f"[trained pair, temperature {temp}] {st}")
    if launches["flash_self_attention"] <= 0 or launches["ragged_paged_attention"] \
            or launches["paged_decode_attention"]:
        raise AssertionError(f"[trained pair] launches {launches}: want flash, no paged kernel")
    summary = {}
    for (mode, temp), run in runs.items():
        st = run["stats"]
        summary[f"spec {mode}, temperature {temp}"] = {
            "tokens_per_s": round(run["tokens_per_s"], 1), "tokens": len(run["toks"]),
            **({} if mode == "off" else {
                "acceptance_pct": round(100.0 * st["accepted"] / st["drafted"], 1),
                "tokens_per_round": round(st["spec_tokens"] / st["verify_calls"], 2),
                "verify_calls": st["verify_calls"], "fallback_steps": st["fallback_steps"],
                "accept_hist": dict(sorted(run["accept_hist"].items()))})}
    log(f"serving [trained pair]: greedy speculation equals spec off's {len(runs['off', 0.0]['toks'])} "
        f"tokens; launches {launches}")
    log(f"info [{smi}] serving [trained pair, {target} target (bf16) with a {draft} draft "
        f"from draft_checkpoint, lockstep, bs 1, spec_k 8, {PAIR_TOKENS} tokens from a "
        f"32-token Markov prompt]: " + json.dumps(summary))
    shutil.rmtree(ddir, ignore_errors=True)
    return launches["flash_self_attention"]


def training_phases(smi: str) -> int:
    """The training section (outside inference mode): the pipeline, ring
    attention and the trained pair, each followed by a reading of the
    card's memory. Returns the trained pair's flash launches."""
    t = time.perf_counter()
    pipeline_train_phase(smi)
    card_memory("training: pipeline")
    ring_phase(smi)
    card_memory("training: ring attention")
    flash = trained_pair_phase(smi)
    card_memory("training: trained pair")
    log(f"training section: {time.perf_counter() - t:.1f} s")
    return flash


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if sys.argv[1:] == ["--fed-f32-host"]:
        return fed_f32_host()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--profile-ring"]:
        with torch.inference_mode():
            profile_ring(torch.cuda.get_device_name(0))
        return 0
    # one section alone, with no result line
    sections = {"--sampling-determinism": sampling_determinism, "--federation": fed_only,
                "--train": training_phases, "--trace-cost": trace_cost,
                "--tp": lambda smi: tp_only(torch.cuda.get_device_name(0), smi)}
    if len(sys.argv) == 2 and sys.argv[1] in sections:
        _build.build_all()
        sections[sys.argv[1]](nvidia_smi())
        return 0
    smi = nvidia_smi()
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
        for D in pa.HEAD_DIMS:
            kernel_small_shapes(dev, gen, D)
            kernel_split_cases(dev, gen, D)
        flash_small_shapes(dev, gen)
        flash_groups_and_dims(dev, gen)
        kernel_f32(dev, gen)
        cfg = get_config("llama-3-8b")
        kern = kernel_main_shapes(dev, gen, cfg, page=64, Pmax=32, n_pages=321)
        kern["flash_self_attention"] = flash_main_shape(dev, gen, cfg)
        # the f32 entry points at the main-path shapes
        f32 = kernel_main_shapes(dev, gen, cfg, page=64, Pmax=32, n_pages=321,
                                 dtype=torch.float32)
        f32["flash_self_attention"] = flash_main_shape(dev, gen, cfg, torch.float32)
        torch.cuda.empty_cache()
        # the main-path shapes at the registry's other head dims, and at D 64
        # with llama-3-8b's 32 / 8 heads (no registry model has D 64)
        by_dim = {}
        d64 = dataclasses.replace(cfg, name="llama-3-8b heads at D 64", head_dim=64)
        for other in ("tiny-llama", "phi-3-mini", "gemma-7b", d64):
            ocfg = other if isinstance(other, type(cfg)) else get_config(other)
            other = ocfg.name
            res = kernel_main_shapes(dev, gen, ocfg, page=64, Pmax=32, n_pages=321)
            res["flash_self_attention"] = flash_main_shape(dev, gen, ocfg)
            heads = f"D {ocfg.head_dim}, Hq {ocfg.num_heads}, Hkv {ocfg.num_kv_heads}"
            by_dim[f"{other} ({heads})"] = res
            torch.cuda.empty_cache()
    log("info kernels at the other head dims, main-path shapes: " + json.dumps(by_dim))
    torch.cuda.empty_cache()

    card_memory("kernels")
    # training first, on a card no serving phase has used yet; outside
    # inference mode, which would keep autograd from saving tensors
    trained_pair_flash = training_phases(smi)
    launches = serving_phases(card, smi)
    launches["flash_self_attention"] += trained_pair_flash
    # the slice's main path: the paged kernels' launches from the HTTP storm
    # (flash is not on it; its count stays the phase-separated run's)
    http_launches = http_phase(smi)  # its numbers carry the card's name and power limit
    card_memory("http")
    observability_phase(smi)
    card_memory("observability")
    http_lockstep_phase(smi)
    card_memory("http lockstep")
    # ... and the speculative storm's (its k=4 run), each read just after it
    for name in ("ragged_paged_attention", "paged_decode_attention"):
        launches[name] = http_launches[name] + SPEC_LAUNCHES[name]
    boot_phase()
    # the worker hosts load the kernels built above (build/kernels/, keyed
    # by source hash): no host builds. The federated storm's launches are
    # counted in the hosts and read over their Health RPC
    fed_launches = federation_phase(smi)
    card_memory("federation")
    for name in ("ragged_paged_attention", "paged_decode_attention"):
        launches[name] += fed_launches[name]
    f32_launches = golden_phase(card)
    card_memory("golden")
    golden_quant_phase(card, smi)
    log(f"info [{card}] kernels f32 entry points, main-path shapes (bound: bytes at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s, operations at the f32 CUDA-core peak "
        f"{F32_FLOPS_PER_S / 1e12:.0f} TFLOP/s; library: SDPA in f32; launches: the golden "
        "f32 runs): " + json.dumps({name: {**f32[name], "launches": f32_launches[name]}
                                     for name in KERNELS}))

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
