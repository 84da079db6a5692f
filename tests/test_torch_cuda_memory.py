"""A stopped engine, or a closed replica pool, gives its card memory back.

Needs a CUDA card (the paged kernels and the decode graphs) and skips
without one. Run on the card with

    python -m pytest tests/test_torch_cuda_memory.py -m cuda --noconftest

A paged tiny-llama engine, built as the worker builds one (mixed rounds,
the lookahead ring, decode chunks captured as CUDA graphs), or a
data-parallel pool of two such replicas under a lifecycle manager, serves
two requests and is shut down (closed) and dropped, twice after a first
warm-up build. Dropping the last reference must free the KV pools, the
graphs and their private memory pools without a cycle collection: the
allocator reads its base again. The base is taken with PyTorch's cuBLAS
workspaces cleared, which it caches per handle and stream for the life of
the process, whatever frees an engine."""

import gc
import threading

import pytest
import torch

from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.lifecycle import LifecycleConfig
from cyberfabric_core_tpu_torch.runtime.replicas import DataParallelServingPool
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

pytestmark = pytest.mark.cuda

CFG = EngineConfig(model="tiny-llama", max_seq_len=256, max_batch=4, decode_chunk=4,
                   prefix_cache_pages=80, prefix_page_size=16, prefill_budget_tokens=24)


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the paged kernels have no CPU mode")
    return torch.device("cuda")


def _serve(target) -> None:
    done = [threading.Event() for _ in range(2)]
    for i, prompt in enumerate(([5, 9, 13] * 10, [7, 11] * 20)):
        target.submit(prompt, SamplingParams(max_tokens=24),
                      lambda ev, e=done[i]: ev.finished and e.set())
    assert all(e.wait(120) for e in done)


def _engine(params, dev) -> None:
    engine = ContinuousBatchingEngine(CFG, params=params, seed=0)
    try:
        _serve(engine)
    finally:
        engine.shutdown()
    assert engine.stats()["pipeline"]["decode_graph_replays"] > 0


def _pool(params, dev) -> None:
    pool = DataParallelServingPool(CFG, n_replicas=2, devices=[dev, dev], seed=0, params=params,
                                   lifecycle=LifecycleConfig(check_interval_s=0.05))
    try:
        _serve(pool)
    finally:
        pool.close()


def _allocated() -> int:
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


@pytest.mark.parametrize("build", [_engine, _pool], ids=["engine", "dp pool with lifecycle"])
def test_stopped_engine_returns_the_card_to_its_base(dev, build):
    params = llama.init_params(get_config("tiny-llama"), 0, torch.bfloat16, dev)
    build(params, dev)
    base = _allocated()
    gc.disable()
    try:
        for _ in range(2):
            build(params, dev)
            assert _allocated() == base
    finally:
        gc.enable()
