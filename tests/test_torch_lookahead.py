"""The port's lookahead ring on the CPU: streams equal at every depth.

Mirrors of the JAX package's ring tests (``tests/test_scheduler_pipeline.py``
and ``tests/test_mixed_batch.py``) on the port's ContinuousBatchingEngine,
tiny-llama in f32 with random weights from a seed. The contract is the JAX
package's: the ring changes when device work runs, never what a request
receives, so greedy and seeded sampled streams are equal across depths 0
(synchronous), 1, 2 and 3 — also when chunks are discarded (their enqueued
draws are undone by putting the generators' states back). Each test also
checks that the ring was really used, so the equality cannot hold
vacuously."""

import threading
import time

import numpy as np
import pytest

from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine


def _cfg(**over):
    base = dict(model="tiny-llama", max_seq_len=256, max_batch=4, decode_chunk=4,
                dtype="float32", use_flash=False, prefix_cache_pages=80,
                prefix_page_size=16, prefill_budget_tokens=24)
    base.update(over)
    return EngineConfig(**base)


class _Collector:
    def __init__(self, n: int):
        self.tokens: dict[int, list[int]] = {i: [] for i in range(n)}
        self.finishes: dict[int, str] = {}
        self.done = threading.Event()
        self._lock = threading.Lock()
        self._n = n

    def emit_for(self, i: int):
        def emit(ev):
            with self._lock:
                self.tokens[i].append(ev.token_id)
                if ev.finished:
                    self.finishes[i] = ev.finished
                    if len(self.finishes) == self._n:
                        self.done.set()
        return emit


def _run_streams(cfg, prompts, samplings, stagger_s=0.0):
    engine = ContinuousBatchingEngine(cfg, seed=0, device="cpu")
    col = _Collector(len(prompts))
    try:
        for i, (p, s) in enumerate(zip(prompts, samplings)):
            if stagger_s:
                time.sleep(stagger_s)
            engine.submit(p, s, col.emit_for(i))
        assert col.done.wait(120), (col.finishes, engine.stats())
    finally:
        engine.shutdown()
    stats = engine.stats()  # read once the scheduler thread has stopped
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0
    return col, stats


@pytest.mark.parametrize("path", ["mixed", "phase_separated"])
def test_lookahead_streams_bit_identical_to_sync(path):
    """Mirror of test_scheduler_pipeline.py:67: the pipeline (ring at the
    default depth, budget, coalescing) against the synchronous scheduler,
    seeded sampling — identical streams, and the ring was used."""
    rng = np.random.default_rng(7)
    prompts = [rng.integers(3, 500, 10 + 5 * i).tolist() for i in range(6)]
    samplings = [SamplingParams(max_tokens=40, temperature=0.8, top_p=0.9, seed=1000 + i)
                 for i in range(6)]
    mixed = path == "mixed"
    pipe_col, pipe = _run_streams(_cfg(mixed_batch=mixed, decode_lookahead=True,
                                       prefill_budget_tokens=64, prefill_coalesce=4),
                                  prompts, samplings)
    sync_col, sync = _run_streams(_cfg(mixed_batch=mixed, decode_lookahead=False,
                                       prefill_budget_tokens=0, prefill_coalesce=1),
                                  prompts, samplings)
    assert pipe_col.tokens == sync_col.tokens, "pipelined streams diverged"
    assert pipe_col.finishes == sync_col.finishes
    assert pipe["pipeline"]["depth"] == 2 and sync["pipeline"]["depth"] == 0
    assert pipe["pipeline"]["lookahead"]["used"] > 0
    assert pipe["pipeline"]["overlap_ratio"] > 0
    assert sync["pipeline"]["lookahead_rounds"] == 0


def test_lookahead_discard_on_stop_token_stays_identical():
    """Mirror of test_scheduler_pipeline.py:92: a stop set wider than
    ``device_stop_width`` is matched on the host only, so a stop there
    discards the in-flight ring (after its chunks drew); streams still
    match the synchronous run."""
    rng = np.random.default_rng(3)
    prompts = [rng.integers(3, 500, 12).tolist() for _ in range(3)]
    samplings = [SamplingParams(max_tokens=60, temperature=0.9, seed=50 + i,
                                stop_token_ids=tuple(range(0, 40)))
                 for i in range(3)]
    pipe_col, pipe = _run_streams(_cfg(decode_lookahead=2), prompts, samplings)
    sync_col, _ = _run_streams(_cfg(decode_lookahead=0), prompts, samplings)
    assert pipe_col.tokens == sync_col.tokens
    assert pipe_col.finishes == sync_col.finishes
    assert "stop" in pipe_col.finishes.values()
    la = pipe["pipeline"]["lookahead"]
    assert la["used"] > 0 and la["discarded"] > 0, la


def test_deep_lookahead_streams_bit_identical_across_depths():
    """Mirror of test_scheduler_pipeline.py:167 with depth 2 added: depths
    0, 1, 2 and 3 give identical greedy and seeded sampled streams, and the
    deep run really ran deep (drain-time depth 2 or more)."""
    rng = np.random.default_rng(21)
    prompts = [rng.integers(3, 500, 10 + 5 * i).tolist() for i in range(6)]
    samplings = [SamplingParams(max_tokens=40, temperature=0.8 if i % 2 else 0.0,
                                top_p=0.9, seed=2000 + i) for i in range(6)]
    results = {d: _run_streams(_cfg(decode_lookahead=d, prefill_budget_tokens=64),
                               prompts, samplings) for d in (0, 1, 2, 3)}
    for d in (1, 2, 3):
        assert results[d][0].tokens == results[0][0].tokens, f"depth {d} diverged"
        assert results[d][0].finishes == results[0][0].finishes
        assert results[d][1]["pipeline"]["lookahead"]["used"] > 0
    deep = results[3][1]["pipeline"]
    assert deep["depth"] == 3
    assert max(int(d) for d in deep["depth_hist"]) >= 2, deep["depth_hist"]
    sync = results[0][1]["pipeline"]
    assert sync["lookahead_rounds"] == 0 and set(sync["depth_hist"]) <= {"0"}


def test_device_termination_keeps_ring_alive_through_finish():
    """Mirror of test_scheduler_pipeline.py:198: one request at depth 3. Its
    max-tokens finish is predicted on the device, so no chunk is discarded,
    and after the mixed round the ring chains off it: every later round is
    ring-served (rounds == mixed rounds + lookahead rounds)."""
    prompt = np.random.default_rng(4).integers(3, 500, 12).tolist()
    col, stats = _run_streams(_cfg(decode_lookahead=3), [prompt],
                              [SamplingParams(max_tokens=40, temperature=0.7, seed=9)])
    assert len(col.tokens[0]) == 40
    pipe = stats["pipeline"]
    assert pipe["lookahead"]["discarded"] == 0 and pipe["discard_ratio"] == 0.0, pipe
    assert pipe["lookahead"]["used"] > 0 and pipe["mixed_rounds"] >= 1
    assert pipe["rounds"] == pipe["mixed_rounds"] + pipe["lookahead_rounds"], pipe


def test_mixed_to_pure_decode_transition_bit_identical_seeded():
    """Mirror of test_scheduler_pipeline.py:222: seeded streams across the
    mixed → pure-decode transition, the ring chained off the mixed
    dispatch's flipped state (depth 3) against the synchronous path."""
    rng = np.random.default_rng(33)
    prompts = [rng.integers(3, 500, 20 + 7 * i).tolist() for i in range(4)]
    samplings = [SamplingParams(max_tokens=24, temperature=0.9, top_p=0.85, seed=500 + i)
                 for i in range(4)]
    span_col, span = _run_streams(_cfg(decode_lookahead=3, prefill_budget_tokens=16),
                                  prompts, samplings)
    sync_col, _ = _run_streams(_cfg(decode_lookahead=0, prefill_budget_tokens=16),
                               prompts, samplings)
    assert span_col.tokens == sync_col.tokens
    assert span_col.finishes == sync_col.finishes
    pipe = span["pipeline"]
    assert pipe["mixed_rounds"] >= 2 and pipe["lookahead"]["used"] > 0


def test_stop_finish_within_device_width_keeps_ring():
    """Mirror of test_scheduler_pipeline.py:245: a stop set that fits the
    device's stop row ends the stream on the device; the deep ring and the
    synchronous run agree on the tokens and the reason, and the stop
    discards nothing."""
    prompt = np.random.default_rng(6).integers(3, 500, 10).tolist()
    sampling = [SamplingParams(max_tokens=60, temperature=1.3, seed=77,
                               stop_token_ids=tuple(range(3, 9)))]
    deep_col, deep = _run_streams(_cfg(decode_lookahead=3), [prompt], sampling)
    sync_col, _ = _run_streams(_cfg(decode_lookahead=0), [prompt], sampling)
    assert deep_col.tokens == sync_col.tokens
    assert deep_col.finishes == sync_col.finishes
    assert deep["pipeline"]["lookahead"]["used"] > 0
    assert deep["pipeline"]["lookahead"]["discarded"] == 0


def test_mixed_lookahead_vs_sync_bit_identical_seeded():
    """Mirror of test_mixed_batch.py:103: staggered arrivals keep admitting
    into mixed rounds while the ring runs (each admission discards it);
    seeded streams equal the synchronous run's."""
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 500, 30 + 7 * i).tolist() for i in range(4)]
    samplings = [SamplingParams(max_tokens=40, temperature=0.8, top_p=0.9, seed=500 + i)
                 for i in range(4)]
    ahead_col, ahead = _run_streams(_cfg(decode_lookahead=True), prompts, samplings,
                                    stagger_s=0.01)
    sync_col, _ = _run_streams(_cfg(decode_lookahead=False), prompts, samplings,
                               stagger_s=0.01)
    assert ahead_col.tokens == sync_col.tokens
    assert ahead_col.finishes == sync_col.finishes
    assert ahead["pipeline"]["mixed_rounds"] >= 1
    assert ahead["pipeline"]["lookahead"]["used"] > 0
