"""The paged decode chunk as a function of static buffers, on the CPU.

On CUDA the engine captures :class:`PagedDecodeChunk`'s body as a CUDA graph
and replays it; on the CPU it calls the same body eagerly. These tests hold
that body to the chunk the engine dispatched before it existed: k eager
decode steps whose sampling slots drew one ``torch.rand(1)`` each per step
(``split_keys_per_slot``). Streams (greedy, seeded sampled, a stop id) are
equal token for token at lookahead depths 0 and 2, tiny-llama in f32 with
random weights from a seed. The card-only twin (graph replay against the
eager CUDA path) is in ``tests/test_torch_cuda_kernels.py``."""

import threading
from typing import Optional

import numpy as np
import pytest
import torch

from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.ops.sampling import split_keys_per_slot
from cyberfabric_core_tpu_torch.runtime import scheduler as sched
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.programs import PagedDecodeChunk


class _BeforeEngine(sched.ContinuousBatchingEngine):
    """The engine with the decode chunk it dispatched before the static-buffer
    program: every step enqueued inline, draws made inside the steps."""

    def _dispatch_chunk(self, after: Optional[sched._InflightChunk],
                        draw_mask: np.ndarray) -> sched._InflightChunk:
        k, cfg = self._k_steps, self.model_config
        self._flush_page_table()
        self._note_sharing()
        if after is None:
            toks, lens, fin, active = (self._last_dev, self._lengths_dev,
                                       self._finished_dev, self._active_dev)
        else:
            toks, lens, fin, active = (after.last, after.lengths_dev, after.finished_dev,
                                       after.active_dev)
        gens, all_greedy = self._sampling_rows(draw_mask)
        saved = [(g, g.get_state()) for g in gens if g is not None]
        emits = []
        for j in range(k):
            run = active & ~fin
            hidden, _ = llama.forward_paged_decode(
                self.params, cfg, toks[:, None], (self.pool.k_pool, self.pool.v_pool),
                self._page_table_dev, lens, self.rope_tables, write_mask=run)
            logits = llama.lm_head_logits(self.params, cfg, hidden[:, 0])
            nxt = self._sample(logits, gens, all_greedy)
            new_lens = lens + 1
            is_stop = (nxt[:, None] == self._stops_dev).any(dim=1)
            hit = new_lens >= self._limit_dev
            if j == k - 1:
                hit = hit | (new_lens + k > self.config.max_seq_len)
            emits.append(torch.where(run, nxt, torch.full_like(nxt, -1)))
            toks = torch.where(run, nxt, toks)
            lens = torch.where(run, new_lens, lens)
            fin = fin | (run & (is_stop | hit))
        chunk = torch.stack(emits, dim=1)
        host, ready = self._readback(chunk)
        return sched._InflightChunk(chunk, toks,
                                    torch.where(active, lens, torch.zeros_like(lens)),
                                    fin, active, self._epoch, host, ready, saved)


def _cfg(depth: int) -> EngineConfig:
    return EngineConfig(model="tiny-llama", max_seq_len=256, max_batch=4, decode_chunk=4,
                        dtype="float32", use_flash=False, prefix_cache_pages=80,
                        prefix_page_size=16, prefill_budget_tokens=24,
                        decode_lookahead=depth)


def _serve(engine_cls, depth: int, requests):
    engine = engine_cls(_cfg(depth), seed=0, device="cpu")
    toks = {i: [] for i in range(len(requests))}
    fins, done, lock = {}, threading.Event(), threading.Lock()

    def emit_for(i):
        def emit(ev):
            with lock:
                toks[i].append(ev.token_id)
                if ev.finished:
                    fins[i] = ev.finished
                    if len(fins) == len(requests):
                        done.set()
        return emit

    try:
        for i, (prompt, sp) in enumerate(requests):
            engine.submit(prompt, sp, emit_for(i))
        assert done.wait(120), engine.stats()
    finally:
        engine.shutdown()
    return toks, fins, engine.stats()


def _requests():
    rng = np.random.default_rng(5)
    prompts = [rng.integers(3, 500, n).tolist() for n in (5, 19, 40, 11, 30, 7)]
    sps = [SamplingParams(max_tokens=14),
           SamplingParams(max_tokens=17, temperature=0.9, seed=7),
           SamplingParams(max_tokens=12, temperature=0.7, top_k=20, seed=11),
           SamplingParams(max_tokens=15, temperature=1.1, top_p=0.8, seed=3),
           SamplingParams(max_tokens=13),
           SamplingParams(max_tokens=16, temperature=0.8)]
    return list(zip(prompts, sps))


@pytest.mark.parametrize("depth", [0, 2])
def test_static_buffer_chunk_gives_the_streams_of_the_eager_chunk(depth):
    requests = _requests()
    before, before_fins, _ = _serve(_BeforeEngine, depth, requests)
    # a stop id the greedy request 0 meets mid-stream, in both runs
    stop = before[0][6]
    requests[0] = (requests[0][0], SamplingParams(max_tokens=14, stop_token_ids=(stop,)))
    before, before_fins, _ = _serve(_BeforeEngine, depth, requests)
    now, now_fins, stats = _serve(sched.ContinuousBatchingEngine, depth, requests)
    assert now == before and now_fins == before_fins
    assert now_fins[0] == "stop"
    pipe = stats["pipeline"]
    assert pipe["decode_eager_chunks"] > 0 and not pipe["decode_graphs"]
    assert pipe["decode_graph_replays"] == 0
    if depth:
        assert pipe["lookahead_rounds"] > 0


def test_draws_are_each_slots_rand_calls_in_step_order():
    """The static [k, B] uniforms: slot i's column holds what k
    ``torch.rand(1)`` calls of its generator return, and the generator ends
    where those calls leave it; rows without a generator get 0."""
    prog = PagedDecodeChunk.__new__(PagedDecodeChunk)
    prog.k = 5
    prog.uniforms = torch.full((5, 3), 9.0)
    g0, g2 = torch.Generator(), torch.Generator()
    g0.manual_seed(1)
    g2.manual_seed(2)
    twin0, twin2 = torch.Generator(), torch.Generator()
    twin0.set_state(g0.get_state())
    twin2.set_state(g2.get_state())
    prog._draw([g0, None, g2])
    for col, twin, g in ((0, twin0, g0), (2, twin2, g2)):
        want = torch.cat([torch.rand(1, generator=twin) for _ in range(5)])
        assert torch.equal(prog.uniforms[:, col], want)
        assert torch.equal(g.get_state(), twin.get_state())
    assert bool((prog.uniforms[:, 1] == 0).all())
    # the per-step draws of the eager chunk give the same numbers
    twin0.manual_seed(1)
    steps = [split_keys_per_slot([twin0], [True], torch.device("cpu"))[0] for _ in range(5)]
    assert torch.equal(torch.stack(steps), prog.uniforms[:, 0])


def test_outputs_are_clones_of_the_static_buffers():
    engine = sched.ContinuousBatchingEngine(_cfg(0), seed=0, device="cpu")
    prog = engine._chunk
    n = engine.n_slots
    active = torch.tensor([True, False, True, False])
    out = prog(torch.tensor([3, 4, 5, 6], dtype=torch.int32),
               torch.tensor([2, 0, 9, 0], dtype=torch.int32),
               torch.zeros(n, dtype=torch.bool), active, [None] * n, True)
    for t, buf in zip(out, (prog.out_chunk, prog.out_last, prog.out_lengths,
                            prog.out_finished)):
        assert torch.equal(t, buf) and t.data_ptr() != buf.data_ptr()
    assert bool((out[0][~active] == -1).all()) and bool((out[2][~active] == 0).all())
    assert prog.eager_runs == 1 and prog.replays == 0


def test_graphs_need_a_cuda_device():
    engine = sched.ContinuousBatchingEngine(_cfg(0), seed=0, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        PagedDecodeChunk(engine.params, engine.model_config,
                         (engine.pool.k_pool, engine.pool.v_pool), engine._chunk.rows,
                         engine.rope_tables, engine.n_slots, 4, 256, graphs=True)
