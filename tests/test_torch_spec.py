"""Speculative rounds in the port's ContinuousBatchingEngine, on the CPU.

Mirrors of ``tests/test_scheduler_spec.py`` as the port at
``scheduler_spec_k`` > 0 against the port at k=0, on both paged paths
(mixed and phase-separated), tiny-llama in f32 with random weights from a
seed. The contract is the JAX package's: speculation changes speed, never
text. Greedy streams at k > 0 equal those at k = 0 token for token and
finish for finish, stop and window finishes included; sampled rows never
speculate and keep their generator streams; a rejected draft's KV is
rewritten before anything reads it. Each identity is checked beside
evidence that drafts were proposed and accepted, so it cannot hold
vacuously. One greedy storm at k=4 equals the JAX engine's on the same
weights, and ``NgramProposer`` / ``greedy_accept_counts`` give JAX's
proposals and counts on the same sequences (hypothesis)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from cyberfabric_core_tpu.runtime import EngineConfig as JEngineConfig
from cyberfabric_core_tpu.runtime import SamplingParams as JSamplingParams
from cyberfabric_core_tpu.runtime import speculative as jspec
from cyberfabric_core_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime import speculative as spec
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

PATHS = {"mixed": {}, "phase_separated": {"mixed_batch": False}}
#: repetitive prompts: a tiled motif gives the proposer hits from the first
#: decode round
REP_PROMPTS = [[5, 6, 7, 8] * 4, [9, 10, 11] * 5, [3, 4] * 6]


def _cfg(path="mixed", **over):
    base = dict(model="tiny-llama", max_seq_len=256, max_batch=4, decode_chunk=4,
                dtype="float32", use_flash=False, prefix_cache_pages=80,
                prefix_page_size=16, prefill_budget_tokens=24)
    base.update(PATHS[path])
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
                if ev.token_id >= 0:
                    self.tokens[i].append(ev.token_id)
                if ev.finished:
                    self.finishes[i] = ev.finished
                    if len(self.finishes) == self._n:
                        self.done.set()
        return emit


def _check_pool(stats):
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0, stats
    assert stats["pages_free"] + stats["cached_pages"] == stats["pages_total"], stats


def _run_streams(cfg, prompts, samplings, engine_hook=None, params=None):
    engine = ContinuousBatchingEngine(cfg, params=params, seed=0, device="cpu")
    if engine_hook is not None:
        engine_hook(engine)
    col = _Collector(len(prompts))
    try:
        for i, (p, s) in enumerate(zip(prompts, samplings)):
            engine.submit(p, s, col.emit_for(i))
        assert col.done.wait(120), (col.finishes, engine.stats())
    finally:
        engine.shutdown()
    stats = engine.stats()  # read once the scheduler thread has stopped
    assert stats["broken"] is None
    _check_pool(stats)
    return col, stats


def _spies_on_spec_rounds(engine, seen: list):
    """Record, at each speculative dispatch, whether a sampled row is
    active in the batch beside the drafts."""
    orig = engine._spec_outputs

    def spy(*args, **kwargs):
        seen.append(any(st is not None and engine.active[i] and st.sampling.temperature > 0
                        for i, st in enumerate(engine.slots)))
        return orig(*args, **kwargs)

    engine._spec_outputs = spy


@pytest.mark.parametrize("path", list(PATHS))
def test_spec_fields_at_zero_equal_the_defaults(path):
    """Mirror of :81: explicit zeros take the default path, greedy and
    seeded sampled streams alike, and the engine reports no speculation."""
    samp = [SamplingParams(max_tokens=24),
            SamplingParams(max_tokens=24, temperature=0.9, seed=7),
            SamplingParams(max_tokens=24, temperature=0.7, top_p=0.9, seed=11)]
    base, base_stats = _run_streams(_cfg(path), REP_PROMPTS, samp)
    zero, zero_stats = _run_streams(_cfg(path, scheduler_spec_k=0, spec_min_accept=0.5),
                                    REP_PROMPTS, samp)
    assert base.tokens == zero.tokens and base.finishes == zero.finishes
    for stats in (base_stats, zero_stats):
        assert stats["speculative"]["k"] == 0 and stats["speculative"]["rounds"] == 0


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("k", [1, 4])
def test_greedy_spec_streams_equal_k0_with_real_acceptance(path, k):
    """Mirror of :98: greedy k>0 output equals k=0 output, beside evidence
    that speculation ran and accepted drafts."""
    samp = [SamplingParams(max_tokens=48)] * len(REP_PROMPTS)
    k0, _ = _run_streams(_cfg(path), REP_PROMPTS, samp)
    kn, stats = _run_streams(_cfg(path, scheduler_spec_k=k), REP_PROMPTS, samp)
    sp = stats["speculative"]
    assert kn.tokens == k0.tokens, f"spec_k={k} changed greedy text"
    assert kn.finishes == k0.finishes
    assert sp["rounds"] > 0 and sp["accepted"] > 0 and sp["emitted"] > 0, sp
    assert sum(sp["accept_hist"].values()) > 0
    assert max(int(a) for a in sp["accept_hist"]) <= k


@pytest.mark.parametrize("path", list(PATHS))
def test_stop_token_finish_equal_under_speculation(path):
    """Mirror of :117: a stop token inside an accepted span truncates the
    commit on the device where k=0 stops (synchronous ring, so speculation
    engages as soon as drafts appear)."""
    probe, _ = _run_streams(_cfg(path), [REP_PROMPTS[0]], [SamplingParams(max_tokens=64)])
    first: dict[int, int] = {}
    for i, t in enumerate(probe.tokens[0]):
        first.setdefault(t, i)
    stop_tok = max(first, key=first.get)
    samp = [SamplingParams(max_tokens=64, stop_token_ids=(stop_tok,))]
    k0, _ = _run_streams(_cfg(path), [REP_PROMPTS[0]], samp)
    kn, stats = _run_streams(_cfg(path, scheduler_spec_k=4, decode_lookahead=0),
                             [REP_PROMPTS[0]], samp)
    assert k0.finishes[0] == "stop"
    assert kn.tokens == k0.tokens and kn.finishes == k0.finishes
    assert stats["speculative"]["rounds"] > 0


@pytest.mark.parametrize("path", list(PATHS))
def test_seeded_sampling_rides_spec_rounds_unchanged(path):
    """Mirror of :143, made to bite: the greedy row speculates in rounds
    where the seeded sampled row is active beside it (asserted at the
    speculative dispatch), and both streams equal k=0's."""
    prompts = [[20, 21, 22] * 4, [5, 6, 7, 8] * 4]
    samp = [SamplingParams(max_tokens=30, temperature=0.8, seed=42),
            SamplingParams(max_tokens=48)]
    k0, _ = _run_streams(_cfg(path), prompts, samp)
    seen: list = []
    kn, stats = _run_streams(_cfg(path, scheduler_spec_k=4), prompts, samp,
                             engine_hook=lambda e: _spies_on_spec_rounds(e, seen))
    assert kn.tokens == k0.tokens and kn.finishes == k0.finishes
    assert stats["speculative"]["rounds"] > 0
    assert any(seen), "no speculative round ran beside the sampled row"


@pytest.mark.parametrize("path", list(PATHS))
def test_spec_composes_with_lookahead_ring_and_preemption(path):
    """Mirror of :158: speculation, a deep ring and a forced preempt /
    resume (the pool's chain growth fails once mid-stream): streams equal
    the synchronous k=0 run."""
    samp = [SamplingParams(max_tokens=40)] * len(REP_PROMPTS)
    k0, _ = _run_streams(_cfg(path, decode_lookahead=0), REP_PROMPTS, samp)

    def inject(engine):
        """Fail every chain growth once 12 tokens are out, until a
        preemption lands (a failed draft span or ring horizon only skips;
        the next chunk's growth preempts)."""
        orig = engine.pool.extend_chain

        def flaky(chain, needed):
            if engine.tokens_emitted >= 12 and engine.preemptions == 0:
                raise MemoryError("injected pool pressure")
            return orig(chain, needed)

        engine.pool.extend_chain = flaky

    kn, stats = _run_streams(_cfg(path, scheduler_spec_k=3, decode_lookahead=3),
                             REP_PROMPTS, samp, engine_hook=inject)
    assert kn.tokens == k0.tokens and kn.finishes == k0.finishes
    assert stats["speculative"]["rounds"] > 0
    assert stats["preemptions"] >= 1


@pytest.mark.parametrize("span", [8, 16])
def test_rejected_suffix_kv_never_commits(span):
    """Mirror of :182: garbage KV where a rejected suffix would lie (past the
    committed length), then the next span over those positions: its hidden
    states equal those of a pool that never saw the garbage (the span
    rewrites before it attends), for a span on the decode path (≤ 8) and
    one on the chunk path."""
    cfg = get_config("tiny-llama")
    params = llama.init_params(cfg, 0, torch.float32, "cpu")
    rope = rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta, device="cpu")
    page, n_pages = 8, 5
    shape = (cfg.num_layers, n_pages, page, cfg.num_kv_heads, cfg.head_dim)
    table = torch.tensor([[1, 2, 3, 0]], dtype=torch.int32)
    rng = np.random.default_rng(3)
    prompt = rng.integers(3, 200, 8).tolist()
    cont = rng.integers(3, 200, span).tolist()

    def run(poison: bool):
        pools = (torch.zeros(shape), torch.zeros(shape))
        llama.forward_paged_mixed(params, cfg, torch.tensor([prompt], dtype=torch.int32),
                                  pools, table, torch.tensor([0], dtype=torch.int32),
                                  torch.tensor([len(prompt)], dtype=torch.int32), rope)
        if poison:
            pools[0][:, 2:4] = 7.25
            pools[1][:, 2:4] = 7.25
        hidden, _ = llama.forward_paged_mixed(
            params, cfg, torch.tensor([cont], dtype=torch.int32), pools, table,
            torch.tensor([len(prompt)], dtype=torch.int32),
            torch.tensor([span], dtype=torch.int32), rope)
        return hidden[0, :span]

    assert torch.equal(run(poison=True), run(poison=False))


def _drive(engine, until, limit=400):
    """Run the scheduler's rounds on this thread until ``until()``."""
    for _ in range(limit):
        if until():
            return
        engine._service_cancellations()
        engine._admit()
        if engine.active.any() or engine._prefill_slots:
            engine._decode_round()
    raise AssertionError(f"not reached in {limit} rounds: {engine.stats()}")


@pytest.mark.parametrize("path", list(PATHS))
def test_round_composition_chunks_plus_spec_plus_decode(path):
    """Mirror of :236, driven round by round: while a long prompt is
    prefilled (chunk by chunk, mixed; in one dispatch, phase-separated), an
    in-flight greedy stream speculates and a sampled stream rides along; the
    greedy stream equals its solo k=0 run. Mixed: some round carried prompt
    chunks and draft spans both."""
    solo, _ = _run_streams(_cfg(path), [REP_PROMPTS[0]], [SamplingParams(max_tokens=60)])
    engine = ContinuousBatchingEngine(_cfg(path, scheduler_spec_k=4,
                                           prefill_budget_tokens=16), seed=0, device="cpu")
    engine.start = lambda: None  # this thread drives the rounds
    col = _Collector(3)
    engine.submit(REP_PROMPTS[0], SamplingParams(max_tokens=60), col.emit_for(0))
    _drive(engine, lambda: len(col.tokens[0]) >= 6)
    long_prompt = [int(t) for t in np.random.default_rng(9).integers(3, 200, 120)]
    engine.submit(long_prompt, SamplingParams(max_tokens=8), col.emit_for(1))
    engine.submit([13, 14, 15] * 4, SamplingParams(max_tokens=8, temperature=0.9, seed=5),
                  col.emit_for(2))
    _drive(engine, col.done.is_set)
    stats = engine.stats()
    sp = stats["speculative"]
    assert sp["rounds"] > 0
    if path == "mixed":
        assert sp["mixed_rounds"] >= 1, sp
        assert stats["prefill_chunks"] >= 2
    assert col.tokens[0] == solo.tokens[0] and col.finishes[0] == solo.finishes[0]
    assert len(col.tokens[1]) == 8 and len(col.tokens[2]) == 8
    _check_pool(stats)


@pytest.mark.parametrize("path", list(PATHS))
def test_spec_min_accept_gate_disables_hopeless_streams(path):
    """Mirror of :277: an impossible floor closes the gate after the
    probation window; streams still equal k=0's."""
    samp = [SamplingParams(max_tokens=60)] * 2
    k0, _ = _run_streams(_cfg(path), REP_PROMPTS[:2], samp)
    kn, stats = _run_streams(_cfg(path, scheduler_spec_k=2, spec_min_accept=1.01),
                             REP_PROMPTS[:2], samp)
    assert kn.tokens == k0.tokens and kn.finishes == k0.finishes
    sp = stats["speculative"]
    assert sp["rounds"] > 0 and sp["slots_disabled"] >= 1, sp


@pytest.mark.parametrize("path", list(PATHS))
def test_window_bound_streams_never_speculate(path):
    """Mirror of :293: a request whose max_tokens cannot fit the window
    keeps k=0's chunk-boundary 'length' finish and never speculates."""
    samp = [SamplingParams(max_tokens=200)]
    k0, _ = _run_streams(_cfg(path, max_seq_len=64), [[5, 6, 7, 8] * 3], samp)
    kn, stats = _run_streams(_cfg(path, max_seq_len=64, scheduler_spec_k=4),
                             [[5, 6, 7, 8] * 3], samp)
    assert kn.tokens == k0.tokens and kn.finishes == k0.finishes
    assert stats["speculative"]["rounds"] == 0


@pytest.mark.parametrize("path", list(PATHS))
def test_spec_stats_and_round_timings_surface(path):
    """Mirror of :308: the acceptance record and the rounds' spec tokens."""
    _, stats = _run_streams(_cfg(path, scheduler_spec_k=3), REP_PROMPTS[:2],
                            [SamplingParams(max_tokens=32)] * 2)
    sp = stats["speculative"]
    for key in ("k", "rounds", "mixed_rounds", "proposed", "accepted", "emitted",
                "accept_rate", "accept_hist", "slots_disabled"):
        assert key in sp, key
    assert sp["k"] == 3 and sp["proposed"] >= sp["accepted"] >= 0
    assert 0.0 <= sp["accept_rate"] <= 1.0
    spec_tokens = sum(t["spec_tokens"] for t in stats["round_timings"])
    assert spec_tokens == sp["proposed"] > 0
    # a round without prompt chunks verifies as a decode step (the decode
    # chunk's program, one step) and a ragged pass over the drafts
    pipe = stats["pipeline"]
    assert pipe["verify_step_eager_runs"] == sp["rounds"] - sp["mixed_rounds"] > 0
    assert pipe["verify_step_graph_replays"] == 0  # no graphs on the CPU


@pytest.mark.parametrize("path", list(PATHS))
@pytest.mark.parametrize("temp", [0.0, 0.8])
def test_sampled_requests_never_arm_a_proposer(path, temp):
    """Mirror of :357: only greedy, limit-bound requests arm a proposer."""
    armed: list = []

    def hook(engine):
        orig = engine._arm_spec

        def arm(state):
            orig(state)
            armed.append(state.proposer is not None)

        engine._arm_spec = arm

    _, stats = _run_streams(_cfg(path, scheduler_spec_k=4), [REP_PROMPTS[0]],
                            [SamplingParams(max_tokens=8, temperature=temp,
                                            seed=3 if temp else None)], engine_hook=hook)
    assert armed == [temp == 0.0]
    if temp:
        assert stats["speculative"]["rounds"] == 0


def test_dense_engine_disables_speculation():
    """As in JAX: speculation needs the paged scheduler; a dense engine
    logs and serves with k = 0."""
    engine = ContinuousBatchingEngine(_cfg(prefix_cache_pages=0, scheduler_spec_k=4),
                                      seed=0, device="cpu")
    assert engine.spec_k == 0 and engine.stats()["speculative"]["k"] == 0


# ------------------------------------------------------------- against JAX
def test_greedy_spec_storm_equals_the_jax_engine():
    """One storm at k=4 (mixed, ring depth 2) on the JAX engine and on the
    port over the same weights: the same greedy tokens and finishes, and
    both speculated."""
    rng = np.random.default_rng(5)
    prompts = REP_PROMPTS + [rng.integers(3, 500, 14).tolist()]
    max_tokens = [40, 33, 48, 24]
    opts = dict(model="tiny-llama", max_seq_len=256, max_batch=4, decode_chunk=4,
                use_flash=False, prefix_cache_pages=80, prefix_page_size=16,
                prefill_budget_tokens=64, scheduler_spec_k=4, dtype="float32")
    jengine = JEngine(JEngineConfig(**opts), seed=0)
    jcol = _Collector(len(prompts))
    try:
        for i, (p, m) in enumerate(zip(prompts, max_tokens)):
            jengine.submit(p, JSamplingParams(max_tokens=m), jcol.emit_for(i))
        assert jcol.done.wait(240), jengine.stats()
        jstats = jengine.stats()
        state = params_from_jax(jax.tree.map(np.asarray, jengine.params),
                                get_config("tiny-llama"))
    finally:
        jengine.shutdown()
    col, stats = _run_streams(EngineConfig(**opts), prompts,
                              [SamplingParams(max_tokens=m) for m in max_tokens],
                              params=state)
    assert col.tokens == jcol.tokens
    assert col.finishes == jcol.finishes
    assert stats["speculative"]["accepted"] > 0 and jstats["speculative"]["accepted"] > 0


def test_window_bound_stream_reaches_the_window_as_jax_does():
    """A stream that runs to the window: on the port, a finished row frozen
    at length == max_seq_len (a whole page table) made the next chained
    decode step index past the page table and failed the engine. Now it
    ends with 'length' where the JAX engine ends it, with the same tokens,
    at k=0 and k=4, the ring chained past the finish (depth 2)."""
    opts = dict(model="tiny-llama", max_seq_len=64, max_batch=4, decode_chunk=4,
                use_flash=False, prefix_cache_pages=80, prefix_page_size=16,
                prefill_budget_tokens=24, dtype="float32")
    prompt = [5, 6, 7, 8] * 3
    jengine = JEngine(JEngineConfig(**opts), seed=0)
    jcol = _Collector(1)
    try:
        jengine.submit(prompt, JSamplingParams(max_tokens=200), jcol.emit_for(0))
        assert jcol.done.wait(120), jengine.stats()
        state = params_from_jax(jax.tree.map(np.asarray, jengine.params),
                                get_config("tiny-llama"))
    finally:
        jengine.shutdown()
    assert jcol.finishes[0] == "length" and len(jcol.tokens[0]) < 200
    for k in (0, 4):
        col, _ = _run_streams(EngineConfig(**opts, scheduler_spec_k=k), [prompt],
                              [SamplingParams(max_tokens=200)], params=state)
        assert col.tokens == jcol.tokens and col.finishes == jcol.finishes


def test_accept_counts_match_host_accept_length():
    """Mirror of :338: the device accept and the host accept agree."""
    rng = np.random.default_rng(0)
    S = 5
    for _ in range(50):
        outs = rng.integers(0, 4, (1, S)).astype(np.int32)
        d = int(rng.integers(0, S))
        drafts = rng.integers(0, 4, (1, S - 1)).astype(np.int32)
        dev = int(spec.greedy_accept_counts(torch.from_numpy(outs), torch.from_numpy(drafts),
                                            torch.tensor([d], dtype=torch.int32))[0])
        assert dev == spec.accept_length(list(drafts[0][:d]), list(outs[0]))


@settings(max_examples=30, deadline=None)
@given(st.data())
def test_accept_counts_match_jax(data):
    """``greedy_accept_counts`` gives JAX's counts on the same rows."""
    # the verify widths k+1 of k = 4 and 7, four rows (one JAX program a shape)
    n = 4
    S = data.draw(st.sampled_from([5, 8]))
    outs = np.asarray(data.draw(st.lists(st.lists(st.integers(0, 3), min_size=S, max_size=S),
                                         min_size=n, max_size=n)), np.int32)
    drafts = np.asarray(data.draw(st.lists(st.lists(st.integers(0, 3), min_size=S - 1,
                                                    max_size=S - 1),
                                           min_size=n, max_size=n)), np.int32)
    lens = np.asarray(data.draw(st.lists(st.integers(0, S - 1), min_size=n, max_size=n)),
                      np.int32)
    want = np.asarray(jspec.greedy_accept_counts(jnp.asarray(outs), jnp.asarray(drafts),
                                                 jnp.asarray(lens)))
    got = spec.greedy_accept_counts(torch.from_numpy(outs), torch.from_numpy(drafts),
                                    torch.from_numpy(lens)).numpy()
    np.testing.assert_array_equal(got, want)


@settings(max_examples=80, deadline=None)
@given(tokens=st.lists(st.integers(0, 5), max_size=60),
       ngram=st.tuples(st.integers(1, 4), st.integers(0, 3)), k=st.integers(1, 8),
       cut=st.integers(0, 60))
def test_ngram_proposer_proposes_as_jax_does(tokens, ngram, k, cut):
    """The same proposals as JAX's NgramProposer after every extension,
    fed in two pieces (the index is incremental) and probed twice (the
    memo)."""
    min_n, extra = ngram
    max_n = min_n + extra
    mine = spec.NgramProposer(max_n, min_n, k)
    ref = jspec.NgramProposer(max_n, min_n, k)
    for piece in (tokens[:cut], tokens[cut:]):
        for tok in piece:
            mine.extend([tok])
            ref.extend([tok])
            assert mine.propose() == ref.propose()
            assert mine.propose() == ref.propose()
    with pytest.raises(ValueError):
        spec.NgramProposer(1, 2)
