"""The port's ContinuousBatchingEngine on the CPU against a JAX greedy reference.

The engine runs tiny-llama in f32 on ``device="cpu"`` (the kernels' plain
versions) with weights taken from the JAX package's ``init_params``, on each
of its paths: mixed (the default), phase-separated (``mixed_batch=False``,
with and without coalescing, flash prefill on and off) and dense
(``prefix_cache_pages=0``).
The reference decodes greedily with the JAX package's dense ``forward`` +
``lm_head_logits`` + argmax over the whole sequence. Greedy token streams
must be equal; finish reasons and page accounting must be exact."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

SEQ = 64  # reference width (every sequence here is shorter)


def _config(**kw):
    base = dict(model="tiny-llama", max_seq_len=128, max_batch=3, dtype="float32",
                decode_chunk=4, prefix_page_size=8, prefix_cache_pages=64,
                prefill_budget_tokens=24)
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_model():
    cfg = jget_config("tiny-llama")
    params = jllama.init_params(cfg, jax.random.PRNGKey(3), jnp.float32)
    rope = jrope(cfg.head_dim, cfg.max_position, cfg.rope_theta)

    @jax.jit
    def last_logits(ids, lengths):
        B = ids.shape[0]
        pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32), (B, SEQ))
        h, _ = jllama.forward(params, cfg, ids, pos,
                              jllama.init_cache(cfg, B, SEQ, jnp.float32),
                              jnp.zeros(B, jnp.int32), rope)
        return jllama.lm_head_logits(params, cfg,
                                     jllama.gather_last_hidden(h, lengths))

    return params, last_logits


def _greedy_reference(last_logits, prompts, n_tokens):
    """Greedy continuation of every prompt, all rows in one padded batch."""
    seqs = [list(p) for p in prompts]
    for _ in range(n_tokens):
        ids = np.zeros((len(seqs), SEQ), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        lengths = np.asarray([len(s) for s in seqs], np.int32)
        nxt = np.asarray(jnp.argmax(last_logits(jnp.asarray(ids),
                                                jnp.asarray(lengths)), -1))
        for i, s in enumerate(seqs):
            s.append(int(nxt[i]))
    return [s[len(p):] for s, p in zip(seqs, prompts)]


def _run(engine, requests, timeout=60.0):
    """Submit (prompt, SamplingParams) pairs from two threads; wait for every
    stream's terminal event. Returns [(tokens, finish_reasons)]."""
    out = [([], []) for _ in requests]
    done = threading.Event()
    left = [len(requests)]
    lock = threading.Lock()

    def emit_for(i):
        def emit(ev):
            toks, fins = out[i]
            toks.append(ev.token_id)
            fins.append(ev.finished)
            if ev.finished is not None:
                with lock:
                    left[0] -= 1
                    if left[0] == 0:
                        done.set()
        return emit

    def submit(idx):
        for i in idx:
            engine.submit(requests[i][0], requests[i][1], emit_for(i))

    threads = [threading.Thread(target=submit, args=(range(k, len(requests), 2),))
               for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout)
    assert done.wait(timeout), engine.stats()
    return out


PATHS = {
    "mixed": {},
    "phase_separated": dict(mixed_batch=False, prefill_coalesce=1, use_flash=False),
    "phase_separated_coalesce4_flash": dict(mixed_batch=False, prefill_coalesce=4,
                                            use_flash=True),
    "dense_flash": dict(prefix_cache_pages=0, use_flash=True),
    "dense": dict(prefix_cache_pages=0, use_flash=False),
}


def _jax_engine(jparams, **overrides):
    cfg = get_config("tiny-llama")
    return ContinuousBatchingEngine(
        _config(**overrides), params=params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
        device="cpu")


@pytest.mark.parametrize("path", list(PATHS))
def test_greedy_streams_match_jax_reference(jax_model, path):
    """Five prompts (chunks crossing pages and the 24-token round budget,
    more requests than slots) → the JAX greedy tokens, exactly, on every
    path; a stop id ends its stream with 'stop', the others end with
    'length'; no page is left held."""
    jparams, last_logits = jax_model
    rng = np.random.default_rng(0)
    lens = [5, 17, 30, 9, 40]
    prompts = [rng.integers(3, 512, n).tolist() for n in lens]
    ref = _greedy_reference(last_logits, prompts, 10)
    max_tokens = [10, 7, 10, 3, 9]
    stop_at = 2  # request 1 stops on its third reference token
    stop_id = ref[1][stop_at]
    assert stop_id not in ref[1][:stop_at]
    requests = [(p, SamplingParams(max_tokens=m)) for p, m in zip(prompts, max_tokens)]
    requests[1] = (prompts[1], SamplingParams(max_tokens=7, stop_token_ids=(stop_id,)))

    engine = _jax_engine(jparams, **PATHS[path])
    try:
        out = _run(engine, requests)
    finally:
        engine.shutdown()
    for i, (toks, fins) in enumerate(out):
        want = ref[i][:stop_at + 1] if i == 1 else ref[i][:max_tokens[i]]
        assert toks == want, (i, toks, want)
        assert fins[:-1] == [None] * (len(fins) - 1)
        assert fins[-1] == ("stop" if i == 1 else "length")
    stats = engine.stats()
    # the pool's conservation invariant (I1): nothing referenced or orphaned,
    # every page free or held by the prefix tree
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0
    assert stats["pages_free"] + stats["cached_pages"] == stats["pages_total"]
    assert stats["requests_completed"] == len(prompts)
    assert stats["rounds"]["decode"] > 0
    if path == "mixed":
        assert stats["rounds"]["mixed"] > 0
        assert stats["prefill_chunks"] > len(prompts)  # budget split some prompts
    else:
        assert stats["mode"] == ("dense" if path.startswith("dense") else "phase_separated")
        assert stats["use_flash"] == PATHS[path]["use_flash"]
        assert stats["rounds"]["mixed"] == 0 and stats["prefill_chunks"] == 0
        assert 0 < stats["prefill_dispatches"] <= len(prompts)
        assert stats["pages_total"] == (0 if path.startswith("dense") else 63)


def _run_queued(engine, requests):
    """Queue every request before the scheduler thread starts, so the first
    admission pass sees them all (deterministic coalescing)."""
    engine.start = lambda: None
    out = [([], []) for _ in requests]
    done, left = threading.Event(), [len(requests)]

    def emit_for(i):
        def emit(ev):
            out[i][0].append(ev.token_id)
            out[i][1].append(ev.finished)
            if ev.finished is not None:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        return emit

    for i, (prompt, sp) in enumerate(requests):
        engine.submit(prompt, sp, emit_for(i))
    del engine.start
    engine.start()
    try:
        assert done.wait(60), engine.stats()
    finally:
        engine.shutdown()
    return out


def test_phase_separated_coalesces_same_bucket_prompts(jax_model):
    """Four queued prompts, two per bucket (16 and 32), with an unbounded
    round budget: two batch_prefill dispatches of two rows each, and every
    stream still equals the JAX greedy reference."""
    jparams, last_logits = jax_model
    rng = np.random.default_rng(4)
    prompts = [rng.integers(3, 512, n).tolist() for n in (5, 17, 9, 30)]
    ref = _greedy_reference(last_logits, prompts, 5)
    engine = _jax_engine(jparams, mixed_batch=False, prefill_coalesce=4,
                         prefill_budget_tokens=0, max_batch=4, use_flash=True)
    out = _run_queued(engine, [(p, SamplingParams(max_tokens=5)) for p in prompts])
    assert [toks for toks, _ in out] == ref
    stats = engine.stats()
    assert stats["prefill_dispatches"] == 2 and stats["coalesced_prefills"] == 2
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0
    assert stats["pages_free"] + stats["cached_pages"] == stats["pages_total"]


def test_seeded_stream_is_the_same_mixed_or_phase_separated():
    """A seeded sampled request draws its first token from its own stream
    whichever path prefills it: alone in a mixed engine, and coalesced with
    a same-bucket sampled companion in a phase-separated one."""
    prompt = list(range(3, 14))
    seeded = SamplingParams(max_tokens=6, temperature=0.9, top_k=40, seed=99)
    mixed = ContinuousBatchingEngine(_config(), seed=5, device="cpu")
    alone = _run_queued(mixed, [(prompt, seeded)])[0][0]
    phase = ContinuousBatchingEngine(
        _config(mixed_batch=False, prefill_coalesce=4, prefill_budget_tokens=0),
        seed=5, device="cpu")
    crowded = _run_queued(phase, [(list(range(20, 32)),
                                   SamplingParams(max_tokens=4, temperature=1.0)),
                                  (prompt, seeded)])
    assert phase.stats()["coalesced_prefills"] == 1
    assert crowded[1][0] == alone and len(alone) == 6


def test_dense_mode_rejects_a_per_request_seed():
    engine = ContinuousBatchingEngine(_config(prefix_cache_pages=0), device="cpu")
    with pytest.raises(ValueError, match="shares one sampling stream"):
        engine.submit([3, 4, 5], SamplingParams(temperature=0.7, seed=1), lambda ev: None)
    engine.shutdown()


def test_default_engine_config_serves_dense_on_cpu():
    """``EngineConfig()`` as it is (tiny-llama, bf16, dense mode): it builds
    and serves a greedy and a sampled request to their lengths."""
    engine = ContinuousBatchingEngine(EngineConfig(), device="cpu")
    assert engine.stats()["mode"] == "dense" and not engine.use_flash
    out = _run_queued(engine, [([5, 6, 7, 8], SamplingParams(max_tokens=5)),
                               ([9, 10], SamplingParams(max_tokens=3, temperature=0.8))])
    assert [len(t) for t, _ in out] == [5, 3]
    assert [f[-1] for _, f in out] == ["length", "length"]


def test_seeded_sampling_is_reproducible_whatever_the_batch():
    """A seeded request's tokens do not depend on its batch companions."""
    prompt = list(range(3, 14))
    seeded = SamplingParams(max_tokens=6, temperature=0.9, top_k=40, seed=1234)

    def stream(companions):
        engine = ContinuousBatchingEngine(_config(), seed=5, device="cpu")
        try:
            out = _run(engine, [(prompt, seeded)] + companions)
        finally:
            engine.shutdown()
        return out[0][0]

    alone = stream([])
    crowded = stream([(list(range(20, 45)), SamplingParams(max_tokens=8)),
                      (list(range(50, 57)), SamplingParams(max_tokens=5,
                                                           temperature=1.0))])
    assert alone == crowded and len(alone) == 6


def test_engine_defaults_to_cuda_and_raises_without_it():
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ContinuousBatchingEngine(_config())


@pytest.mark.parametrize("override", [dict(quantization="int8"),
                                      dict(quantization="int4"), dict(tp=2),
                                      dict(pd_role="prefill")])
def test_path_changing_options_name_their_later_slice(override):
    """Every one of these options is served now. Quantization and the PD
    roles since ROADMAP items 5 and 6: the engine draws its weights at the
    config's bit width, and a prefill-role engine hands each stream to its
    sink after the first token (here the sink keeps it). tp > 1 since item
    9: a pinned device refuses it, as in JAX, and on two CPU ranks its
    tokens are the tp=1 engine's."""
    if "tp" in override:
        with pytest.raises(ValueError, match="pinned device"):
            ContinuousBatchingEngine(_config(**override), device="cpu")
        request = (list(range(5, 17)), SamplingParams(max_tokens=6))
        runs = []
        for engine in (ContinuousBatchingEngine(_config(**override), rank_devices=["cpu"] * 2),
                       ContinuousBatchingEngine(_config(), device="cpu")):
            try:
                runs.append(_run(engine, [request]))
            finally:
                engine.shutdown()
        assert runs[0] == runs[1] and len(runs[0][0][0]) == 6
        return
    from cyberfabric_core_tpu_torch.runtime.quant import QuantWeight

    engine = ContinuousBatchingEngine(_config(**override), device="cpu")
    request = (list(range(5, 17)), SamplingParams(max_tokens=6))
    try:
        if "quantization" in override:
            (toks, fins), = _run(engine, [request])
            wq = engine.params.layers[0].wq
            assert isinstance(wq, QuantWeight)
            assert wq.bits == int(override["quantization"][-1])
            assert len(toks) == 6 and fins[-1] == "length"
            return
        handed, events = [], []
        got = threading.Event()
        engine._handoff_sink = lambda rec: (handed.append(rec), got.set())
        engine.submit(*request, events.append)
        assert got.wait(60)
    finally:
        engine.shutdown()
    assert engine.pd_role == "prefill" and len(events) == 1 and events[0].finished is None
    assert len(handed) == 1 and handed[0].handoff and handed[0].length == 12
    assert handed[0].last_token == events[0].token_id
    assert engine.stats()["rounds"]["decode"] == 0 and engine.in_flight() == 0


@pytest.mark.parametrize("T", [5, 8, 21])
def test_pool_admit_slot_places_prompt_kv_in_fresh_pages(T):
    """A phase-separated prefill's collected KV lands in ceil(T/page) fresh
    pages in order (full pages, then the tail), the prefill bucket padded
    where it is shorter than the pages; release returns the private tail
    page and leaves the full pages cached in the prefix tree."""
    from cyberfabric_core_tpu_torch.runtime.paged import PrefixKVPool

    cfg = get_config("tiny-llama")
    pool = PrefixKVPool(cfg, num_pages=9, page_size=8, dtype=torch.float32,
                        device=torch.device("cpu"))
    bucket = max(16, T)
    shape = (cfg.num_layers, 1, bucket, cfg.num_kv_heads, cfg.head_dim)
    g = torch.Generator().manual_seed(T)
    kv = (torch.randn(shape, generator=g), torch.randn(shape, generator=g))
    chain = pool.admit_slot(list(range(T)), [], kv)
    assert len(chain) == -(-T // 8) and 0 not in chain and len(set(chain)) == len(chain)
    for pool_t, new in ((pool.k_pool, kv[0]), (pool.v_pool, kv[1])):
        placed = pool_t[:, chain].reshape(cfg.num_layers, -1, cfg.num_kv_heads,
                                          cfg.head_dim)
        assert torch.equal(placed[:, :T], new[:, 0, :T])
    assert pool.stats()["pages_in_use"] == pool.stats()["pages_referenced"] == len(chain)
    pool.release_slot(chain)
    stats = pool.stats()
    assert stats["pages_referenced"] == 0 and stats["cached_pages"] == T // 8
    assert stats["pages_free"] + stats["cached_pages"] == stats["pages_total"]
