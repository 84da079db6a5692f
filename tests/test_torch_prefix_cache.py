"""The port's radix prefix reuse on the CPU, held against the JAX package.

- ``runtime/native.py`` ``PrefixCache`` against the JAX package's Python
  ``PrefixCache`` over seeded random operation sequences: every result equal.
- ``runtime/paged.py`` ``PrefixKVPool`` under the six invariants of
  ``tests/test_model_check_pool.py`` (every operation sequence to a depth
  bound, then seeded random walks), on real CPU tensors, plus a seventh: a
  live chain's pages hold its prompt's KV.
- the serving paths (mixed and phase-separated) with prefix hits: greedy
  streams equal to the port's cold (dense) streams and to a JAX greedy
  reference; hit counts, saved tokens, suffix-only chunking, pins released.
- :func:`runtime.scheduler.suffix_prefill` against the JAX ``llama.forward``
  over the same gathered cache, rtol = atol = 1e-4.

tiny-llama in f32, weights from the JAX package's ``init_params``."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu.runtime.native import PrefixCache as JPrefixCache
from cyberfabric_core_tpu_torch.models import llama as tllama
from cyberfabric_core_tpu_torch.models.configs import ModelConfig, get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.native import PrefixCache
from cyberfabric_core_tpu_torch.runtime.paged import PrefixKVPool
from cyberfabric_core_tpu_torch.runtime.scheduler import (ContinuousBatchingEngine,
                                                          suffix_prefill)
from cyberfabric_core_tpu_torch.runtime.weights import (model_from_state_dict,
                                                        params_from_jax)

TOL = dict(rtol=1e-4, atol=1e-4)
SEQ = 96  # the JAX reference's width


# ---------------------------------------------------------------- PrefixCache
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_prefix_cache_matches_jax_python_cache(seed):
    """Seeded random match / release / insert / insert_tracked / evict /
    stats sequences over prompts that share, fork and cut prefixes at page
    and sub-page boundaries: the port's tree answers every call as the JAX
    package's Python tree does."""
    rng = np.random.default_rng(seed)
    page = 3
    ours, theirs = PrefixCache(page), JPrefixCache(page, force_python=True)
    heads = [rng.integers(0, 4, 12).tolist() for _ in range(3)]
    next_page = [100]

    def prompt():
        head = heads[rng.integers(len(heads))]
        return head[: rng.integers(0, 13)] + rng.integers(0, 4, rng.integers(0, 7)).tolist()

    for step in range(400):
        op = rng.integers(6)
        if op in (0, 1):
            toks = prompt()
            got = (ours.match(toks), theirs.match(toks))
            if op == 1:  # release what was just pinned
                ours.release(toks)
                theirs.release(toks)
        elif op == 2:
            toks = prompt()
            ours.release(toks)
            theirs.release(toks)
            got = (None, None)
        elif op in (3, 4):
            toks = prompt()
            n = int(rng.integers(0, len(toks) // page + 2))
            pages = list(range(next_page[0], next_page[0] + n))
            next_page[0] += n
            got = ((ours.insert(toks, pages), theirs.insert(toks, pages)) if op == 3
                   else (ours.insert_tracked(toks, pages), theirs.insert_tracked(toks, pages)))
        else:
            n = int(rng.integers(1, 5))
            got = (ours.evict(n), theirs.evict(n))
        assert got[0] == got[1], (step, op, got)
        assert ours.stats() == theirs.stats(), step


# ---------------------------------------------------------------- pool protocol
PAGE = 2
POOL_PAGES = 5  # capacity 4 (page 0 is scratch): eviction pressure is real
TINY = ModelConfig(
    name="mc-tiny", architecture="llama", vocab_size=32, hidden_size=4,
    intermediate_size=8, num_layers=1, num_heads=1, num_kv_heads=1,
    head_dim=2, max_position=32, rope_theta=10000.0)
#: p0/p1 share 2 full pages; p2 is disjoint; p0 has a partial tail page
PROMPTS = {"p0": [1, 2, 3, 4, 5], "p1": [1, 2, 3, 4, 9, 10], "p2": [7, 8, 6]}


def _prompt_kv(prompt: list[int]) -> tuple[torch.Tensor, torch.Tensor]:
    """A prefill's collected KV [1, 1, T', 1, 2] over an 8-position bucket:
    position i of token t holds (t*100 + i, -(t*100 + i)), padding -1."""
    k = torch.full((1, 1, 8, 1, 2), -1.0)
    for i, t in enumerate(prompt):
        k[0, 0, i, 0] = t * 100 + i
    k[..., 1] *= -1
    return k, -k


class Model:
    """One machine state: the real pool on CPU tensors + the scheduler's
    records the invariants refer to (live chains with their prompts,
    suspended chains with their saved KV)."""

    MAX_SLOTS = 2
    MAX_SUSPENDED = 1

    def __init__(self) -> None:
        self.pool = PrefixKVPool(TINY, num_pages=POOL_PAGES, page_size=PAGE,
                                 dtype=torch.float32, device=torch.device("cpu"))
        self.slots: dict[int, tuple[list[int], list[int]]] = {}
        self.suspended: list[tuple[list[int], tuple]] = []
        self._next_slot = 0

    def ops(self) -> list[tuple]:
        out: list[tuple] = []
        if len(self.slots) < self.MAX_SLOTS:
            out += [("admit", name) for name in PROMPTS]
        for sid in self.slots:
            out += [("complete", sid), ("extend", sid)]
            if len(self.suspended) < self.MAX_SUSPENDED:
                out.append(("preempt", sid))
        if self.suspended and len(self.slots) < self.MAX_SLOTS:
            out.append(("resume",))
        return out

    def apply(self, op: tuple) -> None:
        kind, pool = op[0], self.pool
        if kind == "admit":
            prompt = PROMPTS[op[1]]
            cached, _ = pool.match_prefix(prompt)
            try:
                chain = pool.admit_slot(prompt, cached, _prompt_kv(prompt))
            except MemoryError:
                return  # full even after eviction: the request stays queued
            finally:
                pool.release(prompt)
            self.slots[self._next_slot] = (chain, prompt)
            self._next_slot += 1
        elif kind == "complete":
            pool.release_slot(self.slots.pop(op[1])[0])
        elif kind == "extend":
            chain = self.slots[op[1]][0]
            try:
                pool.extend_chain(chain, (len(chain) + 1) * PAGE)
            except MemoryError:
                pass  # growth denied: the scheduler would cap or preempt
        elif kind == "preempt":
            chain, prompt = self.slots.pop(op[1])
            host = pool.save_chain_to_host(chain)
            pool.release_slot(chain)
            self.suspended.append((prompt, host))
        elif kind == "resume":
            prompt, host = self.suspended[0]
            try:
                chain = pool.restore_chain_from_host(host)
            except MemoryError:
                return  # still no room: stays suspended
            self.suspended.pop(0)
            self.slots[self._next_slot] = (chain, prompt)
            self._next_slot += 1
        else:  # pragma: no cover
            raise AssertionError(op)

    def audit(self, trace: tuple) -> None:
        pool = self.pool
        tracked = set(pool._tree_owned) | set(pool._orphans) | set(pool._refs)
        free = pool.allocator.num_free
        ctx = f"trace={trace} tracked={sorted(tracked)} free={free}"
        assert pool.capacity_pages - free == len(tracked), f"I1 {ctx}"
        assert not (pool._orphans & pool._tree_owned), f"I2 {ctx}"
        for p in pool._orphans:
            assert pool._refs.get(p, 0) >= 1, f"I2 orphan unref'd {p} {ctx}"
        for p, c in pool._refs.items():
            assert c >= 1, f"I3 refs[{p}]={c} {ctx}"
        for sid, (chain, prompt) in self.slots.items():
            assert len(set(chain)) == len(chain), f"I5 dup in {chain} {ctx}"
            for p in chain:
                assert pool._refs.get(p, 0) >= 1, f"I4 slot {sid} page {p} unref'd {ctx}"
            # I7: the chain's pages hold its prompt's KV
            held = pool.k_pool[0, chain].reshape(-1, 2)[: len(prompt), 0]
            want = torch.tensor([t * 100 + i for i, t in enumerate(prompt)],
                                dtype=torch.float32)
            assert torch.equal(held, want), f"I7 slot {sid} {held} {ctx}"
        for prompt in PROMPTS.values():
            with pool._tree_lock:
                pages = pool.tree.match(prompt)
                pool.tree.release(prompt)
            for p in pages:
                assert p in tracked, f"I6 match returned free page {p} {ctx}"


def _replay(trace: tuple) -> Model:
    m = Model()
    for op in trace:
        m.apply(op)
    return m


def test_pool_invariants_exhaustive_to_depth_bound():
    """Every operation sequence to depth 5, the invariants audited after
    each step: within the bound, a proof over the port's allocator, tree,
    reference counts and movers on real tensors."""
    frontier: list[tuple] = [()]
    states = 0
    for _ in range(5):
        nxt: list[tuple] = []
        for trace in frontier:
            for op in _replay(trace).ops():
                m = _replay(trace)
                m.apply(op)
                m.audit(trace + (op,))
                states += 1
                nxt.append(trace + (op,))
        frontier = nxt
    assert states > 3000, states


def test_pool_invariants_on_random_walks():
    """Seeded walks far past the exhaustive depth, audited at every step;
    then every slot completes and only the tree holds pages."""
    rng = np.random.default_rng(1234)
    for _ in range(12):
        m = Model()
        trace: tuple = ()
        for _ in range(50):
            ops = m.ops()
            op = ops[rng.integers(len(ops))]
            trace += (op,)
            m.apply(op)
            m.audit(trace[-6:])
        for sid in list(m.slots):
            m.apply(("complete", sid))
        m.audit(trace[-6:] + (("drain",),))
        assert not m.pool._refs and not m.pool._orphans
        assert m.pool.capacity_pages - m.pool.allocator.num_free == len(m.pool._tree_owned)


# ---------------------------------------------------------------- serving paths
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
        return jllama.lm_head_logits(params, cfg, jllama.gather_last_hidden(h, lengths))

    tparams = params_from_jax(jax.tree.map(np.asarray, params), get_config("tiny-llama"))
    return params, tparams, last_logits


def _greedy_reference(last_logits, prompts, n_tokens):
    seqs = [list(p) for p in prompts]
    for _ in range(n_tokens):
        ids = np.zeros((len(seqs), SEQ), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        lengths = np.asarray([len(s) for s in seqs], np.int32)
        nxt = np.asarray(jnp.argmax(last_logits(jnp.asarray(ids), jnp.asarray(lengths)), -1))
        for i, s in enumerate(seqs):
            s.append(int(nxt[i]))
    return [s[len(p):] for s, p in zip(seqs, prompts)]


def _engine(tparams, **kw):
    base = dict(model="tiny-llama", max_seq_len=SEQ, max_batch=2, decode_chunk=4,
                dtype="float32", prefix_cache_pages=32, prefix_page_size=4,
                prefill_budget_tokens=24, use_flash=False)
    base.update(kw)
    return ContinuousBatchingEngine(EngineConfig(**base), params=tparams, device="cpu")


def run_request(engine, prompt, sampling, timeout=60.0):
    done, tokens, finish = threading.Event(), [], []

    def emit(ev):
        tokens.append(ev.token_id)
        if ev.finished:
            finish.append(ev.finished)
            done.set()

    engine.submit(prompt, sampling, emit)
    assert done.wait(timeout), engine.stats()
    return tokens, finish[0]


PATHS = {"mixed": {}, "phase_separated": dict(mixed_batch=False, prefill_coalesce=4)}


def _conserved(stats) -> None:
    """Invariant I1 from the engine's view: nothing referenced or orphaned,
    every page free or in the tree."""
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0, stats
    assert stats["pages_free"] + stats["cached_pages"] == stats["pages_total"], stats


@pytest.mark.parametrize("path", list(PATHS))
def test_prefix_reuse_matches_cold_path(jax_model, path):
    """Mirror of tests/test_prefix_cache.py:46 on both paged paths: four
    queries behind a 20-token system prompt (5 full pages of 4), one after
    another. Requests 2..4 hit the prefix; every greedy stream equals the
    port's dense (cold) stream and the JAX greedy reference."""
    _, tparams, last_logits = jax_model
    system = list(range(10, 30))
    queries = [system + [40 + i] for i in range(4)]
    sampling = SamplingParams(max_tokens=6)
    cached, plain = _engine(tparams, **PATHS[path]), _engine(tparams, prefix_cache_pages=0)
    try:
        got = [run_request(cached, q, sampling) for q in queries]
        cold = [run_request(plain, q, sampling) for q in queries]
    finally:
        cached.shutdown()
        plain.shutdown()
    stats = cached.stats()
    ref = _greedy_reference(last_logits, queries, 6)
    assert got == cold, "prefix-cached streams diverge from the cold path"
    assert [toks for toks, _ in got] == ref
    pc = stats["prefix_cache"]
    assert pc["hits"] >= 3 and pc["prefill_tokens_saved"] >= 3 * 20, pc
    assert pc["cached_pages"] > 0
    if path == "mixed":  # only the suffix of each hit was chunk-prefilled
        assert stats["chunked_prefill_tokens"] == 21 + 3 * (21 - 20)
    else:
        assert stats["suffix_prefills"] == 3
    _conserved(stats)


@pytest.mark.parametrize("path", list(PATHS))
def test_prefix_pool_eviction_under_pressure(jax_model, path):
    """Mirror of tests/test_prefix_cache.py:63: distinct 16-token prompts
    flood the 48-page pool until the tree evicts; a prompt behind an
    earlier cached head is still served exactly (JAX greedy reference)."""
    _, tparams, last_logits = jax_model
    engine = _engine(tparams, **PATHS[path])
    try:
        for i in range(16):
            run_request(engine, [100 + i] * 16, SamplingParams(max_tokens=2))
        evicted = engine.stats()["prefix_cache"]["evicted"]
        probe = [115] * 16 + [7]
        toks, fin = run_request(engine, probe, SamplingParams(max_tokens=4))
    finally:
        engine.shutdown()
    stats = engine.stats()
    assert evicted > 0, stats["prefix_cache"]
    assert toks == _greedy_reference(last_logits, [probe], 4)[0] and fin == "length"
    assert stats["prefix_cache"]["hits"] >= 1
    _conserved(stats)


def test_prefix_hit_chunks_only_the_suffix(jax_model):
    """Mirror of tests/test_mixed_batch.py:208: a second request behind a
    64-token head (4 pages of 16) chunk-prefills only its suffix once the
    first has finished (the first's pages reach the tree at its final
    chunk), its chain shares the head's pages, and both streams equal the
    JAX greedy reference."""
    _, tparams, last_logits = jax_model
    rng = np.random.default_rng(13)
    head = rng.integers(3, 500, 64).tolist()
    p1 = head + rng.integers(3, 500, 10).tolist()
    p2 = head + rng.integers(3, 500, 12).tolist()
    engine = _engine(tparams, max_seq_len=128, prefix_page_size=16,
                     prefix_cache_pages=40, prefill_budget_tokens=32)
    try:
        out1 = run_request(engine, p1, SamplingParams(max_tokens=8))
        out2 = run_request(engine, p2, SamplingParams(max_tokens=8))
    finally:
        engine.shutdown()
    stats = engine.stats()
    pc = stats["prefix_cache"]
    assert pc["prefill_tokens_saved"] >= 64 and pc["hits"] >= 1 and pc["lookups"] >= 2
    assert 0.0 < pc["hit_rate"] < 1.0
    assert stats["chunked_prefill_tokens"] <= len(p1) + (len(p2) - 64)
    ref = _greedy_reference(last_logits, [p1, p2], 8)
    assert [out1[0], out2[0]] == ref
    _conserved(stats)


def test_concurrent_hits_share_the_head_pages(jax_model):
    """Two requests behind a cached head, decoding together: their chains
    share the head's pages while both are live (counted on the scheduler
    thread at each dispatch), and both streams equal the JAX reference."""
    _, tparams, last_logits = jax_model
    head = list(range(60, 80))  # 5 full pages of 4
    engine = _engine(tparams)
    try:
        run_request(engine, head + [89], SamplingParams(max_tokens=2))
        outs = [([], threading.Event()) for _ in range(2)]
        for i, (toks, done) in enumerate(outs):
            def emit(ev, toks=toks, done=done):
                toks.append(ev.token_id)
                if ev.finished:
                    done.set()
            engine.submit(head + [90 + i], SamplingParams(max_tokens=12), emit)
        assert all(done.wait(60) for _, done in outs)
    finally:
        engine.shutdown()
    stats = engine.stats()
    assert stats["max_shared_chain_pages"] >= 5, stats
    ref = _greedy_reference(last_logits, [head + [90], head + [91]], 12)
    assert [toks for toks, _ in outs] == ref
    _conserved(stats)


def test_fully_cached_prompt_admission_releases_radix_pins(jax_model):
    """Mirror of tests/test_mixed_batch.py:242: a prompt of exactly one
    cached page matches (and pins) it, the match is trimmed to empty, and
    admission must still release the pin: with every stream finished, a
    full evict recovers every cached page."""
    _, tparams, _ = jax_model
    prompt = np.random.default_rng(11).integers(3, 500, 16).tolist()
    engine = _engine(tparams, max_seq_len=128, prefix_page_size=16, prefix_cache_pages=40)
    try:
        for _ in range(2):  # the second run is the fully cached admission
            run_request(engine, prompt, SamplingParams(max_tokens=4))
        pool = engine.pool
        cached = pool.stats()["cached_pages"]
        assert cached >= 1, "the prompt's page never reached the tree"
        with pool._tree_lock:
            freed = pool.tree.evict(cached)
    finally:
        engine.shutdown()
    assert len(freed) == cached, f"unevictable pages: freed {len(freed)}/{cached}"


def test_suffix_prefill_matches_jax_forward_over_gathered_cache(jax_model):
    """The phase-separated hit program: cached pages gathered into a fresh
    cache, the suffix prefilled at positions cached_len.. with plain
    attention over that history. Logits and the written cache against the
    JAX ``llama.forward`` + ``lm_head_logits`` over the same cache."""
    jparams, tparams_sd, _ = jax_model
    cfg, jcfg = get_config("tiny-llama"), jget_config("tiny-llama")
    tparams = model_from_state_dict(tparams_sd, cfg, device="cpu")
    page, cached_pages, bucket, suf_bucket = 4, [5, 2, 7], 32, 16
    rng = np.random.default_rng(5)
    pool = PrefixKVPool(cfg, num_pages=9, page_size=page, dtype=torch.float32,
                        device=torch.device("cpu"))
    pool.k_pool.copy_(torch.from_numpy(rng.standard_normal(pool.k_pool.shape, np.float32)))
    pool.v_pool.copy_(torch.from_numpy(rng.standard_normal(pool.v_pool.shape, np.float32)))
    cache = tllama.init_cache(cfg, 1, bucket, torch.float32, device="cpu")
    cache = pool.gather_for_prefill(cached_pages, bucket, cache)
    cached_len = len(cached_pages) * page
    for c, p in zip(cache, (pool.k_pool, pool.v_pool)):
        want = p[:, cached_pages].reshape(cfg.num_layers, cached_len, *p.shape[3:])
        assert torch.equal(c[:, 0, :cached_len], want)
        assert not c[:, 0, cached_len:].any()
    suffix = rng.integers(3, 500, 11)
    ids = np.zeros((1, suf_bucket), np.int32)
    ids[0, :11] = suffix
    jcache = tuple(jnp.asarray(c.numpy()) for c in cache)
    pos = cached_len + np.arange(suf_bucket, dtype=np.int32)[None]
    jh, jkv = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos), jcache,
                             jnp.full((1,), cached_len, jnp.int32),
                             jrope(cfg.head_dim, cfg.max_position, cfg.rope_theta))
    jlogits = jllama.lm_head_logits(jparams, jcfg,
                                    jllama.gather_last_hidden(jh, jnp.asarray([11])))
    logits, kv = suffix_prefill(tparams, cfg, torch.from_numpy(ids),
                                torch.tensor([11], dtype=torch.int32), cached_len, cache,
                                rope_frequencies(cfg.head_dim, cfg.max_position,
                                                 cfg.rope_theta, device="cpu"))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for ours, theirs in zip(kv, jkv):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), **TOL)


def test_pool_host_copies_round_trip():
    """save_chain_to_host / restore_chain_from_host and export / import move
    a chain's pages exactly; export releases the chain (tree pages stay)."""
    cfg = get_config("tiny-llama")
    pool = PrefixKVPool(cfg, num_pages=12, page_size=4, dtype=torch.float32,
                        device=torch.device("cpu"))
    g = torch.Generator().manual_seed(0)
    shape = (cfg.num_layers, 1, 16, cfg.num_kv_heads, cfg.head_dim)
    kv = (torch.randn(shape, generator=g), torch.randn(shape, generator=g))
    prompt = list(range(10))
    chain = pool.admit_slot(prompt, [], kv)
    host = pool.export_pages(chain)
    assert torch.equal(host[0].reshape(cfg.num_layers, -1, *shape[3:])[:, :10],
                       kv[0][:, 0, :10])
    assert pool.stats()["pages_referenced"] == 0 and pool.stats()["cached_pages"] == 2
    back = pool.import_pages(host)
    assert torch.equal(pool.k_pool[:, back], host[0])
    assert torch.equal(pool.v_pool[:, back], host[1])
    assert pool.peek_prefix_len(prompt) == 8 and pool.stats()["lookups"] == 0
    pool.release_slot(back)
    _conserved(pool.stats())
