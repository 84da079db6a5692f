"""Preempt-to-host in the port's engine, against the JAX engine.

Mirrors ``tests/test_preemption.py``: pool pressure (a ``MemoryError``
injected into ``pool.extend_chain``, as there) saves the chain to host and
resumes it later instead of breaking the engine. A preempted greedy stream
equals the JAX engine's undisturbed stream on the same weights, token for
token; a preempted seeded stream equals the port's own undisturbed one (the
two packages draw from different generators), at ring depths 0 and 2,
mid-decode and mid chunked prefill."""

import threading
import time

import jax
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.runtime import EngineConfig as JEngineConfig
from cyberfabric_core_tpu.runtime import SamplingParams as JSamplingParams
from cyberfabric_core_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import (ContinuousBatchingEngine,
                                                          _SlotState, _Suspended)
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

OPTS = dict(model="tiny-llama", max_seq_len=128, max_batch=2, decode_chunk=4,
            use_flash=False, prefix_cache_pages=64, prefix_page_size=8, dtype="float32")
PROMPT = np.random.default_rng(0).integers(3, 500, 20).tolist()


def _collect(engine, prompt, sampling, emit_hook=None, timeout=60):
    done = threading.Event()
    out = {"tokens": [], "finish": None}

    def emit(ev):
        if ev.token_id >= 0:
            out["tokens"].append(ev.token_id)
        if emit_hook is not None:
            emit_hook(ev)
        if ev.finished is not None:
            out["finish"] = ev.finished
            done.set()

    engine.submit(prompt, sampling, emit)
    assert done.wait(timeout), (out, engine.stats())
    return out


@pytest.fixture(scope="module")
def jax_reference():
    """The JAX engine's undisturbed greedy stream of PROMPT, and its
    weights as the port's state_dict."""
    engine = JEngine(JEngineConfig(**OPTS), seed=0)
    try:
        done, toks = threading.Event(), []

        def emit(ev):
            if ev.token_id >= 0:
                toks.append(ev.token_id)
            if ev.finished is not None:
                done.set()

        engine.submit(PROMPT, JSamplingParams(max_tokens=16), emit)
        assert done.wait(120)
        state = params_from_jax(jax.tree.map(np.asarray, engine.params),
                                get_config("tiny-llama"))
    finally:
        engine.shutdown()
    return toks, state


def _engine(state, **over):
    return ContinuousBatchingEngine(EngineConfig(**{**OPTS, **over}), params=state,
                                    device="cpu")


def _inject(engine, when):
    """Fail every chain extension while ``when()`` holds and no preemption
    has landed yet (the lookahead horizon absorbs failures without
    preempting; only a next-chunk failure preempts)."""
    orig, fired = engine.pool.extend_chain, [0]

    def flaky(chain, needed):
        if when() and engine.preemptions == 0:
            fired[0] += 1
            raise MemoryError("injected pool pressure")
        return orig(chain, needed)

    engine.pool.extend_chain = flaky
    return fired


def _check_pool(engine):
    st = engine.stats()
    assert st["pages_referenced"] == 0 and st["orphan_pages"] == 0, st
    assert st["pages_free"] + st["cached_pages"] == st["pages_total"], st


@pytest.mark.parametrize("depth", [0, 2])
@pytest.mark.parametrize("temperature", [0.0, 0.8])
def test_preempted_stream_resumes_bit_exact(jax_reference, depth, temperature):
    """Mid-decode preemption: the greedy stream equals the JAX engine's
    undisturbed one; the seeded stream equals the port's undisturbed one;
    one preemption, pages conserved, the engine not broken."""
    ref_toks, state = jax_reference
    sampling = SamplingParams(max_tokens=16, temperature=temperature, seed=7)
    if temperature > 0:
        engine = _engine(state, decode_lookahead=depth)
        try:
            ref_toks = _collect(engine, PROMPT, sampling)["tokens"]
        finally:
            engine.shutdown()
    engine = _engine(state, decode_lookahead=depth)
    try:
        started = threading.Event()
        fired = _inject(engine, started.is_set)
        out = _collect(engine, PROMPT, sampling,
                       lambda ev: ev.token_id >= 0 and started.set())
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert fired[0] >= 1 and stats["preemptions"] == 1
    assert stats["broken"] is None and stats["suspended"] == 0
    assert stats["resume_recovery_ms"]["count"] == 1
    assert out["finish"] == "length" and out["tokens"] == ref_toks
    _check_pool(engine)


def test_preempted_mid_chunked_prefill_resumes_at_its_chunk(jax_reference):
    """A slot preempted between prompt chunks keeps ``prefill_pos``: it
    resumes chunking there and its greedy stream equals JAX's."""
    ref_toks, state = jax_reference
    engine = _engine(state, prefill_budget_tokens=8)
    try:
        def second_chunk():
            st = engine.slots[0]
            return st is not None and st.phase == "prefill" and st.prefill_pos == 8

        fired = _inject(engine, second_chunk)
        out = _collect(engine, PROMPT, SamplingParams(max_tokens=16))
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert fired[0] >= 1 and stats["preemptions"] == 1
    assert out["tokens"] == ref_toks
    _check_pool(engine)


def test_suspended_request_outranks_new_admissions(jax_reference):
    """A preempted request takes the freed slot before queued new work."""
    _, state = jax_reference
    engine = _engine(state, max_batch=1)
    try:
        started = threading.Event()
        _inject(engine, started.is_set)
        events, lock = [], threading.Lock()
        done = {"a": threading.Event(), "b": threading.Event()}

        def mk(name):
            def emit(ev):
                with lock:
                    if ev.token_id >= 0:
                        events.append(name)
                        started.set()
                    if ev.finished is not None:
                        done[name].set()
            return emit

        rng = np.random.default_rng(1)
        engine.submit(rng.integers(3, 500, 12).tolist(), SamplingParams(max_tokens=12),
                      mk("a"))
        engine.submit(rng.integers(3, 500, 12).tolist(), SamplingParams(max_tokens=4),
                      mk("b"))
        assert done["a"].wait(60) and done["b"].wait(60), engine.stats()
        assert engine.preemptions == 1
    finally:
        engine.shutdown()
    assert max(i for i, n in enumerate(events) if n == "a") < events.index("b")


def test_unserviceable_suspended_request_terminal_sheds_not_hangs(jax_reference):
    """A preempted request even the idle pool cannot hold ends with
    'length' instead of retrying for ever."""
    _, state = jax_reference
    engine = _engine(state)
    try:
        def never(chain, needed):
            raise MemoryError("no pages, ever")

        engine.pool.extend_chain = never
        out = _collect(engine, [5] * 20, SamplingParams(max_tokens=16))
        assert out["finish"] == "length"
        assert engine.stats()["preemptions"] >= 1 and engine.servable()
    finally:
        engine.shutdown()


def _suspended(request_id, emit, n_pages, length):
    shape = (2, n_pages, 8, 2, 16)
    return _Suspended(state=_SlotState(request_id=request_id, emit=emit,
                                       sampling=SamplingParams(max_tokens=4),
                                       stops=frozenset(), prompt_ids=[5] * 8, chain=[],
                                       generator=None),
                      host_kv=(torch.zeros(shape), torch.zeros(shape)), length=length,
                      last_token=5, gen_state=None)


def test_scheduler_failure_fails_suspended_requests_too(jax_reference):
    _, state = jax_reference
    engine = _engine(state)
    errors = []
    try:
        engine._suspended.append(_suspended("r", errors.append, 1, 8))

        def boom():
            raise RuntimeError("boom")

        engine._decode_round = boom
        engine.submit([5, 6, 7], SamplingParams(max_tokens=2), lambda ev: None)
        deadline = time.monotonic() + 30
        while not errors and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        engine.shutdown()
    assert errors and errors[0].finished == "error"
    assert not engine.servable() and not engine._suspended


def test_infeasible_suspended_request_sheds_even_under_load(jax_reference):
    """A suspended request needing more pages than the whole pool sheds at
    once, even while other slots keep the engine busy."""
    _, state = jax_reference
    engine = _engine(state, max_seq_len=256, prefix_cache_pages=8)
    events = []
    try:
        def no_room(host_kv):
            raise MemoryError("pool exhausted")

        engine.pool.restore_chain_from_host = no_room
        n_pages = engine.pool.pages_for(200)
        engine.pool.num_pages = n_pages  # capacity n_pages - 1 < need
        engine._suspended.append(_suspended("big", events.append, n_pages, 200))
        engine.active[0] = True  # the pool is not idle
        engine._resume_suspended()
        assert not engine._suspended
        assert events and events[-1].finished == "length"
    finally:
        engine.active[0] = False
        engine.shutdown()
