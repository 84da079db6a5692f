"""Cancellation and deadlines in the port's engine.

Mirrors ``tests/test_cancellation.py``: a request is let go of in every
phase (queued, mid chunked prefill, mid decode, with the lookahead ring in
flight, in dense mode) with exactly one terminal event, its slot, pages and
pins released, and deadlines lapse in the queue and mid-decode. A stream
that survives a neighbour's cancel equals the JAX package's greedy decode of
its prompt on the same weights."""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax


@pytest.fixture(scope="module")
def weights():
    cfg = jget_config("tiny-llama")
    jparams = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams),
                                    get_config("tiny-llama"))


def jax_greedy(jparams, prompt, n, width=64):
    """The JAX package's greedy decode of ``prompt``: dense forward over the
    whole sequence (padded to ``width``), argmax of the last row's logits."""
    cfg = jget_config("tiny-llama")
    rope = jrope(cfg.head_dim, cfg.max_position, cfg.rope_theta)

    @jax.jit
    def next_token(ids, length):
        h, _ = jllama.forward(jparams, cfg, ids, jnp.arange(width, dtype=jnp.int32)[None],
                              jllama.init_cache(cfg, 1, width, jnp.float32),
                              jnp.zeros((1,), jnp.int32), rope)
        return jnp.argmax(jllama.lm_head_logits(
            jparams, cfg, jllama.gather_last_hidden(h, length)), -1)

    seq = list(prompt)
    for _ in range(n):
        ids = np.zeros((1, width), np.int32)
        ids[0, :len(seq)] = seq
        seq.append(int(next_token(jnp.asarray(ids), jnp.asarray([len(seq)], jnp.int32))[0]))
    return seq[len(prompt):]


def _engine(state, **over):
    base = dict(model="tiny-llama", max_seq_len=256, max_batch=2, decode_chunk=4,
                use_flash=False, prefix_cache_pages=80, prefix_page_size=16,
                dtype="float32")
    base.update(over)
    return ContinuousBatchingEngine(EngineConfig(**base), params=state, device="cpu")


class _Collector:
    def __init__(self, n):
        self.tokens = {i: [] for i in range(n)}
        self.finishes = {i: [] for i in range(n)}
        self.done = threading.Event()
        self._lock = threading.Lock()
        self._n = n

    def emit_for(self, i, hook=None):
        def emit(ev):
            with self._lock:
                if ev.token_id >= 0:
                    self.tokens[i].append(ev.token_id)
                if ev.finished:
                    self.finishes[i].append(ev.finished)
                    if sum(bool(f) for f in self.finishes.values()) == self._n:
                        self.done.set()
            if hook is not None:
                hook(ev)
        return emit


def _assert_clean(engine):
    assert len(engine._free_slots) == engine.n_slots
    assert all(s is None for s in engine.slots)
    assert engine.pending_depth() == 0 and not engine._suspended
    if engine.pool is not None:
        st = engine.pool.stats()
        assert st["pages_referenced"] == 0 and st["orphan_pages"] == 0, st
        assert st["pages_free"] + st["cached_pages"] == st["pages_total"], st


def _wait_for(pred, timeout=30):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.002)
    assert pred()


def test_cancel_pending_request_never_takes_a_slot(weights):
    engine = _engine(weights[1], max_batch=1)
    col = _Collector(2)
    try:
        engine.submit([5] * 8, SamplingParams(max_tokens=60), col.emit_for(0),
                      request_id="runner")
        _wait_for(lambda: engine.active_slots + len(engine._prefill_slots) > 0)
        engine.submit([6] * 8, SamplingParams(max_tokens=50), col.emit_for(1),
                      request_id="queued")
        assert engine.cancel("queued", "changed_mind") is True
        assert col.done.wait(60), (col.finishes, engine.stats())
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert col.finishes[1] == ["cancelled"] and col.tokens[1] == []
    assert stats["cancellations"] == {"changed_mind": 1}
    assert stats["reclaimed_tokens"] >= 50
    _assert_clean(engine)


def test_cancel_unknown_id_is_noop(weights):
    engine = _engine(weights[1])
    col = _Collector(1)
    try:
        assert engine.cancel("never-submitted") is False
        engine.submit([3, 4, 5], SamplingParams(max_tokens=6), col.emit_for(0))
        assert col.done.wait(60)
        assert engine.stats()["cancellations"] == {}
    finally:
        engine.shutdown()
    assert col.finishes[0] == ["length"]
    _assert_clean(engine)


def test_deadline_lapses_mid_decode(weights):
    engine = _engine(weights[1])
    col = _Collector(1)
    try:
        # lapse once the stream is under way, whatever this host's speed
        hook = (lambda ev: len(col.tokens[0]) == 8 and
                setattr(engine.slots[0] or engine.slots[1], "deadline", time.monotonic()))
        engine.submit([7] * 8, SamplingParams(max_tokens=200), col.emit_for(0, hook),
                      request_id="slow", deadline=time.monotonic() + 600)
        assert col.done.wait(60), (col.finishes, engine.stats())
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert col.finishes[0] == ["deadline"]
    assert 8 <= len(col.tokens[0]) < 200
    assert stats["cancellations"] == {"deadline": 1}
    _assert_clean(engine)


def test_deadline_lapses_in_the_queue(weights):
    engine = _engine(weights[1], max_batch=1)
    col = _Collector(2)
    try:
        def lapse(ev):  # from the runner's 4th token on, queued deadlines pass
            if len(col.tokens[0]) >= 4:
                for req in engine._pending.snapshot():
                    req.deadline = time.monotonic()

        engine.submit([5] * 8, SamplingParams(max_tokens=40), col.emit_for(0, lapse))
        _wait_for(lambda: engine.active_slots + len(engine._prefill_slots) > 0)
        engine.submit([6] * 8, SamplingParams(max_tokens=10), col.emit_for(1),
                      deadline=time.monotonic() + 600)
        assert col.done.wait(60), (col.finishes, engine.stats())
    finally:
        engine.shutdown()
    assert col.finishes[1] == ["deadline"] and col.tokens[1] == []
    assert col.finishes[0] == ["length"] and len(col.tokens[0]) == 40
    _assert_clean(engine)


def test_deadline_admission_estimate_rejects_unfillable_budget(weights):
    """While the engine is busy and the best prefill rate says the request
    cannot prefill inside its budget, it lapses at the take."""
    engine = _engine(weights[1])
    col = _Collector(2)
    try:
        engine.submit([5] * 8, SamplingParams(max_tokens=120), col.emit_for(0))
        _wait_for(lambda: engine.active_slots > 0)
        engine._prefill_rates.clear()
        engine._prefill_rates.append(1.0)  # 1 token/s: 40 tokens ≫ a 2 s budget
        engine.submit([9] * 40, SamplingParams(max_tokens=10), col.emit_for(1),
                      request_id="doomed", deadline=time.monotonic() + 2.0)
        assert col.done.wait(60), (col.finishes, engine.stats())
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert col.finishes[1] == ["deadline"] and col.tokens[1] == []
    assert col.finishes[0] == ["length"]
    assert stats["cancellations"] == {"deadline": 1}
    _assert_clean(engine)


def test_cancel_mid_chunked_prefill_releases_chain(weights):
    engine = _engine(weights[1], prefill_budget_tokens=3)
    col = _Collector(1)
    try:
        def hook_round():
            st = engine.slots[0]
            if st is not None and st.phase == "prefill" and st.prefill_pos >= 6:
                engine.cancel("chunky", "disconnect")
                return True
            return False

        inner = engine._decode_round_mixed
        engine._decode_round_mixed = lambda: (inner(), hook_round())[0]
        engine.submit(list(range(3, 43)), SamplingParams(max_tokens=20), col.emit_for(0),
                      request_id="chunky")
        assert col.done.wait(60), (col.finishes, engine.stats())
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert col.finishes[0] == ["cancelled"] and col.tokens[0] == []
    assert stats["cancellations"] == {"disconnect": 1}
    _assert_clean(engine)


@pytest.mark.parametrize("depth", [0, 2])
def test_cancel_mid_decode_with_the_ring_in_flight(weights, depth):
    """A decode row cancelled from the emit callback (the scheduler thread,
    so the cancel lands in the same round every run): one 'cancelled'
    event, a second cancel is a no-op, the freed slot serves a later
    request, and the survivor's greedy stream equals the JAX package's
    greedy decode of its prompt."""
    jparams, state = weights
    engine = _engine(state, decode_lookahead=depth)
    col = _Collector(3)
    survivor = list(range(40, 60))
    try:
        def hook(ev):
            if len(col.tokens[0]) == 6 and not col.finishes[0]:
                assert engine.cancel("victim", "client_disconnect")
                engine.cancel("victim", "client_disconnect")

        engine.submit([5] * 12, SamplingParams(max_tokens=40), col.emit_for(0, hook),
                      request_id="victim")
        engine.submit(survivor, SamplingParams(max_tokens=24), col.emit_for(1))
        _wait_for(lambda: bool(col.finishes[0]))
        engine.submit([9] * 10, SamplingParams(max_tokens=5), col.emit_for(2))
        assert col.done.wait(60), (col.finishes, engine.stats())
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert col.finishes == {0: ["cancelled"], 1: ["length"], 2: ["length"]}
    assert 6 <= len(col.tokens[0]) < 40 and len(col.tokens[2]) == 5
    assert stats["cancellations"] == {"client_disconnect": 1}
    _assert_clean(engine)

    assert col.tokens[1] == jax_greedy(jparams, survivor, 24)


def test_cancel_works_in_dense_mode(weights):
    engine = _engine(weights[1], max_seq_len=64, prefix_cache_pages=0)
    col = _Collector(1)
    try:
        def hook(ev):
            if len(col.tokens[0]) == 4:
                engine.cancel("dense", "test")

        engine.submit([5, 6, 7], SamplingParams(max_tokens=40), col.emit_for(0, hook),
                      request_id="dense")
        assert col.done.wait(60), (col.finishes, engine.stats())
    finally:
        engine.shutdown()
    assert col.finishes[0] == ["cancelled"] and len(col.tokens[0]) < 40
    _assert_clean(engine)


def test_close_ends_everything_and_refuses_new_work(weights):
    engine = _engine(weights[1], max_batch=1)
    col = _Collector(2)
    engine.submit([5] * 8, SamplingParams(max_tokens=200), col.emit_for(0))
    _wait_for(lambda: engine.active_slots > 0)
    engine.submit([6] * 8, SamplingParams(max_tokens=5), col.emit_for(1))
    engine.close()
    assert col.done.wait(10)
    assert col.finishes == {0: ["error"], 1: ["error"]}
    assert not engine.servable() and engine.stats()["broken"] is None
    with pytest.raises(RuntimeError, match="closed"):
        engine.submit([1, 2], SamplingParams(max_tokens=2), lambda ev: None)
    engine.close()  # idempotent
