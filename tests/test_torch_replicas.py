"""The port's data-parallel serving pool (``runtime/replicas.py``) on the CPU.

Mirrors ``tests/test_replicas.py``: load spreads and every request ends;
each replica's tensors are on its assigned device (the CPU test's devices
are ``["cpu"] * n``; replicas on one device share one params tree);
greedy output is replica-independent and equal to the JAX package's greedy
decode of the same weights, also across a mid-stream failover; cache-aware
placement; no healthy replica raises; too many replicas for the devices
raise; the failover policy on bare-instance doubles (a synthesized
``length`` terminal, no canary credit for it, the breaking replica excluded
before its flag flips, jittered-backoff retries); the ``replicas.submit``
and ``replicas.failover`` failpoints; and a storm in which two of three
replicas break at once, every stream ending once and the lifecycle manager
rebuilding both.
"""

from __future__ import annotations

import contextlib
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu_torch.device import on_card
from cyberfabric_core_tpu_torch.modkit import failpoints as fp
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams, StepEvent
from cyberfabric_core_tpu_torch.runtime.lifecycle import LifecycleConfig
from cyberfabric_core_tpu_torch.runtime.replicas import DataParallelServingPool, _Tracked
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

SEQ = 48  # the JAX reference's width


def _cfg(**kw):
    base = dict(model="tiny-llama", max_seq_len=128, max_batch=2, decode_chunk=4,
                use_flash=False, dtype="float32")
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_model():
    """One JAX tiny-llama tree (f32), the same weights as a port state_dict,
    and a jitted greedy reference over it."""
    jcfg = jget_config("tiny-llama")
    params = jllama.init_params(jcfg, jax.random.PRNGKey(5), jnp.float32)
    rope = jrope(jcfg.head_dim, jcfg.max_position, jcfg.rope_theta)

    @jax.jit
    def step(ids, lengths):
        B = ids.shape[0]
        pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32), (B, SEQ))
        h, _ = jllama.forward(params, jcfg, ids, pos, jllama.init_cache(jcfg, B, SEQ,
                                                                       jnp.float32),
                              jnp.zeros(B, jnp.int32), rope)
        return jnp.argmax(jllama.lm_head_logits(params, jcfg,
                                                jllama.gather_last_hidden(h, lengths)), -1)

    def greedy(prompt, n):
        seq = list(prompt)
        for _ in range(n):
            ids = np.zeros((1, SEQ), np.int32)
            ids[0, :len(seq)] = seq
            seq.append(int(step(ids, np.asarray([len(seq)], np.int32))[0]))
        return seq[len(prompt):]

    return params_from_jax(jax.tree.map(np.asarray, params), get_config("tiny-llama")), greedy


def _pool(state, n=2, lifecycle=None, max_retries=1, **kw):
    return DataParallelServingPool(_cfg(**kw), n_replicas=n, devices=["cpu"] * n, seed=0,
                                   params=state, lifecycle=lifecycle, max_retries=max_retries)


def _run(pool, prompt, max_tokens=8, hook=None, request_id=None):
    """Serve one greedy request; ``hook(tokens)`` sees each token on the
    scheduler thread."""
    done = threading.Event()
    out = {"tokens": [], "finish": None}

    def emit(ev):
        if ev.token_id >= 0:
            out["tokens"].append(ev.token_id)
            if hook is not None:
                hook(out["tokens"])
        if ev.finished is not None:
            out["finish"] = ev.finished
            done.set()

    pool.submit(prompt, SamplingParams(max_tokens=max_tokens), emit, request_id=request_id)
    assert done.wait(60), "request did not finish"
    return out


def test_fanout_spreads_load_and_completes(jax_model):
    state, _ = jax_model
    pool = _pool(state)
    try:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(3, 500, 12 + i).tolist() for i in range(6)]
        done, lock = threading.Event(), threading.Lock()
        finished = [0]

        def emit(ev):
            if ev.finished is not None:
                with lock:
                    finished[0] += 1
                    if finished[0] == len(prompts):
                        done.set()

        for p in prompts:
            pool.submit(p, SamplingParams(max_tokens=6), emit)
        assert done.wait(60), pool.stats()
        st = pool.stats()
        assert st["requests_completed"] == len(prompts)
        assert all(s["requests_completed"] > 0 for s in st["per_replica"])
    finally:
        pool.shutdown()


def test_each_replica_on_its_assigned_device(jax_model):
    state, _ = jax_model
    pool = _pool(state, prefix_cache_pages=32, prefix_page_size=16)
    try:
        for eng, dev in zip(pool.replicas, pool.devices):
            assert eng.device == dev == torch.device("cpu")
            tensors = list(eng.params.parameters()) + [eng.pool.k_pool, eng.pool.v_pool]
            assert all(t.device == dev for t in tensors)
        assert pool.replicas[0].params is pool.replicas[1].params  # one tree, no copy
        _run(pool, [5, 6, 7, 8], max_tokens=3)
    finally:
        pool.shutdown()


def test_engine_build_is_scoped_to_its_card(jax_model, monkeypatch):
    """Each replica's build runs inside ``on_card(its device)`` and nothing
    sets the building thread's card for good, so a pool built over several
    cards leaves its builder on the card it was on. ``on_card`` of a CUDA
    index is ``torch.cuda.device`` of it; of the CPU, no change."""
    from cyberfabric_core_tpu_torch.runtime import scheduler as sched
    events = []

    @contextlib.contextmanager
    def recording(device):
        events.append(("enter", device))
        yield
        events.append(("exit", device))

    build = sched.ContinuousBatchingEngine._build

    def traced(self, *args, **kw):
        events.append(("build", self.device))
        return build(self, *args, **kw)

    def set_device(_):
        raise AssertionError("the building thread's card was set for good")

    monkeypatch.setattr(sched, "on_card", recording)
    monkeypatch.setattr(sched.ContinuousBatchingEngine, "_build", traced)
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    state, _ = jax_model
    _pool(state).shutdown()
    cpu = torch.device("cpu")
    assert events == [("enter", cpu), ("build", cpu), ("exit", cpu)] * 2
    card = on_card(torch.device("cuda", 1))
    assert isinstance(card, torch.cuda.device) and card.idx == 1
    assert isinstance(on_card(cpu), contextlib.nullcontext)


def test_replicas_agree_greedy_and_equal_jax(jax_model):
    state, greedy = jax_model
    pool = _pool(state)
    try:
        prompt = np.random.default_rng(1).integers(3, 500, 16).tolist()
        a, b = _run(pool, prompt), _run(pool, prompt)
        assert a["tokens"] == b["tokens"] == greedy(prompt, 8)
    finally:
        pool.shutdown()


def test_cache_aware_placement_prefers_warm_replica(jax_model):
    state, _ = jax_model
    pool = _pool(state, prefix_cache_pages=40, prefix_page_size=16)
    try:
        rng = np.random.default_rng(4)
        head = rng.integers(3, 500, 48).tolist()  # 3 full pages
        assert _run(pool, head + rng.integers(3, 500, 6).tolist())["finish"]
        hits_before = pool.placement_hint_hits
        warm = [i for i, r in enumerate(pool.replicas)
                if r.pool.peek_prefix_len(head + [499]) > 0]
        assert len(warm) == 1, "exactly one replica should be warm"
        assert _run(pool, head + rng.integers(3, 500, 8).tolist())["finish"]
        assert pool.placement_hint_hits > hits_before
        assert pool.replicas[warm[0]].stats()["requests_completed"] >= 2
        cold_hits = pool.placement_hint_hits
        _run(pool, rng.integers(3, 500, 20).tolist())
        assert pool.placement_hint_hits == cold_hits
    finally:
        pool.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_failover_resumes_on_survivor(jax_model, paged):
    """The replica serving the stream breaks right after its first token
    (its next round raises): the stream goes on on the survivor, 10 tokens
    ending 'length', equal to JAX's greedy decode; the victim is broken."""
    state, greedy = jax_model
    kw = dict(prefix_cache_pages=32, prefix_page_size=16) if paged else {}
    pool = _pool(state, max_batch=1, **kw)
    try:
        prompt = np.random.default_rng(2).integers(3, 500, 10).tolist()
        poisoned = []

        def poison_after_first(tokens):
            if len(tokens) == 1:
                victim = pool._requests["fo"].replica
                eng = pool.replicas[victim]

                def boom():
                    raise RuntimeError("injected device fault")

                eng._decode_round = boom  # this replica's next round raises
                poisoned.append(victim)

        out = _run(pool, prompt, max_tokens=10, hook=poison_after_first, request_id="fo")
        assert out["finish"] == "length" and out["tokens"] == greedy(prompt, 10)
        st = pool.stats()
        assert st["healthy"] == 1 and st["failovers"] == 1
        assert st["per_replica"][poisoned[0]]["broken"]
        assert not pool._requests
    finally:
        pool.shutdown()


def test_no_healthy_replicas_raises(jax_model):
    state, _ = jax_model
    pool = _pool(state, n=1)
    try:
        pool.replicas[0]._broken = "poisoned"
        with pytest.raises(RuntimeError, match="no healthy replicas"):
            pool.submit([5, 6, 7], SamplingParams(max_tokens=2), lambda ev: None)
    finally:
        pool.shutdown()


def test_too_many_replicas_rejected():
    with pytest.raises(ValueError, match="3 replicas need 3 devices, have 2"):
        DataParallelServingPool(_cfg(), n_replicas=3, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        # the default devices are the visible cards: none here
        with pytest.raises(RuntimeError, match="device='cpu'"):
            DataParallelServingPool(_cfg(), n_replicas=1)


# ------------------------------------------------------- failover unit tests
def _bare_pool():
    pool = DataParallelServingPool.__new__(DataParallelServingPool)
    pool._lock = threading.Lock()
    pool._requests = {}
    pool.replicas = []
    pool.max_retries = 1
    pool.failovers = 0
    pool.failovers_failed = 0
    return pool


class _FakeReplica:
    """A stats()-healthy replica double recording submissions."""

    def __init__(self, fail_submits=0):
        self.submissions = []
        self._fail = fail_submits

    def stats(self):
        return {"broken": None, "closed": False, "active": 0, "pending": 0}

    def submit(self, prompt_ids, sampling, emit, request_id=None, trace=None):
        if self._fail > 0:
            self._fail -= 1
            raise RuntimeError("submit refused")
        self.submissions.append((list(prompt_ids), sampling.max_tokens, request_id))


def test_failover_synthesizes_length_when_budget_already_served():
    pool = _bare_pool()
    events = []
    tracked = _Tracked([1, 2, 3], SamplingParams(max_tokens=3), events.append, [7, 8, 9],
                       replica=0, retries_left=1)
    pool._requests["rid"] = tracked
    pool._wrap("rid", tracked)(StepEvent(0, -1, "error"))
    assert [(e.token_id, e.finished) for e in events] == [(-1, "length")]
    assert tracked.done and "rid" not in pool._requests
    assert pool.failovers == 0 and pool.failovers_failed == 0


def test_failover_synthesized_terminal_does_not_credit_canary():
    class _Lc:
        def __init__(self):
            self.calls = []

        def on_departed(self, idx):
            self.calls.append(("departed", idx))

        def on_terminal(self, idx, ok):
            self.calls.append(("terminal", idx, ok))

    pool = _bare_pool()
    pool.lifecycle = _Lc()
    tracked = _Tracked([1, 2, 3], SamplingParams(max_tokens=3), lambda ev: None, [7, 8, 9],
                       replica=0, retries_left=1)
    pool._requests["rid"] = tracked
    assert pool._failover("rid", tracked)
    assert pool.lifecycle.calls == [("departed", 0)]


def test_failover_excludes_breaking_replica_before_broken_flips():
    pool = _bare_pool()
    corpse, survivor = _FakeReplica(), _FakeReplica()
    pool.replicas = [corpse, survivor]
    tracked = _Tracked([1, 2, 3], SamplingParams(max_tokens=8), lambda ev: None, [7],
                       replica=0, retries_left=1)
    pool._requests["rid"] = tracked
    assert pool._failover("rid", tracked)
    assert corpse.submissions == []
    assert survivor.submissions == [([1, 2, 3, 7], 7, "rid")]
    assert tracked.replica == 1 and pool.failovers == 1


def test_failover_retries_with_backoff_until_a_target_appears():
    pool = _bare_pool()
    flaky = _FakeReplica(fail_submits=1)
    pool.replicas = [_FakeReplica(), flaky]
    pool.failover_backoff_s = 0.001
    tracked = _Tracked([1, 2], SamplingParams(max_tokens=8), lambda ev: None, [5],
                       replica=0, retries_left=1)
    pool._requests["rid"] = tracked
    t0 = time.monotonic()
    assert pool._failover("rid", tracked)
    assert time.monotonic() - t0 < 5.0
    assert len(flaky.submissions) == 1
    assert pool.failovers == 1 and pool.failovers_failed == 0
    pool2 = _bare_pool()
    pool2.replicas = [_FakeReplica(fail_submits=99), _FakeReplica(fail_submits=99)]
    pool2.failover_backoff_s = 0.001
    tracked2 = _Tracked([1, 2], SamplingParams(max_tokens=8), lambda ev: None, [5],
                        replica=0, retries_left=1)
    assert not pool2._failover("rid2", tracked2)
    assert pool2.failovers_failed == 1


def test_failpoints_reject_a_submit_and_consume_a_failover_attempt():
    """``replicas.submit`` armed: the submit raises and no record is left;
    ``replicas.failover`` armed once: the first attempt is consumed, the
    retry lands."""
    pool = _bare_pool()
    survivor = _FakeReplica()
    pool.replicas = [_FakeReplica(), survivor]
    pool.failover_backoff_s = 0.001
    with fp.scoped("replicas.submit", "raise"):
        with pytest.raises(fp.FaultInjected):
            pool.submit([1, 2], SamplingParams(max_tokens=4), lambda ev: None)
    assert not pool._requests and not survivor.submissions
    tracked = _Tracked([1, 2], SamplingParams(max_tokens=8), lambda ev: None, [5],
                       replica=0, retries_left=1)
    with fp.scoped("replicas.failover", "1*raise"):
        assert pool._failover("rid", tracked)
        assert fp.stats()["armed"]["replicas.failover"]["injected"] == 1
    assert survivor.submissions == [([1, 2, 5], 7, "rid")]


# --------------------------------------------------- concurrent-break torture
def test_a_request_queued_before_a_break_belongs_to_the_engine():
    """A break between a submit's locked check and its thread start: the
    request is in the queue the broken loop's teardown drains, so ``submit``
    must not raise (a pool would route it again, and its client would get
    two terminals: the flake of the concurrent-break storm below)."""
    from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

    engine = ContinuousBatchingEngine(_cfg(), device="cpu")
    put = engine._pending.put

    def put_then_break(req):
        put(req)
        engine._broken = "injected device fault"

    engine._pending.put = put_then_break
    events: list[StepEvent] = []
    engine.submit([5, 6, 7], SamplingParams(max_tokens=4), events.append)
    engine._fail_all_inflight("scheduler loop failed")  # the broken loop's teardown
    assert [ev.finished for ev in events] == ["error"]
    with pytest.raises(RuntimeError, match="broken"):  # a later submit is refused
        engine.submit([5, 6, 7], SamplingParams(max_tokens=4), events.append)


def test_concurrent_break_recovers_full_capacity(jax_model):
    """Two of three replicas break in the same storm (each at its first
    decode round): every stream ends exactly once, no tracking record
    leaks, and the lifecycle manager rebuilds both back to healthy."""
    state, _ = jax_model
    pool = _pool(state, n=3, max_retries=2, max_seq_len=64, prefix_cache_pages=32,
                 prefix_page_size=16, lifecycle=LifecycleConfig(check_interval_s=0.05, rebuild_backoff_s=0.05,
                                           probation_successes=1))
    for eng in pool.replicas[:2]:
        def boom():
            raise RuntimeError("injected device fault")
        eng._decode_round = boom
    rng = np.random.default_rng(7)
    n = 8
    lock, done = threading.Lock(), threading.Event()
    terminals = {i: [] for i in range(n)}

    def mk(i):
        def emit(ev):
            if ev.finished is not None:
                with lock:
                    terminals[i].append(ev.finished)
                    if all(terminals.values()):
                        done.set()
        return emit

    try:
        for i in range(n):
            pool.submit(rng.integers(3, 250, 6 + i % 5).tolist(),
                        SamplingParams(max_tokens=6), mk(i))
        assert done.wait(60), pool.stats()
        time.sleep(0.2)
        assert all(len(t) == 1 for t in terminals.values()), terminals
        assert not pool._requests, "tracking records leaked"
        deadline = time.monotonic() + 30
        while pool.stats()["healthy"] < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.stats()["healthy"] == 3, pool.lifecycle.status()
        for _ in range(3):  # canaries promote the rebuilt replicas
            _run(pool, rng.integers(3, 250, 8).tolist(), max_tokens=4)
        deadline = time.monotonic() + 10
        while pool.lifecycle.counts()["healthy"] < 3 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert pool.lifecycle.counts()["healthy"] == 3, pool.lifecycle.status()
        assert pool.lifecycle.rebuilds_ok == 2
    finally:
        pool.shutdown()
    for eng in pool.replicas:
        st = eng.stats()
        assert len(eng._free_slots) == eng.n_slots and st["pages_referenced"] == 0


def test_submit_skips_a_replica_that_broke_after_the_pick():
    """A replica whose loop breaks between the pick and its submit refuses
    the submit; the pool picks again instead of failing the request."""
    pool = _bare_pool()

    class _Breaking(_FakeReplica):
        def __init__(self):
            super().__init__()
            self.broken = None

        def stats(self):
            return {**super().stats(), "broken": self.broken}

        def submit(self, *a, **k):
            self.broken = "broke after the pick"
            raise RuntimeError("scheduler is broken: broke after the pick")

    corpse, survivor = _Breaking(), _FakeReplica()
    pool.replicas = [corpse, survivor]
    rid = pool.submit([1, 2, 3], SamplingParams(max_tokens=4), lambda ev: None,
                      request_id="r")
    assert rid == "r" and survivor.submissions == [([1, 2, 3], 4, "r")]
    assert pool._requests["r"].replica == 1
