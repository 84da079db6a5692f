"""Tenant isolation in the port's engine.

Mirrors ``tests/test_tenancy.py``: the port's ``TenantFairQueue`` (FIFO
within a tenant, weighted pop, the new-backlog lift, blocked tenants, the
tenant-blind FIFO, remove_if) and, on seeded random operation sequences,
the same pops as the JAX package's queue; the engine with tenancy armed:
fair admission under a flood, the per-tenant caps (slots, pending, the hard
page quota, the soft-quota yield), single-tenant streams identical with and
without fairness (and equal to the JAX engine's), and the drain-rate
Retry-After."""

from __future__ import annotations

import logging
import threading
import time

import jax
import numpy as np
import pytest

from cyberfabric_core_tpu.runtime import EngineConfig as JEngineConfig
from cyberfabric_core_tpu.runtime import SamplingParams as JSamplingParams
from cyberfabric_core_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from cyberfabric_core_tpu.runtime.scheduler import TenantFairQueue as JQueue
from cyberfabric_core_tpu.runtime.scheduler import _Pending as JPending
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import (EngineConfig, SamplingParams,
                                                       SchedulerSaturated,
                                                       TenantQuotaExceeded,
                                                       TenantSaturated)
from cyberfabric_core_tpu_torch.runtime.scheduler import (ContinuousBatchingEngine,
                                                          TenantFairQueue, _Pending)
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

TINY = dict(model="tiny-llama", max_seq_len=64, max_batch=2, decode_chunk=4,
            prefix_cache_pages=64, prefix_page_size=16, use_flash=False, dtype="float32")


def _req(rid: str, tenant: str = "default", enq: float = 0.0, cls=_Pending):
    req = cls(rid, [1, 2, 3], SamplingParams(max_tokens=4), emit=lambda ev: None,
              tenant=tenant)
    req.enqueued_at = enq or time.monotonic()
    return req


# ------------------------------------------------------------ fair queue


def test_fair_queue_fifo_within_tenant():
    q = TenantFairQueue()
    for i in range(4):
        q.put(_req(f"a{i}", "a", enq=float(i + 1)))
    assert [q.pop_fair().request_id for _ in range(4)] == ["a0", "a1", "a2", "a3"]
    assert q.empty()


def test_fair_queue_weighted_pop_tracks_charges():
    q = TenantFairQueue()
    for i in range(3):
        q.put(_req(f"a{i}", "a", enq=1.0 + i))
        q.put(_req(f"b{i}", "b", enq=1.0 + i))
    assert q.pop_fair().request_id == "a0"  # tie: head arrival, then tenant id
    q.charge("a", 100, weight=1.0)
    assert q.pop_fair().request_id == "b0"
    q.charge("b", 40, weight=2.0)  # 20 < 100
    assert q.pop_fair().request_id == "b1"
    q.charge("b", 200, weight=2.0)  # 120 > 100
    assert q.pop_fair().request_id == "a1"


def test_fair_queue_new_backlog_lift():
    q = TenantFairQueue()
    q.put(_req("a0", "a", enq=1.0))
    q.charge("a", 500, weight=1.0)
    q.put(_req("b0", "b", enq=2.0))
    assert q.vtc_snapshot()["b"] == pytest.approx(500.0)
    assert q.pop_fair().request_id == "a0"


def test_fair_queue_blocked_tenants_are_skipped():
    q = TenantFairQueue()
    q.put(_req("a0", "a", enq=1.0))
    q.put(_req("b0", "b", enq=2.0))
    assert q.pop_fair(blocked={"a"}).request_id == "b0"
    assert q.pop_fair(blocked={"a"}) is None
    assert q.pop_fair().request_id == "a0"


def test_fair_queue_tenant_blind_mode_is_one_fifo():
    q = TenantFairQueue(fair=False)
    for rid, t, enq in (("a0", "a", 1.0), ("b0", "b", 2.0), ("a1", "a", 3.0)):
        q.put(_req(rid, t, enq=enq))
    q.charge("b", 10 ** 6, weight=1.0)
    assert [q.pop_fair().request_id for _ in range(3)] == ["a0", "b0", "a1"]
    assert q.depths() == {} and q.charged_snapshot() == {"default": 10 ** 6}


def test_fair_queue_remove_if_put_front_and_drain_all():
    q = TenantFairQueue()
    for i in range(4):
        q.put(_req(f"a{i}", "a", enq=float(i + 1)))
    removed = q.remove_if(lambda r: r.request_id in ("a1", "a3"))
    assert sorted(r.request_id for r in removed) == ["a1", "a3"] and q.qsize() == 2
    head = q.pop_fair()
    q.put_front(head)
    assert q.oldest_age() is not None
    assert [r.request_id for r in q.drain_all()] == ["a0", "a2"]
    assert q.empty() and q.oldest_age() is None


@pytest.mark.parametrize("fair", [True, False])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_fair_queue_pops_as_the_jax_queue(seed, fair):
    """Seeded random sequences of put, put_front, charge, pop_fair (with
    blocked sets) and remove_if on both packages' queues: the same pops,
    removals, counters and depths after every operation."""
    rng = np.random.default_rng(seed)
    ours, theirs = TenantFairQueue(fair), JQueue(fair)
    tenants = ["a", "b", "c", "d"]
    n = 0
    for _ in range(400):
        op = rng.choice(["put", "put", "put", "charge", "pop", "pop", "front", "remove"])
        if op == "put":
            t, enq = str(rng.choice(tenants)), float(rng.integers(1, 50))
            ours.put(_req(f"r{n}", t, enq))
            theirs.put(_req(f"r{n}", t, enq, cls=JPending))
            n += 1
        elif op == "charge":
            t, tok, w = str(rng.choice(tenants)), int(rng.integers(0, 60)), \
                float(rng.choice([0.5, 1.0, 2.0]))
            ours.charge(t, tok, w)
            theirs.charge(t, tok, w)
        elif op in ("pop", "front"):
            blocked = {t for t in tenants if rng.random() < 0.3} or None
            a, b = ours.pop_fair(blocked), theirs.pop_fair(blocked)
            assert (a and a.request_id) == (b and b.request_id)
            if op == "front" and a is not None:
                ours.put_front(a)
                theirs.put_front(b)
        else:
            mod = int(rng.integers(2, 6))
            a = ours.remove_if(lambda r: int(r.request_id[1:]) % mod == 0)
            b = theirs.remove_if(lambda r: int(r.request_id[1:]) % mod == 0)
            assert [r.request_id for r in a] == [r.request_id for r in b]
        assert ours.depths() == theirs.depths() and ours.qsize() == theirs.qsize()
        assert ours.vtc_snapshot() == theirs.vtc_snapshot()
    rest = [r.request_id for r in ours.drain_all()]
    assert rest == [r.request_id for r in theirs.drain_all()]


# ----------------------------------------------------------- engine level


@pytest.fixture(scope="module")
def jax_engine_streams():
    """Six single-tenant requests through the JAX engine (its weights come
    along as the port's state_dict)."""
    engine = JEngine(JEngineConfig(**TINY), seed=0)
    loads = [(f"r{i}", "default", [7 + i, 11, 13 + i, 17], 6) for i in range(6)]
    try:
        streams = _drive(engine, loads, sampling=JSamplingParams)
        state = params_from_jax(jax.tree.map(np.asarray, engine.params),
                                get_config("tiny-llama"))
    finally:
        engine.shutdown()
    return loads, streams, state


def _engine(state, **over):
    return ContinuousBatchingEngine(EngineConfig(**{**TINY, **over}), params=state,
                                    device="cpu")


def _drive(engine, loads, timeout=60.0, sampling=SamplingParams):
    """Submit (rid, tenant, prompt, max_tokens); wait for every terminal.
    Returns {rid: tokens}."""
    streams: dict[str, list[int]] = {}
    done, lock, left = threading.Event(), threading.Lock(), [len(loads)]

    def mk_emit(rid):
        streams[rid] = []

        def emit(ev):
            with lock:
                if ev.token_id >= 0:
                    streams[rid].append(ev.token_id)
                if ev.finished:
                    left[0] -= 1
                    if left[0] == 0:
                        done.set()
        return emit

    for rid, tenant, prompt, max_tokens in loads:
        engine.submit(prompt, sampling(max_tokens=max_tokens), mk_emit(rid),
                      request_id=rid, tenant=tenant)
    assert done.wait(timeout), "streams never drained"
    return streams


def _admission_order(engine):
    """Request ids in the order they leave the queue (the seed is fixed
    there)."""
    order, inner = [], engine._new_state

    def new_state(req):
        order.append((req.request_id, time.monotonic()))
        return inner(req)

    engine._new_state = new_state
    return order


def test_single_tenant_streams_identical_fair_vs_blind(jax_engine_streams):
    loads, jax_streams, state = jax_engine_streams
    out = {}
    for fair in (True, False):
        engine = _engine(state, tenant_fair=fair)
        try:
            out[fair] = _drive(engine, loads)
        finally:
            engine.shutdown()
    assert out[True] == out[False] == jax_streams


def test_fair_admission_under_flood_and_stats_surfaces(jax_engine_streams):
    engine = _engine(jax_engine_streams[2])
    order = _admission_order(engine)
    loads = [(f"h{i}", "heavy", [5 + i, 9, 12, 19], 6) for i in range(12)]
    loads += [(f"l{j}", "light", [6 + j, 8, 21], 6) for j in range(2)]
    try:
        _drive(engine, loads)
        stats = engine.stats()
    finally:
        engine.shutdown()
    tenants = stats["tenants"]
    assert tenants["heavy"]["charged_tokens"] > tenants["light"]["charged_tokens"] > 0
    assert stats["queue"]["pending"] == 0 and "drain_rate_per_s" in stats["queue"]
    assert stats["queue_wait_ms"]["count"] == 14
    ids = [rid for rid, _ in order]
    for j in range(2):
        assert ids.index(f"l{j}") <= 8, f"l{j} admitted after heavy backlog: {ids}"


def test_tenant_max_pending_raises_tenant_saturated(jax_engine_streams):
    engine = _engine(jax_engine_streams[2], tenant_max_pending=2, max_pending=100)
    engine.start = lambda: None  # park the queue: no scheduler thread
    ok = 0
    with pytest.raises(TenantSaturated) as exc:
        for i in range(5):
            engine.submit([3, 4, 5], SamplingParams(max_tokens=2), lambda ev: None,
                          request_id=f"t{i}", tenant="spam")
            ok += 1
    assert ok == 2 and exc.value.tenant == "spam" and exc.value.retry_after_s >= 1.0
    assert isinstance(exc.value, SchedulerSaturated)
    engine.submit([3, 4, 5], SamplingParams(max_tokens=2), lambda ev: None,
                  request_id="other", tenant="polite")
    assert engine.stats()["queue"]["per_tenant"] == {"spam": 2, "polite": 1}
    assert engine.tenant_snapshot()["spam"]["rejections"]["pending"] >= 1
    assert engine.pending_depth() == 3 and engine.pending_oldest_age_s() >= 0
    engine._fail_all_inflight("test teardown")


def test_tenant_hard_page_quota_rejects_at_submit(jax_engine_streams):
    engine = _engine(jax_engine_streams[2], tenant_max_pages=2)  # 32 tokens
    try:
        with pytest.raises(TenantQuotaExceeded) as exc:
            engine.submit(list(range(3, 40)), SamplingParams(max_tokens=20),
                          lambda ev: None, tenant="greedy")
        assert exc.value.tenant == "greedy"
        streams = _drive(engine, [("ok", "greedy", [3, 4, 5], 4)])
        assert len(streams["ok"]) == 4
        assert engine.tenant_snapshot()["greedy"]["rejections"]["quota"] == 1
    finally:
        engine.shutdown()


def test_tenant_max_slots_blocks_admission_not_others(jax_engine_streams):
    """The capped tenant never holds two slots (read at every round); the
    other tenant takes the second slot."""
    engine = _engine(jax_engine_streams[2], tenant_max_slots=1)
    held, inner = [], engine._decode_round

    def round_():
        held.append(engine.tenant_snapshot().get("hog", {}).get("active_slots", 0))
        inner()

    engine._decode_round = round_
    loads = [(f"h{i}", "hog", [5, 9, 12], 8) for i in range(4)] + \
        [("lite", "light", [6, 8, 21], 8)]
    try:
        streams = _drive(engine, loads)
    finally:
        engine.shutdown()
    assert held and max(held) == 1
    assert all(len(v) == 8 for v in streams.values())


def test_tenant_soft_page_quota_yields_under_contention(jax_engine_streams):
    """An over-soft-cap tenant yields a slot to host while another tenant
    waits; the starved tenant admits before the yielded stream resumes; the
    yielded stream ends normally and nothing leaks."""
    engine = _engine(jax_engine_streams[2], tenant_soft_pages=1)
    order = _admission_order(engine)
    resumed, inner = [], engine._resume_suspended

    def resume():
        n = inner()
        if n:
            resumed.append(time.monotonic())
        return n

    engine._resume_suspended = resume
    loads = [("hog0", "hog", list(range(3, 15)), 24), ("hog1", "hog", list(range(3, 15)), 24),
             ("p0", "polite", [3, 4, 5], 4), ("p1", "polite", [3, 4, 5], 4),
             ("p2", "polite", [3, 4, 5], 4)]
    try:
        streams = _drive(engine, loads)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert len(streams["hog0"]) == len(streams["hog1"]) == 24
    assert stats["tenants"]["hog"]["soft_yields"] >= 1 and stats["preemptions"] >= 1
    assert resumed, "no yield/resume ever happened"
    assert dict(order)["p0"] <= min(resumed)
    assert len(engine._free_slots) == engine.n_slots
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0


def test_caps_disarmed_with_tenant_blind_queue(jax_engine_streams, caplog):
    with caplog.at_level(logging.WARNING, logger="scheduler"):
        engine = _engine(jax_engine_streams[2], tenant_fair=False, tenant_max_pending=1,
                         tenant_max_pages=1, tenant_soft_pages=1)
    assert any("DISARMED" in r.message for r in caplog.records)
    assert engine._tenant_caps_armed is False
    try:
        streams = _drive(engine, [(f"r{i}", "t", list(range(3, 30)), 8) for i in range(4)])
    finally:
        engine.shutdown()
    assert all(len(v) == 8 for v in streams.values())


def test_saturation_retry_after_derives_from_drain_rate(jax_engine_streams):
    engine = _engine(jax_engine_streams[2])
    t0 = time.monotonic()
    engine._admit_events.append((t0 - 10.0, 999))
    engine._admit_events.append((t0, 20))
    assert engine._drain_rate_per_s() == pytest.approx(2.0, rel=1e-3)
    assert engine._saturation_retry_after(10) == pytest.approx(5.0, rel=1e-3)
    assert engine._saturation_retry_after(1000) == 30.0
    engine._admit_events.clear()
    engine._admit_events.append((t0 - 3600.0, 50))
    engine._admit_events.append((t0 - 3599.0, 50))
    assert engine._drain_rate_per_s() == 0.0
    engine._admit_events.clear()
    assert engine._saturation_retry_after(50) == 1.0
    hb = engine.heartbeat()
    assert hb["pending"] == 0 and hb["suspended"] == 0 and hb["broken"] is None
