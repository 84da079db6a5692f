"""The port's replica lifecycle manager (``runtime/lifecycle.py``) on fast
fakes and on a real CPU pool, driving ``tick()`` by hand.

Mirrors the manager and pool tests of ``tests/test_lifecycle.py``: break →
quarantine → rebuild → probation → promote; failed rebuilds back off
exponentially, then bench, until an operator restart; a probation canary
error re-quarantines; drain (clean, and killed past its deadline), restart
and the undrain rules, and an undrain that raced the drain's close healed
by a rebuild; drains refused from non-serving states; the state census;
the ``replicas.rebuild`` failpoint on the pool manager and the
single-engine supervisor; and a real pool whose broken replica is rebuilt
from the shared params and serves the same greedy stream again, as the
JAX pool does on the same prompt.
"""

from __future__ import annotations

import gc
import threading
import time
import weakref

import numpy as np
import pytest

from cyberfabric_core_tpu_torch.modkit import failpoints as fp
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.lifecycle import (STATES, EngineSupervisor,
                                                          LifecycleConfig,
                                                          LifecycleStateError,
                                                          ReplicaLifecycleManager,
                                                          ReplicaUnavailable)
from cyberfabric_core_tpu_torch.runtime.replicas import DataParallelServingPool


class _FakeEngine:
    def __init__(self):
        self.broken = None
        self.closed = False
        self.load = dict(active=0, pending=0, prefilling=0, suspended=0)
        self.started = False

    def stats(self):
        return {"broken": self.broken, "closed": self.closed, **self.load}

    def start(self):
        self.started = True

    def close(self, timeout=0.0):
        self.closed = True

    def shutdown(self, timeout=0.0):
        pass


class _FakePool:
    def __init__(self, n, build=None):
        self.replicas = [_FakeEngine() for _ in range(n)]
        self.builds = 0
        self._build = build

    def build_replica(self, idx):
        self.builds += 1
        if self._build is not None:
            return self._build(idx)
        return _FakeEngine()


def _mgr(pool, **kw):
    kw.setdefault("check_interval_s", 0.01)
    kw.setdefault("rebuild_backoff_s", 0.005)
    kw.setdefault("rebuild_backoff_max_s", 0.02)
    kw.setdefault("probation_successes", 2)
    # the thread is not started: the tests drive tick()
    return ReplicaLifecycleManager(pool, LifecycleConfig(**kw))


def _tick_until(mgr, predicate, timeout_s=2.0):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        mgr.tick()
        if predicate():
            return True
        time.sleep(0.005)
    return False


def test_break_quarantine_rebuild_probation_promote():
    pool = _FakePool(2)
    mgr = _mgr(pool)
    old = pool.replicas[0]
    old.broken = "device fault"
    mgr.tick()
    assert mgr.status_row(0)["state"] == "quarantined"
    assert mgr.status_row(0)["strikes"] == 1
    assert not mgr.admit_allowed(0) and mgr.admit_allowed(1)
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation")
    assert pool.replicas[0] is not old and pool.replicas[0].started
    assert old.closed and mgr.rebuilds_ok == 1
    assert mgr.admit_allowed(0) and mgr.canary_wanted(0)
    mgr.note_dispatch(0)
    assert not mgr.admit_allowed(0)  # probation_max_inflight=1
    mgr.on_terminal(0, ok=True)
    mgr.note_dispatch(0)
    mgr.on_terminal(0, ok=True)
    row = mgr.status_row(0)
    assert row["state"] == "healthy" and row["strikes"] == 0
    assert [h["state"] for h in row["history"]] == ["quarantined", "rebuilding",
                                                    "probation", "healthy"]
    assert mgr.probation_promotions == 1


def test_rebuild_failures_back_off_exponentially_then_bench():
    def explode(idx):
        raise RuntimeError("still sick")

    pool = _FakePool(2, build=explode)
    mgr = _mgr(pool, max_strikes=2, backoff_jitter=0.0)
    pool.replicas[0].broken = "fault"
    mgr.tick()
    backoffs = [mgr._recs[0].backoff_until - time.monotonic()]
    assert _tick_until(mgr, lambda: mgr.rebuilds_failed >= 1)
    backoffs.append(mgr._recs[0].backoff_until - time.monotonic())
    assert _tick_until(mgr, lambda: mgr.counts()["benched"] == 1)
    assert backoffs[1] > backoffs[0]
    assert mgr.rebuilds_failed == 2 and mgr.benched_total == 1
    assert not mgr.admit_allowed(0)
    before = pool.builds
    for _ in range(5):
        mgr.tick()
    assert pool.builds == before  # benched stays benched
    pool._build = None
    mgr.restart(0)
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation")
    assert mgr.rebuilds_ok == 1


def test_probation_canary_error_requarantines():
    pool = _FakePool(2)
    mgr = _mgr(pool)
    pool.replicas[0].broken = "fault"
    mgr.tick()
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation")
    mgr.note_dispatch(0)
    mgr.on_terminal(0, ok=False)
    row = mgr.status_row(0)
    assert row["state"] == "quarantined" and row["strikes"] == 2


def test_drain_clean_then_restart_and_undrain_rules():
    pool = _FakePool(2)
    mgr = _mgr(pool)
    eng = pool.replicas[0]
    mgr.drain(0, deadline_s=30.0)
    assert mgr.status_row(0)["state"] == "draining" and not mgr.admit_allowed(0)
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "drained")
    assert eng.closed and mgr.drains_clean == 1
    with pytest.raises(LifecycleStateError):
        mgr.undrain(0)
    mgr.restart(0)
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation")
    mgr.drain(1, deadline_s=30.0)
    pool.replicas[1].load["active"] = 1  # busy: the tick cannot close it
    mgr.tick()
    assert mgr.status_row(1)["state"] == "draining"
    mgr.undrain(1)
    assert mgr.status_row(1)["state"] == "healthy" and not pool.replicas[1].closed


def test_undrain_racing_drain_close_heals_via_rebuild():
    pool = _FakePool(2)
    mgr = _mgr(pool)
    mgr.drain(0, deadline_s=30.0)
    mgr.undrain(0)
    pool.replicas[0].closed = True  # the close landed after the undrain
    mgr.tick()
    row = mgr.status_row(0)
    assert row["state"] == "quarantined" and "closed" in row["last_error"]
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation")


def test_drain_deadline_kills_stragglers():
    pool = _FakePool(2)
    mgr = _mgr(pool)
    eng = pool.replicas[0]
    eng.load["active"] = 2
    mgr.drain(0, deadline_s=0.0)
    assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "drained")
    assert eng.closed and mgr.drains_killed == 1


def test_drain_rejected_from_non_serving_states():
    pool = _FakePool(2)
    mgr = _mgr(pool)
    pool.replicas[0].broken = "fault"
    mgr.tick()
    with pytest.raises(LifecycleStateError):
        mgr.drain(0)
    with pytest.raises(IndexError):
        mgr.drain(7)


def test_counts_census():
    pool = _FakePool(3)
    mgr = _mgr(pool)
    pool.replicas[1].broken = "fault"
    mgr.tick()
    mgr.drain(2, deadline_s=30.0)
    c = mgr.counts()
    assert set(STATES) <= set(c)
    assert (c["replicas"], c["healthy"], c["quarantined"], c["draining"], c["serving"]) \
        == (3, 1, 1, 1, 1)
    assert mgr.status()["counts"] == c


def test_rebuild_failpoint_strikes_the_pool_manager_and_the_supervisor():
    """``replicas.rebuild`` armed once: the pool manager's first rebuild
    fails (a strike, backoff) and the next one lands; the single-engine
    supervisor's rebuild fails the same way."""
    pool = _FakePool(2)
    mgr = _mgr(pool, backoff_jitter=0.0)
    pool.replicas[0].broken = "fault"
    with fp.scoped("replicas.rebuild", "1*raise"):
        mgr.tick()
        assert _tick_until(mgr, lambda: mgr.rebuilds_failed == 1)
        assert mgr.status_row(0)["strikes"] == 2
        assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation")
    assert mgr.rebuilds_ok == 1
    sup = EngineSupervisor(lambda old: _FakeEngine(), LifecycleConfig(
        rebuild_backoff_s=0.0, rebuild_backoff_max_s=0.0, backoff_jitter=0.0))
    broken = _FakeEngine()
    broken.broken = "fault"
    with fp.scoped("replicas.rebuild", "1*raise"):
        with pytest.raises(ReplicaUnavailable, match="rebuild failed"):
            sup.ensure(broken)
    assert sup.ensure(broken).started and sup.status()["rebuilds_failed"] == 1
    sup.note_ok()
    assert sup.status()["strikes"] == 0


# --------------------------------------------------- pool integration (real)
def _tiny_cfg(**kw):
    base = dict(model="tiny-llama", max_seq_len=64, max_batch=2, decode_chunk=4,
                prefix_cache_pages=64, prefix_page_size=16, use_flash=False,
                dtype="float32")
    base.update(kw)
    return EngineConfig(**base)


@pytest.fixture(scope="module")
def jax_pool_baseline():
    """The JAX pool's greedy stream for the prompt below (same config, the
    JAX package's seeded weights), served once."""
    import jax
    import jax.numpy as jnp

    from cyberfabric_core_tpu.models import llama as jllama
    from cyberfabric_core_tpu.models.configs import get_config as jget_config
    from cyberfabric_core_tpu.runtime import EngineConfig as JaxEngineConfig
    from cyberfabric_core_tpu.runtime import SamplingParams as JaxSamplingParams
    from cyberfabric_core_tpu.runtime.replicas import DataParallelServingPool as JaxPool
    from cyberfabric_core_tpu_torch.models.configs import get_config
    from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

    params = jllama.init_params(jget_config("tiny-llama"), jax.random.PRNGKey(0), jnp.float32)
    jpool = JaxPool(JaxEngineConfig(**{**_tiny_cfg().__dict__}), n_replicas=2, seed=0,
                    params=params)
    try:
        out = _serve(jpool, PROMPT, JaxSamplingParams(max_tokens=8))
    finally:
        jpool.shutdown()
    return params_from_jax(jax.tree.map(np.asarray, params), get_config("tiny-llama")), out


PROMPT = np.random.default_rng(0).integers(3, 250, 8).tolist()


def _serve(pool, prompt, sampling):
    done = threading.Event()
    out = {"tokens": [], "fin": None}

    def emit(ev):
        if ev.token_id >= 0:
            out["tokens"].append(ev.token_id)
        if ev.finished is not None:
            out["fin"] = ev.finished
            done.set()

    pool.submit(prompt, sampling, emit)
    assert done.wait(120)
    return out


def test_pool_self_heals_and_rebuilt_streams_match(jax_pool_baseline):
    """A real pool of two CPU replicas: the victim breaks mid-stream (the
    stream fails over and ends cleanly), ticks rebuild it from the shared
    params, a canary promotes it, and it serves the baseline stream again,
    equal to the JAX pool's on the same prompt."""
    state, jax_out = jax_pool_baseline
    pool = DataParallelServingPool(
        _tiny_cfg(), n_replicas=2, devices=["cpu", "cpu"], seed=0, params=state,
        lifecycle=LifecycleConfig(check_interval_s=0.05, rebuild_backoff_s=0.05,
                                  probation_successes=1))
    pool.lifecycle.stop()  # ticks by hand from here
    mgr = pool.lifecycle
    try:
        baseline = _serve(pool, PROMPT, SamplingParams(max_tokens=8))
        assert baseline == jax_out
        victim = pool.replicas[0]

        def boom():
            raise RuntimeError("injected device fault")

        victim._decode_round = boom
        # the least-loaded pick takes replica 0 on a tie
        crash = _serve(pool, np.random.default_rng(1).integers(3, 250, 8).tolist(),
                       SamplingParams(max_tokens=8))
        assert crash["fin"] in ("stop", "length") and pool.failovers == 1
        assert _tick_until(mgr, lambda: mgr.status_row(0)["state"] == "probation", 10.0)
        assert pool.replicas[0] is not victim
        assert pool.replicas[0].params is pool.replicas[1].params is victim.params
        assert pool.stats()["healthy"] == 2
        again = _serve(pool, PROMPT, SamplingParams(max_tokens=8))  # the canary
        assert again == baseline
        assert mgr.counts()["healthy"] == 2 and mgr.rebuilds_ok == 1
        assert not pool._requests
    finally:
        pool.shutdown()


def test_closed_pool_frees_its_replicas_without_a_collection():
    """The pool owns its lifecycle manager, which holds the pool weakly: a
    closed pool dropped by its caller frees its replicas (their KV pools
    and decode graphs) at once, not at the next cycle collection."""
    pool = DataParallelServingPool(_tiny_cfg(), n_replicas=2, devices=["cpu", "cpu"], seed=0,
                                   lifecycle=LifecycleConfig(check_interval_s=0.01))
    replicas = [weakref.ref(r) for r in pool.replicas]
    manager = pool.lifecycle
    gc.disable()
    try:
        pool.close()
        del pool
        assert [r() for r in replicas] == [None, None]
        assert manager.pool is None
    finally:
        gc.enable()
