"""Prefill/decode disaggregation in the port (``runtime/pd.py`` and the
scheduler's handoff path) on the CPU.

Mirrors ``tests/test_pd_disaggregation.py`` (its tp=2 head-sharded move
waits for the multi-GPU slice): the export/import pair on bare pools (bitwise KV round
trip, pages conserved, radix pins released with the warm prefix kept, the
cast to the destination dtype, a pool too small to import into); and
end to end a 1 prefill + 1 decode pool on ``["cpu", "cpu"]`` against a
unified port engine and against the JAX package's PD pool over the same
weights at f32: greedy and seeded streams (a tenant tag carried through)
bit-identical to the unified engine, greedy streams equal to the JAX pool's,
every stream handed off exactly once with no preemption counted, role-pure
rounds, a warm prefix served from the prefill radix, cancellation and
deadline compositions, a handoff that breaks the prefill replica (the
``scheduler.handoff`` failpoint) failing over bit-identically, the inline
role flip, the constructor's validation, and both pools' pages conserved.
"""

from __future__ import annotations

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu_torch.modkit import failpoints as fp
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.paged import PrefixKVPool
from cyberfabric_core_tpu_torch.runtime.pd import PDServingPool
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

MODEL = get_config("tiny-llama")
L, H, D = MODEL.num_layers, MODEL.num_kv_heads, MODEL.head_dim
CPU = torch.device("cpu")


# ===================================================================== units
def _host_chain(n_pages, page_size=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (L, n_pages, page_size, H, D)
    return torch.randn(shape, generator=g), torch.randn(shape, generator=g)


def _pool(dtype=torch.float32, num_pages=16):
    return PrefixKVPool(MODEL, num_pages=num_pages, page_size=8, dtype=dtype, device=CPU)


def test_export_import_roundtrip_bitwise():
    src, dst = _pool(), _pool()
    host = _host_chain(3)
    free0 = src.stats()["pages_free"]
    chain = src.restore_chain_from_host(host)
    assert src.stats()["pages_referenced"] == 3
    exported = src.export_pages(chain)
    assert torch.equal(exported[0], host[0]) and torch.equal(exported[1], host[1])
    st = src.stats()
    assert st["pages_referenced"] == 0 and st["orphan_pages"] == 0
    assert st["pages_free"] == free0
    chain2 = dst.import_pages(exported)
    assert len(chain2) == 3
    out = dst.save_chain_to_host(chain2)
    assert torch.equal(out[0], host[0]) and torch.equal(out[1], host[1])
    dst.release_slot(chain2)
    assert dst.stats()["pages_referenced"] == 0
    assert dst.stats()["pages_free"] == dst.num_pages - 1


def test_export_releases_radix_pins_and_keeps_warm_prefix():
    pool = _pool(num_pages=8)
    prompt = list(range(17))  # 2 full pages + 1 tail token
    chain = pool.restore_chain_from_host(_host_chain(3, seed=1))
    pool.commit_chain(prompt, chain)
    pages, cached = pool.match_prefix(prompt)  # pins the shared prefix
    assert pages == chain[:2] and cached == 16
    pool.export_pages(chain, prompt_ids=prompt)
    st = pool.stats()
    assert st["pages_referenced"] == 0 and st["cached_pages"] == 2
    pages2, cached2 = pool.match_prefix(prompt)
    assert pages2 == pages and cached2 == 16, "prefix still warm"
    pool.release(prompt)
    assert sorted(pool.tree.evict(2)) == sorted(pages)  # unpinned: evictable


def test_import_casts_to_destination_dtype():
    src, dst = _pool(torch.float32), _pool(torch.bfloat16)
    host = _host_chain(2, seed=2)
    chain = dst.import_pages(src.export_pages(src.restore_chain_from_host(host)))
    out = dst.save_chain_to_host(chain)
    assert out[0].dtype == torch.bfloat16
    assert torch.equal(out[0], host[0].to(torch.bfloat16))
    assert torch.equal(out[1], host[1].to(torch.bfloat16))


def test_import_raises_when_pool_cannot_hold_chain():
    src = _pool()
    exported = src.export_pages(src.restore_chain_from_host(_host_chain(3)))
    tiny = _pool(num_pages=3)  # 2 usable pages (page 0 is scratch)
    with pytest.raises(MemoryError):
        tiny.import_pages(exported)
    assert tiny.stats()["pages_referenced"] == 0


# ============================================================== end to end
CFG = dict(model="tiny-llama", max_seq_len=64, max_batch=4, decode_chunk=4,
           prefix_cache_pages=40, prefix_page_size=8, dtype="float32")

#: a greedy shared-prefix pair, a page-boundary greedy stream and a seeded
#: sampled one (its generator must survive the handoff)
REQUESTS = [
    ([5, 6, 7] * 3, SamplingParams(max_tokens=12)),
    ([5, 6, 7] * 3 + [9], SamplingParams(max_tokens=10)),
    ([20, 21, 22, 23] * 3, SamplingParams(max_tokens=10)),
    ([3, 4, 5, 6, 7], SamplingParams(max_tokens=10, temperature=0.8, top_p=0.9, seed=1234)),
]
TENANTS = {2: "acme"}


def _drive(target, requests, tenants=None, cancel_at=None, timeout=60.0):
    """Submit to an engine or pool; each stream as [(token, finished)]."""
    tenants, cancel_at = tenants or {}, cancel_at or {}
    streams = {i: [] for i in range(len(requests))}
    rids: dict[int, str] = {}
    done, left = threading.Event(), [len(requests)]

    def mk(i):
        seen = [0]

        def emit(ev):
            streams[i].append((ev.token_id, ev.finished))
            if ev.token_id >= 0:
                seen[0] += 1
                if seen[0] == cancel_at.get(i):
                    target.cancel(rids[i], "cancelled")
            if ev.finished:
                left[0] -= 1
                if not left[0]:
                    done.set()
        return emit

    for i, (prompt, sampling) in enumerate(requests):
        rids[i] = f"r{i}-{time.monotonic_ns()}"
        target.submit(list(prompt), sampling, mk(i), request_id=rids[i],
                      tenant=tenants.get(i))
    assert done.wait(timeout), "streams did not finish"
    return streams, rids


@pytest.fixture(scope="module")
def pd_runs():
    """The storm on a unified port engine, on the port's PD pool and on the
    JAX package's PD pool, over one JAX-drawn tree at f32. Stats are taken
    right after the drive; later tests reuse the live port pool."""
    from cyberfabric_core_tpu.models import llama as jllama
    from cyberfabric_core_tpu.models.configs import get_config as jget_config
    from cyberfabric_core_tpu.runtime import EngineConfig as JaxEngineConfig
    from cyberfabric_core_tpu.runtime import SamplingParams as JaxSamplingParams
    from cyberfabric_core_tpu.runtime.pd import PDServingPool as JaxPDPool

    jparams = jllama.init_params(jget_config("tiny-llama"), jax.random.PRNGKey(0),
                                 jnp.float32)
    state = params_from_jax(jax.tree.map(np.asarray, jparams), MODEL)
    jpool = JaxPDPool(JaxEngineConfig(**CFG), n_prefill=1, n_decode=1, seed=0,
                      params=jparams)
    try:
        jax_streams, _ = _drive(jpool, [(p, JaxSamplingParams(**s.__dict__))
                                        for p, s in REQUESTS[:3]])
    finally:
        jpool.shutdown()

    base = ContinuousBatchingEngine(EngineConfig(**CFG), params=state, seed=0, device="cpu")
    baseline, _ = _drive(base, REQUESTS, tenants=TENANTS)
    base_stats = base.stats()
    base.shutdown()

    pool = PDServingPool(EngineConfig(**CFG), n_prefill=1, n_decode=1, devices=[CPU, CPU],
                         seed=0, params=state)
    streams, rids = _drive(pool, REQUESTS, tenants=TENANTS)
    snap = {"pool": pool.stats(), "prefill": pool.replicas[0].stats(),
            "decode": pool.replicas[1].stats()}
    yield {"pool": pool, "baseline": baseline, "streams": streams, "rids": rids,
           "stats": snap, "base_stats": base_stats, "jax": jax_streams}
    pool.shutdown()


def test_pd_streams_bit_identical_to_unified(pd_runs):
    assert pd_runs["streams"] == pd_runs["baseline"]


def test_pd_greedy_streams_equal_the_jax_pd_pool(pd_runs):
    for i in range(3):
        assert pd_runs["streams"][i] == pd_runs["jax"][i], i


def test_every_stream_handed_off_exactly_once(pd_runs):
    st = pd_runs["stats"]
    pd = st["pool"]["pd"]
    assert pd["handoffs"] == len(REQUESTS) and pd["handoffs_failed"] == 0
    assert pd["roles"] == ["prefill", "decode"]
    assert st["prefill"]["pd"]["exported"] == len(REQUESTS)
    assert st["decode"]["pd"]["imported"] == len(REQUESTS)
    assert st["decode"]["pd"]["handoff_ms"]["count"] == len(REQUESTS)
    # a handoff is routing, not pool pressure
    assert st["decode"]["preemptions"] == 0
    assert st["decode"]["resume_recovery_ms"]["count"] == 0


def test_handoff_events_in_flight_recorder(pd_runs):
    """``tests/test_pd_disaggregation.py::test_handoff_events_in_flight_recorder``:
    one request id carries the story across both engines, handoff_export
    (prefill side) then handoff_import (decode side), once each."""
    from cyberfabric_core_tpu_torch.modkit.flight_recorder import default_recorder

    for i, rid in pd_runs["rids"].items():
        events = [e["event"] for e in (default_recorder.lookup(rid) or {}).get("timeline", ())]
        assert events.count("handoff_export") == 1, (i, events)
        assert events.count("handoff_import") == 1, (i, events)
        assert events.index("handoff_export") < events.index("handoff_import")
        assert events[0] == "enqueued" and events[-1] == "finished", (i, events)


def test_role_purity_of_dispatch_rounds(pd_runs):
    prefill, decode = pd_runs["stats"]["prefill"]["rounds"], \
        pd_runs["stats"]["decode"]["rounds"]
    assert prefill["decode"] == 0 and prefill["prefill"] + prefill["mixed"] >= 1
    assert decode["mixed"] == 0 and decode["prefill"] == 0 and decode["decode"] >= 1
    base = pd_runs["base_stats"]["rounds"]
    assert base["decode"] >= 1 and base["prefill"] + base["mixed"] >= 1


def test_pages_conserved_on_both_engines(pd_runs):
    for role in ("prefill", "decode"):
        st = pd_runs["stats"][role]
        assert st["pages_referenced"] == 0 and st["orphan_pages"] == 0, role
        assert st["pages_free"] + st["cached_pages"] == st["pages_total"], role


def test_warm_prefix_served_from_prefill_radix(pd_runs):
    """A 17-token prompt served, then a second sharing its two full pages:
    the prefill radix serves them, and the exports leave no reference."""
    pool = pd_runs["pool"]
    head = list(range(100, 116))
    hits0 = pool.replicas[0].stats()["prefix_cache"]["hits"]
    _drive(pool, [(head + [7], SamplingParams(max_tokens=4))])
    streams, _ = _drive(pool, [(head + [8, 9], SamplingParams(max_tokens=4))])
    ps = pool.replicas[0].stats()["prefix_cache"]
    assert ps["hits"] >= hits0 + 1
    assert ps["pages_referenced"] == 0 and ps["orphan_pages"] == 0
    assert [f for _, f in streams[0] if f] == ["length"]


def test_pd_cancellation_composition(pd_runs):
    """Cancelled after 2 tokens (on the decode engine by then): one
    'cancelled' terminal; the greedy survivor equals the baseline."""
    pool = pd_runs["pool"]
    victim = ([40, 41, 42, 43] * 3, SamplingParams(max_tokens=24))
    streams, _ = _drive(pool, [victim, REQUESTS[2]], cancel_at={0: 2})
    assert [f for _, f in streams[0] if f] == ["cancelled"]
    assert streams[1] == pd_runs["baseline"][2]


def test_pd_deadline_composition(pd_runs):
    pool = pd_runs["pool"]
    before = pool.stats()["pd"]["handoffs"]
    rec, done = [], threading.Event()

    def emit(ev):
        rec.append((ev.token_id, ev.finished))
        if ev.finished:
            done.set()

    pool.submit([7, 8, 9, 10], SamplingParams(max_tokens=8), emit,
                deadline=time.monotonic() - 1.0)
    assert done.wait(30)
    assert [f for _, f in rec if f] == ["deadline"] and all(t < 0 for t, _ in rec)
    assert pool.stats()["pd"]["handoffs"] == before


def test_handoff_fault_fails_over_and_stays_bit_identical(pd_runs):
    """The first handoff of a 2 + 1 pool raises on the prefill replica
    (``scheduler.handoff``): that engine breaks, the stream fails over to
    the other prefill replica, re-prefills prompt + first token and hands
    off from there; the stream equals the unified baseline."""
    pool = PDServingPool(EngineConfig(**CFG), n_prefill=2, n_decode=1, devices=[CPU] * 3,
                         seed=0, params=pd_runs["pool"].replicas[0].params)
    try:
        with fp.scoped("scheduler.handoff", "1*raise"):
            streams, _ = _drive(pool, [REQUESTS[2]])
        st = pool.stats()
        assert streams[0] == pd_runs["baseline"][2]
        assert st["failovers"] == 1 and st["healthy"] == 2 and st["pd"]["handoffs"] == 1
        assert st["per_replica"][0]["broken"] is not None
    finally:
        pool.shutdown()


def test_flip_role_inline_rebuild(pd_runs):
    pool = PDServingPool(EngineConfig(**CFG), n_prefill=2, n_decode=1, devices=[CPU] * 3,
                         seed=0, params=pd_runs["pool"].replicas[0].params)
    try:
        assert pool.flip_role(1, "decode") == {"index": 1, "role": "decode",
                                               "flipped": True, "mode": "inline"}
        assert pool._roles == ["prefill", "decode", "decode"]
        assert pool.replicas[1].pd_role == "decode"
        assert pool.replicas[1]._handoff_sink is None
        assert pool.replicas[1].params is pool.replicas[0].params
        streams, _ = _drive(pool, [REQUESTS[0]])
        assert [f for _, f in streams[0] if f] == ["length"]
        with pytest.raises(ValueError):
            pool.flip_role(0, "decode")  # the last prefill replica
        assert pool.flip_role(0, "prefill")["flipped"] is False
        with pytest.raises(ValueError):
            pool.flip_role(0, "verify")
        assert pool.rebalance()["recommendation"] is None
    finally:
        pool.shutdown()


def test_pd_constructor_validation():
    with pytest.raises(ValueError):
        PDServingPool(EngineConfig(**CFG), n_prefill=0, n_decode=1, devices=[CPU])
    with pytest.raises(ValueError):
        PDServingPool(EngineConfig(**CFG), n_prefill=1, n_decode=0, devices=[CPU])
    with pytest.raises(ValueError, match="2 replicas need 2 devices, have 1"):
        PDServingPool(EngineConfig(**CFG), n_prefill=1, n_decode=1, devices=[CPU])
    with pytest.raises(ValueError, match="paged pool"):
        ContinuousBatchingEngine(EngineConfig(**{**CFG, "prefix_cache_pages": 0},
                                              pd_role="prefill"), device="cpu")
    with pytest.raises(ValueError, match="mixed_batch"):
        ContinuousBatchingEngine(EngineConfig(**CFG, mixed_batch=False, pd_role="prefill"),
                                 device="cpu")
    with pytest.raises(ValueError, match="pd_role must be"):
        ContinuousBatchingEngine(EngineConfig(**CFG, pd_role="verify"), device="cpu")
    engine = ContinuousBatchingEngine(EngineConfig(**CFG, pd_role="prefill"), device="cpu")
    with pytest.raises(RuntimeError, match="decode-role or unified"):
        engine.submit_handoff(None)
