"""The port's flight recorder and its scheduler's emits, against the JAX
package's (``modkit/flight_recorder.py``, ``runtime/scheduler.py``).

- The same events under one fake clock give equal timelines, derived
  figures, live tables and ring evictions in both recorders: the lifecycle,
  failover reopen, a client retry of a finished id, stalled marks (no record
  for a stalled emit), an error terminal, and the three bounds.
- A tiny-llama storm through JAX's ``ContinuousBatchingEngine`` and the
  port's, on the CPU with one config (mixed, ring depth 2, a prefill budget
  that chunks prompts, one preemption forced through the
  ``scheduler.page_alloc`` failpoint armed as a MemoryError in both): each
  request has the same event kinds in the same order with the same attribute
  keys, the same sampled span names and counts (none for the unsampled
  trace), and its stream is identical with tracing on and off.
- The scheduler's failpoints sit where JAX's do: a prefill fault errors one
  admission, a readback or admission fault breaks the engine with an
  ``error`` terminal in every record, a prefill chunk's MemoryError preempts.
"""

from __future__ import annotations

import types
from collections import Counter

import jax
import numpy as np
import pytest

from cyberfabric_core_tpu.modkit import failpoints as jfp
from cyberfabric_core_tpu.modkit import flight_recorder as jfr
from cyberfabric_core_tpu.modkit import telemetry as jtel
from cyberfabric_core_tpu.runtime import EngineConfig as JEngineConfig
from cyberfabric_core_tpu.runtime import SamplingParams as JSamplingParams
from cyberfabric_core_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from cyberfabric_core_tpu_torch.modkit import failpoints as pfp
from cyberfabric_core_tpu_torch.modkit import flight_recorder as pfr
from cyberfabric_core_tpu_torch.modkit import telemetry as ptel
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax


class _Clock:
    def __init__(self) -> None:
        self.now = 1_700_000_000.0

    def time(self) -> float:
        return self.now

    def tick(self, s: float) -> None:
        self.now += s


@pytest.fixture()
def recorders(monkeypatch):
    clock = _Clock()
    fake = types.SimpleNamespace(time=clock.time, monotonic=clock.time)
    for mod in (jfr, pfr):
        monkeypatch.setattr(mod, "time", fake)
    return clock


def _script(rec, clock) -> None:
    """Every case of JAX's recorder tests, one after the other."""
    ev = rec.record
    # lifecycle with derived figures (ttft, queue wait, itl, recovery, e2e)
    ev("a", "enqueued", prompt_tokens=12, trace_id="ab" * 16, tenant="t1")
    clock.tick(0.010)
    ev("a", "admitted", tenant="t1", queue_wait_ms=10.0)
    clock.tick(0.020)
    ev("a", "prefill_chunk", slot=0, tokens=8, pos=8, of=12)
    clock.tick(0.005)
    ev("a", "prefill", slot=0, mixed=True, prompt_tokens=12)
    for _ in range(3):
        clock.tick(0.012)
        ev("a", "decode_chunk", slot=0, tokens=4, depth=2)
    ev("a", "preempted", slot=0, phase="decode", length=25)
    clock.tick(0.050)
    ev("a", "resumed", slot=1, phase="decode", pause_ms=50.0)
    clock.tick(0.007)
    ev("a", "decode_chunk", slot=1, tokens=4, depth=0)
    ev("a", "finished", reason="length", tokens=17)
    rec.annotate("a", model="m", tenant="t1")
    # failover: error → failover reopens the same record → finished
    ev("f", "enqueued", prompt_tokens=3)
    ev("f", "admitted")
    ev("f", "error", detail="replica broke")
    clock.tick(0.002)
    ev("f", "failover", from_replica=0, to_replica=1, tokens_carried=2)
    ev("f", "enqueued", prompt_tokens=5)
    ev("f", "finished", reason="stop", tokens=4)
    ev("f", "finished", reason="stop", tokens=4)  # a duplicate terminal is dropped
    # a client retry of a finished id starts a fresh record
    ev("a", "enqueued", prompt_tokens=2)
    # stalled: never creates a record; marks a live one until progress
    ev("ghost", "stalled", watchdog="stream_stall")
    ev("s", "enqueued")
    ev("s", "admitted")
    ev("s", "prefill", slot=2)
    clock.tick(40.0)
    ev("s", "stalled", watchdog="stream_stall", stalled_for_s=40.0)
    # an error terminal; a cancellation terminal
    ev("e", "enqueued")
    ev("e", "error", detail="boom")
    ev("c", "enqueued")
    ev("c", "cancelled", reason="client_disconnect", phase="queued", tokens=0)
    # lifecycle episodes ride the same recorder
    ev("pool1/replica0/drain-1", "drain_begin", replica=0, deadline_s=5.0)
    # the bounds: live (force-close as evicted), finished ring, events per record
    for i in range(6):
        ev(f"x{i}", "enqueued")
    for i in range(10):
        ev("long", "decode_chunk", slot=3, tokens=1, depth=i)
    for i in range(4):
        ev(f"y{i}", "enqueued")
        ev(f"y{i}", "finished", reason="stop")


def _view(rec) -> dict:
    ids = ["a", "f", "ghost", "s", "e", "c", "pool1/replica0/drain-1", "long"] + \
        [f"x{i}" for i in range(6)] + [f"y{i}" for i in range(4)]
    return {"lookup": {rid: rec.lookup(rid) for rid in ids},
            "inflight": sorted(rec.inflight(), key=lambda r: r["request_id"]),
            "stalled": rec.inflight(stalled_only=True),
            "recent": rec.recent(50), "stats": rec.stats()}


def test_recorders_agree_on_every_case(recorders):
    views = []
    for mod in (jfr, pfr):
        rec = mod.FlightRecorder(max_live=8, max_finished=6, max_events=6)
        start = recorders.now
        _script(rec, recorders)
        views.append(_view(rec))
        recorders.now = start
    assert views[1] == views[0]
    port = views[1]
    assert port["lookup"]["ghost"] is None
    assert port["stats"]["evicted_live"] > 0
    assert port["lookup"]["long"]["dropped_events"] > 0


def test_terminal_listener_payloads_agree(recorders):
    payloads = []
    for mod in (jfr, pfr):
        rec = mod.FlightRecorder()
        seen: list = []
        rec.add_listener(seen.append)
        rec.add_listener(lambda p: 1 / 0)  # a failing observer never fails serving
        start = recorders.now
        _script(rec, recorders)
        payloads.append(seen)
        recorders.now = start
    assert payloads[1] == payloads[0] and payloads[1]


def test_record_event_never_raises(monkeypatch):
    monkeypatch.setattr(pfr.default_recorder, "record", lambda *a, **k: 1 / 0)
    pfr.record_event("r", "enqueued")
    pfr.annotate_request("r", model="m")


# ------------------------------------------------------------ engine storm
OPTS = dict(model="tiny-llama", max_seq_len=128, max_batch=2, decode_chunk=4,
            use_flash=False, prefix_cache_pages=64, prefix_page_size=8, dtype="float32",
            decode_lookahead=2, prefill_budget_tokens=16)
PROMPTS = [np.random.default_rng(0).integers(3, 500, n).tolist() for n in (20, 37, 12)]
#: request 1's trace is unsampled
TRACES = [f"00-{i + 1:032x}-{'cd' * 8}-{'00' if i == 1 else '01'}" for i in range(3)]


class _Collect:
    def __init__(self) -> None:
        self.spans = []

    def export(self, span, duration_ms) -> None:
        self.spans.append(span)


def _storm(engine, sampling_cls, recorder, fp, prefix, traced) -> tuple[dict, dict]:
    """Drive ``engine`` round by round on this thread: every request queued
    first, the page_alloc failpoint armed (once, as a MemoryError) when the
    first slot decodes."""
    engine.start = lambda: None
    outs: dict[str, list[int]] = {}
    for i, prompt in enumerate(PROMPTS):
        rid = f"{prefix}{i}"
        outs[rid] = []
        engine.submit(prompt, sampling_cls(max_tokens=16),
                      lambda ev, rid=rid: outs[rid].append(ev.token_id),
                      request_id=rid, trace=TRACES[i] if traced else None)
    armed = False
    try:
        for _ in range(300):
            engine._service_cancellations()
            engine._admit()
            if not engine.active.any() and not engine._prefill_slots \
                    and engine._pending.empty() and not engine._suspended:
                break
            if engine.active.any() and not armed:
                fp.arm("scheduler.page_alloc", "1*raise(MemoryError)")
                armed = True
            engine._decode_round()
    finally:
        fp.reset()
    kinds = {rid: [(e["event"], sorted(set(e) - {"ts", "event"}))
                   for e in recorder.lookup(rid)["timeline"]] for rid in outs}
    return kinds, outs


@pytest.fixture(scope="module")
def storms():
    jeng = JEngine(JEngineConfig(**OPTS), seed=0)
    state = params_from_jax(jax.tree.map(np.asarray, jeng.params), get_config("tiny-llama"))
    jsink, psink = _Collect(), _Collect()
    jprev, pprev = jtel.get_global_tracer(), ptel.get_global_tracer()
    jtel.set_global_tracer(jtel.Tracer(exporter=jsink))
    ptel.set_global_tracer(ptel.Tracer(exporter=psink))
    try:
        jkinds, jouts = _storm(jeng, JSamplingParams, jfr.default_recorder, jfp, "jx", True)
        peng = ContinuousBatchingEngine(EngineConfig(**OPTS), params=state, device="cpu")
        pkinds, pouts = _storm(peng, SamplingParams, pfr.default_recorder, pfp, "pt", True)
        untraced = ContinuousBatchingEngine(EngineConfig(**OPTS), params=state, device="cpu")
        ukinds, uouts = _storm(untraced, SamplingParams, pfr.default_recorder, pfp, "un", False)
        stats = peng.stats()
    finally:
        jtel.set_global_tracer(jprev)
        ptel.set_global_tracer(pprev)
    return {"jax": (jkinds, jouts, jsink.spans), "port": (pkinds, pouts, psink.spans),
            "untraced": (ukinds, uouts), "stats": stats, "port_spans_total": len(psink.spans)}


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_each_request_has_jax_s_events_and_attribute_keys(storms, i):
    jkinds, pkinds = storms["jax"][0][f"jx{i}"], storms["port"][0][f"pt{i}"]
    assert pkinds == jkinds
    kinds = [k for k, _ in pkinds]
    assert kinds[:2] == ["enqueued", "admitted"] and kinds[-1] == "finished"
    assert "prefill_chunk" in kinds and "decode_chunk" in kinds


def test_the_forced_preemption_lands_in_one_timeline(storms):
    assert storms["stats"]["preemptions"] == 1
    timelines = [[k for k, _ in t] for t in storms["port"][0].values()]
    pre = [t for t in timelines if "preempted" in t]
    assert len(pre) == 1 and pre[0].index("preempted") < pre[0].index("resumed")


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_each_request_has_jax_s_sampled_spans(storms, i):
    tid = TRACES[i].split("-")[1]

    def names(spans):
        return Counter(s.name for s in spans if s.trace_id == tid)

    jnames, pnames = names(storms["jax"][2]), names(storms["port"][2])
    assert pnames == jnames
    if TRACES[i].endswith("-00"):
        assert not pnames  # an unsampled trace emits nothing
    else:
        assert pnames["llm.prefill"] == 1 and pnames["llm.decode_chunk"] > 0
        assert all(s.parent_id == "cd" * 8 for s in storms["port"][2] if s.trace_id == tid)


def test_streams_are_identical_with_tracing_on_and_off(storms):
    port, untraced = storms["port"][1], storms["untraced"][1]
    for i in range(len(PROMPTS)):
        assert port[f"pt{i}"] == untraced[f"un{i}"] == storms["jax"][1][f"jx{i}"]
    # the untraced storm's event kinds are the traced one's
    assert [[k for k, _ in t] for t in storms["untraced"][0].values()] == \
        [[k for k, _ in t] for t in storms["port"][0].values()]


# ------------------------------------------------------------ failpoint sites
@pytest.mark.parametrize("point,spec,mixed,broken", [
    ("scheduler.prefill", "1*raise", False, False),      # only that request errors
    ("scheduler.readback", "1*raise", True, True),       # the drain: the engine breaks
    ("scheduler.admit", "1*raise", True, True),
    ("scheduler.prefill_chunk", "1*raise(MemoryError)", True, False),  # a preemption
])
def test_failpoint_sites_end_requests_as_jax_s_do(point, spec, mixed, broken):
    """Each point sits where JAX's does: an injected prefill fault errors
    one admission and the engine serves on; a readback or admission fault
    breaks the engine and every stream gets one ``error`` terminal in its
    record; a MemoryError at a prefill chunk's growth preempts mid-prefill
    and the streams finish."""
    engine = ContinuousBatchingEngine(EngineConfig(**{**OPTS, "mixed_batch": mixed}),
                                      device="cpu")
    engine.start = lambda: None
    finished: dict[str, str] = {}
    rids = []
    for i, prompt in enumerate(PROMPTS[:2]):
        rid = f"fp-{point}-{i}"
        rids.append(rid)
        engine.submit(prompt, SamplingParams(max_tokens=8),
                      lambda ev, rid=rid: ev.finished and finished.setdefault(rid, ev.finished),
                      request_id=rid)
    pfp.arm(point, spec)
    try:
        for _ in range(100):
            if len(finished) == len(rids):
                break
            try:
                engine._service_cancellations()
                engine._admit()
                if engine.active.any() or engine._prefill_slots:
                    engine._decode_round()
            except Exception as e:  # noqa: BLE001 — the loop's fault path
                engine._broken = str(e)
                engine._fail_all_inflight("scheduler loop failed")
    finally:
        pfp.reset()
    last = {rid: pfr.default_recorder.lookup(rid)["timeline"][-1]["event"] for rid in rids}
    assert (engine._broken is not None) == broken
    if broken:
        assert set(finished.values()) == {"error"} and set(last.values()) == {"error"}
    elif point == "scheduler.prefill":
        assert sorted(finished.values()) == ["error", "length"]
        assert sorted(last.values()) == ["error", "finished"]
    else:
        assert set(finished.values()) == {"length"} and engine.preemptions == 1
        kinds = [e["event"] for e in pfr.default_recorder.lookup(rids[0])["timeline"]]
        assert "preempted" in kinds and "resumed" in kinds
    engine.close()
