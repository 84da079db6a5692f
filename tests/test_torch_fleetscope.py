"""The fleet's observability through the port, against the JAX package: the
``FleetDoctor`` fold (hostile payloads, stale reports, worst-of merge), the
``FleetView`` documents and its host-labelled exposition
(``merge_metric_samples``, ``render_with``), ``stitch_timelines`` and the
hung host's timeout, and the worker's census with its off switch. The same
payloads go through both packages, and the documents must be equal."""

from __future__ import annotations

import asyncio
import time

import pytest

from cyberfabric_core_tpu.modkit import doctor as jdoctor
from cyberfabric_core_tpu.modkit.metrics import MetricsRegistry as JRegistry
from cyberfabric_core_tpu.runtime import federation as jfed
from cyberfabric_core_tpu_torch.modkit import doctor as pdoctor
from cyberfabric_core_tpu_torch.modkit.metrics import MetricsRegistry as PRegistry
from cyberfabric_core_tpu_torch.runtime import federation as pfed

#: (federation module, doctor module, metrics registry class) of each package
IMPLS = {"jax": (jfed, jdoctor, JRegistry), "port": (pfed, pdoctor, PRegistry)}
TIMING_KEYS = {"lease_age_s", "expires_in_s", "evicted_at"}


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in TIMING_KEYS}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _payload(state="healthy", reasons=(), objectives=(), trips=None, shed=(), evals=3,
             terminals=0, metrics=None):
    return {"metrics": dict(metrics or {}),
            "doctor": {"state": state, "state_since": 1000.0, "reasons": list(reasons),
                       "objectives": list(objectives), "watchdog_trips": dict(trips or {}),
                       "shed_tenants": list(shed), "evals": evals},
            "terminals": [{}] * terminals, "ts": 1000.0}


def _both(fn):
    """``fn(impl)`` through both packages; they must agree."""
    port = fn("port")
    assert port == fn("jax")
    return port


# ------------------------------------------------------------- FleetDoctor
HOSTILE = [None, "garbage", 42, [], {"doctor": "not-a-dict"},
           {"doctor": {"state": 17, "reasons": 3.5}},
           {"doctor": {"state": "nonsense-state"}},
           {"doctor": {"watchdog_trips": {"x": "NaNopolis"}}},
           {"doctor": {"state_since": "yesterday"}},
           {"terminals": {"not": "a list"}}]


@pytest.mark.parametrize("hostile", HOSTILE, ids=repr)
def test_hostile_payload_degrades_as_in_jax(hostile):
    def run(impl):
        fd = IMPLS[impl][1].FleetDoctor()
        row = fd.on_report("evil", hostile)
        return row, fd.on_report("h2", _payload()), fd.merge()

    row, ok, _ = _both(run)
    assert row["state"] in ("unknown", "healthy") and ok["state"] == "healthy"


def test_fold_merge_and_stale_decay_equal_jax():
    def run(impl):
        fd = IMPLS[impl][1].FleetDoctor()
        out = [fd.on_report("a", _payload()),
               fd.on_report("b", _payload("degraded", ["slo:itl_p99"], terminals=4,
                                          trips={"stream_stall": 2}, shed=["acme"],
                                          objectives=[{"objective": "itl_p99",
                                                       "burn_fast": 2.5}])),
               fd.on_report("c", _payload("recovering")),
               fd.on_report("silent", _payload("shedding", ["slo:itl_p99"]), stale=True)]
        out += [fd.merge(), fd.host_states()]
        fd.retain(["a", "c"])
        fd.forget("c")
        out += [fd.merge(), fd.host_states()]
        return out

    out = _both(run)
    assert out[4]["state"] == "degraded"
    assert any("host b degraded: slo:itl_p99" in r for r in out[4]["reasons"])
    assert any("silent" in r and "stale" in r for r in out[4]["reasons"])
    assert "silent" not in out[5] and out[7] == {"a": "healthy"}


# ------------------------------------------------- FleetView metric merge
def _snap(name="llm_tokens_total", value=7.0, labels=None, kind="counter"):
    return {name: {"type": kind, "help": "t", "samples": [[dict(labels or {}), value]]}}


SNAPS = {
    "conserves": {"h0": _snap(value=7.0, labels={"model": "m"}),
                  "h1": _snap(value=3.0, labels={"model": "m"})},
    "host-label-wins": {"real-host": _snap(labels={"host": "spoofed"})},
    "hostile": {"h0": "not a snapshot",
                "h1": {"llm_x": "not a family",
                       "llm_ok": {"type": "counter", "help": "",
                                  "samples": [["bad-pair"], [{"a": "b"}, 1.0]]}}},
}


@pytest.mark.parametrize("name", sorted(SNAPS))
def test_merge_metric_samples_equals_jax(name):
    merged = _both(lambda impl: IMPLS[impl][0].FleetView.merge_metric_samples(SNAPS[name]))
    if name == "conserves":
        assert sorted((s[0]["host"], s[1]) for s in merged["llm_tokens_total"]["samples"]) \
            == [("h0", 7.0), ("h1", 3.0)]
    if name == "host-label-wins":
        assert merged["llm_tokens_total"]["samples"][0][0]["host"] == "real-host"
    if name == "hostile":
        assert "llm_x" not in merged and len(merged["llm_ok"]["samples"]) == 1


def _registry(fed, lease_ttl_s=5.0):
    reg = fed.WorkerRegistry(lease_ttl_s=lease_ttl_s)
    for host in ("h0", "h1"):
        reg.announce({"instance_id": f"i-{host}", "host": host,
                      "endpoint": f"127.0.0.1:{1000 + int(host[1])}", "models": ["m"]})
    return reg


HIST = {"llm_itl_ms": {"type": "histogram", "help": "itl", "samples": [
    [{}, {"buckets": {"5.0": 2, "50.0": 5}, "sum": 61.0, "count": 5}]]}}

#: name → (h0's payload, h1's payload, h1 aged past its lease, host_metrics)
VIEWS = {
    "two-hosts": (_payload(metrics=_snap(value=7.0)), _payload(metrics=_snap(value=3.0)),
                  False, True),
    "stale-host": (_payload(), _payload(), True, True),
    "histogram": (_payload(metrics=HIST), _payload(), False, True),
    "degraded-host": (_payload("degraded", ["burn"]), _payload(), False, True),
    "host-metrics-off": (_payload(metrics=_snap(value=7.0)), _payload(), False, False),
}


@pytest.mark.parametrize("name", sorted(VIEWS))
def test_fleet_view_documents_and_exposition_equal_jax(name):
    p0, p1, stale, host_metrics = VIEWS[name]

    def run(impl):
        fed, _, registry_cls = IMPLS[impl]
        reg = _registry(fed, lease_ttl_s=1.0 if stale else 5.0)
        view = fed.FleetView(reg, host_metrics=host_metrics)
        reg.heartbeat("i-h0", {"observability": p0})
        reg.heartbeat("i-h1", {"observability": p1})
        if stale:
            reg.lookup("i-h1").last_heartbeat = time.time() - 2.0
        gw = registry_cls()
        gw.counter("llm_tokens_total", "t").inc(11.0)
        return (view.render_with(gw), _strip(view.report()), view.metric_snapshots(),
                view.host_states(), view.readiness_reasons())

    text, report, snaps, states, reasons = _both(run)
    families = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")]
    assert len(families) == len(set(families))
    assert "llm_tokens_total 11" in text
    if name == "two-hosts":
        assert 'llm_tokens_total{host="h0"} 7' in text
        assert 'llm_remote_workers_healthy{host="h1"} 1' in text
    if name == "stale-host":
        assert 'llm_remote_workers_healthy{host="h1"} 0' in text and set(snaps) == {"h0"}
    if name == "histogram":
        assert 'llm_itl_ms_bucket{host="h0",le="+Inf"} 5' in text
    if name == "degraded-host":
        assert report["state"] == "degraded" and any("h0" in r for r in reasons)
    if name == "host-metrics-off":
        assert snaps == {} and 'host="h0"} 7' not in text and states


# ------------------------------------------------------ timeline stitching
T = 1000.0
STITCHES = {
    "failover-story": (
        {"request_id": "r1", "trace_id": "T", "timeline": [
            {"event": "enqueued", "ts": T},
            {"event": "failover", "ts": T + 2.0, "from_host": "a", "carried_tokens": 3}]},
        {"a": {"state": "finished", "trace_id": "T",
               "timeline": [{"event": "decode_chunk", "ts": T + 1.0}]},
         "b": {"state": "finished", "trace_id": "T",
               "timeline": [{"event": "decode_chunk", "ts": T + 3.0}]}}),
    "hostile-segments": (
        {"request_id": "r1", "timeline": [{"event": "enqueued", "ts": 1.0}]},
        {"bad1": "not a record", "bad2": {"timeline": "not a list"},
         "bad3": {"timeline": [17, {"event": "ok", "ts": "NaNopolis"}]}}),
}


@pytest.mark.parametrize("name", sorted(STITCHES))
def test_stitch_timelines_equals_jax(name):
    gw, segments = STITCHES[name]
    doc = _both(lambda impl: IMPLS[impl][0].stitch_timelines(gw, segments))
    assert doc["stitched"] is True
    if name == "failover-story":
        assert [e["origin"] for e in doc["timeline"]] == ["gateway", "a", "gateway", "b"]
    else:
        assert [e["event"] for e in doc["timeline"]] == ["ok", "enqueued"]


def test_a_hung_host_costs_the_stitch_timeout_not_a_hang():
    class HungObsClient:
        async def timeline(self, request_id):
            await asyncio.sleep(60)

    pool = pfed.FederatedServingPool(_registry(pfed), lambda w: None, dict,
                                     pfed.FederationConfig(stitch_timeout_s=0.05),
                                     obs_client_factory=lambda w: HungObsClient())

    async def run():
        t0 = time.monotonic()
        seg = await pool.fetch_remote_timeline("h0", "rid-1")
        unknown = await pool.fetch_remote_timeline("no-such-host", "rid-1")
        return seg, unknown, time.monotonic() - t0

    seg, unknown, took = asyncio.run(run())
    assert seg is None and unknown is None and took < 5.0


# ---------------------------------------------------- the worker's census
def test_worker_census_shape_and_off_switch_as_in_jax():
    from cyberfabric_core_tpu.modules.llm_gateway.worker import LocalTpuWorker
    from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import LocalTorchWorker

    shapes = {}
    for impl, worker in (("jax", LocalTpuWorker({})),
                         ("port", LocalTorchWorker({"device": "cpu"}))):
        obs = worker.observability_census()
        census = worker.federation_census()
        shapes[impl] = (sorted(obs), sorted(obs["doctor"]), sorted(census))
        assert all(name.startswith("llm_") for name in obs["metrics"])
        # the fold on the gateway's side takes the payload as sent
        assert IMPLS[impl][1].FleetDoctor().on_report("w", obs)["state"] == \
            obs["doctor"]["state"]
    assert shapes["port"] == shapes["jax"]
    assert set(shapes["port"][2]) >= {"load", "capacity", "models", "prefix", "observability"}
    off = {"jax": LocalTpuWorker({"observability": {"enabled": False}}),
           "port": LocalTorchWorker({"device": "cpu", "observability": {"enabled": False}})}
    for worker in off.values():
        assert worker.observability_census() is None
        assert "observability" not in worker.federation_census()


def test_readiness_carries_the_fleet_reasons_as_in_jax():
    """The fleet feed's host reasons ride on /readyz's reasons (at most 8),
    a feed that raises costs nothing, and the local state keeps the
    verdict."""
    def run(impl):
        doc = IMPLS[impl][1].Doctor()
        out = [doc.readiness()]
        doc.set_fleet_provider(lambda: [f"host h{i} degraded: burn" for i in range(12)])
        out.append(doc.readiness())
        doc.set_fleet_provider(lambda: 1 / 0)
        out.append(doc.readiness())
        doc.set_fleet_provider(None)
        out.append(doc.readiness())
        return out

    out = _both(run)
    assert out[1][0] is True and len(out[1][2]) == 8 and out[1][2][0] == "host h0 degraded: burn"
    assert out[2] == out[0] == out[3]
