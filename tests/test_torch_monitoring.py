"""The port's monitoring module on its HTTP host, on the CPU, against the
JAX package's (``modules/monitoring.py``, ``gateway/`` tracing and health).

A ``BackgroundServer`` boots the port's quickstart with the worker on the
CPU, ``monitoring`` and ``tracing`` on, and a fresh metrics registry:

- the ``/metrics`` family set equals the families JAX's
  ``MonitoringModule.init`` registers (run against a stub context, the
  federation's included) together with those the chat path's emit sites
  create (the HTTP counter and latency, ttft, queue wait, itl, tokens);
- each ``/v1/monitoring/*`` route answers with the status and problem code
  of its JAX test (``tests/test_e2e_server.py:317, 658-771``,
  ``tests/test_observability_device.py``, ``tests/test_doctor.py``): the
  flight recorder's timeline by request id, the live table and its
  ``?stalled=`` filter, the rounds as chrome trace, the replica table and
  its refusals, tenants, the SLO report, the profiler's start and stop on
  the CPU profiler, and failpoints (403 without ``allow_fault_injection``;
  armed, an injected preemption lands in the timeline);
- one chat is one trace: the HTTP span and the engine's ``llm.prefill`` and
  ``llm.decode_chunk`` spans carry the client's trace id, which the
  recorder keeps; with an ``otlp_endpoint`` they reach a collector.
"""

from __future__ import annotations

import asyncio
import http.client
import http.server
import json
import threading

import pytest

from cyberfabric_core_tpu_torch.modkit import doctor as pdoctor
from cyberfabric_core_tpu_torch.modkit import failpoints as pfp
from cyberfabric_core_tpu_torch.modkit import metrics as pmetrics

TRACE_ID = "4bf92f3577b34da6a3ce929d0e0e4736"
TRACEPARENT = f"00-{TRACE_ID}-00f067aa0ba902b7-01"
CHAT = {"model": "default-chat", "max_tokens": 24,
        "messages": [{"role": "user", "content": [{"type": "text", "text": "trace me"}]}]}
#: families the chat path's emit sites create (JAX: gateway middleware,
#: flight recorder terminals, ``_observe_ttft``, ``UsageTracker.report``)
EMIT_SITE_FAMILIES = {"http_requests_total", "http_request_duration_seconds",
                      "llm_ttft_seconds", "llm_queue_wait_seconds", "llm_itl_seconds",
                      "llm_tokens_total"}


def _config(home, allow_fault_injection=False, tracing=None):
    from cyberfabric_core_tpu_torch import server

    cfg = json.loads(server.QUICKSTART.read_text())
    cfg["server"] = {"home_dir": str(home)}
    cfg["tracing"] = tracing or {"enabled": True, "sample_ratio": 1.0}
    cfg["modules"]["api_gateway"]["config"]["bind_addr"] = "127.0.0.1:0"
    cfg["modules"]["llm_gateway"]["config"]["worker"]["device"] = "cpu"
    cfg["modules"]["monitoring"] = {"config": {
        "allow_fault_injection": allow_fault_injection,
        "doctor": {"eval_interval_s": 30.0}}}
    return cfg


@pytest.fixture(scope="module")
def registry():
    """A fresh registry in every module that holds the process-global one."""
    from cyberfabric_core_tpu_torch.gateway import middleware
    from cyberfabric_core_tpu_torch.modules import monitoring
    from cyberfabric_core_tpu_torch.modules.llm_gateway import module as llm_module

    fresh = pmetrics.MetricsRegistry()
    mp = pytest.MonkeyPatch()
    for mod in (pmetrics, pdoctor, middleware, monitoring, llm_module):
        mp.setattr(mod, "default_registry", fresh)
    yield fresh
    mp.undo()


class _Collector(http.server.BaseHTTPRequestHandler):
    spans: list = []

    def do_POST(self):  # noqa: N802 — the handler protocol's name
        body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
        for rs in body["resourceSpans"]:
            for ss in rs["scopeSpans"]:
                type(self).spans.extend(ss["spans"])
        self.send_response(200)
        self.end_headers()

    def log_message(self, *args):
        pass


@pytest.fixture(scope="module")
def collector():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _Collector)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv
    srv.shutdown()


@pytest.fixture(scope="module")
def host(registry, collector, tmp_path_factory):
    from cyberfabric_core_tpu_torch.server import BackgroundServer

    home = tmp_path_factory.mktemp("home")
    srv = BackgroundServer(_config(home, tracing={
        "enabled": True, "sample_ratio": 1.0, "service_name": "port-test",
        "otlp_endpoint": f"http://127.0.0.1:{collector.server_port}"})).start()
    port = srv.port
    status, _, body = _request(port, "POST", "/v1/chat/completions", CHAT,
                               {"x-request-id": "mon-1", "traceparent": TRACEPARENT})
    assert status == 200, body
    yield {"port": port, "srv": srv, "home": home}
    srv.stop()


def _request(port, method, path, body=None, headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    try:
        conn.request(method, path, body=None if body is None else json.dumps(body).encode(),
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        data = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    try:
        return resp.status, hdrs, json.loads(data)
    except ValueError:
        return resp.status, hdrs, data.decode()


def _jax_init_families() -> set:
    """The families JAX's ``MonitoringModule.init`` registers, on a fresh
    registry, against a stub context without a worker."""
    from cyberfabric_core_tpu.modkit import doctor as jdoctor
    from cyberfabric_core_tpu.modkit.metrics import MetricsRegistry
    from cyberfabric_core_tpu.modules.monitoring import MonitoringModule

    class Hub:
        def __init__(self):
            self.items = {}

        def register(self, key, value):
            self.items[key] = value

        def try_get(self, key):
            return self.items.get(key)

    class Ctx:
        client_hub = Hub()

        def raw_config(self):
            return {}

    mod = MonitoringModule()
    mod.registry = MetricsRegistry()
    asyncio.run(mod.init(Ctx()))
    jdoctor.default_doctor.set_scheduler_provider(None)
    jdoctor.default_doctor.set_capacity_provider(None)
    return set(mod.registry._metrics)


def _families(text: str) -> set:
    return {line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")}


def test_metrics_family_set_equals_jax_s(host):
    status, hdrs, text = _request(host["port"], "GET", "/metrics")
    assert status == 200 and hdrs["content-type"].startswith("text/plain")
    assert _families(text) == _jax_init_families() | EMIT_SITE_FAMILIES
    for needle in ("http_requests_total", "llm_tokens_total", "llm_ttft_seconds_bucket",
                   "tpu_devices", "llm_batch_active_slots"):
        assert needle in text
    assert "tpu_devices 0.0" in text  # engines on the CPU
    assert 'llm_ttft_seconds_count{model="local::tiny-llama"} 1' in text


def test_healthz_and_readyz(host):
    status, _, doc = _request(host["port"], "GET", "/healthz")
    assert status == 200 and doc["status"] == "ok" and "uptime_s" in doc
    status, _, doc = _request(host["port"], "GET", "/readyz")
    assert status == 200 and doc == {"status": "ready", "state": "healthy", "reasons": []}


def test_request_timeline_and_live_table(host):
    port = host["port"]
    status, _, rec = _request(port, "GET", "/v1/monitoring/requests/mon-1")
    assert status == 200, rec
    kinds = [e["event"] for e in rec["timeline"]]
    assert kinds[:2] == ["enqueued", "admitted"] and kinds[-1] == "finished"
    assert {"prefill_chunk", "prefill", "decode_chunk"} <= set(kinds)
    assert rec["trace_id"] == TRACE_ID and rec["model"] == "local::tiny-llama"
    assert rec["derived"]["ttft_ms"] is not None and rec["phase"] == "finished"
    status, _, table = _request(port, "GET", "/v1/monitoring/requests")
    assert status == 200 and {"in_flight", "recent", "recorder"} <= set(table)
    assert any(r["request_id"] == "mon-1" for r in table["recent"])
    assert _request(port, "GET", "/v1/monitoring/requests?stalled=true")[2]["in_flight"] == []
    assert _request(port, "GET", "/v1/monitoring/requests?stalled=banana")[0] == 400
    assert _request(port, "GET", "/v1/monitoring/requests?recent=-1")[0] == 400
    status, _, prob = _request(port, "GET", "/v1/monitoring/requests/nope-404")
    assert status == 404 and prob["code"] == "unknown_request"


def test_rounds_export(host):
    port = host["port"]
    status, hdrs, doc = _request(port, "GET", "/v1/monitoring/rounds?format=chrome-trace")
    assert status == 200 and "attachment" in hdrs["content-disposition"]
    slices = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert slices
    for e in slices:
        assert {"name", "ph", "pid", "tid", "ts", "dur"} <= set(e)
        assert e["name"] in ("admit", "dispatch", "sync_wait", "host_emit") and e["dur"] >= 0
    assert any(e["ph"] == "M" and e["name"] == "process_name" for e in doc["traceEvents"])
    status, _, raw = _request(port, "GET", "/v1/monitoring/rounds?limit=3")
    assert status == 200 and all(len(r) <= 3 for r in raw["rounds"].values())
    assert any(raw["rounds"].values())
    status, _, prob = _request(port, "GET", "/v1/monitoring/rounds?format=xml")
    assert status == 400 and prob["code"] == "bad_export_format"


def test_replicas_surface(host):
    port = host["port"]
    status, _, doc = _request(port, "GET", "/v1/monitoring/replicas")
    assert status == 200, doc
    row = next(r for r in doc["replicas"] if r["model"] == "local::tiny-llama")
    assert row["state"] == "healthy" and row["pool"] is False
    assert row["supervisor"]["benched"] is False and row["engine"]["broken"] is None
    assert doc["capacity"]["replicas"] >= 1 and doc["capacity"]["serving"] >= 1
    idx = row["index"]
    status, _, prob = _request(port, "POST", f"/v1/monitoring/replicas/{idx}/drain",
                               {"deadline_s": 1.0})
    assert status == 409 and prob["code"] == "replica_conflict", prob
    status, _, prob = _request(port, "POST", "/v1/monitoring/replicas/99/restart")
    assert status == 404 and prob["code"] == "unknown_replica", prob
    assert _request(port, "POST", "/v1/monitoring/replicas/x/drain")[0] == 400
    status, _, prob = _request(
        port, "POST", f"/v1/monitoring/replicas/{idx}/restart?model=local::other")
    assert status == 409 and prob["code"] == "replica_conflict", prob
    assert _request(port, "GET", "/v1/monitoring/replicas/0/drain")[0] == 405


def test_tenants_and_slo(host):
    port = host["port"]
    status, _, doc = _request(port, "GET", "/v1/monitoring/tenants")
    assert status == 200 and doc["count"] == len(doc["tenants"]) >= 1
    row = next(r for r in doc["tenants"] if r["tenant"] == "default")
    assert row["charged_tokens"] > 0 and row["shed"] is False
    assert "local::tiny-llama" in row["per_model"]
    status, _, one = _request(port, "GET", "/v1/monitoring/tenants/default")
    assert status == 200 and one["tenant"] == "default"
    status, _, prob = _request(port, "GET", "/v1/monitoring/tenants/nobody")
    assert status == 404 and prob["code"] == "unknown_tenant"
    status, _, slo = _request(port, "GET", "/v1/monitoring/slo")
    assert status == 200 and slo["state"] == "healthy"
    assert {"state_history", "watchdog_trips", "config"} <= set(slo)


def test_profiler_start_stop_produces_a_chrome_trace(host):
    port, home = host["port"], host["home"]
    status, _, body = _request(port, "POST", "/v1/monitoring/profiler/start")
    assert status == 200 and body["status"] == "started"
    assert body["dir"].startswith(str(home / "profiles" / "trace-"))
    status, _, dup = _request(port, "POST", "/v1/monitoring/profiler/start")
    assert status == 409 and dup["code"] == "profiler_running"
    assert _request(port, "POST", "/v1/completions",
                    {"model": "default-chat", "prompt": "profiled", "max_tokens": 4})[0] == 200
    status, _, body = _request(port, "POST", "/v1/monitoring/profiler/stop")
    assert status == 200 and body["status"] == "stopped" and body["files"]
    trace = json.loads((home / "profiles" / body["dir"].rsplit("/", 1)[1]
                        / body["files"][0]).read_text())
    assert trace["traceEvents"]
    status, _, body = _request(port, "POST", "/v1/monitoring/profiler/stop")
    assert status == 400 and body["code"] == "profiler_not_running"


def test_failpoints_refused_without_fault_injection(host):
    port = host["port"]
    status, _, doc = _request(port, "GET", "/v1/monitoring/failpoints")
    assert status == 200 and doc["enabled"] is False
    assert "scheduler.readback" in doc["catalog"] and "federation.route" in doc["catalog"]
    assert "serverless.tick" not in doc["catalog"]
    for method, path, body in (("PUT", "/v1/monitoring/failpoints/scheduler.admit",
                                {"spec": "raise"}),
                               ("DELETE", "/v1/monitoring/failpoints/scheduler.admit", None),
                               ("DELETE", "/v1/monitoring/failpoints", None)):
        status, _, prob = _request(port, method, path, body)
        assert status == 403 and prob["code"] == "faultlab_disabled", (path, prob)


def test_armed_failpoints_over_rest(host):
    port, mon = host["port"], host["srv"].host.monitoring
    mon.allow_fault_injection = True
    try:
        status, _, prob = _request(port, "PUT", "/v1/monitoring/failpoints/no.such",
                                   {"spec": "raise"})
        assert status == 404 and prob["code"] == "unknown_failpoint"
        status, _, prob = _request(port, "PUT", "/v1/monitoring/failpoints/serverless.tick",
                                   {"spec": "raise"})
        assert status == 404 and "ROADMAP queue 1 item 17" in prob["detail"]
        status, _, body = _request(port, "PUT", "/v1/monitoring/failpoints/federation.route",
                                   {"spec": "raise"})
        assert status == 200 and body["armed"] == "federation.route"
        assert _request(port, "DELETE", "/v1/monitoring/failpoints/federation.route")[2] == \
            {"disarmed": True}
        # a host of a stack that is not federated is unknown
        status, _, prob = _request(port, "PUT", "/v1/monitoring/failpoints/scheduler.admit",
                                   {"spec": "raise", "host": "fedhost-0"})
        assert status == 404 and prob["code"] == "unknown_host"
        status, _, prob = _request(port, "PUT", "/v1/monitoring/failpoints/scheduler.admit",
                                   {"spec": "explode"})
        assert status == 400 and prob["code"] == "bad_failpoint_spec"
        status, _, _ = _request(port, "PUT",
                                "/v1/monitoring/failpoints/scheduler.page_alloc",
                                {"spec": "2*raise(MemoryError)"})
        assert status == 200
        try:
            status, _, body = _request(port, "POST", "/v1/chat/completions", CHAT,
                                       {"x-request-id": "mon-preempt"})
            assert status == 200, body
        finally:
            assert _request(port, "DELETE", "/v1/monitoring/failpoints")[0] == 200
        rec = _request(port, "GET", "/v1/monitoring/requests/mon-preempt")[2]
        kinds = [e["event"] for e in rec["timeline"]]
        assert "preempted" in kinds and kinds.index("preempted") < kinds.index("resumed")
        assert rec["derived"]["recovery_ms"] is not None
        # gateway.request: an injected raise is a problem, the control plane exempt
        assert _request(port, "PUT", "/v1/monitoring/failpoints/gateway.request",
                        {"spec": "raise"})[0] == 200
        status, _, prob = _request(port, "GET", "/v1/models")
        assert status == 500 and prob["code"] == "internal_error"
        status, _, doc = _request(port, "DELETE", "/v1/monitoring/failpoints/gateway.request")
        assert status == 200 and doc == {"disarmed": True}
    finally:
        mon.allow_fault_injection = False
        pfp.reset()


def test_one_chat_is_one_trace_under_the_client_s_trace_id(host, collector):
    from cyberfabric_core_tpu_torch.modkit.telemetry import get_global_tracer

    get_global_tracer().exporter.flush(timeout_s=5.0)
    spans = [s for s in _Collector.spans if s["traceId"] == TRACE_ID]
    names = {s["name"] for s in spans}
    assert {"http POST /v1/chat/completions", "llm.prefill", "llm.prefill_chunk",
            "llm.decode_chunk"} <= names, names
    http_span = next(s for s in spans if s["name"].startswith("http "))
    assert http_span["parentSpanId"] == "00f067aa0ba902b7"
    # the engine's spans hang off the HTTP span
    assert all(s["parentSpanId"] == http_span["spanId"] for s in spans
               if s["name"].startswith("llm."))
