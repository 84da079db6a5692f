"""The port's federated serving path across real processes: one port gateway
(``grpc_hub`` + ``llm_gateway`` with ``federation.enabled`` + ``monitoring``,
no engine of its own) routing over two port worker subprocesses
(``python -m cyberfabric_core_tpu_torch.modules.llm_gateway.worker``,
``"worker": {"device": "cpu"}``, tiny-llama), the scenarios of the JAX
package's ``tests/test_federation_e2e.py``:

* both hosts announce and ``GET /v1/monitoring/workers`` lists them;
* a repeated prefix lands on the host holding it (placement ``prefix``);
* ``GET /v1/monitoring/requests/{id}`` stitches the serving host's flight
  record into the gateway's under one request id;
* ``/v1/monitoring/fleet`` folds the hosts' heartbeats, and ``/metrics``
  carries their ``llm_*`` series labelled ``host``;
* a failpoint armed over REST with a ``host`` fires in that worker;
* each host's ``Health`` RPC names its device and its scheduler's rounds;
* a SIGKILL of the serving host mid-stream fails over to the survivor with
  the token stream bit-identical to the undisturbed one and one terminal.

And the wire against the JAX package: a port worker announces to a JAX
stack's hub, and the JAX gateway serves a completion through it with the
tokens of the port's in-process worker. Last, without federation: a host
serving its worker on its hub (``worker_service.expose``, a bearer token)
behind another host's ``remote_worker_endpoint``.
"""

import asyncio
import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from cyberfabric_core_tpu_torch.modkit.doctor import default_doctor
from cyberfabric_core_tpu_torch.modules.llm_gateway.grpc_service import (
    GrpcLlmWorkerClient, model_ref_dict)
from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import LocalTorchWorker
from cyberfabric_core_tpu_torch.modules.sdk import ModelInfo
from cyberfabric_core_tpu_torch.runtime.federation import digest_chain, match_depth, prompt_text
from cyberfabric_core_tpu_torch.server import BackgroundServer

ROOT = Path(__file__).resolve().parents[1]
MODEL_KEY = "local::tiny-llama"
# decode_chunk 2: a readback a two tokens, so a paced stream spans many chunks
ENGINE_OPTIONS = {"model_config": "tiny-llama", "max_seq_len": 256, "max_batch": 4,
                  "decode_chunk": 2, "dtype": "float32"}
MODEL_ENTRY = {"provider_slug": "local", "provider_model_id": "tiny-llama",
               "approval_state": "approved", "managed": True, "architecture": "llama",
               "format": "safetensors", "capabilities": {"chat": True, "streaming": True},
               "limits": {"max_input_tokens": 200, "max_output_tokens": 64},
               "engine_options": ENGINE_OPTIONS}
MODEL = ModelInfo(canonical_id=MODEL_KEY, provider_slug="local",
                  provider_model_id="tiny-llama", managed=True, architecture="llama",
                  engine_options=ENGINE_OPTIONS, limits=MODEL_ENTRY["limits"])
LEASE_TTL_S = 3.0

CONFIG = {
    "tracing": {"enabled": True, "sample_ratio": 1.0},
    "modules": {
        "api_gateway": {"config": {"bind_addr": "127.0.0.1:0", "auth_disabled": True}},
        "tenant_resolver": {}, "authn_resolver": {},
        "model_registry": {"config": {"models": [MODEL_ENTRY]}},
        # fast leases so the crash is seen within a second
        "grpc_hub": {"config": {"bind_addr": "127.0.0.1:0", "worker_lease_ttl_s": LEASE_TTL_S,
                                "eviction_interval_s": 0.5}},
        "llm_gateway": {"config": {"federation": {"enabled": True,
                                                  "failover_backoff_s": 0.01, "seed": 0}}},
        # this e2e holds routing and failover, not SLOs: a generous gateway
        # doctor (fault injection serves the cross-host arm)
        "monitoring": {"config": {
            "allow_fault_injection": True,
            "doctor": {"objectives": {"ttft_p95": {"threshold_ms": 120000.0, "budget": 0.5}},
                       "stream_stall_s": 300.0, "round_stall_floor_s": 300.0,
                       "queue_deadline_s": 300.0, "shed_after": 1000}}},
    },
}
#: the worker hosts' doctors: only a deliberate fault could degrade them
WORKER_OBSERVABILITY = {
    "allow_fault_injection": True,
    "doctor": {"objectives": {"itl_p99": {"threshold_ms": 120000.0},
                              "ttft_p95": {"threshold_ms": 120000.0},
                              "queue_wait_p95": {"threshold_ms": 120000.0},
                              "error_rate": {"budget": 1.0}},
               "stream_stall_s": 120.0, "round_stall_floor_s": 120.0,
               "queue_deadline_s": 120.0},
}

# >= 2 digest blocks (48 characters each), so the gossiped chain hints
PROMPT_A = "federated e2e prefix probe alpha " * 4
PROMPT_B = "federated e2e crash victim bravo " * 4


def _spawn_worker(hub_endpoint: str, host: str) -> subprocess.Popen:
    cfg = {"hub_endpoint": hub_endpoint, "host": host, "worker": {"device": "cpu"},
           "observability": WORKER_OBSERVABILITY, "models": [model_ref_dict(MODEL)],
           "heartbeat_interval_s": 0.25}
    env = {**os.environ, "FED_WORKER_CONFIG": json.dumps(cfg), "OMP_NUM_THREADS": "2"}
    return subprocess.Popen(
        [sys.executable, "-m", "cyberfabric_core_tpu_torch.modules.llm_gateway.worker"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)


def _read_ready(proc: subprocess.Popen, timeout_s: float = 120.0) -> dict:
    box: dict = {}
    reader = threading.Thread(target=lambda: box.setdefault("line", proc.stdout.readline()),
                              daemon=True)
    reader.start()
    reader.join(timeout_s)
    line = box.get("line")
    if not line:
        raise RuntimeError(f"worker gave no READY line (rc={proc.poll()})")
    return json.loads(line)


class _JaxFederatedStack:
    """A JAX gateway with grpc_hub and federation on, on a loop of its own."""

    def __init__(self) -> None:
        from cyberfabric_core_tpu.modkit import AppConfig, ClientHub, ModuleRegistry, RunOptions
        from cyberfabric_core_tpu.modkit.db import DbManager
        from cyberfabric_core_tpu.modkit.runtime import HostRuntime
        import cyberfabric_core_tpu.modules  # noqa: F401 — registers every module

        cfg = AppConfig.load_or_default(environ={}, cli_overrides={"modules": {
            "api_gateway": {"config": {"bind_addr": "127.0.0.1:0", "auth_disabled": True}},
            "tenant_resolver": {}, "authn_resolver": {}, "authz_resolver": {},
            "model_registry": {"config": {"models": [MODEL_ENTRY]}},
            "grpc_hub": {"config": {"bind_addr": "127.0.0.1:0"}},
            "llm_gateway": {"config": {"federation": {"enabled": True, "seed": 0}}}}})
        registry = ModuleRegistry.discover_and_build(enabled=cfg.module_names())
        self.rt = HostRuntime(RunOptions(config=cfg, registry=registry, client_hub=ClientHub(),
                                         db_manager=DbManager(in_memory=True)))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.rt.run_setup_phases(), self.loop).result(120)
        self.port = registry.get("api_gateway").instance.bound_port
        self.hub_endpoint = registry.get("grpc_hub").instance.endpoint

    def stop(self) -> None:
        self.rt.root_token.cancel()
        asyncio.run_coroutine_threadsafe(self.rt.run_stop_phase(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def request(port, method, path, body=None, headers=None):
    """(status, body: JSON or text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request(method, path, json.dumps(body) if body is not None else None,
                     {"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        raw = resp.read().decode()
        try:
            return resp.status, json.loads(raw)
        except json.JSONDecodeError:
            return resp.status, raw
    finally:
        conn.close()


@pytest.fixture(scope="module")
def fed():
    """The port gateway with two worker hosts, and a JAX federated gateway
    with one port worker host."""
    srv = BackgroundServer(CONFIG).start()
    # the token ids each placed host streamed, by request id (the pool's
    # ledger): the crash test holds the failover stream to them
    ledgers: dict[str, list[int]] = {}
    pool = srv.host.worker
    make_client = pool._factory

    def recording_client(w):
        client = make_client(w)
        inner = client.completion_stream

        async def completion_stream(model, prompt, params):
            async for chunk in inner(model, prompt, params):
                if chunk.token_id is not None:
                    ledgers.setdefault(params["_request_id"], []).append(chunk.token_id)
                yield chunk

        client.completion_stream = completion_stream
        return client

    pool._factory = recording_client
    jax_stack = _JaxFederatedStack()
    procs = [_spawn_worker(srv.host.hub.endpoint, f"fedhost-{i}") for i in range(2)]
    procs.append(_spawn_worker(jax_stack.hub_endpoint, "jaxfed-host"))
    try:
        ready = [_read_ready(p) for p in procs]
        state = {"srv": srv, "port": srv.port, "ready": ready[:2], "jax": jax_stack,
                 "jax_ready": ready[2], "ledgers": ledgers}
        # both hosts serve once before any test (their first request builds
        # nothing, but the prefix and the census start there)
        served, i = set(), 0
        deadline = time.monotonic() + 60.0
        while served != {"fedhost-0", "fedhost-1"}:
            assert time.monotonic() < deadline, f"warm-up reached only {served}"
            rid = f"fed-warm-{i}"
            status, body = request(srv.port, "POST", "/v1/completions",
                                   {"model": MODEL_KEY, "prompt": f"warm-up probe {i} " * 4,
                                    "max_tokens": 4}, {"X-Request-Id": rid})
            assert status == 200, body
            served.add(request(srv.port, "GET", f"/v1/monitoring/requests/{rid}")[1]
                       .get("worker_host"))
            i += 1
        yield state
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait(timeout=10)
            p.stdout.close()
        srv.stop()
        jax_stack.stop()


@pytest.fixture(autouse=True)
def _clear_doctor_shed():
    """The gateway's doctor is process-global: every test starts healthy."""
    default_doctor.configure(default_doctor.config)
    yield
    default_doctor.configure(default_doctor.config)


def on_gateway_loop(fed, coro):
    """``coro`` on the port gateway's event loop (grpc.aio binds its poller
    to the first loop that uses it)."""
    return asyncio.run_coroutine_threadsafe(coro, fed["srv"]._loop).result(120)


def completion(fed, prompt, rid, max_tokens=12):
    status, body = request(fed["port"], "POST", "/v1/completions",
                           {"model": MODEL_KEY, "prompt": prompt, "max_tokens": max_tokens},
                           {"X-Request-Id": rid})
    assert status == 200, body
    return body["content"][0]["text"]


def timeline(fed, rid):
    status, body = request(fed["port"], "GET", f"/v1/monitoring/requests/{rid}")
    assert status == 200, body
    return body


def wait_for(cond, timeout_s=30.0, interval_s=0.2):
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        got = cond()
        if got:
            return got
        time.sleep(interval_s)
    raise AssertionError("condition not met within timeout")


def workers_table(fed):
    status, body = request(fed["port"], "GET", "/v1/monitoring/workers")
    assert status == 200, body
    return body


def test_both_hosts_announce_and_are_listed(fed):
    body = wait_for(lambda: (lambda b: b if len(b["workers"]) == 2 else None)(
        workers_table(fed)))
    assert body["federation"] is True
    assert {w["host"] for w in body["workers"]} == {"fedhost-0", "fedhost-1"}
    for w in body["workers"]:
        assert w["expires_in_s"] > 0 and w["endpoint"] and w["models"] == [MODEL_KEY]
    iid = body["workers"][0]["instance_id"]
    status, row = request(fed["port"], "GET", f"/v1/monitoring/workers/{iid}")
    assert status == 200 and row["instance_id"] == iid
    status, problem = request(fed["port"], "GET", "/v1/monitoring/workers/nope")
    assert status == 404 and problem["code"] == "unknown_worker"


def test_repeated_prefix_lands_on_the_prefix_host(fed):
    text1 = completion(fed, PROMPT_A, "fed-e2e-a1")
    first_host = timeline(fed, "fed-e2e-a1")["worker_host"]
    assert first_host
    # the serving host gossips the prompt's resident prefix on a heartbeat
    chain = digest_chain(prompt_text(prompt=PROMPT_A))
    wait_for(lambda: any(
        w.host == first_host and match_depth(chain, w.census.get("prefix", {}).get(MODEL_KEY, ()))
        for w in fed["srv"].host.hub.registry.alive()))
    assert completion(fed, PROMPT_A, "fed-e2e-a2") == text1
    assert fed["ledgers"]["fed-e2e-a2"] == fed["ledgers"]["fed-e2e-a1"]
    tl = timeline(fed, "fed-e2e-a2")
    assert tl["worker_host"] == first_host
    admitted = [e for e in tl["timeline"] if e["event"] == "admitted" and "placement" in e]
    assert admitted and admitted[-1]["placement"] == "prefix"


def test_stitched_timeline_under_one_request_id(fed):
    completion(fed, "stitch this cross host story " * 4, "fed-e2e-s1")
    tl = wait_for(lambda: (lambda d: d if d.get("stitched") else None)(
        timeline(fed, "fed-e2e-s1")))
    host = tl["worker_host"]
    assert tl["origins"] == ["gateway", host]
    worker_events = [e for e in tl["timeline"] if e.get("origin") == host]
    assert worker_events and tl["segments"][host]["events"] == len(worker_events)
    assert {"enqueued", "finished"} <= {e["event"] for e in worker_events}
    ts = [float(e.get("ts") or 0.0) for e in tl["timeline"]]
    assert ts == sorted(ts)


def test_fleet_endpoint_lists_hosts_and_404s_unknown(fed):
    status, doc = request(fed["port"], "GET", "/v1/monitoring/fleet")
    assert status == 200 and doc["federation"] is True
    assert {h["host"] for h in doc["hosts"]} == {"fedhost-0", "fedhost-1"}
    for h in doc["hosts"]:
        assert h["state"] in ("healthy", "recovering") and h["lease_age_s"] < LEASE_TTL_S
    status, one = request(fed["port"], "GET", "/v1/monitoring/fleet?host=fedhost-1")
    assert status == 200 and [h["host"] for h in one["hosts"]] == ["fedhost-1"]
    status, problem = request(fed["port"], "GET", "/v1/monitoring/fleet?host=no-such")
    assert status == 404 and problem["code"] == "unknown_host"
    status, ready = request(fed["port"], "GET", "/readyz")
    assert status == 200


def test_host_labelled_worker_metrics_on_gateway(fed):
    def scrape():
        status, body = request(fed["port"], "GET", "/metrics")
        assert status == 200
        return body

    text = wait_for(lambda: (lambda t: t if (
        'llm_remote_workers_healthy{host="fedhost-0"} 1' in t
        and 'llm_remote_workers_healthy{host="fedhost-1"} 1' in t) else None)(scrape()))
    # the hosts' own llm_* series, each under its host's label
    assert re.search(r'^llm_(?!remote_workers_healthy)[a-z_]+\{[^}]*host="fedhost-[01]"', text,
                     re.M)
    assert "\nllm_remote_workers_healthy 2.0" in text
    families = [line.split()[2] for line in text.splitlines() if line.startswith("# TYPE ")]
    assert len(families) == len(set(families))


def test_failpoints_arm_and_disarm_on_a_worker_host(fed):
    port = fed["port"]
    path = "/v1/monitoring/failpoints/scheduler.readback"
    status, body = request(port, "PUT", path, {"spec": "delay(0.001)", "host": "fedhost-0"})
    assert status == 200 and body == {"armed": "scheduler.readback", "host": "fedhost-0"}
    status, body = request(port, "DELETE", f"{path}?host=fedhost-0")
    assert status == 200 and body == {"disarmed": True, "host": "fedhost-0"}
    status, problem = request(port, "PUT", path, {"spec": "raise", "host": "no-such"})
    assert status == 404 and problem["code"] == "unknown_host"
    status, problem = request(port, "PUT", "/v1/monitoring/failpoints/no.such",
                              {"spec": "raise", "host": "fedhost-1"})
    assert status == 404 and problem["code"] == "unknown_failpoint"
    status, problem = request(port, "PUT", path, {"spec": "explode", "host": "fedhost-1"})
    assert status == 400 and problem["code"] == "bad_failpoint_spec"


def test_health_rpc_names_the_device_and_the_rounds(fed):
    async def health(endpoint):
        client = GrpcLlmWorkerClient(endpoint=endpoint)
        try:
            return await client.health()
        finally:
            await client.close()

    for r in fed["ready"]:
        doc = on_gateway_loop(fed, health(r["endpoint"]))
        assert doc["devices"] == ["cpu"] and doc["loaded_models"] == [MODEL_KEY]
        sched = doc["schedulers"][MODEL_KEY]
        # rounds with prompt chunks went through the ragged path, decode
        # chunks ran (eagerly: the CPU captures no graph)
        assert sched["pipeline"]["mixed_rounds"] > 0 and doc["requests_served"] > 0
        assert sched["pipeline"]["decode_eager_chunks"] > 0


def _failovers(port) -> float:
    text = request(port, "GET", "/metrics")[1]
    return float(re.search(r"^llm_federated_failovers_total (\S+)$", text, re.M).group(1))


def test_midstream_sigkill_fails_over_bit_identical(fed):
    port, ready = fed["port"], fed["ready"]
    failovers_before = _failovers(port)
    baseline = completion(fed, PROMPT_B, "fed-e2e-b0", max_tokens=24)
    # pace both hosts' decode (each readback waits), so the kill lands
    # while the stream is still flowing
    for r in ready:
        assert request(port, "PUT", "/v1/monitoring/failpoints/scheduler.readback",
                       {"spec": "delay(0.05)", "host": r["host"]})[0] == 200
    rid = "fed-e2e-b1"
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    text, finishes, killed = [], [], None
    try:
        conn.request("POST", "/v1/completions",
                     json.dumps({"model": MODEL_KEY, "prompt": PROMPT_B, "max_tokens": 24,
                                 "stream": True}),
                     {"Content-Type": "application/json", "X-Request-Id": rid})
        resp = conn.getresponse()
        assert resp.status == 200 and resp.getheader("X-Request-Id") == rid
        for raw in resp:
            line = raw.decode().strip()
            if not line.startswith("data: ") or line == "data: [DONE]":
                continue
            chunk = json.loads(line[len("data: "):])
            if chunk.get("delta", {}).get("content"):
                text.append(chunk["delta"]["content"])
            if chunk.get("finish_reason"):
                finishes.append(chunk["finish_reason"])
            if text and killed is None:
                host = timeline(fed, rid)["worker_host"]
                victim = next(r for r in ready if r["host"] == host)
                os.kill(victim["pid"], signal.SIGKILL)
                killed = host
    finally:
        conn.close()
    survivor = next(r["host"] for r in ready if r["host"] != killed)
    assert request(port, "DELETE",
                   f"/v1/monitoring/failpoints/scheduler.readback?host={survivor}")[0] == 200
    assert killed, "no host was killed mid-stream"
    assert "".join(text) == baseline
    # bit-identical: the same token ids, the carried ones and the survivor's
    assert fed["ledgers"][rid] == fed["ledgers"]["fed-e2e-b0"]
    assert len(finishes) == 1 and finishes[0] in ("stop", "length")

    body = wait_for(lambda: (lambda b: b if len(b["workers"]) == 1 else None)(
        workers_table(fed)))
    assert body["workers"][0]["host"] == survivor
    assert any(e["host"] == killed and e["reason"] in ("crash", "lease_expired")
               for e in body["evicted"])
    tl = timeline(fed, rid)
    chunk_hosts = {e.get("worker_host") for e in tl["timeline"]
                   if e["event"] == "decode_chunk"} - {None}
    assert chunk_hosts == {killed, survivor}
    failovers = [e for e in tl["timeline"] if e["event"] == "failover"]
    assert len(failovers) == 1 and failovers[0]["carried_tokens"] >= 1
    assert tl["trace_id"]
    assert _failovers(port) == failovers_before + 1
    assert completion(fed, PROMPT_B, "fed-e2e-b2", max_tokens=24) == baseline


def test_port_worker_serves_a_jax_gateway(fed):
    """The wire both packages speak: the JAX gateway places a completion on
    a port worker host, which answers with the port's tokens."""
    from cyberfabric_core_tpu.modules.llm_gateway.grpc_service import \
        GrpcLlmWorkerClient as JaxClient
    from cyberfabric_core_tpu.modules.sdk import ModelInfo as JaxModelInfo

    prompt = "wire parity between the two packages " * 3
    jax_port = fed["jax"].port
    status, body = request(jax_port, "POST", "/v1/completions",
                           {"model": MODEL_KEY, "prompt": prompt, "max_tokens": 16})
    assert status == 200, body
    jax_text, jax_usage = body["content"][0]["text"], body["usage"]

    async def ids_over_the_wire():
        client = JaxClient(endpoint=fed["jax_ready"]["endpoint"])
        model = JaxModelInfo(canonical_id=MODEL_KEY, provider_slug="local",
                             provider_model_id="tiny-llama", managed=True,
                             architecture="llama", engine_options=ENGINE_OPTIONS,
                             limits=MODEL_ENTRY["limits"])
        try:
            return [c.token_id async for c in client.completion_stream(
                model, prompt, {"max_tokens": 16, "_fed_token_stream": True})
                if c.token_id is not None]
        finally:
            await client.close()

    async def ids_in_process():
        worker = LocalTorchWorker({"device": "cpu"})
        try:
            chunks = [c async for c in worker.completion_stream(
                MODEL, prompt, {"max_tokens": 16, "_fed_token_stream": True})]
        finally:
            worker.close()
        return ([c.token_id for c in chunks if c.token_id is not None],
                "".join(c.text for c in chunks), chunks[-1].usage)

    # grpc.aio binds its poller to the first loop that uses it: run the
    # clients on the JAX stack's loop (its own gRPC lives there)
    wire_ids = asyncio.run_coroutine_threadsafe(ids_over_the_wire(),
                                                fed["jax"].loop).result(120)
    local_ids, local_text, local_usage = asyncio.run(ids_in_process())
    assert wire_ids == local_ids and len(local_ids) >= 1
    assert jax_text == local_text
    assert jax_usage["output_tokens"] == local_usage["output_tokens"]


def test_remote_worker_endpoint_serves_through_an_exposed_worker():
    """``worker_service.expose`` serves a host's local worker on its hub
    (with a bearer token); another host's gateway with
    ``remote_worker_endpoint`` and the same token serves through it, and
    the remote answers what the local host answers."""
    base = {k: v for k, v in CONFIG["modules"].items()
            if k in ("api_gateway", "tenant_resolver", "authn_resolver", "model_registry")}
    exposed = BackgroundServer({"modules": {
        **base, "grpc_hub": {"config": {"bind_addr": "127.0.0.1:0"}},
        "llm_gateway": {"config": {"worker": {"device": "cpu"},
                                   "worker_service": {"expose": True, "token": "s3cret"}}}},
    }).start()
    try:
        remote = BackgroundServer({"modules": {
            **base, "llm_gateway": {"config": {
                "remote_worker_endpoint": exposed.host.hub.endpoint,
                "worker_service": {"token": "s3cret"}}}}}).start()
        try:
            body = {"model": MODEL_KEY, "prompt": PROMPT_A, "max_tokens": 8}
            status, local = request(exposed.port, "POST", "/v1/completions", body)
            assert status == 200, local
            status, served = request(remote.port, "POST", "/v1/completions", body)
            assert status == 200, served
            assert served["content"] == local["content"] and served["usage"] == local["usage"]
            # a problem of the remote worker re-raises as the same problem
            status, problem = request(remote.port, "POST", "/v1/completions",
                                      {**body, "prompt": "x" * 300})
            assert status == 422 and problem["code"] == "context_length_exceeded"
        finally:
            remote.stop()
        wrong = BackgroundServer({"modules": {
            **base, "llm_gateway": {"config": {
                "remote_worker_endpoint": exposed.host.hub.endpoint,
                "worker_service": {"token": "wrong"}}}}}).start()
        try:
            status, _ = request(wrong.port, "POST", "/v1/completions",
                                {"model": MODEL_KEY, "prompt": "hi", "max_tokens": 2})
            assert status == 500
        finally:
            wrong.stop()
    finally:
        exposed.stop()
