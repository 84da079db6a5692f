"""The port's doctor against the JAX package's (``modkit/doctor.py``), and
its shedding cycle over the port's REST surface, on the CPU.

- The same terminal samples, scheduler heartbeats, tenant snapshots and
  capacity census under one fake clock, fed to JAX's ``Doctor`` and the
  port's, give the same evaluation documents pass by pass: burn rates,
  verdicts, reasons, watchdog trips, the tenant shed set, the state
  sequence healthy → degraded → shedding → recovering → healthy, readiness
  and liveness.
- A host booted from the port's quickstart (worker on the CPU, monitoring
  with short doctor windows and fault injection allowed): ``/readyz`` is
  200; ``scheduler.readback`` armed as a delay over REST makes every round
  slow, ``/readyz`` turns 503 ``not_ready`` naming the objective, a new
  chat gets 429 ``llm.load_shed`` with ``Retry-After`` while streams
  already in flight finish; disarmed, ``/readyz`` is 200 again and a chat
  is served.
"""

from __future__ import annotations

import http.client
import json
import threading
import time
import types

import pytest

from cyberfabric_core_tpu.modkit import doctor as jdoctor
from cyberfabric_core_tpu.modkit import flight_recorder as jfr
from cyberfabric_core_tpu_torch.modkit import doctor as pdoctor
from cyberfabric_core_tpu_torch.modkit import failpoints as pfp
from cyberfabric_core_tpu_torch.modkit import flight_recorder as pfr


class _Clock:
    def __init__(self) -> None:
        self.now = 1_700_000_000.0

    def time(self) -> float:
        return self.now


class _Sched:
    """What the doctor reads of a scheduler (heartbeat, queue, tenants)."""

    def __init__(self) -> None:
        self.beat = {"last_round_age_s": 0.1, "round_p95_ms": 20.0, "rounds": 10,
                     "active": 1, "pending": 0, "suspended": 0}
        self.oldest = None
        self.tenants = {"t-a": {"charged_tokens": 0, "weight": 1.0, "pending": 0,
                                "active_slots": 1},
                        "t-b": {"charged_tokens": 0, "weight": 1.0, "pending": 0,
                                "active_slots": 1},
                        "t-c": {"charged_tokens": 0, "weight": 2.0, "pending": 0,
                                "active_slots": 0}}

    def heartbeat(self):
        return dict(self.beat)

    def pending_depth(self):
        return sum(r["pending"] for r in self.tenants.values())

    def pending_oldest_age_s(self):
        return self.oldest

    def tenant_snapshot(self):
        return {t: dict(r) for t, r in self.tenants.items()}


def _finish(rec, clock, rid, *, itl_gap=0.0, error=False, model="m1", tenant="t-a"):
    rec.record(rid, "enqueued", prompt_tokens=4, tenant=tenant)
    rec.annotate(rid, model=model)
    if error:
        rec.record(rid, "error", detail="boom")
        return
    rec.record(rid, "admitted", queue_wait_ms=1.0)
    rec.record(rid, "prefill", slot=0, dur_ms=1.0)
    rec.record(rid, "decode_chunk", slot=0, tokens=8)
    clock.now += itl_gap
    rec.record(rid, "decode_chunk", slot=0, tokens=8)
    rec.record(rid, "finished", reason="stop", tokens=17)


def _scenario(doctor_mod, fr_mod, clock, sched, capacity) -> list:
    cfg = doctor_mod.DoctorConfig(
        min_samples=2, fast_window_s=5.0, slow_window_s=10.0, shed_after=2,
        recover_after=2, round_stall_floor_s=3.0, stream_stall_s=4.0,
        queue_deadline_s=6.0, watchdog_cooldown_s=1.0, tenant_min_activity=8,
        per_model={"m2": {"error_rate": {"budget": 0.5}}})
    rec = fr_mod.FlightRecorder()
    doctor = doctor_mod.Doctor(cfg, recorder=rec)
    doctor.attach_recorder()
    doctor.set_scheduler_provider(lambda: [("m1", sched)])
    doctor.set_capacity_provider(lambda: dict(capacity))
    docs = []

    def evaluate(step=1.0):
        clock.now += step
        docs.append(doctor.evaluate())
        docs.append((doctor.readiness(), doctor.shed_retry_after(),
                     doctor.tenant_shed_retry_after("t-a"),
                     doctor.tenant_shed_retry_after("t-b")))

    for i in range(4):
        _finish(rec, clock, f"ok{i}", itl_gap=0.01)
    evaluate()
    # an error burst, with t-a taking most of the tokens
    for i in range(4):
        _finish(rec, clock, f"err{i}", error=True, model="m2" if i % 2 else "m1")
    sched.tenants["t-a"]["charged_tokens"] += 400
    sched.tenants["t-b"]["charged_tokens"] += 10
    evaluate()
    sched.tenants["t-a"]["charged_tokens"] += 300
    evaluate()
    # slow decode: the itl objective burns too; a wedged round, an old queue,
    # a stream with no event for a while, half the replicas gone
    for i in range(3):
        _finish(rec, clock, f"slow{i}", itl_gap=2.0)
    sched.beat.update(last_round_age_s=9.0, pending=2)
    sched.oldest = 8.0
    capacity.update(replicas=2, serving=1, healthy=1)
    rec.record("stuck", "enqueued", tenant="t-b")
    rec.record("stuck", "admitted")
    rec.record("stuck", "prefill", slot=1)
    evaluate(0.5)
    evaluate(5.0)
    evaluate()
    # recovery: the round moves, the queue drains, the stream finishes, the
    # windows empty
    sched.beat.update(last_round_age_s=0.1, pending=0)
    sched.oldest = None
    capacity.update(replicas=2, serving=2, healthy=2)
    rec.record("stuck", "decode_chunk", slot=1, tokens=8)
    rec.record("stuck", "finished", reason="stop", tokens=9)
    for step in (11.0, 1.0, 1.0, 1.0, 1.0, 1.0):
        evaluate(step)
    docs.append(doctor.state_sequence())
    docs.append(doctor.report())
    docs.append(rec.lookup("stuck"))
    doctor.detach_recorder()
    return docs


def test_doctor_evaluations_equal_jax_s(monkeypatch):
    runs = []
    for doctor_mod, fr_mod in ((jdoctor, jfr), (pdoctor, pfr)):
        clock = _Clock()
        fake = types.SimpleNamespace(time=clock.time, monotonic=clock.time)
        monkeypatch.setattr(doctor_mod, "time", fake)
        monkeypatch.setattr(fr_mod, "time", fake)
        runs.append(_scenario(doctor_mod, fr_mod, clock, _Sched(),
                              {"replicas": 2, "serving": 2, "healthy": 2, "benched": 0}))
    assert runs[1] == runs[0]
    seq = runs[1][-3]
    assert seq == ["healthy", "degraded", "shedding", "recovering", "healthy"]
    reports = [d for d in runs[1] if isinstance(d, dict) and "reasons" in d]
    reasons = {r for d in reports for r in d["reasons"]}
    assert {"slo:error_rate", "slo:itl_p99", "watchdog:scheduler_round",
            "watchdog:queue_age", "watchdog:stream_stall"} <= reasons
    assert any(d["tenants"] and d["tenants"]["shed"] == ["t-a"] for d in reports)


def test_config_rejects_what_jax_rejects():
    for raw in ({"bogus": 1}, {"objectives": {"ttft_p95": {"threshold": 1.0}}},
                {"per_model": {"m": {"nope": {}}}}):
        with pytest.raises(ValueError):
            jdoctor.DoctorConfig.from_config(raw).build_objectives()
        with pytest.raises(ValueError):
            pdoctor.DoctorConfig.from_config(raw).build_objectives()
    # the federation's fold is the port's since its federated-worker entry
    assert pdoctor.__all__ == jdoctor.__all__ and hasattr(pdoctor.Doctor, "set_fleet_provider")


# ------------------------------------------------------------ over REST
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


CHAT = {"model": "default-chat", "max_tokens": 24,
        "messages": [{"role": "user", "content": [{"type": "text", "text": "shed me"}]}]}


def _wait(cond, timeout=20.0):
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if cond():
            return True
        time.sleep(0.05)
    return False


class _HeldClock:
    """The doctor's clock over REST: real time until held, then still until
    released. Held from the moment the slow streams end, it keeps their
    samples inside the doctor's 2 s window however long a loaded machine
    takes to read the shed state and send the chat that is shed."""

    def __init__(self) -> None:
        self.held = None

    def time(self) -> float:
        return time.time() if self.held is None else self.held

    def __getattr__(self, name):
        return getattr(time, name)


def test_shedding_cycle_over_rest(monkeypatch):
    from cyberfabric_core_tpu_torch import server

    cfg = json.loads(server.QUICKSTART.read_text())
    cfg.pop("server")
    cfg["modules"]["api_gateway"]["config"]["bind_addr"] = "127.0.0.1:0"
    cfg["modules"]["llm_gateway"]["config"]["worker"]["device"] = "cpu"
    cfg["modules"]["monitoring"] = {"config": {
        "allow_fault_injection": True,
        "doctor": {"eval_interval_s": 0.1, "fast_window_s": 2.0, "slow_window_s": 3.0,
                   "min_samples": 2, "shed_after": 1, "recover_after": 2,
                   "objectives": {"itl_p99": {"threshold_ms": 20.0}}}}}
    clock = _HeldClock()
    monkeypatch.setattr(pdoctor, "time", clock)
    # the doctor's stream-stall watchdog reads the process-wide recorder: a
    # stream another test left live there (a prefill-role engine's handed-off
    # request whose sink never finishes it) would trip it 30 s later
    pfr.default_recorder.reset()
    srv = server.BackgroundServer(cfg).start()
    port = srv.port
    try:
        assert _request(port, "POST", "/v1/chat/completions", CHAT)[0] == 200  # builds
        assert _request(port, "GET", "/readyz")[:1] == (200,)
        status, _, body = _request(port, "PUT",
                                   "/v1/monitoring/failpoints/scheduler.readback",
                                   {"spec": "delay(0.4)"})
        assert status == 200, body
        results = []
        threads = [threading.Thread(target=lambda: results.append(
            _request(port, "POST", "/v1/chat/completions", CHAT))) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert [r[0] for r in results] == [200, 200]
        clock.held = time.time()
        assert _wait(lambda: _request(port, "GET", "/readyz")[0] == 503)
        status, _, doc = _request(port, "GET", "/readyz")
        assert doc["code"] == "not_ready" and doc["state"] == "shedding"
        assert "slo:itl_p99" in doc["reasons"]
        # a stream admitted before shedding is still served; a new chat is shed
        status, hdrs, doc = _request(port, "POST", "/v1/chat/completions", CHAT)
        assert status == 429 and doc["code"] == "load_shed", doc
        assert int(hdrs["retry-after"]) >= 1
        assert _request(port, "DELETE",
                        "/v1/monitoring/failpoints/scheduler.readback")[0] == 200
        clock.held = None
        assert _wait(lambda: _request(port, "GET", "/readyz")[0] == 200)
        assert _request(port, "POST", "/v1/chat/completions", CHAT)[0] == 200
        slo = _request(port, "GET", "/v1/monitoring/slo")[2]
        assert [h["to"] for h in slo["state_history"]][:2] == ["degraded", "shedding"]
    finally:
        pfp.reset()
        srv.stop()
    assert pdoctor.default_doctor._scheduler_provider is None
    assert not pdoctor.default_doctor._listener_attached
