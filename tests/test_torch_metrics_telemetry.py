"""The port's metrics registry, tracer, failpoints and decode cost count,
against the JAX package's (``modkit/metrics.py``, ``modkit/telemetry.py``,
``modkit/failpoints.py``, ``runtime/engine.py decode_cost_analysis``).

- one sequence of counter, gauge and histogram operations renders byte for
  byte the same Prometheus text, and the same snapshot, in both registries;
- ``traceparent_ids`` agrees on JAX's cases (``tests/test_flight_recorder.py
  ::test_traceparent_ids_parser``) and more;
- the OTLP/HTTP JSON encoding of one span equals JAX's;
- the concurrent read-modify-write test of ``tests/test_flight_recorder.py``;
- the failpoint spec parser gives JAX's actions, a seeded probability
  schedule fires on the same hits, and arming a point whose module the port
  does not serve names its ROADMAP item;
- ``decode_cost_analysis`` equals the shape formula, and JAX's XLA count of
  one scan iteration lies within 25% of the port's first step.
"""

from __future__ import annotations

import threading

import pytest

from cyberfabric_core_tpu.modkit import failpoints as jfp
from cyberfabric_core_tpu.modkit import metrics as jmetrics
from cyberfabric_core_tpu.modkit import telemetry as jtel
from cyberfabric_core_tpu_torch.modkit import failpoints as pfp
from cyberfabric_core_tpu_torch.modkit import metrics as pmetrics
from cyberfabric_core_tpu_torch.modkit import telemetry as ptel


def _drive(mod) -> "object":
    reg = mod.MetricsRegistry()
    c = reg.counter("req_total", "Requests")
    c.inc()
    c.inc(2.5, route="/a", method="GET")
    c.inc(route="/a", method="GET")
    reg.counter("req_total", "a second help is ignored").inc(route="/b", method="POST")
    g = reg.gauge("depth", "Queue depth")
    g.set(3)
    g.set(7.25, model="m1")
    g.set_function(lambda: 11.0, device="0")
    g.set_function(lambda: 1 / 0, device="1")  # a failing function is skipped
    h = reg.histogram("lat_seconds", "Latency")
    for v in (0.001, 0.02, 0.3, 4.0, 30.0):
        h.observe(v, route="/a")
    h.observe(0.5)
    reg.histogram("ttft_seconds", "Time to first token", buckets=(0.1, 1.0)).observe(
        0.2, model="x")
    reg.histogram("empty_seconds", "Never observed")
    return reg


def test_registry_renders_jax_text_byte_for_byte():
    jreg, preg = _drive(jmetrics), _drive(pmetrics)
    assert preg.render() == jreg.render()
    assert preg.snapshot() == jreg.snapshot()
    assert preg.snapshot("lat") == jreg.snapshot("lat")
    jh, ph = jreg.histogram("lat_seconds"), preg.histogram("lat_seconds")
    for q in (0.0, 0.5, 0.9, 1.0):
        assert ph.quantile(q, route="/a") == jh.quantile(q, route="/a")


def test_bump_counter_never_raises_and_counts_by_n():
    pmetrics.bump_counter("tm_bump_total", n=3, kind="x")
    pmetrics.bump_counter("tm_bump_total", kind="x")
    assert pmetrics.default_registry.counter("tm_bump_total")._values[(("kind", "x"),)] == 4
    pmetrics.bump_counter("tm_bump_total", n="not a number")  # swallowed


@pytest.mark.parametrize("tp", [
    f"00-{'ab' * 16}-{'cd' * 8}-01", f"00-{'ab' * 16}-{'cd' * 8}-00",
    None, "garbage", "", f" 00-{'12' * 16}-{'34' * 8}-03 ", f"00-{'AB' * 16}-{'cd' * 8}-01",
    f"01-{'ab' * 16}-{'cd' * 8}-01", f"00-{'ab' * 15}-{'cd' * 8}-01"])
def test_traceparent_ids_agree_with_jax(tp):
    assert ptel.traceparent_ids(tp) == jtel.traceparent_ids(tp)


def test_otlp_encoding_of_a_span_equals_jax():
    def encode(mod):
        exporter = mod.OtlpHttpExporter.__new__(mod.OtlpHttpExporter)  # no thread
        span = mod.Span(name="llm.prefill", trace_id="ab" * 16, span_id="cd" * 8,
                        parent_id="ef" * 8,
                        attributes={"slot": 3, "coalesced": True, "dur": 1.5,
                                    "request_id": "req-1", "none": None},
                        status="error")
        span.start_unix_ns = 1_700_000_000_000_000_000
        root = mod.Span(name="http GET /", trace_id="12" * 16, span_id="34" * 8)
        root.start_unix_ns = 5
        return exporter._encode(span, duration_ms=12.5), exporter._encode(root, 0.25)

    assert encode(ptel) == encode(jtel)


def test_sampling_decisions_follow_the_flags_as_in_jax():
    class Collect(ptel.SpanExporter):
        def __init__(self):
            self.names = []

        def export(self, span, duration_ms):
            self.names.append(span.name)

    sink = Collect()
    tracer = ptel.Tracer(exporter=sink, sample_ratio=0.0)
    with tracer.span("root") as root:
        assert root.sampled is False and root.traceparent().endswith("-00")
    sampled_tp, unsampled_tp = (f"00-{'aa' * 16}-{'bb' * 8}-01",
                                f"00-{'aa' * 16}-{'bb' * 8}-00")
    with tracer.span("child", traceparent=sampled_tp) as child:
        assert child.sampled and child.trace_id == "aa" * 16
    assert tracer.emit_span("retro", traceparent=unsampled_tp) is None
    span = tracer.emit_span("retro", traceparent=sampled_tp, start_unix_ns=123,
                            duration_ms=4.0, slot=1)
    assert span.parent_id == "bb" * 8 and span.start_unix_ns == 123
    assert sink.names == ["child", "retro"]
    assert ptel.Tracer(enabled=False, exporter=sink).emit_span(
        "x", traceparent=sampled_tp) is None


def test_device_profile_writes_a_chrome_trace_on_the_cpu(tmp_path):
    import torch

    with ptel.device_profile("tm-region", enabled=True, logdir=str(tmp_path)) as prof:
        torch.ones(8, 8) @ torch.ones(8, 8)
    assert prof is not None and (tmp_path / "tm-region.trace.json").stat().st_size > 0
    with ptel.device_profile("off") as none:
        assert none is None


def test_metrics_concurrent_rmw_loses_nothing():
    """``tests/test_flight_recorder.py:207`` on the port's metrics: with the
    per-metric locks no increment is lost under contention."""
    c = pmetrics.Counter("t_total", "")
    h = pmetrics.Histogram("t_seconds", "")
    g = pmetrics.Gauge("t_gauge", "")
    N, T = 2000, 8

    def work(tid):
        for i in range(N):
            c.inc(point="x")
            h.observe(0.01 * (i % 7), point="x")
            g.set(float(i), thread=str(tid))

    threads = [threading.Thread(target=work, args=(t,)) for t in range(T)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    key = (("point", "x"),)
    assert c._values[key] == N * T
    assert h._totals[key] == N * T
    assert f"t_total{{point=\"x\"}} {float(N * T)}" in "\n".join(c.render())


# ------------------------------------------------------------ failpoints
SPECS = ["off", "raise", "raise(MemoryError)", "delay(0.05)", "delay", "return(503)",
         "return(busy)", "2*raise", "3*raise(TimeoutError)", "25%raise", "100%delay(0.01)",
         "3:raise", "2:return(7)", {"kind": "raise", "exc": "ValueError", "mode": "once",
                                    "n": 2, "after": 1}]
BAD = ["explode", "raise(SystemExit)", "0*raise", "150%raise", "0:raise",
       {"kind": "raise", "bogus": 1}, 42]


@pytest.mark.parametrize("spec", SPECS, ids=str)
def test_failpoint_spec_parses_to_jax_action(spec):
    assert pfp.parse_action(spec).__dict__ == jfp.parse_action(spec).__dict__


@pytest.mark.parametrize("spec", BAD, ids=str)
def test_failpoint_bad_spec_is_refused_as_jax_refuses_it(spec):
    with pytest.raises(Exception) as jerr:
        jfp.parse_action(spec)
    with pytest.raises(Exception) as perr:
        pfp.parse_action(spec)
    assert type(perr.value) is type(jerr.value)


def _fires(mod, name, spec, seed, hits=64):
    mod.reset()
    mod.configure(seed)
    mod.arm(name, spec)
    out = []
    try:
        for _ in range(hits):
            try:
                out.append(mod.failpoint(name))
            except Exception as e:  # noqa: BLE001 — the injected fault
                out.append(type(e).__name__)
        stats = mod.stats()["armed"][name]
    finally:
        mod.reset()
        mod.configure(0)
    return out, stats


@pytest.mark.parametrize("spec,seed", [("25%raise", 7), ("60%return(5)", 11),
                                       ("3*raise(MemoryError)", 0), ("4:return(1)", 0),
                                       ({"kind": "raise", "mode": "prob", "p": 0.4,
                                         "after": 5}, 3)], ids=str)
def test_seeded_fire_sequence_equals_jax(spec, seed):
    assert _fires(pfp, "scheduler.admit", spec, seed) == \
        _fires(jfp, "scheduler.admit", spec, seed)


def test_catalog_is_jax_s_for_the_points_the_port_has():
    for name, entry in pfp.FAILPOINT_CATALOG.items():
        assert jfp.FAILPOINT_CATALOG[name][0] == entry[0], name
    assert set(pfp.FAILPOINT_CATALOG) | set(pfp.UNPORTED_FAILPOINTS) == \
        set(jfp.FAILPOINT_CATALOG)
    # the federation's points are the port's since its federated-worker entry
    pfp.arm("federation.route", "raise")
    assert pfp.disarm("federation.route")
    with pytest.raises(KeyError, match="ROADMAP queue 1 item 17"):
        pfp.arm("http_client.request", "raise")
    with pytest.raises(KeyError, match="ROADMAP queue 1 item 17"):
        pfp.arm("serverless.tick", "raise")
    with pytest.raises(KeyError, match="catalog"):
        pfp.arm("no.such.point", "raise")


def test_fault_metrics_and_recovery_stats():
    before = pmetrics.default_registry.counter("fault_injected_total")._values.get(
        (("point", "scheduler.resume"),), 0.0)
    with pfp.scoped("scheduler.resume", "1*raise"):
        with pytest.raises(pfp.FaultInjected):
            pfp.failpoint("scheduler.resume")
        assert pfp.failpoint("scheduler.resume") is None
    after = pmetrics.default_registry.counter("fault_injected_total")._values[
        (("point", "scheduler.resume"),)]
    assert after == before + 1
    pfp.record_recovery("tm.point", 0.25)
    assert pfp.stats()["recoveries"]["tm.point"]["last_s"] == 0.25


# ------------------------------------------------------------ decode cost
def _shape_count(cfg, B, k, S, lengths, dtype_bytes, weight_bytes):
    H, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    per_row = cfg.num_layers * (2 * H * (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim
                                + 2 * cfg.num_heads * cfg.head_dim * H + 6 * H * I) + 2 * H * V
    flops = nbytes = 0
    for j in range(k):
        keys = sum(min(S, n + j) for n in lengths)
        flops += B * per_row + 4 * cfg.num_layers * cfg.num_heads * cfg.head_dim * keys
        nbytes += weight_bytes + 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim \
            * dtype_bytes * (keys + B) + 4 * B * V
    return flops, nbytes


@pytest.mark.parametrize("B,k,S", [(2, 2, 128), (4, 4, 256)])
def test_decode_cost_counts_the_shape_formula_and_brackets_jax(B, k, S):
    from cyberfabric_core_tpu.runtime.engine import EngineConfig as JConfig
    from cyberfabric_core_tpu.runtime.engine import InferenceEngine as JEngine
    from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, InferenceEngine

    opts = dict(model="tiny-llama", max_seq_len=S, max_batch=B, decode_chunk=k,
                dtype="float32")
    eng = InferenceEngine(EngineConfig(**opts), device="cpu")
    cfg = eng.model_config
    state = eng.params.state_dict()
    total = sum(t.numel() * 4 for t in state.values())
    embed = state["embed"].numel() * 4
    weight_bytes = total - embed + embed * B // cfg.vocab_size  # untied: B rows read
    assert not cfg.tie_embeddings

    out = eng.decode_cost_analysis()
    flops, nbytes = _shape_count(cfg, B, k, S, [S] * B, 4, weight_bytes)
    assert (out["flops"], out["bytes_accessed"]) == (flops, nbytes)
    assert out["flops_per_token"] == flops / (B * k)
    assert out["bytes_per_token"] == nbytes / (B * k)
    assert (out["batch"], out["decode_chunk"]) == (B, k)
    lengths = [5, 17, 40, 90][:B]
    short = eng.decode_cost_analysis(lengths=lengths)
    assert short["flops"] == _shape_count(cfg, B, k, S, lengths, 4, weight_bytes)[0]
    with pytest.raises(ValueError):
        eng.decode_cost_analysis(lengths=[1] * (B + 1))

    # JAX's XLA count covers ONE scan iteration over the dense cache
    jout = JEngine(JConfig(**opts)).decode_cost_analysis(B)
    assert 0.75 <= jout["flops"] / out["flops_per_step"] <= 1.25, (jout, out)
    assert set(jout) >= {"flops", "bytes_accessed", "flops_per_token", "bytes_per_token",
                         "batch", "decode_chunk"}
    assert set(out) >= {"flops", "bytes_accessed", "flops_per_token", "bytes_per_token",
                        "batch", "decode_chunk"}
