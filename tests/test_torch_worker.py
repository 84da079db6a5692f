"""The port's worker against the JAX worker, on the CPU.

- ``engine_options`` → ``EngineConfig``: the port's :func:`plan_engine`
  against the config of the engine ``LocalTpuWorker._build_entry`` builds,
  field for field, over the quickstart's option set and the option sets
  ``config/quickstart.yaml`` documents in its comments (and the string
  forms registries send); the sets the port does not serve raise a
  ``not_ported`` problem naming their ROADMAP item; the replica pools, the
  PD split, quantization, the lockstep scheduler and ``speculative`` under
  the continuous one build (and serve) their entries, and the
  combinations the JAX worker refuses raise its ``ValueError``s.
- The lockstep entry: ``speculative`` off, ``ngram`` and ``draft`` served
  through the batcher, its idle count (hot-swap keeps an entry with a
  pending or running batch), and JAX's warning for ``speculative`` under
  the continuous scheduler.
- The port's schema checker gives ``jsonschema.Draft202012Validator``'s
  verdict and error list (field and message, sorted, capped at 16) on the
  four wire schemas, over hypothesis-generated bodies and the bodies the JAX
  e2e tests send.
- The incremental detokenizer gives the one-shot decode's text.
- ``config/quickstart.json`` of the port equals the matching sections of
  ``config/quickstart.yaml``.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from cyberfabric_core_tpu.gateway import validation as jax_validation
from cyberfabric_core_tpu.modkit.errors import ProblemError as JaxProblemError
from cyberfabric_core_tpu.modules import sdk as jax_sdk
from cyberfabric_core_tpu.modules.llm_gateway import schemas as jax_schemas
from cyberfabric_core_tpu.modules.llm_gateway.worker import LocalTpuWorker
from cyberfabric_core_tpu_torch.gateway import validation
from cyberfabric_core_tpu_torch.modkit.errors import ProblemError
from cyberfabric_core_tpu_torch.modules.llm_gateway import schemas
from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import (
    IncrementalDetokenizer, LocalTorchWorker, plan_engine)
from cyberfabric_core_tpu_torch.modules.sdk import ModelInfo
from cyberfabric_core_tpu_torch.runtime.tokenizer import ByteTokenizer, load_tokenizer

ROOT = Path(__file__).resolve().parents[1]
GOLDEN = Path(__file__).parent / "golden" / "fixtures" / "tiny-llama-golden"

QUICKSTART_OPTS = {"model_config": "tiny-llama", "max_seq_len": 2048, "max_batch": 8}
#: the option sets quickstart.yaml documents (tenant isolation), and the
#: string forms a registry may send
SERVED_SETS = {
    "quickstart": QUICKSTART_OPTS,
    "tenants": {**QUICKSTART_OPTS, "tenant_fair": True, "tenant_default_weight": 1.0,
                "tenant_weights": {"gold": 4.0}, "tenant_max_slots": 2,
                "tenant_soft_pages": 8, "tenant_max_pages": 64, "tenant_max_pending": 3},
    "words": {**QUICKSTART_OPTS, "mixed_batch": "false", "tenant_fair": "off",
              "decode_lookahead": "4", "max_pending": "16", "prefix_page_size": 32,
              "prefill_budget_tokens": 256, "prefill_coalesce": 2, "decode_chunk": 4,
              "eos_token_ids": [2, 7], "lifecycle": {"max_strikes": 5}},
    "lookahead-off": {**QUICKSTART_OPTS, "decode_lookahead": "off", "max_batch": 4,
                      "max_seq_len": 512, "prefix_cache_pages": 0},
    "spec": {**QUICKSTART_OPTS, "scheduler_spec_k": 4, "spec_min_accept": 0.0,
             "spec_max_ngram": 3, "spec_min_ngram": 1},
    "spec-words": {**QUICKSTART_OPTS, "scheduler_spec_k": "7", "spec_min_accept": "0.25",
                   "spec_max_ngram": "4", "spec_min_ngram": "2"},
}
#: (option set, worker config, the ROADMAP item the problem names). The PD
#: split, the dp pool, quantization, the lockstep scheduler, ``speculative``,
#: tp and the feasibility gate were not ported until ROADMAP items 5, 6, 7
#: and 9 landed: their rows name no item (None), and their cases check the
#: entry the worker now builds and one completion it serves
UNPORTED_SETS = {
    "tp": ({**QUICKSTART_OPTS, "tp": 8, "hbm_bytes_per_device": 0}, {}, None),
    "feasibility": ({**QUICKSTART_OPTS, "hbm_bytes_per_device": 1 << 34}, {}, None),
    "pd": ({**QUICKSTART_OPTS, "pd_prefill_replicas": 1, "pd_decode_replicas": 1}, {},
           None),
    "dp": ({**QUICKSTART_OPTS, "dp_replicas": 2}, {}, None),
    "quant": ({**QUICKSTART_OPTS, "quantization": "int8"}, {}, None),
    "lockstep": (QUICKSTART_OPTS, {"scheduler": "lockstep"}, None),
    "draft": ({**QUICKSTART_OPTS, "speculative": "ngram"}, {}, None),
    "draft-beside-spec": ({**QUICKSTART_OPTS, "scheduler_spec_k": 4, "speculative": "draft",
                           "draft_model": "tiny-llama"}, {}, None),
    "unknown": ({**QUICKSTART_OPTS, "warp_factor": 9}, {}, "not options"),
}


def _infos(opts):
    kw = dict(canonical_id="local::tiny-llama", provider_slug="local",
              provider_model_id="tiny-llama", managed=True, engine_options=dict(opts))
    return jax_sdk.ModelInfo(**kw), ModelInfo(**kw)


@pytest.mark.parametrize("name", sorted(SERVED_SETS))
def test_engine_options_map_as_the_jax_worker_maps_them(name):
    jax_info, info = _infos(SERVED_SETS[name])
    entry = LocalTpuWorker()._build_entry(jax_info)
    try:
        want = dataclasses.asdict(entry.scheduler.config)
    finally:
        entry.scheduler.shutdown()
    plan = plan_engine(info)
    assert dataclasses.asdict(plan.config) == want
    assert plan.chat_family == entry.model_family
    assert plan.checkpoint is None


@pytest.mark.parametrize("name", sorted(UNPORTED_SETS))
def test_unported_options_raise_a_problem_naming_their_item(name):
    opts, worker_cfg, item = UNPORTED_SETS[name]
    _, info = _infos(opts)
    if item is None:
        _check_served_entry(name, info, worker_cfg)
        return
    with pytest.raises(ProblemError) as e:
        LocalTorchWorker({"device": "cpu", **worker_cfg})._build_entry(info)
    problem = e.value.problem
    assert (problem.status, problem.code) == (501, "not_ported")
    assert item in problem.detail


def _check_served_entry(name, info, worker_cfg):
    """The worker builds the entry (a PD pool of 1 + 1 CPU replicas, a dp
    pool of 2 sharing one params tree, an int8 engine, a lockstep engine
    behind its batcher, a continuous engine that ignores ``speculative``, a
    tp=8 engine on eight CPU ranks, an engine whose gate is armed) and
    serves one greedy completion through it."""
    import asyncio

    from cyberfabric_core_tpu_torch.runtime.engine import InferenceEngine
    from cyberfabric_core_tpu_torch.runtime.pd import PDServingPool
    from cyberfabric_core_tpu_torch.runtime.quant import QuantWeight
    from cyberfabric_core_tpu_torch.runtime.replicas import DataParallelServingPool

    worker = LocalTorchWorker({"device": "cpu", **worker_cfg})
    try:
        out = asyncio.run(_complete(worker, info))
        entry = worker._entries[info.canonical_id]
        if name == "pd":
            assert isinstance(entry.pool, PDServingPool) and entry.scheduler is None
            st = entry.pool.stats()
            assert st["pd"]["roles"] == ["prefill", "decode"] and st["pd"]["handoffs"] == 1
        elif name == "dp":
            assert type(entry.pool) is DataParallelServingPool
            a, b = entry.pool.replicas
            assert a.params is b.params and str(a.device) == str(b.device) == "cpu"
        elif name == "lockstep":
            assert entry.scheduler is None and entry.pool is None
            assert type(entry.engine) is InferenceEngine and entry.batcher is not None
            assert worker.engine(info.canonical_id) is entry.engine
        elif name.startswith("draft"):
            assert entry.engine is None and entry.scheduler.spec_k == (
                4 if name == "draft-beside-spec" else 0)
        elif name == "tp":  # eight CPU ranks; tiny-llama's 2 kv heads replicate
            mesh = entry.scheduler.mesh_info()
            assert mesh["tp"] == mesh["devices"] == 8 and not mesh["kv_heads_sharded"]
            assert mesh["plan"]["enforced"] is False
        elif name == "feasibility":  # the gate armed at 16 GiB, tp=1
            plan = entry.scheduler.mesh_info()["plan"]
            assert plan["enforced"] is True and plan["fits"] is True
            assert plan["hbm_bytes"] == 1 << 34
        else:
            assert entry.pool is None
            wq = entry.scheduler.params.layers[0].wq
            assert isinstance(wq, QuantWeight) and wq.q.dtype == torch.int8
    finally:
        worker.close()
    assert out[-1].finish_reason == "length" and out[-1].usage["output_tokens"] == 4


#: option sets the JAX worker refuses, with its ValueError
REFUSED_SETS = {
    "pd-one-sided": {**QUICKSTART_OPTS, "pd_prefill_replicas": 1},
    "pd-with-dp": {**QUICKSTART_OPTS, "pd_prefill_replicas": 1, "pd_decode_replicas": 1,
                   "dp_replicas": 2},
    "pd-with-tp": {**QUICKSTART_OPTS, "pd_prefill_replicas": 1, "pd_decode_replicas": 1,
                   "tp": 2},
    "dp-with-tp": {**QUICKSTART_OPTS, "dp_replicas": 2, "tp": 2},
}


@pytest.mark.parametrize("name", sorted(REFUSED_SETS))
def test_disallowed_pool_combinations_raise_the_jax_workers_errors(name):
    jax_info, info = _infos(REFUSED_SETS[name])
    with pytest.raises(ValueError) as want:
        LocalTpuWorker()._build_entry(jax_info)
    with pytest.raises(ValueError) as got:
        LocalTorchWorker({"device": "cpu"})._build_entry(info)
    assert str(got.value) == str(want.value)


def test_worker_config_rejects_unknown_keys():
    with pytest.raises(ValueError, match="unknown keys"):
        LocalTorchWorker({"device": "cpu", "replicas": 2})


# ------------------------------------------------------------------ schemas
FOUR = ("REQUEST", "COMPLETION_REQUEST", "RESPONSE", "STREAM_CHUNK")


def _verdicts(name, body):
    out = []
    for mod, err in ((jax_validation, JaxProblemError), (validation, ProblemError)):
        schema = getattr(jax_schemas if mod is jax_validation else schemas, name)
        try:
            mod.validate_against(schema, body)
            out.append(None)
        except err as e:
            out.append((e.problem.status, e.problem.code, e.problem.errors))
    return out


def test_the_four_schemas_are_the_jax_schemas():
    for name in FOUR:
        assert getattr(schemas, name) == getattr(jax_schemas, name)


TEXT = [{"type": "text", "text": "hello"}]
E2E_BODIES = [
    ("REQUEST", {"model": "default-chat", "messages": [{"role": "user", "content": TEXT}],
                 "max_tokens": 8}),
    ("REQUEST", {"model": "x", "messages": [{"role": "user", "content": "bare string"}]}),
    ("REQUEST", {"model": "local::pending-model", "fallback": {"models": ["local::tiny-llama"]},
                 "messages": [{"role": "user", "content": TEXT}], "max_tokens": 4}),
    ("REQUEST", {"model": "default-chat", "async": True, "max_tokens": 4,
                 "messages": [{"role": "user", "content": TEXT}]}),
    ("REQUEST", {"model": "m", "messages": [], "top_p": 0, "top_k": -1, "stop": ["a"] * 9,
                 "temperature": -1, "fallback": {"models": [], "max_attempts": 9},
                 "extra": 1}),
    ("REQUEST", {"model": "m", "messages": [{"role": "robot", "content": [
        {"type": "image", "url": "u", "detail": "huge"}, {"type": "text"},
        {"type": "tool_result", "tool_call_id": "t", "result": None}]}],
        "tools": [{"type": "unified", "name": "f"}, {"type": "reference"}]}),
    ("COMPLETION_REQUEST", {"model": "local::tiny-llama", "prompt": "Once upon a time",
                            "max_tokens": 6}),
    ("COMPLETION_REQUEST", {"model": "local::tiny-llama"}),
    ("COMPLETION_REQUEST", {"model": "m", "prompt": "", "max_tokens": 0, "seed": 1.5,
                            "stream": "yes"}),
    ("COMPLETION_REQUEST", {"model": "m", "prompt": "p", "max_tokens": 4.0, "seed": True}),
    ("RESPONSE", {"usage": {"input_tokens": 3, "output_tokens": 4}, "model_used": "m",
                  "fallback_used": False, "finish_reason": "length",
                  "content": [{"type": "text", "text": "x"}]}),
    ("RESPONSE", {"usage": {"input_tokens": -1}, "finish_reason": "done"}),
    ("STREAM_CHUNK", {"id": "c", "model": "m", "delta": {"role": "assistant", "content": "x"}}),
    ("STREAM_CHUNK", {"id": "c", "model": "m", "delta": {}, "finish_reason": None,
                      "usage": {"input_tokens": 1, "output_tokens": 2}}),
    ("STREAM_CHUNK", {"id": 1, "delta": {"text": "x"}, "finish_reason": "weird"}),
    ("STREAM_CHUNK", [1, 2]),
]


@pytest.mark.parametrize("case", range(len(E2E_BODIES)))
def test_schema_checker_matches_jsonschema_on_e2e_bodies(case):
    name, body = E2E_BODIES[case]
    jax_verdict, port_verdict = _verdicts(name, body)
    assert port_verdict == jax_verdict


_scalars = (st.none() | st.booleans() | st.integers(-3, 10)
            | st.floats(-2.0, 2.0, allow_nan=False) | st.sampled_from(
                ["", "x", "text", "image", "user", "assistant", "stop", "length"]))
_json = st.recursive(_scalars, lambda kids: st.lists(kids, max_size=3)
                     | st.dictionaries(st.sampled_from(
                         ["type", "text", "url", "role", "content", "x"]), kids, max_size=3),
                     max_leaves=8)
_part = st.fixed_dictionaries({"type": st.sampled_from(["text", "image", "audio", "video",
                                                         "document", "tool_result", "x"])},
                              optional={"text": _json, "url": _json, "detail": _json,
                                        "tool_call_id": _json, "result": _json})
_message = st.fixed_dictionaries(
    {}, optional={"role": st.sampled_from(["system", "user", "assistant", "tool", "x"]) | _json,
                  "content": st.lists(_part, max_size=3) | _json, "name": _json,
                  "tool_calls": _json})
_common = {"model": st.text(max_size=3) | _json, "stream": st.booleans() | _json,
           "fallback": st.fixed_dictionaries({}, optional={
               "models": st.lists(st.text(max_size=2), max_size=2) | _json,
               "max_attempts": st.integers(-1, 10) | _json}) | _json,
           "max_tokens": st.integers(-1, 5) | _json,
           "temperature": st.floats(-1.0, 2.0, allow_nan=False) | _json,
           "top_p": st.floats(-0.5, 1.5, allow_nan=False) | _json,
           "top_k": st.integers(-1, 3) | _json, "seed": st.integers() | _json,
           "stop": st.lists(st.text(max_size=2), max_size=10) | _json, "extra": _json}
_bodies = {
    "REQUEST": st.fixed_dictionaries({}, optional={
        **_common, "messages": st.lists(_message, max_size=3) | _json,
        "async": st.booleans() | _json, "response_schema": _json,
        "tools": st.lists(st.fixed_dictionaries(
            {"type": st.sampled_from(["reference", "inline_gts", "unified", "x"])},
            optional={"name": _json, "schema_id": _json, "schema": _json}), max_size=2)}),
    "COMPLETION_REQUEST": st.fixed_dictionaries({}, optional={
        **_common, "prompt": st.text(max_size=3) | _json}),
    "RESPONSE": st.fixed_dictionaries({}, optional={
        "usage": st.fixed_dictionaries({}, optional={
            "input_tokens": st.integers(-2, 3) | _json,
            "output_tokens": st.integers(-2, 3) | _json,
            "cost_estimate": st.floats(-1.0, 1.0, allow_nan=False) | _json}) | _json,
        "model_used": _json, "fallback_used": _json, "content": st.lists(_part, max_size=2),
        "finish_reason": st.sampled_from(["stop", "length", "cancelled", "x"]) | _json,
        "tool_calls": _json, "x": _json}),
    "STREAM_CHUNK": st.fixed_dictionaries({}, optional={
        "id": _json, "model": _json, "delta": st.fixed_dictionaries({}, optional={
            "role": _json, "content": _json, "tool_calls": st.lists(
                st.fixed_dictionaries({}, optional={"index": _json, "id": _json,
                                                    "function": _json}), max_size=2),
            "x": _json}) | _json,
        "finish_reason": st.sampled_from(["stop", None, "deadline_exceeded", "x"]) | _json,
        "usage": _json}),
}


@pytest.mark.parametrize("name", FOUR)
@settings(max_examples=150, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(data=st.data())
def test_schema_checker_matches_jsonschema_on_generated_bodies(name, data):
    body = data.draw(_bodies[name] | _json)
    jax_verdict, port_verdict = _verdicts(name, body)
    assert port_verdict == jax_verdict


def test_schema_checker_refuses_keywords_it_does_not_implement():
    with pytest.raises(ValueError, match="pattern"):
        validation.SchemaChecker({"type": "string", "pattern": "^a"})


def test_error_codes_have_the_jax_catalog_status_title_and_type():
    from cyberfabric_core_tpu.modkit.errcat import ERR as JAX_ERR
    from cyberfabric_core_tpu_torch.modkit.errcat import ERR

    for catalog in ERR:
        for code in catalog:
            if (code.namespace, code.code) == ("llm", "not_ported"):
                assert code.status == 501  # the port's own
                continue
            ref = getattr(getattr(JAX_ERR, code.namespace), code.code)
            assert (code.status, code.title, code.gts_type) == \
                (ref.status, ref.title, ref.gts_type), code


# ------------------------------------------------------------ detokenizer
def _incremental(tok, ids):
    """What a stream of ``ids`` sends: each push's new text, the last push
    final (the terminal event)."""
    detok, sent = IncrementalDetokenizer(tok), ""
    for i, t in enumerate(ids):
        text = detok.push(t, final=i == len(ids) - 1)
        assert text.startswith(sent)
        sent = text
    return sent


@settings(max_examples=100, deadline=None, derandomize=True)
@given(ids=st.lists(st.integers(0, 300) | st.sampled_from([3 + 0xC3, 3 + 0xA9, 3 + 0xE2,
                                                           3 + 0x82, 3 + 0xAC]),
                    max_size=40))
def test_incremental_detokenizer_gives_the_one_shot_text_bytes(ids):
    tok = ByteTokenizer(512)
    assert _incremental(tok, ids) == tok.decode(ids)


def test_incremental_detokenizer_gives_the_one_shot_text_hf():
    tok = load_tokenizer(GOLDEN)
    rng = np.random.default_rng(0)
    texts = ["A TPU multiplies matrices.", "héllo wörld — ünïcode ✓ 日本語", "  spaced\n\nout  "]
    for text in texts:
        ids = tok.encode(text, add_specials=False)
        assert _incremental(tok, ids) == tok.decode(ids)
    ids = rng.integers(0, 256, 64).tolist()
    assert _incremental(tok, ids) == tok.decode(ids)


# ------------------------------------------------------------ quickstart
def test_quickstart_json_matches_the_yaml_sections():
    port = json.loads((ROOT / "cyberfabric_core_tpu_torch" / "config"
                       / "quickstart.json").read_text())
    ref = yaml.safe_load((ROOT / "config" / "quickstart.yaml").read_text())
    assert set(port) == {"server", "logging", "tracing", "modules"}
    for top in ("server", "logging", "tracing"):
        assert port[top] == ref[top], top
    assert set(port["modules"]) == {"api_gateway", "tenant_resolver", "authn_resolver",
                                    "model_registry", "llm_gateway", "monitoring"}
    for name, section in port["modules"].items():
        if name != "model_registry":
            assert section == ref["modules"][name], name
    reg, ref_reg = port["modules"]["model_registry"]["config"], \
        ref["modules"]["model_registry"]["config"]
    # the chat model and the embeddings model, under their aliases
    assert reg["models"] == ref_reg["models"]
    assert reg["aliases"] == ref_reg["aliases"] == {"default-chat": "local::tiny-llama",
                                                    "default-embed": "local::tiny-bert"}


# ------------------------------------------------------------ engines
def _tiny(name: str) -> ModelInfo:
    return ModelInfo(canonical_id=f"local::{name}", provider_slug="local",
                     provider_model_id=name, managed=True,
                     engine_options={"model_config": "tiny-llama", "max_seq_len": 256,
                                     "max_batch": 2, "dtype": "float32"})


async def _complete(worker: LocalTorchWorker, model: ModelInfo, n: int = 4) -> list:
    return [c async for c in worker.completion_stream(model, "hello", {"max_tokens": n})]


def test_hot_swap_closes_the_idle_engine_before_the_next_build():
    """``max_loaded_models: 1``: serving a second model evicts the first
    (its engine closed and dropped) before the second is built."""
    import asyncio

    worker = LocalTorchWorker({"device": "cpu", "max_loaded_models": 1})

    async def go():
        a, b = _tiny("a"), _tiny("b")
        first = await _complete(worker, a)
        engine_a = worker.engine(a.canonical_id)
        assert engine_a.servable()
        second = await _complete(worker, b)
        # evicted before b was built: closed, dropped
        assert not engine_a.servable() and worker.engine(a.canonical_id) is None
        assert worker.engine(b.canonical_id).servable()
        return first, second

    try:
        first, second = asyncio.run(go())
    finally:
        worker.close()
    assert first[-1].usage["output_tokens"] == second[-1].usage["output_tokens"] == 4


@pytest.mark.parametrize("held", ["queued", "prefilling", "suspended", "stream open",
                                  "nothing"])
def test_hot_swap_evicts_only_an_engine_that_holds_no_request(held):
    """``max_loaded_models: 1`` and a second model asked for while the first
    engine still holds a request (queued, in chunked prefill with no slot
    active, preempted to host, or a worker stream not yet submitted): the
    first engine stays loaded and servable. Holding nothing, it is closed."""
    from cyberfabric_core_tpu_torch.runtime.engine import SamplingParams

    worker = LocalTorchWorker({"device": "cpu", "max_loaded_models": 1})
    a = _tiny("a")
    entry = worker._build_entry(a)
    worker._entries[a.canonical_id] = entry
    eng = entry.scheduler
    eng.start = lambda: None  # driven by hand: the request stays where it is put
    try:
        if held in ("queued", "prefilling", "suspended"):
            # a 200-token prompt: several chunks of the mixed round's budget
            eng.submit(list(range(1, 201)), SamplingParams(max_tokens=4),
                       emit=lambda ev: None, request_id="long")
        if held in ("prefilling", "suspended"):
            eng._admit()
            slot = eng._prefill_slots[0]
            assert eng.active_slots == 0 and eng.pending_depth() == 0
            if held == "suspended":
                eng._preempt_slot(slot, eng.slots[slot])
                assert not eng._prefill_slots and len(eng._suspended) == 1
        if held == "stream open":
            entry.streams = 1
        worker._maybe_evict_for(_tiny("b"))
        if held == "nothing":
            assert worker.engine(a.canonical_id) is None and not eng.servable()
        else:
            assert eng.in_flight() == (0 if held == "stream open" else 1)
            assert worker.engine(a.canonical_id) is eng and eng.servable()
    finally:
        worker.close()


def test_a_broken_engine_is_rebuilt_in_place_by_its_supervisor():
    import asyncio

    worker = LocalTorchWorker({"device": "cpu"})
    model = _tiny("a")

    async def go():
        await _complete(worker, model)
        broken = worker.engine(model.canonical_id)
        broken._broken = "injected fault"
        out = await _complete(worker, model)
        fresh = worker.engine(model.canonical_id)
        return broken, fresh, fresh.servable(), out

    try:
        broken, fresh, servable, out = asyncio.run(go())
    finally:
        worker.close()
    assert fresh is not broken and servable
    assert fresh.params is broken.params  # rebuilt off the spent engine's weights
    assert out[-1].finish_reason == "length" and out[-1].usage["output_tokens"] == 4


def test_without_a_card_the_default_device_raises_at_the_engine_build():
    """No silent CPU fallback: the worker's default device is the card."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalTorchWorker()._build_entry(_tiny("a"))


def test_the_engine_records_the_phase_a_request_lapsed_in():
    """The worker's 408 / 504 source: the phase on the flight record's
    ``deadline_exceeded`` terminal, "queued" for a lapse while queued, the
    slot's phase ("prefill", "decode") or "suspended" after admission."""
    import time

    from cyberfabric_core_tpu_torch.modkit.flight_recorder import default_recorder
    from cyberfabric_core_tpu_torch.runtime.engine import SamplingParams
    from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine

    def lapse_phase(rid):
        rec = default_recorder.lookup(rid)
        last = (rec or {}).get("timeline", [{}])[-1]
        return last.get("phase") if last.get("event") == "deadline_exceeded" else None

    plan = plan_engine(_tiny("a"))
    eng = ContinuousBatchingEngine(plan.config, device="cpu")
    eng.start = lambda: None  # driven round by round here
    events = {}
    far = time.monotonic() + 1000.0
    for rid in ("admitted", "other"):
        eng.submit([1, 5, 6, 7], SamplingParams(max_tokens=4),
                   emit=lambda ev, rid=rid: events.setdefault(rid, []).append(ev),
                   request_id=rid, deadline=far)
    eng._admit()  # both take a slot in prefill phase (2 slots)
    slot = next(i for i, st in enumerate(eng.slots) if st and st.request_id == "admitted")
    eng.slots[slot].deadline = time.monotonic() - 1.0
    eng._service_cancellations()
    assert lapse_phase("admitted") == "prefill"
    assert events["admitted"][-1].finished == "deadline"
    eng.submit([1, 5, 6], SamplingParams(max_tokens=4),
               emit=lambda ev: events.setdefault("late", []).append(ev),
               request_id="late", deadline=time.monotonic() - 1.0)
    eng._service_cancellations()
    assert lapse_phase("late") == "queued"
    assert lapse_phase("other") is None  # never lapsed
    eng.close()


# ------------------------------------------------------------ speculation
def test_the_worker_serves_speculative_rounds():
    """``scheduler_spec_k`` reaches the engine the worker builds, and a
    repetitive prompt's greedy completion speculates (drafts accepted) and
    gives the same tokens as the same engine options at k=0."""
    import asyncio

    def run(spec_k: int):
        info = ModelInfo(canonical_id="local::tiny-llama", provider_slug="local",
                         provider_model_id="tiny-llama", managed=True,
                         engine_options={"model_config": "tiny-llama", "max_seq_len": 256,
                                         "max_batch": 2, "dtype": "float32",
                                         "decode_lookahead": 0, "scheduler_spec_k": spec_k})
        worker = LocalTorchWorker({"device": "cpu"})
        try:
            chunks = asyncio.run(_complete_text(worker, info, "abcabcabcabcabcabc", 96))
            engine = worker.engine(info.canonical_id)
            return ([c.token_id for c in chunks if c.token_id is not None],
                    chunks[-1].usage, engine.spec_k, engine.stats()["speculative"])
        finally:
            worker.close()

    toks0, usage0, k0, _ = run(0)
    toks4, usage4, k4, spec = run(4)
    assert (k0, k4) == (0, 4)
    assert spec["rounds"] > 0 and spec["accepted"] > 0, spec
    assert toks4 == toks0 and usage4 == usage0


async def _complete_text(worker, model, prompt, n):
    return [c async for c in worker.completion_stream(model, prompt, {"max_tokens": n})]


def _lockstep_info(**opts) -> ModelInfo:
    return ModelInfo(canonical_id="local::tiny-llama", provider_slug="local",
                     provider_model_id="tiny-llama", managed=True,
                     engine_options={"model_config": "tiny-llama", "max_seq_len": 256,
                                     "max_batch": 2, "dtype": "float32", **opts})


@pytest.mark.parametrize("speculative", ["off", "ngram", "draft"])
def test_the_lockstep_worker_serves_speculation(speculative):
    """``scheduler: lockstep``: a repetitive prompt's greedy completion with
    ``speculative`` off, ``ngram`` and ``draft`` (a synthetic tiny-llama
    draft) gives the tokens of a bare InferenceEngine with speculation off
    on the same weights, and the speculative modes ran verify rounds."""
    import asyncio

    from cyberfabric_core_tpu_torch.runtime.engine import InferenceEngine, SamplingParams

    info = _lockstep_info(speculative=speculative, draft_model="tiny-llama", spec_k=4)
    worker = LocalTorchWorker({"device": "cpu", "scheduler": "lockstep",
                               "batch_window_ms": 1})
    seen: list[int] = []

    async def go():
        entry = await worker._entry_for(info)
        stream = entry.engine.generate_stream

        def recording(prompts, sps):  # the ids the engine emits for the stream
            for ev in stream(prompts, sps):
                if ev.token_id >= 0:
                    seen.append(ev.token_id)
                yield ev

        entry.engine.generate_stream = recording
        return entry.engine, await _complete_text(worker, info, "abcabcabcabcabcabc", 48)

    try:
        engine, chunks = asyncio.run(go())
        bare = InferenceEngine(dataclasses.replace(engine.config, speculative="off"),
                               params=engine.params, device="cpu")
    finally:
        worker.close()
    prompt = ByteTokenizer(512).encode("abcabcabcabcabcabc")
    [want] = bare.generate([prompt], SamplingParams(max_tokens=48))
    assert seen == want.token_ids
    assert chunks[-1].usage["output_tokens"] == 48 and chunks[-1].finish_reason == "length"
    stats = engine.spec_stats
    assert (stats["verify_calls"] > 0) == (speculative != "off"), stats


def test_speculative_under_the_continuous_scheduler_warns_as_jax_does(caplog):
    import logging

    jax_info, info = _infos({**QUICKSTART_OPTS, "speculative": "ngram"})
    with caplog.at_level(logging.WARNING):
        entry = LocalTpuWorker()._build_entry(jax_info)
        entry.scheduler.shutdown()
        want = [r.getMessage() for r in caplog.records if "inert" in r.getMessage()]
        caplog.clear()
        plan = plan_engine(info)
        got = [r.getMessage() for r in caplog.records if "inert" in r.getMessage()]
    assert got == want and len(got) == 1
    assert plan.scheduler == "continuous" and plan.config.speculative == "ngram"
    with pytest.raises(ValueError, match="scheduler must be one of"):
        plan_engine(info, "batch")


@pytest.mark.parametrize("held", ["running", "pending", "stream open", "nothing"])
def test_hot_swap_keeps_a_lockstep_entry_that_holds_a_batch(held):
    """``max_loaded_models: 1``: a lockstep entry whose batcher has a batch
    on the executor, or a request waiting for its window, or a stream open,
    is not evicted for a second model; idle, it is closed."""
    import asyncio
    import threading

    worker = LocalTorchWorker({"device": "cpu", "scheduler": "lockstep",
                               "max_loaded_models": 1, "batch_window_ms": 1})
    a = _lockstep_info()
    gate = threading.Event()

    async def go():
        entry = await worker._entry_for(a)
        stream = entry.engine.generate_stream

        def held_stream(*args, **kw):
            gate.wait(30)  # the batch sits on the executor until released
            yield from stream(*args, **kw)

        entry.engine.generate_stream = held_stream
        task = None
        if held in ("running", "pending"):
            task = asyncio.ensure_future(_complete(worker, a))
            for _ in range(200):
                await asyncio.sleep(0.01)
                if entry.batcher.running:
                    break
            assert entry.batcher.running == 1
            if held == "pending":
                entry.batcher.running = 0  # seen as waiting for its window
                entry.batcher._pending.append(object())
        if held == "stream open":
            entry.streams = 1
        worker._maybe_evict_for(_tiny("b"))
        kept = worker.engine(a.canonical_id) is entry.engine
        if held == "pending":
            entry.batcher._pending.clear()
            entry.batcher.running = 1
        gate.set()
        if task is not None:
            out = await task
            assert out[-1].usage["output_tokens"] == 4
        return kept

    try:
        kept = asyncio.run(go())
    finally:
        gate.set()
        worker.close()
    assert kept == (held != "nothing")


# ------------------------------------------------------------ embeddings
def _bert_info(name="tiny-bert", checkpoint=None, info_cls=ModelInfo):
    return info_cls(canonical_id=f"local::{name}", provider_slug="local",
                      provider_model_id=name, managed=True, architecture="bert",
                      checkpoint_path=checkpoint, engine_options={"model_config": name})


@pytest.fixture(scope="module")
def bert_checkpoint(tmp_path_factory):
    """A tiny-bert checkpoint written by the JAX package's saver."""
    import jax
    import jax.numpy as jnp

    from cyberfabric_core_tpu.models import bert as jbert
    from cyberfabric_core_tpu.models.configs import get_config as jget_config
    from cyberfabric_core_tpu.runtime.weights import save_bert_params

    path = tmp_path_factory.mktemp("tiny-bert")
    cfg = jget_config("tiny-bert")
    save_bert_params(jbert.init_params(cfg, jax.random.PRNGKey(2), jnp.float32), cfg, path)
    return path


TEXTS = ["hello world", "the quick brown fox " * 12, "x", "héllo ✓", "a", "b", "c", "d",
         "a ninth input, past one batch of 8"]


def test_embed_matches_the_jax_worker_on_a_shared_checkpoint(bert_checkpoint):
    """Both workers serve the checkpoint at bf16 (the JAX loader's default):
    the same token count, the same number of vectors, each of unit norm and
    within cosine 0.999 and 1e-2 per component of JAX's (two bf16 forwards
    round at different points)."""
    jax_vecs, jax_n = LocalTpuWorker()._embed_blocking(
        _bert_info(checkpoint=str(bert_checkpoint), info_cls=jax_sdk.ModelInfo), TEXTS, {})
    worker = LocalTorchWorker({"device": "cpu"})
    try:
        vecs, n = worker._embed_blocking(_bert_info(checkpoint=str(bert_checkpoint)), TEXTS, {})
    finally:
        worker.close()
    mine, ref = np.asarray(vecs), np.asarray(jax_vecs)
    assert n == jax_n == sum(len(ByteTokenizer(384).encode(t)[:128]) for t in TEXTS)
    assert mine.shape == ref.shape == (len(TEXTS), 32)
    np.testing.assert_allclose(np.linalg.norm(mine, axis=1), 1.0, rtol=1e-5)
    cos = (mine * ref).sum(1) / np.linalg.norm(ref, axis=1)
    assert cos.min() >= 0.999, cos
    np.testing.assert_allclose(mine, ref, atol=1e-2)


def test_without_a_card_embed_raises_at_the_encoder_build():
    """No silent CPU fallback on the embeddings path either."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device builds there")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LocalTorchWorker()._embed_blocking(_bert_info(), ["x"], {})


def test_embed_with_a_missing_checkpoint_raises():
    worker = LocalTorchWorker({"device": "cpu"})
    try:
        with pytest.raises(FileNotFoundError, match="does not exist"):
            worker._embed_blocking(_bert_info(checkpoint="/nonexistent/bert"), ["x"], {})
    finally:
        worker.close()


def test_embed_without_a_checkpoint_serves_seeded_random_weights(caplog):
    """Random weights from a seeded generator, with a warning: two workers
    give the same vectors."""
    out = []
    for _ in range(2):
        worker = LocalTorchWorker({"device": "cpu"})
        try:
            with caplog.at_level("WARNING", logger="llm_worker"):
                out.append(worker._embed_blocking(_bert_info(), ["same text"], {}))
        finally:
            worker.close()
    assert out[0] == out[1] and out[0][1] == len(ByteTokenizer(384).encode("same text"))
    assert "RANDOM-WEIGHT" in caplog.text


def test_embed_builds_once_and_lists_the_model():
    """Concurrent first requests build the encoder once (single-flight);
    ``health`` lists it beside the chat engines."""
    import asyncio

    worker = LocalTorchWorker({"device": "cpu"})
    builds = []
    build = worker._build_embed_entry

    def counted(key, model):
        builds.append(key)
        return build(key, model)

    worker._build_embed_entry = counted

    async def go():
        info = _bert_info()
        got = await asyncio.gather(*(worker.embed(info, [f"text {i}"], {}) for i in range(4)))
        await _complete(worker, _tiny("a"), 2)
        return got, await worker.health()

    try:
        got, health = asyncio.run(go())
    finally:
        worker.close()
    assert builds == ["embed::local::tiny-bert"]
    assert all(len(vecs) == 1 and len(vecs[0]) == 32 for vecs, _ in got)
    assert health["loaded_models"] == ["local::a", "embed::local::tiny-bert"]
