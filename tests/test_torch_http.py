"""The port's HTTP host against the JAX stack, on the CPU (the error cases
and deadlines are in ``tests/test_torch_http_errors.py``).

Both servers boot from the same config sections (the JAX host as
``tests/test_golden_parity.py`` boots it, the port's with its worker on
``device: cpu``), each on an event loop in a thread of its own, and get the
same requests over ``http.client``. The chat model is
``tiny-llama-golden`` at f32 from its committed HF fixture:

- greedy ``/v1/completions`` text equals the unit-level continuation of the
  HF-pinned forward on both servers, and both servers give the same chat
  text;
- the sync response and every SSE chunk carry the same JSON keys;
- the SSE contract (``tests/test_e2e_server.py:224``), ``X-Request-Id`` on
  the SSE response (``:806``), and the disconnect-abort (``:187``), read
  through the port engine's ``cancellations``;
- ``/v1/embeddings`` on a tiny-bert checkpoint the JAX package wrote: the
  same JSON keys, model and usage on both servers, vectors within cosine
  0.999 and 1e-2 per component (both serve bf16 and round at different
  points), and the same problem for each bad body; the port's quickstart
  answers ``default-embed``;
- the lockstep scheduler (``scheduler: lockstep`` on both workers): the
  port engine emits the JAX engine's token ids for a greedy completion and
  a chat (recorded at each engine's ``generate_stream``), both texts are
  the HF continuation, and ``speculative`` ``ngram`` and ``draft`` (the
  golden checkpoint drafting for itself) serve the same text.
"""

from __future__ import annotations

import asyncio
import http.client
import json
import socket
import threading
import time
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from cyberfabric_core_tpu_torch.server import BackgroundServer

FAM = "tiny-llama-golden"
CKPT = Path(__file__).parent / "golden" / "fixtures" / FAM
PROMPT = "A TPU multiplies matrices."
N_NEW = 8


def _models():
    golden = {"provider_slug": "local", "provider_model_id": FAM,
              "approval_state": "approved", "managed": True, "architecture": "llama",
              "format": "safetensors", "checkpoint_path": str(CKPT),
              "capabilities": {"chat": True, "streaming": True},
              "limits": {"max_input_tokens": 48, "max_output_tokens": 64},
              "engine_options": {"model_config": FAM, "max_seq_len": 128, "max_batch": 2,
                                 "dtype": "float32"}}
    return [
        golden,
        # one slot, one queue place, a long window: backpressure and deadlines
        {**golden, "provider_model_id": "one-slot", "limits": {"max_input_tokens": 48},
         "engine_options": {**golden["engine_options"], "max_seq_len": 1024, "max_batch": 1,
                            "max_pending": 1}},
        {"provider_slug": "local", "provider_model_id": "pending-model",
         "approval_state": "pending", "engine_options": {"model_config": FAM}},
        # random weights, a long window: streams that outlast a disconnect
        {"provider_slug": "local", "provider_model_id": "tiny-llama",
         "approval_state": "approved", "managed": True,
         "engine_options": {"model_config": "tiny-llama", "max_seq_len": 2048,
                            "max_batch": 2, "dtype": "float32"}},
    ]


def _bert_model(checkpoint: str) -> dict:
    return {"provider_slug": "local", "provider_model_id": "tiny-bert-ckpt",
            "approval_state": "approved", "managed": True, "architecture": "bert",
            "checkpoint_path": checkpoint, "capabilities": {"embeddings": True},
            "engine_options": {"model_config": "tiny-bert"}}


def _sections(worker: dict, bert_checkpoint: str | None = None,
              models: list | None = None) -> dict:
    models, aliases = models or _models(), {"default-chat": f"local::{FAM}"}
    if bert_checkpoint is not None:
        models.append(_bert_model(bert_checkpoint))
        aliases["default-embed"] = "local::tiny-bert-ckpt"
    return {
        "api_gateway": {"config": {"bind_addr": "127.0.0.1:0", "auth_disabled": True,
                                   "max_body_bytes": 65536}},
        "tenant_resolver": {}, "authn_resolver": {},
        "model_registry": {"config": {"models": models, "aliases": aliases}},
        "llm_gateway": {"config": {"worker": worker}},
    }


class _JaxStack:
    """The JAX host on a loop in a thread of its own."""

    def __init__(self, home: Path, bert_checkpoint: str | None = None,
                 worker: dict | None = None, models: list | None = None) -> None:
        from cyberfabric_core_tpu.modkit import AppConfig, ClientHub, ModuleRegistry, RunOptions
        from cyberfabric_core_tpu.modkit.db import DbManager
        from cyberfabric_core_tpu.modkit.runtime import HostRuntime
        import cyberfabric_core_tpu.modules  # noqa: F401 — registers every module

        cfg = AppConfig.load_or_default(environ={}, cli_overrides={
            "server": {"home_dir": str(home)},
            "modules": {**_sections(worker or {"batch_window_ms": 2}, bert_checkpoint,
                                    models),
                        "authz_resolver": {}}})
        registry = ModuleRegistry.discover_and_build(enabled=cfg.module_names())
        self.registry = registry
        self.rt = HostRuntime(RunOptions(config=cfg, registry=registry,
                                         client_hub=ClientHub(),
                                         db_manager=DbManager(in_memory=True)))
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever, daemon=True)
        self.thread.start()
        asyncio.run_coroutine_threadsafe(self.rt.run_setup_phases(), self.loop).result(120)
        self.port = registry.get("api_gateway").instance.bound_port

    def stop(self) -> None:
        self.rt.root_token.cancel()
        asyncio.run_coroutine_threadsafe(self.rt.run_stop_phase(), self.loop).result(60)
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(30)
        self.loop.close()


def _write_bert_checkpoint(path: Path) -> str:
    """A tiny-bert checkpoint written by the JAX package's saver."""
    import jax

    from cyberfabric_core_tpu.models import bert as jbert
    from cyberfabric_core_tpu.models.configs import get_config as jget_config
    from cyberfabric_core_tpu.runtime.weights import save_bert_params

    cfg = jget_config("tiny-bert")
    save_bert_params(jbert.init_params(cfg, jax.random.PRNGKey(7), jnp.float32), cfg, path)
    return str(path)


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    bert_checkpoint = _write_bert_checkpoint(tmp_path_factory.mktemp("tiny-bert"))
    jax_stack = _JaxStack(tmp_path_factory.mktemp("jax-home"), bert_checkpoint)
    port = BackgroundServer({"modules": _sections({"device": "cpu"}, bert_checkpoint)}).start()
    yield {"jax": jax_stack.port, "port": port.port, "port_server": port}
    port.stop()
    jax_stack.stop()


def request(port, method, path, body=None, headers=None, raw=None):
    """(status, headers with lower-case names, body: JSON or text)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        data = raw if raw is not None else (json.dumps(body).encode()
                                            if body is not None else None)
        conn.request(method, path, body=data,
                     headers={"Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read()
        hdrs = {k.lower(): v for k, v in resp.getheaders()}
    finally:
        conn.close()
    try:
        return resp.status, hdrs, json.loads(payload)
    except ValueError:
        return resp.status, hdrs, payload.decode()


def sse_chunks(text: str) -> list:
    frames = [f for f in text.split("\n\n") if f.startswith("data: ")]
    assert frames[-1] == "data: [DONE]"
    return [json.loads(f[6:]) for f in frames[:-1]]


def both(servers, *args, **kw):
    return {name: request(servers[name], *args, **kw) for name in ("jax", "port")}


def _expected_continuation() -> str:
    """Greedy N_NEW tokens of the HF-pinned unit forward (the JAX one), as
    ``tests/test_golden_parity.py`` computes them."""
    from cyberfabric_core_tpu.models.configs import MODEL_CONFIGS
    from cyberfabric_core_tpu.models.llama import forward, init_cache, lm_head_logits
    from cyberfabric_core_tpu.ops.rope import rope_frequencies
    from cyberfabric_core_tpu.runtime.tokenizer import load_tokenizer
    from cyberfabric_core_tpu.runtime.weights import load_llama_params

    cfg = MODEL_CONFIGS[FAM]
    params = load_llama_params(CKPT, cfg, dtype=jnp.float32)
    tok = load_tokenizer(CKPT)
    ids = tok.encode(PROMPT)
    cache = init_cache(cfg, 1, 64, jnp.float32)
    rope = rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta)
    hidden, cache = forward(params, cfg, jnp.asarray([ids], jnp.int32),
                            jnp.arange(len(ids), dtype=jnp.int32)[None, :], cache,
                            jnp.zeros((1,), jnp.int32), rope)
    out = []
    nxt = int(np.asarray(lm_head_logits(params, cfg, hidden))[0, -1].argmax())
    for _ in range(N_NEW):
        out.append(nxt)
        pos = len(ids) + len(out) - 1
        hidden, cache = forward(params, cfg, jnp.asarray([[nxt]], jnp.int32),
                                jnp.asarray([[pos]], jnp.int32), cache,
                                jnp.asarray([pos], jnp.int32), rope)
        nxt = int(np.asarray(lm_head_logits(params, cfg, hidden))[0, -1].argmax())
    return tok.decode(out)


CHAT = {"model": "default-chat", "max_tokens": N_NEW,
        "messages": [{"role": "user", "content": [{"type": "text", "text": PROMPT}]}]}


def test_greedy_text_equals_the_hf_continuation_on_both_servers(servers):
    want = _expected_continuation()
    got = both(servers, "POST", "/v1/completions",
               {"model": f"local::{FAM}", "prompt": PROMPT, "max_tokens": N_NEW,
                "temperature": 0.0})
    for name, (status, _, body) in got.items():
        assert status == 200, (name, body)
        assert body["content"][0]["text"] == want, name
        assert body["usage"]["output_tokens"] == N_NEW
    assert got["jax"][2]["usage"] == got["port"][2]["usage"]
    chat = both(servers, "POST", "/v1/chat/completions", CHAT)
    assert chat["jax"][0] == chat["port"][0] == 200
    assert chat["port"][2]["content"] == chat["jax"][2]["content"]
    assert chat["port"][2]["usage"] == chat["jax"][2]["usage"]
    # the SSE stream carries the same text
    stream = both(servers, "POST", "/v1/completions",
                  {"model": f"local::{FAM}", "prompt": PROMPT, "max_tokens": N_NEW,
                   "stream": True})
    for name, (status, _, text) in stream.items():
        assert status == 200, name
        assert "".join(c["delta"].get("content", "") for c in sse_chunks(text)) == want


def _shape(obj):
    """Keys, recursively (values' types are the schema's business)."""
    if isinstance(obj, dict):
        return {k: _shape(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_shape(v) for v in obj[:1]]
    return None


def test_sync_and_sse_json_keys_match(servers):
    sync = both(servers, "POST", "/v1/chat/completions", CHAT)
    assert _shape(sync["port"][2]) == _shape(sync["jax"][2])
    stream = both(servers, "POST", "/v1/chat/completions", {**CHAT, "stream": True})
    jax_chunks, port_chunks = (sse_chunks(stream[n][2]) for n in ("jax", "port"))
    assert [_shape(c) for c in port_chunks] == [_shape(c) for c in jax_chunks]
    for name in ("jax", "port"):
        hdrs = stream[name][1]
        assert hdrs["content-type"].startswith("text/event-stream")
        assert hdrs["x-model-used"] == f"local::{FAM}"


def test_sse_contract(servers):
    """``tests/test_e2e_server.py:224``, on the port."""
    status, hdrs, text = request(servers["port"], "POST", "/v1/chat/completions",
                                 {**CHAT, "model": f"local::{FAM}", "max_tokens": 6,
                                  "stream": True})
    assert status == 200
    assert hdrs["content-type"].startswith("text/event-stream")
    chunks = sse_chunks(text)
    assert chunks[0]["delta"].get("role") == "assistant"
    assert all("role" not in c["delta"] for c in chunks[1:])
    assert all("id" in c and "model" in c and "delta" in c for c in chunks)
    final = chunks[-1]
    assert final["finish_reason"] in ("stop", "length")
    assert "usage" in final and final["usage"]["output_tokens"] > 0
    assert all("usage" not in c for c in chunks[:-1])
    assert chunks[0]["id"].startswith("chatcmpl-")


def test_sse_response_carries_the_request_id(servers):
    """``tests/test_e2e_server.py:806``, on both servers."""
    for name in ("jax", "port"):
        status, hdrs, _ = request(servers[name], "POST", "/v1/chat/completions",
                                  {**CHAT, "max_tokens": 4, "stream": True},
                                  headers={"x-request-id": f"sse-rid-{name}"})
        assert status == 200
        assert hdrs.get("x-request-id") == f"sse-rid-{name}"


def test_sse_disconnect_cancels_the_engine_request(servers):
    """``tests/test_e2e_server.py:187`` on the port: a client reads one frame
    of a long stream and leaves; the engine ends the request with one
    ``client_disconnect`` cancellation and serves the next request."""
    srv = servers["port_server"]
    body = json.dumps({"model": "local::tiny-llama", "prompt": "stream then vanish",
                       "max_tokens": 1500, "stream": True}).encode()
    request(servers["port"], "POST", "/v1/completions",
            {"model": "local::tiny-llama", "prompt": "warm", "max_tokens": 2})
    engine = srv.host.worker.engine("local::tiny-llama")
    before = engine.cancellations.get("client_disconnect", 0)
    sock = socket.create_connection(("127.0.0.1", servers["port"]), timeout=30)
    sock.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\nContent-Type: "
                 b"application/json\r\nContent-Length: " + str(len(body)).encode()
                 + b"\r\n\r\n" + body)
    got = b""
    while b"data: " not in got:
        got += sock.recv(4096)
    sock.close()
    deadline = time.monotonic() + 30.0
    while engine.cancellations.get("client_disconnect", 0) == before:
        assert time.monotonic() < deadline, "the disconnect never cancelled the request"
        time.sleep(0.02)
    assert engine.cancellations["client_disconnect"] == before + 1
    assert engine.tokens_emitted < 1500 + 2
    status, _, out = request(servers["port"], "POST", "/v1/completions",
                             {"model": "local::tiny-llama", "prompt": "after", "max_tokens": 4})
    assert status == 200 and out["usage"]["output_tokens"] == 4
    assert srv.host.llm.client_disconnects >= 1


def test_models_and_health(servers):
    status, _, body = request(servers["port"], "GET", "/v1/models")
    assert status == 200
    assert [m["canonical_id"] for m in body["items"]] == sorted(
        [f"local::{m['provider_model_id']}" for m in _models()] + ["local::tiny-bert-ckpt"])
    status, _, body = request(servers["port"], "GET", "/health")
    assert status == 200 and body["status"] == "ok"
    assert body["worker"]["devices"] == ["cpu"]


# ------------------------------------------------------------ embeddings
EMBED_INPUTS = ["hello world", "the quick brown fox " * 12, "x", "héllo ✓",
                "a", "b", "c", "d", "a ninth input, past one batch of 8"]


def test_embeddings_match_the_jax_stack(servers):
    """The same keys, model and usage on both servers; vectors of unit norm
    within cosine 0.999 and 1e-2 per component of the JAX stack's; a bare
    string is one input; ``dimensions`` and ``encoding_format`` are taken
    and do not change the answer, as in JAX."""
    for body in ({"model": "default-embed", "input": EMBED_INPUTS},
                 {"model": "local::tiny-bert-ckpt", "input": "one string"},
                 {"model": "default-embed", "input": ["x", "y"], "dimensions": 8,
                  "encoding_format": "base64"}):
        got = both(servers, "POST", "/v1/embeddings", body)
        (js, _, jbody), (ps, _, pbody) = got["jax"], got["port"]
        assert js == ps == 200, (jbody, pbody)
        assert _shape(pbody) == _shape(jbody)
        assert pbody["model"] == jbody["model"] == "local::tiny-bert-ckpt"
        assert pbody["usage"] == jbody["usage"] and pbody["usage"]["output_tokens"] == 0
        assert [d["index"] for d in pbody["data"]] == [d["index"] for d in jbody["data"]]
        mine = np.asarray([d["embedding"] for d in pbody["data"]])
        ref = np.asarray([d["embedding"] for d in jbody["data"]])
        n_in = len(body["input"]) if isinstance(body["input"], list) else 1
        assert mine.shape == ref.shape == (n_in, 32)
        np.testing.assert_allclose(np.linalg.norm(mine, axis=1), 1.0, rtol=1e-5)
        assert ((mine * ref).sum(1) / np.linalg.norm(ref, axis=1)).min() >= 0.999
        np.testing.assert_allclose(mine, ref, atol=1e-2)


@pytest.mark.parametrize("body", [
    {},
    {"model": "default-embed"},
    {"model": "default-embed", "input": []},
    {"model": "default-embed", "input": 3},
    {"model": "default-embed", "input": ["ok", 4]},
    {"model": "default-embed", "input": "x", "dimensions": 0},
    {"model": "default-embed", "input": "x", "encoding_format": "hex"},
    {"model": "default-embed", "input": "x", "user": "extra"},
    {"model": "local::no-such-model", "input": "x"},
])
def test_embeddings_bad_bodies_give_the_jax_problem(servers, body):
    got = both(servers, "POST", "/v1/embeddings", body)
    (js, _, jbody), (ps, _, pbody) = got["jax"], got["port"]
    assert ps == js >= 400, (jbody, pbody)
    for key in ("code", "status", "errors"):
        assert pbody.get(key) == jbody.get(key), (key, jbody, pbody)


def test_the_quickstart_answers_default_embed():
    """The port's quickstart config (its worker on the CPU) serves tiny-bert
    under ``default-embed``, with random weights from a seed."""
    from cyberfabric_core_tpu_torch import server

    cfg = json.loads(server.QUICKSTART.read_text())
    cfg["modules"]["api_gateway"]["config"]["bind_addr"] = "127.0.0.1:0"
    cfg["modules"]["llm_gateway"]["config"]["worker"]["device"] = "cpu"
    srv = BackgroundServer(cfg).start()
    try:
        status, _, body = request(srv.port, "POST", "/v1/embeddings",
                                  {"model": "default-embed", "input": ["hello", "world"]})
    finally:
        srv.stop()
    assert status == 200, body
    assert body["model"] == "local::tiny-bert"
    vecs = np.asarray([d["embedding"] for d in body["data"]])
    assert vecs.shape == (2, 32)
    np.testing.assert_allclose(np.linalg.norm(vecs, axis=1), 1.0, rtol=1e-5)
    from cyberfabric_core_tpu_torch.runtime.tokenizer import ByteTokenizer

    tok = ByteTokenizer(384)
    assert body["usage"] == {"input_tokens": len(tok.encode("hello")) + len(tok.encode("world")),
                             "output_tokens": 0}


# ------------------------------------------------------------ lockstep
def _lockstep_models() -> list:
    golden = _models()[0]
    opts = golden["engine_options"]
    return [golden,
            {**golden, "provider_model_id": "ngram",
             "engine_options": {**opts, "speculative": "ngram", "spec_k": 4}},
            {**golden, "provider_model_id": "draft",
             "engine_options": {**opts, "speculative": "draft", "spec_k": 4,
                                "draft_model": FAM, "draft_checkpoint": str(CKPT)}}]


@pytest.fixture(scope="module")
def lockstep_servers(tmp_path_factory):
    jax_stack = _JaxStack(tmp_path_factory.mktemp("jax-lockstep"),
                          worker={"batch_window_ms": 2, "scheduler": "lockstep"},
                          models=_lockstep_models())
    port = BackgroundServer({"modules": _sections(
        {"device": "cpu", "scheduler": "lockstep", "batch_window_ms": 2}, None,
        _lockstep_models())}).start()
    yield {"jax": jax_stack.port, "port": port.port, "port_server": port,
           "jax_stack": jax_stack}
    port.stop()
    jax_stack.stop()


def _record_ids(engine) -> list:
    """Every token id ``engine.generate_stream`` emits from now on."""
    seen: list = []
    stream = engine.generate_stream

    def recording(prompts, sampling):
        for ev in stream(prompts, sampling):
            if ev.token_id >= 0:
                seen.append(ev.token_id)
            yield ev

    engine.generate_stream = recording
    return seen


def _lockstep_engines(servers, model: str) -> dict:
    jax_worker = servers["jax_stack"].registry.get("llm_gateway").instance.worker
    return {"jax": jax_worker._entries[model].engine,
            "port": servers["port_server"].host.worker.engine(model)}


def test_lockstep_serves_the_jax_lockstep_workers_ids(lockstep_servers):
    model = f"local::{FAM}"
    body = {"model": model, "prompt": PROMPT, "max_tokens": N_NEW, "temperature": 0.0}
    both(lockstep_servers, "POST", "/v1/completions", {**body, "max_tokens": 2})  # builds
    engines = _lockstep_engines(lockstep_servers, model)
    from cyberfabric_core_tpu_torch.runtime.engine import InferenceEngine

    assert type(engines["port"]) is InferenceEngine
    ids = {name: _record_ids(e) for name, e in engines.items()}
    want = _expected_continuation()
    got = both(lockstep_servers, "POST", "/v1/completions", body)
    for name, (status, _, out) in got.items():
        assert status == 200, (name, out)
        assert out["content"][0]["text"] == want, name
        assert out["usage"]["output_tokens"] == N_NEW
    assert ids["port"] == ids["jax"] and len(ids["port"]) == N_NEW
    chat = both(lockstep_servers, "POST", "/v1/chat/completions", CHAT)
    assert chat["jax"][0] == chat["port"][0] == 200
    assert chat["port"][2]["content"] == chat["jax"][2]["content"]
    assert chat["port"][2]["usage"] == chat["jax"][2]["usage"]
    assert ids["port"] == ids["jax"] and len(ids["port"]) == 2 * N_NEW
    stream = both(lockstep_servers, "POST", "/v1/completions", {**body, "stream": True})
    for name, (status, _, text) in stream.items():
        assert status == 200, name
        chunks = sse_chunks(text)
        assert "".join(c["delta"].get("content", "") for c in chunks) == want
        assert chunks[-1]["finish_reason"] == "length"


@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_lockstep_speculation_is_served(lockstep_servers, mode):
    """A speculative model on both lockstep workers: the greedy text and
    usage equal the plain continuation, and the port's engine speculated."""
    model = f"local::{mode}"
    body = {"model": model, "prompt": PROMPT, "max_tokens": N_NEW, "temperature": 0.0}
    got = both(lockstep_servers, "POST", "/v1/completions", body)
    want = _expected_continuation()
    for name, (status, _, out) in got.items():
        assert status == 200, (name, out)
        assert out["content"][0]["text"] == want, name
    assert got["jax"][2]["usage"] == got["port"][2]["usage"]
    stats = _lockstep_engines(lockstep_servers, model)["port"].spec_stats
    assert stats["verify_calls"] + stats["fallback_steps"] > 0, stats
    if mode == "draft":  # the checkpoint drafts for itself: every draft accepted
        assert stats["accepted"] == stats["drafted"] > 0, stats
