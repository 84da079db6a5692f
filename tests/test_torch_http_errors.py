"""The port's HTTP host against the JAX stack, on the CPU: error cases,
backpressure and deadlines (the servers and helpers of
``tests/test_torch_http.py``, booted again for this file).

Each case gives the same status and problem ``code`` on both servers, and
for a 422 the same ``errors[].field``: malformed JSON, schema violations,
an unknown model, a pending model (and with a fallback chain, the fallback
serves), a prompt over ``max_input_tokens``, bad and zero deadline headers,
a body over ``max_body_bytes`` (413), a body that is not JSON (415), an
unknown path (404) and method (405), and a burst over ``max_pending`` (429
with ``Retry-After``). Deadlines: a request whose deadline lapses before
admission gives 408 (the port reads the phase from its engine's lapse
record, JAX from its flight recorder), and one that lapses mid-stream ends
its SSE stream with ``finish_reason: deadline_exceeded`` on both.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

import pytest

from cyberfabric_core_tpu_torch.server import BackgroundServer
from test_torch_http import PROMPT, _JaxStack, _sections, request, sse_chunks

FAM = "tiny-llama-golden"
ONE_SLOT = "local::one-slot"
TEXT = [{"type": "text", "text": "x"}]


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    jax_stack = _JaxStack(tmp_path_factory.mktemp("jax-home"))
    port = BackgroundServer({"modules": _sections({"device": "cpu"})}).start()
    yield {"jax": jax_stack.port, "port": port.port, "port_server": port}
    port.stop()
    jax_stack.stop()


def both(servers, *args, **kw):
    return {name: request(servers[name], *args, **kw) for name in ("jax", "port")}


ERROR_CASES = {
    "malformed-json": dict(method="POST", path="/v1/chat/completions", raw=b"{not json"),
    "schema-422": dict(method="POST", path="/v1/chat/completions",
                       body={"model": "x", "messages": [{"role": "user", "content": "bare"}],
                             "top_p": 0, "extra": 1}),
    "completion-422": dict(method="POST", path="/v1/completions",
                           body={"model": ONE_SLOT}),
    "unknown-model": dict(method="POST", path="/v1/chat/completions",
                          body={"model": "ghost", "messages": [{"role": "user",
                                                                "content": TEXT}]}),
    "pending-model": dict(method="POST", path="/v1/chat/completions",
                          body={"model": "local::pending-model",
                                "messages": [{"role": "user", "content": TEXT}]}),
    "over-max-input": dict(method="POST", path="/v1/completions",
                           body={"model": ONE_SLOT, "prompt": "word " * 60, "max_tokens": 2}),
    "bad-deadline": dict(method="POST", path="/v1/completions",
                         body={"model": ONE_SLOT, "prompt": "hi", "max_tokens": 2},
                         headers={"X-Request-Deadline-Ms": "not-a-number"}),
    "zero-deadline": dict(method="POST", path="/v1/completions",
                          body={"model": ONE_SLOT, "prompt": "hi", "max_tokens": 2},
                          headers={"X-Request-Deadline-Ms": "0"}),
    "body-too-large": dict(method="POST", path="/v1/completions", raw=b" " * 70000),
    "not-json-media": dict(method="POST", path="/v1/completions", raw=b"{}",
                           headers={"Content-Type": "text/plain"}),
    "unknown-path": dict(method="GET", path="/v1/nothing-here"),
    "wrong-method": dict(method="GET", path="/v1/chat/completions"),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_cases_give_the_jax_status_and_code(servers, case):
    kw = dict(ERROR_CASES[case])
    got = both(servers, kw.pop("method"), kw.pop("path"), **kw)
    (js, jh, jb), (ps, ph, pb) = got["jax"], got["port"]
    assert ps == js, (case, jb, pb)
    assert pb["code"] == jb["code"], (case, jb, pb)
    assert ph["content-type"].startswith("application/problem+json")
    if js == 422 and "errors" in jb:
        assert [e["field"] for e in pb["errors"]] == [e["field"] for e in jb["errors"]]


def test_pending_model_with_a_fallback_chain_serves_the_fallback(servers):
    got = both(servers, "POST", "/v1/chat/completions",
               {"model": "local::pending-model", "fallback": {"models": [ONE_SLOT]},
                "messages": [{"role": "user", "content": TEXT}], "max_tokens": 4})
    for name, (status, _, body) in got.items():
        assert status == 200, (name, body)
        assert body["model_used"] == ONE_SLOT
        assert body["fallback_used"] is True


def test_max_pending_burst_gives_429_with_retry_after(servers):
    body = {"model": ONE_SLOT, "prompt": PROMPT, "max_tokens": 96}
    for name in ("jax", "port"):
        with ThreadPoolExecutor(6) as pool:
            results = list(pool.map(lambda _: request(servers[name], "POST",
                                                      "/v1/completions", body), range(6)))
        statuses = sorted(r[0] for r in results)
        assert 200 in statuses and 429 in statuses, (name, statuses)
        for status, hdrs, payload in results:
            if status == 429:
                assert payload["code"] == "scheduler_saturated", (name, payload)
                assert int(hdrs["retry-after"]) >= 1


def test_a_lapse_before_admission_gives_408(servers):
    """A deadline already past when the engine takes the request: it never
    occupies a slot (408 ``request_timeout``, not 504)."""
    got = both(servers, "POST", "/v1/completions",
               {"model": ONE_SLOT, "prompt": "late", "max_tokens": 4},
               headers={"X-Request-Deadline-Ms": "0.001"})
    for name, (status, _, body) in got.items():
        assert (status, body["code"]) == (408, "request_timeout"), (name, body)


def test_a_lapse_mid_stream_ends_the_stream_with_deadline_exceeded(servers):
    for name in ("jax", "port"):
        status, _, text = request(servers[name], "POST", "/v1/completions",
                                  {"model": ONE_SLOT, "prompt": PROMPT, "max_tokens": 1000,
                                   "stream": True},
                                  headers={"X-Request-Deadline-Ms": "1000"})
        assert status == 200, name
        final = sse_chunks(text)[-1]
        assert final["finish_reason"] == "deadline_exceeded", (name, final)
        assert 0 < final["usage"]["output_tokens"] < 1000
