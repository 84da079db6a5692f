"""The port's federation runtime (``runtime/federation.py``) against the JAX
package's: the prompt digests, the worker registry's leases, the router's
rungs (prefix > health > load > random, all shedding → ``HostShedError``)
and the pool's token ledger and mid-stream failover over in-process fake
worker clients. Each scenario runs through both packages on the same census
and seed, and the two must decide alike."""

import asyncio
import time

import pytest

from cyberfabric_core_tpu.modkit.errors import ProblemError as JProblemError
from cyberfabric_core_tpu.modules.sdk import ChatStreamChunk as JChunk
from cyberfabric_core_tpu.runtime import federation as jfed
from cyberfabric_core_tpu_torch.modkit.errcat import ERR as PERR
from cyberfabric_core_tpu_torch.modkit.errors import ProblemError as PProblemError
from cyberfabric_core_tpu_torch.modules.sdk import ChatStreamChunk as PChunk
from cyberfabric_core_tpu_torch.runtime import federation as pfed

MODEL = "local::fed-test"
#: (federation module, stream chunk class, problem error class) of each package
IMPLS = {"jax": (jfed, JChunk, JProblemError), "port": (pfed, PChunk, PProblemError)}
TIMING_KEYS = {"lease_age_s", "expires_in_s", "evicted_at", "state_since", "ts"}


def _strip(doc):
    """``doc`` without its clock readings (each package reads its own)."""
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in TIMING_KEYS}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


# ------------------------------------------------------------ prefix digests
TEXTS = ["", "x" * 47, "x" * 96, "x" * 100, "A" * 48 + "B" * 48, "héllo wörld " * 40,
         "federated e2e prefix probe alpha " * 4, "z" * 48 * 100]


@pytest.mark.parametrize("text", TEXTS, ids=lambda t: f"len{len(t)}")
@pytest.mark.parametrize("geometry", [(48, 64), (16, 4), (7, 200)])
def test_digest_chain_equals_jax(text, geometry):
    block, blocks = geometry
    assert pfed.digest_chain(text, block, blocks) == jfed.digest_chain(text, block, blocks)


def test_match_depth_and_prompt_text_equal_jax():
    chains = [jfed.digest_chain(t) for t in TEXTS]
    for a in chains:
        assert pfed.match_depth(a, chains) == jfed.match_depth(a, chains)
        assert pfed.match_depth(a, []) == jfed.match_depth(a, []) == 0
    msgs = [{"role": "user", "content": [{"type": "text", "text": "one"},
                                         {"type": "image", "url": "x"},
                                         {"type": "text", "text": "two"}]},
            {"role": "assistant", "content": "three"}]
    for kw in ({"messages": msgs}, {"prompt": "raw"}, {"messages": msgs, "prompt": "raw"},
               {}):
        assert pfed.prompt_text(**kw) == jfed.prompt_text(**kw)
    assert pfed.prompt_text(messages=msgs) == "one\x1ftwo\x1fthree"


# ----------------------------------------------------------------- registry
def _lease_cycle(fed):
    out = []
    reg = fed.WorkerRegistry(lease_ttl_s=60.0)
    seen = []
    reg.add_lease_listener(lambda w, reason: seen.append((w.host, reason)))
    reg.add_lease_listener(lambda w, reason: 1 / 0)  # an observer never breaks it
    got = reg.announce({"instance_id": "ia", "host": "h0", "endpoint": "127.0.0.1:1",
                        "pid": 42, "models": [MODEL]})
    out.append(got)
    out.append((reg.healthy(), reg.lookup("ia").pid))
    out.append(reg.heartbeat("ia", {"load": 3, "models": [MODEL],
                                    "prefix": {MODEL: [["d1", "d2"], ["d3"]]}}))
    out.append(reg.heartbeat("never-announced"))
    out.append(reg.evict_expired())
    out.append(reg.evict_expired(now=time.time() + 61.0))
    out.append((reg.healthy(), reg.heartbeat("ia")))
    reg.announce({"instance_id": "ia", "host": "h0", "endpoint": "127.0.0.1:1"})
    out.append(reg.lookup("ia") is not None)
    reg.announce({"instance_id": "ib", "host": "b", "endpoint": "e-b", "roles": ["chat"]})
    reg.announce({"instance_id": "ic", "host": "c", "endpoint": "e-c"})
    reg.heartbeat("ic", {"models": ["other::model"]})
    out.append([w.host for w in reg.alive(model=MODEL)])
    out.append([w.host for w in reg.alive(role="embed")])
    out.append(reg.withdraw("ia"))
    out.append(reg.withdraw("ia"))
    reg.report_failure("ib")
    reg.evict_expired(now=time.time() + 61.0)
    out.append(list(seen))
    out.append(_strip(reg.rows()))
    for i in range(20):
        reg.withdraw(reg.announce({"host": f"h{i}", "endpoint": f"e{i}"})["instance_id"])
    out.append(len(reg.rows()["evicted"]))
    return out


def test_registry_leases_evictions_and_listeners_equal_jax():
    port = _lease_cycle(pfed)
    assert port == _lease_cycle(jfed)
    assert port[-3] == [("h0", "lease_expired"), ("h0", "withdrawn"), ("b", "crash"),
                        ("c", "lease_expired")]
    assert port[-1] == 16


def test_registry_rows_equal_jax_with_prefix_index():
    def rows(fed):
        reg = fed.WorkerRegistry(lease_ttl_s=5.0)
        reg.announce({"instance_id": "ia", "host": "a", "endpoint": "e-a",
                      "models": [MODEL], "roles": ["chat"], "pid": 7})
        reg.announce({"instance_id": "ib", "host": "b", "endpoint": "e-b"})
        reg.heartbeat("ia", {"load": 2, "requests_served": 9,
                             "prefix": {MODEL: [["d1", "d2"], ["d3"]]},
                             "recent_traces": {"r": "t"}})
        return reg.index_size(), _strip(reg.rows()), _strip(reg.lookup("ia").row())

    assert rows(pfed) == rows(jfed)
    assert rows(pfed)[0] == 2


# ------------------------------------------------------------------ routing
def _payload(state):
    return {"metrics": {}, "doctor": {"state": state, "state_since": 1.0, "reasons": [],
                                      "objectives": [], "watchdog_trips": {},
                                      "shed_tenants": [], "evals": 3},
            "terminals": [], "ts": 1.0}


CHAIN = jfed.digest_chain("p" * 96)

#: name → (per-host census, route calls as (chain, exclude), config)
ROUTES = {
    "prefix-within-slack": ({"a": {"load": 2, "prefix": {MODEL: [CHAIN]}}, "b": {"load": 0}},
                            [(CHAIN, ())] * 3, {}),
    "prefix-beyond-slack": ({"a": {"load": 3, "prefix": {MODEL: [CHAIN]}}, "b": {"load": 0}},
                            [(CHAIN, ())], {"prefix_slack": 2}),
    "least-loaded": ({"a": {"load": 1}, "b": {"load": 0}}, [([], ())] * 2, {}),
    "seeded-random": ({"a": {"load": 0}, "b": {"load": 0}, "c": {"load": 0}},
                      [([], ())] * 16, {"seed": 7}),
    "exclude": ({"a": {"load": 0}, "b": {"load": 5}}, [([], ("ia",))], {}),
    "health-steers": ({"a": {"observability": _payload("degraded")},
                       "b": {"observability": _payload("healthy")}}, [([], ())] * 6, {}),
    "prefix-on-sick-host": ({"a": {"observability": _payload("degraded"),
                                   "prefix": {MODEL: [CHAIN]}},
                             "b": {"observability": _payload("healthy")}}, [(CHAIN, ())], {}),
    "all-degraded": ({"a": {"observability": _payload("degraded")},
                      "b": {"observability": _payload("degraded")}}, [([], ())] * 4, {}),
    "shedding-and-degraded": ({"a": {"observability": _payload("shedding")},
                               "b": {"observability": _payload("degraded")}},
                              [([], ())] * 4, {}),
    "all-shedding": ({"a": {"observability": _payload("shedding")},
                      "b": {"observability": _payload("shedding")}}, [([], ())], {}),
    "no-host-left": ({"a": {"load": 0}}, [([], ("ia",))], {}),
}


def _route_run(fed, census, calls, cfg):
    reg = fed.WorkerRegistry(lease_ttl_s=60.0)
    for host, c in census.items():
        reg.announce({"instance_id": f"i{host}", "host": host, "endpoint": f"e-{host}"})
        reg.heartbeat(f"i{host}", c)
    pool = fed.FederatedServingPool(reg, lambda w: None, dict, fed.FederationConfig(**cfg))
    picks = []
    for chain, exclude in calls:
        try:
            w, reason = pool.route(MODEL, chain, exclude=exclude)
            picks.append((w.host, reason))
        except fed.HostShedError as e:
            picks.append(("HostShedError", e.retry_after_s))
        except RuntimeError as e:
            picks.append(("RuntimeError", str(e)))
    return picks, dict(pool.placements)


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_picks_jax_s_host_for_jax_s_reason(name):
    census, calls, cfg = ROUTES[name]
    port = _route_run(pfed, census, calls, cfg)
    assert port == _route_run(jfed, census, calls, cfg)
    picks = port[0]
    expect = {"prefix-within-slack": {("a", "prefix")},
              "prefix-beyond-slack": {("b", "load")},
              "exclude": {("b", "load")},
              "health-steers": {("b", "health"), ("b", "load")},
              "prefix-on-sick-host": {("b", "health")},
              "shedding-and-degraded": {("b", "load"), ("b", "health")},
              "all-shedding": {("HostShedError", 2.0)}}.get(name)
    if expect is not None:
        assert set(picks) <= expect, picks
    if name == "seeded-random":
        assert {r for _, r in picks} == {"random"} and len({h for h, _ in picks}) >= 2
    if name == "no-host-left":
        assert picks[0][0] == "RuntimeError"


def test_inflight_streams_count_toward_load_as_in_jax():
    def run(fed):
        reg = fed.WorkerRegistry()
        for h in ("a", "b"):
            reg.announce({"instance_id": f"i{h}", "host": h, "endpoint": f"e-{h}"})
        pool = fed.FederatedServingPool(reg, lambda w: None, dict)
        pool._bump_inflight("ia", +2)  # two streams routed there, census not yet
        return pool.route(MODEL, [])[0].host, pool.route(MODEL, [])[1]

    assert run(pfed) == run(jfed) == ("b", "load")


def test_registry_resolves_lazily_as_in_jax():
    for fed, _, _ in IMPLS.values():
        holder = {}
        pool = fed.FederatedServingPool(lambda: holder.get("reg"), lambda w: None, dict)
        with pytest.raises(RuntimeError, match="grpc_hub"):
            pool.registry()
        holder["reg"] = reg = fed.WorkerRegistry()
        assert pool.registry() is reg and pool.registry() is reg


# ----------------------------------------------------------------- failover
class FakeWorkerClient:
    """An LlmWorkerApi-shaped fake that honours the continuation protocol:
    it skips the carried tokens and reports them as prompt, as a worker
    re-prefilling them does."""

    def __init__(self, chunk_cls, tokens, crash_after=None, problem=None,
                 input_tokens=10):
        self.chunk_cls = chunk_cls
        self.tokens = tokens
        self.crash_after = crash_after
        self.problem = problem
        self.input_tokens = input_tokens
        self.calls: list[dict] = []
        self.closed = False

    async def completion_stream(self, model, prompt, params):
        self.calls.append(dict(params))
        if self.problem is not None:
            raise self.problem
        start = len(params.get("_resume_token_ids") or [])
        for emitted, (tid, text) in enumerate(self.tokens[start:]):
            if self.crash_after is not None and emitted >= self.crash_after:
                raise ConnectionError("host died mid-stream")
            yield self.chunk_cls(request_id=params["_request_id"], text=text, token_id=tid)
        yield self.chunk_cls(request_id=params["_request_id"], finish_reason="stop",
                             usage={"input_tokens": self.input_tokens + start,
                                    "output_tokens": len(self.tokens) - start})

    async def close(self):
        self.closed = True


# an empty text is a token whose text the worker's detokenizer still holds
TOKENS = [(11, "Hello"), (12, " wor"), (15, ""), (13, "ld"), (14, "!")]

#: name → (crash_after per host, max_tokens, failover config, remote problem on a)
FAILOVERS = {
    "one-failover": ({"a": 2, "b": None}, 16, {}, False),
    "failover-on-held-token": ({"a": 3, "b": None}, 16, {}, False),
    "budget-served": ({"a": 3, "b": None}, 3, {}, False),
    "exhausted": ({"a": 0, "b": 0}, 16, {"max_failovers": 1}, False),
    "remote-problem": ({"a": None, "b": None}, 16, {}, True),
    "clean": ({"a": None, "b": None}, 16, {}, False),
}


def _failover_run(impl, crash, max_tokens, cfg, problem):
    fed, chunk_cls, problem_cls = IMPLS[impl]
    err = PERR if impl == "port" else None
    if problem:
        from cyberfabric_core_tpu.modkit.errcat import ERR as JERR
        boom = (err or JERR).llm.context_length_exceeded.error("prompt too long")
    reg = fed.WorkerRegistry()
    for h, load in (("a", 0), ("b", 1)):  # a wins the first route
        reg.announce({"instance_id": f"i{h}", "host": h, "endpoint": f"e-{h}"})
        reg.heartbeat(f"i{h}", {"load": load})
    clients = {f"i{h}": FakeWorkerClient(chunk_cls, TOKENS, crash_after=c,
                                         problem=boom if problem and h == "a" else None)
               for h, c in crash.items()}
    pool = fed.FederatedServingPool(reg, lambda w: clients[w.instance_id], chunk_cls,
                                    fed.FederationConfig(failover_backoff_s=0.001, **cfg))

    async def go():
        chunks = []
        async for ch in pool.completion_stream(MODEL, "q" * 96,
                                               {"max_tokens": max_tokens,
                                                "_request_id": "rid-1"}):
            chunks.append((ch.text, ch.token_id, ch.finish_reason, ch.usage))
        return chunks

    try:
        outcome = asyncio.run(go())
    except problem_cls as e:
        outcome = ("problem", e.problem.status, e.problem.code)
    except ConnectionError as e:
        outcome = ("ConnectionError", str(e))
    resumed = [c.get("_resume_token_ids") for cl in clients.values() for c in cl.calls]
    return {"outcome": outcome, "stats": pool.stats(), "healthy": reg.healthy(),
            "evicted": [(e["host"], e["reason"]) for e in reg.rows()["evicted"]],
            "resumed": resumed, "closed": {k: c.closed for k, c in clients.items()},
            "fed_flag": all(c.get("_fed_token_stream") for cl in clients.values()
                            for c in cl.calls)}


@pytest.mark.parametrize("name", sorted(FAILOVERS))
def test_stream_ledger_and_failover_equal_jax(name):
    args = FAILOVERS[name]
    port = _failover_run("port", *args)
    assert port == _failover_run("jax", *args)
    assert port["fed_flag"]
    if name in ("one-failover", "failover-on-held-token", "clean"):
        chunks = port["outcome"]
        # exactly one terminal, the stream's text whole, empty chunks dropped
        assert [c[2] for c in chunks if c[2]] == ["stop"]
        assert "".join(c[0] for c in chunks) == "Hello world!"
        assert all(c[0] or c[2] for c in chunks)
    if name == "one-failover":
        assert port["resumed"] == [None, [11, 12]]
        assert port["outcome"][-1][3] == {"input_tokens": 10, "output_tokens": 5}
        assert port["evicted"] == [("a", "crash")] and port["closed"]["ia"]
    if name == "budget-served":
        assert port["outcome"][-1][2:] == ("length", {"input_tokens": 0, "output_tokens": 3})
    if name == "exhausted":
        assert port["outcome"][0] == "ConnectionError" and port["healthy"] == 0
        assert port["stats"]["failovers_failed"] == 1
    if name == "remote-problem":
        assert port["outcome"] == ("problem", 422, "context_length_exceeded")
        assert port["healthy"] == 2


def test_no_live_host_is_a_503_and_all_shedding_a_429_as_in_jax():
    outs = {}
    for impl, (fed, chunk_cls, problem_cls) in IMPLS.items():
        got = []
        for state in (None, "shedding"):
            reg = fed.WorkerRegistry()
            if state:
                for h in ("a", "b"):
                    reg.announce({"instance_id": f"i{h}", "host": h, "endpoint": f"e-{h}"})
                    reg.heartbeat(f"i{h}", {"observability": _payload(state)})
            pool = fed.FederatedServingPool(reg, lambda w: None, chunk_cls)

            async def go():
                async for _ in pool.completion_stream(MODEL, "q", {}):
                    pass

            with pytest.raises(problem_cls) as ei:
                asyncio.run(go())
            p = ei.value.problem
            got.append((p.status, p.code, p.extensions.get("retry_after_s")))
        outs[impl] = got
    assert outs["port"] == outs["jax"] == [(503, "replica_unavailable", 1.0),
                                           (429, "load_shed", 2.0)]


def test_pool_monitoring_surfaces_equal_jax():
    def run(fed):
        reg = fed.WorkerRegistry()
        for h in ("a", "b"):
            reg.announce({"instance_id": f"i{h}", "host": h, "endpoint": f"e-{h}",
                          "models": [MODEL]})
        reg.heartbeat("ia", {"load": 1, "requests_served": 7, "capacity": {"tenants": {
            "acme": {"charged_tokens": 5, "active_slots": 1, "pages": 2, "pending": 0}}}})
        reg.heartbeat("ib", {"capacity": {"tenants": {
            "acme": {"charged_tokens": 3, "active_slots": 0, "pages": 1, "pending": 1}}}})
        reg.withdraw("ib")
        pool = fed.FederatedServingPool(reg, lambda w: None, dict)
        return (_strip(pool.replicas_view()), pool.replica_capacity(), pool.tenant_usage(),
                pool.stats(), _strip(asyncio.run(pool.health())), pool.schedulers())

    port = run(pfed)
    assert port == run(jfed)
    assert port[1]["serving"] == 1 and port[1]["quarantined"] == 1
