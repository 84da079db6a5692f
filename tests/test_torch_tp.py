"""Tensor-parallel serving in the port, on the CPU (mirror of
``tests/test_tp_engine.py``).

The composition suite of the JAX test (a greedy storm with a shared prefix,
a seeded stream beside a greedy one, a window-bound stream and a mid-stream
cancel, plus two long greedy streams that make the n-gram proposer draft)
runs through ONE port engine at tp 1, 2 and 8 (tiny-llama: at tp=2
each rank holds one kv head; at tp=8 the two kv heads replicate and a rank's
q columns are half a head), on CPU ranks, f32, the weights of the JAX engine
that ran the same suite at tp=2 on its forced-host mesh. Every greedy
stream equals the JAX engine's and the port's tp=1, token for token and
finish for finish (a cancelled stream up to its cut); the seeded stream is
held to the port's tp=1 (its draws come from torch generators, which JAX's
keys do not reproduce). The rank-order f32 reduction is not the unsharded
product's summation order: the logits of a sharded forward agree with the
unsharded one within 1e-5 (tests/test_torch_tp.py
``test_sharded_forward_logits_within_tolerance``), and that is what lets
the tokens agree.

Beside the streams: the machinery that ran (mixed rounds, the ring, spec
spans, the cancel), the ``mesh_info()`` surface against JAX's, the
phase-separated and dense paths, int8, int4 and the routed MoE at tp=2, a
preemption to host under tp, the plan's bytes against each rank's
allocation, the refusal of a pinned device, the worker's 507 for
llama-3-70b bf16 at tp=8 (JAX's problem, word for word), the dp x tp
refusal, and the ``llm_mesh_devices`` gauge and the replicas' mesh block.
"""

import asyncio
import threading

import jax
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.runtime import EngineConfig as JEngineConfig
from cyberfabric_core_tpu.runtime import SamplingParams as JSamplingParams
from cyberfabric_core_tpu.runtime.scheduler import ContinuousBatchingEngine as JEngine
from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.parallel.feasibility import InfeasiblePlanError
from cyberfabric_core_tpu_torch.parallel.mesh import RankMesh
from cyberfabric_core_tpu_torch.parallel.sharding import rank_bytes, shard_llama_params
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

OPTS = dict(model="tiny-llama", max_seq_len=128, max_batch=4, decode_chunk=4,
            prefix_cache_pages=64, prefix_page_size=8, decode_lookahead=2,
            scheduler_spec_k=2, dtype="float32")
#: the logits of a sharded f32 forward against the unsharded one
LOGIT_TOL = 1e-5


def _engine(tp: int, params=None, **over) -> ContinuousBatchingEngine:
    cfg = EngineConfig(**{**OPTS, **over, "tp": tp})
    where = {"device": "cpu"} if tp == 1 else {"rank_devices": ["cpu"] * tp}
    return ContinuousBatchingEngine(cfg, params=params, seed=0, **where)


def _drive(engine, requests, cancel_at=None, timeout=120.0):
    """Submit ``requests`` [(prompt, sampling)] and collect each stream as
    [(token_id, finished)]; ``cancel_at[i] = n`` cancels request i from its
    own emit once n tokens arrived (the JAX test's deterministic cancel)."""
    cancel_at = cancel_at or {}
    streams = {i: [] for i in range(len(requests))}
    rids = {}
    done = threading.Event()
    left = [len(requests)]

    def mk(i):
        seen = [0]

        def emit(ev):
            streams[i].append((ev.token_id, ev.finished))
            if ev.token_id >= 0:
                seen[0] += 1
                if seen[0] == cancel_at.get(i):
                    engine.cancel(rids[i], "test_cancel")
            if ev.finished:
                left[0] -= 1
                if left[0] == 0:
                    done.set()
        return emit

    for i, (prompt, sampling) in enumerate(requests):
        rids[i] = engine.submit(list(prompt), sampling, mk(i))
    assert done.wait(timeout), "streams did not finish"
    return streams


def _scenarios(engine, sp):
    """The JAX test's suite, in its order, through one engine; ``sp`` is
    the engine's SamplingParams class."""
    shared = [5, 6, 7] * 3
    return {
        "storm": _drive(engine, [(shared, sp(max_tokens=24)), (shared, sp(max_tokens=20)),
                                 ([20, 21, 22, 23] * 3, sp(max_tokens=16))]),
        "seeded": _drive(engine, [([3, 4, 5, 6, 7], sp(max_tokens=16, temperature=0.8,
                                                         top_p=0.9, seed=1234)),
                                  ([9, 8, 7, 6, 5, 4], sp(max_tokens=12))]),
        "window": _drive(engine, [([2] * 100, sp(max_tokens=500))]),
        "cancel": _drive(engine, [([40, 41, 42, 43, 44], sp(max_tokens=48)),
                                  ([50, 51, 52, 53], sp(max_tokens=20)),
                                  ([60, 61, 62, 63, 64, 65], sp(max_tokens=20))],
                         cancel_at={0: 3}),
        # long greedy streams off tiled prompts: random weights propose
        # drafts once their output cycles, which the f32 weights' short
        # streams above never do
        "spec": _drive(engine, [([5, 6, 7, 8] * 4, sp(max_tokens=72)),
                                ([9, 10, 11] * 5, sp(max_tokens=72))]),
    }


@pytest.fixture(scope="module")
def runs():
    """The suite on the JAX engine at tp=2, then on the port at tp 1, 2, 8
    over its weights: {tp or "jax": (stats, streams, mesh_info)}."""
    jengine = JEngine(JEngineConfig(**OPTS, tp=2), seed=0)
    jengine.start()
    try:
        out = {"jax": (None, _scenarios(jengine, JSamplingParams), jengine.mesh_info())}
        state = params_from_jax(jax.tree.map(np.asarray, jengine.params),
                                get_config("tiny-llama"))
    finally:
        jengine.shutdown()
    for tp in (1, 2, 8):
        engine = _engine(tp, params=state)
        try:
            streams = _scenarios(engine, SamplingParams)
        finally:
            engine.shutdown()
        out[tp] = (engine.stats(), streams, engine.mesh_info())
    out["state"] = state
    return out


def _assert_identical(a, b, scenario, cancelled=()):
    for i in a[scenario]:
        sa, sb = a[scenario][i], b[scenario][i]
        if i in cancelled:
            # the cancel lands at a round boundary: the cut may move with
            # host timing, the tokens before it and the terminal may not
            ra = [t for t, _ in sa if t >= 0]
            rb = [t for t, _ in sb if t >= 0]
            n = min(len(ra), len(rb))
            assert ra[:n] == rb[:n], f"{scenario}[{i}] diverged before the cancel"
            assert sa[-1][1] == sb[-1][1] == "cancelled"
        else:
            assert sa == sb, f"{scenario}[{i}] diverged"


@pytest.mark.parametrize("tp", [2, 8])
def test_tp_streams_equal_tp1_and_the_jax_tp2_engine(runs, tp):
    base, jax_run, mesh_run = runs[1][1], runs["jax"][1], runs[tp][1]
    for scenario in ("storm", "window", "spec"):
        _assert_identical(base, mesh_run, scenario)
        _assert_identical(jax_run, mesh_run, scenario)
    _assert_identical(base, mesh_run, "seeded")
    assert mesh_run["seeded"][1] == jax_run["seeded"][1]  # the greedy companion
    _assert_identical(base, mesh_run, "cancel", cancelled={0})
    _assert_identical(jax_run, mesh_run, "cancel", cancelled={0})


@pytest.mark.parametrize("tp", [2, 8])
def test_tp_compositions_actually_engaged(runs, tp):
    """Mixed rounds, the ring, spec spans and the cancel all ran on the
    sharded engine, and its pool conserved its pages."""
    stats = runs[tp][0]
    pipe = stats["pipeline"]
    assert pipe["mixed_rounds"] > 0 and pipe["lookahead_rounds"] > 0
    assert stats["speculative"]["proposed"] > 0
    assert stats["cancellations"].get("test_cancel") == 1
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0
    assert stats["pages_free"] + stats["cached_pages"] == stats["pages_total"]


def test_tp_mesh_surface(runs):
    """``mesh_info()`` (also ``stats()["mesh"]``) reports what JAX's does:
    degree, devices, topology, whether the kv heads shard, the page bytes a
    device holds and the plan's bytes; the port adds the rank devices."""
    one, two, eight, jax_two = runs[1][2], runs[2][2], runs[8][2], runs["jax"][2]
    assert one["tp"] == one["devices"] == 1 and "plan" not in one
    for key in ("tp", "devices", "topology", "kv_heads_sharded",
                "sharded_page_bytes_per_device"):
        assert two[key] == jax_two[key], key
    for key in ("param_bytes_per_device", "kv_bytes_per_device", "total_bytes_per_device",
                "fits", "enforced", "quantization"):
        assert two["plan"][key] == jax_two["plan"][key], key
    assert two["kv_heads_sharded"] is True and two["rank_devices"] == ["cpu", "cpu"]
    assert eight["kv_heads_sharded"] is False and eight["devices"] == 8
    assert eight["sharded_page_bytes_per_device"] == one["sharded_page_bytes_per_device"]
    assert runs[2][0]["mesh"] == two


@pytest.mark.parametrize("path", ["phase_separated", "dense"])
def test_tp_phase_separated_and_dense_identity(runs, path):
    """The other two engine paths at tp=2: greedy streams equal tp=1's (the
    dense cache takes the kv-head split too)."""
    over = ({"mixed_batch": False} if path == "phase_separated"
            else {"prefix_cache_pages": 0, "scheduler_spec_k": 0, "decode_lookahead": 0})
    reqs = [([5, 6, 7, 8] * 3, SamplingParams(max_tokens=10)),
            ([9, 10, 11], SamplingParams(max_tokens=8)),
            ([5, 6, 7, 8] * 3 + [1], SamplingParams(max_tokens=6))]
    got = {}
    for tp in (1, 2):
        engine = _engine(tp, params=runs["state"], **over)
        try:
            got[tp] = _drive(engine, reqs)
            mode = engine.stats()["mode"]
        finally:
            engine.shutdown()
    assert mode == path and got[1] == got[2]


@pytest.mark.parametrize("variant", ["int8", "int4", "tiny-moe"])
def test_quantized_and_moe_at_tp2_equal_tp1(variant):
    """int8 and int4 trees (int4 cut on whole bytes of its packed rows) and
    the routed MoE (router replicated, each expert's intermediate axis cut)
    serve at tp=2 the tokens tp=1 serves."""
    over = ({"model": "tiny-moe"} if variant == "tiny-moe"
            else {"quantization": variant})
    reqs = [([5, 6, 7, 8] * 3, SamplingParams(max_tokens=12)),
            ([30, 31, 32], SamplingParams(max_tokens=12))]
    got = {}
    for tp in (1, 2):
        engine = _engine(tp, **over)
        try:
            got[tp] = _drive(engine, reqs)
        finally:
            engine.shutdown()
    assert got[1] == got[2]


def test_sharded_forward_logits_within_tolerance():
    """The rank-order f32 reduction against the unsharded GEMM: prefill
    logits and the collected KV agree within ``LOGIT_TOL`` at tp 2 and 8
    (the KV heads of the ranks joined, or rank 0's replica)."""
    cfg = get_config("tiny-llama")
    model = llama.init_params(cfg, 0, torch.float32, "cpu")
    rope = rope_frequencies(cfg.head_dim, 256, cfg.rope_theta, device="cpu")
    ids = torch.randint(0, cfg.vocab_size, (2, 9), generator=torch.Generator().manual_seed(3))
    lengths = torch.tensor([9, 6])
    h1, kv1 = llama.prefill_collect(model, cfg, ids, lengths, rope)
    logits1 = llama.lm_head_logits(model, cfg, h1)
    for tp in (2, 8):
        sharded = shard_llama_params(model, RankMesh(["cpu"] * tp))
        h2, kv2 = llama.prefill_collect(sharded, cfg, ids, lengths, rope)
        logits2 = llama.lm_head_logits(sharded, cfg, h2)
        k2 = torch.cat(kv2[0], dim=3) if sharded.kv_sharded else kv2[0][0]
        assert (logits1 - logits2).abs().max().item() < LOGIT_TOL
        assert (kv1[0] - k2).abs().max().item() < LOGIT_TOL


def test_preemption_to_host_under_tp(runs):
    """A chain that cannot grow is saved to host with the ranks' heads
    joined, freed, restored split again, and the stream goes on with the
    tokens it would have had (held against tp=1 without preemption)."""
    reqs = [([5, 6, 7, 8] * 3, SamplingParams(max_tokens=20)),
            ([9, 10, 11], SamplingParams(max_tokens=20))]
    base = _engine(1, params=runs["state"])
    try:
        want = _drive(base, reqs)
    finally:
        base.shutdown()
    engine = _engine(2, params=runs["state"])
    real = engine.pool.extend_chain

    def extend(chain, length_needed):
        # fail every extension past 20 tokens until one preemption landed
        # (the ring's deeper horizon absorbs failures without preempting)
        if engine.preemptions == 0 and length_needed > 20:
            raise MemoryError("injected pool pressure")
        return real(chain, length_needed)

    engine.pool.extend_chain = extend
    try:
        got = _drive(engine, reqs)
        stats = engine.stats()
    finally:
        engine.shutdown()
    assert stats["preemptions"] >= 1 and got == want
    assert stats["pages_referenced"] == 0 and stats["orphan_pages"] == 0


def test_plan_bytes_equal_each_ranks_allocation(runs):
    """The gate's plan is what the engine allocates, at tp 2 (kv heads cut)
    and 8 (replicated), and int8 at tp=2: every rank's weights equal the
    plan's per-rank figure (rank 0 the per-device one, JAX's; the others
    less the embedding and norms only rank 0 holds), and every rank's pool
    the per-device kv bytes."""
    for tp, over in ((2, {}), (8, {}), (2, {"quantization": "int8"})):
        engine = _engine(tp, **over)
        try:
            plan = engine.mesh_info()["plan"]
            assert rank_bytes(engine.params) == plan["param_bytes_per_rank"]
            per_rank = plan["param_bytes_per_rank"]
            assert per_rank[0] == plan["param_bytes_per_device"] > per_rank[1]
            assert engine.pool.rank_bytes() == [plan["kv_bytes_per_device"]] * tp
        finally:
            engine.shutdown()


def test_tp_rejects_pinned_device():
    with pytest.raises(ValueError, match="pinned device"):
        ContinuousBatchingEngine(EngineConfig(**OPTS, tp=2), device="cpu")


def test_gate_refuses_before_allocating():
    """llama-3-70b bf16 at tp=8 over a 16 GiB budget: the typed error with
    the plan attached, raised before any weight is drawn (seconds, not a
    140 GB tree)."""
    cfg = EngineConfig(**{**OPTS, "model": "llama-3-70b", "dtype": "bfloat16",
                          "hbm_bytes_per_device": 16 * 1024**3}, tp=8)
    with pytest.raises(InfeasiblePlanError) as exc:
        ContinuousBatchingEngine(cfg, rank_devices=["cpu"] * 8)
    plan = exc.value.plan
    assert plan["fits"] is False and plan["enforced"] is True
    assert plan["total_bytes_per_device"] > 16 * 1024**3 and "tp=8" in str(exc.value)


def _models(opts):
    from cyberfabric_core_tpu.modules.sdk import ModelInfo as JModelInfo
    from cyberfabric_core_tpu_torch.modules.sdk import ModelInfo

    kw = dict(canonical_id="local::tp-model", provider_slug="local",
              provider_model_id="tp-model", engine_options=dict(opts))
    return JModelInfo(**kw), ModelInfo(**kw)


async def _first_chunk(worker, model):
    agen = worker.completion_stream(model, "hello", {"max_tokens": 4})
    try:
        return await agen.__anext__()
    finally:
        await agen.aclose()


def test_worker_infeasible_plan_is_clean_problem():
    """The worker's half of the gate: the 507 ``llm.infeasible_plan``
    problem at the first request, JAX's word for word, and no entry kept
    (a retry gates again)."""
    from cyberfabric_core_tpu.modkit.errors import ProblemError as JProblemError
    from cyberfabric_core_tpu.modules.llm_gateway.worker import LocalTpuWorker
    from cyberfabric_core_tpu_torch.modkit.errors import ProblemError
    from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import LocalTorchWorker

    jmodel, model = _models({"model_config": "llama-3-70b", "max_seq_len": 2048,
                             "max_batch": 8, "tp": 8, "hbm_bytes_per_device": 16 * 1024**3})
    with pytest.raises(JProblemError) as want:
        asyncio.run(_first_chunk(LocalTpuWorker({}), jmodel))
    worker = LocalTorchWorker({"device": "cpu"})
    try:
        with pytest.raises(ProblemError) as got:
            asyncio.run(_first_chunk(worker, model))
        assert not worker._entries
    finally:
        worker.close()
    problem = got.value.problem
    assert (problem.status, problem.code) == (507, "infeasible_plan")
    assert problem.to_dict() == want.value.problem.to_dict()
    assert "tp=8" in problem.detail


def test_worker_rejects_tp_with_dp_pool():
    from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import LocalTorchWorker

    _, model = _models({"model_config": "tiny-llama", "max_seq_len": 128, "max_batch": 2,
                        "tp": 2, "dp_replicas": 2})
    worker = LocalTorchWorker({"device": "cpu"})
    try:
        with pytest.raises(ValueError, match="cannot combine"):
            asyncio.run(_first_chunk(worker, model))
    finally:
        worker.close()


def test_mesh_gauge_and_replicas_block(tmp_path):
    """A worker serving tiny-llama at tp=2 on CPU ranks: ``llm_mesh_devices``
    reads 2, the replicas view carries the mesh block, and off the card the
    utilization gauge reads only an enforced plan."""
    from cyberfabric_core_tpu_torch.modkit.doctor import Doctor
    from cyberfabric_core_tpu_torch.modkit.metrics import MetricsRegistry
    from cyberfabric_core_tpu_torch.modules.llm_gateway.worker import LocalTorchWorker
    from cyberfabric_core_tpu_torch.modules.monitoring import MonitoringModule

    _, model = _models({"model_config": "tiny-llama", "max_seq_len": 128, "max_batch": 2,
                        "tp": 2, "hbm_bytes_per_device": 1 << 30})
    worker = LocalTorchWorker({"device": "cpu"})
    try:
        chunk = asyncio.run(_first_chunk(worker, model))
        assert chunk is not None
        registry = MetricsRegistry()
        MonitoringModule({}, worker, tmp_path, registry=registry, doctor=Doctor())
        text = registry.render()
        values = {line.split()[0]: float(line.split()[1]) for line in text.splitlines()
                  if line and not line.startswith("#")}
        assert values["llm_mesh_devices"] == 2.0
        row, = worker.replicas_view()
        assert row["mesh"]["tp"] == 2 and row["mesh"]["kv_heads_sharded"] is True
        plan = row["mesh"]["plan"]
        assert plan["enforced"] is True
        assert values["llm_hbm_utilization_per_device"] == plan["hbm_utilization"]
    finally:
        worker.close()


@pytest.mark.parametrize("tp", [1, 2, 3, 8])
def test_collectives_run_in_rank_order(tp):
    """``all_reduce_sum`` adds in rank order in f32 on rank 0 (one rank's
    part is the sum, as it is); ``all_gather`` concatenates in rank order;
    ``scatter`` hands rank 0's tensor itself to ranks on its device."""
    mesh = RankMesh(["cpu"] * tp)
    g = torch.Generator().manual_seed(tp)
    parts = [torch.randn(4, 5, generator=g).to(torch.bfloat16) for _ in range(tp)]
    want = parts[0].float()
    for p in parts[1:]:
        want = want + p.float()
    got = mesh.all_reduce_sum(parts)
    if tp == 1:
        assert got is parts[0]
    else:
        assert got.dtype == torch.float32 and torch.equal(got, want)
    assert torch.equal(mesh.all_gather(parts), torch.cat(parts, dim=-1))
    assert mesh.tp == tp and mesh.shared
    assert all(t is parts[0] for t in mesh.scatter(parts[0]))


def test_rank_devices_default_to_the_first_cards():
    """Without explicit rank devices a tp engine takes the first tp CUDA
    cards and raises when there are fewer; a mesh needs one device a rank,
    of one device type."""
    from cyberfabric_core_tpu_torch.parallel.mesh import cuda_rank_devices

    with pytest.raises(ValueError, match="at least one"):
        RankMesh([])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cuda_rank_devices(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ContinuousBatchingEngine(EngineConfig(model="tiny-llama", max_seq_len=64,
                                                  max_batch=2, prefix_cache_pages=8,
                                                  prefix_page_size=16, tp=2))
    with pytest.raises(ValueError, match="names 1 devices"):
        ContinuousBatchingEngine(EngineConfig(model="tiny-llama", tp=2), rank_devices=["cpu"])
