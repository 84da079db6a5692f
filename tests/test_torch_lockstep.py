"""The port's lockstep ``InferenceEngine`` and its plain decode body against
the JAX package's, on the CPU.

tiny-llama in f32, weights from the JAX package's ``init_params`` carried
by ``params_from_jax``; prompts made with numpy from a seed. The port runs
on ``device="cpu"`` (the flash kernel's plain version where flash is on);
the JAX engine runs its flash kernel in interpret mode. Greedy tokens and
finish reasons must be equal; caches agree within TOL (the repo's golden
bar, tests/test_golden_parity.py). Also: the port's dense continuous
engine equals its lockstep engine at greedy (``tests/test_scheduler.py``'s
check), a padded prefill bucket gives an unpadded prompt's first token, and
the sampler's draws follow ``warped_probs`` (chi-square)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops import sampling as jsampling
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu.runtime import engine as jengine
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops import sampling
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime.engine import (EngineConfig, InferenceEngine,
                                                       SamplingParams,
                                                       build_decode_chunk_fn)
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(model="tiny-llama", max_seq_len=128, max_batch=2, decode_chunk=4,
            use_flash=False, dtype="float32")


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("tiny-llama")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    state = params_from_jax(jax.tree.map(np.asarray, jparams), get_config("tiny-llama"))
    return jcfg, jparams, state


def _prompts(seed: int, lengths) -> list[list[int]]:
    rng = np.random.default_rng(seed)
    return [rng.integers(3, 512, n).tolist() for n in lengths]


def _pair(model, **kw):
    jcfg, jparams, state = model
    cfg = {**BASE, **kw}
    je = jengine.InferenceEngine(jengine.EngineConfig(**cfg), params=jparams, seed=0)
    te = InferenceEngine(EngineConfig(**cfg), params=state, seed=0, device="cpu")
    return je, te


def _run(engine, prompts, sps, sp_cls):
    return [(r.token_ids, r.finish_reason) for r in engine.generate(
        prompts, [sp_cls(**dataclasses.asdict(sp)) for sp in sps])]


def test_plain_decode_body_matches_jax(model):
    """k=3 greedy steps over a cache prefilled by JAX: tokens equal, the
    caches within TOL."""
    jcfg, jparams, state = model
    from cyberfabric_core_tpu_torch.runtime.weights import model_from_state_dict

    cfg = get_config("tiny-llama")
    tparams = model_from_state_dict(state, cfg, device="cpu")
    B, S, k = 2, 32, 3
    lengths = np.asarray([5, 9], np.int32)
    ids = np.zeros((B, 9), np.int32)
    for i, p in enumerate(_prompts(1, lengths)):
        ids[i, :len(p)] = p
    jrt, trt = jrope(16, 256, 10000.0), rope_frequencies(16, 256, 10000.0, device="cpu")
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (B, 9))
    _, jcache = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                               jllama.init_cache(jcfg, B, S, jnp.float32),
                               jnp.zeros(B, jnp.int32), jrt)
    tcache = tuple(torch.from_numpy(np.array(c)) for c in jcache)
    last = np.asarray([7, 11], np.int32)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    jout = jengine.build_decode_chunk_fn(jcfg, k, jrt)(
        jparams, jcache[0], jcache[1], jnp.asarray(last), jnp.asarray(lengths),
        jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.asarray(ones), jnp.zeros(B, jnp.int32))
    tout = build_decode_chunk_fn(cfg, k, trt)(
        tparams, tcache[0], tcache[1], torch.from_numpy(last), torch.from_numpy(lengths),
        torch.Generator().manual_seed(0), torch.from_numpy(zeros), torch.from_numpy(ones),
        torch.zeros(B, dtype=torch.int32), all_greedy=True)
    assert tout[0].shape == (B, k)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    for t, j in zip(tout[1:3], jout[1:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module")
def pair(model):
    return _pair(model)


def _stop_case(pair):
    """A stop id the plain run emits mid-stream (learned from JAX)."""
    je, _ = pair
    prompt = _prompts(2, [7])[0]
    [(toks, _)] = _run(je, [prompt], [SamplingParams(max_tokens=20)], jengine.SamplingParams)
    return [prompt], [SamplingParams(max_tokens=20, stop_token_ids=(toks[len(toks) // 2],))]


CASES = {
    "length": lambda pair: (_prompts(3, [6]), [SamplingParams(max_tokens=13)]),
    "batch": lambda pair: (_prompts(4, [5, 17]),
                           [SamplingParams(max_tokens=9), SamplingParams(max_tokens=15)]),
    "stop": _stop_case,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_generate_matches_jax(pair, case):
    je, te = pair
    prompts, sps = CASES[case](pair)
    want = _run(je, prompts, sps, jengine.SamplingParams)
    got = _run(te, prompts, sps, SamplingParams)
    assert got == want
    if case == "stop":
        assert want[0][1] == "stop"


def test_window_tail_matches_jax(model):
    """Near max_seq_len both fill the window to the brim with k=1 tail steps
    and finish with 'length' (tests/test_speculative.py's window case)."""
    je, te = _pair(model, max_seq_len=40)
    prompts, sps = [[3] * 20, _prompts(5, [33])[0]], [SamplingParams(max_tokens=500)] * 2
    want = _run(je, prompts, sps, jengine.SamplingParams)
    got = _run(te, prompts, sps, SamplingParams)
    assert got == want
    # prefill emits one token without a decode slot; 7 slots remain past the
    # longer prompt, so both rows end at 8 tokens with 'length'
    assert [len(t) for t, _ in got] == [8, 8] and {f for _, f in got} == {"length"}


def test_token_less_epilogue_matches_jax(pair):
    """A row still open when no decode step fits the window ends with one
    token-less 'length' event (-1). No request reaches this on its own: the
    window is shrunk under both engines after the prefill's events."""
    prompts = _prompts(6, [10, 4])
    events = {}
    for name, engine, sp_cls in (("jax", pair[0], jengine.SamplingParams),
                                 ("port", pair[1], SamplingParams)):
        config = engine.config
        stream = engine.generate_stream(prompts, [sp_cls(max_tokens=30)] * 2)
        got = [next(stream), next(stream)]
        engine.config = dataclasses.replace(config, max_seq_len=10)
        try:
            got += list(stream)
        finally:
            engine.config = config
        events[name] = [(e.request_index, e.token_id, e.finished) for e in got]
    assert events["port"] == events["jax"]
    assert events["port"][2:] == [(0, -1, "length"), (1, -1, "length")]


def test_batch_and_window_errors_match_jax(pair):
    je, te = pair
    for engine, sp_cls in ((je, jengine.SamplingParams), (te, SamplingParams)):
        with pytest.raises(ValueError, match="exceeds max_batch"):
            list(engine.generate_stream([[1]] * 3, sp_cls()))
        with pytest.raises(ValueError, match="leaves no decode room"):
            list(engine.generate_stream([[1] * 128], sp_cls()))
    assert EngineConfig(**BASE).bucket_for(17) == \
        jengine.EngineConfig(**BASE).bucket_for(17) == 32


def test_flash_prefill_matches_jax_interpret(model):
    """use_flash on the CPU: the port's plain flash version against the JAX
    kernel in interpret mode, a padded batch."""
    je, te = _pair(model, use_flash=True)
    prompts, sps = _prompts(7, [9, 23]), [SamplingParams(max_tokens=6)] * 2
    assert te.use_flash
    assert _run(te, prompts, sps, SamplingParams) == \
        _run(je, prompts, sps, jengine.SamplingParams)


def test_padded_bucket_gives_the_unpadded_first_token(model):
    """Flash lengths in a padded prefill are the bucket for every row (as in
    JAX); causality keeps each real row's attention to its own keys, so
    the first tokens (and their logits) equal each prompt prefilled alone
    at its exact length."""
    _, _, state = model
    prompts = _prompts(8, [5, 11, 16])
    padded = InferenceEngine(EngineConfig(**{**BASE, "use_flash": True, "max_batch": 3}),
                             params=state, device="cpu")
    first = [toks[0] for toks, _ in _run(padded, prompts, [SamplingParams(max_tokens=1)] * 3,
                                         SamplingParams)]
    for p, want in zip(prompts, first):
        exact = InferenceEngine(EngineConfig(**{**BASE, "use_flash": True,
                                                "prefill_buckets": (len(p), 128)}),
                                params=state, device="cpu")
        [(toks, _)] = _run(exact, [p], [SamplingParams(max_tokens=1)], SamplingParams)
        assert toks[0] == want


def test_int8_lockstep_matches_jax_int8(model):
    """The JAX package's int8 tree through both engines (tests/test_quant.py's
    quantized engine)."""
    from cyberfabric_core_tpu.runtime.quant import quantize_llama_params as jquantize

    jcfg, jparams, _ = model
    qtree = jquantize(jparams, bits=8)
    cfg = {**BASE, "quantization": "int8"}
    je = jengine.InferenceEngine(jengine.EngineConfig(**cfg), params=qtree, seed=0)
    te = InferenceEngine(EngineConfig(**cfg), params=params_from_jax(
        jax.tree.map(np.asarray, qtree), get_config("tiny-llama")), device="cpu")
    assert te.params.layers[0].wq.q.dtype == torch.int8
    prompts, sps = _prompts(9, [3, 12]), [SamplingParams(max_tokens=8)] * 2
    assert _run(te, prompts, sps, SamplingParams) == \
        _run(je, prompts, sps, jengine.SamplingParams)


def test_dense_continuous_engine_equals_lockstep_at_greedy(model):
    """The port's dense ContinuousBatchingEngine and its InferenceEngine on
    one tree give the same greedy tokens (tests/test_scheduler.py:17-24)."""
    import threading

    _, _, state = model
    cfg = EngineConfig(**{**BASE, "max_batch": 3, "max_seq_len": 96})
    sched = ContinuousBatchingEngine(cfg, params=state, device="cpu")
    ref = InferenceEngine(cfg, params=state, device="cpu")
    try:
        for prompt in _prompts(10, [4, 13]):
            toks, done = [], threading.Event()

            def emit(ev, toks=toks, done=done):
                if ev.token_id >= 0:
                    toks.append(ev.token_id)
                if ev.finished:
                    done.set()

            sched.submit(prompt, SamplingParams(max_tokens=10), emit)
            assert done.wait(60)
            [(want, _)] = _run(ref, [prompt], [SamplingParams(max_tokens=10)],
                               SamplingParams)
            assert toks == want
    finally:
        sched.shutdown()


def _warp_rows():
    rng = np.random.default_rng(11)
    logits = rng.normal(0, 3, (5, 64)).astype(np.float32)
    logits[4, 7] = logits[4, 9] = logits[4].max() + 1.0  # a tie: the first wins
    temperature = np.asarray([0.0, 0.7, 1.3, 0.9, 0.0], np.float32)
    top_p = np.asarray([1.0, 0.9, 1.0, 0.6, 1.0], np.float32)
    top_k = np.asarray([0, 0, 5, 3, 0], np.int32)
    return logits, temperature, top_p, top_k


def test_warped_probs_match_jax():
    logits, temperature, top_p, top_k = _warp_rows()
    want = np.asarray(jsampling.warped_probs(jnp.asarray(logits), jnp.asarray(temperature),
                                             jnp.asarray(top_p), jnp.asarray(top_k)))
    got = sampling.warped_probs(torch.from_numpy(logits), torch.from_numpy(temperature),
                                torch.from_numpy(top_p), torch.from_numpy(top_k)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[4, 7] == 1.0 and (got[:, :].sum(axis=1) - 1.0 < 1e-6).all()
    assert (got[2] > 0).sum() == 5 and (got[3] > 0).sum() <= 3


def test_sampled_draws_follow_warped_probs():
    """``sample_token`` at temperature > 0 with top-p and top-k: 6000 draws
    of one row from a seeded generator against ``warped_probs``
    (chi-square over the kept tokens, far below p = 0.001's bound), and no
    draw outside the warp's support."""
    logits, temperature, top_p, top_k = (torch.from_numpy(a[3:4]) for a in _warp_rows())
    probs = sampling.warped_probs(logits, temperature, top_p, top_k)[0]
    n = 6000
    g = torch.Generator().manual_seed(3)
    draws = sampling.sample_token(logits.expand(n, -1), g, temperature.expand(n),
                                  top_p.expand(n), top_k.expand(n))
    counts = torch.bincount(draws.long(), minlength=probs.numel()).double()
    support = probs > 0
    assert counts[~support].sum() == 0
    expect = probs[support].double() * n
    stat = float(((counts[support] - expect) ** 2 / expect).sum())
    assert stat < 16.3, (stat, counts[support].tolist(), expect.tolist())  # dof ≤ 2
    # categorical on the same rows draws the same law
    cat = sampling.categorical(probs.expand(n, -1), torch.Generator().manual_seed(4))
    ccounts = torch.bincount(cat.long(), minlength=probs.numel()).double()
    assert ccounts[~support].sum() == 0
    assert float(((ccounts[support] - expect) ** 2 / expect).sum()) < 16.3


def test_without_a_card_the_default_device_raises():
    """Entry points run on the card unless asked for the CPU: the engine
    and the draft model raise at build without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from cyberfabric_core_tpu_torch.runtime.speculative import DraftModel

    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(EngineConfig(**BASE))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DraftModel(get_config("tiny-llama"), None, max_seq=32)
