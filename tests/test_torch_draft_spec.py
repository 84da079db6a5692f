"""The port's lockstep speculation (prompt lookup and a draft model) against
the JAX package's ``runtime/speculative.py`` and its engine, on the CPU.

tiny-llama (and tiny-llama-8l as a bigger target for a tiny-llama draft)
in f32, weights from the JAX package's ``init_params`` carried by
``params_from_jax``. Units: ``span_verify_logits`` / ``build_verify_fn``
within TOL of JAX's with equal argmax, ``build_verify_accept_fn`` at
temperature 0 giving JAX's (accepted, next) for given drafts,
``DraftModel.propose`` at temperature 0 giving JAX's drafts and rows. The
engine, as ``tests/test_speculative.py`` holds JAX's: greedy streams with
speculation on equal the JAX engine's plain ones (ngram and a perfect
draft), a random draft stays lossless, a bad draft config raises, a seeded
sampled draft run repeats itself, and a perturbed draft leaves the target's
sampled marginal in place (two-sample chi-square). The draft's cache is
checked after partial and full acceptance."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu.runtime import engine as jengine
from cyberfabric_core_tpu.runtime import speculative as jspec
from cyberfabric_core_tpu_torch.models import llama as tllama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime import speculative as tspec
from cyberfabric_core_tpu_torch.runtime.engine import (EngineConfig, InferenceEngine,
                                                       SamplingParams)
from cyberfabric_core_tpu_torch.runtime.weights import (model_from_state_dict,
                                                        params_from_jax, save_llama_params)

TOL = dict(rtol=1e-4, atol=1e-4)
BASE = dict(model="tiny-llama", max_seq_len=128, max_batch=2, decode_chunk=4,
            use_flash=False, dtype="float32", spec_k=6)
K = 4


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config("tiny-llama")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    cfg = get_config("tiny-llama")
    state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    return jcfg, jparams, cfg, state, model_from_state_dict(state, cfg, device="cpu")


@pytest.fixture(scope="module")
def draft_ckpt(model, tmp_path_factory):
    """The target's own weights as a checkpoint: a perfect draft."""
    out = tmp_path_factory.mktemp("draft")
    save_llama_params(model[3], model[2], out)
    return str(out)


@pytest.fixture(scope="module")
def cross_ckpt(model, tmp_path_factory):
    """A perturbed target (each leaf + 0.03·std·noise from a seeded
    generator): correlated but different, so drafts are rejected at every
    length."""
    g = torch.Generator().manual_seed(4242)
    state = {k: v + 0.03 * v.std() * torch.randn(v.shape, generator=g)
             for k, v in model[3].items()}
    out = tmp_path_factory.mktemp("cross-draft")
    save_llama_params(state, model[2], out)
    return str(out)


def _engine(model, speculative="off", **kw):
    return InferenceEngine(EngineConfig(**{**BASE, "speculative": speculative, **kw}),
                           params=model[3], seed=0, device="cpu")


def _tokens(engine, prompt, **kw):
    [res] = engine.generate([prompt], SamplingParams(**kw))
    return res.token_ids, res.finish_reason


@pytest.fixture(scope="module")
def jax_plain(model):
    """The JAX engine's plain greedy continuation (speculation off)."""
    eng = jengine.InferenceEngine(jengine.EngineConfig(**{**BASE, "speculative": "off"}),
                                  params=model[1], seed=0)

    def run(prompt, **kw):
        [res] = eng.generate([prompt], jengine.SamplingParams(**kw))
        return res.token_ids, res.finish_reason

    return run


def _prefilled(model, prompt, S=64):
    """Both packages' caches after a prefill of ``prompt``, and the ropes."""
    jcfg, jparams, cfg, _, tparams = model
    T = len(prompt)
    ids, pos = np.asarray([prompt], np.int32), np.arange(T, dtype=np.int32)[None]
    jrt, trt = jrope(16, 256, 10000.0), rope_frequencies(16, 256, 10000.0, device="cpu")
    _, jcache = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                               jllama.init_cache(jcfg, 1, S, jnp.float32),
                               jnp.zeros(1, jnp.int32), jrt)
    return jcache, tuple(torch.from_numpy(np.array(c)) for c in jcache), jrt, trt


def test_span_verify_logits_and_verify_fn_match_jax(model):
    jcfg, jparams, cfg, _, tparams = model
    prompt = [5, 9, 2, 44, 7, 7, 13]
    jcache, tcache, jrt, trt = _prefilled(model, prompt)
    tokens = np.asarray([[3, 17, 99, 4, 250]], np.int32)
    L = np.asarray([len(prompt)], np.int32)
    jlog, _ = jspec.span_verify_logits(jparams, jcfg, jcache, jnp.asarray(tokens),
                                       jnp.asarray(L), jrt)
    tlog, _ = tspec.span_verify_logits(tparams, cfg, tuple(c.clone() for c in tcache),
                                       torch.from_numpy(tokens), torch.from_numpy(L), trt)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    jout = jspec.build_verify_fn(jcfg, 4, jrt)(jparams, jcache[0], jcache[1],
                                               jnp.asarray(tokens), jnp.asarray(L))
    tout = tspec.build_verify_fn(cfg, 4, trt)(tparams, tcache[0], tcache[1],
                                              torch.from_numpy(tokens), torch.from_numpy(L))
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    for t, j in zip(tout[1:], jout[1:]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.fixture(scope="module")
def jax_accept(model):
    return jspec.build_verify_accept_fn(model[0], K, jrope(16, 256, 10000.0))


@pytest.mark.parametrize("matching", [K, 2, 0])
def test_verify_accept_at_temperature_zero_matches_jax(model, jax_plain, jax_accept,
                                                        matching):
    """Drafts whose first ``matching`` tokens are the greedy continuation:
    the same (accepted count, next token) as JAX's, with one-hot draft rows
    (what a temperature-0 draft gives)."""
    jcfg, jparams, cfg, _, tparams = model
    prompt = [8, 1, 30, 30, 6]
    L = np.asarray([len(prompt)], np.int32)
    jcache, tcache, jrt, trt = _prefilled(model, prompt)
    last = 3
    greedy, _ = jax_plain(prompt + [last], max_tokens=K)
    drafts = greedy[:matching] + [(t + 1) % 512 for t in greedy[matching:]]
    dists = np.eye(512, dtype=np.float32)[drafts]
    tokens = np.asarray([[last] + drafts], np.int32)
    zero, one, k0 = np.zeros(1, np.float32), np.ones(1, np.float32), np.zeros(1, np.int32)
    ja, jn, *_ = jax_accept(
        jparams, jcache[0], jcache[1], jnp.asarray(tokens), jnp.asarray(L),
        jnp.asarray(dists), jax.random.PRNGKey(0), jnp.asarray(zero), jnp.asarray(one),
        jnp.asarray(k0))
    ta, tn, *_ = tspec.build_verify_accept_fn(cfg, K, trt)(
        tparams, tcache[0], tcache[1], torch.from_numpy(tokens), torch.from_numpy(L),
        torch.from_numpy(dists), torch.Generator().manual_seed(0), torch.from_numpy(zero),
        torch.from_numpy(one), torch.from_numpy(k0))
    assert (int(ta), int(tn)) == (int(ja), int(jn))
    assert int(ta) == matching


@pytest.mark.parametrize("use_flash", [False, True], ids=["plain", "flash"])
def test_draft_propose_at_temperature_zero_matches_jax(model, use_flash):
    """With ``use_flash`` (what the engine passes on the card) the draft's
    prefill attends through flash where JAX's draft attends plainly
    (ROADMAP departure 7): the same drafts, rows and KV within TOL."""
    jcfg, jparams, cfg, _, tparams = model
    prompt = [40, 41, 42, 43, 44, 45]
    jd = jspec.DraftModel(jcfg, jparams, max_seq=64, dtype=jnp.float32, k=K)
    jd.reset(prompt, jax.random.PRNGKey(1))
    td = tspec.DraftModel(cfg, tparams, max_seq=64, dtype=torch.float32, k=K, device="cpu",
                          use_flash=use_flash)
    td.reset(prompt, 1)
    z, o, k0 = np.zeros(1, np.float32), np.ones(1, np.float32), np.zeros(1, np.int32)
    jdrafts, jdists = jd.propose(7, jnp.asarray(z), jnp.asarray(o), jnp.asarray(k0))
    tdrafts, tdists = td.propose(7, torch.from_numpy(z), torch.from_numpy(o),
                                 torch.from_numpy(k0))
    assert tdrafts.tolist() == jdrafts
    np.testing.assert_allclose(tdists.numpy(), np.stack([np.asarray(d) for d in jdists]),
                               **TOL)
    assert td.len == jd.len == len(prompt)
    # the drafted positions' KV (last token and the first k-1 drafts)
    n = len(prompt) + K
    for t, j in zip(td.cache, jd.cache):
        np.testing.assert_allclose(t[:, :, :n].numpy(), np.asarray(j)[:, :, :n], **TOL)


NGRAM_PROMPTS = [[5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6], list(range(40, 72)),
                 [11, 3, 11, 3, 250, 11, 3, 11]]


@pytest.mark.parametrize("prompt", NGRAM_PROMPTS, ids=["repetitive", "no-repeats", "mixed"])
def test_ngram_greedy_equals_the_jax_plain_stream(model, jax_plain, prompt):
    spec = _engine(model, "ngram")
    assert _tokens(spec, prompt, max_tokens=48) == jax_plain(prompt, max_tokens=48)
    assert spec.spec_stats["verify_calls"] + spec.spec_stats["fallback_steps"] > 0


def test_ngram_accepts_on_looping_output_and_stops_and_falls_back(model):
    """Random-weight greedy output cycles, and prompt lookup then accepts
    (fewer device calls than tokens); a stop id and the window's end finish
    as plain decode does; a sampled or batched request does not speculate."""
    spec = _engine(model, "ngram")
    toks, _ = _tokens(spec, [9, 9, 9, 9], max_tokens=96)
    s = spec.spec_stats
    assert len(toks) == 96 and s["accepted"] > 0
    assert s["verify_calls"] + s["fallback_steps"] < 96
    base, _ = _tokens(_engine(model), [5, 6, 7, 5, 6], max_tokens=40)
    stop = base[len(base) // 2]
    assert _tokens(_engine(model, "ngram"), [5, 6, 7, 5, 6], max_tokens=40,
                   stop_token_ids=(stop,)) == \
        _tokens(_engine(model), [5, 6, 7, 5, 6], max_tokens=40, stop_token_ids=(stop,))
    window = [_tokens(_engine(model, spec_mode, max_seq_len=40), [3] * 20, max_tokens=500)
              for spec_mode in ("off", "ngram")]
    assert window[0] == window[1] and window[0][1] == "length" and len(window[0][0]) == 21
    fallback = _engine(model, "ngram")
    fallback.generate([[5, 6, 7]], SamplingParams(temperature=0.8, max_tokens=8, seed=1))
    fallback.generate([[5, 6, 7], [8, 9]], SamplingParams(max_tokens=6))
    assert fallback.spec_stats["verify_calls"] == 0


def test_int8_ngram_parity(model):
    base = _tokens(_engine(model, quantization="int8"), [5, 6, 7, 5, 6, 7, 5], max_tokens=32)
    assert _tokens(_engine(model, "ngram", quantization="int8"), [5, 6, 7, 5, 6, 7, 5],
                   max_tokens=32) == base


@pytest.mark.parametrize("prompt", [list(range(40, 72)), [5, 6, 7, 5, 6, 7, 5, 6, 7, 5, 6]],
                         ids=["no-repeats", "repetitive"])
def test_draft_greedy_equals_the_jax_plain_stream(model, jax_plain, draft_ckpt, prompt):
    spec = _engine(model, "draft", draft_model="tiny-llama", draft_checkpoint=draft_ckpt)
    assert _tokens(spec, prompt, max_tokens=48) == jax_plain(prompt, max_tokens=48)
    s = spec.spec_stats
    assert s["verify_calls"] > 0 and s["spec_tokens"] / s["verify_calls"] > 1.5


class _Watch:
    """Before each ``propose``: the draft's committed length and cache, and
    the tokens emitted so far."""

    def __init__(self, engine):
        self.emitted: list[int] = []
        self.snapshots: list[tuple[int, int, tuple]] = []
        self.engine = engine

    def wrap(self):
        draft = self.engine._draft
        propose = draft.propose

        def watched(*a, **kw):
            self.snapshots.append((draft.len, len(self.emitted),
                                   tuple(c.clone() for c in draft.cache)))
            return propose(*a, **kw)

        draft.propose = watched


@pytest.mark.parametrize("which", ["full", "partial"])
def test_draft_cache_after_partial_and_full_acceptance(model, draft_ckpt, cross_ckpt, which):
    """Before every round the draft's cache holds exactly the committed
    sequence but the pending last token (prompt + emitted[:-1]): its length
    and its KV (against a fresh forward of that sequence, within TOL). With
    the perfect draft every round accepts all k (the last draft consumed
    after), with the perturbed one rounds stop early."""
    ckpt = draft_ckpt if which == "full" else cross_ckpt
    eng = _engine(model, "draft", draft_model="tiny-llama", draft_checkpoint=ckpt, spec_k=K)
    eng._ensure_draft(K)
    watch = _Watch(eng)
    watch.wrap()
    prompt = list(range(60, 75))
    eng.generate([prompt], SamplingParams(max_tokens=40),
                 on_token=lambda ev: ev.token_id >= 0 and watch.emitted.append(ev.token_id))
    hist = eng.spec_stats["accept_hist"]
    if which == "full":
        assert set(hist) == {K}
    else:
        assert any(a < K for a in hist) and eng.spec_stats["accepted"] > 0
    draft, cfg = eng._draft, get_config("tiny-llama")
    assert len(watch.snapshots) == eng.spec_stats["verify_calls"] >= 3
    for dlen, n_emitted, cache in watch.snapshots:
        seq = prompt + watch.emitted[:n_emitted - 1]
        assert dlen == len(seq)
        ids = torch.tensor([seq], dtype=torch.int32)
        ref = tllama.init_cache(cfg, 1, len(seq), torch.float32, device="cpu")
        tllama.forward(draft.params, cfg, ids, torch.arange(len(seq), dtype=torch.int32)[None],
                       ref, torch.zeros(1, dtype=torch.int32), draft.rope)
        for got, want in zip(cache, ref):
            np.testing.assert_allclose(got[:, :, :len(seq)].numpy(), want.numpy(), **TOL)


def test_random_draft_stays_lossless_for_a_bigger_target():
    """tiny-llama-8l served with a synthetic tiny-llama draft (a shared
    vocabulary, nothing else): acceptance ~0, the output the plain one."""
    kw = dict(model="tiny-llama-8l", draft_model="tiny-llama", draft_checkpoint="")
    prompt = list(range(60, 80))
    plain = InferenceEngine(EngineConfig(**{**BASE, **kw}), seed=3, device="cpu")
    spec = InferenceEngine(EngineConfig(**{**BASE, **kw, "speculative": "draft"}),
                           params=plain.params, seed=3, device="cpu")
    assert _tokens(spec, prompt, max_tokens=24) == _tokens(plain, prompt, max_tokens=24)
    assert spec.spec_stats["verify_calls"] > 0


def test_bad_draft_configs_raise(model, tmp_path):
    with pytest.raises(ValueError, match="vocab"):
        _tokens(_engine(model, "draft", draft_model="tiny-bert"), [1, 2, 3], max_tokens=4)
    with pytest.raises(ValueError, match="does not exist"):
        _tokens(_engine(model, "draft", draft_model="tiny-llama",
                        draft_checkpoint=str(tmp_path / "missing")), [1, 2, 3], max_tokens=4)


def test_draft_sampled_is_reproducible_and_accepts(model, draft_ckpt):
    prompt = list(range(10, 30))

    def run(seed):
        eng = _engine(model, "draft", draft_model="tiny-llama", draft_checkpoint=draft_ckpt)
        toks, _ = _tokens(eng, prompt, temperature=0.8, top_p=0.95, seed=seed, max_tokens=24)
        return toks, eng.spec_stats

    toks1, stats1 = run(123)
    toks2, _ = run(123)
    toks3, _ = run(321)
    assert toks1 == toks2 and len(toks1) == 24
    assert toks1 != toks3 or len(set(toks1)) == 1
    assert stats1["accepted"] > 0


def test_cross_model_draft_preserves_the_sampling_distribution(model, cross_ckpt):
    """Acceptance sampling with a perturbed draft (real rejections) leaves the
    target's second-token marginal as plain decode draws it: two-sample
    chi-square over 220 seeds (tests/test_speculative.py's bound)."""
    prompt, N = list(range(20, 36)), 220
    kw = dict(temperature=0.7, top_k=4, max_tokens=2)

    def marginal(engine):
        counts: dict[int, int] = {}
        for seed in range(N):
            tok = _tokens(engine, prompt, seed=seed, **kw)[0][1]
            counts[tok] = counts.get(tok, 0) + 1
        return counts

    plain = marginal(_engine(model))
    spec = _engine(model, "draft", draft_model="tiny-llama", draft_checkpoint=cross_ckpt)
    drafted = marginal(spec)
    s = spec.spec_stats
    assert s["verify_calls"] > 0 and 0 < s["accepted"] < s["drafted"], s
    assert sum(s["accept_hist"].values()) == s["verify_calls"]
    stat = 0.0
    for t in set(plain) | set(drafted):
        a, b = plain.get(t, 0), drafted.get(t, 0)
        exp = (a + b) / 2.0
        stat += (a - exp) ** 2 / exp + (b - exp) ** 2 / exp
    assert stat < 40.0, (stat, plain, drafted)
