"""The port's llama forwards against the JAX package's, on tiny-llama in f32.

Weights come from the JAX package's ``init_params`` and cross through numpy
(``params_from_jax``); token ids are made with numpy from a seed. The JAX
paged forwards run their Pallas kernels in interpret mode. Tolerance:
rtol = atol = 1e-4 on hidden states and logits (the repo's golden bar,
tests/test_golden_parity.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu_torch.models import llama as tllama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime.weights import (model_from_state_dict,
                                                        params_from_jax)

TOL = dict(rtol=1e-4, atol=1e-4)
PAGE, PMAX, B = 8, 4, 3


@pytest.fixture(scope="module")
def models():
    jcfg = jget_config("tiny-llama")
    cfg = get_config("tiny-llama")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = model_from_state_dict(params_from_jax(tree, cfg), cfg, device="cpu")
    return jcfg, jparams, tree, cfg, tparams


def test_params_from_jax_round_trip(models):
    _, _, tree, cfg, tparams = models
    sd = tparams.state_dict()
    np.testing.assert_array_equal(sd["embed"].numpy(), tree["embed"])
    np.testing.assert_array_equal(sd["lm_head"].numpy(), tree["lm_head"])
    for name, stacked in tree["layers"].items():
        for i in range(cfg.num_layers):
            np.testing.assert_array_equal(sd[f"layers.{i}.{name}"].numpy(), stacked[i])
    n_leaves = sum(1 for _ in jax.tree_util.tree_leaves(tree))
    assert len(sd) == 3 + (n_leaves - 3) * cfg.num_layers


def test_dense_forward_matches_jax(models):
    jcfg, jparams, _, cfg, tparams = models
    ids = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 9)).astype(np.int32)
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9)).copy()
    jh, _ = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                           jllama.init_cache(jcfg, 2, 16, jnp.float32),
                           jnp.zeros(2, jnp.int32), jrope(16, 256, 10000.0))
    th, _ = tllama.forward(tparams, cfg, torch.from_numpy(ids), torch.from_numpy(pos),
                           tllama.init_cache(cfg, 2, 16, torch.float32, device="cpu"),
                           torch.zeros(2, dtype=torch.int32),
                           rope_frequencies(16, 256, 10000.0, device="cpu"))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    np.testing.assert_allclose(
        tllama.lm_head_logits(tparams, cfg, th[:, -1]).numpy(),
        np.asarray(jllama.lm_head_logits(jparams, jcfg, jh[:, -1])), **TOL)


def test_paged_forwards_match_jax_over_steps(models):
    """Two ragged mixed rounds (prompt chunks crossing pages, an idle row,
    a decode row) then a pure-decode step with one row frozen by
    write_mask: hidden states, logits and both pools agree."""
    jcfg, jparams, _, cfg, tparams = models
    rng = np.random.default_rng(2)
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    N = B * PMAX + 1
    pt = (rng.permutation(N - 1)[: B * PMAX] + 1).reshape(B, PMAX).astype(np.int32)
    jpools = (jnp.zeros((L, N, PAGE, Hkv, D), jnp.float32),) * 2
    tpools = (torch.zeros((L, N, PAGE, Hkv, D)), torch.zeros((L, N, PAGE, Hkv, D)))
    jrt, trt = jrope(D, 256, 10000.0), rope_frequencies(D, 256, 10000.0, device="cpu")
    tpt = torch.from_numpy(pt)

    rounds = [([0, 0, 0], [5, 12, 0]), ([5, 12, 0], [1, 7, 3])]
    for hist, q_lens in rounds:
        hist, q_lens = np.asarray(hist, np.int32), np.asarray(q_lens, np.int32)
        ids = rng.integers(0, cfg.vocab_size, (B, 16)).astype(np.int32)
        jh, jpools = jllama.forward_paged_mixed(
            jparams, jcfg, jnp.asarray(ids), jpools, jnp.asarray(pt),
            jnp.asarray(hist), jnp.asarray(q_lens), jrt, interpret=True)
        th, tpools = tllama.forward_paged_mixed(
            tparams, cfg, torch.from_numpy(ids), tpools, tpt,
            torch.from_numpy(hist), torch.from_numpy(q_lens), trt)
        for b in range(B):
            np.testing.assert_allclose(th[b, :q_lens[b]].numpy(),
                                       np.asarray(jh[b, :q_lens[b]]), **TOL)
        jlast = jllama.gather_last_hidden(jh, jnp.asarray(q_lens))
        tlast = tllama.gather_last_hidden(th, torch.from_numpy(q_lens))
        np.testing.assert_allclose(
            tllama.lm_head_logits(tparams, cfg, tlast).numpy(),
            np.asarray(jllama.lm_head_logits(jparams, jcfg, jlast)), **TOL)

    lengths = np.asarray([6, 19, 3], np.int32)
    mask = np.asarray([True, True, False])
    ids = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
    jh, jpools = jllama.forward_paged_decode(
        jparams, jcfg, jnp.asarray(ids), jpools, jnp.asarray(pt),
        jnp.asarray(lengths), jrt, interpret=True, write_mask=jnp.asarray(mask))
    th, tpools = tllama.forward_paged_decode(
        tparams, cfg, torch.from_numpy(ids), tpools, tpt, torch.from_numpy(lengths),
        trt, write_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(th[mask].numpy(), np.asarray(jh)[mask], **TOL)
    # every real page agrees (page 0 is scratch: its contents are garbage)
    for tp, jp in zip(tpools, jpools):
        np.testing.assert_allclose(tp[:, 1:].numpy(), np.asarray(jp)[:, 1:], **TOL)


@pytest.mark.parametrize("use_flash", [False, True])
def test_prefill_collect_matches_jax(models, use_flash):
    """Both packages' prefill_collect (the JAX one through its Pallas flash
    kernel in interpret mode when ``use_flash``): last hidden state at each
    row's length and the whole collected KV [L, B, T, Hkv, D]."""
    jcfg, jparams, _, cfg, tparams = models
    T = 24
    ids = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, T)).astype(np.int32)
    lengths = np.asarray([T, 11], np.int32)
    jh, jkv = jllama.prefill_collect(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths),
                                     jrope(16, 256, 10000.0), use_flash=use_flash)
    th, tkv = tllama.prefill_collect(tparams, cfg, torch.from_numpy(ids),
                                     torch.from_numpy(lengths),
                                     rope_frequencies(16, 256, 10000.0, device="cpu"),
                                     use_flash=use_flash)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    for t, j in zip(tkv, jkv):
        assert t.shape == (cfg.num_layers, 2, T, cfg.num_kv_heads, cfg.head_dim)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_insert_slot_kv_matches_jax(models):
    _, _, _, cfg, _ = models
    rng = np.random.default_rng(6)
    L, Hkv, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
    cache = [rng.standard_normal((L, 3, 32, Hkv, D)).astype(np.float32) for _ in range(2)]
    new = [rng.standard_normal((L, 1, 16, Hkv, D)).astype(np.float32) for _ in range(2)]
    want = jllama.insert_slot_kv(tuple(map(jnp.asarray, cache)), tuple(map(jnp.asarray, new)),
                                 jnp.asarray(1, jnp.int32))
    tcache = tuple(torch.from_numpy(c.copy()) for c in cache)
    got = tllama.insert_slot_kv(tcache, tuple(map(torch.from_numpy, new)), 1)
    assert got[0] is tcache[0]  # in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_decode_chunk_fn_matches_jax(models):
    """The fused dense decode body with device termination over 4 greedy
    steps from a prefilled cache: tokens, cache, lengths and the finished
    mask; row 2 is inactive and row 1 stops on its second token. Then the
    plain form (no device termination) over 2 steps from the same cache:
    tokens, last tokens and cache."""
    import jax

    from cyberfabric_core_tpu.runtime.engine import build_decode_chunk_fn as jbuild
    from cyberfabric_core_tpu_torch.runtime.engine import build_decode_chunk_fn

    jcfg, jparams, _, cfg, tparams = models
    B, S, k = 3, 32, 4
    rng = np.random.default_rng(7)
    ids = rng.integers(0, cfg.vocab_size, (B, 8)).astype(np.int32)
    lengths = np.asarray([8, 5, 0], np.int32)
    jrt, trt = jrope(16, 256, 10000.0), rope_frequencies(16, 256, 10000.0, device="cpu")
    pos = np.broadcast_to(np.arange(8, dtype=np.int32), (B, 8)).copy()
    _, jcache = jllama.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(pos),
                               jllama.init_cache(jcfg, B, S, jnp.float32),
                               jnp.zeros(B, jnp.int32), jrt)
    tcache = tuple(torch.from_numpy(np.array(c)) for c in jcache)
    last = np.asarray([3, 9, 0], np.int32)
    zeros, ones = np.zeros(B, np.float32), np.ones(B, np.float32)
    jargs = [jparams, jcache[0], jcache[1], jnp.asarray(last), jnp.asarray(lengths),
             jax.random.PRNGKey(0), jnp.asarray(zeros), jnp.asarray(ones),
             jnp.zeros(B, jnp.int32)]
    targs = [tparams, tcache[0], tcache[1], torch.from_numpy(last),
             torch.from_numpy(lengths), torch.Generator().manual_seed(0),
             torch.from_numpy(zeros), torch.from_numpy(ones),
             torch.zeros(B, dtype=torch.int32)]
    probe = np.asarray(jbuild(jcfg, 2, jrt)(*jargs)[0])
    active = np.asarray([True, True, False])
    stops = np.full((B, 2), -1, np.int32)
    stops[1, 0] = probe[1, 1]
    limits = np.asarray([100, 100, 0], np.int32)
    extra = [active, np.zeros(B, bool), stops, limits]
    jargs += [jnp.asarray(a) for a in extra]
    targs += [torch.from_numpy(a) for a in extra]
    jout = jbuild(jcfg, k, jrt, max_seq=S, device_term=True)(*jargs)
    tout = build_decode_chunk_fn(cfg, k, trt, max_seq=S, device_term=True)(*targs)
    np.testing.assert_array_equal(tout[0].numpy(), np.asarray(jout[0]))
    np.testing.assert_array_equal(tout[3].numpy(), np.asarray(jout[3]))
    for t, j in zip(tout[1:3], jout[1:3]):
        np.testing.assert_allclose(t.numpy()[:, :2], np.asarray(j)[:, :2], **TOL)
    np.testing.assert_array_equal(tout[5].numpy(), np.asarray(jout[5]))
    np.testing.assert_array_equal(tout[6].numpy(), np.asarray(jout[6]))
    assert tout[0][1, 1] == probe[1, 1] and (tout[0][1, 2:] == -1).all()
    # the plain form (the lockstep engine's) over a fresh copy of the cache
    jplain = jbuild(jcfg, 2, jrt)(*jargs[:9])
    fresh = tuple(torch.from_numpy(np.array(c)) for c in jcache)
    tplain = build_decode_chunk_fn(cfg, 2, trt)(tparams, *fresh, *targs[3:9])
    np.testing.assert_array_equal(tplain[0].numpy(), probe)
    np.testing.assert_array_equal(tplain[3].numpy(), np.asarray(jplain[3]))
    for t, j in zip(tplain[1:3], jplain[1:3]):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)
