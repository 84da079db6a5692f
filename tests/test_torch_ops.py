"""The port's small ops against the JAX package's, with numpy inputs from a seed.

Tolerances: rtol = atol = 1e-5 on f32 outputs (the same formulas, summation
order may differ); the sampling warp mask and greedy argmax exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.ops import attention as jattn
from cyberfabric_core_tpu.ops import norms as jnorms
from cyberfabric_core_tpu.ops import rope as jrope
from cyberfabric_core_tpu.ops import sampling as jsampling
from cyberfabric_core_tpu_torch.ops import attention, norms, rope, sampling

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm_matches_jax(offset):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = rng.standard_normal(32).astype(np.float32)
    ref = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6, offset)
    out = norms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-6, offset)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_rope_tables_and_rotation_match_jax():
    jc, js = jrope.rope_frequencies(16, 64, 10000.0)
    tc, ts = rope.rope_frequencies(16, 64, 10000.0, device="cpu")
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 6, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 64, (2, 6)).astype(np.int32)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), jc, js)
    out = rope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), tc, ts)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("window", [None, 5])
def test_attention_with_cache_matches_jax(window):
    rng = np.random.default_rng(2)
    B, T, S, Hq, Hkv, D = 2, 4, 12, 4, 2, 8
    q = rng.standard_normal((B, T, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    pos = np.asarray([[3, 4, 5, 6], [7, 8, 9, 10]], np.int32)
    kv_len = np.asarray([7, 11], np.int32)
    ref = jattn.attention_with_cache(*map(jnp.asarray, (q, k, v, pos, kv_len)),
                                     sliding_window=window)
    out = attention.attention_with_cache(*map(torch.from_numpy, (q, k, v, pos, kv_len)),
                                         sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_warp_mask_matches_jax_exactly():
    """Well-separated logits (no near-ties at the top-p boundary): the kept
    set and the sort order agree exactly; kept values to rounding."""
    rng = np.random.default_rng(3)
    B, V = 4, 64
    logits = (rng.permutation(V * B).reshape(B, V) * 0.37 / V).astype(np.float32)
    temp = np.asarray([0.7, 1.0, 1.5, 0.0], np.float32)
    top_p = np.asarray([0.9, 1.0, 0.5, 1.0], np.float32)
    top_k = np.asarray([0, 10, 0, 3], np.int32)
    jm, jidx = jsampling._warp_sorted(*map(jnp.asarray, (logits, temp, top_p, top_k)))
    tm, tidx = sampling._warp_sorted(*map(torch.from_numpy, (logits, temp, top_p, top_k)))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(np.isfinite(tm.numpy()), np.isfinite(np.asarray(jm)))
    keep = np.isfinite(tm.numpy())
    np.testing.assert_allclose(tm.numpy()[keep], np.asarray(jm)[keep], **TOL)


def test_greedy_is_argmax_exactly():
    rng = np.random.default_rng(4)
    logits = rng.standard_normal((5, 100)).astype(np.float32)
    logits[2, [7, 40]] = 9.0  # a tie: both pick the first index
    zeros = torch.zeros(5)
    out = sampling.sample_token_per_slot(torch.from_numpy(logits), zeros, zeros,
                                         torch.ones(5), torch.zeros(5, dtype=torch.int32))
    want = np.asarray(jnp.argmax(jnp.asarray(logits), axis=-1))
    np.testing.assert_array_equal(out.numpy(), want)
    assert out[2] == 7


def test_seeded_slot_draws_do_not_depend_on_companions():
    """A slot's tokens depend only on its own stream: the same seed gives the
    same draws whether it samples alone or beside other sampling rows, and
    greedy companions never advance any stream."""
    rng = np.random.default_rng(5)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    temp = torch.tensor([0.8, 0.0, 1.2])
    top_p, top_k = torch.tensor([0.95, 1.0, 1.0]), torch.tensor([0, 0, 5])
    dev = torch.device("cpu")

    def draw(gens, rows, steps=4):
        toks = []
        for _ in range(steps):
            u = sampling.split_keys_per_slot(gens, [g is not None for g in gens], dev)
            toks.append(sampling.sample_token_per_slot(
                logits[rows], u, temp[rows], top_p[rows], top_k[rows]).tolist())
        return toks

    crowded = draw([sampling.make_slot_generator(7, dev), None,
                    sampling.make_slot_generator(99, dev)], [0, 1, 2])
    alone = draw([sampling.make_slot_generator(7, dev)], [0])
    assert [t[0] for t in crowded] == [t[0] for t in alone]
    assert all(t[1] == int(torch.argmax(logits[1])) for t in crowded)
    # the draw respects the warp: row 2 stays inside its top-5
    top5 = set(torch.topk(logits[2] / 1.2, 5).indices.tolist())
    assert all(t[2] in top5 for t in crowded)


def test_shared_stream_sample_token_draws_one_uniform_per_row():
    """Dense mode's ``sample_token``: greedy rows take the argmax (as JAX's
    ``sample_token``), and a sampling batch advances the one generator by
    one uniform per row — the same tokens as the per-slot sampler fed those
    uniforms."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((3, 50)).astype(np.float32))
    temp = torch.tensor([0.0, 0.7, 1.2])
    top_p, top_k = torch.tensor([1.0, 0.9, 1.0]), torch.tensor([0, 0, 10])
    want_greedy = np.asarray(jsampling.sample_token(
        jnp.asarray(logits.numpy()), jnp.zeros(2, jnp.uint32), jnp.zeros(3),
        jnp.ones(3), jnp.zeros(3, jnp.int32)))
    g = torch.Generator().manual_seed(11)
    greedy = sampling.sample_token(logits, g, torch.zeros(3), torch.ones(3),
                                   torch.zeros(3, dtype=torch.int32))
    np.testing.assert_array_equal(greedy.numpy(), want_greedy)
    assert torch.equal(g.get_state(), torch.Generator().manual_seed(11).get_state())
    got = sampling.sample_token(logits, g, temp, top_p, top_k)
    u = torch.rand(3, generator=torch.Generator().manual_seed(11))
    want = sampling.sample_token_per_slot(logits, u, temp, top_p, top_k)
    assert torch.equal(got, want) and got[0] == greedy[0]


@pytest.mark.parametrize("rows", [1, 3])
def test_cumsum_rows_is_torch_cumsum_on_the_cpu(rows):
    """The sampler's running sums: on the CPU the same bits as
    ``torch.cumsum`` (which sums each row in order), with one row or more;
    a one-row input gets its zero row back off."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.random((rows, 1000)).astype(np.float32))
    got = sampling.cumsum_rows(x)
    assert got.shape == x.shape
    assert torch.equal(got, torch.cumsum(x, dim=-1))


def test_a_seeded_one_row_draw_uses_cumsum_rows(monkeypatch):
    """Every CDF of the sampler goes through ``cumsum_rows`` (the warp's
    top-p mass, ``categorical`` and the per-slot draw), so a one-row draw is
    summed in a fixed order on the card too."""
    calls = []
    real = sampling.cumsum_rows
    monkeypatch.setattr(sampling, "cumsum_rows", lambda x: calls.append(x.shape) or real(x))
    logits = torch.from_numpy(np.random.default_rng(7).standard_normal((1, 40)).astype(np.float32))
    t, p, k = torch.tensor([0.8]), torch.tensor([0.9]), torch.tensor([0])
    probs = sampling.warped_probs(logits, t, p, k)
    sampling.categorical(probs, torch.Generator().manual_seed(1))
    sampling.sample_token(logits, torch.Generator().manual_seed(1), t, p, k)
    assert calls == [(1, 40)] * 4


@pytest.mark.cuda
def test_one_row_cdf_is_the_same_on_every_call():
    """On the card, 500 scans of one vocabulary-wide row of probabilities
    give the same bits (``torch.cumsum`` alone did not: a seeded draw could
    change between two runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    g = torch.Generator(device="cuda").manual_seed(0)
    probs = torch.softmax(torch.randn(1, 128256, generator=g, device="cuda") * 2.5, dim=-1)
    first = sampling.cumsum_rows(probs).clone()
    assert all(torch.equal(sampling.cumsum_rows(probs), first) for _ in range(500))
