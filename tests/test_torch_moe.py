"""The port's routed MoE MLP against its dense oracle and the JAX package.

Mirrors ``tests/test_moe.py``: with headroom the routed form equals the
dense oracle; at decode (N == batch) the ``min(N, 256)`` capacity floor keeps
routing exact even when every token picks the same expert; overflow drops
contributions without corrupting rows; and both forms equal the JAX
``_moe_mlp`` / ``_moe_mlp_dense`` on the same weights and inputs, also on
the drop path. A tiny-moe engine's greedy streams equal the JAX package's
greedy decode."""

import dataclasses
import threading

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
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import params_from_jax

TOL = dict(rtol=2e-5, atol=2e-5)


def _setup(capacity_factor=8.0):
    jcfg = dataclasses.replace(jget_config("tiny-moe"), moe_capacity_factor=capacity_factor)
    cfg = dataclasses.replace(get_config("tiny-moe"), moe_capacity_factor=capacity_factor)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    lp = tllama.LlamaLayer({k: torch.from_numpy(np.array(v)) for k, v in jlp.items()})
    return jcfg, jlp, cfg, lp


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _both(fn_j, fn_t, x, jlp, lp, jcfg, cfg):
    return (np.asarray(fn_j(jnp.asarray(x), jlp, jcfg)),
            fn_t(torch.from_numpy(x), lp, cfg).numpy())


def test_routed_matches_dense_and_jax_with_headroom():
    jcfg, jlp, cfg, lp = _setup(8.0)
    x = _x((2, 16, cfg.hidden_size), 1)
    j_routed, routed = _both(jllama._moe_mlp, tllama._moe_mlp, x, jlp, lp, jcfg, cfg)
    j_dense, dense = _both(jllama._moe_mlp_dense, tllama._moe_mlp_dense, x, jlp, lp, jcfg, cfg)
    np.testing.assert_allclose(routed, dense, **TOL)
    np.testing.assert_allclose(routed, j_routed, **TOL)
    np.testing.assert_allclose(dense, j_dense, **TOL)


@pytest.mark.parametrize("seed", range(4))
def test_decode_small_batch_exact_with_default_capacity(seed):
    jcfg, jlp, cfg, lp = _setup(2.0)
    x = _x((4, 1, cfg.hidden_size), seed)
    _, routed = _both(jllama._moe_mlp, tllama._moe_mlp, x, jlp, lp, jcfg, cfg)
    _, dense = _both(jllama._moe_mlp_dense, tllama._moe_mlp_dense, x, jlp, lp, jcfg, cfg)
    assert routed.shape == (4, 1, cfg.hidden_size)
    np.testing.assert_allclose(routed, dense, **TOL)


def test_decode_every_token_routed_to_one_expert_stays_exact():
    """N == batch with one expert winning every token: the capacity floor
    min(N, 256) holds them all."""
    jcfg, jlp, cfg, lp = _setup(2.0)
    router = np.array(jlp["router"])
    router[0, :] = 0.0
    router[0, 2] = 50.0  # feature 0 → expert 2
    jlp = {**jlp, "router": jnp.asarray(router)}
    lp.router.data.copy_(torch.from_numpy(router))
    x = _x((4, 1, cfg.hidden_size), 7)
    x[..., 0] = 5.0
    assert (torch.topk(torch.from_numpy(x).reshape(4, -1) @ lp.router, 2).indices[:, 0]
            == 2).all()
    j_routed, routed = _both(jllama._moe_mlp, tllama._moe_mlp, x, jlp, lp, jcfg, cfg)
    _, dense = _both(jllama._moe_mlp_dense, tllama._moe_mlp_dense, x, jlp, lp, jcfg, cfg)
    np.testing.assert_allclose(routed, dense, **TOL)
    np.testing.assert_allclose(routed, j_routed, **TOL)


def test_capacity_overflow_drops_as_jax_drops():
    """Past the 256 floor (N = 1200, capacity 256 at factor 0.02) tokens
    overflow: finite rows, not the dense result, and the same drops as the
    JAX routed form."""
    jcfg, jlp, cfg, lp = _setup(0.02)
    x = _x((2, 600, cfg.hidden_size), 5)
    j_routed, routed = _both(jllama._moe_mlp, tllama._moe_mlp, x, jlp, lp, jcfg, cfg)
    _, dense = _both(jllama._moe_mlp_dense, tllama._moe_mlp_dense, x, jlp, lp, jcfg, cfg)
    assert np.isfinite(routed).all()
    assert not np.allclose(routed, dense, atol=1e-5), "expected dropped tokens"
    np.testing.assert_allclose(routed, j_routed, **TOL)


def test_moe_engine_greedy_streams_match_jax():
    """tiny-moe through the port's mixed engine (routed MoE in the ragged
    rounds and the decode chunk) against the JAX dense greedy decode."""
    jcfg = jget_config("tiny-moe")
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(2), jnp.float32)
    state = params_from_jax(jax.tree.map(np.asarray, jparams), get_config("tiny-moe"))
    engine = ContinuousBatchingEngine(
        EngineConfig(model="tiny-moe", max_seq_len=64, max_batch=2, decode_chunk=4,
                     prefix_cache_pages=32, prefix_page_size=8, dtype="float32",
                     prefill_budget_tokens=8), params=state, device="cpu")
    prompts = [list(range(5, 17)), list(range(30, 39))]
    outs = [[] for _ in prompts]
    done = [threading.Event() for _ in prompts]
    try:
        for i, p in enumerate(prompts):
            def emit(ev, i=i):
                if ev.token_id >= 0:
                    outs[i].append(ev.token_id)
                if ev.finished:
                    done[i].set()
            engine.submit(p, SamplingParams(max_tokens=10), emit)
        assert all(d.wait(60) for d in done)
    finally:
        engine.shutdown()
    rope = jrope(jcfg.head_dim, jcfg.max_position, jcfg.rope_theta)
    W = 32

    @jax.jit
    def next_token(ids, length):
        h, _ = jllama.forward(jparams, jcfg, ids, jnp.arange(W, dtype=jnp.int32)[None],
                              jllama.init_cache(jcfg, 1, W, jnp.float32),
                              jnp.zeros((1,), jnp.int32), rope)
        return jnp.argmax(jllama.lm_head_logits(jparams, jcfg,
                                                jllama.gather_last_hidden(h, length)), -1)

    for p, got in zip(prompts, outs):
        seq = list(p)
        for _ in range(10):
            ids = np.zeros((1, W), np.int32)
            ids[0, :len(seq)] = seq
            seq.append(int(next_token(jnp.asarray(ids), jnp.asarray([len(seq)]))[0]))
        assert got == seq[len(p):]


def test_padding_takes_no_capacity():
    """A padded batch (a mixed round's idle positions: identical rows that
    all pick the same experts) with ``valid`` marking the real tokens: each
    real row gets what the unpadded batch gives it, and padding rows get no
    MLP output. Without the mask
    the padding fills its experts' buckets first and later real rows lose
    those experts (the drop JAX's mixed round takes at 8 experts)."""
    cfg = dataclasses.replace(get_config("tiny-moe"), num_experts=8, moe_capacity_factor=2.0)
    jcfg = dataclasses.replace(jget_config("tiny-moe"), num_experts=8)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    lp = tllama.LlamaLayer({k: torch.from_numpy(np.array(v[0]))
                            for k, v in jparams["layers"].items()})
    real = torch.from_numpy(_x((1, 24, cfg.hidden_size), 3))
    pad = 600  # past the min(N, 256) floor: buckets of ceil(N·k/E)·2 = 312
    x = torch.cat([torch.zeros((1, pad, cfg.hidden_size)) + real[:, :1] * 0.5, real], dim=1)
    valid = torch.zeros((1, pad + 24), dtype=torch.bool)
    valid[0, pad:] = True
    alone = tllama._moe_mlp(real, lp, cfg)
    masked = tllama._moe_mlp(x, lp, cfg, valid=valid, n_tokens=24)
    np.testing.assert_allclose(masked[:, pad:].numpy(), alone.numpy(), **TOL)
    assert not masked[:, :pad].any()
    np.testing.assert_allclose(alone.numpy(), tllama._moe_mlp_dense(real, lp, cfg).numpy(),
                               **TOL)
    unmasked = tllama._moe_mlp(x, lp, cfg)[:, pad:]
    assert not np.allclose(unmasked.numpy(), alone.numpy(), atol=1e-4), \
        "expected the padding to crowd real tokens out"


def test_real_tokens_keep_jax_padded_capacity():
    """A mixed round's shape: 300 real tokens that all pick the same two
    experts, then 900 padding rows. The buckets take JAX's capacity for the
    1200 rows (600), capped at the 300 real tokens, so nothing drops: the
    masked call equals the dense oracle and JAX's routed form over the
    padded batch at the real rows (JAX's stable sort puts them first in
    each bucket). Buckets sized by the real count alone (256, the floor)
    would drop 44 of each chosen expert's assignments."""
    cfg = dataclasses.replace(get_config("tiny-moe"), num_experts=8, moe_capacity_factor=2.0)
    jcfg = dataclasses.replace(jget_config("tiny-moe"), num_experts=8, moe_capacity_factor=2.0)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(4), jnp.float32)
    jlp = jax.tree.map(lambda a: a[0], jparams["layers"])
    lp = tllama.LlamaLayer({k: torch.from_numpy(np.array(v)) for k, v in jlp.items()})
    n, N = 300, 1200
    x = np.zeros((1, N, cfg.hidden_size), np.float32)
    x[0, :n] = _x((1, cfg.hidden_size), 6) + 0.01 * _x((n, cfg.hidden_size), 7)
    top = torch.topk(torch.from_numpy(x[0, :n]) @ lp.router, 2, dim=-1).indices
    assert int(torch.bincount(top.reshape(-1), minlength=8).max()) == n  # one expert pair
    assert tllama.moe_capacity(cfg, N, n) == n
    valid = torch.zeros((1, N), dtype=torch.bool)
    valid[0, :n] = True
    masked = tllama._moe_mlp(torch.from_numpy(x), lp, cfg, valid=valid, n_tokens=n)
    j_routed = np.asarray(jllama._moe_mlp(jnp.asarray(x), jlp, jcfg))
    np.testing.assert_allclose(masked[0, :n].numpy(), j_routed[0, :n], **TOL)
    dense = tllama._moe_mlp_dense(torch.from_numpy(x[:, :n]), lp, cfg)
    np.testing.assert_allclose(masked[:, :n].numpy(), dense.numpy(), **TOL)
    assert not masked[:, n:].any()
