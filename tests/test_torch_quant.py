"""The port's weight-only quantization (``runtime/quant.py``) against the JAX
package's, on the CPU.

Mirrors ``tests/test_quant.py`` and the quantization tests of
``tests/test_golden_parity.py``:

- ``quantize_weight`` on the same numpy-seeded weights: the int values equal
  JAX's, the scales within one f32 ulp, at 8 and 4 bits (int4 packed two a
  byte, the pack round trip pinned over every value); the embedding's int8
  rows likewise;
- the quantized forward of a JAX-quantized tree carried across
  (``params_from_jax``) within 1e-5 of JAX's logits at f32, for an untied
  llama, a tied qwen2 with q/k/v bias and a routed tiny-moe. JAX's routed
  MoE cannot take a quantized tree (its ``_scaled`` broadcasts the
  ``[E, I]`` scales against ``[E, C, I]``, which fails unless C equals E,
  and is wrong when it does), so the MoE reference is JAX's dense oracle
  ``_moe_mlp_dense``, which the test swaps in for JAX's ``_moe_mlp``; the
  port's routed form applies each expert's scales;
- greedy streams of quantized paged engines (mixed and phase-separated at
  8 and 4 bits, and tiny-moe routed) equal to the JAX package's greedy
  decode of the same tree through its dense forward;
- the three fixtures' ``QUANT_BOUNDS`` and the outlier fixture's CE
  deltas, through the port's quantizing loader;
- a quantized tree refuses to be saved; a quantized init draws what
  ``init_params`` draws and quantizes it, router and norms unquantized.
"""

from __future__ import annotations

import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.rope import rope_frequencies as jrope
from cyberfabric_core_tpu.runtime import quant as jquant
from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime import quant
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import (load_llama_params,
                                                        model_from_state_dict,
                                                        params_from_jax, save_llama_params)

FIXTURES = Path(__file__).parent / "golden" / "fixtures"
#: (bits → max allowed mean |Δlogit| against transformers'), as
#: tests/test_golden_parity.py states them
QUANT_BOUNDS = {8: 0.02, 4: 0.12}
#: the port's forward against JAX's on one quantized tree, at f32
FWD_TOL = dict(rtol=1e-5, atol=1e-5)


def _w(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 0.1


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_weight_matches_jax(bits):
    w = _w((3, 48, 24), bits)
    w[1, :, 5] = 0.0  # an all-zero channel takes the 1e-12 floor
    ref = jquant.quantize_weight(jnp.asarray(w), bits)
    ours = quant.quantize_weight(torch.from_numpy(w), bits)
    assert ours.q.dtype == torch.int8 and ours.bits == bits
    assert ours.q.shape == ((3, 48, 24) if bits == 8 else (3, 24, 24))
    want_q = np.asarray(ref["q"]).astype(np.int8)
    assert np.array_equal(ours.values().numpy(), want_q)
    np.testing.assert_array_max_ulp(ours.s.numpy(), np.asarray(ref["s"]), 1)
    back = np.asarray(jquant.dequantize_weight(ref, jnp.float32))
    np.testing.assert_allclose(ours.dequantize(torch.float32).numpy(), back, rtol=1e-6,
                               atol=0)
    e = _w((40, 16), 7)
    ref_e = jquant._quantize_embed(jnp.asarray(e))
    ours_e = quant.quantize_embed(torch.from_numpy(e))
    assert np.array_equal(ours_e.qe.numpy(), np.asarray(ref_e["qe"]))
    np.testing.assert_array_max_ulp(ours_e.se.numpy(), np.asarray(ref_e["se"]), 1)


@pytest.mark.parametrize("rows", [32, 15])
def test_int4_pack_round_trip_over_every_value(rows):
    """Every pair of int4 values, as the low and the high nibble of one
    byte (16 × 16 pairs along the contraction axis), unpacked exactly; an
    odd contraction length raises."""
    vals = torch.arange(-8, 8, dtype=torch.int8)
    q = torch.empty((rows, 16), dtype=torch.int8)
    if rows % 2:
        with pytest.raises(ValueError, match="even"):
            quant.pack_int4(q)
        return
    q[0::2] = vals[None, :].expand(rows // 2, 16)  # low nibble: the column's value
    q[1::2] = vals[:, None].expand(rows // 2, 16)  # high nibble: the pair's value
    q = torch.stack([q, q.flip(0)])                # [2, 32, 16]: the roles swapped too
    packed = quant.pack_int4(q)
    assert packed.dtype == torch.int8 and packed.shape == (2, rows // 2, 16)
    assert torch.equal(quant.unpack_int4(packed), q)


def _jax_logits(cfg, params, ids):
    B, T = ids.shape
    rope = jrope(cfg.head_dim, cfg.max_position, cfg.rope_theta)
    hidden, _ = jllama.forward(params, cfg, jnp.asarray(ids), jnp.broadcast_to(
        jnp.arange(T, dtype=jnp.int32), (B, T)), jllama.init_cache(cfg, B, T, jnp.float32),
        jnp.zeros((B,), jnp.int32), rope)
    return np.asarray(jllama.lm_head_logits(params, cfg, hidden))


def _port_logits(cfg, model, ids):
    B, T = ids.shape
    rope = rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta, device="cpu")
    hidden, _ = llama.forward(model, cfg, torch.from_numpy(ids),
                              torch.arange(T, dtype=torch.int32)[None].expand(B, T),
                              llama.init_cache(cfg, B, T, torch.float32, device="cpu"),
                              torch.zeros(B, dtype=torch.int32), rope)
    return llama.lm_head_logits(model, cfg, hidden).numpy()


@pytest.fixture
def jax_dense_moe(monkeypatch):
    """JAX's forward with its dense MoE oracle in place of its routed MoE,
    which cannot take quantized experts (see the module docstring)."""
    monkeypatch.setattr(jllama, "_moe_mlp", jllama._moe_mlp_dense)


def _jax_quantized(name, bits, seed=0):
    jcfg = jget_config(name)
    return jcfg, jquant.quantize_llama_params(
        jllama.init_params(jcfg, jax.random.PRNGKey(seed), jnp.float32), bits)


@pytest.mark.parametrize("name", ["tiny-llama", "tiny-qwen2-golden", "tiny-moe"])
@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_forward_matches_jax(name, bits, jax_dense_moe):
    jcfg, jparams = _jax_quantized(name, bits)
    cfg = get_config(name)
    model = model_from_state_dict(params_from_jax(jax.tree.map(np.asarray, jparams), cfg),
                                  cfg, "cpu")
    assert isinstance(model.layers[0].wq, quant.QuantWeight) and model.layers[0].wq.bits == bits
    assert isinstance(model.embed, quant.QuantEmbed)
    ids = np.random.default_rng(bits).integers(3, cfg.vocab_size, (2, 11)).astype(np.int32)
    np.testing.assert_allclose(_port_logits(cfg, model, ids), _jax_logits(jcfg, jparams, ids),
                               **FWD_TOL)


def _greedy_jax(jcfg, jparams, prompts, n, width=32):
    """JAX's greedy continuation of every prompt: each step one jitted dense
    forward over the padded batch, the argmax at each row's last token."""
    rope = jrope(jcfg.head_dim, jcfg.max_position, jcfg.rope_theta)

    @jax.jit
    def step(params, ids, lengths):
        B = ids.shape[0]
        pos = jnp.broadcast_to(jnp.arange(width, dtype=jnp.int32), (B, width))
        h, _ = jllama.forward(params, jcfg, ids, pos,
                              jllama.init_cache(jcfg, B, width, jnp.float32),
                              jnp.zeros(B, jnp.int32), rope)
        logits = jllama.lm_head_logits(params, jcfg, jllama.gather_last_hidden(h, lengths))
        return jnp.argmax(logits, -1)

    seqs = [list(p) for p in prompts]
    for _ in range(n):
        ids = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            ids[i, :len(s)] = s
        nxt = np.asarray(step(jparams, ids, np.asarray([len(s) for s in seqs], np.int32)))
        for s, t in zip(seqs, nxt):
            s.append(int(t))
    return [s[len(p):] for s, p in zip(seqs, prompts)]


ENGINE_CASES = {
    "tiny-llama-int8-mixed": ("tiny-llama", 8, {}),
    "tiny-llama-int8-phase-separated": ("tiny-llama", 8, dict(mixed_batch=False,
                                                              prefill_coalesce=2)),
    "tiny-llama-int4-mixed": ("tiny-llama", 4, {}),
    "tiny-moe-int8-mixed": ("tiny-moe", 8, {}),
}


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_quantized_engine_greedy_streams_match_jax(case, jax_dense_moe):
    """The JAX tree quantized there and carried across, served by the
    port's paged engine (an unquantized copy passed with the quantization
    option must give the same streams: the engine quantizes it)."""
    name, bits, overrides = ENGINE_CASES[case]
    jcfg, jparams = _jax_quantized(name, bits, seed=3)
    cfg = get_config(name)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, n).tolist() for n in (5, 19, 12)]
    want = _greedy_jax(jcfg, jparams, prompts, 6)
    state = params_from_jax(jax.tree.map(np.asarray, jparams), cfg)
    engine = ContinuousBatchingEngine(
        EngineConfig(model=name, max_seq_len=64, max_batch=2, decode_chunk=4,
                     prefix_cache_pages=32, prefix_page_size=8, dtype="float32",
                     prefill_budget_tokens=8, quantization=f"int{bits}", **overrides),
        params=state, device="cpu")
    outs = [[] for _ in prompts]
    done = threading.Event()
    left = [len(prompts)]

    def emit_for(i):
        def emit(ev):
            if ev.token_id >= 0:
                outs[i].append(ev.token_id)
            if ev.finished:
                left[0] -= 1
                if not left[0]:
                    done.set()
        return emit

    try:
        for i, p in enumerate(prompts):
            engine.submit(p, SamplingParams(max_tokens=6), emit_for(i))
        assert done.wait(60), engine.stats()
    finally:
        engine.shutdown()
    assert outs == want
    st = engine.stats()
    assert st["pages_referenced"] == 0 and st["orphan_pages"] == 0


def test_an_unquantized_tree_is_quantized_by_the_engine():
    jcfg = jget_config("tiny-llama")
    cfg = get_config("tiny-llama")
    state = params_from_jax(jax.tree.map(np.asarray, jllama.init_params(
        jcfg, jax.random.PRNGKey(3), jnp.float32)), cfg)
    engine = ContinuousBatchingEngine(EngineConfig(model="tiny-llama", dtype="float32",
                                                   quantization="int4"),
                                      params=state, device="cpu")
    wq = engine.params.layers[0].wq
    assert isinstance(wq, quant.QuantWeight) and wq.bits == 4
    ref = jquant.quantize_weight(jnp.asarray(np.asarray(state["layers.0.wq"])), 4)
    assert np.array_equal(wq.values().numpy(), np.asarray(ref["q"]).astype(np.int8))


def _fixture_logits(fam, bits):
    cfg = get_config(fam)
    golden = np.load(FIXTURES / fam / "golden.npz")
    model = model_from_state_dict(load_llama_params(FIXTURES / fam, cfg, torch.float32, "cpu",
                                                    quantize=True, quant_bits=bits), cfg, "cpu")
    return _port_logits(cfg, model, golden["input_ids"].astype(np.int32)), golden


@pytest.mark.parametrize("fam", ["tiny-llama-golden", "tiny-qwen2-golden",
                                 "tiny-llama-outlier"])
def test_quantization_error_bounds_on_real_checkpoints(fam):
    """W8 and W4 through the port's quantizing loader against transformers'
    logits: within QUANT_BOUNDS, and W8 closer than W4."""
    errs = {}
    for bits in (8, 4):
        ours, golden = _fixture_logits(fam, bits)
        errs[bits] = float(np.abs(ours - golden["logits"]).mean())
        assert errs[bits] < QUANT_BOUNDS[bits], (fam, bits, errs[bits])
    assert errs[8] < errs[4], errs


def _ce(logits, targets):
    lp = torch.log_softmax(torch.from_numpy(logits[:, :-1]).double(), dim=-1)
    return float(-lp.gather(-1, torch.from_numpy(targets).long()[..., None]).mean())


def test_quantization_perplexity_delta_on_outlier_weights():
    """Next-token CE on the outlier checkpoint moves less than 0.01 nats at
    W8 and 0.05 at W4 (the JAX test's budgets), W8 less than W4."""
    fam = "tiny-llama-outlier"
    deltas = {}
    for bits, budget in ((8, 0.01), (4, 0.05)):
        ours, golden = _fixture_logits(fam, bits)
        targets = golden["input_ids"][:, 1:]
        deltas[bits] = abs(_ce(ours, targets) - _ce(golden["logits"], targets))
        assert deltas[bits] < budget, (bits, deltas[bits])
    assert deltas[8] < deltas[4], deltas


def test_saving_a_quantized_tree_raises(tmp_path):
    cfg = get_config("tiny-llama")
    model = quant.init_params_quantized(cfg, 0, torch.float32, 8, "cpu")
    with pytest.raises(ValueError, match="quantized"):
        save_llama_params(model, cfg, tmp_path)
    with pytest.raises(ValueError, match="quantized"):
        save_llama_params(model.state_dict(), cfg, tmp_path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_init_quantizes_the_plain_draw(bits):
    """The same generator, the same order: ``init_params_quantized`` equals
    quantizing ``init_params``; the router and norms stay f32, the
    embedding int8 rows even at 4 bits, and the tree shrinks."""
    cfg = get_config("tiny-moe")
    plain = llama.init_params(cfg, 5, torch.float32, "cpu")
    q = quant.init_params_quantized(cfg, 5, torch.float32, bits, "cpu")
    ref = quant.quantize_llama_params(plain, bits).state_dict()
    got = q.state_dict()
    assert sorted(got) == sorted(ref) and all(torch.equal(got[k], ref[k]) for k in got)
    lp = q.layers[0]
    assert lp.router.dtype == torch.float32 and lp.attn_norm.dtype == torch.float32
    assert isinstance(lp.moe_gate, quant.QuantWeight) and lp.moe_gate.bits == bits
    assert q.embed.qe.dtype == torch.int8
    assert quant.quantized_bytes(q) < quant.quantized_bytes(plain) * (0.3 if bits == 8
                                                                       else 0.2)


def test_without_a_card_a_quantized_init_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device draws there")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        quant.init_params_quantized(get_config("tiny-llama"))
