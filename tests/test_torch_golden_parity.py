"""The port against transformers' own output on real HF checkpoints.

The committed fixtures under ``tests/golden/fixtures/`` are HF checkpoints
(llama, the outlier-weight llama, qwen2 with q/k/v bias and tied embeddings,
gemma, mixtral's top-2 MoE) with the logits and greedy ids transformers
computed (f32, D 16). Mirroring ``tests/test_golden_parity.py``:

- the port's loader gives, at f32, exactly the tree of the JAX package's
  loader (through ``params_from_jax``), and its safetensors reader equals
  ``safetensors.numpy`` tensor for tensor;
- full-prompt logits within rtol = atol = 1e-4 of ``golden.npz``, with every
  argmax equal;
- the 16-token greedy continuation equals ``greedy_ids`` through the dense
  KV-cache decode and through the paged mixed engine;
- the HF tokenizer and ``render_chat`` against the committed encodings and
  transformers' chat renderings;
- ``save_llama_params`` writes the HF tensor set, and loading it back gives
  the same tensors.
"""

from __future__ import annotations

import json
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu_torch.models import llama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime.engine import EngineConfig, SamplingParams
from cyberfabric_core_tpu_torch.runtime.scheduler import ContinuousBatchingEngine
from cyberfabric_core_tpu_torch.runtime.weights import (SafetensorsIndex, load_llama_params,
                                                        model_from_state_dict,
                                                        params_from_jax, save_llama_params)

FIXTURES = Path(__file__).parent / "golden" / "fixtures"
FAMILIES = sorted(["tiny-llama-golden", "tiny-qwen2-golden", "tiny-gemma-golden",
                   "tiny-mixtral-golden", "tiny-llama-outlier"])


def _model(fam):
    cfg = get_config(fam)
    return cfg, model_from_state_dict(load_llama_params(FIXTURES / fam, cfg, torch.float32,
                                                        "cpu"), cfg, "cpu")


def _rope(cfg):
    return rope_frequencies(cfg.head_dim, cfg.max_position, cfg.rope_theta, device="cpu")


@pytest.mark.parametrize("fam", FAMILIES)
def test_loader_tree_equals_the_jax_loaders(fam):
    from cyberfabric_core_tpu.models.configs import get_config as jget_config
    from cyberfabric_core_tpu.runtime.weights import load_llama_params as jload

    cfg = get_config(fam)
    ours = load_llama_params(FIXTURES / fam, cfg, torch.float32, "cpu")
    theirs = params_from_jax(jax.tree.map(np.asarray, jload(FIXTURES / fam, jget_config(fam),
                                                            dtype=jnp.float32)), cfg)
    assert sorted(ours) == sorted(theirs)
    for name, t in ours.items():
        assert t.dtype == torch.float32 and torch.equal(t, theirs[name]), name


@pytest.mark.parametrize("fam", ["tiny-llama-golden", "tiny-mixtral-golden"])
def test_safetensors_reader_equals_safetensors_numpy(fam):
    from safetensors.numpy import load_file

    ref = load_file(str(FIXTURES / fam / "model.safetensors"))
    idx = SafetensorsIndex(FIXTURES / fam)
    assert sorted(idx.name_to_file) == sorted(ref)
    for name, arr in ref.items():
        t = idx.load(name)
        assert t.dtype == torch.float32 and tuple(t.shape) == arr.shape
        assert np.array_equal(t.numpy(), arr), name
    with pytest.raises(KeyError):
        idx.load("model.no_such_tensor")


def test_safetensors_reader_reads_bf16_f16_and_refuses_other_dtypes(tmp_path):
    from safetensors.numpy import save_file

    rng = np.random.default_rng(0)
    f32 = rng.standard_normal((3, 5)).astype(np.float32)
    save_file({"h": f32.astype(np.float16), "i": np.arange(4, dtype=np.int64)},
              str(tmp_path / "a.safetensors"))
    from cyberfabric_core_tpu_torch.runtime.weights import write_safetensors

    write_safetensors({"b": torch.from_numpy(f32).to(torch.bfloat16)},
                      tmp_path / "b.safetensors")
    idx = SafetensorsIndex(tmp_path)
    assert np.array_equal(idx.load("h").numpy(), f32.astype(np.float16))
    assert torch.equal(idx.load("b"), torch.from_numpy(f32).to(torch.bfloat16))
    with pytest.raises(ValueError, match="I64"):
        idx.load("i")


@pytest.mark.parametrize("fam", FAMILIES)
def test_forward_logits_match_transformers(fam):
    golden = np.load(FIXTURES / fam / "golden.npz")
    cfg, params = _model(fam)
    ids = torch.from_numpy(golden["input_ids"].astype(np.int32))
    B, T = ids.shape
    hidden, _ = llama.forward(params, cfg, ids, torch.arange(T, dtype=torch.int32)[None]
                              .expand(B, T), llama.init_cache(cfg, B, T, torch.float32,
                                                               device="cpu"),
                              torch.zeros(B, dtype=torch.int32), _rope(cfg))
    ours = llama.lm_head_logits(params, cfg, hidden).numpy()
    ref = golden["logits"]
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-4)
    assert (ours.argmax(-1) == ref.argmax(-1)).all()


@pytest.mark.parametrize("fam", FAMILIES)
def test_incremental_greedy_decode_matches_transformers(fam):
    """Prefill 12 tokens, then T=1 steps through the dense cache."""
    golden = np.load(FIXTURES / fam / "golden.npz")
    cfg, params = _model(fam)
    prompt, want = golden["greedy_ids"][:12].tolist(), golden["greedy_ids"][12:].tolist()
    cache = llama.init_cache(cfg, 1, 64, torch.float32, device="cpu")
    rope = _rope(cfg)
    hidden, cache = llama.forward(params, cfg, torch.tensor([prompt], dtype=torch.int32),
                                  torch.arange(12, dtype=torch.int32)[None], cache,
                                  torch.zeros(1, dtype=torch.int32), rope)
    tok = int(llama.lm_head_logits(params, cfg, hidden)[0, -1].argmax())
    got, n = [tok], 12
    for _ in range(len(want) - 1):
        hidden, cache = llama.forward(params, cfg, torch.tensor([[tok]], dtype=torch.int32),
                                      torch.tensor([[n]], dtype=torch.int32), cache,
                                      torch.tensor([n], dtype=torch.int32), rope)
        tok = int(llama.lm_head_logits(params, cfg, hidden)[0, -1].argmax())
        got.append(tok)
        n += 1
    assert got == want


def test_paged_mixed_engine_greedy_matches_transformers():
    """Every fixture through the paged mixed engine at f32 (ragged rounds,
    the decode chunk, the ring): the continuation equals greedy_ids."""
    for fam in FAMILIES:
        golden = np.load(FIXTURES / fam / "golden.npz")
        cfg = get_config(fam)
        prompt, want = golden["greedy_ids"][:12].tolist(), golden["greedy_ids"][12:].tolist()
        engine = ContinuousBatchingEngine(
            EngineConfig(model=fam, max_seq_len=64, max_batch=2, decode_chunk=4,
                         prefix_cache_pages=32, prefix_page_size=8, dtype="float32",
                         prefill_budget_tokens=8),
            params=load_llama_params(FIXTURES / fam, cfg, torch.float32, "cpu"),
            device="cpu")
        got, done = [], threading.Event()

        def emit(ev):
            if ev.token_id >= 0:
                got.append(ev.token_id)
            if ev.finished:
                done.set()

        try:
            engine.submit(prompt, SamplingParams(max_tokens=len(want)), emit)
            assert done.wait(60)
        finally:
            engine.shutdown()
        assert got == want, fam


def test_roundtrip_save_matches_hf_layout(tmp_path):
    from safetensors import safe_open

    for fam in ("tiny-llama-golden", "tiny-mixtral-golden", "tiny-qwen2-golden"):
        cfg = get_config(fam)
        state = load_llama_params(FIXTURES / fam, cfg, torch.float32, "cpu")
        out = tmp_path / fam
        save_llama_params(model_from_state_dict(state, cfg, "cpu"), cfg, out)
        with safe_open(str(out / "model.safetensors"), framework="numpy") as ours, \
                safe_open(str(FIXTURES / fam / "model.safetensors"), framework="numpy") as ref:
            assert set(ours.keys()) == set(ref.keys())
            for name in ref.keys():
                assert np.array_equal(ours.get_tensor(name), ref.get_tensor(name)), name
        back = load_llama_params(out, cfg, torch.float32, "cpu")
        assert all(torch.equal(back[k], state[k]) for k in state)


def test_quantized_loading_is_a_later_slice():
    """Quantized loading, ported since ROADMAP item 6: at 8 and 4 bits the
    port's loader gives the JAX loader's quantized tree (through
    ``params_from_jax``, int4 packed): int values equal, scales within one
    f32 ulp."""
    from cyberfabric_core_tpu.models.configs import get_config as jget_config
    from cyberfabric_core_tpu.runtime.weights import load_llama_params as jload

    fam = "tiny-llama-golden"
    cfg = get_config(fam)
    for bits in (8, 4):
        ours = load_llama_params(FIXTURES / fam, cfg, torch.float32, "cpu", quantize=True,
                                 quant_bits=bits)
        theirs = params_from_jax(jax.tree.map(np.asarray, jload(
            FIXTURES / fam, jget_config(fam), dtype=jnp.float32, quantize=True,
            quant_bits=bits)), cfg)
        assert sorted(ours) == sorted(theirs)
        assert "embed.qe" in ours and "layers.0.wq.q" in ours
        for name, t in ours.items():
            if t.dtype == torch.int8:
                assert torch.equal(t, theirs[name]), name
            else:
                np.testing.assert_array_max_ulp(t.numpy(), theirs[name].numpy(), 1)


# ------------------------------------------------------------- tokenizer


def test_hf_tokenizer_path_matches_golden():
    from cyberfabric_core_tpu_torch.runtime.tokenizer import HfTokenizer, load_tokenizer

    tok = load_tokenizer(FIXTURES / "tokenizer")
    assert isinstance(tok, HfTokenizer)
    golden = json.loads((FIXTURES / "tokenizer" / "golden_tokenizer.json").read_text())
    for pair in golden["pairs"]:
        assert tok.encode(pair["text"]) == pair["ids"], pair["text"]
        assert tok.decode(pair["ids"]) == pair["decoded"], pair["text"]
    assert tok.bos_id == tok._tok.token_to_id("<|begin_of_text|>")
    assert tok.eos_id == tok._tok.token_to_id("<|end_of_text|>")


def test_hf_tokenizer_without_the_package_raises(monkeypatch):
    import builtins

    from cyberfabric_core_tpu_torch.runtime import tokenizer as ttok

    real_import = builtins.__import__

    def no_tokenizers(name, *args, **kwargs):
        if name == "tokenizers":
            raise ImportError("no module named tokenizers")
        return real_import(name, *args, **kwargs)

    monkeypatch.setattr(builtins, "__import__", no_tokenizers)
    with pytest.raises(ImportError, match="tokenizers"):
        ttok.load_tokenizer(FIXTURES / "tokenizer")
    assert isinstance(ttok.load_tokenizer(None), ttok.ByteTokenizer)


@pytest.mark.parametrize("family", ["llama", "qwen2", "gemma", "mistral"])
def test_render_chat_matches_apply_chat_template(family):
    from cyberfabric_core_tpu_torch.runtime.tokenizer import render_chat

    golden = json.loads((FIXTURES / "tokenizer" / "golden_chat.json").read_text())[family]
    parts = [{"role": m["role"], "content": [{"type": "text", "text": m["content"]}]}
             for m in golden["messages"]]
    assert render_chat(parts, family) == golden["rendered"]


def test_render_chat_system_folding_and_families():
    from cyberfabric_core_tpu_torch.runtime.tokenizer import chat_family_for, render_chat

    def t(s):
        return [{"type": "text", "text": s}]

    out = render_chat([{"role": "system", "content": t("Be terse.")},
                       {"role": "user", "content": t("Hi")}], "gemma")
    assert "<start_of_turn>user\nBe terse.\n\nHi<end_of_turn>\n" in out and "system" not in out
    out = render_chat([{"role": "system", "content": t("Be terse.")},
                       {"role": "assistant", "content": t("Ready.")},
                       {"role": "user", "content": t("Go")}], "gemma")
    assert out.index("Be terse.") < out.index("Ready.")
    out = render_chat([{"role": "user", "content": t("Hi")},
                       {"role": "assistant", "content": t("Hello")},
                       {"role": "system", "content": t("Switch to French.")},
                       {"role": "user", "content": t("Go")}], "mistral")
    assert "[INST] Hi [/INST]" in out and "[INST] Switch to French.\n\nGo [/INST]" in out
    assert [chat_family_for(n) for n in ("gemma-7b", "qwen2-7b", "tiny-llama", "mistral-7b",
                                         "mixtral-8x7b")] == \
        ["gemma", "qwen2", "llama", "mistral", "mistral"]


def test_hf_encode_no_double_bos_with_postprocessor(tmp_path):
    from tokenizers import Tokenizer as RawTok
    from tokenizers.processors import TemplateProcessing

    from cyberfabric_core_tpu_torch.runtime.tokenizer import load_tokenizer

    raw = RawTok.from_file(str(FIXTURES / "tokenizer" / "tokenizer.json"))
    bos = raw.token_to_id("<|begin_of_text|>")
    raw.post_processor = TemplateProcessing(single="<|begin_of_text|> $A",
                                            special_tokens=[("<|begin_of_text|>", bos)])
    raw.save(str(tmp_path / "tokenizer.json"))
    tok = load_tokenizer(tmp_path)
    templated = "<|begin_of_text|>hello"
    assert tok.encode(templated)[:2] == [bos, bos]
    clean = tok.encode(templated, add_specials=False)
    assert clean[0] == bos and bos not in clean[1:]
