"""The port's bert encoder on the CPU against the JAX package's.

tiny-bert (and bge-base-en's shapes at two layers) in f32, the JAX weights
carried across by ``bert_params_from_jax``: ``layer_norm``,
``encoder_attention``, the bert ``forward`` and ``embed_pooled`` (cls and
mean pooling, padded rows) within rtol = atol = 1e-5 of the JAX functions.
A checkpoint written by the JAX ``save_bert_params`` loads through the
port's ``load_bert_params`` (also under the ``bert.`` prefix) to the same
state_dict, and the port's ``save_bert_params`` writes what the JAX loader
reads back."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import bert as jbert
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.ops.attention import encoder_attention as jencoder_attention
from cyberfabric_core_tpu.ops.norms import layer_norm as jlayer_norm
from cyberfabric_core_tpu.runtime import weights as jweights
from cyberfabric_core_tpu_torch.models import bert
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.attention import encoder_attention
from cyberfabric_core_tpu_torch.ops.norms import layer_norm
from cyberfabric_core_tpu_torch.runtime import weights

TOL = dict(rtol=1e-5, atol=1e-5)


def _jax_tree(name: str, seed: int = 0, **over):
    jcfg = dataclasses.replace(jget_config(name), **over)
    return jcfg, jax.tree.map(np.asarray, jbert.init_params(jcfg, jax.random.PRNGKey(seed),
                                                            jnp.float32))


def _batch(cfg, lens, T, seed=0):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), T), np.int32)
    mask = np.zeros((len(lens), T), np.int32)
    for i, n in enumerate(lens):
        ids[i, :n] = rng.integers(1, cfg.vocab_size, n)
        mask[i, :n] = 1
    return ids, mask


@pytest.mark.parametrize("shape", [(2, 5, 32), (3, 7, 768)])
def test_layer_norm_matches_jax(shape):
    rng = np.random.default_rng(1)
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    w = rng.standard_normal(shape[-1]).astype(np.float32)
    b = rng.standard_normal(shape[-1]).astype(np.float32)
    want = np.asarray(jlayer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-12))
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # statistics in f32: a bf16 input gives the f32 result, rounded once
    xb = torch.from_numpy(x).bfloat16()
    got_b = layer_norm(xb, torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    assert got_b.dtype == torch.bfloat16
    ref_b = layer_norm(xb.float(), torch.from_numpy(w), torch.from_numpy(b), 1e-12)
    assert torch.equal(got_b, ref_b.bfloat16())


@pytest.mark.parametrize("lens", [[6, 6], [6, 2, 1], [1]])
def test_encoder_attention_matches_jax(lens):
    """Bidirectional, padded keys masked, rows of any length."""
    rng = np.random.default_rng(2)
    B, T, H, D = len(lens), 6, 2, 16
    q, k, v = (rng.standard_normal((B, T, H, D)).astype(np.float32) for _ in range(3))
    mask = np.asarray([[1] * n + [0] * (T - n) for n in lens], np.int32)
    want = np.asarray(jencoder_attention(*(jnp.asarray(a) for a in (q, k, v, mask))))
    got = encoder_attention(*(torch.from_numpy(a) for a in (q, k, v, mask)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("name,over", [("tiny-bert", {}),
                                       ("bge-base-en", {"num_layers": 2, "vocab_size": 512,
                                                        "max_position": 64})])
@pytest.mark.parametrize("pooling", ["cls", "mean"])
def test_forward_and_embed_pooled_match_jax(name, over, pooling):
    """Token states and pooled, normalised embeddings on padded rows."""
    jcfg, tree = _jax_tree(name, pooling=pooling, **over)
    cfg = dataclasses.replace(get_config(name), pooling=pooling, **over)
    params = bert.from_state_dict(weights.bert_params_from_jax(tree, cfg), cfg, device="cpu")
    ids, mask = _batch(cfg, [9, 4, 1], 12)
    jtree = jax.tree.map(jnp.asarray, tree)
    want_h = np.asarray(jbert.forward(jtree, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    want_e = np.asarray(jbert.embed_pooled(jtree, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        h = bert.forward(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
        e = bert.embed_pooled(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    for i, n in enumerate([9, 4, 1]):
        np.testing.assert_allclose(h[i, :n].numpy(), want_h[i, :n], **TOL)
    np.testing.assert_allclose(e.numpy(), want_e, **TOL)
    assert e.dtype == torch.float32
    np.testing.assert_allclose(torch.linalg.norm(e, dim=-1).numpy(), 1.0, rtol=1e-6)


def test_init_params_is_seeded_and_needs_an_explicit_device():
    cfg = get_config("tiny-bert")
    a = bert.init_params(cfg, 3, torch.float32, "cpu").state_dict()
    b = bert.init_params(cfg, 3, torch.float32, "cpu").state_dict()
    c = bert.init_params(cfg, 4, torch.float32, "cpu").state_dict()
    assert set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["word_embed"], c["word_embed"])
    assert torch.equal(a["layers.1.attn_ln_w"], torch.ones(cfg.hidden_size))
    assert torch.equal(a["layers.0.bq"], torch.zeros(cfg.hidden_size))
    assert abs(float(a["layers.0.wq"].std()) - 0.02) < 0.005
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bert.init_params(cfg)
    with pytest.raises(ValueError, match="encoder"):
        bert.init_params(get_config("tiny-llama"), 0, torch.float32, "cpu")


def test_bert_params_from_jax_unstacks_every_leaf():
    jcfg, tree = _jax_tree("tiny-bert")
    cfg = get_config("tiny-bert")
    state = weights.bert_params_from_jax(tree, cfg)
    top, layer = bert.leaf_shapes(cfg)
    assert set(state) == set(top) | {f"layers.{i}.{n}" for i in range(cfg.num_layers)
                                     for n in layer}
    for n, shape in layer.items():
        assert tuple(state[f"layers.1.{n}"].shape) == shape
        np.testing.assert_array_equal(state[f"layers.1.{n}"].numpy(), tree["layers"][n][1])
    bad = dict(tree, layers={**tree["layers"], "wq": tree["layers"]["wq"][:1]})
    with pytest.raises(ValueError, match="layers"):
        weights.bert_params_from_jax(bad, cfg)


@pytest.mark.parametrize("prefixed", [False, True])
def test_jax_checkpoint_loads_through_the_port(tmp_path, prefixed):
    """JAX ``save_bert_params`` → port ``load_bert_params``: the state_dict
    ``bert_params_from_jax`` gives for the same tree (a ``bert.`` prefix,
    as a BertForMaskedLM checkpoint has, is stripped), on the device and
    dtype asked for."""
    jcfg, tree = _jax_tree("tiny-bert", seed=5)
    cfg = get_config("tiny-bert")
    path = jweights.save_bert_params(jax.tree.map(jnp.asarray, tree), jcfg, tmp_path)
    if prefixed:
        idx = weights.SafetensorsIndex(tmp_path)
        tensors = {f"bert.{n}": idx.load(n) for n in idx.name_to_file}
        path.unlink()
        weights.write_safetensors(tensors, tmp_path / "model.safetensors")
    state = weights.load_bert_params(tmp_path, cfg, dtype=torch.float32, device="cpu")
    want = weights.bert_params_from_jax(tree, cfg)
    assert set(state) == set(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k
    half = weights.load_bert_params(tmp_path, cfg, device="cpu")
    assert half["layers.0.wq"].dtype == torch.bfloat16


def test_port_checkpoint_loads_through_the_jax_loader(tmp_path):
    """Port ``save_bert_params`` writes the HF layout the JAX loader reads:
    the same tree back, and the same embeddings from both packages."""
    cfg = get_config("tiny-bert")
    params = bert.init_params(cfg, 1, torch.float32, "cpu")
    weights.save_bert_params(params, cfg, tmp_path)
    jcfg = jget_config("tiny-bert")
    jtree = jweights.load_bert_params(tmp_path, jcfg, dtype=jnp.float32)
    mine = weights.bert_params_from_jax(jax.tree.map(np.asarray, jtree), cfg)
    state = params.state_dict()
    assert all(torch.equal(mine[k], state[k]) for k in state)
    ids, mask = _batch(cfg, [7, 3], 8, seed=4)
    want = np.asarray(jbert.embed_pooled(jtree, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    with torch.inference_mode():
        got = bert.embed_pooled(params, cfg, torch.from_numpy(ids), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
