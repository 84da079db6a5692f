"""The port's GPipe pipeline (``parallel/pipeline.py``) against the JAX
package's, on the CPU.

The tiny config of ``tests/test_pipeline.py``; weights from the JAX
package's ``init_params`` carried by ``params_from_jax``; ids from numpy
seeds. Every stage and data-parallel row of the port's mesh sits on the
CPU (the one-controller layout, as ``["cuda:0"] * n`` on one card).

- ``reference_loss_fn`` equals JAX's within 2e-5 (rtol and atol), llama
  and the gemma family;
- the pipelined loss equals JAX's reference within 2e-5 at JAX's (pp, dp,
  M) grid and for the gemma family, and JAX's own ``pipelined_loss_fn`` at
  (2, 2, 2) on the conftest's 8 host devices;
- the pipelined gradients equal JAX's reference gradients within rtol
  5e-4, atol 5e-5 (``tests/test_pipeline.py:67``), and repeat bit for bit;
- ``make_train_step`` lowers the loss over 5 steps and keeps each stage's
  leaves and AdamW moments on the stage's device;
- a batch the microbatches do not divide, layers the stages do not divide,
  and a bf16 or quantized tree raise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import ModelConfig as JModelConfig
from cyberfabric_core_tpu.parallel import MeshConfig, build_mesh
from cyberfabric_core_tpu.parallel import pipeline as jpipe
from cyberfabric_core_tpu_torch.models import llama as tllama
from cyberfabric_core_tpu_torch.models.configs import ModelConfig
from cyberfabric_core_tpu_torch.parallel import pipeline as tpipe
from cyberfabric_core_tpu_torch.parallel.mesh import StageMesh
from cyberfabric_core_tpu_torch.runtime.weights import model_from_state_dict, params_from_jax

LOSS_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_TOL = dict(rtol=5e-4, atol=5e-5)

CFG_KW = dict(name="pipe-test", architecture="llama", vocab_size=128, hidden_size=32,
              intermediate_size=64, num_layers=4, num_heads=4, num_kv_heads=2, head_dim=8,
              max_position=64, rope_theta=10000.0)
GEMMA_KW = dict(name="pipe-gemma", tie_embeddings=True, hidden_act="gelu",
                norm_weight_offset=1.0, embedding_multiplier=32.0 ** 0.5,
                final_logit_softcap=30.0)
FAMILIES = {"llama": {}, "gemma": GEMMA_KW}


def _data(B=8, T=16, seed=0):
    ids = np.random.default_rng(seed).integers(0, CFG_KW["vocab_size"], (B, T)).astype(np.int32)
    return ids, np.roll(ids, -1, axis=1)


def _mesh(pp, dp):
    return StageMesh(pp, dp, ["cpu"] * (pp * dp))


@pytest.fixture(scope="module")
def family():
    """Per family: the JAX config, tree and jitted reference loss and grad;
    the port's config and state_dict."""
    out = {}
    for name, extra in FAMILIES.items():
        jcfg = dataclasses.replace(JModelConfig(**CFG_KW), **extra)
        cfg = dataclasses.replace(ModelConfig(**CFG_KW), **extra)
        jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0), jnp.float32)
        loss = jpipe.reference_loss_fn(jcfg)
        out[name] = dict(jcfg=jcfg, jparams=jparams, cfg=cfg, jloss=jax.jit(loss),
                         jgrad=jax.jit(jax.grad(loss)),
                         state=params_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return out


def _model(f):
    return model_from_state_dict(f["state"], f["cfg"], "cpu")


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_reference_loss_matches_jax(family, name):
    f = family[name]
    ids, targets = _data()
    want = f["jloss"](f["jparams"], jnp.asarray(ids), jnp.asarray(targets))
    got = tpipe.reference_loss_fn(f["cfg"])(_model(f), *_t(ids, targets))
    np.testing.assert_allclose(got.item(), np.asarray(want), **LOSS_TOL)


@pytest.mark.parametrize("name,pp,dp,M", [("llama", 2, 1, 4), ("llama", 4, 1, 4),
                                          ("llama", 2, 2, 2), ("llama", 2, 4, 2),
                                          ("gemma", 2, 1, 4)])
def test_pipelined_loss_matches_jax_reference(family, name, pp, dp, M):
    f = family[name]
    ids, targets = _data()
    want = f["jloss"](f["jparams"], jnp.asarray(ids), jnp.asarray(targets))
    got = tpipe.pipelined_loss_fn(f["cfg"], _mesh(pp, dp), M)(_model(f), *_t(ids, targets))
    np.testing.assert_allclose(got.item(), np.asarray(want), **LOSS_TOL)


def test_pipelined_loss_matches_jax_pipeline(family):
    """JAX's own shard_map pipeline at (pp, dp, M) = (2, 2, 2) on 4 of the
    conftest's host devices."""
    f = family["llama"]
    mesh = build_mesh(MeshConfig(dp=2, tp=1, sp=1, ep=1, pp=2), jax.devices()[:4])
    ids, targets = _data(seed=3)
    want = jax.jit(jpipe.pipelined_loss_fn(f["jcfg"], mesh, 2))(
        f["jparams"], jnp.asarray(ids), jnp.asarray(targets))
    got = tpipe.pipelined_loss_fn(f["cfg"], _mesh(2, 2), 2)(_model(f), *_t(ids, targets))
    np.testing.assert_allclose(got.item(), np.asarray(want), **LOSS_TOL)


def _grads(params, loss):
    return dict(zip(params.state_dict(), torch.autograd.grad(loss, list(params.parameters()))))


def test_pipelined_grads_match_jax_reference(family):
    """The autograd backward is the reverse pipeline: every leaf's gradient
    equals JAX's reference gradient, and a second run gives the same bits."""
    f = family["llama"]
    ids, targets = _data(seed=1)
    want = f["jgrad"](f["jparams"], jnp.asarray(ids), jnp.asarray(targets))
    runs = []
    for _ in range(2):
        params = _model(f)
        tpipe.trainable(params)
        loss = tpipe.pipelined_loss_fn(f["cfg"], _mesh(2, 2), 4)(params, *_t(ids, targets))
        runs.append(_grads(params, loss))
    want_state = params_from_jax(jax.tree.map(np.asarray, want), f["cfg"])
    assert set(runs[0]) == set(want_state)
    for key, g in runs[0].items():
        np.testing.assert_allclose(g.numpy(), want_state[key].numpy(), err_msg=key, **GRAD_TOL)
        assert torch.equal(g, runs[1][key]), key


def test_train_step_reduces_loss_and_keeps_stage_placement(family):
    f = family["llama"]
    mesh = _mesh(2, 2)
    ids, targets = _t(*_data(seed=2))
    params = tpipe.place_pipeline_params(_model(f), mesh)
    train_step, init_opt = tpipe.make_train_step(f["cfg"], mesh, num_microbatches=4,
                                                 learning_rate=3e-3)
    opt = init_opt(params)
    losses = []
    for _ in range(5):
        params, opt, loss = train_step(params, opt, ids, targets)
        losses.append(loss.item())
    assert losses[-1] < losses[0], losses
    for p in range(mesh.pp):
        for i in tpipe._stage_layers(f["cfg"], mesh.pp, p):
            for leaf in params.layers[i].parameters():
                moments = opt.state[leaf]
                assert leaf.device == mesh.device(p)
                assert moments["exp_avg"].device == moments["exp_avg_sq"].device == leaf.device
    assert params.embed.device == mesh.device(0)
    assert params.lm_head.device == params.final_norm.device == mesh.device(mesh.pp - 1)


def test_microbatch_count_must_divide_batch(family):
    f = family["llama"]
    ids, targets = _t(*_data())
    with pytest.raises(ValueError, match="microbatches"):
        tpipe.pipelined_loss_fn(f["cfg"], _mesh(2, 1), 3)(_model(f), ids, targets)
    with pytest.raises(ValueError, match="stages"):
        tpipe.pipelined_loss_fn(f["cfg"], _mesh(3, 1), 2)
    with pytest.raises(ValueError, match="devices"):
        StageMesh(2, 2, ["cpu"] * 3)


def test_trainable_takes_only_f32_trees(family):
    cfg = family["llama"]["cfg"]
    params = tllama.init_params(cfg, 0, torch.float32, "cpu")
    assert not any(p.requires_grad for p in params.parameters())
    assert all(p.requires_grad for p in tpipe.trainable(params))
    with pytest.raises(ValueError, match="float32"):
        tpipe.trainable(tllama.init_params(cfg, 0, torch.bfloat16, "cpu"))
    with pytest.raises(ValueError, match="quantized"):
        tpipe.trainable(tllama.init_params(cfg, 0, torch.float32, "cpu", quant_bits=8))
