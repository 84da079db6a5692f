"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's and against plain causal attention, on the CPU.

JAX's two cases (``tests/test_ring_attention.py:13-48``), inputs from numpy
seeds, every ring rank on the CPU: the port's output equals the port's
plain ``attention_with_cache`` and JAX's ``ring_attention`` (on the
conftest's host devices) within rtol = atol = 2e-5, with and without
``lengths`` (rows past a length are not compared, as in JAX's test); its q,
k and v gradients equal the plain attention's within the same tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.parallel import MeshConfig, build_mesh
from cyberfabric_core_tpu.parallel.ring_attention import ring_attention as jring
from cyberfabric_core_tpu_torch.ops.attention import attention_with_cache
from cyberfabric_core_tpu_torch.parallel.ring_attention import ring_attention

TOL = dict(rtol=2e-5, atol=2e-5)
CASES = [(8, 2, 64, 4, 2, 16, None), (4, 1, 128, 8, 8, 32, None),
         (8, 2, 64, 4, 2, 16, (64, 40))]


@pytest.fixture(scope="module")
def jax_ring():
    """JAX's ring_attention under one jit for the module (its shard_map
    runs op by op otherwise)."""
    return jax.jit(jring, static_argnames=("mesh", "axis"))


def _qkv(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, T, h, D)).astype(np.float32) for h in (Hq, Hkv, Hkv))


def _plain(q, k, v, lengths):
    B, T = q.shape[:2]
    positions = torch.arange(T, dtype=torch.int32)[None].expand(B, T)
    lens = torch.full((B,), T, dtype=torch.int32) if lengths is None else lengths
    return attention_with_cache(q, k, v, positions, lens)


def _rows(out, lengths):
    """Each row's valid positions (all of them without lengths)."""
    return [out[b, :T] for b, T in enumerate(lengths or [out.shape[1]] * out.shape[0])]


@pytest.mark.parametrize("sp,B,T,Hq,Hkv,D,lengths", CASES)
def test_ring_matches_plain_and_jax(jax_ring, sp, B, T, Hq, Hkv, D, lengths):
    q, k, v = _qkv(B, T, Hq, Hkv, D, seed=sp + T)
    lens = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ring_attention(tq, tk, tv, ["cpu"] * sp, lengths=lens)
    ref = _plain(tq, tk, tv, lens)

    mesh = build_mesh(MeshConfig(dp=1, tp=8 // sp, sp=sp))
    jout = np.asarray(jax_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mesh=mesh,
                               axis="sp",
                               lengths=None if lengths is None else jnp.asarray(lengths)))
    for got, want, jwant in zip(_rows(out, lengths), _rows(ref, lengths), _rows(jout, lengths)):
        np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), **TOL)
        np.testing.assert_allclose(got.detach().numpy(), jwant, **TOL)

    # gradients of a loss over the valid rows
    w = torch.from_numpy(np.random.default_rng(1).standard_normal(out.shape).astype(np.float32))
    if lengths is not None:
        w = w * (torch.arange(T)[None, :] < lens[:, None])[..., None, None]
    grads = torch.autograd.grad((out * w).sum(), (tq, tk, tv))
    ref_grads = torch.autograd.grad((ref * w).sum(), (tq, tk, tv))
    for name, g, r in zip("qkv", grads, ref_grads):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), r.numpy(), err_msg=name, **TOL)


def test_ring_needs_equal_blocks():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 30, 4, 2, 16, seed=0))
    with pytest.raises(ValueError, match="ring ranks"):
        ring_attention(q, k, v, ["cpu"] * 4)
