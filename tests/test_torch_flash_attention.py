"""The port's flash self-attention plain version against the JAX Pallas kernel.

The JAX kernel runs in interpret mode, as ``tests/test_flash_attention.py``
runs it; its plain counterpart in ``cyberfabric_core_tpu_torch`` is what the
port's wrapper runs for CPU tensors. Inputs are made with numpy from a seed
and handed to both packages. Tolerance: rtol = atol = 2e-5 on f32 outputs
at positions below each row's length (the JAX kernel's own bar; positions
past the length are undefined there and zeros in the port)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.ops.flash_attention import flash_self_attention as jflash
from cyberfabric_core_tpu_torch.ops import flash_attention as tfa
from cyberfabric_core_tpu_torch.ops.attention import attention_with_cache

TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, B, T, Hq, Hkv, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, T, Hq, D), (B, T, Hkv, D), (B, T, Hkv, D))]


@pytest.mark.parametrize("B,T,Hq,Hkv,D,block_q,block_k,window", [
    (2, 64, 4, 2, 32, 32, 16, None),
    (1, 128, 8, 8, 16, 64, 32, None),   # MHA (G=1)
    (2, 32, 4, 1, 16, 32, 32, None),    # extreme GQA, single kv block
    (1, 128, 2, 1, 32, 32, 64, None),   # bk > bq
    (1, 128, 4, 2, 32, 32, 32, 48),     # sliding window
])
def test_plain_matches_jax_kernel_and_dense_attention(B, T, Hq, Hkv, D, block_q,
                                                       block_k, window):
    q, k, v = _inputs(T + Hq, B, T, Hq, Hkv, D)
    lengths = np.asarray([T, max(1, T - 13)][:B], np.int32)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             jnp.asarray(lengths), block_q=block_q, block_k=block_k,
                             interpret=True, sliding_window=window))
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lengths))
    got = tfa.flash_self_attention(tq, tk, tv, tl, block_q=block_q, block_k=block_k,
                                   sliding_window=window).numpy()
    pos = torch.arange(T)[None].expand(B, T)
    dense = attention_with_cache(tq, tk, tv, pos, tl, sliding_window=window).numpy()
    for b in range(B):
        L = int(lengths[b])
        np.testing.assert_allclose(got[b, :L], want[b, :L], **TOL)
        np.testing.assert_allclose(got[b, :L], dense[b, :L], **TOL)
        assert (got[b, L:] == 0).all()


def test_plain_bf16_is_the_f32_computation_rounded_once():
    """bf16 inputs go through the same float64 arithmetic as f32 ones: the
    bf16 output equals the f32-input output rounded to bf16."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(7, 1, 40, 4, 2, 128))
    lengths = torch.tensor([33], dtype=torch.int32)
    out = tfa.flash_self_attention_plain(q, k, v, lengths)
    ref = tfa.flash_self_attention_plain(q.float(), k.float(), v.float(), lengths)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out, ref.to(torch.bfloat16))


def test_block_normalization_follows_the_jax_kernel():
    assert tfa._block(512, 2048) == 512
    assert tfa._block(512, 128) == 128
    assert tfa._block(256, 384) == 128   # 256 does not divide 384
    assert tfa._block(100, 256) == 64    # rounded down to a power of two


def test_wrapper_counts_no_launch_on_the_cpu():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 1, 16, 2, 1, 8))
    before = tfa.flash_self_attention.launches
    tfa.flash_self_attention(q, k, v, torch.tensor([16], dtype=torch.int32))
    assert tfa.flash_self_attention.launches == before
    assert tfa.flash_available() == torch.cuda.is_available()


@pytest.mark.parametrize("head_dim,Hq,Hkv,dtype,bad", [
    (128, 32, 8, torch.bfloat16, None),        # llama-3-8b
    (96, 32, 32, torch.bfloat16, "head_dim"),  # phi-3-mini
    (128, 12, 4, torch.bfloat16, "query heads per kv head"),
    (128, 32, 8, torch.float32, "bfloat16"),
])
def test_kernel_support_check_names_what_it_refuses(head_dim, Hq, Hkv, dtype, bad):
    """What a CUDA engine checks once at build: a model the kernel cannot
    take raises before any prompt reaches the kernel."""
    if bad is None:
        tfa.check_kernel_supports(head_dim, Hq, Hkv, dtype)
    else:
        with pytest.raises(ValueError, match=bad):
            tfa.check_kernel_supports(head_dim, Hq, Hkv, dtype)
