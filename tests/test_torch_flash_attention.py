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
    (1, 64, 7, 1, 16, 32, 16, None),    # G=7 (qwen2-7b's group)
    (2, 64, 2, 2, 96, 32, 32, None),    # D=96 (phi-3-mini)
    (1, 64, 2, 1, 256, 32, 32, 20),     # D=256 (gemma-7b), window
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
    (96, 32, 32, torch.bfloat16, None),        # phi-3-mini
    (128, 28, 4, torch.bfloat16, None),        # qwen2-7b: G=7
    (256, 16, 16, torch.bfloat16, None),       # gemma-7b
    (16, 4, 2, torch.float32, None),           # tiny-llama at dtype float32
    (32, 4, 2, torch.bfloat16, "head_dim"),
    (128, 36, 4, torch.bfloat16, "query heads per kv head"),   # G=9
    (128, 32, 8, torch.float16, "bfloat16 or float32"),
])
def test_kernel_support_check_names_what_it_refuses(head_dim, Hq, Hkv, dtype, bad):
    """What a CUDA engine checks once at build: a model the kernel cannot
    take raises before any prompt reaches the kernel."""
    if bad is None:
        tfa.check_kernel_supports(head_dim, Hq, Hkv, dtype)
    else:
        with pytest.raises(ValueError, match=bad):
            tfa.check_kernel_supports(head_dim, Hq, Hkv, dtype)


def _p_rounding_bound(q, k, v, lengths, window):
    """Per element of the output, in float64 from the bf16 inputs: the most
    that rounding each softmax weight p to bf16 (relative error at most
    2^-8) can move it, 2^-8 * sum_j p_j |v_j| / l, with l = sum_j p_j; the
    float64 output itself rides along. [B, T, Hq, D] each."""
    B, T, Hq, D = q.shape
    G = Hq // k.shape[2]
    qd = q.double().permute(0, 2, 1, 3)                                  # [B,Hq,T,D]
    kd = k.double().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    vd = v.double().repeat_interleave(G, dim=2).permute(0, 2, 1, 3)
    pos = torch.arange(T)
    mask = (pos[None, :] <= pos[:, None])[None] & (pos[None, None, :] < lengths[:, None, None])
    if window is not None:
        mask = mask & (pos[None, :] > pos[:, None] - window)[None]
    s = torch.where(mask[:, None], qd @ kd.transpose(-1, -2) / D ** 0.5, -torch.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True)).nan_to_num(0.0)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    bound = 2.0 ** -8 * (p @ vd.abs()) / l
    exact = (p @ vd) / l
    return bound.permute(0, 2, 1, 3), exact.permute(0, 2, 1, 3)


def _bf16_ulp(x):
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -20))) - 7)


@pytest.mark.parametrize("lengths,window", [([250], None), ([256, 97], 40)])
def test_bf16_port_matches_jax_kernel_within_its_p_rounding(lengths, window):
    """bf16 inputs, D = 128 (the CUDA kernel's head dim): the JAX kernel casts
    P to bf16 before P.V (``p.astype(v.dtype)``, flash_attention.py:113); the
    port keeps P exact, because its own gate holds the CUDA kernel within one
    bf16 ulp of a float64 plain version. So the two may differ, at each
    position below the length, by one bf16 ulp of the output (the two final
    roundings) plus what rounding P to bf16 can move it:
    tol = ulp + 2^-8 * sum_j p_j |v_j| / l. The port stays within one bf16
    ulp of the float64 value; the JAX kernel need not (ROADMAP section 3)."""
    B, T, Hq, Hkv, D = len(lengths), 256, 4, 2, 128
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _inputs(11 + B, B, T, Hq, Hkv, D))
    lens = torch.tensor(lengths, dtype=torch.int32)
    jq, jk, jv = (jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, jnp.asarray(lengths, jnp.int32), interpret=True,
                             sliding_window=window).astype(jnp.float32))
    want = torch.from_numpy(np.array(want))
    got = tfa.flash_self_attention(q, k, v, lens, sliding_window=window)
    assert got.dtype == torch.bfloat16
    bound, exact = _p_rounding_bound(q, k, v, lens, window)
    beyond_ulp, n, max_diff, worst = 0, 0, 0.0, (0.0, None)
    for b, L in enumerate(lengths):
        g, w = got[b, :L].float(), want[b, :L]
        ulp = _bf16_ulp(torch.maximum(g.abs(), w.abs()))
        tol = ulp + bound[b, :L].float()
        assert bool(((g - w).abs() <= tol).all()), float(((g - w).abs() - tol).max())
        assert bool(((g.double() - exact[b, :L]).abs() <= _bf16_ulp(exact[b, :L])).all())
        beyond_ulp += int(((g - w).abs() > ulp).sum())
        n += g.numel()
        max_diff = max(max_diff, float((g - w).abs().max()))
        ulps = (g - w).abs() / ulp
        i = int(ulps.argmax())
        if float(ulps.flatten()[i]) > worst[0]:
            worst = (float(ulps.flatten()[i]), (float(w.flatten()[i]), float(g.flatten()[i]),
                                                 float(tol.flatten()[i])))
        assert (got[b, L:] == 0).all()
    print(f"bf16 JAX kernel vs port: {beyond_ulp} of {n} elements beyond one bf16 ulp, "
          f"max abs diff {max_diff:.3e}; worst in ulps "
          f"{worst[0]:.0f}: JAX {worst[1][0]:.6e}, port {worst[1][1]:.6e}, tol {worst[1][2]:.3e}")
    # the departure is real at these inputs: the test pins it, not its absence
    assert beyond_ulp > 0


def test_sweep_counts_elements_beyond_the_one_ulp_bar():
    """ops/flash_sweep.py's count, on the CPU: a final rounding that fell
    the other way differs but stays within the bar; two ulps or a NaN miss."""
    from cyberfabric_core_tpu_torch.ops.flash_sweep import misses

    ref = torch.tensor([1.0, 1.0, -0.5, 3e-7, 2.0], dtype=torch.bfloat16)
    out = ref.clone()
    assert misses(out, ref) == (0, 0)
    out[0] = 1.0078125                          # one ulp above 1.0
    out[2] = -0.5 - 2 * 2.0 ** -8               # two ulps of 0.5
    out[3] = float("nan")
    assert misses(out, ref) == (2, 3)


def test_sweep_reads_the_main_loop_out_of_the_kernels_sass(monkeypatch):
    """ops/flash_sweep.py's static instruction mix, on the CPU from a made-up
    listing: the shortest backward branch whose body holds both products'
    wgmma is the main loop; a wider one (an out-of-line retry branching
    back) is not."""
    import subprocess
    import types

    from cyberfabric_core_tpu_torch.ops import _build, flash_sweep

    sass = "\n".join([
        "        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ ;",
        "        /*0110*/                   FADD R1, R2, R3 ;",
        "        /*0120*/                   HGMMA.64x64x16.F32.BF16 R88, gdesc[UR4], RZ ;",
        "        /*0130*/                   HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR4] ;",
        "        /*0140*/                   MUFU.EX2 R5, R6 ;",
        "        /*0150*/              @!P0 BRA 0x120 ;",
        "        /*0160*/                   HGMMA.64x128x16.F32.BF16 R24, R152, gdesc[UR4] ;",
        "        /*0170*/                   EXIT ;",
        "        /*0180*/                   BRA 0x100 ;",
    ])
    monkeypatch.setattr(_build, "_nvcc", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: types.SimpleNamespace(stdout=sass))
    mix = flash_sweep.loop_mix(flash_sweep.Path("lib.so"))
    assert mix.startswith("main loop 4 instructions")
    assert "MUFU.EX2 1" in mix and "FADD" not in mix
