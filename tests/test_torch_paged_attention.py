"""The port's paged-attention plain versions against the JAX Pallas kernels.

The JAX kernels run in interpret mode, as the JAX package's own tests run
them; their plain counterparts in ``cyberfabric_core_tpu_torch`` are what the
port's wrappers run for CPU tensors. Inputs are made with numpy from a seed
and handed to both packages. Tolerance: rtol = atol = 1e-5 on f32 outputs
(same online-softmax algorithm, summation order may differ)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.ops import attention as jattn
from cyberfabric_core_tpu.ops import paged_attention as jpa
from cyberfabric_core_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _pools(seed, N, page, Hkv, D):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((N, page, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((N, page, Hkv, D)).astype(np.float32)
    return k, v


def _table(seed, B, Pmax, N, share_first=False):
    rng = np.random.default_rng(seed + 1)
    ids = rng.permutation(N - 1)[: B * Pmax] + 1
    pt = ids.reshape(B, Pmax).astype(np.int32)
    if share_first:  # rows 0 and 1 alias their first two pages (prefix sharing)
        pt[1, :2] = pt[0, :2]
    return pt


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# (B, Hq, Hkv, D, page, Pmax, window, lengths): GQA G=2 with a page crossing,
# and a windowed case with shared pages; then lengths on either side of a
# 4-page boundary (where the card's decode path splits at page 8) under a
# window that leaves the first split empty
DECODE_CASES = [
    (3, 4, 2, 16, 8, 4, None, [1, 9, 30]),
    (3, 4, 2, 16, 8, 5, 11, [5, 17, 40]),
    (3, 4, 2, 16, 8, 6, 9, [31, 32, 33]),
    # the other head dims and groups the card's kernels are built for:
    # qwen2-7b's G=7, phi-3-mini's D=96, gemma-7b's D=256 (with a window)
    (2, 7, 1, 16, 8, 4, None, [9, 30]),
    (2, 2, 2, 96, 8, 3, None, [5, 20]),
    (2, 2, 1, 256, 8, 3, 7, [12, 24]),
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_plain_matches_jax_kernel(case):
    B, Hq, Hkv, D, page, Pmax, window, lengths = case
    N = B * Pmax + 2
    k, v = _pools(0, N, page, Hkv, D)
    pt = _table(0, B, Pmax, N, share_first=window is not None)
    q = np.random.default_rng(2).standard_normal((B, Hq, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    ref = jpa.paged_decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     jnp.asarray(pt), jnp.asarray(lens),
                                     interpret=True, sliding_window=window)
    out = tpa.paged_decode_attention(*_t(q, k, v, pt, lens), sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


# (B, Qmax, Hq, Hkv, D, page, Pmax, window, hist, q_lens): an idle row, a
# chunk crossing pages, a decode row; then a window with aliased pages; then
# spans on both sides of the card's short-span route (q_len <= 8 decodes
# position by position, longer spans take the chunk path), without and with
# a window
RAGGED_CASES = [
    (4, 16, 4, 2, 16, 8, 5, None, [0, 5, 20, 7], [0, 13, 1, 16]),
    (3, 8, 4, 2, 16, 8, 6, 6, [9, 0, 30], [8, 3, 1]),
    (5, 24, 4, 2, 16, 8, 8, None, [0, 10, 20, 31, 40], [1, 3, 8, 9, 17]),
    (5, 24, 4, 2, 16, 8, 8, 13, [0, 10, 20, 31, 40], [1, 3, 8, 9, 17]),
    # G=7, D=96 and D=256 (with a window), short spans and chunks
    (3, 16, 7, 1, 16, 8, 5, None, [0, 9, 20], [13, 1, 9]),
    (2, 16, 2, 2, 96, 8, 4, None, [3, 12], [12, 1]),
    (2, 16, 2, 1, 256, 8, 4, 9, [4, 10], [16, 2]),
]


@pytest.mark.parametrize("case", RAGGED_CASES)
def test_ragged_plain_matches_jax_kernel(case):
    B, Qmax, Hq, Hkv, D, page, Pmax, window, hist, q_lens = case
    N = B * Pmax + 2
    k, v = _pools(1, N, page, Hkv, D)
    pt = _table(1, B, Pmax, N, share_first=window is not None)
    q = np.random.default_rng(3).standard_normal((B, Qmax, Hq, D)).astype(np.float32)
    hist, q_lens = np.asarray(hist, np.int32), np.asarray(q_lens, np.int32)
    ref = jpa.ragged_paged_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt),
        jnp.asarray(hist), jnp.asarray(q_lens), interpret=True,
        sliding_window=window)
    out = tpa.ragged_paged_attention(*_t(q, k, v, pt, hist, q_lens),
                                     sliding_window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def _dense_rows(q, k, v, pt, hist, q_lens, window):
    """JAX's dense oracle per row: paged_gather_dense + attention_with_cache."""
    kd, vd = jpa.paged_gather_dense(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt))
    Qmax = q.shape[1]
    pos = jnp.asarray(hist[:, None] + np.arange(Qmax, dtype=np.int32)[None])
    out = jattn.attention_with_cache(jnp.asarray(q), kd, vd, pos,
                                     jnp.asarray(hist + q_lens),
                                     sliding_window=window)
    return np.asarray(out)  # rows past q_len are not compared


# two fixed geometries (G=4 with one kv head and 4-token pages; G=2 with two
# kv heads and 8-token pages): the data, spans and windows vary by seed, the
# shapes do not, so the JAX oracle compiles once per geometry
SWEEP_SHAPES = [(2, 16, 4, 1, 4, 6), (3, 8, 4, 2, 8, 4)]


@pytest.mark.parametrize("shape", range(len(SWEEP_SHAPES)))
@pytest.mark.parametrize("seed", range(3))
def test_ragged_plain_sweep_against_dense_oracle(shape, seed):
    """Random spans, histories, idle rows and windows against the JAX dense
    path. rtol = atol = 1e-5 (online vs one-shot softmax in f32)."""
    B, Qmax, Hq, Hkv, page, Pmax = SWEEP_SHAPES[shape]
    D = 16
    rng = np.random.default_rng(100 + 10 * shape + seed)
    window = None if seed == 0 else int(rng.integers(2, 20))
    N = B * Pmax + 3
    k, v = _pools(seed, N, page, Hkv, D)
    pt = _table(seed, B, Pmax, N)
    q_lens = rng.integers(0, Qmax + 1, B).astype(np.int32)
    hist = np.asarray([rng.integers(0, Pmax * page - ql + 1) for ql in q_lens],
                      np.int32)
    q = rng.standard_normal((B, Qmax, Hq, D)).astype(np.float32)
    ref = _dense_rows(q, k, v, pt, hist, q_lens, window)
    out = tpa.ragged_paged_attention(*_t(q, k, v, pt, hist, q_lens),
                                     sliding_window=window).numpy()
    for b in range(B):
        ql = int(q_lens[b])
        np.testing.assert_allclose(out[b, :ql], ref[b, :ql], **TOL)


def test_ragged_padding_rows_are_exact_zeros():
    B, Qmax, Hq, Hkv, D, page, Pmax = 3, 16, 4, 2, 16, 8, 4
    N = B * Pmax + 1
    k, v = _pools(5, N, page, Hkv, D)
    pt = _table(5, B, Pmax, N)
    q = np.random.default_rng(6).standard_normal((B, Qmax, Hq, D)).astype(np.float32)
    hist = np.asarray([3, 0, 10], np.int32)
    q_lens = np.asarray([5, 0, 9], np.int32)
    out = tpa.ragged_paged_attention(*_t(q, k, v, pt, hist, q_lens)).numpy()
    assert np.isfinite(out).all()
    for b in range(B):
        assert (out[b, q_lens[b]:] == 0.0).all()


@pytest.mark.parametrize("window", [None, 7])
def test_ragged_q_len_one_is_bitwise_decode(window):
    """A decode row's value cannot depend on whether its round was mixed or
    pure decode: ragged at q_len=1 equals decode exactly (torch.equal)."""
    B, Hq, Hkv, D, page, Pmax = 4, 4, 2, 16, 8, 6
    N = B * Pmax + 2
    k, v = _pools(7, N, page, Hkv, D)
    pt = _table(7, B, Pmax, N)
    q1 = np.random.default_rng(8).standard_normal((B, Hq, D)).astype(np.float32)
    hist = np.asarray([0, 9, 33, 45], np.int32)
    q = np.zeros((B, 8, Hq, D), np.float32)
    q[:, 0] = q1
    kt, vt, ptt = _t(k, v, pt)
    dec = tpa.paged_decode_attention(torch.from_numpy(q1), kt, vt, ptt,
                                     torch.from_numpy(hist + 1),
                                     sliding_window=window)
    rag = tpa.ragged_paged_attention(torch.from_numpy(q), kt, vt, ptt,
                                     torch.from_numpy(hist),
                                     torch.ones(B, dtype=torch.int32),
                                     sliding_window=window)
    assert torch.equal(rag[:, 0], dec)


@pytest.mark.parametrize("window", [None, 5])
def test_ragged_short_span_positions_are_bitwise_decode(window):
    """Each position hist+i of a span decodes as its token alone would:
    ragged row i equals decode at length hist+i+1 exactly (the card keeps
    this for spans of up to SHORT_SPAN positions by routing them through the
    decode path)."""
    B, Hq, Hkv, D, page, Pmax = 3, 4, 2, 16, 8, 6
    N = B * Pmax + 2
    k, v = _pools(11, N, page, Hkv, D)
    pt = _table(11, B, Pmax, N)
    q = np.random.default_rng(12).standard_normal((B, 8, Hq, D)).astype(np.float32)
    hist = np.asarray([0, 13, 30], np.int32)
    q_lens = np.asarray([2, 5, tpa.SHORT_SPAN], np.int32)
    kt, vt, ptt = _t(k, v, pt)
    rag = tpa.ragged_paged_attention(torch.from_numpy(q), kt, vt, ptt,
                                     torch.from_numpy(hist), torch.from_numpy(q_lens),
                                     sliding_window=window)
    for i in range(tpa.SHORT_SPAN):
        rows = [b for b in range(B) if i < q_lens[b]]
        dec = tpa.paged_decode_attention(
            torch.from_numpy(q[rows, i]), kt, vt, ptt[rows],
            torch.from_numpy(hist[rows] + i + 1), sliding_window=window)
        assert torch.equal(rag[rows, i], dec)


def test_paged_gather_dense_matches_jax():
    N, page, Hkv, D, B, Pmax = 9, 4, 2, 8, 2, 3
    k, v = _pools(9, N, page, Hkv, D)
    pt = _table(9, B, Pmax, N)
    jk, jv = jpa.paged_gather_dense(jnp.asarray(k), jnp.asarray(v), jnp.asarray(pt))
    tk, tv = tpa.paged_gather_dense(*_t(k, v, pt))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_wrappers_count_no_launch_on_cpu():
    """CPU tensors run the plain version; the launch counters only count
    kernel launches."""
    before = (tpa.paged_decode_attention.launches,
              tpa.ragged_paged_attention.launches)
    k, v = _pools(10, 5, 4, 1, 8)
    pt = np.asarray([[1, 2]], np.int32)
    tpa.paged_decode_attention(torch.zeros(1, 2, 8), *_t(k, v, pt),
                               torch.tensor([3], dtype=torch.int32))
    assert (tpa.paged_decode_attention.launches,
            tpa.ragged_paged_attention.launches) == before


def test_kernel_checks_take_every_llama_config_of_the_registry():
    """What a CUDA engine checks at build: every llama-family config of the
    registry (head dims 16, 96, 128 and 256; G 1, 2, 4, 7 and 8) in bf16 and
    f32 passes both kernels' checks; what the kernels do not take raises."""
    from cyberfabric_core_tpu_torch.models.configs import MODEL_CONFIGS
    from cyberfabric_core_tpu_torch.ops import flash_attention as tfa

    checked = set()
    for cfg in MODEL_CONFIGS.values():
        if cfg.architecture != "llama" or cfg.num_experts:
            continue
        for dtype in (torch.bfloat16, torch.float32):
            tpa.check_kernel_supports(cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
                                      dtype, 64)
            tfa.check_kernel_supports(cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, dtype)
        checked.add((cfg.head_dim, cfg.num_heads // cfg.num_kv_heads))
    assert {d for d, _ in checked} == {16, 96, 128, 256}
    assert {g for _, g in checked} == {1, 2, 4, 7, 8}
    for args, what in [((32, 4, 2, torch.bfloat16, 16), "head_dim"),
                       ((128, 36, 4, torch.bfloat16, 16), "groups of at most"),
                       ((128, 32, 8, torch.bfloat16, 128), "page size"),
                       ((128, 32, 8, torch.float16, 16), "bfloat16 or float32")]:
        with pytest.raises(ValueError, match=what):
            tpa.check_kernel_supports(*args)
