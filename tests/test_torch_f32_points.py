"""The port keeps f32 where the JAX package does, at bf16.

Three points of the llama forward take an f32 product in JAX
(``preferred_element_type=jnp.float32``) and work on it before one cast:
the logits (``lm_head_logits``), ``act(gate) * up`` in the MLP, and the
qwen2 q/k/v bias. The port computes the same f32 products (bf16 operands, f32
accumulation and result) and rounds where JAX rounds. Weights come from the
JAX package's ``init_params`` in bf16 (tiny-qwen2: biased q/k/v, tied head),
inputs from numpy with a seed; both packages' functions run on them.

Tolerance, derived from the two sides' rounding. Each side sums a K-term f32
product in its own order, so each lies within gamma_K * S of the exact
(float64) value, gamma_K = K u / (1 - K u), u = 2^-24, S = sum |x_i w_i|:
the two differ by at most 2 gamma_K S. That is the whole tolerance of the
f32 logits. A value rounded to bf16 once on each side is equal on both sides
unless an f32 error bound E around the exact value holds a bf16 rounding
midpoint; there a one-ulp difference is allowed, and everywhere else the
bits must be equal. For the bias, E = gamma_K S + u |z| (the f32 add); for
the MLP's ``act = silu(g) * u_`` the errors of g and u_ carry through the
derivatives, plus 16 u |act| for silu's own f32 arithmetic and the product.
The parent's rounding (products cast to bf16 before the bias, before
``act``, before the logits' f32 widening) lies outside these bounds at most
elements; each test checks that at its inputs, so it cannot pass vacuously.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu_torch.models import llama as tllama
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.ops.rope import rope_frequencies
from cyberfabric_core_tpu_torch.runtime.weights import model_from_state_dict, params_from_jax

U = 2.0 ** -24


def _gamma(k: int) -> float:
    return k * U / (1 - k * U)


@pytest.fixture(scope="module")
def models():
    jcfg, cfg = jget_config("tiny-qwen2"), get_config("tiny-qwen2")
    assert cfg.attention_bias and cfg.tie_embeddings
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3), jnp.bfloat16)
    tree = jax.tree.map(lambda a: np.asarray(a, np.float32), jparams)
    tparams = model_from_state_dict(params_from_jax(tree, cfg), cfg, device="cpu",
                                    dtype=torch.bfloat16)
    return jcfg, jparams, cfg, tparams


def _bf16(rng, shape, scale=1.0):
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32)
                            ).to(torch.bfloat16)


def _jnp(t: torch.Tensor):
    return jnp.asarray(t.float().numpy(), jnp.bfloat16)


def _np(a) -> torch.Tensor:
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32)))


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.float().to(torch.bfloat16).double()


def _rounded_within(got: torch.Tensor, want: torch.Tensor, exact: torch.Tensor,
                    err: torch.Tensor, ulps: int = 1) -> torch.Tensor:
    """Per element: ``got`` agrees with ``want`` as two bf16 roundings of f32
    values within ``err`` of ``exact`` can: equal, or ``ulps`` ulps apart at
    most where a rounding midpoint lies within ``err`` of ``exact``."""
    g, w = got.double(), want.double()
    may_flip = _round_bf16(exact - err) != _round_bf16(exact + err)
    ulp = torch.exp2(torch.floor(torch.log2(torch.maximum(g.abs(), w.abs())
                                            .clamp_min(2.0 ** -126))) - 7)
    return (g == w) | (may_flip & ((g - w).abs() <= ulps * ulp))


def test_logits_are_the_f32_product(models):
    jcfg, jparams, cfg, tparams = models
    hidden = _bf16(np.random.default_rng(0), (6, cfg.hidden_size))
    got = tllama.lm_head_logits(tparams, cfg, hidden)
    want = _np(jllama.lm_head_logits(jparams, jcfg, _jnp(hidden)))
    assert got.dtype == torch.float32
    head = tparams.embed.double().t()
    S = hidden.double().abs() @ head.abs()
    tol = 2 * _gamma(cfg.hidden_size) * S
    diff = (got.double() - want.double()).abs()
    assert bool((diff <= tol).all()), float((diff - tol).max())
    # the parent's logits: the bf16 product widened to f32
    parent = (hidden @ tparams.embed.t()).float().double()
    assert float(((parent - want.double()).abs() > tol).float().mean()) > 0.5


def test_mlp_rounds_act_once_from_f32_gate_and_up(models):
    """``down`` set to 2^24 times a selection of the first H intermediate
    channels: the layer's output is then ``h + 2^24 act``, each act exact in
    the product, and a unit-scale residual ``h`` (so the norm's variance is
    far above eps) lies below half an ulp of the sum wherever act is not
    tiny. Equal acts give equal outputs on both sides (the same bf16 add); a
    one-ulp act flip moves the output by at most two of its ulps."""
    jcfg, jparams, cfg, tparams = models
    H, I = cfg.hidden_size, cfg.intermediate_size
    rng = np.random.default_rng(1)
    h = _bf16(rng, (2, 5, H))
    sel = torch.zeros((I, H), dtype=torch.bfloat16)
    sel[torch.arange(H), torch.arange(H)] = 2.0 ** 24
    lp = tparams.layers[0]
    jlp = {name: leaf[0] for name, leaf in jparams["layers"].items()}
    jlp["down"] = _jnp(sel)
    down = lp.down.data
    lp.down.data = sel
    try:
        got = tllama._mlp_residual(lp, h, cfg)
    finally:
        lp.down.data = down
    want = _np(jllama._mlp_residual(jlp, _jnp(h), jcfg))

    x = tllama.rms_norm(h, lp.mlp_norm, cfg.rms_norm_eps, cfg.norm_weight_offset)
    jx = _np(jllama.rms_norm(_jnp(h), jlp["mlp_norm"], jcfg.rms_norm_eps,
                             jcfg.norm_weight_offset))
    assert torch.equal(x.float(), jx), "the two norms must hand the MLP the same x"
    xd, wg, wu = x.double(), lp.gate.double(), lp.up.double()
    g, u_ = xd @ wg, xd @ wu
    sg, su = xd.abs() @ wg.abs(), xd.abs() @ wu.abs()
    sig = torch.sigmoid(g)
    silu = g * sig
    dsilu = sig * (1 + g * (1 - sig))
    act = (silu * u_)[..., :H]
    gam = _gamma(H)
    err = ((dsilu * u_.abs() * gam * sg + silu.abs() * gam * su)[..., :H]
           + 16 * U * act.abs())
    ok = _rounded_within(got, want, act, err, ulps=2)
    assert bool(ok.all()), f"{int((~ok).sum())} of {ok.numel()} elements"
    # the parent's act: gate and up rounded to bf16 first
    gb, ub = _round_bf16(g), _round_bf16(u_)
    parent = _round_bf16(h.double() + 2.0 ** 24 * _round_bf16(
        (gb * torch.sigmoid(gb) * ub)[..., :H]))
    assert float((~_rounded_within(parent, want, act, err, ulps=2)).float().mean()) > 0.2


def test_qkv_bias_is_added_in_f32(models):
    """Position 0 (rope there is the identity), so q, k and v are the biased
    projections rounded once."""
    jcfg, jparams, cfg, tparams = models
    B, T = 2, 3
    rng = np.random.default_rng(2)
    x = _bf16(rng, (B, T, cfg.hidden_size))
    pos = torch.zeros((B, T), dtype=torch.int32)
    cos_t, sin_t = rope_frequencies(cfg.head_dim, 8, cfg.rope_theta, device="cpu")
    lp = tparams.layers[0]
    jlp = {name: leaf[0] for name, leaf in jparams["layers"].items()}
    got = tllama._qkv_proj(lp, x, cfg, pos, cos_t, sin_t)
    want = jllama._qkv_proj(jlp, _jnp(x), jcfg, jnp.zeros((B, T), jnp.int32),
                            jnp.asarray(cos_t.numpy()), jnp.asarray(sin_t.numpy()))
    gam = _gamma(cfg.hidden_size)
    caught = []
    for t, w, (wm, bias) in zip(got, want, ((lp.wq, lp.bq), (lp.wk, lp.bk), (lp.wv, lp.bv))):
        z = x.double() @ wm.double() + bias.double()
        err = gam * (x.double().abs() @ wm.double().abs()) + U * z.abs()
        z, err = (a.reshape(t.shape) for a in (z, err))
        ok = _rounded_within(t, _np(w), z, err)
        assert bool(ok.all()), f"{int((~ok).sum())} of {ok.numel()} elements"
        # the parent's: the projection rounded to bf16, then the bias added in bf16
        parent = _round_bf16(_round_bf16(x.double() @ wm.double()).reshape(t.shape)
                             + bias.double().reshape(t.shape[-2:]))
        caught.append(float((~_rounded_within(parent, _np(w), z, err)).float().mean()))
    assert min(caught) > 0.05, caught


def test_f32_weights_take_the_plain_product():
    """In f32 nothing is widened: the helper is the plain product."""
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
            for s in ((3, 4, 8), (8, 5)))
    assert torch.equal(tllama._mm_f32(x, w), x @ w)
    got = tllama._mm_f32(x.to(torch.bfloat16), w.to(torch.bfloat16))
    assert got.dtype == torch.float32 and got.shape == (3, 4, 5)
    want = x.to(torch.bfloat16).double() @ w.to(torch.bfloat16).double()
    assert float((got.double() - want).abs().max()) <= 2 * _gamma(8) * float(
        (x.to(torch.bfloat16).double().abs() @ w.to(torch.bfloat16).double().abs()).max())


def test_fixture_config_is_the_registrys_in_both_packages(models):
    """The fixture's config is the registry's tiny-qwen2 in both packages."""
    jcfg, _, cfg, _ = models
    assert {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)} == \
        {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
