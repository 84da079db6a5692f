"""The port's toy trainer (``models/toytrain.py``) against the JAX
package's, on the CPU.

- ``markov_sampler``: the same chain and the same batches as JAX's for the
  same seeds, array for array;
- the AdamW step: from the same initial parameters (JAX's ``init_params``
  carried by ``params_from_jax``) and the same Markov batches, the port's
  losses over 5 steps of ``reference_loss_fn`` + ``pipeline.adamw`` equal
  those of JAX's step (``jax.value_and_grad(reference_loss_fn)`` +
  ``optax.adamw``, as ``toytrain.py:81-89`` builds it) within 1e-4
  relative, and every updated leaf equals optax's within rtol 1e-4, atol
  1e-5;
- ``train_lm`` lowers the loss on the CPU, and ``cast_params`` gives a
  frozen bf16 copy of the trained tree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from cyberfabric_core_tpu.models import llama as jllama
from cyberfabric_core_tpu.models import toytrain as jtoy
from cyberfabric_core_tpu.models.configs import get_config as jget_config
from cyberfabric_core_tpu.parallel.pipeline import reference_loss_fn as jreference_loss_fn
from cyberfabric_core_tpu_torch.models import llama as tllama
from cyberfabric_core_tpu_torch.models import toytrain
from cyberfabric_core_tpu_torch.models.configs import get_config
from cyberfabric_core_tpu_torch.parallel.pipeline import adamw, reference_loss_fn, trainable
from cyberfabric_core_tpu_torch.runtime.weights import model_from_state_dict, params_from_jax

LOSS_RTOL = 1e-4
LEAF_TOL = dict(rtol=1e-4, atol=1e-5)
LR = 3e-3
STEPS = 5


@pytest.mark.parametrize("vocab,seed,batch,length", [(512, 1234, 4, 33), (128, 7, 3, 10),
                                                     (512, 0, 1, 32)])
def test_markov_sampler_matches_jax(vocab, seed, batch, length):
    ours = toytrain.markov_sampler(vocab, seed)
    theirs = jtoy.markov_sampler(vocab, seed)
    rng_a, rng_b = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
    for _ in range(2):
        a, b = ours(batch, length, rng_a), theirs(batch, length, rng_b)
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def jax_steps():
    """JAX's toytrain step over 5 Markov batches on tiny-llama from
    PRNGKey(0): the initial tree, the batches, the losses and the final
    tree."""
    cfg = jget_config("tiny-llama")
    params = jllama.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    loss_fn = jreference_loss_fn(cfg)
    tx = optax.adamw(LR)

    @jax.jit
    def step(params, opt_state, ids, targets):
        loss, grads = jax.value_and_grad(loss_fn)(params, ids, targets)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    sample = jtoy.markov_sampler(cfg.vocab_size, seed=1234)
    rng = np.random.default_rng(1235)
    batches = [sample(8, 33, rng) for _ in range(STEPS)]
    initial = jax.tree.map(np.asarray, params)
    opt_state, losses = tx.init(params), []
    for seqs in batches:
        params, opt_state, loss = step(params, opt_state, jnp.asarray(seqs[:, :-1]),
                                       jnp.asarray(seqs[:, 1:]))
        losses.append(float(loss))
    return initial, batches, losses, jax.tree.map(np.asarray, params)


def test_adamw_step_matches_optax(jax_steps):
    initial, batches, want_losses, want_final = jax_steps
    cfg = get_config("tiny-llama")
    params = model_from_state_dict(params_from_jax(initial, cfg), cfg, "cpu")
    opt = adamw(trainable(params), LR)
    loss_fn = reference_loss_fn(cfg)
    losses = []
    for seqs in batches:
        seqs = torch.from_numpy(seqs)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, seqs[:, :-1], seqs[:, 1:])
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, want_losses, rtol=LOSS_RTOL)
    assert losses[-1] < losses[0]
    want = params_from_jax(want_final, cfg)
    for key, leaf in params.state_dict().items():
        np.testing.assert_allclose(leaf.numpy(), want[key].numpy(), err_msg=key, **LEAF_TOL)


def test_train_lm_lowers_loss_and_casts():
    """100 steps at batch 8: the last loss lies a nat below the initial
    tree's loss on the first batch."""
    cfg = get_config("tiny-llama")
    logs = []
    params, loss = toytrain.train_lm(cfg, steps=100, batch=8, seq_len=32, device="cpu",
                                     log=logs.append)
    first = reference_loss_fn(cfg)(tllama.init_params(cfg, 0, torch.float32, "cpu"),
                                   *_first_batch(cfg))
    assert logs == [f"tiny-llama: step 100/100 loss={loss:.3f}"]
    assert loss < first.item() - 1.0, (loss, first.item())
    served = toytrain.cast_params(params, torch.bfloat16)
    assert served.dtype == torch.bfloat16 and served.device == params.device
    assert not any(p.requires_grad for p in served.parameters())
    for key, leaf in served.state_dict().items():
        assert torch.equal(leaf, params.state_dict()[key].to(torch.bfloat16)), key


def _first_batch(cfg):
    seqs = torch.from_numpy(toytrain.markov_sampler(cfg.vocab_size, 1234)(
        8, 33, np.random.default_rng(1235)))
    return seqs[:, :-1], seqs[:, 1:]
