"""Toy LM training: a Markov corpus and an AdamW loop (counterpart of
``models/toytrain.py``).

It trains the tiny draft/target pairs that draft-model speculation needs
to be measured in its real regime: an 8-layer target and an independent
2-layer draft trained on one synthetic language predict overlapping but
different distributions, so acceptance lands strictly between 0 and 100%
(a random draft accepts ~nothing, the target drafting for itself
everything).

The corpus is a first-order Markov chain over the tiny vocabulary:
structure enough to learn in seconds, randomness enough that sampling at
temperature > 0 rejects drafts. :func:`markov_sampler` is the JAX
package's numpy code as it is, so both packages draw the same batches from
the same seeds."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..device import DeviceLike, resolve_device, to_device
from . import llama
from .configs import ModelConfig


def markov_sampler(vocab_size: int, seed: int, branch: int = 4,
                   skew: tuple[float, ...] = (0.55, 0.25, 0.15, 0.05)
                   ) -> Callable[[int, int, np.random.Generator], np.ndarray]:
    """A fixed random Markov chain: every token has ``branch`` successors with
    probabilities ``skew``. Returns sample(batch, length, rng) -> int32 ids.

    The chain is a function of ``seed`` alone — draft and target train on the
    SAME language while their parameter seeds differ.
    """
    chain_rng = np.random.default_rng(seed)
    successors = np.stack([
        chain_rng.choice(vocab_size, size=branch, replace=False)
        for _ in range(vocab_size)
    ])  # [V, branch]
    probs = np.asarray(skew, np.float64)
    probs = probs / probs.sum()

    def sample(batch: int, length: int, rng: np.random.Generator) -> np.ndarray:
        out = np.empty((batch, length), np.int32)
        out[:, 0] = rng.integers(0, vocab_size, batch)
        for t in range(1, length):
            pick = rng.choice(branch, size=batch, p=probs)
            out[:, t] = successors[out[:, t - 1], pick]
        return out

    return sample


def train_lm(cfg: ModelConfig, *, steps: int = 300, batch: int = 64, seq_len: int = 64,
             param_seed: int = 0, data_seed: int = 1234, lr: float = 3e-3,
             device: DeviceLike = None, log: Callable[[str], None] | None = None):
    """AdamW next-token training of a tiny llama on the Markov corpus, on
    ``device`` (default the CUDA card).

    Returns (params, final_loss): a trainable f32 tree (cast it with
    :func:`cast_params` to serve it). The JAX function takes a ``dtype``;
    the port trains in float32 only (see
    :func:`..parallel.pipeline.trainable`)."""
    from ..parallel.pipeline import adamw, reference_loss_fn, trainable

    dev = resolve_device(device)
    sample = markov_sampler(cfg.vocab_size, seed=data_seed)
    data_rng = np.random.default_rng(data_seed + 1)
    params = llama.init_params(cfg, param_seed, torch.float32, dev)
    loss_fn = reference_loss_fn(cfg)
    opt = adamw(trainable(params), lr)

    loss = None
    for i in range(steps):
        seqs = to_device(sample(batch, seq_len + 1, data_rng), dev)
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(params, seqs[:, :-1], seqs[:, 1:])
        loss.backward()
        opt.step()
        loss = loss.detach()
        if log is not None and (i + 1) % 100 == 0:
            log(f"{cfg.name}: step {i + 1}/{steps} loss={float(loss):.3f}")
    return params, float(loss) if loss is not None else float("nan")


def cast_params(params: llama.LlamaModel, dtype: torch.dtype) -> llama.LlamaModel:
    """A frozen copy of a float tree in the serving dtype (e.g. bf16), on
    the tree's device."""
    from ..runtime.weights import model_from_state_dict

    return model_from_state_dict(params.state_dict(), params.cfg, params.device, dtype)
