"""PyTorch/CUDA port of the cyberfabric_core_tpu serving stack for NVIDIA Hopper.

The package mirrors the JAX package's layout (``models/``, ``ops/``,
``runtime/``) so every module has an obvious counterpart there. It imports
``torch`` and never ``jax``, and nothing of ``cyberfabric_core_tpu``: what it
needs from that package it keeps as its own copy.

Every entry point runs on the CUDA device unless the caller passes
``device="cpu"`` (see :mod:`.device`). Its kernels (paged attention, ragged
and decode; flash prefill attention) are hand-written CUDA C++ for
``sm_90a`` (``ops/csrc/``), built at first use.
"""
