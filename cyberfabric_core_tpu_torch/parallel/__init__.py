"""Tensor-parallel serving (counterpart of ``parallel/``): rank meshes and
their collectives (:mod:`.mesh`), the Megatron cut of a llama model
(:mod:`.sharding`) and the per-device byte plan that gates an engine before
it allocates (:mod:`.feasibility`). Ring attention and the pipeline of the
JAX package are training paths and are not here."""
