"""Parallelism (counterpart of ``parallel/``): rank meshes and their
collectives (:mod:`.mesh`), the Megatron cut of a llama model
(:mod:`.sharding`) and the per-device byte plan that gates an engine before
it allocates (:mod:`.feasibility`) for tensor-parallel serving; the GPipe
training pipeline (:mod:`.pipeline`) and ring attention
(:mod:`.ring_attention`) for training. Every layout is an explicit device
list run from one controller."""
