"""Multi-chip scaling: mesh construction, shard_map wrappers, ring attention.

The reference is single-GPU (SURVEY.md §2 parallelism inventory: all absent);
this package provides them over a jax.sharding.Mesh with XLA collectives,
which XLA lowers to NCCL — no hand-written comm backend (the reference had
none either).
"""
