"""Compute ops in plain ``jax.numpy`` / ``lax``.

Each module holds one op family (interactions, attention, embedding
gather); XLA compiles them for whatever device JAX runs on.  The only op
with a choice of implementation is attention (:mod:`.dispatch`).
"""
