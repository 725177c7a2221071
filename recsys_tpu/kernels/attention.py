"""Masked scaled-dot-product attention — jnp reference op.

Replaces the reference's sdpa utilities (/root/reference/src/ctr/layers/
util.py:12-35, /root/reference/src/match/layers/modules.py:76-96) with bugs
fixed: scaling is 1/sqrt(d) (ref bug §2.6.4 multiplies by sqrt(d)) and a
``None`` mask means *no* masking (ref bug §2.6.9 masks everything).  Masking
uses a large negative additive bias in the softmax.

This materialised-softmax form is the plain reference; the model path goes
through :func:`recsys_tpu.kernels.dispatch.sdpa`.
"""
from __future__ import annotations

import jax.numpy as jnp

NEG_INF = -1e9


def sdpa(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    mask: jnp.ndarray | None = None,
    *,
    precision=None,
) -> jnp.ndarray:
    """Attention over the last two axes: (..., S_q, D) x (..., S_k, D).

    mask: broadcastable to (..., S_q, S_k); 1/True = attend, 0 = masked out.
    precision: matmul precision for both einsums (None = the backend's
    default, which on the GPU may run float32 products in TF32).
    """
    d = q.shape[-1]
    logits = jnp.einsum(
        "...qd,...kd->...qk", q, k, preferred_element_type=jnp.float32,
        precision=precision,
    ) / jnp.sqrt(jnp.asarray(d, jnp.float32))
    if mask is not None:
        logits = jnp.where(mask.astype(bool), logits, NEG_INF)
    weights = jnp.exp(
        logits - jnp.max(logits, axis=-1, keepdims=True)
    )
    weights = weights / jnp.sum(weights, axis=-1, keepdims=True)
    weights = weights.astype(v.dtype)
    return jnp.einsum("...qk,...kd->...qd", weights, v, precision=precision)
