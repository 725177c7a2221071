"""Feature-interaction compute ops: FM pairwise and DLRM dot-interaction.

Plain jnp implementations; XLA's autodiff supplies their backward.

Reference semantics being reproduced (with its bugs fixed):
* FM second-order: 0.5 * sum((sum_f v_f)^2 - sum_f v_f^2) over field
  embeddings — /root/reference/src/ctr/layers/modules.py:67-70.
* DLRM dot-interaction: pairwise dots between all feature vectors, lower
  triangle flattened — the published DLRM op the reference *omits*
  (SURVEY.md §2.6.1; /root/reference/src/ctr/dlrm/model.py:42-54 is broken).
"""
from __future__ import annotations

import jax.numpy as jnp


def fm_pairwise(field_embs: jnp.ndarray) -> jnp.ndarray:
    """FM second-order interaction over field embeddings.

    field_embs: (B, F, D) -> (B,) per-example interaction score:
    0.5 * sum_d [ (sum_f v_fd)^2 - sum_f v_fd^2 ].
    """
    sum_sq = jnp.square(jnp.sum(field_embs, axis=1))      # (B, D)
    sq_sum = jnp.sum(jnp.square(field_embs), axis=1)      # (B, D)
    return 0.5 * jnp.sum(sum_sq - sq_sum, axis=-1)        # (B,)


def fm_pairwise_vector(field_embs: jnp.ndarray) -> jnp.ndarray:
    """Bi-interaction pooling: like fm_pairwise but keeps the D axis (B, D)."""
    sum_sq = jnp.square(jnp.sum(field_embs, axis=1))
    sq_sum = jnp.sum(jnp.square(field_embs), axis=1)
    return 0.5 * (sum_sq - sq_sum)


def dot_interaction(
    vectors: jnp.ndarray, *, self_interaction: bool = False
) -> jnp.ndarray:
    """DLRM pairwise dot-interaction.

    vectors: (B, F, D) — the bottom-MLP output concatenated with the field
    embeddings, all projected to a common D.  Returns (B, F*(F-1)/2) — the
    strictly-lower-triangular entries of the (F, F) Gram matrix (or the
    inclusive triangle when ``self_interaction``).
    """
    gram = jnp.einsum(
        "bfd,bgd->bfg", vectors, vectors, preferred_element_type=jnp.float32
    )
    f = vectors.shape[1]
    rows, cols = jnp.tril_indices(f, k=0 if self_interaction else -1)
    return gram[:, rows, cols]
