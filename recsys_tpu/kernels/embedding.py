"""Embedding gather / segment-sum lookup.

Replacement for the per-field ``tf.keras.layers.Embedding``
gathers of the reference (/root/reference/src/ctr/deep_fm/model.py:53-54).
The framework-level contract is two ops:

* ``gather(table, rows)`` — (V, D) table, int32 ``rows`` of any shape ->
  embeddings of shape ``rows.shape + (D,)``.
* ``segment_sum_gather(table, rows, mask)`` — pooled lookup for padded
  variable-length fields: gathers (B, L) rows and mean/sum-pools the unmasked
  positions (reference's PoolingLayer, /root/reference/src/match/layers/
  modules.py:187-211).

Both are XLA's native gather (``table[rows]``) plus a masked reduction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def gather(table: jnp.ndarray, rows: jnp.ndarray) -> jnp.ndarray:
    """Embed ``rows`` (int32, any shape) from ``table`` (V, D)."""
    return jnp.take(table, rows, axis=0)


def pack_factor(embed_dim: int, vocab: int | None = None) -> int:
    """Vocab rows per 512-byte physical row (128 f32 values).

    The packed layout stores ``pack`` vocab rows side by side in one wide
    physical row, so gathers and scatter-adds move whole 512-byte rows
    instead of narrow ``embed_dim``-wide ones.  Whether this pays on the
    GPU is not measured yet.  Small vocabularies pack less so the physical
    table keeps >= 64 rows (degenerate 1-row tables can't row-shard and
    gain nothing).
    """
    p = max(1, 128 // embed_dim)
    if vocab is not None:
        while p > 1 and vocab < p * 64:
            p //= 2
    return p


def packed_select(
    wide: jnp.ndarray, rows: jnp.ndarray, pack: int, embed_dim: int
) -> jnp.ndarray:
    """Select each row's sub-slot from fetched WIDE physical rows.

    ``wide`` is rows.shape + (pack * embed_dim,) — the physical rows
    holding vocab rows ``rows`` (fetched by any engine: local take, psum,
    or all-to-all exchange).  The sub-row is selected with a one-hot
    einsum (vectorised multiply+reduce — NOT take_along_axis, which would
    lower to another narrow gather)."""
    if pack == 1:
        return wide
    wide = wide.reshape(*rows.shape, pack, embed_dim)
    onehot = jax.nn.one_hot(rows % pack, pack, dtype=wide.dtype)
    return jnp.einsum("...pd,...p->...d", wide, onehot)


def packed_gather(
    table: jnp.ndarray, rows: jnp.ndarray, pack: int, embed_dim: int
) -> jnp.ndarray:
    """Gather vocab ``rows`` from a row-packed table.

    ``table`` is (ceil(V / pack), pack * embed_dim): physical row ``r``
    holds vocab rows ``r*pack .. r*pack+pack-1`` side by side.  The fetch
    reads the wide physical row; :func:`packed_select` picks the sub-row.
    The autodiff backward spreads the cotangent into the wide layout and
    scatter-adds whole physical rows, which is the fast-scatter path this
    layout exists for.
    """
    if pack == 1:
        return jnp.take(table, rows, axis=0)
    wide = jnp.take(table, rows // pack, axis=0)  # rows.shape + (pack*D,)
    return packed_select(wide, rows, pack, embed_dim)


def pool(emb: jnp.ndarray, mask: jnp.ndarray, *, mode: str = "mean"):
    """Pool (B, L, D) embeddings over unmasked positions -> (B, D)."""
    m = mask.astype(emb.dtype)[..., None]
    summed = jnp.sum(emb * m, axis=1)
    if mode == "sum":
        return summed
    count = jnp.maximum(jnp.sum(m, axis=1), 1.0)
    if mode == "mean":
        return summed / count
    if mode == "sqrtn":
        return summed / jnp.sqrt(count)
    raise ValueError(f"unknown pooling mode {mode!r}")


def segment_sum_gather(
    table: jnp.ndarray,
    rows: jnp.ndarray,
    mask: jnp.ndarray,
    *,
    mode: str = "mean",
) -> jnp.ndarray:
    """Pooled embedding of padded sequences.

    rows: (B, L) int32; mask: (B, L) bool/float (1 = real token).
    Returns (B, D).  ``mode`` in {'mean', 'sum', 'sqrtn'}.
    """
    return pool(gather(table, rows), mask, mode=mode)
