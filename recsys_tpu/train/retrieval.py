"""Brute-force top-k retrieval engine.

In-framework replacement for the reference's post-training
``faiss.IndexFlatIP`` flow (/root/reference/src/match/dssm/
dssm_train.py:74-78, /root/reference/src/match/fm/train.py:71-75): score
every catalog item against every query ON DEVICE with one batched matmul
(bf16-friendly) and take ``jax.lax.top_k`` — no host round-trip,
usable inside the jitted eval step.

The sharded variant splits the catalog over the ``model`` mesh axis inside
``shard_map``: each shard computes a local top-k over its item rows, then the
(k * n_shards) candidates are all-gathered and reduced to the global top-k —
the cross-shard merge pattern of SURVEY.md §2.5 / §7.3.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from recsys_tpu.parallel.mesh import pad_to_multiple, MODEL_AXIS


def topk_scores(
    query_embs: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int = 10,
    normalize: bool = False,
):
    """Dense brute-force top-k: (Q, D) x (N, D) -> (values, indices) (Q, k).
    Materialises the (Q, N) score matrix; :func:`topk_scores_streaming`
    bounds memory for large catalogs."""
    if normalize:
        query_embs = _l2(query_embs)
        item_embs = _l2(item_embs)
    scores = jnp.einsum(
        "qd,nd->qn", query_embs, item_embs, preferred_element_type=jnp.float32
    )
    return jax.lax.top_k(scores, k)


def topk_scores_sharded(
    mesh: Mesh,
    query_embs: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int = 10,
    normalize: bool = False,
):
    """Catalog-sharded top-k over the `model` mesh axis.

    ``item_embs`` rows are split over MODEL_AXIS (pad N to a multiple of the
    axis size); queries are replicated.  Per-shard local top-k + all-gather
    merge keeps the collective payload at k*n_shards instead of N.
    """
    n_shards = mesh.shape[MODEL_AXIS]
    n = item_embs.shape[0]
    pad = pad_to_multiple(n, n_shards) - n
    if pad:
        item_embs = jnp.concatenate(
            [item_embs, jnp.full((pad, item_embs.shape[1]), -jnp.inf,
                                 item_embs.dtype)],
            axis=0,
        )
    if normalize:
        query_embs = _l2(query_embs)

    def local_topk(q, items):
        it = _l2(items) if normalize else items
        scores = jnp.einsum(
            "qd,nd->qn", q, it, preferred_element_type=jnp.float32
        )
        scores = jnp.where(jnp.isfinite(scores), scores, -jnp.inf)
        v, i = jax.lax.top_k(scores, min(k, it.shape[0]))  # local ids
        shard = jax.lax.axis_index(MODEL_AXIS)
        gi = i + shard * it.shape[0]  # globalise row ids
        # gather all shards' candidates: (S, Q, k)
        av = jax.lax.all_gather(v, MODEL_AXIS)
        ai = jax.lax.all_gather(gi, MODEL_AXIS)
        q_n = q.shape[0]
        av = jnp.moveaxis(av, 0, 1).reshape(q_n, -1)
        ai = jnp.moveaxis(ai, 0, 1).reshape(q_n, -1)
        mv, mi = jax.lax.top_k(av, k)
        return mv, jnp.take_along_axis(ai, mi, axis=1)

    fn = shard_map(
        local_topk,
        mesh=mesh,
        in_specs=(P(), P(MODEL_AXIS, None)),
        out_specs=(P(), P()),
        check_vma=False,
    )
    return fn(query_embs, item_embs)


@functools.partial(jax.jit, static_argnames=("k", "tile", "normalize"))
def topk_scores_streaming(
    query_embs: jnp.ndarray,
    item_embs: jnp.ndarray,
    k: int = 10,
    tile: int = 8192,
    normalize: bool = False,
):
    """Memory-bounded top-k: stream the catalog in tiles with a lax.scan,
    merging each tile's scores into a running (Q, k) candidate set.

    Peak memory is O(Q * (tile + k)) instead of the O(Q * N) score matrix of
    :func:`topk_scores` — the single-chip path for catalogs where Q*N scores
    would not fit device memory (N ~ millions).
    """
    if normalize:
        query_embs = _l2(query_embs)
        item_embs = _l2(item_embs)
    n, d = item_embs.shape
    q = query_embs.shape[0]
    pad = pad_to_multiple(n, tile) - n
    if pad:
        item_embs = jnp.concatenate(
            [item_embs, jnp.zeros((pad, d), item_embs.dtype)], axis=0
        )
    tiles = item_embs.reshape(-1, tile, d)
    pos_ids = jnp.arange(tile)

    def body(carry, xs):
        best_v, best_i = carry
        tile_items, tile_idx = xs
        scores = jnp.einsum(
            "qd,nd->qn", query_embs, tile_items,
            preferred_element_type=jnp.float32,
        )
        ids = tile_idx * tile + pos_ids
        valid = ids < n
        scores = jnp.where(valid[None, :], scores, -jnp.inf)
        cat_v = jnp.concatenate([best_v, scores], axis=1)
        cat_i = jnp.concatenate(
            [best_i, jnp.broadcast_to(ids[None, :], (q, tile))], axis=1
        )
        v, sel = jax.lax.top_k(cat_v, k)
        return (v, jnp.take_along_axis(cat_i, sel, axis=1)), None

    init = (
        jnp.full((q, k), -jnp.inf, jnp.float32),
        jnp.zeros((q, k), jnp.int32),
    )
    (v, i), _ = jax.lax.scan(
        body, init, (tiles, jnp.arange(tiles.shape[0]))
    )
    return v, i


def _l2(x: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    return x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), eps)


class BruteForceIndex:
    """Minimal faiss-like convenience wrapper (host API parity).

    ``index = BruteForceIndex(dim); index.add(items); D, I = index.search(q, k)``
    mirrors the reference's IndexFlatIP usage so migrating scripts is
    mechanical, but the scoring runs jit-compiled on device.
    """

    def __init__(self, dim: int, normalize: bool = False):
        self.dim = dim
        self.normalize = normalize
        self._items = None

    def add(self, item_embs):
        items = jnp.asarray(item_embs)
        self._items = (
            items if self._items is None
            else jnp.concatenate([self._items, items], axis=0)
        )

    @property
    def ntotal(self) -> int:
        return 0 if self._items is None else int(self._items.shape[0])

    def search(self, query_embs, k: int):
        if self._items is None:
            raise ValueError("index is empty; call add() first")
        v, i = _jit_topk(
            jnp.asarray(query_embs), self._items, k, self.normalize
        )
        return jax.device_get(v), jax.device_get(i)


@functools.partial(jax.jit, static_argnums=(2, 3))
def _jit_topk(q, items, k, normalize):
    return topk_scores(q, items, k, normalize)
