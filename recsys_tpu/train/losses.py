"""Loss functions (numerically stable, jit-safe).

Replaces the reference's Keras BCE / manual-add_loss patterns, fixing the
NaN-prone ``log(1 - sigmoid(x))`` constructions (bug §2.6.12 at
/root/reference/src/match/ncf/model.py:75-77, /root/reference/src/match/
sasrec/model.py:93-95) with ``log_sigmoid`` identities, and the
misconfigured ``tf.nn.sampled_softmax_loss`` (bug §2.6.14) with the idiomatic
retrieval loss: in-batch sampled softmax with logQ correction.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def bce_with_logits(logits: jnp.ndarray, labels: jnp.ndarray) -> jnp.ndarray:
    """Mean binary cross-entropy on logits: stable via log_sigmoid."""
    labels = labels.astype(logits.dtype)
    per_ex = -(
        labels * jax.nn.log_sigmoid(logits)
        + (1.0 - labels) * jax.nn.log_sigmoid(-logits)
    )
    return jnp.mean(per_ex)


def bce_probs(probs: jnp.ndarray, labels: jnp.ndarray, eps: float = 1e-7):
    """BCE on probabilities (ESMM heads output products of sigmoids)."""
    p = jnp.clip(probs, eps, 1.0 - eps)
    labels = labels.astype(p.dtype)
    return jnp.mean(-(labels * jnp.log(p) + (1.0 - labels) * jnp.log(1.0 - p)))


def pairwise_bce(pos_logits: jnp.ndarray, neg_logits: jnp.ndarray,
                 mask: jnp.ndarray | None = None) -> jnp.ndarray:
    """NCF/SASRec objective: push pos logits up, neg logits down.

    pos (B,) or (B,L); neg (..., N) broadcast-compatible.  Equivalent to the
    reference's -mean[log σ(pos)] - mean[log(1-σ(neg))] but stable.
    """
    pos_term = -jax.nn.log_sigmoid(pos_logits)
    neg_term = -jax.nn.log_sigmoid(-neg_logits)
    if mask is not None:
        m = mask.astype(pos_term.dtype)
        denom = jnp.maximum(jnp.sum(m), 1.0)
        pos_loss = jnp.sum(pos_term * m) / denom
        neg_m = jnp.broadcast_to(m[..., None], neg_term.shape)
        neg_loss = jnp.sum(neg_term * neg_m) / jnp.maximum(jnp.sum(neg_m), 1.0)
        return pos_loss + neg_loss
    return jnp.mean(pos_term) + jnp.mean(neg_term)


def in_batch_sampled_softmax(
    query_embs: jnp.ndarray,
    item_embs: jnp.ndarray,
    item_log_q: jnp.ndarray | None = None,
    temperature: float = 1.0,
) -> jnp.ndarray:
    """In-batch sampled softmax with logQ correction.

    query_embs (B, D), item_embs (B, D) — row i's item is the positive for
    row i's query; all other rows are negatives.  ``item_log_q`` (B,) is the
    log sampling probability of each item (its popularity in the batch
    distribution) subtracted from the logits so frequent items are not
    over-penalised as negatives.  The idiomatic accelerator replacement for
    tf.nn.sampled_softmax_loss (SURVEY.md §2.5).
    """
    logits = (
        jnp.einsum(
            "bd,nd->bn", query_embs, item_embs,
            preferred_element_type=jnp.float32,
        )
        / temperature
    )
    if item_log_q is not None:
        logits = logits - item_log_q[None, :]
    labels = jnp.arange(logits.shape[0])
    return jnp.mean(
        -jax.nn.log_softmax(logits, axis=-1)[labels, labels]
    )


def log_uniform_candidates(rng, num_items: int, shape, offset: int = 0):
    """Log-uniform (Zipfian) negative ids + their log sampling probability.

    The distribution behind TF's LogUniformCandidateSampler (what
    tf.nn.sampled_softmax_loss samples from when ids are sorted by
    frequency): P(k) = log(1 + 1/(k+1)) / log(num_items + 1).  Returns
    (ids int32, log_p float32) of the given shape.

    ID convention: the base ids are 0-based and assume the catalog is
    sorted by DESCENDING frequency (id 0 = most popular) — rank-in-
    popularity, not raw catalog id.  The sequence/item datasets in this
    repo use 1-based ids with 0 reserved for padding (data/movielens.py
    builders); pass ``offset=1`` for those catalogs so the sampler never
    emits the pad row and accidental-hit masking stays aligned.
    """
    u = jax.random.uniform(rng, shape)
    ids = (jnp.exp(u * jnp.log(num_items + 1.0)) - 1.0).astype(jnp.int32)
    ids = jnp.clip(ids, 0, num_items - 1)
    log_p = jnp.log1p(1.0 / (ids + 1.0)) - jnp.log(num_items + 1.0)
    return ids + offset, log_p


def popularity_log_q(counts: jnp.ndarray, smoothing: float = 1.0):
    """Per-item log sampling probability from empirical frequency counts.

    ``counts`` (V,) — how often each item id appears as a POSITIVE in the
    training stream (the distribution in-batch negatives are implicitly
    drawn from).  Returns log((counts + smoothing) / total) as float32 —
    the ``item_log_q`` table for :func:`in_batch_sampled_softmax`:
    subtracting it from the logits stops popular items being over-penalised
    just for showing up as negatives often (the logQ-corrected sampled
    softmax; SURVEY.md §2.5 sampled-softmax row).  Index it with the
    batch's item ids: ``in_batch_sampled_softmax(u, i, log_q[item_ids])``.
    """
    counts = jnp.asarray(counts, jnp.float32) + smoothing
    return jnp.log(counts) - jnp.log(jnp.sum(counts))


def sampled_softmax(
    query_embs: jnp.ndarray,
    pos_embs: jnp.ndarray,
    neg_embs: jnp.ndarray,
    pos_log_q: jnp.ndarray | None = None,
    neg_log_q: jnp.ndarray | None = None,
    pos_ids: jnp.ndarray | None = None,
    neg_ids: jnp.ndarray | None = None,
    temperature: float = 1.0,
) -> jnp.ndarray:
    """Sampled softmax over explicit catalog negatives with logQ correction.

    The faithful replacement for the reference's misused
    tf.nn.sampled_softmax_loss (SURVEY.md §2.6.14): softmax CE over
    [positive, S sampled negatives].  query/pos (B, D); neg (S, D) shared
    across the batch or (B, S, D) per-example; ``*_log_q`` are the log
    sampling probabilities (e.g. from :func:`log_uniform_candidates`) so
    popular negatives are not over-penalised.  Pass ``pos_ids`` (B,) and
    ``neg_ids`` ((S,) or (B, S)) to mask accidental hits — a sampled
    negative equal to the example's positive — like TF's
    remove_accidental_hits=True default (a Zipfian sampler collides with
    popular positives often).  In-batch negatives
    (:func:`in_batch_sampled_softmax`) remain the default.
    """
    pos_logit = jnp.sum(
        query_embs * pos_embs, axis=-1, keepdims=True
    ) / temperature  # (B, 1)
    if neg_embs.ndim == 2:
        neg_logits = jnp.einsum(
            "bd,sd->bs", query_embs, neg_embs,
            preferred_element_type=jnp.float32,
        ) / temperature
        if neg_log_q is not None:
            neg_logits = neg_logits - neg_log_q[None, :]
    else:
        neg_logits = jnp.einsum(
            "bd,bsd->bs", query_embs, neg_embs,
            preferred_element_type=jnp.float32,
        ) / temperature
        if neg_log_q is not None:
            neg_logits = neg_logits - neg_log_q
    if pos_log_q is not None:
        pos_logit = pos_logit - pos_log_q[:, None]
    if pos_ids is not None and neg_ids is not None:
        hit = (
            neg_ids[None, :] if neg_ids.ndim == 1 else neg_ids
        ) == pos_ids[:, None]  # (B, S)
        neg_logits = jnp.where(hit, -jnp.inf, neg_logits)
    logits = jnp.concatenate([pos_logit, neg_logits], axis=1)
    return jnp.mean(-jax.nn.log_softmax(logits, axis=-1)[:, 0])


def multi_task_bce(outputs: dict, labels: dict, weights: dict | None = None,
                   on_probs: bool = False) -> jnp.ndarray:
    """Weighted sum of per-task BCE losses over matching dict keys."""
    total = 0.0
    for name, y in labels.items():
        w = 1.0 if weights is None else weights.get(name, 1.0)
        fn = bce_probs if on_probs else bce_with_logits
        total = total + w * fn(outputs[name], y)
    return total


def l2_regularization(params, scale: float) -> jnp.ndarray:
    """Explicit l2 penalty over a params pytree (reference's embed_reg/w_reg)."""
    leaves = jax.tree_util.tree_leaves(params)
    return scale * sum(jnp.sum(jnp.square(p)) for p in leaves)
