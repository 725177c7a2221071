"""MIND: multi-interest network with per-example dynamic routing.

Parity target: /root/reference/src/match/mind/model.py:57-104 and the
capsule layer at /root/reference/src/match/layers/modules.py:214-290 — with
bug §2.6.13 fixed: routing logits here are PER-EXAMPLE values carried through
a ``lax.fori_loop`` (the reference stores them in a non-trainable variable
mutated with assign_add, leaking routing state across batches).

Pipeline: history item embeddings -> B2I dynamic routing into ``k_max``
interest capsules -> per-capsule user MLP -> label-aware attention against
the target item (softmax over capsules of (interest . item)^p).  Training
scores come from the attended user vector vs in-batch items (sampled
softmax); retrieval scores every capsule and takes the max.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import embedding as ekernels
from recsys_tpu.ops.linen import MLP


def squash(s: jnp.ndarray, axis: int = -1, eps: float = 1e-9) -> jnp.ndarray:
    """Capsule squash: keeps direction, maps norm into [0, 1)."""
    sq = jnp.sum(jnp.square(s), axis=axis, keepdims=True)
    return (sq / (1.0 + sq)) * s / jnp.sqrt(sq + eps)


class CapsuleRouting(nn.Module):
    """Behaviour-to-interest routing.  (B, L, D), mask (B, L) -> (B, K, D)."""

    k_max: int = 4
    iterations: int = 3

    @nn.compact
    def __call__(self, hist: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        d = hist.shape[-1]
        bilinear = self.param(
            "S", nn.initializers.normal(0.05), (d, d)
        )  # shared B2I map
        u_hat = jnp.einsum("bld,de->ble", hist, bilinear)  # (B, L, D)
        m = mask.astype(hist.dtype)  # (B, L)
        neg = jnp.asarray(-1e9, hist.dtype)

        # Per-example routing logits, fresh every call (paper: random init;
        # fixed pseudo-random values keep the fwd pass deterministic).
        b0 = jax.random.normal(
            jax.random.PRNGKey(0), (1, self.k_max, hist.shape[1])
        ) * jnp.ones((hist.shape[0], 1, 1), hist.dtype)

        u_hat_sg = jax.lax.stop_gradient(u_hat)

        def body(i, b):
            # softmax over capsules for each behaviour, padding masked out.
            # Every loop iteration is a logit update only, so it always
            # consumes the stop-gradient behaviours; the single
            # gradient-carrying capsule computation happens after the loop.
            logits = jnp.where(m[:, None, :] > 0, b, neg)
            w = jax.nn.softmax(logits, axis=1)  # (B, K, L)
            caps = squash(jnp.einsum("bkl,bld->bkd", w, u_hat_sg))  # (B, K, D)
            b_new = b + jnp.einsum("bkd,bld->bkl", caps, u_hat_sg)
            return b_new

        # run iterations-1 logit updates, then one final capsule computation
        b_final = jax.lax.fori_loop(0, self.iterations - 1, body, b0)
        logits = jnp.where(m[:, None, :] > 0, b_final, neg)
        w = jax.nn.softmax(logits, axis=1)
        return squash(jnp.einsum("bkl,bld->bkd", w, u_hat))


class LabelAwareAttention(nn.Module):
    """softmax over capsules of (capsule . item)^p — /root/reference/src/
    match/layers/modules.py:263-290 semantics, per example."""

    pow_p: float = 2.0

    def __call__(self, capsules: jnp.ndarray, item: jnp.ndarray) -> jnp.ndarray:
        # capsules (B, K, D), item (B, D) -> (B, D)
        scores = jnp.einsum("bkd,bd->bk", capsules, item)
        w = jax.nn.softmax(jnp.power(jnp.maximum(scores, 1e-9), self.pow_p))
        return jnp.einsum("bk,bkd->bd", w, capsules)


class MIND(nn.Module):
    num_items: int
    embed_dim: int = 32
    k_max: int = 4
    routing_iterations: int = 3
    pow_p: float = 2.0
    user_units: Sequence[int] = (64,)
    pad_id: int = 0
    dropout_rate: float = 0.0

    def setup(self):
        self.item_table = self.param(
            "item_table",
            nn.initializers.normal(0.05),
            (self.num_items, self.embed_dim),
        )
        self.routing = CapsuleRouting(self.k_max, self.routing_iterations)
        self.user_mlp = MLP(
            self.user_units, out_dim=self.embed_dim,
            dropout_rate=self.dropout_rate,
        )
        self.label_att = LabelAwareAttention(self.pow_p)

    def interests(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        """(B, K, D) interest capsules from the behaviour history."""
        hist = batch["hist"]
        mask = hist != self.pad_id
        embs = ekernels.gather(self.item_table, hist.astype(jnp.int32))
        caps = self.routing(embs, mask)
        b, k, d = caps.shape
        return self.user_mlp(
            caps.reshape(b * k, d), training=training
        ).reshape(b, k, self.embed_dim)

    def item_embed(self, item_ids: jnp.ndarray) -> jnp.ndarray:
        return ekernels.gather(self.item_table, item_ids.astype(jnp.int32))

    def all_item_embeddings(self) -> jnp.ndarray:
        return self.item_table

    def __call__(self, batch: dict, *, training: bool = False) -> dict:
        caps = self.interests(batch, training=training)  # (B, K, D)
        item = self.item_embed(batch["item_id"])  # (B, D)
        user = self.label_att(caps, item)  # (B, D)
        return {"user": user, "item": item, "interests": caps}
