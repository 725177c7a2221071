"""YoutubeDNN retrieval: user tower over profile + pooled watch history,
items scored against the catalog with in-batch sampled softmax.

Parity target: /root/reference/src/match/youtube_dnn/model.py:43-61, with
the SampledSoftmaxLayer misuse fixed (bug §2.6.14: the reference used the
batch's item-tower outputs as the softmax weight matrix and the embedding
dim as num_classes).  Here training uses the idiomatic accelerator
objective — in-batch sampled softmax with logQ correction
(recsys_tpu.train.losses.in_batch_sampled_softmax).

``__call__`` returns {'user': (B, D), 'item': (B, D)}; ``user_embed`` /
``item_embed`` / ``all_item_embeddings`` feed the top-k retrieval engine.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import embedding as ekernels
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.linen import MLP


class YoutubeDNN(nn.Module):
    """user_schema: profile fields + a varlen 'hist_item' field sharing the
    item vocabulary; item side is a single id embedding (L2-normalised)."""

    user_schema: FeatureSchema
    num_items: int
    embed_dim: int = 32
    hidden_units: Sequence[int] = (128, 64)
    hist_field: str = "hist_item"
    pooling: str = "mean"
    dropout_rate: float = 0.0

    def setup(self):
        self.user_table = StackedEmbedding(self.user_schema)
        self.item_table = self.param(
            "item_table",
            nn.initializers.normal(0.05),
            (self.num_items, self.embed_dim),
        )
        self.user_mlp = MLP(
            self.hidden_units, out_dim=self.embed_dim,
            dropout_rate=self.dropout_rate,
        )

    def user_embed(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        hist = batch["hist"]  # (B, L)
        pad_id = self.user_schema.field(self.hist_field).pad_id
        mask = hist != pad_id
        pooled = self.user_table.pooled_lookup(
            self.hist_field, hist, mask, mode=self.pooling
        )  # (B, D)
        parts = [pooled]
        if "user_sparse" in batch and batch["user_sparse"].shape[-1] > 0:
            profile = self.user_table(batch["user_sparse"])
            parts.append(profile.reshape(profile.shape[0], -1))
        if batch.get("user_dense") is not None:
            parts.append(batch["user_dense"])
        x = jnp.concatenate(parts, axis=-1)
        u = self.user_mlp(x, training=training)
        return u / jnp.maximum(jnp.linalg.norm(u, axis=-1, keepdims=True), 1e-8)

    def item_embed(self, item_ids: jnp.ndarray) -> jnp.ndarray:
        v = ekernels.gather(self.item_table, item_ids.astype(jnp.int32))
        return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)

    def all_item_embeddings(self) -> jnp.ndarray:
        v = self.item_table
        return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-8)

    def __call__(self, batch: dict, *, training: bool = False) -> dict:
        return {
            "user": self.user_embed(batch, training=training),
            "item": self.item_embed(batch["item_id"]),
        }
