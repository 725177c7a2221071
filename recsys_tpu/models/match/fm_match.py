"""FM-match: two-tower factorization machine for retrieval.

Parity target: /root/reference/src/match/fm/model.py:68-91 — FM over the
concatenation of user-side and item-side field embeddings, while exposing
sum-pooled per-tower embeddings (`user_embeds`/`item_embeds`, model.py:73,77)
for inner-product retrieval.  The defect at /root/reference/src/match/fm/
train.py:66-67 (passing embeddings through a freshly initialised untrained
DNN before indexing) is not reproduced.
"""
from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import interactions as ikernels
from recsys_tpu.ops.linen import SparseLinear, StackedEmbedding


class FMMatch(nn.Module):
    user_schema: FeatureSchema
    item_schema: FeatureSchema

    def setup(self):
        self.user_table = StackedEmbedding(self.user_schema)
        self.item_table = StackedEmbedding(self.item_schema)
        self.user_linear = SparseLinear(self.user_schema)
        self.item_linear = SparseLinear(self.item_schema)

    def user_embed(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        """Sum-pooled user field embeddings (B, D) for retrieval."""
        return jnp.sum(self.user_table(batch["user_sparse"]), axis=1)

    def item_embed(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        return jnp.sum(self.item_table(batch["item_sparse"]), axis=1)

    def __call__(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        u_fields = self.user_table(batch["user_sparse"])  # (B, Fu, D)
        i_fields = self.item_table(batch["item_sparse"])  # (B, Fi, D)
        fields = jnp.concatenate([u_fields, i_fields], axis=1)
        first = self.user_linear(batch["user_sparse"]) + self.item_linear(
            batch["item_sparse"]
        )
        return first + ikernels.fm_pairwise(fields)
