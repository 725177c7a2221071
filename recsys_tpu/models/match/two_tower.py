"""Two-tower retrieval models: DSSM and its SENet variant.

Parity targets:
* DSSM — /root/reference/src/match/dssm/model.py:17-82, with bug §2.6.8
  fixed: cosine similarity is computed PER EXAMPLE (the reference reshapes to
  (1,-1) and emits one scalar per batch, model.py:49-62).
* SENet-DSSM — /root/reference/src/match/senet/model.py:63-81: SE field
  re-weighting on both towers, gamma-scaled clipped cosine.

Towers expose ``user_embed`` / ``item_embed`` methods (via ``apply(...,
method=...)``) so the retrieval engine can embed the full catalog for
brute-force top-k — the in-framework replacement for the reference's
submodel-extraction + faiss flow (/root/reference/src/match/dssm/
dssm_train.py:63-96).
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.interactions import SEBlock
from recsys_tpu.ops.linen import MLP


def cosine(u: jnp.ndarray, v: jnp.ndarray, eps: float = 1e-8) -> jnp.ndarray:
    """Row-wise cosine similarity (B, D) x (B, D) -> (B,)."""
    num = jnp.sum(u * v, axis=-1)
    den = jnp.linalg.norm(u, axis=-1) * jnp.linalg.norm(v, axis=-1)
    return num / jnp.maximum(den, eps)


class TwoTower(nn.Module):
    """Shared base: embeds each tower's sparse (+dense) fields, MLP to a
    common dim.  Scoring = gamma * cosine(user, item), a per-example logit.
    """

    user_schema: FeatureSchema
    item_schema: FeatureSchema
    user_units: Sequence[int] = (128, 64)
    item_units: Sequence[int] = (128, 64)
    out_dim: int = 32
    dropout_rate: float = 0.0
    gamma: float = 1.0  # logit scale on the cosine
    use_senet: bool = False
    se_reduction: int = 2
    # "score": per-example gamma*cosine logit (reference protocol, trained
    # with BCE on rated pairs).  "pair": return both tower embeddings for
    # in-batch sampled-softmax training — measured 0.23 vs 0.06 recall@10
    # on the synthetic ml-100k fixture, so the CLI defaults to it.
    output_mode: str = "score"

    def setup(self):
        self.user_table = StackedEmbedding(self.user_schema)
        self.item_table = StackedEmbedding(self.item_schema)
        self.user_mlp = MLP(
            self.user_units, out_dim=self.out_dim, dropout_rate=self.dropout_rate
        )
        self.item_mlp = MLP(
            self.item_units, out_dim=self.out_dim, dropout_rate=self.dropout_rate
        )
        if self.use_senet:
            self.user_se = SEBlock(self.se_reduction)
            self.item_se = SEBlock(self.se_reduction)

    def _tower(self, table, mlp, se, sparse, dense, training):
        embs = table(sparse)  # (B, F, D)
        if se is not None:
            embs = se(embs)
        x = embs.reshape(sparse.shape[0], -1)
        if dense is not None and dense.shape[-1] > 0:
            x = jnp.concatenate([x, dense], axis=-1)
        return mlp(x, training=training)

    def user_embed(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        return self._tower(
            self.user_table,
            self.user_mlp,
            self.user_se if self.use_senet else None,
            batch["user_sparse"],
            batch.get("user_dense"),
            training,
        )

    def item_embed(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        return self._tower(
            self.item_table,
            self.item_mlp,
            self.item_se if self.use_senet else None,
            batch["item_sparse"],
            batch.get("item_dense"),
            training,
        )

    def __call__(self, batch: dict, *, training: bool = False):
        u = self.user_embed(batch, training=training)
        v = self.item_embed(batch, training=training)
        if self.output_mode == "pair":
            return {"user": u, "item": v}
        sim = cosine(u, v)
        if self.use_senet:
            # SENet reference clips low similarities to 0 before scaling
            sim = jnp.maximum(sim, 0.0)
        return self.gamma * sim


def DSSM(user_schema, item_schema, **kw) -> TwoTower:
    return TwoTower(user_schema, item_schema, use_senet=False, **kw)


def SENetDSSM(user_schema, item_schema, **kw) -> TwoTower:
    return TwoTower(user_schema, item_schema, use_senet=True, **kw)
