"""Deep&Crossing: field embeddings -> stack of residual units -> logit.

Parity target: /root/reference/src/ctr/deep_crossing/model.py:42-51.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.interactions import ResidualUnit
from recsys_tpu.ops.linen import MLP


class DeepCrossing(nn.Module):
    schema: FeatureSchema
    hidden_units: Sequence[int] = (256, 256)  # one ResidualUnit per entry
    dropout_rate: float = 0.0
    # enables the StackedEmbedding perturbation tap so the Trainer's
    # sparse (touched-rows-only) embedding optimizer can be used --
    # see recsys_tpu/train/sparse_embed.py
    sparse_embed_grads: bool = False

    # passthrough construction kwargs for StackedEmbedding (engine/mesh/
    # capacity_factor/num_groups ... ) -- how the Trainer/CLI select the
    # explicit sharded-lookup engines (see ops/embedding.py ENGINES)
    embed_kw: dict | None = None

    @nn.compact
    def __call__(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        sparse, dense = batch["sparse"], batch.get("dense")
        field_embs = StackedEmbedding(
            self.schema, perturb_out=self.sparse_embed_grads,
            **(self.embed_kw or {}),
        )(sparse)
        b, f, d = field_embs.shape
        x = field_embs.reshape(b, f * d)
        if dense is not None and dense.shape[-1] > 0:
            x = jnp.concatenate([x, dense], axis=-1)
        for width in self.hidden_units:
            x = ResidualUnit(width)(x)
        if self.dropout_rate > 0:
            x = nn.Dropout(self.dropout_rate, deterministic=not training)(x)
        return nn.Dense(1)(x)[..., 0]
