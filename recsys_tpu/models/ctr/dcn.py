"""DCN: parallel explicit CrossNetwork and deep MLP over shared features.

Parity target: /root/reference/src/ctr/dcn/model.py:45-57.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.interactions import CrossNetwork
from recsys_tpu.ops.linen import MLP


class DCN(nn.Module):
    schema: FeatureSchema
    cross_layers: int = 2
    hidden_units: Sequence[int] = (256, 128, 64)
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
        x0 = field_embs.reshape(b, f * d)
        if dense is not None and dense.shape[-1] > 0:
            x0 = jnp.concatenate([x0, dense], axis=-1)
        crossed = CrossNetwork(self.cross_layers)(x0)
        deep = MLP(self.hidden_units, dropout_rate=self.dropout_rate)(
            x0, training=training
        )
        return nn.Dense(1)(jnp.concatenate([crossed, deep], axis=-1))[..., 0]
