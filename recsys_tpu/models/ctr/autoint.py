"""AutoInt: multi-head self-attention feature interaction over field embeds.

Parity target: /root/reference/src/ctr/autoint/model.py:44-55 with reference
bugs fixed: input to attention is the proper (B, F, D) field tensor (bug
§2.6.5 fed a 2-D tensor), the Q/K/V projections are persistent learned params
(bug §2.6.4 recreated them every call so they never trained), and scaling is
1/sqrt(d).  Dense features are projected to embed_dim and appended as an
extra field, so numeric features participate in the interaction as in the
AutoInt paper.
"""
from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.attention import MultiHeadAttention
from recsys_tpu.ops.linen import StackedEmbedding


class AutoInt(nn.Module):
    schema: FeatureSchema
    num_layers: int = 3
    num_heads: int = 2
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
        d = self.schema.embed_dim
        x = StackedEmbedding(
            self.schema, perturb_out=self.sparse_embed_grads,
            **(self.embed_kw or {}),
        )(sparse)  # (B, F, D)
        if dense is not None and dense.shape[-1] > 0:
            # per-dense-feature learned vector scaled by the value
            v = self.param(
                "v_dense", nn.initializers.normal(0.05), (dense.shape[-1], d)
            )
            x = jnp.concatenate([x, dense[..., None] * v[None]], axis=1)
        for _ in range(self.num_layers):
            x = MultiHeadAttention(
                num_heads=self.num_heads, use_residual=True
            )(x)
            if self.dropout_rate > 0:
                x = nn.Dropout(
                    self.dropout_rate, deterministic=not training
                )(x)
        b = x.shape[0]
        return nn.Dense(1)(x.reshape(b, -1))[..., 0]
