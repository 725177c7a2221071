"""Wide&Deep: linear (wide) path over dense + sparse, deep MLP path.

Parity target: /root/reference/src/ctr/wide_deep/model.py:70-83 — wide =
linear over dense features, deep = MLP over [field embeddings, dense], final
score = sigmoid(0.5*wide + 0.5*deep).  Returned here as the pre-sigmoid
0.5*(wide_logit + deep_logit).
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.linen import SparseLinear, StackedEmbedding
from recsys_tpu.ops.interactions import LinearLogit
from recsys_tpu.ops.linen import MLP


class WideDeep(nn.Module):
    schema: FeatureSchema
    hidden_units: Sequence[int] = (256, 128, 64)
    dropout_rate: float = 0.0
    wide_uses_sparse: bool = True
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

        wide = jnp.zeros((b,), field_embs.dtype)
        if dense is not None and dense.shape[-1] > 0:
            wide = wide + LinearLogit()(dense)
        if self.wide_uses_sparse:
            wide = wide + SparseLinear(self.schema)(sparse)

        deep_in = field_embs.reshape(b, f * d)
        if dense is not None and dense.shape[-1] > 0:
            deep_in = jnp.concatenate([deep_in, dense], axis=-1)
        deep = MLP(
            self.hidden_units, out_dim=1, dropout_rate=self.dropout_rate
        )(deep_in, training=training)[..., 0]
        return 0.5 * (wide + deep)
