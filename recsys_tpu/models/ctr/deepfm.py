"""DeepFM: shared field embeddings feeding an FM head and a deep MLP head.

Parity target: /root/reference/src/ctr/deep_fm/model.py:50-65 with reference
bug §2.6.3 fixed (the first-order term is per-example here, not collapsed
over the batch as at /root/reference/src/ctr/layers/modules.py:65).
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import interactions as ikernels
from recsys_tpu.ops.linen import SparseLinear, StackedEmbedding
from recsys_tpu.ops.linen import MLP


class DeepFM(nn.Module):
    schema: FeatureSchema
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
        )(sparse)  # (B, F, D)
        b, f, d = field_embs.shape

        # FM head over the shared embeddings.
        fm_logit = (
            SparseLinear(self.schema)(sparse)
            + ikernels.fm_pairwise(field_embs)
        )

        # Deep head over flattened embeddings (+ dense features).
        deep_in = field_embs.reshape(b, f * d)
        if dense is not None and dense.shape[-1] > 0:
            deep_in = jnp.concatenate([deep_in, dense], axis=-1)
        deep_logit = MLP(
            self.hidden_units, out_dim=1, dropout_rate=self.dropout_rate
        )(deep_in, training=training)[..., 0]

        return fm_logit + deep_logit
