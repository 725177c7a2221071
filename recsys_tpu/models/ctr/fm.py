"""Factorization Machine for CTR ranking.

Capability parity with /root/reference/src/ctr/fm/model.py:34-53 (full-vocab
one-hot FM: w0 + w.x + 0.5*sum[(xV)^2 - x^2 V^2]), re-expressed without the
one-hot: for categorical fields the latent vector is a table row; for dense
features the latent vector is the feature value times a learned per-feature
vector.  This is algebraically the same FM, as one big gather + one fused
pairwise-interaction op instead of a (B, vocab) matmul.
"""
from __future__ import annotations

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import interactions as ikernels
from recsys_tpu.ops.linen import SparseLinear, StackedEmbedding


class FM(nn.Module):
    schema: FeatureSchema
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
        sparse = batch["sparse"]  # (B, F_s) int32
        dense = batch.get("dense")  # (B, F_d) float32 or None

        field_embs = StackedEmbedding(
            self.schema, perturb_out=self.sparse_embed_grads,
            **(self.embed_kw or {}),
        )(sparse)  # (B, F_s, D)
        first = SparseLinear(self.schema)(sparse)  # (B,)
        bias = self.param("bias", nn.initializers.zeros, ())

        if dense is not None and dense.shape[-1] > 0:
            d = self.schema.embed_dim
            v_dense = self.param(
                "v_dense", nn.initializers.normal(0.05), (dense.shape[-1], d)
            )
            dense_vecs = dense[..., None] * v_dense[None, :, :]  # (B, F_d, D)
            field_embs = jnp.concatenate([field_embs, dense_vecs], axis=1)
            w_dense = self.param(
                "w_dense", nn.initializers.zeros, (dense.shape[-1],)
            )
            first = first + dense @ w_dense

        second = ikernels.fm_pairwise(field_embs)  # (B,)
        return bias + first + second
