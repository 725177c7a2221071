"""ESMM: entire-space multi-task model — pCTR head, pCVR head, pCTCVR=pCTR*pCVR.

Parity target: /root/reference/src/ctr/esmm/model.py:37-112 (shared user/item
embedding dict + shared DNN towers feeding both heads; two trained outputs
[ctr, ctcvr] with BCE each).  Returns a dict of *probabilities* — ESMM's
ctcvr is a product of probabilities, so the heads are trained in probability
space (clipped stable BCE in the loss helper).

Batch layout: ``sparse`` (B, F) where the first ``num_user_fields`` columns
are user-side fields and the rest item-side; optional ``dense``.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.linen import MLP


class ESMM(nn.Module):
    schema: FeatureSchema
    num_user_fields: int
    user_units: Sequence[int] = (128, 64)
    item_units: Sequence[int] = (128, 64)
    head_units: Sequence[int] = (64, 32)
    dropout_rate: float = 0.0

    # passthrough construction kwargs for StackedEmbedding (engine/mesh/
    # capacity_factor/num_groups ... ) -- how the Trainer/CLI select the
    # explicit sharded-lookup engines (see ops/embedding.py ENGINES)
    embed_kw: dict | None = None

    @nn.compact
    def __call__(self, batch: dict, *, training: bool = False) -> dict:
        sparse, dense = batch["sparse"], batch.get("dense")
        field_embs = StackedEmbedding(self.schema, **(self.embed_kw or {}))(sparse)  # (B, F, D)
        b = sparse.shape[0]
        u = field_embs[:, : self.num_user_fields, :].reshape(b, -1)
        i = field_embs[:, self.num_user_fields :, :].reshape(b, -1)

        # Shared towers: ONE user tower + ONE item tower feed both heads
        # (reference model.py:42-46 — the sharing is the entire-space trick).
        u = MLP(self.user_units, dropout_rate=self.dropout_rate)(
            u, training=training
        )
        i = MLP(self.item_units, dropout_rate=self.dropout_rate)(
            i, training=training
        )
        x = jnp.concatenate(
            [u, i] + ([dense] if dense is not None and dense.shape[-1] else []),
            axis=-1,
        )
        ctr_logit = MLP(self.head_units, out_dim=1, dropout_rate=self.dropout_rate)(
            x, training=training
        )[..., 0]
        cvr_logit = MLP(self.head_units, out_dim=1, dropout_rate=self.dropout_rate)(
            x, training=training
        )[..., 0]
        p_ctr = nn.sigmoid(ctr_logit)
        p_cvr = nn.sigmoid(cvr_logit)
        return {"ctr": p_ctr, "cvr": p_cvr, "ctcvr": p_ctr * p_cvr}
