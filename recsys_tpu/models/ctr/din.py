"""DIN: target attention over a padded behaviour sequence.

Parity target: /root/reference/src/ctr/din/model.py:57-93 and the
Amazon-Electronics protocol (/root/reference/src/ctr/utils/
data_process.py:121-227, maxlen=40).  Unlike the reference — which routes the
behaviour sequence through the broken ctr MultiHeadAttention with no query
and no mask (model.py:77, bug §2.6.4) — this uses the purpose-built
target-attention semantics of the reference's own AttentionLayer
(/root/reference/src/ctr/layers/modules.py:137-175): the candidate item
queries the history, padding masked, softmax-weighted sum.

Batch layout: ``sparse`` (B, F) where column ``target_index`` is the
candidate item id (and, when the category stream is used, column
``target_index + 1`` its category), ``hist`` (B, L) history item ids padded
with the varlen field's pad_id, optional ``hist_cate`` (B, L) category ids
aligned with ``hist`` (the Amazon protocol emits both), optional ``dense``.
When the category stream is present the attention keys/query are the
CONCAT of item and category embeddings — the published DIN's
[item_emb, cate_emb] goods representation.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.attention import TargetAttention
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.linen import Dice, PReLU


class DIN(nn.Module):
    schema: FeatureSchema
    hist_field: str = "hist_item"
    hist_cate_field: str = "hist_cate"
    target_index: int = 0  # column of `sparse` holding the candidate item
    att_hidden_units: Sequence[int] = (32, 16)
    ffn_hidden_units: Sequence[int] = (80, 40)
    ffn_activation: str = "prelu"  # 'prelu' or 'dice'
    dropout_rate: float = 0.0

    # passthrough construction kwargs for StackedEmbedding (engine/mesh/
    # capacity_factor/num_groups ... ) -- how the Trainer/CLI select the
    # explicit sharded-lookup engines (see ops/embedding.py ENGINES)
    embed_kw: dict | None = None

    @nn.compact
    def __call__(self, batch: dict, *, training: bool = False) -> jnp.ndarray:
        sparse, dense, hist = batch["sparse"], batch.get("dense"), batch["hist"]
        hist_cate = batch.get("hist_cate")
        table = StackedEmbedding(self.schema, **(self.embed_kw or {}))
        field_embs = table(sparse)  # (B, F, D)
        target_emb = field_embs[:, self.target_index, :]  # (B, D)

        hist_cfg = self.schema.field(self.hist_field)
        hist_embs = table.lookup(self.hist_field, hist)  # (B, L, D)
        mask = hist != hist_cfg.pad_id  # (B, L)
        if hist_cate is not None:
            # goods representation = [item_emb ; cate_emb] for keys & query
            cate_embs = table.lookup(self.hist_cate_field, hist_cate)
            hist_embs = jnp.concatenate([hist_embs, cate_embs], axis=-1)
            target_emb = jnp.concatenate(
                [target_emb, field_embs[:, self.target_index + 1, :]], axis=-1
            )
        att_pooled = TargetAttention(tuple(self.att_hidden_units))(
            target_emb, hist_embs, mask
        )

        b = sparse.shape[0]
        parts = [field_embs.reshape(b, -1), att_pooled]
        if dense is not None and dense.shape[-1] > 0:
            parts.append(dense)
        x = jnp.concatenate(parts, axis=-1)
        x = nn.BatchNorm(use_running_average=not training)(x)
        for w in self.ffn_hidden_units:
            x = nn.Dense(w)(x)
            if self.ffn_activation == "dice":
                x = Dice()(x, training=training)
            else:
                x = PReLU()(x)
            if self.dropout_rate > 0:
                x = nn.Dropout(self.dropout_rate, deterministic=not training)(x)
        return nn.Dense(1)(x)[..., 0]
