"""MMoE: multi-gate mixture-of-experts multi-task model.

Parity target: /root/reference/src/ctr/mmoe/model.py:71-121, with reference
bugs fixed (§2.6.6/.7: distinct experts instead of one reused instance, gate
weights as persistent params, softmax gates).  Experts run as ONE batched
einsum (ops/experts.py) instead of a Python loop.

Returns a dict {task_name: logits (B,)}.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.linen import StackedEmbedding
from recsys_tpu.ops.experts import ExpertBank, SoftmaxGate, mix
from recsys_tpu.ops.linen import MLP


class MMoE(nn.Module):
    schema: FeatureSchema
    task_names: Sequence[str] = ("ctr", "cvr")
    num_experts: int = 6
    expert_units: Sequence[int] = (64, 32)
    tower_units: Sequence[int] = (32,)
    dropout_rate: float = 0.0

    # passthrough construction kwargs for StackedEmbedding (engine/mesh/
    # capacity_factor/num_groups ... ) -- how the Trainer/CLI select the
    # explicit sharded-lookup engines (see ops/embedding.py ENGINES)
    embed_kw: dict | None = None

    @nn.compact
    def __call__(self, batch: dict, *, training: bool = False) -> dict:
        sparse, dense = batch.get("sparse"), batch.get("dense")
        parts = []
        if sparse is not None and sparse.shape[-1] > 0:
            embs = StackedEmbedding(self.schema, **(self.embed_kw or {}))(sparse)
            parts.append(embs.reshape(sparse.shape[0], -1))
        if dense is not None and dense.shape[-1] > 0:
            parts.append(dense)
        x = jnp.concatenate(parts, axis=-1)

        experts = ExpertBank(self.num_experts, self.expert_units)(
            x, training=training
        )  # (B, E, O)
        out = {}
        for name in self.task_names:
            gate = SoftmaxGate(self.num_experts, name=f"gate_{name}")(x)
            h = mix(experts, gate)
            h = MLP(
                self.tower_units,
                out_dim=1,
                dropout_rate=self.dropout_rate,
                name=f"tower_{name}",
            )(h, training=training)
            out[name] = h[..., 0]
        return out
