"""PLE: progressive layered extraction (correct CGC), multi-level.

The reference PLE is broken (undefined attributes, gating by elementwise
product — /root/reference/src/ctr/ple/model.py:50-61,141-147, bugs §2.6.2).
This is the published PLE (Tang et al. 2020): each level has per-task expert
banks plus a shared bank; task gate k softmax-mixes [task_k experts || shared
experts] queried by the task's current representation; the shared path's gate
mixes ALL experts.  The final level feeds per-task towers.

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


class PLE(nn.Module):
    schema: FeatureSchema
    task_names: Sequence[str] = ("ctr", "cvr")
    num_levels: int = 2
    specific_experts: int = 2  # per task, per level
    shared_experts: int = 2
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

        n_tasks = len(self.task_names)
        # Level inputs: one representation per task + one shared.
        task_in = [x] * n_tasks
        shared_in = x
        for level in range(self.num_levels):
            last = level == self.num_levels - 1
            task_expert_outs = []
            for t, name in enumerate(self.task_names):
                bank = ExpertBank(
                    self.specific_experts,
                    self.expert_units,
                    name=f"l{level}_experts_{name}",
                )(task_in[t], training=training)
                task_expert_outs.append(bank)  # (B, Es, O)
            shared_out = ExpertBank(
                self.shared_experts,
                self.expert_units,
                name=f"l{level}_experts_shared",
            )(shared_in, training=training)  # (B, Eh, O)

            new_task_in = []
            for t, name in enumerate(self.task_names):
                cands = jnp.concatenate(
                    [task_expert_outs[t], shared_out], axis=1
                )  # (B, Es+Eh, O)
                gate = SoftmaxGate(
                    self.specific_experts + self.shared_experts,
                    name=f"l{level}_gate_{name}",
                )(task_in[t])
                new_task_in.append(mix(cands, gate))
            task_in = new_task_in

            if not last:
                all_experts = jnp.concatenate(
                    task_expert_outs + [shared_out], axis=1
                )
                gate_s = SoftmaxGate(
                    n_tasks * self.specific_experts + self.shared_experts,
                    name=f"l{level}_gate_shared",
                )(shared_in)
                shared_in = mix(all_experts, gate_s)

        out = {}
        for t, name in enumerate(self.task_names):
            h = MLP(
                self.tower_units,
                out_dim=1,
                dropout_rate=self.dropout_rate,
                name=f"tower_{name}",
            )(task_in[t], training=training)
            out[name] = h[..., 0]
        return out
