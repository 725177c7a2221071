"""Batched expert banks for multi-task models (MMoE / PLE).

The reference evaluates its "experts" serially and reuses ONE Expert instance
for all of them (/root/reference/src/ctr/mmoe/model.py:68,86 — bug §2.6.7).
Here an expert bank is a single batched einsum over a stacked
(E, in, hidden) weight tensor — E distinct experts, one batched matmul,
no Python loop over experts and no expert parallelism needed at this scale
(SURVEY.md §2.5 EP row).
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp


class ExpertBank(nn.Module):
    """E parallel MLP experts: (B, I) -> (B, E, O) via stacked weights."""

    num_experts: int
    hidden_units: Sequence[int]

    @nn.compact
    def __call__(self, x: jnp.ndarray, *, training: bool = False) -> jnp.ndarray:
        h = jnp.broadcast_to(
            x[:, None, :], (x.shape[0], self.num_experts, x.shape[-1])
        )
        in_dim = x.shape[-1]
        for i, width in enumerate(self.hidden_units):
            w = self.param(
                f"w{i}",
                nn.initializers.lecun_normal(batch_axis=(0,)),
                (self.num_experts, in_dim, width),
            )
            b = self.param(
                f"b{i}", nn.initializers.zeros, (self.num_experts, width)
            )
            h = jnp.einsum(
                "bei,eio->beo", h, w, preferred_element_type=jnp.float32
            ) + b[None]
            h = nn.relu(h)
            in_dim = width
        return h  # (B, E, O)


class SoftmaxGate(nn.Module):
    """Per-task gate: (B, I) -> softmax weights (B, E) over experts."""

    num_experts: int

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        return nn.softmax(nn.Dense(self.num_experts, use_bias=False)(x))


def mix(experts: jnp.ndarray, gate: jnp.ndarray) -> jnp.ndarray:
    """Gate-weighted expert mixture: (B, E, O) x (B, E) -> (B, O)."""
    return jnp.einsum("beo,be->bo", experts, gate)
