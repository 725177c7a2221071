"""flax.linen adapters over the pure ops, for the models not yet ported.

The flax-free DLRM path (models/ctr/dlrm.py) never imports this module;
the other models build on these classes until they are ported to plain
functions.  ``StackedEmbedding`` is a thin wrapper over
:class:`recsys_tpu.ops.embedding.EmbeddingLayout`.

Dense-tower blocks cover the reference's two duplicated DNN layers
(reference src/ctr/layers/modules.py:114-135 and reference src/
match/layers/modules.py:8-26) with the reference bugs fixed: BatchNorm is a
proper flax module with learned state (the reference constructs a fresh BN
inside ``call`` every trace, modules.py:131).  Dice
(reference src/ctr/layers/modules.py:327-337) is a normalised gate.
"""
from __future__ import annotations

from typing import Sequence

import flax.linen as nn
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import embedding as embedding_kernels
from recsys_tpu.ops.embedding import (
    EmbeddingLayout,
    _group_assignment,
    _pad8,
    init_table,
)
from recsys_tpu.ops.mlp import resolve_activation


class StackedEmbedding(nn.Module):
    """flax wrapper over :class:`EmbeddingLayout` (see its docstring for the
    layout and the engines).  Dropped-id counts of the a2a engines are sown
    into the ``'a2a_stats'`` collection; ``perturb_out`` exposes the stacked
    gather output as a flax perturbation (the tap of the sparse and fused
    embedding optimizers)."""

    schema: FeatureSchema
    param_dtype: jnp.dtype = jnp.float32
    num_groups: int | None = None
    pack_rows: bool = True
    perturb_out: bool = False
    engine: str = "gather"
    mesh: object = None
    capacity_factor: float | None = 2.0
    a2a_dedup: bool = True
    a2a_chunks: int = 2

    def setup(self):
        self.layout = EmbeddingLayout(
            self.schema, param_dtype=self.param_dtype,
            num_groups=self.num_groups, pack_rows=self.pack_rows,
            engine=self.engine, mesh=self.mesh,
            capacity_factor=self.capacity_factor, a2a_dedup=self.a2a_dedup,
            a2a_chunks=self.a2a_chunks,
        )
        self.tables = [
            self.param(f"table_{g}", init_table, shape, self.param_dtype)
            for g, shape in enumerate(self.layout.table_shapes())
        ]

    def _params(self) -> dict:
        return {f"table_{g}": t for g, t in enumerate(self.tables)}

    def _sow(self, dropped: list) -> None:
        for d in dropped:
            if d is not None:
                self.sow("a2a_stats", "dropped", d)

    def pack(self, field_name: str) -> int:
        return self.layout.pack(field_name)

    def __call__(self, sparse_ids: jnp.ndarray) -> jnp.ndarray:
        out, dropped = self.layout.embed(self._params(), sparse_ids)
        self._sow(dropped)
        if self.perturb_out:
            out = self.perturb("stacked_out", out)
        return out

    def lookup(self, field_name: str, ids: jnp.ndarray) -> jnp.ndarray:
        out, dropped = self.layout.lookup(self._params(), field_name, ids)
        self._sow([dropped])
        return out

    def pooled_lookup(
        self, field_name: str, ids: jnp.ndarray, mask: jnp.ndarray,
        *, mode: str = "mean",
    ) -> jnp.ndarray:
        out, dropped = self.layout.pooled_lookup(
            self._params(), field_name, ids, mask, mode=mode
        )
        self._sow([dropped])
        return out

    def table_for(self, field_name: str) -> jnp.ndarray:
        return self.layout.table_for(self._params(), field_name)

    def table_logical(self, field_name: str) -> jnp.ndarray:
        return self.layout.table_logical(self._params(), field_name)

    def field_offset(self, field_name: str) -> int:
        return self.layout.field_offset(field_name)


class SparseLinear(nn.Module):
    """Per-ID first-order weights: sum_f w[id_f] over a batch's sparse IDs.

    The exact-FM first-order term for one-hot categorical inputs, without
    materialising the one-hot (reference src/ctr/fm/model.py:44-47).
    Grouped like StackedEmbedding.
    """

    schema: FeatureSchema
    num_groups: int | None = None
    pack_rows: bool = True  # (V, 1) -> (ceil(V/128), 128), like the tables

    def setup(self):
        group_of, offset_in, group_vocab = _group_assignment(
            self.schema, self.num_groups
        )
        self._group_of, self._offset_in = group_of, offset_in
        self._packs = [
            embedding_kernels.pack_factor(1, v) if self.pack_rows else 1
            for v in group_vocab
        ]
        self.weights = [
            self.param(
                f"w_{g}", nn.initializers.zeros,
                (_pad8(-(-max(v, 1) // p)), p),
            )
            for g, (v, p) in enumerate(zip(group_vocab, self._packs))
        ]

    def __call__(self, sparse_ids: jnp.ndarray) -> jnp.ndarray:
        total = 0.0
        for j, f in enumerate(self.schema.sparse):
            g = self._group_of[f.name]
            rows = sparse_ids[:, j].astype(jnp.int32) + self._offset_in[f.name]
            total = total + embedding_kernels.packed_gather(
                self.weights[g], rows, self._packs[g], 1
            )[..., 0]
        return total


class Dice(nn.Module):
    """DIN's adaptive activation: x * p + alpha * x * (1 - p), p = sigmoid(x_norm).

    Reference semantics at reference src/ctr/layers/modules.py:327-337
    (BN without scale/offset followed by a sigmoid gate with learned alpha).
    Uses batch statistics in training and running stats in eval, matching
    BatchNormalization(center=False, scale=False).
    """

    epsilon: float = 1e-9
    momentum: float = 0.99

    @nn.compact
    def __call__(self, x: jnp.ndarray, *, training: bool = False) -> jnp.ndarray:
        alpha = self.param("alpha", nn.initializers.zeros, (x.shape[-1],))
        norm = nn.BatchNorm(
            use_running_average=not training,
            use_bias=False,
            use_scale=False,
            momentum=self.momentum,
            epsilon=self.epsilon,
        )(x)
        p = nn.sigmoid(norm)
        return x * p + alpha * x * (1.0 - p)


class PReLU(nn.Module):
    """Parametric ReLU with a per-channel learned negative slope."""

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        alpha = self.param(
            "alpha", nn.initializers.constant(0.25), (x.shape[-1],)
        )
        return jnp.where(x >= 0, x, alpha * x)


class MLP(nn.Module):
    """Stack of Dense layers with optional entry BatchNorm and dropout.

    `hidden_units` are the intermediate widths; `out_dim` (if set) appends a
    final linear projection with no activation.  `batch_norm=True` normalises
    the input once before the stack — the reference ctr DNN's behaviour
    (modules.py:129-131) — rather than per layer.  `dtype` sets the COMPUTE
    dtype (params stay float32): pass jnp.bfloat16 to run the matmuls in bf16.
    """

    hidden_units: Sequence[int]
    activation: str = "relu"
    out_dim: int | None = None
    dropout_rate: float = 0.0
    batch_norm: bool = False
    use_dice: bool = False
    dtype: jnp.dtype | None = None

    @nn.compact
    def __call__(self, x: jnp.ndarray, *, training: bool = False) -> jnp.ndarray:
        if self.batch_norm:
            x = nn.BatchNorm(use_running_average=not training)(x)
        act = None if self.use_dice else resolve_activation(self.activation)
        for width in self.hidden_units:
            x = nn.Dense(width, dtype=self.dtype)(x)
            if self.use_dice:
                x = Dice()(x, training=training)
            else:
                x = act(x)
            if self.dropout_rate > 0.0:
                x = nn.Dropout(self.dropout_rate, deterministic=not training)(x)
        if self.out_dim is not None:
            x = nn.Dense(self.out_dim, dtype=self.dtype)(x)
        return x
