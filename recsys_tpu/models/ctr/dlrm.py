"""DLRM: bottom MLP over dense, pairwise dot-interaction, top MLP.

The reference's DLRM is broken (undefined attributes, missing the paper's
dot-interaction — /root/reference/src/ctr/dlrm/model.py:42-54, bug ledger
SURVEY.md §2.6.1).  This is the *published* DLRM (Naumov et al. 2019):
  z = bottom_mlp(dense)                      (B, D)
  E = field embeddings                       (B, F, D)
  I = pairwise dots of [z, E]                (B, (F+1)F/2)
  logit = top_mlp([z, I])

The model imports only JAX: it is a plain class over the pure ops in
ops/embedding.py, ops/mlp.py and kernels/interactions.py.  It keeps flax's
calling contract (``init(rngs, batch, training=...)``, ``apply(variables,
batch, training=..., rngs=..., mutable=[...])``) and flax's param-tree
paths (``StackedEmbedding_0/table_g``, ``MLP_0/Dense_i/kernel``, ...), so
the Trainer, the sharding rules and the sparse-embedding plan treat it
like the flax models.
"""
from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import interactions
from recsys_tpu.ops import mlp
from recsys_tpu.ops.embedding import EmbeddingLayout

EMB = "StackedEmbedding_0"
_A2A_ENGINES = ("a2a", "a2a_pipelined")


class DLRM:
    """``compute_dtype=jnp.bfloat16`` runs the MLPs and the interaction in
    bf16 (params and loss stay float32); None = full float32.

    ``sparse_embed_grads`` adds the ``perturbations`` tap on the stacked
    gather output, which the Trainer's sparse and fused embedding
    optimizers differentiate instead of the tables.

    ``dense_microbatch`` runs the dense tail (bottom MLP + interaction +
    top MLP) as N per-slice computations over the batch while the
    embedding gather stays whole-batch.  Mathematically identical at
    dropout 0 (per-slice dropout draws fresh masks).  1 = off.

    ``embed_kw`` passes construction kwargs to the embedding layout
    (engine / mesh / capacity_factor / num_groups / param_dtype ...; see
    ops/embedding.py ENGINES) — how the Trainer/CLI select the explicit
    sharded-lookup engines.
    """

    def __init__(
        self,
        schema: FeatureSchema,
        bottom_units: Sequence[int] = (256, 64),
        top_units: Sequence[int] = (256, 128, 64),
        self_interaction: bool = False,
        dropout_rate: float = 0.0,
        compute_dtype=None,
        sparse_embed_grads: bool = False,
        dense_microbatch: int = 1,
        embed_kw: dict | None = None,
    ):
        self.schema = schema
        self.bottom_units = tuple(bottom_units)
        self.top_units = tuple(top_units)
        self.self_interaction = self_interaction
        self.dropout_rate = dropout_rate
        self.compute_dtype = compute_dtype
        self.sparse_embed_grads = sparse_embed_grads
        self.dense_microbatch = dense_microbatch
        self.embed_kw = embed_kw
        self.layout = EmbeddingLayout(schema, **(embed_kw or {}))

    @staticmethod
    def _mlp_names(has_dense: bool) -> tuple[str | None, str]:
        return ("MLP_0", "MLP_1") if has_dense else (None, "MLP_0")

    def init(self, rngs, batch: dict, *, training: bool = False) -> dict:
        """Variables ``{"params": ..., ["perturbations": ...],
        ["a2a_stats": ...]}`` for a batch shaped like ``batch``."""
        del training
        key = rngs["params"] if isinstance(rngs, dict) else rngs
        k_emb, k_bot, k_top = jax.random.split(key, 3)
        sparse, dense = batch["sparse"], batch.get("dense")
        has_dense = dense is not None and dense.shape[-1] > 0
        d = self.schema.embed_dim
        params = {EMB: self.layout.init(k_emb)}
        bottom_name, top_name = self._mlp_names(has_dense)
        n_vec = len(self.schema.sparse)
        if has_dense:
            params[bottom_name] = mlp.mlp_init(
                k_bot, dense.shape[-1], self.bottom_units, d
            )
            n_vec += 1
        n_inter = n_vec * (n_vec + 1 if self.self_interaction
                           else n_vec - 1) // 2
        params[top_name] = mlp.mlp_init(
            k_top, (d if has_dense else 0) + n_inter, self.top_units, 1
        )
        variables = {"params": params}
        if self.sparse_embed_grads:
            variables["perturbations"] = {EMB: {"stacked_out": jnp.zeros(
                (sparse.shape[0], len(self.schema.sparse), d),
                self.layout.param_dtype,
            )}}
        if self.layout.engine in _A2A_ENGINES:
            n_groups = len({self.layout.group_of[f.name]
                            for f in self.schema.sparse})
            variables["a2a_stats"] = {EMB: {"dropped": tuple(
                jnp.zeros((), jnp.int32) for _ in range(n_groups)
            )}}
        return variables

    def apply(self, variables: dict, batch: dict, *, training: bool = False,
              rngs=None, mutable=False):
        """Logits (B,) float32; with ``mutable``, ``(logits, updates)``
        where ``updates`` holds this step's ``a2a_stats`` (if any)."""
        params = variables["params"]
        sparse, dense = batch["sparse"], batch.get("dense")
        has_dense = dense is not None and dense.shape[-1] > 0
        bottom_name, top_name = self._mlp_names(has_dense)
        with jax.named_scope("embedding_gather"):
            field_embs, dropped = self.layout.embed(params[EMB], sparse)
        pert = variables.get("perturbations")
        if pert is not None:
            field_embs = field_embs + pert[EMB]["stacked_out"]
        if self.compute_dtype is not None:
            field_embs = field_embs.astype(self.compute_dtype)
        rng = None
        if training and self.dropout_rate > 0.0:
            rng = rngs["dropout"] if isinstance(rngs, dict) else rngs

        def tail(dense_s, fe_s, rng_s):
            feats, bottom = fe_s, None
            if has_dense:
                with jax.named_scope("bottom_mlp"):
                    bottom = mlp.mlp_apply(params[bottom_name], dense_s,
                                           dtype=self.compute_dtype)
                feats = jnp.concatenate(
                    [bottom[:, None, :].astype(fe_s.dtype), fe_s], axis=1
                )
            with jax.named_scope("interaction"):
                inter = interactions.dot_interaction(
                    feats, self_interaction=self.self_interaction
                )
            top_in = inter if bottom is None else jnp.concatenate(
                [bottom.astype(inter.dtype), inter], axis=-1
            )
            with jax.named_scope("top_mlp"):
                return mlp.mlp_apply(
                    params[top_name], top_in,
                    dropout_rate=self.dropout_rate, training=training,
                    rng=rng_s, dtype=self.compute_dtype,
                )[..., 0]

        nm = self.dense_microbatch
        b = sparse.shape[0]
        if nm <= 1 or b % nm:
            logits = tail(dense, field_embs, rng)
        else:
            # unrolled slices share one param set; the gather above stays
            # whole-batch
            bs = b // nm
            logits = jnp.concatenate([
                tail(
                    dense[i * bs:(i + 1) * bs] if has_dense else None,
                    field_embs[i * bs:(i + 1) * bs],
                    None if rng is None else jax.random.fold_in(rng, i),
                )
                for i in range(nm)
            ])
        logits = logits.astype(jnp.float32)
        if not mutable:
            return logits
        updates = {}
        if dropped:
            updates["a2a_stats"] = {EMB: {"dropped": tuple(dropped)}}
        return logits, updates
