"""Grouped stacked-vocabulary embedding engine, as pure functions.

Replaces the reference's per-field ``Embedding`` dicts
(/root/reference/src/ctr/deep_fm/model.py:31-38,
/root/reference/src/match/dssm/model.py:24-34).

Physical layout is *grouped*: the schema's sparse fields are assigned to
``num_groups`` tables (default: one table per field), so each group's
scatter-add in the backward is an independent op, and each group table
row-shards independently over the ``model`` mesh axis.  ``num_groups=1``
recovers the single-table layout.

:class:`EmbeddingLayout` holds the static layout (group assignment, row
packing, lookup engine) and computes on an explicit param dict
``{"table_0": ..., "table_1": ...}``.  The flax adapter
(:class:`recsys_tpu.ops.linen.StackedEmbedding`) and the flax-free DLRM
(:mod:`recsys_tpu.models.ctr.dlrm`) both call it.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.kernels import embedding as embedding_kernels


def _group_assignment(schema: FeatureSchema, num_groups: int | None):
    """Assign owner fields (sparse + non-shared varlen) to group tables.

    Returns (group_of: {field: g}, offset_in_group: {field: off},
    group_vocab: [V_g]).  Fields are assigned round-robin in schema order;
    shared varlen fields inherit their owner's slot.
    """
    owners = list(schema.sparse) + [
        f for f in schema.varlen if f.shared_with is None
    ]
    n = len(owners)
    g_count = n if num_groups is None else max(1, min(num_groups, n))
    group_of: dict[str, int] = {}
    offset_in: dict[str, int] = {}
    group_vocab = [0] * g_count
    for i, f in enumerate(owners):
        g = i % g_count
        group_of[f.name] = g
        offset_in[f.name] = group_vocab[g]
        group_vocab[g] += f.vocab_size
    for f in schema.varlen:
        if f.shared_with is not None:
            group_of[f.name] = group_of[f.shared_with]
            offset_in[f.name] = offset_in[f.shared_with]
    return group_of, offset_in, group_vocab


def _pad8(n: int) -> int:
    """Round physical row counts up to a multiple of 8 (shardability)."""
    return ((n + 7) // 8) * 8


ENGINES = ("gather", "psum", "dedup", "a2a", "a2a_pipelined")

# Keras Embedding's default init, uniform(-0.05, 0.05); the reference's
# embed_reg l2 is applied by the train loop as decoupled weight decay.
TABLE_INIT_SCALE = 0.05


def init_table(key, shape, dtype=jnp.float32):
    return jax.random.uniform(
        key, shape, dtype, -TABLE_INIT_SCALE, TABLE_INIT_SCALE
    )


@dataclasses.dataclass(frozen=True, eq=False)
class EmbeddingLayout:
    """Grouped embedding tables behind a stacked-offset API.

    ``embed`` takes field-local IDs shaped (B, F) ordered like
    ``schema.sparse`` and returns (B, F, D).  ``lookup`` embeds an
    arbitrary ID tensor for one named field (varlen history / item towers).

    Physical storage is additionally ROW-PACKED (``pack_rows``): each group
    table is (ceil(V_g / p), p * D) with ``p = pack_factor(D)`` vocab rows
    per 512-byte physical row (kernels.embedding.pack_factor);
    ``table_logical`` recovers the (V, D) view (a free reshape).

    ``engine`` selects the sharded-lookup mechanism (requires ``mesh``):

    * ``'gather'`` (default) — plain ``jnp.take``; under a Trainer mesh the
      tables carry P('model', None) and XLA's SPMD partitioner emits the
      masked-local-gather + all-reduce (the compiler-partitioned path).
    * ``'psum'`` / ``'dedup'`` — the explicit shard_map psum engine
      (parallel/embedding_sharding.sharded_gather[_dedup]).
    * ``'a2a'`` — explicit all-to-all ID exchange, the production path for
      tables too large to replicate.  Comm accounting (tools/comm_bytes.py,
      artifacts/comm_bytes.json): at cf=1.25 it moves ~1.29x the psum
      engine's bytes through all-to-all, a ~2/cf wire advantage once the
      all-reduce's ~2x ring amplification is priced in; its other wins are
      owner-local gather/scatter (no full-output partial-sum buffer per
      model shard) and dedup'd hot ids.  All of a group's fields exchange
      in ONE a2a pair, so ``num_groups=1`` gives one exchange per step.
      Every call returns its dropped-id count (the Trainer surfaces the
      sum as ``history['a2a_dropped']``); ``capacity_factor=None`` is the
      exact (never-drop) mode.
    * ``'a2a_pipelined'`` — the same exchange split into ``a2a_chunks`` id
      chunks scheduled so chunk k's return a2a can overlap chunk k+1's
      local gather (independence proven at the jaxpr level,
      tests/test_pipeline_structure.py).  It moves the SAME total bytes as
      'a2a'; whether the overlap shortens a step on four cards is not
      measured yet, so 'a2a' stays the default.  Finite-cf drop accounting
      is per chunk.
    """

    schema: FeatureSchema
    param_dtype: Any = jnp.float32
    num_groups: int | None = None  # None -> one table per field
    pack_rows: bool = True
    engine: str = "gather"
    mesh: Any = None  # jax.sharding.Mesh for the explicit engines
    capacity_factor: float | None = 2.0  # None = exact (never drop)
    a2a_dedup: bool = True
    a2a_chunks: int = 2  # pipelined engine's comm/compute overlap depth

    def __post_init__(self):
        if self.engine not in ENGINES:
            raise ValueError(f"engine={self.engine!r} not in {ENGINES}")
        if self.engine != "gather" and self.mesh is None:
            raise ValueError(
                f"engine={self.engine!r} needs a mesh (pass the Trainer's)"
            )
        d = self.schema.embed_dim
        group_of, offset_in, group_vocab = _group_assignment(
            self.schema, self.num_groups
        )
        packs = [
            embedding_kernels.pack_factor(d, v) if self.pack_rows else 1
            for v in group_vocab
        ]
        set_ = object.__setattr__
        set_(self, "group_of", group_of)
        set_(self, "offset_in", offset_in)
        set_(self, "group_vocab", list(group_vocab))
        set_(self, "packs", packs)

    # -- params -----------------------------------------------------------
    def table_shapes(self) -> list[tuple[int, int]]:
        """Physical (rows, pack * D) per group; rows padded to a multiple
        of 8 so the tables stay row-shardable over small model axes."""
        d = self.schema.embed_dim
        return [
            (_pad8(-(-max(v, 1) // p)), p * d)
            for v, p in zip(self.group_vocab, self.packs)
        ]

    def init(self, key) -> dict:
        keys = jax.random.split(key, len(self.group_vocab))
        return {
            f"table_{g}": init_table(k, shape, self.param_dtype)
            for g, (k, shape) in enumerate(zip(keys, self.table_shapes()))
        }

    # -- lookups ------------------------------------------------------------
    def pack(self, field_name: str) -> int:
        return self.packs[self.group_of[field_name]]

    def field_offset(self, field_name: str) -> int:
        return self.offset_in[field_name]

    def _fetch_wide(self, tables: dict, g: int, prows):
        """Fetch PHYSICAL rows ``prows`` of group table ``g`` through the
        engine; returns (prows.shape + (pack*D,), dropped count or None)."""
        table = tables[f"table_{g}"]
        if self.engine == "gather":
            return jnp.take(table, prows, axis=0), None
        from recsys_tpu.parallel import embedding_sharding as es

        if self.engine == "psum":
            return es.sharded_gather(table, prows, self.mesh), None
        if self.engine == "dedup":
            return es.sharded_gather_dedup(table, prows, self.mesh), None
        if self.engine == "a2a":
            return es.sharded_gather_a2a(
                table, prows, self.mesh,
                capacity_factor=self.capacity_factor,
                dedup=self.a2a_dedup, return_stats=True,
            )
        return es.sharded_gather_a2a_pipelined(
            table, prows, self.mesh, num_chunks=self.a2a_chunks,
            capacity_factor=self.capacity_factor,
            dedup=self.a2a_dedup, return_stats=True,
        )

    def gather_rows(self, tables: dict, g: int, rows):
        """Vocab-row gather via the engine (physical fetch + sub-select);
        returns (embeddings, dropped count or None)."""
        pack = self.packs[g]
        prows = rows // pack if pack > 1 else rows
        wide, dropped = self._fetch_wide(tables, g, prows)
        return embedding_kernels.packed_select(
            wide, rows, pack, self.schema.embed_dim
        ), dropped

    def embed(self, tables: dict, sparse_ids):
        """(B, F) field-local ids -> ((B, F, D), [dropped counts]).

        Group-batched: all of a group's field columns fetch in ONE engine
        call, so the explicit engines do one collective pair per group."""
        by_group: dict[int, list[int]] = {}
        for j, f in enumerate(self.schema.sparse):
            by_group.setdefault(self.group_of[f.name], []).append(j)
        cols: list = [None] * len(self.schema.sparse)
        dropped = []
        for g, js in by_group.items():
            offs = jnp.asarray(
                [self.offset_in[self.schema.sparse[j].name] for j in js],
                jnp.int32,
            )
            rows = sparse_ids[:, js].astype(jnp.int32) + offs[None, :]
            emb, drop = self.gather_rows(tables, g, rows)  # (B, |js|, D)
            if drop is not None:
                dropped.append(drop)
            for i, j in enumerate(js):
                cols[j] = emb[:, i, :]
        return jnp.stack(cols, axis=1), dropped

    def lookup(self, tables: dict, field_name: str, ids):
        """Embed `ids` (any shape) using `field_name`'s table slice;
        returns (embeddings, dropped count or None)."""
        g = self.group_of[field_name]
        rows = ids.astype(jnp.int32) + self.offset_in[field_name]
        return self.gather_rows(tables, g, rows)

    def pooled_lookup(self, tables: dict, field_name: str, ids, mask, *,
                      mode: str = "mean"):
        """Masked-pooled embedding of a padded (B, L) id sequence; returns
        ((B, D), dropped count or None)."""
        g = self.group_of[field_name]
        if self.engine == "gather" and self.packs[g] == 1 and ids.ndim == 2:
            rows = ids.astype(jnp.int32) + self.offset_in[field_name]
            return embedding_kernels.segment_sum_gather(
                tables[f"table_{g}"], rows, mask, mode=mode
            ), None
        emb, dropped = self.lookup(tables, field_name, ids)
        return embedding_kernels.pool(emb, mask, mode=mode), dropped

    def table_for(self, tables: dict, field_name: str):
        """The raw PHYSICAL (row-packed) group table holding `field_name`.

        Do NOT index this with logical ids (+field_offset): use ``lookup``
        for embeddings or ``table_logical`` for a (V, D) view;
        ``pack(field_name)`` gives the rows-per-physical-row factor.
        """
        return tables[f"table_{self.group_of[field_name]}"]

    def table_logical(self, tables: dict, field_name: str):
        """(V_group, D) logical view of `field_name`'s group table (padding
        rows from the packed layout sliced off)."""
        g = self.group_of[field_name]
        t = tables[f"table_{g}"]
        if self.packs[g] == 1:
            return t[: self.group_vocab[g]]
        return t.reshape(-1, self.schema.embed_dim)[: self.group_vocab[g]]
