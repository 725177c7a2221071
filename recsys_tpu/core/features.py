"""Typed feature schema for the recommender framework.

Generalises the reference's untyped feature-descriptor dicts
(``sparseFeature``/``denseFeature`` at /root/reference/src/ctr/utils/
data_process.py:13-30 and ``varLenSparseFeat`` at /root/reference/src/match/
utils/feature_util.py:1-29) into frozen dataclasses, and adds the one thing
the design needs that the reference does not have: a *stacked vocabulary*
view. Instead of one small Embedding table per field (reference pattern at
/root/reference/src/ctr/deep_fm/model.py:31-38), all sparse fields of equal
embed_dim share ONE (total_vocab, embed_dim) table addressed with per-field
offsets — a single large gather that XLA tiles well and that can later be
row-sharded over the `model` mesh axis.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class DenseFeature:
    """A scalar (already-normalised) float feature."""

    name: str


@dataclasses.dataclass(frozen=True)
class SparseFeature:
    """A single categorical ID feature with its own vocabulary."""

    name: str
    vocab_size: int
    embed_dim: int = 8


@dataclasses.dataclass(frozen=True)
class VarLenSparseFeature:
    """A padded variable-length sequence of categorical IDs.

    ``pad_id`` marks padding positions (the reference pads with 0 and masks on
    ``seq == 0``, /root/reference/src/match/sasrec/model.py:72).  When
    ``shared_with`` is set, the sequence reuses another sparse field's
    embedding table (e.g. DIN behaviour history sharing the item table).
    """

    name: str
    vocab_size: int
    embed_dim: int = 8
    max_len: int = 40
    pad_id: int = 0
    shared_with: str | None = None


Feature = DenseFeature | SparseFeature | VarLenSparseFeature


class FeatureSchema:
    """Groups a model's features and precomputes stacked-vocab offsets.

    The stacked table covers every ``SparseFeature`` plus every
    ``VarLenSparseFeature`` that does not share a table.  All stacked fields
    must share an ``embed_dim`` (models in this zoo always do).
    """

    def __init__(
        self,
        dense: Sequence[DenseFeature] = (),
        sparse: Sequence[SparseFeature] = (),
        varlen: Sequence[VarLenSparseFeature] = (),
    ):
        self.dense = tuple(dense)
        self.sparse = tuple(sparse)
        self.varlen = tuple(varlen)

        names = [f.name for f in self.dense + self.sparse + self.varlen]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names: {names}")

        owner_fields: list[SparseFeature | VarLenSparseFeature] = list(self.sparse)
        owner_fields += [f for f in self.varlen if f.shared_with is None]
        dims = {f.embed_dim for f in owner_fields}
        if len(dims) > 1:
            raise ValueError(f"stacked table requires one embed_dim, got {dims}")
        self.embed_dim = dims.pop() if dims else 0

        # Stacked-vocab offsets: field i's id j maps to row offsets[i] + j.
        self._offset_of: dict[str, int] = {}
        total = 0
        for f in owner_fields:
            self._offset_of[f.name] = total
            total += f.vocab_size
        self.total_vocab = total

        for f in self.varlen:
            if f.shared_with is not None:
                if f.shared_with not in self._offset_of:
                    raise ValueError(
                        f"{f.name} shares table with unknown field {f.shared_with}"
                    )
                self._offset_of[f.name] = self._offset_of[f.shared_with]

    # -- lookups -----------------------------------------------------------
    @property
    def num_dense(self) -> int:
        return len(self.dense)

    @property
    def num_sparse(self) -> int:
        return len(self.sparse)

    def offset(self, name: str) -> int:
        return self._offset_of[name]

    @property
    def sparse_offsets(self) -> np.ndarray:
        """(num_sparse,) int32 offsets aligned with `self.sparse` order."""
        return np.asarray(
            [self._offset_of[f.name] for f in self.sparse], dtype=np.int32
        )

    def field(self, name: str) -> Feature:
        for f in self.dense + self.sparse + self.varlen:
            if f.name == name:
                return f
        raise KeyError(name)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"FeatureSchema(dense={len(self.dense)}, sparse={len(self.sparse)}, "
            f"varlen={len(self.varlen)}, total_vocab={self.total_vocab}, "
            f"embed_dim={self.embed_dim})"
        )
