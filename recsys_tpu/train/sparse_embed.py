"""Touched-rows-only ("sparse") optimizer updates for embedding tables.

Why: differentiating through an embedding gather makes XLA materialise a
dense (V, D) cotangent by scatter-add, and a dense optimizer then reads and
writes the full table plus both Adam moments every step.  Production recsys
systems update only the rows a batch touches; this module is that path:

  1. the model's perturbation tap on the stacked gather output
     (``DLRM(sparse_embed_grads=True)``, or the flax
     ``StackedEmbedding(perturb_out=True)``) makes ``jax.grad`` w.r.t. the
     perturbation yield the per-occurrence cotangent (B, F, D) — 27 MB
     instead of a 166 MB dense table cotangent at bench shapes — while the
     tables themselves are closed over (not differentiated).
  2. Per table group: ids are deduplicated SORT-FREE (scatter-min of
     occurrence positions + compact scatter-add; see ``_dedup``) and the
     cotangent is summed per unique physical row (exact, duplicates summed
     like dense scatter-add would), with a per-sub-slot touched mask so the
     packed layout keeps strict touched-VOCAB-row semantics.
  3. The optimizer reads/writes ONLY the touched rows, with ``mode='drop'``
     scatters so the unique-padding slots fall away.

Optimizers:
  - ``lazy_adam``: TF LazyAdamOptimizer semantics — Adam moments are decayed
    and bias-corrected (global step t) only at touched rows.  Identical to
    dense Adam on every step in which a row is touched from fresh moments;
    untouched rows keep stale moments instead of decaying them (the accepted
    trade for sparse-update speed).
  - ``rowwise_adagrad``: DLRM-style AdaGrad with ONE accumulator scalar per
    row (mean of the squared row gradient), the standard choice for very
    large tables (halves optimizer-state memory vs per-element AdaGrad).

The reference has no analogue — its tables are dense Keras ``Embedding``
variables updated by dense Adam (/root/reference/src/ctr/deep_fm/model.py:
31-38 with compile(Adam) at /root/reference/src/ctr/deep_fm/train.py:50-51).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import jax
import jax.numpy as jnp

from recsys_tpu.core.features import FeatureSchema
from recsys_tpu.ops.embedding import _group_assignment

KINDS = ("lazy_adam", "rowwise_adagrad")


@dataclasses.dataclass(frozen=True)
class EmbedPlan:
    """Where the tables live and which batch columns feed each one."""

    prefix: tuple[str, ...]  # path of the StackedEmbedding param subtree
    table_names: tuple[str, ...]  # 'table_0'.. in group order
    group_cols: tuple[tuple[int, ...], ...]  # per group: schema.sparse col idx
    group_offsets: tuple[tuple[int, ...], ...]  # per group: offset per col
    packs: tuple[int, ...] = ()  # per group: vocab rows per physical row
    embed_dim: int = 0
    group_vocab: tuple[int, ...] = ()  # per group: stacked vocab size


def build_plan(params: dict, schema: FeatureSchema) -> EmbedPlan:
    """Locate the (single) StackedEmbedding subtree and map batch columns.

    Raises if the model has zero or multiple StackedEmbedding instances, or
    varlen fields (their ``lookup`` path is not covered by the perturbation
    tap, so stopping table gradients would silently drop those updates).
    """
    if schema.varlen:
        raise ValueError(
            "sparse embedding updates cover StackedEmbedding.__call__ only; "
            "schema has varlen fields whose lookup() grads would be lost"
        )
    hits: list[tuple[str, ...]] = []

    def walk(node, path):
        if isinstance(node, dict):
            if "table_0" in node and any("StackedEmbedding" in p for p in path):
                hits.append(tuple(path))
                return
            for k, v in node.items():
                walk(v, path + [k])

    walk(params, [])
    if len(hits) != 1:
        raise ValueError(
            f"expected exactly one StackedEmbedding param subtree, found "
            f"{len(hits)}: {hits}"
        )
    prefix = hits[0]
    sub = get_subtree(params, prefix)
    table_names = tuple(
        sorted((k for k in sub if k.startswith("table_")),
               key=lambda k: int(k.split("_")[1]))
    )
    owners = list(schema.sparse)
    num_groups = None if len(table_names) == len(owners) else len(table_names)
    group_of, offset_in, group_vocab = _group_assignment(schema, num_groups)
    if len(group_vocab) != len(table_names):
        raise ValueError(
            f"{len(table_names)} tables but {len(group_vocab)} groups"
        )
    cols: list[list[int]] = [[] for _ in table_names]
    offs: list[list[int]] = [[] for _ in table_names]
    for j, f in enumerate(schema.sparse):
        g = group_of[f.name]
        cols[g].append(j)
        offs[g].append(offset_in[f.name])
    d = schema.embed_dim
    # physical row width = pack * D (ops.embedding row packing), per group
    packs = tuple(sub[name].shape[1] // d for name in table_names)
    return EmbedPlan(
        prefix=prefix,
        table_names=table_names,
        group_cols=tuple(tuple(c) for c in cols),
        group_offsets=tuple(tuple(o) for o in offs),
        packs=packs,
        embed_dim=d,
        group_vocab=tuple(int(v) for v in group_vocab),
    )


# -- param-tree surgery -----------------------------------------------------

def get_subtree(params: dict, prefix: tuple[str, ...]) -> dict:
    sub = params
    for k in prefix:
        sub = sub[k]
    return sub


def split_params(params: dict, plan: EmbedPlan):
    """(rest, tables): tables is {name: array}; rest has them removed."""
    sub = get_subtree(params, plan.prefix)
    tables = {k: sub[k] for k in plan.table_names}
    rest = dict(params)
    node = rest
    for k in plan.prefix[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    leafdir = dict(sub)
    for k in plan.table_names:
        del leafdir[k]
    if plan.prefix:
        node[plan.prefix[-1]] = leafdir
    else:
        rest = leafdir
    return rest, tables


def merge_params(rest: dict, tables: dict, plan: EmbedPlan) -> dict:
    """Inverse of :func:`split_params` (shallow copies along the path)."""
    full = dict(rest)
    node = full
    for k in plan.prefix[:-1]:
        node[k] = dict(node[k])
        node = node[k]
    leafdir = dict(get_subtree(rest, plan.prefix)) if plan.prefix else full
    leafdir.update(tables)
    if plan.prefix:
        node[plan.prefix[-1]] = leafdir
    return full


def group_rows_and_cots(plan: EmbedPlan, sparse_ids: jnp.ndarray, pert_grad):
    """Per group: (rows (B*Fg,), cot (B*Fg, row_width), slot1h (B*Fg, p))
    from ids + the (B, F, D) tap — in PHYSICAL table coordinates: with a
    packed layout (plan.packs[g] > 1) the vocab row becomes its physical
    row and the cotangent is spread to the row's sub-slot (one-hot
    multiply, the same transform autodiff applies on the forward's packed
    gather).  slot1h marks which sub-slot each occurrence touches so the
    optimizers can keep strict touched-VOCAB-row semantics (sibling rows
    sharing a physical row stay untouched)."""
    out = []
    for cols, offsets, p in zip(
        plan.group_cols, plan.group_offsets, plan.packs
    ):
        rows = jnp.concatenate(
            [sparse_ids[:, j].astype(jnp.int32) + off
             for j, off in zip(cols, offsets)]
        )
        cot = jnp.concatenate([pert_grad[:, j, :] for j in cols])
        d = plan.embed_dim
        if p > 1:
            sub = rows % p
            rows = rows // p
            onehot = jax.nn.one_hot(sub, p, dtype=cot.dtype)  # (n, p)
            cot = (cot[:, None, :] * onehot[:, :, None]).reshape(-1, p * d)
        else:
            onehot = jnp.ones((rows.shape[0], 1), cot.dtype)
        out.append((rows, cot, onehot))
    return out


# -- optimizer state ---------------------------------------------------------

def init_state(tables: dict, kind: str, plan: EmbedPlan) -> dict:
    """Moment buffers matching each table's (packed) shape (and sharding,
    if placed afterwards by the caller).  rowwise_adagrad keeps one
    accumulator per VOCAB row: (V_phys, pack)."""
    # moments/accumulators stay float32 whatever the table dtype:
    # bf16 master tables (StackedEmbedding(param_dtype=bf16) — halved
    # gather + update stream bytes) must not also quantise the optimizer
    # state, where bf16's 8-bit mantissa destroys the v second-moment
    if kind == "lazy_adam":
        return {
            name: {"m": jnp.zeros(t.shape, jnp.float32),
                   "v": jnp.zeros(t.shape, jnp.float32)}
            for name, t in tables.items()
        }
    if kind == "rowwise_adagrad":
        return {
            name: {"acc": jnp.zeros((t.shape[0], p), jnp.float32)}
            for (name, t), p in zip(tables.items(), plan.packs)
        }
    raise ValueError(f"unknown sparse embedding optimizer {kind!r}: {KINDS}")


# -- the updates -------------------------------------------------------------

def _dedup(rows: jnp.ndarray, cot: jnp.ndarray, vocab: int):
    """Sort-free exact dedup.

    No sort (``jnp.unique(size=n)`` sorts): scatter-min each occurrence's position
    into a tiny (V,) int32 buffer to find first occurrences, then
    scatter-add the cotangent into a compact (n, D) buffer keyed by the
    first-occurrence position — exact duplicate summing with only O(V) int32
    + O(n*D) float traffic, no sort, no dense (V, D) cotangent.

    Returns (uids, grad): position i holds the row id if occurrence i is its
    id's first occurrence (else the out-of-range sentinel ``vocab``, dropped
    by the callers' ``mode='drop'`` scatters) and the summed cotangent.
    """
    n = rows.shape[0]
    iota = jnp.arange(n, dtype=jnp.int32)
    first = jnp.full((vocab,), n, jnp.int32).at[rows].min(iota)
    slot = first[rows]  # first-occurrence position of each occurrence's id
    grad = jnp.zeros((n,) + cot.shape[1:], cot.dtype).at[slot].add(cot)
    uids = jnp.where(slot == iota, rows, vocab)
    return uids, grad


def _dedup_with_mask(rows, cot, slot1h, vocab, pack, d):
    """Dedup cot AND the slot one-hot in one pass; returns (uids, g,
    touched) with touched (n, pack*d) True exactly at the columns of vocab
    rows some occurrence touched."""
    n = rows.shape[0]
    payload = jnp.concatenate([cot, slot1h], axis=1)
    uids, g_all = _dedup(rows, payload, vocab)
    g = g_all[:, : pack * d]
    touched = jnp.repeat(g_all[:, pack * d:] > 0, d, axis=1)  # (n, pack*d)
    touched = touched & (uids < vocab)[:, None]
    return uids, g, touched


def lazy_adam_update(
    table, m, v, rows, cot, slot1h, *, lr, step, pack=1, b1=0.9, b2=0.999,
    eps=1e-8, weight_decay=0.0,
):
    """Adam at touched VOCAB rows only; bias correction uses the global
    step (TF LazyAdam semantics).  `step` is 1-based.  With the packed
    physical layout, decay / weight decay / updates are masked to the
    touched sub-slots, so sibling vocab rows sharing a physical row keep
    strict lazy (untouched) semantics.

    Structured as pure read-modify-write scatter chains (scatter-mul then
    scatter-add, with gathers only AFTER a buffer's final write): a
    gather-then-scatter on the same donated buffer makes XLA's copy
    insertion clone the whole (V, D) buffer, a cost that scales with V,
    while a sequential RMW chain aliases in place.
    """
    vocab = table.shape[0]
    d = table.shape[1] // pack
    uids, g, touched = _dedup_with_mask(rows, cot, slot1h, vocab, pack, d)
    safe = jnp.minimum(uids, vocab - 1)
    m = m.at[uids].mul(jnp.where(touched, b1, 1.0), mode="drop")
    m = m.at[uids].add((1.0 - b1) * g, mode="drop")
    v = v.at[uids].mul(jnp.where(touched, b2, 1.0), mode="drop")
    v = v.at[uids].add((1.0 - b2) * (g * g), mode="drop")
    t = step.astype(table.dtype)
    m_hat = m[safe] / (1.0 - b1**t)
    v_hat = v[safe] / (1.0 - b2**t)
    upd = -lr * m_hat / (jnp.sqrt(v_hat) + eps)
    # mask: non-first-occurrence slots read a foreign row's moments, and
    # untouched sub-slots must not move
    upd = jnp.where(touched, upd, 0.0)
    if weight_decay:
        upd = upd - lr * weight_decay * jnp.where(touched, table[safe], 0.0)
    return table.at[uids].add(upd, mode="drop"), m, v


def rowwise_adagrad_update(
    table, acc, rows, cot, slot1h, *, lr, pack=1, eps=1e-8, weight_decay=0.0
):
    """DLRM-style rowwise AdaGrad: one accumulator per VOCAB row, fed by the
    mean squared row gradient.  With a packed physical layout the
    accumulator is (V_phys, pack) — still per vocab row; updates and weight
    decay are masked to touched sub-slots.  Same RMW-chain structure as
    lazy_adam_update."""
    vocab = table.shape[0]
    n = rows.shape[0]
    d = table.shape[1] // pack
    uids, g, touched = _dedup_with_mask(rows, cot, slot1h, vocab, pack, d)
    g_slots = g.reshape(n, pack, d)
    acc = acc.at[uids].add(jnp.mean(g_slots * g_slots, axis=-1), mode="drop")
    safe = jnp.minimum(uids, vocab - 1)
    denom = jnp.sqrt(acc[safe])[:, :, None] + eps  # (n, pack, 1)
    upd = (-lr * g_slots / denom).reshape(n, pack * d)
    upd = jnp.where(touched, upd, 0.0)
    if weight_decay:
        upd = upd - lr * weight_decay * jnp.where(touched, table[safe], 0.0)
    return table.at[uids].add(upd, mode="drop"), acc


def apply_updates(
    tables: dict,
    state: dict,
    plan: EmbedPlan,
    sparse_ids: jnp.ndarray,
    pert_grad: jnp.ndarray,
    *,
    kind: str,
    lr: float,
    step: jnp.ndarray,
    weight_decay: float = 0.0,
) -> tuple[dict, dict]:
    """One sparse optimizer step over every table group."""
    per_group = group_rows_and_cots(plan, sparse_ids, pert_grad)
    new_tables: dict[str, Any] = {}
    new_state: dict[str, Any] = {}
    for name, (rows, cot, slot1h), pk in zip(
        plan.table_names, per_group, plan.packs
    ):
        t = tables[name]
        if kind == "lazy_adam":
            nt, m, v = lazy_adam_update(
                t, state[name]["m"], state[name]["v"], rows, cot, slot1h,
                lr=lr, step=step, pack=pk, weight_decay=weight_decay,
            )
            new_tables[name], new_state[name] = nt, {"m": m, "v": v}
        elif kind == "rowwise_adagrad":
            nt, acc = rowwise_adagrad_update(
                t, state[name]["acc"], rows, cot, slot1h,
                lr=lr, pack=pk, weight_decay=weight_decay,
            )
            new_tables[name], new_state[name] = nt, {"acc": acc}
        else:
            raise ValueError(f"unknown kind {kind!r}")
    return new_tables, new_state
