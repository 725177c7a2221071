"""Row-sharded embedding lookup over the `model` mesh axis.

The centerpiece the reference lacks (SURVEY.md §2.5: every reference table
is replicated per device).  Two complementary paths:

1. **Compiler-partitioned** (default): shard the stacked table with
   ``PartitionSpec('model', None)`` (parallel.mesh.table_sharding) and let
   XLA's SPMD partitioner turn ``jnp.take`` into the masked-local-gather +
   all-reduce pattern.  Zero custom code in the model; this is what
   `__graft_entry__.dryrun_multichip` exercises.

2. **Explicit shard_map engine** (this module): the same computation written
   out — each shard masks the IDs that fall in its row range, gathers
   locally, zeroes the misses, and ``psum``s partial embeddings over the
   `model` axis (each global row lives on exactly one shard, so the sum IS
   the lookup).  The backward pass through this code is the local
   scatter-add each shard needs — no gradient all-to-all for table rows.
   This form is the substrate for dedup/capacity optimisations.

Also provides ``unique_with_counts_static`` — the static-shape dedup step
for the ID exchange (SURVEY.md §7.3 "duplicate-ID dedup before all-to-all").
"""
from __future__ import annotations


import jax
import numpy as np
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from recsys_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS, pad_to_multiple


def shard_table(table: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a (V, D) table row-sharded over the model axis (V padded by
    caller to a multiple of the axis size if needed)."""
    return jax.device_put(table, NamedSharding(mesh, P(MODEL_AXIS, None)))


def sharded_gather(
    table: jnp.ndarray, rows: jnp.ndarray, mesh: Mesh,
    data_sharded_rows: bool = True,
) -> jnp.ndarray:
    """Lookup ``rows`` (int32, any shape) in a row-sharded ``table``.

    table: (V, D) with V divisible by mesh model-axis size; rows hold global
    row ids.  Returns rows.shape + (D,), sharded over `data` on the leading
    axis when ``data_sharded_rows``.
    """
    rows_spec = P(DATA_AXIS) if data_sharded_rows else P()

    def local_lookup(table_shard, rows_local):
        # table_shard: (V/S, D) — this shard's contiguous row block
        shard = jax.lax.axis_index(MODEL_AXIS)
        v_local = table_shard.shape[0]
        lo = shard * v_local
        local = rows_local - lo
        hit = (local >= 0) & (local < v_local)
        safe = jnp.where(hit, local, 0)
        emb = jnp.take(table_shard, safe, axis=0)
        emb = emb * hit[..., None].astype(emb.dtype)
        # each global row id exists on exactly one shard -> sum == lookup
        return jax.lax.psum(emb, MODEL_AXIS)

    fn = shard_map(
        local_lookup,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), rows_spec),
        out_specs=rows_spec,
        check_vma=False,
    )
    return fn(table, rows.astype(jnp.int32))


def sharded_gather_dedup(
    table: jnp.ndarray, rows: jnp.ndarray, mesh: Mesh,
) -> jnp.ndarray:
    """Like :func:`sharded_gather` but dedups IDs per data shard first.

    CTR batches repeat hot IDs heavily; deduping before the cross-shard
    exchange cuts the psum payload's effective information (XLA still moves
    the same padded buffer, but the local gather + backward scatter-add
    touch each unique row once).
    """

    def local_fn(table_shard, rows_local):
        shape = rows_local.shape
        flat = rows_local.reshape(-1)
        uniq, inv = unique_with_counts_static(flat)
        shard = jax.lax.axis_index(MODEL_AXIS)
        v_local = table_shard.shape[0]
        lo = shard * v_local
        local = uniq - lo
        hit = (local >= 0) & (local < v_local)
        emb = jnp.take(table_shard, jnp.where(hit, local, 0), axis=0)
        emb = emb * hit[:, None].astype(emb.dtype)
        emb = jax.lax.psum(emb, MODEL_AXIS)
        return jnp.take(emb, inv, axis=0).reshape(*shape, emb.shape[-1])

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return fn(table, rows.astype(jnp.int32))



# -- a2a building blocks (shared by the single-shot and pipelined engines) --

def _a2a_bucket(ids, v_local, n_model, cap):
    """Owner-bucket one chunk's ids -> (send (S, C), undo state, dropped).

    Slot 0 of each bucket means "no id" (ids are shifted +1); ids past an
    owner's capacity are dropped by the mode='drop' scatter and later
    produce zero vectors via the overflow mask.  NEGATIVE ids are padding
    (e.g. the -1 fill of :func:`unique_with_counts_static` or the pipelined
    engine's chunk padding): they consume NO capacity, cross no wire, and
    come back as zero vectors.  ``dropped`` counts the real (non-padding)
    ids this shard could not serve — the overflow signal surfaced by
    ``return_stats``."""
    n = ids.shape[0]
    valid = ids >= 0
    # invalid ids get the out-of-range owner S: bincount drops them, the
    # stable sort puts them last, and the send scatter's mode='drop'
    # discards their slots
    owner = jnp.where(valid, ids // v_local, n_model)
    order = jnp.argsort(owner, stable=True)
    sorted_ids = ids[order]
    sorted_owner = owner[order]
    counts = jnp.bincount(owner, length=n_model)
    group_start = jnp.cumsum(counts) - counts
    pos_in_group = jnp.arange(n) - group_start[
        jnp.minimum(sorted_owner, n_model - 1)
    ]
    send = jnp.zeros((n_model, cap), jnp.int32)
    send = send.at[sorted_owner, pos_in_group].set(sorted_ids + 1, mode="drop")
    dropped = jnp.sum(
        ((pos_in_group >= cap) & (sorted_owner < n_model)).astype(jnp.int32)
    )
    return send, (order, sorted_owner, pos_in_group), dropped


def _a2a_serve(table_shard, recv):
    """Gather this shard's rows for the received (S, C) requests."""
    v_local = table_shard.shape[0]
    got = recv.reshape(-1)
    valid = got > 0
    local = jnp.where(valid, got - 1, 0) - jax.lax.axis_index(
        MODEL_AXIS
    ) * v_local
    local = jnp.clip(local, 0, v_local - 1)
    emb = jnp.take(table_shard, local, axis=0)
    return emb * valid[:, None].astype(emb.dtype)


def _a2a_unbucket(back, state, n_model, cap, d):
    """Undo the owner sort; zero overflowed (dropped) and padding slots."""
    order, sorted_owner, pos_in_group = state
    flat = back.reshape(n_model * cap, d)
    slot = sorted_owner * cap + pos_in_group
    dead = (pos_in_group >= cap) | (sorted_owner >= n_model)
    gathered = jnp.take(flat, jnp.clip(slot, 0, n_model * cap - 1), axis=0)
    gathered = gathered * (~dead)[:, None].astype(gathered.dtype)
    return jnp.zeros_like(gathered).at[order].set(gathered)


def a2a_capacity(n: int, n_model: int, capacity_factor: float | None) -> int:
    """Owner-bucket slot count for an n-id exchange.

    ``capacity_factor=None`` is the EXACT mode: every id is served even if
    all n land on one owner (cap = n) — the escape hatch when drops are
    unacceptable and the skew is unknown.  Otherwise
    ``cap = ceil(n / S * capacity_factor)``; uniform ids need ~1.3,
    production skew typically 2-4 with ``return_stats`` watching the
    dropped counter (see StackedEmbedding's ``a2a_dropped`` surface).
    """
    if capacity_factor is None:
        return n
    return min(n, int(np.ceil(n / n_model * capacity_factor)))


def sharded_gather_a2a(
    table: jnp.ndarray,
    rows: jnp.ndarray,
    mesh: Mesh,
    capacity_factor: float | None = 2.0,
    dedup: bool = False,
    return_stats: bool = False,
):
    """Row-sharded lookup via explicit all-to-all ID exchange.

    The production pattern for large tables (SURVEY.md §2.5 north star):
    each data shard buckets its IDs by owner model-shard, exchanges the
    buckets with ``all_to_all`` (payload: IDs), owners gather their rows
    locally, and a second ``all_to_all`` returns the vectors.

    Comm accounting (measured at the compiled-HLO level by
    tools/comm_bytes.py — see BASELINE.md "collective bytes"): per data
    shard with N lookups, the vector exchange moves ``capacity_factor *
    N*D`` each way vs the psum engine's N*D all-reduce, and a ring
    all-reduce costs ~2x its payload on the wire while an all-to-all
    costs ~(S-1)/S of its.  Net: the a2a engine's wire advantage is
    ~2/capacity_factor (e.g. 1.6x at cf=1.25), NOT the O(N*D/S) an
    earlier revision of this docstring claimed — every data shard still
    receives its full N*D vectors back whatever S is.  The engine's
    *other* wins are what production needs it for: the owner shard
    gathers/scatter-adds only its OWN rows (no full-output partial-sum
    buffer per model shard), and ``dedup=True`` collapses hot ids before
    the exchange so skewed traffic fits a small capacity_factor.

    Static shapes via a capacity factor: each owner bucket holds
    ``C = ceil(N / S * capacity_factor)`` slots; IDs beyond an owner's
    capacity are dropped and produce ZERO vectors.  ``capacity_factor=None``
    is the exact mode (C = N, no drop possible at any skew).  With
    ``return_stats=True`` returns ``(out, dropped)`` where ``dropped`` is
    the GLOBAL number of ids that overflowed this step (an int32 scalar,
    replicated) — wire it into training metrics so capacity overflow is an
    observable, never a silent quality regression.  Negative ids are
    treated as padding (zero vector, no capacity consumed).
    """
    n_model = mesh.shape[MODEL_AXIS]

    def local_fn(table_shard, rows_local):
        shape = rows_local.shape
        ids = rows_local.reshape(-1)
        if dedup:
            # SURVEY.md §7.3: duplicate-ID dedup before the exchange — hot
            # IDs cross the wire once; the inverse map re-expands after
            ids, inverse = unique_with_counts_static(ids)
        n = ids.shape[0]
        v_local = table_shard.shape[0]
        d = table_shard.shape[-1]
        cap = a2a_capacity(n, n_model, capacity_factor)

        send, state, dropped = _a2a_bucket(ids, v_local, n_model, cap)
        # exchange: shard s receives every shard's bucket destined for it
        recv = jax.lax.all_to_all(
            send, MODEL_AXIS, split_axis=0, concat_axis=0, tiled=False
        )  # (S, C) on each shard: rows requested from THIS shard
        emb = _a2a_serve(table_shard, recv)
        # return the vectors to the requesting shards
        back = jax.lax.all_to_all(
            emb.reshape(n_model, cap, -1), MODEL_AXIS,
            split_axis=0, concat_axis=0, tiled=False,
        )  # (S, C, D): bucket s holds vectors for MY requests to shard s
        out = _a2a_unbucket(back, state, n_model, cap, d)
        if dedup:
            out = jnp.take(out, inverse, axis=0)
        out = out.reshape(*shape, d)
        if not return_stats:
            return out
        return out, jax.lax.psum(dropped, DATA_AXIS)

    out_specs = (P(DATA_AXIS), P()) if return_stats else P(DATA_AXIS)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), P(DATA_AXIS)),
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(table, rows.astype(jnp.int32))


def sharded_gather_a2a_pipelined(
    table: jnp.ndarray,
    rows: jnp.ndarray,
    mesh: Mesh,
    num_chunks: int = 2,
    capacity_factor: float | None = 2.0,
    dedup: bool = False,
    return_stats: bool = False,
):
    """:func:`sharded_gather_a2a` with an explicit comm/compute pipeline.

    The batch is split into ``num_chunks`` id chunks and the schedule is
    issued as: ALL id all-to-alls first (mutually independent), then per
    chunk the local gather followed by its vector all-to-all.  With the
    chunks' collectives data-independent of each other's compute, XLA's
    latency-hiding scheduler can run chunk k's return exchange while chunk
    k+1's local gather computes.  The independence structure is PROVEN at the jaxpr
    level by tests/test_pipeline_structure.py: each return exchange
    transitively depends on its own id exchange only.

    Capacity: each chunk's owner buckets are sized from the CHUNK's id
    count — ``cap = a2a_capacity(ceil(n/k), S, capacity_factor)`` — so the
    pipeline moves the SAME total bytes as the single-shot engine (the
    round-3 comm-bytes audit caught the earlier unchunked-n sizing moving
    k x the single-shot payload, which made the engine strictly worse on
    the wire).  Drop semantics under a finite ``capacity_factor`` are
    therefore PER CHUNK: a bursty chunk can overflow an owner bucket the
    whole-batch sizing would have absorbed — the ``a2a_dropped`` counter
    surfaces it, and ``capacity_factor=None`` (cap = chunk length) remains
    exactly never-dropping at any skew.  Chunk padding uses the id -1,
    which consumes no capacity (it is not bucketed to owner 0).

    ``dedup=True`` dedups the ids BEFORE chunking (hot ids cross the wire
    once, exactly like the single-shot engine; the -1 pad slots of the
    static dedup ride the chunks as ordinary padding) and re-expands with
    the inverse map after the pipeline (VERDICT r2 weak #8).
    """
    n_model = mesh.shape[MODEL_AXIS]

    def local_fn(table_shard, rows_local):
        shape = rows_local.shape
        flat = rows_local.reshape(-1)
        if dedup:
            flat, inverse = unique_with_counts_static(flat)
        n = flat.shape[0]
        k = max(1, min(num_chunks, n))
        pad = pad_to_multiple(n, k) - n
        flat = jnp.concatenate([flat, jnp.full(pad, -1, flat.dtype)])
        chunks = flat.reshape(k, -1)
        # per-CHUNK capacity: total wire bytes match the single-shot
        # engine (see docstring; finite-cf drops become per-chunk)
        cap = a2a_capacity(chunks.shape[1], n_model, capacity_factor)
        d = table_shard.shape[-1]

        v_local = table_shard.shape[0]
        # phase A: every chunk's id exchange, issued back to back
        sends, states, recvs = [], [], []
        dropped = jnp.zeros((), jnp.int32)
        for c in range(k):
            send, st, drop_c = _a2a_bucket(chunks[c], v_local, n_model, cap)
            sends.append(send)
            states.append(st)
            dropped = dropped + drop_c
        for c in range(k):
            recvs.append(jax.lax.all_to_all(
                sends[c], MODEL_AXIS, split_axis=0, concat_axis=0,
                tiled=False,
            ))
        # phase B: local gather + return exchange, chunk by chunk — chunk
        # c's return a2a is independent of chunk c+1's gather
        outs = []
        for c in range(k):
            emb = _a2a_serve(table_shard, recvs[c])
            back = jax.lax.all_to_all(
                emb.reshape(n_model, cap, d), MODEL_AXIS,
                split_axis=0, concat_axis=0, tiled=False,
            )
            outs.append(_a2a_unbucket(back, states[c], n_model, cap, d))
        out = jnp.concatenate(outs, axis=0)[:n]
        if dedup:
            out = jnp.take(out, inverse, axis=0)
        out = out.reshape(*shape, d)
        if not return_stats:
            return out
        return out, jax.lax.psum(dropped, DATA_AXIS)

    out_specs = (P(DATA_AXIS), P()) if return_stats else P(DATA_AXIS)
    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(MODEL_AXIS, None), P(DATA_AXIS)),
        out_specs=out_specs,
        check_vma=False,
    )
    return fn(table, rows.astype(jnp.int32))


def shard_table_cols(table: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Column-shard a (V, D) table over the model axis (D split)."""
    return jax.device_put(table, NamedSharding(mesh, P(None, MODEL_AXIS)))


def sharded_gather_cols(
    table: jnp.ndarray, rows: jnp.ndarray, mesh: Mesh
) -> jnp.ndarray:
    """Lookup in a COLUMN-sharded table: each shard gathers its D-slice
    locally (no ID exchange at all) and the slices all-gather along D.
    Best when D is large and IDs are skewed; comm is O(N*D) but the gather
    itself never crosses shards."""

    def local_fn(table_shard, rows_local):
        emb = jnp.take(table_shard, rows_local.reshape(-1), axis=0)
        full = jax.lax.all_gather(
            emb, MODEL_AXIS, axis=emb.ndim - 1, tiled=True
        )
        return full.reshape(*rows_local.shape, -1)

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(None, MODEL_AXIS), P(DATA_AXIS)),
        out_specs=P(DATA_AXIS),
        check_vma=False,
    )
    return fn(table, rows.astype(jnp.int32))


def unique_with_counts_static(ids: jnp.ndarray):
    """Static-shape dedup: returns (uniq, inverse) with uniq padded to
    ids.shape (tail slots filled with -1).

    jit-safe replacement for jnp.unique (whose output shape is dynamic):
    sorts ids, marks first occurrences, and builds an inverse map such that
    ``uniq[inverse] == ids``.  Padding slots hold -1 — the sentinel every
    lookup engine here treats as "no id" (zero vector, no a2a capacity
    consumed); the inverse map never points at them.
    """
    n = ids.shape[0]
    order = jnp.argsort(ids)
    sorted_ids = ids[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_ids[1:] != sorted_ids[:-1]]
    )
    # group index of each sorted position = cumsum(first) - 1
    group = jnp.cumsum(first) - 1
    uniq = jnp.zeros_like(ids).at[group].set(sorted_ids)
    n_uniq = group[-1] + 1
    slot = jnp.arange(n)
    uniq = jnp.where(slot < n_uniq, uniq, -1)
    inverse = jnp.zeros_like(ids).at[order].set(group)
    return uniq, inverse
