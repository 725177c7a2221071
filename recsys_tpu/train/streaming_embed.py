"""Dense-Adam / rowwise-AdaGrad table updates from the perturbation tap.

The ``fused_adam`` / ``fused_rowwise_adagrad`` embedding path: EXACT
dense-optimizer semantics (the same math as optax.adam on the dense
scatter-add gradient -- every row decayed, duplicate ids summed) without
differentiating through the tables.

Composition per step and table group:
  1. HOST (numpy, runs in the Trainer's prefetch thread): stable-argsort
     the batch's vocab ids by physical row and pad each table block's
     segment to CH-multiples at a STATIC total chunk count (no recompiles),
     emitting (ids2d, idx, cptr) -- :func:`host_prep_group` /
     :func:`make_host_prep`.
  2. XLA: permute the (n, D) cotangent rows into that order with one
     narrow gather per group.
  3. XLA: scatter-add the rows into a dense gradient and apply the
     optimizer in one elementwise pass over table and moments
     (:func:`_xla_group_update`).

Like train/sparse_embed.py, the tables are closed over (not
differentiated) and the per-occurrence cotangent arrives through the
StackedEmbedding ``perturb_out`` tap; unlike it, the update is exactly
dense Adam (no lazy semantics, no dedup approximation choices).

Reference perf surface: the embedding update dominating every reference
CTR train loop (/root/reference/src/ctr/deep_fm/train.py:58-65).
"""
from __future__ import annotations

import jax
import numpy as np
import jax.numpy as jnp

from recsys_tpu.train.sparse_embed import EmbedPlan

# host-prep geometry: table rows per block, ids per chunk
DEFAULT_BLOCK = 512
DEFAULT_CH = 256


def _pad8(n: int) -> int:
    return ((n + 7) // 8) * 8


def host_prep_group(
    rows: np.ndarray, *, pack: int, vp: int, block: int = DEFAULT_BLOCK,
    ch: int = DEFAULT_CH, shards: int = 1, use_native: bool = True,
):
    """Sort/bucket one group's vocab-row ids for the table update.

    rows: (n,) int32 vocab ids (field offsets already applied).
    Returns (ids2d (nc_max, ch) int32, idx (nc_max*ch,) int32,
    cptr (nb+1,) int32) with the STATIC nc_max = n//ch + nb.

    ``shards`` > 1 (model-axis row sharding, vp % shards == 0) aligns the
    block boundaries to the shard boundaries: shard ``s`` owns physical
    rows [s*vs, (s+1)*vs) split into nb_s = ceil(vs/block) blocks, so
    shard ``s``'s rows occupy the chunk window
    ``cptr[s*nb_s : (s+1)*nb_s + 1]``; the device update rebases ids by
    ``s*vs*pack`` (apply_updates_fused).  The sort key (physical row)
    is unchanged; only where the block fences fall moves.

    The native C++ counting-sort path (native/recsys_native.cc fused_prep,
    bit-exact with this builder) runs when the library is available —
    O(n + vp) single pass vs numpy's argsort, keeping the prefetch
    thread ahead of sub-10ms device steps.
    """
    if shards > 1 and vp % shards:
        raise ValueError(f"vp={vp} not divisible by shards={shards}")
    if use_native:
        try:
            from recsys_tpu.data import native

            if native.available():
                return native.fused_prep(rows, pack, vp, block, ch,
                                         shards=shards)
        except Exception:
            pass
    n = rows.shape[0]
    vs = vp // shards
    nb_s = -(-vs // block)
    nb = shards * nb_s
    sentinel = np.int32(nb * block * pack)
    prow = rows // pack
    order = np.argsort(prow, kind="stable").astype(np.int32)
    # block fences: within each shard, nb_s fences at s*vs + j*block
    # (clamped to the shard end); shards=1 reduces to arange(nb+1)*block
    s_idx = np.arange(nb + 1) // nb_s
    j_idx = np.arange(nb + 1) - s_idx * nb_s
    bounds = np.minimum(s_idx * vs + j_idx * block, np.minimum(
        (s_idx + 1) * vs, vp))
    ptr = np.searchsorted(prow[order], bounds)
    seg_lens = np.diff(ptr)
    chunks = -(-seg_lens // ch)
    cptr = np.concatenate([[0], np.cumsum(chunks)]).astype(np.int32)
    nc_max = n // ch + nb
    ids2d = np.full((max(nc_max, 1), ch), sentinel, np.int32)
    idx = np.zeros((max(nc_max, 1) * ch,), np.int32)
    flat_ids = ids2d.reshape(-1)
    for k in range(nb):
        lo, hi = ptr[k], ptr[k + 1]
        base = cptr[k] * ch
        flat_ids[base:base + hi - lo] = rows[order[lo:hi]]
        idx[base:base + hi - lo] = order[lo:hi]
    # absorb the static padding chunks into the LAST block (sentinel ids,
    # zero contribution — a bounded matmul overhead, never a recompile)
    cptr[nb] = nc_max
    return ids2d, idx, cptr


def group_shards(plan: EmbedPlan, g: int, model_shards: int) -> int:
    """Shard count the fused path uses for group ``g``: the model-axis
    size when the packed table's physical rows divide it (the same
    condition parallel/sharding_rules.py uses to row-shard the param),
    else 1 (the table stays replicated and every device runs the full
    update identically).

    Fallback predicate only — the Trainer derives the per-table count from
    each placed table leaf's ACTUAL NamedSharding (loop.py `_fused_shards`)
    and threads it through ``shards_by_name``, so prep fences cannot drift
    from real placement if the sharding rule changes."""
    pack = plan.packs[g]
    vocab = max(plan.group_vocab[g], 1)
    vp = _pad8(-(-vocab // pack))
    return model_shards if model_shards > 1 and vp % model_shards == 0 else 1


def make_host_prep(plan: EmbedPlan, block: int = DEFAULT_BLOCK,
                   ch: int = DEFAULT_CH, model_shards: int = 1,
                   shards_by_name: dict | None = None,
                   data_shards: int = 1):
    """Returns fn(sparse (B, F) np.int32) -> {aux key: np.ndarray}.

    The aux keys ride the batch dict into the jitted train step (static
    shapes for a fixed batch size).  Runs on the host — put it behind the
    prefetch thread, as Trainer.fit does.  ``shards_by_name`` (preferred:
    table name -> shard count, derived from the placed tables' actual
    NamedShardings) or ``model_shards`` (the predicate fallback) must match
    what apply_updates_fused runs with: it aligns each group's block fences
    to the row-shard boundaries (see :func:`host_prep_group`).

    ``data_shards > 1`` — the host-LOCAL prep contract: the (B, F) batch
    passed to ``prep`` is split into ``data_shards`` equal row slices (the
    data-axis shards this process feeds) and each slice is sorted
    INDEPENDENTLY, so host work is O(rows this process holds), never
    O(global batch).  Aux arrays gain a leading ``data_shards`` axis
    (stream-per-shard) that apply_updates_fused consumes stream by
    stream; under multi-process feeding the leading axis is this
    process's share and jax.make_array_from_process_local_data assembles
    the global (total_data_shards, ...) arrays.
    """
    geoms = []
    for g in range(len(plan.table_names)):
        pack = plan.packs[g]
        vocab = max(plan.group_vocab[g], 1)
        vp = _pad8(-(-vocab // pack))
        if shards_by_name is not None:
            shards = shards_by_name.get(plan.table_names[g], 1)
        else:
            shards = group_shards(plan, g, model_shards)
        geoms.append((pack, vp, min(block, vp // shards), shards))

    def prep_one(sparse: np.ndarray) -> dict:
        aux = {}
        for g, (pack, vp, blk, shards) in enumerate(geoms):
            cols = plan.group_cols[g]
            offs = plan.group_offsets[g]
            rows = np.concatenate([
                sparse[:, j].astype(np.int32) + off
                for j, off in zip(cols, offs)
            ])
            ids2d, idx, _ = host_prep_group(
                rows, pack=pack, vp=vp, block=blk, ch=ch, shards=shards
            )
            aux[f"embaux{g}_ids"] = ids2d
            aux[f"embaux{g}_idx"] = idx
        return aux

    if data_shards == 1:
        return prep_one

    def prep(sparse: np.ndarray) -> dict:
        n = sparse.shape[0]
        if n % data_shards:
            raise ValueError(
                f"batch rows {n} not divisible by data_shards={data_shards}"
            )
        bs = n // data_shards
        per = [prep_one(sparse[s * bs:(s + 1) * bs])
               for s in range(data_shards)]
        return {
            k: np.stack([p[k] for p in per]) for k in per[0]
        }

    return prep


def _xla_group_update(t, state, cot_sorted, ids2d, *, pack, d, lr, step,
                      wd, kind, b1=0.9, b2=0.999, eps=1e-8):
    """Exact dense Adam / rowwise AdaGrad for one table group.

    Consumes the host-prep arrays (cotangent rows in ids2d order, ids2d
    padded with sentinels; cptr is not needed): scatter-add the
    per-occurrence cotangents into a dense (vp, pack, d) float32 gradient,
    then one elementwise optimizer pass over table and moments.  Ids
    outside ``[0, vp * pack)`` -- the prep's sentinels, and under a model
    axis the rows another shard owns -- index past the last row and are
    dropped by the scatter."""
    vp, wide = t.shape
    ids = ids2d.reshape(-1)
    cot = cot_sorted.reshape(-1, d).astype(jnp.float32)
    valid = (ids >= 0) & (ids < vp * pack)
    prow = jnp.where(valid, ids // pack, vp)
    sub = jnp.where(valid, ids % pack, 0)
    g = (
        jnp.zeros((vp, pack, d), jnp.float32)
        .at[prow, sub].add(cot, mode="drop")
        .reshape(vp, wide)
    )
    p_cur = t.astype(jnp.float32)
    if kind == "adam":
        tf = step.astype(jnp.float32)
        m = b1 * state["m"] + (1.0 - b1) * g
        v = b2 * state["v"] + (1.0 - b2) * g * g
        upd = lr * (m / (1.0 - b1 ** tf)) / (
            jnp.sqrt(v / (1.0 - b2 ** tf)) + eps
        )
        if wd:
            upd = upd + lr * wd * p_cur
        return (p_cur - upd).astype(t.dtype), {"m": m, "v": v}
    if kind != "rowwise_adagrad":
        raise ValueError(f"unknown update kind {kind!r}")
    # one accumulator per vocab row: mean over d of g^2
    g3 = g.reshape(vp, pack, d)
    acc = state["acc"] + jnp.mean(g3 * g3, axis=2)
    upd = (lr * g3 / (jnp.sqrt(acc) + eps)[..., None]).reshape(vp, wide)
    if wd:
        upd = upd + lr * wd * p_cur
    return (p_cur - upd).astype(t.dtype), {"acc": acc}


def apply_updates_fused(
    tables: dict,
    state: dict,
    plan: EmbedPlan,
    batch: dict,
    pert_grad: jnp.ndarray,
    *,
    lr: float,
    step: jnp.ndarray,
    weight_decay: float = 0.0,
    kind: str = "adam",
    mesh=None,
    shards_by_name: dict | None = None,
) -> tuple[dict, dict]:
    """One dense-optimizer step over every table group.

    ``batch`` must carry the ``embaux{g}_*`` arrays from
    :func:`make_host_prep`; ``pert_grad`` is the (B, F, D) tap cotangent.
    ``kind='adam'``: ``state`` is {name: {'m', 'v'}} (sparse_embed
    init_state('lazy_adam') shapes -- the moments ARE dense Adam's).
    ``kind='rowwise_adagrad'``: ``state`` is {name: {'acc'}} (init_state
    ('rowwise_adagrad')); at wd=0 the dense update equals the sparse one.

    ``mesh`` runs the same exact math SPMD.  Data axis: ONE all-gather
    brings the (n, D) cotangent into the global sorted order.  When the
    aux arrays carry a leading stream axis (host-LOCAL prep,
    ``make_host_prep(..., data_shards=Sd)``), each data shard first
    permutes only its LOCAL cotangent rows and the Sd per-shard streams
    are concatenated -- host prep is O(local batch) per process.  Model
    axis: each row-sharded table group updates shard-locally under
    ``shard_map``: shard ``s`` rebases ids by ``s*vs*pack`` and every id
    outside its ``vs`` local rows is dropped (groups whose row count
    doesn't divide the axis stay replicated and update identically on
    every device).  ``shards_by_name`` (table name -> shard count, from
    the placed tables' NamedShardings) must match the prep's; omitted,
    the :func:`group_shards` predicate is used.  Semantics are identical
    to the single-device path up to f32 summation order.
    """
    if kind not in ("adam", "rowwise_adagrad"):
        raise ValueError(f"unknown update kind {kind!r}")
    n_model = 1
    if mesh is not None:
        from jax import shard_map
        from jax.sharding import NamedSharding, PartitionSpec as P

        from recsys_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

        n_model = mesh.shape.get(MODEL_AXIS, 1)
        rep = NamedSharding(mesh, P())

    d = plan.embed_dim
    new_tables, new_state = {}, {}
    for g, name in enumerate(plan.table_names):
        pack = plan.packs[g]
        if shards_by_name is not None:
            sg = shards_by_name.get(name, 1)
        else:
            sg = group_shards(plan, g, n_model)
        if sg > 1 and mesh is None:
            raise ValueError(
                f"group {name!r} prepped for {sg} model shards but no mesh "
                "was passed -- shards_by_name must match the mesh"
            )
        cols = plan.group_cols[g]
        ids_aux = batch[f"embaux{g}_ids"]
        idx = batch[f"embaux{g}_idx"]
        if ids_aux.ndim == 2:
            cot = jnp.concatenate([pert_grad[:, j, :] for j in cols])
            cot_sorted = jnp.take(cot, idx, axis=0)
            ids2d = ids_aux
        else:
            # host-LOCAL prep, (Sd, nc_s, ch): per-data-shard sorted streams
            streams = int(ids_aux.shape[0])
            if mesh is not None:
                n_data = mesh.shape.get(DATA_AXIS, 1)
                if streams != n_data:
                    raise ValueError(
                        f"streamed prep has {streams} streams but the "
                        f"mesh data axis is {n_data}"
                    )

                def local_sort(pg, idx_blk, cols=cols):
                    # pg (B_local, F, d); idx_blk (1, nc_s*ch) local perm
                    cot_l = jnp.concatenate(
                        [pg[:, j, :] for j in cols], axis=0
                    )
                    return jnp.take(cot_l, idx_blk[0], axis=0)

                cot_sorted = shard_map(
                    local_sort,
                    mesh=mesh,
                    in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                    out_specs=P(DATA_AXIS),
                    check_vma=False,
                )(pert_grad, idx)
            else:
                bs = pert_grad.shape[0] // streams
                cot_sorted = jnp.concatenate([
                    jnp.take(
                        jnp.concatenate(
                            [pert_grad[s * bs:(s + 1) * bs, j, :]
                             for j in cols]
                        ),
                        idx[s], axis=0,
                    )
                    for s in range(streams)
                ])
            ids2d = ids_aux.reshape(-1, ids_aux.shape[-1])
        if mesh is not None:
            # the sorted permutation crosses data shards: replicate here so
            # XLA emits one all-gather of the cotangent rows
            cot_sorted = jax.lax.with_sharding_constraint(cot_sorted, rep)
            ids2d = jax.lax.with_sharding_constraint(ids2d, rep)
        t = tables[name]
        st = state[name]
        upd_kw = dict(pack=pack, d=d, lr=lr, wd=weight_decay, kind=kind)
        if sg == 1:
            new_t, new_st = _xla_group_update(
                t, st, cot_sorted, ids2d, step=step, **upd_kw
            )
        else:
            vs = t.shape[0] // sg  # local rows per model shard

            def run(t_, st_, cs_, ids_, step_, vs=vs, pack=pack):
                s = jax.lax.axis_index(MODEL_AXIS)
                return _xla_group_update(
                    t_, st_, cs_, ids_ - s * (vs * pack), step=step_,
                    **upd_kw,
                )

            row = P(MODEL_AXIS, None)
            st_spec = {k: row for k in st}
            new_t, new_st = shard_map(
                run,
                mesh=mesh,
                in_specs=(row, st_spec, P(), P(), P()),
                out_specs=(row, st_spec),
                check_vma=False,
            )(t, st, cot_sorted, ids2d, step)
        new_tables[name] = new_t
        new_state[name] = new_st
    return new_tables, new_state
