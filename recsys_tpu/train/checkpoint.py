"""Checkpoint save/restore for train state.

The reference comments its ModelCheckpoint blocks out everywhere
(/root/reference/src/ctr/fm/train.py:52-55 etc.); this provides real
checkpointing in two forms:

* :func:`save` / :func:`restore` — the whole TrainState pytree gathered to
  host and written as one numpy ``.npz`` of its leaves, keyed by tree
  path.  Simple, adequate while every param fits one host.
* :func:`save_sharded` / :func:`restore_sharded` — shard-parallel
  checkpointing for the model-axis story: each process writes only the
  array SHARDS it owns (replica 0 of each distinct block), and restore
  device_puts blocks straight into the target sharded layout via
  ``jax.make_array_from_single_device_arrays``.  No step ever materialises
  a full table on any single host — the property that matters once tables
  are row-sharded precisely because they don't fit one chip (or one host).
  This is the Orbax-style host-parallel save SURVEY.md §5's checkpoint row
  calls for, self-contained.
"""
from __future__ import annotations

import json
import os

import jax
import numpy as np


def save(path: str, state) -> None:
    """Write ``state``'s leaves to ``path`` as an ``.npz`` keyed by
    ``jax.tree_util.keystr`` of each leaf's path (the file name is used
    as given)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    flat = jax.tree_util.tree_leaves_with_path(jax.device_get(state))
    arrays = {jax.tree_util.keystr(p): np.asarray(x) for p, x in flat}
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def restore(path: str, template):
    """Restore into the structure of ``template`` (an initialised state).

    Every template leaf must be in the file with the same shape; dtypes
    follow the template (numpy stores bf16 as raw 2-byte records)."""
    flat, treedef = jax.tree_util.tree_flatten_with_path(template)
    out = []
    with np.load(path, allow_pickle=False) as data:
        for p, leaf in flat:
            key = jax.tree_util.keystr(p)
            if key not in data:
                raise ValueError(f"checkpoint {path!r} has no leaf {key}")
            arr = data[key]
            want = np.dtype(getattr(leaf, "dtype", arr.dtype))
            if arr.shape != np.shape(leaf):
                raise ValueError(
                    f"leaf {key}: checkpoint shape {arr.shape} != "
                    f"{np.shape(leaf)}"
                )
            out.append(arr.view(want) if arr.dtype.kind == "V"
                       else arr.astype(want))
    return jax.tree_util.tree_unflatten(treedef, out)


# -- shard-parallel checkpointing ------------------------------------------

def _norm_index(index, shape):
    """Normalise a shard index (tuple of slices) to [[start, stop], ...]."""
    out = []
    for sl, dim in zip(index, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        out.append([start, stop])
    return out


def save_sharded(path: str, state) -> None:
    """Write this process's addressable shards of ``state`` under ``path``.

    Every process calls this with the same directory (a shared filesystem,
    as usual for checkpoints).  Each distinct block of each array is saved
    exactly once across the job — by the process holding its replica-0
    shard — STREAMED block-per-file (``np.save`` immediately per shard, no
    accumulation), so peak host memory really is one shard, even on a
    single-host mesh that addresses the whole model.  A per-process JSON
    manifest records which leaf and which index range each file covers.
    """
    os.makedirs(path, exist_ok=True)
    proc = jax.process_index()
    leaves = jax.tree_util.tree_leaves(state)
    manifest = []
    for i, leaf in enumerate(leaves):
        if not isinstance(leaf, jax.Array):
            arr = np.asarray(leaf)
            if proc == 0:
                key = f"b{i}_0"
                np.save(os.path.join(path, f"p{proc}_{key}.npy"), arr)
                manifest.append({
                    "leaf": i, "key": key,
                    "index": _norm_index((slice(None),) * arr.ndim,
                                         arr.shape),
                })
            continue
        for j, shard in enumerate(leaf.addressable_shards):
            if shard.replica_id != 0:
                continue  # another device/process owns this block's copy
            key = f"b{i}_{j}"
            # fetch + write + free ONE shard at a time
            np.save(
                os.path.join(path, f"p{proc}_{key}.npy"),
                np.asarray(shard.data),
            )
            manifest.append({
                "leaf": i, "key": key,
                "index": _norm_index(shard.index, leaf.shape),
            })
    with open(os.path.join(path, f"manifest_p{proc}.json"), "w") as f:
        json.dump(manifest, f)


def restore_sharded(path: str, template):
    """Restore a :func:`save_sharded` checkpoint into ``template``'s
    structure AND sharded layout.

    ``template`` is an initialised state (e.g. from ``Trainer.init``) whose
    array leaves carry the target shardings.  For each leaf, each local
    device receives exactly the block its sharding assigns it —
    device_put of one shard at a time, assembled with
    ``jax.make_array_from_single_device_arrays``; the full array is never
    formed on host.
    """
    manifests = []
    for name in sorted(os.listdir(path)):
        if name.startswith("manifest_p"):
            with open(os.path.join(path, name)) as f:
                part = json.load(f)
            proc = name[len("manifest_p"):-len(".json")]
            for entry in part:
                entry["proc"] = proc
            manifests.extend(part)

    by_leaf: dict[int, list[dict]] = {}
    for entry in manifests:
        by_leaf.setdefault(entry["leaf"], []).append(entry)

    leaves, treedef = jax.tree_util.tree_flatten(template)
    out = []
    for i, leaf in enumerate(leaves):
        entries = by_leaf.get(i)
        if entries is None:
            raise ValueError(f"checkpoint at {path!r} has no data for "
                             f"leaf {i} (structure mismatch?)")

        def block_for(index_norm):
            for e in entries:
                if e["index"] == index_norm:
                    return np.load(
                        os.path.join(path, f"p{e['proc']}_{e['key']}.npy")
                    )
            raise ValueError(
                f"leaf {i}: no saved block covers index {index_norm} "
                f"(mesh/sharding changed since save?)"
            )

        if not isinstance(leaf, jax.Array):
            arr = np.asarray(leaf)
            out.append(
                block_for(_norm_index((slice(None),) * arr.ndim, arr.shape))
                .astype(arr.dtype)
            )
            continue
        sharding = leaf.sharding
        shape = leaf.shape
        idx_map = sharding.addressable_devices_indices_map(shape)
        shards = [
            jax.device_put(
                block_for(_norm_index(index, shape)).astype(leaf.dtype),
                device,
            )
            for device, index in idx_map.items()
        ]
        out.append(jax.make_array_from_single_device_arrays(
            shape, sharding, shards
        ))
    return jax.tree_util.tree_unflatten(treedef, out)


class BestCheckpointer:
    """Keeps the best-metric checkpoint on disk (lower is better by default).

    ``sharded=True`` uses the shard-parallel writer (``path`` becomes a
    directory) — the right mode whenever the Trainer runs with a model
    axis."""

    def __init__(self, path: str, mode: str = "min", sharded: bool = False):
        self.path = path
        self.mode = mode
        self.sharded = sharded
        self.best: float | None = None

    def update(self, metric: float, state) -> bool:
        better = (
            self.best is None
            or (self.mode == "min" and metric < self.best)
            or (self.mode == "max" and metric > self.best)
        )
        if better:
            self.best = metric
            if self.sharded:
                save_sharded(self.path, state)
            else:
                save(self.path, state)
        return better
