"""Device mesh construction and sharding helpers.

The JAX replacement for the reference's
``tf.distribute.MirroredStrategy`` (every train script, e.g.
/root/reference/src/ctr/fm/train.py:43-44): ONE ``jax.sharding.Mesh`` with a
``data`` axis (batch / data-parallel) and a ``model`` axis (embedding-table
row sharding).  Gradient all-reduces are emitted by XLA from jit's sharding
propagation (NCCL on GPUs) — no hand-written collectives in the train loop.
"""
from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    data: int | None = None, model: int = 1, devices=None
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Defaults to all devices on the data axis — pure DP, the reference's only
    strategy.  ``model > 1`` reserves an axis for sharded embedding tables.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    return Mesh(devices.reshape(data, model), (DATA_AXIS, MODEL_AXIS))


def make_multihost_mesh(model: int = 1) -> Mesh:
    """(data, model) mesh for several processes, host-aware axis order.

    The `model` axis (embedding-table row sharding: the all-to-all /
    psum-heavy traffic) is laid out INSIDE a host, where the GPUs are
    joined all to all by NVLink; the `data` axis factors as hosts x
    remaining-local-devices, so the gradient all-reduce crosses the
    slower host-to-host network only on its host-level component.  Within
    one host every GPU reaches every other at the same rate, so no axis
    order is preferred there.  Single-process falls back to
    :func:`make_mesh` (used by the virtual-device tests; real multi-host
    requires jax.distributed.initialize()).
    """
    n_proc = jax.process_count()
    if n_proc == 1:
        return make_mesh(model=model)
    from jax.experimental import mesh_utils

    n_local = jax.local_device_count()
    if n_local % model:
        raise ValueError(
            f"model axis {model} must divide local device count {n_local}"
        )
    # process_is_granule: the outer factor counts HOSTS (processes), not
    # the default's slice granules.
    devs = mesh_utils.create_hybrid_device_mesh(
        [n_local // model, model], [n_proc, 1], process_is_granule=True
    )
    return Mesh(devs, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) axis over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def table_sharding(mesh: Mesh) -> NamedSharding:
    """Row-shard an embedding table over the model axis."""
    return NamedSharding(mesh, P(MODEL_AXIS, None))


def shard_batch(batch: dict, mesh: Mesh | None) -> dict:
    """Device-put a host batch with its leading axis split over `data`.

    GLOBAL contract: every process passes the full global arrays.  The
    ``embaux*`` keys (fused-update host prep under GLOBAL prep: sorted-id
    chunks and the gather permutation — train/streaming_embed.py)
    are global batch metadata, not per-example rows; they replicate.
    Under host-local prep (leading stream axis, ndim bumped by one) they
    are per-data-shard streams and shard over `data` like the batch rows.
    """
    if mesh is None:
        return jax.device_put(batch)
    s = batch_sharding(mesh)
    r = replicated(mesh)

    def put(k, x):
        if k.startswith("embaux") and np.ndim(x) in (2, 3):
            # global-prep aux: ids (nc, ch) / idx (n,) -> replicate;
            # local-prep aux has a leading (Sd, ...) stream axis -> shard
            # it over data.  idx is 1-D global / 2-D local.
            is_local = (np.ndim(x) == 3) or (
                np.ndim(x) == 2 and k.endswith("_idx")
            )
            return jax.device_put(x, s if is_local else r)
        if k.startswith("embaux"):
            return jax.device_put(x, r)
        return jax.device_put(x, s)

    if isinstance(batch, dict):
        return {
            k: jax.tree_util.tree_map(lambda x, k=k: put(k, x), v)
            for k, v in batch.items()
        }
    return jax.tree_util.tree_map(lambda x: jax.device_put(x, s), batch)


def shard_batch_local(batch: dict, mesh: Mesh | None) -> dict:
    """Assemble a GLOBAL device batch from this process's LOCAL arrays.

    The host-local multihost data contract (the JAX replacement for
    MirroredStrategy's per-replica feeding, /root/reference/src/ctr/fm/
    train.py:43-44): each process passes only the rows it feeds — batch
    arrays shaped (B_local, ...) and local-prep ``embaux*`` streams shaped
    (Sd_local, ...) — and ``jax.make_array_from_process_local_data``
    assembles the logically-global sharded arrays without any host ever
    holding the global batch.  Single-process, this equals
    :func:`shard_batch` with local-prep aux.
    """
    if mesh is None:
        return jax.device_put(batch)
    s = batch_sharding(mesh)

    def put(x):
        return jax.make_array_from_process_local_data(s, np.asarray(x))

    return {
        k: jax.tree_util.tree_map(put, v) for k, v in batch.items()
    }


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m
