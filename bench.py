"""Benchmark: DLRM-Criteo training throughput on one GPU.

    python bench.py [--model dlrm|sasrec] [options]

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"platform", "device_kind", "device_count"}; it refuses to run without a
GPU.  The window is closed by ``jax.block_until_ready``.

``vs_baseline`` (DLRM only) is the ratio to a reference-style
implementation of the same model run in the same process: per-field
embedding tables gathered in a Python loop
(the reference's dict-of-Embeddings pattern, /root/reference/src/ctr/
deep_fm/model.py:31-38,53-54) instead of the framework's single stacked
gather, both jit-compiled.  value = optimized examples/s; vs_baseline =
optimized/naive.
"""
from __future__ import annotations

import functools
import json
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from recsys_tpu.tools import enable_compile_cache

BATCH = 16384
VOCAB = 100_000
NUM_SPARSE = 26
NUM_DENSE = 13
EMBED_DIM = 16
WARMUP = 5
STEPS = 40


def _zipf_col(rng, n, vocab, a=1.1):
    """Zipf(a) ranks through a random per-field permutation — the Criteo
    categorical skew regime (data/realistic.py's model; ref
    src/ctr/utils/data_process.py:57-66 label-encodes such traffic)."""
    r = rng.zipf(a, size=n * 4)
    r = r[r <= vocab][:n]
    while r.shape[0] < n:
        extra = rng.zipf(a, size=n)
        r = np.concatenate([r, extra[extra <= vocab]])[:n]
    return rng.permutation(vocab)[r - 1].astype(np.int32)


def _data(rng, id_dist: str = "uniform"):
    if id_dist == "zipf":
        sparse = np.stack(
            [_zipf_col(rng, BATCH, VOCAB) for _ in range(NUM_SPARSE)],
            axis=1,
        )
    else:
        sparse = rng.integers(
            0, VOCAB, (BATCH, NUM_SPARSE), dtype=np.int64
        ).astype(np.int32)
    return {
        "dense": jnp.asarray(rng.random((BATCH, NUM_DENSE), np.float32)),
        "sparse": jnp.asarray(sparse),
        "label": jnp.asarray(rng.integers(0, 2, BATCH).astype(np.float32)),
    }


def _time_steps(step, state, batch):
    for _ in range(WARMUP):
        state, loss = step(state, batch)
    jax.block_until_ready((state, loss))
    t0 = time.perf_counter()
    for _ in range(STEPS):
        state, loss = step(state, batch)
    jax.block_until_ready((state, loss))
    dt = time.perf_counter() - t0
    return BATCH * STEPS / dt


def bench_framework(rng, embed_update: str = "fused",
                    embed_optimizer: str = "adam",
                    id_dist: str = "uniform",
                    dense_microbatch: int = 1,
                    table_dtype: str = "f32"):
    """The framework's DLRM step.  ``embed_update``:

    * 'fused' (default) — the production path: the table update runs from
      the perturbation tap as one scatter-add and one dense-Adam pass
      (train/streaming_embed.py; exact dense-Adam semantics, host id-sort
      precomputed like any other loader work — in Trainer.fit it rides the
      prefetch thread, here the batch is fixed so it is computed once).
    * 'optax' — autodiff through the tables + optax.adam on every param.
    """
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.losses import bce_with_logits

    schema, _ = synthetic_ctr(
        num_examples=8, num_dense=NUM_DENSE, num_sparse=NUM_SPARSE,
        vocab_size=VOCAB, embed_dim=EMBED_DIM,
    )
    # mixed precision: activations/matmuls bf16, params + loss f32.  AUC
    # parity with full f32 is guarded by
    # tests/test_models_ctr.py::test_dlrm_bf16_compute_matches_f32_quality;
    # the naive baseline keeps the reference's full-f32 compute.
    fused = embed_update == "fused"
    model = DLRM(schema, bottom_units=(512, 256, EMBED_DIM),
                 top_units=(1024, 1024, 512, 256),
                 compute_dtype=jnp.bfloat16,
                 sparse_embed_grads=fused,
                 dense_microbatch=dense_microbatch,
                 embed_kw=({"param_dtype": jnp.bfloat16}
                           if table_dtype == "bf16" else None))
    batch = _data(rng, id_dist)
    variables = model.init(jax.random.PRNGKey(0), batch, training=False)
    params = variables["params"]
    tx = optax.adam(1e-3)

    if not fused:
        state = (params, tx.init(params))

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(state, batch):
            params, opt = state

            def loss_fn(p):
                logits = model.apply({"params": p}, batch, training=False)
                return bce_with_logits(logits, batch["label"])

            loss, grads = jax.value_and_grad(loss_fn)(params)
            upd, opt = tx.update(grads, opt, params)
            return (optax.apply_updates(params, upd), opt), loss

        return _time_steps(step, state, batch)

    from recsys_tpu.train import sparse_embed, streaming_embed

    plan = sparse_embed.build_plan(params, schema)
    rest, tables = sparse_embed.split_params(params, plan)
    emb_state = sparse_embed.init_state(
        tables,
        "lazy_adam" if embed_optimizer == "adam" else "rowwise_adagrad",
        plan,
    )
    # host id-sort/bucket: loader-side prep (prefetch-thread work in
    # Trainer.fit); the bench batch is fixed, so prepped once like _data
    aux = {
        k: jnp.asarray(v)
        for k, v in streaming_embed.make_host_prep(plan)(
            np.asarray(batch["sparse"])
        ).items()
    }
    batch = dict(batch, **aux)
    pert_template = variables["perturbations"]
    state = (rest, tables, emb_state, tx.init(rest), jnp.int32(0))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, batch):
        rest, tables, emb, opt, t = state
        pert0 = pert_template

        def loss_fn(rest_p, pert):
            full = sparse_embed.merge_params(rest_p, tables, plan)
            logits = model.apply(
                {"params": full, "perturbations": pert}, batch,
                training=False,
            )
            return bce_with_logits(logits, batch["label"])

        (loss), (grest, gpert) = jax.value_and_grad(
            loss_fn, argnums=(0, 1)
        )(rest, pert0)
        upd, opt = tx.update(grest, opt, rest)
        rest = optax.apply_updates(rest, upd)
        tables, emb = streaming_embed.apply_updates_fused(
            tables, emb, plan, batch,
            jax.tree_util.tree_leaves(gpert)[0],
            lr=1e-3, step=t + 1, kind=embed_optimizer,
        )
        return (rest, tables, emb, opt, t + 1), loss

    return _time_steps(step, state, batch)


def bench_naive(rng, id_dist: str = "uniform"):
    """Reference-style DLRM: one table per field, Python-loop gathers, fp32."""
    from recsys_tpu.train.losses import bce_with_logits

    key = jax.random.PRNGKey(0)
    keys = jax.random.split(key, NUM_SPARSE + 6)
    params = {
        f"table_{i}": jax.random.uniform(
            keys[i], (VOCAB, EMBED_DIM), minval=-0.05, maxval=0.05
        )
        for i in range(NUM_SPARSE)
    }
    dims = [NUM_DENSE, 512, 256, EMBED_DIM]
    for i in range(3):
        params[f"bot_w{i}"] = jax.random.normal(
            keys[NUM_SPARSE + i], (dims[i], dims[i + 1])
        ) * 0.05
        params[f"bot_b{i}"] = jnp.zeros((dims[i + 1],))
    n_inter = (NUM_SPARSE + 1) * NUM_SPARSE // 2
    tdims = [EMBED_DIM + n_inter, 1024, 1024, 512, 256, 1]
    for i in range(5):
        params[f"top_w{i}"] = jax.random.normal(
            keys[(NUM_SPARSE + 3 + i) % len(keys)], (tdims[i], tdims[i + 1])
        ) * 0.05
        params[f"top_b{i}"] = jnp.zeros((tdims[i + 1],))

    batch = _data(rng, id_dist)
    tx = optax.adam(1e-3)
    state = (params, tx.init(params))

    def fwd(p, batch):
        embs = [
            jnp.take(p[f"table_{i}"], batch["sparse"][:, i], axis=0)
            for i in range(NUM_SPARSE)
        ]
        x = batch["dense"]
        for i in range(3):
            x = jax.nn.relu(x @ p[f"bot_w{i}"] + p[f"bot_b{i}"])
        feats = jnp.stack([x] + embs, axis=1)
        gram = jnp.einsum("bfd,bgd->bfg", feats, feats)
        rows, cols = jnp.tril_indices(NUM_SPARSE + 1, k=-1)
        inter = gram[:, rows, cols]
        t = jnp.concatenate([x, inter], axis=-1)
        for i in range(5):
            t = t @ p[f"top_w{i}"] + p[f"top_b{i}"]
            if i < 4:
                t = jax.nn.relu(t)
        return t[..., 0]

    @jax.jit
    def step(state, batch):
        params, opt = state

        def loss_fn(p):
            return bce_with_logits(fwd(p, batch), batch["label"])

        loss, grads = jax.value_and_grad(loss_fn)(params)
        upd, opt = tx.update(grads, opt, params)
        return (optax.apply_updates(params, upd), opt), loss

    return _time_steps(step, state, batch)


def bench_sasrec(rng, *, maxlen=512, batch=256, steps=20):
    """SASRec train throughput at long history (float32, so attention
    takes XLA's route; kernels/dispatch.py)."""
    from recsys_tpu.models.match.sasrec import SASRec
    from recsys_tpu.train.losses import pairwise_bce

    num_items = 50_000
    hist = jnp.asarray(
        rng.integers(1, num_items, (batch, maxlen), dtype=np.int64).astype(np.int32)
    )
    pos = jnp.asarray(rng.integers(1, num_items, batch, dtype=np.int64).astype(np.int32))
    neg = jnp.asarray(rng.integers(1, num_items, (batch, 1), dtype=np.int64).astype(np.int32))
    b = {"hist": hist, "pos": pos, "neg": neg}
    model = SASRec(num_items=num_items, embed_dim=64, num_blocks=2,
                   num_heads=2, max_len=maxlen, dropout_rate=0.0)
    params = model.init(jax.random.PRNGKey(0), b, training=False)["params"]
    tx = optax.adam(1e-3)
    state = (params, tx.init(params))

    @functools.partial(jax.jit, donate_argnums=(0,))
    def step(state, batch):
        p, o = state

        def loss_fn(p):
            out = model.apply({"params": p}, batch, training=False)
            return pairwise_bce(out["pos_logits"], out["neg_logits"])

        loss, grads = jax.value_and_grad(loss_fn)(p)
        upd, o = tx.update(grads, o, p)
        return (optax.apply_updates(p, upd), o), loss

    for _ in range(3):
        state, loss = step(state, b)
    jax.block_until_ready((state, loss))
    t0 = time.perf_counter()
    for _ in range(steps):
        state, loss = step(state, b)
    jax.block_until_ready((state, loss))
    return batch * steps / (time.perf_counter() - t0)


def _device() -> dict:
    """The device every result line names; no GPU, no measurement."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"bench.py measures on a GPU; JAX found {dev.platform!r}"
        )
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": len(jax.devices())}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--model", choices=["dlrm", "sasrec"], default="dlrm")
    p.add_argument(
        "--embed-update", choices=["fused", "optax"], default="fused",
        help="table update path: scatter-add + dense Adam from the "
        "perturbation tap (default, exact dense-Adam semantics) or "
        "autodiff through the tables + optax",
    )
    p.add_argument("--dense-microbatch", type=int, default=4,
                   help="slice the dense tail into N per-slice "
                   "computations (gather stays whole-batch); 1 disables")
    p.add_argument(
        "--embed-optimizer", choices=["adam", "rowwise_adagrad"],
        default="adam",
        help="table optimizer for the fused path; rowwise_adagrad is the "
        "DLRM-paper production choice (1 accumulator/row) and reports "
        "under its own metric name",
    )
    p.add_argument("--maxlen", type=int, default=512,
                   help="SASRec history length")
    p.add_argument(
        "--table-dtype", choices=["f32", "bf16"], default="f32",
        help="embedding MASTER-table dtype.  bf16 halves the gather reads "
        "and the update's table bytes (moments stay f32; Adam math in "
        "f32).  Opt-in pending quality validation at protocol scale",
    )
    p.add_argument(
        "--id-dist", choices=["uniform", "zipf"], default="uniform",
        help="sparse-id distribution for the DLRM bench: uniform or "
        "zipf(1.1) production skew (the Criteo categorical regime)",
    )
    p.add_argument(
        "--breakdown", action="store_true",
        help="per-phase device timings + roofline shares for the DLRM "
        "step (tools/roofline); prints the breakdown JSON instead of the "
        "headline line",
    )
    args = p.parse_args(argv)
    device = _device()
    enable_compile_cache()
    if args.breakdown:
        from recsys_tpu.tools import roofline

        roofline.main(["--batch", str(BATCH)])
        return
    rng = np.random.default_rng(0)
    if args.model == "sasrec":
        maxlen = args.maxlen
        batch = 256 if maxlen <= 512 else max(32, 256 * 512 // maxlen)
        rate = bench_sasrec(rng, maxlen=maxlen, batch=batch)
        print(json.dumps({
            "metric": f"sasrec_maxlen{maxlen}_train_examples_per_s",
            "value": rate,
            "unit": "examples/s/chip",
            **device,
        }))
        return
    fw = bench_framework(rng, embed_update=args.embed_update,
                         embed_optimizer=args.embed_optimizer,
                         id_dist=args.id_dist,
                         dense_microbatch=args.dense_microbatch,
                         table_dtype=args.table_dtype)
    naive = bench_naive(rng, id_dist=args.id_dist)
    suffix = (
        "" if args.embed_optimizer == "adam"
        else f"_{args.embed_optimizer}"
    )
    if args.id_dist != "uniform":
        suffix += f"_{args.id_dist}"
    if args.dense_microbatch != 4:  # non-default tail slicing
        suffix += f"_mb{args.dense_microbatch}"
    if args.table_dtype != "f32":
        suffix += f"_t{args.table_dtype}"
    print(json.dumps({
        "metric": f"dlrm_criteo_train_examples_per_s{suffix}",
        "value": fw,
        "unit": "examples/s/chip",
        "vs_baseline": fw / naive,
        **device,
    }))


if __name__ == "__main__":
    main()
