"""Per-phase speed-of-light accounting for the DLRM bench step.

Decomposes the benched DLRM train step (bench.py shapes: B=16384, 26x100k
vocab, D=16, packed rows, bf16 dense compute) into its device phases,
times each in isolation with scan-chained jits closed by
``block_until_ready``, and compares each phase against an analytic
roofline bound built from the device's published peaks (:data:`PEAKS`):

    phase        bound
    ------------ -------------------------------------------------------
    gather       memory: B*F physical-row reads (512 B each, packed)
    dense        FLOPs: 3x fwd matmul FLOPs (fwd + dgrad + wgrad), bf16
    scatter      memory: cotangent read + expected-unique-row RMW
    update       memory: dense Adam on tables = 7x table bytes
    fused_bwd    memory: the fused_adam update (cotangent permute, dense
                 gradient write + read, p/m/v read + write)

The reference publishes no perf numbers (SURVEY.md §6); the roofline is the
absolute yardstick instead.  Run:

    python -m recsys_tpu.tools.roofline [--batch 16384] [--iters 30]

Prints a human table on stderr and one JSON object on stdout.

``--trace DIR`` instead traces the Trainer's DLRM train step (bench widths,
bf16, ``fused_adam``) with ``jax.profiler`` and attributes each device
kernel to the ``jax.named_scope`` of its HLO op (embedding_gather,
interaction, bottom_mlp, top_mlp, table_update; the rest is "other"):
device time per step, share of the step, the device's idle share, and each
scope's roofline share against the published peaks and against a bf16
matmul and a copy measured in the same process (:func:`trace_breakdown`).
XLA runs a step as CUDA-graph command buffers, whose kernels the trace
labels only ``command_buffer``; run the trace with
``XLA_FLAGS=--xla_gpu_enable_command_buffer=`` so each kernel carries its
HLO op.  The optimized HLO is written beside the trace.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import lax

from recsys_tpu.kernels.embedding import pack_factor, packed_gather, packed_select

# Published dense peaks by jax ``device_kind``: bf16 tensor-core FLOP/s
# without sparsity, device-memory bytes/s.  Source: NVIDIA H100 Tensor
# Core GPU data sheet, SXM5 80 GB part (at the full 700 W power limit).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bw": 3.35e12},
}

VOCAB = 100_000
NUM_SPARSE = 26
NUM_DENSE = 13
EMBED_DIM = 16
BOTTOM = (512, 256)
TOP = (1024, 1024, 512, 256)


def peaks(device_kind: str) -> dict:
    """The :data:`PEAKS` row of ``device_kind``; a device without one is
    an error, never a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device_kind {device_kind!r}; add a "
            f"row to tools/roofline.PEAKS (known: {sorted(PEAKS)})"
        ) from None


def roofline_share(device_kind: str, nbytes: float, flops: float,
                   ms: float) -> dict:
    """Least time the device could take (the larger of bytes over peak
    bandwidth and FLOPs over peak bf16 rate) over the measured ``ms``."""
    spec = peaks(device_kind)
    bw_ms = nbytes / spec["hbm_bw"] * 1e3
    fl_ms = flops / spec["bf16_flops"] * 1e3
    sol = max(bw_ms, fl_ms)
    return {"sol_ms": sol, "share": sol / ms,
            "bound": "memory" if bw_ms >= fl_ms else "flops"}


def time_chained(fn, carry, iters: int, warmup: int = 1) -> float:
    """ms per call of carry->carry `fn`, chained through one lax.scan
    (one dispatch per window) and closed by ``block_until_ready``."""
    many = jax.jit(
        lambda c: lax.scan(
            lambda c, _: (fn(c), None), c, None, length=iters
        )[0]
    )
    for _ in range(warmup):
        jax.block_until_ready(many(carry))
    t0 = time.perf_counter()
    jax.block_until_ready(many(carry))
    return (time.perf_counter() - t0) / iters * 1e3


def _opaque_zero_i32(s: jnp.ndarray) -> jnp.ndarray:
    """An int32 zero XLA cannot constant-fold (s is nonneg at runtime)."""
    return jnp.minimum(s.astype(jnp.int32), 0)


def build_phases(batch: int, rng: np.random.Generator):
    """Returns {phase: (fn, carry)} + analytic {phase: (bytes, flops)}."""
    pack = pack_factor(EMBED_DIM, VOCAB)  # 8 at D=16
    v_phys = -(-VOCAB // pack)
    v_phys += (-v_phys) % 8  # _pad8
    wide = pack * EMBED_DIM  # 128 lanes

    keys = jax.random.split(jax.random.PRNGKey(0), NUM_SPARSE)
    tables = [
        jax.random.uniform(k, (v_phys, wide), minval=-0.05, maxval=0.05)
        for k in keys
    ]
    ids = jnp.asarray(
        rng.integers(0, VOCAB, (batch, NUM_SPARSE), dtype=np.int64).astype(np.int32)
    )
    dense_x = jnp.asarray(rng.random((batch, NUM_DENSE), np.float32))
    labels = jnp.asarray(rng.integers(0, 2, batch).astype(np.float32))
    embs = jnp.asarray(rng.standard_normal((batch, NUM_SPARSE, EMBED_DIM)), jnp.float32)
    cot = jnp.asarray(rng.standard_normal((batch, NUM_SPARSE, EMBED_DIM)), jnp.float32)

    # ---- phase 1: gather (fwd packed lookup of all 26 fields) -------------
    def gather_fn(s):
        shift = _opaque_zero_i32(s)
        total = 0.0
        for g in range(NUM_SPARSE):
            rows = ids[:, g] + shift
            w = jnp.take(tables[g], rows // pack, axis=0)
            total = total + jnp.sum(packed_select(w, rows, pack, EMBED_DIM))
        return jnp.abs(jnp.tanh(total * 1e-12))

    # ---- phase 2: dense tail fwd + bwd (bf16, DLRM math minus embedding) --
    from recsys_tpu.kernels.interactions import dot_interaction
    from recsys_tpu.ops import mlp

    kb, kt = jax.random.split(jax.random.PRNGKey(1))
    n_inter_in = (NUM_SPARSE + 1) * NUM_SPARSE // 2
    dense_params = {
        "bottom": mlp.mlp_init(kb, NUM_DENSE, BOTTOM, EMBED_DIM),
        "top": mlp.mlp_init(kt, EMBED_DIM + n_inter_in, TOP, 1),
    }

    def tail(p, dense, e):
        z = mlp.mlp_apply(p["bottom"], dense, dtype=jnp.bfloat16)
        feats = jnp.concatenate(
            [z[:, None, :], e.astype(jnp.bfloat16)], axis=1
        )
        inter = dot_interaction(feats)
        logits = mlp.mlp_apply(
            p["top"], jnp.concatenate([z.astype(inter.dtype), inter], -1),
            dtype=jnp.bfloat16,
        )[..., 0]
        return logits.astype(jnp.float32)

    def dense_fn(p):
        def loss(p, e):
            logits = tail(p, dense_x, e)
            return jnp.mean(
                optax.sigmoid_binary_cross_entropy(logits, labels)
            )

        (gp, ge) = jax.grad(loss, argnums=(0, 1))(p, embs)
        # consume d(loss)/d(embeddings) — part of the real backward
        eps = 1e-30 * jnp.sum(ge)
        return jax.tree_util.tree_map(lambda a, g: a - 1e-30 * g - eps, p, gp)

    # ---- phase 3: scatter (backward of the packed gather) -----------------
    def scatter_fn(ts):
        def consume(ts):
            total = 0.0
            for g in range(NUM_SPARSE):
                e = packed_gather(ts[g], ids[:, g], pack, EMBED_DIM)
                total = total + jnp.sum(e * cot[:, g, :])
            return total

        grads = jax.grad(consume)(ts)  # scatter-adds; fwd gather is DCE'd
        return [t - 1e-30 * gt for t, gt in zip(ts, grads)]

    # ---- phase 4: dense Adam update of the tables --------------------------
    tx = optax.adam(1e-3)
    grads_fixed = [
        jax.random.normal(k, (v_phys, wide)) * 1e-3 for k in keys
    ]
    upd_carry = (list(tables), tx.init(list(tables)))

    def update_fn(carry):
        params, opt = carry
        upd, opt = tx.update(grads_fixed, opt, params)
        return (optax.apply_updates(params, upd), opt)

    # ---- fused_adam phase: id-sorted cotangent permute + XLA update ------
    from recsys_tpu.train.streaming_embed import (
        _xla_group_update, host_prep_group,
    )

    prep = [
        host_prep_group(np.asarray(ids[:, g]), pack=pack, vp=v_phys)
        for g in range(NUM_SPARSE)
    ]
    ids2ds = [jnp.asarray(p[0]) for p in prep]
    idxs = [jnp.asarray(p[1]) for p in prep]
    cots = jnp.asarray(
        rng.standard_normal((NUM_SPARSE, batch, EMBED_DIM)), jnp.float32
    ) * 1e-2

    def fused_bwd_fn(carry):
        ts, ms, vs, t = carry
        outs = []
        for g in range(NUM_SPARSE):
            cs = jnp.take(cots[g], idxs[g], axis=0)
            new_t, st = _xla_group_update(
                ts[g], {"m": ms[g], "v": vs[g]}, cs, ids2ds[g], pack=pack,
                d=EMBED_DIM, lr=1e-3, step=t, wd=0.0, kind="adam",
            )
            outs.append((new_t, st["m"], st["v"]))
        return ([o[0] for o in outs], [o[1] for o in outs],
                [o[2] for o in outs], t + 1)

    fused_carry = (
        list(tables),
        [jnp.zeros_like(t) for t in tables],
        [jnp.zeros_like(t) for t in tables],
        jnp.int32(1),
    )

    phases = {
        "gather": (gather_fn, jnp.float32(0.5)),
        "dense": (dense_fn, dense_params),
        "scatter": (scatter_fn, list(tables)),
        "update": (update_fn, upd_carry),
        "fused_bwd": (fused_bwd_fn, fused_carry),
    }

    # ---- analytic bytes / flops -------------------------------------------
    table_bytes = NUM_SPARSE * v_phys * wide * 4
    row_bytes = wide * 4  # one physical row = 512 B
    lookups = batch * NUM_SPARSE
    # expected unique physical rows touched per table by `batch` uniform ids
    uniq = v_phys * (1.0 - (1.0 - 1.0 / v_phys) ** batch)

    def mlp_flops(in_dim, units, out_dim):
        dims = [in_dim, *units, out_dim]
        return 2 * batch * sum(a * b for a, b in zip(dims, dims[1:]))

    f = NUM_SPARSE + 1
    n_inter = f * (f - 1) // 2
    fwd_flops = (
        mlp_flops(NUM_DENSE, BOTTOM, EMBED_DIM)
        + 2 * batch * f * f * EMBED_DIM  # dot-interaction gram
        + mlp_flops(EMBED_DIM + n_inter, TOP, 1)
    )
    analytic = {
        "gather": {"bytes": lookups * row_bytes, "flops": 0},
        "dense": {"bytes": 0, "flops": 3 * fwd_flops},  # fwd + dgrad + wgrad
        "scatter": {
            # wide-spread cotangent read + read-modify-write of touched rows
            "bytes": int(lookups * row_bytes + 2 * NUM_SPARSE * uniq * row_bytes),
            "flops": 0,
        },
        "update": {"bytes": 7 * table_bytes, "flops": 0},
        # permute (narrow cot r+w) + dense gradient (zero-fill write,
        # read) + p/m/v read and write
        "fused_bwd": {
            "bytes": int(
                8 * table_bytes
                + 3 * lookups * EMBED_DIM * 4  # cot read + sorted write+read
            ),
            "flops": 0,
        },
    }
    return phases, analytic


def full_step_ms(batch: int, rng: np.random.Generator, iters: int,
                 fused: bool = False) -> float:
    """The actual bench step (framework DLRM, bf16, donated), scan-chained.

    ``fused=True`` times the default bench composition (perturbation tap
    + fused_adam table update)."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.losses import bce_with_logits

    schema, _ = synthetic_ctr(
        num_examples=8, num_dense=NUM_DENSE, num_sparse=NUM_SPARSE,
        vocab_size=VOCAB, embed_dim=EMBED_DIM,
    )
    model = DLRM(schema, bottom_units=(*BOTTOM, EMBED_DIM),
                 top_units=TOP, compute_dtype=jnp.bfloat16,
                 sparse_embed_grads=fused)
    b = {
        "dense": jnp.asarray(rng.random((batch, NUM_DENSE), np.float32)),
        "sparse": jnp.asarray(
            rng.integers(0, VOCAB, (batch, NUM_SPARSE), dtype=np.int64).astype(np.int32)
        ),
        "label": jnp.asarray(rng.integers(0, 2, batch).astype(np.float32)),
    }
    variables = model.init(jax.random.PRNGKey(0), b, training=False)
    params = variables["params"]
    tx = optax.adam(1e-3)

    if not fused:
        def step(state):
            params, opt = state

            def loss_fn(p):
                return bce_with_logits(
                    model.apply({"params": p}, b, training=False), b["label"]
                )

            loss, grads = jax.value_and_grad(loss_fn)(params)
            upd, opt = tx.update(grads, opt, params)
            return (optax.apply_updates(params, upd), opt)

        return time_chained(step, (params, tx.init(params)), iters)

    from recsys_tpu.train import sparse_embed, streaming_embed

    plan = sparse_embed.build_plan(params, schema)
    rest, tables = sparse_embed.split_params(params, plan)
    emb0 = sparse_embed.init_state(tables, "lazy_adam", plan)
    aux = {k: jnp.asarray(v) for k, v in
           streaming_embed.make_host_prep(plan)(np.asarray(b["sparse"])).items()}
    b = dict(b, **aux)
    pert0 = variables["perturbations"]

    def step(state):
        rest, tables, emb, opt, t = state

        def loss_fn(rest_p, pert):
            full = sparse_embed.merge_params(rest_p, tables, plan)
            return bce_with_logits(
                model.apply({"params": full, "perturbations": pert}, b,
                            training=False),
                b["label"],
            )

        _, (grest, gpert) = jax.value_and_grad(
            loss_fn, argnums=(0, 1)
        )(rest, pert0)
        upd, opt = tx.update(grest, opt, rest)
        rest = optax.apply_updates(rest, upd)
        tables2, emb2 = streaming_embed.apply_updates_fused(
            tables, emb, plan, b, jax.tree_util.tree_leaves(gpert)[0],
            lr=1e-3, step=t + 1,
        )
        return (rest, tables2, emb2, opt, t + 1)

    return time_chained(
        step, (rest, tables, emb0, tx.init(rest), jnp.int32(0)), iters
    )


def run(batch: int, iters: int, fused: bool = True) -> dict:
    """Phase timings, each phase's roofline share and the full step.
    ``fused=True`` (the bench default): the step-relevant phase set is
    gather + dense + fused_bwd; the autodiff phases (scatter, update) are
    timed for comparison."""
    kind = jax.devices()[0].device_kind
    peaks(kind)  # fail before timing on a device without published peaks
    rng = np.random.default_rng(0)
    phases, analytic = build_phases(batch, rng)
    report = {"device": kind, "batch": batch, "fused": fused, "phases": {}}
    step_phases = (
        ("gather", "dense", "fused_bwd") if fused
        else ("gather", "dense", "scatter", "update")
    )

    for name, (fn, carry) in phases.items():
        ms = time_chained(fn, carry, iters)
        a = analytic[name]
        report["phases"][name] = {
            "ms": ms, "gb": a["bytes"] / 1e9, "gflops": a["flops"] / 1e9,
            **roofline_share(kind, a["bytes"], a["flops"], ms),
        }

    total_ms = full_step_ms(batch, rng, iters, fused=fused)
    phase_sum = sum(report["phases"][p]["ms"] for p in step_phases)
    sol_total = sum(report["phases"][p]["sol_ms"] for p in step_phases)
    report.update(
        step_phases=list(step_phases), full_step_ms=total_ms,
        phase_sum_ms=phase_sum, residual_ms=total_ms - phase_sum,
        sol_step_ms=sol_total, sol_share_step=sol_total / total_ms,
        examples_per_s=batch / (total_ms / 1e3),
    )
    return report


SCOPES = ("embedding_gather", "interaction", "bottom_mlp", "top_mlp",
          "table_update")
_HLO_LINE = re.compile(
    r'^\s*(?:ROOT )?%?([\w.\-]+) = .*?op_name="([^"]*)"', re.M)


def hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> the first :data:`SCOPES` entry in its
    ``op_name`` metadata (``'other'`` when none).  Names are also keyed
    with '.' and '-' as '_', the form GPU kernel names take."""
    out = {}
    for name, op_name in _HLO_LINE.findall(hlo_text):
        scope = next((sc for sc in SCOPES if sc in op_name), "other")
        out[name] = scope
        out[re.sub(r"[.\-]", "_", name)] = scope
    return out


def device_events(xplane_path: str) -> list:
    """(name, start_ns, duration_ns, hlo_op) of every kernel on the GPU
    planes' stream lines."""
    from jax.profiler import ProfileData

    out = []
    for plane in ProfileData.from_file(xplane_path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines or plane.lines:
            for ev in line.events:
                hlo_op = next((v for k, v in ev.stats if k == "hlo_op"),
                              None)
                out.append((ev.name, ev.start_ns, ev.duration_ns, hlo_op))
    return out


def busy_ns(events) -> float:
    """Length of the union of the events' [start, end) intervals."""
    total, end = 0.0, -1.0
    for _, start, dur, _ in sorted(events, key=lambda e: e[1]):
        if start >= end:
            total += dur
            end = start + dur
        elif start + dur > end:
            total += start + dur - end
            end = start + dur
    return total


def ceilings() -> dict:
    """What a large bf16 matmul and a large copy reach on this device."""
    n = 8192
    a = jnp.ones((n, n), jnp.bfloat16)
    mm = jax.jit(lambda x: x @ x)
    x = jnp.ones((256 * 1024 * 1024,), jnp.float32)  # 1 GiB
    cp = jax.jit(lambda x: x + 1.0)

    def best_ms(fn, arg):
        jax.block_until_ready(fn(arg))
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(arg))
            times.append(time.perf_counter() - t0)
        return min(times) * 1e3

    mm_ms, cp_ms = best_ms(mm, a), best_ms(cp, x)
    return {"matmul_bf16_tflops": 2 * n ** 3 / mm_ms / 1e9,
            "copy_gbytes_per_s": 2 * x.nbytes / cp_ms / 1e6}


def scope_costs(batch: int, table_bytes: int) -> dict:
    """Analytic (bytes, flops) per traced scope and train step."""
    f = NUM_SPARSE + 1
    pairs = f * (f - 1) // 2
    lookups = batch * NUM_SPARSE
    x_bytes = batch * f * EMBED_DIM * 2  # bf16 interaction operands

    def mlp_flops(in_dim, units, out_dim):
        dims = [in_dim, *units, out_dim]
        return 6 * batch * sum(a * b for a, b in zip(dims, dims[1:]))

    return {
        # packed 512-byte rows in, (B, F, D) out and its cotangent back
        "embedding_gather": (lookups * (128 * 4 + 2 * EMBED_DIM * 4), 0),
        # forward x in, pairs out; backward pairs and x in, dx out
        "interaction": (3 * x_bytes + 2 * batch * pairs * 4, 0),
        "bottom_mlp": (0, mlp_flops(NUM_DENSE, (*BOTTOM, EMBED_DIM),
                                    EMBED_DIM)),
        "top_mlp": (0, mlp_flops(EMBED_DIM + pairs, TOP, 1)),
        # cotangent permute + dense gradient write and read + p/m/v
        # read and write
        "table_update": (8 * table_bytes + 3 * lookups * EMBED_DIM * 4, 0),
    }


def trace_breakdown(logdir: str, batch: int = 16384, steps: int = 10) -> dict:
    """Trace ``steps`` Trainer train steps of the bench DLRM and reduce
    the trace to per-scope device time and roofline shares."""
    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.train.loop import Trainer, _device_batch

    kind = jax.devices()[0].device_kind
    peaks(kind)  # fail before tracing on a device without published peaks
    schema, data = synthetic_ctr(
        num_examples=batch, num_dense=NUM_DENSE, num_sparse=NUM_SPARSE,
        vocab_size=VOCAB, embed_dim=EMBED_DIM,
    )
    tr = Trainer(DLRM(schema, bottom_units=(*BOTTOM, EMBED_DIM),
                      top_units=TOP, compute_dtype=jnp.bfloat16,
                      sparse_embed_grads=True),
                 learning_rate=1e-3, embedding_optimizer="fused_adam")
    tr.fit(data, batch_size=batch, epochs=1, verbose=False)  # compile
    host = next(tr._batches(data, batch, False, True, with_aux=True))
    db = jax.device_put(_device_batch(host))
    key = jax.random.PRNGKey(0)
    hlo = tr._train_step.lower(tr.state, db, key).compile().as_text()
    state = tr.state

    def window(state):
        for _ in range(steps):
            state, loss, _ = tr._train_step(state, db, key)
        jax.block_until_ready((state, loss))
        return state

    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "step.hlo.txt"), "w") as f:
        f.write(hlo)
    for _ in range(3):  # warm, then a window long enough for the clock
        state = window(state)
    t0 = time.perf_counter()
    for _ in range(5):
        state = window(state)
    step_ms = (time.perf_counter() - t0) / (5 * steps) * 1e3
    jax.profiler.start_trace(logdir)
    state = window(state)
    jax.profiler.stop_trace()
    tr.state = state
    path = sorted(glob.glob(os.path.join(
        logdir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    events = device_events(path)
    if not events:
        raise RuntimeError(f"no GPU kernel events in {path}")
    names = hlo_scopes(hlo)
    per_scope: dict = {}
    unmapped: dict = {}
    for name, _, dur, hlo_op in events:
        sc = (names.get(hlo_op) or names.get(name)
              or names.get(re.sub(r"[.\-]", "_", name), "other"))
        per_scope[sc] = per_scope.get(sc, 0.0) + dur
        if sc == "other":
            unmapped[name] = unmapped.get(name, 0.0) + dur
    span = max(s + d for _, s, d, _ in events) - min(s for _, s, _, _ in
                                                    events)
    tables = [x for p, x in jax.tree_util.tree_leaves_with_path(
        state.params) if "StackedEmbedding" in jax.tree_util.keystr(p)]
    costs = scope_costs(batch, sum(t.size * 4 for t in tables))
    ceil = ceilings()
    rep = {"device": kind, "batch": batch, "steps": steps,
           "step_ms": step_ms, "device_step_ms": span / 1e6 / steps,
           "window_ms": span / 1e6,
           "device_busy_ms": busy_ns(events) / 1e6,
           "idle_share": 1.0 - busy_ns(events) / span, "ceilings": ceil,
           "scopes": {}}
    for sc in (*SCOPES, "other"):
        ms = per_scope.get(sc, 0.0) / 1e6 / steps
        entry = {"ms_per_step": ms,
                 "share_of_device_step": ms / (span / 1e6 / steps)}
        if sc in costs and ms > 0:
            nbytes, flops = costs[sc]
            entry.update(roofline_share(kind, nbytes, flops, ms))
            entry["share_of_ceiling"] = (
                nbytes / (ceil["copy_gbytes_per_s"] * 1e6) / ms if flops == 0
                else flops / (ceil["matmul_bf16_tflops"] * 1e9) / ms)
        rep["scopes"][sc] = entry
    rep["top_other_kernels_ms_per_step"] = {
        k: v / 1e6 / steps for k, v in
        sorted(unmapped.items(), key=lambda kv: -kv[1])[:15]}
    return rep


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=16384)
    p.add_argument("--iters", type=int, default=30)
    p.add_argument("--optax-path", action="store_true",
                   help="time the autodiff + optax composition instead of "
                   "the fused_adam default")
    p.add_argument("--trace", metavar="DIR",
                   help="trace the Trainer step into DIR and print the "
                   "per-scope breakdown instead")
    args = p.parse_args(argv)
    if args.trace:
        print(json.dumps(trace_breakdown(args.trace, batch=args.batch)))
        return
    rep = run(args.batch, args.iters, fused=not args.optax_path)

    w = sys.stderr.write
    w(f"device={rep['device']} batch={rep['batch']}\n")
    w(f"{'phase':<10}{'ms':>9}{'SoL ms':>9}{'share':>8}  bound\n")
    for name, e in rep["phases"].items():
        w(f"{name:<10}{e['ms']:>9.3f}{e['sol_ms']:>9.3f}"
          f"{e['share']:>8.3f}  {e['bound']}\n")
    w(f"full step {rep['full_step_ms']:.3f} ms; phase sum "
      f"{rep['phase_sum_ms']:.3f} ms; residual {rep['residual_ms']:.3f} ms\n")
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
