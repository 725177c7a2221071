"""Smoke test of the training system on NVIDIA GPUs.

    python chip_smoke.py          # one card: every single-card phase
    python chip_smoke.py --four   # four cards: the sharded-mesh phase only

One process drives the card(s); ``nvidia-smi`` runs as a child that stays
off JAX.  Phases, in order (one card):

1. device and installation: refuse anything but a GPU; print the card,
   the versions, and which optional packages import (information only --
   the DLRM path needs none of them);
2. DLRM through ``Trainer.fit`` at bench.py's widths with the production
   ``fused_adam`` table update and bf16 compute: a few finite losses;
3. one training step of the framework's DLRM against a plain per-field
   float32 DLRM at ``default_matmul_precision("highest")``, from the same
   initial weights: f32 compute under optax Adam and under ``fused_adam``
   (loss and updated tables), bf16 compute (loss);
4. op checks at real widths against float32 references at "highest": the
   dot interaction, the table update (Adam and rowwise AdaGrad), and
   ``dispatch.sdpa`` at SASRec's shapes, forward and backward, with the
   XLA and cuDNN attention routes timed.

``--four`` instead trains on ``make_mesh(data=4)`` and on
``make_mesh(data=2, model=2)`` (row-sharded tables, model-axis table
update, ``gather`` and exact ``a2a`` engines) and compares every step's
loss with a single-card run of the same batches.

Any failed check raises, so the process exits non-zero; the last line of
a passing run is one JSON object naming the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from recsys_tpu.data.synthetic import synthetic_ctr
from recsys_tpu.kernels import attention as attention_ref
from recsys_tpu.kernels import dispatch
from recsys_tpu.kernels import interactions
from recsys_tpu.models.ctr.dlrm import DLRM
from recsys_tpu.parallel.mesh import make_mesh
from recsys_tpu.tools import enable_compile_cache
from recsys_tpu.train import sparse_embed
from recsys_tpu.train.losses import bce_with_logits
from recsys_tpu.train.loop import Trainer
from recsys_tpu.train.streaming_embed import apply_updates_fused, make_host_prep

# f32 vs f32 at "highest": the two sides differ only in summation order,
# which moves a float32 loss by ~1e-7 relative.
LOSS_RTOL_F32 = 1e-5
# Updated tables: one Adam step moves a touched value by ~lr = 1e-3; an
# error of 1e-7 (f32 rounding of values ~0.05 is 4e-9) is 1e-4 of a step.
TABLE_ATOL = 1e-7
TABLE_RTOL = 1e-5
# bf16 keeps 8 significant bits (eps 2^-8 = 3.9e-3).  The bf16 DLRM rounds
# embeddings, every layer's inputs and activations; the loss, a mean of
# per-example terms near log 2, stays within a few eps: 4 * 2^-8.
LOSS_RTOL_BF16 = 4 * 2.0 ** -8
# bf16 attention against the f32 reference: a few bf16 eps of the output
# scale, for both the forward and the gradients.
ATTN_TOL_BF16 = 4 * 2.0 ** -8
# f32 ops at "highest" against f32 references at "highest".
OP_RTOL_F32 = 1e-5
OP_ATOL_F32 = 1e-6
# four cards vs one on f32 "highest": summation order of the data-axis
# gradient reduction and of the sharded table update; Adam's sign-like
# first steps carry it into later losses.
FOUR_LOSS_RTOL = 1e-4


@dataclasses.dataclass(frozen=True)
class Widths:
    """The DLRM shapes of a run (bench.py's by default)."""

    batch: int = 16384
    num_sparse: int = 26
    vocab: int = 100_000
    embed_dim: int = 16
    num_dense: int = 13
    bottom: tuple = (512, 256, 16)
    top: tuple = (1024, 1024, 512, 256)
    lr: float = 1e-3
    steps: int = 3
    # SASRec attention shapes: (batch, heads, seq, head dim)
    attention: tuple = ((256, 2, 512, 32), (64, 2, 2048, 32))


BENCH = Widths()


def log(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, err: float, limit: float) -> None:
    """Print an error beside its limit; raise if it is over."""
    ok = bool(np.isfinite(err)) and err <= limit
    log(f"  {name}: {err:.3e} (limit {limit:.3e}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: {err} > {limit}")


def rel_err(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)),
                                                   1e-30))


def allclose_err(got, want, rtol: float, atol: float) -> float:
    """max |got - want| / (atol + rtol |want|): <= 1 means allclose."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (atol + rtol * np.abs(want))))


# -- phase 1 ----------------------------------------------------------------

def require_gpu(count: int = 1) -> jax.Device:
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found platform "
            f"{devices[0].platform!r} ({devices[0].device_kind})"
        )
    if len(devices) < count:
        raise SystemExit(f"need {count} GPUs, JAX found {len(devices)}")
    return devices[0]


def _child(cmd: list[str]) -> subprocess.CompletedProcess:
    # JAX_PLATFORMS=cpu: a child never opens the card this process uses
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))


def nvidia_smi() -> str:
    out = _child(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip()


def phase_device(count: int = 1) -> dict:
    dev = require_gpu(count)
    import jaxlib

    log("== phase 1: device and installation")
    log(f"device_kind: {dev.device_kind}; devices: {len(jax.devices())}")
    log(f"jax {jax.__version__}; jaxlib {jaxlib.__version__}; "
        f"python {sys.version.split()[0]}")
    from importlib.metadata import PackageNotFoundError, version

    for pkg in ("jax-cuda12-plugin", "jax-cuda13-plugin"):
        try:
            log(f"cuda plugin: {pkg} {version(pkg)}")
        except PackageNotFoundError:
            pass
    # the card(s) as `nvidia-smi --query-gpu=name,power.limit
    # --format=csv,noheader` prints them, one line per card
    log("nvidia-smi name, power.limit:")
    log(nvidia_smi())
    from recsys_tpu.data import native

    log(f"native library builds and loads: {native.available()}")
    for pkg in ("flax", "pandas", "msgpack"):
        r = _child([sys.executable, "-c", f"import {pkg}"])
        log(f"optional package {pkg} imports: {r.returncode == 0}")
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# -- data and models ----------------------------------------------------------

def ctr_data(w: Widths, n: int, seed: int = 0):
    return synthetic_ctr(
        num_examples=n, num_dense=w.num_dense, num_sparse=w.num_sparse,
        vocab_size=w.vocab, embed_dim=w.embed_dim, seed=seed,
    )


def dlrm(schema, w: Widths, **kw) -> DLRM:
    return DLRM(schema, bottom_units=w.bottom, top_units=w.top, **kw)


def fit_steps(tr: Trainer, data: dict, w: Widths) -> tuple[list, list]:
    """One ``Trainer.fit`` epoch per batch of ``w.batch`` rows; returns the
    per-step losses and the per-step a2a drop histories."""
    losses, drops = [], []
    for s in range(len(data["label"]) // w.batch):
        sl = slice(s * w.batch, (s + 1) * w.batch)
        h = tr.fit({k: v[sl] for k, v in data.items()}, batch_size=w.batch,
                   epochs=1, verbose=False)
        losses.append(h["loss"][0])
        drops.append(h.get("a2a_dropped"))
    return losses, drops


# -- phase 2 ----------------------------------------------------------------

def phase_trainer(w: Widths) -> list[float]:
    log(f"== phase 2: DLRM Trainer.fit, fused_adam, bf16 compute, "
        f"B={w.batch}, {w.num_sparse} fields x {w.vocab} x D={w.embed_dim}")
    schema, data = ctr_data(w, w.batch * w.steps)
    tr = Trainer(dlrm(schema, w, compute_dtype=jnp.bfloat16,
                      sparse_embed_grads=True),
                 learning_rate=w.lr, embedding_optimizer="fused_adam")
    t0 = time.perf_counter()
    losses, _ = fit_steps(tr, data, w)
    log(f"losses: {losses} ({time.perf_counter() - t0:.1f} s incl. compile)")
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"non-finite DLRM losses {losses}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    return losses


# -- phase 3 ----------------------------------------------------------------

def unpack_tables(model: DLRM, params: dict) -> list[np.ndarray]:
    """Per-field (V, D) tables from the packed group tables."""
    lay = model.layout
    emb = params["StackedEmbedding_0"]
    out = []
    for f in model.schema.sparse:
        off = lay.field_offset(f.name)
        out.append(np.asarray(
            lay.table_logical(emb, f.name)[off:off + f.vocab_size]
        ))
    return out


def reference_params(model: DLRM, params: dict) -> dict:
    return {"tables": [jnp.asarray(t) for t in unpack_tables(model, params)],
            "bottom": params["MLP_0"], "top": params["MLP_1"]}


def reference_loss(p: dict, batch: dict) -> jnp.ndarray:
    """Plain float32 DLRM: one table per field, a Python loop of gathers."""
    embs = [jnp.take(t, batch["sparse"][:, i], axis=0)
            for i, t in enumerate(p["tables"])]

    def tower(layers, x):
        for i in range(len(layers)):
            x = x @ layers[f"Dense_{i}"]["kernel"] + layers[f"Dense_{i}"]["bias"]
            if i < len(layers) - 1:
                x = jax.nn.relu(x)
        return x

    z = tower(p["bottom"], batch["dense"])
    feats = jnp.stack([z] + embs, axis=1)
    gram = jnp.einsum("bfd,bgd->bfg", feats, feats)
    rows, cols = np.tril_indices(feats.shape[1], k=-1)
    logits = tower(p["top"], jnp.concatenate([z, gram[:, rows, cols]], -1))
    return bce_with_logits(logits[..., 0], batch["label"])


def phase_reference(w: Widths) -> None:
    log("== phase 3: one training step against the plain float32 DLRM "
        "(matmul precision 'highest')")
    schema, data = ctr_data(w, w.batch, seed=1)
    batch = {k: jnp.asarray(v) for k, v in data.items()}
    ref_step = jax.jit(jax.value_and_grad(reference_loss))
    with jax.default_matmul_precision("highest"):
        for update in ("optax", "fused_adam"):
            fused = update == "fused_adam"
            model = dlrm(schema, w, sparse_embed_grads=fused)
            tr = Trainer(model, learning_rate=w.lr, seed=3,
                         embedding_optimizer="fused_adam" if fused else None)
            tr.init(data)
            p0 = jax.device_get(tr.state.params)
            h = tr.fit(data, batch_size=w.batch, epochs=1, verbose=False)
            ref = reference_params(model, p0)
            ref_loss, grads = ref_step(ref, batch)
            ref_loss = float(ref_loss)
            tx = optax.adam(w.lr)
            upd, _ = tx.update(grads, tx.init(ref), ref)
            ref_tables = optax.apply_updates(ref, upd)["tables"]
            got_tables = unpack_tables(model, jax.device_get(tr.state.params))
            log(f" f32 compute, table update {update}: loss "
                f"{h['loss'][0]:.7f} vs reference {ref_loss:.7f}")
            check("loss relative error",
                  abs(h["loss"][0] - ref_loss) / abs(ref_loss), LOSS_RTOL_F32)
            check(f"updated tables, max |err| / ({TABLE_ATOL:g} + "
                  f"{TABLE_RTOL:g} |ref|)",
                  max(allclose_err(g, r, TABLE_RTOL, TABLE_ATOL)
                      for g, r in zip(got_tables, ref_tables)), 1.0)
        m16 = dlrm(schema, w, compute_dtype=jnp.bfloat16)
        loss16 = float(jax.jit(lambda v, b: bce_with_logits(
            m16.apply(v, b), b["label"]))({"params": p0}, batch))
    log(f" bf16 compute: loss {loss16:.7f} vs reference {ref_loss:.7f}")
    check("bf16 loss relative error", abs(loss16 - ref_loss) / abs(ref_loss),
          LOSS_RTOL_BF16)


# -- phase 4 ----------------------------------------------------------------

def check_interaction(w: Widths, rng: np.random.Generator) -> None:
    f = w.num_sparse + 1
    x = jnp.asarray(rng.standard_normal((w.batch, f, w.embed_dim)),
                    jnp.float32)
    g = jnp.asarray(rng.standard_normal((w.batch, f * (f - 1) // 2)),
                    jnp.float32)
    rows, cols = np.tril_indices(f, k=-1)

    def ref(x):
        return jnp.einsum("bfd,bgd->bfg", x, x)[:, rows, cols]

    log(f" dot interaction B={w.batch} F={f} D={w.embed_dim}, f32 at "
        "'highest' vs the einsum reference")
    with jax.default_matmul_precision("highest"):
        got, vjp = jax.vjp(jax.jit(interactions.dot_interaction), x)
        want, vjp_ref = jax.vjp(ref, x)
        check("forward", allclose_err(got, want, OP_RTOL_F32, OP_ATOL_F32),
              1.0)
        check("gradient", allclose_err(vjp(g)[0], vjp_ref(g)[0],
                                       OP_RTOL_F32, OP_ATOL_F32), 1.0)


def check_table_update(w: Widths, rng: np.random.Generator) -> None:
    """One group of bench width through apply_updates_fused against dense
    optax Adam and a plain rowwise-AdaGrad on the unpacked (V, D) table."""
    from recsys_tpu.kernels.embedding import pack_factor
    from recsys_tpu.ops.embedding import _pad8

    v, d, b = w.vocab, w.embed_dim, w.batch
    pack = pack_factor(d, v)
    vp = _pad8(-(-v // pack))
    plan = sparse_embed.EmbedPlan(
        prefix=("E",), table_names=("table_0",), group_cols=((0,),),
        group_offsets=((0,),), packs=(pack,), embed_dim=d,
        group_vocab=(v,))
    ids = rng.integers(0, v, (b, 1)).astype(np.int32)
    cot = jnp.asarray(rng.standard_normal((b, 1, d)) * 1e-2, jnp.float32)
    table = rng.uniform(-0.05, 0.05, (vp * pack, d)).astype(np.float32)
    aux = {k: jnp.asarray(a) for k, a in make_host_prep(plan)(ids).items()}
    g = jnp.zeros((vp * pack, d)).at[ids[:, 0]].add(cot[:, 0])
    packed = jnp.asarray(table.reshape(vp, pack * d))
    log(f" table update, one group V={v} D={d} pack={pack}, B={b}")
    with jax.default_matmul_precision("highest"):
        new, st = jax.jit(lambda t, s, bt, c: apply_updates_fused(
            {"table_0": t}, {"table_0": s}, plan, bt, c, lr=w.lr,
            step=jnp.int32(1), kind="adam",
        ))(packed, {"m": jnp.zeros_like(packed), "v": jnp.zeros_like(packed)},
           aux, cot)
        tx = optax.adam(w.lr)
        upd, _ = tx.update(g, tx.init(jnp.asarray(table)), jnp.asarray(table))
        want = optax.apply_updates(jnp.asarray(table), upd)
        check("adam vs optax.adam, tables",
              allclose_err(np.asarray(new["table_0"]).reshape(-1, d), want,
                           TABLE_RTOL, TABLE_ATOL), 1.0)
        acc0 = jnp.zeros((vp, pack), jnp.float32)
        new, st = jax.jit(lambda t, s, bt, c: apply_updates_fused(
            {"table_0": t}, {"table_0": s}, plan, bt, c, lr=w.lr,
            step=jnp.int32(1), kind="rowwise_adagrad",
        ))(packed, {"acc": acc0}, aux, cot)
    acc = np.mean(np.asarray(g, np.float64) ** 2, axis=1)
    want = table - w.lr * np.asarray(g) / (np.sqrt(acc) + 1e-8)[:, None]
    check("rowwise adagrad vs plain reference, tables",
          allclose_err(np.asarray(new["table_0"]).reshape(-1, d), want,
                       TABLE_RTOL, TABLE_ATOL), 1.0)
    check("rowwise adagrad accumulators",
          allclose_err(np.asarray(st["table_0"]["acc"]).reshape(-1), acc,
                       OP_RTOL_F32, 1e-12), 1.0)


def _time_ms(fn, *args, iters: int = 10) -> float:
    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) * 1e3


def check_attention(shape: tuple, rng: np.random.Generator,
                    routes: tuple = ("xla", "cudnn")) -> None:
    """f32 sdpa at 'highest' and each bf16 route against the f32
    reference, forward and backward, then each route's time."""
    b, h, s, dh = shape
    q, k, v = (jnp.asarray(rng.standard_normal((b, h, s, dh)), jnp.float32)
               for _ in range(3))
    # left-padded histories, as SASRec feeds them: the first `pad` keys of
    # each row are masked, and key s-1 is always real.  Query rows inside
    # the padding see no key under the causal mask; SASRec zeroes them, so
    # they are left out of the comparison.
    pad = rng.integers(0, s // 2, b)
    mask = jnp.asarray(np.arange(s)[None, :] >= pad[:, None])
    valid = jnp.asarray(np.asarray(mask)[:, None, :, None])
    causal = np.arange(s)[:, None] >= np.arange(s)[None, :]
    full = jnp.asarray(np.asarray(mask)[:, None, None, :] & causal)

    def masked(out):
        return jnp.where(valid, out.astype(jnp.float32), 0.0)

    def fns(attend):
        fwd = jax.jit(lambda q, k, v: masked(attend(q, k, v)))
        grad = jax.jit(jax.grad(
            lambda q, k, v: jnp.sum(masked(attend(q, k, v)) ** 2),
            argnums=(0, 1, 2)))
        return fwd, grad

    def route(impl):
        return fns(lambda q, k, v: dispatch.sdpa(
            q, k, v, mask, causal=True, implementation=impl))

    log(f" sdpa B={b} H={h} S={s} Dh={dh}, causal + left-padded key mask")
    times = {}
    with jax.default_matmul_precision("highest"):
        ref_fwd, ref_grad = fns(
            lambda q, k, v: attention_ref.sdpa(q, k, v, full))
        want, want_g = ref_fwd(q, k, v), ref_grad(q, k, v)
        impl32 = dispatch.attention_implementation(jnp.float32)
        fwd, grad = route(impl32)
        log(f"  f32 route {impl32}, precision 'highest'")
        check("f32 forward", allclose_err(fwd(q, k, v), want, OP_RTOL_F32,
                                          OP_ATOL_F32), 1.0)
        check("f32 gradients", max(
            allclose_err(a, b_, 1e-4, 1e-5)
            for a, b_ in zip(grad(q, k, v), want_g)), 1.0)
    times[("f32", impl32)] = (_time_ms(fwd, q, k, v),
                              _time_ms(grad, q, k, v))
    args = tuple(t.astype(jnp.bfloat16) for t in (q, k, v))
    for impl in routes:
        fwd, grad = route(impl)
        check(f"bf16 {impl} forward, max |err| / max |ref|",
              rel_err(fwd(*args), want), ATTN_TOL_BF16)
        check(f"bf16 {impl} gradients, max |err| / max |ref|", max(
            rel_err(a.astype(jnp.float32), b_)
            for a, b_ in zip(grad(*args), want_g)), ATTN_TOL_BF16)
        times[("bf16", impl)] = (_time_ms(fwd, *args), _time_ms(grad, *args))
    for (dtype, impl), (f, g) in times.items():
        log(f"  time {dtype} {impl}: forward {f:.3f} ms, forward+backward "
            f"{g:.3f} ms")
    log(f"  route chosen by dtype: f32 {impl32}, bf16 "
        f"{dispatch.attention_implementation(jnp.bfloat16)}")


def phase_ops(w: Widths, routes: tuple = ("xla", "cudnn")) -> None:
    log("== phase 4: op checks against float32 references")
    rng = np.random.default_rng(4)
    check_interaction(w, rng)
    check_table_update(w, rng)
    for shape in w.attention:
        check_attention(shape, rng, routes)


# -- four cards ---------------------------------------------------------------

def phase_four(w: Widths) -> None:
    log("== four cards: Trainer.fit on meshes vs one card, f32 compute at "
        "'highest', fused_adam")
    schema, data = ctr_data(w, w.batch * w.steps, seed=2)

    def run(mesh, engine=None):
        kw = None
        if engine is not None:
            kw = {"engine": engine, "mesh": mesh, "capacity_factor": None}
        tr = Trainer(dlrm(schema, w, sparse_embed_grads=True, embed_kw=kw),
                     learning_rate=w.lr, embedding_optimizer="fused_adam",
                     mesh=mesh, seed=5)
        losses, drops = fit_steps(tr, data, w)
        return losses, drops, tr

    with jax.default_matmul_precision("highest"):
        one, _, _ = run(None)
        log(f" one card: {one}")
        cases = [("data=4", make_mesh(data=4, devices=jax.devices()[:4]),
                  None)]
        m22 = make_mesh(data=2, model=2, devices=jax.devices()[:4])
        cases += [("data=2 model=2 gather", m22, None),
                  ("data=2 model=2 a2a", m22, "a2a")]
        for name, mesh, engine in cases:
            losses, drops, tr = run(mesh, engine)
            shards = tr._fused_shards
            log(f" {name}: {losses}; table shards {sorted(set(shards.values()))}"
                + (f"; a2a_dropped per step {drops}" if engine else ""))
            check(f"{name} loss relative error vs one card",
                  max(abs(a - b) / abs(b) for a, b in zip(losses, one)),
                  FOUR_LOSS_RTOL)
            if "model=2" in name and max(shards.values()) != 2:
                raise AssertionError(f"{name}: tables not row-sharded")
            if engine is not None and any(d != [0] for d in drops):
                raise AssertionError(f"{name}: a2a dropped ids {drops}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--four", action="store_true",
                   help="run only the four-card sharded-mesh phase")
    args = p.parse_args(argv)
    count = 4 if args.four else 1
    require_gpu(count)
    enable_compile_cache()
    device = phase_device(count)
    if args.four:
        phase_four(BENCH)
    else:
        phase_trainer(BENCH)
        phase_reference(BENCH)
        phase_ops(BENCH)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
