"""Count collective wire bytes per engine from the compiled HLO.

The a2a engines' reason for existing is the comm claim at
parallel/embedding_sharding.py (sharded_gather_a2a docstring): per-shard
traffic O(N/S ids + N*D/S vectors) vs the psum engine's O(N*D) full-output
reduction.  This tool turns the claim into a measured number: it compiles
each engine's fwd+bwd lookup on a (data x model) mesh and walks the
compiled (SPMD, per-device) HLO, summing the result bytes of every
collective op (all-to-all / all-reduce / all-gather / collective-permute /
reduce-scatter).

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python -m recsys_tpu.tools.comm_bytes [--batch 4096] [--vocab 100000]

Prints one JSON object on stdout and a table on stderr.  Bytes are
PER-DEVICE per step (the SPMD program is identical on every device).
"""
from __future__ import annotations

import argparse
import json
import os
import re
import sys

# must precede backend init: flags are read when the cpu backend is first
# created
os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

import jax.numpy as jnp
import numpy as np

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8": 1,
    "s64": 8, "s32": 4, "s16": 2, "s8": 1,
    "u64": 8, "u32": 4, "u16": 2, "u8": 1, "pred": 1,
}
_COLLECTIVES = (
    "all-to-all", "all-reduce", "all-gather", "collective-permute",
    "reduce-scatter",
)
_SHAPE_RE = re.compile(r"\b(\w+)\[([\d,]*)\]")


def _shape_bytes(span: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(span):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


def collective_bytes(hlo_text: str) -> dict:
    """{op_kind: {'count': n, 'bytes': result bytes}} over a compiled HLO."""
    out: dict[str, dict] = {}
    for line in hlo_text.splitlines():
        line = line.strip()
        m = re.match(r"%?\S+\s*=\s*(.*?)\s+([a-z\-]+)\(", line)
        if not m:
            continue
        result_span, op = m.groups()
        kind = next((c for c in _COLLECTIVES if op == c or
                     op.startswith(c + ".")), None)
        if kind is None:
            continue
        e = out.setdefault(kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += _shape_bytes(result_span)
    return out


def engine_step_hlo(engine: str, mesh, table, rows) -> str:
    """Compiled HLO text of a fwd+bwd lookup through ``engine``."""
    from recsys_tpu.parallel import embedding_sharding as es

    def gather(t, r):
        if engine == "psum":
            return es.sharded_gather(t, r, mesh)
        if engine == "dedup":
            return es.sharded_gather_dedup(t, r, mesh)
        if engine == "a2a":
            return es.sharded_gather_a2a(t, r, mesh, dedup=False)
        if engine == "a2a_cf1.25":
            return es.sharded_gather_a2a(t, r, mesh, capacity_factor=1.25)
        if engine == "a2a_dedup":
            return es.sharded_gather_a2a(t, r, mesh, dedup=True)
        if engine == "a2a_pipelined":
            return es.sharded_gather_a2a_pipelined(t, r, mesh, dedup=True)
        raise ValueError(engine)

    def step(t, r):
        # fwd + bwd: the grad path is where the psum engine pays again
        return jax.grad(lambda tt: jnp.sum(gather(tt, r) ** 2))(t)

    lowered = jax.jit(step).lower(table, rows)
    return lowered.compile().as_text()


def run(batch: int, vocab: int, d: int, fields: int = 8) -> dict:
    from recsys_tpu.parallel.embedding_sharding import shard_table
    from recsys_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=4, model=2)
    rng = np.random.default_rng(0)
    v = vocab + (-vocab) % 2
    table = shard_table(
        jnp.asarray(rng.normal(size=(v, d)), jnp.float32), mesh
    )
    rows = jnp.asarray(
        rng.integers(0, vocab, (batch, fields)).astype(np.int32)
    )
    report = {
        "mesh": dict(mesh.shape), "batch": batch, "vocab": vocab, "d": d,
        "fields": fields, "note": "bytes are per-device per train step",
        "engines": {},
    }
    for engine in ("psum", "dedup", "a2a", "a2a_cf1.25", "a2a_dedup",
                   "a2a_pipelined"):
        hlo = engine_step_hlo(engine, mesh, table, rows)
        per = collective_bytes(hlo)
        total = sum(e["bytes"] for e in per.values())
        report["engines"][engine] = {"total_bytes": total, "ops": per}
    base = report["engines"]["psum"]["total_bytes"]
    for name, e in report["engines"].items():
        e["vs_psum"] = round(e["total_bytes"] / base, 4) if base else None
    return report


def main(argv=None):
    p = argparse.ArgumentParser(prog="recsys_tpu.tools.comm_bytes")
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--vocab", type=int, default=100_000)
    p.add_argument("--d", type=int, default=16)
    p.add_argument("--fields", type=int, default=8)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rep = run(args.batch, args.vocab, args.d, args.fields)

    w = sys.stderr.write
    w(f"mesh={rep['mesh']} batch={rep['batch']} x {rep['fields']} fields, "
      f"vocab={rep['vocab']}, D={rep['d']}\n")
    w(f"{'engine':<14}{'collective bytes/step':>22}{'vs psum':>9}  ops\n")
    for name, e in rep["engines"].items():
        ops = ", ".join(f"{k} x{v['count']}" for k, v in e["ops"].items())
        w(f"{name:<14}{e['total_bytes']:>22,}{e['vs_psum']:>9}  {ops}\n")
    payload = json.dumps(rep)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload + "\n")
        size = os.path.getsize(args.out)
        if size <= 2:
            raise RuntimeError(f"artifact write produced {size} bytes")
    print(payload)


if __name__ == "__main__":
    main()
