"""a2a capacity-factor headroom under production id skew — measured.

The a2a engine's docstring claims "dedup collapses hot ids so skewed
traffic fits a small capacity factor" (ops/embedding.py); until this
tool that was an unmeasured story.  Here the claim gets numbers: on a
(data x model) virtual mesh, count ids DROPPED per lookup
(`a2a_dropped`, the engine's overflow observability) across capacity
factors x {uniform, zipf(1.1)} ids x dedup {off, on}.

Wire context: the vector exchange moves capacity_factor * N * D bytes
each way (tools/comm_bytes.py), so the smallest cf with zero drops IS
the engine's wire cost under that traffic.  Skew makes per-owner bucket
sizes uneven (hot shards overflow first); dedup collapses duplicate hot
ids BEFORE bucketing, so skewed traffic needs a smaller cf than uniform
— a distributed-path saving that uniform traffic does not show.

Runs on the virtual CPU mesh (drop counts are a program property, not a
bandwidth measurement).  Run:

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python -m recsys_tpu.tools.skew_capacity --out artifacts/skew_capacity.json
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

import jax
import jax.numpy as jnp

from recsys_tpu.tools.dedup_probe import zipf_ids

VOCAB = 100_000
EMBED_DIM = 16
BATCH = 4096
FIELDS = 8


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default=None)
    p.add_argument("--data", type=int, default=2)
    p.add_argument("--model", type=int, default=4)
    args = p.parse_args(argv)

    from recsys_tpu.parallel import embedding_sharding as es
    from recsys_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(data=args.data, model=args.model)
    rng = np.random.default_rng(0)
    table = jnp.asarray(
        rng.uniform(-0.05, 0.05, (VOCAB, EMBED_DIM)), jnp.float32
    )
    n = BATCH * FIELDS
    ids = {
        "uniform": rng.integers(0, VOCAB, (BATCH, FIELDS)).astype(np.int32),
        "zipf": np.stack(
            [zipf_ids(rng, BATCH, VOCAB) for _ in range(FIELDS)], axis=1
        ),
    }
    rep = {
        "mesh": {"data": args.data, "model": args.model},
        "batch": BATCH, "fields": FIELDS, "vocab": VOCAB,
        "lookups_per_step": n, "results": [],
    }
    w = sys.stderr.write
    for dist, arr in ids.items():
        uniq = np.unique(arr).shape[0]
        w(f"[{dist}] unique ids in batch: {uniq}/{n}\n")
        rows = jnp.asarray(arr)
        for dedup in (False, True):
            for cf in (0.25, 0.5, 0.75, 1.0, 1.25, 2.0):
                _, dropped = es.sharded_gather_a2a(
                    table, rows, mesh, capacity_factor=cf, dedup=dedup,
                    return_stats=True,
                )
                d = int(jnp.sum(dropped))
                rep["results"].append({
                    "dist": dist, "dedup": dedup, "cf": cf,
                    "dropped": d,
                    "dropped_frac": round(d / n, 4),
                })
                w(f"[{dist}] dedup={int(dedup)} cf={cf:4}: "
                  f"dropped {d}/{n} ({100 * d / n:.2f}%)\n")
    # smallest zero-drop cf per (dist, dedup)
    summary = {}
    for dist in ids:
        for dedup in (False, True):
            zs = [r["cf"] for r in rep["results"]
                  if r["dist"] == dist and r["dedup"] == dedup
                  and r["dropped"] == 0]
            summary[f"{dist}_dedup{int(dedup)}_min_zero_drop_cf"] = (
                min(zs) if zs else None
            )
    rep["min_zero_drop_cf"] = summary
    out = json.dumps(rep, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
