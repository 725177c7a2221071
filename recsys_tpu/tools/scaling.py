"""Data-parallel scaling-efficiency harness.

Measures DLRM train-step throughput at 1, 2, ..., N devices on the current
backend (real chips when available; the virtual CPU mesh otherwise — which
validates mechanics, not interconnect bandwidth) and reports examples/s plus scaling
efficiency vs the single-device run, per the SURVEY.md §6 performance axis.

    python -m recsys_tpu.tools.scaling [--per-device-batch 2048] [--steps 10]
"""
from __future__ import annotations

import argparse
import json
import time

import jax
import numpy as np
import optax


def measure(per_device_batch: int, steps: int, vocab: int, embed_dim: int):
    import jax.numpy as jnp

    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train.loop import Trainer

    devices = jax.devices()
    results = []
    n = 1
    while n <= len(devices):
        batch = per_device_batch * n
        schema, data = synthetic_ctr(
            num_examples=batch, num_dense=13, num_sparse=26,
            vocab_size=vocab, embed_dim=embed_dim, seed=0,
        )
        mesh = make_mesh(data=n, model=1, devices=devices[:n])
        tr = Trainer(DLRM(schema, bottom_units=(128, 64),
                          top_units=(256, 128)),
                     learning_rate=1e-3, mesh=mesh)
        tr.fit(data, batch_size=batch, epochs=1, verbose=False)  # compile
        t0 = time.perf_counter()
        tr.fit(data, batch_size=batch, epochs=steps, verbose=False)
        # fit syncs per-epoch via float(loss)
        dt = time.perf_counter() - t0
        ex_s = batch * steps / dt
        results.append({"devices": n, "examples_per_s": round(ex_s, 1)})
        n *= 2
    base = results[0]["examples_per_s"]
    for r in results:
        r["scaling_efficiency"] = round(
            r["examples_per_s"] / (base * r["devices"]), 3
        )
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--per-device-batch", type=int, default=2048)
    p.add_argument("--steps", type=int, default=5)
    p.add_argument("--vocab", type=int, default=10_000)
    p.add_argument("--embed-dim", type=int, default=16)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    dev = jax.devices()[0]
    measured = measure(args.per_device_batch, args.steps, args.vocab,
                       args.embed_dim)
    rep = {
        "backend": dev.platform,
        "device_kind": dev.device_kind,
        "kind": (
            "mechanics only (virtual CPU mesh: validates the SPMD "
            "program + collective placement, NOT interconnect bandwidth)"
            if dev.platform == "cpu" else "measured"
        ),
        "measured": measured,
    }
    out = json.dumps(rep, indent=1)
    print(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")


if __name__ == "__main__":
    main()
