"""Multi-host (multi-process) mesh execution — VERDICT round-1 #8.

Spawns two localhost CPU processes (4 virtual devices each), initialises
jax.distributed, builds the multi-process (data, model) mesh via
make_multihost_mesh(model=2) — exercising the process_is_granule n_proc>1
branch of parallel/mesh.py — and runs one full Trainer epoch through both
the compiler-partitioned and the explicit a2a embedding engines."""
import os
import re
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(__file__), "assets",
                      "multihost_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_mesh_trains_both_engines():
    port = _free_port()
    env = dict(
        os.environ,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PYTHONPATH=REPO,
    )
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(port)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(2)
    ]
    outs = [p.communicate(timeout=540)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-2000:]
    # both processes computed the same loss for each engine
    losses = {}
    for out in outs:
        for m in re.finditer(
            r"RESULT proc=(\d) engine=(\w+) loss=([0-9.e+-]+)", out
        ):
            losses.setdefault(m.group(2), set()).add(m.group(3))
    assert set(losses) == {"gather", "a2a", "fused", "fused_local"}, losses
    for engine, vals in losses.items():
        assert len(vals) == 1, (engine, vals)  # procs agree bit-for-bit
    # the fused streaming update across 2 processes matches a
    # single-process run of the same config on an equal-shaped mesh
    # (VERDICT r3 next-step #3): same global batch order, same shard
    # fences, same kernel — only process count differs
    import numpy as np

    from recsys_tpu.data.synthetic import synthetic_ctr
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train.loop import Trainer

    schema, data = synthetic_ctr(num_examples=256, num_dense=2,
                                 num_sparse=4, vocab_size=64, embed_dim=4,
                                 seed=11)
    tr = Trainer(DLRM(schema, bottom_units=(16, 4), top_units=(16,),
                      sparse_embed_grads=True),
                 learning_rate=1e-2, mesh=make_mesh(data=4, model=2),
                 seed=3, embedding_optimizer="fused_adam")
    h = tr.fit(data, batch_size=64, epochs=1, verbose=False)
    (two_proc_loss,) = losses["fused"]
    np.testing.assert_allclose(h["loss"][0], float(two_proc_loss),
                               rtol=0, atol=1e-6)
    # the LOCAL-contract 2-process run (each process passed only its 32
    # rows, per-shard host prep) matches a single-process local-contract
    # run of the same mesh shape: same one-batch dataset, so only f32
    # reduction order across shuffled row order / streams differs
    schema2, data2 = synthetic_ctr(num_examples=64, num_dense=2,
                                   num_sparse=4, vocab_size=64,
                                   embed_dim=4, seed=13)
    tr2 = Trainer(DLRM(schema2, bottom_units=(16, 4), top_units=(16,),
                       sparse_embed_grads=True),
                  learning_rate=1e-2, mesh=make_mesh(data=4, model=2),
                  seed=3, embedding_optimizer="fused_adam",
                  data_contract="local")
    h2 = tr2.fit(data2, batch_size=64, epochs=2, verbose=False)
    (local_loss,) = losses["fused_local"]
    np.testing.assert_allclose(h2["loss"][-1], float(local_loss),
                               rtol=0, atol=2e-5)
