"""What the program needs from its installation and its devices: the DLRM
path imports without flax and friends, the compile cache follows
JAX_COMPILATION_CACHE_DIR, and the multi-device dry run refuses to run on
too few devices instead of switching platform."""
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("flax", "msgpack", "pandas", "sklearn", "tensorflow")


def _run(code: str, **env) -> subprocess.CompletedProcess:
    full_env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env)
    for k, v in env.items():
        if v is None:
            full_env.pop(k)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=REPO, env=full_env, capture_output=True,
                          text=True, timeout=300)


def test_dlrm_path_runs_with_optional_packages_blocked():
    """chip_smoke's single-card phases, bench.py's DLRM step, the Trainer
    and checkpoints run with flax, msgpack, pandas, sklearn and
    tensorflow unimportable."""
    r = _run(f"""
        import importlib.abc, sys

        class Block(importlib.abc.MetaPathFinder):
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in {BLOCKED!r}:
                    raise ImportError(f"blocked: {{name}}")

        sys.meta_path.insert(0, Block())
        import os, tempfile
        import numpy as np
        import recsys_tpu, bench, chip_smoke
        from recsys_tpu.train import checkpoint

        tiny = chip_smoke.Widths(
            batch=32, num_sparse=3, vocab=200, embed_dim=8, num_dense=2,
            bottom=(8,), top=(8,), steps=2, attention=((2, 1, 8, 4),))
        chip_smoke.phase_trainer(tiny)
        chip_smoke.phase_reference(tiny)
        chip_smoke.phase_ops(tiny, routes=("xla",))
        bench.BATCH, bench.VOCAB, bench.WARMUP, bench.STEPS = 32, 200, 1, 1
        assert bench.bench_framework(np.random.default_rng(0)) > 0

        from recsys_tpu.data.synthetic import synthetic_ctr
        from recsys_tpu.models.ctr.dlrm import DLRM
        from recsys_tpu.train.loop import Trainer

        schema, data = synthetic_ctr(num_examples=64, num_sparse=3,
                                     vocab_size=50, embed_dim=8)
        tr = Trainer(DLRM(schema, bottom_units=(8,), top_units=(8,),
                          sparse_embed_grads=True),
                     embedding_optimizer="fused_adam")
        tr.fit(data, batch_size=32, epochs=1, verbose=False)
        with tempfile.TemporaryDirectory() as d:
            checkpoint.save(os.path.join(d, "ck.npz"), tr.state)
            checkpoint.restore(os.path.join(d, "ck.npz"), tr.state)
        loaded = [m for m in {BLOCKED!r} if m in sys.modules]
        assert not loaded, loaded
        print("OK")
    """)
    assert r.returncode == 0 and "OK" in r.stdout, r.stderr[-3000:]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR set: JAX uses it and nothing else is set
    in code; unset: the fixed <repo>/.jax_cache."""
    want = str(tmp_path / env_dir) if env_dir else os.path.join(
        REPO, ".jax_cache")
    r = _run("""
        import jax
        from recsys_tpu.tools import enable_compile_cache
        print(enable_compile_cache())
        print(jax.config.jax_compilation_cache_dir)
    """, JAX_COMPILATION_CACHE_DIR=want if env_dir else None)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == [want, want]


def test_dryrun_multichip_raises_on_too_few_devices():
    import jax

    import __graft_entry__

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"need {n} devices"):
        __graft_entry__.dryrun_multichip(n)
    assert jax.devices()[0].platform == "cpu"
