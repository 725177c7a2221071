"""chip_smoke.py's phases at tiny widths on the CPU (the checks and the
references are the ones the card runs at bench width), and its refusal to
run without a GPU.

Each phase runs in a child process of its own, on the same 8 virtual CPU
devices, so the compiled programs and host memory of these whole-model
runs do not stay in the test worker.
"""
import ast
import os
import subprocess
import sys

import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = chip_smoke.Widths(
    batch=64, num_sparse=4, vocab=1000, embed_dim=16, num_dense=3,
    bottom=(16, 16), top=(32, 16), steps=2, attention=((2, 2, 16, 8),),
)


def _run_phase(call: str) -> str:
    """Run ``chip_smoke.<call>`` on TINY widths in a fresh CPU process."""
    code = (
        "import chip_smoke\n"
        f"TINY = chip_smoke.{TINY!r}\n"
        f"out = chip_smoke.{call}\n"
        "print('RESULT', out)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    return r.stdout


def test_main_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert "needs a GPU" in str(e.value.code)
    assert "'cpu'" in str(e.value.code)


def test_phase_trainer_tiny():
    out = _run_phase("phase_trainer(TINY)")
    losses = ast.literal_eval(out.split("RESULT", 1)[1].strip())
    assert len(losses) == TINY.steps
    assert all(abs(x) < float("inf") for x in losses), losses


def test_phase_reference_tiny():
    out = _run_phase("phase_reference(TINY)")
    assert out.count(" ok") == 5, out


def test_phase_ops_tiny():
    out = _run_phase("phase_ops(TINY, routes=('xla',))")
    assert "FAIL" not in out and "route chosen by dtype: f32 xla" in out


def test_phase_four_tiny():
    out = _run_phase("phase_four(TINY)")
    assert out.count("a2a_dropped per step [[0], [0]]") == 1, out


def test_check_raises_over_limit():
    chip_smoke.check("ok", 1e-6, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke.check("over", 1e-4, 1e-5)
    with pytest.raises(AssertionError):
        chip_smoke.check("nan", float("nan"), 1.0)


@pytest.mark.gpu
def test_phase_ops_both_attention_routes_on_gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs an NVIDIA GPU (cuDNN attention route)")
    chip_smoke.phase_ops(TINY)
