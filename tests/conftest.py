"""Test configuration: force a local 8-device virtual CPU mesh.

Multi-chip sharding behaviour (mesh, collectives, table sharding) is
exercised on a virtual CPU mesh per SURVEY.md §4.  JAX_PLATFORMS defaults
to cpu; tests that need a GPU carry the ``gpu`` marker, skip themselves
when JAX finds none, and run on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_chip_smoke.py``.
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

# a jax imported before this file read the old environment
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])


def pytest_sessionfinish(session, exitstatus):
    """Name any thread that could keep the interpreter alive after the
    summary line (repo code starts only daemon threads, so a straggler
    here is a bug).  Purely diagnostic."""
    import sys
    import threading

    stragglers = [
        t for t in threading.enumerate()
        if t is not threading.main_thread() and not t.daemon
    ]
    if stragglers:
        sys.stderr.write(
            "\n[conftest] non-daemon threads alive at session finish "
            f"(may block interpreter exit): {[t.name for t in stragglers]}\n"
        )
