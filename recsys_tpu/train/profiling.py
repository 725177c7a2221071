"""Profiling and per-step timing utilities.

The reference's only observability is wall-clock deltas around fit/eval
(/root/reference/src/match/ncf/train.py:66,76-79).  This provides:

* ``trace(logdir)`` — context manager around ``jax.profiler`` producing a
  TensorBoard/Perfetto trace of device execution.
* ``StepTimer`` — cheap rolling per-step wall timing, synced with
  ``jax.block_until_ready`` every ``sync_every`` steps.
* ``annotate`` — ``jax.profiler.TraceAnnotation`` passthrough for labelling
  host-side phases.
"""
from __future__ import annotations

import contextlib
import time

import jax
import numpy as np


@contextlib.contextmanager
def trace(logdir: str):
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


annotate = jax.profiler.TraceAnnotation


def sync(tree) -> None:
    """Wait until every array in ``tree`` is computed."""
    jax.block_until_ready(tree)


class StepTimer:
    """Rolling per-step timing: ``with timer.step(): state = f(state)``.

    ``summary()`` reports mean/p50/p90 ms over the retained window.
    Syncing every step serialises the pipeline, so by default only every
    ``sync_every``-th step pays a device sync; the others measure dispatch.
    """

    def __init__(self, window: int = 200, sync_every: int = 10):
        self.window = window
        self.sync_every = sync_every
        self.times_ms: list[float] = []
        self._count = 0

    @contextlib.contextmanager
    def step(self, result=None):
        t0 = time.perf_counter()
        yield
        self._count += 1
        if result is not None and self._count % self.sync_every == 0:
            sync(result)
        self.times_ms.append((time.perf_counter() - t0) * 1e3)
        if len(self.times_ms) > self.window:
            self.times_ms.pop(0)

    def summary(self) -> dict:
        if not self.times_ms:
            return {}
        arr = np.asarray(self.times_ms)
        return {
            "steps": int(self._count),
            "mean_ms": float(arr.mean()),
            "p50_ms": float(np.percentile(arr, 50)),
            "p90_ms": float(np.percentile(arr, 90)),
        }
