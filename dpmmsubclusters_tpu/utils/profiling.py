"""Profiling helpers.

The reference's only instrumentation is wall-clock accumulation per
iteration (``src/dp-parallel-sampling.jl:363-366``); this build exposes
the same per-iteration host timings (``FitResult.history.times``) plus real
device traces via ``jax.profiler``.
"""
from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler device trace around a block::

        with profiling.trace("/tmp/dpmm-trace"):
            dpmm.fit(x, iters=10)

    Open the result with TensorBoard's profile plugin or Perfetto.
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Accumulating wall-clock timer with named sections (host-side)."""

    def __init__(self):
        self.totals: dict = {}

    @contextlib.contextmanager
    def section(self, name: str, sync: bool = False):
        t0 = time.perf_counter()
        yield
        if sync:
            # fence pending device work so the section is attributable
            jax.effects_barrier()
        self.totals[name] = self.totals.get(name, 0.0) + (
            time.perf_counter() - t0
        )

    def report(self) -> str:
        width = max((len(k) for k in self.totals), default=0)
        return "\n".join(
            f"{k:<{width}} {v * 1e3:10.1f} ms" for k, v in self.totals.items()
        )
