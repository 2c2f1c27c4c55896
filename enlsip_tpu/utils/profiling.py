"""Tracing / profiling hooks.

The reference's observability is wall-clock timing + evaluation
counters (SURVEY.md §5.1, enlsip_functions.jl:2676, cnls_model.jl:40-62)
— both preserved in ``ExecutionInfo``.  This module adds the device-side
instrumentation the reference never needed: ``jax.profiler`` traces and
a tiny stage-timer for host-side phase breakdowns.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax


@contextlib.contextmanager
def trace(dir_path: str):
    """Capture a jax.profiler trace (view with TensorBoard/xprof)."""
    jax.profiler.start_trace(dir_path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named region that shows up on the device timeline."""
    return jax.profiler.TraceAnnotation(name)


class StageTimer:
    """Host-side cumulative stage timer (blocks on device results)."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if result is not None:
                jax.block_until_ready(result)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        lines = [f"{k:30s} {self.totals[k]:9.4f}s / {self.counts[k]}"
                 for k in sorted(self.totals, key=self.totals.get,
                                 reverse=True)]
        return "\n".join(lines)
