"""Tracing / profiling helpers (SURVEY §5: the reference has wall-time
bookkeeping only; the answer here is ``jax.profiler`` traces plus
a per-step timing callback).

Usage::

    with trace("/tmp/jax-trace"):          # open in Perfetto/XProf
        sim.run()

    sim.callbacks["timing"] = Callback(StepTimer(), IterationInterval(50))
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "StepTimer"]


@contextlib.contextmanager
def trace(logdir):
    """``jax.profiler`` trace context: captures device timelines, HLO
    cost breakdowns, and host/device transfer activity for anything run
    inside."""
    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class StepTimer:
    """Progress callback printing iteration, model time, and wall-clock
    throughput since the previous call (the reference's
    ``run_wall_time`` bookkeeping, per-window)."""

    def __init__(self, printer=print):
        self._last_wall = None
        self._last_iter = 0
        self._printer = printer

    def __call__(self, sim):
        now = time.monotonic()
        it = int(sim.state.clock.iteration)
        t = float(sim.state.clock.time)
        if self._last_wall is not None and it > self._last_iter:
            per_step = (now - self._last_wall) / (it - self._last_iter)
            self._printer(f"iter {it:7d}  t={t:12.3f}  "
                          f"{per_step * 1e3:8.2f} ms/step")
        else:
            self._printer(f"iter {it:7d}  t={t:12.3f}")
        self._last_wall = now
        self._last_iter = it
