"""Debugging & profiling utilities (SURVEY.md §5.1/5.2).

The reference's observability is phase timers (``Timer``/``RDLOG_TIME_USE``)
and ``-Wall`` hygiene; JAX's functional model removes data races by
construction, so the equivalents here are:

* :func:`trace` — ``jax.profiler`` trace context for a phase (the device
  analog of the reference's per-phase timers, but with full op-level
  timelines viewable in TensorBoard/Perfetto);
* :class:`PhaseTimer` — cheap wall-clock phase timers with a printed
  summary, RDLOG_TIME_USE-style;
* :func:`check_raster` — checkify-based NaN/Inf + bounds validation of a
  raster op (debug mode; the reference has no sanitizer, we do).
"""

from __future__ import annotations

import contextlib
import time

import jax
import numpy as np

from richdem_tpu.provenance import logger

__all__ = ["trace", "PhaseTimer", "check_raster"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a phase: ``with trace('/tmp/prof'): step(z)``; view the
    trace in TensorBoard (Profile plugin) or Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class PhaseTimer:
    """Wall-clock per-phase timers with an RDLOG-style summary.

    >>> t = PhaseTimer()
    >>> with t.phase("fill"): ...
    >>> t.summary()
    """

    def __init__(self):
        self.times = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.times[name] = self.times.get(name, 0.0) + (
                time.perf_counter() - t0)

    def summary(self) -> str:
        total = sum(self.times.values()) or 1.0
        lines = [f"[time-use] {k}: {v:.3f}s ({100 * v / total:.0f}%)"
                 for k, v in self.times.items()]
        out = "\n".join(lines)
        logger.info(out)
        return out


def check_raster(arr, name="raster", finite=True, lo=None, hi=None):
    """Validate a raster on host: finiteness and optional bounds.

    Raises ``ValueError`` with cell coordinates of the first offender —
    the debug-mode counterpart of running the reference under asserts."""
    a = np.asarray(arr)
    if finite:
        bad = ~np.isfinite(a)
        if bad.any():
            r, c = np.argwhere(bad)[0]
            raise ValueError(
                f"{name}: non-finite value {a[r, c]!r} at ({r}, {c}) "
                f"(+{int(bad.sum()) - 1} more)")
    for bound, op, word in ((lo, np.less, "below"), (hi, np.greater,
                                                     "above")):
        if bound is None:
            continue
        bad = op(a, bound)
        if bad.any():
            r, c = np.argwhere(bad)[0]
            raise ValueError(
                f"{name}: value {a[r, c]!r} at ({r}, {c}) {word} bound "
                f"{bound} (+{int(bad.sum()) - 1} more)")
    return arr
