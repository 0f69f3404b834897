"""Tracing, profiling and runtime-checking utilities.

The JAX equivalents of the reference's observability toolkit (SURVEY.md 5.1/5.2):

* reference gprof build mode (``makefile:49-52``)      -> ``trace()`` context
  manager emitting JAX profiler traces viewable in TensorBoard/Perfetto;
* per-operator steady-clock timers (``algebra.hh:176-199``) -> ``DeviceTimer``
  wall-clocking jitted calls around ``block_until_ready`` (the algebra layer's
  per-operator inclusive runtimes build on this);
* compile-time trace flags (``algebra.hh:437,511,626``)  -> ``debug_callback``
  printing via ``jax.debug.print`` (zero-cost when not inserted);
* ASan/UBSan build mode (``makefile:56-58``)           -> ``checked()``:
  ``jax.experimental.checkify`` with index/NaN/div checks, catching
  out-of-bounds gathers and scatter corruption at runtime.
"""

from __future__ import annotations

import contextlib
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Emit a device profile for the enclosed block (open in TensorBoard)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class DeviceTimer:
    """Wall-clock a jitted callable including device completion."""

    def __init__(self):
        self.total = 0.0
        self.calls = 0

    def __call__(self, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        self.total += time.perf_counter() - t0
        self.calls += 1
        return out

    @property
    def mean(self):
        return self.total / max(self.calls, 1)


def checked(fn, errors=None):
    """Wrap a jittable fn with runtime checks (returns ``(err, out)``).

    Example::

        err, table = checked(build_nested)(keys, 64)
        err.throw()   # raises on OOB index / NaN / div-by-zero
    """
    from jax.experimental import checkify

    if errors is None:
        errors = checkify.index_checks | checkify.float_checks
    return checkify.checkify(fn, errors=errors)
