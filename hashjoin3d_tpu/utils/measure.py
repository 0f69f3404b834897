"""Benchmark repetition protocol, device peaks and wall-clock helpers.

``repeat_mintime`` reproduces the reference's measurement discipline
(``util/measure_helpers.hh:15-41``): run the closure, doubling the planned
repetition count whenever the cumulative time is still under ``min_time`` at
the end of the current plan, with a per-iteration teardown and a minimum
repetition floor.  Returns ``(total_seconds, n_reps)``.

``repeat_mintime_batch`` is its device twin: JAX dispatch is asynchronous, so
a batch of reps is enqueued back to back and timed up to
``jax.block_until_ready`` on the batch's last output.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import jax

#: Published device-memory bandwidth per ``jax.Device.device_kind``, GB/s.
#: Source: NVIDIA H100 data sheet (SXM part, 80 GB HBM3 at 3.35 TB/s).
HBM_PEAK_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
}


def hbm_peak_gbs(device_kind: str) -> float:
    """Peak device-memory bandwidth of ``device_kind`` in GB/s.

    An unknown device is an error, never a default: a roofline share
    against the wrong peak is a wrong number.
    """
    try:
        return HBM_PEAK_GBS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published memory bandwidth for device kind "
            f"{device_kind!r}; add it to HBM_PEAK_GBS with its source"
        ) from None


def repeat_mintime_batch(min_time_s: float, enqueue, min_repeat: int = 8):
    """Batched doubling protocol for asynchronous device dispatch.

    Enqueues ``n`` reps back to back and waits once, on the last rep's
    outputs (executions on one device run in submission order, so the last
    output being ready implies the whole batch ran), timing the batch;
    doubles ``n`` until the batch exceeds ``min_time_s``.  Returns
    ``(batch_seconds, n_reps, last_output)``.

    This is the device-time analogue of the reference's synchronous loop
    (``util/measure_helpers.hh:15-41``): the host never waits between reps,
    so the batch time is the device's time for ``n`` reps plus one launch
    latency.
    """
    n = min_repeat
    while True:
        t0 = time.perf_counter()
        out = None
        for _ in range(n):
            out = enqueue()
        jax.block_until_ready(out)
        total = time.perf_counter() - t0
        if total >= min_time_s:
            return total, n, out
        n *= 2


def repeat_mintime(min_time_s: float, func, teardown=lambda: None,
                   teardown_after_last: bool = False, min_repeat: int = 1):
    n = min_repeat
    total = 0.0
    i = 0
    while i < n:
        t0 = time.perf_counter()
        func()
        total += time.perf_counter() - t0
        if i == n - 1 and total < min_time_s:
            n *= 2
        if i != n - 1 or teardown_after_last:
            teardown()
        i += 1
    return total, n


@dataclass
class Timers:
    """Named start/stop experiment timers (main_experiment1.cc:199-201,1349-1359)."""

    points: dict = field(default_factory=dict)

    def start(self, desc: str):
        self.points[desc] = [time.perf_counter(), None]

    def stop(self, desc: str):
        self.points[desc][1] = time.perf_counter()

    def print(self, out=None):
        import sys
        out = out or sys.stdout
        for desc, (t0, t1) in sorted(self.points.items()):
            dur_ms = ((t1 if t1 is not None else time.perf_counter()) - t0) * 1e3
            out.write(f"  {desc}|{dur_ms:.3f} ms\n")
