#!/usr/bin/env python
"""Headline benchmark: chaining hash-join probe throughput on one GPU.

Reproduces the reference's primary measurement (BASELINE.md, experiment 1 plan
Csr: build |R| = 2^20 unique keys, probe |S| = 2^24 uniform FKs, early-exit
probe) with the reference's repetition protocol (>= 300 ms cumulative,
>= 8 reps).  The timed probe strand materializes the (probe_row, build_row)
result columns on device and produces the exact reference counters
(c_htProbe = c_top = 2^24, c_htProbeCmp) -- strictly more work than the
reference's count-only Top operator.

Baseline: 13.1 M probes/s on one CPU core (BASELINE.md, t_probeStr = 1.284 s).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...} naming
the device it ran on.  Exits non-zero when JAX finds no accelerator.
"""

import json
import sys

LOG2_R, LOG2_S = 20, 24
BASELINE_PROBES_PER_S = 16777216 / 1.284  # BASELINE.md Csr probe strand

#: Speed-of-light byte budget per probe for this strand.  An ideal
#: implementation of the same semantics moves, per probe element:
#:   - probe sort, counting-sort lower bound over the 2^20 domain:
#:       histogram pass: read keys            =  4 B
#:       permute pass:   read+write (key,row) = 16 B
#:   - table lookup: read sorted keys = 4 B (table reads amortize to
#:     ~0.25 B at |R|=2^20 over 2^24 probes)
#:   - result emission: read srow 4 B + write (probe_row, build_row) = 12 B
#: Total 36 B/elem; sol_pct reports achieved / this bound.
SOL_BYTES_PER_PROBE = 36.0


def measure(min_time_s=0.3):
    """Run the headline strand; returns ``(result, last_output, (rk, sa))``
    with the generated build and probe keys as numpy arrays."""
    import jax

    from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand
    from hashjoin3d_tpu.ops.chaining import build_chaining_host
    from hashjoin3d_tpu.ops.chaining import can_use_dense_direct
    from hashjoin3d_tpu.ops.strands_windowed import direct_probe_strand_sorted
    from hashjoin3d_tpu.utils import exp1_data
    from hashjoin3d_tpu.utils.measure import (hbm_peak_gbs,
                                              repeat_mintime_batch)

    dev = jax.devices()[0]
    peak_gbs = hbm_peak_gbs(dev.device_kind)
    card_s = 1 << LOG2_S
    rk_np, sa_np, _ = exp1_data(LOG2_R, LOG2_S, False, 0)
    dd = can_use_dense_direct(rk_np, 1 << LOG2_R)
    rk = jax.device_put(rk_np)
    sa = jax.device_put(sa_np)
    table = jax.block_until_ready(
        build_chaining_host(rk, 1 << LOG2_R, dense_direct=dd))

    # the sorted direct strand when the adaptive dense-direct layout
    # applies, the baseline strand otherwise
    if dd:
        def strand():
            return direct_probe_strand_sorted(table, sa, unique=True)
    else:
        def strand():
            return _chaining_probe_strand(table, sa, card_s, True)

    # warm-up compile outside the timed region
    out = jax.block_until_ready(strand())
    assert int(out["c_htProbe"]) == card_s, int(out["c_htProbe"])

    total_s, reps, _ = repeat_mintime_batch(min_time_s, strand, min_repeat=8)
    per_rep = total_s / reps
    value = card_s / per_rep

    sol_probes_per_s = peak_gbs * 1e9 / SOL_BYTES_PER_PROBE
    return {
        "metric": "csr_probe_throughput",
        "value": value,
        "unit": "probes/s",
        "vs_baseline": value / BASELINE_PROBES_PER_S,
        "sol_pct": 100.0 * value / sol_probes_per_s,
        "sol_model_bytes_per_probe": SOL_BYTES_PER_PROBE,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }, out, (rk_np, sa_np)


def main():
    import jax

    from hashjoin3d_tpu.utils.misc import enable_compile_cache
    enable_compile_cache()
    if jax.devices()[0].platform == "cpu":
        sys.exit("bench.py: no accelerator found (a CPU run measures "
                 "nothing this benchmark reports)")
    print(json.dumps(measure()[0]))


if __name__ == "__main__":
    main()
