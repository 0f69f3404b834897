#!/usr/bin/env python
"""Scaling-efficiency harness: distributed 3D join throughput vs mesh size.

Measures the full distributed pipeline (exchange + build + probe + unnest) at
1, 2, 4, ..., N devices with the per-device data volume held constant (weak
scaling): efficiency = throughput(N) / (N * throughput(1)).

Run with ``--cpu --devices 8`` for a functional weak-scaling check on a
virtual CPU mesh, or on the cards of one host for meaningful numbers
(BASELINE.json targets >= 85% scaling efficiency).

Prints one JSON line per mesh size.
"""

import argparse
import json
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=0,
                    help="max devices (0 = all available)")
    ap.add_argument("--rows-per-device", type=int, default=1 << 16)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (virtual mesh)")
    args = ap.parse_args()

    if args.cpu and args.devices > 1:
        # must precede the jax import: host-platform device count is fixed
        # at backend initialization
        import os
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            f"{flags} --xla_force_host_platform_device_count={args.devices}")

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from hashjoin3d_tpu.parallel import (
        dist_nested_join, make_mesh, shard_axis)

    n_dev = args.devices or jax.device_count()
    sizes = []
    d = 1
    while d <= n_dev:
        sizes.append(d)
        d *= 2

    base = None
    rng = np.random.default_rng(0)
    for nd in sizes:
        mesh = make_mesh(nd)
        sh = shard_axis(mesh)
        n_b = args.rows_per_device * nd
        n_p = args.rows_per_device * nd
        bk = rng.integers(0, n_b // 2, n_b, dtype=np.uint32)
        pk = rng.integers(0, n_b // 2, n_p, dtype=np.uint32)
        cap = int(args.rows_per_device * 1.5) + 64
        step = dist_nested_join(mesh, num_buckets_per_shard=max(n_b // nd, 1),
                                build_capacity=cap, probe_capacity=cap,
                                out_capacity=4 * args.rows_per_device)
        bkd = jax.device_put(bk, sh)
        pkd = jax.device_put(pk, sh)
        out = step(bkd, pkd)
        jax.block_until_ready(out)  # compile warm-up
        assert int(out["overflow"]) == 0, "undersized exchange capacity"
        t0 = time.perf_counter()
        for _ in range(args.reps):
            jax.block_until_ready(step(bkd, pkd))
        dt = (time.perf_counter() - t0) / args.reps
        thr = n_p / dt
        if base is None:
            base = thr
        eff = thr / (base * nd)
        print(json.dumps(dict(
            devices=nd, probes_per_s=round(thr),
            weak_scaling_efficiency=round(eff, 3),
            platform=jax.devices()[0].platform,
            note=("virtual devices share one host core; efficiency is only "
                  "meaningful on real multi-chip hardware")
            if jax.devices()[0].platform == "cpu" else "")))


if __name__ == "__main__":
    main()
