"""Distributed-path overhead at 1 chip (PERF.md "Multi-chip readiness").

Runs the SAME workload through (a) the distributed nested join on a
1-device mesh (shard_map + partition_exchange + padded build + probe +
unnest) and (b) the single-card path (compacted host build + sorted
probe strand), on one accelerator, each as a timed batch of reps.  The ratio quantifies
what the distributed machinery costs when the mesh collapses to one chip
— the fixed overhead a pod-slice run must amortize (BASELINE.json targets
>= 85% weak-scaling efficiency; combine with scaling_bench.py on real
hardware).

Usage: python tools/dist_overhead.py [--n 22]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=22, help="log2 rows per side")
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()

    from hashjoin3d_tpu.ops.nested import build_nested_host
    from hashjoin3d_tpu.ops.strands_windowed import (
        keydirect_nested_strand_sorted)
    from hashjoin3d_tpu.parallel import (
        dist_nested_join, make_mesh, shard_axis)

    n = 1 << args.n
    dom = n // 4
    rng = np.random.default_rng(5)
    bk = rng.integers(0, dom, n, dtype=np.uint32)
    pk = rng.integers(0, dom, n, dtype=np.uint32)
    ndv = int(np.unique(bk).size)

    def timeit(fn):
        jax.block_until_ready(fn())
        t0 = time.perf_counter()
        out = None
        for _ in range(args.reps):
            out = fn()
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / args.reps, out

    # (a) distributed join on a 1-device mesh
    mesh = make_mesh(1)
    sh = shard_axis(mesh)
    bkd, pkd = jax.device_put(bk, sh), jax.device_put(pk, sh)
    out_cap = 8 * n
    step = dist_nested_join(mesh, num_buckets_per_shard=ndv,
                            build_capacity=n, probe_capacity=n,
                            out_capacity=out_cap)
    t_dist, out_d = timeit(lambda: step(bkd, pkd))
    assert int(out_d["overflow"]) == 0
    total_d = int(out_d["num_unnested"])

    # (a') same, with the sorted shard-local probe (key_domain)
    stepw = dist_nested_join(mesh, num_buckets_per_shard=ndv,
                             build_capacity=n, probe_capacity=n,
                             out_capacity=out_cap, key_domain=dom)
    t_distw, out_w = timeit(lambda: stepw(bkd, pkd))
    assert int(out_w["overflow"]) == 0
    assert int(out_w["num_unnested"]) == total_d

    # (a'') full fast path: + fused compacted shard build (n_keys) +
    # key-sorted exchange consumed presorted + global-id emission
    stepf = dist_nested_join(mesh, num_buckets_per_shard=ndv,
                             build_capacity=n, probe_capacity=n,
                             out_capacity=out_cap, key_domain=dom,
                             n_keys=ndv)
    t_distf, out_f = timeit(lambda: stepf(bkd, pkd))
    assert int(out_f["overflow"]) == 0
    assert int(out_f["num_unnested"]) == total_d

    # (b) single-card path: compacted build + sorted probe strand
    bk_dev = jax.device_put(bk)
    pk_dev = jax.device_put(pk)

    def single():
        tbl = build_nested_host(bk_dev, ndv, n_keys=ndv, key_domain=dom)
        return keydirect_nested_strand_sorted(tbl, pk_dev, out_cap)

    t_single, out_s = timeit(single)
    assert int(out_s["c_unnest"]) == total_d, (
        int(out_s["c_unnest"]), total_d)

    print(f"rows/side: {n}  results: {total_d}")
    print(f"single-card path:             {t_single*1e3:8.1f} ms")
    print(f"dist @ 1-dev (default probe): {t_dist*1e3:8.1f} ms "
          f"({t_dist/t_single:.2f}x)")
    print(f"dist @ 1-dev (sorted probe):  {t_distw*1e3:8.1f} ms "
          f"({t_distw/t_single:.2f}x)")
    print(f"dist @ 1-dev (fast: fused build + presorted probe):"
          f"{t_distf*1e3:8.1f} ms ({t_distf/t_single:.2f}x)")
    print("breakdown drivers: exchange sort+pack+all_to_all of both sides, "
          "padded (shard_map-safe) build instead of the compacted host "
          "build, unsorted probe instead of the sorted strand")


if __name__ == "__main__":
    main()
