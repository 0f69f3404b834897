"""Exchange/compute overlap measurement (PERF.md "Exchange/compute overlap").

Runs the pipelined (prefetch=True) vs strictly-sequential (prefetch=False)
variants of the chunked flat join and the ring join on a virtual 8-device
CPU mesh (on the cards of one host the same script runs unchanged over
NVLink) and reports wall times.  With
``--trace DIR`` it also captures a jax profiler trace of one pipelined step
so the collective/compute concurrency is inspectable in TensorBoard/xprof.

Usage:  python tools/overlap_bench.py [--n 18] [--chunks 8] [--trace DIR]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=18,
                    help="log2 global probe rows (default 2^18)")
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--trace", default=None,
                    help="directory for a jax profiler trace")
    args = ap.parse_args()

    import os
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{args.devices}")
    jax.config.update("jax_platforms", "cpu")

    import numpy as np

    from hashjoin3d_tpu.parallel import (
        dist_nested_join_chunked, dist_ring_nested_join, make_mesh,
        shard_axis)

    mesh = make_mesh(args.devices)
    sh = shard_axis(mesh)
    n_p = 1 << args.n
    n_b = n_p // 4
    rng = np.random.default_rng(3)
    bk = rng.integers(0, n_b // 2, n_b, dtype=np.uint32)
    pk = rng.integers(0, n_b // 2, n_p, dtype=np.uint32)
    bk_d = jax.device_put(bk, sh)
    pk_d = jax.device_put(pk, sh)

    def timeit(fn):
        out = fn(bk_d, pk_d)
        jax.block_until_ready(out)     # real sync on CPU
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = fn(bk_d, pk_d)
            jax.block_until_ready(out)
            best = min(best, time.perf_counter() - t0)
        return best, int(out["num_unnested"])

    results = {}
    for prefetch in (False, True):
        fn = dist_nested_join_chunked(
            mesh, num_buckets_per_shard=n_b // args.devices,
            build_capacity=n_b, probe_capacity=n_p,
            out_capacity=int(4.5 * n_p), n_chunks=args.chunks,
            prefetch=prefetch)
        t, total = timeit(fn)
        results[f"chunked flat (prefetch={prefetch})"] = (t, total)

    for prefetch in (False, True):
        fn = dist_ring_nested_join(
            mesh, num_buckets_per_shard=n_b // args.devices,
            build_capacity=n_b, out_capacity=int(4.5 * n_p),
            step_out_capacity=n_p, prefetch=prefetch)
        t, total = timeit(fn)
        results[f"ring (prefetch={prefetch})"] = (t, total)

    totals = {t for _, t in results.values()}
    assert len(totals) == 1, f"result mismatch across variants: {totals}"

    print(f"\ndevices={args.devices} probes={n_p} chunks={args.chunks} "
          f"(best of {args.reps})")
    print("| schedule | wall ms | vs sequential |")
    print("|---|---|---|")
    base = results[f"chunked flat (prefetch=False)"][0]
    ring_base = results[f"ring (prefetch=False)"][0]
    for name, (t, _) in results.items():
        ref = ring_base if name.startswith("ring") else base
        print(f"| {name} | {t*1e3:.1f} | {ref/t:.2f}x |")

    if args.trace:
        fn = dist_nested_join_chunked(
            mesh, num_buckets_per_shard=n_b // args.devices,
            build_capacity=n_b, probe_capacity=n_p,
            out_capacity=int(4.5 * n_p), n_chunks=args.chunks, prefetch=True)
        jax.block_until_ready(fn(bk_d, pk_d))
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(fn(bk_d, pk_d))
        print(f"profiler trace written to {args.trace}")


if __name__ == "__main__":
    main()
