"""Weak-scaling benchmark over mesh sizes (PERF.md "Multi-chip readiness").

Holds PER-SHARD work constant -- ``--n`` is log2 rows per shard on each
side, and the key domain grows with the mesh so per-shard build/probe/
result sizes stay fixed -- and times the distributed nested join's fast
path (``key_domain`` presorted sorted-strand probes + ``n_keys`` fused
compacted shard builds, `parallel/dist_join.py`) across mesh sizes.
Weak-scaling efficiency is t(1)/t(P); BASELINE.json targets >= 85% on
real cards.

Capacities are sized exactly from the data (host-side replication of
``shuffle.shard_of_key``'s double-murmur routing) so every run is
lossless (overflow == 0, asserted) without padding slack distorting the
comparison across mesh sizes.

With ``--platform cpu`` the mesh is virtual (CPU devices sharing the
host's cores): virtual-mesh "efficiencies" measure the engine's
algorithmic overhead growth (exchange fan-out, per-(src,dst) padding)
rather than interconnect behavior, so treat them as a plumbing check.
On four GPUs the same script runs unchanged with ``--platform default``.

The reference is single-process (no distributed path to compare,
SURVEY.md section 5.8); the scaling target is BASELINE.json's.

Usage: python tools/scaling_bench.py [--sizes 1,2,4,8] [--n 16]
       [--platform cpu|default] [--reps 5] [--json]
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax


def exact_capacities(bk, pk, num_shards, n_loc):
    """Host-side replication of the exchange routing: exact per-(src,dst)
    receive counts, per-shard distinct build keys, per-shard unnested
    totals.  Returns (build_cap, probe_cap, n_keys_max, out_max)."""
    import numpy as np

    from hashjoin3d_tpu.ops.hashing import hash_key_np

    def dests(keys):
        return hash_key_np(hash_key_np(keys)) % np.uint32(num_shards)

    bd, pd = dests(bk), dests(pk)

    def max_src_dst(d):
        src = np.arange(d.size) // n_loc
        counts = np.bincount(src * num_shards + d,
                             minlength=num_shards * num_shards)
        return int(counts.max())

    build_cap = max_src_dst(bd)
    probe_cap = max_src_dst(pd)
    n_keys_max = max(int(np.unique(bk[bd == s]).size)
                     for s in range(num_shards))
    # per-shard unnested pairs: probes routed to s matching bk groups there
    group_sz = np.bincount(bk)
    out_max = max(int(group_sz[pk[pd == s][pk[pd == s] < group_sz.size]]
                      .sum()) for s in range(num_shards))
    return build_cap, probe_cap, n_keys_max, out_max


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1,2,4,8",
                    help="comma-separated mesh sizes")
    ap.add_argument("--n", type=int, default=16,
                    help="log2 rows PER SHARD per side (weak scaling)")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--platform", default="cpu", choices=["cpu", "default"],
                    help="cpu: virtual host devices; default: real devices")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON summary line at the end")
    args = ap.parse_args()
    sizes = sorted({int(s) for s in args.sizes.split(",")})

    import os
    if args.platform == "cpu":
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={max(sizes)}")
        jax.config.update("jax_platforms", "cpu")
    avail = len(jax.devices())
    sizes = [s for s in sizes if s <= avail] or [avail]

    import numpy as np

    from hashjoin3d_tpu.parallel import (
        dist_nested_join, make_mesh, shard_axis)

    n_loc = 1 << args.n
    dom_per = max(n_loc // 4, 1)
    rng = np.random.default_rng(11)
    rows = []
    for P in sizes:
        n_glob, dom = P * n_loc, P * dom_per
        bk = rng.integers(0, dom, n_glob, dtype=np.uint32)
        pk = rng.integers(0, dom, n_glob, dtype=np.uint32)
        build_cap, probe_cap, n_keys, out_max = exact_capacities(
            bk, pk, P, n_loc)

        mesh = make_mesh(P)
        sh = shard_axis(mesh)
        bkd, pkd = jax.device_put(bk, sh), jax.device_put(pk, sh)
        step = dist_nested_join(
            mesh, num_buckets_per_shard=max(n_keys, 1),
            build_capacity=build_cap, probe_capacity=probe_cap,
            out_capacity=max(out_max, 1), key_domain=dom, n_keys=n_keys)

        out = step(bkd, pkd)            # compile + warm
        jax.block_until_ready(out["num_unnested"])
        assert int(out["overflow"]) == 0
        want = int(np.bincount(bk, minlength=dom)[pk].sum())
        assert int(out["num_unnested"]) == want, (
            int(out["num_unnested"]), want)

        t0 = time.perf_counter()
        for _ in range(args.reps):
            out = step(bkd, pkd)
        jax.block_until_ready(out["num_unnested"])
        t = (time.perf_counter() - t0) / args.reps
        rows.append((P, t, want))
        eff = rows[0][1] / t
        print(f"P={P:2d}  rows/shard={n_loc}  results={want:>12d}  "
              f"t={t*1e3:8.1f} ms  weak-scaling eff={eff:5.2f}")

    if args.json:
        print(json.dumps({
            "metric": "weak_scaling_efficiency",
            "sizes": [r[0] for r in rows],
            "t_ms": [round(r[1] * 1e3, 1) for r in rows],
            "value": round(rows[0][1] / rows[-1][1], 3),
            "unit": "t(1)/t(P)",
            "platform": jax.default_backend(),
            "log2_rows_per_shard": args.n,
        }))


if __name__ == "__main__":
    main()
