"""Out-of-core streaming run: a probe column LARGER than any whole-column
path in this engine ever holds, streamed through a resident table.

A >= 2^27-probe run whose counters are diffed against an independent
chunked sum.  This driver:

  1. builds a device-resident table (chaining dense-direct from 2^logr
     unique keys -- the exp-1 Csr shape, ``ht_chaining.hh:38-158``; and a
     nested/3D table from 2^logb rows over the same 2^logr domain --
     ``ht_nested.hh:71-251``),
  2. generates 2^logp uniform probe keys HOST-side (numpy; at logp=27
     that is 512 MiB of u32 -- the whole-column device strands are never
     asked to hold it),
  3. streams them through ``ops.streaming.stream_probe_*`` in 2^logc-key
     chunks (double-buffered device_put, counters accumulate on device),
  4. checks the streamed counters EXACTLY against an independent host
     model: per-key comparison costs derived from the reference's chain
     semantics (validated in-process against tests/oracle.py at 2^12),
     summed over the probe stream with one numpy gather.

Counter semantics match the reference binaries (c_htProbe / c_htProbeCmp /
c_unnest, ``algebra.hh:625-659`` and ``ht_nested.hh:354-382``), so the
check is the same contract the golden CSV diffs pin at small scale.

Run:  python tools/oocbench.py                  # logp=27 (134M probes)
      python tools/oocbench.py --logp 25 --selfcheck-only
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np


def np_murmur32(x):
    """Vectorized murmur32 finalizer (util/hasht.hh:53-61 semantics)."""
    h = x.astype(np.uint64)
    h ^= h >> np.uint64(16)
    h = (h * np.uint64(0x85EBCA6B)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(13)
    h = (h * np.uint64(0xC2B2AE35)) & np.uint64(0xFFFFFFFF)
    h ^= h >> np.uint64(16)
    return h.astype(np.uint32)


def chaining_unique_cost(keys, num_buckets):
    """Per-key probe comparison cost for a UNIQUE-key chaining table with
    early exit (AlgHashJoinProbe IsBuildKeyUnique, algebra.hh:653-655).

    Chain order per bucket is [first arrival, then later arrivals LIFO]
    (dir node + head-insert, ht_chaining.hh:180-196), so the k-th arrival
    (k>=2) of a bucket with c entries sits at position 1 + (c - k + 1).
    Returns cost[key] indexed by key value (keys must be a permutation of
    [0, len(keys))).
    """
    b = np_murmur32(keys) % np.uint32(num_buckets)
    order = np.argsort(b, kind="stable")          # groups arrivals by bucket
    bs = b[order]
    starts = np.flatnonzero(np.r_[True, bs[1:] != bs[:-1]])
    counts = np.diff(np.r_[starts, bs.size])
    arrival = np.arange(bs.size) - np.repeat(starts, counts)   # 0-based
    clen = np.repeat(counts, counts)
    pos = np.where(arrival == 0, 1, 1 + (clen - arrival))      # 1-based walk
    cost = np.empty(keys.size, np.int64)
    cost[keys[order]] = pos
    return cost


def nested_cost_and_groups(bkeys, num_buckets, domain):
    """Per-key (cmp cost, group size) for a nested/3D table.

    Main-chain order per bucket = first-occurrence order of distinct keys
    (tail-append, ht_nested.hh:414-436); findMainNodeByOther counts one
    comparison per MainNode visited including the match
    (ht_nested.hh:354-382).  Missing keys cost the full main-chain walk.
    """
    uniq, first = np.unique(bkeys, return_index=True)
    ub = np_murmur32(uniq) % np.uint32(num_buckets)
    order = np.argsort(ub * np.uint64(bkeys.size) + first, kind="stable")
    ubs = ub[order]
    starts = np.flatnonzero(np.r_[True, ubs[1:] != ubs[:-1]])
    counts = np.diff(np.r_[starts, ubs.size])
    rank = np.arange(ubs.size) - np.repeat(starts, counts)     # 0-based
    cost = np.zeros(domain, np.int64)          # misses patched below
    cost[uniq[order]] = rank + 1
    # miss cost = full main-chain length of the key's bucket
    chain_len = np.zeros(num_buckets, np.int64)
    chain_len[ubs[starts]] = counts
    all_keys = np.arange(domain, dtype=np.uint32)
    miss = np.ones(domain, bool)
    miss[uniq] = False
    cost[miss] = chain_len[np_murmur32(all_keys[miss]) % np.uint32(num_buckets)]
    gsize = np.zeros(domain, np.int64)
    np.add.at(gsize, bkeys, 1)
    return cost, gsize


def selfcheck(rng):
    """Pin both host cost models against tests/oracle.py at 2^12."""
    from tests.oracle import ChainingOracle, NestedOracle
    n = 1 << 12
    keys = rng.permutation(n).astype(np.uint32)
    nb = n // 2
    cost = chaining_unique_cost(keys, nb)
    probes = rng.integers(0, n, 1 << 13).astype(np.uint32)
    ora = ChainingOracle(keys, nb)
    _, m, c = ora.probe(probes, unique=True)
    assert m == probes.size and c == int(cost[probes].sum()), \
        (m, c, int(cost[probes].sum()))

    bkeys = rng.integers(0, n, n * 4).astype(np.uint32)
    ncost, gsize = nested_cost_and_groups(bkeys, nb, n)
    nora = NestedOracle(bkeys, nb)
    nested, nm, nc = nora.probe(probes)
    exp_un = sum(len(nora.unnest([t])) for t in nested)
    assert nm == int((gsize[probes] > 0).sum()), nm
    assert nc == int(ncost[probes].sum()), (nc, int(ncost[probes].sum()))
    assert exp_un == int(gsize[probes].sum())
    print("selfcheck vs tests/oracle.py @ 2^12: OK", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--logp", type=int, default=27, help="log2 #probes")
    ap.add_argument("--logr", type=int, default=20, help="log2 key domain")
    ap.add_argument("--logb", type=int, default=24,
                    help="log2 build rows for the nested table")
    ap.add_argument("--logc", type=int, default=22, help="log2 chunk size")
    ap.add_argument("--selfcheck-only", action="store_true")
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (functional test)")
    args = ap.parse_args()

    rng = np.random.default_rng(20260817)
    selfcheck(rng)
    if args.selfcheck_only:
        return

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from hashjoin3d_tpu.ops import build_chaining, build_nested
    from hashjoin3d_tpu.ops.streaming import (stream_probe_chaining,
                                              stream_probe_nested)

    R, P, C = 1 << args.logr, 1 << args.logp, 1 << args.logc
    print(f"devices: {jax.devices()}", flush=True)
    print(f"probe column: 2^{args.logp} = {P:,} u32 keys "
          f"({P * 4 / 2**20:.0f} MiB, host-resident)", flush=True)

    probes = rng.integers(0, R, P).astype(np.uint32)

    # --- chaining, unique build (exp-1 Csr shape) ---
    keys = rng.permutation(R).astype(np.uint32)
    cost = chaining_unique_cost(keys, R)
    exp_m, exp_c = P, int(cost[probes].sum())

    tbl = build_chaining(keys, R)
    jax.block_until_ready(tbl.bucket_len)
    mem = tbl.memory_consumption()["total"]
    t0 = time.perf_counter()
    m, c, _ = stream_probe_chaining(tbl, probes, chunk_size=C, unique=True)
    t1 = time.perf_counter()
    ok = (m == exp_m and c == exp_c)
    print(f"chaining  2^{args.logp} probes / 2^{args.logr} unique build: "
          f"{t1 - t0:.2f} s = {P / (t1 - t0) / 1e6:.1f} M probes/s "
          f"(chunks of 2^{args.logc}, device residency ~"
          f"{(mem + 3 * C * 4) / 2**20:.0f} MiB)", flush=True)
    print(f"  counters: c_htProbe {m:,} (expect {exp_m:,})  "
          f"c_htProbeCmp {c:,} (expect {exp_c:,})  -> "
          f"{'EXACT' if ok else 'MISMATCH'}", flush=True)
    if not ok:
        sys.exit(1)

    # --- nested 3D, duplicate-heavy build (exp-1 Nrs t-style shape) ---
    B = 1 << args.logb
    bkeys = rng.integers(0, R, B).astype(np.uint32)
    ncost, gsize = nested_cost_and_groups(bkeys, R, R)
    exp_nm = int((gsize[probes] > 0).sum())
    exp_nc = int(ncost[probes].sum())
    exp_un = int(gsize[probes].sum())

    ntbl = build_nested(bkeys, R)
    jax.block_until_ready(ntbl.bucket_main_len)
    nmem = ntbl.memory_consumption()["total"]
    t0 = time.perf_counter()
    nm, nc, un, _ = stream_probe_nested(ntbl, probes, chunk_size=C)
    t1 = time.perf_counter()
    ok = (nm == exp_nm and nc == exp_nc and un == exp_un)
    print(f"nested 3D 2^{args.logp} probes / 2^{args.logb} rows over "
          f"2^{args.logr} keys: {t1 - t0:.2f} s = "
          f"{P / (t1 - t0) / 1e6:.1f} M probes/s (device residency ~"
          f"{(nmem + 3 * C * 4) / 2**20:.0f} MiB)", flush=True)
    print(f"  counters: c_htProbe {nm:,} (expect {exp_nm:,})  "
          f"c_htProbeCmp {nc:,} (expect {exp_nc:,})  "
          f"c_unnest {un:,} (expect {exp_un:,})  -> "
          f"{'EXACT' if ok else 'MISMATCH'}", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
