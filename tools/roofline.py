"""Roofline microbenchmarks: what the card gives the engine's primitives.

Times the plain XLA formulations the probe strands are built from, each
beside a plain copy of the same bytes measured in the same process:

* the strands' lookup (``layout.safe_lookup``: gather with misses as 0) on
  the canonical stream, 2^24 keys into a 2^20-entry u32 table, sorted and
  unsorted, and 2^25 keys into 2^21 entries;
* ``lax.sort`` 1-op and 2-op at 2^24, global and (K, C)-segmented at the
  segment ``ops.sort.probe_sort_chunk`` picks for the canonical probe sort;
* the scans ``layout.run_boundaries`` and ``expand`` use
  (``scan.engine_multi_scan``): the fused sum+max+min bundle and maxpair.

Every result is checked against numpy before it is timed.  ``--trace DIR``
also records one profiler trace of the sorts and prints the device kernel
names (which sort XLA picked).

    python tools/roofline.py [--quick] [--trace chiprun_out/sort_trace]

Prints one row per op and a markdown table; needs an accelerator.
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from hashjoin3d_tpu.utils.measure import hbm_peak_gbs, repeat_mintime_batch

I32, U32 = jnp.int32, jnp.uint32


def timeit(fn, *args, min_time=0.5, min_repeat=4):
    """Seconds per call of ``fn(*args)`` (compiled and warmed first)."""
    jax.block_until_ready(fn(*args))
    total, n, _ = repeat_mintime_batch(min_time, lambda: fn(*args),
                                       min_repeat=min_repeat)
    return total / n


def device_kernel_names(trace_dir):
    """(name, total device ns) of every kernel in the newest trace under
    ``trace_dir``, largest first."""
    from jax.profiler import ProfileData
    xp = sorted(Path(trace_dir).rglob("*.xplane.pb"),
                key=lambda p: p.stat().st_mtime)[-1]
    tot = {}
    for plane in ProfileData.from_file(str(xp)).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            for ev in line.events:
                tot[ev.name] = tot.get(ev.name, 0) + ev.duration_ns
    return sorted(tot.items(), key=lambda kv: -kv[1])


def run(mt=0.5, trace=None):
    """Check every primitive against numpy, time it, and return the rows
    ``(name, ms, GB/s, % peak, % copy)``; raises on a wrong result."""
    dev = jax.devices()[0]
    peak = hbm_peak_gbs(dev.device_kind)
    print(f"devices: {jax.devices()}  peak {peak} GB/s", flush=True)

    from hashjoin3d_tpu.ops.layout import safe_lookup
    from hashjoin3d_tpu.ops.scan import engine_multi_scan
    from hashjoin3d_tpu.ops.sort import probe_sort_chunk, sort_segmented

    rng = np.random.default_rng(7)
    rows = []
    copy_gbs = {}

    def report(name, secs, nbytes, ref=None):
        gbs = nbytes / secs / 1e9
        share = gbs / copy_gbs[ref] if ref else float("nan")
        rows.append((name, secs * 1e3, gbs, 100 * gbs / peak, 100 * share))
        print(f"{name:44s} {secs*1e3:9.3f} ms {gbs:8.1f} GB/s "
              f"{100*gbs/peak:5.1f}% peak {100*share:6.1f}% copy", flush=True)

    inc = jax.jit(lambda x: x + jnp.uint32(1))

    def copy_row(logn):
        n = 1 << logn
        x = jnp.asarray(rng.integers(0, 2**32, n, dtype=np.uint32))
        t = timeit(inc, x, min_time=mt)
        copy_gbs[logn] = 2 * 4 * n / t / 1e9
        report(f"copy 2^{logn} u32 (read+write)", t, 2 * 4 * n)

    for logn in (24, 25, 26):
        copy_row(logn)

    # -- the lookup: plain gather, misses as 0 ----------------------------
    look = jax.jit(safe_lookup)
    for logn, logt in ((24, 20), (25, 21)):
        n, T = 1 << logn, 1 << logt
        table_np = rng.integers(1, 2**32, T, dtype=np.uint32)
        keys_np = rng.integers(0, T, n).astype(np.int32)
        keys_np[::97] = -1                       # miss holes
        keys_np[::101] = T + 5                   # keys past the table
        want = np.where((keys_np >= 0) & (keys_np < T),
                        table_np[np.clip(keys_np, 0, T - 1)], 0)
        table = jnp.asarray(table_np)
        for label, k in (("unsorted", keys_np), ("sorted", np.sort(keys_np))):
            kd = jnp.asarray(k)
            got = np.asarray(look(table, kd))
            w = want if label == "unsorted" else np.where(
                (k >= 0) & (k < T), table_np[np.clip(k, 0, T - 1)], 0)
            assert np.array_equal(got, w), f"gather 2^{logn} {label} WRONG"
            report(f"gather 2^{logn} from 2^{logt} ({label})",
                   timeit(look, table, kd, min_time=mt), 2 * 4 * n, ref=logn)

    # -- sorts at 2^24 -----------------------------------------------------
    n = 1 << 24
    keys_np = rng.integers(0, 1 << 20, n, dtype=np.uint32)
    keys = jnp.asarray(keys_np)
    row_ids = jnp.arange(n, dtype=I32)
    chunk = probe_sort_chunk(n, 1 << 20)
    sort1 = jax.jit(lambda k: lax.sort((k,), num_keys=1)[0])
    sort2 = jax.jit(lambda k, r: lax.sort((k, r), num_keys=1))
    seg1 = jax.jit(lambda k: lax.sort((k.reshape(n // chunk, chunk),),
                                      num_keys=1, dimension=1)[0].reshape(n))
    seg2 = jax.jit(lambda k: sort_segmented(k, chunk))
    ks = np.sort(keys_np)
    assert np.array_equal(np.asarray(sort1(keys)), ks), "sort 1-op WRONG"
    sk, sr = (np.asarray(x) for x in sort2(keys, row_ids))
    assert np.array_equal(sk, ks) and np.array_equal(keys_np[sr], sk)
    wseg = np.sort(keys_np.reshape(-1, chunk), axis=1).reshape(n)
    assert np.array_equal(np.asarray(seg1(keys)), wseg), "seg 1-op WRONG"
    gk, gr = (np.asarray(x) for x in seg2(keys))
    assert np.array_equal(gk, wseg) and np.array_equal(keys_np[gr], gk)
    report("lax.sort 1-op u32 2^24", timeit(sort1, keys, min_time=mt),
           2 * 4 * n, ref=24)
    report("lax.sort 2-op u32+i32 2^24",
           timeit(sort2, keys, row_ids, min_time=mt), 4 * 4 * n, ref=24)
    report(f"lax.sort 1-op ({n // chunk}, {chunk})",
           timeit(seg1, keys, min_time=mt), 2 * 4 * n, ref=24)
    report(f"sort_segmented 2-op ({n // chunk}, {chunk})",
           timeit(seg2, keys, min_time=mt), 4 * 4 * n, ref=24)

    # -- scans at 2^24 (the lax formulations the engine runs) --------------
    a = rng.integers(0, 2, n).astype(np.int32)
    b = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    c = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    rank = np.sort(rng.integers(-1, 1 << 20, n)).astype(np.int32)
    val = rng.integers(0, 1 << 26, n).astype(np.int32)
    bundle = jax.jit(lambda x, y, z: engine_multi_scan(
        (x, y, z), ("sum", "max", "min")))
    maxpair = jax.jit(lambda k, v: engine_multi_scan((k, v), ("maxpair",)))
    g = [np.asarray(x) for x in bundle(a, b, c)]
    assert np.array_equal(g[0], np.cumsum(a).astype(np.int32))
    assert np.array_equal(g[1], np.maximum.accumulate(b))
    assert np.array_equal(g[2], np.minimum.accumulate(c))
    gk, gv = (np.asarray(x) for x in maxpair(rank, val))
    packed = (rank.astype(np.int64) << 32) | val.astype(np.int64)
    m = np.maximum.accumulate(packed)
    assert np.array_equal(gk, (m >> 32).astype(np.int32))
    assert np.array_equal(gv, (m & 0xFFFFFFFF).astype(np.int32))
    report("scan bundle sum+max+min i32 2^24",
           timeit(bundle, jnp.asarray(a), jnp.asarray(b), jnp.asarray(c),
                  min_time=mt), 6 * 4 * n, ref=24)
    report("scan maxpair (key, payload) i32 2^24",
           timeit(maxpair, jnp.asarray(rank), jnp.asarray(val),
                  min_time=mt), 4 * 4 * n, ref=24)

    if trace:
        with jax.profiler.trace(trace):
            jax.block_until_ready((sort1(keys), sort2(keys, row_ids),
                                   seg1(keys), seg2(keys)))
        print("\nsort kernels on the device (name, total us):")
        for name, ns in device_kernel_names(trace)[:12]:
            print(f"  {ns/1e3:10.1f}  {name[:110]}")
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true",
                    help="0.2 s minimum per case instead of 0.5 s")
    ap.add_argument("--trace", default=None,
                    help="directory for a profiler trace of the sorts")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        sys.exit("roofline: no accelerator (device numbers come only from "
                 "a run on the card)")
    rows = run(0.2 if args.quick else 0.5, args.trace)
    print(f"\n{dev.device_kind}")
    print("| op | ms | GB/s | % peak | % copy |")
    print("|---|---|---|---|---|")
    for name, ms, gbs, pk, cp in rows:
        print(f"| {name} | {ms:.3f} | {gbs:.1f} | {pk:.1f} | {cp:.1f} |")


if __name__ == "__main__":
    main()
