"""The engine's scans (``ops.scan.engine_multi_scan``) at 2^24, against a
copy of the same bytes.

Rows: single cumsum / cummax / reverse cummin, the fused sum+max+min bundle
``layout.run_boundaries`` uses, and ``maxpair`` (``expand``'s segmented
propagation) next to the packed-i64 cummax it equals.  Results are checked
against numpy before any timing is reported.

    python tools/scanbench.py [--n 24] [--quick]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from hashjoin3d_tpu.ops.scan import engine_multi_scan
from roofline import timeit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24, help="log2 elements")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    mt = 0.2 if args.quick else 0.5
    n = 1 << args.n

    print(f"devices: {jax.devices()}  n=2^{args.n}", flush=True)
    rng = np.random.default_rng(13)
    a = rng.integers(-100, 100, n).astype(np.int32)
    b = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    c = rng.integers(-1 << 30, 1 << 30, n).astype(np.int32)
    rank = np.sort(rng.integers(-1, 1 << 20, n)).astype(np.int32)
    val = rng.integers(0, 1 << 26, n).astype(np.int32)

    bundle = jax.jit(lambda x, y, z: engine_multi_scan(
        (x, y, z), ("sum", "max", "min")))
    got = [np.asarray(g) for g in bundle(a, b, c)]
    assert np.array_equal(got[0], np.cumsum(a).astype(np.int32))
    assert np.array_equal(got[1], np.maximum.accumulate(b))
    assert np.array_equal(got[2], np.minimum.accumulate(c))
    print("scan results match numpy", flush=True)

    a, b, c = jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)
    rank, val = jnp.asarray(rank), jnp.asarray(val)
    copy = jax.jit(lambda x: x + 1)
    t_copy = timeit(copy, a, min_time=mt)
    copy_gbs = 2 * 4 * n / t_copy / 1e9
    rows = []

    def report(name, secs, arrays):
        gbs = 2 * 4 * n * arrays / secs / 1e9
        rows.append((name, secs * 1e3, gbs, 100 * gbs / copy_gbs))
        print(f"{name:44s} {secs*1e3:9.3f} ms  {gbs:8.1f} GB/s "
              f"{100*gbs/copy_gbs:6.1f}% copy", flush=True)

    report("copy i32 (read+write)", t_copy, 1)
    for op, x, rev in (("sum", a, False), ("max", b, False),
                       ("min", c, True)):
        f = jax.jit(lambda v, op=op, rev=rev: engine_multi_scan(
            (v,), (op,), reverse=rev))
        report(f"{op} scan i32{' (reverse)' if rev else ''}",
               timeit(f, x, min_time=mt), 1)
    report("bundle sum+max+min", timeit(bundle, a, b, c, min_time=mt), 3)
    packed = (rank.astype(jnp.int64) << 26) | val.astype(jnp.int64)
    lax_i64 = jax.jit(lambda p: jax.lax.cummax(p, 0))
    pair = jax.jit(lambda k, v: engine_multi_scan((k, v), ("maxpair",)))
    report("cummax i64 (packed rank|val)", timeit(lax_i64, packed,
                                                  min_time=mt), 2)
    report("maxpair (rank, val) i32", timeit(pair, rank, val, min_time=mt), 2)

    print(f"\n{jax.devices()[0].device_kind}")
    print("| op | ms | GB/s | % copy |")
    print("|---|---|---|---|")
    for name, ms, gbs, cp in rows:
        print(f"| {name} | {ms:.3f} | {gbs:.1f} | {cp:.1f} |")


if __name__ == "__main__":
    main()
