"""Sort-wall measurement: how does lax.sort scale with batching and ops?

The probe strands' one sort is either XLA's global ``lax.sort`` or its
(K, C)-segmented form (``ops.sort.sort_segmented``, chosen by
``probe_sort_chunk``).  This probe measures the global sorts, the batched
curve over segment sizes, a u64-packed 1-op alternative to the 2-op sort,
and the runtime skip of an already-ascending stream, all at 2^24 keys over
a 2^20 domain.

Run on an accelerator: python tools/sortbench.py
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from tools.roofline import timeit

I32 = jnp.int32
U32 = jnp.uint32

N = 1 << 24


def bench(name, fn, *args, n=N, min_time=0.5):
    t = timeit(fn, *args, min_time=min_time)
    print(f"  {name:46s} {t*1e3:8.3f} ms  {t*1e9/n:6.3f} ns/elem",
          flush=True)
    return t


def main():
    print(f"devices: {jax.devices()}", flush=True)
    rng = np.random.default_rng(7)
    keys = jnp.asarray(rng.integers(0, 1 << 20, N), dtype=U32)
    rows = jnp.arange(N, dtype=I32)

    s1 = jax.jit(lambda k: lax.sort((k,), num_keys=1)[0])
    s2 = jax.jit(lambda k, r: lax.sort((k, r), num_keys=1, is_stable=True))
    bench("1-op sort (2^24,)", s1, keys)
    bench("2-op sort (2^24,)", s2, keys, rows)

    # u64-packed 1-op alternative to the 2-op (key<<24 | row)
    packed = (keys.astype(jnp.uint64) << jnp.uint64(24)) | \
        rows.astype(jnp.uint64)
    su = jax.jit(lambda p: lax.sort((p,), num_keys=1)[0])
    bench("1-op u64 packed sort (2^24,)", su, packed)

    # batched: sort each row of (K, C) independently
    for logc in (22, 20, 18, 16, 14, 12):
        C = 1 << logc
        K = N // C
        k2 = keys.reshape(K, C)
        r2 = rows.reshape(K, C)
        b1 = jax.jit(lambda k: lax.sort((k,), num_keys=1, dimension=1)[0])
        b2 = jax.jit(lambda k, r: lax.sort((k, r), num_keys=1, dimension=1,
                                           is_stable=True))
        bench(f"1-op batched ({K}, 2^{logc})", b1, k2)
        bench(f"2-op batched ({K}, 2^{logc})", b2, k2, r2)

    # does key entropy matter? (few distinct values)
    lowent = jnp.asarray(rng.integers(0, 256, N), dtype=U32)
    bench("1-op sort, 256 distinct keys", s1, lowent)

    # runtime sortedness detection (ops/layout.py:sort_rows_maybe_skip):
    # skip-branch cost on ascending input vs the cond's overhead on random
    # input
    from hashjoin3d_tpu.ops.layout import sort_rows_maybe_skip
    sd = jax.jit(sort_rows_maybe_skip)
    ksorted = jnp.sort(keys)
    bench("maybe-skip sort, ascending input (skip)", sd, ksorted)
    bench("maybe-skip sort, random input (cond+sort)", sd, keys)


if __name__ == "__main__":
    main()
