"""Stage-level build profiler: where do the 2^24-row build milliseconds go?

The host/fused compacted builds (`build_nested_host` / `build_chaining_host`)
are the engine's build fast path.  Their cost decomposes into three device
phases:

  1. phase-1 key sort            (`layout.sort_with_rows`, 2-op lax.sort)
  2. compacted directory         (`layout.compact_group_index`: scans +
                                  narrow head scatter + directory gathers)
  3. bucket/directory phase      (cap-sized main-chain sort + histograms,
                                  plus the optional ee / key_direct indexes)

This tool times each phase (tools/roofline.py protocol) and reports the
residual of the full build against the sum -- if the residual is large, the
cost model is missing a term; if phase 2's scans dominate, a scan kernel is
the next lever; if phase 1 dominates, the sort remains the wall.  Run on an
accelerator:

    python tools/buildprof.py [--n 24] [--keylog 20]
"""

import argparse
import sys
from functools import partial
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp
import numpy as np

from hashjoin3d_tpu.ops import chaining as chainmod
from hashjoin3d_tpu.ops import nested as nestmod
from hashjoin3d_tpu.ops.layout import (compact_group_index, key_direct_index,
                                       sort_with_rows)
from roofline import timeit


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=24, help="log2 build rows")
    ap.add_argument("--keylog", type=int, default=20, help="log2 key domain")
    ap.add_argument("--quick", action="store_true")
    args = ap.parse_args()
    mt = 0.2 if args.quick else 0.5

    n, dom = 1 << args.n, 1 << args.keylog
    cap = dom                       # group_capacity upper bound for FK draws
    nb = dom                        # experiments: #buckets ~ #distinct keys
    print(f"devices: {jax.devices()}  n=2^{args.n} domain=2^{args.keylog}",
          flush=True)

    rng = np.random.default_rng(11)
    keys = jnp.asarray(rng.integers(0, dom, n, dtype=np.uint32))

    rows = []

    def report(name, secs):
        rows.append((name, secs * 1e3))
        print(f"{name:44s} {secs*1e3:9.2f} ms", flush=True)

    # phase 1: the 2-op key sort (+ sortedness cond)
    t_sort = timeit(jax.jit(sort_with_rows), keys, min_time=mt)
    report("phase1 sort_with_rows (2-op)", t_sort)

    skey, srow, _ = jax.jit(sort_with_rows)(keys)

    # phase 2: compacted directory from the sorted stream
    cgi = jax.jit(partial(compact_group_index, cap=cap))
    t_cgi = timeit(cgi, keys, skey, srow, min_time=mt)
    report(f"phase2 compact_group_index (cap=2^{args.keylog})", t_cgi)

    # phase 2 vivisection: run_boundaries alone vs the directory writes
    from hashjoin3d_tpu.ops.layout import run_boundaries
    t_rb = timeit(jax.jit(lambda s: run_boundaries(s, jnp.int32(n))), skey,
                  min_time=mt)
    report("  phase2a run_boundaries (scans)", t_rb)

    # full fused nested build and the chaining variants
    nest_full = jax.jit(partial(nestmod._build_nested_fused, cap=cap,
                                num_buckets=nb, dense_direct=False,
                                key_domain=dom))
    t_nest = timeit(nest_full, keys, min_time=mt)
    report("nested fused build (key_domain)", t_nest)
    report("  nested residual vs sort+cgi", t_nest - t_sort - t_cgi)

    kdi = jax.jit(partial(key_direct_index, key_domain=dom))
    groups = cgi(keys, skey, srow)
    t_kdi = timeit(kdi, groups, min_time=mt)
    report("  key_direct_index (narrow scatter)", t_kdi)

    chain_ee = jax.jit(partial(chainmod._build_chaining_fused, cap=cap,
                               num_buckets=nb, dense_direct=False,
                               key_domain=dom, early_exit_index=True))
    t_ce = timeit(chain_ee, keys, min_time=mt)
    report("chaining fused build (ee=True)", t_ce)
    report("  chaining ee=True residual vs sort+cgi", t_ce - t_sort - t_cgi)

    chain_ne = jax.jit(partial(chainmod._build_chaining_fused, cap=cap,
                               num_buckets=nb, dense_direct=False,
                               key_domain=dom, early_exit_index=False))
    t_cn = timeit(chain_ne, keys, min_time=mt)
    report("chaining fused build (ee=False)", t_cn)
    report("  chaining ee=False residual vs sort+cgi", t_cn - t_sort - t_cgi)

    # inverse-permutation formulation A/B: the ee=True build pays one
    # n-sized inverse permutation (pos_by_row); dense builds pay two.
    # Decides layout._INVPERM_IMPL's device default (currently "sort").
    from hashjoin3d_tpu.ops.layout import set_invperm_impl
    for impl in ("scatter", "sort"):
        set_invperm_impl(impl)
        jax.clear_caches()
        chain_ee_i = jax.jit(partial(chainmod._build_chaining_fused, cap=cap,
                                     num_buckets=nb, dense_direct=False,
                                     key_domain=dom, early_exit_index=True))
        report(f"chaining ee=True build [invperm={impl}]",
               timeit(chain_ee_i, keys, min_time=mt))
        perm = jnp.asarray(rng.permutation(n).astype(np.uint32))
        dense_i = jax.jit(partial(chainmod._build_chaining_dense,
                                  num_buckets=n))
        report(f"dense-direct build 2^{args.n} [invperm={impl}]",
               timeit(dense_i, perm, min_time=mt))
    set_invperm_impl("auto")
    jax.clear_caches()

    # head-compaction formulation A/B: every build pays one directory
    # head compaction in compact_group_index (the padded key_group_index
    # additionally replaces two n-sized directory gathers with
    # sort payload slots).  Decides layout._HEADCOMPACT_IMPL's device
    # default.
    from hashjoin3d_tpu.ops.layout import key_group_index, set_headcompact_impl
    for impl in ("scatter", "sort"):
        set_headcompact_impl(impl)
        jax.clear_caches()
        cgi_i = jax.jit(partial(compact_group_index, cap=cap))
        report(f"phase2 compact_group_index [headcompact={impl}]",
               timeit(cgi_i, keys, skey, srow, min_time=mt))
        kgi_i = jax.jit(key_group_index)
        report(f"padded key_group_index [headcompact={impl}]",
               timeit(kgi_i, keys, min_time=mt))
    set_headcompact_impl("auto")
    jax.clear_caches()

    print("\n| stage | ms |")
    print("|---|---|")
    for name, ms in rows:
        print(f"| {name.strip()} | {ms:.1f} |")


if __name__ == "__main__":
    main()
