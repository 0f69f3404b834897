#!/usr/bin/env python
"""Experiment 1 CLI: single key/FK hash join microbenchmark.

Mirrors the reference executable's interface (``main_experiment1.cc:1374-1461``):

  python exp1.py -R 20 -S 24 --no-skew -t 0 -b 1 --measure-file out.csv \
      -p Csr,Nrs [--print-timers] [--print-relations]

Runs on the default JAX device (the GPU; ``--platform cpu`` for a CPU run);
the measurement CSV is column-compatible with the reference binary's.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description="Hash Table Experiment 1")
    ap.add_argument("-R", "--card-R", type=int, required=True,
                    help="cardinality of key relation R as log2")
    ap.add_argument("-S", "--card-S", type=int, required=True,
                    help="cardinality of FK relation S as log2")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--skew", dest="skew", action="store_true",
                   help="zipf(1.0) foreign keys")
    g.add_argument("--no-skew", dest="skew", action="store_false",
                   help="uniform foreign keys")
    ap.add_argument("-t", "--param-t", type=int, required=True,
                    help="FK domain scale: S.a in [0, |R|/2^t)")
    ap.add_argument("-b", "--param-b", type=int, default=1, choices=range(1, 5),
                    help="bucket scale-down: #buckets = #dv/b")
    ap.add_argument("--measure-file", required=True,
                    help="CSV output path ('-' for stdout)")
    ap.add_argument("-p", "--plans", default="all",
                    help="comma-separated plans (scr,scs,Csr,CsrUU,Crs,Nsr,Nrs,NrsNU,all; "
                    "plus CsrSel,CrsSel,NrsSel -- the reference's declared-"
                    "only selection plans, excluded from 'all' like its ALL "
                    "mask) or numeric plans_e bitmask values (e.g. 4,8 = "
                    "Csr,Crs; 128,256,512 = the Sel plans)")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "device", "host"),
                    help="execution backend: JAX device, native host engine, "
                    "or automatic per-plan crossover (PERF.md)")
    ap.add_argument("--print-timers", action="store_true")
    ap.add_argument("--print-relations", action="store_true")
    ap.add_argument("--min-time-ms", type=float, default=300.0,
                    help="repeat plans until this cumulative time")
    ap.add_argument("--min-repeat", type=int, default=8)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="force the JAX platform")
    args = ap.parse_args(argv)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from hashjoin3d_tpu.utils.misc import enable_compile_cache
    enable_compile_cache()

    if args.param_t > args.card_R:
        print("--param-t must not be greater than --card-R", file=sys.stderr)
        return 1
    if not (0 <= args.card_R <= 30 and 0 <= args.card_S <= 30):
        print("-R/-S must be in [0, 30]", file=sys.stderr)
        return 1

    print("Running Experiment 1 with the following config:")
    for k in ("card_R", "card_S", "skew", "param_t", "param_b",
              "measure_file", "plans"):
        print(f"  --{k.replace('_','-')} {getattr(args, k)}")

    from hashjoin3d_tpu.models.exp1 import Experiment1

    exp = Experiment1(
        args.card_R, args.card_S, args.skew, args.param_t, b=args.param_b,
        measure_file=None if args.measure_file == "-" else args.measure_file,
        plans=args.plans.split(","),
        min_runtime_s=args.min_time_ms / 1e3, min_repeat=args.min_repeat,
        backend=args.backend)
    exp.init()
    if args.print_relations:
        exp.print_relations()
    exp.run()
    if args.print_timers:
        print("Timers:")
        exp.print_timers()
    print("----")
    return 0


if __name__ == "__main__":
    sys.exit(main())
