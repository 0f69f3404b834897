#!/usr/bin/env python
"""Experiment 4 CLI: two joins with deferred unnesting.

Mirrors the reference executable's interface (``main_experiment4.cc:1048-1161``):

  python exp4.py -R 20 -a 4 -A 4 -b 2 -B 2 --measure-file out.csv \
      [-p Ndu,Chj,Nnu] [--no-run] [--print-relations] [--print-paramtable]

``-p all`` runs the reference's runnable plan set (Ndu, Chj).  Nnu -- declared
but unimplemented in the reference -- is available by naming it explicitly.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Hash Table Experiment 4: Two Joins w/ Deferred Unnesting")
    ap.add_argument("-R", "--card-R", type=int, required=True,
                    help="cardinality of key relation R as log2")
    ap.add_argument("-a", "--alpha", type=int, required=True,
                    help="log2 fraction of keys referenced by both S and T")
    ap.add_argument("-b", "--beta", type=int, required=True,
                    help="log2 fraction of keys referenced by exactly one of S/T")
    ap.add_argument("-A", "--alpha-mult", type=int, required=True,
                    help="multiplicity of common FKs")
    ap.add_argument("-B", "--beta-mult", type=int, required=True,
                    help="multiplicity of exclusive FKs")
    ap.add_argument("--measure-file", required=True)
    ap.add_argument("-p", "--plans", default="all",
                    help="comma-separated plans (Ndu,Chj,Nnu,all) or numeric "
                    "plans_e bitmask values (e.g. 1,4 = Ndu,Chj)")
    run_g = ap.add_mutually_exclusive_group()
    run_g.add_argument("--run", dest="run", action="store_true", default=True)
    run_g.add_argument("--no-run", dest="run", action="store_false")
    ap.add_argument("--backend", default="auto",
                    choices=("auto", "device", "host"),
                    help="execution backend: JAX device, native host engine, "
                    "or automatic per-plan crossover (PERF.md)")
    ap.add_argument("--print-timers", action="store_true")
    ap.add_argument("--print-relations", action="store_true")
    ap.add_argument("--print-paramtable", action="store_true")
    ap.add_argument("--min-time-ms", type=float, default=300.0)
    ap.add_argument("--min-repeat", type=int, default=8)
    ap.add_argument("--platform", default=None, choices=("cpu", "gpu"),
                    help="force the JAX platform")
    args = ap.parse_args(argv)
    import jax
    if args.platform:
        jax.config.update("jax_platforms", args.platform)
    from hashjoin3d_tpu.utils.misc import enable_compile_cache
    enable_compile_cache()

    print("Running Experiment 4 with the following config:")
    for k in ("card_R", "alpha", "beta", "alpha_mult", "beta_mult",
              "measure_file", "plans"):
        print(f"  --{k.replace('_','-')} {getattr(args, k)}")

    from hashjoin3d_tpu.models.exp4 import Experiment4

    exp = Experiment4(
        args.card_R, args.alpha, args.alpha_mult, args.beta, args.beta_mult,
        measure_file=None if args.measure_file == "-" else args.measure_file,
        plans=args.plans.split(","),
        min_runtime_s=args.min_time_ms / 1e3, min_repeat=args.min_repeat,
        backend=args.backend)
    exp.print_config()
    exp.init()
    if args.print_relations:
        exp.print_relations()
    if args.run:
        exp.run()
    if args.print_paramtable:
        Experiment4.print_param_table()
    if args.print_timers:
        print("Timers:")
        exp.print_timers()
    return 0


if __name__ == "__main__":
    sys.exit(main())
