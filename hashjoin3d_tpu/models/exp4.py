"""Experiment 4: two key/FK joins R |><| S |><| T with deferred unnesting.

JAX re-implementation of the reference's second benchmark driver
(``main_experiment4.cc``): an "inverted star" -- central key relation R, two FK
relations S, T whose FK columns share an alpha-fraction of R's keys
(multiplicity A) and reference a beta-fraction exclusively (multiplicity B)
(``main_experiment4.cc:55-74``).  Rows of join(R,S) whose key has no T partner
die at the second probe while still *nested* (one tuple per match group), so
unnest work is proportional to the final -- not intermediate -- result.

Plans (``main_experiment4.cc:158-164``):
  Ndu   3D hash joins, both unnests deferred after both probes (:832-941)
  Chj   chaining hash joins, full expansion between the joins (:943-1043)
  Nnu   3D hash joins, NO unnest: nested RST tuples straight to top.  The
        reference declares this plan in its enum/CLI map but never implements
        a run function (``main_experiment4.cc:161,321,577-582``); here it is
        implemented as the exp-4 analogue of exp-1's ``NrsNU``.

Pipelines are jitted device programs; build strands and the probe strand are
timed separately under the batched doubling protocol
(``utils.measure.repeat_mintime_batch``); the CSV
is column-compatible with the reference (``main_experiment4.cc:769-812``) and
all c_* counters are bit-equal.
"""

from __future__ import annotations

import sys
import time
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import (
    materialize_chaining_join,
    probe_chaining,
    probe_nested,
)
from ..utils import exp4_data
from ..utils.csv_writer import CSVWriter
from ..utils.measure import Timers, repeat_mintime, repeat_mintime_batch

PLAN_NAMES = ["Ndu", "Chj", "Nnu"]

_CSV_HEADER = [
    "mintime", "minreps", "log2CardR", "a", "aM", "b", "bM",
    "cardR", "cardS", "cardT",
    "plan", "ht_impl", "reps",
    "t_total", "t_build_S", "t_build_T", "t_probe_R",
    "c_sc_R", "c_sc_S", "c_sc_T", "c_build_S", "c_build_T",
    "c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp",
    "c_unnest_S", "c_unnest_T", "c_top",
]


@partial(jax.jit, static_argnames=("out1", "out2"))
def _ndu_probe_strand(tbl_s, tbl_t, r_k, out1, out2):
    """scan R -> NestProbe(S) -> NestProbe(T) -> Unnest(T) -> Unnest(S) -> Top.

    The strand body (shared with the distributed pipeline) lives in
    ``ops.nested.deferred_two_join_strand``.
    """
    from ..ops.nested import deferred_two_join_strand

    out = deferred_two_join_strand(tbl_s, tbl_t, r_k, out1, out2)
    out.pop("valid")
    out["c_top"] = out["c_unnest_2"]
    return out


@jax.jit
def _nnu_probe_strand(tbl_s, tbl_t, r_k):
    """scan R -> NestProbe(S) -> NestProbe(T) -> Top, no unnesting.

    Each surviving R row carries its two match-group ids (the "nested tuple");
    c_top counts nested tuples, exactly like exp-1's NrsNU counts un-expanded
    nested tuples (``main_experiment1.cc:1187-1285``).
    """
    rs = probe_nested(tbl_s, r_k)
    rst = probe_nested(tbl_t, r_k, mask=rs.hit)
    both = rst.hit
    return dict(
        g_s=jnp.where(both, rs.g, -1),
        g_t=jnp.where(both, rst.g, -1),
        c_probe_RS=rs.num_matches, c_probe_RS_cmp=rs.num_cmps,
        c_probe_RT=rst.num_matches, c_probe_RT_cmp=rst.num_cmps,
        c_top=rst.num_matches.astype(jnp.int64),
    )


@partial(jax.jit, static_argnames=("out1", "out2"))
def _chj_probe_strand(tbl_s, tbl_t, r_k, out1, out2):
    """scan R -> Probe(S) -> Probe(T) -> Top with immediate expansion
    (``main_experiment4.cc:943-1043``): the RS pairs are fully materialized
    before probing T, so the second probe runs once per *pair*."""
    prs = probe_chaining(tbl_s, r_k)
    r_row1, s_row1, v1, n_rs = materialize_chaining_join(tbl_s, prs, out1)

    # Probe T once per materialized RS pair, hashing the pair's R key
    # (HashfunRS, main_experiment4.cc:355-361).
    pair_keys = r_k[jnp.maximum(r_row1, 0)]
    prt = probe_chaining(tbl_t, pair_keys, mask=v1)
    pr_row2, t_row2, v2, n_rst = materialize_chaining_join(tbl_t, prt, out2)

    pr2 = jnp.maximum(pr_row2, 0)
    r_row = jnp.where(v2, r_row1[pr2], -1)
    s_row = jnp.where(v2, s_row1[pr2], -1)

    return dict(
        r_row=r_row, s_row=s_row, t_row=t_row2,
        c_probe_RS=prs.num_matches, c_probe_RS_cmp=prs.num_cmps,
        c_probe_RT=prt.num_matches, c_probe_RT_cmp=prt.num_cmps,
        c_top=n_rst,
    )


class Experiment4:
    """One parameter combination of experiment 4 (``main_experiment4.cc:156-291``)."""

    def __init__(self, log2_card_r: int, alpha: int, mult_alpha: int,
                 beta: int, mult_beta: int, measure_file=None, plans=("all",),
                 min_runtime_s: float = 0.3, min_repeat: int = 8,
                 trace: bool = True, backend: str = "auto"):
        self.log2_card_r = log2_card_r
        self.alpha, self.beta = alpha, beta
        self.mult_alpha, self.mult_beta = mult_alpha, mult_beta
        self.min_runtime_s = min_runtime_s
        self.min_repeat = min_repeat
        self.trace = trace
        self.plans = self._resolve_plans(plans)
        self.csv = CSVWriter(measure_file)
        self.timers = Timers()
        self._rk = self._sa = self._ta = None
        assert backend in ("device", "host", "auto")
        self.backend = backend
        #: plan name -> the last rep's probe output (dict), for result
        #: checks after run()
        self.outputs = {}

    @staticmethod
    def _resolve_plans(plans):
        out = set()
        for p in plans:
            for item in str(p).split(","):
                if not item:
                    continue
                if item.lower() == "all":
                    out.update(("Ndu", "Chj"))  # reference's runnable set
                elif item.lower() == "none":
                    pass
                elif item.lower() == "nnu":
                    out.add("Nnu")
                elif item in PLAN_NAMES:
                    out.add(item)
                elif item.isdigit():
                    # plans_e bits (main_experiment4.cc:158-164)
                    mask = int(item)
                    bits = {"Ndu": 1, "Nnu": 2, "Chj": 4}
                    out.update(n for n, b in bits.items() if mask & b)
                else:
                    raise ValueError(f"unknown plan {item!r}")
        return out

    # -- derived cardinalities (main_experiment4.cc:208-227) -------------------

    @property
    def card_r(self):
        return 1 << self.log2_card_r

    @property
    def num_fk_common(self):
        return self.card_r >> self.alpha

    @property
    def num_fk_exclusive(self):
        return self.card_r >> self.beta

    @property
    def card_fk_common(self):
        return self.num_fk_common * self.mult_alpha

    @property
    def card_fk_exclusive(self):
        return self.num_fk_exclusive * self.mult_beta

    @property
    def card_fk_relations(self):
        return self.card_fk_common + self.card_fk_exclusive

    card_s = card_t = card_fk_relations

    def calc_join_card1(self):
        """|join(R,S)| = |join(R,T)| = |S| (main_experiment4.cc:584-591)."""
        return self.card_fk_relations

    def calc_join_card2(self):
        """|join(R,S,T)| = numFkCommon * A^2 (main_experiment4.cc:593-597)."""
        return self.num_fk_common * self.mult_alpha ** 2

    # -- setup -----------------------------------------------------------------

    def init(self, shuffle: bool = True):
        if self.card_r < self.num_fk_common + 2 * self.num_fk_exclusive:
            # the reference asserts this (main_experiment4.cc:519) but ships
            # with DO_ASSERTS off, so its release binaries RUN such configs:
            # T-exclusive FK values spill past R's key domain and simply
            # never match (e.g. -R 10 -a 1 -b 1).  Accept them likewise so
            # differential sweeps can cover the quirk (tools/parity_sweep.py)
            sys.stderr.write(
                "warning: cardR < numFkCommon + 2*numFkExclusive -- "
                "T-exclusive FK values exceed R's key domain and will "
                "never match (the reference runs this config the same "
                "way, its assert being compiled out)\n")
        self.timers.start("init")
        sa, ta = exp4_data(self.log2_card_r, self.alpha, self.mult_alpha,
                           self.beta, self.mult_beta, shuffle)
        self._rk = jax.device_put(np.arange(self.card_r, dtype=np.uint32))
        self._sa = jax.device_put(sa)
        self._ta = jax.device_put(ta)
        jax.block_until_ready((self._rk, self._sa, self._ta))
        self.timers.stop("init")

    def print_relations(self, out=None):
        out = out or sys.stdout
        for name, rel in (("R", None), ("S", self._sa), ("T", self._ta)):
            out.write(f"-- {name} --\n")
            if rel is None:
                for k in range(self.card_r):
                    out.write(f"{k}|0\n")
            else:
                for i, a in enumerate(np.asarray(rel)):
                    out.write(f"{i}|{a}\n")

    def print_config(self, out=None):
        out = out or sys.stdout
        out.write(
            "Data Generation Config\n"
            f"  |R|: {self.card_r}  |S|: {self.card_s}  |T|: {self.card_t}\n"
            f"  FK_Common  dv={self.num_fk_common} mult={self.mult_alpha}"
            f" card={self.card_fk_common}\n"
            f"  FK_Excl    dv={self.num_fk_exclusive} mult={self.mult_beta}"
            f" card={self.card_fk_exclusive}\n"
            f"  card(j(R,Fk)):  {self.calc_join_card1()}\n"
            f"  card(j(R,S,T)): {self.calc_join_card2()}\n")

    @staticmethod
    def print_param_table(out=None, log2_range=(10, 26)):
        """Enumerate parameter combinations with derived cardinalities
        (``main_experiment4.cc:659-726``)."""
        out = out or sys.stdout
        out.write("r  a  am b  bm cardR cardS cardT FkC_dv FkC_mul FkC_card "
                  "FkE_dv FkE_mul FkE_card c(RS) c(RST)\n")
        ctr = 0
        for lr in range(*log2_range):
            for a in range(lr + 1):
                for am in range(1, 10):
                    for b in range(lr + 1):
                        for bm in range(1, 10):
                            e = Experiment4(lr, a, am, b, bm, plans=("none",))
                            out.write(
                                f"{lr} {a} {am} {b} {bm} {e.card_r} {e.card_s}"
                                f" {e.card_t} {e.num_fk_common} {am}"
                                f" {e.card_fk_common} {e.num_fk_exclusive}"
                                f" {bm} {e.card_fk_exclusive}"
                                f" {e.calc_join_card1()} {e.calc_join_card2()}\n")
                            ctr += 1
        out.write(f"Counter: {ctr}\n")

    # -- measurement -------------------------------------------------------------

    def _write_params(self):
        self.csv.write_fields(
            f"{int(self.min_runtime_s * 1e3)}ms", self.min_repeat,
            self.log2_card_r, self.alpha, self.mult_alpha, self.beta,
            self.mult_beta, self.card_r, self.card_s, self.card_t)

    # Auto-backend crossover: below this total row volume (|R|+|S|+|T|+|out|)
    # the native host engine is expected to beat the device path's fixed
    # cost of three strands and ~40 kernel launches.  Not yet calibrated on
    # the GPU.
    HOST_CROSSOVER_ROWS = 12_000_000

    def _backend_for_plan(self, name):
        if self.backend != "auto":
            return self.backend
        from ..hostengine import native_engine
        if name == "Nnu" or native_engine() is None:
            return "device"
        vol = (self.card_r + self.card_s + self.card_t
               + self.calc_join_card2())
        return "host" if vol < self.HOST_CROSSOVER_ROWS else "device"

    def _run_plan_host(self, name):
        """Run one plan end-to-end on the native host engine (same counters,
        same CSV row shape; the right choice for small configs where device
        dispatch latency dominates -- see HOST_CROSSOVER_ROWS)."""
        from ..hostengine import HostTable, host_two_join_probe

        nested = name == "Ndu"
        num_dv_fk = self.num_fk_common + self.num_fk_exclusive
        kind = "nested" if nested else "chaining"
        sa, ta = np.asarray(self._sa), np.asarray(self._ta)
        rk = np.asarray(self._rk)
        out_cap = max(self.calc_join_card2(), 1)

        durs = dict(bs=0.0, bt=0.0, probe=0.0, total=0.0)
        state = {}

        def once():
            t0 = time.perf_counter()
            tbl_s = HostTable(sa, num_dv_fk, kind=kind)
            t1 = time.perf_counter()
            tbl_t = HostTable(ta, num_dv_fk, kind=kind)
            t2 = time.perf_counter()
            out = host_two_join_probe(tbl_s, tbl_t, rk, out_cap)
            t3 = time.perf_counter()
            tbl_s.close()
            tbl_t.close()
            durs["bs"] += t1 - t0
            durs["bt"] += t2 - t1
            durs["probe"] += t3 - t2
            durs["total"] += t3 - t0
            state["out"] = out

        once()  # warm the allocator / page cache like the device warm-up
        for k in durs:
            durs[k] = 0.0
        _, reps = repeat_mintime(self.min_runtime_s, once,
                                 min_repeat=self.min_repeat)
        out = state["out"]

        if self.trace:
            print(f"Plan {name} [host]: reps {reps}, "
                  f"probe {durs['probe']/reps*1e3:.3f} ms, "
                  f"c_top {int(out['c_top'])}")

        self._write_params()
        self.csv.write_fields(
            name, "nested" if nested else "chaining", reps,
            int(durs["total"] / reps * 1e9),
            int(durs["bs"] / reps * 1e9),
            int(durs["bt"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            self.card_r, self.card_s, self.card_t,
            self.card_s, self.card_t,
            int(out["c_probe_RS"]), int(out["c_probe_RS_cmp"]),
            int(out["c_probe_RT"]), int(out["c_probe_RT_cmp"]),
            int(out["c_unnest_1"]) if "c_unnest_1" in out else "NA",
            int(out["c_unnest_2"]) if "c_unnest_2" in out else "NA",
            int(out["c_top"]),
        ).newline()
        self.outputs[name] = out

    def _run_plan(self, name):
        if self._backend_for_plan(name) == "host":
            return self._run_plan_host(name)
        nested = name in ("Ndu", "Nnu")
        num_dv_fk = self.num_fk_common + self.num_fk_exclusive
        from ..ops.chaining import build_chaining_host
        from ..ops.nested import build_nested_host

        # FK domains are dense by construction: S.a in [0, nCommon+nExcl),
        # T.a in [0, nCommon) U [nCommon+nExcl, nCommon+2*nExcl)
        # (main_experiment4.cc:517-575) -> dense key-domain index applies.
        key_dom = self.num_fk_common + 2 * self.num_fk_exclusive

        def build_fn(keys, nb):
            # exact distinct-FK count is known analytically -> sync-free build;
            # Chj probes never use IsBuildKeyUnique, so the chaining builds
            # skip the early-exit chain-position index (an n-sized scatter
            # plus scans: ~700 ms at 12.6M rows)
            if nested:
                return build_nested_host(keys, nb, n_keys=num_dv_fk,
                                         key_domain=key_dom)
            return build_chaining_host(keys, nb, n_keys=num_dv_fk,
                                       key_domain=key_dom,
                                       early_exit_index=False)
        # Sorted-probe strands: R.k is an iota by construction
        # (main_experiment4.cc:522-525), so the probe pipeline needs no
        # probe sort at all (ops/strands_windowed.py).
        from ..ops.strands_windowed import (
            chj_strand_sorted, ndu_strand_sorted, nnu_strand_sorted)

        if name == "Nnu":
            probe_fn = nnu_strand_sorted
        elif nested:
            out1 = self.calc_join_card2() // max(self.mult_alpha, 1)
            out1 = max(out1, 1)

            def probe_fn(ts, tt, rk, _o1=out1,
                         _o2=max(self.calc_join_card2(), 1)):
                out = ndu_strand_sorted(ts, tt, rk, _o1, _o2)
                out = dict(out)
                out.pop("valid")
                out["c_top"] = out["c_unnest_2"]
                return out
        else:
            probe_fn = partial(chj_strand_sorted,
                               out1=max(self.calc_join_card1(), 1),
                               out2=max(self.calc_join_card2(), 1))

        state = {}

        # compile outside the timed region (see exp1); free the warm-up
        # tables before timing -- holding them across the loop inflates
        # device memory pressure and distorts each repetition's first big
        # allocation
        ws = build_fn(self._sa, num_dv_fk)
        wt = build_fn(self._ta, num_dv_fk)
        jax.block_until_ready((ws, wt))
        jax.block_until_ready(probe_fn(ws, wt, self._rk))
        # memory snapshot from the warm-up tables: keeping per-rep tables
        # in `state` would hold the previous rep's tables alive while the
        # next rep builds (2x table HBM inside the timed loop)
        state["mem_s"] = ws.memory_consumption()
        state["mem_t"] = wt.memory_consumption()
        del ws, wt

        # batched strands (utils/measure.py, see exp1's _run_join_plan):
        # the reference times n synchronous (build S; build T; probe) reps
        # (main_experiment4.cc:869-886); each strand phase here enqueues its
        # batch and waits once -- the same device work.
        t_bs, reps_bs, tbl_s = repeat_mintime_batch(
            self.min_runtime_s, lambda: build_fn(self._sa, num_dv_fk),
            min_repeat=self.min_repeat)
        t_bt, reps_bt, tbl_t = repeat_mintime_batch(
            self.min_runtime_s, lambda: build_fn(self._ta, num_dv_fk),
            min_repeat=self.min_repeat)
        t_p, reps, out = repeat_mintime_batch(
            self.min_runtime_s, lambda: probe_fn(tbl_s, tbl_t, self._rk),
            min_repeat=self.min_repeat)
        durs = dict(bs=t_bs / reps_bs * reps, bt=t_bt / reps_bt * reps,
                    probe=t_p,
                    total=(t_bs / reps_bs + t_bt / reps_bt
                           + t_p / reps) * reps)

        if self.trace:
            print(f"Plan {name}: reps {reps}, "
                  f"probe {durs['probe']/reps*1e3:.3f} ms, c_top {int(out['c_top'])}")
            # the reference's per-table node-sizeof dump
            # (main_experiment4.cc:907-910, :1015-1016) -- device bytes
            for label in ("mem_s", "mem_t"):
                print(f"  {label[-1].upper()}: ht memory: " + ", ".join(
                    f"{k} {v:,}" for k, v in state[label].items()) + " bytes")

        self._write_params()
        self.csv.write_fields(
            name, "nested" if nested else "chaining", reps,
            int(durs["total"] / reps * 1e9),
            int(durs["bs"] / reps * 1e9),
            int(durs["bt"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            self.card_r, self.card_s, self.card_t,
            self.card_s, self.card_t,
            int(out["c_probe_RS"]), int(out["c_probe_RS_cmp"]),
            int(out["c_probe_RT"]), int(out["c_probe_RT_cmp"]),
            int(out["c_unnest_1"]) if "c_unnest_1" in out else "NA",
            int(out["c_unnest_2"]) if "c_unnest_2" in out else "NA",
            int(out["c_top"]),
        ).newline()
        self.outputs[name] = out

    def run(self):
        self.csv.write_fields(*_CSV_HEADER).newline()
        for name in PLAN_NAMES:  # fixed dispatch order like :577-582
            if name in self.plans:
                self._run_plan(name)

    def print_timers(self):
        self.timers.print()
