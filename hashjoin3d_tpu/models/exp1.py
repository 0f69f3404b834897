"""Experiment 1: single key/FK hash join R |><| S, all eight reference plans.

JAX re-implementation of the reference's primary benchmark driver
(``main_experiment1.cc``): relations R (unique key, |R| = 2^log2R) and
S (foreign key S.a over [0, |R|/2^t), uniform or zipf(1.0)), joined under
eight plans (``main_experiment1.cc:96-113``):

  scr/scs  scan-only calibration
  Csr      chaining HT, build R probe S, early-exit (IsBuildKeyUnique)
  CsrUU    same without early exit
  Crs      chaining HT, build S probe R (duplicate chains)
  Nsr      3D HT, build R probe S, + unnest
  Nrs      3D HT, build S probe R, + unnest
  NrsNU    3D HT, build S probe R, NO unnest (nested tuples straight to top)

Where the reference pushes tuples one at a time through operator strands, each
plan here is two jitted device pipelines (build strand, probe strand) timed
under the same doubling protocol (>= 300 ms cumulative, >= 8 reps; each batch
of reps ends in ``block_until_ready``, ``utils.measure.repeat_mintime_batch``).  The probe strand *materializes*
its result row-id columns on device (the reference's Top only counts --
materialization is strictly more work, keeping the comparison honest) and
produces all plan counters of the reference CSV, bit-equal:
c_htProbe, c_htProbeCmp, c_unnest, c_top (``main_experiment1.cc:1288-1333``).

The measurement CSV is column-compatible with the reference, including the
reference's quirk that scr/scs rows omit the ``reps`` field (compare
``main_experiment1.cc:546-573`` against the header at ``:1288-1333``).
"""

from __future__ import annotations

import sys
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import (
    materialize_chaining_join,
    probe_chaining,
    probe_nested,
    unnest,
)
from ..ops.stats import chaining_statistics, nested_statistics
from ..utils import exp1_data
from ..utils.csv_writer import CSVWriter
from ..utils.measure import Timers, repeat_mintime, repeat_mintime_batch

PLAN_NAMES = ["scr", "scs", "Csr", "CsrUU", "Crs", "Nsr", "Nrs", "NrsNU",
              "CsrSel", "CrsSel", "NrsSel"]

#: plans the reference's ALL mask covers (main_experiment1.cc:111: ALL =
#: (CsrUU << 1) - 1 minus the commented-out bits) -- "all" selects these;
#: the *Sel plans (declared-only in the reference, implemented here) are
#: opt-in by name or bit
DEFAULT_PLANS = ["scr", "scs", "Csr", "CsrUU", "Crs", "Nsr", "Nrs", "NrsNU"]

# plans_e bit values (main_experiment1.cc:96-113) -- lets scripted workflows
# pass numeric masks like ``-p 4,8`` (Csr|Crs) in place of plan names;
# the Sel bits are the reference's commented-out values
PLAN_BITS = {"scr": 1, "scs": 2, "Csr": 4, "Crs": 8, "Nrs": 16, "Nsr": 32,
             "NrsNU": 64, "CsrSel": 128, "CrsSel": 256, "NrsSel": 512,
             "CsrUU": 8192}


def resolve_plan_items(plans, names, bits, all_names=None):
    """Shared plan-list resolution for both experiment CLIs.

    Accepts plan names, ``all``/``none``, and (beyond the reference, whose
    ``plansFromVec`` silently drops anything not in its name map,
    main_experiment1.cc:1361-1370) numeric ``plans_e`` bitmask values --
    ``4,8`` and ``12`` both select Csr+Crs.  Unknown names raise.
    ``all_names`` narrows what ``all`` selects (the reference's ALL mask
    excludes its commented-out Sel bits, main_experiment1.cc:111, so
    "all" CSVs stay column-diffable against the reference binaries).
    """
    out = set()
    for p in plans:
        for item in str(p).split(","):
            if not item:
                continue
            if item.lower() == "all":
                out.update(all_names or names)
            elif item.lower() == "none":
                pass
            elif item in names:
                out.add(item)
            elif item.isdigit():
                mask = int(item)
                out.update(n for n, b in bits.items() if mask & b)
            else:
                raise ValueError(f"unknown plan {item!r}")
    return out

def _with_sel_count(out: dict, sel_mask) -> dict:
    """Attach the selection-output cardinality (c_selProbe) to a probe
    strand's result dict -- the *Sel plans' extra counter."""
    out = dict(out)
    out["c_selProbe"] = jnp.sum(sel_mask.astype(jnp.int64))
    return out


_CSV_HEADER = [
    "mintime", "minreps", "log2CardR", "log2CardS", "skew", "t", "fkMax",
    "numDvSa", "b",
    "plan", "ht_impl", "build", "probe", "ht_buckets", "ht_fracEmpty",
    "cc0_avg", "cc0_min", "cc0_max", "cc1_avg", "cc1_min", "cc1_max",
    "reps", "t_total", "t_buildStr", "t_probeStr", "t_top",
    "c_scanBuild", "c_selBuild", "c_htBuild", "c_scanProbe", "c_selProbe",
    "c_htProbe", "c_htProbeCmp", "c_unnest", "c_top",
]


# --- jitted plan strands -----------------------------------------------------

@jax.jit
def _scan_strand(col):
    """Scan -> Top: stream the column once and count it."""
    return jnp.max(col), jnp.int64(col.shape[0])


@partial(jax.jit, static_argnames=("out_size", "unique"))
def _chaining_probe_strand(table, probe_keys, out_size, unique):
    pr = probe_chaining(table, probe_keys, unique=unique)
    prow, brow, valid, total = materialize_chaining_join(
        table, pr, out_size, unique=unique)
    return dict(probe_row=prow, build_row=brow, total=total,
                c_htProbe=pr.num_matches, c_htProbeCmp=pr.num_cmps)


@partial(jax.jit, static_argnames=("out_size",))
def _nested_probe_strand(table, probe_keys, out_size):
    nb = probe_nested(table, probe_keys)
    prow, brow, valid, total = unnest(table, nb, out_size)
    return dict(probe_row=prow, build_row=brow, total=total,
                c_htProbe=nb.num_matches, c_htProbeCmp=nb.num_cmps,
                c_unnest=total)


@jax.jit
def _nested_probe_strand_nounnest(table, probe_keys):
    nb = probe_nested(table, probe_keys)
    # Top receives the nested tuples themselves: materialize the nested column
    # triple (probe rows pair with group ids under the hit mask).
    return dict(nested_g=nb.g, nested_hit=nb.hit,
                c_htProbe=nb.num_matches, c_htProbeCmp=nb.num_cmps,
                c_top=nb.num_matches)


class Experiment1:
    """One parameter combination of experiment 1 (``main_experiment1.cc:94-240``)."""

    def __init__(self, log2_card_r: int, log2_card_s: int, skew: bool, t: int,
                 b: int = 1, measure_file=None, plans=("all",),
                 min_runtime_s: float = 0.3, min_repeat: int = 8,
                 trace: bool = True, backend: str = "auto"):
        assert t <= log2_card_r
        self.log2_card_r = log2_card_r
        self.log2_card_s = log2_card_s
        self.skew = skew
        self.t = t
        self.b = b
        self.min_runtime_s = min_runtime_s
        self.min_repeat = min_repeat
        self.trace = trace
        self.plans = self._resolve_plans(plans)
        self.csv = CSVWriter(measure_file)
        self.timers = Timers()
        self.num_dv_sa = None
        self._rk = self._sa = None
        assert backend in ("device", "host", "auto")
        self.backend = backend
        #: plan name -> the last rep's probe output (device dict of arrays,
        #: or the host engine's tuple), for result checks after run()
        self.outputs = {}

    # -- setup ---------------------------------------------------------------

    @staticmethod
    def _resolve_plans(plans):
        return resolve_plan_items(plans, PLAN_NAMES, PLAN_BITS,
                                  all_names=DEFAULT_PLANS)

    @property
    def card_r(self):
        return 1 << self.log2_card_r

    @property
    def card_s(self):
        return 1 << self.log2_card_s

    @property
    def fk_max(self):
        return 1 << (self.log2_card_r - self.t)

    def init(self):
        """Generate inputs (bit-exact vs the reference) and stage on device."""
        self.timers.start("init")
        rk, sa, ndv = exp1_data(self.log2_card_r, self.log2_card_s,
                                self.skew, self.t)
        self.num_dv_sa = ndv
        self._rk = jax.device_put(rk)
        self._sa = jax.device_put(sa)
        jax.block_until_ready((self._rk, self._sa))
        self.timers.stop("init")

    def print_relations(self, out=None):
        out = out or sys.stdout
        rk = np.asarray(self._rk)
        sa = np.asarray(self._sa)
        out.write("-- R --\n")
        for k in rk:
            out.write(f"{k}|0|0\n")
        out.write("-- S --\n")
        for i, a in enumerate(sa):
            out.write(f"{i}|{a}|0\n")

    def print_timers(self):
        self.timers.print()

    # -- measurement core ------------------------------------------------------

    # Auto-backend crossover: below this per-plan row volume
    # (|build| + |probe| + |out|) the native host engine is expected to
    # beat the device path's fixed dispatch cost.  Not yet calibrated on
    # the GPU.
    HOST_CROSSOVER_ROWS = 4_000_000

    def _backend_for_plan(self, n_build, n_probe, n_out):
        if self.backend != "auto":
            return self.backend
        from ..hostengine import native_engine
        if native_engine() is None:
            return "device"
        vol = n_build + n_probe + n_out
        return "host" if vol < self.HOST_CROSSOVER_ROWS else "device"

    def _run_join_plan_host(self, name, build_keys, probe_keys, num_buckets,
                            impl, build_rel, probe_rel, has_unnest,
                            unique=False, unnest=True):
        """One join plan end-to-end on the native host engine (same counters,
        same CSV row shape)."""
        import time

        from ..hostengine import HostTable
        from ..ops.stats import chaining_statistics_np, nested_statistics_np

        self.timers.start(f"run{name}")
        bk = np.asarray(build_keys)
        pk = np.asarray(probe_keys)
        out_cap = max(self.card_s, 1)
        durs = dict(build=0.0, probe=0.0, total=0.0, last_probe=0.0)
        state = {}

        def once():
            t0 = time.perf_counter()
            table = HostTable(bk, num_buckets, kind=impl)
            t1 = time.perf_counter()
            if impl == "nested":
                out = table.probe(pk, unnest=unnest, out_cap=out_cap)
            else:
                out = table.probe(pk, unique=unique, out_cap=out_cap)
            t2 = time.perf_counter()
            table.close()
            durs["build"] += t1 - t0
            durs["probe"] += t2 - t1
            durs["total"] += t2 - t0
            durs["last_probe"] = t2 - t1
            state["out"] = out

        once()  # warm allocator / page cache (mirrors the device warm-up)
        for k in ("build", "probe", "total"):
            durs[k] = 0.0
        _, reps = repeat_mintime(self.min_runtime_s, once,
                                 min_repeat=self.min_repeat)
        out = state["out"]

        stats = (nested_statistics_np if impl == "nested"
                 else chaining_statistics_np)(bk, num_buckets)
        if self.trace:
            print(f"Plan {name} [host]")
            print(f"  reps {reps}, build {durs['build']/reps*1e3:.3f} ms, "
                  f"probe {durs['probe']/reps*1e3:.3f} ms")

        if impl == "nested":
            _, _, matches, cmps, unnested = out
            c_top = unnested if unnest else matches
            c_unnest = unnested if has_unnest else "NA"
        else:
            _, _, matches, cmps = out
            c_top = matches
            c_unnest = "NA"
        row = [
            name, impl, build_rel, probe_rel,
            *stats.to_csv_fields(),
            reps,
            int(durs["total"] / reps * 1e9),
            int(durs["build"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            int(durs["last_probe"] * 1e9),
            len(bk), "NA", len(bk),
            len(pk), "NA",
            int(matches), int(cmps),
            c_unnest,
            int(c_top),
        ]
        self._write_params()
        self.csv.write_fields(*row).newline()
        self.timers.stop(f"run{name}")
        self.outputs[name] = out
        return out

    def _run_join_plan(self, name, build_keys, probe_keys, num_buckets,
                       build_fn, probe_fn, impl, build_rel, probe_rel,
                       has_unnest):
        """Shared shape of all run*() functions (main_experiment1.cc:623-744):
        wire plan, repeat_mintime over (build strand; probe strand), HT stats,
        one CSV row."""
        self.timers.start(f"run{name}")

        # warm-up: compile both strands outside the timed region; steady
        # state is what the reference's repetition protocol measures --
        # compilation is a one-time cost.  Free the warm-up buffers before
        # timing: tables/outputs held alive across the loop inflate device
        # memory pressure and distort the first allocation of every
        # repetition.
        wt = build_fn(build_keys)
        jax.block_until_ready(wt)
        jax.block_until_ready(probe_fn(wt, probe_keys))
        del wt

        # batched strands (utils/measure.py): the reference times n
        # synchronous (build; probe) reps (main_experiment1.cc:664-677);
        # here each strand phase enqueues its whole batch and waits once --
        # the same device work (n fresh builds; n probes of the same table,
        # which the probe strands never mutate).
        t_build, reps_b, table = repeat_mintime_batch(
            self.min_runtime_s, lambda: build_fn(build_keys),
            min_repeat=self.min_repeat)
        t_probe, reps, out = repeat_mintime_batch(
            self.min_runtime_s, lambda: probe_fn(table, probe_keys),
            min_repeat=self.min_repeat)
        durs = dict(build=t_build / reps_b * reps,
                    probe=t_probe,
                    total=(t_build / reps_b + t_probe / reps) * reps,
                    last_probe=t_probe / reps)
        stats = (nested_statistics if impl == "nested"
                 else chaining_statistics)(table)

        if self.trace:
            print(f"Plan {name}")
            print(f"  reps {reps}, build {durs['build']/reps*1e3:.3f} ms, "
                  f"probe {durs['probe']/reps*1e3:.3f} ms")
            # the reference's node-sizeof/memory dump (main_experiment1.cc:
            # 701-708) -- here the table's actual device bytes
            mem = table.memory_consumption()
            print("  ht memory: " + ", ".join(
                f"{k} {v:,}" for k, v in mem.items()) + " bytes")

        c_top = int(out.get("c_top", out.get("total", 0)))
        row = [
            name, impl, build_rel, probe_rel,
            *stats.to_csv_fields(),
            reps,
            int(durs["total"] / reps * 1e9),
            int(durs["build"] / reps * 1e9),
            int(durs["probe"] / reps * 1e9),
            int(durs["last_probe"] * 1e9),  # ~ Top inclusive runtime of last run
            len(build_keys), "NA", len(build_keys),
            len(probe_keys),
            int(out["c_selProbe"]) if "c_selProbe" in out else "NA",
            int(out["c_htProbe"]), int(out["c_htProbeCmp"]),
            int(out["c_unnest"]) if has_unnest else "NA",
            c_top,
        ]
        self._write_params()
        self.csv.write_fields(*row).newline()
        self.timers.stop(f"run{name}")
        self.outputs[name] = out
        return out

    def _run_scan_plan(self, name, col):
        """scr / scs: a single un-repeated scan->top run
        (main_experiment1.cc:532-621).  NOTE: reproduces the reference quirk
        of omitting the ``reps`` column in these rows."""
        import time
        self.timers.start(f"run{name}")
        jax.block_until_ready(_scan_strand(col))  # compile outside the timing
        t0 = time.perf_counter()
        mx, cnt = jax.block_until_ready(_scan_strand(col))
        dt = time.perf_counter() - t0
        self._write_params()
        self.csv.write_fields(
            name, "NA", "NA", "NA", "NA", "NA", "NA", "NA", "NA", "NA",
            "NA", "NA",
            int(dt * 1e9),        # t_total
            "NA", "NA",
            int(dt * 1e9),        # t_top
            int(cnt),             # scan count
            "NA", "NA", "NA", "NA", "NA", "NA", "NA",
            int(cnt),             # c_top
        ).newline()
        self.timers.stop(f"run{name}")

    def _write_params(self):
        self.csv.write_fields(
            f"{int(self.min_runtime_s * 1e3)}ms", self.min_repeat,
            self.log2_card_r, self.log2_card_s, self.skew, self.t,
            self.fk_max, self.num_dv_sa, self.b)

    # -- plans ---------------------------------------------------------------

    def run(self):
        self.timers.start("run")
        self.csv.write_fields(*_CSV_HEADER).newline()
        if "scr" in self.plans:
            self._run_scan_plan("scr", self._rk)
        if "scs" in self.plans:
            self._run_scan_plan("scs", self._sa)
        nb_r = max(self.card_r // self.b, 1)      # build on key side: #dv = |R|
        nb_s = max(self.num_dv_sa // self.b, 1)   # build on FK side: #dv(S.a)

        # Two-phase compacted host builds (ops.chaining/nested.build_*_host).
        # The harness knows each build side's exact distinct-key count (R.k is
        # a permutation; #dv(S.a) comes from generation), so the builds run
        # sync-free: no device->host round trip inside the timed build strand.
        from ..ops.chaining import build_chaining_host
        from ..ops.nested import build_nested_host

        # S.a lives in [0, fkMax) by construction (main_experiment1.cc:190),
        # so S-side tables also get the one-gather dense key-domain index.
        # ee=False skips the early-exit chain-position index for tables only
        # probed without IsBuildKeyUnique (plan Crs).
        def chaining_build(nb, nk, dense=False, dom=None, ee=True):
            return lambda keys: build_chaining_host(
                keys, nb, dense_direct=dense, n_keys=nk, key_domain=dom,
                early_exit_index=ee)

        def nested_build(nb, nk, dense=False, dom=None):
            return lambda keys: build_nested_host(
                keys, nb, dense_direct=dense, n_keys=nk, key_domain=dom)
        # Adaptive physical layout: R.k is a dense permutation by construction
        # (main_experiment1.cc:425-428), enabling the one-gather direct probe.
        from ..ops.chaining import can_use_dense_direct
        dd_r = can_use_dense_direct(np.asarray(self._rk), nb_r)

        def host_route(n_build, n_probe, n_out):
            return self._backend_for_plan(n_build, n_probe, n_out) == "host"

        # Sorted-probe strands (ops/strands_windowed.py) are the device path
        # wherever their table layout exists.
        from ..ops.strands_windowed import (
            direct_probe_strand_sorted, keydirect_chaining_strand_sorted,
            keydirect_nested_strand_sorted)

        if "Csr" in self.plans:
            if host_route(self.card_r, self.card_s, self.card_s):
                self._run_join_plan_host("Csr", self._rk, self._sa, nb_r,
                                         "chaining", "R", "S", False,
                                         unique=True)
            elif dd_r:
                self._run_join_plan(
                    "Csr", self._rk, self._sa, nb_r,
                    chaining_build(nb_r, self.card_r, dd_r),
                    lambda t, p: direct_probe_strand_sorted(t, p,
                                                            unique=True),
                    "chaining", "R", "S", has_unnest=False)
            else:
                self._run_join_plan(
                    "Csr", self._rk, self._sa, nb_r,
                    chaining_build(nb_r, self.card_r, dd_r),
                    lambda t, p: _chaining_probe_strand(t, p, self.card_s,
                                                        True),
                    "chaining", "R", "S", has_unnest=False)
        if "CsrUU" in self.plans:
            if host_route(self.card_r, self.card_s, self.card_s):
                self._run_join_plan_host("CsrUU", self._rk, self._sa, nb_r,
                                         "chaining", "R", "S", False)
            elif dd_r:
                def _build_uu(keys):
                    return build_chaining_host(
                        keys, nb_r, dense_direct=True, n_keys=self.card_r,
                        full_chain_index=True)
                self._run_join_plan(
                    "CsrUU", self._rk, self._sa, nb_r, _build_uu,
                    lambda t, p: direct_probe_strand_sorted(t, p,
                                                            unique=False),
                    "chaining", "R", "S", has_unnest=False)
            else:
                self._run_join_plan(
                    "CsrUU", self._rk, self._sa, nb_r,
                    chaining_build(nb_r, self.card_r, dd_r),
                    lambda t, p: _chaining_probe_strand(t, p, self.card_s,
                                                        False),
                    "chaining", "R", "S", has_unnest=False)
        if "Crs" in self.plans:
            if host_route(self.card_s, self.card_r, self.card_s):
                self._run_join_plan_host("Crs", self._sa, self._rk, nb_s,
                                         "chaining", "S", "R", False)
            else:
                self._run_join_plan(
                    "Crs", self._sa, self._rk, nb_s,
                    chaining_build(nb_s, self.num_dv_sa, dom=self.fk_max,
                                   ee=False),
                    lambda t, p: keydirect_chaining_strand_sorted(
                        t, p, self.card_s, probes_permutation=dd_r),
                    "chaining", "S", "R", has_unnest=False)
        if "Nsr" in self.plans:
            if host_route(self.card_r, self.card_s, self.card_s):
                self._run_join_plan_host("Nsr", self._rk, self._sa, nb_r,
                                         "nested", "R", "S", True)
            elif dd_r:
                self._run_join_plan(
                    "Nsr", self._rk, self._sa, nb_r,
                    nested_build(nb_r, self.card_r, dd_r),
                    lambda t, p: direct_probe_strand_sorted(t, p,
                                                            nested=True),
                    "nested", "R", "S", has_unnest=True)
            else:
                self._run_join_plan(
                    "Nsr", self._rk, self._sa, nb_r,
                    nested_build(nb_r, self.card_r, dd_r),
                    lambda t, p: _nested_probe_strand(t, p, self.card_s),
                    "nested", "R", "S", has_unnest=True)
        if "Nrs" in self.plans:
            if host_route(self.card_s, self.card_r, self.card_s):
                self._run_join_plan_host("Nrs", self._sa, self._rk, nb_s,
                                         "nested", "S", "R", True)
            else:
                self._run_join_plan(
                    "Nrs", self._sa, self._rk, nb_s,
                    nested_build(nb_s, self.num_dv_sa, dom=self.fk_max),
                    lambda t, p: keydirect_nested_strand_sorted(
                        t, p, self.card_s, do_unnest=True,
                        probes_permutation=dd_r),
                    "nested", "S", "R", has_unnest=True)
        if "NrsNU" in self.plans:
            if host_route(self.card_s, self.card_r, 0):
                self._run_join_plan_host("NrsNU", self._sa, self._rk, nb_s,
                                         "nested", "S", "R", False,
                                         unnest=False)
            else:
                self._run_join_plan(
                    "NrsNU", self._sa, self._rk, nb_s,
                    nested_build(nb_s, self.num_dv_sa, dom=self.fk_max),
                    lambda t, p: keydirect_nested_strand_sorted(
                        t, p, 1, do_unnest=False,
                        probes_permutation=dd_r),
                    "nested", "S", "R", has_unnest=False)

        # --- *Sel plans: selection pushed under the probe ------------------
        # The reference DECLARES CsrSel/CrsSel/NrsSel but never implements
        # them (main_experiment1.cc:107-110, 275-280: commented-out enum
        # bits and name-map rows).  We define them as the obvious reading
        # -- the probe side passes a selection first (AlgSelection
        # semantics, models/algebra.py) -- with the predicate
        # ``attr < probe_domain / 2``; the strand's ``mask`` machinery
        # makes unselected rows neither probe nor count comparisons.
        # Device-only (the native host ABI has no filtered-probe entry).
        def _sel_mask(dom_half):
            return lambda p: p < jnp.uint32(dom_half)

        if "CsrSel" in self.plans:
            assert dd_r, "CsrSel needs the dense-direct layout (R.k dense)"
            sel = _sel_mask(max(self.fk_max // 2, 1))
            self._run_join_plan(
                "CsrSel", self._rk, self._sa, nb_r,
                chaining_build(nb_r, self.card_r, dd_r),
                jax.jit(lambda t, p: _with_sel_count(
                    direct_probe_strand_sorted(t, p, unique=True,
                                               mask=sel(p)), sel(p))),
                "chaining", "R", "S", has_unnest=False)
        if "CrsSel" in self.plans:
            sel = _sel_mask(max(self.card_r // 2, 1))
            self._run_join_plan(
                "CrsSel", self._sa, self._rk, nb_s,
                chaining_build(nb_s, self.num_dv_sa, dom=self.fk_max,
                               ee=False),
                jax.jit(lambda t, p: _with_sel_count(
                    keydirect_chaining_strand_sorted(
                        t, p, self.card_s, mask=sel(p)), sel(p))),
                "chaining", "S", "R", has_unnest=False)
        if "NrsSel" in self.plans:
            sel = _sel_mask(max(self.card_r // 2, 1))
            self._run_join_plan(
                "NrsSel", self._sa, self._rk, nb_s,
                nested_build(nb_s, self.num_dv_sa, dom=self.fk_max),
                jax.jit(lambda t, p: _with_sel_count(
                    keydirect_nested_strand_sorted(
                        t, p, self.card_s, do_unnest=True, mask=sel(p)),
                    sel(p))),
                "nested", "S", "R", has_unnest=True)
        self.timers.stop("run")
