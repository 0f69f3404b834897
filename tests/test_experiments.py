"""Differential tests: experiment pipelines vs reference binaries' CSVs.

The reference's own correctness strategy is plan-vs-plan redundancy and
analytic cardinalities (SURVEY.md section 4); here we go further and diff
every counter and hash-table-shape column of the measurement CSV against
golden CSVs captured from the reference binaries (tests/golden/csv/), plus a
result-set equality check against a numpy oracle join.
"""

import csv
import io
from pathlib import Path

import numpy as np
import pytest

from hashjoin3d_tpu.models.exp1 import Experiment1
from hashjoin3d_tpu.models.exp4 import Experiment4
from hashjoin3d_tpu.utils import exp1_data

GOLDEN = Path(__file__).parent / "golden" / "csv"

# columns whose values must be bit-equal (times/reps legitimately differ)
_VALUE_COLS = lambda h: [
    i for i, c in enumerate(h)
    if c.startswith("c_") or c.startswith("card") or c in (
        "plan", "ht_impl", "build", "probe", "ht_buckets", "ht_fracEmpty",
        "cc0_avg", "cc0_min", "cc0_max", "cc1_avg", "cc1_min", "cc1_max",
        "fkMax", "numDvSa", "log2CardR", "log2CardS", "skew", "t", "b",
        "a", "aM", "bM",
    )
]


def _load(path_or_str):
    if isinstance(path_or_str, Path):
        text = path_or_str.read_text()
    else:
        text = path_or_str
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], rows[1:]


def _diff(ref_hdr, ref_rows, got_hdr, got_rows, plan_col):
    assert ref_hdr == got_hdr
    refd = {r[plan_col]: r for r in ref_rows}
    gotd = {r[plan_col]: r for r in got_rows}
    assert set(refd) == set(gotd)
    cols = _VALUE_COLS(ref_hdr)
    mismatches = []
    for plan, r in refd.items():
        g = gotd[plan]
        for i in cols:
            if i < len(r) and i < len(g) and r[i] != g[i]:
                mismatches.append((plan, ref_hdr[i], r[i], g[i]))
    assert not mismatches, mismatches


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("golden,params", [
    ("e1_R6_S8_uni_t0.csv", dict(log2_card_r=6, log2_card_s=8, skew=False,
                                 t=0, b=1)),
    ("e1_R7_S9_zipf_t2_b2.csv", dict(log2_card_r=7, log2_card_s=9, skew=True,
                                     t=2, b=2)),
])
def test_exp1_csv_matches_reference(golden, params, backend):
    if backend == "host":
        from hashjoin3d_tpu.hostengine import native_engine
        if native_engine() is None:
            pytest.skip("no native toolchain")
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, backend=backend)
    exp.init()
    exp.run()
    _diff(*_load(GOLDEN / golden), *_load(buf.getvalue()), plan_col=9)


@pytest.mark.parametrize("backend", ["device", "host"])
@pytest.mark.parametrize("golden,params", [
    ("e4_R6_a2_A2_b3_B2.csv", dict(log2_card_r=6, alpha=2, mult_alpha=2,
                                   beta=3, mult_beta=2)),
    ("e4_R8_a3_A3_b2_B1.csv", dict(log2_card_r=8, alpha=3, mult_alpha=3,
                                   beta=2, mult_beta=1)),
])
def test_exp4_csv_matches_reference(golden, params, backend):
    if backend == "host":
        from hashjoin3d_tpu.hostengine import native_engine
        if native_engine() is None:
            pytest.skip("no native toolchain")
    buf = io.StringIO()
    exp = Experiment4(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, backend=backend)
    exp.init()
    exp.run()
    _diff(*_load(GOLDEN / golden), *_load(buf.getvalue()), plan_col=10)


def test_experiment_outputs_device_equal_host():
    """``Experiment1.outputs`` keeps each plan's last probe output: the
    device strands' (probe_row, build_row) multisets and CSV value columns
    equal the native host engine's on the same generated data."""
    from hashjoin3d_tpu.hostengine import native_engine
    if native_engine() is None:
        pytest.skip("native host engine unavailable (no g++)")
    plans = ["Csr", "CsrUU", "Crs", "Nsr", "Nrs"]
    runs = {}
    for backend in ("device", "host"):
        buf = io.StringIO()
        exp = Experiment1(log2_card_r=6, log2_card_s=9, skew=False, t=1,
                          b=1, measure_file=buf, min_runtime_s=0.0,
                          min_repeat=1, trace=False, backend=backend,
                          plans=plans)
        exp.init()
        exp.run()
        runs[backend] = (exp.outputs, buf.getvalue())
    dev, host = runs["device"][0], runs["host"][0]
    assert sorted(dev) == sorted(host) == sorted(plans)
    for name in plans:
        d = {k: np.asarray(v) for k, v in dev[name].items()}
        v = d["probe_row"] >= 0
        got = sorted(zip(d["probe_row"][v].tolist(),
                         d["build_row"][v].tolist()))
        want = sorted(zip(host[name][0].tolist(), host[name][1].tolist()))
        assert got == want, name
    _diff(*_load(runs["host"][1]), *_load(runs["device"][1]), plan_col=9)


def test_exp1_result_set_vs_numpy_oracle():
    """Materialized join rows equal the true join as a multiset (exp1 data)."""
    from hashjoin3d_tpu.models.exp1 import (
        _chaining_probe_strand, _nested_probe_strand)
    from hashjoin3d_tpu.ops import build_chaining, build_nested

    rk, sa, ndv = exp1_data(6, 8, False, 1)
    want = sorted(
        (int(s_row), int(a)) for s_row, a in enumerate(sa)
        if a in set(rk.tolist()))
    # Csr: probe S into R-table; pair = (s_row, R.k[r_row]) with R.k[r]==S.a
    tbl = build_chaining(rk, 64)
    out = _chaining_probe_strand(tbl, sa, 1 << 8, True)
    got = sorted(
        (int(p), int(rk[b]))
        for p, b in zip(np.asarray(out["probe_row"]), np.asarray(out["build_row"]))
        if p >= 0)
    assert got == want

    # Nrs direction: probe R into S-table; pairs (r_row -> key, s_row)
    tbl2 = build_nested(sa, max(ndv, 1))
    out2 = _nested_probe_strand(tbl2, rk, 1 << 8)
    got2 = sorted(
        (int(b), int(rk[p]))
        for p, b in zip(np.asarray(out2["probe_row"]), np.asarray(out2["build_row"]))
        if p >= 0)
    assert got2 == want

    # plan-vs-plan redundancy: identical totals (SURVEY.md section 4.5)
    assert int(out["total"]) == int(out2["total"]) == len(want)


def test_exp1_sel_plans_vs_numpy_oracle():
    """The *Sel plans (the reference's declared-only selection variants,
    main_experiment1.cc:107-110, defined here as probe-side selection
    ``attr < domain/2``): counters and result CSV fields must match a
    numpy oracle of filter-then-join, and c_selProbe must record the
    selection's output cardinality."""
    from tests.oracle import ChainingOracle, NestedOracle

    params = dict(log2_card_r=6, log2_card_s=8, skew=False, t=0, b=1)
    buf = io.StringIO()
    exp = Experiment1(**params, measure_file=buf, min_runtime_s=0.0,
                      min_repeat=1, trace=False, backend="device",
                      plans=["CsrSel", "CrsSel", "NrsSel"])
    exp.init()
    exp.run()
    hdr, rows = _load(buf.getvalue())
    got = {r[hdr.index("plan")]: r for r in rows}
    assert set(got) == {"CsrSel", "CrsSel", "NrsSel"}
    col = {c: hdr.index(c) for c in ("c_selProbe", "c_htProbe",
                                     "c_htProbeCmp", "c_unnest", "c_top",
                                     "c_scanProbe")}
    rk, sa, ndv = exp1_data(6, 8, False, 0)
    nb_r = max(exp.card_r // exp.b, 1)
    nb_s = max(exp.num_dv_sa // exp.b, 1)

    # CsrSel: build R, probe selected S (a < fkMax/2)
    sel_s = sa[sa < exp.fk_max // 2]
    _, m, c = ChainingOracle(rk, nb_r).probe(sel_s, unique=True)
    r = got["CsrSel"]
    assert int(r[col["c_scanProbe"]]) == sa.size
    assert int(r[col["c_selProbe"]]) == sel_s.size
    assert int(r[col["c_htProbe"]]) == m
    assert int(r[col["c_htProbeCmp"]]) == c

    # CrsSel: build S, probe selected R (k < |R|/2), full-chain walk
    sel_r = rk[rk < 32]
    _, m2, c2 = ChainingOracle(sa, nb_s).probe(sel_r)
    r = got["CrsSel"]
    assert int(r[col["c_selProbe"]]) == sel_r.size == 32
    assert int(r[col["c_htProbe"]]) == m2
    assert int(r[col["c_htProbeCmp"]]) == c2

    # NrsSel: nested build S, probe selected R, + unnest
    nested, m3, c3 = NestedOracle(sa, nb_s).probe(sel_r)
    r = got["NrsSel"]
    assert int(r[col["c_selProbe"]]) == 32
    assert int(r[col["c_htProbe"]]) == m3
    assert int(r[col["c_htProbeCmp"]]) == c3
    n_unnest = len(NestedOracle(sa, nb_s).unnest(nested))
    assert int(r[col["c_unnest"]]) == n_unnest
    assert int(r[col["c_top"]]) == n_unnest


def test_exp4_result_set_vs_numpy_oracle():
    """Ndu and Chj produce the same triples, equal to the numpy oracle."""
    from hashjoin3d_tpu.models.exp4 import _chj_probe_strand, _ndu_probe_strand
    from hashjoin3d_tpu.ops import build_chaining, build_nested
    from hashjoin3d_tpu.utils import exp4_data

    exp = Experiment4(6, 2, 2, 3, 2, plans=("none",))
    sa, ta = exp4_data(6, 2, 2, 3, 2)
    rk = np.arange(64, dtype=np.uint32)
    ndv = exp.num_fk_common + exp.num_fk_exclusive

    want = sorted(
        (int(k), int(si), int(ti))
        for k in rk
        for si in np.nonzero(sa == k)[0]
        for ti in np.nonzero(ta == k)[0])

    def triples(out):
        return sorted(
            (int(r), int(s), int(t))
            for r, s, t in zip(np.asarray(out["r_row"]), np.asarray(out["s_row"]),
                               np.asarray(out["t_row"]))
            if r >= 0)

    c1, c2 = exp.calc_join_card1(), exp.calc_join_card2()
    ndu = _ndu_probe_strand(build_nested(sa, ndv), build_nested(ta, ndv), rk,
                            c2 // 2, c2)
    chj = _chj_probe_strand(build_chaining(sa, ndv), build_chaining(ta, ndv),
                            rk, c1, c2)
    assert triples(ndu) == want
    assert triples(chj) == want
    assert int(ndu["c_top"]) == c2 == len(want)


def test_exp4_nnu_plan():
    """Nnu: 3D joins without unnesting; one nested tuple per surviving R row.

    The reference declares Nnu but never implements it; semantics follow
    exp-1's NrsNU (nested tuples straight to top).
    """
    from hashjoin3d_tpu.models.exp4 import _nnu_probe_strand
    from hashjoin3d_tpu.ops import build_nested
    from hashjoin3d_tpu.utils import exp4_data

    exp = Experiment4(6, 2, 2, 3, 2, plans=("Nnu",))
    assert exp.plans == {"Nnu"}
    sa, ta = exp4_data(6, 2, 2, 3, 2)
    rk = np.arange(64, dtype=np.uint32)
    ndv = exp.num_fk_common + exp.num_fk_exclusive

    out = _nnu_probe_strand(build_nested(sa, ndv), build_nested(ta, ndv), rk)
    # exactly the alpha-common keys have partners in BOTH S and T
    assert int(out["c_top"]) == exp.num_fk_common
    g_s, g_t = np.asarray(out["g_s"]), np.asarray(out["g_t"])
    hits = g_s >= 0
    assert hits.sum() == exp.num_fk_common
    assert np.array_equal(hits, g_t >= 0)
    # probe counters: RS probe matches every key present in S
    assert int(out["c_probe_RS"]) == exp.num_fk_common + exp.num_fk_exclusive

    # end-to-end through the harness (CSV written, counters sane)
    import io
    buf = io.StringIO()
    e2 = Experiment4(6, 2, 2, 3, 2, plans=("Nnu",), measure_file=buf,
                     min_runtime_s=0.0, min_repeat=1, trace=False)
    e2.init()
    e2.run()
    rows = [r.split(";") for r in buf.getvalue().strip().splitlines()]
    assert rows[1][10] == "Nnu"
    assert int(rows[1][-1]) == exp.num_fk_common
