#!/usr/bin/env python
"""Bring-up check of the join engine on one GPU, or on four.

    python chip_smoke.py              # one card, every phase
    python chip_smoke.py --cards 4    # the distributed joins only

One card, at the reference's own data sizes, through the normal entry
points:

1. primitives: the strands' lookup, ``lax.sort`` (global and segmented) and
   the scans against numpy at 2^24 (``tools/roofline.py``), timed beside a
   copy of the same bytes;
2. exp-1, |R| = 2^20, |S| = 2^24: uniform t=0, uniform t=4 and zipf t=0,
   every plan (scr, scs, Csr, CsrUU, Crs, Nsr, Nrs, NrsNU);
3. exp-4, |R| = 2^24, a=4 A=4 b=2 B=2: Ndu and Chj;
4. the ``bench.py`` headline strand (Csr, 2^20 / 2^24);
5. ``hashjoin3d_tpu.join`` above ``HOST_CROSSOVER_ROWS``, nested and
   chaining, 2^22 build rows and 2^24 probe rows.

Phases 2-5 run each plan on the device and on the native C++ host engine
(``hostengine.py``) over the same generated data.  The counters
(c_htProbe, c_htProbeCmp, c_unnest, c_top, the exp-4 counters) and the HT
shape statistics must be bit-equal, and the result row-id tuples equal as
multisets, compared by an order-independent digest (row count plus the
wrapping sum of a 64-bit mix of each tuple).  Everything is integer, so
every comparison is exact.

``--cards 4`` runs every schedule of ``hashjoin3d_tpu.parallel`` -- flat
nested and chaining joins (gather path and ``key_domain=`` path), the ring
with and without prefetch, the chunked join, the 2x2 hierarchical join, the
deferred two-join, filter->join->aggregate and the broadcast and hybrid
skew joins -- at a global 2^22-key build and 2^26 probes against a numpy
oracle on the global data, and checks that the shards sit on 4 distinct
devices.

Any failure raises.  Only when every phase passed does the last line of
standard output read ``{"ok": true, "device": {...}}``.  Exits non-zero when
JAX finds no GPU.
"""

import argparse
import csv
import io
import json
import subprocess
import sys
import time

import numpy as np

#: the experiments' repetition floor: a short window, every plan still
#: runs >= 8 device reps
MIN_TIME_S = 0.05

#: power-limit line of the card, printed before any result
NVSMI = ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"]


def card_line():
    try:
        r = subprocess.run(NVSMI, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"
    return (r.stdout.strip() or r.stderr.strip()).splitlines()[0]


# -- result comparison -------------------------------------------------------

_GOLD = np.uint64(0x9E3779B97F4A7C15)


def _mix(x):
    """splitmix64 finalizer over a uint64 array (wrapping arithmetic)."""
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def digest(*cols):
    """Order-independent multiset digest of the row tuples whose first
    column is >= 0: (count, wrapping sum of mixed tuples, xor of them)."""
    cols = [np.asarray(c).astype(np.int64) for c in cols]
    valid = cols[0] >= 0
    with np.errstate(over="ignore"):
        h = np.zeros(int(valid.sum()), np.uint64)
        for c in cols:
            h = _mix(h ^ (c[valid].astype(np.uint64) + _GOLD))
        return (int(valid.sum()), int(h.sum(dtype=np.uint64)),
                int(np.bitwise_xor.reduce(h)) if h.size else 0)


def _csv_rows(text):
    rows = list(csv.reader(io.StringIO(text), delimiter=";"))
    return rows[0], rows[1:]


def _is_time_col(name):
    return name.startswith("t_") or name in ("reps", "mintime", "minreps")


def compare_csv(dev_text, host_text, plan_col):
    """Every non-timing column of every join-plan row equal; scan rows
    (which omit a column, as the reference's do) compare their count."""
    hdr, dev = _csv_rows(dev_text)
    hdr2, host = _csv_rows(host_text)
    assert hdr == hdr2
    dev = {r[plan_col]: r for r in dev}
    host = {r[plan_col]: r for r in host}
    assert set(dev) == set(host), (sorted(dev), sorted(host))
    bad = []
    for plan, d in dev.items():
        h = host[plan]
        if plan in ("scr", "scs"):
            if d[-1] != h[-1]:
                bad.append((plan, "c_top", d[-1], h[-1]))
            continue
        for i, name in enumerate(hdr):
            if not _is_time_col(name) and d[i] != h[i]:
                bad.append((plan, name, d[i], h[i]))
    assert not bad, f"device and host CSV columns differ: {bad}"
    return hdr, dev


def _ms(row, hdr, name):
    return int(row[hdr.index(name)]) / 1e6


# -- one-card phases ---------------------------------------------------------

def phase_primitives(card):
    sys.path.insert(0, "tools")
    import roofline
    print(f"[primitives vs numpy at 2^24, each beside a copy] {card}")
    roofline.run(mt=MIN_TIME_S)


def _exp1_run(backend, skew, t, min_time_s, min_repeat, log_r, log_s):
    from hashjoin3d_tpu.models.exp1 import Experiment1
    buf = io.StringIO()
    exp = Experiment1(log_r, log_s, skew, t, b=1, measure_file=buf,
                      min_runtime_s=min_time_s, min_repeat=min_repeat,
                      trace=False, backend=backend)
    exp.init()
    exp.run()
    return exp.outputs, buf.getvalue()


def _pairs_digest(out):
    if isinstance(out, dict):          # device strand output
        if "probe_row" not in out:
            return None                # NrsNU: nested tuples, no pairs
        return digest(out["probe_row"], out["build_row"])
    prow, brow = out[0], out[1]        # host engine tuple
    return digest(prow, brow) if len(prow) or out[2] == 0 else None


def phase_exp1(card, min_time_s, log_r=20, log_s=24):
    for skew, t in ((False, 0), (False, 4), (True, 0)):
        label = (f"exp1 R{log_r} S{log_s} {'zipf' if skew else 'uniform'} "
                 f"t={t}")
        t0 = time.perf_counter()
        dev_out, dev_csv = _exp1_run("device", skew, t, min_time_s, 8,
                                     log_r, log_s)
        dev_dig = {k: _pairs_digest(v) for k, v in dev_out.items()}
        del dev_out
        t1 = time.perf_counter()
        host_out, host_csv = _exp1_run("host", skew, t, min_time_s, 1,
                                       log_r, log_s)
        host_dig = {k: _pairs_digest(v) for k, v in host_out.items()}
        del host_out
        hdr, rows = compare_csv(dev_csv, host_csv, plan_col=9)
        for plan, d in dev_dig.items():
            if d is not None and host_dig[plan] is not None:
                assert d == host_dig[plan], (label, plan, d, host_dig[plan])
        print(f"[{label}] device == host: counters, HT stats, "
              f"{sum(d is not None for d in dev_dig.values())} result "
              f"multisets  (device {t1 - t0:.0f} s, host "
              f"{time.perf_counter() - t1:.0f} s wall)  {card}")
        for plan, r in rows.items():
            if plan in ("scr", "scs"):
                continue
            print(f"  {plan:6s} build {_ms(r, hdr, 't_buildStr'):9.3f} ms  "
                  f"probe {_ms(r, hdr, 't_probeStr'):9.3f} ms  "
                  f"total {_ms(r, hdr, 't_total'):9.3f} ms  "
                  f"c_htProbe {r[hdr.index('c_htProbe')]}")


def phase_exp4(card, min_time_s, log_r=24):
    from hashjoin3d_tpu.models.exp4 import Experiment4
    runs = {}
    for backend in ("device", "host"):
        buf = io.StringIO()
        exp = Experiment4(log_r, 4, 4, 2, 2, measure_file=buf,
                          plans=["Ndu", "Chj"], min_runtime_s=min_time_s,
                          min_repeat=8 if backend == "device" else 1,
                          trace=False, backend=backend)
        exp.init()
        exp.run()
        runs[backend] = ({k: digest(v["r_row"], v["s_row"], v["t_row"])
                          for k, v in exp.outputs.items()}, buf.getvalue())
        del exp
    hdr, rows = compare_csv(runs["device"][1], runs["host"][1], plan_col=10)
    for plan, d in runs["device"][0].items():
        assert d == runs["host"][0][plan], (plan, d, runs["host"][0][plan])
    print(f"[exp4 R{log_r} a4 A4 b2 B2] device == host: counters and (r, s, t) "
          f"multisets  {card}")
    for plan, r in rows.items():
        print(f"  {plan}  build S {_ms(r, hdr, 't_build_S'):9.3f} ms  "
              f"build T {_ms(r, hdr, 't_build_T'):9.3f} ms  "
              f"probe {_ms(r, hdr, 't_probe_R'):9.3f} ms  "
              f"total {_ms(r, hdr, 't_total'):9.3f} ms  "
              f"c_top {r[hdr.index('c_top')]}")


def phase_bench(card, min_time_s):
    import bench
    from hashjoin3d_tpu.hostengine import host_chaining_join
    res, out, (rk, sa) = bench.measure(min_time_s)
    op, ob, m, c = host_chaining_join(rk, sa, 1 << bench.LOG2_R, unique=True)
    assert int(out["c_htProbe"]) == m and int(out["c_htProbeCmp"]) == c
    assert digest(out["probe_row"], out["build_row"]) == digest(op, ob)
    print(f"[bench Csr 2^{bench.LOG2_R}/2^{bench.LOG2_S}] device == host; "
          f"{res['value'] / 1e6:.1f} M probes/s, "
          f"{1e3 * (1 << bench.LOG2_S) / res['value']:.3f} ms/strand, "
          f"vs_baseline {res['vs_baseline']:.1f}x, "
          f"sol_pct {res['sol_pct']:.2f}  {card}")


def phase_api(card, log_b=22, log_p=24):
    import hashjoin3d_tpu as hj
    from hashjoin3d_tpu.api import HOST_CROSSOVER_ROWS
    rng = np.random.default_rng(2024)
    nb = 1 << log_b
    bk = rng.integers(0, nb, nb).astype(np.uint32)
    pk = rng.integers(0, nb + nb // 4, 1 << log_p).astype(np.uint32)
    assert bk.size + pk.size >= HOST_CROSSOVER_ROWS
    for how in ("nested", "chaining"):
        t0 = time.perf_counter()
        d = hj.join(bk, pk, how=how)            # auto: above the crossover
        t1 = time.perf_counter()
        h = hj.join(bk, pk, how=how, backend="host")
        t2 = time.perf_counter()
        for f in ("num_matches", "num_cmps", "num_results"):
            assert getattr(d, f) == getattr(h, f), (how, f, getattr(d, f),
                                                    getattr(h, f))
        assert digest(d.probe_rows, d.build_rows) == \
            digest(h.probe_rows, h.build_rows), how
        print(f"[api.join {how} 2^{log_b} x 2^{log_p}] device == host "
              f"({d.num_results} pairs); device {t1 - t0:.2f} s incl. "
              f"compile, host {t2 - t1:.2f} s  {card}")


# -- four cards --------------------------------------------------------------

def _devices_of(arr):
    return {s.device for s in arr.addressable_shards}


def _join_oracle(bk, pk):
    """All (probe_row, build_row) with pk == bk, as numpy arrays."""
    order = np.argsort(bk, kind="stable")
    sbk = bk[order]
    lo = np.searchsorted(sbk, pk, "left")
    cnt = np.searchsorted(sbk, pk, "right") - lo
    prow = np.repeat(np.arange(pk.size, dtype=np.int64), cnt)
    start = np.repeat(lo - np.cumsum(cnt) + cnt, cnt)
    brow = order[start + np.arange(prow.size)]
    return prow, brow, int((cnt > 0).sum())


def phase_cards(n, log_b, log_p):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from hashjoin3d_tpu.parallel import (
        dist_chaining_join, dist_deferred_two_join,
        dist_filter_join_aggregate, dist_nested_join,
        dist_nested_join_2d, dist_nested_join_chunked,
        dist_ring_nested_join, make_mesh, make_mesh_2d, shard_axis)
    from hashjoin3d_tpu.parallel.skew import (
        dist_broadcast_join, dist_hybrid_nested_join)

    assert len(jax.devices()) >= n, f"need {n} devices, have {jax.devices()}"
    mesh = make_mesh(n)
    sh = shard_axis(mesh)
    nb, npr = 1 << log_b, 1 << log_p
    dom = nb                                 # ~1 build row per key
    rng = np.random.default_rng(7)
    bk = rng.integers(0, dom, nb).astype(np.uint32)
    pk = rng.integers(0, dom, npr).astype(np.uint32)
    prow_o, brow_o, matched = _join_oracle(bk, pk)
    want = digest(prow_o, brow_o)
    n_pairs = prow_o.size
    n_keys = int(np.unique(bk).size)
    del prow_o, brow_o
    bkd, pkd = jax.device_put(bk, sh), jax.device_put(pk, sh)
    assert len(_devices_of(pkd)) == n

    # per-(src, dst) exchange blocks and per-shard outputs, with slack
    def cap(x):
        return int(x * 1.1) + 4096
    b_cap, p_cap = cap(nb / n / n), cap(npr / n / n)
    o_cap = cap(n_pairs / n)
    nbps = max(n_keys // n, 1)
    results = {}

    def check(name, out, cnt="num_unnested", rows=True):
        jax.block_until_ready(out)
        assert int(out.get("overflow", 0)) == 0, (name, "overflow")
        assert int(out[cnt]) == n_pairs, (name, int(out[cnt]), n_pairs)
        if rows:
            assert len(_devices_of(out["probe_row"])) == n, name
            got = digest(np.where(np.asarray(out["out_valid"]),
                                  np.asarray(out["probe_row"]), -1),
                         np.asarray(out["build_row"]))
            assert got == want, (name, got, want)
        results[name] = out
        print(f"  {name:34s} ok: {int(out[cnt])} pairs, "
              f"cmps {int(out['num_cmps']) if 'num_cmps' in out else '-'}")

    def timed(name, fn, *args, **kw):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        t1 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        print(f"  {name:34s} first call {t1 - t0:.2f} s, steady "
              f"{1e3 * (time.perf_counter() - t1):.1f} ms")
        check(name, out, **kw)
        return out

    print(f"[{n} cards] build 2^{log_b}, probe 2^{log_p}, {n_pairs} pairs")
    kw = dict(num_buckets_per_shard=nbps, build_capacity=b_cap,
              probe_capacity=p_cap, out_capacity=o_cap)
    nested = timed("flat nested (gather)",
                   dist_nested_join(mesh, **kw), bkd, pkd)
    assert int(nested["num_matches"]) == matched
    chain = timed("flat chaining (gather)", dist_chaining_join(mesh, **kw),
                  bkd, pkd, cnt="num_results")
    fast_n = timed("flat nested (key_domain)", dist_nested_join(
        mesh, key_domain=dom, n_keys=n_keys, **kw), bkd, pkd)
    fast_c = timed("flat chaining (key_domain)", dist_chaining_join(
        mesh, key_domain=dom, n_keys=n_keys, **kw), bkd, pkd,
        cnt="num_results")
    assert int(fast_n["num_matches"]) == matched
    assert int(chain["num_matches"]) == int(fast_c["num_matches"]) == n_pairs
    assert int(fast_n["num_cmps"]) == int(nested["num_cmps"])
    assert int(fast_c["num_cmps"]) == int(chain["num_cmps"])

    ring_kw = dict(num_buckets_per_shard=nbps, build_capacity=b_cap,
                   out_capacity=o_cap)
    ring_g = timed("ring nested (gather)",
                   dist_ring_nested_join(mesh, **ring_kw), bkd, pkd)
    ring_t = timed("ring nested (key_domain, prefetch)",
                   dist_ring_nested_join(mesh, key_domain=dom, n_keys=n_keys,
                                         **ring_kw), bkd, pkd)
    ring_f = timed("ring nested (key_domain, no prefetch)",
                   dist_ring_nested_join(mesh, key_domain=dom, n_keys=n_keys,
                                         prefetch=False, **ring_kw), bkd, pkd)
    assert int(ring_t["num_cmps"]) == int(ring_f["num_cmps"])
    for o in (ring_g, ring_t, ring_f):
        assert int(o["num_matches"]) == matched
    timed("chunked nested (4 chunks)",
          dist_nested_join_chunked(mesh, n_chunks=4,
                                   **dict(kw, probe_capacity=cap(
                                       npr / n / n / 4))), bkd, pkd)

    if n % 2 == 0:
        mesh2 = make_mesh_2d(2, n // 2)
        sh2 = NamedSharding(mesh2, P(("host", "chip")))
        b2, p2 = jax.device_put(bk, sh2), jax.device_put(pk, sh2)
        kw2 = dict(kw, build_capacity=cap(nb / n / (n // 2)),
                   probe_capacity=cap(npr / n / (n // 2)))
        for name, extra in (("hier 2x%d nested (gather)" % (n // 2), {}),
                            ("hier 2x%d nested (key_domain)" % (n // 2),
                             dict(key_domain=dom, n_keys=n_keys))):
            o = timed(name, dist_nested_join_2d(mesh2, **kw2, **extra),
                      b2, p2)
            assert int(o["num_matches"]) == matched
            assert int(o["num_cmps"]) == int(nested["num_cmps"])

    # deferred two-join R -> S -> T (exp-4 Ndu shape): oracle triples
    s_np = rng.integers(0, dom, nb).astype(np.uint32)
    t_np = rng.integers(0, dom, nb).astype(np.uint32)
    cs = np.bincount(s_np, minlength=dom)
    ct = np.bincount(t_np, minlength=dom)
    n_rs = int(cs[pk].sum())
    n_rst = int((cs[pk] * ct[pk]).sum())
    two = dist_deferred_two_join(
        mesh, num_buckets_per_shard=nbps, fk_capacity=b_cap,
        r_capacity=p_cap, out1_capacity=cap(n_rs / n),
        out2_capacity=cap(n_rst / n))
    o = jax.block_until_ready(two(pkd, jax.device_put(s_np, sh),
                                  jax.device_put(t_np, sh)))
    assert int(o["overflow"]) == 0
    assert int(o["c_top"]) == n_rst, ("two-join", int(o["c_top"]), n_rst)
    assert len(_devices_of(o["r_row"])) == n
    r_i, s_i, _ = _join_oracle(s_np, pk)
    pair_i, t_i, _ = _join_oracle(t_np, pk[r_i])
    want3 = digest(r_i[pair_i], s_i[pair_i], t_i)
    del r_i, s_i, pair_i, t_i
    v = np.asarray(o["out_valid"])
    got3 = digest(np.where(v, np.asarray(o["r_row"]), -1),
                  np.asarray(o["s_row"]), np.asarray(o["t_row"]))
    assert got3 == want3, ("two-join", got3, want3)
    print(f"  {'deferred two-join':34s} ok: {n_rst} triples")

    # filter -> join -> aggregate: per-key count and integer sum
    bv = rng.integers(0, 9, nb).astype(np.int32)
    pp = rng.integers(0, 100, npr).astype(np.int32)
    keep = pp < 50
    pipe = dist_filter_join_aggregate(
        mesh, num_buckets_per_shard=nbps, build_capacity=b_cap,
        probe_capacity=p_cap, out_capacity=o_cap,
        predicate=lambda payload: payload < 50)
    o = jax.block_until_ready(pipe(bkd, jax.device_put(bv, sh), pkd,
                                   jax.device_put(pp, sh)))
    assert int(o["overflow"]) == 0
    cnt_k = np.bincount(bk, minlength=dom)
    sum_k = np.bincount(bk, weights=bv, minlength=dom).astype(np.int64)
    pcnt = np.bincount(pk[keep], minlength=dom)
    assert int(o["num_filtered"]) == int(keep.sum())
    assert int(o["num_joined"]) == int((pcnt * cnt_k).sum())
    assert int(o["sum_v"]) == int((pcnt * sum_k).sum())
    gk = np.asarray(o["group_keys"]).astype(np.int64)
    gc = np.asarray(o["group_count"]).astype(np.int64)
    gs = np.asarray(o["group_sum"]).astype(np.int64)
    live = gc > 0
    keys_w = np.flatnonzero(pcnt * cnt_k)
    assert digest(gk[live], gc[live], gs[live]) == digest(
        keys_w, (pcnt * cnt_k)[keys_w], (pcnt * sum_k)[keys_w])
    print(f"  {'filter->join->aggregate':34s} ok: {int(live.sum())} groups")

    # skew: one hot key takes half the probe stream
    bk_s = bk.copy()
    bk_s[bk_s == 7] = 8
    bk_s[0] = 7                                      # exactly one hot row
    pk_s = pk.copy()
    pk_s[: npr // 2] = 7
    prow_o, brow_o, _ = _join_oracle(bk_s, pk_s)
    want_s, n_s = digest(prow_o, brow_o), prow_o.size
    del prow_o, brow_o
    bks, pks = jax.device_put(bk_s, sh), jax.device_put(pk_s, sh)
    for name, fn in (
            ("broadcast skew join", dist_broadcast_join(
                mesh, num_buckets=n_keys, out_capacity=cap(n_s / n))),
            ("hybrid skew join", dist_hybrid_nested_join(
                mesh, hot_keys=[7], num_buckets_per_shard=nbps,
                build_capacity=b_cap, probe_capacity=p_cap,
                hot_build_capacity=64, out_capacity=cap(n_s / n)))):
        o = jax.block_until_ready(fn(bks, pks))
        assert int(o.get("overflow", 0)) == 0, name
        assert int(o["num_unnested"]) == n_s, (name, int(o["num_unnested"]))
        assert len(_devices_of(o["probe_row"])) == n, name
        got = digest(np.where(np.asarray(o["out_valid"]),
                              np.asarray(o["probe_row"]), -1),
                     np.asarray(o["build_row"]))
        assert got == want_s, (name, got, want_s)
        print(f"  {name:34s} ok: {n_s} pairs")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4 = run only the distributed joins on 4 cards")
    args = ap.parse_args(argv)

    card = card_line()
    print(card, flush=True)
    import jax
    print(f"jax.devices(): {jax.devices()}", flush=True)
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: platform is {dev.platform!r}, not 'gpu'",
              file=sys.stderr)
        return 1
    from hashjoin3d_tpu.hostengine import native_engine
    from hashjoin3d_tpu.utils.gen import native_lib
    from hashjoin3d_tpu.utils.misc import enable_compile_cache
    print(f"native data generator: {native_lib() is not None}, "
          f"native host engine: {native_engine() is not None}", flush=True)
    if native_engine() is None:
        print("chip_smoke: the native host engine did not build",
              file=sys.stderr)
        return 1
    enable_compile_cache()

    t0 = time.perf_counter()
    if args.cards == 4:
        phase_cards(4, 22, 26)
    else:
        phase_primitives(card)
        phase_exp1(card, MIN_TIME_S)
        phase_exp4(card, MIN_TIME_S)
        phase_bench(card, MIN_TIME_S)
        phase_api(card)
    print(f"all phases passed in {time.perf_counter() - t0:.0f} s  {card}")
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
