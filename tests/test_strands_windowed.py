"""Sorted-probe strands vs the reference-pinned baseline strands.

The baseline strands (models.exp1/exp4) are pinned bit-equal to the
reference binaries by the CSV differential tests; the sorted strands must
reproduce their counters exactly and their result sets as multisets.
"""

import jax
import numpy as np
import pytest

from hashjoin3d_tpu.ops.chaining import build_chaining_host
from hashjoin3d_tpu.ops.layout import safe_lookup
from hashjoin3d_tpu.ops.nested import build_nested_host
from hashjoin3d_tpu.ops.strands_windowed import (
    chj_strand_sorted, direct_probe_strand_sorted,
    keydirect_nested_strand_sorted, ndu_strand_sorted)


def _pairs(prow, brow, valid=None):
    prow, brow = np.asarray(prow), np.asarray(brow)
    if valid is None:
        valid = prow >= 0
    else:
        valid = np.asarray(valid)
    return sorted(zip(prow[valid].tolist(), brow[valid].tolist()))


def test_safe_lookup_gather_fallback():
    """Unsorted keys with misses (negative and past the table)."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    vals = rng.integers(1, 2**31, 8192, dtype=np.uint32)
    keys = rng.integers(-10, 8192, 4096).astype(np.int32)  # unsorted + misses
    got = np.asarray(safe_lookup(jnp.asarray(vals), jnp.asarray(keys)))
    want = np.where((keys >= 0) & (keys < 8192), vals[np.clip(keys, 0, 8191)], 0)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("unique", [True, False])
def test_direct_probe_strand_sorted(unique):
    from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand

    rng = np.random.default_rng(1)
    n, P = 4096, 16384
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 64, P, dtype=np.uint32)  # some out-of-range

    tbl = build_chaining_host(bk, n, dense_direct=True, n_keys=n,
                              full_chain_index=not unique)
    base = jax.device_get(_chaining_probe_strand(tbl, pk, P, unique))
    got = jax.device_get(direct_probe_strand_sorted(tbl, pk, unique=unique))
    assert int(got["c_htProbe"]) == int(base["c_htProbe"])
    assert int(got["c_htProbeCmp"]) == int(base["c_htProbeCmp"])
    assert int(got["total"]) == int(base["total"])
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        base["probe_row"], base["build_row"])


def test_direct_nested_strand_sorted():
    from hashjoin3d_tpu.models.exp1 import _nested_probe_strand

    rng = np.random.default_rng(2)
    n, P = 4096, 16384
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 64, P, dtype=np.uint32)
    tbl = build_nested_host(bk, n, dense_direct=True, n_keys=n)
    base = jax.device_get(_nested_probe_strand(tbl, pk, P))
    got = jax.device_get(direct_probe_strand_sorted(tbl, pk, nested=True))
    for k in ("c_htProbe", "c_htProbeCmp", "c_unnest", "total"):
        assert int(got[k]) == int(base[k]), k
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        base["probe_row"], base["build_row"])


@pytest.mark.parametrize("do_unnest", [True, False])
def test_keydirect_nested_strand_sorted(do_unnest):
    from hashjoin3d_tpu.models.exp1 import (
        _nested_probe_strand, _nested_probe_strand_nounnest)

    rng = np.random.default_rng(3)
    dom, P = 1024, 8192          # FK domain; probes = permutation of [0, P)
    bk = rng.integers(0, dom, 16384, dtype=np.uint32)   # duplicate-heavy
    pk = rng.permutation(P).astype(np.uint32)           # R.k-like
    ndv = int(np.unique(bk).size)
    tbl = build_nested_host(bk, ndv, n_keys=ndv, key_domain=dom)

    if do_unnest:
        out_size = 32768
        base = jax.device_get(_nested_probe_strand(tbl, pk, out_size))
        got = jax.device_get(keydirect_nested_strand_sorted(
            tbl, pk, out_size, do_unnest=True))
        for k in ("c_htProbe", "c_htProbeCmp", "c_unnest", "total"):
            assert int(got[k]) == int(base[k]), k
        assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
            base["probe_row"], base["build_row"])
    else:
        base = jax.device_get(_nested_probe_strand_nounnest(tbl, pk))
        got = jax.device_get(keydirect_nested_strand_sorted(
            tbl, pk, 1, do_unnest=False))
        for k in ("c_htProbe", "c_htProbeCmp", "c_top"):
            assert int(got[k]) == int(base[k]), k
        # nested tuples as multisets of (probe_row, group)
        bg, bh = np.asarray(base["nested_g"]), np.asarray(base["nested_hit"])
        want = sorted((int(i), int(g)) for i, (g, h)
                      in enumerate(zip(bg, bh)) if h)
        gg = np.asarray(got["nested_g"])
        gh = np.asarray(got["nested_hit"])
        gp = np.asarray(got["nested_probe_row"])
        have = sorted((int(p), int(g)) for p, g, h in zip(gp, gg, gh) if h)
        assert have == want


def test_exp4_strands_sorted_match_device():
    from hashjoin3d_tpu.models.exp4 import (
        Experiment4, _chj_probe_strand, _ndu_probe_strand)
    from hashjoin3d_tpu.utils import exp4_data

    e = Experiment4(10, 2, 3, 3, 2, plans=("none",))
    sa, ta = exp4_data(10, 2, 3, 3, 2)
    rk = np.arange(e.card_r, dtype=np.uint32)
    ndv = e.num_fk_common + e.num_fk_exclusive
    dom = e.num_fk_common + 2 * e.num_fk_exclusive
    out1 = max(e.calc_join_card2() // e.mult_alpha, 1)
    out2 = max(e.calc_join_card2(), 1)

    ts = build_nested_host(sa, ndv, n_keys=ndv, key_domain=dom)
    tt = build_nested_host(ta, ndv, n_keys=ndv, key_domain=dom)
    base = jax.device_get(_ndu_probe_strand(ts, tt, rk, out1, out2))
    got = jax.device_get(ndu_strand_sorted(ts, tt, rk, out1, out2))
    for k in ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp",
              "c_unnest_1", "c_unnest_2"):
        assert int(got[k]) == int(base[k]), k
    want = sorted((int(r), int(s), int(t)) for r, s, t in
                  zip(base["r_row"], base["s_row"], base["t_row"]) if r >= 0)
    have = sorted((int(r), int(s), int(t)) for r, s, t, v in
                  zip(got["r_row"], got["s_row"], got["t_row"], got["valid"])
                  if v)
    assert have == want

    cs = build_chaining_host(sa, ndv, n_keys=ndv, key_domain=dom)
    ct = build_chaining_host(ta, ndv, n_keys=ndv, key_domain=dom)
    base2 = jax.device_get(_chj_probe_strand(
        cs, ct, rk, max(e.calc_join_card1(), 1), out2))
    got2 = jax.device_get(chj_strand_sorted(
        cs, ct, rk, max(e.calc_join_card1(), 1), out2))
    for k in ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp",
              "c_top"):
        assert int(got2[k]) == int(base2[k]), k
    want2 = sorted((int(r), int(s), int(t)) for r, s, t in
                   zip(base2["r_row"], base2["s_row"], base2["t_row"])
                   if r >= 0)
    have2 = sorted((int(r), int(s), int(t)) for r, s, t in
                   zip(got2["r_row"], got2["s_row"], got2["t_row"])
                   if r >= 0)
    assert have2 == want2


def test_keydirect_chaining_strand_sorted():
    from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand
    from hashjoin3d_tpu.ops.strands_windowed import (
        keydirect_chaining_strand_sorted)

    rng = np.random.default_rng(5)
    dom, P = 1024, 8192
    bk = rng.integers(0, dom, 16384, dtype=np.uint32)
    pk = rng.permutation(P).astype(np.uint32)
    ndv = int(np.unique(bk).size)
    tbl = build_chaining_host(bk, ndv, n_keys=ndv, key_domain=dom,
                              early_exit_index=False)
    out_size = 65536
    base = jax.device_get(_chaining_probe_strand(tbl, pk, out_size, False))
    got = jax.device_get(keydirect_chaining_strand_sorted(tbl, pk, out_size))
    for k in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(got[k]) == int(base[k]), k
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        base["probe_row"], base["build_row"])


@pytest.mark.parametrize("wide", [False, True])
def test_merged_nested_strand_sorted(wide):
    """Merged (sort-merge, index-free) nested strand == probe_nested+unnest
    on sparse u32 domains and on u64 keys (hi/lo-plane sort)."""
    from hashjoin3d_tpu.ops.nested import probe_nested, unnest
    from hashjoin3d_tpu.ops.strands_windowed import (
        merged_nested_strand_sorted)

    rng = np.random.default_rng(11)
    n, P = 16384, 8192
    if wide:
        hi = rng.integers(0, 3, n).astype(np.uint64) << np.uint64(40)
        bk = (hi | rng.integers(0, 1024, n).astype(np.uint64))
        pk = ((rng.integers(0, 3, P).astype(np.uint64) << np.uint64(40))
              | rng.integers(0, 1100, P).astype(np.uint64))  # some misses
    else:
        # sparse domain: values up to 2^30 -- no key_direct possible
        bk = (rng.integers(0, 1024, n, dtype=np.uint32) * 1048573 + 7
              ).astype(np.uint32)
        pk = (rng.integers(0, 1100, P, dtype=np.uint32) * 1048573 + 7
              ).astype(np.uint32)
    ndv = int(np.unique(bk).size)
    tbl = build_nested_host(bk, ndv, n_keys=ndv)
    assert tbl.key_direct is None and tbl.direct is None

    res = probe_nested(tbl, pk)
    total = int(np.sum(np.asarray(jax.device_get(res.group_len))))
    prow, brow, valid, _ = unnest(tbl, res, max(1, total))
    got = jax.device_get(merged_nested_strand_sorted(
        tbl, pk, max(1, total)))
    assert int(got["c_htProbe"]) == int(res.num_matches)
    assert int(got["c_htProbeCmp"]) == int(res.num_cmps)
    assert int(got["c_unnest"]) == total
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        prow, brow, valid)

    pre = jax.device_get(merged_nested_strand_sorted(
        tbl, pk, 1, do_unnest=False))
    assert int(pre["c_expand_total"]) == total
    assert int(pre["c_htProbe"]) == int(res.num_matches)
    assert int(pre["c_htProbeCmp"]) == int(res.num_cmps)


@pytest.mark.parametrize("wide,unique", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_merged_chaining_strand_sorted(wide, unique):
    """Merged chaining strand == probe_chaining+materialize on sparse/u64."""
    from hashjoin3d_tpu.ops.chaining import (
        materialize_chaining_join, probe_chaining)
    from hashjoin3d_tpu.ops.strands_windowed import (
        merged_chaining_strand_sorted)

    rng = np.random.default_rng(13)
    n, P = 8192, 8192
    if unique:
        base_keys = rng.permutation(1 << 20)[:n].astype(np.uint32)
    else:
        base_keys = rng.integers(0, 1024, n, dtype=np.uint32) * 65521 + 3
    if wide:
        bk = base_keys.astype(np.uint64) | (np.uint64(5) << np.uint64(40))
        pk = (rng.choice(base_keys, P).astype(np.uint64)
              | (np.uint64(5) << np.uint64(40)))
        pk[::7] ^= np.uint64(1) << np.uint64(50)   # misses
    else:
        bk = base_keys.astype(np.uint32)
        pk = rng.choice(base_keys, P).astype(np.uint32)
        pk[::7] += 1                               # misses
    ndv = int(np.unique(bk).size)
    tbl = build_chaining_host(bk, ndv, n_keys=ndv)
    assert tbl.key_direct is None and tbl.direct is None

    res = probe_chaining(tbl, pk, unique=unique)
    total = int(res.num_matches)
    prow, brow, valid, _ = materialize_chaining_join(
        tbl, res, max(1, total), unique=unique)
    got = jax.device_get(merged_chaining_strand_sorted(
        tbl, pk, max(1, total), unique=unique))
    assert int(got["c_htProbe"]) == total
    assert int(got["c_htProbeCmp"]) == int(res.num_cmps)
    assert int(got["total"]) == total
    assert _pairs(got["probe_row"], got["build_row"]) == _pairs(
        prow, brow, valid)

    pre = jax.device_get(merged_chaining_strand_sorted(
        tbl, pk, 1, unique=unique, do_expand=False))
    assert int(pre["c_htProbe"]) == total
    assert int(pre["c_htProbeCmp"]) == int(res.num_cmps)


# -- the gather on the strands' stream shapes --------------------------------


def test_route_codes_surface_per_strand():
    """safe_lookup on the three stream shapes the strands produce -- fully
    sorted, segment-restarting with a misaligned wrap, fully random --
    equals the numpy gather."""
    import jax.numpy as jnp

    rng = np.random.default_rng(11)
    vals_np = rng.integers(1, 2**31, 1 << 14, dtype=np.uint32)
    vals = jnp.asarray(vals_np)
    seg = 4096
    streams = [
        np.sort(rng.integers(0, 1 << 12, 8192)).astype(np.int32),
        np.concatenate([
            np.sort(rng.integers(0, 1 << 14, seg)).astype(np.int32)[
                np.r_[np.arange(137, seg), np.arange(137)]]
            for _ in range(4)]),
        rng.integers(0, 1 << 14, 1 << 15).astype(np.int32),
    ]
    for ks in streams:
        got = np.asarray(safe_lookup(vals, jnp.asarray(ks)))
        np.testing.assert_array_equal(got, vals_np[ks])


def test_direct_strand_route_is_windowed():
    """The canonical strand shape (scaled down, no misses) equals the
    reference-pinned baseline strand: counters and pair multiset."""
    from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand

    rng = np.random.default_rng(12)
    n, P = 4096, 32768
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n, P, dtype=np.uint32)
    tbl = build_chaining_host(bk, n, dense_direct=True, n_keys=n)
    out = jax.device_get(direct_probe_strand_sorted(tbl, pk, unique=True))
    base = jax.device_get(_chaining_probe_strand(tbl, pk, P, True))
    assert "route_worst" not in out
    for c in ("c_htProbe", "c_htProbeCmp", "total"):
        assert int(out[c]) == int(base[c]), c
    assert _pairs(out["probe_row"], out["build_row"]) == _pairs(
        base["probe_row"], base["build_row"])
