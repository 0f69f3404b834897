"""Native host engine: differential tests vs the python oracle and device engine.

The C++ engine (``native/hj3engine.cpp``) must reproduce the reference's
chain orders and counters exactly; the JAX engine already does (pinned by
the reference-CSV tests), so all three must agree pairwise.
"""

import numpy as np
import pytest

from hashjoin3d_tpu.hostengine import (
    host_chaining_join, host_nested_join, native_engine)
from oracle import ChainingOracle, NestedOracle

pytestmark = pytest.mark.skipif(native_engine() is None,
                                reason="no native toolchain")


def _workloads():
    rng = np.random.default_rng(42)
    yield (rng.integers(0, 50, 200, dtype=np.uint32),
           rng.integers(0, 64, 300, dtype=np.uint32), 16)
    yield (np.full(64, 7, np.uint32),  # one hot key
           np.array([7, 7, 9], np.uint32), 4)
    yield (rng.permutation(256).astype(np.uint32),  # unique keys
           rng.integers(0, 300, 512, dtype=np.uint32), 256)
    yield (np.array([], np.uint32), np.array([3], np.uint32), 8)


@pytest.mark.parametrize("unique", [False, True])
def test_chaining_matches_python_oracle(unique):
    for bk, pk, nb in _workloads():
        orc = ChainingOracle(bk, nb)
        pairs, matches, cmps = orc.probe(pk, unique=unique)
        op, ob, m, c = host_chaining_join(bk, pk, nb, unique=unique)
        assert (m, c) == (matches, cmps)
        # exact emission order, not just multiset: chain order must match
        assert list(zip(op.tolist(), ob.tolist())) == pairs


def test_nested_matches_python_oracle():
    for bk, pk, nb in _workloads():
        orc = NestedOracle(bk, nb)
        nested, matches, cmps = orc.probe(pk)
        expanded = orc.unnest(nested)
        op, ob, m, c, u = host_nested_join(bk, pk, nb)
        assert (m, c, u) == (matches, cmps, len(expanded))
        assert list(zip(op.tolist(), ob.tolist())) == expanded
        # no-unnest variant: counters identical, nothing materialized
        op2, ob2, m2, c2, u2 = host_nested_join(bk, pk, nb, unnest=False)
        assert (m2, c2, u2) == (matches, cmps, len(expanded))
        assert op2.size == 0


@pytest.mark.parametrize("how", ["chaining", "nested"])
def test_host_engine_u64_matches_python_oracle(how):
    """The u64 instantiation (hj3e_*_join64): murmur64 bucketing, chain
    orders and counters vs the oracle; high bits must be distinguished."""
    from hashjoin3d_tpu.hostengine import HostTable
    from hashjoin3d_tpu.ops.hashing import murmur64_np

    rng = np.random.default_rng(31)
    hi = np.uint64(0x5) << np.uint64(40)
    bk = (rng.integers(0, 60, 300).astype(np.uint64) | hi)
    bk[::7] ^= np.uint64(1) << np.uint64(52)  # a second hi-plane
    pk = (rng.integers(0, 80, 500).astype(np.uint64) | hi)

    def hf(k):
        return int(murmur64_np(np.uint64(k)))

    nb = 16
    if how == "chaining":
        orc = ChainingOracle(bk, nb, hashfun=hf)
        for unique in (False, True):
            pairs, matches, cmps = orc.probe(pk, unique=unique)
            op, ob, m, c = host_chaining_join(bk, pk, nb, unique=unique)
            assert (m, c) == (matches, cmps)
            assert list(zip(op.tolist(), ob.tolist())) == pairs
        tbl = HostTable(bk, nb, kind="chaining")
        op2, ob2, m2, c2 = tbl.probe(pk)
        assert list(zip(op2.tolist(), ob2.tolist())) == orc.probe(pk)[0]
    else:
        orc = NestedOracle(bk, nb, hashfun=hf)
        nested, matches, cmps = orc.probe(pk)
        expanded = orc.unnest(nested)
        op, ob, m, c, u = host_nested_join(bk, pk, nb)
        assert (m, c, u) == (matches, cmps, len(expanded))
        assert list(zip(op.tolist(), ob.tolist())) == expanded
        tbl = HostTable(bk, nb, kind="nested")
        op2, ob2, m2, c2, u2 = tbl.probe(pk)
        assert (m2, c2, u2) == (matches, cmps, len(expanded))
    # probing a u32 table with u64 keys must refuse, not truncate
    t32 = HostTable(np.array([1, 2], np.uint32), 2, kind=how)
    with pytest.raises(ValueError, match="truncate"):
        t32.probe(np.array([1], np.uint64))


def test_host_engine_vs_jax_engine_large():
    """At sizes beyond the python oracle, host C++ and device-path JAX engines
    must agree on matches, comparison counts and the result multiset."""
    from hashjoin3d_tpu.ops import build_chaining, build_nested, probe_chaining
    from hashjoin3d_tpu.ops import materialize_chaining_join, probe_nested, unnest

    rng = np.random.default_rng(7)
    n_b, n_p, nb = 20_000, 50_000, 4096
    bk = rng.integers(0, 8_000, n_b, dtype=np.uint32)
    pk = rng.integers(0, 10_000, n_p, dtype=np.uint32)

    op, ob, m, c = host_chaining_join(bk, pk, nb, out_cap=16 * n_p)
    tbl = build_chaining(bk, nb)
    res = probe_chaining(tbl, pk)
    assert int(res.num_matches) == m
    assert int(res.num_cmps) == c
    jp, jb, jv, jt = materialize_chaining_join(tbl, res, 16 * n_p)
    got = sorted(zip(np.asarray(jp)[np.asarray(jv)].tolist(),
                     np.asarray(jb)[np.asarray(jv)].tolist()))
    assert got == sorted(zip(op.tolist(), ob.tolist()))
    assert int(jt) == m

    onp, onb, nm, nc, nu = host_nested_join(bk, pk, nb, out_cap=16 * n_p)
    ntbl = build_nested(bk, nb)
    nres = probe_nested(ntbl, pk)
    assert int(nres.num_matches) == nm
    assert int(nres.num_cmps) == nc
    up, ub, uv, ut = unnest(ntbl, nres, 16 * n_p)
    assert int(ut) == nu
    got_n = sorted(zip(np.asarray(up)[np.asarray(uv)].tolist(),
                       np.asarray(ub)[np.asarray(uv)].tolist()))
    assert got_n == sorted(zip(onp.tolist(), onb.tolist()))


def test_host_engine_overflow():
    bk = np.full(32, 1, np.uint32)
    pk = np.full(8, 1, np.uint32)
    with pytest.raises(ValueError, match="too small"):
        host_chaining_join(bk, pk, 4, out_cap=8)
    with pytest.raises(ValueError, match="too small"):
        host_nested_join(bk, pk, 4, out_cap=8)


def test_host_table_handles_match_one_shot():
    """Prebuilt HostTable probes == one-shot joins (same counters/pairs)."""
    from hashjoin3d_tpu.hostengine import HostTable

    rng = np.random.default_rng(5)
    bk = rng.integers(0, 50, 200, dtype=np.uint32)
    pk = rng.integers(0, 64, 300, dtype=np.uint32)

    ct = HostTable(bk, 16, kind="chaining")
    for unique in (False, True):
        want = host_chaining_join(bk, pk, 16, unique=unique)
        got = ct.probe(pk, unique=unique)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))

    nt = HostTable(bk, 16, kind="nested")
    want = host_nested_join(bk, pk, 16)
    got = nt.probe(pk)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    got2 = nt.probe(pk, unnest=False)
    assert got2[2:] == want[2:] and got2[0].size == 0
    ct.close()
    nt.close()


def test_host_two_join_strands_match_device():
    """Native exp-4 Ndu/Chj strands == device strands (counters + multiset)."""
    import jax
    from hashjoin3d_tpu.hostengine import HostTable, host_two_join_probe
    from hashjoin3d_tpu.models.exp4 import Experiment4
    from hashjoin3d_tpu.utils import exp4_data
    from hashjoin3d_tpu.models.exp4 import _ndu_probe_strand, _chj_probe_strand
    from hashjoin3d_tpu.ops.chaining import build_chaining_host
    from hashjoin3d_tpu.ops.nested import build_nested_host

    e = Experiment4(8, 2, 3, 3, 2, plans=("none",))
    sa, ta = exp4_data(8, 2, 3, 3, 2)
    rk = np.arange(e.card_r, dtype=np.uint32)
    ndv = e.num_fk_common + e.num_fk_exclusive
    out1 = max(e.calc_join_card2() // e.mult_alpha, 1)
    out2 = max(e.calc_join_card2(), 1)

    # Ndu
    hs = HostTable(sa, ndv, kind="nested")
    htb = HostTable(ta, ndv, kind="nested")
    host = host_two_join_probe(hs, htb, rk, out2)
    ts = build_nested_host(sa, ndv, n_keys=ndv)
    tt = build_nested_host(ta, ndv, n_keys=ndv)
    dev = jax.device_get(_ndu_probe_strand(ts, tt, rk, out1, out2))
    for k in ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp",
              "c_unnest_1", "c_unnest_2", "c_top"):
        assert int(host[k]) == int(dev[k]), k
    want = sorted((int(r), int(s), int(t)) for r, s, t in
                  zip(dev["r_row"], dev["s_row"], dev["t_row"]) if r >= 0)
    got = sorted(zip(host["r_row"].tolist(), host["s_row"].tolist(),
                     host["t_row"].tolist()))
    assert got == want

    # Chj
    hs2 = HostTable(sa, ndv, kind="chaining")
    ht2 = HostTable(ta, ndv, kind="chaining")
    host2 = host_two_join_probe(hs2, ht2, rk, out2)
    cs = build_chaining_host(sa, ndv, n_keys=ndv)
    ctt = build_chaining_host(ta, ndv, n_keys=ndv)
    dev2 = jax.device_get(_chj_probe_strand(
        cs, ctt, rk, max(e.calc_join_card1(), 1), out2))
    for k in ("c_probe_RS", "c_probe_RS_cmp", "c_probe_RT", "c_probe_RT_cmp",
              "c_top"):
        assert int(host2[k]) == int(dev2[k]), k
    want2 = sorted((int(r), int(s), int(t)) for r, s, t in
                   zip(dev2["r_row"], dev2["s_row"], dev2["t_row"]) if r >= 0)
    got2 = sorted(zip(host2["r_row"].tolist(), host2["s_row"].tolist(),
                      host2["t_row"].tolist()))
    assert got2 == want2


def test_host_backend_hash_functors_match_device():
    """VERDICT r3 residual #2: the native host engine accepts every
    registry hash functor (native/hj3engine.cpp HashFunId), with counters
    equal to the device path's functor-parameterized tables."""
    import hashjoin3d_tpu as hj

    rng = np.random.default_rng(31)
    bk = rng.integers(0, 300, 800, dtype=np.uint32)
    pk = rng.integers(0, 380, 1200, dtype=np.uint32)
    for hf in ("murmur", "boncz", "fib", "mult", "identity"):
        for how in ("chaining", "nested"):
            dev = hj.join(bk, pk, how=how, num_buckets=128, hashfun=hf,
                          backend="device")
            host = hj.join(bk, pk, how=how, num_buckets=128, hashfun=hf,
                           backend="host")
            assert host.num_matches == dev.num_matches, (hf, how)
            assert host.num_cmps == dev.num_cmps, (hf, how)
            assert sorted(host.pairs()) == sorted(dev.pairs()), (hf, how)


def test_host_backend_u64_hash_functors():
    import hashjoin3d_tpu as hj

    rng = np.random.default_rng(32)
    bk = (rng.integers(0, 200, 500).astype(np.uint64) << np.uint64(33)
          | np.uint64(5))
    pk = (rng.integers(0, 260, 700).astype(np.uint64) << np.uint64(33)
          | np.uint64(5))
    for hf in ("boncz", "fib", "mult"):
        dev = hj.join(bk, pk, how="chaining", num_buckets=64, hashfun=hf,
                      backend="device")
        host = hj.join(bk, pk, how="chaining", num_buckets=64, hashfun=hf,
                       backend="host")
        assert host.num_matches == dev.num_matches, hf
        assert host.num_cmps == dev.num_cmps, hf
        assert sorted(host.pairs()) == sorted(dev.pairs()), hf


def test_host_backend_rejects_callable_functor():
    import pytest

    import hashjoin3d_tpu as hj

    with pytest.raises(ValueError, match="registry"):
        hj.join(np.arange(4, dtype=np.uint32), np.arange(4, dtype=np.uint32),
                backend="host", hashfun=lambda x: x)
