"""Segmented probe sorts, the probe-sort policy and the gather helper.

``ops/sort.py:sort_segmented`` replaces the probe strands' global 2-op sort
with a batched within-segment ``lax.sort`` when the key domain is known
(``probe_sort_chunk``).  These tests pin:

* sort_segmented semantics against numpy (per-segment order, row-id
  recovery, u32 vs i32 order, ties, miss keys at segment tails, single and
  presorted segments);
* probe_sort_chunk's routing policy;
* ``layout.safe_lookup`` against brute force on adversarial streams;
* full strand counters/result parity vs the python oracles when the
  segmented paths are active (P large enough, domain small enough).
"""

import numpy as np
import pytest

import jax.numpy as jnp

import hashjoin3d_tpu as hj
from hashjoin3d_tpu.ops.layout import safe_lookup
from hashjoin3d_tpu.ops.sort import (MAX_SEGMENT, probe_sort_chunk,
                                     sort_segmented)
from oracle import ChainingOracle, NestedOracle

I32 = np.int32
U32 = np.uint32


def test_probe_sort_chunk_policy():
    # unknown domain -> global sort
    assert probe_sort_chunk(1 << 24, None) is None
    # canonical bench shape: 2^24 probes over 2^20 domain.  The policy
    # wants segments of 2x the domain, capped at MAX_SEGMENT = 2^20
    assert probe_sort_chunk(1 << 24, 1 << 20) == 1 << 20
    # sub-cap domain: the full 2x-domain segment
    assert probe_sort_chunk(1 << 20, 1 << 16) == 1 << 17
    # domain not a power of two rounds up (then doubles)
    assert probe_sort_chunk(1 << 20, (1 << 16) - 3) == 1 << 17
    # large domains stay segmentable up to 4 * MAX_SEGMENT
    assert probe_sort_chunk(1 << 24, 1 << 22) == 1 << 20
    assert probe_sort_chunk(1 << 26, 1 << 23) is None
    # indivisible P
    assert probe_sort_chunk((1 << 20) + 512, 1 << 16) is None
    # segment floor: 1024-element alignment
    assert probe_sort_chunk(1 << 16, 16) == 1024
    # segment count cap (max_k=64): tiny domain under a huge P
    assert probe_sort_chunk(1 << 24, 16) == 1 << 18


@pytest.mark.parametrize("logp,logd", [(24, 20), (25, 21), (24, 21)])
def test_probe_sort_chunk_canonical_shapes(logp, logd):
    """At the canonical bench shapes the policy segments the probe sort:
    each segment is an ascending run over the whole domain (at least the
    domain long, capped at MAX_SEGMENT), segments tile P exactly, and the
    segment count stays within [min_k, max_k]."""
    P, domain = 1 << logp, 1 << logd
    chunk = probe_sort_chunk(P, domain)
    assert chunk is not None
    assert chunk == min(2 * domain, MAX_SEGMENT)
    assert P % chunk == 0 and 8 <= P // chunk <= 64


@pytest.mark.parametrize("logp,logd,want", [(24, 20, 1 << 20),
                                            (25, 21, 1 << 20),
                                            (24, 21, 1 << 20),
                                            (21, 20, None)])
def test_probe_sort_chunk_shape_table(logp, logd, want):
    """The segment each canonical shape gets (None = global sort: 2^21
    probes over a 2^20 domain leave fewer than 8 capped segments)."""
    assert probe_sort_chunk(1 << logp, 1 << logd) == want


def test_probe_sort_chunk_small_domains():
    # small domains: 2x the domain; the segment never undercuts 1024
    assert probe_sort_chunk(1 << 20, 1 << 16) == 1 << 17
    assert probe_sort_chunk(1 << 14, 100) == 1024
    # too few segments for a batched sort to pay: global
    assert probe_sort_chunk(1 << 12, 1 << 10) is None


# -- sort_segmented vs numpy ----------------------------------------------


def _check_segments(keys, chunk, got_k, got_r, stable=True):
    """Per segment: keys sorted exactly (numpy order of the dtype), row ids
    a permutation of the segment carrying their own keys, and -- for a
    stable sort -- equal keys in ascending row order."""
    got_k, got_r = np.asarray(got_k), np.asarray(got_r)
    k2 = keys.reshape(-1, chunk)
    want_k = np.sort(k2, axis=1, kind="stable")
    assert np.array_equal(got_k.reshape(-1, chunk), want_k)
    for s in range(k2.shape[0]):
        rows = got_r.reshape(-1, chunk)[s] - s * chunk
        assert sorted(rows.tolist()) == list(range(chunk))
        assert np.array_equal(k2[s][rows], want_k[s])
        if stable:
            want_r = np.argsort(k2[s], kind="stable")
            assert np.array_equal(rows, want_r)


@pytest.mark.parametrize("chunk", [256, 512])
def test_sort_segmented_random_u32(chunk):
    rng = np.random.default_rng(0)
    P = 4 * chunk
    keys = rng.integers(0, 1 << 32, P, dtype=np.uint64).astype(U32)
    _check_segments(keys, chunk, *sort_segmented(jnp.asarray(keys), chunk))


def test_sort_segmented_duplicate_keys_stable():
    """Dense duplicates: equal keys keep ascending row order."""
    rng = np.random.default_rng(1)
    chunk, P = 256, 1024
    keys = rng.integers(0, 7, P).astype(U32)  # heavy ties
    _check_segments(keys, chunk, *sort_segmented(jnp.asarray(keys), chunk))


def test_sort_segmented_rows_follow_keys():
    """Heavy ties at two segment sizes: every row id stays aligned with its
    key and the row column stays a per-segment permutation."""
    rng = np.random.default_rng(7)
    for chunk, P, hi in ((512, 4096, 11), (1024, 4096, 5)):
        keys = rng.integers(0, hi, P).astype(U32)
        _check_segments(keys, chunk,
                        *sort_segmented(jnp.asarray(keys), chunk))


@pytest.mark.parametrize("chunk,P,hi", [(1024, 4096, 61),
                                        (1024, 4096, 1 << 24),
                                        (2048, 8192, 1 << 24)])
def test_sort_segmented_packed_shapes(chunk, P, hi):
    """The key ranges and segment shapes of the probe streams: small dense
    domains and 24-bit keys, one and several segments per stream."""
    rng = np.random.default_rng(21)
    keys = rng.integers(0, hi, P, dtype=np.int64).astype(U32)
    _check_segments(keys, chunk, *sort_segmented(jnp.asarray(keys), chunk))


def test_sort_segmented_out_of_domain_tail():
    """Miss keys above the domain sort to each segment's tail exactly."""
    rng = np.random.default_rng(24)
    chunk, P = 1024, 2048
    keys = rng.integers(0, 200, P).astype(U32)
    keys[rng.choice(P, 100, replace=False)] = (1 << 24) - 1  # miss marker
    sk, sr = sort_segmented(jnp.asarray(keys), chunk)
    _check_segments(keys, chunk, sk, sr)
    sk = np.asarray(sk).reshape(-1, chunk)
    for seg in sk:
        big = seg >= 200
        assert np.all(big == (np.arange(chunk) >= chunk - big.sum()))


def test_sort_segmented_sign_flip_order():
    """Keys straddling 2^31 must sort in u32 order, not i32."""
    rng = np.random.default_rng(2)
    chunk = 256
    keys = np.concatenate([
        rng.integers(0, 100, 128), rng.integers((1 << 32) - 100, 1 << 32,
                                                128)]).astype(U32)
    rng.shuffle(keys)
    sk, sr = sort_segmented(jnp.asarray(keys), chunk)
    assert np.asarray(sk)[:128].max() < 100
    _check_segments(keys, chunk, sk, sr)


def test_sort_segmented_i32_markers():
    """i32 keys sort signed: -1 markers lead each segment."""
    rng = np.random.default_rng(3)
    chunk, P = 512, 2048
    v = rng.integers(0, 64, P).astype(I32)
    v[rng.choice(P, 300, replace=False)] = -1
    _check_segments(v, chunk, *sort_segmented(jnp.asarray(v), chunk))


@pytest.mark.parametrize("chunk", [512, 1024])
def test_sort_segmented_multi_level(chunk):
    """Random u32 keys with payload-sized segments, and signed i32 values
    through the same sort."""
    rng = np.random.default_rng(6)
    P = 4 * chunk
    keys = rng.integers(0, 1 << 32, P, dtype=np.uint64).astype(U32)
    _check_segments(keys, chunk, *sort_segmented(jnp.asarray(keys), chunk))
    v = rng.integers(-50, 50, P).astype(I32)
    _check_segments(v, chunk, *sort_segmented(jnp.asarray(v), chunk))


def test_sort_segmented_single_segment_and_presorted():
    chunk = 256
    asc = np.arange(chunk, dtype=U32)
    desc = asc[::-1].copy()
    const = np.full(chunk, 7, U32)
    for keys in (asc, desc, const):
        _check_segments(keys, chunk,
                        *sort_segmented(jnp.asarray(keys), chunk))


def test_sort_segmented_equals_per_segment_numpy():
    """The whole output equals numpy's per-segment stable sort, keys and
    global row ids alike."""
    rng = np.random.default_rng(5)
    P, chunk = 4096, 1024
    b = rng.integers(0, 64, P).astype(U32)
    sk, sr = (np.asarray(x) for x in sort_segmented(jnp.asarray(b), chunk))
    order = np.argsort(b.reshape(-1, chunk), axis=1, kind="stable")
    want_r = (order + (np.arange(P // chunk) * chunk)[:, None]).reshape(P)
    assert np.array_equal(sr, want_r)
    assert np.array_equal(sk, b[want_r])


def test_sort_probes_segmented_vs_global():
    """_sort_probes with a known domain (segmented) and without (global)
    yield the same key multiset per row id, and each is sorted the way its
    policy says."""
    from hashjoin3d_tpu.ops.strands_windowed import _sort_probes
    rng = np.random.default_rng(4)
    P, dom = 16384, 600
    pk = rng.integers(0, dom, P).astype(U32)
    chunk = probe_sort_chunk(P, dom)
    assert chunk is not None
    seg = _sort_probes(jnp.asarray(pk), domain=dom)
    glo = _sort_probes(jnp.asarray(pk))
    _check_segments(pk, chunk, seg.skey, seg.srow)
    gk, gr = np.asarray(glo.skey), np.asarray(glo.srow)
    assert np.array_equal(gk, np.sort(pk))
    assert np.array_equal(pk[gr], gk)


def test_sort_segmented_semantics():
    rng = np.random.default_rng(0)
    P, chunk = 8192, 1024
    pk = rng.integers(0, 600, P, dtype=U32)
    sk, sr = (np.asarray(x) for x in sort_segmented(jnp.asarray(pk), chunk))
    for s in range(P // chunk):
        seg = slice(s * chunk, (s + 1) * chunk)
        # ascending within the segment
        assert np.all(np.diff(sk[seg].astype(np.int64)) >= 0)
        # row ids point back into this segment and recover the keys
        assert np.all((sr[seg] >= s * chunk) & (sr[seg] < (s + 1) * chunk))
        assert np.array_equal(pk[sr[seg]], sk[seg])
    # global multiset preserved
    assert np.array_equal(np.sort(sk), np.sort(pk))


def test_sort_segmented_miss_keys_at_tails():
    rng = np.random.default_rng(1)
    P, chunk = 4096, 1024
    pk = rng.integers(0, 512, P, dtype=U32)
    miss = rng.choice(P, 100, replace=False)
    pk[miss] = rng.integers(1 << 30, 1 << 31, 100)  # far out of domain
    sk, sr = (np.asarray(x) for x in sort_segmented(jnp.asarray(pk), chunk))
    for s in range(P // chunk):
        seg = sk[s * chunk:(s + 1) * chunk]
        big = seg >= 512
        # miss keys occupy a contiguous tail of the segment
        assert np.all(big == (np.arange(chunk) >= chunk - big.sum()))


def test_sort_segmented_i32_dead_markers():
    rng = np.random.default_rng(2)
    P, chunk = 4096, 1024
    b = rng.integers(0, 64, P).astype(I32)
    b[rng.choice(P, 500, replace=False)] = -1
    out = np.asarray(sort_segmented(jnp.asarray(b), chunk)[0])
    for s in range(P // chunk):
        seg = out[s * chunk:(s + 1) * chunk]
        assert np.all(np.diff(seg) >= 0)  # -1s at the front
    assert np.array_equal(np.sort(out), np.sort(b))


def _brute(values, keys):
    T = values.shape[0]
    ok = (keys >= 0) & (keys < T)
    return np.where(ok, values[np.clip(keys, 0, T - 1)], 0).astype(U32)


def test_safe_lookup_patches_boundary_chunks():
    """A segment-restarting key stream (each segment sweeps the whole
    value range, rotated off the 1024 grid)."""
    rng = np.random.default_rng(3)
    T = 1 << 14
    values = rng.integers(1, 1 << 30, T).astype(U32)
    K, seg = 8, 4096
    keys = np.concatenate([
        np.sort(rng.integers(0, T, seg)).astype(I32)[
            np.r_[np.arange(137, seg), np.arange(137)]]
        for _ in range(K)])
    out = np.asarray(safe_lookup(jnp.asarray(values), jnp.asarray(keys)))
    assert np.array_equal(out, _brute(values, keys))


def test_safe_lookup_gather_fallback_beyond_patch_budget():
    """A fully random stream."""
    rng = np.random.default_rng(4)
    T = 1 << 14
    values = rng.integers(1, 1 << 30, T).astype(U32)
    keys = rng.integers(0, T, 1 << 15).astype(I32)  # fully random stream
    out = np.asarray(safe_lookup(jnp.asarray(values), jnp.asarray(keys)))
    assert np.array_equal(out, _brute(values, keys))


def test_safe_lookup_patch_with_misses_and_pad():
    rng = np.random.default_rng(5)
    T = 5000  # not a power of two
    values = rng.integers(1, 1 << 30, T).astype(U32)
    n = 3 * 1024 + 700  # ragged length
    keys = np.sort(rng.integers(0, T, n)).astype(I32)
    keys[rng.choice(n, 50, replace=False)] = -1
    keys[rng.choice(n, 50, replace=False)] = T + 17
    # one artificial wrap
    keys[2048:2060] = np.arange(12, dtype=I32)
    out = np.asarray(safe_lookup(jnp.asarray(values), jnp.asarray(keys)))
    assert np.array_equal(out, _brute(values, keys))


# -- full strands with segmentation active -----------------------------------


def test_direct_strand_segmented_counters():
    """Csr/CsrUU over a dense-direct table, P large enough that the
    segmented sort engages (probe_sort_chunk != None)."""
    rng = np.random.default_rng(6)
    dom = 512
    bk = rng.permutation(dom).astype(U32)
    pk = rng.integers(0, 600, 8192, dtype=U32)  # ~15% misses
    assert probe_sort_chunk(8192, dom) is not None

    for unique in (False, True):
        res = hj.join(bk, pk, how="chaining", unique=unique, num_buckets=64,
                      backend="device")
        orc = ChainingOracle(bk, 64)
        pairs, matches, cmps = orc.probe(pk, unique=unique)
        assert res.num_matches == matches
        assert res.num_cmps == cmps
        assert sorted(res.pairs()) == sorted(pairs)


def test_keydirect_nested_strand_segmented_counters():
    """Nrs expansion path with segment-restarting group-position streams:
    build_row stays exact."""
    rng = np.random.default_rng(7)
    dom = 512
    bk = rng.integers(0, dom, 4096, dtype=U32)  # ~8 rows per key
    pk = rng.integers(0, 600, 8192, dtype=U32)
    res = hj.join(bk, pk, how="nested", num_buckets=128, backend="device",
                  key_domain=dom)
    orc = NestedOracle(bk, 128)
    nested, matches, cmps = orc.probe(pk)
    assert res.num_matches == matches
    assert res.num_cmps == cmps
    assert sorted(res.pairs()) == sorted(orc.unnest(nested))


def test_keydirect_chaining_strand_segmented_counters():
    rng = np.random.default_rng(8)
    dom = 512
    bk = rng.integers(0, dom, 4096, dtype=U32)
    pk = rng.integers(0, 600, 8192, dtype=U32)
    res = hj.join(bk, pk, how="chaining", num_buckets=128, backend="device",
                  key_domain=dom)
    orc = ChainingOracle(bk, 128)
    pairs, matches, cmps = orc.probe(pk)
    assert res.num_matches == matches
    assert res.num_cmps == cmps
    assert sorted(res.pairs()) == sorted(pairs)


def test_zipf_skewed_segmented():
    """Heavy duplicate skew: counters stay exact."""
    rng = np.random.default_rng(9)
    dom = 512
    bk = rng.integers(0, dom, 2048, dtype=U32)
    z = np.minimum((rng.pareto(1.2, 8192) * 3).astype(np.int64), dom - 1)
    pk = z.astype(U32)
    res = hj.join(bk, pk, how="nested", num_buckets=64, backend="device",
                  key_domain=dom)
    orc = NestedOracle(bk, 64)
    nested, matches, cmps = orc.probe(pk)
    assert res.num_matches == matches
    assert res.num_cmps == cmps
    assert res.num_results == len(orc.unnest(nested))


def test_directory_fetch_window_covers_head_stream():
    """The build-side directory (layout.compact_group_index) on exp-4's
    BIMODAL fk multiplicity -- a common region at ~4 rows/key next to an
    exclusive region at ~2 -- equals numpy's run-length directory."""
    import jax

    from hashjoin3d_tpu.ops.layout import compact_group_index, sort_with_rows

    rng = np.random.default_rng(17)
    dv_a, dv_b = 1 << 10, 1 << 12
    keys = np.concatenate([rng.integers(0, dv_a, 4 * dv_a),
                           dv_a + rng.integers(0, dv_b, 2 * dv_b)])
    keys = rng.permutation(keys).astype(U32)
    skey, srow, nk = sort_with_rows(jnp.asarray(keys))
    cap = dv_a + dv_b
    g = jax.device_get(compact_group_index(jnp.asarray(keys), skey, srow,
                                           cap))
    uk, first, cnt = np.unique(keys, return_index=True, return_counts=True)
    k = uk.size
    assert int(nk) == int(g.n_keys) == k
    np.testing.assert_array_equal(np.asarray(g.ukey)[:k], uk)
    np.testing.assert_array_equal(np.asarray(g.group_len)[:k], cnt)
    np.testing.assert_array_equal(np.asarray(g.first_row)[:k], first)
    starts = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    np.testing.assert_array_equal(np.asarray(g.group_start)[:k], starts)
    assert (np.asarray(g.group_len)[k:] == 0).all()


@pytest.mark.parametrize("logp,logd,logn", [(20, 20, 24),   # exp-1 Crs
                                            (21, 21, 25),   # exp-1 2x Crs
                                            (24, 20, 24)])  # Csr-shaped
def test_rows_window_covers_expansion_streams(logp, logd, logn):
    """The emission stream (``group_rows[group_start[g] + within]``) of a
    segment-sorted probe stream, at the canonical shapes' ratios (scaled
    down 2^10): ``expand`` must reproduce numpy's per-probe repeat exactly,
    including the restart at every segment boundary."""
    from hashjoin3d_tpu.ops.layout import expand

    P, domain, n_rows = (1 << logp) >> 10, (1 << logd) >> 10, \
        (1 << logn) >> 10
    glen = n_rows // domain
    rng = np.random.default_rng(3)
    seg = max(P // 4, 1)
    keys = np.sort(rng.integers(0, domain, P).reshape(-1, seg),
                   axis=1).reshape(P)
    counts = np.full(P, glen, np.int32)
    counts[rng.random(P) < 0.1] = 0                       # misses
    out_size = int(counts.sum())
    p, within, valid, total = (np.asarray(x) for x in
                               expand(jnp.asarray(counts), out_size)[:4])
    want_p = np.repeat(np.arange(P), counts)
    assert int(total) == out_size and valid.all()
    np.testing.assert_array_equal(p, want_p)
    want_w = np.concatenate([np.arange(c) for c in counts if c])
    np.testing.assert_array_equal(within, want_w)
    pos = keys[p] * glen + within                          # CSR positions
    np.testing.assert_array_equal(pos, keys[want_p] * glen + want_w)
