"""Tests for the auxiliary operator set: hash aggregate, sort/partition, filter."""

import pytest
import jax.numpy as jnp
import numpy as np

from hashjoin3d_tpu.ops.aggregate import hash_aggregate
from hashjoin3d_tpu.ops.filter import apply_predicate, compact
from hashjoin3d_tpu.ops.sort import radix_partition, sort_by_key, sort_rows
from hashjoin3d_tpu.ops.hashing import murmur32_np


def test_hash_aggregate_vs_numpy():
    rng = np.random.default_rng(1)
    keys = rng.integers(0, 30, 500, dtype=np.uint32)
    vals = rng.integers(0, 1000, 500, dtype=np.int32)
    res = hash_aggregate(keys, {"v": jnp.asarray(vals)})
    nk = int(res.n_keys)
    ukey = np.asarray(res.keys)[:nk]
    got = {
        int(ukey[g]): (int(res.count[g]), int(res.sums["v"][g]),
                       int(res.mins["v"][g]), int(res.maxs["v"][g]))
        for g in range(nk)
    }
    want = {}
    for k in np.unique(keys):
        v = vals[keys == k]
        want[int(k)] = (len(v), int(v.sum()), int(v.min()), int(v.max()))
    assert got == want


def test_hash_aggregate_masked():
    keys = np.array([1, 1, 2, 2], np.uint32)
    vals = jnp.asarray(np.array([10, 20, 30, 40], np.int32))
    mask = jnp.asarray(np.array([True, False, True, True]))
    res = hash_aggregate(keys, {"v": vals}, mask=mask)
    nk = int(res.n_keys)
    got = {int(np.asarray(res.keys)[g]): int(res.sums["v"][g])
           for g in range(nk)}
    assert got == {1: 10, 2: 70}


def test_sorts():
    rng = np.random.default_rng(2)
    keys = rng.integers(0, 1 << 30, 1000, dtype=np.uint32)
    pay = rng.integers(0, 100, 1000, dtype=np.int32)
    sk, sp = sort_by_key(keys, jnp.asarray(pay))
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(np.asarray(sk), keys[order])
    np.testing.assert_array_equal(np.asarray(sp), pay[order])
    sk2, rows = sort_rows(keys)
    np.testing.assert_array_equal(np.asarray(rows), order)


def test_radix_partition():
    rng = np.random.default_rng(3)
    keys = rng.integers(0, 1000, 800, dtype=np.uint32)
    rows = jnp.arange(800, dtype=jnp.int32)
    p, k, r, start, length = radix_partition(keys, 16, rows)
    p, k, r = np.asarray(p), np.asarray(k), np.asarray(r)
    start, length = np.asarray(start), np.asarray(length)
    want_p = murmur32_np(keys) % np.uint32(16)
    assert length.sum() == 800
    for part in range(16):
        seg = k[start[part]:start[part] + length[part]]
        want = np.sort(keys[want_p == part])
        np.testing.assert_array_equal(np.sort(seg), want)
    # payload consistency: the key at each row id matches
    np.testing.assert_array_equal(keys[r], k)


def test_filter_and_compact():
    cols = {"a": jnp.arange(10, dtype=jnp.uint32),
            "b": jnp.arange(10, dtype=jnp.int32) * 10}
    mask = apply_predicate(lambda c: c["b"] < 45, cols)
    packed, rows, count = compact(mask, cols, 8)
    assert int(count) == 5
    np.testing.assert_array_equal(np.asarray(rows)[:5], np.arange(5))
    np.testing.assert_array_equal(np.asarray(packed["b"])[:5],
                                  np.arange(5) * 10)
    assert np.asarray(rows)[5] == -1


def test_checked_catches_oob():
    import jax
    from hashjoin3d_tpu.utils.tracing import checked, DeviceTimer

    def bad(i):
        return jnp.arange(4)[i]

    err, _ = checked(jax.jit(lambda i: jnp.arange(4).at[i].get(
        mode="promise_in_bounds")))(jnp.int32(2))
    err, out = checked(bad)(jnp.int32(2))
    assert int(out) == 2
    t = DeviceTimer()
    t(jax.jit(lambda x: x + 1), jnp.ones(8))
    assert t.calls == 1 and t.total > 0


def test_bucket_statistics_and_misc_helpers():
    from hashjoin3d_tpu.ops import build_chaining, build_nested
    from hashjoin3d_tpu.ops.stats import (
        bucket_statistics_chaining, bucket_statistics_nested,
        chaining_statistics)
    from hashjoin3d_tpu.utils.misc import (
        binomial, duration_str, factorial, indent, is_power_of,
        number_of_digits)

    bk = np.array([1, 1, 2, 5], np.uint32)
    ct = build_chaining(bk, 4)
    rows = bucket_statistics_chaining(ct)
    assert sum(r.num_entries for r in rows) == 4
    assert rows[0].to_csv_string().count(";") == 2
    nt = build_nested(bk, 4)
    rows2 = bucket_statistics_nested(nt)
    assert sum(r.num_entries for r in rows2) == 4
    assert sum(r.chain_len for r in rows2) == 3  # distinct keys
    s = chaining_statistics(ct)
    assert s.CSV_HEADER.startswith("numBuckets")
    assert s.to_csv_string().count(";") == 9

    assert factorial(5) == 120 and binomial(5, 2) == 10
    assert number_of_digits(1000) == 4 and number_of_digits(0) == 1
    assert is_power_of(27, 3) and not is_power_of(10, 3)
    assert indent(2) == "    "
    assert duration_str(0.3) == "300 ms"


def test_crc32c_and_fibhash():
    from hashjoin3d_tpu.ops.hashing import crc32c_u32_np, fibhash16_np, fibhash64_np
    # validated against SSE4.2 _mm_crc32_u32 on this host
    assert int(crc32c_u32_np(np.array([0x12345678], np.uint32))[0]) == 0x4DECE20C
    assert fibhash16_np(np.array([7], np.uint16), 100).shape == (1,)
    assert fibhash64_np(np.array([7], np.uint64), 100).shape == (1,)


def test_crc_functors_match_sse42_goldens():
    """HashCrc32/HashCrc64/HashCrc32x2 (util/hasht.hh:195-262) vs hardware.

    Goldens computed on this host with _mm_crc32_u32/_mm_crc32_u64 and the
    reference's seed constants.
    """
    from hashjoin3d_tpu.ops.hashing import (
        crc32c_u64_np, hash_crc32_np, hash_crc32x2_np, hash_crc64_np)

    v64 = np.array([0x123456789ABCDEF0], np.uint64)
    assert int(crc32c_u64_np(v64)[0]) == 0xD95B664B
    assert int(hash_crc64_np(v64)[0]) == 0x554CA2FDCC86751D
    x32 = np.array([0x12345678], np.uint32)
    assert int(hash_crc32_np(x32)[0]) == 0xCF51A615
    assert int(hash_crc32x2_np(x32)[0]) == 0x4816ED18
    assert int(hash_crc32x2_np(x32, 1000)[0]) == 278


def test_string_and_debug_helpers():
    from hashjoin3d_tpu.utils.misc import (
        ltrim, rtrim, to_lower, to_upper, trim, type_name)

    assert ltrim("  x ") == "x " and rtrim("  x ") == "  x"
    assert trim(" x ") == "x"
    assert to_lower("AbC") == "abc" and to_upper("AbC") == "ABC"
    assert type_name(np.zeros(4, np.uint32)) == "uint32[4]"
    assert type_name({"k": np.zeros((2, 3), np.int32)}) == "{k: int32[2,3]}"
    assert type_name([1, (2.0,)]) == "[int, (float)]"


def test_checkpoint_roundtrip(tmp_path):
    from hashjoin3d_tpu.ops import build_nested, probe_nested
    from hashjoin3d_tpu.ops.chaining import build_chaining_host
    from hashjoin3d_tpu.utils.checkpoint import load_table, save_table

    bk = np.array([3, 3, 1, 9], np.uint32)
    pk = np.array([3, 9, 4], np.uint32)
    t = build_nested(bk, 4)
    p = tmp_path / "tbl.npz"
    save_table(p, t)
    t2 = load_table(p)
    r1, r2 = probe_nested(t, pk), probe_nested(t2, pk)
    assert int(r1.num_matches) == int(r2.num_matches)
    assert int(r1.num_cmps) == int(r2.num_cmps)

    # host build with dense-direct (optional field set) round-trips too
    perm = np.random.default_rng(0).permutation(64).astype(np.uint32)
    c = build_chaining_host(perm, 64, dense_direct=True)
    save_table(tmp_path / "c.npz", c)
    c2 = load_table(tmp_path / "c.npz")
    assert c2.direct is not None and c2.num_buckets == 64
    np.testing.assert_array_equal(np.asarray(c.direct), np.asarray(c2.direct))


def test_hash_aggregate_n_keys_hint_and_empty():
    """Compact-directory aggregation (n_keys hint) equals the padded path."""
    rng = np.random.default_rng(77)
    keys = jnp_arr(rng.integers(0, 50, 500, dtype=np.uint32))
    vals = jnp_arr(rng.integers(-100, 100, 500, dtype=np.int32))
    full = hash_aggregate(keys, {"v": vals})
    nk = int(full.groups.n_keys)
    hinted = hash_aggregate(keys, {"v": vals}, n_keys=nk)
    assert int(hinted.groups.n_keys) == nk
    np.testing.assert_array_equal(np.asarray(full.sums["v"])[:nk],
                                  np.asarray(hinted.sums["v"])[:nk])
    np.testing.assert_array_equal(np.asarray(full.mins["v"])[:nk],
                                  np.asarray(hinted.mins["v"])[:nk])
    np.testing.assert_array_equal(np.asarray(full.maxs["v"])[:nk],
                                  np.asarray(hinted.maxs["v"])[:nk])
    np.testing.assert_array_equal(np.asarray(full.keys)[:nk],
                                  np.asarray(hinted.keys)[:nk])

    empty = hash_aggregate(jnp_arr(np.zeros(0, np.uint32)), {}, n_keys=1)
    assert int(empty.groups.n_keys) == 0


def jnp_arr(x):
    import jax.numpy as jnp
    return jnp.asarray(x)


def test_windowed_lookup_matches_gather():
    """layout.safe_lookup == numpy gather on sorted keys, with out-of-range
    keys (sorted to the tail) coming back 0 = miss marker, and on a sparse
    stream whose chunks mix both ends of the table."""
    import jax.numpy as jnp
    from hashjoin3d_tpu.ops.layout import safe_lookup

    rng = np.random.default_rng(3)
    T = 2048
    table = rng.integers(1, 2**32, T, dtype=np.uint32)
    keys = np.sort(rng.integers(0, T, 16384).astype(np.int32))
    out = safe_lookup(jnp.asarray(table), jnp.asarray(keys))
    assert out.dtype == jnp.uint32
    np.testing.assert_array_equal(np.asarray(out), table[keys])

    keys2 = np.concatenate([keys[:-256], np.full(256, T, np.int32)])
    out2 = safe_lookup(jnp.asarray(table), jnp.asarray(keys2))
    assert (np.asarray(out2)[-256:] == 0).all()
    np.testing.assert_array_equal(np.asarray(out2)[:-256],
                                  table[keys2[:-256]])

    T4 = 8192
    table4 = rng.integers(1, 2**32, T4, dtype=np.uint32)
    sparse = np.sort(np.array([0, T4 - 1] * 100, np.int32))
    np.testing.assert_array_equal(
        np.asarray(safe_lookup(jnp.asarray(table4), jnp.asarray(sparse))),
        table4[sparse])


def test_windowed_lookup_double_buffered():
    """Miss holes in a sorted stream over a table of values >= 2^31 (u32
    values must come back unchanged), at a length that is no power of
    two, from u32 keys (>= 2^31 reads as a miss)."""
    import jax.numpy as jnp
    from hashjoin3d_tpu.ops.layout import safe_lookup

    rng = np.random.default_rng(7)
    T = 8192
    table = rng.integers(1 << 31, 2**32, T, dtype=np.uint32)
    keys = np.sort(rng.integers(0, T, 16384 + 77).astype(np.int32))
    keys[rng.random(keys.size) < 0.2] = -1          # miss holes
    want = np.where(keys >= 0, table[np.maximum(keys, 0)], 0)
    out = np.asarray(safe_lookup(jnp.asarray(table), jnp.asarray(keys)))
    np.testing.assert_array_equal(out, want)
    out_u = np.asarray(safe_lookup(jnp.asarray(table),
                                   jnp.asarray(keys.view(np.uint32))))
    np.testing.assert_array_equal(out_u, want)


def test_windowed_lookup_miss_holes():
    """Interspersed -1 miss markers (key_direct images) yield 0 without
    disturbing their neighbours; i32 values keep their dtype."""
    import jax.numpy as jnp
    from hashjoin3d_tpu.ops.layout import safe_lookup

    rng = np.random.default_rng(9)
    T = 4096
    table = rng.integers(-2**31, 2**31, T, dtype=np.int64).astype(np.int32)
    keys = np.sort(rng.integers(0, T, 16384).astype(np.int32))
    holes = rng.random(16384) < 0.3
    keys[holes] = -1
    out = safe_lookup(jnp.asarray(table), jnp.asarray(keys))
    assert out.dtype == jnp.int32
    want = np.where(holes, 0, table[np.maximum(keys, 0)])
    np.testing.assert_array_equal(np.asarray(out), want)


def test_stream_probe_matches_whole_column():
    """Chunk-streamed host-resident probe == whole-column probe (counters
    and pair multiset), including a ragged tail chunk."""
    import jax
    from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand
    from hashjoin3d_tpu.ops.chaining import build_chaining_host
    from hashjoin3d_tpu.ops.streaming import stream_probe_chaining

    rng = np.random.default_rng(13)
    n = 4096
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 32, 10000, dtype=np.uint32)  # ragged vs 4096
    tbl = build_chaining_host(bk, n, dense_direct=True, n_keys=n)

    want = jax.device_get(_chaining_probe_strand(
        tbl, jax.device_put(pk), pk.size, True))
    m, c, pairs = stream_probe_chaining(tbl, pk, chunk_size=4096,
                                        unique=True, collect_pairs=True)
    assert m == int(want["c_htProbe"])
    assert c == int(want["c_htProbeCmp"])
    got = sorted((int(a), int(b)) for pr, br in pairs
                 for a, b in zip(pr, br))
    wp, wb = np.asarray(want["probe_row"]), np.asarray(want["build_row"])
    v = wp >= 0
    assert got == sorted(zip(wp[v].tolist(), wb[v].tolist()))


def test_stream_probe_dense_direct_nonmurmur_pad_correction():
    """Dense-direct streaming with a non-murmur functor: the ragged tail's
    pad-comparison correction must use the TABLE's hashfun (review fix --
    the correction used to hash the pad key with the murmur default)."""
    import jax
    from hashjoin3d_tpu.models.exp1 import _chaining_probe_strand
    from hashjoin3d_tpu.ops.chaining import build_chaining_host
    from hashjoin3d_tpu.ops.hashing import hash_key_np
    from hashjoin3d_tpu.ops.streaming import stream_probe_chaining

    rng = np.random.default_rng(13)
    n = 4096
    bk = rng.permutation(n).astype(np.uint32)
    pk = rng.integers(0, n + 32, 10000, dtype=np.uint32)  # ragged vs 4096
    # the bug is visible only if murmur and boncz route the pad key to
    # buckets of different chain length -- pick num_buckets so they do
    pad = np.uint32(0xFFFFFFFF)
    for nb in range(61, 257):
        blen = np.bincount(hash_key_np(bk, "boncz") % np.uint32(nb),
                           minlength=nb)
        b_murmur = int(hash_key_np(pad, "murmur") % np.uint32(nb))
        b_boncz = int(hash_key_np(pad, "boncz") % np.uint32(nb))
        if blen[b_murmur] != blen[b_boncz]:
            break
    else:
        pytest.fail("no num_buckets separates the pad buckets")
    tbl = build_chaining_host(bk, nb, dense_direct=True, n_keys=n,
                              hashfun="boncz")

    want = jax.device_get(_chaining_probe_strand(
        tbl, jax.device_put(pk), pk.size, True))
    m, c, _ = stream_probe_chaining(tbl, pk, chunk_size=4096, unique=True)
    assert m == int(want["c_htProbe"])
    assert c == int(want["c_htProbeCmp"])


@pytest.mark.parametrize("layout", ["keydirect", "merged_u32", "merged_u64"])
def test_stream_probe_nested_matches_whole_column(layout):
    """Chunk-streamed nested probe+unnest == whole-column probe_nested +
    unnest on every table layout (counters and pair multiset)."""
    import jax
    from hashjoin3d_tpu.ops.nested import (
        build_nested_host, probe_nested, unnest)
    from hashjoin3d_tpu.ops.streaming import stream_probe_nested

    rng = np.random.default_rng(17)
    if layout == "keydirect":
        bk = rng.integers(0, 1024, 4096, dtype=np.uint32)
        pk = rng.integers(0, 1100, 10000, dtype=np.uint32)
        kd = 1100
    elif layout == "merged_u32":
        bk = (rng.integers(0, 1024, 4096, dtype=np.uint32)
              * 65521 + 3).astype(np.uint32)
        pk = (rng.integers(0, 1100, 10000, dtype=np.uint32)
              * 65521 + 3).astype(np.uint32)
        kd = None
    else:
        hi = np.uint64(0x3) << np.uint64(40)
        bk = rng.integers(0, 1024, 4096).astype(np.uint64) | hi
        pk = rng.integers(0, 1100, 10000).astype(np.uint64) | hi
        kd = None
    ndv = int(np.unique(bk).size)
    tbl = build_nested_host(bk, ndv, n_keys=ndv, key_domain=kd)

    res = probe_nested(tbl, jax.device_put(pk))
    total = int(np.sum(np.asarray(jax.device_get(res.group_len))))
    prow, brow, valid, _ = unnest(tbl, res, max(1, total))
    m, c, u, pairs = stream_probe_nested(tbl, pk, chunk_size=4096,
                                         collect_pairs=True,
                                         out_per_chunk=8 * 4096)
    assert m == int(res.num_matches)
    assert c == int(res.num_cmps)
    assert u == total
    got = sorted((int(a), int(b)) for pr, br in pairs
                 for a, b in zip(pr, br))
    wp, wb = np.asarray(prow), np.asarray(brow)
    v = np.asarray(valid)
    assert got == sorted(zip(wp[v].tolist(), wb[v].tolist()))


@pytest.mark.parametrize("unique", [False, True])
def test_stream_probe_chaining_keydirect_and_merged(unique):
    """Streaming chaining probes on NON-dense-direct layouts (the round-2
    restriction removed): keydirect and merged tables."""
    import jax
    from hashjoin3d_tpu.ops.chaining import (
        build_chaining_host, materialize_chaining_join, probe_chaining)
    from hashjoin3d_tpu.ops.streaming import stream_probe_chaining

    rng = np.random.default_rng(19)
    if unique:
        base = rng.permutation(1 << 16)[:2048].astype(np.uint32)
    else:
        base = rng.integers(0, 512, 2048, dtype=np.uint32)
    for kd, tr in ((1 << 16, lambda a: a),
                   (None, lambda a: a.astype(np.uint64)
                    | (np.uint64(9) << np.uint64(40)))):
        bk = tr(base)
        pk = tr(np.concatenate([rng.choice(base, 9000),
                                rng.integers(1 << 17, 1 << 18, 1000)
                                ]).astype(base.dtype))
        ndv = int(np.unique(bk).size)
        tbl = build_chaining_host(bk, ndv, n_keys=ndv, key_domain=kd)

        res = probe_chaining(tbl, jax.device_put(pk), unique=unique)
        total = int(res.num_matches)
        prow, brow, valid, _ = materialize_chaining_join(
            tbl, res, max(1, total), unique=unique)
        m, c, pairs = stream_probe_chaining(
            tbl, pk, chunk_size=4096, unique=unique, collect_pairs=True,
            out_per_chunk=16 * 4096)
        assert m == total
        assert c == int(res.num_cmps)
        got = sorted((int(a), int(b)) for pr, br in pairs
                     for a, b in zip(pr, br))
        wp, wb = np.asarray(prow), np.asarray(brow)
        v = np.asarray(valid)
        assert got == sorted(zip(wp[v].tolist(), wb[v].tolist()))


def test_inverse_permute_impls_agree():
    from hashjoin3d_tpu.ops.layout import inverse_permute, set_invperm_impl
    rng = np.random.default_rng(7)
    for n in (0, 1, 5, 1000):
        perm = rng.permutation(n).astype(np.int32)
        for vals in (rng.integers(-50, 50, n).astype(np.int32),
                     rng.integers(0, 2**32, n, dtype=np.uint64)
                     .astype(np.uint32)):
            outs = {}
            for impl in ("scatter", "sort"):
                set_invperm_impl(impl)
                try:
                    outs[impl] = np.asarray(
                        inverse_permute(jnp.asarray(perm), jnp.asarray(vals)))
                finally:
                    set_invperm_impl("auto")
            want = np.zeros(n, vals.dtype)
            want[perm] = vals
            np.testing.assert_array_equal(outs["scatter"], want)
            np.testing.assert_array_equal(outs["sort"], want)
            assert outs["sort"].dtype == vals.dtype


def test_builds_bit_equal_across_invperm_impls():
    """The builds' row-order recovery must be formulation-independent."""
    import jax
    from hashjoin3d_tpu.ops.chaining import build_chaining
    from hashjoin3d_tpu.ops.nested import build_nested
    from hashjoin3d_tpu.ops.layout import set_invperm_impl

    rng = np.random.default_rng(11)
    keys = rng.integers(0, 64, 300, dtype=np.uint32)
    perm_keys = rng.permutation(256).astype(np.uint32)

    def snapshot():
        ct = build_chaining(jnp.asarray(keys), 16)
        nt = build_nested(jnp.asarray(keys), 16)
        cd = build_chaining(jnp.asarray(perm_keys), 16, dense_direct=True)
        nd = build_nested(jnp.asarray(perm_keys), 16, dense_direct=True)
        leaves = jax.tree_util.tree_leaves((ct, nt, cd, nd))
        return [np.asarray(x) for x in leaves]

    try:
        set_invperm_impl("scatter")
        jax.clear_caches()
        a = snapshot()
        set_invperm_impl("sort")
        jax.clear_caches()
        b = snapshot()
    finally:
        set_invperm_impl("auto")
        jax.clear_caches()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_group_index_bit_equal_across_headcompact_impls():
    """Directory head compaction (scatter vs stable 1-bit partition sort)
    must produce bit-identical GroupIndex structures, incl. valid masks,
    u64 keys and cap > n."""
    import jax
    from hashjoin3d_tpu.ops.layout import (compact_group_index,
                                           key_group_index,
                                           set_headcompact_impl,
                                           sort_with_rows)

    rng = np.random.default_rng(3)
    cases = []
    for n, dom in ((1, 4), (300, 64), (1000, 5000)):
        k = rng.integers(0, dom, n, dtype=np.uint32)
        cases.append((k, None))
        cases.append((k, rng.random(n) < 0.7))
    k64 = rng.integers(0, 2**40, 500, dtype=np.uint64)
    cases.append((k64, None))

    def snapshot():
        leaves = []
        for keys, valid in cases:
            v = None if valid is None else jnp.asarray(valid)
            gi = key_group_index(jnp.asarray(keys), v)
            leaves += jax.tree_util.tree_leaves(gi)
            if valid is None:
                skey, srow, nk = sort_with_rows(jnp.asarray(keys))
                for cap in (int(nk), int(nk) + 7, keys.shape[0] + 13):
                    cgi = compact_group_index(jnp.asarray(keys), skey, srow,
                                              cap, with_gid_by_row=True)
                    leaves += jax.tree_util.tree_leaves(cgi)
        return [np.asarray(x) for x in leaves]

    try:
        set_headcompact_impl("scatter")
        jax.clear_caches()
        a = snapshot()
        set_headcompact_impl("sort")
        jax.clear_caches()
        b = snapshot()
    finally:
        set_headcompact_impl("auto")
        jax.clear_caches()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_builds_bit_equal_across_headcompact_impls():
    """Full padded + host-compacted builds across head-compaction impls."""
    import jax
    from hashjoin3d_tpu.ops.chaining import build_chaining, build_chaining_host
    from hashjoin3d_tpu.ops.nested import build_nested, build_nested_host
    from hashjoin3d_tpu.ops.layout import set_headcompact_impl

    rng = np.random.default_rng(5)
    keys = rng.integers(0, 64, 300, dtype=np.uint32)

    def snapshot():
        ct = build_chaining(jnp.asarray(keys), 16)
        nt = build_nested(jnp.asarray(keys), 16)
        ch = build_chaining_host(jnp.asarray(keys), 16, n_keys=64)
        nh = build_nested_host(jnp.asarray(keys), 16, n_keys=64)
        leaves = jax.tree_util.tree_leaves((ct, nt, ch, nh))
        return [np.asarray(x) for x in leaves]

    try:
        set_headcompact_impl("scatter")
        jax.clear_caches()
        a = snapshot()
        set_headcompact_impl("sort")
        jax.clear_caches()
        b = snapshot()
    finally:
        set_headcompact_impl("auto")
        jax.clear_caches()
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
