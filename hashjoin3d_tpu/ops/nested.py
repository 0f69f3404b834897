"""Nested ("3D") hash-table equivalent: build, probe, and deferred unnest.

Vectorized re-design of ``HtNested1`` (``ht_nested.hh:71-251``) and the
``AlgNestJoinBuild`` / ``AlgNestJoinProbe`` / ``AlgUnnestHt`` operators
(``algebra.hh:362-552``).

The reference's core idea (the CIDR 2022 paper): store *one* MainNode per
distinct build key with the duplicate rows in a SubNode list, so the probe walks
one node per distinct key and can emit a single *nested tuple*
``(probe_row, match_group)`` whose expansion (unnesting) is deferred
(``algebra.hh:404-473, 476-552``).

The dense equivalent:

* MainNode directory  -> sorted distinct keys + per-bucket main-chain CSR
* SubNode lists       -> contiguous ``group_rows`` runs (see ``layout.py``)
* nested tuple        -> ``(probe index, group id, hit mask)`` -- a
  :class:`NestedBatch` column triple, no pointers
* unnest              -> prefix-sum segment expansion

Counter semantics preserved exactly (``ht_nested.hh::findMainNodeByOther``,
``ht_nested.hh:354-382``):

* per probe, comparisons = 1-based position of the matching MainNode in its
  bucket's main chain, or the full main-chain length on a miss (0 if the bucket
  is empty).  Main-chain order is *first-occurrence* order: new distinct keys
  append at the chain tail (``ht_nested.hh:286-311``).
* probe ``_count`` = number of probe tuples with >= 1 match (at most one nested
  tuple per probe row, ``algebra.hh:446-458``).
* unnest ``_count`` = number of expanded output tuples; expansion order per
  group is [first-inserted row, then remaining duplicates LIFO]
  (``algebra.hh:510-541`` + head-insert in ``ht_nested.hh:398-412``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .hashing import bucket_of, hash_key
from .layout import (I32, U32, GroupIndex, canon_key_dtype, expand,
                     group_capacity,
                     key_group_index, lookup_auto,
                     shrink_group_arrays)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NestedTable:
    """Dense 3D hash-table state.

    ``main_pos_by_group[g]`` is the 0-based position of distinct key ``g`` in
    its bucket's main chain; ``bucket_main_len[b]`` the number of distinct keys
    (MainNodes) hashed to bucket ``b``.  Groups beyond ``groups.n_keys`` are
    padding.
    """

    groups: GroupIndex
    main_pos_by_group: jax.Array  # i32[n]
    bucket_main_len: jax.Array    # i32[nb]
    keys: jax.Array               # u32[n] original build key column
    num_buckets: int = field(metadata=dict(static=True), default=1)
    # Adaptive dense-direct layout (see chaining.py): for permutation keys the
    # group id IS the key and one packed gather yields (row | main_pos+1).
    direct: jax.Array | None = None      # u32[n]
    direct_shift: int = field(metadata=dict(static=True), default=0)
    # Dense key-domain index (see chaining.py): key value -> group id in ONE
    # gather when the key domain [0, domain) is small and statically known.
    key_direct: jax.Array | None = None  # i32[domain], -1 = key absent
    # Bucket-assignment functor (the reference's pluggable ``Thashfun`` /
    # ``Tprobehashfun``, ``ht_nested.hh:355-363``): a HASH_FUNCTORS name or
    # traceable callable; probes read it from here.
    hashfun: str = field(metadata=dict(static=True), default="murmur")

    @property
    def size(self):
        """Row count (the reference's ``size()``: number of inserted nodes)."""
        return self.keys.shape[0]

    def memory_consumption(self) -> dict:
        """HBM bytes held by this table, split like the reference's
        ``memoryConsupmtion{,Dir,MainChains,SubChains}``
        (``ht_nested.hh:261-284``).

        ``dir``: per-bucket arrays; ``main``: per-distinct-key (MainNode)
        arrays -- the sorted-key directory, main-chain positions and the
        optional dense-direct / key-domain indexes; ``sub``: per-row (SubNode)
        arrays -- the CSR duplicate rows plus the retained key column.
        ``total = dir + main + sub``; sizes are actual device-array
        footprints (``nbytes``).
        """
        g = self.groups
        dir_bytes = self.bucket_main_len.nbytes
        main_arrays = [self.main_pos_by_group, g.ukey, g.group_start,
                       g.group_len, g.first_row, self.direct, self.key_direct]
        main_bytes = sum(a.nbytes for a in main_arrays if a is not None)
        sub_bytes = g.group_rows.nbytes + g.gid_by_row.nbytes + self.keys.nbytes
        return dict(total=dir_bytes + main_bytes + sub_bytes, dir=dir_bytes,
                    main=main_bytes, sub=sub_bytes)


def can_use_dense_direct(keys_np, num_buckets: int,
                         hashfun="murmur") -> bool:
    """Host-side validity check for the dense-direct nested layout."""
    from .chaining import can_use_dense_direct as _chk
    return _chk(keys_np, num_buckets, hashfun)


@partial(jax.jit, static_argnames=("num_buckets", "dense_direct",
                                   "key_domain", "hashfun"))
def build_nested(keys: jax.Array, num_buckets: int,
                 valid: jax.Array | None = None,
                 dense_direct: bool = False,
                 key_domain: int | None = None,
                 hashfun="murmur") -> NestedTable:
    """Build the 3D table from a build-side key column.

    Equivalent of scanning the build relation through ``AlgNestJoinBuild::step``
    (``algebra.hh:386-389``).  Grouping duplicates under one directory entry is
    *naturally* a sort + run-length encode -- no per-tuple chain walks.
    ``valid`` marks live rows (padded shuffle outputs / filtered batches).
    ``key_domain`` adds the dense key->group index (usable inside shard_map,
    unlike the host builds), enabling the sorted probe strands on
    distributed shards.
    """
    keys = keys.astype(canon_key_dtype(keys))
    n = keys.shape[0]

    groups = key_group_index(keys, valid)

    h_main = hash_key(groups.ukey, hashfun)
    valid = groups.group_len > 0
    b_main = jnp.where(
        valid, bucket_of(h_main, num_buckets), num_buckets
    )

    # Main-chain position: distinct keys ordered by first occurrence within
    # each bucket (tail append, ht_nested.hh:299-308); the main-chain
    # histogram rides the same sort (sorted_histogram avoids bincount's slow
    # scatter-add, and run_start replaces a bucket_start gather).
    from .layout import run_boundaries, sorted_histogram
    gid = jnp.arange(n, dtype=I32)
    bm_s, _, gid_sorted = lax.sort(
        (b_main, groups.first_row, gid), num_keys=2
    )
    n_valid_groups = jnp.sum(valid.astype(I32))
    is_first_m, _, run_start_m, run_len_m = run_boundaries(
        bm_s.astype(U32), n_valid_groups)
    _, bucket_main_len = sorted_histogram(bm_s, num_buckets, is_first_m,
                                          run_len_m)
    pos_sorted = jnp.arange(n, dtype=I32) - run_start_m
    from .layout import inverse_permute
    main_pos_by_group = inverse_permute(gid_sorted, pos_sorted)

    direct = None
    direct_shift = 0
    if dense_direct:
        # caller verified can_use_dense_direct(): keys are a permutation of
        # [0, n), so ukey[i] == i and each group has exactly one row.
        direct_shift = (n - 1).bit_length()
        row = jnp.arange(n, dtype=I32)
        pos1 = main_pos_by_group[keys.astype(I32)] + 1  # key == gid
        packed = row.astype(U32) | (pos1.astype(U32) << jnp.uint32(direct_shift))
        direct = inverse_permute(keys.astype(I32), packed)

    from .layout import key_direct_index
    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)

    return NestedTable(
        groups=groups,
        main_pos_by_group=main_pos_by_group,
        bucket_main_len=bucket_main_len,
        keys=keys,
        num_buckets=num_buckets,
        direct=direct,
        direct_shift=direct_shift,
        key_direct=key_direct,
        hashfun=hashfun,
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class NestedBatch:
    """A batch of nested tuples: the vectorized ``(probe*, MainNode*)`` pair.

    ``probe_row[i]`` pairs with match group ``g[i]`` when ``hit[i]``; rows with
    ``hit[i] == False`` carry no nested tuple (the reference simply does not
    call ``step`` downstream for them, ``algebra.hh:451-458``).

    Contract: ``probe_row`` is positional (``arange(P)``) -- every
    constructor in the engine builds it that way, and ``unnest`` relies on
    it to emit the expansion's segment index as the probe row directly.
    """

    probe_row: jax.Array   # i32[P]
    g: jax.Array           # i32[P]
    hit: jax.Array         # bool[P]
    group_len: jax.Array   # i32[P] (0 where no hit)
    num_matches: jax.Array  # i64[] probes with a match (probe op _count)
    num_cmps: jax.Array     # i64[] main-chain comparisons (numCmps)
    direct_row: jax.Array | None = None  # i32[P] the single matching build row
    #                                      (dense-direct tables: groups are
    #                                       singletons, unnest is positional)


@partial(jax.jit, static_argnames=("cap",))
def shrink_nested(table: NestedTable, cap: int) -> NestedTable:
    """Slice the main-node directory to ``cap`` entries (see shrink_chaining)."""
    import dataclasses
    g = table.groups
    ukey, gs, gl, fr = shrink_group_arrays(
        (g.ukey, g.group_start, g.group_len, g.first_row), cap)
    groups = GroupIndex(ukey, gs, gl, g.group_rows, fr, g.gid_by_row, g.n_keys)
    return dataclasses.replace(
        table, groups=groups,
        main_pos_by_group=table.main_pos_by_group[:cap])


def build_nested_host(keys: jax.Array, num_buckets: int,
                      dense_direct: bool = False,
                      n_keys: int | None = None,
                      key_domain: int | None = None,
                      hashfun="murmur") -> NestedTable:
    """Two-phase host-orchestrated build with a *compacted* directory.

    Phase 1 sorts the keys and reads the distinct-key count on the host (one
    sync); phase 2 builds directly into ``cap``-sized directory arrays with
    scans + one stacked scatter -- no n-sized random gathers, no padding work.
    Use inside other jits is impossible (host sync); there, use
    :func:`build_nested`.

    ``n_keys``: exact distinct-key count, when the caller knows it (cardinality
    statistics; the experiment harnesses compute it at generation time).
    Passing it removes the phase-1 device->host sync -- the only blocking
    round trip in the build.  A smaller
    value truncates the directory (groups beyond ``cap`` are lost); exact or
    larger values are safe.
    """
    from .layout import sort_with_rows, group_capacity

    if dense_direct and n_keys == keys.shape[0]:
        # permutation keys: probe/unnest/stats read only direct +
        # bucket_main_len; skip the distinct-key directory entirely
        return _build_nested_dense(keys, num_buckets, hashfun)
    if n_keys is not None:
        # sync-free: both phases fuse into one device program (one dispatch)
        cap = group_capacity(n_keys, keys.shape[0])
        return _build_nested_fused(keys, cap, num_buckets, dense_direct,
                                   key_domain, hashfun)
    skey, srow, nk = sort_with_rows(keys)
    n_keys = int(nk)  # the one host sync
    cap = group_capacity(n_keys, keys.shape[0])
    return _build_nested_phase2(keys, skey, srow, cap, num_buckets,
                                dense_direct, key_domain, hashfun)


@partial(jax.jit, static_argnames=("num_buckets", "hashfun"))
def _build_nested_dense(keys, num_buckets, hashfun="murmur"):
    """Slim dense-direct 3D build: no distinct-key directory.

    Permutation keys make every row its own MainNode; main-chain position is
    the ARRIVAL rank within the bucket (tail append, ht_nested.hh:299-308 --
    unlike the chaining table's head-insert order).
    """
    from .layout import GroupIndex, run_boundaries, sorted_histogram

    keys = keys.astype(U32)
    n = keys.shape[0]
    row = jnp.arange(n, dtype=I32)

    h = hash_key(keys, hashfun)
    b = bucket_of(h, num_buckets)
    b_sorted, srow = lax.sort((b, row), num_keys=1, is_stable=True)
    is_first_b, _, run_start_b, run_len_b = run_boundaries(
        b_sorted.astype(U32), jnp.int32(n))
    _, bucket_main_len = sorted_histogram(
        b_sorted, num_buckets, is_first_b, run_len_b)
    rank = jnp.arange(n, dtype=I32) - run_start_b  # arrival order in bucket
    from .layout import inverse_permute
    pos_by_row = inverse_permute(srow, rank)

    direct_shift = (n - 1).bit_length()
    direct = inverse_permute(
        keys.astype(I32),
        row.astype(U32) | ((pos_by_row + 1).astype(U32)
                           << jnp.uint32(direct_shift)))

    empty = jnp.zeros(0, I32)
    groups = GroupIndex(ukey=jnp.zeros(0, U32), group_start=empty,
                        group_len=empty, group_rows=empty, first_row=empty,
                        gid_by_row=empty, n_keys=jnp.int32(n))
    return NestedTable(
        groups=groups, main_pos_by_group=empty,
        bucket_main_len=bucket_main_len, keys=keys, num_buckets=num_buckets,
        direct=direct, direct_shift=direct_shift, hashfun=hashfun)


@partial(jax.jit, static_argnames=("cap", "num_buckets", "dense_direct",
                                   "key_domain", "hashfun", "drop_pad_key"))
def _build_nested_fused(keys, cap, num_buckets, dense_direct,
                        key_domain=None, hashfun="murmur",
                        drop_pad_key=False, rows=None):
    from .layout import sort_with_rows

    if rows is None:
        skey, srow, _ = sort_with_rows(keys)
        rows_s = None
    else:
        # ``rows`` (e.g. global row ids on a distributed shard) ride the
        # phase-1 sort so group_rows emits them directly
        from .layout import sort_rows_maybe_skip
        keys = keys.astype(canon_key_dtype(keys))
        skey, srow, rows_s = sort_rows_maybe_skip(keys, rows.astype(I32))
    return _build_nested_phase2(keys, skey, srow, cap, num_buckets,
                                dense_direct, key_domain, hashfun,
                                drop_pad_key, rows_s)


@partial(jax.jit, static_argnames=("cap", "num_buckets", "dense_direct",
                                   "key_domain", "hashfun", "drop_pad_key"))
def _build_nested_phase2(keys, skey, srow, cap, num_buckets, dense_direct,
                         key_domain=None, hashfun="murmur",
                         drop_pad_key=False, row_values=None):
    """``drop_pad_key``: rows carrying the all-ones key are dead (padded
    shuffle receives); their group is zeroed (layout.drop_pad_groups) so
    they enter no bucket and match nothing -- the shard_map-safe compacted
    build (the host builds' fast path, usable under jit because ``cap`` is
    static).  ``row_values``: key-sorted alternate ids for ``group_rows``
    (see layout.compact_group_index)."""
    from .layout import (compact_group_index, drop_pad_groups,
                         key_direct_index, run_boundaries)

    keys = keys.astype(canon_key_dtype(keys))
    n = keys.shape[0]
    groups = compact_group_index(keys, skey, srow, cap,
                                 row_values=row_values)
    if drop_pad_key:
        groups = drop_pad_groups(groups)

    h_main = hash_key(groups.ukey, hashfun)
    validg = groups.group_len > 0
    b_main = jnp.where(validg,
                       bucket_of(h_main, num_buckets),
                       num_buckets)

    # main-chain position: first-occurrence order within each bucket; the
    # main-chain histogram rides the same sort (sorted_histogram avoids
    # bincount's slow scatter-add)
    from .layout import sorted_histogram
    gidc = jnp.arange(cap, dtype=I32)
    bm_s, _, gid_s = lax.sort((b_main, groups.first_row, gidc), num_keys=2)
    n_valid_groups = jnp.sum(validg.astype(I32))
    is_first_m, _, run_start, run_len_m = run_boundaries(
        bm_s.astype(U32), n_valid_groups)
    _, bucket_main_len = sorted_histogram(bm_s, num_buckets, is_first_m,
                                          run_len_m)
    pos_s = jnp.arange(cap, dtype=I32) - run_start
    from .layout import inverse_permute
    main_pos_by_group = inverse_permute(gid_s, pos_s)

    direct = None
    direct_shift = 0
    if dense_direct:
        # permutation keys: cap == n, ukey[g] == g, singleton groups
        direct_shift = (n - 1).bit_length()
        pos1 = main_pos_by_group + 1
        direct = (groups.first_row.astype(U32)
                  | (pos1.astype(U32) << jnp.uint32(direct_shift)))

    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)

    return NestedTable(
        key_direct=key_direct,
        groups=groups,
        main_pos_by_group=main_pos_by_group,
        bucket_main_len=bucket_main_len,
        keys=keys,
        num_buckets=num_buckets,
        direct=direct,
        direct_shift=direct_shift,
        hashfun=hashfun,
    )


def probe_nested(
    table: NestedTable,
    probe_keys: jax.Array,
    mask: jax.Array | None = None,
    method: str = "auto",
) -> NestedBatch:
    """Vectorized ``AlgNestJoinProbe`` (``algebra.hh:435-459``).

    Emits at most one nested tuple per live probe row.  Cost is independent of
    duplicates-per-key: one binary search over distinct keys plus O(1) gathers.
    """
    pk = probe_keys.astype(canon_key_dtype(probe_keys))

    if table.direct is not None:
        # Dense-direct fast path: one gather; key == group id, groups are
        # singletons (see build_nested).
        n = table.direct.shape[0]
        in_range = pk < n
        hit = in_range if mask is None else (in_range & mask)
        d = table.direct[jnp.minimum(pk, n - 1)]
        row = (d & jnp.uint32((1 << table.direct_shift) - 1)).astype(I32)
        pos1 = (d >> jnp.uint32(table.direct_shift)).astype(I32)
        cmps = jnp.where(hit, pos1, 0)
        live_miss = ~in_range if mask is None else (mask & ~in_range)
        n_miss = jnp.sum(live_miss.astype(I32))

        def miss_cmps(_):
            h = hash_key(pk, table.hashfun)
            b = bucket_of(h, table.num_buckets)
            return jnp.sum(jnp.where(live_miss, table.bucket_main_len[b], 0)
                           .astype(jnp.int64))

        cmps_miss = lax.cond(n_miss > 0, miss_cmps,
                             lambda _: jnp.int64(0), None)
        return NestedBatch(
            probe_row=jnp.arange(pk.shape[0], dtype=I32),
            g=jnp.minimum(pk, n - 1).astype(I32),
            hit=hit,
            group_len=hit.astype(I32),
            num_matches=jnp.sum(hit.astype(jnp.int64)),
            num_cmps=jnp.sum(cmps.astype(jnp.int64)) + cmps_miss,
            direct_row=row,
        )

    h = hash_key(pk, table.hashfun)
    b = bucket_of(h, table.num_buckets)

    if table.key_direct is not None:
        from .layout import key_direct_lookup
        g, hit = key_direct_lookup(table.key_direct, pk)  # ONE gather
    else:
        g, hit = lookup_auto(table.groups, pk, method)
    if mask is not None:
        hit = hit & mask

    cmps = jnp.where(hit, table.main_pos_by_group[g] + 1, table.bucket_main_len[b])
    if mask is not None:
        cmps = jnp.where(mask, cmps, 0)
    glen = jnp.where(hit, table.groups.group_len[g], 0)

    return NestedBatch(
        probe_row=jnp.arange(pk.shape[0], dtype=I32),
        g=g,
        hit=hit,
        group_len=glen,
        num_matches=jnp.sum(hit.astype(jnp.int64)),
        num_cmps=jnp.sum(cmps.astype(jnp.int64)),
    )


def deferred_two_join_strand(tbl_s: NestedTable, tbl_t: NestedTable,
                             keys: jax.Array, out1: int, out2: int,
                             mask: jax.Array | None = None):
    """Probe S, probe T under the S-hit mask, unnest T then S -- the exp-4
    Ndu strand (``main_experiment4.cc:832-941``), shared by the single-chip
    experiment model and the distributed pipeline.

    Nested batches flow through the second probe un-expanded; both
    expansions run only for rows that survived both joins.  Returns a dict
    of shard/chip-local row ids (``r_row``/``s_row``/``t_row``, -1-masked),
    ``valid``, both probes' counters and both unnest counts (i64).
    """
    rs = probe_nested(tbl_s, keys, mask=mask)           # [r, {s}]
    rst = probe_nested(tbl_t, keys, mask=rs.hit)        # [r, {s}, {t}]

    from .layout import emit_pos

    # Unnest #1 unpacks T: one row per T duplicate of surviving nested
    # tuples; per-segment attributes ride the expansions as payloads.
    both = rst.hit                                       # implies rs.hit
    t_counts = jnp.where(both, rst.group_len, 0)
    p1, w1, v1, n_unnest1, gst_t, gs1, tlen1 = expand(
        t_counts, out1,
        (tbl_t.groups.group_start[rst.g], jnp.where(both, rs.g, 0)),
        with_seg_len=True)
    t_row = tbl_t.groups.group_rows[gst_t + emit_pos(w1, tlen1)]

    # Unnest #2 unpacks S.
    s_counts = jnp.where(v1, tbl_s.groups.group_len[gs1], 0)
    _, w2, v2, n_unnest2, gst_s, t_prop, r_prop, slen2 = expand(
        s_counts, out2,
        (tbl_s.groups.group_start[gs1],
         jnp.where(v1, t_row, 0),
         jnp.where(v1, p1, 0)),
        with_seg_len=True)
    s_row = tbl_s.groups.group_rows[gst_s + emit_pos(w2, slen2)]

    return dict(
        r_row=jnp.where(v2, r_prop, -1),
        s_row=jnp.where(v2, s_row, -1),
        t_row=jnp.where(v2, t_prop, -1),
        valid=v2,
        c_probe_RS=rs.num_matches, c_probe_RS_cmp=rs.num_cmps,
        c_probe_RT=rst.num_matches, c_probe_RT_cmp=rst.num_cmps,
        c_unnest_1=n_unnest1.astype(jnp.int64),
        c_unnest_2=n_unnest2.astype(jnp.int64),
    )


@partial(jax.jit, static_argnames=("out_size",))
def unnest(table: NestedTable, nested: NestedBatch, out_size: int):
    """Vectorized ``AlgUnnestHt`` (``algebra.hh:510-541``).

    Expands each nested tuple into one output row per duplicate of the matched
    key, in [MainNode row, then SubNodes] order.  Returns
    ``(probe_row i32[out_size], build_row i32[out_size], valid bool[out_size],
    total i64[])`` where ``total`` is the unnest operator's ``_count``.
    """
    P = nested.g.shape[0]
    if nested.direct_row is not None and out_size == P:
        # Singleton groups from a dense-direct table: positional unnest, no
        # expansion machinery.
        total = jnp.sum(nested.hit.astype(jnp.int64))
        probe_row = jnp.where(nested.hit, nested.probe_row, -1)
        build_row = jnp.where(nested.hit, nested.direct_row, -1)
        return probe_row, build_row, nested.hit, total

    # Per-segment attributes ride the expansion as propagated payloads --
    # P-sized gathers before, zero out-sized gathers after; the single
    # remaining gather is the result-row fetch.  The probe row needs no
    # payload at all: every NestedBatch constructor sets probe_row to
    # arange(P), so the segment index p that expand() already propagates IS
    # the probe row (one int64 scatter + one out-sized cummax saved).
    from .layout import emit_pos
    gstart_by_probe = table.groups.group_start[nested.g]
    p, within, valid, total, gstart, glen_o = expand(
        nested.group_len, out_size, (gstart_by_probe,), with_seg_len=True)
    build_row = table.groups.group_rows[gstart + emit_pos(within, glen_o)]
    probe_row = jnp.where(valid, p, -1)
    build_row = jnp.where(valid, build_row, -1)
    return probe_row, build_row, valid, total.astype(jnp.int64)
