"""Sorted-probe experiment strands: the engine's device probe path.

These strands restructure the experiment probe pipelines around ONE sort of
the probe keys:

* probes are sorted by key once (or arrive sorted: exp-4's ``R.k`` is an
  iota, ``main_experiment4.cc:522-525``) and then look up the table's
  ``direct`` / ``key_direct`` arrays;
* every downstream per-match array access inherits (near-)sortedness:
  group ids ``g`` are assigned in sorted-key order, so ``group_len[g]``,
  ``group_start[g]``, ``main_pos[g]`` are nondecreasing streams with -1
  miss holes; segment-expansion outputs walk ``group_rows`` in CSR order;
  and the original probe ids come back via ``srow[p]`` keyed by the sorted
  segment index ``p``;
* emission order is by sorted key rather than probe order, and within a
  group it is ascending insertion order rather than the reference's
  [first, rest LIFO].  Result sets are bit-equal as multisets (the
  engine's standing contract, SURVEY §7.4) and all counters (c_htProbe /
  c_htProbeCmp / c_unnest / c_top) are bit-equal to the reference, pinned
  by differential tests.  (The clarity-layer ops -- unnest / materialize /
  algebra -- keep exact LIFO emission via layout.emit_pos.)

Every table access is ``layout.safe_lookup``: a plain gather that reads
keys outside the table as 0 (a miss).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .hashing import bucket_of, hash_key
from .layout import I32, U32, expand, safe_lookup


class SortedProbes(NamedTuple):
    """The result of :func:`_sort_probes` (named fields, so call sites
    never depend on the tuple's arity)."""
    skey: jax.Array       #: sorted keys, u32
    srow: jax.Array       #: original row ids, i32


def _sort_probes(pk: jax.Array, domain: int | None = None) -> SortedProbes:
    """(sorted keys u32, original rows i32) -- the one sort of the strand.

    With a known key ``domain`` (the table's ``direct`` / ``key_direct``
    extent) the global 2-op sort becomes a segmented batched sort where
    :func:`ops.sort.probe_sort_chunk` allows it: each segment covers the
    domain and out-of-domain (miss) keys sort to each segment's tail
    exactly as they sort to the global tail.

    A probe stream that is ALREADY ascending (pre-partitioned input, the
    output of a sorted operator) skips the sort entirely at runtime: the
    monotonicity check is one reduction read (layout.is_sorted_ascending).
    """
    from .layout import is_sorted_ascending
    from .sort import probe_sort_chunk, sort_segmented
    P = pk.shape[0]
    pku = pk.astype(U32)
    # vma-typed identity permutation (see layout.sort_rows_maybe_skip)
    rowv = jnp.arange(P, dtype=I32) + (pku ^ pku).astype(I32)
    chunk = probe_sort_chunk(P, domain)
    if chunk is None:
        def sort(k):
            return lax.sort((k, rowv), num_keys=1)
    else:
        def sort(k):
            return sort_segmented(k, chunk)
    skey, srow = lax.cond(is_sorted_ascending(pku),
                          lambda k: (k, rowv), sort, pku)
    return SortedProbes(skey, srow)


def _miss_chain_cmps(table_bucket_len, num_buckets, skey_u32, miss_mask,
                     hashfun="murmur"):
    """Comparison count contributed by missing probes: each walks its full
    bucket chain (``algebra.hh:640-658`` on a miss).  Runs only when misses
    exist."""
    n_miss = jnp.sum(miss_mask.astype(I32))

    def walk(_):
        b = bucket_of(hash_key(skey_u32, hashfun), num_buckets)
        b = jnp.where(miss_mask, b, -1)        # live misses only
        return jnp.sum(safe_lookup(table_bucket_len, b).astype(jnp.int64))

    # inside shard_map (check_vma) both cond branches must agree on how
    # they vary across mesh axes -- mark the constant like the data
    zero = jnp.int64(0)
    try:
        vma = jax.typeof(miss_mask).vma
        if vma:
            zero = lax.pcast(zero, tuple(vma), to="varying")
    except Exception:
        pass
    return lax.cond(n_miss > 0, walk, lambda _: zero, None)


@partial(jax.jit, static_argnames=("unique", "nested"))
def direct_probe_strand_sorted(table, pk, unique=False, nested=False,
                               mask=None):
    """Sorted Csr / CsrUU / Nsr probe strand (dense-direct tables).

    Equivalent to ``models.exp1._chaining_probe_strand`` /
    ``_nested_probe_strand`` over a dense-direct table: one lookup of the
    packed ``(row | pos+1 << shift)`` word per sorted probe.  Emission is
    in sorted-key order (multiset-equal); counters are bit-equal
    (``algebra.hh:625-659``).

    ``nested=True`` = the Nsr plan: same packed-word probe, plus the
    positional unnest of singleton groups (c_unnest = matches).

    ``mask`` marks live probe rows (a pushed-down selection, the
    exp-1 *Sel plans): dead rows neither probe nor contribute miss-side
    comparisons.  Dead rows travel as the all-ones key with liveness as a
    second sort column, exactly like the keydirect strands' padded-shuffle
    path, so a live probe whose key IS 0xFFFFFFFF stays correct.
    """
    direct = table.direct
    n = direct.shape[0]
    live_s = None
    if mask is None:
        skey, srow = _sort_probes(pk, domain=n)
    else:
        pk_m = jnp.where(mask, pk.astype(U32), jnp.uint32(0xFFFFFFFF))
        skey, live_i, srow = lax.sort(
            (pk_m, mask.astype(I32), jnp.arange(pk.shape[0], dtype=I32)),
            num_keys=1)
        live_s = live_i > 0
    sk = skey.astype(I32)  # keys >= 2^31 go negative = out-of-range = miss

    d = safe_lookup(direct, sk)
    hit = d != 0  # packed words carry a 1-based chain position: never 0
    if live_s is not None:
        hit = hit & live_s
    row = (d & jnp.uint32((1 << table.direct_shift) - 1)).astype(I32)
    pos1 = (d >> jnp.uint32(table.direct_shift)).astype(I32)

    blen = (table.bucket_main_len if nested else table.bucket_len)
    miss = (~hit) if live_s is None else (live_s & ~hit)
    miss_cmps = _miss_chain_cmps(blen, table.num_buckets, skey, miss,
                                 table.hashfun)

    if unique or nested:
        cmps = jnp.sum(jnp.where(hit, pos1, 0).astype(jnp.int64)) + miss_cmps
    else:
        # full-chain walk (no early exit): per-key chain length
        cbk = safe_lookup(table.chain_by_key, sk).astype(I32)
        cmps = jnp.sum(jnp.where(hit, cbk, 0).astype(jnp.int64)) + miss_cmps

    m = jnp.sum(hit.astype(jnp.int64))
    out = dict(
        probe_row=jnp.where(hit, srow, -1),
        build_row=jnp.where(hit, row, -1),
        total=m,
        c_htProbe=m,
        c_htProbeCmp=cmps,
    )
    if nested:
        out["c_unnest"] = m
    return out


def _keydirect_probe(table, sk, skey_u32, g=None, live=None):
    """Shared key_direct probe: sorted keys -> (g, hit, glen, pos1,
    miss_cmps) with -1/0 miss markers throughout.

    ``g`` short-circuits the key_direct lookup when the caller already has
    the group-id stream (iota/permutation probes: the key_direct image
    itself); ``live`` gates dead (padded) rows out of the miss count.
    """
    if g is None:
        g = safe_lookup(table.key_direct + 1, sk).astype(I32) - 1
    hit = g >= 0
    glen = safe_lookup(table.groups.group_len, g).astype(I32)
    pos1 = safe_lookup(table.main_pos_by_group + 1, g).astype(I32)
    miss = (~hit) if live is None else (live & ~hit)
    miss_cmps = _miss_chain_cmps(table.bucket_main_len, table.num_buckets,
                                 skey_u32, miss, table.hashfun)
    return g, hit, glen, pos1, miss_cmps


@partial(jax.jit, static_argnames=("out_size", "do_unnest", "probes_iota",
                                   "probes_permutation", "presorted"))
def keydirect_nested_strand_sorted(table, pk, out_size, do_unnest=True,
                                   probes_iota=False,
                                   probes_permutation=False,
                                   mask=None, presorted=False,
                                   srow_values=None):
    """Sorted Nrs / NrsNU probe strand (key_direct nested tables).

    The sorted group-id stream makes every per-group array access a
    nondecreasing gather; the unnest expansion walks ``group_rows`` in CSR
    order and recovers original probe ids through ``srow[p]`` (the segment
    index p is nondecreasing).  ``probes_iota`` skips the probe
    sort when the key column is already the identity (exp-4's R.k);
    ``probes_permutation`` replaces it with one inverse-permutation scatter
    when the keys are a permutation of [0, P) (exp-1's R.k,
    main_experiment1.cc:425-428) -- the sorted keys are then the identity
    and the key_direct image needs no lookup at all.  ``mask`` marks live
    probe rows (padded shuffle outputs inside shard_map): dead rows hit
    nothing and contribute no comparisons.  ``presorted=True`` skips the
    probe sort entirely: the caller promises ``pk`` is already sorted --
    globally or blockwise (``partition_exchange(sort_within_dest=True)``
    receive streams, circulated ring chunks) -- with any dead rows (mask
    False) carrying the all-ones key.
    ``srow_values`` (presorted only) replaces the emitted probe ids: pass
    the global row-id payload of a shuffle receive and ``probe_row`` comes
    out in global coordinates directly, skipping the id-mapping gather the
    caller would otherwise pay per result row.
    """
    P = pk.shape[0]
    live_s = None
    if presorted:
        assert not (probes_iota or probes_permutation)
        if mask is None:
            skey = pk.astype(U32)
        else:
            skey = jnp.where(mask, pk.astype(U32), jnp.uint32(0xFFFFFFFF))
            live_s = mask
        srow = (jnp.arange(P, dtype=I32) if srow_values is None
                else srow_values.astype(I32))
    elif mask is not None:
        assert not (probes_iota or probes_permutation)
        # dead rows travel as the all-ones key (sorts last, i32-views to
        # -1 = miss); liveness rides the sort to gate the miss-cmps count
        pk_m = jnp.where(mask, pk.astype(U32), jnp.uint32(0xFFFFFFFF))
        skey, live_s, srow = lax.sort(
            (pk_m, mask.astype(I32), jnp.arange(P, dtype=I32)), num_keys=1)
        live_s = live_s > 0
    elif probes_iota:
        skey = pk.astype(U32)
        srow = None
    elif probes_permutation:
        # sorted(permutation of [0,P)) == iota; srow == inverse permutation
        from .layout import inverse_permute
        skey = jnp.arange(P, dtype=U32)
        srow = inverse_permute(pk.astype(I32), jnp.arange(P, dtype=I32))
    else:
        skey, srow = _sort_probes(pk, domain=table.key_direct.shape[0])
    sk = skey.astype(I32)

    if probes_iota or probes_permutation:
        # keys are exactly [0, P): the key_direct image IS the g stream
        kd = table.key_direct
        dom = kd.shape[0]
        g0 = (kd[:P] if P <= dom
              else jnp.concatenate([kd, jnp.full(P - dom, -1, I32)]))
        g, hit, glen, pos1, miss_cmps = _keydirect_probe(table, sk, skey,
                                                         g=g0)
    else:
        g, hit, glen, pos1, miss_cmps = _keydirect_probe(table, sk, skey,
                                                         live=live_s)
    m = jnp.sum(hit.astype(jnp.int64))
    cmps = jnp.sum(pos1.astype(jnp.int64)) + miss_cmps

    if not do_unnest:
        prow = (jnp.arange(P, dtype=I32) if probes_iota else srow)
        return dict(nested_g=jnp.where(hit, g, -1),
                    nested_hit=hit, nested_probe_row=prow,
                    c_htProbe=m, c_htProbeCmp=cmps, c_top=m)

    gstart_by_p = safe_lookup(table.groups.group_start, g).astype(I32)
    p, within, valid, total, = expand(glen, out_size)[:4]
    gst = safe_lookup(gstart_by_p, p).astype(I32)
    # ascending within-group emission: group_rows positions stay
    # near-contiguous.  Result sets are multiset-exact; per-group order here
    # is insertion order rather than the reference's [first, rest LIFO].
    build_row = safe_lookup(table.groups.group_rows, gst + within).astype(I32)
    if probes_iota:
        probe_row = p
    else:
        probe_row = safe_lookup(srow, p).astype(I32)
    return dict(
        probe_row=jnp.where(valid, probe_row, -1),
        build_row=jnp.where(valid, build_row, -1),
        total=total.astype(jnp.int64),
        c_htProbe=m, c_htProbeCmp=cmps,
        c_unnest=total.astype(jnp.int64),
    )


def _merge_groups(ukey: jax.Array, pk: jax.Array):
    """Sort-merge group resolution that STAYS in merged (sorted) order.

    The dense ``key_direct`` index cannot exist for u64 keys or sparse u32
    domains; the engine's generic lookup (``layout.merge_lookup``) scatters
    results back to probe order, after which every downstream per-group
    access is a random gather.  This variant keeps the merged order
    instead, so the group-id stream is NONDECREASING like the u32 strands',
    extended to any key width (re-implements the group resolution of
    /root/reference/ht_nested.hh:354-382 for keys with no dense index).

    Mechanics: concatenate the directory's unique keys with the probe keys
    and sort ONCE -- u64 values as (hi, lo) u32 planes -- with the source
    index as the last sort key, so each equal-key run leads with its
    directory entry (directory indexes [0, K) < probe indexes).  The
    run-head payload, one gather away, IS the group id.

    Returns merged-order ``(skey, g, is_probe, probe_row_by_pos)`` of
    length ``K + P``; ``g`` is -1 where the run head is a probe (key absent
    from the directory); padding directory slots surface with their real
    ``g`` and are rejected by the caller's ``group_len > 0`` gate.
    """
    K, P = ukey.shape[0], pk.shape[0]
    M = K + P
    wide = max(jnp.dtype(ukey.dtype).itemsize, jnp.dtype(pk.dtype).itemsize) == 8
    tgt = jnp.uint64 if wide else U32
    vals = jnp.concatenate([ukey.astype(tgt), pk.astype(tgt)])
    idx = jnp.arange(M, dtype=I32)
    if wide:
        hi = (vals >> jnp.uint64(32)).astype(U32)
        lo = (vals & jnp.uint64(0xFFFFFFFF)).astype(U32)
        hi_s, lo_s, idx_s = lax.sort((hi, lo, idx), num_keys=3)
        is_first = jnp.concatenate(
            [jnp.ones((1,), bool),
             (hi_s[1:] != hi_s[:-1]) | (lo_s[1:] != lo_s[:-1])])
        skey = ((hi_s.astype(jnp.uint64) << jnp.uint64(32))
                | lo_s.astype(jnp.uint64))
    else:
        skey, idx_s = lax.sort((vals, idx), num_keys=2)
        is_first = jnp.concatenate(
            [jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    run_start = lax.cummax(jnp.where(is_first, jnp.arange(M, dtype=I32), -1),
                           0)
    head = safe_lookup(idx_s, run_start).astype(I32)
    g = jnp.where(head < K, head, -1)
    is_probe = idx_s >= K
    return skey, g, is_probe, idx_s - K


@partial(jax.jit, static_argnames=("out_size", "do_unnest"))
def merged_nested_strand_sorted(table, pk, out_size, do_unnest=True):
    """Sorted nested probe strand for u64 / composite / sparse-domain keys.

    The generic-key twin of :func:`keydirect_nested_strand_sorted`: group
    resolution comes from :func:`_merge_groups` instead of a ``key_direct``
    index, everything downstream is identical.  Counters equal
    ``probe_nested`` + ``unnest`` (``ht_nested.hh:354-382``,
    ``algebra.hh:435-459, 510-541``); emission is ascending insertion order
    per group (multiset-equal, the sorted strands' standing contract).

    ``do_unnest=False`` returns the counters plus ``c_expand_total`` (the
    exact unnested size) without materializing -- the one-pass sizing probe
    ``api.join`` uses.
    """
    ukey = table.groups.ukey
    skey, g, is_probe, prow_by_pos = _merge_groups(ukey, pk)

    glen = safe_lookup(table.groups.group_len, g).astype(I32)
    hit = is_probe & (g >= 0) & (glen > 0)
    pos1 = safe_lookup(table.main_pos_by_group + 1, g).astype(I32)
    miss_cmps = _miss_chain_cmps(table.bucket_main_len, table.num_buckets,
                                 skey, is_probe & ~hit, table.hashfun)
    m = jnp.sum(hit.astype(jnp.int64))
    # gate by hit: padding directory slots (group_len 0) carry no defined
    # main position, and misses contribute via the bucket walk above
    cmps = jnp.sum(jnp.where(hit, pos1, 0).astype(jnp.int64)) + miss_cmps
    counts = jnp.where(hit, glen, 0)

    if not do_unnest:
        return dict(c_htProbe=m, c_htProbeCmp=cmps,
                    c_expand_total=jnp.sum(counts.astype(jnp.int64)))

    gstart_by_pos = safe_lookup(table.groups.group_start, g).astype(I32)
    p, within, valid, total = expand(counts, out_size)[:4]
    gst = safe_lookup(gstart_by_pos, p).astype(I32)
    build_row = safe_lookup(table.groups.group_rows, gst + within).astype(I32)
    probe_row = safe_lookup(jnp.maximum(prow_by_pos, 0), p).astype(I32)
    return dict(
        probe_row=jnp.where(valid, probe_row, -1),
        build_row=jnp.where(valid, build_row, -1),
        total=total.astype(jnp.int64),
        c_htProbe=m, c_htProbeCmp=cmps,
        c_unnest=total.astype(jnp.int64),
    )


@partial(jax.jit, static_argnames=("out_size", "unique", "do_expand"))
def merged_chaining_strand_sorted(table, pk, out_size, unique=False,
                                  do_expand=True):
    """Sorted chaining probe strand for u64 / sparse-domain keys
    (generic-key twin of :func:`keydirect_chaining_strand_sorted`;
    ``algebra.hh:625-659``).  ``do_expand=False`` returns counters only
    (the emitted-pair total for chaining IS ``c_htProbe``)."""
    ukey = table.groups.ukey
    skey, g, is_probe, prow_by_pos = _merge_groups(ukey, pk)

    glen = safe_lookup(table.groups.group_len, g).astype(I32)
    hit = is_probe & (g >= 0) & (glen > 0)

    if unique:
        if table.group_min_pos.shape[0] == 0:
            raise ValueError(
                "table was built with early_exit_index=False; "
                "IsBuildKeyUnique probes need the chain-position index")
        counts = hit.astype(I32)
        m = jnp.sum(hit.astype(jnp.int64))
        pos1 = safe_lookup(table.group_min_pos + 1, g).astype(I32)
        miss_cmps = _miss_chain_cmps(table.bucket_len, table.num_buckets,
                                     skey, is_probe & ~hit, table.hashfun)
        cmps = jnp.sum(jnp.where(hit, pos1, 0).astype(jnp.int64)) + miss_cmps
        row_by_pos = safe_lookup(table.group_chain_first + 1, g) - 1
    else:
        counts = jnp.where(hit, glen, 0)
        m = jnp.sum(counts.astype(jnp.int64))
        # full-chain comparisons for every probe: bucket chain lengths
        # (dir entries excluded)
        b = bucket_of(hash_key(skey, table.hashfun),
                      table.num_buckets).astype(I32)
        b = jnp.where(is_probe, b, -1)
        cmps = jnp.sum(safe_lookup(table.bucket_len, b).astype(jnp.int64))
        row_by_pos = None

    if not do_expand:
        return dict(c_htProbe=m, c_htProbeCmp=cmps)

    gstart_by_pos = safe_lookup(table.groups.group_start, g).astype(I32)
    p, within, valid, total = expand(counts, out_size)[:4]
    if unique:
        build_row = safe_lookup(row_by_pos, p).astype(I32)
    else:
        gst = safe_lookup(gstart_by_pos, p).astype(I32)
        build_row = safe_lookup(table.groups.group_rows,
                                gst + within).astype(I32)
    probe_row = safe_lookup(jnp.maximum(prow_by_pos, 0), p).astype(I32)
    return dict(
        probe_row=jnp.where(valid, probe_row, -1),
        build_row=jnp.where(valid, build_row, -1),
        total=total.astype(jnp.int64),
        c_htProbe=m, c_htProbeCmp=cmps,
    )


@partial(jax.jit, static_argnames=("out1", "out2"))
def ndu_strand_sorted(tbl_s, tbl_t, keys_iota, out1, out2):
    """Sorted exp-4 Ndu probe strand (``main_experiment4.cc:832-941``):
    scan R -> NestProbe(S) -> NestProbe(T) -> Unnest(T) -> Unnest(S).

    R.k is an iota by construction, so no probe sort is needed; every
    lookup of the two-probe / two-expansion chain is keyed by a
    nondecreasing stream.  Counters and
    result multisets equal ``ops.nested.deferred_two_join_strand``.
    """
    sk = keys_iota.astype(I32)
    skey = keys_iota.astype(U32)

    g_s, hit_s, glen_s, pos1_s, miss_s = _keydirect_probe(tbl_s, sk, skey)
    c_rs = jnp.sum(hit_s.astype(jnp.int64))
    c_rs_cmp = jnp.sum(pos1_s.astype(jnp.int64)) + miss_s

    # T probe runs only under the S-hit mask (algebra.hh:451-458)
    g_t = safe_lookup(tbl_t.key_direct + 1, sk).astype(I32) - 1
    g_t = jnp.where(hit_s, g_t, -1)
    both = g_t >= 0
    glen_t = safe_lookup(tbl_t.groups.group_len, g_t).astype(I32)
    pos1_t = safe_lookup(tbl_t.main_pos_by_group + 1, g_t).astype(I32)
    miss_t = _miss_chain_cmps(tbl_t.bucket_main_len, tbl_t.num_buckets,
                              skey, hit_s & ~both, tbl_t.hashfun)
    c_rt = jnp.sum(both.astype(jnp.int64))
    c_rt_cmp = jnp.sum(pos1_t.astype(jnp.int64)) + miss_t

    # Unnest #1 (T): one row per T duplicate of rows surviving both probes
    t_counts = jnp.where(both, glen_t, 0)
    gstart_t_by_p = safe_lookup(tbl_t.groups.group_start, g_t).astype(I32)
    p1, w1, v1, n_un1 = expand(t_counts, out1)[:4]
    gst_t = safe_lookup(gstart_t_by_p, p1).astype(I32)
    t_row = safe_lookup(tbl_t.groups.group_rows, gst_t + w1).astype(I32)

    # Unnest #2 (S): expand each (r, t_row) by the S group
    glen_s_m = jnp.where(both, glen_s, 0)
    s_counts = jnp.where(v1, safe_lookup(glen_s_m, p1).astype(I32), 0)
    gstart_s_by_p = safe_lookup(tbl_s.groups.group_start, g_s).astype(I32)
    gst_s_by_p1 = safe_lookup(gstart_s_by_p, p1).astype(I32)
    p2, w2, v2, n_un2 = expand(s_counts, out2)[:4]
    gst_s = safe_lookup(gst_s_by_p1, p2).astype(I32)
    s_row = safe_lookup(tbl_s.groups.group_rows, gst_s + w2).astype(I32)
    t_prop = safe_lookup(t_row, p2).astype(I32)
    r_prop = safe_lookup(p1, p2).astype(I32)  # p1 IS the R row

    return dict(
        r_row=jnp.where(v2, r_prop, -1),
        s_row=jnp.where(v2, s_row, -1),
        t_row=jnp.where(v2, t_prop, -1),
        valid=v2,
        c_probe_RS=c_rs, c_probe_RS_cmp=c_rs_cmp,
        c_probe_RT=c_rt, c_probe_RT_cmp=c_rt_cmp,
        c_unnest_1=n_un1.astype(jnp.int64),
        c_unnest_2=n_un2.astype(jnp.int64),
    )


@partial(jax.jit, static_argnames=("out1", "out2"))
def chj_strand_sorted(tbl_s, tbl_t, keys_iota, out1, out2):
    """Sorted exp-4 Chj probe strand (``main_experiment4.cc:943-1043``):
    Probe(S) materializes every RS pair, each pair probes T with its R key
    (full chain walks, no early exit).  Counters / multisets equal
    ``models.exp4._chj_probe_strand``.
    """
    sk = keys_iota.astype(I32)
    skey = keys_iota.astype(U32)

    # S probe: all matches per probe (chaining, not unique)
    g_s = safe_lookup(tbl_s.key_direct + 1, sk).astype(I32) - 1
    hit_s = g_s >= 0
    glen_s = safe_lookup(tbl_s.groups.group_len, g_s).astype(I32)
    c_rs = jnp.sum(glen_s.astype(jnp.int64))
    # full-chain comparisons: bucket chain length per probe key
    b_s = bucket_of(hash_key(skey, tbl_s.hashfun), tbl_s.num_buckets)
    c_rs_cmp = jnp.sum(safe_lookup(tbl_s.bucket_len,
                                   b_s).astype(jnp.int64))

    # materialize RS pairs (expansion #1)
    gstart_s_by_p = safe_lookup(tbl_s.groups.group_start, g_s).astype(I32)
    p1, w1, v1, n_rs = expand(glen_s, out1)[:4]
    gst_s = safe_lookup(gstart_s_by_p, p1).astype(I32)
    s_row = safe_lookup(tbl_s.groups.group_rows, gst_s + w1).astype(I32)

    # each PAIR probes T with the pair's R key == p1 (keys are the iota)
    g_t_by_p = safe_lookup(tbl_t.key_direct + 1, sk).astype(I32) - 1
    glen_t_by_p = safe_lookup(tbl_t.groups.group_len, g_t_by_p).astype(I32)
    t_counts = jnp.where(v1, safe_lookup(glen_t_by_p, p1).astype(I32), 0)
    c_rt = jnp.sum(t_counts.astype(jnp.int64))
    # per-key full T-chain length (domain-sized, once per strand)
    b_dom = bucket_of(hash_key(jnp.arange(tbl_t.key_direct.shape[0],
                                          dtype=U32), tbl_t.hashfun),
                      tbl_t.num_buckets)
    cbk_t = tbl_t.bucket_len[b_dom]
    # per-pair full T-chain walk: chain length of the pair's key, keyed by
    # the sorted pair-key stream p1 (keys are iota => key == p1)
    cmps_t_by_key = safe_lookup(cbk_t, sk).astype(I32)
    c_rt_cmp = jnp.sum(jnp.where(
        v1, safe_lookup(cmps_t_by_key, p1).astype(I32), 0).astype(jnp.int64))

    # expansion #2: one output per T duplicate of each pair
    gstart_t_by_p = safe_lookup(tbl_t.groups.group_start, g_t_by_p).astype(I32)
    gst_t_by_p1 = safe_lookup(gstart_t_by_p, p1).astype(I32)
    p2, w2, v2, n_rst = expand(t_counts, out2)[:4]
    gst_t = safe_lookup(gst_t_by_p1, p2).astype(I32)
    t_row = safe_lookup(tbl_t.groups.group_rows, gst_t + w2).astype(I32)
    s_prop = safe_lookup(s_row, p2).astype(I32)
    r_prop = safe_lookup(p1, p2).astype(I32)

    return dict(
        r_row=jnp.where(v2, r_prop, -1),
        s_row=jnp.where(v2, s_prop, -1),
        t_row=jnp.where(v2, t_row, -1),
        c_probe_RS=c_rs, c_probe_RS_cmp=c_rs_cmp,
        c_probe_RT=c_rt, c_probe_RT_cmp=c_rt_cmp,
        c_top=n_rst.astype(jnp.int64),
    )


@jax.jit
def nnu_strand_sorted(tbl_s, tbl_t, keys_iota):
    """Sorted exp-4 Nnu probe strand: two nested probes, no unnesting
    (mirrors ``models.exp4._nnu_probe_strand``)."""
    sk = keys_iota.astype(I32)
    skey = keys_iota.astype(U32)
    g_s, hit_s, _, pos1_s, miss_s = _keydirect_probe(tbl_s, sk, skey)
    g_t = safe_lookup(tbl_t.key_direct + 1, sk).astype(I32) - 1
    g_t = jnp.where(hit_s, g_t, -1)
    both = g_t >= 0
    pos1_t = safe_lookup(tbl_t.main_pos_by_group + 1, g_t).astype(I32)
    miss_t = _miss_chain_cmps(tbl_t.bucket_main_len, tbl_t.num_buckets,
                              skey, hit_s & ~both, tbl_t.hashfun)
    return dict(
        g_s=jnp.where(both, g_s, -1),
        g_t=jnp.where(both, g_t, -1),
        c_probe_RS=jnp.sum(hit_s.astype(jnp.int64)),
        c_probe_RS_cmp=jnp.sum(pos1_s.astype(jnp.int64)) + miss_s,
        c_probe_RT=jnp.sum(both.astype(jnp.int64)),
        c_probe_RT_cmp=jnp.sum(pos1_t.astype(jnp.int64)) + miss_t,
        c_top=jnp.sum(both.astype(jnp.int64)),
    )


@partial(jax.jit, static_argnames=("out_size", "unique", "presorted",
                                   "probes_permutation"))
def keydirect_chaining_strand_sorted(table, pk, out_size, unique=False,
                                     mask=None, presorted=False,
                                     probes_permutation=False,
                                     srow_values=None):
    """Sorted Crs-style probe strand (key_direct chaining table,
    ``algebra.hh:625-659``).

    ``unique=False``: every probe walks its full bucket chain
    (comparisons) and emits its whole key group (matches).
    ``unique=True`` (IsBuildKeyUnique): comparisons stop at the first
    match in chain order and at most one pair is emitted per probe
    (``group_chain_first`` / ``group_min_pos``, as in probe_chaining).
    ``mask`` marks live probe rows (padded shuffle outputs inside
    shard_map).  ``presorted=True``: the stream is already (block-)sorted
    with dead rows on the all-ones key -- no probe sort (see
    keydirect_nested_strand_sorted).  ``probes_permutation=True``: the
    probe keys are a permutation of [0, P) (exp-1's R.k) -- the sort
    collapses to one inverse-permutation and the key_direct image is read
    contiguously.  Emission rides the nested strand's expansion machinery.
    """
    P = pk.shape[0]
    if probes_permutation:
        assert not presorted and mask is None and srow_values is None
    if presorted:
        if mask is None:
            skey, live_s = pk.astype(U32), None
        else:
            skey = jnp.where(mask, pk.astype(U32), jnp.uint32(0xFFFFFFFF))
            live_s = mask
        srow = (jnp.arange(P, dtype=I32) if srow_values is None
                else srow_values.astype(I32))
    elif mask is not None:
        pk_m = jnp.where(mask, pk.astype(U32), jnp.uint32(0xFFFFFFFF))
        skey, live_s, srow = lax.sort(
            (pk_m, mask.astype(I32), jnp.arange(P, dtype=I32)), num_keys=1)
        live_s = live_s > 0
    elif probes_permutation:
        # sorted(permutation of [0, P)) == iota; srow == inverse permutation
        # (exp-1's R.k, main_experiment1.cc:425-428) -- no probe sort, and
        # the key_direct image needs no lookup at all
        from .layout import inverse_permute
        skey = jnp.arange(P, dtype=U32)
        srow = inverse_permute(pk.astype(I32), jnp.arange(P, dtype=I32))
        live_s = None
    else:
        skey, srow = _sort_probes(pk, domain=table.key_direct.shape[0])
        live_s = None
    sk = skey.astype(I32)

    if probes_permutation:
        kd = table.key_direct
        dom = kd.shape[0]
        g = (kd[:P] if P <= dom
             else jnp.concatenate([kd, jnp.full(P - dom, -1, I32)]))
    else:
        g = safe_lookup(table.key_direct + 1, sk).astype(I32) - 1
    hit = g >= 0
    glen = safe_lookup(table.groups.group_len, g).astype(I32)

    if unique:
        if table.group_min_pos.shape[0] == 0:
            raise ValueError(
                "table was built with early_exit_index=False; "
                "IsBuildKeyUnique probes need the chain-position index")
        counts = hit.astype(I32)
        m = jnp.sum(hit.astype(jnp.int64))
        pos1 = safe_lookup(table.group_min_pos + 1, g).astype(I32)
        miss = (~hit) if live_s is None else (live_s & ~hit)
        miss_cmps = _miss_chain_cmps(table.bucket_len, table.num_buckets,
                                     skey, miss, table.hashfun)
        cmps = jnp.sum(pos1.astype(jnp.int64)) + miss_cmps
        # emission source: the first matching row in chain order
        row_by_p = safe_lookup(table.group_chain_first + 1, g) - 1
    else:
        counts = glen
        m = jnp.sum(glen.astype(jnp.int64))
        # full-chain comparisons for every LIVE probe: bucket chain lengths
        b = bucket_of(hash_key(skey, table.hashfun),
                      table.num_buckets).astype(I32)
        if live_s is not None:
            b = jnp.where(live_s, b, -1)
        cmps = jnp.sum(safe_lookup(table.bucket_len, b).astype(jnp.int64))
        row_by_p = None

    gstart_by_p = safe_lookup(table.groups.group_start, g).astype(I32)
    p, within, valid, total = expand(counts, out_size)[:4]
    if unique:
        build_row = safe_lookup(row_by_p, p).astype(I32)
    else:
        gst = safe_lookup(gstart_by_p, p).astype(I32)
        build_row = safe_lookup(table.groups.group_rows,
                                gst + within).astype(I32)
    probe_row = safe_lookup(srow, p).astype(I32)
    return dict(
        probe_row=jnp.where(valid, probe_row, -1),
        build_row=jnp.where(valid, build_row, -1),
        total=total.astype(jnp.int64),
        c_htProbe=m, c_htProbeCmp=cmps,
    )
