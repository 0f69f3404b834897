"""Shared CSR layout builders: the vectorized replacement for linked-list hash tables.

The reference implements two pointer-chasing hash tables (``ht_chaining.hh:38-158``,
``ht_nested.hh:71-251``) built one tuple at a time from a ``Reservoir`` arena.
Here both tables are *dense index arrays* (CSR) constructed with sorts, segment
boundaries and prefix sums -- whole-column ops with no pointer chasing.  Stable
addresses come for free because everything is an index into a dense array
(replacing ``util/reservoir.hh:11-233``).

Semantics preserved exactly (so the reference's measurement counters can be
reproduced bit-for-bit):

* bucket of a key  = ``murmur32(key) % num_buckets``   (``ht_chaining.hh:139-140``)
* chaining chain order per bucket = [first-inserted row, then remaining rows in
  LIFO / reverse insertion order]  (head-insert after the directory entry,
  ``ht_chaining.hh::insert``)
* nested main-chain order per bucket = distinct keys by first-occurrence order
  (new MainNodes append at the tail, ``ht_nested.hh:286-311``)
* nested sub-chain / unnest order per key = [first-inserted row, then remaining
  duplicates in LIFO order]  (``ht_nested.hh:398-412``, ``algebra.hh:510-541``)

All shapes are static: arrays are sized by row count ``n`` (the maximum possible
number of distinct keys) and padded; ``n_keys`` is a traced scalar.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

I32 = jnp.int32
U32 = jnp.uint32

#: Padding sentinel for the sorted-unique-key array.  Padded entries sort last;
#: a probe key can only "hit" a padded slot if it equals a real key with the
#: same value that sorts immediately before the padding, in which case
#: ``searchsorted(..., side='left')`` returns the real slot first.
UKEY_PAD = jnp.uint32(0xFFFFFFFF)


def canon_key_dtype(keys: jax.Array):
    """Canonical unsigned key dtype: 8-byte inputs stay u64, the rest u32.

    The engine is dtype-generic over 32- and 64-bit keys (the reference
    templates over arbitrary key types, e.g. ``HashMurmur<uint64_t>``);
    composite keys pack into u64 via :func:`pack2u32`.
    """
    return jnp.uint64 if jnp.dtype(keys.dtype).itemsize == 8 else U32


def ukey_pad(dtype):
    """All-ones padding sentinel in the given unsigned key dtype."""
    return jnp.array(jnp.iinfo(dtype).max, dtype)


def pack2u32(hi: jax.Array, lo: jax.Array) -> jax.Array:
    """Pack a composite (hi, lo) u32 key pair into one u64 join key."""
    return ((jnp.asarray(hi).astype(jnp.uint64) << jnp.uint64(32))
            | jnp.asarray(lo).astype(jnp.uint64))


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class GroupIndex:
    """Distinct-key directory + CSR group storage over the build rows.

    This single structure is the vectorized analogue of the nested hash table's
    MainNode/SubNode layout (``ht_nested.hh:111-183``): one logical entry per
    distinct key, with the duplicate rows of that key stored contiguously.
    The chaining table reuses it as its match index.

    All arrays have length ``n`` (row count); entries with index >= n_keys are
    padding.
    """

    ukey: jax.Array        # u32[n]  distinct keys, ascending, padded with UKEY_PAD
    group_start: jax.Array  # i32[n]  offset of each key's rows in group_rows
    group_len: jax.Array    # i32[n]  number of rows per key (0 for padding)
    group_rows: jax.Array   # i32[n]  build row ids per key, ASCENDING (the
    #   stable key sort's row payload verbatim -- storing emission order
    #   would cost an n-sized permutation scatter per build; consumers
    #   recover the [first, rest LIFO] chain order with
    #   :func:`emit_pos` instead)
    first_row: jax.Array    # i32[n]  first-inserted row id per key (MainNode._data)
    gid_by_row: jax.Array   # i32[n]  group id of each build row
    n_keys: jax.Array       # i32[]   number of distinct keys (traced)

    @property
    def n_rows(self) -> int:
        return self.group_rows.shape[0]


def key_group_index(keys: jax.Array, valid: jax.Array | None = None) -> GroupIndex:
    """Group build rows by exact key value; duplicates ordered [first, rest LIFO].

    Vectorized equivalent of repeatedly calling ``HtNested1::insert``
    (``ht_nested.hh:286-311``): a sort by (key, row) + run-length boundaries
    replaces the per-tuple directory walk, and a bijective scatter produces the
    sub-chain emission order without building linked lists.

    ``valid`` marks live rows (used for padded shuffle outputs and filtered
    batches); invalid rows join no group (``gid_by_row == -1``).  The masked
    path costs one extra sort key.
    """
    keys = keys.astype(canon_key_dtype(keys))
    n = keys.shape[0]
    row = jnp.arange(n, dtype=I32)

    if valid is None:
        # Stable sort by key keeps rows ascending within each duplicate run.
        skey, srow = lax.sort((keys, row), num_keys=1, is_stable=True)
        vs = None
        n_valid = jnp.int32(n)
    else:
        inv = (~valid).astype(I32)
        # Major key: validity (invalid rows sort last); minor: key value.
        _, skey, srow = lax.sort((inv, keys, row), num_keys=2, is_stable=True)
        n_valid = (n - jnp.sum(inv)).astype(I32)
        vs = jnp.arange(n, dtype=I32) < n_valid  # valid in sorted order

    # Scan-based run structure: per-sorted-row run_start/run_len come from
    # cummax/cummin (no [gid] gathers, no jnp.nonzero(size=)).
    is_first, gid, run_start, run_len = run_boundaries(skey, n_valid)
    n_keys = jnp.maximum(gid[-1] + 1, 0)

    i_sorted = jnp.arange(n, dtype=I32)
    if _headcompact_use_sort():
        # Stable partition by ~is_first: the heads land first, in ascending
        # group-id order, and the payload slots deliver every directory
        # column in one sort -- no scatters and no n-sized gathers for
        # ukey/first_row.
        _, start_c, len_c, ukey_c, first_c = lax.sort(
            ((~is_first).astype(I32), i_sorted, run_len.astype(I32),
             skey, srow), num_keys=1, is_stable=True)
        live = i_sorted < n_keys
        group_start = jnp.where(live, start_c, n)
        group_len = jnp.where(live, len_c, 0)
        ukey = jnp.where(live, ukey_c, ukey_pad(skey.dtype))
        first_row = jnp.where(live, first_c, n).astype(I32)
    else:
        tgt_head = jnp.where(is_first, gid, n)
        group_start = (jnp.full(n + 1, n, I32)
                       .at[tgt_head].set(i_sorted, mode="drop")[:n])
        group_len = (jnp.zeros(n + 1, I32)
                     .at[tgt_head].set(run_len.astype(I32), mode="drop")[:n])

        gvalid = group_start < n
        ukey = jnp.where(gvalid, skey[jnp.minimum(group_start, n - 1)],
                         ukey_pad(skey.dtype))
        first_row = jnp.where(
            gvalid, srow[jnp.minimum(group_start, n - 1)], n).astype(I32)

    # group_rows stays in sorted order (= srow verbatim; invalid rows sit
    # at the tail already); the [first, rest LIFO] emission order
    # (head-insert into the sub-chain, ht_nested.hh:398-412) is recovered
    # arithmetically by consumers via emit_pos() -- dropping the n-sized
    # permutation scatter this used to cost.
    group_rows = srow

    gid_eff = gid if vs is None else jnp.where(vs, gid, -1)
    gid_by_row = inverse_permute(srow, gid_eff)

    return GroupIndex(
        ukey=ukey,
        group_start=group_start,
        group_len=group_len,
        group_rows=group_rows,
        first_row=first_row,
        gid_by_row=gid_by_row,
        n_keys=n_keys.astype(I32),
    )


def run_boundaries(skey: jax.Array, n_valid):
    """Run-length structure of a sorted key column, gather-free.

    Returns ``(is_first, gid, run_start, run_len)`` per sorted element, all
    computed with scans (cumsum / cummax / reverse-cummin).
    """
    from .scan import engine_multi_scan

    n = skey.shape[0]
    n_valid = jnp.asarray(n_valid).astype(I32)  # callers may pass int64 sums
    i = jnp.arange(n, dtype=I32)
    vs = i < n_valid
    is_first = jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
    is_first = is_first & vs
    # one forward scan bundle (cumsum + cummax) and one reverse scan
    gid1, run_start = engine_multi_scan(
        (is_first.astype(I32), jnp.where(is_first, i, -1)), ("sum", "max"))
    gid = gid1 - 1
    # start of the NEXT run, filled from the right
    nxt = jnp.concatenate([jnp.where(is_first, i, n)[1:], jnp.array([n], I32)])
    (nxt_min,) = engine_multi_scan((nxt,), ("min",), reverse=True)
    next_start = jnp.minimum(nxt_min, n_valid)
    run_len = jnp.where(vs, next_start - run_start, 0)
    return is_first, gid, run_start, run_len


#: Directory head-compaction formulation: "auto" (device -> sort, cpu ->
#: scatter), "scatter" (n-update narrow scatter at the run heads), or "sort"
#: (stable 1-bit partition: run heads already appear in ascending group-id
#: order, so a stable ``lax.sort`` keyed on ``~is_first`` compacts their
#: positions -- and, on the padded path, carries run_len/srow/skey as
#: payload slots, replacing two scatters AND two n-sized directory gathers
#: with one multi-operand sort).  Which one wins on the GPU is not yet
#: measured.  Binds at trace time; tools/buildprof.py A/Bs the formulations.
_HEADCOMPACT_IMPL = "auto"


def set_headcompact_impl(impl: str) -> None:
    """Select the directory head-compaction formulation
    ("auto"|"scatter"|"sort")."""
    global _HEADCOMPACT_IMPL
    assert impl in ("auto", "scatter", "sort"), impl
    _HEADCOMPACT_IMPL = impl


def _headcompact_use_sort() -> bool:
    impl = _HEADCOMPACT_IMPL
    if impl == "auto":
        impl = "scatter" if jax.default_backend() == "cpu" else "sort"
    return impl == "sort"


#: Inverse-permutation formulation: "auto" (device -> sort, cpu -> scatter),
#: "scatter" (XLA scatter) or "sort" (one 2-op ``lax.sort``).  Which one
#: wins on the GPU is not yet measured.  Flip for benchmarking with
#: :func:`set_invperm_impl`; binds at trace time.
_INVPERM_IMPL = "auto"


def set_invperm_impl(impl: str) -> None:
    """Select the inverse-permutation formulation ("auto"|"scatter"|"sort")."""
    global _INVPERM_IMPL
    assert impl in ("auto", "scatter", "sort"), impl
    _INVPERM_IMPL = impl


def inverse_permute(perm: jax.Array, vals: jax.Array) -> jax.Array:
    """``out[perm[i]] = vals[i]`` for ``perm`` an EXACT permutation of [0, n).

    The builds' inverse-permutation primitive (row-order recovery of values
    computed in sort order: ``pos_by_row``, ``gid_by_row``, dense-direct
    images).  Two formulations, selected by :func:`set_invperm_impl`:

    * scatter: ``zeros(n).at[perm].set(vals)``.
    * sort: ``lax.sort((perm, vals))`` -- a permutation sorted ascending IS
      iota, so the co-sorted payload lands in ``out[perm[i]]`` order.

    The contract is strict: every output position written exactly once (no
    sentinels, no drops).  All call sites pass a sort's row payload or a
    verified dense-direct key permutation.
    """
    impl = _INVPERM_IMPL
    if impl == "auto":
        impl = "scatter" if jax.default_backend() == "cpu" else "sort"
    if impl == "sort":
        return lax.sort((perm.astype(I32), vals), num_keys=1,
                        is_stable=False)[1]
    return jnp.zeros(perm.shape[0], vals.dtype).at[perm].set(vals)


@partial(jax.jit, static_argnames=("cap", "with_gid_by_row"))
def compact_group_index(keys: jax.Array, skey: jax.Array, srow: jax.Array,
                        cap: int, with_gid_by_row: bool = False,
                        row_values: jax.Array | None = None) -> GroupIndex:
    """Build a GroupIndex with *compacted* directory arrays (length ``cap``).

    Second phase of the two-phase host build: the caller sorted the keys
    (phase 1), read ``n_keys`` on the host, and picked a static ``cap``.  All
    group attributes scatter into the compact directory in ONE stacked write;
    large random gathers are avoided entirely (boundaries come from scans).

    ``row_values``: alternate per-sorted-row ids to emit as ``group_rows``
    (already key-sorted, i.e. rode the phase-1 sort as a payload).
    Distributed builds pass the GLOBAL row ids here so probe strands emit
    global coordinates directly -- without this, every shard-local result
    row pays an id-mapping gather after the probe.
    """
    n = keys.shape[0]
    kd = skey.dtype
    i = jnp.arange(n, dtype=I32)
    is_first, gid, run_start, run_len = run_boundaries(skey, jnp.int32(n))

    # group_rows in sorted order (see GroupIndex docstring / emit_pos)
    group_rows = srow if row_values is None else row_values.astype(I32)

    # Directory via ONE narrow head-position compaction + cap-sized
    # gathers at the (ascending) head positions hp.
    if n == 0:
        ukey = jnp.full(cap, ukey_pad(kd), kd)
        group_start = jnp.zeros(cap, I32)
        group_len = jnp.zeros(cap, I32)
        first_row = jnp.zeros(cap, I32)
    else:
        pad = jnp.arange(cap, dtype=I32) >= jnp.minimum(gid[-1] + 1, cap)
        if _headcompact_use_sort():
            # stable 1-bit partition: head positions compact in gid order
            _, s_i = lax.sort(((~is_first).astype(I32), i), num_keys=1,
                              is_stable=True)
            head_c = (s_i[:cap] if cap <= n else
                      jnp.concatenate([s_i, jnp.full(cap - n, n, I32)]))
            head = jnp.where(pad, n, head_c)
        else:
            tgt = jnp.where(is_first, gid, cap)
            head = (jnp.full(cap + 1, n, I32)
                    .at[tgt].set(i, mode="drop")[:cap])
        hp = jnp.minimum(head, n - 1)
        ukey = jnp.where(pad, ukey_pad(kd), skey[hp])
        group_start = jnp.where(pad, n, head)
        group_len = jnp.where(pad, 0, run_len[hp].astype(I32))
        first_row = jnp.where(pad, n, srow[hp].astype(I32))

    if with_gid_by_row:
        gid_by_row = inverse_permute(srow, gid)
    else:
        gid_by_row = jnp.zeros(0, I32)  # not materialized (saves one scatter)

    return GroupIndex(
        ukey=ukey,
        group_start=group_start,
        group_len=group_len,
        group_rows=group_rows,
        first_row=first_row,
        gid_by_row=gid_by_row,
        n_keys=jnp.maximum(gid[-1] + 1, 0).astype(I32),
    )


def drop_pad_groups(groups: "GroupIndex") -> "GroupIndex":
    """Kill any group whose key is the all-ones pad value ``ukey_pad``.

    Callers that park dead rows on the impossible key (padded shuffle
    receives: ``parallel.shuffle.partition_exchange`` fills dead slots with
    the all-ones key) can run the unmasked fused build and drop the one
    sentinel group here: its ``group_len`` goes to 0 (so it enters no
    bucket, matches no probe and expands to nothing) and ``n_keys`` stops
    counting it.  Directory *padding* slots already carry the pad key with
    ``group_len == 0`` and are unaffected.
    """
    import dataclasses
    dead = groups.ukey == ukey_pad(groups.ukey.dtype)
    live_sentinel = dead & (groups.group_len > 0)
    return dataclasses.replace(
        groups,
        group_len=jnp.where(dead, 0, groups.group_len),
        n_keys=(groups.n_keys
                - jnp.sum(live_sentinel.astype(I32))).astype(I32),
    )


@jax.jit
def is_sorted_ascending(keys: jax.Array) -> jax.Array:
    """True iff ``keys`` is already ascending -- one fused reduction read.

    The check is one read pass, far cheaper than the sort it lets
    :func:`sort_rows_maybe_skip` skip, so every build and probe strand runs
    it unconditionally.
    """
    if keys.shape[0] < 2:
        return jnp.bool_(True)
    return jnp.all(keys[1:] >= keys[:-1])


def sort_rows_maybe_skip(keys: jax.Array, *payloads: jax.Array):
    """Stable ``lax.sort((keys, arange, *payloads))`` that skips itself at
    runtime when ``keys`` is already ascending (one ``lax.cond`` on
    :func:`is_sorted_ascending`).

    Presorted key columns are common -- clustered primary keys, the output
    of a previous sorted operator, merge-exchange streams -- and the phase-1
    sort is a large term of every build and unsorted-probe strand.
    Skipping is exact: a STABLE
    sort of an ascending stream returns the stream itself with
    ``srow == arange`` and payloads untouched, so counters and chain-order
    semantics are bit-identical (the reference has no such fast path; its
    per-tuple inserts cost the same either way, ``ht_chaining.hh::insert``).
    """
    n = keys.shape[0]
    # ``keys ^ keys`` is zero but carries the keys' device-varying type, so
    # under shard_map both cond branches return identically-typed (varying)
    # outputs -- a bare arange is replicated and trips the vma type check
    vzero = keys ^ keys
    row = jnp.arange(n, dtype=I32) + vzero.astype(I32)
    ops = (keys, row,
           *(p + vzero.astype(p.dtype) for p in payloads))
    return lax.cond(
        is_sorted_ascending(keys),
        lambda o: o,
        lambda o: lax.sort(o, num_keys=1, is_stable=True),
        ops)


@jax.jit
def sort_with_rows(keys: jax.Array):
    """Phase 1 of the host build: sort keys with row payload + count distinct."""
    keys = keys.astype(canon_key_dtype(keys))
    skey, srow = sort_rows_maybe_skip(keys)
    n_keys = jnp.sum(
        jnp.concatenate([jnp.ones((1,), bool), skey[1:] != skey[:-1]])
        .astype(I32))
    return skey, srow, n_keys


def safe_lookup(values: jax.Array, keys: jax.Array) -> jax.Array:
    """``values[keys]``, with 0 wherever a key is < 0 or >= len(values).

    The strands' one table-access primitive: a plain gather.  ``keys`` of
    any integer dtype are read as i32, so u32 keys >= 2^31 miss like
    negative ones.  The result keeps ``values``' dtype.
    """
    T = values.shape[0]
    k = keys.astype(I32)
    if T == 0:
        return jnp.zeros(k.shape, values.dtype)
    hit = (k >= 0) & (k < T)
    return jnp.where(hit, values[jnp.clip(k, 0, T - 1)],
                     jnp.zeros((), values.dtype))


def lookup(groups: "GroupIndex", probe_keys: jax.Array):
    """Find each probe key's group id in a GroupIndex.

    Returns ``(g, hit)``: candidate group id (i32) and a boolean hit mask.
    Binary search over the sorted distinct keys -- O(log n_keys) vectorized
    gathers, independent of duplicate counts (the 3D hash join property:
    probe cost scales with #distinct keys, not #rows, ``ht_nested.hh:354-382``).

    A hit additionally requires a non-empty group: padded directory slots carry
    ``UKEY_PAD == 0xFFFFFFFF``, which a probe key may legitimately equal, but
    padding always has ``group_len == 0`` (and a real key of that value sorts
    before its padding, so ``side='left'`` finds the real slot first).
    """
    pk = probe_keys.astype(groups.ukey.dtype)
    g = jnp.searchsorted(groups.ukey, pk, side="left").astype(I32)
    g = jnp.minimum(g, groups.ukey.shape[0] - 1)
    hit = (groups.ukey[g] == pk) & (groups.group_len[g] > 0)
    return g, hit


def merge_lookup(groups: "GroupIndex", probe_keys: jax.Array,
                 mask: jax.Array | None = None):
    """Sort-merge alternative to :func:`lookup` -- same ``(g, hit)`` contract.

    A binary search is ~log2(n_keys) dependent random gathers per probe;
    the merge instead streams: concatenate the sorted distinct keys with the probe keys,
    sort once (stable; directory entries precede equal probe keys), propagate
    the last-seen directory entry with cumulative maxima, and scatter results
    back to probe positions.
    """
    pk = probe_keys.astype(groups.ukey.dtype)
    n = groups.ukey.shape[0]
    P = pk.shape[0]

    vals = jnp.concatenate([groups.ukey, pk])
    # padding directory slots (group_len == 0) must not shadow a real trailing
    # key of the same value: exclude them from the directory side entirely
    dir_gid = jnp.where(groups.group_len > 0, jnp.arange(n, dtype=I32), -1)
    gid_in = jnp.concatenate([dir_gid, jnp.full(P, -1, I32)])
    row_in = jnp.concatenate([jnp.full(n, -1, I32), jnp.arange(P, dtype=I32)])
    svals, sgid, srow = lax.sort((vals, gid_in, row_in), num_keys=1,
                                 is_stable=True)

    is_dir = sgid >= 0
    g_prop = lax.cummax(sgid, 0)                       # last directory gid
    k_prop = lax.cummax(jnp.where(is_dir, svals, 0), 0)  # last directory key
    hit_s = (~is_dir) & (k_prop == svals) & (g_prop >= 0)

    # scatter back to probe positions; directory entries (srow == -1) must
    # target out-of-range so mode="drop" discards them (clamping to 0 would
    # clobber probe 0's result)
    tgt = jnp.where(srow >= 0, srow, P)
    g = jnp.zeros(P, I32).at[tgt].set(jnp.maximum(g_prop, 0), mode="drop")
    hit = jnp.zeros(P, bool).at[tgt].set(hit_s, mode="drop")
    # padding directory slots carry group_len 0; exclude them like lookup()
    hit = hit & (groups.group_len[g] > 0)
    if mask is not None:
        hit = hit & mask
    return g, hit


def lookup_auto(groups: "GroupIndex", probe_keys: jax.Array,
                method: str = "auto"):
    """Dispatch between binary-search and sort-merge lookup.

    "auto" takes the binary search on the CPU and the sort-merge path on an
    accelerator; which one wins on the GPU is not yet measured.
    ``method``: "auto" | "search" | "merge".
    """
    if method == "auto":
        method = "search" if jax.default_backend() == "cpu" else "merge"
    if method == "merge":
        return merge_lookup(groups, probe_keys)
    return lookup(groups, probe_keys)


def key_direct_index(groups: "GroupIndex", key_domain: int) -> jax.Array:
    """Dense key->group map over a statically known domain [0, key_domain).

    ONE narrow scatter at build time buys probes a ONE-gather directory
    lookup (a merge pass sorts the probes; a binary search costs
    log2(n_keys) gathers).  ``-1`` marks
    absent keys.  ``key_domain`` must be a true upper bound on build key
    values + 1 -- keys at or beyond it would become unreachable.
    """
    cap = groups.ukey.shape[0]
    ok = (groups.group_len > 0) & (groups.ukey < key_domain)
    tgt = jnp.where(ok, groups.ukey.astype(I32), key_domain)
    return (jnp.full(key_domain + 1, -1, I32)
            .at[tgt].set(jnp.arange(cap, dtype=I32), mode="drop")[:key_domain])


def key_direct_lookup(key_direct: jax.Array, probe_keys: jax.Array):
    """One-gather probe against a :func:`key_direct_index` map -> (g, hit)."""
    dom = key_direct.shape[0]
    pk = probe_keys.astype(canon_key_dtype(probe_keys))
    in_dom = pk < canon_key_dtype(probe_keys)(dom)
    g = jnp.where(in_dom, key_direct[jnp.minimum(pk, dom - 1)], -1)
    return jnp.maximum(g, 0), g >= 0


def emit_pos(within: jax.Array, length: jax.Array) -> jax.Array:
    """Within-group offset into the ASCENDING ``group_rows`` for emission
    slot ``within`` of a group of ``length`` rows.

    The reference emits [first-inserted row, then remaining duplicates in
    LIFO order] (head-insert, ``ht_chaining.hh::insert`` /
    ``ht_nested.hh:398-412``; unnest ``algebra.hh:510-541``).  Rows ascend
    within each sorted-key run (stable sort), so emission slot 0 reads
    offset 0 and slot w>0 reads offset ``length - w``.
    """
    return jnp.where(within == 0, 0, length - within)


def shrink_group_arrays(arrays: tuple, cap: int):
    """Slice group-indexed arrays to a compile-time capacity.

    Directory arrays are allocated at row count n (the worst-case distinct-key
    count); once the true ``n_keys`` is known (one host sync after the build),
    slicing to the next power of two >= n_keys shrinks every downstream probe
    sort/search from O(n) to O(n_keys).  Valid groups occupy a prefix (group
    ids are assigned in sorted-key order), so plain slices are exact.
    """
    return tuple(a[:cap] for a in arrays)


def group_capacity(n_keys: int, n: int) -> int:
    """Next power of two >= n_keys (bounded by n)."""
    return min(max(1, 1 << (int(n_keys) - 1).bit_length()), n)


def sorted_histogram(b_sorted: jax.Array, num_buckets: int,
                     is_first: jax.Array, run_len: jax.Array):
    """Bucket histogram from an already-sorted bucket column.

    When the column is already sorted (every build does a bucket sort
    anyway), the histogram needs no scatter-ADD (``jnp.bincount``): scatter
    each run's length at its head with a plain ``set``.  Values sorted to
    position >= ``num_buckets`` (validity parking) fall off the extended slot.

    ``is_first``/``run_len`` come from :func:`run_boundaries` over the same
    sorted column.  Returns ``(bucket_start, bucket_len)``, both i32[nb].
    """
    tgt = jnp.where(is_first, b_sorted.astype(I32), num_buckets)
    blen = (jnp.zeros(num_buckets + 1, I32).at[tgt]
            .set(run_len.astype(I32), mode="drop")[:num_buckets])
    bstart = (jnp.cumsum(blen) - blen).astype(I32)
    return bstart, blen


def expand(counts: jax.Array, out_size: int, payloads: tuple = (),
           with_seg_len: bool = False):
    """Variable-count segment expansion to a static-size output buffer.

    Maps output slot j to (segment p, position-within-segment, valid).  This is
    the vectorized unnest (``algebra.hh:510-541``): instead of a per-tuple
    while-loop over SubNodes, every output row materializes in parallel.

    Formulation: ONE segment-sized scatter marks each non-empty segment's
    rank at its first output slot; a cumulative max fills the segment ids
    forward; and everything else -- the segment's start offset, every
    propagated payload, the optional segment length -- is a gather keyed by
    the resulting NONDECREASING ``p`` stream.

    ``payloads``: optional per-segment i32 arrays to propagate to every
    output slot of their segment (``pay[p]``; bit patterns are carried
    exactly, so negative markers survive).

    ``with_seg_len`` appends the expansion segment's length per output slot
    (== ``counts[p]`` whenever the segment is fully materialized; the last
    segment of a truncated expansion reports its CUT length) -- one more
    gather of the segment-end offsets (the emit_pos consumers need this).

    Returns ``(p, within, valid, total, *propagated_payloads[, seg_len])``.
    """
    counts = counts.astype(I32)
    P = counts.shape[0]
    cum = jnp.cumsum(counts)
    total = cum[-1] if P > 0 else jnp.int32(0)
    off = (cum - counts).astype(I32)

    from .scan import engine_multi_scan

    is_head = counts > 0
    tgt = jnp.where(is_head, off, out_size)  # empty segments scatter off-end
    rank = jnp.arange(P, dtype=I32)
    head_p = jnp.full(out_size, -1, I32).at[tgt].set(rank, mode="drop")
    (p,) = engine_multi_scan((head_p,), ("max",))
    j = jnp.arange(out_size, dtype=I32)
    valid_p = p >= 0
    pc = jnp.maximum(p, 0)

    start = safe_lookup(off, pc)
    within = j - start
    valid = (j < total) & valid_p

    props = [safe_lookup(jnp.asarray(pay, I32), pc) for pay in payloads]
    if with_seg_len:
        # segment end = cum[p], capped by the materialized buffer and the
        # true total; distance to start IS the (possibly cut) length
        seg_end = safe_lookup(cum.astype(I32), pc)
        seg_end = jnp.minimum(seg_end,
                              jnp.minimum(jnp.int32(out_size),
                                          total.astype(I32)))
        props.append(jnp.maximum(seg_end - start, 0))

    return (pc, within, valid, total, *props)
