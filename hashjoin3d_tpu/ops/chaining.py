"""Chaining hash-table equivalent: build + vectorized probe with exact counters.

Vectorized re-design of ``HtChaining1`` (``ht_chaining.hh:38-158``) and of the
``AlgHashJoinBuild`` / ``AlgHashJoinProbe`` operators (``algebra.hh:556-672``).

The reference stores one 24-byte Node per build row in bucket chains and probes
tuple-at-a-time, walking the chain and counting one comparison per node visited
(``algebra.hh:644-658``).  Probe cost therefore grows with duplicates-per-key.
Here the table is a dense CSR layout (see ``layout.py``); the probe is a
whole-column pipeline (hash -> bucket gather -> binary-search match) whose
*measured* counters reproduce the reference semantics exactly:

* ``num_cmps``  - sum over probe tuples of the chain length walked:
    - no early exit (``IsBuildKeyUnique=False``): full chain, i.e.
      ``bucket_len[bucket(probe)]`` (0 when the bucket is empty -- the reference
      returns before counting, ``algebra.hh:640-643``);
    - early exit (``IsBuildKeyUnique=True``, ``algebra.hh:653-655``): the 1-based
      chain position of the first matching node, or the full chain length on a
      miss.
* ``num_matches`` - emitted result tuples (``AlgBase::_count`` of the probe op).

Chain positions are derived analytically from insertion order: the directory
node holds the bucket's first-inserted row and later rows head-insert behind it
(``ht_chaining.hh::insert``), so chain order is [first, rest reversed].

Result-set note: materialized join outputs are bit-exact as *multisets*; the
per-probe emission order follows the key-group layout rather than the bucket
chain interleaving (an artifact of the reference's linked lists; see SURVEY.md
section 7.4).
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
class ChainingTable:
    """Dense chaining-hash-table state (the ``hashtable()`` of a build op).

    ``num_buckets`` is static (compile-time), mirroring the reference's
    constructor argument (``algebra.hh:566-567``).
    """

    groups: GroupIndex        # distinct-key directory + CSR duplicate groups
    bucket_start: jax.Array   # i32[nb]
    bucket_len: jax.Array     # i32[nb]
    pos_by_row: jax.Array     # i32[n] 0-based chain position of each build row
    group_min_pos: jax.Array  # i32[n] min chain position among each key's rows
    group_chain_first: jax.Array  # i32[n] row at that min position (first match
    #                                       in chain order, for early-exit emit)
    keys: jax.Array           # u32[n] original build key column
    num_buckets: int = field(metadata=dict(static=True), default=1)
    # Adaptive dense-direct layout (physical index selection): when the build
    # keys are a permutation of [0, n) -- experiment 1's R.k by construction
    # (main_experiment1.cc:425-428) -- probing needs no hash directory at all:
    # ``direct[key]`` packs (build row | (chain_pos+1) << shift), turning the
    # probe into ONE vector gather.  Validated host-side by
    # ``can_use_dense_direct``; None when not applicable.
    direct: jax.Array | None = None      # u32[n] packed (row | pos1 << shift)
    direct_shift: int = field(metadata=dict(static=True), default=0)
    # Dense key-domain index (the FK-side analogue of ``direct``): when build
    # keys live in a small, statically known domain [0, domain) -- experiment
    # FK columns by construction (fkMax, main_experiment1.cc:190) -- a
    # ``key value -> group id`` array turns the probe's directory lookup into
    # ONE gather (vs a merge sort pass or log2(n_keys) search gathers).
    # Non-unique keys are fine (it maps to the GROUP).  -1 = key absent.
    key_direct: jax.Array | None = None  # i32[domain]
    # Per-key full-chain length (``bucket_len[bucket_of(key)]``), built on
    # demand for plans that count full chain walks on every probe (CsrUU):
    # turns the probe's comparison counting into one gather per probe.
    chain_by_key: jax.Array | None = None  # i32[n] (dense-direct tables)
    # Bucket-assignment functor (the reference's pluggable ``Thashfun``,
    # ``ht_chaining.hh:236-248``): a HASH_FUNCTORS name or traceable
    # callable.  Probes read it from here so build/probe always agree.
    hashfun: str = field(metadata=dict(static=True), default="murmur")

    @property
    def size(self):
        """Row count (the reference's ``size()``: number of inserted nodes)."""
        return self.keys.shape[0]

    def memory_consumption(self) -> dict:
        """HBM bytes held by this table, split like the reference's
        ``memoryConsupmtion{,Dir,Chains}`` (``ht_chaining.hh:161-177``).

        ``dir``: the per-bucket arrays (the reference's ``numBuckets *
        sizeof(Node)`` hash directory); ``chains``: everything row- or
        group-sized (the reference's reservoir of chain nodes -- here the CSR
        group index, chain-position index and the optional dense-direct /
        key-domain indexes).  ``total = dir + chains``.  Sizes are the actual
        device-array footprints (``nbytes``), so layout optimizations (slim
        builds, skipped early-exit index) are reflected truthfully.
        """
        dir_bytes = self.bucket_start.nbytes + self.bucket_len.nbytes
        g = self.groups
        chain_arrays = [self.pos_by_row, self.group_min_pos,
                        self.group_chain_first, self.keys, g.ukey,
                        g.group_start, g.group_len, g.group_rows, g.first_row,
                        g.gid_by_row, self.direct, self.key_direct,
                        self.chain_by_key]
        chains_bytes = sum(a.nbytes for a in chain_arrays if a is not None)
        return dict(total=dir_bytes + chains_bytes, dir=dir_bytes,
                    chains=chains_bytes)


def can_use_dense_direct(keys_np, num_buckets: int,
                         hashfun="murmur") -> bool:
    """Host-side check that the dense-direct layout is exact for these keys.

    Requires: keys are a permutation of [0, n) with n a power of two, and the
    deepest chain position + 1 fits the packing bits above the row field.
    """
    import numpy as np

    from .hashing import hash_key_np

    keys_np = np.asarray(keys_np)
    n = keys_np.size
    if keys_np.dtype.itemsize == 8:
        # 64-bit keys bucket with murmur64 (hash_key); the occupancy bound
        # below would test the wrong hash's histogram, and the packed direct
        # word is u32 -- dense-direct stays a 32-bit-key layout.
        return False
    if n == 0 or (n & (n - 1)) != 0:
        return False
    if keys_np.max() != n - 1 or np.bincount(keys_np, minlength=n).max() != 1:
        return False
    shift = n.bit_length() - 1
    occ = np.bincount(hash_key_np(keys_np.astype(np.uint32), hashfun)
                      % np.uint32(num_buckets))
    return int(occ.max()) < (1 << (32 - shift))


@partial(jax.jit, static_argnames=("num_buckets", "dense_direct",
                                   "key_domain", "hashfun",
                                   "early_exit_index"))
def build_chaining(keys: jax.Array, num_buckets: int,
                   valid: jax.Array | None = None,
                   dense_direct: bool = False,
                   key_domain: int | None = None,
                   hashfun="murmur",
                   early_exit_index: bool = True) -> ChainingTable:
    """Build the chaining table from a build-side key column.

    Equivalent of scanning the build relation through ``AlgHashJoinBuild::step``
    (``algebra.hh:574-577``) -- but as two sorts + histograms instead of n
    pointer insertions into a ``Reservoir`` arena.  ``valid`` marks live rows
    (padded shuffle outputs / filtered batches).  ``key_domain`` adds the
    dense key->group index (usable inside shard_map, unlike the host
    builds), enabling the sorted probe strands on distributed shards.
    """
    keys = keys.astype(canon_key_dtype(keys))
    n = keys.shape[0]
    row = jnp.arange(n, dtype=I32)

    h = hash_key(keys, hashfun)
    b = bucket_of(h, num_buckets)
    if valid is not None:
        b = jnp.where(valid, b, num_buckets)  # park invalid rows past the end

    # Chain position per row: stable sort by bucket keeps insertion (row)
    # order, giving each row its insertion rank within its bucket; the bucket
    # histogram rides the same sort (bincount's scatter-add is ~35x slower).
    from .layout import run_boundaries, sorted_histogram
    b_sorted, srow = lax.sort((b, row), num_keys=1, is_stable=True)
    vs = b_sorted < num_buckets
    is_first_b, _, run_start_b, run_len_b = run_boundaries(
        b_sorted.astype(U32), jnp.sum(vs.astype(I32)))
    bucket_start, bucket_len = sorted_histogram(
        b_sorted, num_buckets, is_first_b, run_len_b)
    rank = jnp.arange(n, dtype=I32) - run_start_b
    # insertion rank 0 -> chain pos 0 (directory node); rank p>0 -> pos len-p
    pos_sorted = jnp.where(rank == 0, 0, run_len_b - rank)
    pos_sorted = jnp.where(vs, pos_sorted, n)
    from .layout import inverse_permute
    if dense_direct or early_exit_index:
        pos_by_row = inverse_permute(srow, pos_sorted)
    else:
        # full-chain-walk probes read only bucket_len (same contract as the
        # fused/host builds' early_exit_index=False)
        pos_by_row = jnp.zeros(0, I32)

    groups = key_group_index(keys, valid)

    if early_exit_index:
        # Minimum chain position among each key's rows: the node the
        # early-exit probe stops at.
        gid_sorted = jnp.where(vs, groups.gid_by_row[srow], n - 1)
        group_min_pos = jnp.full(n, n, I32).at[gid_sorted].min(
            jnp.where(vs, pos_sorted, n))
        # The row sitting at that minimum position: due to LIFO
        # head-insertion this is the *last inserted* duplicate (or the
        # bucket's directory row), and it is the tuple an early-exit probe
        # emits (``algebra.hh:650-655``).
        is_min = vs & (pos_sorted == group_min_pos[gid_sorted])
        group_chain_first = (
            jnp.full(n, -1, I32).at[gid_sorted]
            .max(jnp.where(is_min, srow, -1)))
    else:
        group_min_pos = jnp.zeros(0, I32)
        group_chain_first = jnp.zeros(0, I32)

    direct = None
    direct_shift = 0
    if dense_direct:
        # caller has verified can_use_dense_direct(); keys are a permutation
        direct_shift = (n - 1).bit_length()
        packed = row.astype(U32) | ((pos_by_row + 1).astype(U32)
                                    << jnp.uint32(direct_shift))
        direct = inverse_permute(keys.astype(I32), packed)

    from .layout import key_direct_index
    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)

    return ChainingTable(
        key_direct=key_direct,
        groups=groups,
        bucket_start=bucket_start,
        bucket_len=bucket_len,
        pos_by_row=pos_by_row,
        group_min_pos=group_min_pos,
        group_chain_first=group_chain_first,
        keys=keys,
        num_buckets=num_buckets,
        direct=direct,
        direct_shift=direct_shift,
        hashfun=hashfun,
    )


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class ChainProbeResult:
    """Per-probe match descriptors + plan counters (all static-shape)."""

    g: jax.Array            # i32[P] candidate group per probe (or the build
    #                               row itself when from_direct)
    hit: jax.Array          # bool[P]
    match_count: jax.Array  # i32[P] tuples this probe emits
    num_matches: jax.Array  # i64[] total emitted tuples (c_htProbe)
    num_cmps: jax.Array     # i64[] total chain comparisons (c_htProbeCmp)
    from_direct: bool = field(metadata=dict(static=True), default=False)


def build_chaining_host(keys: jax.Array, num_buckets: int,
                        dense_direct: bool = False,
                        n_keys: int | None = None,
                        key_domain: int | None = None,
                        early_exit_index: bool = True,
                        full_chain_index: bool = False,
                        hashfun="murmur") -> ChainingTable:
    """Two-phase host-orchestrated build with a compacted directory.

    See :func:`hashjoin3d_tpu.ops.nested.build_nested_host` -- same structure
    (including the ``n_keys`` / ``key_domain`` hints); additionally derives
    the early-exit unique index (group_min_pos / group_chain_first) from
    compact-sized gathers instead of n-sized scatters.
    ``full_chain_index`` materializes ``chain_by_key`` on dense-direct
    builds (for plans whose probes count full chain walks, e.g. CsrUU).
    """
    from .layout import group_capacity, sort_with_rows

    if dense_direct and n_keys == keys.shape[0]:
        # permutation keys: the probe reads ONLY direct/bucket_len, so the
        # distinct-key directory need not be materialized at all
        return _build_chaining_dense(keys, num_buckets,
                                     full_chain_index=full_chain_index,
                                     hashfun=hashfun)
    if n_keys is not None:
        # sync-free: both phases fuse into one device program (one dispatch)
        cap = group_capacity(n_keys, keys.shape[0])
        return _build_chaining_fused(keys, cap, num_buckets, dense_direct,
                                     key_domain, early_exit_index, hashfun)
    skey, srow, nk = sort_with_rows(keys)
    n_keys = int(nk)  # the one host sync
    cap = group_capacity(n_keys, keys.shape[0])
    return _build_chaining_phase2(keys, skey, srow, cap, num_buckets,
                                  dense_direct, key_domain, early_exit_index,
                                  hashfun)


@partial(jax.jit, static_argnames=("num_buckets", "full_chain_index",
                                   "hashfun"))
def _build_chaining_dense(keys, num_buckets, full_chain_index=False,
                          hashfun="murmur"):
    """Slim dense-direct build: no distinct-key directory.

    Valid only for permutation keys (``can_use_dense_direct``): every probe
    path on a direct table reads ``direct``/``bucket_len`` only, and
    ``chaining_statistics`` reads ``bucket_len``/``keys``.  Skipping the key
    sort + compaction cuts the 1M-row build strand by ~30%.
    """
    from .layout import run_boundaries, sorted_histogram

    keys = keys.astype(U32)
    n = keys.shape[0]
    row = jnp.arange(n, dtype=I32)

    h = hash_key(keys, hashfun)
    b = bucket_of(h, num_buckets)
    b_sorted, srow = lax.sort((b, row), num_keys=1, is_stable=True)
    is_first_b, _, run_start_b, run_len_b = run_boundaries(
        b_sorted.astype(U32), jnp.int32(n))
    bucket_start, bucket_len = sorted_histogram(
        b_sorted, num_buckets, is_first_b, run_len_b)
    rank = jnp.arange(n, dtype=I32) - run_start_b
    pos_sorted = jnp.where(rank == 0, 0, run_len_b - rank)
    from .layout import inverse_permute
    pos_by_row = inverse_permute(srow, pos_sorted)

    direct_shift = (n - 1).bit_length()
    direct = inverse_permute(
        keys.astype(I32),
        row.astype(U32) | ((pos_by_row + 1).astype(U32)
                           << jnp.uint32(direct_shift)))

    chain_by_key = None
    if full_chain_index:
        bk2 = bucket_of(hash_key(row.astype(U32), hashfun), num_buckets)
        chain_by_key = bucket_len[bk2]

    empty = jnp.zeros(0, I32)
    groups = GroupIndex(ukey=jnp.zeros(0, U32), group_start=empty,
                        group_len=empty, group_rows=empty, first_row=empty,
                        gid_by_row=empty, n_keys=jnp.int32(n))
    return ChainingTable(
        groups=groups, bucket_start=bucket_start, bucket_len=bucket_len,
        pos_by_row=pos_by_row, group_min_pos=empty, group_chain_first=empty,
        keys=keys, num_buckets=num_buckets, direct=direct,
        direct_shift=direct_shift, chain_by_key=chain_by_key,
        hashfun=hashfun)


@partial(jax.jit, static_argnames=("cap", "num_buckets", "dense_direct",
                                   "key_domain", "early_exit_index",
                                   "hashfun", "drop_pad_key"))
def _build_chaining_fused(keys, cap, num_buckets, dense_direct,
                          key_domain=None, early_exit_index=True,
                          hashfun="murmur", drop_pad_key=False, rows=None):
    from .layout import sort_with_rows

    if rows is None:
        skey, srow, _ = sort_with_rows(keys)
        rows_s = None
    else:
        # alternate emission ids (global rows on a distributed shard) ride
        # the phase-1 sort; see nested._build_nested_fused
        from .layout import sort_rows_maybe_skip
        keys = keys.astype(canon_key_dtype(keys))
        skey, srow, rows_s = sort_rows_maybe_skip(keys, rows.astype(I32))
    return _build_chaining_phase2(keys, skey, srow, cap, num_buckets,
                                  dense_direct, key_domain, early_exit_index,
                                  hashfun, drop_pad_key, rows_s)


@partial(jax.jit, static_argnames=("cap", "num_buckets", "dense_direct",
                                   "key_domain", "early_exit_index",
                                   "hashfun", "drop_pad_key"))
def _build_chaining_phase2(keys, skey, srow, cap, num_buckets, dense_direct,
                           key_domain=None, early_exit_index=True,
                           hashfun="murmur", drop_pad_key=False,
                           row_values=None):
    """``drop_pad_key``: rows carrying the all-ones key are dead (padded
    shuffle receives) -- their group is zeroed and the rows enter no
    bucket, making the compacted build shard_map-safe (see
    nested._build_nested_phase2).  ``row_values``: key-sorted alternate
    emission ids for ``group_rows`` AND ``group_chain_first`` (global rows
    on a distributed shard; chain ORDER still follows the local arrival
    positions)."""
    from .layout import (compact_group_index, drop_pad_groups,
                         key_direct_index, run_boundaries, sorted_histogram,
                         ukey_pad)

    keys = keys.astype(canon_key_dtype(keys))
    n = keys.shape[0]
    row = jnp.arange(n, dtype=I32)
    groups = compact_group_index(keys, skey, srow, cap,
                                 row_values=row_values)
    if drop_pad_key:
        groups = drop_pad_groups(groups)

    if not early_exit_index and 2 * cap <= n:
        # Full-chain-walk probes read only bucket_len.  The histogram over
        # ROWS equals the per-bucket sum of the distinct keys' group sizes,
        # so it falls out of the compacted directory with cap-sized ops
        # (sort + segment sums) -- the 16.8M-row bucket sort this replaces
        # was ~100 ms of the ee=False build.  Only pays off when the
        # directory is meaningfully smaller than the row count (duplicate-
        # heavy builds); near cap == n the cap-sized sort+scan machinery
        # costs as much as the row sort it replaces.
        validg = groups.group_len > 0
        b_g = jnp.where(validg,
                        bucket_of(hash_key(groups.ukey, hashfun),
                                  num_buckets),
                        num_buckets)
        bs, ls = lax.sort((b_g, groups.group_len), num_keys=1,
                          is_stable=True)
        n_validg = jnp.sum(validg.astype(I32))
        is_f, _, r_start, r_len = run_boundaries(bs.astype(U32), n_validg)
        csum = jnp.cumsum(ls.astype(jnp.int64))
        seg_end = csum[jnp.minimum(r_start + r_len - 1, cap - 1)]
        seg_before = jnp.where(r_start > 0,
                               csum[jnp.maximum(r_start - 1, 0)], 0)
        seg_sum = (seg_end - seg_before).astype(I32)
        tgt = jnp.where(is_f, bs.astype(I32), num_buckets)
        bucket_len = (jnp.zeros(num_buckets + 1, I32)
                      .at[tgt].set(seg_sum, mode="drop")[:num_buckets])
        bucket_start = (jnp.cumsum(bucket_len) - bucket_len).astype(I32)
        pos_by_row = jnp.zeros(0, I32)
        group_min_pos = jnp.zeros(0, I32)
        group_chain_first = jnp.zeros(0, I32)
        return _assemble_chaining(groups, bucket_start, bucket_len,
                                  pos_by_row, group_min_pos,
                                  group_chain_first, keys, num_buckets,
                                  dense_direct, key_domain, hashfun)

    h = hash_key(keys, hashfun)
    b = bucket_of(h, num_buckets)
    if drop_pad_key:
        # dead rows (all-ones key) enter no bucket: park them past the last
        # bucket, where sorted_histogram's scatter drops them
        b = jnp.where(keys == ukey_pad(keys.dtype), num_buckets, b)

    # chain positions via bucket-run scans (gather-free); the bucket histogram
    # rides the same sort (sorted_histogram, no scatter-add)
    b_sorted, srow_b = lax.sort((b, row), num_keys=1, is_stable=True)
    is_first_b, _, run_start_b, run_len_b = run_boundaries(
        b_sorted.astype(U32), jnp.int32(n))
    bucket_start, bucket_len = sorted_histogram(
        b_sorted, num_buckets, is_first_b, run_len_b)
    if early_exit_index:
        rank = jnp.arange(n, dtype=I32) - run_start_b
        pos_sorted = jnp.where(rank == 0, 0, run_len_b - rank)
        from .layout import inverse_permute
        pos_by_row = inverse_permute(srow_b, pos_sorted)

        # early-exit unique index from compact-sized gathers: the first match
        # in chain order is the bucket head (pos 0) if the group owns it,
        # else the last-inserted duplicate (max row; LIFO head-insertion).
        gs = jnp.minimum(
            groups.group_start + jnp.maximum(groups.group_len - 1, 0), n - 1)
        max_row = srow[gs]  # rows ascend within a key run
        pos_first = pos_by_row[jnp.minimum(groups.first_row, n - 1)]
        pos_max = pos_by_row[jnp.minimum(max_row, n - 1)]
        head = pos_first == 0
        group_min_pos = jnp.where(groups.group_len > 0,
                                  jnp.where(head, 0, pos_max), n)
        if row_values is None:
            first_emit, max_emit = groups.first_row, max_row
        else:
            # emit the SAME chosen rows in override (global) coordinates;
            # chain order itself stays in local arrival positions
            first_emit = row_values[jnp.minimum(groups.group_start, n - 1)]
            max_emit = row_values[gs]
        group_chain_first = jnp.where(groups.group_len > 0,
                                      jnp.where(head, first_emit, max_emit),
                                      -1)
    else:
        # caller promises no IsBuildKeyUnique probes on this table: full-
        # chain-walk probes read only bucket_len, so the per-row chain
        # positions (an n-sized scatter + scans) need not be materialized
        pos_by_row = jnp.zeros(0, I32)
        group_min_pos = jnp.zeros(0, I32)
        group_chain_first = jnp.zeros(0, I32)

    return _assemble_chaining(groups, bucket_start, bucket_len, pos_by_row,
                              group_min_pos, group_chain_first, keys,
                              num_buckets, dense_direct, key_domain, hashfun)


def _assemble_chaining(groups, bucket_start, bucket_len, pos_by_row,
                       group_min_pos, group_chain_first, keys, num_buckets,
                       dense_direct, key_domain, hashfun="murmur"):
    from .layout import key_direct_index

    n = keys.shape[0]
    direct = None
    direct_shift = 0
    if dense_direct:
        # permutation keys: cap == n, ukey[g] == g, singleton groups
        direct_shift = (n - 1).bit_length()
        pos1 = group_min_pos + 1
        direct = (groups.first_row.astype(U32)
                  | (pos1.astype(U32) << jnp.uint32(direct_shift)))

    key_direct = (key_direct_index(groups, key_domain)
                  if key_domain is not None and not dense_direct else None)

    return ChainingTable(
        key_direct=key_direct,
        groups=groups,
        bucket_start=bucket_start,
        bucket_len=bucket_len,
        pos_by_row=pos_by_row,
        group_min_pos=group_min_pos,
        group_chain_first=group_chain_first,
        keys=keys,
        num_buckets=num_buckets,
        direct=direct,
        direct_shift=direct_shift,
        hashfun=hashfun,
    )


@partial(jax.jit, static_argnames=("cap",))
def shrink_chaining(table: ChainingTable, cap: int) -> ChainingTable:
    """Slice the directory (group-indexed arrays) to ``cap`` entries.

    Call after the build once the true distinct-key count is known (one host
    sync); probes over the compacted directory sort/search O(n_keys) instead
    of O(n_rows).  See ``layout.shrink_group_arrays``.
    """
    import dataclasses
    g = table.groups
    ukey, gs, gl, fr = shrink_group_arrays(
        (g.ukey, g.group_start, g.group_len, g.first_row), cap)
    groups = GroupIndex(ukey, gs, gl, g.group_rows, fr, g.gid_by_row, g.n_keys)
    return dataclasses.replace(
        table, groups=groups,
        group_min_pos=table.group_min_pos[:cap],
        group_chain_first=table.group_chain_first[:cap])


@partial(jax.jit, static_argnames=("unique", "method"))
def probe_chaining(
    table: ChainingTable,
    probe_keys: jax.Array,
    unique: bool = False,
    mask: jax.Array | None = None,
    method: str = "auto",
) -> ChainProbeResult:
    """Vectorized ``AlgHashJoinProbe`` (``algebra.hh:625-659``).

    ``unique`` mirrors the ``IsBuildKeyUnique`` template parameter
    (``algebra.hh:600-603``): the probe stops at the first matching chain node,
    so at most one tuple is emitted per probe and comparisons stop at the match
    position.  ``mask`` marks which probe rows are live (the vectorized stand-in
    for upstream operators not calling ``step`` on filtered-out tuples).
    """
    pk = probe_keys.astype(canon_key_dtype(probe_keys))

    if not unique and table.direct is not None:
        # Dense-direct, no early exit (plan CsrUU): the match row still comes
        # from ONE direct gather, but the probe walks its whole bucket chain,
        # so the comparison count is the bucket length -- a second gather --
        # for every live probe (``algebra.hh:644-659`` without the break).
        n = table.direct.shape[0]
        in_range = pk < n
        hit = in_range if mask is None else (in_range & mask)
        d = table.direct[jnp.minimum(pk, n - 1)]
        row = (d & jnp.uint32((1 << table.direct_shift) - 1)).astype(I32)
        h = hash_key(pk, table.hashfun)
        b = bucket_of(h, table.num_buckets)
        cmps = table.bucket_len[b]
        if mask is not None:
            cmps = jnp.where(mask, cmps, 0)
        return ChainProbeResult(
            g=row,
            hit=hit,
            match_count=hit.astype(I32),
            num_matches=jnp.sum(hit.astype(jnp.int64)),
            num_cmps=jnp.sum(cmps.astype(jnp.int64)),
            from_direct=True,
        )

    if unique and table.direct is not None:
        # Dense-direct fast path: ONE gather per probe.  Keys are a permutation
        # of [0, n), so any in-range probe hits and the packed word carries
        # both the matching build row and its 1-based chain position (= the
        # early-exit comparison count, algebra.hh:653-655).
        n = table.direct.shape[0]
        in_range = pk < n
        hit = in_range if mask is None else (in_range & mask)
        d = table.direct[jnp.minimum(pk, n - 1)]
        row = (d & jnp.uint32((1 << table.direct_shift) - 1)).astype(I32)
        pos1 = (d >> jnp.uint32(table.direct_shift)).astype(I32)
        cmps = jnp.where(hit, pos1, 0)

        # Out-of-range probes still walk their full bucket chain; pay for that
        # gather only when misses exist.
        live_miss = ~in_range if mask is None else (mask & ~in_range)
        n_miss = jnp.sum(live_miss.astype(I32))

        def miss_cmps(_):
            h = hash_key(pk, table.hashfun)
            b = bucket_of(h, table.num_buckets)
            return jnp.sum(jnp.where(live_miss, table.bucket_len[b], 0)
                           .astype(jnp.int64))

        cmps_miss = lax.cond(n_miss > 0, miss_cmps,
                             lambda _: jnp.int64(0), None)
        return ChainProbeResult(
            g=row,  # for a dense permutation, row doubles as the match handle
            hit=hit,
            match_count=hit.astype(I32),
            num_matches=jnp.sum(hit.astype(jnp.int64)),
            num_cmps=jnp.sum(cmps.astype(jnp.int64)) + cmps_miss,
            from_direct=True,
        )

    h = hash_key(pk, table.hashfun)
    b = bucket_of(h, table.num_buckets)
    blen = table.bucket_len[b]

    if table.key_direct is not None:
        from .layout import key_direct_lookup
        g, hit = key_direct_lookup(table.key_direct, pk)  # ONE gather
    else:
        g, hit = lookup_auto(table.groups, pk, method)
    if mask is not None:
        hit = hit & mask
    glen = jnp.where(hit, table.groups.group_len[g], 0)

    if unique:
        if table.group_min_pos.shape[0] == 0:
            raise ValueError(
                "table was built with early_exit_index=False; "
                "IsBuildKeyUnique probes need the chain-position index")
        cmps = jnp.where(hit, table.group_min_pos[g] + 1, blen)
        match_count = hit.astype(I32)
    else:
        cmps = blen
        match_count = glen
    if mask is not None:
        cmps = jnp.where(mask, cmps, 0)

    return ChainProbeResult(
        g=g,
        hit=hit,
        match_count=match_count,
        num_matches=jnp.sum(match_count.astype(jnp.int64)),
        num_cmps=jnp.sum(cmps.astype(jnp.int64)),
    )


@partial(jax.jit, static_argnames=("out_size", "unique"))
def materialize_chaining_join(
    table: ChainingTable,
    probe: ChainProbeResult,
    out_size: int,
    unique: bool = False,
):
    """Expand probe matches into (probe_row, build_row) id pairs.

    The reference pushes each concatenated tuple to its consumer
    (``algebra.hh:650-652``); here all output rows are written in one shot into
    a static buffer of ``out_size`` slots (pad rows flagged invalid).

    Returns ``(probe_row i32[out_size], build_row i32[out_size],
    valid bool[out_size], total i64[])``.
    """
    if unique or probe.from_direct:
        # from_direct implies unique build keys (a dense permutation): at most
        # one match per probe regardless of the plan's early-exit promise.
        P = probe.g.shape[0]
        brow = probe.g if probe.from_direct else table.group_chain_first[probe.g]
        total = jnp.sum(probe.match_count.astype(jnp.int64))
        if out_size == P:
            # Positional layout: at most one output per probe slot, so the
            # probe index itself addresses the output -- no compaction pass.
            p = jnp.arange(P, dtype=I32)
            probe_row = jnp.where(probe.hit, p, -1)
            build_row = jnp.where(probe.hit, brow, -1)
            return probe_row, build_row, probe.hit, total
        # Compacted layout: prefix-sum offsets, one scatter.
        p = jnp.arange(P, dtype=I32)
        cnt = probe.match_count
        off = (jnp.cumsum(cnt) - cnt).astype(I32)
        idx = jnp.where(probe.hit, off, out_size)  # dropped rows scatter off-end
        probe_row = jnp.full(out_size, -1, I32).at[idx].set(p, mode="drop")
        build_row = jnp.full(out_size, -1, I32).at[idx].set(brow, mode="drop")
        valid = jnp.arange(out_size, dtype=I32) < total
        return probe_row, build_row, valid, total

    P = probe.g.shape[0]
    total = jnp.sum(probe.match_count.astype(jnp.int64))

    def expanded(_):
        from .layout import emit_pos
        gstart_by_probe = table.groups.group_start[probe.g]
        p, within, valid, tot, gstart, glen_o = expand(
            probe.match_count, out_size, (gstart_by_probe,),
            with_seg_len=True)
        build_row = table.groups.group_rows[
            gstart + emit_pos(within, glen_o)]
        return (jnp.where(valid, p, -1), jnp.where(valid, build_row, -1),
                valid)

    if out_size == P:
        # Runtime-adaptive: when no probe has more than one match (e.g. the
        # build side happens to be unique but the plan did not promise it,
        # plan CsrUU), emit positionally and skip the expansion machinery.
        def positional(_):
            hit1 = probe.match_count > 0
            brow = table.groups.group_rows[table.groups.group_start[probe.g]]
            p = jnp.arange(P, dtype=I32)
            return (jnp.where(hit1, p, -1), jnp.where(hit1, brow, -1), hit1)

        prow, brow, valid = lax.cond(
            jnp.max(probe.match_count) <= 1, positional, expanded, None)
        return prow, brow, valid, total

    prow, brow, valid = expanded(None)
    return prow, brow, valid, total
