"""Distributed hash joins over a device mesh.

SPMD dataflow (both table variants):

  1. build side: ``partition_exchange`` routes build rows to the shard owning
     their key; each shard builds its local table (chaining or 3D) over the
     received rows (validity-masked -- padding never enters a group);
  2. probe side: probe rows route to the same shards, probe locally;
  3. counters are ``psum``'d across the axis; matched/unnested row-id pairs are
     materialized shard-locally in *global* row coordinates (original row ids
     travel through the shuffle as payload).

This is the operator-parallel axis the reference never had (SURVEY.md
section 2.6): per-chip hash partitions with an ``all_to_all`` shuffle instead
of one big table.  Result counters equal the single-chip engine exactly; the
comparison counters (`num_cmps`) equal the single-chip value of a table built
in shuffle arrival order (chain order is insertion-order-dependent in the
reference too, so cross-run cmp counts are layout artifacts; match counts and
result sets are layout-independent).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import (
    build_chaining,
    build_nested,
    materialize_chaining_join,
    probe_chaining,
    probe_nested,
    unnest,
)
from ..ops.layout import I32
from .mesh import SHARD_AXIS
from .shuffle import partition_exchange


def _global_rows(n_local: int, axis: str) -> jax.Array:
    base = lax.axis_index(axis).astype(jnp.int32) * n_local
    return base + jnp.arange(n_local, dtype=I32)


def _merged_pad_cmps(table, pkeys, pvalid, chain_len):
    """Comparison count contributed by the exchange's dead receive slots.

    Dead slots carry the reserved all-ones key (``partition_exchange``
    contract) and ride the merged strand as ordinary misses, walking the
    pad key's bucket; the single-chip contract (``probe_*`` with
    ``mask=``) counts masked probes as zero comparisons, so the pad
    bucket's walk is recomputed and subtracted -- the same correction
    ``ops/streaming.py`` applies to its chunk tails."""
    from ..ops.hashing import bucket_of, hash_key
    from ..ops.streaming import _pad_key

    pad = _pad_key(pkeys.dtype)
    pad_b = bucket_of(hash_key(pad, table.hashfun), table.num_buckets)
    n_dead = jnp.sum((~pvalid).astype(jnp.int64))
    return chain_len[pad_b].astype(jnp.int64) * n_dead


def dist_nested_join(mesh: Mesh, num_buckets_per_shard: int,
                     build_capacity: int, probe_capacity: int,
                     out_capacity: int, axis: str = SHARD_AXIS,
                     key_domain: int | None = None,
                     n_keys: int | None = None,
                     merged: bool | None = None):
    """Build a jitted distributed 3D-hash-join step.

    Returns ``step(build_keys, probe_keys) -> dict`` where the key columns are
    sharded along ``axis``.  The result dict carries replicated global counters
    (num_matches, num_cmps, num_unnested, overflow) and shard-local unnested
    (probe_row, build_row) global-id pairs of length ``out_capacity`` per shard
    (valid-masked).

    ``key_domain`` (a static upper bound on key values + 1, when known)
    switches the shard-local probe to the sorted keydirect strand
    (ops/strands_windowed.py), the single-card probe path applied per
    shard.  The probe
    exchange then also key-sorts within each destination
    (``sort_within_dest``), so received streams arrive blockwise sorted
    and the strand runs with NO local re-sort (``presorted``), and the
    global probe ids ride the strand's ``srow`` lookup instead of an
    out_capacity-sized mapping gather.

    ``n_keys`` (a static upper bound on DISTINCT keys received per shard,
    when known -- e.g. ``min(global distinct keys, key_domain)``) switches
    the shard-local build to the fused *compacted* two-phase build
    (``ops.nested._build_nested_fused``): directory arrays shrink from
    receive-capacity size to ~n_keys, dead receive slots die by their
    all-ones fill key (``drop_pad_key``), and the global build row ids
    ride the build sort so results emit global coordinates directly.
    Together these remove most of the distributed path's overhead over
    the single-chip engine (tools/dist_overhead.py; PERF.md).

    ``merged`` routes the shard-local probe through the MERGED sorted
    strand (``ops/strands_windowed.py:merged_nested_strand_sorted``) --
    the fast path for keys with no dense index (u64 / composite / sparse
    u32 domains).  Default ``None`` auto-selects it for 64-bit keys when
    ``key_domain`` is unset; the dead receive slots' reserved all-ones
    key rides as a miss whose bucket walk is subtracted
    (:func:`_merged_pad_cmps`).
    """
    ns = mesh.shape[axis]

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]
        fast = key_domain is not None
        use_merged = (merged if merged is not None else
                      (not fast
                       and jnp.dtype(probe_keys.dtype).itemsize == 8))

        bkeys, bpay, bvalid, bovf = partition_exchange(
            axis, build_keys, {"row": _global_rows(nb_local, axis)},
            ns, build_capacity)
        if n_keys is not None:
            from ..ops.layout import group_capacity
            from ..ops.nested import _build_nested_fused
            cap = group_capacity(n_keys + 1, bkeys.shape[0])  # +1: sentinel pad group
            table = _build_nested_fused(
                bkeys, cap, num_buckets_per_shard, False,
                key_domain=key_domain, drop_pad_key=True, rows=bpay["row"])
        else:
            table = build_nested(bkeys, num_buckets_per_shard, valid=bvalid,
                                 key_domain=key_domain)

        pkeys, ppay, pvalid, povf = partition_exchange(
            axis, probe_keys, {"row": _global_rows(np_local, axis)},
            ns, probe_capacity, sort_within_dest=fast)

        if fast:
            from ..ops.strands_windowed import keydirect_nested_strand_sorted
            # the receive stream is ns sorted blocks of probe_capacity rows
            out = keydirect_nested_strand_sorted(
                table, pkeys, out_capacity, mask=pvalid, presorted=True,
                srow_values=ppay["row"])
            prow_l, brow_l = out["probe_row"], out["build_row"]
            ovalid = prow_l >= 0
            total = out["c_unnest"]
            n_matches, n_cmps = out["c_htProbe"], out["c_htProbeCmp"]
            probe_row = prow_l  # already global via srow_values
        elif use_merged:
            from ..ops.strands_windowed import merged_nested_strand_sorted
            out = merged_nested_strand_sorted(table, pkeys, out_capacity)
            prow_l, brow_l = out["probe_row"], out["build_row"]
            ovalid = prow_l >= 0
            total = out["c_unnest"]
            n_matches = out["c_htProbe"]
            n_cmps = out["c_htProbeCmp"] - _merged_pad_cmps(
                table, pkeys, pvalid, table.bucket_main_len)
            probe_row = jnp.where(ovalid,
                                  ppay["row"][jnp.maximum(prow_l, 0)], -1)
        else:
            res = probe_nested(table, pkeys, mask=pvalid)
            prow_l, brow_l, ovalid, total = unnest(table, res, out_capacity)
            n_matches, n_cmps = res.num_matches, res.num_cmps
            probe_row = jnp.where(ovalid,
                                  ppay["row"][jnp.maximum(prow_l, 0)], -1)

        if n_keys is not None:
            build_row = brow_l  # group_rows carry global ids (rows=...)
        else:
            build_row = jnp.where(ovalid,
                                  bpay["row"][jnp.maximum(brow_l, 0)], -1)

        return dict(
            num_matches=lax.psum(n_matches, axis),
            num_cmps=lax.psum(n_cmps, axis),
            num_unnested=lax.psum(total, axis),
            overflow=bovf + povf,
            probe_row=probe_row,
            build_row=build_row,
            out_valid=ovalid,
        )

    specs_in = (P(axis), P(axis))
    specs_out = dict(
        num_matches=P(), num_cmps=P(), num_unnested=P(), overflow=P(),
        probe_row=P(axis), build_row=P(axis), out_valid=P(axis),
    )
    # check_vma stays at its default (on): the sorted strand's
    # varying-axis types are annotated where needed, so the checker passes
    return jax.jit(shard_map(step, mesh=mesh, in_specs=specs_in,
                             out_specs=specs_out))


def dist_chaining_join(mesh: Mesh, num_buckets_per_shard: int,
                       build_capacity: int, probe_capacity: int,
                       out_capacity: int, unique: bool = False,
                       axis: str = SHARD_AXIS,
                       key_domain: int | None = None,
                       n_keys: int | None = None,
                       merged: bool | None = None):
    """Distributed chaining hash join; see :func:`dist_nested_join`
    (``key_domain`` likewise enables the presorted sorted shard-local
    probe; ``n_keys`` the fused compacted shard build with global-id
    emission, including the ``unique`` early-exit index; ``merged`` the
    merged sorted strand for u64/sparse keys, auto for 64-bit)."""
    ns = mesh.shape[axis]

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]
        fast = key_domain is not None
        use_merged = (merged if merged is not None else
                      (not fast
                       and jnp.dtype(probe_keys.dtype).itemsize == 8))

        bkeys, bpay, bvalid, bovf = partition_exchange(
            axis, build_keys, {"row": _global_rows(nb_local, axis)},
            ns, build_capacity)
        if n_keys is not None:
            from ..ops.chaining import _build_chaining_fused
            from ..ops.layout import group_capacity
            cap = group_capacity(n_keys + 1, bkeys.shape[0])  # +1: sentinel pad group
            table = _build_chaining_fused(
                bkeys, cap, num_buckets_per_shard, False,
                key_domain=key_domain, drop_pad_key=True, rows=bpay["row"],
                early_exit_index=unique)
        else:
            table = build_chaining(bkeys, num_buckets_per_shard,
                                   valid=bvalid, key_domain=key_domain,
                                   early_exit_index=unique)

        pkeys, ppay, pvalid, povf = partition_exchange(
            axis, probe_keys, {"row": _global_rows(np_local, axis)},
            ns, probe_capacity, sort_within_dest=fast)

        if fast:
            from ..ops.strands_windowed import (
                keydirect_chaining_strand_sorted)
            out_k = keydirect_chaining_strand_sorted(
                table, pkeys, out_capacity, unique=unique, mask=pvalid,
                presorted=True, srow_values=ppay["row"])
            prow_l, brow_l = out_k["probe_row"], out_k["build_row"]
            ovalid = prow_l >= 0
            total = out_k["total"]
            n_matches, n_cmps = out_k["c_htProbe"], out_k["c_htProbeCmp"]
            probe_row = prow_l  # already global via srow_values
        elif use_merged:
            from ..ops.strands_windowed import merged_chaining_strand_sorted
            out_m = merged_chaining_strand_sorted(table, pkeys, out_capacity,
                                                  unique=unique)
            prow_l, brow_l = out_m["probe_row"], out_m["build_row"]
            ovalid = prow_l >= 0
            total = out_m["total"]
            n_matches = out_m["c_htProbe"]
            n_cmps = out_m["c_htProbeCmp"] - _merged_pad_cmps(
                table, pkeys, pvalid, table.bucket_len)
            probe_row = jnp.where(ovalid,
                                  ppay["row"][jnp.maximum(prow_l, 0)], -1)
        else:
            res = probe_chaining(table, pkeys, unique=unique, mask=pvalid)
            prow_l, brow_l, ovalid, total = materialize_chaining_join(
                table, res, out_capacity, unique=unique)
            n_matches, n_cmps = res.num_matches, res.num_cmps
            probe_row = jnp.where(ovalid,
                                  ppay["row"][jnp.maximum(prow_l, 0)], -1)
        if n_keys is not None:
            build_row = brow_l  # group_rows/chain_first carry global ids
        else:
            build_row = jnp.where(ovalid,
                                  bpay["row"][jnp.maximum(brow_l, 0)], -1)

        return dict(
            num_matches=lax.psum(n_matches, axis),
            num_cmps=lax.psum(n_cmps, axis),
            num_results=lax.psum(total, axis),
            overflow=bovf + povf,
            probe_row=probe_row,
            build_row=build_row,
            out_valid=ovalid,
        )

    specs_in = (P(axis), P(axis))
    specs_out = dict(
        num_matches=P(), num_cmps=P(), num_results=P(), overflow=P(),
        probe_row=P(axis), build_row=P(axis), out_valid=P(axis),
    )
    return jax.jit(shard_map(step, mesh=mesh, in_specs=specs_in,
                             out_specs=specs_out))


def dist_nested_join_chunked(mesh: Mesh, num_buckets_per_shard: int,
                             build_capacity: int, probe_capacity: int,
                             out_capacity: int, n_chunks: int,
                             step_out_capacity: int | None = None,
                             axis: str = SHARD_AXIS, prefetch: bool = True):
    """Chunked flat join: the exchange of probe chunk i+1 overlaps the probe
    of chunk i.

    Same results contract as :func:`dist_nested_join` (the one-shot
    exchange), but the local probe column is split into ``n_chunks`` chunks
    that are exchanged and probed in a software pipeline: with
    ``prefetch=True`` chunk i+1's ``partition_exchange`` (sort + pack +
    ``all_to_all``) is issued before chunk i's probe compute, so the
    collective has no dependence on the probe in issue order and XLA's
    latency-hiding scheduler can run them concurrently
    (tools/overlap_bench.py measures both orders; PERF.md
    "Exchange/compute overlap").  ``probe_capacity`` bounds received rows
    per (src, dst, chunk); ``step_out_capacity`` bounds one chunk's
    unnested output (default ``out_capacity // n_chunks``).
    """
    ns = mesh.shape[axis]
    step_cap = (out_capacity // n_chunks if step_out_capacity is None
                else step_out_capacity)

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]
        assert np_local % n_chunks == 0, "probe length % n_chunks != 0"
        cn = np_local // n_chunks

        bkeys, bpay, bvalid, bovf = partition_exchange(
            axis, build_keys, {"row": _global_rows(nb_local, axis)},
            ns, build_capacity)
        table = build_nested(bkeys, num_buckets_per_shard, valid=bvalid)

        chunks = probe_keys.reshape(n_chunks, cn)
        rows = _global_rows(np_local, axis).reshape(n_chunks, cn)

        def xchg(i):
            return partition_exchange(axis, chunks[i], {"row": rows[i]},
                                      ns, probe_capacity)

        out_p = jnp.full(out_capacity, -1, I32)
        out_b = jnp.full(out_capacity, -1, I32)
        offset = jnp.int64(0)
        dropped = jnp.int64(0)
        unnested = jnp.int64(0)
        matches = jnp.int64(0)
        cmps = jnp.int64(0)
        povf = jnp.int64(0)

        state = xchg(0)
        for i in range(n_chunks):
            if prefetch and i + 1 < n_chunks:
                nxt = xchg(i + 1)  # issued before this chunk's probe
            pkeys, ppay, pvalid, povf_i = state
            res = probe_nested(table, pkeys, mask=pvalid)
            prow_l, brow_l, ovalid, total = unnest(table, res, step_cap)
            prow_g = ppay["row"][jnp.maximum(prow_l, 0)]
            brow_g = bpay["row"][jnp.maximum(brow_l, 0)]

            materialized = jnp.minimum(total, step_cap)
            pos = jnp.cumsum(ovalid.astype(I32)) - 1
            idx = jnp.where(ovalid, offset.astype(I32) + pos, out_capacity)
            out_p = out_p.at[idx].set(jnp.where(ovalid, prow_g, -1),
                                      mode="drop")
            out_b = out_b.at[idx].set(jnp.where(ovalid, brow_g, -1),
                                      mode="drop")
            offset = offset + materialized
            dropped = dropped + (total - materialized)
            unnested = unnested + total
            matches = matches + res.num_matches
            cmps = cmps + res.num_cmps
            povf = povf + povf_i
            if i + 1 < n_chunks:
                state = nxt if prefetch else xchg(i + 1)

        dropped = jnp.maximum(offset - out_capacity, 0) + dropped
        out_valid = jnp.arange(out_capacity, dtype=I32) < jnp.minimum(
            offset, out_capacity).astype(I32)
        return dict(
            num_matches=lax.psum(matches, axis),
            num_cmps=lax.psum(cmps, axis),
            num_unnested=lax.psum(unnested, axis),
            overflow=bovf + povf + lax.psum(dropped, axis),
            probe_row=out_p,
            build_row=out_b,
            out_valid=out_valid,
        )

    specs_in = (P(axis), P(axis))
    specs_out = dict(
        num_matches=P(), num_cmps=P(), num_unnested=P(), overflow=P(),
        probe_row=P(axis), build_row=P(axis), out_valid=P(axis),
    )
    return jax.jit(shard_map(step, mesh=mesh, in_specs=specs_in,
                             out_specs=specs_out))
