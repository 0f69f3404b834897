"""Skew handling for distributed joins: detection + broadcast strategy.

A zipf-skewed key column routes a large fraction of rows to one shard
(BASELINE.md: the hottest chain holds 1.16M of 16.8M rows at s=1.0), blowing
the partition-exchange capacity of that shard.  Two standard remedies, both
provided here:

* :func:`detect_skew` -- host-side heavy-hitter analysis of a key column
  (sampled): the max key frequency and the implied per-shard imbalance, used
  by planners to size exchange capacities or switch strategies;
* :func:`dist_broadcast_join` -- replicate the (small) build side to every
  shard with ``all_gather`` and probe purely locally: probe rows never move,
  so probe-side skew cannot imbalance the exchange.  The classic
  broadcast-vs-partition plan choice: pick broadcast when
  ``|build| * n_shards`` fits comfortably in per-chip HBM.

Per-key replication of heavy directory entries inside the partitioned join
(the hybrid strategy) is planned on top of these primitives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

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


def detect_skew(keys, num_shards: int, sample: int = 1 << 20, seed: int = 0,
                max_hot: int = 16):
    """Host-side skew report for a key column.

    Returns a dict with the top key frequency fraction, the max/mean shard
    load ratio under hash partitioning, a recommended strategy
    ("partition", "hybrid" or "broadcast"), ``hot_keys``: the (up to
    ``max_hot``) key values whose individual frequency exceeds 1/num_shards
    of the sample -- the keys worth replicating in the hybrid join -- and
    ``top_keys``: the ``max_hot`` most frequent keys regardless of
    threshold.  Under a zipf(1.0) column (exp-1 --skew) no single key
    exceeds the mean shard share for small meshes (top key ~7% of 2^24
    rows over a 2^20 domain), yet the head of the distribution still
    concentrates enough volume on whichever shards own it to overflow a
    uniformly-sized exchange; replicating ``top_keys`` removes that head
    from the exchange entirely (see dist_hybrid_nested_join).
    """
    keys = np.asarray(keys)
    n = keys.size
    if n > sample:
        idx = np.random.default_rng(seed).integers(0, n, sample)
        ks = keys[idx]
    else:
        ks = keys
    uniq, counts = np.unique(ks, return_counts=True)
    top_frac = counts.max() / ks.size

    hot_mask = counts * num_shards > ks.size
    n_hot = int(np.count_nonzero(hot_mask))  # pre-truncation count
    order = np.argsort(counts[hot_mask])[::-1][:max_hot]
    hot_keys = uniq[hot_mask][order]
    top_keys = uniq[np.argsort(counts)[::-1][:max_hot]]

    # width-matched host mirror of shard_of_key (u64 keys must not truncate)
    from ..ops.hashing import murmur32_np, murmur64_np
    if np.asarray(ks).dtype.itemsize == 8:
        shard = murmur64_np(murmur64_np(ks)) % np.uint64(num_shards)
    else:
        shard = murmur32_np(murmur32_np(ks)) % np.uint32(num_shards)
    loads = np.bincount(shard.astype(np.int64), minlength=num_shards)
    imbalance = loads.max() / max(loads.mean(), 1)

    if top_frac * num_shards <= 1.0:
        strategy = "partition"
    elif n_hot <= max_hot and top_frac < 0.9:
        # hybrid only if the REPLICATED set covers every hot key; with more
        # hot keys than max_hot the leftovers would still blow the exchange
        strategy = "hybrid"
    else:
        strategy = "broadcast"
    return dict(
        top_key_fraction=float(top_frac),
        shard_imbalance=float(imbalance),
        strategy=strategy,
        hot_keys=hot_keys,
        top_keys=top_keys,
    )


def suggest_capacity(n_local: int, num_shards: int, imbalance: float,
                     slack: float = 1.25) -> int:
    """Exchange capacity per (src, dst) pair covering the measured imbalance."""
    per_dst = n_local / num_shards
    return int(per_dst * max(imbalance, 1.0) * slack) + 64


def dist_broadcast_join(mesh: Mesh, num_buckets: int, out_capacity: int,
                        nested: bool = True, unique: bool = False,
                        axis: str = SHARD_AXIS):
    """Broadcast-build distributed join: build side replicated, probes local.

    ``step(build_keys, probe_keys)``: build keys sharded along ``axis`` are
    all-gathered onto every shard (one all-gather), each shard builds the
    full table and probes its local probe rows -- no probe exchange, so probe
    skew is irrelevant.  Counters psum'd; result pairs in global row ids.
    """

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]
        all_build = lax.all_gather(build_keys, axis, tiled=True)
        my = lax.axis_index(axis).astype(jnp.int32)
        probe_gids = my * np_local + jnp.arange(np_local, dtype=I32)

        if nested:
            table = build_nested(all_build, num_buckets)
            res = probe_nested(table, probe_keys)
            prow_l, brow_l, ovalid, total = unnest(table, res, out_capacity)
            n_out = dict(num_unnested=lax.psum(total, axis))
        else:
            table = build_chaining(all_build, num_buckets,
                                   early_exit_index=unique)
            res = probe_chaining(table, probe_keys, unique=unique)
            prow_l, brow_l, ovalid, total = materialize_chaining_join(
                table, res, out_capacity, unique=unique)
            n_out = dict(num_results=lax.psum(total, axis))

        probe_row = jnp.where(ovalid, probe_gids[jnp.maximum(prow_l, 0)], -1)
        build_row = jnp.where(ovalid, brow_l, -1)  # all_gather order is global
        return dict(
            num_matches=lax.psum(res.num_matches, axis),
            num_cmps=lax.psum(res.num_cmps, axis),
            probe_row=probe_row,
            build_row=build_row,
            out_valid=ovalid,
            **n_out,
        )

    specs_out = dict(
        num_matches=P(), num_cmps=P(),
        probe_row=P(axis), build_row=P(axis), out_valid=P(axis),
    )
    specs_out["num_unnested" if nested else "num_results"] = P()
    return jax.jit(shard_map(step, mesh=mesh, in_specs=(P(axis), P(axis)),
                             out_specs=specs_out))


def _is_hot(keys: jax.Array, hot_keys) -> jax.Array:
    """Membership mask against a small static hot-key set (unrolled compares)."""
    acc = jnp.zeros(keys.shape[0], bool)
    for hk in hot_keys:
        acc = acc | (keys == keys.dtype.type(int(hk)))
    return acc


def dist_hybrid_nested_join(mesh: Mesh, hot_keys, num_buckets_per_shard: int,
                            build_capacity: int, probe_capacity: int,
                            hot_build_capacity: int, out_capacity: int,
                            axis: str = SHARD_AXIS):
    """Hybrid skew strategy: replicate HOT keys' build rows, partition the rest.

    The SURVEY.md section 5.8 recipe ("detect heavy keys and replicate their
    HT entries / spread their probes") made concrete:

    * build rows whose key is in ``hot_keys`` (a small static host-side set
      from :func:`detect_skew`) are all-gathered to every shard, which builds
      a replicated *hot* 3D table; cold rows take the normal hash-partition
      exchange into per-shard *cold* tables;
    * probe rows with hot keys never move -- they probe the local hot
      replica (their load spreads evenly over shards by construction);
      cold probes exchange as usual.

    Neither the exchange capacity nor any single shard's receive volume
    depends on the hot keys' frequency, so zipf-style skew cannot blow the
    partition-exchange of the flat join.  Counters are psum'd; the two
    result streams are concatenated per shard (hot first), in global row
    coordinates.
    """
    from .dist_join import _global_rows
    from .shuffle import partition_exchange

    ns = mesh.shape[axis]
    hot_keys = [int(k) for k in np.asarray(hot_keys).tolist()]

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]
        brow_g = _global_rows(nb_local, axis)
        prow_g = _global_rows(np_local, axis)

        bhot = _is_hot(build_keys, hot_keys)
        phot = _is_hot(probe_keys, hot_keys)

        # --- hot side: pack local hot rows, all_gather, build replica -------
        hpos = jnp.cumsum(bhot.astype(I32)) - 1
        hidx = jnp.where(bhot, hpos, hot_build_capacity)
        hkeys = jnp.zeros(hot_build_capacity, build_keys.dtype).at[hidx].set(
            build_keys, mode="drop")
        hrows = jnp.full(hot_build_capacity, -1, I32).at[hidx].set(
            brow_g, mode="drop")
        hvalid = (jnp.arange(hot_build_capacity, dtype=I32)
                  < jnp.sum(bhot.astype(I32)))
        hot_ovf = lax.psum(
            jnp.maximum(jnp.sum(bhot.astype(jnp.int64))
                        - hot_build_capacity, 0), axis)

        all_hkeys = lax.all_gather(hkeys, axis, tiled=True)
        all_hrows = lax.all_gather(hrows, axis, tiled=True)
        all_hvalid = lax.all_gather(hvalid, axis, tiled=True)
        hot_table = build_nested(all_hkeys, max(len(hot_keys), 1),
                                 valid=all_hvalid)

        # --- cold side: the normal partitioned join -------------------------
        ckeys, cpay, cvalid, covf = partition_exchange(
            axis, build_keys, {"row": brow_g}, ns, build_capacity,
            valid=~bhot)
        cold_table = build_nested(ckeys, num_buckets_per_shard, valid=cvalid)

        pkeys_c, ppay_c, pvalid_c, povf = partition_exchange(
            axis, probe_keys, {"row": prow_g}, ns, probe_capacity,
            valid=~phot)

        # --- probes ----------------------------------------------------------
        hres = probe_nested(hot_table, probe_keys, mask=phot)
        hp, hb, hv, htot = unnest(hot_table, hres, out_capacity)
        cres = probe_nested(cold_table, pkeys_c, mask=pvalid_c)
        cp, cb, cv, ctot = unnest(cold_table, cres, out_capacity)
        out_ovf = lax.psum(
            jnp.maximum(htot - out_capacity, 0)
            + jnp.maximum(ctot - out_capacity, 0), axis)

        probe_row = jnp.concatenate([
            jnp.where(hv, prow_g[jnp.maximum(hp, 0)], -1),
            jnp.where(cv, ppay_c["row"][jnp.maximum(cp, 0)], -1)])
        build_row = jnp.concatenate([
            jnp.where(hv, all_hrows[jnp.maximum(hb, 0)], -1),
            jnp.where(cv, cpay["row"][jnp.maximum(cb, 0)], -1)])

        return dict(
            num_matches=lax.psum(hres.num_matches + cres.num_matches, axis),
            num_cmps=lax.psum(hres.num_cmps + cres.num_cmps, axis),
            num_unnested=lax.psum(htot + ctot, axis),
            overflow=hot_ovf + covf + povf + out_ovf,
            probe_row=probe_row,
            build_row=build_row,
            out_valid=jnp.concatenate([hv, cv]),
        )

    specs_out = dict(
        num_matches=P(), num_cmps=P(), num_unnested=P(), overflow=P(),
        probe_row=P(axis), build_row=P(axis), out_valid=P(axis),
    )
    return jax.jit(shard_map(step, mesh=mesh, in_specs=(P(axis), P(axis)),
                             out_specs=specs_out))
