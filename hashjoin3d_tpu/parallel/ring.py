"""Ring-scheduled distributed probe: the join analogue of ring attention.

The ``all_to_all`` joins in ``dist_join.py`` move every probe row to the shard
owning its key in one global exchange.  This module implements the alternative
schedule sketched in SURVEY.md section 5.7: build-side tables stay **resident**
(one hash-partitioned shard each), and the *probe chunks* circulate around the
mesh axis with ``lax.ppermute`` -- each shard probes the chunk currently
visiting it, then forwards the chunk to its ring neighbor.  After ``n_shards``
steps every chunk has visited every table shard exactly once.

Why this schedule exists (systems reasoning, not reference parity -- the
reference is single-threaded):

* traffic is nearest-neighbor only: each hop is a fixed-size ``ppermute`` to
  one neighbor, never an all-to-all hotspot.  Under zipf-skewed probe keys an
  ``all_to_all`` exchange concentrates most probe rows onto the hot key's
  owner shard (capacity blowup, SURVEY.md section 7.4); in the ring schedule
  probe rows NEVER move based on their key, so per-shard receive volume is
  exactly uniform regardless of skew;
* each step's probe compute can overlap the next hop's permute (XLA schedules
  the independent collective concurrently under jit);
* a probe row meets its key's owning table exactly once, so global match
  counters are exact -- non-owner visits just miss (their comparisons are
  counted like any hash-table miss, which is chain-layout-dependent in the
  reference too).

The cost: every chunk probes every shard (n_shards local probes instead of
one), so prefer the all_to_all join when keys are near-uniform and probe
volume dominates; prefer the ring when the key distribution is skewed or
when per-shard receive capacity is the binding constraint.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import build_nested, probe_nested, unnest
from ..ops.layout import I32
from .dist_join import _global_rows
from .mesh import SHARD_AXIS
from .shuffle import partition_exchange


def dist_ring_nested_join(mesh: Mesh, num_buckets_per_shard: int,
                          build_capacity: int, out_capacity: int,
                          step_out_capacity: int | None = None,
                          axis: str = SHARD_AXIS, prefetch: bool = True,
                          key_domain: int | None = None,
                          n_keys: int | None = None):
    """Build a jitted ring-scheduled distributed 3D hash join step.

    Returns ``step(build_keys, probe_keys) -> dict`` (same contract as
    :func:`..parallel.dist_join.dist_nested_join`: replicated global counters,
    shard-local ``(probe_row, build_row)`` global-id pairs, ``out_valid``
    mask, ``overflow``).  The build side is hash-partition exchanged once;
    probe rows are never routed by key -- chunks circulate instead.

    ``step_out_capacity`` bounds one (chunk, shard) probe's unnested output
    (default: ``out_capacity``); ``out_capacity`` bounds the per-shard total
    across all ring steps.

    ``prefetch=True`` software-pipelines the schedule: the ppermute shipping
    chunk k+1 is issued BEFORE step k's probe compute, so the collective and
    the probe have no data dependence in issue order and XLA's latency-hiding
    scheduler can run the hop concurrently with the probe (measured in
    tools/overlap_bench.py; PERF.md "Exchange/compute overlap").
    ``prefetch=False`` keeps the strictly sequential probe->hop order for
    comparison.  ``key_domain`` (static key bound, when known) switches each
    visit's local probe to the sorted keydirect strand, exactly as in
    ``dist_nested_join`` -- and the chunk is sorted ONCE at home before
    entering the ring, so all ``n_shards`` visits probe presorted with no
    per-hop re-sort (the sorted keys and their global row ids circulate
    together).  ``n_keys`` (static per-shard distinct-key bound) switches
    the resident build to the fused compacted build emitting global build
    ids, as in ``dist_nested_join``.
    """
    ns = mesh.shape[axis]
    step_cap = out_capacity if step_out_capacity is None else step_out_capacity
    fwd = [(i, (i + 1) % ns) for i in range(ns)]

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]

        # Build side: one exchange, resident table per shard.
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

        # Probe side: the local chunk starts at home and rides the ring.
        vkeys = probe_keys
        vrow = _global_rows(np_local, axis)
        if key_domain is not None:
            # sort once at home; every ring visit then probes presorted.
            # vrow is base + iota, so the sorted global ids come from the
            # sort's row payload arithmetically (no gather).
            from ..ops.strands_windowed import _sort_probes
            vkeys, sr = _sort_probes(vkeys, domain=key_domain)
            vrow = lax.axis_index(axis).astype(jnp.int32) * np_local + sr

        out_p = jnp.full(out_capacity, -1, I32)
        out_b = jnp.full(out_capacity, -1, I32)
        offset = jnp.int64(0)     # materialized rows appended so far
        unnested = jnp.int64(0)   # true unnest count (c_unnest semantics)
        step_dropped = jnp.int64(0)
        matches = jnp.int64(0)
        cmps = jnp.int64(0)

        for k in range(ns):
            if prefetch and k + 1 < ns:
                # issue the next hop before this step's compute: the
                # ppermute depends only on (vkeys, vrow), so it overlaps
                # the probe below instead of serializing after it
                nkeys = lax.ppermute(vkeys, axis, fwd)
                nrow = lax.ppermute(vrow, axis, fwd)
            if key_domain is not None:
                from ..ops.strands_windowed import (
                    keydirect_nested_strand_sorted)
                # chunk is (block-)sorted since home: no per-hop re-sort,
                # and the circulating global ids ride the strand's srow
                # lookup so probe_row comes out global directly
                out_k = keydirect_nested_strand_sorted(
                    table, vkeys, step_cap, presorted=True,
                    srow_values=vrow)
                prow_l, brow_l = out_k["probe_row"], out_k["build_row"]
                ovalid = prow_l >= 0
                total = out_k["c_unnest"]
                step_matches, step_cmps = out_k["c_htProbe"], \
                    out_k["c_htProbeCmp"]
                prow_g = prow_l
            else:
                res = probe_nested(table, vkeys)
                prow_l, brow_l, ovalid, total = unnest(table, res, step_cap)
                step_matches, step_cmps = res.num_matches, res.num_cmps
                prow_g = vrow[jnp.maximum(prow_l, 0)]
            if n_keys is not None:
                brow_g = brow_l  # group_rows carry global ids (rows=...)
            else:
                brow_g = bpay["row"][jnp.maximum(brow_l, 0)]

            # Append this step's valid rows at the running offset.  unnest()
            # materializes at most step_cap rows but reports the true total;
            # advance by the MATERIALIZED count and count the rest as
            # overflow, or truncation would silently leave (-1,-1) rows
            # marked valid.
            materialized = jnp.minimum(total, step_cap)
            pos = jnp.cumsum(ovalid.astype(I32)) - 1
            idx = jnp.where(ovalid, offset.astype(I32) + pos, out_capacity)
            out_p = out_p.at[idx].set(jnp.where(ovalid, prow_g, -1),
                                      mode="drop")
            out_b = out_b.at[idx].set(jnp.where(ovalid, brow_g, -1),
                                      mode="drop")
            offset = offset + materialized
            step_dropped = step_dropped + (total - materialized)
            unnested = unnested + total
            matches = matches + step_matches
            cmps = cmps + step_cmps

            if k + 1 < ns:  # forward the chunk to the ring neighbor
                if prefetch:
                    vkeys, vrow = nkeys, nrow
                else:
                    vkeys = lax.ppermute(vkeys, axis, fwd)
                    vrow = lax.ppermute(vrow, axis, fwd)

        dropped = jnp.maximum(offset - out_capacity, 0) + step_dropped
        out_valid = jnp.arange(out_capacity, dtype=I32) < jnp.minimum(
            offset, out_capacity).astype(I32)

        return dict(
            num_matches=lax.psum(matches, axis),
            num_cmps=lax.psum(cmps, axis),
            num_unnested=lax.psum(unnested, axis),
            overflow=bovf + lax.psum(dropped, axis),
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
