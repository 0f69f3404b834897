"""Hierarchical (host x chip) distribution: 2D mesh + two-hop exchange.

The 1D joins in ``dist_join.py`` treat all devices as one flat axis -- right
for the cards of one host, which NVLink joins all to all.  Across hosts,
links are asymmetric: cards within a host connect over NVLink (fast), hosts
over the network (slow, per-message overhead).  The classic remedy is a
**hierarchical all_to_all**: route every row first to the correct *chip
column* inside its own host (intra-host hop), then exchange along the host
axis in one aggregated message per host pair (network hop).  Each network
message carries all rows for one (src_host, dst_host) pair
instead of H*C smaller ones.

Shard numbering: global shard of a key = ``shard_of_key(k, H*C)``; its owner
is host ``d // C``, chip ``d % C``.  Hop 1 (axis "chip") moves a row to chip
``d % C`` of the sender's host; hop 2 (axis "host") moves it between hosts
within its chip column.  After both hops every row sits on its owning device,
exactly as the flat exchange would place it -- the local build/probe code is
unchanged.

On this environment there is no multi-host hardware; the schedule is
validated on a virtual 2x4 CPU mesh (tests) where it must produce results
identical to the flat 1D join.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..ops import build_nested, probe_nested, unnest
from ..ops.layout import I32, U32
from .shuffle import shard_of_key

HOST_AXIS, CHIP_AXIS = "host", "chip"


def make_mesh_2d(n_hosts: int, chips_per_host: int,
                 axes=(HOST_AXIS, CHIP_AXIS)) -> Mesh:
    """A (host, chip) mesh over the first n_hosts*chips_per_host devices."""
    import numpy as np

    devs = np.array(jax.devices()[: n_hosts * chips_per_host])
    return Mesh(devs.reshape(n_hosts, chips_per_host), axes)


def _exchange_1hop(axis_name: str, dest: jax.Array, cols: list[jax.Array],
                   num_groups: int, capacity: int, valid: jax.Array,
                   sort_by_u32_cols: int = 0):
    """Route rows to ``dest`` along one mesh axis (same scheme as
    shuffle.partition_exchange, but payload-list based and validity-aware).

    ``sort_by_u32_cols``: additionally order rows by the first k cols
    WITHIN each destination, comparing them as u32 bit patterns (the key
    halves travel as i32 views; an i32 compare would order 0x8.. before
    0x0..).  Each receive block then arrives ascending with its dead
    slots -- the all-ones fill -- at the tail, i.e. the presorted layout
    the sorted probe strands consume without a local re-sort.

    Returns ``(cols_recv, valid_recv, n_dropped)`` with recv length
    ``num_groups * capacity``.
    """
    n = dest.shape[0]
    dest = jnp.where(valid, dest, num_groups)

    k = sort_by_u32_cols
    ops = ((dest,) + tuple(c.view(U32) for c in cols[:k])
           + tuple(c.astype(I32) for c in cols[k:]))
    sorted_ops = lax.sort(ops, num_keys=1 + k, is_stable=True)
    dest_s = sorted_ops[0]
    cols_s = ([c.view(I32) for c in sorted_ops[1:1 + k]]
              + list(sorted_ops[1 + k:]))

    # scan-based within-destination rank (no bincount: see shuffle.py)
    from ..ops.layout import run_boundaries
    _, _, run_start, _ = run_boundaries(dest_s.astype(U32), jnp.int32(n))
    within = jnp.arange(n, dtype=I32) - run_start
    live = dest_s < num_groups
    fits = live & (within < capacity)
    dropped = jnp.sum((live & ~fits).astype(jnp.int64))

    tgt = jnp.where(fits, dest_s * capacity + within, num_groups * capacity)

    def pack(col, fill):
        buf = jnp.full(num_groups * capacity, fill, col.dtype)
        return buf.at[tgt].set(col, mode="drop").reshape(num_groups, capacity)

    send = [pack(c, -1) for c in cols_s]
    send_valid = pack(fits.astype(I32), 0)

    def xchg(x):
        return lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0)

    recv = [xchg(c).reshape(-1) for c in send]
    valid_r = xchg(send_valid).reshape(-1) > 0
    return recv, valid_r, dropped


def hier_exchange(keys: jax.Array, payload_rows: jax.Array,
                  n_hosts: int, n_chips: int, capacity1: int, capacity2: int,
                  valid: jax.Array | None = None,
                  sort_within_dest: bool = False):
    """Two-hop hierarchical exchange to each key's owning (host, chip).

    ``capacity1`` bounds rows accepted per (sender, chip-column) in the
    intra-host hop; ``capacity2`` per (chip-column holder, dst host) in the
    network hop.  ``sort_within_dest``: the final (network) hop also key-orders rows within
    each destination, so the receive stream arrives as ``n_hosts``
    ascending blocks with all-ones dead tails -- consumable presorted by
    the sorted strands (see shuffle.partition_exchange).
    Returns ``(keys_r, rows_r, valid_r, overflow)``; overflow is psum'd over
    the whole mesh.
    """
    ns = n_hosts * n_chips
    from ..ops.layout import canon_key_dtype
    keys = keys.astype(canon_key_dtype(keys))
    wide = keys.dtype == jnp.uint64
    n = keys.shape[0]
    if valid is None:
        valid = jnp.ones(n, bool)

    d = shard_of_key(keys, ns)          # global owner shard (64-bit finalizer
    #                                     for u64 keys, see shuffle.py)
    chip_d = d % n_chips                # hop 1: chip column (intra-host)
    host_d = d // n_chips               # hop 2: destination host (network)

    # keys travel as i32 bit patterns (view, not value conversion); u64 keys
    # ship as (hi, lo) u32 halves exactly like the flat partition_exchange --
    # every shipped column stays 32-bit (64-bit sort keys cost more)
    if wide:
        key_cols = [(keys >> jnp.uint64(32)).astype(U32).view(I32),
                    keys.astype(jnp.uint32).view(I32)]
    else:
        key_cols = [keys.astype(U32).view(I32)]
    nkc = len(key_cols)
    cols = key_cols + [payload_rows.astype(I32), host_d]
    recv1, valid1, drop1 = _exchange_1hop(
        CHIP_AXIS, chip_d, cols, n_chips, capacity1, valid)
    kc1, rows1, hostd1 = recv1[:nkc], recv1[nkc], recv1[nkc + 1]

    recv2, valid2, drop2 = _exchange_1hop(
        HOST_AXIS, jnp.maximum(hostd1, 0), kc1 + [rows1], n_hosts,
        capacity2, valid1,
        sort_by_u32_cols=nkc if sort_within_dest else 0)
    kc2, rows2 = recv2[:nkc], recv2[nkc]

    if wide:
        keys2 = ((kc2[0].view(U32).astype(jnp.uint64) << jnp.uint64(32))
                 | kc2[1].view(U32).astype(jnp.uint64))
    else:
        keys2 = kc2[0].view(U32)
    overflow = lax.psum(lax.psum(drop1 + drop2, CHIP_AXIS), HOST_AXIS)
    return keys2, rows2, valid2, overflow


def dist_nested_join_2d(mesh: Mesh, num_buckets_per_shard: int,
                        build_capacity: int, probe_capacity: int,
                        out_capacity: int, key_domain: int | None = None,
                        n_keys: int | None = None):
    """Distributed 3D join over a (host, chip) mesh with hierarchical exchange.

    Same output contract as ``dist_join.dist_nested_join``; the only
    difference is the two-hop routing.  ``*_capacity`` are per-hop,
    per-group bounds (the network hop uses 2x the per-group bound: a chip
    column aggregates a whole host's rows for each destination host).  ``key_domain`` enables
    the sorted shard-local probe -- presorted over the key-ordered network
    receive, with the global probe ids riding the strand's srow lookup --
    and ``n_keys`` (static per-shard distinct-key bound) the fused
    compacted shard build emitting global build ids, both exactly as in
    the flat join (see dist_join.dist_nested_join).
    """
    n_hosts = mesh.shape[HOST_AXIS]
    n_chips = mesh.shape[CHIP_AXIS]

    def step(build_keys, probe_keys):
        nb_local = build_keys.shape[0]
        np_local = probe_keys.shape[0]
        fast = key_domain is not None

        def grows(n_local):
            base = (lax.axis_index(HOST_AXIS).astype(jnp.int32) * n_chips
                    + lax.axis_index(CHIP_AXIS).astype(jnp.int32)) * n_local
            return base + jnp.arange(n_local, dtype=I32)

        bkeys, brows, bvalid, bovf = hier_exchange(
            build_keys, grows(nb_local), n_hosts, n_chips,
            build_capacity, 2 * build_capacity)
        if n_keys is not None:
            from ..ops.layout import group_capacity
            from ..ops.nested import _build_nested_fused
            cap = group_capacity(n_keys + 1, bkeys.shape[0])  # +1: pad group
            table = _build_nested_fused(
                bkeys, cap, num_buckets_per_shard, False,
                key_domain=key_domain, drop_pad_key=True, rows=brows)
        else:
            table = build_nested(bkeys, num_buckets_per_shard, valid=bvalid,
                                 key_domain=key_domain)

        pkeys, prows, pvalid, povf = hier_exchange(
            probe_keys, grows(np_local), n_hosts, n_chips,
            probe_capacity, 2 * probe_capacity, sort_within_dest=fast)
        if fast:
            from ..ops.strands_windowed import keydirect_nested_strand_sorted
            # receive stream = per-source sorted blocks
            out_k = keydirect_nested_strand_sorted(
                table, pkeys, out_capacity, mask=pvalid, presorted=True,
                srow_values=prows)
            prow_l, brow_l = out_k["probe_row"], out_k["build_row"]
            ovalid = prow_l >= 0
            total = out_k["c_unnest"]
            n_matches, n_cmps = out_k["c_htProbe"], out_k["c_htProbeCmp"]
            probe_row = prow_l  # already global via srow_values
        else:
            res = probe_nested(table, pkeys, mask=pvalid)
            prow_l, brow_l, ovalid, total = unnest(table, res, out_capacity)
            n_matches, n_cmps = res.num_matches, res.num_cmps
            probe_row = jnp.where(ovalid, prows[jnp.maximum(prow_l, 0)], -1)
        if n_keys is not None:
            build_row = brow_l  # group_rows carry global ids (rows=...)
        else:
            build_row = jnp.where(ovalid,
                                  brows[jnp.maximum(brow_l, 0)], -1)

        def allsum(x):
            return lax.psum(lax.psum(x, CHIP_AXIS), HOST_AXIS)

        return dict(
            num_matches=allsum(n_matches),
            num_cmps=allsum(n_cmps),
            num_unnested=allsum(total),
            overflow=bovf + povf,
            probe_row=probe_row,
            build_row=build_row,
            out_valid=ovalid,
        )

    specs_in = (P((HOST_AXIS, CHIP_AXIS)), P((HOST_AXIS, CHIP_AXIS)))
    specs_out = dict(
        num_matches=P(), num_cmps=P(), num_unnested=P(), overflow=P(),
        probe_row=P((HOST_AXIS, CHIP_AXIS)),
        build_row=P((HOST_AXIS, CHIP_AXIS)),
        out_valid=P((HOST_AXIS, CHIP_AXIS)),
    )
    return jax.jit(shard_map(step, mesh=mesh, in_specs=specs_in,
                             out_specs=specs_out))
