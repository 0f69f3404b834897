"""Hash-partition shuffle: the distributed exchange under every parallel join.

The reference has no communication layer at all (SURVEY.md section 5.8); the
design here is: rows are routed to the shard owning their join key
(``shard = murmur(murmur(key)) % n_shards`` with the width-matched finalizer
-- double-hashed so shard routing is decorrelated from the in-table bucket
assignment ``h % num_buckets``),
locally radix-partitioned by destination with one stable sort, packed into a
fixed-capacity ``[n_shards, capacity]`` send tensor, and exchanged with a
single ``lax.all_to_all`` (NCCL over NVLink between the cards of a host).

Static shapes force a per-destination ``capacity``; rows beyond it are dropped
and *counted* -- callers size capacity from the expected distribution (uniform:
local_n/n_shards plus slack) and must check ``overflow == 0``.  Skewed key
distributions are the province of heavy-hitter replication (planned on top of
this primitive).

All functions here run *inside* ``shard_map`` -- they see the per-device local
shard of each array and use ``axis_name`` collectives.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..ops.hashing import hash_key, murmur32
from ..ops.layout import I32, U32, canon_key_dtype


def shard_of_key(keys: jax.Array, num_shards: int) -> jax.Array:
    """Owning shard of each key (double murmur, see module docstring).

    Width-matched: u64 keys route via the 64-bit finalizer (truncating them
    to u32 would merge distinct keys into one shard-and-bucket identity).
    """
    h = hash_key(hash_key(keys.astype(canon_key_dtype(keys))))
    return (h % h.dtype.type(num_shards)).astype(I32)


def partition_exchange(axis_name: str, keys: jax.Array, payloads: dict,
                       num_shards: int, capacity: int,
                       valid: jax.Array | None = None,
                       sort_within_dest: bool = False):
    """Exchange rows to their key-owning shards.

    Args (all per-device local views, inside shard_map):
      keys:     u32[n] or u64[n] join keys (u64 ships as (hi, lo) u32 halves)
      payloads: dict of i32/u32[n] columns to ship alongside (e.g. global row ids)
      capacity: static max rows accepted per (src, dst) pair
      sort_within_dest: also order rows by KEY within each destination (the
        partition sort gains the key columns as extra sort keys).  The
        receive stream then arrives *blockwise sorted*: ``num_shards``
        blocks of ``capacity``, each ascending with its dead slots --
        filled with the impossible key ``0xFF..F`` -- at the block tail.
        That is exactly the segment-sorted layout of
        ``ops.sort.sort_segmented``, so a sorted probe strand can
        consume the received keys with NO local re-sort
        (``presorted=True``).

    Returns ``(keys_recv, payloads_recv, valid_recv, overflow)`` where the recv
    arrays have length ``num_shards * capacity`` and ``overflow`` is the global
    number of dropped rows (psum'd; must be 0 for a lossless exchange).
    Dead receive slots always carry the all-ones key (``ukey_pad``: a value
    the key domain cannot contain), never a legitimate-looking 0.
    """
    n = keys.shape[0]
    keys = keys.astype(canon_key_dtype(keys))
    wide = keys.dtype == jnp.uint64
    dest = shard_of_key(keys, num_shards)
    if valid is not None:
        dest = jnp.where(valid, dest, num_shards)

    # Local radix partition by destination: one stable multi-payload sort.
    # 64-bit keys travel as (hi, lo) u32 halves so every shipped column
    # stays 32-bit (64-bit sort keys and scatters cost more).
    names = sorted(payloads)
    if wide:
        key_cols = ((keys >> jnp.uint64(32)).astype(U32),
                    keys.astype(jnp.uint32))
    else:
        key_cols = (keys,)
    ops = (dest,) + key_cols + tuple(payloads[k].astype(I32) for k in names)
    nsort = 1 + len(key_cols) if sort_within_dest else 1
    sorted_ops = lax.sort(ops, num_keys=nsort, is_stable=True)
    dest_s = sorted_ops[0]
    key_cols_s = sorted_ops[1:1 + len(key_cols)]
    payload_s = sorted_ops[1 + len(key_cols):]

    # Within-destination rank from the sorted runs (scan-based run_start
    # instead of a bincount histogram, which would be a scatter-add).
    from ..ops.layout import run_boundaries
    _, _, run_start, _ = run_boundaries(dest_s.astype(U32), jnp.int32(n))
    within = jnp.arange(n, dtype=I32) - run_start
    live = dest_s < num_shards
    fits = live & (within < capacity)
    overflow = jnp.sum((live & ~fits).astype(jnp.int64))
    overflow = lax.psum(overflow, axis_name)

    tgt = jnp.where(fits, dest_s * capacity + within, num_shards * capacity)

    def pack(col, fill):
        buf = jnp.full(num_shards * capacity, fill, col.dtype)
        return buf.at[tgt].set(col, mode="drop").reshape(num_shards, capacity)

    send_key_cols = [pack(c, jnp.uint32(0xFFFFFFFF)) for c in key_cols_s]
    send_valid = pack(fits.astype(I32), 0)
    send_payloads = [pack(c, -1) for c in payload_s]

    # The exchange: row block d of the send tensor goes to device d; we receive
    # one block from every peer.
    def xchg(x):
        return lax.all_to_all(x, axis_name, split_axis=0, concat_axis=0)

    key_cols_r = [xchg(c).reshape(-1) for c in send_key_cols]
    if wide:
        keys_r = ((key_cols_r[0].astype(jnp.uint64) << jnp.uint64(32))
                  | key_cols_r[1].astype(jnp.uint64))
    else:
        keys_r = key_cols_r[0]
    valid_r = xchg(send_valid).reshape(-1) > 0
    payloads_r = {k: xchg(c).reshape(-1) for k, c in zip(names, send_payloads)}

    return keys_r, payloads_r, valid_r, overflow
