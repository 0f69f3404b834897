"""Out-of-core probe streaming: probe relations larger than device memory.

SURVEY §5.7's "long sequence" axis applied to memory: the build table stays
resident in HBM while the probe column streams from HOST memory in fixed
chunks.  Transfers overlap compute double-buffered: chunk i+1's
``jax.device_put`` (async) is issued before chunk i's probe is awaited, so
the PCIe transfer of the next chunk rides under the current chunk's device
time.  Counters accumulate ON DEVICE across chunks (one scalar
carry, no per-chunk host sync); materialized row-id pairs are returned to
the host per chunk (they must leave the device anyway for an out-of-core
consumer).

This bounds device residency at O(table + 2 * chunk + chunk_out) bytes
regardless of the probe relation's size -- a 2^30-row probe column (4 GB)
streams through a card with the same footprint as a 2^24 one.

Every table layout streams: dense-direct and key_direct chaining tables,
nested (3D) tables with positional / keydirect / merged strands, and u64 /
sparse-domain keys via the merged strands (the all-ones key is reserved as
chunk padding throughout, matching the shuffle layer's convention).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .layout import I32


@partial(jax.jit, static_argnames=("unique", "nested"))
def _chunk_probe_direct(table, pk_chunk, n_valid, unique=True, nested=False):
    """One chunk through the sorted direct-table probe strand; returns
    (probe_row_local, build_row, matches_i64, cmps_i64)."""
    from .strands_windowed import direct_probe_strand_sorted

    live = jnp.arange(pk_chunk.shape[0], dtype=I32) < n_valid
    # dead tail rows become the all-ones key: out of range, miss, and their
    # bucket walk is skipped below by masking the counters
    pk = jnp.where(live, pk_chunk, jnp.uint32(0xFFFFFFFF))
    out = direct_probe_strand_sorted(table, pk, unique=unique, nested=nested)
    # out-of-range misses contributed bucket walks for the PAD rows too;
    # recompute the pad contribution and subtract (pads all share one key)
    from .hashing import bucket_of, hash_key
    blen = table.bucket_main_len if nested else table.bucket_len
    pad_b = bucket_of(hash_key(jnp.uint32(0xFFFFFFFF), table.hashfun),
                      table.num_buckets)
    pad_cmps = (blen[pad_b].astype(jnp.int64)
                * (pk_chunk.shape[0] - n_valid))
    return (out["probe_row"], out["build_row"], out["c_htProbe"],
            out["c_htProbeCmp"] - pad_cmps)


@partial(jax.jit, static_argnames=("out_size", "unique"))
def _chunk_probe_chaining_kd(table, pk_chunk, n_valid, out_size, unique):
    """One chunk through the keydirect chaining strand (masked dead tail)."""
    from .strands_windowed import keydirect_chaining_strand_sorted

    live = jnp.arange(pk_chunk.shape[0], dtype=I32) < n_valid
    out = keydirect_chaining_strand_sorted(table, pk_chunk, out_size,
                                           unique=unique, mask=live)
    return (out["probe_row"], out["build_row"], out["c_htProbe"],
            out["c_htProbeCmp"], out["total"])


def _pad_key(dtype):
    return (jnp.uint64(0xFFFFFFFFFFFFFFFF)
            if jnp.dtype(dtype).itemsize == 8 else jnp.uint32(0xFFFFFFFF))


@partial(jax.jit, static_argnames=("out_size", "unique"))
def _chunk_probe_chaining_merged(table, pk_chunk, n_valid, out_size, unique):
    """One chunk through the merged chaining strand: the dead tail rides as
    the reserved all-ones key (misses by construction; its bucket-walk
    comparisons are recomputed and subtracted, as in _chunk_probe_direct)."""
    from .hashing import bucket_of, hash_key
    from .strands_windowed import merged_chaining_strand_sorted

    P = pk_chunk.shape[0]
    live = jnp.arange(P, dtype=I32) < n_valid
    pad = _pad_key(table.keys.dtype)
    pk = jnp.where(live, pk_chunk.astype(pad.dtype), pad)
    out = merged_chaining_strand_sorted(table, pk, out_size, unique=unique)
    pad_b = bucket_of(hash_key(pad, table.hashfun), table.num_buckets)
    pad_cmps = (table.bucket_len[pad_b].astype(jnp.int64)
                * (P - n_valid))
    return (out["probe_row"], out["build_row"], out["c_htProbe"],
            out["c_htProbeCmp"] - pad_cmps, out["total"])


@partial(jax.jit, static_argnames=("out_size",))
def _chunk_probe_nested_kd(table, pk_chunk, n_valid, out_size):
    """One chunk through the keydirect nested strand (masked dead tail)."""
    from .strands_windowed import keydirect_nested_strand_sorted

    live = jnp.arange(pk_chunk.shape[0], dtype=I32) < n_valid
    out = keydirect_nested_strand_sorted(table, pk_chunk, out_size,
                                         mask=live)
    return (out["probe_row"], out["build_row"], out["c_htProbe"],
            out["c_htProbeCmp"], out["c_unnest"])


@partial(jax.jit, static_argnames=("out_size",))
def _chunk_probe_nested_merged(table, pk_chunk, n_valid, out_size):
    """One chunk through the merged nested strand (pad-key dead tail, see
    _chunk_probe_chaining_merged)."""
    from .hashing import bucket_of, hash_key
    from .strands_windowed import merged_nested_strand_sorted

    P = pk_chunk.shape[0]
    live = jnp.arange(P, dtype=I32) < n_valid
    pad = _pad_key(table.keys.dtype)
    pk = jnp.where(live, pk_chunk.astype(pad.dtype), pad)
    out = merged_nested_strand_sorted(table, pk, out_size)
    pad_b = bucket_of(hash_key(pad, table.hashfun), table.num_buckets)
    pad_cmps = (table.bucket_main_len[pad_b].astype(jnp.int64)
                * (P - n_valid))
    return (out["probe_row"], out["build_row"], out["c_htProbe"],
            out["c_htProbeCmp"] - pad_cmps, out["c_unnest"])


def _stream_chunks(pk, chunk_size, probe_one, collect_pairs):
    """Shared double-buffered chunk loop: async device_put of chunk i+1
    overlaps chunk i's probe; counters accumulate on device."""
    n = pk.shape[0]
    n_chunks = max(1, -(-n // chunk_size))
    matches = jnp.int64(0)
    cmps = jnp.int64(0)
    emitted = jnp.int64(0)
    pairs = []

    def put(i):
        lo = i * chunk_size
        hi = min(lo + chunk_size, n)
        buf = pk[lo:hi]
        if hi - lo < chunk_size:  # static shapes: pad the tail chunk
            buf = np.concatenate(
                [buf, np.zeros(chunk_size - (hi - lo), pk.dtype)])
        return jax.device_put(buf), hi - lo, lo

    nxt = put(0)
    for i in range(n_chunks):
        chunk, n_valid, base = nxt
        if i + 1 < n_chunks:
            nxt = put(i + 1)  # async: overlaps this chunk's probe
        prow, brow, m, c, tot = probe_one(chunk, jnp.int32(n_valid))
        matches = matches + m
        cmps = cmps + c
        emitted = emitted + tot
        if collect_pairs:
            prow_np = np.asarray(prow)   # syncs this chunk only
            brow_np = np.asarray(brow)
            v = prow_np >= 0
            pairs.append((prow_np[v] + base, brow_np[v]))
    return int(matches), int(cmps), int(emitted), pairs


def stream_probe_chaining(table, probe_keys_host, chunk_size: int = 1 << 22,
                          unique: bool = True, collect_pairs: bool = False,
                          out_per_chunk: int | None = None):
    """Probe a device-resident chaining table with a HOST-resident key
    column of any size (numpy array or memmap), in overlapped chunks.

    Returns ``(num_matches, num_cmps, pairs)`` where ``pairs`` is a list of
    per-chunk ``(probe_row_global, build_row)`` numpy arrays when
    ``collect_pairs`` (valid rows only), else ``[]``.  Counters are
    bit-equal to a whole-column probe.

    Any table layout works: dense-direct tables ride the positional strand;
    key_direct tables the sorted keydirect strand; everything else (u64 /
    sparse domains) the merged strand, where the all-ones key is reserved
    as chunk padding.  Non-direct layouts EXPAND matches, so
    ``out_per_chunk`` (default ``4 * chunk_size``) must bound one chunk's
    emitted pairs when ``collect_pairs`` -- a chunk that would emit more
    raises.
    """
    if getattr(table, "direct", None) is not None:
        if not unique and getattr(table, "chain_by_key", None) is None:
            raise ValueError(
                "stream_probe_chaining(unique=False) on a dense-direct "
                "table counts full chain walks per probe: build with "
                "full_chain_index=True")

        def probe_one(chunk, n_valid):
            p, b, m, c = _chunk_probe_direct(table, chunk, n_valid,
                                             unique=unique)
            return p, b, m, c, m
    else:
        out_size = out_per_chunk or 4 * chunk_size
        kd = getattr(table, "key_direct", None) is not None
        fn = (_chunk_probe_chaining_kd if kd
              else _chunk_probe_chaining_merged)

        def probe_one(chunk, n_valid):
            return fn(table, chunk, n_valid, out_size, unique)

    pk = np.asarray(probe_keys_host)
    matches, cmps, emitted, pairs = _stream_chunks(
        pk, chunk_size, probe_one, collect_pairs)
    if collect_pairs and sum(p[0].size for p in pairs) < emitted:
        raise ValueError(
            f"a chunk overflowed out_per_chunk: emitted {emitted} total but "
            f"materialized fewer; raise out_per_chunk or lower chunk_size")
    return matches, cmps, pairs


def stream_probe_nested(table, probe_keys_host, chunk_size: int = 1 << 22,
                        collect_pairs: bool = False,
                        out_per_chunk: int | None = None):
    """Probe + unnest a device-resident NESTED (3D) table with a
    host-resident key column of any size, in overlapped chunks.

    Returns ``(num_matches, num_cmps, num_unnested, pairs)``; counters are
    bit-equal to a whole-column ``probe_nested`` + ``unnest``.  key_direct
    tables ride the sorted keydirect strand; u64 / sparse-domain tables
    the merged strand (all-ones key reserved as padding); dense-direct
    tables the positional strand.  ``out_per_chunk`` (default
    ``4 * chunk_size``) bounds one chunk's expansion when
    ``collect_pairs``.
    """
    out_size = out_per_chunk or 4 * chunk_size
    if getattr(table, "direct", None) is not None:
        def probe_one(chunk, n_valid):
            p, b, m, c = _chunk_probe_direct(table, chunk, n_valid,
                                             unique=True, nested=True)
            return p, b, m, c, m
    elif getattr(table, "key_direct", None) is not None:
        def probe_one(chunk, n_valid):
            return _chunk_probe_nested_kd(table, chunk, n_valid, out_size)
    else:
        def probe_one(chunk, n_valid):
            return _chunk_probe_nested_merged(table, chunk, n_valid,
                                              out_size)

    pk = np.asarray(probe_keys_host)
    matches, cmps, emitted, pairs = _stream_chunks(
        pk, chunk_size, probe_one, collect_pairs)
    if collect_pairs and sum(p[0].size for p in pairs) < emitted:
        raise ValueError(
            f"a chunk overflowed out_per_chunk: emitted {emitted} total but "
            f"materialized fewer; raise out_per_chunk or lower chunk_size")
    return matches, cmps, emitted, pairs
