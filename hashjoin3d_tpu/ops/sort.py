"""Sort and radix-partition primitives.

XLA's sort is the engine's workhorse: hash-table builds, merge lookups, probe
strands and shuffles are all expressed through it.  This module wraps it as
the engine's sort operator and provides the radix partition used by the
distributed exchange (``parallel/shuffle.py``) as a local operator.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .hashing import murmur32
from .layout import I32, U32, run_boundaries, sorted_histogram


@jax.jit
def sort_by_key(keys: jax.Array, *payloads: jax.Array):
    """Stable sort of payload columns by a key column (ascending).

    Returns ``(sorted_keys, *sorted_payloads)``.
    """
    out = lax.sort((keys, *payloads), num_keys=1, is_stable=True)
    return out


@jax.jit
def sort_rows(keys: jax.Array):
    """Argsort-style: returns (sorted_keys, row_ids) -- a permutation handle."""
    n = keys.shape[0]
    return lax.sort((keys, jnp.arange(n, dtype=I32)), num_keys=1,
                    is_stable=True)


def _pow2_ceil(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


#: Longest within-segment row :func:`probe_sort_chunk` hands out.  Together
#: with its 4 * MAX_SEGMENT domain bound it fixes which probe streams get a
#: segmented sort.  Whether the segmented sort pays on the GPU at all is
#: open (PERF.md).
MAX_SEGMENT = 1 << 20


def probe_sort_chunk(P: int, domain: int | None, min_k: int = 8,
                     max_k: int = 64, align: int = 1024) -> int | None:
    """Segment size for a batched (segmented) probe sort, or None.

    With a known key ``domain`` the probe strands may sort ``P // chunk``
    independent segments instead of the whole stream: each segment is
    then an ascending run over the whole domain, so the table lookups of
    one segment sweep the table once in order.  Returns the smallest
    power-of-two segment that is at least twice the pow2-ceiled domain and
    ``align``, keeps at most ``max_k`` segments, and is capped at
    :data:`MAX_SEGMENT`; None (a global sort) when the domain is unknown,
    larger than 4 * MAX_SEGMENT, ``P`` is not a multiple of the segment,
    or fewer than ``min_k`` segments would result.
    """
    if domain is None or domain <= 0:
        return None
    chunk = max(2 * _pow2_ceil(domain), align, _pow2_ceil(-(-P // max_k)))
    chunk = min(chunk, MAX_SEGMENT)
    if 2 * 1024 * _pow2_ceil(domain) > 8192 * chunk:
        return None
    if chunk * min_k > P or P % chunk:
        return None
    return chunk


@partial(jax.jit, static_argnames=("chunk",))
def sort_segmented(keys: jax.Array, chunk: int):
    """Sort keys independently within contiguous ``chunk``-sized segments;
    returns (segment-sorted keys, original row ids).

    The probe strands' replacement for the global 2-op sort when the key
    domain is known (see :func:`probe_sort_chunk`).  Row ids are recovered
    from segment-local ids, so the sort stays 2-op 32-bit.  Stable: equal
    keys keep their row order.  Any 32-bit key dtype sorts in its own
    order (u32 unsigned, i32 signed, so -1 markers lead a segment).
    """
    P = keys.shape[0]
    K = P // chunk
    k2 = keys.reshape(K, chunk)
    r2 = jnp.broadcast_to(jnp.arange(chunk, dtype=I32)[None, :], (K, chunk))
    sk, sr = lax.sort((k2, r2), num_keys=1, dimension=1)
    sr = sr + (jnp.arange(K, dtype=I32) * jnp.int32(chunk))[:, None]
    return sk.reshape(P), sr.reshape(P)


@partial(jax.jit, static_argnames=("num_partitions", "by_hash"))
def radix_partition(keys: jax.Array, num_partitions: int,
                    *payloads: jax.Array, by_hash: bool = True,
                    valid: jax.Array | None = None):
    """Partition rows by ``murmur32(key) % p`` (or ``key % p``).

    Returns ``(part_id_sorted, keys_sorted, payloads_sorted..., part_start,
    part_len)`` -- rows grouped by partition (one stable sort), with the CSR
    over partitions.  This is the single-chip analogue of the distributed
    hash-partition exchange and the building block of radix joins.
    """
    k = keys.astype(U32)
    p = (murmur32(k) if by_hash else k) % jnp.uint32(num_partitions)
    p = p.astype(I32)
    if valid is not None:
        p = jnp.where(valid, p, num_partitions)
    sorted_ops = lax.sort((p, k, *payloads), num_keys=1, is_stable=True)
    psort = sorted_ops[0]
    # the histogram rides the sort: run lengths at the run heads, no
    # scatter-add
    is_first, _, _, run_len = run_boundaries(
        psort.astype(U32), jnp.int32(psort.shape[0]))
    part_start, part_len = sorted_histogram(psort, num_partitions,
                                            is_first, run_len)
    return (*sorted_ops, part_start, part_len)
