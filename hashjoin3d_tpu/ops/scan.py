"""Prefix scans over parallel i32 arrays: the builds' and expansions' scans.

``run_boundaries`` (a cumsum + cummax + reverse-cummin bundle behind every
build) and ``expand`` (a cummax over the segment heads) call
:func:`engine_multi_scan`, which computes each scan with XLA's own
``lax`` scans; XLA fuses them into the surrounding program.

Ops: "sum" | "max" | "min" (one i32 array each) and "maxpair" (TWO i32
arrays -- a key and a payload -- combined by lexicographic maximum, the
engine's segmented-copy propagation).

Reference mapping: these scans implement the same run-structure recovery
the reference gets from its sequential bucket-chain walks
(``ht_chaining.hh::insert`` arrival bookkeeping, ``algebra.hh:510-541``
unnest) -- there is no per-element reference analogue to cite because the
reference never materializes whole-column prefix structures.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .layout import I32

#: op -> number of arrays it consumes
_ARITY = {"sum": 1, "max": 1, "min": 1, "maxpair": 2}


def engine_multi_scan(arrays, ops, reverse: bool = False):
    """Inclusive prefix scans of parallel i32 arrays.

    ``ops``: tuple of "sum" | "max" | "min" (one array each) | "maxpair"
    (two arrays: key then payload, combined by lexicographic maximum --
    bit-equal to a cummax of the i64 packing ``key << 32 | biased payload``).
    ``arrays``: the matching flat tuple of equal-length 1-D arrays.
    ``reverse=True`` scans right to left.  Returns the flat tuple of
    scanned i32 arrays.
    """
    if isinstance(arrays, jax.Array):
        arrays = (arrays,)
    if isinstance(ops, str):
        ops = (ops,)
    for op in ops:
        if op not in _ARITY:
            raise ValueError(f"unknown scan op {op!r}")
    if len(arrays) != sum(_ARITY[op] for op in ops):
        raise ValueError(f"ops {ops} consume {sum(_ARITY[op] for op in ops)}"
                         f" arrays, got {len(arrays)}")
    outs = []
    slot = 0
    for op in ops:
        if op == "sum":
            x = arrays[slot].astype(I32)
            outs.append(jnp.cumsum(x[::-1])[::-1].astype(I32) if reverse
                        else jnp.cumsum(x).astype(I32))
        elif op in ("max", "min"):
            f = jax.lax.cummax if op == "max" else jax.lax.cummin
            outs.append(f(arrays[slot].astype(I32), 0, reverse=reverse))
        else:  # maxpair == cummax of (key << 32 | biased payload) in i64
            k = arrays[slot].astype(jnp.int64)
            v = arrays[slot + 1].astype(jnp.int64)
            bias = jnp.int64(0x80000000)  # signed->unsigned order, low 32
            packed = (k << 32) | ((v & jnp.int64(0xFFFFFFFF)) ^ bias)
            m = jax.lax.cummax(packed, 0, reverse=reverse)
            outs.append((m >> 32).astype(I32))
            outs.append(((m & jnp.int64(0xFFFFFFFF)) ^ bias).astype(I32))
        slot += _ARITY[op]
    return tuple(outs)
