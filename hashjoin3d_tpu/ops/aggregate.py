"""Hash aggregate: vectorized group-by over key columns.

Part of the engine's operator set alongside the joins (BASELINE.json north
star).  The reference has no aggregate operator; the design here sorts
each value column by key and extracts per-group reductions at the run
boundaries of the sorted order -- the same sort+scan discipline as the table
builds.

Scatter-reductions are deliberately absent: sorted-run extraction gives the
same exact-int64 reduction without a scatter-add, and min/max fall out of
the value-sorted run boundaries for free.

Aggregates: count, sum, min, max (and mean = sum/count).  Results are padded
group-major arrays (valid prefix ``n_keys``); pass the exact distinct-key
count via ``n_keys=`` (cardinality statistics) to get a compacted directory
and proportionally cheaper boundary extraction.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from .layout import (GroupIndex, I32, canon_key_dtype, group_capacity,
                     run_boundaries, ukey_pad)


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class AggregateResult:
    """Per-distinct-key aggregates; rows beyond ``n_keys`` are padding.

    ``groups`` carries the distinct-key directory (ukey/group_start/
    group_len); its row-level arrays (group_rows/first_row/gid_by_row) are
    not materialized for aggregation (empty).
    """

    groups: GroupIndex
    count: jax.Array          # i32[cap]
    sums: dict                # name -> i64[cap] (float64 for float inputs)
    mins: dict                # name -> input dtype[cap]
    maxs: dict                # name -> input dtype[cap]

    @property
    def keys(self):
        return self.groups.ukey

    @property
    def n_keys(self):
        return self.groups.n_keys


def hash_aggregate(keys: jax.Array, values: dict,
                   mask: jax.Array | None = None,
                   n_keys: int | None = None) -> AggregateResult:
    """Group ``values`` columns by ``keys``; compute count/sum/min/max per key.

    ``values`` is a dict of equal-length columns; ``mask`` excludes rows;
    ``n_keys`` (optional, exact or larger) compacts the output directory.
    """
    cap = keys.shape[0] if n_keys is None else group_capacity(
        n_keys, keys.shape[0])
    names = tuple(sorted(values))
    return _hash_aggregate(keys, tuple(values[k] for k in names), names,
                           mask, cap)


def _acc_dtype_sentinels(dtype):
    """(accumulator dtype, min-sentinel, max-sentinel) for a value column.

    Floats accumulate in float64: the cumsum-difference extraction makes the
    error scale with the global prefix, so a float32 running sum over
    millions of rows would swamp small groups; a float64 prefix keeps group
    sums exact to float32 precision.  Ints accumulate in int64 (exact).
    """
    if jnp.issubdtype(dtype, jnp.floating):
        return jnp.float64, jnp.array(jnp.inf, dtype), jnp.array(-jnp.inf,
                                                                 dtype)
    return jnp.int64, jnp.iinfo(dtype).max, jnp.iinfo(dtype).min


@partial(jax.jit, static_argnames=("names", "cap"))
def _hash_aggregate(keys, cols, names, mask, cap):
    keys = keys.astype(canon_key_dtype(keys))
    n = keys.shape[0]

    if n == 0:
        groups = GroupIndex(
            ukey=jnp.full(cap, ukey_pad(keys.dtype), keys.dtype),
            group_start=jnp.zeros(cap, I32), group_len=jnp.zeros(cap, I32),
            group_rows=jnp.zeros(0, I32), first_row=jnp.zeros(0, I32),
            gid_by_row=jnp.zeros(0, I32), n_keys=jnp.int32(0))
        sums, mins, maxs = {}, {}, {}
        for nm, col in zip(names, cols):  # same dtypes/sentinels as n > 0
            acc, big, small = _acc_dtype_sentinels(col.dtype)
            sums[nm] = jnp.zeros(cap, acc)
            mins[nm] = jnp.full(cap, big, col.dtype)
            maxs[nm] = jnp.full(cap, small, col.dtype)
        return AggregateResult(groups=groups, count=jnp.zeros(cap, I32),
                               sums=sums, mins=mins, maxs=maxs)

    skey = None
    sorted_cols = []
    for col in cols:
        if mask is None:
            sk, col_s = lax.sort((keys, col), num_keys=2)
            n_valid = jnp.int32(n)
        else:
            inv = (~mask).astype(I32)
            _, sk, col_s = lax.sort((inv, keys, col), num_keys=3)
            n_valid = (n - jnp.sum(inv)).astype(I32)
        skey = sk  # identical across columns: same (validity, key) major sort
        sorted_cols.append(col_s)
    if skey is None:  # count-only aggregation
        if mask is None:
            skey = lax.sort(keys)
            n_valid = jnp.int32(n)
        else:
            inv = (~mask).astype(I32)
            _, skey = lax.sort((inv, keys), num_keys=2)
            n_valid = (n - jnp.sum(inv)).astype(I32)

    is_first, gid, run_start, run_len = run_boundaries(skey, n_valid)
    # clamp to cap: an undershooting n_keys hint truncates the directory, and
    # the reported count must match the arrays' valid prefix
    n_groups = jnp.minimum(jnp.maximum(gid[-1] + 1, 0), cap)

    # compact directory: head positions scattered once, columns gathered
    tgt = jnp.where(is_first, gid, cap)
    head = (jnp.full(cap + 1, n, I32)
            .at[tgt].set(jnp.arange(n, dtype=I32), mode="drop")[:cap])
    pad = jnp.arange(cap, dtype=I32) >= n_groups
    hp = jnp.minimum(head, n - 1)
    glen = jnp.where(pad, 0, run_len[hp])
    ukey = jnp.where(pad, ukey_pad(skey.dtype), skey[hp])
    gvalid = glen > 0
    startpos = jnp.where(gvalid, head, 0)
    endpos = jnp.minimum(jnp.where(gvalid, head + glen - 1, 0),
                         max(n - 1, 0))

    sums, mins, maxs = {}, {}, {}
    for name, col_s in zip(names, sorted_cols):
        acc_dtype, big, small = _acc_dtype_sentinels(col_s.dtype)
        cs = jnp.cumsum(col_s.astype(acc_dtype))
        ce = cs[endpos]
        c0 = jnp.where(startpos > 0, cs[jnp.maximum(startpos - 1, 0)],
                       jnp.zeros((), acc_dtype))
        sums[name] = jnp.where(gvalid, ce - c0, 0)
        # values ascend within each run: min at the head, max at the tail
        mins[name] = jnp.where(gvalid, col_s[startpos], big)
        maxs[name] = jnp.where(gvalid, col_s[endpos], small)

    groups = GroupIndex(
        ukey=ukey,
        group_start=jnp.where(pad, n, head),
        group_len=glen,
        group_rows=jnp.zeros(0, I32),
        first_row=jnp.zeros(0, I32),
        gid_by_row=jnp.zeros(0, I32),
        n_keys=n_groups.astype(I32),
    )
    return AggregateResult(groups=groups, count=glen, sums=sums,
                           mins=mins, maxs=maxs)
