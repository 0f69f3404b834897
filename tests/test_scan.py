"""The engine's scans (ops/scan.py:engine_multi_scan) vs numpy oracles.

Lengths are multiples and non-multiples of ``C`` (256) so the ragged tails
and long runs the builds and expansions produce are both covered.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from hashjoin3d_tpu.ops.scan import engine_multi_scan

C = 256


def _oracle(x, op, reverse):
    x = np.asarray(x, np.int64)
    f = {"sum": np.cumsum, "max": np.maximum.accumulate,
         "min": np.minimum.accumulate}[op]
    r = f(x[::-1])[::-1] if reverse else f(x)
    return r.astype(np.int32)


@pytest.mark.parametrize("op", ["sum", "max", "min"])
@pytest.mark.parametrize("reverse", [False, True])
def test_single_scan_kernel(op, reverse):
    rng = np.random.default_rng(3)
    x = rng.integers(-100, 100, 4 * C).astype(np.int32)
    (got,) = engine_multi_scan((jnp.asarray(x),), (op,), reverse=reverse)
    np.testing.assert_array_equal(np.asarray(got), _oracle(x, op, reverse))


@pytest.mark.parametrize("reverse", [False, True])
def test_fused_three_scans_one_pass(reverse):
    rng = np.random.default_rng(5)
    n = 3 * C + 128          # deliberately NOT a multiple of C (padding)
    xs = [rng.integers(-50, 50, n).astype(np.int32) for _ in range(3)]
    ops = ("sum", "max", "min")
    got = engine_multi_scan(tuple(jnp.asarray(x) for x in xs), ops,
                     reverse=reverse)
    for g, x, op in zip(got, xs, ops):
        np.testing.assert_array_equal(np.asarray(g), _oracle(x, op, reverse))


def test_carry_across_many_blocks():
    # all-ones cumsum: output is arange+1, any carry bug shows immediately
    n = 7 * C
    (got,) = engine_multi_scan((jnp.ones(n, jnp.int32),), ("sum",))
    np.testing.assert_array_equal(np.asarray(got),
                                  np.arange(1, n + 1, dtype=np.int32))


def test_cummax_run_start_pattern():
    # the run_boundaries use: cummax(where(is_first, i, -1)) recovers each
    # element's run start
    keys = np.repeat(np.array([3, 5, 5, 9, 9, 9, 12], np.int32),
                     [40, 100, 60, 30, 130, 50, 102])
    n = keys.size
    i = np.arange(n, dtype=np.int32)
    is_first = np.concatenate([[True], keys[1:] != keys[:-1]])
    head = np.where(is_first, i, -1).astype(np.int32)
    (got,) = engine_multi_scan((jnp.asarray(head),), ("max",))
    np.testing.assert_array_equal(np.asarray(got), _oracle(head, "max", False))


def _maxpair_oracle(k, v, reverse):
    """Elementwise lexicographic running max (pure numpy)."""
    n = k.size
    ok = np.empty(n, np.int64)
    ov = np.empty(n, np.int64)
    order = range(n - 1, -1, -1) if reverse else range(n)
    bk, bv = np.int64(np.iinfo(np.int32).min), np.int64(np.iinfo(np.int32).min)
    for i in order:
        if (k[i] > bk) or (k[i] == bk and v[i] >= bv):
            bk, bv = k[i], v[i]
        ok[i], ov[i] = bk, bv
    return ok.astype(np.int32), ov.astype(np.int32)


@pytest.mark.parametrize("reverse", [False, True])
def test_maxpair_kernel(reverse):
    rng = np.random.default_rng(17)
    n = 3 * C + 64
    # few distinct keys -> many ties (payload tiebreak exercised), plus
    # negative payloads (the i64-packed bias case)
    k = rng.integers(-4, 4, n).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    gk, gv = engine_multi_scan((jnp.asarray(k), jnp.asarray(v)), ("maxpair",),
                        reverse=reverse)
    wk, wv = _maxpair_oracle(k, v, reverse)
    np.testing.assert_array_equal(np.asarray(gk), wk)
    np.testing.assert_array_equal(np.asarray(gv), wv)


def test_maxpair_twin_matches_packed_cummax():
    # the CPU twin must equal expand()'s packed-int64 cummax formulation
    rng = np.random.default_rng(23)
    n = 5000
    rank = np.sort(rng.integers(-1, 1000, n)).astype(np.int32)  # -1 = holes
    val = rng.integers(0, 1 << 26, n).astype(np.int32)
    packed = (rank.astype(np.int64) << 26) | val.astype(np.int64)
    want = np.maximum.accumulate(packed)
    gk, gv = engine_multi_scan((jnp.asarray(rank), jnp.asarray(val)), ("maxpair",))
    got = (np.asarray(gk, np.int64) << 26) | np.asarray(gv, np.int64)
    # where rank == -1 everywhere so far, both formulations carry idents;
    # compare only from the first real rank on
    live = np.maximum.accumulate(rank) >= 0
    np.testing.assert_array_equal(got[live], want[live])


@pytest.mark.parametrize("reverse", [False, True])
def test_mixed_ops_with_maxpair(reverse):
    rng = np.random.default_rng(29)
    n = 2 * C + 200
    a = rng.integers(-10, 10, n).astype(np.int32)
    k = rng.integers(-3, 3, n).astype(np.int32)
    v = rng.integers(-99, 99, n).astype(np.int32)
    got = engine_multi_scan(
        (jnp.asarray(a), jnp.asarray(k), jnp.asarray(v)),
        ("sum", "maxpair"), reverse=reverse)
    np.testing.assert_array_equal(np.asarray(got[0]),
                                  _oracle(a, "sum", reverse))
    wk, wv = _maxpair_oracle(k, v, reverse)
    np.testing.assert_array_equal(np.asarray(got[1]), wk)
    np.testing.assert_array_equal(np.asarray(got[2]), wv)


def test_cpu_twin_matches_lax():
    # long ragged input, every single op both ways
    rng = np.random.default_rng(9)
    x = rng.integers(-1000, 1000, 5000).astype(np.int32)
    for op in ("sum", "max", "min"):
        for reverse in (False, True):
            (got,) = engine_multi_scan((jnp.asarray(x),), (op,), reverse=reverse)
            np.testing.assert_array_equal(np.asarray(got),
                                          _oracle(x, op, reverse))
