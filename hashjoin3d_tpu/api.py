"""One-call join API: the friendly front door over the table/probe/unnest ops.

For users who want the reference's end result -- joined row-id pairs plus the
plan counters -- without wiring build/probe/expand by hand:

    import hashjoin3d_tpu as hj
    pairs = hj.join(build_keys, probe_keys)          # 3D table by default
    pairs.probe_rows, pairs.build_rows               # np.int32 arrays
    pairs.num_matches, pairs.num_cmps, pairs.num_results

Semantics match the reference operators exactly (same counters the CSV
differential tests pin).  Output sizing is handled internally: a first pass
computes exact match counts on device, the result buffers are then allocated
exactly (one host sync -- this is a convenience API; latency-critical
pipelines should use the ops layer with static capacities).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


_kd_total_jit = None


def _kd_expand_total(table, pk):
    """Exact unnested-result size of a keydirect probe (one reduction)."""
    global _kd_total_jit
    if _kd_total_jit is None:
        import jax
        import jax.numpy as jnp

        def f(table, pk):
            from .ops.layout import safe_lookup
            g = safe_lookup(table.key_direct + 1, pk.astype(jnp.uint32)) - 1
            glen = safe_lookup(table.groups.group_len, g)
            return jnp.sum(glen.astype(jnp.int64))

        _kd_total_jit = jax.jit(f)
    return _kd_total_jit(table, pk)


@dataclass(frozen=True)
class JoinResult:
    """Materialized join: global row-id pairs + reference-exact counters."""

    probe_rows: np.ndarray   # i32[num_results]
    build_rows: np.ndarray   # i32[num_results]
    num_matches: int         # probe-op _count (c_htProbe)
    num_cmps: int            # chain comparisons (c_htProbeCmp)
    num_results: int         # emitted tuples (c_top; == unnest count for 3D)

    def pairs(self):
        return list(zip(self.probe_rows.tolist(), self.build_rows.tolist()))

    def take(self, probe_cols: dict | None = None,
             build_cols: dict | None = None) -> dict:
        """Gather payload columns through the row-id pairs.

        The engine joins on key columns and returns row ids (the reference's
        zero-copy tuple pointers, SURVEY.md §1); this materializes any other
        columns of the joined rows.  Build-side rows of -1 (left/semi/anti
        modes) yield the column dtype's zero.
        """
        out = {}
        for name, col in (probe_cols or {}).items():
            out[name] = np.asarray(col)[self.probe_rows]
        for name, col in (build_cols or {}).items():
            col = np.asarray(col)
            if col.size == 0:  # all build_rows are -1 (empty build side)
                out[name] = np.zeros(self.build_rows.size, col.dtype)
                continue
            safe = np.where(self.build_rows >= 0, self.build_rows, 0)
            v = col[safe]
            v = np.where(self.build_rows >= 0, v, np.zeros((), col.dtype))
            out[name] = v
        return out


#: Auto-backend crossover: below this total row volume (build + probe) the
#: native host engine is expected to finish before the device path's
#: dispatch latency (two device round trips + per-op launch overhead).  The
#: value is not yet calibrated on the GPU.
HOST_CROSSOVER_ROWS = 2_000_000


def join(build_keys, probe_keys, how: str = "nested",
         num_buckets: int | None = None, unique: bool = False,
         n_keys: int | None = None, key_domain: int | None = None,
         backend: str = "auto", mode: str = "inner",
         hashfun="murmur", predicate=None, predicate_mode: str = "post",
         probe_payload: dict | None = None,
         build_payload: dict | None = None) -> JoinResult:
    """Equi-join ``probe_keys`` against ``build_keys``; returns row-id pairs.

    ``how``: "nested" (3D hash table, ``ht_nested.hh``) or "chaining"
    (``ht_chaining.hh``).  ``unique`` = the chaining plan's IsBuildKeyUnique
    early exit.  ``num_buckets`` defaults to the distinct-key count (the
    experiments' ``#dv / b`` policy with b=1).  ``n_keys`` / ``key_domain``
    are the optional build hints (see ``build_*_host``).  ``backend``:
    "device" (the accelerator), "host" (the native C++ engine -- exact same
    counters, right choice for tiny ad-hoc queries where device dispatch
    latency dominates; u32 and u64 keys both dispatch to the engine's
    width-matched instantiation), or "auto" (default: route small queries
    to the host engine, everything else to the device; threshold
    ``HOST_CROSSOVER_ROWS``).

    ``mode`` extends the reference's inner join (its only kind) with the
    standard variants, all derived from the same probe pass:
      "inner"  one output pair per match (default);
      "left"   inner plus (probe_row, -1) for matchless probe rows;
      "semi"   probe rows with >= 1 match, build_rows == -1;
      "anti"   probe rows with no match, build_rows == -1.
    num_matches/num_cmps always describe the underlying probe.

    ``hashfun`` plugs a bucket-assignment functor into the table (the
    reference's ``Thashfun`` / ``Tprobehashfun`` contract,
    ``ht_chaining.hh:236-248``, ``ht_nested.hh:355-363``): a
    ``ops.hashing.HASH_FUNCTORS`` name ("murmur" default, "boncz", "fib",
    "mult", "identity") or any traceable callable.  Registry names work on
    every backend (the native host engine carries the same functor table,
    ``hostengine.HASHFUN_IDS``); callables cannot cross the C ABI and
    always run on the device.

    ``predicate`` adds a join predicate beyond hash equality
    (``alg_binary_predicate_c``, ``concepts.hh:49-56``): a callable
    ``predicate(probe_cols, build_cols) -> bool array`` over the candidate
    pairs' payload columns (``probe_payload`` / ``build_payload`` dicts of
    name -> column; the join keys are always provided under ``"key"``).
    ``predicate_mode`` selects the semantics:

    * ``"post"`` (default, the fast path): the predicate post-filters the
      hash-EQUALITY matches -- ``num_matches``/``num_results`` count pairs
      that survive, while ``num_cmps`` still counts the underlying
      hash-chain comparisons (equality is all the reference experiments
      ever instantiate, so their counters are unaffected).
    * ``"inchain"``: reference-exact counter parity -- the predicate is
      evaluated INSIDE the chain walk exactly as the reference does it
      (``algebra.hh:625-659``: candidates are hashvalue-equal chain nodes,
      IsBuildKeyUnique breaks at the first passing node so ``num_cmps``
      depends on the predicate; ``ht_nested.hh:354-382``: one evaluation
      per distinct-key main node against the group's first tuple, the
      matched group emits wholesale).  Host-side simulation
      (``ops/predicate.py``); differentially pinned against a
      predicate-parameterized oracle in ``tests/test_genericity.py``.
    """
    if how not in ("nested", "chaining"):
        raise ValueError(f"how must be 'nested' or 'chaining', got {how!r}")
    if backend not in ("device", "host", "auto"):
        raise ValueError(
            f"backend must be 'device', 'host' or 'auto', got {backend!r}")
    if mode not in ("inner", "left", "semi", "anti"):
        raise ValueError(f"unknown mode {mode!r}")
    if callable(hashfun) and backend == "host":
        raise ValueError(
            "backend='host' supports registry hash functors only "
            "(callables cannot cross the C ABI); use backend='device'")

    bk = np.ascontiguousarray(build_keys)
    pk = np.ascontiguousarray(probe_keys)

    if predicate is not None:
        if predicate_mode not in ("post", "inchain"):
            raise ValueError(
                f"predicate_mode must be 'post' or 'inchain', "
                f"got {predicate_mode!r}")
        if predicate_mode == "inchain":
            return _join_with_predicate_inchain(
                bk, pk, how, num_buckets, unique, n_keys, mode, hashfun,
                predicate, probe_payload or {}, build_payload or {})
        return _join_with_predicate(
            bk, pk, how, num_buckets, unique, n_keys, key_domain, backend,
            mode, hashfun, predicate, probe_payload or {}, build_payload or {})

    if backend == "auto":
        from .hostengine import HASHFUN_IDS, native_engine
        small = bk.size + pk.size < HOST_CROSSOVER_ROWS
        backend = ("host" if small and not callable(hashfun)
                   and hashfun in HASHFUN_IDS
                   and native_engine() is not None else "device")

    empty = np.zeros(0, np.int32)
    if bk.size == 0 or pk.size == 0:
        # the static-shape ops layer assumes non-empty columns
        if mode in ("left", "anti") and pk.size:
            rows = np.arange(pk.size, dtype=np.int32)
            return JoinResult(rows, np.full(pk.size, -1, np.int32),
                              0, 0, pk.size)
        return JoinResult(empty, empty, 0, 0, 0)

    # Same bucket policy on both backends (counters are bucket-dependent):
    # explicit num_buckets > n_keys hint > exact distinct count.
    if num_buckets is None:
        num_buckets = max(1, n_keys if n_keys is not None
                          else int(np.unique(bk).size))

    if mode != "inner":
        return _join_with_mode(bk, pk, how, num_buckets, unique, n_keys,
                               key_domain, backend, mode, hashfun)

    if backend == "host":
        # u32 and u64 keys both dispatch to the native engine's
        # width-matched instantiation (hj3e_*_join / hj3e_*_join64)
        from .hostengine import host_chaining_join, host_nested_join
        if how == "chaining":
            op, ob, m, c = host_chaining_join(bk, pk, num_buckets,
                                              unique=unique, hashfun=hashfun)
            return JoinResult(op, ob, m, c, op.size)
        op, ob, m, c, u = host_nested_join(bk, pk, num_buckets,
                                           hashfun=hashfun)
        return JoinResult(op, ob, m, c, u)

    import jax

    from .ops.chaining import build_chaining_host, can_use_dense_direct
    from .ops.nested import build_nested_host

    # Physical-plan choices (the sorted probe strands, PERF.md):
    # - permutation build keys -> dense-direct layout, single-pass sorted
    #   probe strand;
    # - densely bounded 32-bit key domains -> key_direct index + sorted
    #   keydirect strand.  The domain is inferred from max(build_keys) when
    #   the caller gave no hint and the domain is not too sparse (<= 4x the
    #   build rows: a sparser key_direct wastes HBM for few hits);
    # - everything else (u64 / composite / sparse domains) -> the merged
    #   sorted strands (sort-merge group resolution in sorted order; u64
    #   sorts as (hi, lo) u32 planes).
    # key_direct inference wants 32-bit UNSIGNED keys only: signed columns
    # canonicalize negatives to huge u32 values (beyond any inferred
    # domain) and u64 keys would be truncated by the u32 index
    narrow = bk.dtype.kind == "u" and bk.dtype.itemsize == 4 \
        and pk.dtype.kind == "u" and pk.dtype.itemsize == 4
    if key_domain is None and narrow:
        dom = int(bk.max()) + 1
        if dom <= 4 * bk.size:
            key_domain = dom
    dense = narrow and can_use_dense_direct(bk, num_buckets, hashfun)

    if how == "chaining" and dense:
        # single-pass sorted strand: positional pairs + exact counters
        from .ops.strands_windowed import direct_probe_strand_sorted
        table = build_chaining_host(bk, num_buckets, dense_direct=True,
                                    n_keys=bk.size,
                                    full_chain_index=not unique,
                                    hashfun=hashfun)
        out = jax.device_get(direct_probe_strand_sorted(table, pk,
                                                        unique=unique))
        v = out["probe_row"] >= 0
        return JoinResult(out["probe_row"][v], out["build_row"][v],
                          int(out["c_htProbe"]), int(out["c_htProbeCmp"]),
                          int(out["total"]))

    if how == "chaining":
        table = build_chaining_host(bk, num_buckets, n_keys=n_keys,
                                    key_domain=key_domain, hashfun=hashfun)
        if table.key_direct is not None and narrow:
            # sorted keydirect strand (mirrors the nested branch below):
            # one domain-sized lookup resolves each probe's group -- no
            # merged (n_keys+P)-element sort.  total == matches for
            # chaining probes, so the sizing sync reads the pre-pass.
            from .ops.strands_windowed import keydirect_chaining_strand_sorted
            pre = keydirect_chaining_strand_sorted(table, pk, 1,
                                                   unique=unique)
            m, c = (int(x) for x in jax.device_get(
                (pre["c_htProbe"], pre["c_htProbeCmp"])))
            out = jax.device_get(keydirect_chaining_strand_sorted(
                table, pk, max(1, m), unique=unique))
            v = out["probe_row"] >= 0
            return JoinResult(out["probe_row"][v], out["build_row"][v],
                              m, c, m)
        # merged sorted strand: ANY key width (u64 / composite / sparse
        # u32 domains ride the same path as dense ones -- the sort-merge
        # group resolution stays in sorted order).  One sizing sync; num_matches IS
        # the emitted-pair total for chaining probes.
        from .ops.strands_windowed import merged_chaining_strand_sorted
        pre = merged_chaining_strand_sorted(table, pk, 1, unique=unique,
                                            do_expand=False)
        m, c = (int(x) for x in jax.device_get(
            (pre["c_htProbe"], pre["c_htProbeCmp"])))
        total = m
        out = jax.device_get(merged_chaining_strand_sorted(
            table, pk, max(1, total), unique=unique))
        v = out["probe_row"] >= 0
        return JoinResult(out["probe_row"][v], out["build_row"][v],
                          m, c, total)
    else:
        table = build_nested_host(bk, num_buckets, n_keys=n_keys,
                                  key_domain=key_domain, hashfun=hashfun)
        if table.key_direct is not None and narrow:
            # sorted keydirect strand: one sizing sync, then the fused
            # probe+unnest pipeline
            from .ops.strands_windowed import keydirect_nested_strand_sorted
            pre = keydirect_nested_strand_sorted(table, pk, 1,
                                                 do_unnest=False)
            m, c = (int(x) for x in jax.device_get(
                (pre["c_htProbe"], pre["c_htProbeCmp"])))
            total = int(_kd_expand_total(table, pk))
            out = jax.device_get(keydirect_nested_strand_sorted(
                table, pk, max(1, total)))
            v = out["probe_row"] >= 0
            return JoinResult(out["probe_row"][v], out["build_row"][v],
                              m, c, total)
        # merged sorted strand (see the chaining branch): the generic-key
        # path
        from .ops.strands_windowed import merged_nested_strand_sorted
        pre = merged_nested_strand_sorted(table, pk, 1, do_unnest=False)
        m, c, total = (int(x) for x in jax.device_get(
            (pre["c_htProbe"], pre["c_htProbeCmp"],
             pre["c_expand_total"])))
        out = jax.device_get(merged_nested_strand_sorted(
            table, pk, max(1, total)))
        v = out["probe_row"] >= 0
        return JoinResult(out["probe_row"][v], out["build_row"][v],
                          m, c, total)


def _join_with_mode(bk, pk, how, num_buckets, unique, n_keys, key_domain,
                    backend, mode, hashfun="murmur"):
    """left/semi/anti variants, derived from the inner probe's hit set.

    semi/anti never materialize the inner pairs -- the probe pass already
    yields the per-row hit mask, and a duplicate-heavy inner join can be
    quadratically larger than the semi/anti result.
    """
    if mode in ("semi", "anti") and backend == "device":
        import jax

        from .ops import probe_chaining, probe_nested
        from .ops.chaining import build_chaining_host
        from .ops.nested import build_nested_host

        if how == "chaining":
            table = build_chaining_host(bk, num_buckets, n_keys=n_keys,
                                        key_domain=key_domain,
                                        hashfun=hashfun)
            res = probe_chaining(table, pk, unique=unique)
        else:
            table = build_nested_host(bk, num_buckets, n_keys=n_keys,
                                      key_domain=key_domain, hashfun=hashfun)
            res = probe_nested(table, pk)
        hit, m, c = jax.device_get((res.hit, res.num_matches, res.num_cmps))
        hit = np.asarray(hit)
        rows = np.nonzero(hit if mode == "semi" else ~hit)[0].astype(np.int32)
        return JoinResult(rows, np.full(rows.size, -1, np.int32),
                          int(m), int(c), rows.size)

    inner = join(bk, pk, how=how, num_buckets=num_buckets, unique=unique,
                 n_keys=n_keys, key_domain=key_domain, backend=backend,
                 hashfun=hashfun)
    hit = np.zeros(pk.shape[0], bool)
    hit[inner.probe_rows] = True

    if mode == "semi":
        rows = np.nonzero(hit)[0].astype(np.int32)
    elif mode == "anti":
        rows = np.nonzero(~hit)[0].astype(np.int32)
    else:  # left: inner pairs + matchless probes with a null build row
        miss = np.nonzero(~hit)[0].astype(np.int32)
        prow = np.concatenate([inner.probe_rows, miss])
        brow = np.concatenate([inner.build_rows,
                               np.full(miss.size, -1, np.int32)])
        return JoinResult(prow, brow, inner.num_matches, inner.num_cmps,
                          prow.size)

    return JoinResult(rows, np.full(rows.size, -1, np.int32),
                      inner.num_matches, inner.num_cmps, rows.size)


def _join_with_predicate(bk, pk, how, num_buckets, unique, n_keys,
                         key_domain, backend, mode, hashfun, predicate,
                         probe_payload, build_payload):
    """Residual-predicate join: hash-equality pairs post-filtered by
    ``predicate`` (see :func:`join`; ``concepts.hh:49-56``,
    ``algebra.hh:647-648``).

    The inner pairs are materialized first (the engine's probes are
    whole-column pipelines, so the predicate runs once over the match
    columns instead of per chain node); left/semi/anti are then derived
    from the SURVIVING matches, so e.g. a probe row whose only matches are
    filtered out counts as matchless for "left"/"anti".
    """
    inner = join(bk, pk, how=how, num_buckets=num_buckets, unique=unique,
                 n_keys=n_keys, key_domain=key_domain, backend=backend,
                 hashfun=hashfun)
    pcols = {n: np.asarray(c)[inner.probe_rows]
             for n, c in probe_payload.items()}
    bcols = {n: np.asarray(c)[inner.build_rows]
             for n, c in build_payload.items()}
    pcols.setdefault("key", pk[inner.probe_rows])
    bcols.setdefault("key", bk[inner.build_rows])
    keep = np.asarray(predicate(pcols, bcols), bool)
    if keep.shape != inner.probe_rows.shape:
        raise ValueError(
            f"predicate returned shape {keep.shape}, expected "
            f"{inner.probe_rows.shape}")
    prow = inner.probe_rows[keep]
    brow = inner.build_rows[keep]

    if mode == "inner":
        return JoinResult(prow, brow, prow.size, inner.num_cmps, prow.size)

    hit = np.zeros(pk.shape[0], bool)
    hit[prow] = True
    if mode == "semi":
        rows = np.nonzero(hit)[0].astype(np.int32)
    elif mode == "anti":
        rows = np.nonzero(~hit)[0].astype(np.int32)
    else:  # left
        miss = np.nonzero(~hit)[0].astype(np.int32)
        return JoinResult(
            np.concatenate([prow, miss]),
            np.concatenate([brow, np.full(miss.size, -1, np.int32)]),
            prow.size, inner.num_cmps, prow.size + miss.size)
    return JoinResult(rows, np.full(rows.size, -1, np.int32),
                      prow.size, inner.num_cmps, rows.size)


def _join_with_predicate_inchain(bk, pk, how, num_buckets, unique, n_keys,
                                 mode, hashfun, predicate, probe_payload,
                                 build_payload):
    """Reference-exact in-chain predicate join (``predicate_mode="inchain"``,
    ``algebra.hh:625-659``, ``ht_nested.hh:354-382``): counters reflect the
    predicate evaluated inside the chain walk, via the host-side chain-order
    simulation in ``ops/predicate.py``.  left/semi/anti derive from the
    surviving matches, as in the "post" path.
    """
    from .ops.predicate import chaining_inchain_probe, nested_inchain_probe

    if hashfun != "murmur" and not isinstance(hashfun, str):
        raise ValueError(
            "predicate_mode='inchain' needs a registry hash functor name "
            "(the host-side walk uses the numpy functor mirrors)")
    empty = np.zeros(0, np.int32)
    if bk.size == 0 or pk.size == 0:
        if mode in ("left", "anti") and pk.size:
            rows = np.arange(pk.size, dtype=np.int32)
            return JoinResult(rows, np.full(pk.size, -1, np.int32),
                              0, 0, pk.size)
        return JoinResult(empty, empty, 0, 0, 0)
    if num_buckets is None:
        num_buckets = max(1, n_keys if n_keys is not None
                          else int(np.unique(bk).size))

    def evaluate(p_idx, b_rows):
        pcols = {n: np.asarray(c)[p_idx] for n, c in probe_payload.items()}
        bcols = {n: np.asarray(c)[b_rows] for n, c in build_payload.items()}
        pcols.setdefault("key", pk[p_idx])
        bcols.setdefault("key", bk[b_rows])
        keep = np.asarray(predicate(pcols, bcols), bool)
        if keep.shape != p_idx.shape:
            raise ValueError(
                f"predicate returned shape {keep.shape}, expected "
                f"{p_idx.shape}")
        return keep

    if how == "chaining":
        prow, brow, m, c = chaining_inchain_probe(
            bk, pk, num_buckets, unique, evaluate, hashfun)
        total = prow.size
    else:
        prow, brow, m, c, total = nested_inchain_probe(
            bk, pk, num_buckets, evaluate, hashfun)

    if mode == "inner":
        return JoinResult(prow, brow, m, c, total)

    hit = np.zeros(pk.shape[0], bool)
    hit[prow] = True
    if mode == "semi":
        rows = np.nonzero(hit)[0].astype(np.int32)
    elif mode == "anti":
        rows = np.nonzero(~hit)[0].astype(np.int32)
    else:  # left
        miss = np.nonzero(~hit)[0].astype(np.int32)
        return JoinResult(
            np.concatenate([prow, miss]),
            np.concatenate([brow, np.full(miss.size, -1, np.int32)]),
            m, c, total + miss.size)
    return JoinResult(rows, np.full(rows.size, -1, np.int32), m, c,
                      rows.size)
