"""Native host execution backend: C++ CSR joins with reference-equal counters.

Wraps ``native/hj3engine.cpp`` (built on demand with g++, loaded via ctypes).
Two roles:

* **scalable differential oracle** -- the randomized test suite checks the
  device engine's match counts, comparison counts and result multisets against
  this engine at sizes where the pure-Python insertion-simulating oracle
  (``tests/oracle.py``) is too slow;
* **small-query fallback** -- for tiny ad-hoc joins the device path's
  compile and dispatch latency dwarfs execution;
  callers can route such queries here (same semantics, same counters).

Counter semantics match ``ht_chaining.hh:236-248`` / ``ht_nested.hh:354-382``
/ ``algebra.hh:625-659`` bit-exactly (verified against the python oracle and
the reference binaries' CSVs in tests).
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

_DIR = Path(__file__).resolve().parent / "native"
_SRC = _DIR / "hj3engine.cpp"
_SO = _DIR / "libhj3engine.so"

_lib = None
_lib_tried = False

#: Registry-functor ids shared with the C ABI (native/hj3engine.cpp
#: ``HashFunId``); mirrors ``ops.hashing.HASH_FUNCTORS`` so any registry
#: hash works on the host backend too (the reference's Thashfun contract,
#: util/hasht.hh:17-113).  Callable functors stay device-only.
HASHFUN_IDS = {"murmur": 0, "boncz": 1, "fib": 2, "mult": 3, "identity": 4}


def _hf_id(hashfun) -> int:
    try:
        return HASHFUN_IDS[hashfun]
    except (KeyError, TypeError):
        raise ValueError(
            f"host backend supports registry hash functors "
            f"{sorted(HASHFUN_IDS)} only, got {hashfun!r}") from None


def _i32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def _u64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _i64p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _canon_keys(keys):
    """Contiguous u32 or u64 key column (the engine's two instantiations,
    like the reference's HtChaining1<uint32_t>/<uint64_t>); 64-bit input
    with any high bit set stays u64, narrow input canonicalizes to u32."""
    a = np.ascontiguousarray(keys)
    if a.dtype.itemsize == 8:
        return a.astype(np.uint64, copy=False)
    return a.astype(np.uint32, copy=False)


def _kp(a):
    return _u64p(a) if a.dtype == np.uint64 else _u32p(a)


def native_engine():
    """Load (building if needed) the native engine; None if unavailable."""
    global _lib, _lib_tried
    if _lib is not None or _lib_tried:
        return _lib
    _lib_tried = True
    try:
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            subprocess.run(
                ["g++", "-O3", "-std=c++20", "-shared", "-fPIC",
                 "-o", str(_SO), str(_SRC)],
                check=True, capture_output=True,
            )
        lib = ctypes.CDLL(str(_SO))
        u32p, u64p, i32p, i64p = (ctypes.POINTER(ctypes.c_uint32),
                                  ctypes.POINTER(ctypes.c_uint64),
                                  ctypes.POINTER(ctypes.c_int32),
                                  ctypes.POINTER(ctypes.c_int64))
        for kp, sfx in ((u32p, ""), (u64p, "64")):
            argt = [kp, ctypes.c_int64, kp, ctypes.c_int64,
                    ctypes.c_uint32, ctypes.c_int, i32p, i32p,
                    ctypes.c_int64, i64p, ctypes.c_uint32]
            for name in ("hj3e_chaining_join", "hj3e_nested_join"):
                fn = getattr(lib, name + sfx)
                fn.restype = ctypes.c_int64
                fn.argtypes = argt
            for name in ("hj3e_chaining_create", "hj3e_nested_create"):
                create = getattr(lib, name + sfx)
                create.restype = ctypes.c_void_p
                create.argtypes = [kp, ctypes.c_int64, ctypes.c_uint32,
                                   ctypes.c_uint32]
            probe_argt = [ctypes.c_void_p, kp, ctypes.c_int64, ctypes.c_int,
                          i32p, i32p, ctypes.c_int64, i64p]
            for name in ("hj3e_chaining_probe", "hj3e_nested_probe"):
                fn = getattr(lib, name + sfx)
                fn.restype = ctypes.c_int64
                fn.argtypes = probe_argt
        lib.hj3e_table_free.restype = None
        lib.hj3e_table_free.argtypes = [ctypes.c_void_p]
        two_argt = [ctypes.c_void_p, ctypes.c_void_p, u32p, ctypes.c_int64,
                    i32p, i32p, i32p, ctypes.c_int64, i64p]
        lib.hj3e_ndu_probe.restype = ctypes.c_int64
        lib.hj3e_ndu_probe.argtypes = two_argt
        lib.hj3e_chj_probe.restype = ctypes.c_int64
        lib.hj3e_chj_probe.argtypes = two_argt
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def host_chaining_join(build_keys, probe_keys, num_buckets: int,
                       unique: bool = False, out_cap: int | None = None,
                       hashfun="murmur"):
    """Chaining hash join on the host engine.

    Returns ``(probe_rows, build_rows, num_matches, num_cmps)``; the pair
    arrays are trimmed to the true result size.  Raises if the native engine
    is unavailable or ``out_cap`` was insufficient.
    """
    lib = native_engine()
    if lib is None:
        raise RuntimeError("native engine unavailable (g++ build failed?)")
    bk = _canon_keys(build_keys)
    pk = _canon_keys(probe_keys)
    wide = bk.dtype == np.uint64 or pk.dtype == np.uint64
    if wide:
        bk, pk = bk.astype(np.uint64), pk.astype(np.uint64)
    fn = lib.hj3e_chaining_join64 if wide else lib.hj3e_chaining_join
    cap = int(out_cap) if out_cap is not None else max(
        16, 4 * pk.size + bk.size)
    while True:
        op = np.empty(cap, np.int32)
        ob = np.empty(cap, np.int32)
        ctr = np.zeros(2, np.int64)
        n = fn(_kp(bk), bk.size, _kp(pk), pk.size,
               num_buckets, int(unique), _i32p(op),
               _i32p(ob), cap, _i64p(ctr), _hf_id(hashfun))
        if n >= 0:
            return op[:n].copy(), ob[:n].copy(), int(ctr[0]), int(ctr[1])
        if out_cap is not None:  # explicit cap: surface the overflow
            raise ValueError(f"out_cap={cap} too small (matches={ctr[0]})")
        cap = max(int(ctr[0]), 1)  # counters are exact: retry once, exact-size


def host_nested_join(build_keys, probe_keys, num_buckets: int,
                     unnest: bool = True, out_cap: int | None = None,
                     hashfun="murmur"):
    """3D/nested hash join on the host engine.

    Returns ``(probe_rows, build_rows, num_matches, num_cmps, num_unnested)``
    where the pair arrays are the unnested result (empty if ``unnest=False``).
    """
    lib = native_engine()
    if lib is None:
        raise RuntimeError("native engine unavailable (g++ build failed?)")
    bk = _canon_keys(build_keys)
    pk = _canon_keys(probe_keys)
    wide = bk.dtype == np.uint64 or pk.dtype == np.uint64
    if wide:
        bk, pk = bk.astype(np.uint64), pk.astype(np.uint64)
    fn = lib.hj3e_nested_join64 if wide else lib.hj3e_nested_join
    cap = int(out_cap) if out_cap is not None else max(
        16, 4 * pk.size + bk.size)
    if not unnest:
        cap = 1
    while True:
        op = np.empty(cap, np.int32)
        ob = np.empty(cap, np.int32)
        ctr = np.zeros(3, np.int64)
        n = fn(_kp(bk), bk.size, _kp(pk), pk.size,
               num_buckets, int(unnest), _i32p(op),
               _i32p(ob), cap, _i64p(ctr), _hf_id(hashfun))
        if n >= 0:
            return (op[:n].copy(), ob[:n].copy(),
                    int(ctr[0]), int(ctr[1]), int(ctr[2]))
        if out_cap is not None:
            raise ValueError(f"out_cap={cap} too small (unnested={ctr[2]})")
        cap = max(int(ctr[2]), 1)  # counters are exact: retry once, exact-size


class HostTable:
    """Prebuilt native table handle (build/probe split for strand timing).

    ``kind``: "chaining" or "nested".  The handle owns C++ CSR state built
    once (the reference's build strand); probes run against it repeatedly.
    """

    def __init__(self, build_keys, num_buckets: int, kind: str = "nested",
                 hashfun="murmur"):
        lib = native_engine()
        if lib is None:
            raise RuntimeError("native engine unavailable (g++ build failed?)")
        self._lib = lib
        self.kind = kind
        self.num_buckets = int(num_buckets)
        bk = _canon_keys(build_keys)
        self.key_dtype = bk.dtype
        self.n_rows = bk.size
        sfx = "64" if bk.dtype == np.uint64 else ""
        create = getattr(lib, ("hj3e_nested_create" if kind == "nested"
                               else "hj3e_chaining_create") + sfx)
        self._h = create(_kp(bk), bk.size, self.num_buckets,
                         _hf_id(hashfun))

    def close(self):
        if getattr(self, "_h", None):
            self._lib.hj3e_table_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def probe(self, probe_keys, unique: bool = False, unnest: bool = True,
              out_cap: int | None = None):
        """Probe this table; same returns as host_{chaining,nested}_join."""
        pk = _canon_keys(probe_keys)
        if pk.dtype == np.uint64 and self.key_dtype == np.uint32:
            raise ValueError("u64 probe keys against a u32 table would "
                             "truncate; build the table from u64 keys")
        pk = pk.astype(self.key_dtype, copy=False)
        sfx = "64" if self.key_dtype == np.uint64 else ""
        cap = int(out_cap) if out_cap is not None else max(
            16, 4 * pk.size + self.n_rows)
        if self.kind == "nested" and not unnest:
            cap = 1
        while True:
            op = np.empty(cap, np.int32)
            ob = np.empty(cap, np.int32)
            ctr = np.zeros(3, np.int64)
            if self.kind == "nested":
                n = getattr(self._lib, "hj3e_nested_probe" + sfx)(
                    self._h, _kp(pk), pk.size, int(unnest), _i32p(op),
                    _i32p(ob), cap, _i64p(ctr))
                if n >= 0:
                    return (op[:n].copy(), ob[:n].copy(),
                            int(ctr[0]), int(ctr[1]), int(ctr[2]))
                exact = int(ctr[2])
            else:
                n = getattr(self._lib, "hj3e_chaining_probe" + sfx)(
                    self._h, _kp(pk), pk.size, int(unique), _i32p(op),
                    _i32p(ob), cap, _i64p(ctr))
                if n >= 0:
                    return op[:n].copy(), ob[:n].copy(), int(ctr[0]), int(ctr[1])
                exact = int(ctr[0])
            if out_cap is not None:
                raise ValueError(f"out_cap={cap} too small ({exact} results)")
            cap = max(exact, 1)


def host_two_join_probe(tbl_s: HostTable, tbl_t: HostTable, probe_keys,
                        out_cap: int):
    """Exp-4 probe strand on the host engine: Ndu (nested tables, deferred
    unnesting) or Chj (chaining tables, immediate expansion) -- the kind is
    taken from the tables.  Returns a dict with the same counter keys as the
    device strands (models/exp4.py) plus the (r,s,t) row-id triples."""
    assert tbl_s.kind == tbl_t.kind
    lib = tbl_s._lib
    pk = np.ascontiguousarray(probe_keys, np.uint32)
    cap = max(int(out_cap), 1)
    o_r = np.empty(cap, np.int32)
    o_s = np.empty(cap, np.int32)
    o_t = np.empty(cap, np.int32)
    ctr = np.zeros(7, np.int64)
    if tbl_s.kind == "nested":
        n = lib.hj3e_ndu_probe(tbl_s._h, tbl_t._h, _u32p(pk), pk.size,
                               _i32p(o_r), _i32p(o_s), _i32p(o_t), cap,
                               _i64p(ctr))
        if n < 0:
            raise ValueError(f"out_cap={cap} too small "
                             f"(c_top={int(ctr[6])})")
        return dict(r_row=o_r[:n], s_row=o_s[:n], t_row=o_t[:n],
                    c_probe_RS=int(ctr[0]), c_probe_RS_cmp=int(ctr[1]),
                    c_probe_RT=int(ctr[2]), c_probe_RT_cmp=int(ctr[3]),
                    c_unnest_1=int(ctr[4]), c_unnest_2=int(ctr[5]),
                    c_top=int(ctr[6]))
    n = lib.hj3e_chj_probe(tbl_s._h, tbl_t._h, _u32p(pk), pk.size,
                           _i32p(o_r), _i32p(o_s), _i32p(o_t), cap,
                           _i64p(ctr))
    if n < 0:
        raise ValueError(f"out_cap={cap} too small (c_top={int(ctr[4])})")
    return dict(r_row=o_r[:n], s_row=o_s[:n], t_row=o_t[:n],
                c_probe_RS=int(ctr[0]), c_probe_RS_cmp=int(ctr[1]),
                c_probe_RT=int(ctr[2]), c_probe_RT_cmp=int(ctr[3]),
                c_top=int(ctr[4]))
