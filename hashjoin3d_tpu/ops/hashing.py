"""Scalar integer hash functions, vectorized (jax.numpy) with numpy mirrors.

Vectorized re-implementation of the reference hash library (see
``/root/reference/util/hasht.hh:17-264``).  The reference evaluates these hashes
one tuple at a time inside the probe/build loops; here every function maps a whole
*column* (a ``uint32``/``uint64`` array) to a hash column in one vector op so XLA
can fuse it into the surrounding gather/compare pipeline.

``murmur32`` is the one hash actually used by the experiment drivers
(``main_experiment1.cc:231``, ``main_experiment4.cc:263``) and therefore the one
that must match the reference *bit-exactly*: hash-table bucket assignment
(``hash % num_buckets``, ``ht_chaining.hh:139-140``) and the multi-chip partition
routing both derive from it.  All arithmetic is explicit uint32/uint64 with
wraparound multiplication, mirroring C semantics.

Each function comes in two flavors:
  * ``murmur32(x)``      - jax.numpy, traced/jitted, runs on the device
  * ``murmur32_np(x)``   - numpy, host-side mirror for data generation and oracles

Both flavors are tested to agree with each other and with the reference
finalizer constants.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "murmur32",
    "murmur32_np",
    "murmur64",
    "murmur64_np",
    "boncz32",
    "boncz32_np",
    "boncz64",
    "fibhash32_np",
    "larson_np",
    "multiplicative32",
    "crc32c_u32_np",
    "crc32c_u64_np",
    "hash_crc32_np",
    "hash_crc64_np",
    "hash_crc32x2_np",
]


# -- murmur finalizers (reference: util/hasht.hh:49-72) -----------------------

_M32_C1 = 0x85EBCA6B
_M32_C2 = 0xC2B2AE35
_M64_C1 = 0xFF51AFD7ED558CCD
_M64_C2 = 0xC4CEB9FE1A95EC63


def murmur32(x):
    """Murmur3 32-bit finalizer, elementwise over a uint32 array (device path)."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(_M32_C1)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(_M32_C2)
    x = x ^ (x >> 16)
    return x


def murmur32_np(x):
    """Murmur3 32-bit finalizer, numpy mirror (host path)."""
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(_M32_C1)
        x = x ^ (x >> np.uint32(13))
        x = x * np.uint32(_M32_C2)
        x = x ^ (x >> np.uint32(16))
    return x


def murmur64(x):
    """Murmur3 64-bit finalizer (needs jax x64 enabled)."""
    x = jnp.asarray(x, jnp.uint64)
    x = x ^ (x >> 33)
    x = x * jnp.uint64(_M64_C1)
    x = x ^ (x >> 33)
    x = x * jnp.uint64(_M64_C2)
    x = x ^ (x >> 33)
    return x


def murmur64_np(x):
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(_M64_C1)
        x = x ^ (x >> np.uint64(33))
        x = x * np.uint64(_M64_C2)
        x = x ^ (x >> np.uint64(33))
    return x


def hash_key(x, hashfun="murmur"):
    """Hash finalizer matched to the key width (util/hasht.hh:17-113).

    The engine's tables are dtype-generic over u32/u64 join keys; bucket
    assignment uses the same-width functor the reference would instantiate
    (``HashMurmur<uint32_t>`` / ``HashMurmur<uint64_t>`` by default).

    ``hashfun`` selects the functor, closing the reference's pluggable
    hash-functor contract (``Thashfun`` / ``Tprobehashfun``,
    ``ht_chaining.hh:236-248``, ``ht_nested.hh:355-363``): a registry name
    from :data:`HASH_FUNCTORS` ("murmur", "boncz", "fib", "mult") or any
    traceable callable ``u32/u64 array -> same-width hash array``.  Build
    and probe must agree on the functor; the tables record it as a static
    field so probes pick it up automatically.
    """
    if callable(hashfun):
        return hashfun(x)
    f32, f64 = HASH_FUNCTORS[hashfun]
    if jnp.dtype(x.dtype).itemsize == 8:
        return f64(x)
    return f32(x)


def hash_key_np(x, hashfun="murmur"):
    """Host-side (numpy) mirror of :func:`hash_key` for oracles and the
    dense-direct occupancy check."""
    if callable(hashfun):
        return hashfun(x)
    f32, f64 = HASH_FUNCTORS_NP[hashfun]
    if np.dtype(np.asarray(x).dtype).itemsize == 8:
        return f64(x)
    return f32(x)


def bucket_of(h, num_buckets: int):
    """``hash % numBuckets`` in the hash's own width (ht_chaining.hh:139-140)."""
    return (h % h.dtype.type(num_buckets)).astype(jnp.int32)


# -- boncz hash (reference: util/hasht.hh:100-113) ----------------------------

def boncz32(x):
    x = jnp.asarray(x, jnp.uint32)
    return (x >> 21) ^ (x >> 13) ^ (x >> 7) ^ x


def boncz32_np(x):
    x = np.asarray(x, np.uint32)
    return (x >> np.uint32(21)) ^ (x >> np.uint32(13)) ^ (x >> np.uint32(7)) ^ x


def boncz64(x):
    x = jnp.asarray(x, jnp.uint64)
    return (x >> 7) ^ (x >> 13) ^ (x >> 17) ^ (x >> 23) ^ (x >> 43)


# -- fibonacci hash (reference: util/hasht.hh:19-47) --------------------------

def fibhash32_np(x, n):
    """32-bit Fibonacci hash into [0, n).  Double-precision host mirror."""
    x = np.asarray(x, np.uint32).astype(np.float64)
    b = 2654435769.0
    a = b / float(1 << 32)
    z = a * x
    return np.floor(n * (z - np.floor(z))).astype(np.uint32)


# -- larson string hash (reference: util/hasht.hh:75-86) ----------------------

def larson_np(s: bytes, salt: int = 0) -> int:
    h = np.uint32(salt)
    with np.errstate(over="ignore"):
        for ch in s:
            h = h * np.uint32(101) + np.uint32(ch)
    return int(h)


# -- multiplicative hashing (reference: util/hasht.hh:89-98) ------------------

def multiplicative32(x, a: int, b: int):
    x = jnp.asarray(x, jnp.uint32)
    return jnp.uint32(a) * x + jnp.uint32(b)


def multiplicative32_np(x, a: int, b: int):
    x = np.asarray(x, np.uint32)
    with np.errstate(over="ignore"):
        return np.uint32(a) * x + np.uint32(b)


def multiplicative64(x, a: int, b: int):
    x = jnp.asarray(x, jnp.uint64)
    return jnp.uint64(a) * x + jnp.uint64(b)


def multiplicative64_np(x, a: int, b: int):
    x = np.asarray(x, np.uint64)
    with np.errstate(over="ignore"):
        return np.uint64(a) * x + np.uint64(b)


# -- fibonacci hash, device (jnp) flavors (reference: util/hasht.hh:31-39) -------

def fibhash32(x, n):
    """32-bit Fibonacci hash into [0, n), double-precision like the
    reference (``util/hasht.hh:31-39``); needs jax x64 (enabled at package
    import)."""
    x = jnp.asarray(x, jnp.uint32).astype(jnp.float64)
    b = 2654435769.0
    a = b / float(1 << 32)
    z = a * x
    return jnp.floor(n * (z - jnp.floor(z))).astype(jnp.uint32)


def fibhash64(x, n):
    x = jnp.asarray(x, jnp.uint64).astype(jnp.float64)
    b = 11400714819323198485.0
    a = b / float(1 << 64)
    z = a * x
    return jnp.floor(n * (z - jnp.floor(z))).astype(jnp.uint64)


# -- fibonacci hash, 16/64-bit variants (reference: util/hasht.hh:22-47) ------

def fibhash16_np(x, n):
    x = np.asarray(x, np.uint16).astype(np.float64)
    b = 40503.0
    a = b / float(1 << 16)
    z = a * x
    return np.floor(n * (z - np.floor(z))).astype(np.uint16)


def fibhash64_np(x, n):
    x = np.asarray(x, np.uint64).astype(np.float64)
    b = 11400714819323198485.0
    a = b / float(1 << 64)
    z = a * x
    return np.floor(n * (z - np.floor(z))).astype(np.uint64)


# -- CRC32-C (Castagnoli), software table implementation -----------------------
# The reference's HashCrc32 family uses SSE4.2 _mm_crc32_u32
# (util/hasht.hh:115-262); the device has no CRC instruction here, so provide the standard
# table-driven software CRC32-C for host-side parity and as a secondary
# engine hash.

_CRC32C_POLY = 0x82F63B78
_crc32c_table = None


def _crc32c_build_table():
    global _crc32c_table
    t = np.zeros(256, np.uint32)
    for i in range(256):
        c = np.uint32(i)
        for _ in range(8):
            c = np.uint32((int(c) >> 1) ^ (_CRC32C_POLY if int(c) & 1 else 0))
        t[i] = c
    _crc32c_table = t
    return t


def crc32c_u32_np(x, seed=0xFFFFFFFF):
    """CRC32-C of each uint32 value (4 bytes LE), vectorized numpy.

    Matches hardware ``_mm_crc32_u32(seed, x)`` semantics (no final xor).
    """
    t = _crc32c_table if _crc32c_table is not None else _crc32c_build_table()
    x = np.asarray(x, np.uint32)
    crc = np.full(x.shape, np.uint32(seed & 0xFFFFFFFF), np.uint32)
    for shift in (0, 8, 16, 24):
        byte = ((x >> np.uint32(shift)) & np.uint32(0xFF))
        crc = (crc >> np.uint32(8)) ^ t[((crc ^ byte) & np.uint32(0xFF))]
    return crc


def crc32c_u64_np(x, seed=0xFFFFFFFF):
    """CRC32-C of each uint64 value (8 bytes LE): ``_mm_crc32_u64`` semantics.

    Only the low 32 bits of ``seed`` participate; the result is the 32-bit
    CRC zero-extended to uint64, exactly like the hardware instruction the
    reference wraps at ``util/hasht.hh:126-131``.
    """
    t = _crc32c_table if _crc32c_table is not None else _crc32c_build_table()
    x = np.asarray(x, np.uint64)
    crc = np.full(x.shape, np.uint32(seed & 0xFFFFFFFF), np.uint32)
    for shift in range(0, 64, 8):
        byte = ((x >> np.uint64(shift)) & np.uint64(0xFF)).astype(np.uint32)
        crc = (crc >> np.uint32(8)) ^ t[((crc ^ byte) & np.uint32(0xFF))]
    return crc.astype(np.uint64)


# Reference functor seeds (util/hasht.hh:195-262).
CRC_SEED_INITIAL = 0x6CA55437AE08FE14
CRC_SEED_1 = 0x832CA348C6F5DAE9
CRC_SEED_2 = 0x53C5A37A580308E3


def hash_crc32_np(x, seed=CRC_SEED_INITIAL):
    """``HashCrc32<u32>::operator()`` (util/hasht.hh:202-225): one-shot CRC."""
    return crc32c_u32_np(x, seed)


def hash_crc64_np(x):
    """``HashCrc64::hash`` (util/hasht.hh:227-244): two u64 CRCs combined.

    Validated against SSE4.2: hash(0x123456789abcdef0) == 0x554ca2fdcc86751d.
    """
    h1 = crc32c_u64_np(x, CRC_SEED_1)
    h2 = crc32c_u64_np(x, CRC_SEED_2)
    return h1 ^ (h2 << np.uint64(32))


def hash_crc32x2_np(x, mod=None):
    """``HashCrc32x2<u32>::operator()`` (util/hasht.hh:246-262).

    Without ``mod``: the first-seed CRC only (the reference's unary form).
    With ``mod``: ``((crc1 << 32) | crc2) % mod`` truncated to uint32.
    """
    c1 = crc32c_u32_np(x, CRC_SEED_1)
    if mod is None:
        return c1
    c2 = crc32c_u32_np(x, CRC_SEED_2)
    h = (c1.astype(np.uint64) << np.uint64(32)) | c2.astype(np.uint64)
    return (h % np.uint64(mod)).astype(np.uint32)


# -- pluggable functor registry (reference: concepts.hh:40-47 hashfun_c;
# per-call-site injection at ht_chaining.hh:236-248, ht_nested.hh:355-363).
# Each entry is a (u32 flavor, u64 flavor) pair; full-width outputs so the
# table's ``hash % num_buckets`` bucketing (ht_chaining.hh:139-140) applies
# uniformly.  Knuth multiplicative constants for "mult"; "fib" maps through
# the reference's double-precision formula at full width.

_KNUTH32 = 2654435761
_KNUTH64 = 11400714819323198485

HASH_FUNCTORS = {
    "murmur": (murmur32, murmur64),
    "boncz": (boncz32, boncz64),
    "fib": (lambda x: fibhash32(x, float(1 << 32)),
            lambda x: fibhash64(x, float(1 << 64))),
    "mult": (lambda x: multiplicative32(x, _KNUTH32, 0),
             lambda x: multiplicative64(x, _KNUTH64, 0)),
    "identity": (lambda x: jnp.asarray(x, jnp.uint32),
                 lambda x: jnp.asarray(x, jnp.uint64)),
}


def boncz64_np(x):
    x = np.asarray(x, np.uint64)
    return ((x >> np.uint64(7)) ^ (x >> np.uint64(13))
            ^ (x >> np.uint64(17)) ^ (x >> np.uint64(23))
            ^ (x >> np.uint64(43)))


def _fib_full32_np(x):
    x = np.asarray(x, np.uint32).astype(np.float64)
    a = 2654435769.0 / float(1 << 32)
    z = a * x
    return np.floor(float(1 << 32) * (z - np.floor(z))).astype(np.uint32)


def _fib_full64_np(x):
    x = np.asarray(x, np.uint64).astype(np.float64)
    a = 11400714819323198485.0 / float(1 << 64)
    z = a * x
    return np.floor(float(1 << 64) * (z - np.floor(z))).astype(np.uint64)


HASH_FUNCTORS_NP = {
    "murmur": (murmur32_np, murmur64_np),
    "boncz": (boncz32_np, boncz64_np),
    "fib": (_fib_full32_np, _fib_full64_np),
    "mult": (lambda x: multiplicative32_np(x, _KNUTH32, 0),
             lambda x: multiplicative64_np(x, _KNUTH64, 0)),
    "identity": (lambda x: np.asarray(x, np.uint32),
                 lambda x: np.asarray(x, np.uint64)),
}
