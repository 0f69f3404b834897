"""hashjoin3d_tpu: a vectorized query-execution engine in JAX.

Brand-new JAX/XLA implementation of the capabilities of the CIDR 2022
"3D Hash Join" artifact (dflaxx/3d-hashjoin, mounted read-only at
``/root/reference``): hash joins over a chaining and a nested/"3D" hash table,
deferred unnesting of nested match groups, filter, hash aggregate and radix
sort -- as whole-column operators over SoA batches, plus the two experiment
harnesses with identical CSV measurement schemas.

Not a port: the reference's tuple-at-a-time push algebra and pointer-chasing
hash tables (``algebra.hh``, ``ht_chaining.hh``, ``ht_nested.hh``) become dense
CSR layouts built by sorts/prefix sums and probed by vectorized gathers, with
multi-chip scaling via ``jax.sharding`` meshes and ``shard_map`` collectives.

Layout:
  ops/       hash functions, CSR table layouts, join/unnest/filter/aggregate/sort
  models/    query-plan compositions mirroring the reference experiment plans
  parallel/  device meshes, hash-partition shuffles, distributed joins
  utils/     data generators (bit-exact vs the reference), CSV writer, measurement
  native/    C++ support library (bit-exact std::mt19937 data generation)

64-bit integer support is enabled at import: plan counters (comparison counts,
result cardinalities) can exceed 2**31 on large configs.  All hot-path arrays
declare explicit 32-bit dtypes, so this only affects the final counter
reductions.
"""

from jax import config as _config

_config.update("jax_enable_x64", True)

from .api import JoinResult, join  # noqa: E402  (needs x64 set first)

__version__ = "0.1.0"
__all__ = ["join", "JoinResult"]
