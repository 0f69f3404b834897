"""Multi-chip scaling: device meshes, hash-partition shuffles, distributed joins.

The reference is single-process single-threaded (SURVEY.md section 2.6); this
layer is new design territory: ``jax.sharding.Mesh`` + ``shard_map`` with
XLA collectives (``all_to_all``, ``psum``, ``ppermute``) instead of message
passing.
"""

from .mesh import make_mesh, shard_axis
from .shuffle import shard_of_key, partition_exchange
from .dist_join import dist_nested_join, dist_chaining_join
from .hier import dist_nested_join_2d, make_mesh_2d
from .dist_join import dist_nested_join_chunked
from .ring import dist_ring_nested_join
from .skew import (detect_skew, dist_broadcast_join, dist_hybrid_nested_join,
                   suggest_capacity)
from .pipeline import dist_filter_join_aggregate
from .multi import dist_deferred_two_join

__all__ = [
    "make_mesh", "shard_axis",
    "shard_of_key", "partition_exchange",
    "dist_nested_join", "dist_chaining_join",
    "dist_nested_join_2d", "make_mesh_2d",
    "dist_nested_join_chunked",
    "dist_ring_nested_join",
    "detect_skew", "dist_broadcast_join", "dist_hybrid_nested_join",
    "suggest_capacity",
    "dist_filter_join_aggregate",
    "dist_deferred_two_join",
]
