"""Device-mesh helpers.

One logical axis ``'x'`` carries the table partitioning (the operator/tensor
parallel axis of the join: each chip owns one hash partition of the build
table).  The cards of one host are joined all to all by NVLink, so a flat
axis is the whole topology; ``hier.py`` adds a (host, chip) mesh for
schedules that span hosts over the network.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

SHARD_AXIS = "x"


def make_mesh(n_devices: int | None = None, axis: str = SHARD_AXIS) -> Mesh:
    devs = jax.devices()
    if n_devices is None:
        n_devices = len(devs)
    if n_devices > len(devs):
        raise ValueError(f"requested {n_devices} devices, have {len(devs)}")
    return Mesh(np.asarray(devs[:n_devices]), (axis,))


def shard_axis(mesh: Mesh, axis: str = SHARD_AXIS) -> NamedSharding:
    """Sharding that splits a 1-D column across the mesh axis."""
    return NamedSharding(mesh, P(axis))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
