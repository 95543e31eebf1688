"""Device-mesh helpers: the replacement for the reference's Julia
``Distributed`` worker topology.

The reference discovers a two-level master/node-leader/worker tree over TCP
RPC (``src/utils.jl:51-64``) and hand-rolls reduce/broadcast over it
(``src/local_clusters_actions.jl:171-203,518-549``).  Here the *entire*
topology is a 1-D ``jax.sharding.Mesh`` over every addressable device;
points are sharded over the ``"data"`` axis, the cluster table is
replicated, and the per-sweep statistics reduction is a single ``psum``
that XLA hands to NCCL on GPUs.  The GPUs of a host reach each other all to
all, so the mesh follows the algorithm alone: one data axis.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def make_data_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None) -> Mesh:
    """A 1-D mesh over ``n_devices`` (default: all addressable devices)."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        if n_devices > len(devices):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devices)} present"
            )
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (DATA_AXIS,))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Rows sharded over the data axis (points, labels, sub-labels)."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    """Fully-replicated sharding (cluster table, PRNG key, scalars)."""
    return NamedSharding(mesh, P())
