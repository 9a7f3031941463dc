"""Device mesh and sharding helpers.

Design (scaling-book recipe): pick a mesh, annotate shardings with
``NamedSharding``, let XLA's SPMD partitioner insert the collectives.
For feature extraction the only tensor axis worth sharding is the
utterance batch ("data"); the model axes ("feat") exist for the
trainable front-end and for very wide filterbanks.

Axis convention:
- ``data`` — utterance batch; maps onto every device of every host.
  Per-host input shards stay host-local, so the network between hosts
  carries only CMVN statistics (bytes, not tensors).
- ``feat`` — feature/model dimension for tensor-parallel projections.
"""

from __future__ import annotations

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


DATA_AXIS = "data"
FEAT_AXIS = "feat"


def make_mesh(shape: tuple[int, ...] | None = None,
              axis_names: tuple[str, ...] = (DATA_AXIS,),
              devices=None) -> Mesh:
    """Build a mesh over available devices.

    Default: 1-D mesh over all devices named "data".  ``shape`` with more
    axes (e.g. (n//2, 2) with ("data", "feat")) enables tensor-parallel
    layouts.  Devices are laid out in the given order: the GPUs of a host
    are joined all to all, so no physical ordering applies.
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != {n} devices")
    return Mesh(np.asarray(devices).reshape(shape), axis_names)


def data_sharding(mesh: Mesh, ndim: int = 2) -> NamedSharding:
    """Shard the leading (batch) axis over "data"; replicate the rest."""
    return NamedSharding(mesh, P(DATA_AXIS, *([None] * (ndim - 1))))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(x, mesh: Mesh):
    """Place a host array with its batch axis sharded over "data"."""
    return jax.device_put(x, data_sharding(mesh, x.ndim))
