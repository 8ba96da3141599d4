"""Mesh construction helpers.

Axis conventions:
* 1-D mesh ("shards",): row partition of the operator — the analog of the
  reference's MPI_COMM_WORLD rank dimension.
* 2-D mesh ("host", "chip"): the analog of the reference's two-level
  communicator split (reference: utils/preAlps_utils.c:687
  preAlps_comm2LevelsSplit — masterLevel ↔ "host" axis, localLevel ↔ "chip"
  axis). Collectives are scoped per axis.

The mesh follows the algorithm alone: the cards of one host are joined all
to all by NVLink, so any device order costs the same, and shard i of an
n-shard mesh lives on jax.devices()[i].
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(nshards: int | None = None, axis: str = "shards") -> Mesh:
    devices = jax.devices()
    nshards = nshards or len(devices)
    if nshards > len(devices):
        raise ValueError(f"requested {nshards} shards but only {len(devices)} devices")
    return Mesh(np.array(devices[:nshards]), (axis,))


def make_mesh_2level(nhosts: int, chips_per_host: int) -> Mesh:
    devices = jax.devices()
    need = nhosts * chips_per_host
    if need > len(devices):
        raise ValueError(f"requested {need} devices, have {len(devices)}")
    arr = np.array(devices[:need]).reshape(nhosts, chips_per_host)
    return Mesh(arr, ("host", "chip"))
