"""Device-mesh construction for spatial domain decomposition.

The DEM grid is sharded over a 2-D mesh with axes ``("y", "x")`` —
the device analog of the reference's rectangular tile grid [P1]
(SURVEY.md §2.4): each device owns one contiguous tile; neighbor halos ride
``ppermute`` (:mod:`richdem_tpu.parallel.halo`).
"""

from __future__ import annotations

import math

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec

__all__ = ["make_mesh", "grid_sharding", "best_factorization"]


def best_factorization(n: int) -> tuple:
    """Split n devices into the most-square (ny, nx) grid."""
    best = (1, n)
    for ny in range(1, int(math.isqrt(n)) + 1):
        if n % ny == 0:
            best = (ny, n // ny)
    return best


def make_mesh(devices=None, shape=None) -> Mesh:
    """A 2-D ``("y", "x")`` mesh over the given (default: all) devices."""
    devices = jax.devices() if devices is None else list(devices)
    if shape is None:
        shape = best_factorization(len(devices))
    ny, nx = shape
    if ny * nx != len(devices):
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.array(devices).reshape(ny, nx)
    return Mesh(arr, axis_names=("y", "x"))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding that tiles an (H, W) raster over the mesh."""
    return NamedSharding(mesh, PartitionSpec("y", "x"))
