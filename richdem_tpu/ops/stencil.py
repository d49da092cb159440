"""8-neighbor shifted-array stencil primitives (pure XLA).

The workhorse of every flow metric and Jacobi fixpoint: ``neighbor(x, d)``
returns, for each cell, the value of its direction-``d`` neighbor (package
encoding, :mod:`richdem_tpu.topology`), with a caller-chosen fill for
off-grid.  XLA fuses chains of these pads/slices with the consuming
elementwise math into a single HBM pass, which is the speed-of-light plan
for stencils.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from richdem_tpu.topology import DX, DY, DR

__all__ = ["neighbor", "all_neighbors", "neighbor_distances", "nodata_like"]


def neighbor(x: jnp.ndarray, d: int, fill) -> jnp.ndarray:
    """Value of each cell's neighbor in direction ``d`` (static int 1..8).

    Off-grid positions read ``fill``.  Works on (..., H, W) arrays,
    shifting the last two axes.
    """
    dy, dx = int(DY[d]), int(DX[d])
    h, w = x.shape[-2], x.shape[-1]
    pad = [(0, 0)] * (x.ndim - 2) + [(1, 1), (1, 1)]
    xp = jnp.pad(x, pad, constant_values=fill)
    return xp[..., 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def all_neighbors(x: jnp.ndarray, fill) -> jnp.ndarray:
    """Stack of the 8 neighbor views, shape (8, ..., H, W), index k = d-1."""
    return jnp.stack([neighbor(x, d, fill) for d in range(1, 9)])


def neighbor_distances(cellsize=1.0, dtype=jnp.float32) -> jnp.ndarray:
    """(8,) distances to each neighbor (1 or sqrt(2), times cellsize)."""
    return jnp.asarray(np.asarray(DR[1:9]) * float(cellsize), dtype=dtype)


def nodata_like(z: jnp.ndarray, no_data) -> jnp.ndarray:
    """Boolean nodata mask from a scalar ``no_data`` (None -> all False)."""
    if no_data is None:
        return jnp.zeros(z.shape, dtype=bool)
    if isinstance(no_data, float) and np.isnan(no_data):
        return jnp.isnan(z)
    return z == jnp.asarray(no_data, dtype=z.dtype)
