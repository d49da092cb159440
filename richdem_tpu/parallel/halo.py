"""Halo exchange over the device mesh via ``lax.ppermute``.

The device-mesh form of the reference's perimeter exchange [P1]: instead of
MPI send/recv through a producer rank, each shard swaps 1-cell (or k-cell)
halos with its 4 mesh neighbors in two stages — rows along ``y``, then
columns of the row-extended block along ``x`` — which carries the diagonal
corners implicitly.  Neighbour ``ppermute`` is point-to-point between
mesh neighbours (strictly better than the reference's star topology —
SURVEY.md §2.4 parallelism table); on GPUs XLA hands it to NCCL.

All functions here must be called inside ``shard_map`` with mesh axes
``("y", "x")``.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

__all__ = ["exchange_halo"]


def _shift(x, axis_name, forward: bool):
    """Receive data from the previous (forward=True: lower-index) mesh
    neighbor along ``axis_name``; edge shards receive zeros."""
    n = lax.axis_size(axis_name)
    if n == 1:
        return jnp.zeros_like(x)
    if forward:  # shard i sends to i+1; I receive from i-1 (my north/west)
        perm = [(i, i + 1) for i in range(n - 1)]
    else:        # shard i sends to i-1; I receive from i+1 (south/east)
        perm = [(i, i - 1) for i in range(1, n)]
    return lax.ppermute(x, axis_name, perm)


def exchange_halo(block, halo=1, fill=0.0, axis_names=("y", "x")):
    """Extend a local (h, w) shard to (h+2k, w+2k) with neighbor halos.

    Off-grid positions (global boundary) are filled with ``fill`` — the
    op-specific boundary condition (e.g. -BIG = drain for filling, nan for
    replicate-center stencils).
    """
    ynam, xnam = axis_names
    k = halo
    yi = lax.axis_index(ynam)
    xi = lax.axis_index(xnam)
    ny = lax.axis_size(ynam)
    nx = lax.axis_size(xnam)
    fillv = jnp.asarray(fill, block.dtype)

    # stage 1: rows. top halo = north neighbor's bottom k rows.
    top = _shift(block[-k:, :], ynam, forward=True)
    bot = _shift(block[:k, :], ynam, forward=False)
    top = jnp.where(yi == 0, fillv, top)
    bot = jnp.where(yi == ny - 1, fillv, bot)
    ext = jnp.concatenate([top, block, bot], axis=0)

    # stage 2: columns of the extended block (carries corners).
    left = _shift(ext[:, -k:], xnam, forward=True)
    right = _shift(ext[:, :k], xnam, forward=False)
    left = jnp.where(xi == 0, fillv, left)
    right = jnp.where(xi == nx - 1, fillv, right)
    return jnp.concatenate([left, ext, right], axis=1)
