"""Depression filling as an iterative parallel-flood fixpoint (device op).

Data-parallel replacement for the reference's serial Priority-Flood
(``include/richdem/depressions/Barnes2014.hpp`` — SURVEY.md §2.2, appendix
A.2): the filled surface is the unique Bellman value

    W(c) = min over paths c→drain of max(Z along path) (+ eps per step)

with drains = off-grid (via border cells) and nodata regions, which the
sweep engine (:mod:`richdem_tpu.ops.sweeps`) computes in a handful of
log-depth directional sweeps.  Output is allclose-identical to the oracle's
heap-based fill by construction.

Epsilon semantics: a *fixed* per-step epsilon (uniform over all 8
directions by default), identical to the oracle — not the reference's
order-dependent ``nextafter`` chain (SURVEY.md §7 hard-part 1).  Beware
float32: choose ``eps`` > ulp of the highest elevation or the increments
vanish; :func:`auto_epsilon` does this.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from richdem_tpu.ops.stencil import nodata_like
from richdem_tpu.ops.sweeps import (BIG, fixpoint_cap, minplus_fixpoint,
                                    require_converged)
from richdem_tpu.topology import DR

__all__ = ["fill_depressions", "fill_epsilon", "fill_depressions_info",
           "auto_epsilon"]


def auto_epsilon(dem, dtype=None) -> float:
    """Smallest safe fixed epsilon for a DEM: 2 ulp at the max |elevation|
    plus headroom for accumulation across the grid diameter.

    Only a scalar leaves the device (pulling the whole raster to this
    host's ~0.3 GB/s RAM costs seconds at 8192²)."""
    if isinstance(dem, jnp.ndarray):
        dtype = np.dtype(dtype or dem.dtype)
        zab = jnp.abs(dem)
        zab = jnp.where(jnp.isfinite(zab), zab, 0.0)
        scale = max(float(jnp.max(zab)), 1.0)
        shape = dem.shape
    else:
        z = np.asarray(dem)
        dtype = np.dtype(dtype or z.dtype)
        scale = float(np.max(np.abs(z[np.isfinite(z)]), initial=1.0))
        shape = z.shape
    diam = sum(shape[-2:])
    # increments must stay resolvable after `diam` additions
    return float(np.finfo(dtype).eps * scale * 4 *
                 max(1, int(np.log2(max(diam, 2)))))


@partial(jax.jit, static_argnames=("max_iters", "scale_diagonal"))
def fill_depressions_info(dem, nodata_mask=None, eps=0.0, max_iters=None,
                          scale_diagonal=False):
    """Fill; returns ``(filled, iters, converged)``.

    ``nodata_mask``: optional bool (H, W) — nodata regions act as drains
    and are returned unchanged.  ``max_iters`` defaults to
    :func:`~richdem_tpu.ops.sweeps.fixpoint_cap` of the grid.  ``scale_diagonal``: multiply eps by sqrt(2)
    on diagonal edges (Planchon–Darboux flavor); default off to match the
    reference's uniform-epsilon behavior.
    """
    z = jnp.asarray(dem)
    if nodata_mask is None:
        nodata_mask = jnp.zeros(z.shape, dtype=bool)
    neg = jnp.asarray(-BIG, z.dtype)
    floor = jnp.where(nodata_mask, neg, z)
    w0 = jnp.where(nodata_mask, neg, jnp.asarray(BIG, z.dtype))
    if scale_diagonal:
        costs = (jnp.asarray(eps, z.dtype)
                 * jnp.asarray(DR[1:9], z.dtype)[:, None, None])
    else:
        costs = jnp.asarray(eps, z.dtype)
    w, iters, done = minplus_fixpoint(w0, floor, costs, boundary=neg,
                                      max_iters=max_iters)
    return jnp.where(nodata_mask, z, w), iters, done


def fill_depressions(dem, no_data=None, eps=0.0, max_iters=None,
                     scale_diagonal=False):
    """Plain (or epsilon) depression fill; returns the filled raster.

    Device counterpart of ``oracle.priority_flood_fill`` /
    ``oracle.priority_flood_epsilon``; raises if the sweeps do not
    converge within ``max_iters``."""
    z = jnp.asarray(dem)
    filled, _, done = fill_depressions_info(z, nodata_like(z, no_data),
                                            eps=eps, max_iters=max_iters,
                                            scale_diagonal=scale_diagonal)
    require_converged(done, "depression fill",
                      max_iters or fixpoint_cap(z.shape))
    return filled


def fill_epsilon(dem, no_data=None, eps=None, max_iters=None):
    """Epsilon fill with an automatically chosen epsilon by default."""
    if eps is None:
        eps = auto_epsilon(np.asarray(dem))
    return fill_depressions(dem, no_data=no_data, eps=eps,
                            max_iters=max_iters)
