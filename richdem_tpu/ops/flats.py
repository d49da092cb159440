"""Flat resolution as min-plus distance-transform fixpoints (device op).

Device counterpart of the reference's ``flats/flat_resolution.hpp``
(Barnes, Lehman & Mulla 2014 — SURVEY.md §2.2, appendix A.3) and of
:mod:`richdem_tpu.oracle.flats`.  The oracle's two synchronized BFS passes
are unit-weight shortest-path problems, so each runs on the sweep engine
(:mod:`richdem_tpu.ops.sweeps`) in a handful of log-depth sweeps:

1. flat membership  — a local predicate standing in for the flood from
   NO_FLOW cells over equal-elevation edges (see ``_resolve_impl``; a flat
   is the connected equal-z component containing a NO_FLOW cell,
   label-free since two distinct flats cannot be adjacent at equal z);
2. ``T`` towards-lower — hop distance from the flat's outlet cells;
3. ``D`` away-from-higher — hop distance (seeded at 1) from cells adjacent
   to strictly higher ground, through NO_FLOW flat cells;
4. per-flat ``max(D)`` — a max-propagation, run as min-plus on ``-D`` with
   zero-cost flat edges;
5. ``flat_mask = 2T + (maxD + 1 - D)`` and steepest descent on it.

The resulting integer fields equal the oracle's BFS levels exactly
(synchronized-frontier BFS ≡ unit-weight Bellman fixpoint), so resolved
flow directions match bitwise.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from richdem_tpu.ops.stencil import neighbor, nodata_like
from richdem_tpu.ops.sweeps import (BIG, fixpoint_cap, minplus_fixpoint,
                                    require_converged)
from richdem_tpu.topology import DR, NO_FLOW

__all__ = ["resolve_flats", "flat_mask_and_labels_device"]

_UNREACHED = BIG / 2


def _edge_costs(allowed_into, step=1.0):
    """(8, H, W) costs: ``step`` where the edge is allowed, else BIG."""
    return jnp.where(allowed_into, jnp.float32(step), jnp.float32(BIG))


def _dist(w0, costs, max_iters):
    w, iters, done = minplus_fixpoint(
        w0.astype(jnp.float32), jnp.float32(-BIG), costs,
        boundary=jnp.float32(BIG), max_iters=max_iters)
    return w, iters, done


@partial(jax.jit, static_argnames=("max_iters",))
def _resolve_impl(z, fd, nodata_mask, max_iters):
    zf = z.astype(jnp.float32) if z.dtype != jnp.float64 else z
    data = ~nodata_mask
    noflow = (fd == NO_FLOW) & data

    nan = jnp.asarray(jnp.nan, zf.dtype)
    zed = jnp.where(nodata_mask, nan, zf)
    z_nb = [neighbor(zed, d, jnp.nan) for d in range(1, 9)]
    z_eq = jnp.stack([zed == zb for zb in z_nb])          # (8, H, W)
    nb_data = jnp.stack([~jnp.isnan(zb) for zb in z_nb])
    nb_higher = jnp.stack([zb > zed for zb in z_nb])

    # 1. flat membership.  Exact membership is a flood from NO_FLOW cells
    # across equal-z edges; every edge predicate below already requires
    # ``z_eq`` between the two cells, and NO_FLOW cells are members by
    # definition, so the local closure ``noflow | (data ∧ ∃ equal-z data
    # neighbour)`` changes no resolved direction or mask value: a
    # superset cell can seed or relax a NO_FLOW chain only through an
    # equal-z adjacency, which would make it an exact member too.  The
    # ``in_flat`` diagnostic is that superset.
    in_flat = noflow | (data & jnp.any(z_eq & nb_data, axis=0))

    def nb_mask(m):
        return jnp.stack([neighbor(m, d, False) for d in range(1, 9)])

    nb_in_flat = nb_mask(in_flat)
    nb_noflow = nb_mask(noflow)

    # Virtual drains: NO_FLOW cells on the border or touching nodata —
    # they drain off-grid (fill semantics), seed T at 0, and keep NO_FLOW.
    h, w = z.shape
    rows = jnp.arange(h)[:, None]
    cols = jnp.arange(w)[None, :]
    on_border = (rows == 0) | (rows == h - 1) | (cols == 0) | (cols == w - 1)
    near_nodata = jnp.any(nb_mask(nodata_mask), axis=0)
    drain = noflow & (on_border | near_nodata)

    # 2. T: towards-lower distance, seeded 0 at outlet cells
    #    (real outlets = flat cells that already flow; virtual = drains).
    outlet = in_flat & (~noflow | drain)
    t_cost = _edge_costs(z_eq & (noflow & in_flat)[None] & nb_in_flat)
    T, i1, d1 = _dist(jnp.where(outlet, 0.0, BIG), t_cost, max_iters)

    # 3. D: away-from-higher distance, seeded 1 at flat/higher boundary.
    high_seed = noflow & in_flat & jnp.any(nb_higher & nb_data, axis=0)
    d_cost = _edge_costs(
        z_eq & (noflow & in_flat)[None] & (nb_noflow & nb_in_flat))
    D, i2, d2 = _dist(jnp.where(high_seed, 1.0, BIG), d_cost, max_iters)

    # 4. per-flat max(D) via min-plus on -D over zero-cost flat edges.
    m_cost = _edge_costs(z_eq & in_flat[None] & nb_in_flat, step=0.0)
    d_finite = jnp.where(D < _UNREACHED, D, 0.0)
    neg_max, i3, d3 = _dist(jnp.where(in_flat, -d_finite, BIG), m_cost,
                            max_iters)
    maxD = -neg_max

    # 5. combine.
    away_term = jnp.where(D < _UNREACHED, maxD + 1.0 - D, 0.0)
    drained = noflow & ~drain & in_flat & (T < _UNREACHED)
    mask = jnp.where(drained, 2.0 * T + away_term, 0.0)

    # Steepest descent on the mask, restricted to same-flat neighbors.
    inv_dr = jnp.asarray(1.0 / DR[1:9], mask.dtype)[:, None, None]
    nb_mask_vals = jnp.stack(
        [neighbor(mask, d, BIG) for d in range(1, 9)])
    slopes = jnp.where(z_eq & nb_in_flat, (mask[None] - nb_mask_vals)
                       * inv_dr, -BIG)
    k = jnp.argmax(slopes, axis=0)
    best = jnp.max(slopes, axis=0)
    new_dir = jnp.where(best > 0, (k + 1).astype(fd.dtype),
                        jnp.asarray(NO_FLOW, fd.dtype))
    resolved = jnp.where(drained & (fd == NO_FLOW), new_dir, fd)
    info = (i1 + i2 + i3, d1 & d2 & d3)
    return resolved, mask.astype(jnp.int32), in_flat, info


def resolve_flats(dem, flowdirs, no_data=None, max_iters=None,
                  return_info=False):
    """Return flow directions with flats drained (device op).
    ``return_info`` additionally returns ``(total sweep rotations,
    converged)`` across the distance fixpoints (roofline accounting +
    truncation guard)."""
    z = jnp.asarray(dem)
    fd = jnp.asarray(flowdirs)
    resolved, _, _, info = _resolve_impl(z, fd, nodata_like(z, no_data),
                                         max_iters)
    require_converged(info[1], "flat-resolution distance sweeps",
                      max_iters or fixpoint_cap(z.shape))
    if return_info:
        return resolved, info[0], info[1]
    return resolved


def flat_mask_and_labels_device(dem, flowdirs, no_data=None,
                                max_iters=None):
    """(flat_mask, in_flat) diagnostic view (labels are implicit — the
    mask is already per-flat consistent)."""
    z = jnp.asarray(dem)
    fd = jnp.asarray(flowdirs)
    _, mask, in_flat, _ = _resolve_impl(z, fd, nodata_like(z, no_data),
                                        max_iters)
    return mask, in_flat
