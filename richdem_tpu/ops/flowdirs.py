"""Flow-direction metrics as fused XLA stencils (device ops).

Vectorized counterparts of the reference's ``flowmet/`` headers
(SURVEY.md §2.2) and of :mod:`richdem_tpu.oracle.flowdirs`, sharing the
package conventions: off-grid/nodata neighbors skipped, first-max-in-scan-
order tie-breaking (``argmax`` first-occurrence = the oracle's strict-``>``
loop), proportions as (H, W, 8).

Each metric is one fused elementwise pass over 8 shifted views — XLA
compiles it into a single HBM-bandwidth-bound kernel, the speed-of-light
plan for 3×3 stencils.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from richdem_tpu.ops.stencil import neighbor, nodata_like
from richdem_tpu.topology import DR, NO_FLOW, FLOWDIR_NO_DATA

__all__ = [
    "d8_flowdirs", "rho8_flowdirs", "dinf_flowdirs", "flow_proportions",
    "proportions_from_d8", "proportions_from_dinf",
]

_NEG = jnp.float32(-3e38)  # "invalid neighbor" slope sentinel


def _neighbor_slopes(z, nodata_mask, cellsize, dirs, diag_dist=None):
    """(len(dirs), H, W) slopes toward each direction; -inf-ish if invalid.

    ``diag_dist``: optional (H, W) randomized diagonal distance (Rho8)."""
    compute = z.astype(jnp.float32) if z.dtype == jnp.float16 else z
    big = jnp.asarray(np.finfo(np.float32).max, compute.dtype)
    zed = jnp.where(nodata_mask, big, compute)
    slopes = []
    for d in dirs:
        zn = neighbor(zed, d, big)
        dist = jnp.asarray(DR[d], compute.dtype) * cellsize
        if diag_dist is not None and DR[d] > 1.0:
            dist = diag_dist * cellsize
        s = (compute - zn) / dist
        valid = zn < big
        slopes.append(jnp.where(valid, s, _NEG.astype(compute.dtype)))
    return jnp.stack(slopes)


def _steepest(slopes, dirs):
    """First-max direction with positive slope, else NO_FLOW."""
    k = jnp.argmax(slopes, axis=0)  # first occurrence on ties
    best = jnp.max(slopes, axis=0)
    dir_codes = jnp.asarray(np.asarray(dirs, dtype=np.int8))
    return jnp.where(best > 0, dir_codes[k], jnp.int8(NO_FLOW))


def d8_core(z, nodata_mask, cellsize, topology="D8"):
    """Un-jitted core (reused by the sharded wrapper)."""
    dirs = (1, 3, 5, 7) if topology == "D4" else (1, 2, 3, 4, 5, 6, 7, 8)
    slopes = _neighbor_slopes(z, nodata_mask, cellsize, dirs)
    fd = _steepest(slopes, dirs)
    return jnp.where(nodata_mask, jnp.int8(FLOWDIR_NO_DATA), fd)


_d8_flowdirs_impl = partial(jax.jit, static_argnames=("topology",))(d8_core)


def d8_flowdirs(dem, no_data=None, topology="D8", cellsize=1.0):
    """Steepest-descent single flow directions (O'Callaghan & Marks 1984;
    reference ``flowmet/d8_flowdirs.hpp``), as one fused XLA stencil."""
    z = jnp.asarray(dem)
    return _d8_flowdirs_impl(z, nodata_like(z, no_data),
                             jnp.asarray(cellsize, jnp.float32), topology)


@partial(jax.jit, static_argnames=("topology",))
def _rho8_impl(z, nodata_mask, cellsize, key, topology):
    dirs = (1, 3, 5, 7) if topology == "D4" else (1, 2, 3, 4, 5, 6, 7, 8)
    u = jax.random.uniform(key, z.shape, dtype=jnp.float32)
    diag = 1.0 + jnp.tan(u * (jnp.pi / 4.0))
    slopes = _neighbor_slopes(z, nodata_mask, cellsize, dirs,
                              diag_dist=diag.astype(z.dtype))
    fd = _steepest(slopes, dirs)
    return jnp.where(nodata_mask, jnp.int8(FLOWDIR_NO_DATA), fd)


def rho8_flowdirs(dem, no_data=None, key=None, seed=0, topology="D8",
                  cellsize=1.0):
    """Stochastic aspect-unbiased single flow (Fairfield & Leymarie 1991).

    Same randomized-diagonal-distance construction as the oracle
    (``1 + tan(u·pi/4)`` — see oracle docstring for the unbiasedness
    derivation).  Randomness comes from ``jax.random`` (``key``, or
    ``PRNGKey(seed)``); the gates are statistical (SURVEY.md §4d)."""
    z = jnp.asarray(dem)
    if key is None:
        key = jax.random.PRNGKey(seed)
    return _rho8_impl(z, nodata_like(z, no_data),
                      jnp.asarray(cellsize, jnp.float32), key, topology)


# -- D-infinity ---------------------------------------------------------

# (e1, e2, ac, af) facet table — identical to the oracle's _DINF_FACETS.
_FACETS = ((5, 4, 0, 1), (3, 4, 1, -1), (3, 2, 1, 1), (1, 2, 2, -1),
           (1, 8, 2, 1), (7, 8, 3, -1), (7, 6, 3, 1), (5, 6, 4, -1))


@jax.jit
def _dinf_impl(z, nodata_mask, cellsize):
    compute = z.astype(jnp.float64 if z.dtype == jnp.float64
                       else jnp.float32)
    d1 = d2 = cellsize.astype(compute.dtype)
    rmax = jnp.arctan2(d2, d1)
    diag = jnp.sqrt(d1 * d1 + d2 * d2)
    nan = jnp.asarray(jnp.nan, compute.dtype)
    zed = jnp.where(nodata_mask, nan, compute)

    best_s = jnp.zeros(z.shape, compute.dtype)
    best_a = jnp.full(z.shape, -1.0, compute.dtype)
    for e1, e2, ac, af in _FACETS:
        z1 = neighbor(zed, e1, jnp.nan)
        z2 = neighbor(zed, e2, jnp.nan)
        ok1 = ~jnp.isnan(z1)
        ok2 = ~jnp.isnan(z2)
        z1v = jnp.where(ok1, z1, compute)       # degrade to center
        z2v = jnp.where(ok2, z2, z1v)           # degrade to e1
        s1 = (compute - z1v) / d1
        s2 = (z1v - z2v) / d2
        r = jnp.arctan2(s2, s1)
        s_mid = jnp.sqrt(s1 * s1 + s2 * s2)
        s_hi = (compute - z2v) / diag
        rr = jnp.clip(r, 0.0, rmax)
        ss = jnp.where(r < 0.0, s1, jnp.where(r > rmax, s_hi, s_mid))
        ss = jnp.where(ok1 | ok2, ss, -jnp.inf)
        ang = af * rr + ac * (jnp.pi / 2.0)
        take = ss > best_s   # strict: first facet wins ties, as the oracle
        best_a = jnp.where(take, ang, best_a)
        best_s = jnp.where(take, ss, best_s)
    out = jnp.where(best_a >= 0.0, best_a % (2.0 * jnp.pi),
                    jnp.where(best_a == -1.0, best_a,
                              best_a % (2.0 * jnp.pi)))
    out = jnp.where(best_s > 0.0, out, -1.0)
    return jnp.where(nodata_mask, jnp.asarray(-2.0, compute.dtype), out)


def dinf_flowdirs(dem, no_data=None, cellsize=1.0):
    """Continuous flow angles, radians CCW-from-East (Tarboton 1997;
    reference ``flowmet/Tarboton1997.hpp``).  -1 = NO_FLOW, -2 = nodata."""
    z = jnp.asarray(dem)
    return _dinf_impl(z, nodata_like(z, no_data),
                      jnp.asarray(cellsize, jnp.float32))


#: D8 code at angle k·pi/4 — E, NE, N, NW, W, SW, S, SE.
_OCTANT_DIRS = np.array([5, 4, 3, 2, 1, 8, 7, 6])


@jax.jit
def proportions_from_dinf(angles):
    """(H, W, 8) proportions from a D-infinity angle raster: flow splits
    between the two D8 directions bracketing the angle (appendix A.5)."""
    a = jnp.asarray(angles)
    quarter = jnp.asarray(jnp.pi / 4.0, a.dtype)
    k = jnp.floor(a / quarter).astype(jnp.int32) % 8
    frac = (a / quarter - jnp.floor(a / quarter))
    octants = jnp.asarray(_OCTANT_DIRS)
    d_lo = octants[k] - 1
    d_hi = octants[(k + 1) % 8] - 1
    flowing = a >= 0.0
    lo = jnp.where(flowing, 1.0 - frac, 0.0).astype(a.dtype)
    hi = jnp.where(flowing, frac, 0.0).astype(a.dtype)
    props = (jax.nn.one_hot(d_lo, 8, dtype=a.dtype) * lo[..., None]
             + jax.nn.one_hot(d_hi, 8, dtype=a.dtype) * hi[..., None])
    return props


@jax.jit
def proportions_from_d8(flowdirs):
    """One-hot (H, W, 8) proportions from a D8 raster (NO_FLOW/nodata → 0)."""
    fd = jnp.asarray(flowdirs).astype(jnp.int32)
    return jax.nn.one_hot(fd - 1, 8, dtype=jnp.float32) * (
        fd > 0)[..., None].astype(jnp.float32)


@partial(jax.jit, static_argnames=("exponent",))
def _mfd_impl(z, nodata_mask, cellsize, exponent):
    dirs = (1, 2, 3, 4, 5, 6, 7, 8)
    slopes = _neighbor_slopes(z, nodata_mask, cellsize, dirs)
    pos = jnp.maximum(slopes, 0.0)
    wts = jnp.where(pos > 0, pos ** exponent, 0.0)
    total = jnp.sum(wts, axis=0)
    props = jnp.where(total > 0, wts / jnp.maximum(total, 1e-30), 0.0)
    props = jnp.moveaxis(props, 0, -1)
    return jnp.where(nodata_mask[..., None], 0.0, props).astype(
        jnp.float32 if z.dtype != jnp.float64 else jnp.float64)


def flow_proportions(dem, method="D8", no_data=None, exponent=None,
                     cellsize=1.0, key=None, seed=0):
    """Dispatch any metric to (H, W, 8) proportions — device counterpart of
    pyrichdem's ``FlowProportions`` (SURVEY.md §2.5)."""
    z = jnp.asarray(dem)
    method_l = method.lower()
    cs = jnp.asarray(cellsize, jnp.float32)
    if method_l in ("d8", "ocallaghan", "d4"):
        topo = "D4" if method_l == "d4" else "D8"
        return proportions_from_d8(d8_flowdirs(z, no_data, topo, cs))
    if method_l in ("rho8", "rho4"):
        topo = "D4" if method_l == "rho4" else "D8"
        return proportions_from_d8(
            rho8_flowdirs(z, no_data, key=key, seed=seed, topology=topo,
                          cellsize=cs))
    if method_l in ("dinf", "tarboton"):
        return proportions_from_dinf(dinf_flowdirs(z, no_data, cs))
    if method_l == "quinn":
        return _mfd_impl(z, nodata_like(z, no_data), cs, 1.0)
    if method_l == "freeman":
        return _mfd_impl(z, nodata_like(z, no_data), cs,
                         1.1 if exponent is None else float(exponent))
    if method_l == "holmgren":
        if exponent is None:
            raise ValueError("Holmgren requires an exponent")
        return _mfd_impl(z, nodata_like(z, no_data), cs, float(exponent))
    if method_l in ("seibertmcglynn", "md_infinity", "mdinf"):
        return _seibert_impl(z, nodata_like(z, no_data), cs,
                             1.0 if exponent is None else float(exponent))
    raise ValueError(f"unknown flow metric: {method!r}")


@partial(jax.jit, static_argnames=("exponent",))
def _seibert_impl(z, nodata_mask, cellsize, exponent):
    """Triangular multi-flow MD∞ (Seibert & McGlynn 2007), facet-vectorized;
    mirrors the oracle's ``_seibert_mcglynn_proportions`` exactly."""
    compute = z.astype(jnp.float64 if z.dtype == jnp.float64
                       else jnp.float32)
    d1 = d2 = cellsize.astype(compute.dtype)
    rmax = jnp.arctan2(d2, d1)
    diag = jnp.sqrt(d1 * d1 + d2 * d2)
    nan = jnp.asarray(jnp.nan, compute.dtype)
    zed = jnp.where(nodata_mask, nan, compute)

    shares = jnp.zeros(z.shape + (8,), compute.dtype)
    for e1, e2, ac, af in _FACETS:
        z1 = neighbor(zed, e1, jnp.nan)
        z2 = neighbor(zed, e2, jnp.nan)
        ok1 = ~jnp.isnan(z1)
        ok2 = ~jnp.isnan(z2)
        z1v = jnp.where(ok1, z1, compute)
        z2v = jnp.where(ok2, z2, z1v)
        s1 = (compute - z1v) / d1
        s2 = (z1v - z2v) / d2
        r = jnp.arctan2(s2, s1)
        rr = jnp.clip(r, 0.0, rmax)
        ss = jnp.where(r < 0.0, s1,
                       jnp.where(r > rmax, (compute - z2v) / diag,
                                 jnp.sqrt(s1 * s1 + s2 * s2)))
        valid = (ok1 | ok2) & (ss > 0.0)
        weight = jnp.where(valid, ss ** exponent, 0.0)
        frac2 = rr / rmax
        shares = shares.at[..., e1 - 1].add(weight * (1.0 - frac2))
        shares = shares.at[..., e2 - 1].add(weight * frac2)
    total = jnp.sum(shares, axis=-1, keepdims=True)
    props = jnp.where(total > 0, shares / jnp.maximum(total, 1e-30), 0.0)
    return jnp.where(nodata_mask[..., None], 0.0, props)
