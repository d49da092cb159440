"""Terrain attributes as one fused 3×3 stencil (device op).

Device counterpart of the reference's ``TA_*`` family (SURVEY.md §2.2,
appendix A.8) and of :mod:`richdem_tpu.oracle.terrain` — Horn 1981
slope/aspect, Zevenbergen & Thorne 1987 curvatures.  All derivatives come
from one pass over the 8 neighbor views; XLA fuses the whole computation
into a single HBM-bound kernel (the per-device speed-of-light case the
baseline targets).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from richdem_tpu.ops.stencil import neighbor, nodata_like
from richdem_tpu.oracle.terrain import TERRAIN_ATTRIBUTES

__all__ = ["terrain_attribute", "slope_riserun", "TERRAIN_ATTRIBUTES"]


def _window(z, nodata_mask):
    """The 3×3 window with out-of-bounds/nodata replaced by the center.

    Returns (a, b, c, d, e, f, g, h, i) row-major, matching the oracle."""
    nan = jnp.asarray(jnp.nan, z.dtype)
    zed = jnp.where(nodata_mask, nan, z)

    def nb(d):
        v = neighbor(zed, d, jnp.nan)
        return jnp.where(jnp.isnan(v), z, v)

    # direction codes: 2=NW 3=N 4=NE 1=W 5=E 8=SW 7=S 6=SE
    return (nb(2), nb(3), nb(4), nb(1), z, nb(5), nb(8), nb(7), nb(6))


def terrain_core(z, nodata_mask, zscale, cellsize, attrib):
    """Un-jitted core (reused by the sharded wrapper in
    :mod:`richdem_tpu.parallel.sharded`)."""
    compute = (z.astype(jnp.float32) if z.dtype not in
               (jnp.float32, jnp.float64) else z) * zscale
    L = cellsize.astype(compute.dtype)
    a, b, c, d, e, f, g, h, i = _window(compute, nodata_mask)
    fx = ((c + 2 * f + i) - (a + 2 * d + g)) / (8 * L)
    fy = ((g + 2 * h + i) - (a + 2 * b + c)) / (8 * L)

    if attrib == "slope_riserun":
        out = jnp.hypot(fx, fy)
    elif attrib == "slope_percentage":
        out = 100.0 * jnp.hypot(fx, fy)
    elif attrib == "slope_radians":
        out = jnp.arctan(jnp.hypot(fx, fy))
    elif attrib == "slope_degrees":
        out = jnp.degrees(jnp.arctan(jnp.hypot(fx, fy)))
    elif attrib == "aspect":
        flat = (fx == 0) & (fy == 0)
        out = jnp.where(flat, -1.0,
                        jnp.degrees(jnp.arctan2(-fx, fy)) % 360.0)
    else:
        D = ((d + f) / 2.0 - e) / (L * L)
        E = ((b + h) / 2.0 - e) / (L * L)
        F = (-a + c + g - i) / (4.0 * L * L)
        G = (-d + f) / (2.0 * L)
        H = (b - h) / (2.0 * L)
        g2h2 = G * G + H * H
        if attrib == "curvature":
            out = -2.0 * (D + E) * 100.0
        elif attrib == "planform_curvature":
            out = jnp.where(
                g2h2 == 0.0, 0.0,
                2.0 * (D * H * H + E * G * G - F * G * H)
                / jnp.maximum(g2h2, 1e-30) * 100.0)
        else:  # profile_curvature
            out = jnp.where(
                g2h2 == 0.0, 0.0,
                -2.0 * (D * G * G + E * H * H + F * G * H)
                / jnp.maximum(g2h2, 1e-30) * 100.0)
    return jnp.where(nodata_mask, jnp.nan, out)


_terrain_impl = partial(jax.jit, static_argnames=("attrib",))(terrain_core)


def terrain_attribute(dem, attrib, zscale=1.0, cellsize=1.0, no_data=None):
    """One attribute of :data:`TERRAIN_ATTRIBUTES`; nodata cells → nan."""
    if attrib not in TERRAIN_ATTRIBUTES:
        raise ValueError(f"unknown terrain attribute {attrib!r}; "
                         f"expected one of {TERRAIN_ATTRIBUTES}")
    z = jnp.asarray(dem)
    return _terrain_impl(z, nodata_like(z, no_data),
                         jnp.asarray(zscale, jnp.float32),
                         jnp.asarray(cellsize, jnp.float32), attrib)


def slope_riserun(dem, zscale=1.0, cellsize=1.0, no_data=None):
    return terrain_attribute(dem, "slope_riserun", zscale, cellsize,
                             no_data)
