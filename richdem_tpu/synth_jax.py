"""On-device synthetic DEM generators (JAX).

Device-side counterparts of :mod:`richdem_tpu.synth` (the reference's
terrain-generation layer, SURVEY.md §2.2).  The numpy generators exist for
tiny oracle fixtures; THESE are what benchmarks and large-scale runs use:
the device generates a 10240² raster in milliseconds, where host-side
numpy takes seconds and a host-to-device copy besides.

Values are NOT bit-identical to the numpy generators (different RNG
streams); statistically equivalent terrain with the same knobs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["cone_dem", "saddle_dem", "plateau_dem", "depression_dem",
           "perlin_dem", "perlin_dem_rows", "with_nodata_holes"]


def _coords(height, width, dtype=jnp.float32):
    y = jax.lax.broadcasted_iota(dtype, (height, width), 0)
    x = jax.lax.broadcasted_iota(dtype, (height, width), 1)
    return y, x


@partial(jax.jit, static_argnames=("height", "width"))
def cone_dem(height: int, width: int = None, peak: float = 100.0):
    """Cone peaking at the grid center (benchmark config 1 terrain)."""
    width = height if width is None else width
    y, x = _coords(height, width)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    r = jnp.hypot(y - cy, x - cx)
    rmax = max(float(np.hypot(cy, cx)), 1.0)
    return peak * (1.0 - r / rmax)


@partial(jax.jit, static_argnames=("height", "width"))
def saddle_dem(height: int, width: int = None, scale: float = 50.0):
    width = height if width is None else width
    y, x = _coords(height, width)
    yn = (y / max(height - 1, 1)) * 2 - 1
    xn = (x / max(width - 1, 1)) * 2 - 1
    return scale * (xn * xn - yn * yn)


@partial(jax.jit, static_argnames=("height", "width", "margin"))
def plateau_dem(height: int, width: int = None, base: float = 10.0,
                top: float = 20.0, margin: int = None):
    width = height if width is None else width
    margin = max(height, width) // 4 if margin is None else margin
    y, x = _coords(height, width)
    z = base + 1e-3 * (x + y)
    flat = ((y >= margin) & (y < height - margin)
            & (x >= margin) & (x < width - margin))
    return jnp.where(flat, jnp.float32(top), z)


@partial(jax.jit, static_argnames=("height", "width", "n_pits"))
def depression_dem(height: int, width: int = None, seed: int = 0,
                   n_pits: int = 8, pit_depth: float = 30.0):
    """Sloping plane pocked with Gaussian pits (guaranteed depressions)."""
    width = height if width is None else width
    key = jax.random.PRNGKey(seed)
    ky, kx, ks, kd = jax.random.split(key, 4)
    y, x = _coords(height, width)
    z = 50.0 + 0.05 * (x + 0.5 * y)
    py = jax.random.uniform(ky, (n_pits,), minval=0.15, maxval=0.85) * height
    px = jax.random.uniform(kx, (n_pits,), minval=0.15, maxval=0.85) * width
    sig = jax.random.uniform(ks, (n_pits,), minval=0.03,
                             maxval=0.1) * max(height, width)
    dep = jax.random.uniform(kd, (n_pits,), minval=0.3,
                             maxval=1.0) * pit_depth

    def body(i, z):
        g = jnp.exp(-((y - py[i]) ** 2 + (x - px[i]) ** 2)
                    / (2 * sig[i] ** 2))
        return z - dep[i] * g

    return jax.lax.fori_loop(0, n_pits, body, z)


def perlin_dem(height: int, width: int = None, seed: int = 0,
               octaves: int = 5, base_period: int = None,
               amplitude: float = 100.0):
    """Multi-octave smoothstep value noise, entirely on device.

    Above 12288² the whole-grid call is staged through
    ``perlin_dem_rows`` strips (equal up to backend fusion rounding —
    see its docstring): one whole-grid gather holds ~20 grid-sized
    temporaries live, while 8 strip dispatches peak at ~2 grid-sizes."""
    width = height if width is None else width
    if height * width > 12288 * 12288:
        bh = -(-height // 8)
        return jnp.concatenate(
            [perlin_dem_rows(height, width, r0,
                             min(bh, height - r0), seed=seed,
                             octaves=octaves, base_period=base_period,
                             amplitude=amplitude)
             for r0 in range(0, height, bh)], axis=0)
    return _perlin_dem_whole(height, width, seed=seed, octaves=octaves,
                             base_period=base_period, amplitude=amplitude)


@partial(jax.jit, static_argnames=("height", "width", "octaves",
                                   "base_period"))
def _perlin_dem_whole(height, width, seed=0, octaves=5, base_period=None,
                      amplitude=100.0):
    return perlin_dem_rows(height, width, 0, height, seed=seed,
                           octaves=octaves, base_period=base_period,
                           amplitude=amplitude)


@partial(jax.jit, static_argnames=("height", "width", "row0", "nrows",
                                   "octaves", "base_period"))
def perlin_dem_rows(height: int, width: int, row0: int, nrows: int,
                    seed: int = 0, octaves: int = 5,
                    base_period: int = None, amplitude: float = 100.0):
    """Rows ``[row0, row0+nrows)`` of ``perlin_dem(height, width, ...)``:
    the per-octave lattices are seeded and shaped from the GLOBAL dims
    and every per-cell op is elementwise over globally-offset
    coordinates, so the strip equals slicing the full field —
    bit-identical on CPU (tests/test_synth_jax.py); an accelerator
    backend's excess-precision fusion may round the two programs apart
    by ≤1 ulp of the amplitude (either field is a valid, deterministic
    DEM).  This is how a grid too large for one gather is staged."""
    base_period = (max(height, width) // 4 if base_period is None
                   else base_period)
    base_period = max(base_period, 2)
    key = jax.random.PRNGKey(seed)
    y, x = _coords(nrows, width)
    y = y + jnp.float32(row0)
    z = jnp.zeros((nrows, width), jnp.float32)
    amp, total_amp = 1.0, 0.0
    for octave in range(octaves):
        key, sub = jax.random.split(key)
        period = max(base_period >> octave, 1)
        gh, gw = height // period + 2, width // period + 2
        lattice = jax.random.uniform(sub, (gh, gw), minval=-1.0, maxval=1.0)
        gy, gx = y / period, x / period
        y0 = jnp.floor(gy).astype(jnp.int32)
        x0 = jnp.floor(gx).astype(jnp.int32)
        ty, tx = gy - y0, gx - x0
        sy = ty * ty * (3 - 2 * ty)
        sx = tx * tx * (3 - 2 * tx)
        v00 = lattice[y0, x0]
        v01 = lattice[y0, x0 + 1]
        v10 = lattice[y0 + 1, x0]
        v11 = lattice[y0 + 1, x0 + 1]
        top = v00 * (1 - sx) + v01 * sx
        bot = v10 * (1 - sx) + v11 * sx
        z = z + amp * (top * (1 - sy) + bot * sy)
        total_amp += amp
        amp *= 0.5
    return z * (amplitude / total_amp)


def with_nodata_holes(dem, no_data=-9999.0, seed=0, n_holes=4,
                      max_radius=None):
    """Punch circular nodata holes into a device DEM (the device
    counterpart of :func:`richdem_tpu.synth.with_nodata_holes`)."""
    h, w = dem.shape
    max_radius = max(h, w) // 10 if max_radius is None else max_radius
    return _holes(dem, jnp.float32(no_data), seed, n_holes,
                  float(max(max_radius, 2)))


@partial(jax.jit, static_argnames=("n_holes",))
def _holes(dem, no_data, seed, n_holes, max_radius):
    h, w = dem.shape
    ky, kx, kr = jax.random.split(jax.random.PRNGKey(seed), 3)
    cy = jax.random.uniform(ky, (n_holes,)) * h
    cx = jax.random.uniform(kx, (n_holes,)) * w
    r = jax.random.uniform(kr, (n_holes,), minval=1.0, maxval=max_radius)
    y, x = _coords(h, w)

    def body(i, hole):
        return hole | ((y - cy[i]) ** 2 + (x - cx[i]) ** 2 <= r[i] ** 2)

    hole = jax.lax.fori_loop(0, n_holes, body, jnp.zeros((h, w), bool))
    return jnp.where(hole, no_data.astype(dem.dtype), dem)
