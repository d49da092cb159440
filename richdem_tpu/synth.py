"""Synthetic DEM generators for tests and benchmarks.

Host-side stand-in for the reference's terrain generation layer
(SURVEY.md §2.2, ``include/richdem/terrain_generation/``): analytic surfaces
(cone, saddle, plateau) plus value-noise fractal terrain.  Everything is
plain numpy so the oracle and the device path share fixtures; ``*_jnp``
variants are trivial wrappers.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "cone_dem",
    "inverted_cone_dem",
    "saddle_dem",
    "plateau_dem",
    "perlin_dem",
    "depression_dem",
    "with_nodata_holes",
]


def _grid_coords(height: int, width: int):
    y, x = np.mgrid[0:height, 0:width]
    return y.astype(np.float64), x.astype(np.float64)


def cone_dem(height: int, width: int = None, peak: float = 100.0,
             dtype=np.float32) -> np.ndarray:
    """A cone peaking at the grid center — every cell drains outward.

    This is benchmark config 1's terrain (BASELINE.md): depression-free, so
    fill is the identity and flow directions are analytically radial.
    """
    width = height if width is None else width
    y, x = _grid_coords(height, width)
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0
    r = np.hypot(y - cy, x - cx)
    rmax = max(np.hypot(cy, cx), 1.0)
    return (peak * (1.0 - r / rmax)).astype(dtype)


def inverted_cone_dem(height: int, width: int = None, depth: float = 100.0,
                      dtype=np.float32) -> np.ndarray:
    """A single giant depression: a cone opening upward (pit at center)."""
    return (-cone_dem(height, width, peak=depth, dtype=np.float64)).astype(
        dtype)


def saddle_dem(height: int, width: int = None, scale: float = 50.0,
               dtype=np.float32) -> np.ndarray:
    """A hyperbolic-paraboloid saddle: mixed aspect/curvature signs."""
    width = height if width is None else width
    y, x = _grid_coords(height, width)
    yn = (y / max(height - 1, 1)) * 2 - 1
    xn = (x / max(width - 1, 1)) * 2 - 1
    return (scale * (xn * xn - yn * yn)).astype(dtype)


def plateau_dem(height: int, width: int = None, base: float = 10.0,
                top: float = 20.0, margin: int = None,
                dtype=np.float32) -> np.ndarray:
    """A flat-topped mesa: exercises flat resolution (a perfectly flat
    region whose drainage is undefined until ResolveFlats runs)."""
    width = height if width is None else width
    margin = max(height, width) // 4 if margin is None else margin
    z = np.full((height, width), base, dtype=np.float64)
    z[margin:height - margin, margin:width - margin] = top
    # Tilt the surrounding terrain slightly so it drains deterministically.
    y, x = _grid_coords(height, width)
    z += 1e-3 * (x + y)
    z[margin:height - margin, margin:width - margin] = top  # keep flat exact
    return z.astype(dtype)


def depression_dem(height: int, width: int = None, dtype=np.float32,
                   seed: int = 0, n_pits: int = 8,
                   pit_depth: float = 30.0) -> np.ndarray:
    """A gently sloping plane pocked with Gaussian pits — guarantees real
    depressions with known count for fill tests."""
    width = height if width is None else width
    rng = np.random.default_rng(seed)
    y, x = _grid_coords(height, width)
    z = 50.0 + 0.05 * (x + 0.5 * y)
    for _ in range(n_pits):
        py = rng.uniform(0.15, 0.85) * height
        px = rng.uniform(0.15, 0.85) * width
        sigma = rng.uniform(0.03, 0.1) * max(height, width)
        depth = rng.uniform(0.3, 1.0) * pit_depth
        z -= depth * np.exp(-((y - py) ** 2 + (x - px) ** 2) / (2 * sigma**2))
    return z.astype(dtype)


def perlin_dem(height: int, width: int = None, seed: int = 0,
               octaves: int = 5, base_period: int = None,
               amplitude: float = 100.0, dtype=np.float32) -> np.ndarray:
    """Fractal value-noise terrain (smooth, multi-octave).

    Not Ken Perlin's exact gradient noise — a smoothstep-interpolated value
    noise with the same role as the reference's Perlin generator
    (``terrain_generation/PerlinNoise.hpp`` per SURVEY.md §2.2): realistic
    multi-scale terrain with seedable determinism.
    """
    width = height if width is None else width
    base_period = max(height, width) // 4 if base_period is None else base_period
    base_period = max(base_period, 2)
    rng = np.random.default_rng(seed)
    z = np.zeros((height, width), dtype=np.float64)
    amp = 1.0
    total_amp = 0.0
    for octave in range(octaves):
        period = max(base_period >> octave, 1)
        gh = height // period + 2
        gw = width // period + 2
        lattice = rng.uniform(-1.0, 1.0, size=(gh, gw))
        y, x = _grid_coords(height, width)
        gy, gx = y / period, x / period
        y0, x0 = np.floor(gy).astype(int), np.floor(gx).astype(int)
        ty, tx = gy - y0, gx - x0
        # smoothstep interpolation
        sy = ty * ty * (3 - 2 * ty)
        sx = tx * tx * (3 - 2 * tx)
        v00 = lattice[y0, x0]
        v01 = lattice[y0, x0 + 1]
        v10 = lattice[y0 + 1, x0]
        v11 = lattice[y0 + 1, x0 + 1]
        top = v00 * (1 - sx) + v01 * sx
        bot = v10 * (1 - sx) + v11 * sx
        z += amp * (top * (1 - sy) + bot * sy)
        total_amp += amp
        amp *= 0.5
    z *= amplitude / total_amp
    return z.astype(dtype)


def with_nodata_holes(dem: np.ndarray, no_data: float = -9999.0,
                      seed: int = 0, n_holes: int = 4,
                      max_radius: int = None) -> np.ndarray:
    """Punch circular nodata holes into a DEM (returns a copy)."""
    h, w = dem.shape
    max_radius = max(h, w) // 10 if max_radius is None else max_radius
    rng = np.random.default_rng(seed)
    z = np.array(dem, copy=True)
    y, x = _grid_coords(h, w)
    for _ in range(n_holes):
        cy = rng.uniform(0, h)
        cx = rng.uniform(0, w)
        r = rng.uniform(1, max(max_radius, 2))
        z[(y - cy) ** 2 + (x - cx) ** 2 <= r * r] = no_data
    return z
