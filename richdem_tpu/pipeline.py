"""The flagship end-to-end pipeline: fill → flow directions → accumulation
(+ slope/TWI), as one jittable step.

This is the benchmark target of BASELINE.md (north star: grid-points/s for
fill→flowdir→accum on a 10k×10k DEM) and the ``entry()`` model for the
driver.  Single-device here; the domain-decomposed version lives in
:func:`richdem_tpu.parallel.sharded.sharded_pipeline`.

Every stage is plain XLA except D8 accumulation, whose engine
:func:`richdem_tpu.ops.accum.d8_accumulation_info` picks per platform
(the row-walk kernel on a GPU).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from richdem_tpu.ops.sweeps import BIG, minplus_fixpoint_core
from richdem_tpu.ops.flowdirs import d8_core
from richdem_tpu.ops.accum import d8_accumulation_info
from richdem_tpu.ops.terrain import terrain_core
from richdem_tpu.methods import twi as _twi

import numpy as np

__all__ = ["terrain_pipeline", "make_pipeline", "resumable_pipeline",
           "check_converged"]


def _pipeline(z, nodata, eps, cellsize, fill_iters, rounds, with_twi):
    neg = jnp.asarray(-BIG, z.dtype)
    floor = jnp.where(nodata, neg, z)
    w0 = jnp.where(nodata, neg, jnp.asarray(BIG, z.dtype))
    filled, fiters, fdone = minplus_fixpoint_core(
        w0, floor, jnp.asarray(eps, z.dtype),
        boundary=neg, max_iters=fill_iters)
    filled = jnp.where(nodata, z, filled)
    fd = d8_core(filled, nodata, jnp.asarray(cellsize, jnp.float32))
    weights = jnp.where(nodata, 0.0, 1.0).astype(jnp.float32)
    acc, aiters, adone = d8_accumulation_info(fd, weights, rounds)
    acc = jnp.where(nodata, 0.0, acc)
    # convergence flags ride in the output so no caller can silently use
    # a truncated fixpoint: the eager wrappers and bench/CLI entry points
    # assert them once concrete.
    out = {"filled": filled, "flowdirs": fd, "accum": acc,
           "fill_iters": fiters, "accum_rotations": aiters,
           "fill_converged": fdone, "accum_converged": adone}
    if with_twi:
        slope = terrain_core(filled, nodata,
                             jnp.asarray(1.0, jnp.float32),
                             jnp.asarray(cellsize, jnp.float32),
                             "slope_radians")
        out["slope"] = slope
        out["twi"] = _twi(acc, slope, cellsize=cellsize)
    return out


def make_pipeline(shape, eps=1e-3, cellsize=1.0, fill_iters=None,
                  with_twi=False, no_data=None, max_rotations=None):
    """A jitted ``step(dem) -> dict`` closure for a fixed grid shape.

    ``no_data``: sentinel value treated as nodata (drains; zero weight;
    returned unchanged) — matching ``resumable_pipeline`` so the cached
    and uncached CLI paths agree.

    ``fill_iters`` defaults to :func:`~richdem_tpu.ops.sweeps.fixpoint_cap`
    of the grid.  The output dict carries ``fill_converged``/
    ``accum_converged`` flags; the caps bound the *loop*, never the result — callers must
    check the flags (``check_converged``/``terrain_pipeline`` do) rather
    than trust a possibly-truncated fixpoint."""
    from richdem_tpu.ops.stencil import nodata_like

    # Gauss–Seidel rotation cap: each rotation resolves every monotone
    # flow-path segment, so convergence is O(direction changes) — but an
    # adversarial serpentine DEM has O(H) direction changes, so the
    # log2(n) default is a *loop bound*, not a guarantee; the converged
    # flags in the output are the guarantee.
    if max_rotations is None:
        max_rotations = max(
            4, int(np.ceil(np.log2(max(shape[0] * shape[1], 2)))))
    rounds = max_rotations

    @jax.jit
    def step(z):
        nodata = nodata_like(z, no_data)
        return _pipeline(z, nodata, eps, cellsize, fill_iters, rounds,
                         with_twi)

    return step


def check_converged(out):
    """Raise if a pipeline output dict carries unconverged fixpoints.
    Call on concrete (post-run) outputs; a truncated accumulation is a
    correctness bug, not a degraded answer."""
    if not bool(out["fill_converged"]):
        raise RuntimeError(
            f"pipeline fill did not converge in {int(out['fill_iters'])} "
            "iterations; raise fill_iters")
    if not bool(out["accum_converged"]):
        raise RuntimeError(
            "pipeline accumulation did not converge in "
            f"{int(out['accum_rotations'])} GS rotations; raise "
            "max_rotations (adversarial flow paths need up to O(H))")
    return out


def terrain_pipeline(dem, eps=1e-3, cellsize=1.0, fill_iters=None,
                     with_twi=False, no_data=None, max_rotations=None):
    """One-shot convenience wrapper around :func:`make_pipeline`;
    raises on non-convergence (no silent truncation)."""
    z = jnp.asarray(dem)
    out = make_pipeline(z.shape, eps, cellsize, fill_iters,
                        with_twi, no_data=no_data,
                        max_rotations=max_rotations)(z)
    return check_converged(out)


def resumable_pipeline(dem, cache_dir, grid_id="grid", eps=1e-3,
                       cellsize=1.0, with_twi=True, no_data=None):
    """fill → flowdirs → accum (→ slope/TWI) with phase-granular
    checkpoint/resume (SURVEY.md §5.3/5.4: the reference's --cache-dir
    tile eviction recast as .npy phase dumps).  A rerun after a crash
    loads finished phases from ``cache_dir`` and computes only the rest.
    """
    import numpy as np

    from richdem_tpu import ops
    from richdem_tpu.checkpoint import PhaseCache, fingerprint_of
    from richdem_tpu.ops.stencil import nodata_like

    dem_np = np.asarray(dem)
    # the fingerprint invalidates stale entries when the DEM or any
    # result-changing knob differs from the cached run (ADVICE r1)
    fp = fingerprint_of(
        f"eps={eps};cellsize={cellsize};no_data={no_data}", dem_np)
    cache = PhaseCache(cache_dir, grid_id, fingerprint=fp)
    z = jnp.asarray(dem_np)
    nd_mask = nodata_like(z, no_data)

    filled = cache.run(
        "filled", lambda: ops.fill_depressions(z, no_data=no_data, eps=eps))
    fd = cache.run(
        "flowdirs", lambda: ops.flowdirs.d8_flowdirs(
            jnp.asarray(filled), no_data=no_data, cellsize=cellsize))
    acc = cache.run(
        "accum", lambda: ops.d8_accumulation(
            jnp.asarray(fd), no_data_mask=nd_mask))
    out = {"filled": filled, "flowdirs": fd, "accum": acc}
    if with_twi:
        slope = cache.run(
            "slope", lambda: terrain_core(
                jnp.asarray(filled), nd_mask, jnp.asarray(1.0, jnp.float32),
                jnp.asarray(cellsize, jnp.float32), "slope_radians"))
        out["slope"] = slope
        out["twi"] = cache.run(
            "twi", lambda: _twi(jnp.asarray(acc), jnp.asarray(slope),
                                cellsize=cellsize))
    return out
