"""Orlandini 2003 D8-LTD/LAD as a device iterate-to-fixpoint (XLA).

Counterpart of the reference's ``flowmet/Orlandini2003.hpp`` (SURVEY.md
§2.2, which asked for a device iterate-to-fixpoint over the deviation
field as the alternative to oracle-only).  The method is path-
sequential: each cell's choice between the two facet-bracketing D8
directions depends on the cumulative deviation δ carried from upstream.

Device formulation.  Candidate targets are *strictly lower* neighbors,
so the (fd, δ) dependency graph is stratified by elevation — an acyclic
system with a unique fixpoint equal to the oracle's descending-elevation
serial computation.  Iterate jointly:

    fd ← choose(δ)        (pointwise, from per-cell facet data that is
                           static given z — precomputed once)
    δ  ← λ·(δ(u*) + t(u*)) where u* is the lowest-elevation inflowing
                           neighbor (ties: largest flat index — the
                           oracle's "last processed wins" rule)

Jacobi-style, one path step per iteration; equality convergence is sound
because the map's fixpoint is unique.  All tie-breaks replicate
``oracle/orlandini.py`` exactly (first-max facet, |δ+t| then steeper-
side then smaller D8 code) — gated bitwise in tests/test_ops_flowdirs.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from richdem_tpu.ops.stencil import neighbor, nodata_like
from richdem_tpu.topology import DX, DY, D8_INVERSE, FLOWDIR_NO_DATA, \
    NO_FLOW

__all__ = ["orlandini_flowdirs_device"]

#: (e1, e2, ac, af) — same facet table as Tarboton/Dinf and the oracle.
_FACETS = ((5, 4, 0, 1), (3, 4, 1, -1), (3, 2, 1, 1), (1, 2, 2, -1),
           (1, 8, 2, 1), (7, 8, 3, -1), (7, 6, 3, 1), (5, 6, 4, -1))


def _facet_data(z, nodata, d1, mode):
    """Static per-cell facet selection + candidate data (oracle §loop).

    Returns (e1, e2, t1, t2, c1_ok, c2_ok, pref1, pref2, any_facet)."""
    compute = z.dtype
    diag = d1 * jnp.sqrt(jnp.asarray(2.0, compute))
    rmax = jnp.arctan2(d1, d1)
    nan = jnp.asarray(jnp.nan, compute)
    zed = jnp.where(nodata, nan, z)

    best_s = jnp.zeros(z.shape, compute)
    best_i = jnp.full(z.shape, -1, jnp.int32)
    best_r = jnp.zeros(z.shape, compute)
    best_ok1 = jnp.zeros(z.shape, bool)
    best_ok2 = jnp.zeros(z.shape, bool)
    for i, (e1, e2, ac, af) in enumerate(_FACETS):
        z1 = neighbor(zed, e1, jnp.nan)
        z2 = neighbor(zed, e2, jnp.nan)
        ok1 = ~jnp.isnan(z1)
        ok2 = ~jnp.isnan(z2)
        z1v = jnp.where(ok1, z1, zed)
        z2v = jnp.where(ok2, z2, z1v)
        s1 = (zed - z1v) / d1
        s2 = (z1v - z2v) / d1
        r = jnp.arctan2(s2, s1)
        rr = jnp.clip(r, 0.0, rmax)
        ss = jnp.where(r < 0.0, s1,
                       jnp.where(r > rmax, (zed - z2v) / diag,
                                 jnp.hypot(s1, s2)))  # == oracle np.hypot
        ss = jnp.where(ok1 | ok2, ss, -jnp.inf)
        take = ss > best_s   # strict: FIRST facet wins ties (oracle)
        best_s = jnp.where(take, ss, best_s)
        best_i = jnp.where(take, i, best_i)
        best_r = jnp.where(take, rr, best_r)
        best_ok1 = jnp.where(take, ok1, best_ok1)
        best_ok2 = jnp.where(take, ok2, best_ok2)

    e1_tab = jnp.asarray([f[0] for f in _FACETS], jnp.int32)
    e2_tab = jnp.asarray([f[1] for f in _FACETS], jnp.int32)
    bi = best_i.clip(0)
    e1 = e1_tab[bi]
    e2 = e2_tab[bi]
    rr = best_r
    if mode == "LTD":
        t1 = -d1 * jnp.sin(rr)
        t2 = diag * jnp.sin(rmax - rr)
    else:                       # LAD
        t1 = -rr
        t2 = rmax - rr

    # candidate must exist AND be strictly lower than the center
    def lower(code):
        zn = jnp.zeros(z.shape, compute)
        for d in range(1, 9):
            zn = jnp.where(code == d, neighbor(zed, d, jnp.nan), zn)
        return zn < zed

    c1_ok = best_ok1 & lower(e1)
    c2_ok = best_ok2 & lower(e2)
    half = rmax / 2.0
    pref1 = jnp.where(rr <= half, 0, 1).astype(jnp.int32)
    pref2 = jnp.where(rr > half, 0, 1).astype(jnp.int32)
    any_facet = best_i >= 0
    return e1, e2, t1, t2, c1_ok, c2_ok, pref1, pref2, any_facet


@partial(jax.jit, static_argnames=("mode", "max_iters"))
def _orlandini_impl(z, nodata, lam, d1, mode, max_iters):
    compute = jnp.float64 if z.dtype == jnp.float64 else jnp.float32
    zc = z.astype(compute)
    (e1, e2, t1, t2, c1_ok, c2_ok,
     pref1, pref2, any_facet) = _facet_data(zc, nodata,
                                            jnp.asarray(d1, compute),
                                            mode)
    h, w = z.shape
    idx = (jax.lax.broadcasted_iota(jnp.int32, (h, w), 0) * w
           + jax.lax.broadcasted_iota(jnp.int32, (h, w), 1))
    big = jnp.asarray(jnp.inf, compute)
    zed = jnp.where(nodata, big, zc)  # nodata never wins the u* argmin

    def choose(delta):
        """fd from δ — the oracle's candidate rule, vectorized."""
        a1 = jnp.abs(delta + t1)
        a2 = jnp.abs(delta + t2)
        # lexicographic (|δ+t|, pref, D8 code) over available candidates
        pick1 = jnp.where(
            c1_ok & ~c2_ok, True,
            jnp.where(~c1_ok & c2_ok, False,
                      (a1 < a2) | ((a1 == a2) & (
                          (pref1 < pref2)
                          | ((pref1 == pref2) & (e1 < e2))))))
        fd = jnp.where(pick1, e1, e2).astype(jnp.int8)
        fd = jnp.where(any_facet & (c1_ok | c2_ok), fd,
                       jnp.int8(NO_FLOW))
        fd = jnp.where(nodata, jnp.int8(FLOWDIR_NO_DATA), fd)
        return fd

    def propagate(fd, delta):
        """δ(c) ← λ·(δ(u*)+t_sel(u*)); u* = lowest-z inflowing neighbor
        (ties: largest flat index — oracle's last-processed-wins)."""
        t_sel = jnp.where(fd == e1, t1, t2)
        contrib = lam * (delta + t_sel)
        best_z = jnp.full((h, w), big, compute)
        best_idx = jnp.full((h, w), -1, jnp.int32)
        best_v = jnp.zeros((h, w), compute)
        for d in range(1, 9):
            inv = int(D8_INVERSE[d])
            nb_fd = neighbor(fd, d, jnp.int8(0))
            flows_in = nb_fd == inv
            nb_z = neighbor(zed, d, big)
            nb_idx = neighbor(idx, d, jnp.int32(-1))
            nb_v = neighbor(contrib, d, jnp.asarray(0.0, compute))
            better = flows_in & (
                (nb_z < best_z)
                | ((nb_z == best_z) & (nb_idx > best_idx)))
            best_z = jnp.where(better, nb_z, best_z)
            best_idx = jnp.where(better, nb_idx, best_idx)
            best_v = jnp.where(better, nb_v, best_v)
        return jnp.where(best_idx >= 0, best_v, 0.0)

    def cond(state):
        _, _, it, done = state
        return jnp.logical_and(~done, it < max_iters)

    def body(state):
        fd, delta, it, _ = state
        new_delta = propagate(fd, delta)
        new_fd = choose(new_delta)
        done = jnp.all(new_fd == fd) & jnp.all(new_delta == delta)
        return new_fd, new_delta, it + 1, done

    delta0 = jnp.zeros((h, w), compute)
    fd0 = choose(delta0)
    fd, delta, iters, done = jax.lax.while_loop(
        cond, body, (fd0, delta0, jnp.int32(0), jnp.bool_(False)))
    return fd, iters, done


def orlandini_flowdirs_device(dem, no_data=None, lam=1.0, mode="LTD",
                              cellsize=1.0, max_iters=65536):
    """Device D8-LTD/LAD; identical output to the oracle (tests).

    One Jacobi iteration advances the deviation field one flow-path step,
    so the iteration count is O(longest flow path) — fine for moderate
    grids; the serial host oracle remains the default dispatch at scale
    (the reference's own posture: serial C++)."""
    if mode not in ("LTD", "LAD"):
        raise ValueError("mode must be 'LTD' or 'LAD'")
    z = jnp.asarray(dem)
    mask = nodata_like(z, no_data)
    compute = jnp.float64 if z.dtype == jnp.float64 else jnp.float32
    fd, _, done = _orlandini_impl(z, mask, jnp.asarray(lam, compute),
                                  float(cellsize), mode, max_iters)
    if not isinstance(done, jax.core.Tracer) and not bool(done):
        raise RuntimeError("Orlandini deviation fixpoint did not "
                           f"converge within {max_iters} iterations")
    return fd
