"""Derived hydrological methods (device ops): TWI/SPI, watersheds,
upslope cells, Strahler order.

Counterpart of the reference's ``methods/d8_methods.hpp`` family
(``d8_SPI``, ``d8_CTI``, ``find_watersheds``, ``d8_upslope_cells``,
``strahler`` — SURVEY.md §2.2, appendix A.7).  Pointwise indices are fused
stencil math; graph-valued methods (watersheds, upslope) use log-depth
successor pointer doubling with gathers only — no queues, no scatters.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from richdem_tpu.ops.stencil import neighbor
from richdem_tpu.ops.sweeps import require_converged
from richdem_tpu.topology import DX, DY, D8_INVERSE

__all__ = ["twi", "spi", "watersheds_from_flowdirs", "upslope_cells",
           "strahler_order", "strahler_order_info"]


@jax.jit
def twi(accum, slope_radians, cellsize=1.0, min_slope=1e-6):
    """Topographic wetness index ``ln(a / tan beta)`` (appendix A.7);
    ``a`` = specific catchment area = accumulation x cellsize."""
    a = jnp.asarray(accum) * cellsize
    tanb = jnp.maximum(jnp.tan(jnp.asarray(slope_radians)), min_slope)
    return jnp.log(jnp.maximum(a, 1e-30) / tanb)


@jax.jit
def spi(accum, slope_radians, cellsize=1.0):
    """Stream power index ``a * tan beta`` (appendix A.7)."""
    return (jnp.asarray(accum) * cellsize
            * jnp.tan(jnp.asarray(slope_radians)))


def _successors(fd):
    """Flattened successor indices; terminals (NO_FLOW/nodata/off-grid
    targets) point to themselves."""
    fd = jnp.asarray(fd).astype(jnp.int32)
    h, w = fd.shape
    rows = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    dy = jnp.asarray(np.asarray(DY, np.int32))[fd.clip(0)]
    dx = jnp.asarray(np.asarray(DX, np.int32))[fd.clip(0)]
    nr, nc = rows + dy, cols + dx
    valid = (fd > 0) & (nr >= 0) & (nr < h) & (nc >= 0) & (nc < w)
    self_idx = rows * w + cols
    return jnp.where(valid, nr * w + nc, self_idx).reshape(-1)


@jax.jit
def watersheds_from_flowdirs(flowdirs):
    """Label every cell with the flat index of its terminal cell — the
    drainage-basin partition (reference ``find_watersheds``).
    Nodata/NO_FLOW cells label themselves.  Log-depth pointer doubling
    (⌈log2 L⌉ gather rounds)."""
    fd = jnp.asarray(flowdirs)
    h, w = fd.shape
    succ = _successors(fd)
    rounds = max(1, int(np.ceil(np.log2(max(h * w, 2)))))

    def body(_, s):
        return s[s]

    final = jax.lax.fori_loop(0, rounds, body, succ)
    return final.reshape(h, w)


@jax.jit
def upslope_cells(seed_mask, flowdirs):
    """Cells whose flow path passes through any seed cell (inclusive) —
    reference ``d8_upslope_cells``.  Pointer doubling on (successor,
    hit-seed)."""
    fd = jnp.asarray(flowdirs)
    h, w = fd.shape
    succ = _successors(fd)
    hit = jnp.asarray(seed_mask).reshape(-1)
    rounds = max(1, int(np.ceil(np.log2(max(h * w, 2)))))

    def body(_, state):
        s, r = state
        return s[s], r | r[s]

    _, reach = jax.lax.fori_loop(0, rounds, body, (succ, hit))
    return reach.reshape(h, w)


@partial(jax.jit, static_argnames=("max_iters",))
def strahler_order_info(flowdirs, max_iters=None):
    """Strahler stream order via monotone fixpoint; returns ``(order,
    iters, converged)``.

    order(c) = m if the max order among inflowing neighbors is m and it is
    unique, m+1 if two or more inflowing neighbors attain m; leaves
    (no inflow) have order 1.  Iterated as a monotone nondecreasing
    stencil fixpoint, which converges one step after the longest flow
    path; ``max_iters`` defaults to a cap no flow path can reach."""
    fd = jnp.asarray(flowdirs).astype(jnp.int32)
    if max_iters is None:
        max_iters = fd.shape[0] * fd.shape[1] + 2
    data = fd >= 0

    def inflow_orders(order):
        """(8, H, W): order of the d-neighbor if it flows into us else 0."""
        stacks = []
        for d in range(1, 9):
            nb_fd = neighbor(fd, d, jnp.int32(-1))
            nb_or = neighbor(order, d, jnp.int32(0))
            flows_in = nb_fd == int(D8_INVERSE[d])
            stacks.append(jnp.where(flows_in, nb_or, 0))
        return jnp.stack(stacks)

    def step(order):
        inc = inflow_orders(order)
        mx = jnp.max(inc, axis=0)
        n_at_max = jnp.sum((inc == mx) & (mx > 0), axis=0)
        new = jnp.where(mx == 0, 1, jnp.where(n_at_max >= 2, mx + 1, mx))
        return jnp.where(data, jnp.maximum(order, new), 0)

    def cond(state):
        _, it, done = state
        return jnp.logical_and(~done, it < max_iters)

    def body(state):
        order, it, _ = state
        new = step(order)
        return new, it + 1, jnp.all(new == order)

    order0 = jnp.where(data, 1, 0).astype(jnp.int32)
    return jax.lax.while_loop(cond, body,
                              (order0, jnp.int32(0), jnp.bool_(False)))


def strahler_order(flowdirs, max_iters=None):
    """Strahler stream order (see :func:`strahler_order_info`); raises if
    the fixpoint does not converge within ``max_iters``."""
    order, iters, done = strahler_order_info(flowdirs, max_iters=max_iters)
    require_converged(done, "Strahler order", int(iters))
    return order
