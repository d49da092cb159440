"""Flow accumulation by parallel upstream propagation (device ops).

Device counterpart of the reference's topological-queue engine
(``methods/flow_accumulation_generic.hpp`` — SURVEY.md §2.2, §3.2,
appendix A.6).  Two strategies, both queue-free:

* **Jacobi fixpoint** (any metric): ``A ← w + Pᵀ A`` where ``Pᵀ A`` is one
  fused 8-direction stencil (inflow from each neighbor that routes toward
  us).  ``P`` is nilpotent on the post-fill DAG, so iteration converges in
  longest-flow-path steps.  Used for multi-flow metrics and as a
  cross-check.
* **Gauss–Seidel line sweeps** (D8): one directional sweep resolves
  every monotone flow-path segment, so a few rotations converge where
  Jacobi needs O(longest-path) iterations.  On a GPU the sweeps run as
  the row-walk kernel of :mod:`richdem_tpu.ops.accum_rowwalk`; elsewhere
  as the XLA line scan below, which is the CPU engine and the kernel's
  cross-check.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from richdem_tpu.ops.stencil import neighbor
from richdem_tpu.ops.sweeps import require_converged
from richdem_tpu.topology import D8_INVERSE

__all__ = ["flow_accumulation_from_props", "d8_accumulation",
           "d8_accumulation_info", "accumulation_jacobi_info", "jacobi_cap"]


def _inflow_step(acc, props):
    """One application of Pᵀ: total inflow into each cell.

    ``props``: (H, W, 8).  The neighbor in direction d sends us its
    ``acc * props[..., inverse(d)-1]``."""
    total = jnp.zeros_like(acc)
    for d in range(1, 9):
        inv = int(D8_INVERSE[d])
        contrib = acc * props[..., inv - 1]
        total = total + neighbor(contrib, d, 0.0)
    return total


def jacobi_cap(h, w, check_every=8):
    """Iteration cap that no acyclic flow field can reach: Jacobi
    converges one step after the longest flow path, which has at most
    ``h * w`` cells."""
    return h * w + 2 * check_every


@partial(jax.jit, static_argnames=("max_iters", "check_every"))
def accumulation_jacobi_info(props, weights=None, max_iters=None,
                             check_every=8):
    """Jacobi accumulation; returns ``(accum, iters, converged)``.
    ``max_iters`` defaults to :func:`jacobi_cap` of the grid."""
    props = jnp.asarray(props)
    h, w, _ = props.shape
    if max_iters is None:
        max_iters = jacobi_cap(h, w, check_every)
    dtype = props.dtype if props.dtype == jnp.float64 else jnp.float32
    if weights is None:
        weights = jnp.ones((h, w), dtype)
    else:
        weights = jnp.asarray(weights, dtype)
    props = props.astype(dtype)

    def cond(state):
        _, it, done = state
        return jnp.logical_and(~done, it < max_iters)

    def body(state):
        acc, it, _ = state
        new = acc
        for _ in range(check_every):
            new = weights + _inflow_step(new, props)
        done = jnp.all(new == acc)
        return new, it + check_every, done

    acc0 = weights
    acc, iters, done = jax.lax.while_loop(
        cond, body, (acc0, jnp.int32(0), jnp.bool_(False)))
    return acc, iters, done


def _jacobi_checked(props, weights, no_data_mask, max_iters, what):
    acc, iters, done = accumulation_jacobi_info(props, weights,
                                                max_iters=max_iters)
    h, w = acc.shape
    require_converged(done, what, max_iters or jacobi_cap(h, w))
    if no_data_mask is not None:
        acc = jnp.where(jnp.asarray(no_data_mask), 0.0, acc)
    return acc, iters, done


def flow_accumulation_from_props(props, weights=None, no_data_mask=None,
                                 max_iters=None, return_info=False):
    """Weighted upstream accumulation from (H, W, 8) proportions.

    Nodata cells must already have zero proportions (they do, from
    :mod:`richdem_tpu.ops.flowdirs`); the mask only zeroes their output.
    Raises if the Jacobi fixpoint does not converge within ``max_iters``
    (default: sized from the grid).  ``return_info`` additionally returns
    ``(iterations, converged)``."""
    acc, iters, done = _jacobi_checked(props, weights, no_data_mask,
                                       max_iters, "multi-flow accumulation")
    if return_info:
        return acc, iters, done
    return acc


def dinf_accumulation_from_angles(angles, weights=None, no_data_mask=None,
                                  return_info=False):
    """D∞ accumulation straight from the Tarboton angle raster (decoded
    proportions through the Jacobi engine).  ``return_info``
    additionally returns ``(iterations, converged)``."""
    from richdem_tpu.ops.flowdirs import proportions_from_dinf
    props = proportions_from_dinf(jnp.asarray(angles))
    acc, iters, done = _jacobi_checked(props, weights, no_data_mask, None,
                                       "D-infinity accumulation")
    if return_info:
        return acc, iters, done
    return acc


# -- D8 Gauss–Seidel directional line sweeps ----------------------------
#
# One "sweep" processes grid lines sequentially in
# one of the 4 axis directions (lax.scan over lines); within a step the
# new values of the previous line feed the current line, so any flow-path
# segment that advances monotonically in the sweep direction is resolved
# in ONE sweep regardless of its length.  Measured on fractal terrain,
# flow paths change x (or y) direction at most ~once (valley runs are
# monotone), so a few E/S/W/N rotations converge where Jacobi needs
# O(longest-path) = O(grid-size) iterations.  This is the single-chip analog of the reference's
# wave-of-sweeps design philosophy, applied to the accumulation recurrence
# A = w + Pᵀ A (a linear Gauss–Seidel splitting: monotone nondecreasing,
# exact-equality convergence detection).

def _code_remap(fd, perm):
    """Remap direction codes under a grid transform (tiny select chain)."""
    out = fd
    for src in range(1, 9):
        dst = perm[src]
        if dst != src:
            out = jnp.where(fd == src, jnp.int8(dst), out)
    return out

#: code permutations under grid transforms
_PERM_FLIPUD = {0: 0, 1: 1, 2: 8, 3: 7, 4: 6, 5: 5, 6: 4, 7: 3, 8: 2}
_PERM_TRANSPOSE = {0: 0, 1: 3, 2: 2, 3: 1, 4: 8, 5: 7, 6: 6, 7: 5, 8: 4}


def _roll_up(x):
    """x[r+1] at row r (value from the next line), zero at the last row."""
    return jnp.concatenate([x[1:], jnp.zeros_like(x[:1])], axis=0)


def _roll_down(x):
    return jnp.concatenate([jnp.zeros_like(x[:1]), x[:-1]], axis=0)


def _shift_w(v):  # value of west neighbor within a line vector (W,)
    return jnp.concatenate([jnp.zeros_like(v[:1]), v[:-1]], axis=0)


def _shift_e(v):
    return jnp.concatenate([v[1:], jnp.zeros_like(v[:1])], axis=0)


def _gs_down_sweep(acc, w, fd):
    """One top→bottom Gauss–Seidel sweep of A = w + Pᵀ A.

    Contributions from the previous (above) line use NEW values; the
    within-line and next-line contributions use the old ``acc``."""
    fd_prev = _roll_down(fd)       # line r-1's codes, aligned to line r
    fd_next = _roll_up(fd)
    acc_next = _roll_up(acc)

    xs = (w, fd, fd_prev, fd_next, acc, acc_next)

    def body(prev_new, x):
        w_l, fd_l, fdp, fdn, a_l, a_n = x
        # NEW: from the line above — straight S(7), SE(6) from west
        # source, SW(8) from east source.
        newc = (prev_new * (fdp == 7)
                + _shift_w(prev_new * (fdp == 6))
                + _shift_e(prev_new * (fdp == 8)))
        # OLD: from the line below — N(3), NE(4) from west src, NW(2)
        # from east src.
        oldb = (a_n * (fdn == 3)
                + _shift_w(a_n * (fdn == 4))
                + _shift_e(a_n * (fdn == 2)))
        # OLD: within the line — E(5) from west neighbor, W(1) from east.
        oldl = _shift_w(a_l * (fd_l == 5)) + _shift_e(a_l * (fd_l == 1))
        new = w_l + newc + oldb + oldl
        return new, new

    _, out = jax.lax.scan(body, jnp.zeros_like(acc[0]), xs)
    return out


def _gs_rotation(acc, w, fd, fd_t):
    """One full E, S, W, N rotation of directional GS sweeps."""
    # S-sweep (identity orientation)
    acc = _gs_down_sweep(acc, w, fd)
    # N-sweep (flipud)
    acc = jnp.flipud(_gs_down_sweep(jnp.flipud(acc), jnp.flipud(w),
                                    jnp.flipud(fd_t["ud"])))
    # E-sweep (transpose)
    acc = _gs_down_sweep(acc.T, w.T, fd_t["tr"]).T
    # W-sweep (transpose + flip)
    acc = jnp.flipud(_gs_down_sweep(
        jnp.flipud(acc.T), jnp.flipud(w.T), jnp.flipud(fd_t["trud"]))).T
    return acc


@partial(jax.jit, static_argnames=("max_rotations",))
def _d8_gs_impl(flowdirs, weights, max_rotations=64):
    fd = jnp.asarray(flowdirs).astype(jnp.int8)
    w = weights
    # Precompute code-remapped flow directions for each orientation.
    fd_t = {
        "ud": _code_remap(fd, _PERM_FLIPUD),
        "tr": _code_remap(fd.T, _PERM_TRANSPOSE),
    }
    fd_t["trud"] = _code_remap(fd_t["tr"], _PERM_FLIPUD)

    def cond(state):
        _, it, done = state
        return jnp.logical_and(~done, it < max_rotations)

    def body(state):
        acc, it, _ = state
        new = _gs_rotation(acc, w, fd, fd_t)
        return new, it + 1, jnp.all(new == acc)

    done0 = jnp.any(w != w)
    acc, iters, done = jax.lax.while_loop(cond, body,
                                          (w, jnp.int32(0), done0))
    return acc, iters, done


def d8_accumulation_info(flowdirs, weights, max_rotations=64):
    """``(accum, rotations, converged)`` of D8 accumulation; traceable.

    ``weights`` must already be zero on nodata.  The one engine choice:
    the row-walk kernel on a GPU, the XLA line sweeps elsewhere."""
    if jax.default_backend() == "gpu":
        from richdem_tpu.ops.accum_rowwalk import d8_rowwalk_info
        return d8_rowwalk_info(flowdirs, weights,
                               max_rotations=max_rotations)
    return _d8_gs_impl(flowdirs, weights, max_rotations=max_rotations)


def d8_accumulation(flowdirs, weights=None, no_data_mask=None,
                    max_rotations=64, return_info=False):
    """Exact D8 accumulation via Gauss–Seidel directional line sweeps
    (see block comment above); raises if the sweeps do not converge
    within ``max_rotations``.  ``return_info`` additionally returns
    ``(rotations, converged)``."""
    fd = jnp.asarray(flowdirs)
    h, wdt = fd.shape
    if weights is None:
        weights = jnp.ones((h, wdt), jnp.float32)
    else:
        weights = jnp.asarray(weights, jnp.float32)
    if no_data_mask is not None:
        weights = jnp.where(jnp.asarray(no_data_mask), 0.0, weights)
    acc, iters, done = d8_accumulation_info(fd, weights, max_rotations)
    require_converged(done, "D8 accumulation", max_rotations)
    if no_data_mask is not None:
        acc = jnp.where(jnp.asarray(no_data_mask), 0.0, acc)
    if return_info:
        return acc, iters, done
    return acc
