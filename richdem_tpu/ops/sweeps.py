"""Masked min-plus sweep engine: the data-parallel replacement for the
reference's priority queues.

Depression filling, flat-resolution BFS distances, and least-cost fields are
all least fixpoints of

    W(c) = min( W0(c),  max( floor(c),  min_d  W(n_d) + cost_d(c) ) )

over the 8-neighbor graph (SURVEY.md appendix A.2/A.3): fill uses
``floor = Z`` and ``cost = eps``; unit-cost distance transforms use
``floor = -BIG`` and ``cost = 1`` on allowed edges / ``+BIG`` on blocked
ones.  A serial priority queue (Priority-Flood, BFS) computes exactly this
fixpoint; here it is computed by *directional sweeps*:

* Along rows and columns the 1-D relaxation ``w_i = min(h_i, max(l_i,
  w_{i-1} + e_i))`` is a composition of clamp functions
  ``f(w) = min(h, max(l, w + e))``, which are **closed under composition**::

      (f_b ∘ f_a)(w) = min( min(h_b, max(l_b, h_a + e_b)),
                            max( max(l_b, l_a + e_b), w + e_a + e_b ) )

  so a full row/column relaxation runs as one ``lax.associative_scan`` —
  log-depth, fully parallel across the other axis.  This is the parallel
  analog of the reference's sequential Planchon–Darboux-style sweeps.
* Diagonal edges are relaxed by an 8-neighbor Jacobi step each iteration.

Starting from ``W = +BIG`` (unreached), iteration is monotone nonincreasing
and converges to the Bellman path value in the (min, max/plus) semiring —
i.e. exactly the Priority-Flood result — independent of sweep order.
Typical terrain converges in a handful of iterations; pathological spirals
degrade gracefully toward the Jacobi bound.

Infinities are represented by ±BIG (finite) so that blocked-edge arithmetic
(``-inf + inf``) can never manufacture NaNs inside the scans.  No clamping
is needed anywhere: every intermediate is bounded by (chain length)·BIG ≤
1e6·1e30 ≪ float32 max, so sums cannot overflow.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["BIG", "minplus_fixpoint", "minplus_fixpoint_core",
           "minplus_sweep_once", "jacobi_step", "require_converged",
           "fixpoint_cap"]

#: Finite stand-in for infinity (fits comfortably in float32).
BIG = 1.0e30

def fixpoint_cap(shape):
    """Default iteration cap of a min-plus fixpoint on an (H, W) grid.

    Plain fills converge in a handful of iterations, but an ε fill or a
    flat-distance field needs about one iteration per diagonal step of
    its longest shortest path (measured ~0.5·H on square grids), so the
    cap scales with the grid.  It bounds the loop, never the result: the
    converged flag is the guarantee."""
    return 2 * (shape[-2] + shape[-1])


def require_converged(done, what, cap):
    """Raise on a concrete unconverged fixpoint: a truncated fill or
    accumulation is a wrong answer, never a degraded one.  Inside ``jit``
    the flag is a tracer; the caller then returns it to a caller that can
    check it."""
    if isinstance(done, jax.core.Tracer):
        return
    if not bool(done):
        raise RuntimeError(
            f"{what} did not converge within {cap} iterations; "
            "raise the cap")


def _combine(a, b):
    """Compose clamp elements: apply ``a`` first, then ``b``."""
    ha, la, ea = a
    hb, lb, eb = b
    h = jnp.minimum(hb, jnp.maximum(lb, ha + eb))
    low = jnp.maximum(lb, la + eb)
    e = ea + eb
    return h, low, e


def _axis_sweep(w, floor, cost_in, axis, reverse, boundary):
    """One directional relaxation along ``axis`` via associative scan.

    ``cost_in[c]`` is the cost of the edge INTO cell ``c`` from its
    predecessor along the sweep direction (a scalar for uniform costs);
    ``boundary`` is the incoming value from off-grid (e.g. ``-BIG`` = the
    edge drains, ``+BIG`` = no injection).
    """
    cost_in = jnp.broadcast_to(cost_in, w.shape)
    axis = w.ndim + axis if axis < 0 else axis
    h, low, e = lax.associative_scan(
        _combine, (w, floor, cost_in), axis=axis, reverse=reverse)
    return jnp.minimum(h, jnp.maximum(low, boundary + e))


def _cost(costs, d):
    """Edge cost into each cell from its direction-``d`` neighbour:
    ``costs`` is a scalar (uniform) or an (8, H, W) stack."""
    return costs if costs.ndim == 0 else costs[d - 1]


def jacobi_step(w, floor, costs, boundary):
    """One full 8-neighbor Jacobi relaxation (carries diagonal edges).

    ``costs``: scalar or (8, H, W) edge costs into each cell from
    direction d = k+1.
    """
    from richdem_tpu.ops.stencil import neighbor

    best = jnp.full_like(w, BIG)
    for d in range(1, 9):
        cand = neighbor(w, d, boundary) + _cost(costs, d)
        best = jnp.minimum(best, cand)
    return jnp.minimum(w, jnp.maximum(floor, best))


def minplus_sweep_once(w, floor, costs, boundary):
    """One iteration: W→E, E→W, N→S, S→N scans + one Jacobi step.

    ``costs``: scalar or (8, H, W); index k is the cost into a cell from
    its direction-(k+1) neighbor (package D8 encoding: 1=W, 3=N, 5=E,
    7=S).
    """
    w = _axis_sweep(w, floor, _cost(costs, 1), axis=-1, reverse=False,
                    boundary=boundary)  # from W neighbors, sweeping east
    w = _axis_sweep(w, floor, _cost(costs, 5), axis=-1, reverse=True,
                    boundary=boundary)  # from E neighbors, sweeping west
    w = _axis_sweep(w, floor, _cost(costs, 3), axis=-2, reverse=False,
                    boundary=boundary)  # from N neighbors, sweeping south
    w = _axis_sweep(w, floor, _cost(costs, 7), axis=-2, reverse=True,
                    boundary=boundary)  # from S neighbors, sweeping north
    w = jacobi_step(w, floor, costs, boundary)
    return w


def minplus_fixpoint_core(w0, floor, costs, boundary, max_iters=None,
                          check_every=1):
    """Un-jitted fixpoint core — usable inside ``shard_map``/other jits.
    See :func:`minplus_fixpoint`."""
    w0 = jnp.asarray(w0)
    if max_iters is None:
        max_iters = fixpoint_cap(w0.shape)
    floor = jnp.broadcast_to(jnp.asarray(floor, w0.dtype), w0.shape)
    costs = jnp.asarray(costs, w0.dtype)
    if costs.ndim:
        costs = jnp.broadcast_to(costs, (8,) + w0.shape)
    boundary = jnp.asarray(boundary, w0.dtype)

    def cond(state):
        _, it, done = state
        return jnp.logical_and(~done, it < max_iters)

    def body(state):
        w, it, _ = state
        new = w
        for _ in range(check_every):
            new = minplus_sweep_once(new, floor, costs, boundary)
        done = jnp.all(new == w)
        return new, it + check_every, done

    # Derive the initial flag from the data so its sharding/varying-axes
    # annotation matches the body's output under shard_map.
    done0 = jnp.any(w0 != w0)  # always False
    w, iters, done = lax.while_loop(cond, body, (w0, jnp.int32(0), done0))
    return w, iters, done


@partial(jax.jit, static_argnames=("max_iters", "check_every"))
def minplus_fixpoint(w0, floor, costs, boundary, max_iters=None,
                     check_every=1):
    """Iterate sweeps to convergence (jitted entry).

    Returns ``(w, iters, converged)``; ``max_iters`` defaults to
    :func:`fixpoint_cap` of the grid.  ``costs`` may be scalar (uniform
    edge cost, e.g. fill epsilon) or an (8, H, W) array; ``boundary`` is
    the off-grid value (scalar).

    Monotone: ``w`` only decreases, so exact-equality convergence detection
    is sound.
    """
    return minplus_fixpoint_core(w0, floor, costs, boundary,
                                 max_iters=max_iters,
                                 check_every=check_every)
