"""D8 accumulation as a GPU row-walk Gauss–Seidel kernel (Pallas, Triton).

One directional sweep of ``A = w + Pᵀ A`` walks the grid's rows in order.
The grid is cut into column stripes; each stripe is one program, and the
program loops over the rows, carrying the new values of the row it just
finished.  A cell therefore sees its upstream neighbours in the previous
row with their NEW values, so every flow-path segment that advances
monotonically in the walk direction is resolved in one sweep, as in the
XLA line sweeps of :func:`richdem_tpu.ops.accum._d8_gs_impl`.

Programs run in no order, so a stripe never reads a value that another
program writes during the same sweep: the two columns just outside a
stripe (its seam neighbours) are read from the previous iterate.  That is
a Jacobi step across the seam.  Every value read is either the previous
iterate or the program's own result, so the sweep is deterministic, and
it stays a monotone splitting of the same linear system: it converges to
the exact fixpoint, possibly in more rotations than a seamless sweep.

A rotation is four sweeps: down and up the rows, then down and up the
columns of the transposed grid (direction codes remapped).  Convergence is
decided per rotation by exact equality; per-sweep flags chatter in the
last bit for non-integer weights.

Layout: every array is padded to ``(Hp, Wp)`` with a one-cell zero halo
and stripe-aligned interiors (``Hp - 2`` and ``Wp - 2`` both multiples of
the stripe width), so the same padded buffer serves both orientations and
no load ever leaves the array.  Halo and padding cells have direction
code 0 and weight 0: they absorb flow leaving the grid and send nothing.
A program covers a ``block``-wide window whose ``block - 2`` inner lanes
it owns; the outer two lanes are the seam neighbours.

The lateral ±1 taps need the carried row shifted by one lane, which
Triton cannot do in registers.  Each row's rightward and leftward sends
go through a per-program scratch row in device memory, with a block-wide
barrier between the store and the shifted reload (double-buffered by row
parity, so one barrier per row suffices).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

__all__ = ["d8_rowwalk_info", "padded_shape", "DEFAULT_BLOCK"]

#: Window width of one program (a power of two, as Triton requires); the
#: program owns ``block - 2`` columns.
DEFAULT_BLOCK = 512

#: D8 code permutation under a transpose (package encoding, 1 = W, CCW).
_PERM_TRANSPOSE = (0, 3, 2, 1, 8, 7, 6, 5, 4)


def padded_shape(h, w, block=DEFAULT_BLOCK):
    """``(Hp, Wp)``: a one-cell halo around stripe-aligned interiors."""
    bs = block - 2
    return -(-h // bs) * bs + 2, -(-w // bs) * bs + 2


def _sweep_kernel(fd_ref, w_ref, old_ref, _zero_ref, out_ref, scr_ref, *,
                  block, reverse, interpret):
    """One walk over rows ``1 .. Hp-2`` of one column stripe."""
    i32 = partial(jnp.asarray, dtype=jnp.int32)  # one index type, x64 too
    s = pl.program_id(0)
    hp = fd_ref.shape[0]
    cols = pl.ds(s * (block - 2), block)
    lane = jax.lax.broadcasted_iota(jnp.int32, (block,), 0)
    owned = (lane > 0) & (lane < block - 1)
    zero = jnp.zeros((block,), jnp.float32)
    step = -1 if reverse else 1
    first = hp - 2 if reverse else 1
    # codes through which the previous row (already walked, NEW values)
    # and the next row (OLD values) send into this cell: straight, from
    # the left lane, from the right lane.
    p_st, p_l, p_r = (3, 4, 2) if reverse else (7, 6, 8)
    n_st, n_l, n_r = (7, 6, 8) if reverse else (3, 4, 2)

    def barrier():
        if not interpret:  # programs run one after another when interpreted
            plgpu.debug_barrier()

    for k in range(4):
        plgpu.store(scr_ref.at[s, i32(k), pl.ds(i32(0), block)], zero)
        plgpu.store(scr_ref.at[s, i32(k), pl.ds(i32(2), block)], zero)
    barrier()

    def load_row(r):
        r = jnp.clip(r, 0, hp - 1).astype(jnp.int32)
        return (plgpu.load(fd_ref.at[r, cols]).astype(jnp.int32),
                plgpu.load(old_ref.at[r, cols]),
                plgpu.load(w_ref.at[r, cols]))

    def sel(code_row, code, vals):
        return jnp.where(code_row == code, vals, zero)

    def body(k, carry):
        prev, fd_p, fd_c, old_c, w_c, fd_n, old_n, w_n = carry
        r = i32(first + step * k)
        nxt = load_row(r + 2 * step)  # prefetch: consumed next row
        right = sel(fd_p, p_l, prev) + sel(fd_n, n_l, old_n) \
            + sel(fd_c, 5, old_c)
        left = sel(fd_p, p_r, prev) + sel(fd_n, n_r, old_n) \
            + sel(fd_c, 1, old_c)
        slot = 2 * jnp.bitwise_and(k, 1)
        plgpu.store(scr_ref.at[s, slot, pl.ds(i32(1), block)], right)
        plgpu.store(scr_ref.at[s, slot + 1, pl.ds(i32(1), block)], left)
        barrier()
        from_left = plgpu.load(scr_ref.at[s, slot, pl.ds(i32(0), block)])
        from_right = plgpu.load(
            scr_ref.at[s, slot + 1, pl.ds(i32(2), block)])
        new = (w_c + sel(fd_p, p_st, prev) + sel(fd_n, n_st, old_n)
               + from_left + from_right)
        plgpu.store(out_ref.at[r, cols], new, mask=owned)
        # seam lanes belong to the neighbouring stripes: the next row sees
        # them at their previous-iterate values
        prev = jnp.where(owned, new, old_c)
        return (prev, fd_c, fd_n, old_n, w_n) + nxt

    fd_p, _, _ = load_row(first - step)
    cur = load_row(first)
    nxt = load_row(first + step)
    init = (zero, fd_p, cur[0], cur[1], cur[2]) + nxt
    jax.lax.fori_loop(i32(0), i32(hp - 2), body, init)


def _sweep(fd, w, acc, *, block, reverse, interpret):
    hp, wp = fd.shape
    n_prog = (wp - 2) // (block - 2)
    kernel = partial(_sweep_kernel, block=block, reverse=reverse,
                     interpret=interpret)
    # the output starts as zeros (aliased): halo cells that no program
    # owns stay 0, and the scratch output is per-program row buffers
    out, _ = pl.pallas_call(
        kernel,
        out_shape=(jax.ShapeDtypeStruct((hp, wp), jnp.float32),
                   jax.ShapeDtypeStruct((n_prog, 4, block + 2),
                                        jnp.float32)),
        grid=(n_prog,),
        input_output_aliases={3: 0},
        compiler_params=plgpu.CompilerParams(num_warps=max(1, block // 64),
                                             num_stages=1),
        interpret=interpret,
        name=f"d8_rowwalk_{'up' if reverse else 'down'}",
    )(fd, w, acc, jnp.zeros_like(acc))
    return out


def _remap(fd, perm):
    return jnp.asarray(perm, jnp.int8)[fd.astype(jnp.int32)]


@partial(jax.jit, static_argnames=("max_rotations", "block", "interpret"))
def d8_rowwalk_info(flowdirs, weights, max_rotations=64,
                    block=DEFAULT_BLOCK, interpret=False):
    """D8 accumulation; returns ``(accum, rotations, converged)``.

    ``flowdirs``: (H, W) D8 codes (≤ 0 = no outflow); ``weights``: (H, W)
    float32, already zero on nodata.  Flow leaving the grid is dropped,
    as in every engine of :mod:`richdem_tpu.ops.accum`."""
    h, w = flowdirs.shape
    hp, wp = padded_shape(h, w, block)
    fd = jnp.zeros((hp, wp), jnp.int8).at[1:h + 1, 1:w + 1].set(
        jnp.maximum(flowdirs, 0).astype(jnp.int8))
    wt = jnp.zeros((hp, wp), jnp.float32).at[1:h + 1, 1:w + 1].set(
        weights.astype(jnp.float32))
    fd_t = _remap(fd.T, _PERM_TRANSPOSE)
    wt_t = wt.T
    sweep = partial(_sweep, block=block, interpret=interpret)

    def rotation(acc):
        acc = sweep(fd, wt, acc, reverse=False)
        acc = sweep(fd, wt, acc, reverse=True)
        acc_t = sweep(fd_t, wt_t, acc.T, reverse=False)
        return sweep(fd_t, wt_t, acc_t, reverse=True).T

    def cond(state):
        _, it, done = state
        return jnp.logical_and(~done, it < max_rotations)

    def body(state):
        acc, it, _ = state
        new = rotation(acc)
        return new, it + 1, jnp.all(new == acc)

    acc, iters, done = jax.lax.while_loop(
        cond, body, (wt, jnp.int32(0), jnp.bool_(False)))
    return acc[1:h + 1, 1:w + 1], iters, done
