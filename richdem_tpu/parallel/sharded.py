"""Sharded terrain ops: ``shard_map`` + halo exchange over a 2-D mesh.

The distribution recipe (SURVEY.md §5.7, recasting [P1]'s tile algorithm):

* **stencil ops** (terrain attributes, flow metrics): one halo exchange,
  run the single-device core on the extended block, crop — output is
  bitwise identical to the single-device op;
* **fill**: block-Schwarz iteration — each outer step exchanges a 1-cell
  halo of the current surface, solves the *local* fill fixpoint exactly on
  the extended block (halo ring clamped as boundary data), and reduces a
  global changed-flag with ``psum``.  Monotone ⇒ converges to the same
  least fixpoint as the serial algorithm, in O(mesh diameter) outer steps;
* **D8 accumulation**: block-Schwarz like the fill — halo boundary-inflow
  exchange + exact local GS solves + psum convergence (the on-device
  recast of [P2]'s two-pass tile design).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P
from jax import shard_map

from richdem_tpu.ops.sweeps import BIG, minplus_fixpoint_core
from richdem_tpu.ops.terrain import terrain_core
from richdem_tpu.ops.flowdirs import d8_core
from richdem_tpu.ops import accum as accum_ops
from richdem_tpu.parallel.mesh import make_mesh, grid_sharding
from richdem_tpu.parallel.halo import exchange_halo

__all__ = ["sharded_fill", "sharded_fill_twopass",
           "sharded_terrain_attribute", "sharded_d8_flowdirs",
           "sharded_accumulation_d8", "sharded_accumulation_d8_twopass",
           "sharded_accumulation_mfd", "sharded_pipeline"]


def _put(x, mesh):
    return jax.device_put(x, grid_sharding(mesh))


def _mesh_pad(mesh, h, w):
    """Bottom/right padding that makes (h, w) divisible by the mesh.

    Padding cells are marked nodata, which every sharded op treats
    exactly like off-grid cells (drains for fill, skipped neighbors for
    stencils, zero weight for accumulation), so results on the original
    extent are unchanged — outputs are cropped back before returning."""
    ny, nx = mesh.devices.shape
    return (-h) % ny, (-w) % nx


def _pad_zm(z, mask, ph, pw, z_fill=0.0):
    """Pad a raster + nodata mask; padding is nodata."""
    if ph == 0 and pw == 0:
        return z, mask
    z = jnp.pad(z, ((0, ph), (0, pw)), constant_values=z_fill)
    mask = jnp.pad(mask, ((0, ph), (0, pw)), constant_values=True)
    return z, mask


def _global_any(flag):
    """All-reduce a per-shard bool over both mesh axes."""
    v = lax.psum(lax.psum(flag.astype(jnp.int32), "x"), "y")
    return v > 0


def _local_fill_solve(ext, floor_ext, eps, inner_iters):
    """Exact local fill fixpoint on the halo-extended block, ring clamped
    (``w0 == floor`` on the ring)."""
    new_ext, _, _ = minplus_fixpoint_core(
        ext, floor_ext, jnp.asarray(eps, ext.dtype),
        boundary=jnp.asarray(-BIG, ext.dtype), max_iters=inner_iters)
    return new_ext


def sharded_fill(dem, mesh=None, nodata_mask=None, eps=0.0,
                 outer_iters=128, inner_iters=None):
    """Depression fill, domain-decomposed.  Allclose-identical to
    :func:`richdem_tpu.ops.fill.fill_depressions`."""
    mesh = make_mesh() if mesh is None else mesh
    z = jnp.asarray(dem)
    h, w = z.shape
    if nodata_mask is None:
        nodata_mask = jnp.zeros(z.shape, bool)
    ph, pw = _mesh_pad(mesh, h, w)
    z, nodata_mask = _pad_zm(z, jnp.asarray(nodata_mask), ph, pw)
    z = _put(z, mesh)
    mask = _put(nodata_mask, mesh)

    @partial(shard_map, mesh=mesh, in_specs=(P("y", "x"), P("y", "x")),
             out_specs=P("y", "x"), check_vma=False)
    def run(zb, mb):
        neg = jnp.asarray(-BIG, zb.dtype)
        floor_in = jnp.where(mb, neg, zb)
        w_init = jnp.where(mb, neg, jnp.asarray(BIG, zb.dtype))

        def cond(state):
            _, it, done = state
            return jnp.logical_and(~done, it < outer_iters)

        def body(state):
            w, it, _ = state
            ext = exchange_halo(w, halo=1, fill=-BIG)
            # Halo ring: clamp to incoming values (floor == w0 == value).
            floor_ext = ext.at[1:-1, 1:-1].set(floor_in)
            new_ext = _local_fill_solve(ext, floor_ext, eps, inner_iters)
            new = new_ext[1:-1, 1:-1]
            changed = jnp.any(new != w)
            return new, it + 1, ~_global_any(changed)

        w, _, _ = lax.while_loop(cond, body,
                                 (w_init, jnp.int32(0), jnp.bool_(False)))
        return jnp.where(mb, zb, w)

    return run(z, mask)[:h, :w]


def _shard_tiling(garr, mesh):
    """((rows, cols), pos_of_index): the mesh tiling of a sharded array
    and a mapper from a shard's ``.index`` slices to its (ri, ci)."""
    hp, wp = garr.shape[:2]
    ny, nx = mesh.devices.shape
    th, tw = hp // ny, wp // nx
    rows = [(i * th, (i + 1) * th) for i in range(ny)]
    cols = [(j * tw, (j + 1) * tw) for j in range(nx)]

    def pos(index):
        r0 = index[0].start or 0
        c0 = index[1].start or 0
        return r0 // th, c0 // tw

    return rows, cols, pos


def _assemble(outs, garr, mesh, dtype=None):
    """Build a global sharded array from per-(ri,ci) single-device
    results, placed on the same devices as ``garr``'s shards."""
    _, _, pos = _shard_tiling(garr, mesh)
    shards = []
    for sh in garr.addressable_shards:
        out = outs[pos(sh.index)]
        shards.append(jax.device_put(out, sh.device))
    sharding = NamedSharding(mesh, P("y", "x"))
    return jax.make_array_from_single_device_arrays(
        garr.shape, sharding, shards)


def sharded_fill_twopass(dem, mesh=None, no_data=None, stats=None,
                         exchange=None):
    """Depression fill over the device-mesh tiling via the [P1]
    O(perimeter) label-graph protocol — exactly two passes, no Schwarz
    iteration (plain fill, eps = 0).

    device-resident SPMD recast of the reference's
    ``parallel_priority_flood`` (SURVEY.md §3.4): each host runs the
    DEVICE consumer (:mod:`richdem_tpu.parallel.consumer`) on its own
    addressable shards — local fill + watershed labels + label-graph
    edges all on device, only O(perimeter) ring/edge vectors on the
    host; one global minimax solve; then a ring-Dirichlet device solve
    per shard reproduces the global fill bit-exactly (no full-grid
    gather anywhere).  Output equals :func:`sharded_fill` /
    ``ops.fill.fill_depressions`` — cross-validated in
    tests/test_sharded.py."""
    from richdem_tpu.parallel.twopass import fill_twopass_run

    mesh = make_mesh() if mesh is None else mesh
    z = jnp.asarray(dem)
    if z.dtype != jnp.float32:
        z = z.astype(jnp.float32)
    h, w = z.shape
    ph, pw = _mesh_pad(mesh, h, w)
    if ph or pw:
        # pad with nodata — drains, exactly like off-grid cells
        if no_data is None:
            no_data = float("nan")
        z = jnp.pad(z, ((0, ph), (0, pw)),
                    constant_values=jnp.float32(no_data))
    zg = _put(z, mesh)
    rows, cols, pos = _shard_tiling(zg, mesh)
    shard_of = {pos(sh.index): sh.data for sh in zg.addressable_shards}
    outs = {}
    fill_twopass_run(lambda ri, ci: shard_of[(ri, ci)],
                     lambda ri, ci, filled: outs.__setitem__((ri, ci),
                                                             filled),
                     rows, cols, no_data=no_data, stats=stats,
                     local_tiles=sorted(shard_of), exchange=exchange)
    out = _assemble(outs, zg, mesh)
    # (crop only when padded: eager slicing needs full addressability,
    # which multi-process runs don't have — they use divisible grids)
    return out[:h, :w] if (ph or pw) else out


def _stencil_sharded(mesh, z, mask, core):
    """One-halo-exchange wrapper for pure 3x3 stencil cores."""

    @partial(shard_map, mesh=mesh, in_specs=(P("y", "x"), P("y", "x")),
             out_specs=P("y", "x"), check_vma=False)
    def run(zb, mb):
        ext_z = exchange_halo(zb, halo=1, fill=jnp.nan)
        ext_m = exchange_halo(mb, halo=1, fill=True)
        ext_m = ext_m | jnp.isnan(ext_z)
        out = core(ext_z, ext_m)
        return out[1:-1, 1:-1]

    return run(z, mask)


def sharded_terrain_attribute(dem, attrib, mesh=None, zscale=1.0,
                              cellsize=1.0, nodata_mask=None):
    """Terrain attribute, domain-decomposed (bitwise == single device)."""
    mesh = make_mesh() if mesh is None else mesh
    z = jnp.asarray(dem)
    h, w = z.shape
    if nodata_mask is None:
        nodata_mask = jnp.zeros(z.shape, bool)
    ph, pw = _mesh_pad(mesh, h, w)
    z, nodata_mask = _pad_zm(z, jnp.asarray(nodata_mask), ph, pw)
    z = _put(z, mesh)
    mask = _put(nodata_mask, mesh)
    zs = jnp.asarray(zscale, jnp.float32)
    cs = jnp.asarray(cellsize, jnp.float32)
    return _stencil_sharded(
        mesh, z, mask,
        lambda zb, mb: terrain_core(zb, mb, zs, cs, attrib))[:h, :w]


def sharded_d8_flowdirs(dem, mesh=None, nodata_mask=None, cellsize=1.0,
                        topology="D8"):
    """D8 flow directions, domain-decomposed (bitwise == single device)."""
    mesh = make_mesh() if mesh is None else mesh
    z = jnp.asarray(dem)
    h, w = z.shape
    if nodata_mask is None:
        nodata_mask = jnp.zeros(z.shape, bool)
    ph, pw = _mesh_pad(mesh, h, w)
    z, nodata_mask = _pad_zm(z, jnp.asarray(nodata_mask), ph, pw)
    z = _put(z, mesh)
    mask = _put(nodata_mask, mesh)
    cs = jnp.asarray(cellsize, jnp.float32)
    return _stencil_sharded(
        mesh, z, mask,
        lambda zb, mb: d8_core(zb, mb, cs, topology))[:h, :w]


def _local_accum_solve(fd, w_eff, max_rotations):
    """Exact local D8 accumulation (the single-device D8 engine)."""
    return accum_ops.d8_accumulation_info(fd, w_eff, max_rotations)[0]


def sharded_accumulation_d8(flowdirs, mesh=None, weights=None,
                            no_data_mask=None, outer_iters=256,
                            max_rotations=32):
    """D8 accumulation, domain-decomposed — block-Schwarz iteration, the
    on-device recast of [P2]'s two-pass tile design:

    each outer step (1) exchanges a 1-cell halo of the current
    accumulation, (2) computes the *boundary inflow* each shard receives
    from its neighbors' halo-ring cells whose flow direction points into
    the shard, (3) re-solves the local accumulation exactly with
    ``weights + inflow`` via GS line sweeps, and (4) all-reduces a
    changed-flag.  Inflow only grows (monotone), so exact-equality
    convergence detection is sound; converges once every flow path has
    crossed its last shard boundary."""
    mesh = make_mesh() if mesh is None else mesh
    fd = jnp.asarray(flowdirs).astype(jnp.int8)
    h, w = fd.shape
    if weights is None:
        weights = jnp.ones((h, w), jnp.float32)
    if no_data_mask is None:
        no_data_mask = jnp.zeros((h, w), bool)
    w_eff = jnp.where(jnp.asarray(no_data_mask), 0.0,
                      jnp.asarray(weights, jnp.float32))
    ph, pw = _mesh_pad(mesh, h, w)
    if ph or pw:
        # padding: nodata flow codes with zero weight — invisible to the
        # original extent exactly like off-grid cells
        fd = jnp.pad(fd, ((0, ph), (0, pw)), constant_values=-1)
        w_eff = jnp.pad(w_eff, ((0, ph), (0, pw)))
        no_data_mask = jnp.pad(jnp.asarray(no_data_mask),
                               ((0, ph), (0, pw)), constant_values=True)
    fd_g = _put(fd, mesh)
    w_g = _put(w_eff, mesh)

    from richdem_tpu.ops.stencil import neighbor
    from richdem_tpu.topology import D8_INVERSE

    @partial(shard_map, mesh=mesh, in_specs=(P("y", "x"), P("y", "x")),
             out_specs=P("y", "x"), check_vma=False)
    def run(fdb, wb):
        # Ring flow directions are static: exchange once.
        fd_ext = exchange_halo(fdb, halo=1, fill=0)

        def ring_inflow(acc):
            """Inflow into local cells from OUTSIDE the shard."""
            acc_ext = exchange_halo(acc, halo=1, fill=0.0)
            ring = acc_ext.at[1:-1, 1:-1].set(0.0)  # zero local interior
            total = jnp.zeros_like(acc)
            for d in range(1, 9):
                inv = int(D8_INVERSE[d])
                contrib = ring * (fd_ext == inv)
                total = total + neighbor(contrib, d, 0.0)[1:-1, 1:-1]
            return total

        acc0 = _local_accum_solve(fdb, wb, max_rotations)

        def cond(state):
            _, it, done = state
            return jnp.logical_and(~done, it < outer_iters)

        def body(state):
            acc, it, _ = state
            w_eff = wb + ring_inflow(acc)
            new = _local_accum_solve(fdb, w_eff, max_rotations)
            changed = jnp.any(new != acc)
            return new, it + 1, ~_global_any(changed)

        acc, _, _ = lax.while_loop(cond, body,
                                   (acc0, jnp.int32(0), jnp.bool_(False)))
        return acc

    acc = run(fd_g, w_g)
    return jnp.where(no_data_mask, 0.0, acc)[:h, :w]


def sharded_accumulation_d8_twopass(flowdirs, mesh=None, weights=None,
                                    no_data_mask=None, stats=None,
                                    exchange=None):
    """D8 accumulation over the device-mesh tiling via the [P2]
    O(perimeter) two-pass perimeter-link protocol — exactly two local
    solves per shard (no Schwarz iteration), everything on device:
    local accumulations, the successor-resolve link computation, and
    the pass-2 replay run per addressable shard; the host sees only the
    O(perimeter) ring vectors and the exit-graph topological sweep (no
    full-grid gather).  Output equals :func:`sharded_accumulation_d8` /
    the topological queue."""
    from richdem_tpu.parallel.twopass import accum_twopass_run

    mesh = make_mesh() if mesh is None else mesh
    fd = jnp.asarray(flowdirs).astype(jnp.int8)
    h, w = fd.shape
    ph, pw = _mesh_pad(mesh, h, w)
    wt = (jnp.ones((h, w), jnp.float32) if weights is None
          else jnp.asarray(weights, jnp.float32))
    if no_data_mask is not None:
        wt = jnp.where(jnp.asarray(no_data_mask), 0.0, wt)
    if ph or pw:
        fd = jnp.pad(fd, ((0, ph), (0, pw)), constant_values=-1)
        wt = jnp.pad(wt, ((0, ph), (0, pw)))
    fd_g = _put(fd, mesh)
    wt_g = _put(wt, mesh)
    rows, cols, pos = _shard_tiling(fd_g, mesh)
    fd_of = {pos(sh.index): sh.data for sh in fd_g.addressable_shards}
    wt_of = {pos(sh.index): sh.data for sh in wt_g.addressable_shards}
    outs = {}
    accum_twopass_run(lambda ri, ci: fd_of[(ri, ci)],
                      lambda ri, ci: wt_of[(ri, ci)],
                      lambda ri, ci, a: outs.__setitem__((ri, ci), a),
                      rows, cols, fd_g.shape, stats=stats,
                      local_tiles=sorted(fd_of), exchange=exchange)
    out = _assemble(outs, fd_g, mesh)
    if ph or pw:
        out = out[:h, :w]
    if no_data_mask is not None:
        out = jnp.where(jnp.asarray(no_data_mask), 0.0, out)
    return out


def _local_mfd_solve(props, w_eff, max_rotations):
    """Exact local multi-flow accumulation (Jacobi)."""
    acc, _, _ = accum_ops.accumulation_jacobi_info(props, w_eff)
    return acc


def sharded_accumulation_mfd(props, mesh=None, weights=None,
                             no_data_mask=None, outer_iters=256,
                             max_rotations=512):
    """Divergent-metric (D∞/Quinn/Freeman/Holmgren/MD∞) accumulation,
    domain-decomposed — boundary-inflow Schwarz over the (H, W, 8)
    proportion tensor, exactly like :func:`sharded_accumulation_d8` but
    with weighted taps from the neighbors' proportion planes.  Output
    equals :func:`richdem_tpu.ops.accum.flow_accumulation_from_props`
    (SURVEY.md §5.7 sets the multi-device bar beyond the reference's
    D8-only [P2] program)."""
    mesh = make_mesh() if mesh is None else mesh
    pr = jnp.asarray(props, jnp.float32)
    h, w = pr.shape[:2]
    if weights is None:
        weights = jnp.ones((h, w), jnp.float32)
    if no_data_mask is None:
        no_data_mask = jnp.zeros((h, w), bool)
    w_eff = jnp.where(jnp.asarray(no_data_mask), 0.0,
                      jnp.asarray(weights, jnp.float32))
    ph, pw = _mesh_pad(mesh, h, w)
    if ph or pw:
        pr = jnp.pad(pr, ((0, ph), (0, pw), (0, 0)))
        w_eff = jnp.pad(w_eff, ((0, ph), (0, pw)))
        no_data_mask = jnp.pad(jnp.asarray(no_data_mask),
                               ((0, ph), (0, pw)), constant_values=True)
    pr_g = jax.device_put(pr, NamedSharding(mesh, P("y", "x", None)))
    w_g = _put(w_eff, mesh)

    from richdem_tpu.ops.stencil import neighbor
    from richdem_tpu.topology import D8_INVERSE

    @partial(shard_map, mesh=mesh,
             in_specs=(P("y", "x", None), P("y", "x")),
             out_specs=P("y", "x"), check_vma=False)
    def run(pb, wb):
        # Ring proportions are static: exchange each plane once.
        props_ext = jnp.stack(
            [exchange_halo(pb[..., k], halo=1, fill=0.0)
             for k in range(8)], axis=-1)

        def ring_inflow(acc):
            """Inflow into local cells from OUTSIDE the shard."""
            acc_ext = exchange_halo(acc, halo=1, fill=0.0)
            ring = acc_ext.at[1:-1, 1:-1].set(0.0)
            total = jnp.zeros_like(acc)
            for d in range(1, 9):
                inv = int(D8_INVERSE[d])
                contrib = ring * props_ext[..., inv - 1]
                total = total + neighbor(contrib, d, 0.0)[1:-1, 1:-1]
            return total

        acc0 = _local_mfd_solve(pb, wb, max_rotations)

        def cond(state):
            _, it, done = state
            return jnp.logical_and(~done, it < outer_iters)

        def body(state):
            acc, it, _ = state
            new = _local_mfd_solve(pb, wb + ring_inflow(acc),
                                   max_rotations)
            changed = jnp.any(new != acc)
            return new, it + 1, ~_global_any(changed)

        acc, _, _ = lax.while_loop(cond, body,
                                   (acc0, jnp.int32(0), jnp.bool_(False)))
        return acc

    acc = run(pr_g, w_g)
    return jnp.where(no_data_mask, 0.0, acc)[:h, :w]


def sharded_pipeline(dem, mesh=None, eps=1e-3, nodata_mask=None,
                     cellsize=1.0):
    """The benchmark pipeline (BASELINE.md config 5): epsilon fill →
    D8 flow directions → accumulation → slope, all domain-decomposed.

    Returns a dict of rasters."""
    mesh = make_mesh() if mesh is None else mesh
    filled = sharded_fill(dem, mesh=mesh, eps=eps,
                          nodata_mask=nodata_mask)
    fd = sharded_d8_flowdirs(filled, mesh=mesh, nodata_mask=nodata_mask,
                             cellsize=cellsize)
    acc = sharded_accumulation_d8(fd, mesh=mesh,
                                  no_data_mask=nodata_mask)
    slope = sharded_terrain_attribute(filled, "slope_radians", mesh=mesh,
                                      cellsize=cellsize,
                                      nodata_mask=nodata_mask)
    return {"filled": filled, "flowdirs": fd, "accum": acc,
            "slope": slope}
