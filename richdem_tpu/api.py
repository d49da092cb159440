"""Public API — name-compatible with pyrichdem (SURVEY.md §2.5, the
compatibility contract: ``wrappers/pyrichdem/richdem/__init__.py``).

A RichDEM user should be able to switch imports and keep their script:

    import richdem_tpu as rd
    dem = rd.LoadGDAL("dem.tif")          # GDAL-free loader underneath
    rd.FillDepressions(dem, epsilon=True, in_place=True)
    accum = rd.FlowAccumulation(dem, method="Dinf")
    slope = rd.TerrainAttribute(dem, attrib="slope_riserun")

Differences from pyrichdem, all deliberate and documented:

* computation happens on the accelerator via JAX ops (the
  ``richdem_tpu.ops`` fixpoint kernels), not a serial C++ heap;
* ``epsilon`` fills use a fixed auto-chosen epsilon, not ``nextafter``
  chains (appendix A.2 — same drainage structure, order-independent);
* GeoTIFF IO is a built-in pure-python codec (classic TIFF and BigTIFF;
  uncompressed, DEFLATE or LZW (+ PackBits reads) with horizontal/float
  predictors both ways; multi-band reads; windowed reads and streamed
  strip writes for larger-than-RAM rasters — see
  :mod:`richdem_tpu.io.geotiff`); ``.npz``/``.asc`` cover the rest.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from richdem_tpu.grid import rdarray, rd3array
from richdem_tpu import io as rio
from richdem_tpu import ops
from richdem_tpu import methods as _methods
from richdem_tpu.oracle import breach as _breach_oracle
from richdem_tpu.provenance import add_history, cite
from richdem_tpu.topology import FLOWDIR_NO_DATA

__all__ = [
    "rdarray", "rd3array", "LoadGDAL", "SaveGDAL", "FillDepressions",
    "BreachDepressions", "ResolveFlats", "FlowProportions",
    "FlowAccumulation", "FlowAccumFromProps", "TerrainAttribute",
    "FlowDirections", "WatershedLabels", "UpslopeCells", "StrahlerOrder",
    "TWI", "SPI", "rdCompare", "rdShow",
]


def _as_rd(dem) -> rdarray:
    return dem if isinstance(dem, rdarray) else rdarray(np.asarray(dem))


def _result(src_rd, data, call, no_data=None):
    out = src_rd.like(data)
    if no_data is not None:
        out.no_data = no_data
    add_history(out, call)
    return out


# -- IO -----------------------------------------------------------------

def LoadGDAL(filename, no_data=None) -> rdarray:
    """Load a raster (GeoTIFF/.npz/.asc).  Name kept for pyrichdem
    compatibility; no GDAL underneath."""
    rd = rio.load(filename)
    if no_data is not None:
        rd.no_data = no_data
    return rd


def SaveGDAL(filename, rdarray_in):
    """Save a raster (GeoTIFF/.npz/.asc), embedding PROCESSING_HISTORY."""
    return rio.save(filename, _as_rd(rdarray_in))


# -- hydrological conditioning -----------------------------------------

def FillDepressions(dem, epsilon=False, in_place=False, topology="D8",
                    max_iters=None):
    """Depression filling (device sweep fixpoint == Priority-Flood).

    ``epsilon``: False → plain fill; True → auto epsilon; a float → that
    epsilon per step."""
    cite("priority_flood")
    rd = _as_rd(dem)
    if topology not in ("D8", "D4"):
        raise ValueError("topology must be 'D8' or 'D4'")
    if epsilon is True:
        eps = ops.fill.auto_epsilon(rd.jnp())
    elif epsilon is False:
        eps = 0.0
    else:
        eps = float(epsilon)
    z = rd.jnp()
    mask = ops.stencil.nodata_like(z, rd.no_data)
    if topology == "D4":
        from richdem_tpu.ops.sweeps import (BIG, fixpoint_cap,
                                            minplus_fixpoint,
                                            require_converged)
        # D4 = the fill sweep with diagonal edges priced out
        costs = jnp.asarray(
            [eps, BIG, eps, BIG, eps, BIG, eps, BIG],
            z.dtype)[:, None, None] * jnp.ones_like(z)[None]
        neg = jnp.asarray(-BIG, z.dtype)
        floor = jnp.where(mask, neg, z)
        w0 = jnp.where(mask, neg, jnp.asarray(BIG, z.dtype))
        filled, _, done = minplus_fixpoint(w0, floor, costs, boundary=neg,
                                           max_iters=max_iters)
        require_converged(done, "D4 depression fill",
                          max_iters or fixpoint_cap(z.shape))
        filled = jnp.where(mask, z, filled)
    else:
        filled = ops.fill_depressions(z, no_data=rd.no_data, eps=eps,
                                      max_iters=max_iters)
    call = (f"FillDepressions(dem, epsilon={epsilon!r}, "
            f"topology={topology!r})")
    if in_place:
        rd.data = filled
        return add_history(rd, call)
    return _result(rd, filled, call)


def BreachDepressions(dem, in_place=False, mode="Complete", eps=0.0,
                      max_path_len=None, max_path_depth=None,
                      fill_remainder=False):
    """Depression breaching (Lindsay 2016) — a host op by design: the
    carving walk is inherently path-sequential (SURVEY.md §7 hard-part 5)
    and is serial C++ in the reference too.  Runs on the native C++ engine
    when available, else the Python oracle; both are bit-identical."""
    cite("breach")
    rd = _as_rd(dem)
    from richdem_tpu import native
    impl = (native.breach_depressions if native.available()
            else _breach_oracle.breach_depressions)
    out = impl(
        rd.np(), no_data=rd.no_data, mode=mode, eps=eps,
        max_path_len=max_path_len, max_path_depth=max_path_depth,
        fill_remainder=fill_remainder)
    call = f"BreachDepressions(dem, mode={mode!r})"
    if in_place:
        rd.data = out
        return add_history(rd, call)
    return _result(rd, out, call)


def ResolveFlats(dem, in_place=False):
    """Impose drainage on flats (BLM 2014) by applying the integer
    ``flat_mask`` as resolvable elevation increments, so that subsequent
    D8 flow directions drain every flat."""
    cite("flat_resolution")
    rd = _as_rd(dem)
    z = rd.jnp()
    fd = ops.d8_flowdirs(z, no_data=rd.no_data)
    from richdem_tpu.ops.flats import flat_mask_and_labels_device
    mask, _ = flat_mask_and_labels_device(z, fd, no_data=rd.no_data)
    # Increment small enough to never disturb non-flat ordering, large
    # enough to survive the dtype's ulp at the terrain's scale.
    znp = rd.np()
    finite = np.isfinite(znp)
    scale = float(np.max(np.abs(znp[finite]), initial=1.0))
    ulp = float(np.finfo(znp.dtype if znp.dtype.kind == "f"
                         else np.float64).eps) * max(scale, 1.0)
    delta = ulp * 4.0
    altered = z + mask.astype(z.dtype) * jnp.asarray(delta, z.dtype)
    call = "ResolveFlats(dem)"
    if in_place:
        rd.data = altered
        return add_history(rd, call)
    return _result(rd, altered, call)


# -- flow ----------------------------------------------------------------

def FlowDirections(dem, method="D8", exponent=None, seed=0,
                   engine="host"):
    """D8/D4/Rho8 single-flow direction raster, or Dinf angle raster.

    ``engine`` applies to Orlandini only: ``"host"`` (default — the
    serial oracle, as the reference's serial C++) or ``"device"`` (the
    XLA deviation-field fixpoint in ops/orlandini.py — identical output,
    O(longest-flow-path) Jacobi iterations)."""
    cite(method)
    rd = _as_rd(dem)
    z = rd.jnp()
    m = method.lower()
    if m in ("d8", "d4", "ocallaghan"):
        out = ops.d8_flowdirs(z, no_data=rd.no_data,
                              topology="D4" if m == "d4" else "D8",
                              cellsize=rd.cellsize)
    elif m in ("rho8", "rho4"):
        out = ops.rho8_flowdirs(z, no_data=rd.no_data, seed=seed,
                                topology="D4" if m == "rho4" else "D8",
                                cellsize=rd.cellsize)
    elif m in ("dinf", "tarboton"):
        out = ops.dinf_flowdirs(z, no_data=rd.no_data,
                                cellsize=rd.cellsize)
    elif m in ("orlandini", "d8ltd", "d8lad"):
        # Path-sequential by construction (deviation state rides the
        # flow path).  Default = host oracle, exactly as it is serial
        # C++ in the reference (SURVEY.md §2.2 Orlandini row); the
        # device fixpoint is available via engine="device".
        lam = 1.0 if exponent is None else float(exponent)
        mode = "LAD" if m == "d8lad" else "LTD"
        if engine == "device":
            from richdem_tpu.ops.orlandini import \
                orlandini_flowdirs_device
            out = orlandini_flowdirs_device(
                z, no_data=rd.no_data, lam=lam, mode=mode,
                cellsize=rd.cellsize)
        else:
            from richdem_tpu.oracle.orlandini import orlandini_flowdirs
            out = orlandini_flowdirs(
                rd.np(), no_data=rd.no_data, lam=lam, mode=mode,
                cellsize=rd.cellsize)
    else:
        raise ValueError(f"unknown flow-direction method {method!r}")
    res = _result(rd, out, f"FlowDirections(dem, method={method!r})")
    res.no_data = float(FLOWDIR_NO_DATA) if m not in (
        "dinf", "tarboton") else -2.0
    return res


def FlowProportions(dem, method="D8", exponent=None, seed=0) -> rd3array:
    """(H, W, 8) outflow proportions for any supported metric."""
    cite(method)
    rd = _as_rd(dem)
    props = ops.flow_proportions(rd.jnp(), method=method,
                                 no_data=rd.no_data, exponent=exponent,
                                 cellsize=rd.cellsize, seed=seed)
    out = rd3array(props, no_data=0.0, geotransform=rd.geotransform,
                   projection=rd.projection, metadata=dict(rd.metadata))
    add_history(out, f"FlowProportions(dem, method={method!r}, "
                f"exponent={exponent!r})")
    return out


def FlowAccumFromProps(props, weights=None):
    """Weighted upstream accumulation from an (H, W, 8) proportions
    raster (device Jacobi fixpoint)."""
    rd = props if isinstance(props, rdarray) else rd3array(
        np.asarray(props))
    w = None if weights is None else jnp.asarray(np.asarray(weights))
    acc = ops.flow_accumulation_from_props(rd.jnp(), weights=w)
    out = rdarray(acc, no_data=-1.0, geotransform=rd.geotransform,
                  projection=rd.projection, metadata=dict(rd.metadata))
    add_history(out, "FlowAccumFromProps(props)")
    return out


def FlowAccumulation(dem, method="D8", exponent=None, weights=None,
                     in_place=False, seed=0):
    """Upstream flow accumulation for any metric.

    Single-flow metrics (D8/D4/Rho8/Rho4) ride the Gauss–Seidel line
    sweeps (``ops.accum.d8_accumulation``: the row-walk kernel on a GPU,
    XLA line scans elsewhere); divergent metrics use the Jacobi inflow
    fixpoint."""
    cite(method)
    rd = _as_rd(dem)
    z = rd.jnp()
    w = None if weights is None else jnp.asarray(np.asarray(weights))
    m = method.lower()
    nd_mask = ops.stencil.nodata_like(z, rd.no_data)
    if m in ("d8", "d4", "ocallaghan", "rho8", "rho4"):
        if m in ("rho8", "rho4"):
            fd = ops.rho8_flowdirs(z, no_data=rd.no_data, seed=seed,
                                   topology="D4" if m == "rho4" else "D8",
                                   cellsize=rd.cellsize)
        else:
            fd = ops.d8_flowdirs(z, no_data=rd.no_data,
                                 topology="D4" if m == "d4" else "D8",
                                 cellsize=rd.cellsize)
        acc = ops.d8_accumulation(fd, weights=w, no_data_mask=nd_mask)
    elif m in ("dinf", "tarboton"):
        from richdem_tpu.ops.accum import dinf_accumulation_from_angles
        ang = ops.dinf_flowdirs(z, no_data=rd.no_data,
                                cellsize=rd.cellsize)
        acc = dinf_accumulation_from_angles(ang, weights=w,
                                            no_data_mask=nd_mask)
    else:
        props = ops.flow_proportions(z, method=method, no_data=rd.no_data,
                                     exponent=exponent,
                                     cellsize=rd.cellsize, seed=seed)
        acc = ops.flow_accumulation_from_props(props, weights=w,
                                               no_data_mask=nd_mask)
    acc = jnp.where(nd_mask, -1.0, acc)
    call = (f"FlowAccumulation(dem, method={method!r}, "
            f"exponent={exponent!r})")
    if in_place:
        rd.data = acc
        rd.no_data = -1.0
        return add_history(rd, call)
    return _result(rd, acc, call, no_data=-1.0)


# -- terrain -------------------------------------------------------------

def TerrainAttribute(dem, attrib, zscale=1.0):
    """Horn/Zevenbergen-Thorne attribute (see
    :data:`richdem_tpu.ops.terrain.TERRAIN_ATTRIBUTES`)."""
    cite("horn" if attrib.startswith(("slope", "aspect"))
         else "zevenbergen_thorne")
    rd = _as_rd(dem)
    out = ops.terrain_attribute(rd.jnp(), attrib, zscale=zscale,
                                cellsize=rd.cellsize, no_data=rd.no_data)
    out = jnp.where(jnp.isnan(out),
                    jnp.asarray(-9999.0, out.dtype), out)
    res = _result(rd, out,
                  f"TerrainAttribute(dem, attrib={attrib!r}, "
                  f"zscale={zscale!r})")
    res.no_data = -9999.0
    return res


def TWI(accum, slope_radians, cellsize=None):
    """Topographic wetness index from accumulation + slope rasters."""
    cite("twi")
    rd = _as_rd(accum)
    cs = rd.cellsize if cellsize is None else cellsize
    out = _methods.twi(rd.jnp(), _as_rd(slope_radians).jnp(), cellsize=cs)
    return _result(rd, out, "TWI(accum, slope)")


def SPI(accum, slope_radians, cellsize=None):
    """Stream power index from accumulation + slope rasters."""
    rd = _as_rd(accum)
    cs = rd.cellsize if cellsize is None else cellsize
    out = _methods.spi(rd.jnp(), _as_rd(slope_radians).jnp(), cellsize=cs)
    return _result(rd, out, "SPI(accum, slope)")


def WatershedLabels(dem_or_flowdirs, from_flowdirs=False):
    """Drainage-basin labels (terminal-cell ids) via pointer doubling."""
    rd = _as_rd(dem_or_flowdirs)
    fd = rd.jnp() if from_flowdirs else ops.d8_flowdirs(
        rd.jnp(), no_data=rd.no_data)
    out = _methods.watersheds_from_flowdirs(fd)
    return _result(rd, out, "WatershedLabels(...)")


def UpslopeCells(seeds, flowdirs):
    """Mask of cells draining through any seed cell."""
    rd = _as_rd(flowdirs)
    out = _methods.upslope_cells(jnp.asarray(np.asarray(seeds)), rd.jnp())
    return _result(rd, out, "UpslopeCells(seeds, flowdirs)")


def StrahlerOrder(flowdirs):
    """Strahler stream order raster from D8 flow directions."""
    rd = _as_rd(flowdirs)
    out = _methods.strahler_order(rd.jnp())
    return _result(rd, out, "StrahlerOrder(flowdirs)")


# -- utilities -----------------------------------------------------------

def rdCompare(a, b, atol=0.0, rtol=0.0, verbose=True):
    """Raster comparison (the reference's ``rd_compare`` app, SURVEY.md
    §2.3): returns True when shapes, nodata layout, and values agree."""
    ra, rb = _as_rd(a), _as_rd(b)
    if ra.shape != rb.shape:
        if verbose:
            print(f"shape mismatch: {ra.shape} vs {rb.shape}")
        return False
    na, nb = ra.np(), rb.np()
    ma, mb = ra.nodata_mask(), rb.nodata_mask()
    if not np.array_equal(ma, mb):
        if verbose:
            print(f"nodata layout differs on {int((ma != mb).sum())} cells")
        return False
    sel = ~ma
    if atol == 0.0 and rtol == 0.0:
        ok = np.array_equal(na[sel], nb[sel])
    else:
        ok = np.allclose(na[sel], nb[sel], atol=atol, rtol=rtol)
    if not ok and verbose:
        diff = np.abs(na[sel].astype(np.float64)
                      - nb[sel].astype(np.float64))
        print(f"values differ: max |Δ| = {diff.max():g} on "
              f"{int((diff > atol).sum())} cells")
    return bool(ok)


def rdShow(rd, ignore_colours=(), show=True, axes=True, cmap="terrain",
           log=False, vmin=None, vmax=None, xmin=None, xmax=None,
           ymin=None, ymax=None, zxmin=None, zxmax=None, zymin=None,
           zymax=None, figsize=(8, 6.5)):
    """Matplotlib quicklook (pyrichdem ``rdShow``).  Matplotlib is
    optional; raises a clear error if unavailable.  ``log=True`` draws
    on a log color scale (non-positive cells masked) — the usual view
    for flow accumulation, whose values span ~log(n) decades."""
    try:
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(
            "rdShow requires matplotlib, which is not installed in this "
            "environment") from e
    rd = _as_rd(rd)
    arr = np.array(rd.np(), dtype=np.float64)
    arr[rd.nodata_mask()] = np.nan
    sub = arr[zymin:zymax, zxmin:zxmax]
    fig, ax = plt.subplots(figsize=figsize)
    if log:
        from matplotlib.colors import LogNorm
        sub = np.where(sub > 0, sub, np.nan)
        img = ax.imshow(sub, cmap=cmap, norm=LogNorm(vmin=vmin, vmax=vmax))
    else:
        img = ax.imshow(sub, cmap=cmap, vmin=vmin, vmax=vmax)
    fig.colorbar(img, ax=ax)
    if not axes:
        ax.axis("off")
    if show:
        plt.show()
    return {"figure": fig, "axes": ax, "vmin": np.nanmin(sub),
            "vmax": np.nanmax(sub)}
