"""Command-line multiplexer — device-native replacement for the reference's
~15 single-purpose ``apps/rd_*.cpp`` tools (SURVEY.md §2.3), as one
``python -m richdem_tpu.cli <verb>`` entry point.

Verb map (reference app → verb):

* rd_fill_depressions      → ``fill-depressions``
* rd_breach_depressions    → ``breach-depressions``
* rd_flood_for_flowdirs    → ``flowdirs`` (+ ``--resolve-flats``)
* rd_flow_accumulation     → ``flow-accumulation``
* rd_terrain_attribute     → ``terrain-attribute``
* rd_compare               → ``compare``
* rd_info                  → ``info``
* rd_hist                  → ``hist``
* rd_no_data               → ``no-data``
* rd_geotransform          → ``geotransform``
* rd_ascii_to_terrain etc. → ``convert`` (any→any format)
* rd_expand_dimensions     → ``expand-dimensions``
* terrain generation       → ``synth``
* rd_merge_rasters_by_layout → ``merge`` (tile manifest stitch)

Every verb prints the program identifier and the algorithm citation
banner, mirroring the reference's mandatory citation output.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from richdem_tpu.version import PROGRAM_IDENTIFIER


def _load(path):
    from richdem_tpu import io as rio
    return rio.load(path)


def _save(path, rd_arr):
    from richdem_tpu import io as rio
    rio.save(path, rd_arr)
    print(f"wrote {path}")


def cmd_fill(args):
    import richdem_tpu as rd
    dem = _load(args.input)
    eps = True if args.epsilon and args.eps_value is None else (
        args.eps_value if args.epsilon else False)
    out = rd.FillDepressions(dem, epsilon=eps, topology=args.topology)
    _save(args.output, out)


def cmd_breach(args):
    import richdem_tpu as rd
    dem = _load(args.input)
    out = rd.BreachDepressions(
        dem, mode=args.mode, eps=args.eps_value or 0.0,
        max_path_len=args.max_path_len, max_path_depth=args.max_path_depth,
        fill_remainder=args.fill_remainder)
    _save(args.output, out)


def cmd_resolve_flats(args):
    import richdem_tpu as rd
    out = rd.ResolveFlats(_load(args.input))
    _save(args.output, out)


def cmd_flowdirs(args):
    import richdem_tpu as rd
    dem = _load(args.input)
    if args.resolve_flats:
        dem = rd.ResolveFlats(dem)
    out = rd.FlowDirections(dem, method=args.method)
    _save(args.output, out)


def cmd_accum(args):
    import richdem_tpu as rd
    dem = _load(args.input)
    weights = _load(args.weights).np() if args.weights else None
    out = rd.FlowAccumulation(dem, method=args.method,
                              exponent=args.exponent, weights=weights)
    _save(args.output, out)


def cmd_terrain(args):
    import richdem_tpu as rd
    out = rd.TerrainAttribute(_load(args.input), attrib=args.attrib,
                              zscale=args.zscale)
    _save(args.output, out)


def cmd_twi(args):
    import richdem_tpu as rd
    dem = _load(args.input)
    filled = rd.FillDepressions(dem, epsilon=True)
    acc = rd.FlowAccumulation(filled, method=args.method)
    slope = rd.TerrainAttribute(filled, attrib="slope_radians")
    out = rd.TWI(acc, slope.np())
    _save(args.output, out)


def cmd_info(args):
    r = _load(args.input)
    info = {
        "path": args.input,
        "shape": list(r.shape),
        "dtype": str(r.dtype),
        "no_data": r.no_data,
        "geotransform": list(r.geotransform),
        "projection": r.projection,
        "min": float(np.nanmin(np.where(r.nodata_mask(), np.nan,
                                        r.np().astype(np.float64)))),
        "max": float(np.nanmax(np.where(r.nodata_mask(), np.nan,
                                        r.np().astype(np.float64)))),
        "nodata_cells": int(r.nodata_mask().sum()),
        "processing_history": r.metadata.get("PROCESSING_HISTORY", ""),
    }
    print(json.dumps(info, indent=2))


def cmd_hist(args):
    r = _load(args.input)
    vals = r.np()[~r.nodata_mask()].astype(np.float64)
    counts, edges = np.histogram(vals, bins=args.bins)
    for c, lo, hi in zip(counts, edges[:-1], edges[1:]):
        bar = "#" * int(60 * c / max(counts.max(), 1))
        print(f"[{lo:12.4g}, {hi:12.4g}) {c:10d} {bar}")


def cmd_compare(args):
    import richdem_tpu as rd
    ok = rd.rdCompare(_load(args.a), _load(args.b), atol=args.atol,
                      rtol=args.rtol)
    print("EQUAL" if ok else "DIFFER")
    sys.exit(0 if ok else 1)


def cmd_no_data(args):
    r = _load(args.input)
    if args.set is None:
        print(r.no_data)
        return
    r.no_data = args.set
    _save(args.output or args.input, r)


def cmd_geotransform(args):
    r = _load(args.input)
    if not args.set:
        print(json.dumps(list(r.geotransform)))
        return
    r.geotransform = tuple(args.set)
    _save(args.output or args.input, r)


def cmd_convert(args):
    from richdem_tpu import io as rio
    kw = {}
    if getattr(args, "compress", None):
        kw["compress"] = args.compress
    if getattr(args, "predictor", None):
        kw["predictor"] = args.predictor
    rio.save(args.output, _load(args.input), **kw)
    print(f"wrote {args.output}")


def cmd_taudem(args):
    """Convert a TauDEM-encoded D8 raster to the package encoding (or
    back) — counterpart of ``rd_taudem_d8_to_richdem_d8``."""
    from richdem_tpu.topology import from_taudem_d8, to_taudem_d8
    r = _load(args.input)
    fn = to_taudem_d8 if args.reverse else from_taudem_d8
    r.data = fn(np.asarray(r.data))
    _save(args.output, r)


def cmd_pipeline(args):
    """fill -> flowdirs -> accumulation (-> TWI) with optional
    phase-granular resume (--cache-dir)."""
    from richdem_tpu.grid import rdarray
    r = _load(args.input)
    if args.cache_dir:
        from richdem_tpu.pipeline import resumable_pipeline
        out = resumable_pipeline(r.np(), args.cache_dir,
                                 grid_id=args.grid_id, eps=args.eps_value,
                                 with_twi=args.twi, no_data=r.no_data)
    else:
        from richdem_tpu.pipeline import terrain_pipeline
        out = terrain_pipeline(r.np(), eps=args.eps_value,
                               with_twi=args.twi, no_data=r.no_data)
    base = args.output
    for key, arr in out.items():
        arr = np.asarray(arr)
        if arr.ndim != 2:  # iteration-count scalars etc.
            continue
        path = base.replace("%s", key) if "%s" in base else \
            f"{base}.{key}.npz"
        _save(path, r.like(arr))


def cmd_synth(args):
    from richdem_tpu import synth
    from richdem_tpu.grid import rdarray
    makers = {
        "cone": lambda: synth.cone_dem(args.size, dtype=np.float32),
        "inverted-cone": lambda: synth.inverted_cone_dem(
            args.size, dtype=np.float32),
        "saddle": lambda: synth.saddle_dem(args.size, dtype=np.float32),
        "plateau": lambda: synth.plateau_dem(args.size, dtype=np.float32),
        "perlin": lambda: synth.perlin_dem(args.size, seed=args.seed,
                                           dtype=np.float32),
        "depressions": lambda: synth.depression_dem(
            args.size, seed=args.seed, dtype=np.float32),
    }
    _save(args.output, rdarray(makers[args.kind]()))


def cmd_expand(args):
    """Embed a raster into larger dimensions at an offset, padding with
    nodata — the reference's ``rd_expand_dimensions`` (SURVEY.md §2.3)."""
    r = _load(args.input)
    h, w = r.shape
    H, W = args.height, args.width
    y0, x0 = args.y0, args.x0
    if H < h + y0 or W < w + x0:
        raise SystemExit("target dimensions too small for the raster "
                         f"({h}x{w} at +{y0}+{x0} into {H}x{W})")
    fill = r.no_data if r.no_data is not None else args.fill
    out = np.full((H, W), fill, dtype=np.asarray(r.np()).dtype)
    out[y0:y0 + h, x0:x0 + w] = r.np()
    expanded = r.like(out)
    if r.no_data is None:
        expanded.no_data = args.fill
    _save(args.output, expanded)


def cmd_merge(args):
    """Stitch tiles named in a layout manifest (CSV of paths, blank =
    missing) into one raster — the reference's
    ``rd_merge_rasters_by_layout``."""
    from richdem_tpu.parallel.layout import merge_by_layout
    merged = merge_by_layout(args.layout)
    _save(args.output, merged)


def build_parser():
    p = argparse.ArgumentParser(
        prog="richdem_tpu",
        description=f"{PROGRAM_IDENTIFIER} — terrain analysis verbs")
    sub = p.add_subparsers(dest="verb", required=True)

    def add(name, fn, **kwargs):
        sp = sub.add_parser(name, **kwargs)
        sp.set_defaults(fn=fn)
        return sp

    sp = add("fill-depressions", cmd_fill,
             help="Priority-Flood-equivalent depression filling")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--epsilon", action="store_true")
    sp.add_argument("--eps-value", type=float, default=None)
    sp.add_argument("--topology", default="D8", choices=["D8", "D4"])

    sp = add("breach-depressions", cmd_breach,
             help="Lindsay 2016 depression breaching")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--mode", default="Complete",
                    choices=["Complete", "Selective", "Constrained"])
    sp.add_argument("--eps-value", type=float, default=0.0)
    sp.add_argument("--max-path-len", type=int, default=None)
    sp.add_argument("--max-path-depth", type=float, default=None)
    sp.add_argument("--fill-remainder", action="store_true")

    sp = add("resolve-flats", cmd_resolve_flats,
             help="Barnes-Lehman-Mulla flat resolution")
    sp.add_argument("input"); sp.add_argument("output")

    sp = add("flowdirs", cmd_flowdirs, help="flow directions")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--method", default="D8")
    sp.add_argument("--resolve-flats", action="store_true")

    sp = add("flow-accumulation", cmd_accum, help="flow accumulation")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--method", default="D8")
    sp.add_argument("--exponent", type=float, default=None)
    sp.add_argument("--weights", default=None)

    sp = add("terrain-attribute", cmd_terrain,
             help="slope/aspect/curvature attributes")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--attrib", required=True)
    sp.add_argument("--zscale", type=float, default=1.0)

    sp = add("twi", cmd_twi, help="full fill→accum→TWI pipeline")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--method", default="Dinf")

    sp = add("info", cmd_info, help="raster metadata as JSON")
    sp.add_argument("input")

    sp = add("hist", cmd_hist, help="value histogram")
    sp.add_argument("input")
    sp.add_argument("--bins", type=int, default=20)

    sp = add("compare", cmd_compare, help="compare two rasters")
    sp.add_argument("a"); sp.add_argument("b")
    sp.add_argument("--atol", type=float, default=0.0)
    sp.add_argument("--rtol", type=float, default=0.0)

    sp = add("no-data", cmd_no_data, help="get/set nodata value")
    sp.add_argument("input")
    sp.add_argument("--set", type=float, default=None)
    sp.add_argument("--output", default=None)

    sp = add("geotransform", cmd_geotransform, help="get/set geotransform")
    sp.add_argument("input")
    sp.add_argument("--set", type=float, nargs=6, default=None)
    sp.add_argument("--output", default=None)

    sp = add("convert", cmd_convert, help="convert raster format")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--compress", default=None,
                    choices=["deflate", "lzw"],
                    help="GeoTIFF output compression")
    sp.add_argument("--predictor", type=int, default=None,
                    choices=[2, 3],
                    help="GeoTIFF predictor (2=int diff, 3=float)")

    sp = add("synth", cmd_synth, help="generate synthetic terrain")
    sp.add_argument("kind", choices=["cone", "inverted-cone", "saddle",
                                     "plateau", "perlin", "depressions"])
    sp.add_argument("output")
    sp.add_argument("--size", type=int, default=1024)
    sp.add_argument("--seed", type=int, default=0)

    sp = add("taudem-convert", cmd_taudem,
             help="convert TauDEM D8 encoding to package encoding")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--reverse", action="store_true",
                    help="package encoding -> TauDEM")

    sp = add("pipeline", cmd_pipeline,
             help="fill->flowdirs->accum (->TWI), resumable")
    sp.add_argument("input"); sp.add_argument("output",
                    help="output base; '%%s' expands to the raster name")
    sp.add_argument("--eps-value", type=float, default=1e-3)
    sp.add_argument("--twi", action="store_true")
    sp.add_argument("--cache-dir", default=None)
    sp.add_argument("--grid-id", default="grid")

    sp = add("expand-dimensions", cmd_expand,
             help="embed raster in larger extent, padding with nodata")
    sp.add_argument("input"); sp.add_argument("output")
    sp.add_argument("--height", type=int, required=True)
    sp.add_argument("--width", type=int, required=True)
    sp.add_argument("--y0", type=int, default=0)
    sp.add_argument("--x0", type=int, default=0)
    sp.add_argument("--fill", type=float, default=-9999.0,
                    help="pad value when the raster has no nodata")

    sp = add("merge", cmd_merge, help="stitch tiles by layout manifest")
    sp.add_argument("layout"); sp.add_argument("output")
    return p


def main(argv=None):
    print(PROGRAM_IDENTIFIER, file=sys.stderr)
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
