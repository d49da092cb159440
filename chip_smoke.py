"""Smoke test of the main path on a GPU: fill → D8 → accumulation (→ slope,
TWI) at 10240² through the public entry points, checked against the
native C++ engine, then the card gates and the other configurations.

    python chip_smoke.py              # phases 1-6 on one card
    python chip_smoke.py --cards 4    # only the sharded pipeline, 2×2 mesh

Phases (each prints a line; any failure raises and exits non-zero):

1. identify — assert a GPU; card name and power limit; JAX versions.
2. compile  — the 10240² ``make_pipeline(with_twi=True, no_data=...)``
   step: compile seconds and ``memory_analysis()``.
3. main path — a Perlin DEM with nodata holes made on the device from
   ``--seed``; ``FillDepressions`` → ``FlowAccumulation("D8")`` →
   ``TerrainAttribute("slope_radians")`` → ``TWI``, then three pipeline
   steps; convergence flags and exact mass conservation.
4. reference — the same DEM through the native engine: fill bit-exact,
   D8 directions equal except at f32 slope ties (counted and bounded),
   accumulation exact while below 2²⁴.
5. card gates — ``pytest -m gpu`` in this process.
6. reach — ε-fill + flats, D∞ + TWI and Quinn MFD at 4096², each
   converged; the out-of-core two-pass fill with the device consumer
   against the in-core fill.
7. (``--cards 4``) the sharded pipeline against the one-card pipeline:
   fill and directions bitwise, accumulation exact.

The last line of standard output is one JSON object naming the device.
Without a GPU, or outside the repository, it exits non-zero and prints
no result.  ``--rehearse`` runs the phases on the CPU at ``--size`` and
still prints no result (exit 3).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

NODATA = -9999.0
#: Largest count that f32 holds exactly: accumulation is exact below it.
F32_EXACT = 2 ** 24
#: Relative gap under which two f32 slopes may order differently from
#: their f64 values: a subtraction, a division and a reciprocal rounding,
#: each ≤ 2⁻²⁴ relative, with margin.
TIE_RTOL = 2.0 ** -21


def log(msg):
    print(msg, flush=True)


class Phase:
    def __init__(self, name):
        self.name = name

    def __enter__(self):
        log(f"== {self.name}")
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"== {self.name}: ok in {time.perf_counter() - self.t0:.1f} s")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, *args):
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def make_dem(n, seed):
    from richdem_tpu import synth_jax
    return synth_jax.with_nodata_holes(synth_jax.perlin_dem(n, seed=seed),
                                       no_data=NODATA, seed=seed,
                                       n_holes=12)


def mass_conserved(out, nd):
    """Accumulation absorbed at terminal data cells == number of data cells
    (D8 never routes into nodata or off the grid: terminals are NO_FLOW)."""
    import numpy as np
    acc = np.asarray(out["accum"], np.float64)
    fd = np.asarray(out["flowdirs"])
    absorbed = acc[(fd == 0) & ~nd].sum()
    n_data = float((~nd).sum())
    assert absorbed == n_data, (absorbed, n_data)
    assert (acc[nd] == 0).all()
    return acc.max()


def phase_compile(n, seed):
    from richdem_tpu.pipeline import make_pipeline
    z = make_dem(n, seed)
    step = make_pipeline((n, n), eps=0.0, with_twi=True, no_data=NODATA)
    t0 = time.perf_counter()
    compiled = step.lower(z).compile()
    log(f"pipeline {n}x{n} with TWI: compile {time.perf_counter() - t0:.1f} s")
    log(f"memory_analysis: {compiled.memory_analysis()}")
    return z, compiled


def phase_main(z, compiled, card):
    import jax.numpy as jnp
    import numpy as np

    import richdem_tpu as rd
    from richdem_tpu.pipeline import check_converged

    nd = np.asarray(z == NODATA)
    dem = rd.rdarray(z, no_data=NODATA)
    filled, t_fill = timed(lambda: rd.FillDepressions(dem).data)
    filled_rd = rd.rdarray(filled, no_data=NODATA)
    acc, t_acc = timed(
        lambda: rd.FlowAccumulation(filled_rd, method="D8").data)
    slope, t_slope = timed(
        lambda: rd.TerrainAttribute(filled_rd, "slope_radians").data)
    twi, t_twi = timed(lambda: rd.TWI(rd.rdarray(acc), rd.rdarray(slope)).data)
    log(f"api (first calls, compile included): FillDepressions {t_fill:.2f} s,"
        f" FlowAccumulation {t_acc:.2f} s, TerrainAttribute {t_slope:.2f} s,"
        f" TWI {t_twi:.2f} s")
    assert bool(jnp.isfinite(twi[~nd]).all())

    times = []
    for _ in range(3):
        out, t = timed(compiled, z)
        times.append(t)
    check_converged(out)
    acc_max = mass_conserved(out, nd)
    n = z.shape[0]
    log(f"pipeline steps on {card}: "
        + ", ".join(f"{t:.4f}" for t in times)
        + f" s ({n * n / min(times):.4g} cells/s); "
        f"fill iters {int(out['fill_iters'])}, "
        f"accum rotations {int(out['accum_rotations'])}, "
        f"max accum {acc_max:.0f}")
    # the public API and the fused pipeline give the same rasters
    np.testing.assert_array_equal(np.asarray(filled), np.asarray(out["filled"]))
    np.testing.assert_array_equal(np.asarray(acc)[~nd],
                                  np.asarray(out["accum"])[~nd])
    assert bool(jnp.isfinite(out["twi"][~nd]).all())
    return out, nd


def phase_reference(z, out, nd):
    import numpy as np

    from richdem_tpu import native
    from richdem_tpu.topology import DR, DX, DY

    assert native.available(), "native C++ engine did not build"
    dem = np.asarray(z, np.float64)
    t0 = time.perf_counter()
    want_fill = native.fill(dem, no_data=NODATA)
    filled = np.asarray(out["filled"], np.float64)
    np.testing.assert_array_equal(filled, want_fill)
    log(f"fill: bit-exact vs native ({time.perf_counter() - t0:.1f} s)")

    fd = np.asarray(out["flowdirs"], np.int8)
    want_fd = native.d8_flowdirs(want_fill, no_data=NODATA)
    rows, cols = np.nonzero(fd != want_fd)
    h, w = fd.shape

    def slope(d):
        nr = np.clip(rows + DY[d], 0, h - 1)
        nc = np.clip(cols + DX[d], 0, w - 1)
        return (want_fill[rows, cols] - want_fill[nr, nc]) / DR[d]

    s_dev = slope(fd[rows, cols].astype(np.int64))
    s_nat = slope(want_fd[rows, cols].astype(np.int64))
    gap = np.abs(s_dev - s_nat) / np.maximum(np.abs(s_nat), 1e-30)
    assert (fd[rows, cols] > 0).all() and (want_fd[rows, cols] > 0).all()
    assert (gap <= TIE_RTOL).all(), gap.max()
    assert len(rows) <= 1e-4 * fd.size, len(rows)
    log(f"D8 directions: {len(rows)} of {fd.size} cells differ, all at f32 "
        f"slope ties (max relative slope gap {gap.max() if len(rows) else 0:.3g}"
        f" <= {TIE_RTOL:.3g})")

    acc = np.asarray(out["accum"], np.float64)
    want_acc = native.accum_d8(fd, weights=(~nd).astype(np.float64))
    want_acc[nd] = 0.0
    if want_acc.max() < F32_EXACT:
        np.testing.assert_array_equal(acc, want_acc)
        log(f"accumulation: exact vs native (max {want_acc.max():.0f} < 2^24)")
    else:
        np.testing.assert_allclose(acc, want_acc, rtol=2.0 ** -23 * 64)
        log(f"accumulation: within f32 rounding (max {want_acc.max():.0f})")


def phase_gates(here):
    import pytest
    os.environ["RICHDEM_TEST_ON_DEVICE"] = "1"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu.py")])
    assert rc == 0, f"card gates failed (pytest exit {rc})"


def phase_reach(n, seed):
    import jax
    import numpy as np

    import bench
    from richdem_tpu import synth_jax
    from richdem_tpu.ops.fill import fill_depressions
    from richdem_tpu.parallel.outofcore import out_of_core_fill

    z = jax.block_until_ready(synth_jax.perlin_dem(n, seed=seed))
    for config in ("fill_flats", "dinf_twi", "quinn_mfd"):
        label, step, check = bench.build(config, z)
        out, t = timed(step, z)
        log(f"{config} {n}x{n}: converged {check(out)}, "
            f"{t:.2f} s with compile")

    dem = np.asarray(z)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dem.npy")
        np.save(path, dem)
        stats = {}
        t0 = time.perf_counter()
        got = np.load(out_of_core_fill(path, tile=n // 2, method="twopass",
                                       consumer="device", stats=stats))
        t = time.perf_counter() - t0
    want = np.asarray(fill_depressions(z))
    np.testing.assert_array_equal(got, want)
    log(f"out-of-core two-pass fill, device consumer, {n}x{n} in "
        f"{n // 2}² tiles: equals in-core fill ({t:.1f} s, "
        f"{stats.get('data_passes')} data passes)")


def phase_cards(n, seed, cards):
    import jax
    import numpy as np

    from richdem_tpu.parallel.mesh import make_mesh
    from richdem_tpu.parallel.sharded import sharded_pipeline
    from richdem_tpu.pipeline import check_converged, make_pipeline

    z = make_dem(n, seed)
    nd = z == NODATA
    one, t_one = timed(make_pipeline((n, n), eps=0.0, no_data=NODATA), z)
    check_converged(one)
    mesh = make_mesh(jax.devices()[:cards], shape=(2, cards // 2))
    run = lambda: sharded_pipeline(z, mesh=mesh, eps=0.0, nodata_mask=nd)
    timed(run)  # compile
    many, t_many = timed(run)
    for key in ("filled", "flowdirs", "accum"):
        np.testing.assert_array_equal(np.asarray(many[key]),
                                      np.asarray(one[key]))
    log(f"sharded pipeline on a 2x{cards // 2} mesh == one-card pipeline at "
        f"{n}x{n} (fill, directions, accumulation bitwise); one card "
        f"{t_one:.3f} s with compile, {cards} cards {t_many:.3f} s")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=10240)
    ap.add_argument("--reach-size", type=int, default=4096)
    ap.add_argument("--rehearse", action="store_true",
                    help="allow the CPU; exits 3 without a result")
    args = ap.parse_args()
    here = os.path.dirname(os.path.abspath(__file__))

    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        sys.exit(f"chip_smoke: no GPU (JAX platform {dev.platform!r})")
    try:
        import richdem_tpu  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: run from the repository root ({e})")
    if len(jax.devices()) < args.cards:
        sys.exit(f"chip_smoke: {args.cards} cards asked, "
                 f"{len(jax.devices())} found")

    with Phase("1 identify"):
        card = card_line() if dev.platform == "gpu" else "no card"
        import jaxlib
        log(f"card: {card}")
        log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
            f"devices {jax.devices()}")
    if args.cards > 1:
        with Phase(f"7 {args.cards} cards"):
            phase_cards(args.size, args.seed, args.cards)
    else:
        with Phase("2 compile"):
            z, compiled = phase_compile(args.size, args.seed)
        with Phase("3 main path"):
            out, nd = phase_main(z, compiled, card)
        with Phase("4 against the native engine"):
            phase_reference(z, out, nd)
        del compiled
        with Phase("5 card gates"):
            phase_gates(here)
        with Phase("6 reach"):
            phase_reach(args.reach_size, args.seed)
    if args.rehearse:
        sys.exit(3)
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
