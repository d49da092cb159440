"""Card gates: exact correctness of the production engines at the sizes
they run at, on a GPU, against the native C++ engine (bit-identical to
the oracle — tests/test_native.py).

Run on the card with ``python chip_smoke.py`` (its "card gates" phase
runs ``pytest -m gpu`` in-process) or ``RICHDEM_TEST_ON_DEVICE=1 python
-m pytest -m gpu tests/test_gpu.py``.  Elsewhere every test skips."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from richdem_tpu import oracle, synth, synth_jax
from reference_impls import (strahler_numpy, terminal_labels,
                                   upslope_numpy)

pytestmark = pytest.mark.gpu


@pytest.fixture(autouse=True)
def _on_gpu():
    """Decided per test, never at import: the CPU suite skips here."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("card gate: needs a GPU")


@pytest.fixture
def native():
    from richdem_tpu import native
    if not native.available():
        pytest.skip("native C++ engine unavailable")
    return native


@pytest.fixture(scope="module")
def fd640():
    dem = synth.perlin_dem(640, seed=4, dtype=np.float64)
    filled = oracle.priority_flood_epsilon(dem, eps=1e-3)
    return oracle.d8_flowdirs(filled)


def _filled(dem_d, eps):
    from richdem_tpu.ops.fill import fill_depressions_info
    filled, _, done = fill_depressions_info(dem_d, eps=eps, max_iters=1024)
    assert bool(done)
    return filled


def test_watersheds_exact(fd640):
    from richdem_tpu.methods import watersheds_from_flowdirs
    got = np.asarray(watersheds_from_flowdirs(jnp.asarray(fd640)))
    np.testing.assert_array_equal(got, terminal_labels(fd640))


def test_strahler_exact(fd640):
    from richdem_tpu.methods import strahler_order
    got = np.asarray(strahler_order(jnp.asarray(fd640)))
    np.testing.assert_array_equal(got, strahler_numpy(fd640))


def test_upslope_exact(fd640):
    from richdem_tpu.methods import upslope_cells
    h, w = fd640.shape
    seeds = np.zeros((h, w), bool)
    seeds[100, 100] = seeds[400, 350] = True
    got = np.asarray(upslope_cells(jnp.asarray(seeds), jnp.asarray(fd640)))
    np.testing.assert_array_equal(got, upslope_numpy(seeds, fd640))


@pytest.mark.parametrize("h,w,seed,pits", [(2048, 2176, 9, 24),
                                           (4096, 4224, 21, 60)])
def test_fill_exact_vs_native(native, h, w, seed, pits):
    """Plain fill is pure selection — no arithmetic — so the f32 device
    fill equals the f64 native fill of the same f32 inputs, bit for bit."""
    dem_d = synth_jax.depression_dem(h, w, seed=seed, n_pits=pits)
    filled = _filled(dem_d, 0.0)
    want = native.fill(np.asarray(dem_d, np.float64))
    np.testing.assert_array_equal(np.asarray(filled, np.float64), want)


def test_fill_epsilon_vs_native(native):
    """ε fill in f32 against the native f64 fills.  Rounding can move
    which of two near-equal spill paths feeds a depression, so the f32
    ε surface is not allclose to the f64 one at this size; the gate is
    what makes it an ε fill: on or above the exact plain fill, within
    ε per step of it, and every interior cell strictly above some
    neighbour (drains without flats)."""
    from richdem_tpu.ops.stencil import neighbor
    dem_d = synth_jax.depression_dem(2048, 2176, seed=9, n_pits=24)
    filled = _filled(dem_d, 1e-3)
    plain = native.fill(np.asarray(dem_d, np.float64))
    got = np.asarray(filled, np.float64)
    assert (got >= plain).all()
    assert (got - plain).max() <= 1e-3 * sum(got.shape)
    lower = jnp.zeros(filled.shape, bool)
    for d in range(1, 9):
        lower |= neighbor(filled, d, jnp.inf) < filled
    assert bool(lower[1:-1, 1:-1].all())


def test_flats_exact_vs_native(native):
    """Flat resolution at a production size: the distance fields are
    small integers, so resolved directions match the native BFS."""
    from richdem_tpu.ops.flats import resolve_flats
    dem_d = synth_jax.depression_dem(2048, 2176, seed=13, n_pits=30)
    filled = _filled(dem_d, 0.0)
    fd = native.d8_flowdirs(np.asarray(filled, np.float64))
    got = np.asarray(resolve_flats(filled, jnp.asarray(fd)))
    want = native.resolve_flats(np.asarray(filled, np.float64), fd)
    np.testing.assert_array_equal(got, want)


def test_d4_flowdirs_vs_native(native):
    """D4 directions from the fused stencil vs native: equal except at
    f32 slope ties, which are vanishingly few."""
    from richdem_tpu.ops.flowdirs import d8_flowdirs
    filled = _filled(synth_jax.perlin_dem(2048, 2176, seed=12), 1e-2)
    got = np.asarray(d8_flowdirs(filled, topology="D4"), np.int32)
    want = native.d8_flowdirs(np.asarray(filled, np.float64),
                              topology="D4").astype(np.int32)
    assert (got != want).mean() < 1e-4


def test_accum_d8_exact_vs_native(native):
    """The production D8 engine (the row-walk kernel on a GPU) == native
    topological queue, bit-exact: unit weights give integer partial
    sums, exact in f32 up to 2²⁴ ≫ 2048·2176."""
    from richdem_tpu.ops.accum import d8_accumulation
    from richdem_tpu.ops.flowdirs import d8_flowdirs
    filled = _filled(synth_jax.perlin_dem(2048, 2176, seed=22), 1e-2)
    fd = d8_flowdirs(filled)
    got = np.asarray(d8_accumulation(fd), np.float64)
    want = native.accum_d8(np.asarray(fd, np.int8))
    np.testing.assert_array_equal(got, want)


def test_accum_d8_weighted_nodata_vs_native(native):
    """Nodata holes and non-unit weights through the production D8
    engine: nodata cells come back 0, the rest match the native queue."""
    from richdem_tpu.ops.accum import d8_accumulation
    dem = synth.with_nodata_holes(
        synth.perlin_dem(1536, 1600, seed=5, dtype=np.float64),
        no_data=-9999.0)
    nd = dem == -9999.0
    filled = native.fill(dem, no_data=-9999.0, eps=1e-3)
    fd = native.d8_flowdirs(filled, no_data=-9999.0)
    w = np.where(nd, 0.0, 3.0)
    got = np.asarray(d8_accumulation(jnp.asarray(fd), weights=w,
                                     no_data_mask=jnp.asarray(nd)))
    want = native.accum_d8(fd, weights=w)
    want[nd] = 0.0
    np.testing.assert_array_equal(got.astype(np.float64), want)


def test_accum_rowwalk_matches_xla_sweeps():
    """Kernel and XLA line sweeps, same flow directions, on the card:
    bitwise equal accumulation (the stripe seams change the rotation
    count, never the fixpoint)."""
    from richdem_tpu.ops.accum import _d8_gs_impl
    from richdem_tpu.ops.accum_rowwalk import d8_rowwalk_info
    from richdem_tpu.ops.flowdirs import d8_flowdirs
    filled = _filled(synth_jax.perlin_dem(1000, 3000, seed=3), 1e-2)
    fd = d8_flowdirs(filled)
    w = jnp.ones(fd.shape, jnp.float32)
    a, _, da = d8_rowwalk_info(fd, w)
    b, _, db = _d8_gs_impl(fd, w)
    assert bool(da) and bool(db)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_dinf_vs_native(native):
    """D∞ accumulation (Jacobi over the decoded proportions) vs the
    native topological queue over the same proportions."""
    from richdem_tpu.ops.accum import dinf_accumulation_from_angles
    from richdem_tpu.ops.flowdirs import dinf_flowdirs, proportions_from_dinf
    filled = _filled(synth_jax.perlin_dem(2048, 2176, seed=31), 1e-2)
    ang = dinf_flowdirs(filled)
    got = np.asarray(dinf_accumulation_from_angles(ang), np.float64)
    want = native.accum_props(np.asarray(proportions_from_dinf(ang),
                                         np.float64))
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-3)
    assert abs(got.sum() - want.sum()) / want.sum() < 1e-5


def test_quinn_vs_native(native):
    """Quinn MFD accumulation vs the native queue over the same
    proportions (f32 Jacobi vs f64 queue: relative error grows with path
    length)."""
    from richdem_tpu.ops.accum import flow_accumulation_from_props
    from richdem_tpu.ops.flowdirs import flow_proportions
    filled = _filled(synth_jax.perlin_dem(2048, 2176, seed=23), 1e-2)
    props = flow_proportions(filled, method="Quinn")
    got, iters, done = flow_accumulation_from_props(props, return_info=True)
    assert bool(done) and int(iters) > 0
    want = native.accum_props(np.asarray(props, np.float64))
    np.testing.assert_allclose(np.asarray(got, np.float64), want,
                               rtol=2e-3, atol=1e-3)


def test_slope_twi_vs_native(native):
    """Slope and TWI stencils against the native engine."""
    from richdem_tpu.methods import twi
    from richdem_tpu.ops.terrain import terrain_attribute
    dem = np.asarray(synth_jax.perlin_dem(2048, 2176, seed=8), np.float64)
    got = np.asarray(terrain_attribute(jnp.asarray(dem, jnp.float32),
                                       "slope_radians"), np.float64)
    want = native.slope_radians(dem)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    acc = np.ones_like(dem)
    np.testing.assert_allclose(
        np.asarray(twi(jnp.asarray(acc, jnp.float32),
                       jnp.asarray(want, jnp.float32)), np.float64),
        native.twi(acc, want), rtol=1e-4, atol=1e-4)


def test_rho8_distribution_on_card():
    """Rho8 from ``jax.random`` on the card: exact Fairfield–Leymarie
    unbiasedness, P(diagonal) = θ/45°."""
    from richdem_tpu.ops.flowdirs import rho8_flowdirs
    h = w = 512
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    for theta_deg in (10.0, 20.0, 35.0):
        th = math.radians(theta_deg)
        z = -(np.cos(th) * x + np.sin(th) * y)
        fd = np.asarray(rho8_flowdirs(jnp.asarray(z), seed=3))
        share = (fd[2:-2, 2:-2] == 6).mean()
        assert abs(share - theta_deg / 45.0) < 0.01, (theta_deg, share)


def test_pipeline_wide_12288_exact_vs_native(native):
    """Whole pipeline at width 12288: fill bit-exact vs native
    Priority-Flood; flow directions equal except at f32 slope ties
    (device slopes in f32, native in f64); accumulation over the device
    directions exact vs the native queue (integer values < 2²⁴)."""
    from richdem_tpu.pipeline import terrain_pipeline
    h, w = 2048, 12288
    dem_d = synth_jax.depression_dem(h, w, seed=33, n_pits=40)
    out = terrain_pipeline(dem_d, eps=0.0)
    want_fill = native.fill(np.asarray(dem_d, np.float64))
    np.testing.assert_array_equal(np.asarray(out["filled"], np.float64),
                                  want_fill)
    fd = np.asarray(out["flowdirs"], np.int8)
    mism = fd.astype(np.int32) != native.d8_flowdirs(want_fill)
    assert mism.mean() < 1e-4, f"{mism.sum()} flowdir mismatches"
    np.testing.assert_array_equal(np.asarray(out["accum"], np.float64),
                                  native.accum_d8(fd))
