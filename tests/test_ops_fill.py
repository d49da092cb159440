"""Device fill (sweep fixpoint) vs oracle Priority-Flood — the core
allclose gate (SURVEY.md §4 implication (a))."""

import numpy as np
import pytest

from richdem_tpu import synth
from richdem_tpu.oracle import priority_flood_fill, priority_flood_epsilon
from richdem_tpu.ops.fill import (
    fill_depressions, fill_depressions_info, auto_epsilon,
)


DEMS = {
    "cone": lambda: synth.cone_dem(64, dtype=np.float64),
    "inverted_cone": lambda: synth.inverted_cone_dem(64, dtype=np.float64),
    "depressions": lambda: synth.depression_dem(64, seed=3,
                                                dtype=np.float64),
    "perlin": lambda: synth.perlin_dem(64, seed=7, dtype=np.float64),
    "plateau": lambda: synth.plateau_dem(48, dtype=np.float64),
    "saddle": lambda: synth.saddle_dem(48, dtype=np.float64),
}


@pytest.mark.parametrize("name", sorted(DEMS))
def test_fill_matches_oracle(name):
    dem = DEMS[name]()
    got = np.asarray(fill_depressions(dem))
    want = priority_flood_fill(dem)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("eps", [1e-4, 1e-2])
def test_epsilon_fill_matches_oracle(eps):
    dem = synth.depression_dem(48, seed=5, dtype=np.float64)
    got = np.asarray(fill_depressions(dem, eps=eps))
    want = priority_flood_epsilon(dem, eps=eps)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)


def test_fill_with_nodata_matches_oracle():
    dem = synth.depression_dem(48, seed=9, dtype=np.float64)
    dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=2, n_holes=3)
    got = np.asarray(fill_depressions(dem, no_data=-9999.0))
    want = priority_flood_fill(dem, no_data=-9999.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-9)
    np.testing.assert_array_equal(got == -9999.0, dem == -9999.0)


def test_fill_float32():
    dem = synth.depression_dem(48, seed=1, dtype=np.float32)
    got = np.asarray(fill_depressions(dem))
    assert got.dtype == np.float32
    want = priority_flood_fill(dem.astype(np.float64))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_fill_converges_and_reports():
    dem = synth.depression_dem(32, seed=2, dtype=np.float64)
    filled, iters, done = fill_depressions_info(dem)
    assert bool(done)
    assert int(iters) < 32  # sweeps, not O(diameter) Jacobi steps


def test_auto_epsilon_resolvable():
    dem = synth.depression_dem(32, seed=4, dtype=np.float32) + 1000.0
    eps = auto_epsilon(dem)
    assert np.float32(1000.0 + eps) > np.float32(1000.0)


def test_fill_idempotent():
    dem = synth.depression_dem(48, seed=6, dtype=np.float64)
    once = np.asarray(fill_depressions(dem))
    twice = np.asarray(fill_depressions(once))
    np.testing.assert_array_equal(once, twice)


# float32 cases (the device precision) across generators, seeds, ε,
# nodata and non-square shapes

@pytest.mark.parametrize("gen,seed", [("depression", 3), ("perlin", 7),
                                      ("cone", 0)])
def test_fill_f32_generators(gen, seed):
    dem = (synth.cone_dem(72, dtype=np.float32) if gen == "cone" else
           getattr(synth, f"{gen}_dem")(72, seed=seed, dtype=np.float32))
    filled, _, done = fill_depressions_info(dem, max_iters=1024)
    assert bool(done)
    np.testing.assert_allclose(np.asarray(filled, np.float64),
                               priority_flood_fill(dem.astype(np.float64)),
                               rtol=0, atol=1e-5)


def test_fill_f32_epsilon_and_nodata():
    dem = synth.with_nodata_holes(
        synth.depression_dem(64, seed=5, dtype=np.float32), no_data=-9999.0)
    nd = dem == -9999.0
    got = np.asarray(fill_depressions(dem, no_data=-9999.0, eps=1e-3),
                     np.float64)
    want = priority_flood_epsilon(dem, no_data=-9999.0, eps=1e-3,
                                  dtype=np.float64)
    np.testing.assert_allclose(got[~nd], want[~nd], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[nd], -9999.0)


@pytest.mark.parametrize("hw", [(64, 72), (96, 200), (70, 130), (72, 130)])
def test_fill_nonsquare(hw):
    dem = synth.depression_dem(*hw, seed=9, dtype=np.float32)
    got = np.asarray(fill_depressions(dem), np.float64)
    np.testing.assert_allclose(got, priority_flood_fill(
        dem.astype(np.float64)), rtol=0, atol=1e-5)


def test_fill_d4_is_a_coarser_fill():
    """D4 prices the diagonal edges out: its fill lies on or above the D8
    fill everywhere, above it somewhere, and is itself D4-idempotent."""
    import richdem_tpu as rd
    dem = synth.depression_dem(64, seed=13, dtype=np.float32)
    # a pit whose only low exit is diagonal, to the corner
    dem[0, 0], dem[1, 1] = 0.0, -5.0
    dem[0, 1] = dem[1, 0] = dem[0, 2] = dem[2, 0] = dem[1, 2] = 100.0
    dem[2, 1] = dem[2, 2] = 100.0
    d4 = np.asarray(rd.FillDepressions(dem, topology="D4").data)
    d8 = np.asarray(rd.FillDepressions(dem).data)
    assert (d4 >= d8).all() and (d4 > d8).any()
    again = np.asarray(rd.FillDepressions(d4, topology="D4").data)
    np.testing.assert_array_equal(again, d4)


@pytest.mark.parametrize("eps", [0.0, 1e-3])
def test_scalar_costs_match_stacked(eps):
    """A scalar edge cost stays a scalar through the sweeps; the result
    equals the explicit (8, H, W) cost stack bit for bit."""
    import jax.numpy as jnp
    from richdem_tpu.ops.sweeps import BIG, minplus_fixpoint
    z = jnp.asarray(synth.perlin_dem(48, 56, seed=4, dtype=np.float32))
    w0 = jnp.full(z.shape, BIG, z.dtype)
    a = minplus_fixpoint(w0, z, jnp.float32(eps), jnp.float32(-BIG))
    b = minplus_fixpoint(w0, z, jnp.full((8,) + z.shape, eps, z.dtype),
                         jnp.float32(-BIG))
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    assert int(a[1]) == int(b[1])


def test_fill_raises_when_capped():
    """A truncated fill is an error, never a silently wrong raster."""
    dem = synth.depression_dem(64, seed=3, dtype=np.float64)
    with pytest.raises(RuntimeError, match="did not converge"):
        fill_depressions(dem, max_iters=1)
