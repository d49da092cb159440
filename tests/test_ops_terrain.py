"""Device terrain attributes vs oracle (all 8 attributes, nodata, params)."""

import numpy as np
import pytest

from richdem_tpu import synth, oracle
from richdem_tpu.ops.terrain import terrain_attribute, TERRAIN_ATTRIBUTES


@pytest.mark.parametrize("attrib", TERRAIN_ATTRIBUTES)
def test_matches_oracle(attrib):
    dem = synth.perlin_dem(48, seed=21, dtype=np.float64)
    got = np.asarray(terrain_attribute(dem, attrib))
    want = oracle.terrain_attribute(dem, attrib)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("attrib", ["slope_riserun", "aspect", "curvature"])
def test_matches_oracle_with_params(attrib):
    dem = synth.saddle_dem(32, dtype=np.float64)
    got = np.asarray(terrain_attribute(dem, attrib, zscale=3.0,
                                       cellsize=30.0))
    want = oracle.terrain_attribute(dem, attrib, zscale=3.0, cellsize=30.0)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_nodata_handling():
    dem = synth.perlin_dem(32, seed=2, dtype=np.float64)
    dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=9, n_holes=2)
    got = np.asarray(terrain_attribute(dem, "slope_riserun",
                                       no_data=-9999.0))
    want = oracle.terrain_attribute(dem, "slope_riserun", no_data=-9999.0)
    nd = dem == -9999.0
    assert np.isnan(got[nd]).all()
    np.testing.assert_allclose(got[~nd], want[~nd], atol=1e-9)


def test_float32_path():
    dem = synth.perlin_dem(32, seed=4, dtype=np.float32)
    got = np.asarray(terrain_attribute(dem, "slope_riserun"))
    assert got.dtype == np.float32
    want = oracle.terrain_attribute(dem.astype(np.float64), "slope_riserun")
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-5)


def test_unknown_attrib_raises():
    with pytest.raises(ValueError, match="unknown terrain attribute"):
        terrain_attribute(np.zeros((4, 4)), "bogus")


@pytest.mark.parametrize("attrib", TERRAIN_ATTRIBUTES)
def test_f32_scaled_matches_oracle(attrib):
    """float32 input with zscale and cellsize, every attribute."""
    dem = synth.perlin_dem(72, seed=2, dtype=np.float32)
    got = np.asarray(terrain_attribute(dem, attrib, zscale=2.0,
                                       cellsize=3.0), np.float64)
    want = oracle.terrain_attribute(dem.astype(np.float64), attrib,
                                    zscale=2.0, cellsize=3.0)
    tol = 0.1 if attrib == "aspect" else 2e-3  # angle is ill-conditioned
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_f32_nodata_is_nan():
    dem = synth.with_nodata_holes(
        synth.depression_dem(64, seed=5, dtype=np.float32), no_data=-9999.0)
    got = np.asarray(terrain_attribute(dem, "slope_radians",
                                       no_data=-9999.0))
    assert np.isnan(got[dem == -9999.0]).all()
    assert np.isfinite(got[dem != -9999.0]).all()
