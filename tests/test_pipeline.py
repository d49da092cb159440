"""The flagship pipeline (fill → D8 → accumulation → slope/TWI) on the
CPU engines: oracle equality, nodata drains, convergence guards."""

import numpy as np
import pytest

from richdem_tpu import oracle, synth
from richdem_tpu.pipeline import check_converged, terrain_pipeline


def test_pipeline_matches_oracle_with_twi():
    dem = synth.depression_dem(64, seed=11, dtype=np.float32)
    out = terrain_pipeline(dem, eps=0.0, with_twi=True)
    want = oracle.priority_flood_fill(dem.astype(np.float64))
    np.testing.assert_allclose(np.asarray(out["filled"], np.float64),
                               want, rtol=0, atol=1e-5)
    fd = oracle.d8_flowdirs(np.asarray(out["filled"], np.float64))
    np.testing.assert_array_equal(np.asarray(out["flowdirs"]), fd)
    np.testing.assert_array_equal(np.asarray(out["accum"], np.float64),
                                  oracle.d8_accumulation(fd))
    assert np.isfinite(np.asarray(out["twi"])).all()


def _serpentine_canyon_dem(n, dtype=np.float32):
    """A walled serpentine canyon: channels on even rows descend
    alternately east/west, connected through gaps in the high walls, so
    the steepest-descent directions form one serpentine path — ~n/2
    vertical direction alternations, the adversarial case for sweep
    convergence."""
    z = np.full((n, n), 1e6, dtype)  # walls on odd rows
    val = float(n * n)
    for k, r in enumerate(range(0, n, 2)):
        cols = range(n) if k % 2 == 0 else range(n - 1, -1, -1)
        for c in cols:
            z[r, c] = val
            val -= 1.0
        if r + 1 < n:
            z[r + 1, (n - 1) if k % 2 == 0 else 0] = val  # wall gap
            val -= 1.0
    return z


def test_pipeline_serpentine_raises_or_converges():
    """The pipeline never truncates silently: a serpentine canyon needs
    ~n/2 rotations, beyond the default log2(n²) cap, so the eager
    wrapper raises; with an adequate cap it matches the oracle."""
    n = 96
    dem = _serpentine_canyon_dem(n)
    with pytest.raises(RuntimeError, match="did not converge"):
        terrain_pipeline(dem, eps=0.0)
    out = terrain_pipeline(dem, eps=0.0, max_rotations=2 * n)
    want = oracle.d8_accumulation(oracle.d8_flowdirs(
        dem.astype(np.float64)))
    np.testing.assert_allclose(np.asarray(out["accum"]), want, rtol=1e-6)
    assert float(np.asarray(out["accum"]).max()) == n * n


def test_pipeline_honors_nodata():
    """Sentinel cells act as drains, carry zero weight and come back
    unchanged; accumulation absorbed at terminals counts every data
    cell exactly once."""
    dem = synth.with_nodata_holes(
        synth.depression_dem(64, seed=12, dtype=np.float32), no_data=-9999.0)
    nd = dem == -9999.0
    out = terrain_pipeline(dem, eps=0.0, no_data=-9999.0)
    want = oracle.priority_flood_fill(dem, no_data=-9999.0,
                                      dtype=np.float64)
    filled = np.asarray(out["filled"], np.float64)
    np.testing.assert_allclose(filled[~nd], want[~nd], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(filled[nd], -9999.0)
    acc = np.asarray(out["accum"])
    assert (acc[nd] == 0).all()
    fd = np.asarray(out["flowdirs"])
    assert float(acc[(fd == 0) & ~nd].sum()) == float((~nd).sum())


@pytest.mark.parametrize("flag,what", [("fill_converged", "fill"),
                                       ("accum_converged", "accumulation")])
def test_check_converged_raises(flag, what):
    out = {"fill_converged": True, "accum_converged": True,
           "fill_iters": 3, "accum_rotations": 4}
    assert check_converged(dict(out)) == out
    out[flag] = False
    with pytest.raises(RuntimeError, match=what):
        check_converged(out)
