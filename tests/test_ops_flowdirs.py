"""Device flow metrics vs oracle — bitwise for directions, allclose for
proportions/angles."""

import numpy as np
import pytest

from richdem_tpu import synth, oracle
from richdem_tpu.ops import flowdirs as ops


DEMS = {
    "cone": lambda: synth.cone_dem(48, dtype=np.float64),
    "perlin": lambda: synth.perlin_dem(48, seed=7, dtype=np.float64),
    "plateau": lambda: synth.plateau_dem(40, dtype=np.float64),
    "saddle": lambda: synth.saddle_dem(40, dtype=np.float64),
}


@pytest.mark.parametrize("name", sorted(DEMS))
@pytest.mark.parametrize("topology", ["D8", "D4"])
def test_d8_matches_oracle_bitwise(name, topology):
    dem = DEMS[name]()
    got = np.asarray(ops.d8_flowdirs(dem, topology=topology))
    want = oracle.d8_flowdirs(dem, topology=topology)
    np.testing.assert_array_equal(got, want)


def test_d8_nodata_matches_oracle():
    dem = synth.perlin_dem(40, seed=3, dtype=np.float64)
    dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=2, n_holes=3)
    got = np.asarray(ops.d8_flowdirs(dem, no_data=-9999.0))
    want = oracle.d8_flowdirs(dem, no_data=-9999.0)
    np.testing.assert_array_equal(got, want)


def test_d8_cellsize_invariant_directions():
    dem = synth.perlin_dem(32, seed=5, dtype=np.float64)
    a = np.asarray(ops.d8_flowdirs(dem, cellsize=1.0))
    b = np.asarray(ops.d8_flowdirs(dem, cellsize=30.0))
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(DEMS))
def test_dinf_matches_oracle(name):
    dem = DEMS[name]()
    got = np.asarray(ops.dinf_flowdirs(dem))
    want = oracle.dinf_flowdirs(dem)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_dinf_nodata():
    dem = synth.perlin_dem(32, seed=1, dtype=np.float64)
    dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=5, n_holes=2)
    got = np.asarray(ops.dinf_flowdirs(dem, no_data=-9999.0))
    want = oracle.dinf_flowdirs(dem, no_data=-9999.0)
    np.testing.assert_allclose(got, want, atol=1e-9)


@pytest.mark.parametrize("method,kw", [
    ("D8", {}),
    ("Dinf", {}),
    ("Quinn", {}),
    ("Freeman", {}),
    ("Freeman", {"exponent": 2.0}),
    ("Holmgren", {"exponent": 4.0}),
    ("SeibertMcGlynn", {}),
])
def test_proportions_match_oracle(method, kw):
    dem = synth.perlin_dem(40, seed=11, dtype=np.float64)
    got = np.asarray(ops.flow_proportions(dem, method=method, **kw))
    want = oracle.flow_proportions(dem, method=method, **kw)
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_proportions_rows_sum():
    dem = synth.perlin_dem(40, seed=13, dtype=np.float64)
    for method in ("D8", "Dinf", "Quinn", "SeibertMcGlynn"):
        p = np.asarray(ops.flow_proportions(dem, method=method))
        sums = p.sum(axis=-1)
        assert ((np.isclose(sums, 1.0)) | (np.isclose(sums, 0.0))).all()


def test_rho8_unbiased_device():
    y, x = np.mgrid[0:40, 0:40]
    z = (-1.0 * x - 0.45 * y).astype(np.float64)
    fracs = []
    for seed in range(20):
        fd = np.asarray(ops.rho8_flowdirs(z, seed=seed))
        inner = fd[5:-5, 5:-5]
        assert set(np.unique(inner)) <= {5, 6}
        fracs.append((inner == 6).mean())
    frac_se = np.mean(fracs)
    assert 0.35 < frac_se < 0.75  # atan(0.45)/45deg ~ 0.54


def test_unknown_method_raises():
    with pytest.raises(ValueError, match="unknown flow metric"):
        ops.flow_proportions(np.zeros((4, 4)), method="D9")


def test_orlandini_device_matches_oracle():
    """The XLA deviation-field fixpoint (ops/orlandini.py — the device
    path SURVEY §2.2 asked for) equals the serial oracle bitwise, for
    both modes, several lambdas, and with nodata holes."""
    from richdem_tpu.oracle.orlandini import orlandini_flowdirs
    from richdem_tpu.ops.orlandini import orlandini_flowdirs_device

    filled = oracle.priority_flood_epsilon(
        synth.perlin_dem(48, seed=6, dtype=np.float64), eps=1e-3)
    for mode in ("LTD", "LAD"):
        for lam in (1.0, 0.5, 0.0):
            want = orlandini_flowdirs(filled, lam=lam, mode=mode)
            got = np.asarray(orlandini_flowdirs_device(
                filled, lam=lam, mode=mode))
            np.testing.assert_array_equal(got, want)
    dem = synth.with_nodata_holes(
        oracle.priority_flood_epsilon(
            synth.perlin_dem(40, seed=7, dtype=np.float64), eps=1e-3),
        no_data=-9999.0)
    want = orlandini_flowdirs(dem, no_data=-9999.0)
    got = np.asarray(orlandini_flowdirs_device(dem, no_data=-9999.0))
    np.testing.assert_array_equal(got, want)


def test_orlandini_engine_dispatch():
    import richdem_tpu as rd
    filled = oracle.priority_flood_epsilon(
        synth.perlin_dem(32, seed=8, dtype=np.float64), eps=1e-3)
    host = rd.FlowDirections(rd.rdarray(filled), method="Orlandini")
    dev = rd.FlowDirections(rd.rdarray(filled), method="Orlandini",
                            engine="device")
    np.testing.assert_array_equal(host.np(), dev.np())


@pytest.mark.parametrize("topology", ["D8", "D4"])
def test_d8_f32_filled_matches_oracle(topology):
    dem = synth.perlin_dem(96, seed=2, dtype=np.float32)
    filled = oracle.priority_flood_fill(dem.astype(np.float64))
    got = np.asarray(ops.d8_flowdirs(filled.astype(np.float32),
                                     topology=topology))
    np.testing.assert_array_equal(got, oracle.d8_flowdirs(
        filled, topology=topology))


def test_d8_f32_nodata():
    dem = synth.with_nodata_holes(
        synth.depression_dem(64, seed=5, dtype=np.float32), no_data=-9999.0)
    got = np.asarray(ops.d8_flowdirs(dem, no_data=-9999.0))
    np.testing.assert_array_equal(got, oracle.d8_flowdirs(
        dem.astype(np.float64), no_data=-9999.0))


@pytest.mark.parametrize("theta_deg", [10.0, 30.0])
def test_rho8_share_matches_aspect(theta_deg):
    """Fairfield–Leymarie unbiasedness from ``jax.random``: on a plane
    whose aspect sits θ from a cardinal, the diagonal wins with
    probability θ/45°; nodata comes back as FLOWDIR_NO_DATA."""
    import math
    th = math.radians(theta_deg)
    y, x = np.mgrid[0:256, 0:256].astype(np.float32)
    z = -(np.cos(th) * x + np.sin(th) * y)
    fd = np.asarray(ops.rho8_flowdirs(z, seed=3))
    inner = fd[2:-2, 2:-2]
    assert set(np.unique(inner)) <= {5, 6}
    assert abs((inner == 6).mean() - theta_deg / 45.0) < 0.015
    z[40:50, 40:50] = -9999.0
    fd = np.asarray(ops.rho8_flowdirs(z, no_data=-9999.0))
    assert (fd[40:50, 40:50] == -1).all()
