"""Device accumulation (Jacobi fixpoint + D8 pointer doubling) vs oracle."""

import numpy as np
import pytest

from richdem_tpu import synth, oracle
from richdem_tpu.ops import flowdirs as fops
from richdem_tpu.ops.accum import (
    flow_accumulation_from_props, d8_accumulation, accumulation_jacobi_info,
)


def _filled_perlin(n=40, seed=11):
    dem = synth.perlin_dem(n, seed=seed, dtype=np.float64)
    return oracle.priority_flood_epsilon(dem, eps=1e-6)


@pytest.mark.parametrize("method", ["D8", "Dinf", "Quinn", "Freeman"])
def test_jacobi_matches_oracle(method):
    filled = _filled_perlin()
    props = oracle.flow_proportions(filled, method=method)
    got = np.asarray(flow_accumulation_from_props(props))
    want = oracle.flow_accumulation_from_props(props)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_jacobi_weighted():
    filled = _filled_perlin(seed=5)
    props = oracle.flow_proportions(filled, method="Dinf")
    w = np.random.default_rng(0).uniform(0.5, 2.0, filled.shape)
    got = np.asarray(flow_accumulation_from_props(props, weights=w))
    want = oracle.flow_accumulation_from_props(props, weights=w)
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_jacobi_converges_quickly_on_cone():
    z = -synth.cone_dem(33, dtype=np.float64)  # all paths -> center
    props = oracle.flow_proportions(z, method="D8")
    acc, iters, done = accumulation_jacobi_info(props)
    assert bool(done)
    want = oracle.flow_accumulation_from_props(props)
    np.testing.assert_allclose(np.asarray(acc), want, rtol=1e-9)


def test_d8_doubling_matches_oracle():
    filled = _filled_perlin(seed=17)
    fd = oracle.resolve_flats(filled, oracle.d8_flowdirs(filled))
    got = np.asarray(d8_accumulation(fd))
    want = oracle.d8_accumulation(fd)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_d8_doubling_weighted_and_nodata():
    dem = synth.perlin_dem(40, seed=23, dtype=np.float64)
    dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=3, n_holes=2)
    nd = dem == -9999.0
    filled = oracle.priority_flood_epsilon(dem, no_data=-9999.0, eps=1e-6)
    fd = oracle.d8_flowdirs(filled, no_data=-9999.0)
    w = np.full(dem.shape, 3.0)
    got = np.asarray(d8_accumulation(fd, weights=w, no_data_mask=nd))
    want = oracle.d8_accumulation(fd, weights=np.where(nd, 0, w),
                                  no_data_mask=nd)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_device_pipeline_matches_oracle_pipeline():
    """fill -> flowdirs -> accum entirely on device == entirely in oracle."""
    from richdem_tpu.ops.fill import fill_depressions
    dem = synth.depression_dem(48, seed=31, dtype=np.float64)
    f_dev = fill_depressions(dem, eps=1e-6)
    fd_dev = fops.d8_flowdirs(f_dev)
    acc_dev = d8_accumulation(fd_dev)

    f_or = oracle.priority_flood_epsilon(dem, eps=1e-6)
    fd_or = oracle.d8_flowdirs(f_or)
    acc_or = oracle.d8_accumulation(fd_or)

    np.testing.assert_allclose(np.asarray(f_dev), f_or, atol=1e-7)
    np.testing.assert_array_equal(np.asarray(fd_dev), fd_or)
    np.testing.assert_allclose(np.asarray(acc_dev), acc_or, rtol=1e-6)


def _serpentine_fd(n):
    """One path threading every cell: O(n) direction changes."""
    fd = np.zeros((n, n), np.int8)
    for r in range(n):
        fd[r, :] = 5 if r % 2 == 0 else 1
        fd[r, -1 if r % 2 == 0 else 0] = 7
    fd[n - 1, -1 if (n - 1) % 2 == 0 else 0] = 0
    return fd


def test_d8_f32_matches_oracle():
    dem = synth.perlin_dem(80, seed=4, dtype=np.float32)
    filled = oracle.priority_flood_epsilon(dem.astype(np.float64), eps=1e-3)
    fd = oracle.d8_flowdirs(filled)
    got = np.asarray(d8_accumulation(fd), np.float64)
    np.testing.assert_array_equal(got, oracle.d8_accumulation(fd))


def test_d8_weighted_nodata_f32():
    dem = synth.with_nodata_holes(
        synth.depression_dem(64, seed=6, dtype=np.float32), no_data=-9999.0)
    nd = dem == -9999.0
    filled = oracle.priority_flood_epsilon(dem, no_data=-9999.0, eps=1e-3,
                                           dtype=np.float64)
    fd = oracle.d8_flowdirs(filled, no_data=-9999.0)
    w = np.full(dem.shape, 2.5)
    got = np.asarray(d8_accumulation(fd, weights=w, no_data_mask=nd),
                     np.float64)
    want = oracle.d8_accumulation(fd, weights=np.where(nd, 0.0, w))
    want[nd] = 0.0
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_d8_irrational_weights():
    filled = _filled_perlin(48, seed=3)
    fd = oracle.d8_flowdirs(filled)
    w = np.random.default_rng(1).uniform(0.1, 2.0, fd.shape) * np.pi
    got = np.asarray(d8_accumulation(fd, weights=w), np.float64)
    np.testing.assert_allclose(got, oracle.d8_accumulation(fd, weights=w),
                               rtol=1e-5)


def test_d8_raises_when_capped():
    fd = _serpentine_fd(24)
    with pytest.raises(RuntimeError, match="did not converge"):
        d8_accumulation(fd, max_rotations=1)
    acc, rot, done = d8_accumulation(fd, return_info=True)
    assert bool(done) and int(rot) > 1
    np.testing.assert_array_equal(np.asarray(acc, np.float64),
                                  oracle.d8_accumulation(fd))


@pytest.mark.parametrize("method,kw", [
    ("Quinn", {}), ("Dinf", {}), ("Freeman", {}),
    ("Holmgren", {"exponent": 2.0}), ("SeibertMcGlynn", {"exponent": 1.0}),
])
def test_mfd_f32_matches_oracle(method, kw):
    dem = synth.perlin_dem(64, seed=4, dtype=np.float64)
    filled = oracle.priority_flood_epsilon(dem, eps=1e-3)
    props = oracle.flow_proportions(filled, method=method, **kw)
    got, iters, done = flow_accumulation_from_props(
        np.asarray(props, np.float32), return_info=True)
    assert bool(done) and int(iters) > 0
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               oracle.flow_accumulation_from_props(props),
                               rtol=2e-4, atol=1e-3)


def test_dinf_from_angles_matches_oracle():
    from richdem_tpu.ops.accum import dinf_accumulation_from_angles
    filled = _filled_perlin(48, seed=8)
    ang = oracle.dinf_flowdirs(filled)
    got, _, done = dinf_accumulation_from_angles(ang, return_info=True)
    assert bool(done)
    want = oracle.flow_accumulation_from_props(
        oracle.flow_proportions(filled, method="Dinf"))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-6)


def test_jacobi_raises_when_capped():
    """The multi-flow Jacobi fixpoint raises instead of returning a
    truncated accumulation."""
    props = fops.proportions_from_d8(_serpentine_fd(16))
    with pytest.raises(RuntimeError, match="did not converge"):
        flow_accumulation_from_props(props, max_iters=8)


def test_jacobi_cap_sized_from_grid():
    """No acyclic flow path outlasts the default cap: the longest path
    (a serpentine through every cell) converges under it."""
    from richdem_tpu.ops.accum import jacobi_cap
    assert jacobi_cap(10240, 10240) > 10240 * 10240
    fd = _serpentine_fd(12)
    acc, iters, done = accumulation_jacobi_info(fops.proportions_from_d8(fd))
    assert bool(done) and int(iters) >= 144
    np.testing.assert_array_equal(np.asarray(acc), oracle.d8_accumulation(fd))
