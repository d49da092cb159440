"""Derived methods' fixpoints: Strahler order reports and enforces its
convergence; watersheds match an independent pointer walk."""

import jax.numpy as jnp
import numpy as np
import pytest

from richdem_tpu import oracle, synth
from richdem_tpu.methods import (strahler_order, strahler_order_info,
                                 watersheds_from_flowdirs)
from reference_impls import strahler_numpy, terminal_labels


@pytest.fixture(scope="module")
def fd48():
    dem = synth.perlin_dem(48, seed=4, dtype=np.float64)
    return oracle.d8_flowdirs(oracle.priority_flood_epsilon(dem, eps=1e-3))


def test_strahler_matches_reference(fd48):
    order, iters, done = strahler_order_info(jnp.asarray(fd48))
    assert bool(done) and int(iters) > 1
    np.testing.assert_array_equal(np.asarray(order), strahler_numpy(fd48))


def test_strahler_raises_when_capped(fd48):
    """A truncated Strahler order is an error, never a wrong raster."""
    _, _, done = strahler_order_info(jnp.asarray(fd48), max_iters=2)
    assert not bool(done)
    with pytest.raises(RuntimeError, match="Strahler"):
        strahler_order(jnp.asarray(fd48), max_iters=2)


def test_watersheds_match_reference(fd48):
    got = np.asarray(watersheds_from_flowdirs(jnp.asarray(fd48)))
    np.testing.assert_array_equal(got, terminal_labels(fd48))
