"""Device flat resolution vs oracle — resolved flow directions must match
bitwise (BFS levels == min-plus fixpoint levels)."""

import numpy as np
import pytest

from richdem_tpu import synth, oracle
from richdem_tpu.ops.flats import resolve_flats
from richdem_tpu.topology import NO_FLOW


DEMS = {
    "plateau": lambda: synth.plateau_dem(32, dtype=np.float64),
    "plateau_large_margin": lambda: synth.plateau_dem(40, margin=8,
                                                      dtype=np.float64),
    "filled_depressions": lambda: oracle.priority_flood_fill(
        synth.depression_dem(40, seed=3, dtype=np.float64)),
    "filled_perlin": lambda: oracle.priority_flood_fill(
        synth.perlin_dem(40, seed=9, dtype=np.float64)),
}


@pytest.mark.parametrize("name", sorted(DEMS))
def test_matches_oracle_bitwise(name):
    dem = DEMS[name]()
    fd = oracle.d8_flowdirs(dem)
    got = np.asarray(resolve_flats(dem, fd))
    want = oracle.resolve_flats(dem, fd)
    np.testing.assert_array_equal(got, want)


def test_no_flats_noop():
    dem = synth.cone_dem(33, dtype=np.float64)
    fd = oracle.d8_flowdirs(dem)
    got = np.asarray(resolve_flats(dem, fd))
    np.testing.assert_array_equal(got, fd)


def test_nodata_flats():
    dem = synth.plateau_dem(32, dtype=np.float64)
    dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=2, n_holes=1,
                                  max_radius=3)
    fd = oracle.d8_flowdirs(dem, no_data=-9999.0)
    got = np.asarray(resolve_flats(dem, fd, no_data=-9999.0))
    want = oracle.resolve_flats(dem, fd, no_data=-9999.0)
    np.testing.assert_array_equal(got, want)


def test_resolved_fills_drain():
    """Post-fill + resolve, only border/edge outlet cells keep NO_FLOW."""
    dem = oracle.priority_flood_fill(
        synth.depression_dem(40, seed=5, dtype=np.float64))
    fd = np.asarray(resolve_flats(dem, oracle.d8_flowdirs(dem)))
    interior = fd[1:-1, 1:-1]
    assert (interior == NO_FLOW).sum() == 0


@pytest.mark.parametrize("case", ["plateau72", "filled_depressions64",
                                  "filled_perlin_nodata"])
def test_quasi_membership_matches_oracle(case):
    """Flat membership is the local closure predicate, not the flood
    (see ``_resolve_impl``): resolved directions still equal the
    oracle's BFS bitwise, and ``in_flat`` covers every oracle flat."""
    import jax.numpy as jnp
    from richdem_tpu.ops import flats as F
    dem = {"plateau72": lambda: synth.plateau_dem(72, dtype=np.float64),
           "filled_depressions64": lambda: oracle.priority_flood_fill(
               synth.depression_dem(64, seed=5, dtype=np.float64)),
           "filled_perlin_nodata": lambda: synth.with_nodata_holes(
               oracle.priority_flood_fill(synth.perlin_dem(
                   64, seed=2, dtype=np.float64)), no_data=-9999.0),
           }[case]()
    nd = dem == -9999.0
    fd = oracle.d8_flowdirs(dem, no_data=-9999.0)
    got_fd, _, in_flat, info = F._resolve_impl(
        jnp.asarray(dem), jnp.asarray(fd), jnp.asarray(nd), 256)
    assert bool(info[1])
    want = oracle.resolve_flats(dem, fd, no_data=-9999.0)
    np.testing.assert_array_equal(np.asarray(got_fd), want)
    noflow = (fd == NO_FLOW) & ~nd
    assert np.asarray(in_flat)[noflow].all()


def test_resolve_flats_f32_plateau():
    dem = synth.plateau_dem(72, dtype=np.float32)
    fd = oracle.d8_flowdirs(dem.astype(np.float64))
    got = np.asarray(resolve_flats(dem, fd))
    np.testing.assert_array_equal(got, oracle.resolve_flats(
        dem.astype(np.float64), fd))


@pytest.mark.parametrize("method", ["Dinf", "Quinn"])
def test_resolved_surface_drains_divergent_metrics(method):
    """The single elevation-increment mechanism subsumes the reference's
    ``flat_resolution_dinf`` variant (SURVEY.md §2.2): D∞ and MFD
    proportions computed ON the ResolveFlats surface route flow off
    every formerly-flat cell, and accumulation over them conserves mass.
    """
    import jax.numpy as jnp

    import richdem_tpu as rd
    from richdem_tpu import ops

    dem = synth.depression_dem(64, seed=3, dtype=np.float64)
    filled = np.asarray(ops.fill_depressions(dem, eps=0.0))  # flat lakes
    fd0 = np.asarray(ops.flowdirs.d8_flowdirs(jnp.asarray(filled)))
    flats = (fd0 == NO_FLOW)
    flats[0, :] = flats[-1, :] = flats[:, 0] = flats[:, -1] = False
    assert flats.sum() > 20, "fixture must actually contain flat lakes"

    resolved = rd.ResolveFlats(rd.rdarray(filled))
    props = np.asarray(ops.flow_proportions(jnp.asarray(np.asarray(
        resolved)), method=method))
    outflow = props.sum(-1)
    # every formerly-flat interior cell now sheds its full flow
    np.testing.assert_allclose(outflow[flats], 1.0, rtol=0, atol=1e-6)
    # and the flow field is globally consistent: total mass absorbed at
    # terminals equals the cell count
    acc = np.asarray(ops.flow_accumulation_from_props(props))
    absorbed = acc[outflow < 1e-9].sum()
    np.testing.assert_allclose(absorbed, dem.size, rtol=1e-6)
