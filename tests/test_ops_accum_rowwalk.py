"""The GPU row-walk D8 accumulation kernel, run here in Pallas interpret
mode, against the oracle's topological queue and the XLA line sweeps;
plus its wrapper (padding, engine choice) and its Triton lowering."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from richdem_tpu import oracle, synth
from richdem_tpu.ops import accum
from richdem_tpu.ops.accum import _d8_gs_impl
from richdem_tpu.ops.accum_rowwalk import d8_rowwalk_info, padded_shape


def _rowwalk(fd, w, block, max_rotations=64):
    return d8_rowwalk_info(jnp.asarray(fd), jnp.asarray(w, jnp.float32),
                           max_rotations=max_rotations, block=block,
                           interpret=True)


def _case(h, w, seed, nodata):
    dem = synth.perlin_dem(h, w, seed=seed, dtype=np.float64)
    if nodata:
        dem = synth.with_nodata_holes(dem, no_data=-9999.0, seed=seed,
                                      n_holes=3)
    nd = dem == -9999.0
    filled = oracle.priority_flood_epsilon(dem, no_data=-9999.0, eps=1e-3)
    fd = oracle.d8_flowdirs(filled, no_data=-9999.0)
    return fd, nd


@pytest.mark.parametrize("h,w,block,seed,nodata", [
    (40, 53, 16, 1, False),    # width not a multiple of the stripe
    (70, 33, 8, 2, True),      # many seams, nodata holes
    (64, 64, 32, 3, False),    # square, two stripes
    (31, 90, 8, 4, True),      # wide: 15 stripes
    (97, 24, 16, 5, False),    # tall: transposed stripes dominate
    (48, 48, 128, 6, True),    # one stripe wider than the grid
])
def test_rowwalk_matches_oracle_and_xla(h, w, block, seed, nodata):
    fd, nd = _case(h, w, seed, nodata)
    wts = np.where(nd, 0.0, 1.0)
    acc, rot, done = _rowwalk(fd, wts, block)
    assert bool(done) and int(rot) >= 1
    acc = np.asarray(acc, np.float64)
    want = oracle.d8_accumulation(fd, weights=wts)
    np.testing.assert_array_equal(acc[~nd], want[~nd])
    ref, _, _ = _d8_gs_impl(jnp.asarray(fd), jnp.asarray(wts, jnp.float32))
    np.testing.assert_array_equal(acc[~nd], np.asarray(ref)[~nd])


@pytest.mark.parametrize("code", range(1, 9))
def test_rowwalk_uniform_direction(code):
    """Every cell flows the same way: each direction code exercises one
    walk direction (down/up rows, down/up the transposed columns) and,
    for diagonals, the lateral taps across stripe seams."""
    h, w = 21, 27
    fd = np.full((h, w), code, np.int8)
    acc, _, done = _rowwalk(fd, np.ones((h, w)), 8)
    assert bool(done)
    np.testing.assert_array_equal(np.asarray(acc, np.float64),
                                  oracle.d8_accumulation(fd))


def test_rowwalk_straight_run_one_rotation():
    """A run that goes straight down the walk direction is resolved by
    one sweep: the second rotation only confirms the fixpoint."""
    fd = np.full((50, 20), 7, np.int8)  # everything flows south
    acc, rot, done = _rowwalk(fd, np.ones(fd.shape), 8)
    assert bool(done) and int(rot) == 2
    np.testing.assert_array_equal(np.asarray(acc)[:, 0],
                                  np.arange(1, 51, dtype=np.float32))


def _serpentine_fd(n):
    """One path threading every cell: rows alternate east/west and step
    south at the ends — O(n) direction changes."""
    fd = np.zeros((n, n), np.int8)
    for r in range(n):
        fd[r, :] = 5 if r % 2 == 0 else 1
        fd[r, -1 if r % 2 == 0 else 0] = 7
    fd[n - 1, -1 if (n - 1) % 2 == 0 else 0] = 0
    return fd


def test_rowwalk_convergence_flag():
    """A too-small cap returns ``converged=False``; the wrapper raises."""
    fd = _serpentine_fd(16)
    acc, rot, done = _rowwalk(fd, np.ones(fd.shape), 8, max_rotations=1)
    assert not bool(done) and int(rot) == 1
    acc, rot, done = _rowwalk(fd, np.ones(fd.shape), 8)
    assert bool(done)
    np.testing.assert_array_equal(np.asarray(acc, np.float64),
                                  oracle.d8_accumulation(fd))


def test_rowwalk_float_weights():
    """Irrational weights: partial sums round differently from the
    queue's order, so the gate is allclose; convergence still holds."""
    fd, _ = _case(40, 44, 7, False)
    wts = np.random.default_rng(0).uniform(0.1, 2.0, fd.shape) * np.pi
    acc, _, done = _rowwalk(fd, wts, 16)
    assert bool(done)
    np.testing.assert_allclose(np.asarray(acc, np.float64),
                               oracle.d8_accumulation(fd, weights=wts),
                               rtol=1e-5)


@pytest.mark.parametrize("h,w,block,want", [
    (10, 10, 8, (14, 14)),
    (12, 7, 8, (14, 14)),
    (100, 62, 64, (126, 64)),
    (10240, 10240, 256, (10416, 10416)),
])
def test_padded_shape(h, w, block, want):
    hp, wp = padded_shape(h, w, block)
    assert (hp - 2) % (block - 2) == 0 and (wp - 2) % (block - 2) == 0
    assert hp - 2 >= h and wp - 2 >= w
    assert hp - 2 - h < block - 2 and wp - 2 - w < block - 2
    assert (hp, wp) == want


@pytest.mark.parametrize("platform,engine", [("cpu", "xla"),
                                             ("gpu", "rowwalk")])
def test_engine_choice(monkeypatch, platform, engine):
    """One helper picks the D8 engine: the kernel on a GPU, else XLA."""
    import richdem_tpu.ops.accum_rowwalk as rw
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    monkeypatch.setattr(rw, "d8_rowwalk_info",
                        lambda *a, **k: calls.append("rowwalk") or
                        (jnp.zeros((4, 4)), 0, True))
    monkeypatch.setattr(accum, "_d8_gs_impl",
                        lambda *a, **k: calls.append("xla") or
                        (jnp.zeros((4, 4)), 0, True))
    accum.d8_accumulation_info(jnp.zeros((4, 4), jnp.int8),
                               jnp.ones((4, 4), jnp.float32))
    assert calls == [engine]


@pytest.mark.parametrize("block", [64, 256])
def test_rowwalk_lowers_for_cuda(block):
    """The kernel lowers through Pallas' Triton route for CUDA without a
    card (PTX is compiled only on the card)."""
    from jax import export
    f = jax.jit(lambda a, b: d8_rowwalk_info(a, b, 8, block))
    exp = export.export(
        f, platforms=["cuda"],
        disabled_checks=[export.DisabledSafetyCheck.custom_call(
            "__gpu$xla.gpu.triton")])(
        jax.ShapeDtypeStruct((300, 700), jnp.int8),
        jax.ShapeDtypeStruct((300, 700), jnp.float32))
    assert exp.mlir_module().count("xla.gpu.triton") == 4


def test_rowwalk_inside_shard_map(monkeypatch):
    """The sharded D8 accumulation with the kernel as its local solver
    (as on a GPU mesh) equals the oracle on 4 virtual devices."""
    from richdem_tpu.parallel.mesh import make_mesh
    from richdem_tpu.parallel.sharded import sharded_accumulation_d8
    monkeypatch.setattr(
        accum, "d8_accumulation_info",
        lambda f, w, r: d8_rowwalk_info(f, w, max_rotations=r, block=8,
                                        interpret=True))
    fd, nd = _case(32, 40, 9, False)
    mesh = make_mesh(jax.devices()[:4], shape=(2, 2))
    got = np.asarray(sharded_accumulation_d8(jnp.asarray(fd), mesh=mesh))
    np.testing.assert_array_equal(got.astype(np.float64),
                                  oracle.d8_accumulation(fd))
