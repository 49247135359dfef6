"""The port's binned power spectra (randomfield_tpu_torch.validate.stats) vs
validate/stats.py of the JAX package, on the same numpy arrays.

Counts are compared exactly: both search the same float32 edges with
float32 |k| that differ by an ulp at most (the port squares kx after
rounding it, as the JAX calculate_power does; the JAX spectrum_power
squares first), and at these sizes no lattice shell lies within that of an
edge.  Sums within 1e-5 relative: the JAX package contracts float32 terms
against a one-hot matrix, the port adds the same terms in float64.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from randomfield_tpu.validate import stats as jstats  # noqa: E402
from randomfield_tpu_torch.parallel.mesh import (  # noqa: E402
    make_mesh, make_pencil_mesh)
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
SHAPES = [(16, 16, 16), (8, 12, 10), (16, 16, 15)]
SUM_RTOL = 1e-5


def _assert_bins_equal(got, want):
    k, p, n = got
    kw, pw, nw = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    assert live.sum() >= 3
    np.testing.assert_allclose(p[live], pw[live], rtol=SUM_RTOL)
    np.testing.assert_allclose(k[live], kw[live], rtol=SUM_RTOL)
    assert np.all(np.isnan(p[~live]))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nbins", [6, 32])
def test_bin_setup_matches_jax(shape, nbins):
    edges, mult = stats.bin_setup(shape, SPACING, nbins)
    wedges, wmult = jstats._bin_setup(shape, SPACING, nbins)
    np.testing.assert_array_equal(edges, wedges)
    np.testing.assert_array_equal(mult, wmult)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nbins", [6, 20])
def test_spectrum_power_matches_jax(shape, nbins):
    nzh = shape[2] // 2 + 1
    rng = np.random.default_rng(1)
    re = rng.normal(size=(shape[0], shape[1], nzh)).astype(np.float32)
    im = rng.normal(size=(shape[0], shape[1], nzh)).astype(np.float32)
    want = jstats.spectrum_power(jnp.asarray(re + 1j * im, jnp.complex64),
                                 shape, SPACING, nbins)
    got = stats.spectrum_power((torch.as_tensor(re), torch.as_tensor(im)),
                               shape, SPACING, nbins)
    _assert_bins_equal(got, want)
    c = torch.complex(torch.as_tensor(re), torch.as_tensor(im))
    for a, b in zip(stats.spectrum_power(c, shape, SPACING, nbins), got):
        np.testing.assert_array_equal(a, b)


@pytest.mark.smoke
@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("nbins", [6, 20])
def test_calculate_power_matches_jax(shape, nbins):
    delta = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    want = jstats.calculate_power(jnp.asarray(delta), SPACING, nbins)
    got = stats.calculate_power(torch.as_tensor(delta), SPACING, nbins)
    _assert_bins_equal(got, want)


@pytest.mark.parametrize("shape", SHAPES)
def test_bin_power_grid_matches_jax(shape):
    pgrid = np.random.default_rng(3).uniform(
        1.0, 2.0, size=(shape[0], shape[1], shape[2] // 2 + 1)).astype(np.float32)
    want = jstats.bin_power_grid(jnp.asarray(pgrid), shape, SPACING, 8)
    got = stats.bin_power_grid(torch.as_tensor(pgrid), shape, SPACING, 8)
    _assert_bins_equal(got, want)


def test_one_k_for_every_binning():
    # a field, its spectrum and the per-mode grid bin the same modes: every
    # binning of the port searches the edges with grid.kmag's float32 |k|
    shape, nbins = (16, 12, 10), 9
    delta = torch.as_tensor(
        np.random.default_rng(4).normal(size=shape).astype(np.float32))
    c = torch.fft.rfftn(delta) * SPACING ** 3
    n_field = stats.calculate_power(delta, SPACING, nbins)[2]
    n_spec = stats.spectrum_power(c / (np.prod(shape) * SPACING ** 3), shape,
                                  SPACING, nbins)[2]
    n_grid = stats.bin_power_grid(torch.ones(shape[0], shape[1], 6), shape,
                                  SPACING, nbins)[2]
    np.testing.assert_array_equal(n_field, n_spec)
    np.testing.assert_array_equal(n_field, n_grid)


def test_unported_estimator_options_raise():
    # window= and interlaced_with= run on a slab mesh as on one device (a
    # one-rank mesh gives the single-device bins); a pencil mesh waits for
    # item 5
    delta = torch.zeros((8, 8, 8))
    slab = make_mesh(device="cpu")
    field = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (8, 8, 8)).astype(np.float32))
    for kw in (dict(window="cic"), dict(interlaced_with=field.flip(0))):
        want = stats.calculate_power(field, SPACING, 4, **kw)
        got = stats.calculate_power(field, SPACING, 4, mesh=slab, **kw)
        # the slab transform rounds apart from the one-device one
        np.testing.assert_array_equal(got[2], want[2])
        np.testing.assert_allclose(got[1], want[1], rtol=1e-6)
    for kw, what in ((dict(mesh=make_pencil_mesh(spx=2, spy=2)), "ROADMAP.md"),
                     (dict(mesh=make_pencil_mesh(spx=2, spy=2),
                           interlaced_with=delta), "Queue 1 item 5")):
        with pytest.raises(NotImplementedError, match=what):
            stats.calculate_power(delta, SPACING, 4, **kw)
    with pytest.raises(ValueError, match="float32"):
        stats.calculate_power(delta.double(), SPACING, 4)
    with pytest.raises(NotImplementedError, match="xyz"):
        stats.spectrum_power(torch.zeros((8, 5, 8), dtype=torch.complex64),
                             (8, 8, 8), SPACING, layout="xzy")
