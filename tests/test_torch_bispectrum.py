"""The port's bispectrum estimator and local-f_NL fields vs the JAX
package's validate/bispectrum.py and models/nongaussian.py, on the same
numpy arrays.

Bars: the bins and triples exactly; the triad counts within 1e-4
relative and B within 1e-4 of max|B| (both sides form float32 shells; the
JAX package sums their triple products in float32, the port in float64,
and its own oracle test holds the counts at 1e-4); against an independent
float64 numpy evaluation of the same estimator, the JAX package's oracle
bars (counts 1e-4, B 2e-3 relative); the non-Gaussian fields within
1e-5 of max|delta| on the same Gaussian field (float32 FFTs of two
libraries), and f_NL = 0 bit-equal to the Gaussian render.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.models import nongaussian as jng  # noqa: E402
from randomfield_tpu.validate import bispectrum as jbisp  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.models import nongaussian as ng  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import bispectrum as bisp  # noqa: E402

SPACING = 8.0
SHAPES = [((16, 16, 16), 4), ((20, 16, 24), 4)]
NTRI_RTOL = 1e-4
B_TOL = 1e-4
FIELD_TOL = 1e-5


def _quadratic(shape, seed=0):
    d = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return d + 0.3 * (d * d - 1.0)


@pytest.fixture(scope="module")
def jax_results():
    return {shape: jbisp.calculate_bispectrum(jnp.asarray(_quadratic(shape)),
                                              SPACING, nbins=nb)
            for shape, nb in SHAPES}


def _assert_bispectra(got, want, ntri_rtol=NTRI_RTOL, b_tol=B_TOL,
                      b_rtol=0.0):
    k, tri, b, n = got
    kw, triw, bw, nw = (np.asarray(a) for a in want)
    np.testing.assert_allclose(k, kw, rtol=1e-12)
    np.testing.assert_array_equal(tri, triw)
    np.testing.assert_allclose(n, nw, rtol=ntri_rtol)
    np.testing.assert_allclose(b, bw, rtol=b_rtol,
                               atol=b_tol * np.abs(bw).max())


@pytest.mark.parametrize("shape,nbins,kmin,kmax", [
    ((16, 16, 16), 8, None, None), ((20, 16, 24), 5, 0.1, None),
    ((12, 12, 12), 4, None, 0.6)])
def test_bispectrum_bins_match_jax(shape, nbins, kmin, kmax):
    e, t = bisp.bispectrum_bins(shape, SPACING, nbins, kmin, kmax)
    ew, tw = jbisp.bispectrum_bins(shape, SPACING, nbins, kmin, kmax)
    np.testing.assert_array_equal(e, ew)
    np.testing.assert_array_equal(t, tw)


@pytest.mark.parametrize("shape,nbins", SHAPES)
def test_bispectrum_matches_jax(jax_results, shape, nbins):
    got = bisp.calculate_bispectrum(torch.as_tensor(_quadratic(shape)),
                                    SPACING, nbins=nbins)
    _assert_bispectra(got, jax_results[shape])


def _float64_bispectrum(delta, spacing, nbins):
    """The estimator in float64 numpy: shells of the float64 spectrum and
    unit shells, triple sums, B = num / (V den)."""
    shape = delta.shape
    edges, tri = jbisp.bispectrum_bins(shape, spacing, nbins)
    k32 = [(2 * np.pi * f(n, d=spacing)).astype(np.float32) for f, n in
           ((np.fft.fftfreq, shape[0]), (np.fft.fftfreq, shape[1]),
            (np.fft.rfftfreq, shape[2]))]
    km = np.sqrt(k32[0][:, None, None] ** 2 + k32[1][None, :, None] ** 2
                 + k32[2][None, None, :] ** 2)
    c = np.fft.rfftn(delta.astype(np.float64)) * spacing ** 3
    n = np.prod(shape)
    sh, u = [], []

    def synth(a):
        return np.fft.irfftn(a, s=shape, axes=(0, 1, 2)) * n

    for b in range(nbins):
        m = ((km >= np.float32(edges[b])) & (km < np.float32(edges[b + 1]))
             & (km > 0))
        sh.append(synth(np.where(m, c, 0)))
        u.append(synth(m.astype(np.float64)))
    num = np.array([np.sum(sh[i] * sh[j] * sh[l]) for i, j, l in tri])
    den = np.array([np.sum(u[i] * u[j] * u[l]) for i, j, l in tri])
    keep = den / n > 0.5
    centers = 0.5 * (edges[:-1] + edges[1:])
    return (centers, tri[keep], (num / (n * spacing ** 3 * den))[keep],
            (den / n)[keep])


def test_bispectrum_matches_a_float64_evaluation():
    d = np.random.default_rng(7).normal(size=(12, 12, 12)).astype(np.float32)
    got = bisp.calculate_bispectrum(torch.as_tensor(d), 5.0, nbins=4)
    _assert_bispectra(got, _float64_bispectrum(d, 5.0, 4), b_tol=0.0,
                      b_rtol=2e-3)


def test_reduced_bispectrum_matches_jax():
    k = np.array([0.1, 0.2, 0.3, 0.4])
    tri = np.array([[0, 0, 0], [0, 1, 1], [1, 2, 3]])
    b = np.array([3.0, -2.0, 5.0])
    kp, pp = np.linspace(0.05, 0.5, 10), np.linspace(900.0, 100.0, 10)
    np.testing.assert_allclose(bisp.reduced_bispectrum(k, tri, b, kp, pp),
                               jbisp.reduced_bispectrum(k, tri, b, kp, pp),
                               rtol=1e-14)


@pytest.mark.parametrize("kind,fnl", [("field", 300.0), ("potential", 3e3)])
def test_quadratic_ng_matches_jax(kind, fnl):
    shape = (16, 12, 20)
    g = np.random.default_rng(8).normal(size=shape).astype(np.float32) * 0.05
    alpha = ng._alpha_grid(shape, SPACING, "Planck13")
    want = np.asarray(jng._quadratic_ng(
        jnp.asarray(g), jnp.asarray(fnl, jnp.float32), shape, SPACING, kind,
        jng._alpha_grid(shape, SPACING, "Planck13") if kind == "potential"
        else jnp.zeros((), jnp.float32)))
    np.testing.assert_allclose(
        alpha.numpy(), np.asarray(jng._alpha_grid(shape, SPACING, "Planck13")),
        rtol=1e-6)
    got = ng._quadratic_ng(torch.as_tensor(g), fnl, shape, SPACING, kind,
                           alpha).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=FIELD_TOL * np.abs(want).max())


def test_generator_nongaussian_field():
    g = rft.Generator(16, 16, 16, grid_spacing=16.0, device="cpu")
    gauss = g.generate_delta_field(3, apply_lightcone=False)
    assert torch.equal(g.generate_nongaussian_field(3, 0.0), gauss)
    assert torch.equal(g.generate_nongaussian_field(3, 0.0, kind="potential"),
                       gauss)
    field = g.generate_nongaussian_field(3, 50.0, smoothing_length=4.0)
    base = g.generate_delta_field(3, smoothing_length=4.0,
                                  apply_lightcone=False)
    assert torch.equal(field, ng._quadratic_ng(base, 50.0, (16,) * 3, 16.0,
                                               "field", None))
    with pytest.raises(ValueError, match="kind"):
        g.generate_nongaussian_field(3, 1.0, kind="scalar")


@pytest.mark.parametrize("kind,fnl", [("field", 40.0), ("potential", 2e3)])
def test_predicted_ng_bispectrum_matches_jax(kind, fnl):
    shape, nbins = (16, 16, 16), 4
    power = rf.load_default_power()
    want = jng.predicted_ng_bispectrum(power, shape, SPACING, fnl, kind=kind,
                                       smoothing_length=3.0, nbins=nbins)
    got = ng.predicted_ng_bispectrum(power, shape, SPACING, fnl, kind=kind,
                                     smoothing_length=3.0, nbins=nbins,
                                     device="cpu")
    _assert_bispectra(got, want)


def test_generator_bispectrum_methods():
    g = rft.Generator(16, 16, 16, grid_spacing=SPACING, device="cpu")
    d = g.generate_nongaussian_field(1, 30.0)
    got = g.calculate_bispectrum(d, nbins=4)
    want = bisp.calculate_bispectrum(d, SPACING, nbins=4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    k, tri, bp, ntri = g.predicted_ng_bispectrum(30.0, nbins=4)
    np.testing.assert_array_equal(tri, got[1])
    np.testing.assert_allclose(ntri, got[3], rtol=1e-12)
    assert np.all(np.isfinite(bp))
    # a one-rank slab mesh is the single-device estimator; a pencil mesh
    # waits for item 5
    # (the slab transforms round apart from the one-device ones: B within
    # 1e-5 of the largest |B|, the triad counts within 1e-6)
    kc, tri, bm, nm = bisp.calculate_bispectrum(
        d, SPACING, nbins=4, mesh=pmesh.make_mesh(device="cpu"))
    np.testing.assert_array_equal(kc, want[0])
    np.testing.assert_array_equal(tri, want[1])
    assert np.abs(bm - want[2]).max() <= 1e-5 * np.abs(want[2]).max()
    np.testing.assert_allclose(nm, want[3], rtol=1e-6)
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        bisp.calculate_bispectrum(d, SPACING, mesh=pmesh.make_pencil_mesh(
            spx=2, spy=2))
