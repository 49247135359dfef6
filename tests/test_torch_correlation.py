"""The port's correlation functions, one-point statistics, the rest of
ops/grid.py, ops/power.py and ops/transform.py vs the JAX package, on the
same numpy arrays.

Bars: xi, xi_ell and w_p within 1e-5 of max|xi| (the same float32 power
grid through two float32 inverse FFTs; counts exact: the same float32
separations against the same float32 edges); the PDF's counts exactly and
its bin means within 1e-6; cell variances within 1e-6 (float64 sums here,
axis-wise float32 means there); the host-numpy functions (sigma_r, sigma8,
normalize_power and the theory transforms) within 1e-10; interpolate_power
within 1e-6 (float32 in both), 3e-6 for 'loglog' (10^x of a float32
exponent: an ulp of log10 P is ln 10 ulps of P); the transforms within
1e-6 of their peak (float32 FFTs of two libraries).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.ops import grid as jgrid  # noqa: E402
from randomfield_tpu.ops import power as jpower  # noqa: E402
from randomfield_tpu.ops import transform as jtransform  # noqa: E402
from randomfield_tpu.validate import stats as jstats  # noqa: E402
from randomfield_tpu_torch.ops import grid, power, transform  # noqa: E402
from randomfield_tpu_torch.validate import stats  # noqa: E402

SPACING = 8.0
SHAPE = (16, 12, 10)
NBINS = 6
XI_TOL = 1e-5
HOST_RTOL = 1e-10


def _field(shape=SHAPE, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_xi(got, want):
    r, x, n = (np.asarray(a, np.float64) for a in got)
    rw, xw, nw = (np.asarray(a, np.float64) for a in want)
    np.testing.assert_array_equal(n, nw)
    live = nw > 0
    assert live.sum() >= 3
    np.testing.assert_allclose(x[..., live], xw[..., live], rtol=0,
                               atol=XI_TOL * np.abs(xw[..., live]).max())
    np.testing.assert_allclose(r[live], rw[live], rtol=1e-6)


CASES = {
    "xi": lambda m, d: m.calculate_correlation(d, SPACING, NBINS),
    "xi_ell": lambda m, d: m.calculate_correlation_multipoles(
        d, SPACING, NBINS),
    "xi_ell_x": lambda m, d: m.calculate_correlation_multipoles(
        d, SPACING, NBINS, ells=(2,), los_axis=0),
    "wp": lambda m, d: m.calculate_projected_correlation(d, SPACING, NBINS),
    "wp_y": lambda m, d: m.calculate_projected_correlation(
        d, SPACING, NBINS, pi_max=20.0, los_axis=1),
}
# the port's predictions take device="cpu" here (**kw)
PREDICTIONS = {
    "xi": lambda m, p, **kw: m.predicted_correlation(p, SHAPE, SPACING,
                                                     NBINS, **kw),
    "xi_ell_kaiser": lambda m, p, **kw: m.predicted_correlation_multipoles(
        p, SHAPE, SPACING, f=0.6, nbins=NBINS, los_axis=1, **kw),
    "wp_kaiser": lambda m, p, **kw: m.predicted_projected_correlation(
        p, SHAPE, SPACING, f=0.6, nbins=NBINS, **kw),
    "wp_loglog": lambda m, p, **kw: m.predicted_projected_correlation(
        p, SHAPE, SPACING, nbins=NBINS, pi_max=30.0, los_axis=0,
        interpolation="loglog", **kw),
}


@pytest.fixture(scope="module")
def jax_results():
    d = jnp.asarray(_field())
    out = {name: fn(jstats, d) for name, fn in CASES.items()}
    p = rf.load_default_power()
    out.update({("pred", name): fn(jstats, p)
                for name, fn in PREDICTIONS.items()})
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_correlation_matches_jax(jax_results, name):
    _assert_xi(CASES[name](stats, torch.as_tensor(_field())),
               jax_results[name])


@pytest.mark.parametrize("name", list(PREDICTIONS))
def test_predicted_correlation_matches_jax(jax_results, name):
    _assert_xi(PREDICTIONS[name](stats, rf.load_default_power(),
                                 device="cpu"),
               jax_results["pred", name])


def test_xi_monopole_is_the_correlation():
    t = torch.as_tensor(_field(seed=3))
    r, x, n = stats.calculate_correlation(t, SPACING, NBINS)
    r0, x0, n0 = stats.calculate_correlation_multipoles(t, SPACING, NBINS,
                                                        ells=(0,))
    np.testing.assert_array_equal(n, n0)
    np.testing.assert_array_equal(x, x0[0])


def test_field_pdf_and_cell_variance_match_jax():
    d = _field((16, 16, 16), 4)
    c, dens, cnt = stats.field_pdf(torch.as_tensor(d), 16)
    cw, densw, cntw = jstats.field_pdf(jnp.asarray(d), 16)
    np.testing.assert_array_equal(cnt, cntw)
    np.testing.assert_allclose(dens, densw, rtol=1e-12)
    live = cntw > 0
    np.testing.assert_allclose(c[live], cw[live], rtol=1e-6, atol=1e-6)
    c, dens, cnt = stats.field_pdf(torch.as_tensor(d), 10, vmin=-1.0,
                                   vmax=float(d.max()))
    _, _, cntw = jstats.field_pdf(jnp.asarray(d), 10, vmin=-1.0,
                                  vmax=float(d.max()))
    np.testing.assert_array_equal(cnt, cntw)
    for m in (1, 2, 4):
        np.testing.assert_allclose(stats.cell_variance(torch.as_tensor(d), m),
                                   jstats.cell_variance(jnp.asarray(d), m),
                                   rtol=1e-6, atol=1e-7)
    p = rf.load_default_power()
    for m in (1, 2):
        np.testing.assert_allclose(
            stats.predicted_cell_variance(p, (16, 16, 16), SPACING, m,
                                          device="cpu"),
            jstats.predicted_cell_variance(p, (16, 16, 16), SPACING, m),
            rtol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        stats.cell_variance(torch.as_tensor(d), 3)


def test_host_power_functions_match_jax():
    p = rf.load_default_power()
    r = np.array([0.5, 8.0, 40.0, 105.0])
    for got, want in (
            (power.sigma_r(p, 12.0, 0.8), jpower.sigma_r(p, 12.0, 0.8)),
            (power.sigma8(p), jpower.sigma8(p)),
            (power.normalize_power(p, 0.7).Pk,
             jpower.normalize_power(p, 0.7).Pk),
            (power.power_to_correlation(p, r, n=2048),
             jpower.power_to_correlation(p, r, n=2048)),
            (power.power_to_correlation(p, 30.0, n=1024, kmax=1.0),
             jpower.power_to_correlation(p, 30.0, n=1024, kmax=1.0)),
            (power.power_to_correlation_multipoles(p, r, f=0.6, n=2048),
             jpower.power_to_correlation_multipoles(p, r, f=0.6, n=2048)),
            (power.power_to_projected_correlation(p, r[1:3], 40.0, f=0.5,
                                                  n=1024, npi=33),
             jpower.power_to_projected_correlation(p, r[1:3], 40.0, f=0.5,
                                                   n=1024, npi=33)),
            (power.power_to_projected_correlation(p, 8.0, 40.0, n=1024,
                                                  npi=33),
             jpower.power_to_projected_correlation(p, 8.0, 40.0, n=1024,
                                                   npi=33))):
        np.testing.assert_allclose(got, want, rtol=HOST_RTOL, atol=0)
    with pytest.raises(ValueError, match="ell=1"):
        power.power_to_correlation_multipoles(p, r, ells=(1,))


@pytest.mark.parametrize("interpolation,rtol", [("log10k", 1e-6),
                                                ("loglog", 3e-6)])
def test_interpolate_power_and_grid_match_jax(interpolation, rtol):
    p = rf.load_default_power()
    k = np.concatenate([[0.0, 1e-9], np.geomspace(1e-3, 5.0, 200), [1e3]])
    got = power.interpolate_power(p, torch.as_tensor(k, dtype=torch.float32),
                                  interpolation).numpy()
    want = np.asarray(jpower.interpolate_power(
        p, jnp.asarray(k, jnp.float32), interpolation))
    np.testing.assert_allclose(got, want, rtol=rtol)
    assert grid.half_shape((8, 6, 9)) == jgrid.half_shape((8, 6, 9))
    for dtype, jdtype in ((torch.float32, jnp.float32),):
        np.testing.assert_allclose(
            grid.fill_with_log10k(SHAPE, SPACING, dtype).numpy(),
            np.asarray(jgrid.fill_with_log10k(SHAPE, SPACING, jdtype)),
            rtol=1e-6)
    assert power.get_k_bounds(SHAPE, SPACING) == jpower.get_k_bounds(
        SHAPE, SPACING)


def test_transforms_match_jax():
    d = _field(SHAPE, 5)
    c = transform.field_to_spectrum(torch.as_tensor(d), SPACING)
    cw = np.asarray(jtransform.field_to_spectrum(jnp.asarray(d), SPACING))
    assert c.dtype == torch.complex64
    np.testing.assert_allclose(c.numpy(), cw, rtol=0,
                               atol=1e-6 * np.abs(cw).max())
    back = transform.spectrum_to_field(c, SPACING, SHAPE).numpy()
    np.testing.assert_allclose(back, d, rtol=0, atol=1e-5 * np.abs(d).max())
    rng = np.random.default_rng(6)
    raw = (rng.normal(size=(8, 6, 5)) + 1j * rng.normal(size=(8, 6, 5))
           ).astype(np.complex64)
    for scale in (True, False):
        got = transform.symmetrize(torch.as_tensor(raw), scale).numpy()
        want = np.asarray(jtransform.symmetrize(jnp.asarray(raw), scale))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        transform.spectrum_to_field(torch.as_tensor(np.array(want)), 4.0,
                                    (8, 6, 8)).numpy(),
        np.asarray(jtransform.spectrum_to_field(jnp.asarray(want), 4.0,
                                                (8, 6, 8))),
        rtol=0, atol=1e-6)
