"""The port's peak statistics (validate/peaks.py, KX's plain version
ops/extrema.py) vs the JAX package's validate/peaks.py, on the same numpy
fields, and the JAX package's own gates on the port.

Bars: peak counts and totals exactly equal (the same float32 division u =
delta / sigma0 and the same comparisons); bbks_moments within 2e-3
(float64 sums here, float32 there: the sigma table's bar); the host BBKS
functions within 1e-12 (the same float64 numpy expressions).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.validate import peaks as jpk  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.ops import extrema  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import peaks as pk  # noqa: E402

MOMENT_RTOL = 2e-3


def _field(shape, seed, sm, spacing=4.0):
    g = rft.Generator(*shape, grid_spacing=spacing, device="cpu")
    return g.generate_delta_field(seed, smoothing_length=sm,
                                  apply_lightcone=False).numpy()


@pytest.mark.parametrize("shape,sm,nbins,band", [
    ((32, 32, 32), 8.0, 14, (-2.0, 5.0)), ((32, 16, 24), 0.0, 9, (-1.0, 3.0))])
def test_peak_statistics_match_jax(shape, sm, nbins, band):
    d = _field(shape, 2, sm)
    s0 = float(np.std(d))
    want = jpk.peak_statistics(jnp.asarray(d), 4.0, nbins, *band, sigma0=s0)
    got = pk.peak_statistics(torch.as_tensor(d), 4.0, nbins, *band, sigma0=s0)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1].dtype == np.int64 and got[2] == want[2] > 0


def test_plateaus_and_thin_axes_match_jax():
    """Ties (a quantized field: non-strict maxima on plateaus) and axes of
    1 and 2 cells (a voxel meets itself among its neighbours)."""
    rng = np.random.default_rng(4)
    for shape in ((12, 2, 9), (1, 8, 8), (8, 8, 8)):
        d = np.round(rng.standard_normal(shape) * 2).astype(np.float32)
        want = jpk.peak_statistics(jnp.asarray(d), 1.0, 6, -2.0, 3.0,
                                   sigma0=1.3)
        got = pk.peak_statistics(torch.as_tensor(d), 1.0, 6, -2.0, 3.0,
                                 sigma0=1.3)
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


def test_peak_mask_is_the_band_of_the_peaks():
    d = torch.as_tensor(_field((24, 24, 24), 5, 8.0))
    edges = np.linspace(-1.0, 3.0, 5)
    counts, total, mask = extrema.peak_counts(d, 0.2, edges, band=(0.5, 2.0))
    u = d / torch.tensor(0.2)
    peak = u == extrema.cube_max(u)
    assert int(total) == int(peak.sum())
    assert torch.equal(mask.bool(), peak & (u >= 0.5) & (u < 2.0))
    assert mask.dtype == torch.uint8


@pytest.mark.parametrize("smoothing,interpolation", [
    (14.0, "log10k"), (6.0, "loglog")])
def test_bbks_moments_match_jax(smoothing, interpolation):
    shape, spacing = (32, 24, 20), 4.0
    want = jpk.bbks_moments(rf.load_default_power(), shape, spacing,
                            smoothing, interpolation)
    got = pk.bbks_moments(rft.load_default_power(), shape, spacing, smoothing,
                          interpolation, device="cpu")
    np.testing.assert_allclose(got, want, rtol=MOMENT_RTOL)


def test_bbks_functions_match_jax():
    m = (0.3, 0.02, 0.004)
    nu = np.linspace(-3.0, 6.0, 37)
    np.testing.assert_allclose(pk.bbks_peak_density(nu, *m),
                               jpk.bbks_peak_density(nu, *m), rtol=1e-12)
    assert pk.bbks_total_density(*m) == pytest.approx(
        jpk.bbks_total_density(*m), rel=1e-12)
    edges = np.linspace(-2.0, 5.0, 15)
    for g, w in zip(pk.bbks_expected_counts(edges, 1e6, *m),
                    jpk.bbks_expected_counts(edges, 1e6, *m)):
        np.testing.assert_allclose(g, w, rtol=1e-12)


def test_generator_methods_match_jax():
    shape, spacing, sm = (32, 32, 32), 4.0, 10.0
    gj = rf.Generator(*shape, grid_spacing=spacing)
    gt = rft.Generator(*shape, grid_spacing=spacing, device="cpu")
    d = _field(shape, 6, sm)
    want = gj.calculate_peaks(jnp.asarray(d), sigma0=0.25)
    got = gt.calculate_peaks(torch.as_tensor(d), sigma0=0.25)
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2]
    pw, pg = (gj.predicted_peaks(smoothing_length=sm),
              gt.predicted_peaks(smoothing_length=sm))
    np.testing.assert_array_equal(pg[0], pw[0])
    np.testing.assert_allclose(pg[1], pw[1], rtol=MOMENT_RTOL)
    assert pg[2] == pytest.approx(pw[2], rel=MOMENT_RTOL)


def test_bbks_total_matches_closed_form():
    s0sq, s1sq, s2sq = 1.0, 2.0, 9.0
    nu = np.linspace(-8.0, 8.0, 3201)
    numeric = np.trapezoid(pk.bbks_peak_density(nu, s0sq, s1sq, s2sq), nu)
    np.testing.assert_allclose(numeric, pk.bbks_total_density(s0sq, s1sq,
                                                              s2sq), rtol=1e-9)


def test_bbks_curvature_weight_asymptotics():
    assert pk._f_curvature(0.0) == 0.0
    np.testing.assert_allclose(pk._f_curvature(6.0), 6.0**3 - 18.0,
                               rtol=1e-4)
    g = pk._G(0.7, np.array([0.0, 1.0, 3.0]))
    assert g[2] > g[1] > g[0] > 0


def test_peak_counts_gate():
    """The JAX package's gate at its settings: the mean total of 4 seeds
    within 10% of BBKS, each bin within 4 Poisson sigma + 12%."""
    n, sp, sm = 96, 4.0, 14.0
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    s0sq, _, _ = pk.bbks_moments(g.power, (n, n, n), sp, smoothing_length=sm,
                                 device="cpu")
    np.testing.assert_allclose(s0sq, g.predicted_variance(smoothing_length=sm),
                               rtol=1e-4)
    nu, exp_counts, exp_total = g.predicted_peaks(smoothing_length=sm)
    acc, totals = 0, []
    for s in range(4):
        d = g.generate_delta_field(s, smoothing_length=sm,
                                   apply_lightcone=False)
        nu_m, counts, total = g.calculate_peaks(d, sigma0=np.sqrt(s0sq))
        totals.append(total)
        acc = acc + counts
    np.testing.assert_allclose(nu_m, nu)
    assert abs(np.mean(totals) / exp_total - 1.0) < 0.10
    budget = 4.0 * np.sqrt(np.maximum(exp_counts, 1.0) / 4.0) \
        + 0.12 * exp_counts
    assert np.all(np.abs(acc / 4 - exp_counts) < budget)


def test_peak_statistics_defaults_and_units():
    n, sp = 32, 1.0
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    d = g.generate_delta_field(1, smoothing_length=6.0, apply_lightcone=False)
    nu, counts, total = g.calculate_peaks(d)
    assert counts.sum() <= total
    assert 0.0 < nu[np.argmax(counts)] < 3.0
    c = np.cos(2.0 * np.pi * 4.0 / n * np.arange(n))
    wave = (c[:, None, None] + c[None, :, None]
            + c[None, None, :]).astype(np.float32)
    assert pk.peak_statistics(torch.as_tensor(wave), sp, sigma0=1.0)[2] == 64


def test_mesh_raises():
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        pk.peak_statistics(torch.zeros((16, 16, 16)), 8.0, sigma0=1.0,
                           mesh=pmesh.make_mesh(space=1, device="cpu"))
