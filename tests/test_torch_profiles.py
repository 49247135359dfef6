"""The port's stacked profiles (validate/profiles.py) vs the JAX package's
validate/profiles.py, on the same numpy fields, and the JAX package's own
gates on the port.

Bars: the stacked and peak profiles within 1e-5 of the profile's maximum
and their cell counts exactly (the same cross power through two float32
FFT libraries, the same float32 separations and edges); the peak count
exactly (KX's plain version: the same u and comparisons); nu_bar and x_bar
within 1e-5 (float64 sums here, float32 there); predicted_peak_profile
within 1e-4 of its maximum (the moments summed in float32 there enter
through 1 / (1 - gamma^2)); mean_height_in_band within 1e-6 (float32 erf
there).
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
from randomfield_tpu.validate import profiles as jpf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from randomfield_tpu_torch.validate import peaks as pk  # noqa: E402
from randomfield_tpu_torch.validate import profiles as pf  # noqa: E402

PROFILE_TOL = 1e-5
PREDICTED_TOL = 1e-4


def _field(shape, seed, sm, spacing=4.0):
    g = rft.Generator(*shape, grid_spacing=spacing, device="cpu")
    return g.generate_delta_field(seed, smoothing_length=sm,
                                  apply_lightcone=False).numpy()


def _assert_profile(got, want, tol=PROFILE_TOL):
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    live = ~np.isnan(w)
    np.testing.assert_allclose(g[live], w[live], rtol=0,
                               atol=tol * np.abs(w[live]).max())


def test_stacked_profile_matches_jax():
    shape, sp = (32, 24, 20), 4.0
    d = _field(shape, 1, 8.0)
    u = d / d.std()
    w = ((u >= 0.5) & (u < 1.5)).astype(np.float32)
    want = jpf.stacked_profile(jnp.asarray(d), jnp.asarray(w), sp, nbins=10)
    got = pf.stacked_profile(torch.as_tensor(d), torch.as_tensor(w), sp,
                             nbins=10)
    np.testing.assert_array_equal(got[2], want[2])
    _assert_profile(got[0], want[0], 1e-6)
    _assert_profile(got[1], want[1])


def test_peak_profile_matches_jax():
    shape, sp, sm = (32, 32, 32), 4.0, 8.0
    d = _field(shape, 3, sm)
    mom = jpk.bbks_moments(rf.load_default_power(), shape, sp, sm)
    for band in ((0.0, 2.0),):
        want = jpf.peak_profile(jnp.asarray(d), sp, mom, *band, nbins=12)
        got = pf.peak_profile(torch.as_tensor(d), sp, mom, *band, nbins=12)
        _assert_profile(got[1], want[1])
        assert got[2] == want[2] > 0
        assert got[3] == pytest.approx(want[3], rel=PROFILE_TOL)
        assert got[4] == pytest.approx(want[4], rel=PROFILE_TOL)


def test_predicted_peak_profile_matches_jax():
    shape, sp, sm = (32, 32, 32), 4.0, 8.0
    for x_bar in (None, 1.2):
        want = jpf.predicted_peak_profile(rf.load_default_power(), shape, sp,
                                          1.4, x_bar, smoothing_length=sm,
                                          nbins=12)
        got = pf.predicted_peak_profile(rft.load_default_power(), shape, sp,
                                        1.4, x_bar, smoothing_length=sm,
                                        nbins=12, device="cpu")
        _assert_profile(got[0], want[0], 1e-6)
        _assert_profile(got[1], want[1], PREDICTED_TOL)


def test_generator_methods_match_jax():
    shape, sp, sm = (32, 32, 32), 4.0, 8.0
    gj = rf.Generator(*shape, grid_spacing=sp)
    gt = rft.Generator(*shape, grid_spacing=sp, device="cpu")
    d = _field(shape, 4, sm)
    want = gj.calculate_peak_profile(jnp.asarray(d), nu_min=0.5, nbins=10,
                                     smoothing_length=sm)
    got = gt.calculate_peak_profile(torch.as_tensor(d), nu_min=0.5, nbins=10,
                                    smoothing_length=sm)
    assert got[2] == want[2]
    _assert_profile(got[1], want[1])
    w = (d > 0).astype(np.float32)
    _assert_profile(gt.calculate_stacked_profile(torch.as_tensor(d),
                                                 torch.as_tensor(w), 10)[1],
                    gj.calculate_stacked_profile(jnp.asarray(d),
                                                 jnp.asarray(w), 10)[1])
    _assert_profile(gt.predicted_peak_profile(1.3, 0.9, 10, sm)[1],
                    gj.predicted_peak_profile(1.3, 0.9, 10, sm)[1],
                    PREDICTED_TOL)


def test_mean_height_in_band_matches_jax():
    for band in ((0.0, None), (-1.0, 1.0), (1.0, 1.5), (2.0, None)):
        assert pf.mean_height_in_band(*band) == pytest.approx(
            jpf.mean_height_in_band(*band), rel=1e-6, abs=1e-9)
    np.testing.assert_allclose(pf.mean_height_in_band(0.0),
                               np.sqrt(2.0 / np.pi), rtol=1e-12)


def test_stacked_profile_matches_bruteforce():
    rng = np.random.default_rng(0)
    n, sp, nbins = 12, 2.0, 5
    d = rng.normal(size=(n, n, n)).astype(np.float32)
    w = np.zeros_like(d)
    w[3, 7, 5] = 1.0
    r, prof, counts = pf.stacked_profile(torch.as_tensor(d),
                                         torch.as_tensor(w), sp, nbins=nbins)
    dc = d - d.mean()
    ax = np.minimum(np.arange(n), n - np.arange(n)) * sp
    rmag = np.sqrt((ax**2)[:, None, None] + (ax**2)[None, :, None]
                   + (ax**2)[None, None, :])
    shifted = np.roll(dc, (-3, -7, -5), axis=(0, 1, 2))
    edges = np.linspace(0.0, 0.5 * n * sp, nbins + 1)
    for b in range(nbins):
        sel = (rmag > edges[b]) & (rmag <= edges[b + 1]) & (rmag > 0)
        if sel.any():
            np.testing.assert_allclose(prof[b], shifted[sel].mean(),
                                       rtol=2e-4, atol=1e-6)
            assert counts[b] == sel.sum()


def test_stacked_profile_validation_errors():
    d = torch.zeros((8, 8, 8))
    with pytest.raises(ValueError):
        pf.stacked_profile(d, torch.zeros((4, 4, 4)), 1.0)
    with pytest.raises(ValueError):
        pf.stacked_profile(d, torch.zeros_like(d), 1.0)
    with pytest.raises(NotImplementedError, match="Queue 1 item 8"):
        pf.stacked_profile(d, d, 1.0,
                           mesh=pmesh.make_mesh(space=1, device="cpu"))


def test_value_selected_profile_exact_gate():
    """The JAX package's gate at its settings (16 seeds at 64^3)."""
    n, sp, sm, nbins = 64, 4.0, 10.0, 16
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    mom = pk.bbks_moments(g.power, (n, n, n), sp, smoothing_length=sm,
                          device="cpu")
    s0 = np.sqrt(mom[0])
    acc, nus = 0.0, []
    for s in range(16):
        d = g.generate_delta_field(s, smoothing_length=sm,
                                   apply_lightcone=False)
        u = d.numpy() / s0
        mask = ((u >= 1.0) & (u < 1.5)).astype(np.float32)
        r, prof, _ = pf.stacked_profile(d, torch.as_tensor(mask), sp,
                                        nbins=nbins)
        nus.append(float((u * mask).sum() / mask.sum()))
        acc = acc + prof
    prof = acc / 16
    nu_bar = float(np.mean(nus))
    assert 1.0 < nu_bar < 1.5
    rp, pred = pf.predicted_peak_profile(g.power, (n, n, n), sp, nu_bar,
                                         smoothing_length=sm, nbins=nbins,
                                         device="cpu")
    np.testing.assert_allclose(r, rp)
    assert np.abs(prof - pred).max() / s0 < 0.012
    assert prof[0] > 0.8 * nu_bar * s0
    assert prof[0] > prof[3] > prof[6]


def test_peak_profile_curvature_gate():
    """The JAX package's gate at its settings (8 seeds at 64^3): the BBKS
    profile with the curvature term, which is load-bearing."""
    n, sp, sm, nbins = 64, 4.0, 10.0, 16
    g = rft.Generator(n, n, n, grid_spacing=sp, device="cpu")
    mom = pk.bbks_moments(g.power, (n, n, n), sp, smoothing_length=sm,
                          device="cpu")
    s0 = np.sqrt(mom[0])
    acc, tot, nu_w, x_w = 0.0, 0, 0.0, 0.0
    for s in range(8):
        d = g.generate_delta_field(s, smoothing_length=sm,
                                   apply_lightcone=False)
        r, prof, npk, nub, xbb = pf.peak_profile(d, sp, mom, nu_min=1.0,
                                                 nbins=nbins)
        acc = acc + prof * npk
        nu_w += nub * npk
        x_w += xbb * npk
        tot += npk
    prof = acc / tot
    nu_bar, x_bar = nu_w / tot, x_w / tot
    assert tot > 300 and nu_bar > 1.0 and x_bar > 0.0
    _, pred = pf.predicted_peak_profile(g.power, (n, n, n), sp, nu_bar, x_bar,
                                        smoothing_length=sm, nbins=nbins,
                                        device="cpu")
    _, pred_nox = pf.predicted_peak_profile(g.power, (n, n, n), sp, nu_bar,
                                            smoothing_length=sm, nbins=nbins,
                                            device="cpu")
    assert np.abs(prof - pred).max() / s0 < 0.04
    sh = slice(1, 5)
    assert (np.abs(prof[sh] - pred_nox[sh]).max()
            > 5.0 * np.abs(prof[sh] - pred[sh]).max())
