"""The port's halofit (models/halofit.py) and ``power='halofit'`` vs the JAX
package's models/halofit.py, and the JAX package's own gates on the port.

Bars: halofit_terms, halofit_power and halofit_power_of_z within 1e-10
relative (the same float64 numpy expressions on both sides); the
Generator's halofit table the same.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

import randomfield_tpu as rf  # noqa: E402
from randomfield_tpu.models import halofit as jhf  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.models import halofit as hf  # noqa: E402
from randomfield_tpu_torch.models.cosmology import create_cosmology  # noqa: E402
from randomfield_tpu_torch.models.powerspec import resolve_power  # noqa: E402

HOST_RTOL = 1e-10


W0WA = {"H0": 70.0, "Om0": 0.3, "w0": -0.9, "wa": 0.2}


@pytest.mark.parametrize("z,cosmology,k", [
    (0.0, None, None), (0.7, "Planck13", np.geomspace(1e-3, 20.0, 40)),
    (0.0, W0WA, None)])
def test_halofit_terms_match_jax(z, cosmology, k):
    got = hf.halofit_terms(rft.load_default_power(), k=k, z=z,
                           cosmology=cosmology)
    want = jhf.halofit_terms(rf.load_default_power(), k=k, z=z,
                             cosmology=cosmology)
    for name in got._fields:
        np.testing.assert_allclose(getattr(got, name), getattr(want, name),
                                   rtol=HOST_RTOL, err_msg=name)


def test_background_of_a_cpl_cosmology_matches_jax():
    """Omega_m(z), Omega_de(z) and w(z) of the coefficient table: the port's
    cosmology's efunc, _de_density, w0 and wa."""
    from randomfield_tpu.models.cosmology import create_cosmology as jcc

    for z in (0.0, 0.5, 2.0):
        np.testing.assert_allclose(hf._background(create_cosmology(W0WA), z),
                                   jhf._background(jcc(W0WA), z),
                                   rtol=HOST_RTOL)


def test_halofit_power_of_z_and_table_match_jax():
    kq = np.geomspace(0.01, 2.0, 9)
    got = hf.halofit_power_of_z(rft.load_default_power(), z_max=3.0, nz=7)
    want = jhf.halofit_power_of_z(rf.load_default_power(), z_max=3.0, nz=7)
    for z in (0.0, 0.41, 3.0):
        np.testing.assert_allclose(got(kq, z), want(kq, z), rtol=HOST_RTOL)
    t = hf.halofit_power(rft.load_default_power(), z=1.0, cosmology="Planck13")
    w = jhf.halofit_power(rf.load_default_power(), z=1.0, cosmology="Planck13")
    np.testing.assert_array_equal(t.k, w.k)
    np.testing.assert_allclose(t.Pk, w.Pk, rtol=HOST_RTOL)


def test_named_halofit_power_matches_jax():
    got = resolve_power("halofit", "Planck13")
    want = rf.Generator(16, 16, 16, grid_spacing=8.0, power="halofit").power
    np.testing.assert_allclose(got.Pk, np.asarray(want.Pk), rtol=HOST_RTOL)
    g = rft.Generator(16, 16, 16, grid_spacing=8.0, power="halofit",
                      device="cpu")
    np.testing.assert_allclose(g.power.Pk, np.asarray(want.Pk),
                               rtol=HOST_RTOL)


def _power_law(amp, n, kmin=1e-3, kmax=1e2, npts=512):
    k = np.geomspace(kmin, kmax, npts)
    return k, amp * k**n


def test_power_law_nonlinear_scale_exact():
    r_sigma = 3.0
    amp = r_sigma * 4.0 * math.pi**2 / math.sqrt(math.pi)
    res = hf.halofit_terms(_power_law(amp, -2.0))
    assert res.k_sigma == pytest.approx(1.0 / r_sigma, rel=2e-4)
    assert res.n_eff == pytest.approx(-2.0, abs=2e-4)
    assert res.curvature == pytest.approx(0.0, abs=2e-3)
    amp = 7.0
    r_sigma = (amp * math.gamma(0.75) / (4.0 * math.pi**2)) ** (1.0 / 1.5)
    res = hf.halofit_terms(_power_law(amp, -1.5))
    assert res.k_sigma == pytest.approx(1.0 / r_sigma, rel=2e-4)
    assert res.n_eff == pytest.approx(-1.5, abs=2e-4)


def test_limits_and_enhancement():
    p = rft.load_default_power()
    res = hf.halofit_terms(p, k=np.array([1e-3, 3e-3]))
    np.testing.assert_allclose(res.p_nl / res.p_lin,
                               np.exp(-res.k / (4.0 * res.k_sigma)),
                               rtol=5e-4)
    res = hf.halofit_terms(p)
    np.testing.assert_allclose(res.p_nl, res.p_q + res.p_h, rtol=1e-12)
    assert 0.1 < res.k_sigma < 1.0
    assert 3.0 < np.interp(1.0, res.k, res.p_nl / res.p_lin) < 10.0
    cosmo = create_cosmology()
    r2 = hf.halofit_terms(p, z=2.0, cosmology=cosmo)
    assert r2.k_sigma > 2.0 * res.k_sigma
    np.testing.assert_allclose(
        r2.p_lin, res.p_lin * float(cosmo.growth_function(2.0)) ** 2,
        rtol=1e-10)
    with pytest.raises(ValueError):
        hf.halofit_terms(p, z=1.0)


def test_named_halofit_power_renders():
    g_lin = rft.Generator(16, 16, 16, grid_spacing=8.0, power="eh98",
                          device="cpu")
    g_nl = rft.Generator(16, 16, 16, grid_spacing=8.0, power="halofit",
                         device="cpu")
    v_nl = float(g_nl.predicted_variance())
    assert v_nl > 1.05 * float(g_lin.predicted_variance())
    d = g_nl.generate_delta_field(0, apply_lightcone=False).numpy()
    assert np.isfinite(d).all()
    assert abs(d.var() / v_nl - 1.0) < 0.3
