"""The port's host float64 models (models/streaming.py, massfunction.py,
halomodel.py, limber.py, ssc.py, baofit.py) vs the JAX package's, on the
same inputs.

Bar: within 1e-10 of the largest value of each output (the same float64
numpy on the same tables).  ``limber_cl`` and ``isw_galaxy_cl`` are held
within 1e-6: both packages interpolate P in float32 at float32 k, as the
JAX package's ``interpolate_power`` does, and torch's float32 log10 and
XLA's differ by an ulp at some k.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu.models import baofit as jbao  # noqa: E402
from randomfield_tpu.models import halomodel as jhm  # noqa: E402
from randomfield_tpu.models import limber as jlim  # noqa: E402
from randomfield_tpu.models import massfunction as jmf  # noqa: E402
from randomfield_tpu.models import ssc as jssc  # noqa: E402
from randomfield_tpu.models import streaming as jst  # noqa: E402
from randomfield_tpu.models.cosmology import create_cosmology as jcosmo  # noqa: E402
import randomfield_tpu_torch as rft  # noqa: E402
from randomfield_tpu_torch.models import baofit, halomodel, limber  # noqa: E402
from randomfield_tpu_torch.models import massfunction, ssc, streaming  # noqa: E402
from randomfield_tpu_torch.models.cosmology import create_cosmology  # noqa: E402

BAR = 1e-10
# limber_cl and isw_galaxy_cl: P interpolated in float32 on both sides
BAR_FLOAT32_P = 1e-6
POWER = rft.load_default_power()


def _close(got, want, bar=BAR):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], bar)
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _close(a, b, bar)
        return
    if callable(want):
        return
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert g.shape == w.shape
    scale = max(float(np.abs(w).max()), 1e-300) if w.size else 1.0
    assert float(np.abs(g - w).max(initial=0.0)) <= bar * scale


@pytest.mark.parametrize("fit", ["ps", "st", "tinker08"])
def test_mass_function_and_bias_match_jax(fit):
    m = np.geomspace(1e10, 3e15, 25)
    for z in (0.0, 0.7):
        _close(massfunction.mass_function(POWER, m, "Planck15", z, fit),
               jmf.mass_function(POWER, m, "Planck15", z, fit))
        bfit = "tinker10" if fit == "tinker08" else fit
        _close(massfunction.halo_bias(POWER, m, "Planck13", z, bfit),
               jmf.halo_bias(POWER, m, "Planck13", z, bfit))
    _close(massfunction.sigma_m(POWER, m, z=0.3), jmf.sigma_m(POWER, m, z=0.3))
    _close(massfunction.lagrangian_radius(m), jmf.lagrangian_radius(m))


def test_halo_model_matches_jax():
    k = np.geomspace(0.01, 5.0, 30)
    _close(halomodel.halo_model_power(POWER, k, z=0.5),
           jhm.halo_model_power(POWER, k, z=0.5))
    m = np.geomspace(1e12, 1e15, 4)
    _close(halomodel.nfw_profile_fourier(k, m), jhm.nfw_profile_fourier(k, m))
    _close(halomodel.concentration(m, 1.0), jhm.concentration(m, 1.0))


def test_streaming_model_matches_jax():
    s = np.linspace(20.0, 120.0, 6)
    _close(streaming.pairwise_dispersions(POWER, s, f=0.6, n=1024),
           jst.pairwise_dispersions(POWER, s, f=0.6, n=1024))
    _close(streaming.kaiser_correlation_multipoles(POWER, s, 0.7, bias=1.5,
                                                   n=1024),
           jst.kaiser_correlation_multipoles(POWER, s, 0.7, bias=1.5, n=1024))
    kw = dict(cosmology="Planck15", z=0.5, bias=1.3, sigma_fog=3.0, n=1024,
              n_mu=16, n_y=601)
    _close(streaming.streaming_multipoles(POWER, s, **kw),
           jst.streaming_multipoles(POWER, s, **kw))
    ing = streaming.streaming_ingredients(POWER, n=1024)
    _close(streaming.streaming_xi_smu(ing, s, 0.4, n_y=401),
           jst.streaming_xi_smu(jst.streaming_ingredients(POWER, n=1024), s,
                                0.4, n_y=401))
    fn = lambda ss, mm: np.cos(mm) * ss  # noqa: E731
    _close(streaming.multipoles_from_xi_smu(fn, s),
           jst.multipoles_from_xi_smu(fn, s))
    assert streaming.StreamingIngredients._fields == \
        jst.StreamingIngredients._fields


def test_limber_matches_jax():
    ells = np.array([10.0, 50.0, 200.0, 800.0])
    zz = np.linspace(0.01, 2.0, 80)
    nz = np.exp(-((zz - 0.7) / 0.25) ** 2)
    cos, jc = create_cosmology("Planck13"), jcosmo("Planck13")
    kg, rg = limber.galaxy_kernel(cos, (zz, nz), bias=1.4)
    jkg, jrg = jlim.galaxy_kernel(jc, (zz, nz), bias=1.4)
    kl, rl = limber.nz_lensing_kernel(cos, (zz, nz), nsamp=64)
    jkl, jrl = jlim.nz_lensing_kernel(jc, (zz, nz), nsamp=64)
    ks, rs = limber.source_plane_kernel(cos, 1.2)
    jks, jrs = jlim.source_plane_kernel(jc, 1.2)
    chi = np.linspace(100.0, 3000.0, 50)
    for a, b in ((kg, jkg), (kl, jkl), (ks, jks)):
        _close(a(chi), b(chi))
    _close((rg, rl, rs), (jrg, jrl, jrs))
    _close(limber.limber_cl(ells, POWER, cos, kernel1=kg, kernel2=kl,
                            chi_range=rg, nchi=256),
           jlim.limber_cl(ells, POWER, jc, kernel1=jkg, kernel2=jkl,
                          chi_range=jrg, nchi=256), BAR_FLOAT32_P)
    _close(limber.isw_galaxy_cl(ells, POWER, cos, (zz, nz), nchi=256),
           jlim.isw_galaxy_cl(ells, POWER, jc, (zz, nz), nchi=256),
           BAR_FLOAT32_P)
    el = np.geomspace(1.0, 1e5, 400)
    cl = 1e-9 * (el / 100.0) ** -1.2
    _close(limber.shear_correlation(el, cl, n=1024),
           jlim.shear_correlation(el, cl, n=1024))


def test_ssc_matches_jax():
    k = np.geomspace(0.01, 0.5, 20)
    _close(ssc.power_response(POWER, k), jssc.power_response(POWER, k))
    _close(ssc.sigma_b_tophat(POWER, 300.0), jssc.sigma_b_tophat(POWER, 300.0))
    mask = np.zeros((16, 16, 16))
    mask[:8, :10, 3:12] = 1.0
    _close(ssc.sigma_b_from_mask(mask, 20.0, POWER),
           jssc.sigma_b_from_mask(mask, 20.0, POWER))
    _close(ssc.ssc_covariance(POWER, k, 0.02),
           jssc.ssc_covariance(POWER, k, 0.02))


def test_bao_fits_match_jax():
    k = np.geomspace(0.02, 0.3, 30)
    data = 1.7 * np.interp(np.log10(k / 1.03), np.log10(POWER.k), POWER.Pk)
    data = data + 100.0 / k - 250.0
    sigma = 0.03 * data
    _close(baofit.fit_bao_scale(k, data, sigma=sigma),
           jbao.fit_bao_scale(k, data, sigma=sigma))
    nodes, wts = np.polynomial.legendre.leggauss(24)
    nodes, wts = 0.5 * (nodes + 1.0), 0.5 * wts
    model = 2.0 * jbao._ap_model_multipoles(POWER, k, 1.04, 0.97, 0.35,
                                            (0, 2), nodes, wts)
    _close(baofit._ap_model_multipoles(POWER, k, 1.04, 0.97, 0.35, (0, 2),
                                       nodes, wts), model / 2.0)
    kw = dict(ells=(0, 2), beta=0.35, alpha_par_range=(0.95, 1.1),
              alpha_perp_range=(0.9, 1.05), n_alpha=15)
    _close(baofit.fit_bao_scale_ap(k, model, **kw),
           jbao.fit_bao_scale_ap(k, model, **kw))
