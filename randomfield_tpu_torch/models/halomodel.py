"""Halo-model nonlinear power spectrum: P(k) = P_1h(k) + P_2h(k).

The analytic counterpart of the halo mocks in models/halos.py (the
reference package is linear-theory only; this module predicts the
NONLINEAR matter spectrum from the same mass-function + bias
ingredients, Seljak 2000 / Peacock & Smith 2000 / Cooray & Sheth 2002):

    P_1h(k) = Integral dlnM  (dn/dlnM) (M / rho_m)^2  |u(k|M)|^2
    P_2h(k) = [ Integral dlnM (dn/dlnM) b(M) (M / rho_m) u(k|M) ]^2 P_lin

with u(k|M) the normalized Fourier transform of the NFW profile
(analytic, via sine/cosine integrals), concentration from the Duffy et
al. 2008 relation, and the standard large-scale counter-term that
assigns the mass fraction below the integration range the bias of the
lowest sampled mass — making P_2h(k -> 0) = P_lin EXACTLY when that
bias -> 1 (the PS/ST all-mass constraints asserted in
tests/test_halos.py; the residual mismatch for a finite mass range is
gated in tests/test_halomodel.py).

Host float64 (theory curves — same tier as models/massfunction.py);
the device-side counterpart is measuring halo mocks with
validate/stats.py.

A host float64 copy of ``randomfield_tpu/models/halomodel.py`` that reads the
port's own modules (power table, cosmology, FFTLog); it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.models import massfunction as _mf
from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops import power as _power

__all__ = [
    "concentration",
    "nfw_profile_fourier",
    "halo_model_power",
]


def concentration(m, z=0.0, relation="duffy08"):
    """Concentration c(M, z) for the mean-density Delta=200 definition.

    ``'duffy08'`` — Duffy et al. 2008 (full-sample, 200 x mean):
    ``c = 10.14 (M / 2e12)^-0.081 (1+z)^-1.01``.  Masses in Msun/h.
    """
    m = np.asarray(m, np.float64)
    if relation == "duffy08":
        return 10.14 * (m / 2e12) ** (-0.081) * (1.0 + z) ** (-1.01)
    raise ValueError(f"unknown concentration relation {relation!r}")


def _sici(x):
    from scipy.special import sici

    return sici(x)


def nfw_profile_fourier(k, m, cosmology="Planck13", z=0.0,
                        relation="duffy08", delta=200.0):
    """Normalized NFW Fourier profile u(k | M), shape (nk, nm).

    ``u(k) = [sin(kr_s)(Si((1+c)kr_s) - Si(kr_s))
             + cos(kr_s)(Ci((1+c)kr_s) - Ci(kr_s))
             - sin(c kr_s)/((1+c)kr_s)] / [ln(1+c) - c/(1+c)]``

    with r_s = r_Delta / c and r_Delta the radius enclosing
    ``delta`` x mean matter density.  u(k -> 0) = 1 (mass
    normalization) — asserted in tests.
    """
    c_cosmo = create_cosmology(cosmology)
    rho_m = c_cosmo.Om0 * c_cosmo.critical_density0 / c_cosmo.h**2
    k = np.atleast_1d(np.asarray(k, np.float64))
    m = np.atleast_1d(np.asarray(m, np.float64))
    c = concentration(m, z=z, relation=relation)
    r_delta = (3.0 * m / (4.0 * np.pi * float(delta) * rho_m)) ** (1.0 / 3.0)
    r_s = r_delta / c

    x = k[:, None] * r_s[None, :]          # (nk, nm)
    cx = c[None, :]
    si_hi, ci_hi = _sici((1.0 + cx) * x)
    si_lo, ci_lo = _sici(x)
    norm = np.log1p(cx) - cx / (1.0 + cx)
    u = (
        np.sin(x) * (si_hi - si_lo)
        + np.cos(x) * (ci_hi - ci_lo)
        - np.sin(cx * x) / ((1.0 + cx) * x)
    ) / norm
    return np.where(x > 0, u, 1.0)


def halo_model_power(power, k=None, cosmology="Planck13", z=0.0, fit="st",
                     mmin=1e4, mmax=1e17, nm=256, relation="duffy08"):
    """Halo-model P(k): returns ``(k, p_total, p_1h, p_2h)``.

    ``power`` is the LINEAR table (z=0); redshift enters through
    sigma(M, z) and D(z)^2 P_lin.  ``k`` defaults to the table's range.
    The mass integrals run over log-uniform masses [``mmin``,
    ``mmax``] Msun/h with the standard counter-term for the mass
    fraction outside the range (assigned b(M_min), u = 1), so
    ``p_2h(k -> 0) / P_lin -> [f_covered + (1 - f_covered)]^2 = 1`` up
    to the fit's own all-mass accuracy.
    """
    c_cosmo = create_cosmology(cosmology)
    table = _power.validate_power(power)
    if k is None:
        k = np.geomspace(table.k[0] * 1.001, table.k[-1] * 0.999, 256)
    k = np.atleast_1d(np.asarray(k, np.float64))
    d = float(c_cosmo.growth_function(z))
    p_lin = d * d * np.interp(np.log10(k), np.log10(table.k), table.Pk)

    rho_m = c_cosmo.Om0 * c_cosmo.critical_density0 / c_cosmo.h**2
    m = np.geomspace(float(mmin), float(mmax), int(nm))
    lnm = np.log(m)
    _, dn = _mf.mass_function(table, m, c_cosmo, z=z, fit=fit)
    bias_fit = {"ps": "ps", "st": "st", "tinker08": "tinker10"}[fit] \
        if fit in ("ps", "st", "tinker08") else fit
    _, b = _mf.halo_bias(table, m, c_cosmo, z=z, fit=bias_fit)
    u = nfw_profile_fourier(k, m, c_cosmo, z=z, relation=relation)

    w = (m / rho_m) * dn                    # mass-fraction weight per lnM
    p_1h = np.trapezoid(w[None, :] * (m / rho_m)[None, :] * u * u,
                        lnm, axis=1)
    i_2h = np.trapezoid(w[None, :] * b[None, :] * u, lnm, axis=1)
    # counter-term: mass outside [mmin, mmax] carries b(mmin), u = 1
    f_cov = np.trapezoid(w, lnm)
    i_2h = i_2h + (1.0 - f_cov) * b[0]
    p_2h = i_2h**2 * p_lin
    return k, p_1h + p_2h, p_1h, p_2h
