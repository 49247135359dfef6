"""Halo mass functions from sigma(M): Press-Schechter, Sheth-Tormen,
Tinker.

The classic downstream consumer of sigma(R) (ops/power.py — the
reference tabulates sigma(R) only for sigma8 normalization; abundance
forecasting is added capability): the comoving number density of
collapsed halos per log mass,

    dn/dlnM = (rho_m / M) f(sigma) |dln sigma^{-1} / dln M|,

with sigma(M, z) = D(z) sigma(R_L(M)) the top-hat rms on the Lagrangian
scale R_L = (3 M / 4 pi rho_m)^{1/3} and f(sigma) the multiplicity
function.  Exact invariants pin the implementation: the
Press-Schechter multiplicity integrates to EXACTLY one over
dln sigma^{-1} (all mass in halos — the famous factor of 2), so
integral M (dn/dM) dM = rho_m — asserted numerically in the tests.

Units follow the power table: masses in Msun/h, comoving densities in
(Msun/h)/(Mpc/h)^3 — in which rho_m = Om0 * 2.775e11 independent of h.

Host float64 (tiny integrals over the table — no device work; the
device-side counterpart the measurement chain offers is peak abundance,
validate/peaks.py).

A host float64 copy of ``randomfield_tpu/models/massfunction.py`` that reads the
port's own modules (power table, cosmology, FFTLog); it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops import power as _power

__all__ = [
    "DELTA_C",
    "lagrangian_radius",
    "sigma_m",
    "multiplicity",
    "mass_function",
    "bias_nu",
    "halo_bias",
]

#: Spherical-collapse critical overdensity (EdS value; the standard
#: choice for LCDM mass functions — the fits below were calibrated
#: against simulations with this constant).
DELTA_C = 1.686


def _rho_m_comoving(cosmology):
    """Comoving matter density in (Msun/h) / (Mpc/h)^3."""
    c = create_cosmology(cosmology)
    return c.Om0 * c.critical_density0 / c.h**2


def lagrangian_radius(m, cosmology="Planck13"):
    """Comoving top-hat radius R_L(M) [Mpc/h] enclosing mass M [Msun/h]."""
    rho = _rho_m_comoving(cosmology)
    m = np.asarray(m, np.float64)
    return (3.0 * m / (4.0 * np.pi * rho)) ** (1.0 / 3.0)


def sigma_m(power, m, cosmology="Planck13", z=0.0):
    """sigma(M, z): top-hat rms on the Lagrangian scale of M, grown to z.

    ``sigma_m(power, M(R=8)) == sigma8(power)`` exactly by construction.
    """
    c = create_cosmology(cosmology)
    d = float(c.growth_function(z))
    m = np.atleast_1d(np.asarray(m, np.float64))
    r = lagrangian_radius(m, c)
    out = np.array([_power.sigma_r(power, float(ri)) for ri in r])
    return d * out


def multiplicity(sigma, fit="st"):
    """Multiplicity f(sigma): the mass fraction per dln sigma^{-1}.

    * ``'ps'`` — Press & Schechter 1974 (with the factor 2):
      sqrt(2/pi) nu exp(-nu^2/2), nu = delta_c / sigma.  Integrates to
      exactly 1: all mass is in halos.
    * ``'st'`` — Sheth & Tormen 1999 (A=0.3222, a=0.707, p=0.3):
      ellipsoidal-collapse correction, more high-mass halos.
    * ``'tinker08'`` — Tinker et al. 2008, Delta = 200 x mean
      (A=0.186, a=1.47, b=2.57, c=1.19), z=0 calibration.
    """
    s = np.asarray(sigma, np.float64)
    nu = DELTA_C / s
    if fit == "ps":
        return np.sqrt(2.0 / np.pi) * nu * np.exp(-0.5 * nu * nu)
    if fit == "st":
        a_st, big_a, p = 0.707, 0.3222, 0.3
        anu2 = a_st * nu * nu
        return (
            big_a * np.sqrt(2.0 * a_st / np.pi) * nu
            * (1.0 + anu2 ** (-p)) * np.exp(-0.5 * anu2)
        )
    if fit == "tinker08":
        big_a, a_t, b_t, c_t = 0.186, 1.47, 2.57, 1.19
        return big_a * ((s / b_t) ** (-a_t) + 1.0) * np.exp(-c_t / (s * s))
    raise ValueError(f"unknown mass-function fit {fit!r}; "
                     "use 'ps', 'st' or 'tinker08'")


def mass_function(power, m, cosmology="Planck13", z=0.0, fit="st"):
    """dn/dlnM [(Mpc/h)^-3 per ln mass] at masses ``m`` [Msun/h].

    ``dn/dlnM = (rho_m / M) f(sigma) dln sigma^{-1}/dln M`` with the
    log-derivative taken by central finite difference of the exact
    sigma(R_L(M)) integral (the integrand is smooth in ln M; step
    1e-3).  Returns ``(sigma, dn_dlnM)`` so callers can reuse the
    sigma(M, z) values (e.g. to locate M*, where sigma = delta_c).
    """
    c = create_cosmology(cosmology)
    rho = _rho_m_comoving(c)
    m = np.atleast_1d(np.asarray(m, np.float64))
    if np.any(m <= 0):
        raise ValueError("masses must be positive")
    eps = 1e-3
    s_mid = sigma_m(power, m, c, z=z)
    s_lo = sigma_m(power, m * np.exp(-eps), c, z=z)
    s_hi = sigma_m(power, m * np.exp(eps), c, z=z)
    # dln sigma^{-1}/dln M = -dln sigma/dln M  (positive: sigma falls)
    dlnsinv_dlnm = -(np.log(s_hi) - np.log(s_lo)) / (2.0 * eps)
    f = multiplicity(s_mid, fit=fit)
    return s_mid, (rho / m) * f * dlnsinv_dlnm


def bias_nu(nu, fit="st"):
    """Linear halo bias b(nu), nu = delta_c / sigma(M, z).

    * ``'ps'`` — peak-background split of Press-Schechter (Mo & White
      1996): ``b = 1 + (nu^2 - 1)/delta_c``.  Satisfies the exact
      all-mass constraint ``Integral f_PS(nu) b_PS(nu) dln nu = 1``
      (matter is unbiased against itself) — asserted in tests.
    * ``'st'`` — peak-background split of the Sheth-Tormen
      multiplicity (Sheth & Tormen 1999 eq. 12, a=0.707, p=0.3):
      ``b = 1 + (a nu^2 - 1)/delta_c + 2p / (delta_c [1 + (a nu^2)^p])``.
      Satisfies the same constraint against f_ST.
    * ``'tinker10'`` — Tinker et al. 2010 (table 2, Delta = 200 x
      mean), the simulation-calibrated companion of the 'tinker08'
      mass function: ``b = 1 - A nu^a/(nu^a + delta_c^a) + B nu^b
      + C nu^c`` with y = log10(200).
    """
    nu = np.asarray(nu, np.float64)
    if fit == "ps":
        return 1.0 + (nu * nu - 1.0) / DELTA_C
    if fit == "st":
        a_st, p = 0.707, 0.3
        anu2 = a_st * nu * nu
        return (
            1.0
            + (anu2 - 1.0) / DELTA_C
            + 2.0 * p / (DELTA_C * (1.0 + anu2**p))
        )
    if fit in ("tinker10", "tinker08"):  # bias companion of tinker08
        y = np.log10(200.0)
        expy = np.exp(-((4.0 / y) ** 4))
        big_a = 1.0 + 0.24 * y * expy
        a_t = 0.44 * y - 0.88
        big_b, b_t = 0.183, 1.5
        big_c = 0.019 + 0.107 * y + 0.19 * expy
        c_t = 2.4
        nua = nu**a_t
        return (
            1.0
            - big_a * nua / (nua + DELTA_C**a_t)
            + big_b * nu**b_t
            + big_c * nu**c_t
        )
    raise ValueError(f"unknown bias fit {fit!r}; "
                     "use 'ps', 'st' or 'tinker10'")


def halo_bias(power, m, cosmology="Planck13", z=0.0, fit="st"):
    """Linear halo bias b(M, z) [dimensionless] at masses ``m`` [Msun/h].

    Peak-background split / calibrated fits (see :func:`bias_nu`)
    evaluated at ``nu = delta_c / sigma(M, z)`` with the same exact
    sigma(R_L(M)) integral as :func:`mass_function` — the two are a
    consistent pair for abundance-and-clustering mocks
    (models/halos.py).  Returns ``(sigma, b)``.
    """
    s = sigma_m(power, m, cosmology, z=z)
    return s, bias_nu(DELTA_C / s, fit=fit)
