"""Halofit nonlinear P(k): the Takahashi (2012) recalibration.

Port of ``randomfield_tpu/models/halofit.py``, host float64 numpy with the
same expressions: the Smith et al. (2003) functional form with the
Takahashi et al. (2012) coefficients (arXiv:1208.2701 eqs. A1-A22) split

    Delta^2_NL(k) = Delta^2_Q(k) + Delta^2_H(k),

the quasi-linear term

    Delta^2_Q = Delta^2_L [(1 + Delta^2_L)^beta / (1 + alpha
                Delta^2_L)] exp(-y/4 - y^2/8),   y = k / k_sigma,

and the one-halo term

    Delta^2_H = a y^{3 f1} / (1 + b y^{f2} + (c f3 y)^{3 - gamma})
                / (1 + mu/y + nu/y^2),

with k_sigma the scale of the Gaussian-filtered sigma^2(R = 1/k_sigma) = 1,
n_eff = -3 - dln sigma^2/dln R and C = -d^2 ln sigma^2 / dln R^2 setting
the coefficients, and Omega_m(z), Omega_de(z) (1 + w(z)) of the CPL
background (:mod:`.cosmology`) carrying the cosmology.  ``power='halofit'``
of :func:`.powerspec.resolve_power` is :func:`halofit_power` of the
cosmology's EH98 table.
"""

from __future__ import annotations

import typing

import numpy as np

from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops.fftlog import log_grid, resample_loglog
from randomfield_tpu_torch.ops.power import PowerTable, validate_power

__all__ = ["HalofitResult", "halofit_terms", "halofit_power",
           "halofit_power_of_z"]


class HalofitResult(typing.NamedTuple):
    """Halofit decomposition at wavenumbers ``k`` [h/Mpc]."""

    k: np.ndarray
    p_lin: np.ndarray     # growth-scaled linear input
    p_q: np.ndarray       # quasi-linear (two-halo-like) term
    p_h: np.ndarray       # one-halo term
    p_nl: np.ndarray      # total nonlinear power
    k_sigma: float        # nonlinear scale [h/Mpc]
    n_eff: float
    curvature: float      # C


def _gaussian_sigma2(lnk, d2l, ln_r):
    """sigma^2(R) with a Gaussian filter, plus d/dlnR and d^2/dlnR^2
    of ln sigma^2, by log-trapezoid over the tabulated Delta^2_L."""
    k = np.exp(lnk)
    r = np.exp(ln_r)
    x2 = (k * r) ** 2
    w = np.exp(-x2)
    s2 = np.trapezoid(d2l * w, lnk)
    ds2 = np.trapezoid(d2l * w * (-2.0 * x2), lnk)
    d2s2 = np.trapezoid(d2l * w * (4.0 * x2 * x2 - 4.0 * x2), lnk)
    dln = ds2 / s2
    d2ln = d2s2 / s2 - dln * dln
    return s2, dln, d2ln


def _solve_nonlinear_scale(lnk, d2l):
    """ln R_sigma with sigma^2(R_sigma) = 1 by bisection (sigma^2 is
    monotone decreasing in R for any non-negative Delta^2)."""
    lo, hi = np.log(1e-4), np.log(1e3)
    s_lo = _gaussian_sigma2(lnk, d2l, lo)[0]
    s_hi = _gaussian_sigma2(lnk, d2l, hi)[0]
    if not (s_hi < 1.0 < s_lo):
        raise ValueError(
            f"nonlinear scale not bracketed: sigma^2 in [{s_hi:.3e}, "
            f"{s_lo:.3e}] over R in [1e-4, 1e3] Mpc/h — the input power "
            "is too low (or too high) for halofit's sigma(R)=1 definition")
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _gaussian_sigma2(lnk, d2l, mid)[0] > 1.0:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _background(cosmology, z):
    """(Omega_m(z), Omega_de(z), w(z)) for the coefficient table."""
    zp1 = 1.0 + float(z)
    a = 1.0 / zp1
    e2 = float(cosmology.efunc(z)) ** 2
    om = cosmology.Om0 * zp1**3 / e2
    ode = cosmology.Ode0 * float(cosmology._de_density(a)) / e2
    w = cosmology.w0 + cosmology.wa * (1.0 - a)
    return om, ode, w


def halofit_terms(power, k=None, z=0.0, cosmology=None, n_grid=4096,
                  pad_decades=3.0):
    """Takahashi-halofit decomposition of a z=0 linear P(k) table.

    With ``z`` and a ``cosmology`` the table is growth-scaled by
    D(z)^2 first (the spt/irresum convention) and the coefficient
    table uses Omega_m(z), Omega_de(z), w(z).  Returns a
    :class:`HalofitResult` at ``k`` (default: the table's k column).
    """
    k_t, p_t = validate_power(power)
    z = float(z)
    if z != 0.0 and cosmology is None:
        raise ValueError("scaling to z != 0 requires a cosmology")
    cosmology = create_cosmology(cosmology)
    if z != 0.0:
        d = float(cosmology.growth_function(z))
        p_t = p_t * d * d
    if k is None:
        k = k_t
    k = np.atleast_1d(np.asarray(k, np.float64))
    if np.any(k <= 0):
        raise ValueError("wavenumbers must be positive")

    # Untapered end-slope power-law extension (unlike FFTLog's
    # _prep_power, whose cos^2 taper right at the table edge biases
    # sigma^2 by ~5e-4): the Gaussian filter converges the high-k tail
    # and any n > -3 low-k slope converges on its own.
    kg = log_grid(k_t[0] * 10.0 ** (-pad_decades),
                  k_t[-1] * 10.0 ** (pad_decades), n_grid)
    pg = resample_loglog(k_t, p_t, kg)
    lnk = np.log(kg)
    d2l_grid = kg**3 * pg / (2.0 * np.pi**2)

    ln_r = _solve_nonlinear_scale(lnk, d2l_grid)
    s2, dln, d2ln = _gaussian_sigma2(lnk, d2l_grid, ln_r)
    k_sigma = float(np.exp(-ln_r))
    n_eff = -3.0 - dln
    c_curv = -d2ln

    om, ode, w = _background(cosmology, z)
    n, c = n_eff, c_curv
    a_n = 10.0 ** (1.5222 + 2.8553 * n + 2.3706 * n**2 + 0.9903 * n**3
                   + 0.2250 * n**4 - 0.6038 * c + 0.1749 * ode * (1.0 + w))
    b_n = 10.0 ** (-0.5642 + 0.5864 * n + 0.5716 * n**2 - 1.5474 * c
                   + 0.2279 * ode * (1.0 + w))
    c_n = 10.0 ** (0.3698 + 2.0404 * n + 0.8161 * n**2 + 0.5869 * c)
    gamma_n = 0.1971 - 0.0843 * n + 0.8460 * c
    alpha_n = abs(6.0835 + 1.3373 * n - 0.1959 * n**2 - 5.5274 * c)
    beta_n = (2.0379 - 0.7354 * n + 0.3157 * n**2 + 1.2490 * n**3
              + 0.3980 * n**4 - 0.1682 * c)
    mu_n = 0.0
    nu_n = 10.0 ** (5.2105 + 3.6902 * n)
    f1 = om ** -0.0307
    f2 = om ** -0.0585
    f3 = om ** 0.0743

    # interpolate the (growth-scaled) linear power onto the output k
    p_lin = np.exp(np.interp(np.log(k), lnk, np.log(np.maximum(pg, 1e-300))))
    d2l = k**3 * p_lin / (2.0 * np.pi**2)
    y = k / k_sigma

    fy = y / 4.0 + y**2 / 8.0
    d2q = d2l * ((1.0 + d2l) ** beta_n / (1.0 + alpha_n * d2l)) * np.exp(-fy)
    d2h_prime = (a_n * y ** (3.0 * f1)
                 / (1.0 + b_n * y**f2 + (c_n * f3 * y) ** (3.0 - gamma_n)))
    d2h = d2h_prime / (1.0 + mu_n / y + nu_n / y**2)

    two_pi2_k3 = 2.0 * np.pi**2 / k**3
    return HalofitResult(
        k=k, p_lin=p_lin, p_q=d2q * two_pi2_k3, p_h=d2h * two_pi2_k3,
        p_nl=(d2q + d2h) * two_pi2_k3, k_sigma=k_sigma, n_eff=float(n_eff),
        curvature=float(c_curv))


def halofit_power(power, k=None, z=0.0, cosmology=None, **kw) -> PowerTable:
    """Nonlinear P(k) as a :class:`PowerTable` (feedable to the
    Generator / LognormalGenerator for nonlinear-spectrum mocks)."""
    res = halofit_terms(power, k=k, z=z, cosmology=cosmology, **kw)
    return PowerTable(np.asarray(res.k), np.asarray(res.p_nl))


def halofit_power_of_z(power, cosmology=None, z_max=5.0, nz=33, k=None,
                       **kw):
    """Callable ``(k, z) -> P_NL(k, z)`` for nonlinear Limber spectra.

    Precomputes the halofit nonlinear power on an (nz, nk) table —
    z uniform on [0, z_max], k defaulting to the input table's column —
    and returns an elementwise bilinear interpolator in (z, ln k) of
    ln P_NL.  Out-of-range k clamps to the table edges (the
    ops/power.py:interpolate_power convention Limber documents); z
    clamps to [0, z_max].  Plug straight into
    ``models.limber.limber_cl(..., power_of_z=...)`` for nonlinear
    lensing / clustering C_ell.
    """
    cosmology = create_cosmology(cosmology)
    k_t, p_t = validate_power(power)
    if k is None:
        k = k_t
    k = np.atleast_1d(np.asarray(k, np.float64))
    zs = np.linspace(0.0, float(z_max), int(nz))
    if zs.size < 2:
        raise ValueError("need nz >= 2 redshift nodes")
    rows = [halofit_terms((k_t, p_t), k=k, z=z, cosmology=cosmology, **kw)
            .p_nl for z in zs]
    ln_p = np.log(np.maximum(np.stack(rows), 1e-300))
    ln_k = np.log(k)
    nk = k.size

    def p_of(kq, zq):
        kq = np.atleast_1d(np.asarray(kq, np.float64))
        zq = np.broadcast_to(np.asarray(zq, np.float64), kq.shape)
        lq = np.clip(np.log(kq), ln_k[0], ln_k[-1])
        zc = np.clip(zq, zs[0], zs[-1])
        ik = np.clip(np.searchsorted(ln_k, lq) - 1, 0, nk - 2)
        iz = np.clip(np.searchsorted(zs, zc) - 1, 0, zs.size - 2)
        tk = (lq - ln_k[ik]) / (ln_k[ik + 1] - ln_k[ik])
        tz = (zc - zs[iz]) / (zs[iz + 1] - zs[iz])
        v = ((1 - tz) * ((1 - tk) * ln_p[iz, ik] + tk * ln_p[iz, ik + 1])
             + tz * ((1 - tk) * ln_p[iz + 1, ik]
                     + tk * ln_p[iz + 1, ik + 1]))
        return np.exp(v)

    return p_of
