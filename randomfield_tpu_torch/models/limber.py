"""Limber angular power spectra C_ell from 3-D P(k) and radial kernels.

The box-level lensing stack (models/lensing.py) predicts and measures
flat-sky spectra of *renders*; survey analysis additionally needs the
continuum theory curve C_ell for arbitrary projected two-point
functions — galaxy clustering (gg), galaxy-galaxy lensing (g kappa) and
cosmic shear (kappa kappa).  This module evaluates the standard Limber
approximation

    C_ell^{AB} = Integral dchi  W_A(chi) W_B(chi) / f_K(chi)^2
                 * P( (ell + 1/2) / f_K(chi), z(chi) )

(first-order "extended Limber" wavenumber ell + 1/2) on the engine's
own background cosmology (models/cosmology.py — distances, growth), in
h-units throughout: chi and f_K in Mpc/h, k in h/Mpc, P in (Mpc/h)^3,
kernels W in (Mpc/h)^{-1}, so C_ell is dimensionless with no stray h.

Kernel builders return plain callables chi -> W(chi) (host float64):

- :func:`galaxy_kernel` — W = b(z) n(chi) with n the normalized radial
  selection from a tabulated n(z);
- :func:`source_plane_kernel` — the single-source-plane convergence
  kernel; EXACTLY the continuum limit of the discrete plane weights in
  models/lensing.py:lensing_efficiency (gated:
  W(chi_i) == w_i / dchi to rounding);
- :func:`nz_lensing_kernel` — the same integrated over a source
  distribution n(z).

Shear two-point functions xi_plus/minus(theta) come from the existing
FFTLog machinery (ops/fftlog.py) with J_0 / J_4 kernels.

Linear evolution P(k, z) = D(z)^2 P(k, 0) by default; pass
``power_of_z`` for an arbitrary (vectorized) P(k, z) — e.g. a halo-model
interpolator from models/halomodel.py.

Host-float64 analysis utilities (like ops/fftlog.py and
models/baofit.py): the integrals are tiny 1-D quadratures; nothing here
belongs on the card.

A host float64 copy of ``randomfield_tpu/models/limber.py`` that reads the
port's own modules (power table, cosmology, FFTLog); it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.models.cosmology import C_KM_S, create_cosmology
from randomfield_tpu_torch.ops import fftlog as _fftlog
from randomfield_tpu_torch.ops import power as _power

__all__ = [
    "galaxy_kernel",
    "source_plane_kernel",
    "nz_lensing_kernel",
    "limber_cl",
    "isw_galaxy_cl",
    "shear_correlation",
]


def _fk_h(cosmology, chi_h):
    """f_K(chi) in Mpc/h from chi in Mpc/h (curvature-correct)."""
    if cosmology.Ok0 == 0.0:
        return np.asarray(chi_h, np.float64)
    dh = cosmology.hubble_distance * cosmology.h  # Mpc/h
    sq = np.sqrt(abs(cosmology.Ok0))
    x = sq * np.asarray(chi_h, np.float64) / dh
    if cosmology.Ok0 > 0:
        return dh / sq * np.sinh(x)
    return dh / sq * np.sin(x)


def _z_of_chi_h(cosmology, chi_h):
    return cosmology.redshift_at_comoving_distance(
        np.asarray(chi_h, np.float64) / cosmology.h)


def _chi_h_of_z(cosmology, z):
    return cosmology.comoving_distance(z) * cosmology.h


_LENS_PREF = 1.5 / (C_KM_S / 100.0) ** 2  # (3/2) (H0/c)^2 in (Mpc/h)^-2 per Om0


def galaxy_kernel(cosmology, nz, bias=1.0):
    """Radial clustering kernel W_g(chi) = b(z(chi)) * n(chi).

    ``nz``: tabulated (z, dN/dz) with arbitrary normalization —
    internally converted to n(chi) = n(z) dz/dchi and normalized so
    Integral W dchi = mean bias over the selection (== b for scalar
    bias).  ``bias``: scalar or callable z -> b(z).  Returns
    ``(kernel, (chi_min, chi_max))`` with chi bounds in Mpc/h covering
    the selection's support.
    """
    cosmology = create_cosmology(cosmology)
    z_t = np.asarray(nz[0], np.float64)
    n_t = np.asarray(nz[1], np.float64)
    if z_t.ndim != 1 or z_t.shape != n_t.shape or z_t.size < 2:
        raise ValueError("nz must be two equal-length 1-D arrays")
    if np.any(np.diff(z_t) <= 0) or z_t[0] < 0:
        raise ValueError("nz redshifts must be non-negative and increasing")
    if np.any(n_t < 0) or not np.any(n_t > 0):
        raise ValueError("dN/dz must be non-negative and not all zero")
    chi_t = _chi_h_of_z(cosmology, z_t)
    # dz/dchi = H(z)/c in h-units: (100/c) E(z) per Mpc/h
    dz_dchi = cosmology.efunc(z_t) * (100.0 / C_KM_S)
    n_chi = n_t * dz_dchi
    norm = np.trapezoid(n_chi, chi_t)
    if norm <= 0:
        raise ValueError("n(z) selection has zero integral")
    n_chi = n_chi / norm

    def kernel(chi_h):
        chi_h = np.asarray(chi_h, np.float64)
        n = np.interp(chi_h, chi_t, n_chi, left=0.0, right=0.0)
        if callable(bias):
            return n * np.asarray(bias(_z_of_chi_h(cosmology, chi_h)),
                                  np.float64)
        return n * float(bias)

    return kernel, (float(chi_t[0]), float(chi_t[-1]))


def source_plane_kernel(cosmology, z_source):
    """Convergence kernel for a single source plane at ``z_source``:

        W_kappa(chi) = (3/2) Om0 (H0/c)^2 (1 + z) f_K(chi)
                       * f_K(chi_s - chi) / f_K(chi_s)

    in (Mpc/h)^-1.  The continuum limit of
    models/lensing.py:lensing_efficiency — W(chi_i) equals the discrete
    plane weight w_i / dchi exactly (gated in tests/test_limber.py).
    Returns ``(kernel, (0, chi_s))``.
    """
    cosmology = create_cosmology(cosmology)
    chi_s = float(_chi_h_of_z(cosmology, float(z_source)))
    if chi_s <= 0.0:
        raise ValueError(f"z_source={z_source} puts the source at the observer")
    fk_s = float(_fk_h(cosmology, chi_s))
    pref = _LENS_PREF * cosmology.Om0

    def kernel(chi_h):
        chi_h = np.asarray(chi_h, np.float64)
        z = _z_of_chi_h(cosmology, chi_h)
        w = (pref * (1.0 + z) * _fk_h(cosmology, chi_h)
             * _fk_h(cosmology, chi_s - chi_h) / fk_s)
        return np.where((chi_h > 0) & (chi_h < chi_s), w, 0.0)

    return kernel, (0.0, chi_s)


def nz_lensing_kernel(cosmology, nz, nsamp=256):
    """Convergence kernel for a source distribution: the
    :func:`source_plane_kernel` integrated over the normalized n(z).

    Evaluated by trapezoid over ``nsamp`` source planes spanning the
    tabulated range.  Returns ``(kernel, (0, chi_max))``.
    """
    cosmology = create_cosmology(cosmology)
    z_t = np.asarray(nz[0], np.float64)
    n_t = np.asarray(nz[1], np.float64)
    if z_t.ndim != 1 or z_t.shape != n_t.shape or z_t.size < 2:
        raise ValueError("nz must be two equal-length 1-D arrays")
    zs = np.linspace(max(z_t[0], 1e-4), z_t[-1], int(nsamp))
    ns = np.interp(zs, z_t, n_t, left=0.0, right=0.0)
    norm = np.trapezoid(ns, zs)
    if norm <= 0:
        raise ValueError("n(z) selection has zero integral")
    ns = ns / norm
    chi_src = _chi_h_of_z(cosmology, zs)
    fk_src = _fk_h(cosmology, chi_src)
    pref = _LENS_PREF * cosmology.Om0

    def kernel(chi_h):
        chi_h = np.atleast_1d(np.asarray(chi_h, np.float64))
        z = _z_of_chi_h(cosmology, chi_h)
        fk = _fk_h(cosmology, chi_h)
        # (nchi, nsrc) relative distances; zero weight for chi >= chi_s
        rel = _fk_h(cosmology, chi_src[None, :] - chi_h[:, None])
        frac = np.where(chi_src[None, :] > chi_h[:, None],
                        rel / fk_src[None, :], 0.0)
        g = np.trapezoid(ns[None, :] * frac, zs, axis=1)
        return pref * (1.0 + z) * fk * g

    return kernel, (0.0, float(chi_src[-1]))


def limber_cl(ells, power, cosmology=None, kernel1=None, kernel2=None,
              chi_range=None, nchi=1024, evolve=True, z_power=0.0,
              interpolation="log10k", power_of_z=None):
    """Limber C_ell for one or two radial kernels.

    ``ells``: array of multipoles (need not be integers).  ``power``:
    tabulated P(k) at z = ``z_power`` (k in h/Mpc, P in (Mpc/h)^3),
    interpolated like the render path (ops/power.py:interpolate_power;
    'loglog' is exact for power laws).  ``kernel1``/``kernel2``:
    callables chi_h -> W (from the builders above; kernel2 defaults to
    kernel1 for an auto-spectrum).  ``chi_range``: (chi_min, chi_max)
    in Mpc/h — pass the builder's returned range, intersected by the
    caller for cross-spectra.  ``evolve``: scale P by the linear growth
    (D(z(chi)) / D(z_power))^2 along the line of sight.
    ``power_of_z``: optional callable (k, z) -> P overriding table +
    growth entirely.

    Out-of-table wavenumbers (ell + 1/2)/f_K clamp to the table edges
    (ops/power.py:interpolate_power semantics) — size the table to
    cover [ (min ell)/chi_max, (max ell)/chi_min ].

    Quadrature: trapezoid over ``nchi`` uniform chi samples — exact
    convergence is the caller's knob; the power-law gate in
    tests/test_limber.py holds at 1e-4 with the default.  Modes with
    f_K(chi) = 0 (the observer) contribute zero.  Returns C_ell
    (same shape as ``ells``), float64.
    """
    cosmology = create_cosmology(cosmology)
    if kernel1 is None:
        raise ValueError("kernel1 is required")
    if kernel2 is None:
        kernel2 = kernel1
    if chi_range is None:
        raise ValueError("pass chi_range=(chi_min, chi_max) from the "
                         "kernel builder")
    lo, hi = float(chi_range[0]), float(chi_range[1])
    if not (hi > lo >= 0.0):
        raise ValueError(f"bad chi_range {chi_range}")
    ells = np.asarray(ells, np.float64)
    chi = np.linspace(lo, hi, int(nchi) + 1)  # f_K=0 samples masked below
    fk = _fk_h(cosmology, chi)
    w12 = np.asarray(kernel1(chi), np.float64) * np.asarray(
        kernel2(chi), np.float64)

    if power_of_z is None:
        table = _power.validate_power(power)

        def p_of(k, z):
            p = np.asarray(_power.interpolate_power(
                table, np.asarray(k, np.float32), interpolation), np.float64)
            if evolve:
                d = (cosmology.growth_function(z)
                     / cosmology.growth_function(float(z_power)))
                p = p * d * d
            return p
    else:
        def p_of(k, z):
            return np.asarray(power_of_z(k, z), np.float64)

    z = _z_of_chi_h(cosmology, chi)
    good = fk > 0
    integrand = np.zeros((ells.size, chi.size))
    kq = (ells[:, None] + 0.5) / np.where(good, fk, 1.0)[None, :]
    pk = p_of(kq.ravel(), np.broadcast_to(z, kq.shape).ravel())
    pk = pk.reshape(kq.shape)
    integrand[:, good] = (w12[None, good] / fk[None, good] ** 2
                          * pk[:, good])
    return np.trapezoid(integrand, chi, axis=1)


def isw_galaxy_cl(ells, power, cosmology, nz, bias=1.0, nchi=1024,
                  interpolation="log10k"):
    """ISW x galaxy cross spectrum C_ell^{Tg} (dimensionless DT/T).

    The integrated Sachs-Wolfe temperature anisotropy sources on the
    conformal-time derivative of the potential; through Poisson's
    equation and the Limber projection (the 1/k^2 absorbs into
    (ell + 1/2)^2):

        C_ell^{Tg} = 3 Om0 (H0/c)^2 / (ell + 1/2)^2
                     * Integral dchi  G'(chi) b(z) n(chi) D(z) P(k),

    k = (ell + 1/2)/f_K(chi), P the z = 0 table, growth normalized
    D(0) = 1, and G'(chi) = d[(1+z) D]/dchi evaluated ANALYTICALLY:

        G' = D(z) (1 - f(z)) (100/c) E(z)        [per Mpc/h]

    (dG/dz = D (1 - f) from f = dlnD/dlna, times dz/dchi = H/c) — so a
    pure-matter universe gives C == 0 EXACTLY (f = 1: the Einstein-de
    Sitter null gate in tests/test_limber.py), and an accelerating one
    gives C > 0 (decaying potentials).  Multiply by T_CMB to get muK.
    ``nz``/``bias`` as in :func:`galaxy_kernel`.  Returns C_ell (f64).
    """
    cosmology = create_cosmology(cosmology)
    kern_g, (lo, hi) = galaxy_kernel(cosmology, nz, bias)
    table = _power.validate_power(power)
    ells = np.asarray(ells, np.float64)
    chi = np.linspace(max(lo, 1e-6), hi, int(nchi) + 1)
    fk = _fk_h(cosmology, chi)
    z = _z_of_chi_h(cosmology, chi)
    d = cosmology.growth_function(z)
    f = cosmology.growth_rate(z)
    gprime = d * (1.0 - f) * (100.0 / C_KM_S) * cosmology.efunc(z)
    wg = np.asarray(kern_g(chi), np.float64)
    kq = (ells[:, None] + 0.5) / fk[None, :]
    pk = np.asarray(_power.interpolate_power(
        table, np.asarray(kq.ravel(), np.float32), interpolation),
        np.float64).reshape(kq.shape)
    integrand = (gprime * wg * d)[None, :] * pk
    pref = 3.0 * cosmology.Om0 * (100.0 / C_KM_S) ** 2 / (ells + 0.5) ** 2
    return pref * np.trapezoid(integrand, chi, axis=1)


def shear_correlation(ells, cl, n=2048, pad_decades=2.0, q=1.0,
                      theta_min=None, theta_max=None):
    """Shear two-point functions xi_plus/minus(theta) from C_ell:

        xi_+(theta) = Integral dl l C(l) J_0(l theta) / (2 pi)
        xi_-(theta) = Integral dl l C(l) J_4(l theta) / (2 pi)

    via FFTLog (ops/fftlog.py:fftlog_bessel_2d, mu = 0 / 4) with the
    C_ell table power-law padded like
    ops/fftlog.py:angular_correlation.  Returns ``(theta, xi_plus,
    xi_minus)`` with theta in radians, trimmed to the reciprocal
    interior of the tabulated ell range.
    """
    table = np.stack([np.asarray(ells, np.float64),
                      np.asarray(cl, np.float64)], axis=1)
    lg, cg = _fftlog._prep_power(table, n, pad_decades)
    # lowring=False: the low-ringing kr offset is mu-dependent and would
    # put xi_plus and xi_minus on different theta grids; the power-law
    # padded input keeps ringing negligible anyway (gated analytically).
    th, xp = _fftlog.fftlog_bessel_2d(lg, lg ** 2 * cg / (2.0 * np.pi),
                                      mu=0, q=q, lowring=False)
    th2, xm = _fftlog.fftlog_bessel_2d(lg, lg ** 2 * cg / (2.0 * np.pi),
                                       mu=4, q=q, lowring=False)
    if not np.allclose(th, th2, rtol=1e-12):
        raise AssertionError("FFTLog output grids diverged between mu=0/4")
    lo = 1.0 / table[-1, 0] if theta_min is None else float(theta_min)
    hi = 1.0 / table[0, 0] if theta_max is None else float(theta_max)
    keep = (th >= lo) & (th <= hi)
    return th[keep], xp[keep], xm[keep]
