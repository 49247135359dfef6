"""Gaussian streaming model: theory xi_s(s, mu) and multipoles from P(k).

The redshift-space correlation function of the streaming model (Peebles
1980 eq. 76.8; Fisher 1995; Reid & White 2011) maps the real-space
clustering and the pairwise line-of-sight velocity PDF onto xi_s:

    1 + xi_s(s_perp, s_par) =
        Int dy [1 + xi_gg(r)] N(s_par - y - mu_r v12(r); sigma2(r, mu_r))

with r = sqrt(s_perp^2 + y^2), mu_r = y / r, N a unit-normalized
Gaussian pdf, v12(r) the mean pairwise (infall) velocity and

    sigma2(r, mu) = mu^2 sigma_par^2(r) + (1 - mu^2) sigma_perp^2(r)

the line-of-sight projection of the pairwise dispersion tensor.  All
velocity quantities here are in DISPLACEMENT units (comoving Mpc/h,
i.e. v / (a H / h)), so the streaming integral needs no unit
conversions; multiply by `validate.velocity._velocity_prefactor / f`
to recover km/s.

Linear-theory ingredients (potential flow u_k = i f delta_k k / k^2,
the engine's own velocity kernel, ops/derived.py:delta_to_velocity):

    Psi_perp(r) = (f^2 / 6 pi^2) Int dk P(k) [j0(kr) + j2(kr)]
    Psi_par(r)  = (f^2 / 6 pi^2) Int dk P(k) [j0(kr) - 2 j2(kr)]
    sigma_v^2   = (f^2 / 6 pi^2) Int dk P(k)          (1-D dispersion)
    sigma_par^2(r)  = 2 [sigma_v^2 - Psi_par(r)]
    sigma_perp^2(r) = 2 [sigma_v^2 - Psi_perp(r)]
    psi_r(r)    = -(f / 2 pi^2) Int dk k P(k) j1(kr)
    v12(r)      = 2 b psi_r(r) / (1 + b^2 xi(r))

(the j1(x)/x = (j0 + j2)/3 identity turns both Psi integrals into two
FFTLog calls).  Expanded to first order in P, the streaming integral
reduces exactly to the Kaiser multipoles (Fisher 1995 eq. 26) — the
sharpest correctness gate this module has (tests/test_streaming.py
checks the epsilon -> 0 limit converges to
:func:`kaiser_correlation_multipoles` at first order).

Scope note: the 2015 reference package generates Gaussian fields and
has no RSD theory layer at all; this module is capability expansion on
the framework side (SURVEY.md section 0 classifies clustering theory as
out-of-reference additions), pairing with the measured-side estimators
(validate/stats.py:calculate_correlation_multipoles, models/hod.py RSD
catalogs, validate/velocity.py v12).  Like models/spt.py and
models/irresum.py this is host-side float64 numpy: 1-D theory
quadratures are latency-bound scalar work, not device work.

A host float64 copy of ``randomfield_tpu/models/streaming.py`` that reads
the port's own modules (power table, cosmology, FFTLog); it imports no JAX.
"""

from __future__ import annotations

import typing

import numpy as np

from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops.fftlog import (
    _prep_power, fftlog_bessel, xi_from_power,
)
from randomfield_tpu_torch.ops.power import validate_power

__all__ = [
    "velocity_correlations",
    "pairwise_dispersions",
    "kaiser_correlation_multipoles",
    "StreamingIngredients",
    "streaming_ingredients",
    "streaming_xi_smu",
    "streaming_multipoles",
    "multipoles_from_xi_smu",
]


def _growth_scaled_table(power, z, cosmology):
    """(k, P D(z)^2) from a z=0 table — the spt/irresum convention."""
    k_t, p_t = validate_power(power)
    z = float(z)
    if z != 0.0:
        if cosmology is None:
            raise ValueError("scaling to z != 0 requires a cosmology")
        d = float(create_cosmology(cosmology).growth_function(z))
        p_t = p_t * d * d
    return k_t, p_t


def velocity_correlations(power, r, f=1.0, n=2048, pad_decades=3.0):
    """Linear velocity correlation functions in displacement units.

    Returns ``(psi_par, psi_perp, sigma_v2)`` at separations ``r``
    [Mpc/h]: the parallel/transverse velocity autocorrelations and the
    1-D dispersion, each in (Mpc/h)^2 and carrying the f^2 factor.
    ``power`` is the linear P(k) at the epoch of interest.
    """
    r = np.atleast_1d(np.asarray(r, np.float64))
    if np.any(r <= 0):
        raise ValueError("separations must be positive")
    kg, pg = _prep_power(power, n, pad_decades)
    # Int dk P j_ell(kr) = Int dk/k (k P) j_ell(kr)
    r0, g0 = fftlog_bessel(kg, kg * pg, ell=0, q=1.0)
    r2, g2 = fftlog_bessel(kg, kg * pg, ell=2, q=1.0)
    i0 = np.interp(r, r0, g0)
    i2 = np.interp(r, r2, g2)
    pref = float(f) ** 2 / (6.0 * np.pi**2)
    psi_par = pref * (i0 - 2.0 * i2)
    psi_perp = pref * (i0 + i2)
    sigma_v2 = pref * np.trapezoid(kg * pg, np.log(kg))
    return psi_par, psi_perp, float(sigma_v2)


def pairwise_dispersions(power, r, f=1.0, n=2048, pad_decades=3.0):
    """Linear pairwise dispersions sigma_par^2(r), sigma_perp^2(r)
    [(Mpc/h)^2, displacement units]: 2 [sigma_v^2 - Psi(r)], clipped at
    zero (FFTLog ringing can leave ~1e-6 sigma_v^2 negatives as r->0).
    """
    psi_par, psi_perp, sv2 = velocity_correlations(
        power, r, f=f, n=n, pad_decades=pad_decades)
    return (np.clip(2.0 * (sv2 - psi_par), 0.0, None),
            np.clip(2.0 * (sv2 - psi_perp), 0.0, None))


def kaiser_correlation_multipoles(power, s, f, bias=1.0, ells=(0, 2, 4),
                                  n=2048, pad_decades=3.0):
    """Linear Kaiser xi_ell(s): i^ell/(2 pi^2) Int dk k^2 P_ell j_ell(ks)
    with P_ell = b^2 c_ell(beta) P, beta = f/b, and the standard
    coefficients c_0 = 1 + 2 beta/3 + beta^2/5, c_2 = 4 beta/3 +
    4 beta^2/7, c_4 = 8 beta^2/35.  Returns ``{ell: xi_ell(s)}``.
    """
    s = np.atleast_1d(np.asarray(s, np.float64))
    beta = float(f) / float(bias)
    coeff = {
        0: 1.0 + 2.0 * beta / 3.0 + beta**2 / 5.0,
        2: 4.0 * beta / 3.0 + 4.0 * beta**2 / 7.0,
        4: 8.0 * beta**2 / 35.0,
    }
    out = {}
    for ell in ells:
        if ell not in coeff:
            raise ValueError(f"Kaiser multipoles exist for ell in (0, 2, 4); got {ell}")
        rg, xg = xi_from_power(power, ell=ell, n=n, pad_decades=pad_decades,
                               rmin=0.5 * s.min(), rmax=2.0 * s.max() + 1.0)
        out[ell] = float(bias) ** 2 * coeff[ell] * np.interp(s, rg, xg)
    return out


class StreamingIngredients(typing.NamedTuple):
    """Callable ingredients of the streaming integral, each a function
    of the real-space pair separation r [Mpc/h]; velocities in
    displacement units.  Build from linear theory with
    :func:`streaming_ingredients`, or construct directly (e.g. with
    analytic functions) to test or extend the model."""

    xi: typing.Callable          # real-space xi_gg(r) (bias included)
    v12: typing.Callable         # mean pairwise LOS-projectable velocity
    sigma_par2: typing.Callable  # pairwise dispersion along r
    sigma_perp2: typing.Callable  # pairwise dispersion transverse to r
    rmax: float                  # trusted separation range (for spans)


def streaming_ingredients(power, cosmology=None, z=0.0, bias=1.0,
                          sigma_fog=0.0, f=None, n=2048, pad_decades=3.0):
    """Linear-theory :class:`StreamingIngredients` from a z=0 P(k) table.

    ``f`` defaults to the cosmology's growth rate at ``z``;
    ``sigma_fog`` [Mpc/h] is an isotropic small-scale dispersion added
    in quadrature (the Fingers-of-God knob, same role as models/hod.py's
    satellite dispersion).  Tabulates xi, psi_r and the dispersions on
    one shared log grid and returns interp-backed callables.
    """
    k_t, p_t = _growth_scaled_table(power, z, cosmology)
    if f is None:
        f = float(create_cosmology(cosmology).growth_rate(float(z)))
    f = float(f)
    bias = float(bias)
    sigma_fog2 = float(sigma_fog) ** 2

    rg, xig = xi_from_power((k_t, p_t), ell=0, n=n, pad_decades=pad_decades)
    kg, pg = _prep_power((k_t, p_t), n, pad_decades)
    rpsi, gpsi = fftlog_bessel(kg, kg**2 * pg / (2.0 * np.pi**2), ell=1,
                               q=1.0)
    psig = -f * np.interp(rg, rpsi, gpsi)   # psi_r(r), Mpc/h
    sp2, st2 = pairwise_dispersions((k_t, p_t), rg, f=f, n=n,
                                    pad_decades=pad_decades)

    xgg = bias**2 * xig
    v12g = 2.0 * bias * psig / (1.0 + xgg)

    def _interp(table):
        def fn(r):
            return np.interp(np.asarray(r, np.float64), rg, table)
        return fn

    def _disp(table):
        def fn(r):
            return np.interp(np.asarray(r, np.float64), rg, table) + sigma_fog2
        return fn

    return StreamingIngredients(
        xi=_interp(xgg), v12=_interp(v12g),
        sigma_par2=_disp(sp2), sigma_perp2=_disp(st2),
        rmax=float(rg[-1]))


def _span(ing: StreamingIngredients, smax, y_span_sigma):
    """Half-width of the y integration window: covers the dispersion
    tails and the v12 shift over the relevant separations."""
    probe = np.geomspace(1e-2, max(2.0 * smax, 10.0), 512)
    smax_sig = float(np.sqrt(max(np.max(ing.sigma_par2(probe)),
                                 np.max(ing.sigma_perp2(probe)), 0.0)))
    vmax = float(np.max(np.abs(ing.v12(probe))))
    return y_span_sigma * max(smax_sig, 1e-3) + vmax + 2.0


def streaming_xi_smu(ingredients, s, mu, n_y=1201, y_span_sigma=8.0):
    """Evaluate the streaming-model xi_s at (s, mu) [broadcastable].

    ``ingredients`` is a :class:`StreamingIngredients` (or a power
    table / (k, P) pair, turned into linear-theory ingredients with
    defaults).  The y integral uses an ``n_y``-node trapezoid over
    s_par +- span, span = ``y_span_sigma`` max-sigma + max|v12| + 2 —
    raise ``n_y`` if the dispersions are much smaller than the span
    (the Gaussian must be resolved by the node spacing).
    """
    if not isinstance(ingredients, StreamingIngredients):
        ingredients = streaming_ingredients(ingredients)
    s = np.asarray(s, np.float64)
    mu = np.asarray(mu, np.float64)
    s, mu = np.broadcast_arrays(s, mu)
    shape = s.shape
    s = s.ravel()
    mu = mu.ravel()
    if np.any(s <= 0):
        raise ValueError("separations must be positive")
    if np.any(np.abs(mu) > 1):
        raise ValueError("mu must lie in [-1, 1]")

    s_par = s * mu
    s_perp = s * np.sqrt(np.clip(1.0 - mu * mu, 0.0, None))
    half = _span(ingredients, float(s.max()), y_span_sigma)
    t = np.linspace(-half, half, int(n_y))           # y = s_par + t
    y = s_par[:, None] + t[None, :]
    r = np.sqrt(s_perp[:, None] ** 2 + y * y)
    r_safe = np.where(r > 0, r, 1.0)
    mu_r = np.where(r > 0, y / r_safe, 0.0)

    xi_r = ingredients.xi(r)
    v12 = ingredients.v12(r)
    sig2 = (mu_r**2 * ingredients.sigma_par2(r)
            + (1.0 - mu_r**2) * ingredients.sigma_perp2(r))
    sig2 = np.clip(sig2, 1e-20, None)
    arg = -t[None, :] - mu_r * v12                  # s_par - y - mu_r v12
    pdf = np.exp(-0.5 * arg * arg / sig2) / np.sqrt(2.0 * np.pi * sig2)
    xi_s = np.trapezoid((1.0 + xi_r) * pdf, t, axis=1) - 1.0
    return xi_s.reshape(shape)


def multipoles_from_xi_smu(fn, s, ells=(0, 2, 4), n_mu=32):
    """xi_ell(s) = (2 ell + 1) Int_0^1 dmu fn(s, mu) L_ell(mu) by
    Gauss-Legendre (mu-symmetry assumed; streaming xi_s has it by
    parity).  ``fn(s, mu)`` must broadcast.  Returns ``{ell: array}``.
    """
    s = np.atleast_1d(np.asarray(s, np.float64))
    nodes, wts = np.polynomial.legendre.leggauss(int(n_mu))
    mu = 0.5 * (nodes + 1.0)                        # [0, 1]
    w = 0.5 * wts
    grid = fn(s[:, None], mu[None, :])              # (ns, n_mu)
    out = {}
    for ell in ells:
        if ell % 2:
            raise ValueError("mu-symmetric multipoles need even ell")
        leg = np.polynomial.legendre.Legendre.basis(ell)(mu)
        out[ell] = (2 * ell + 1) * np.sum(grid * (w * leg)[None, :], axis=1)
    return out


def streaming_multipoles(power, s, cosmology=None, z=0.0, bias=1.0,
                         sigma_fog=0.0, f=None, ells=(0, 2, 4), n_mu=32,
                         n_y=1201, y_span_sigma=8.0, n=2048,
                         pad_decades=3.0):
    """Gaussian-streaming-model xi_ell(s) from a z=0 linear P(k) table
    (or directly from a prebuilt :class:`StreamingIngredients` passed
    as ``power``).  Returns ``{ell: xi_ell(s)}``.

    Valid on quasi-linear scales (s >~ 15-20 Mpc/h with linear-theory
    ingredients); at smaller s the linear v12/xi inputs, not the
    streaming mapping, are what breaks down.
    """
    if isinstance(power, StreamingIngredients):
        ing = power
    else:
        ing = streaming_ingredients(power, cosmology=cosmology, z=z,
                                    bias=bias, sigma_fog=sigma_fog, f=f,
                                    n=n, pad_decades=pad_decades)

    def fn(ss, mm):
        return streaming_xi_smu(ing, ss, mm, n_y=n_y,
                                y_span_sigma=y_span_sigma)

    return multipoles_from_xi_smu(fn, s, ells=ells, n_mu=n_mu)
