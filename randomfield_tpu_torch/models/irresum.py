"""IR-resummed BAO power spectra: wiggle/no-wiggle split and damping.

Port of ``randomfield_tpu/models/irresum.py`` with its names, arguments
and returns, host float64 numpy as there (theory code, evaluated once per
study), on the port's FFTLog (:mod:`..ops.fftlog`) and one-loop SPT
(:mod:`.spt`, imported when the loops are asked for).  The infrared
resummation of large-scale displacements (Blas, Garny, Ivanov &
Sibiryakov 2016; Ivanov 2018 conventions):

1. :func:`nowiggle_power`: P = P_nw + P_w by the correlation-space sideband
   method (Kirkby et al. 2013), exactly the input outside the BAO band;
2. :func:`bao_damping_sigma2`: Sigma^2 = (1/6 pi^2) int_0^{k_s} dq P_nw(q)
   [1 - j0(q r_s) + 2 j2(q r_s)], r_s the sound horizon
   (:func:`sound_horizon`, EH98's exact expression);
3. :func:`ir_resummed_terms` / :func:`ir_resummed_power`: the leading-order
   and one-loop IR-resummed spectra

       P_LO  = P_nw + E P_w,                       E = exp(-k^2 Sigma^2)
       P_NLO = P_nw + E (1 + k^2 Sigma^2) P_w
               + P_1loop[P_LO] - 2 c_s^2 k^2 P_LO.
"""

from __future__ import annotations

import typing

import numpy as np

from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops.fftlog import (
    log_grid,
    power_from_xi,
    resample_loglog,
    xi_from_power,
)
from randomfield_tpu_torch.ops.power import PowerTable, validate_power

__all__ = [
    "IRResult",
    "sound_horizon",
    "nowiggle_power",
    "bao_damping_sigma2",
    "ir_resummed_terms",
    "ir_resummed_power",
]


def sound_horizon(cosmology=None):
    """Drag-epoch sound horizon in Mpc/h (EH98 eq. 2-6, exact form).

    The same expression :func:`.powerspec.eh98_transfer` uses inside,
    exposed because it sets both the BAO
    wiggle frequency (P_w oscillates as sin(k s)) and the xi(r) peak
    location the no-wiggle split windows around.
    """
    c = create_cosmology(cosmology)
    omhh = c.Om0 * c.h**2
    obhh = c.Ob0 * c.h**2
    theta = c.Tcmb0 / 2.7
    z_eq = 2.50e4 * omhh / theta**4  # really 1 + z_eq
    k_eq = 0.0746 * omhh / theta**2  # [1/Mpc]
    b1 = 0.313 * omhh**-0.419 * (1.0 + 0.607 * omhh**0.674)
    b2 = 0.238 * omhh**0.223
    z_drag = (
        1291.0 * omhh**0.251 / (1.0 + 0.659 * omhh**0.828) * (1.0 + b1 * obhh**b2)
    )
    r_drag = 31.5 * obhh / theta**4 * (1000.0 / (1.0 + z_drag))
    r_eq = 31.5 * obhh / theta**4 * (1000.0 / z_eq)
    s_mpc = (
        2.0
        / (3.0 * k_eq)
        * np.sqrt(6.0 / r_eq)
        * np.log(
            (np.sqrt(1.0 + r_drag) + np.sqrt(r_drag + r_eq)) / (1.0 + np.sqrt(r_eq))
        )
    )
    return float(s_mpc * c.h)  # Mpc -> Mpc/h


def _smoothstep(x, lo, hi):
    """Cosine ramp: 0 for x <= lo, 1 for x >= hi, C^1 in between."""
    t = np.clip((x - lo) / (hi - lo), 0.0, 1.0)
    return 0.5 - 0.5 * np.cos(np.pi * t)


def _loess2_loglog(k_t, p_t, width_decades=0.4, n=2048):
    """Degree-2 local regression of log P vs log k (Gaussian weights).

    EXACT for any pure power law (log P quadratic in log k is
    reproduced identically, truncated edges included — the normal
    equations are solved with the same truncated moment sums), which
    makes it the shape-agnostic de-wiggler for inputs whose broadband
    is nothing like LambdaCDM.  Returns P_nw at the input k nodes.
    """
    lk = np.log10(np.asarray(k_t, np.float64))
    x = np.linspace(lk[0], lk[-1], int(n))
    y = np.log(resample_loglog(k_t, p_t, 10.0**x))
    h = x[1] - x[0]
    half = max(2, int(np.ceil(3.0 * (width_decades / 2.0) / h)))
    d = np.arange(-half, half + 1) * h
    w = np.exp(-0.5 * (d / (width_decades / 2.0)) ** 2)
    ones = np.ones_like(y)
    mom = [np.correlate(ones, w * d**j, mode="same") for j in range(5)]
    rhs = [np.correlate(y, w * d**j, mode="same") for j in range(3)]
    mat = np.stack(
        [np.stack([mom[i + j] for j in range(3)], -1) for i in range(3)], -2
    )
    beta = np.linalg.solve(mat, np.stack(rhs, -1)[..., None])[..., 0]
    return np.exp(np.interp(lk, x, beta[:, 0]))


def nowiggle_power(power, cosmology=None, k_band=(8e-3, 1.0),
                   n=4096) -> PowerTable:
    """Smooth (de-wiggled) companion of a tabulated linear P(k).

    Correlation-space sideband method: xi(r) = FFTLog[P] is evaluated
    on a dense log grid; inside the BAO window (0.55-1.6 times the
    sound horizon) r^2 xi is replaced by a cubic polynomial fitted to
    the flanking sidebands, blended with C^1 cosine edges so the
    replacement introduces no kink; the inverse FFTLog gives P_nw.
    The result is blended back into the exact input outside ``k_band``
    (wiggles are Silk-damped above and unresolved below it), so
    P_nw == P identically at the table's extremes and the returned
    table carries no transform edge effects.  Same k nodes as the
    input; P_w = P - P_nw.
    """
    from randomfield_tpu_torch.models.powerspec import eh98_nowiggle_power

    k_t, p_t = validate_power(power)
    k_t = np.asarray(k_t, np.float64)
    p_t = np.asarray(p_t, np.float64)
    s_h = sound_horizon(cosmology)

    # analytic smooth reference, amplitude-matched to the input by the
    # log-mean ratio over the BAO band (wiggles average out of a log
    # mean); the sideband fit below only has to absorb the RESIDUAL
    # broadband, which is why smooth inputs come back nearly unchanged
    p_an = eh98_nowiggle_power(cosmology, k_t)
    fit = (k_t >= 0.015) & (k_t <= 0.45)
    if fit.sum() < 4:
        fit = slice(None)
    log_ratio = np.log(p_t[fit] / p_an[fit])
    alpha = float(np.exp(np.mean(log_ratio)))
    lo, hi = float(k_band[0]), float(k_band[1])
    taper = _smoothstep(np.log(k_t), np.log(lo * 0.4), np.log(lo)) * (
        1.0 - _smoothstep(np.log(k_t), np.log(hi), np.log(hi * 2.5))
    )
    if float(np.std(log_ratio)) >= 0.3:
        # broadband nothing like LambdaCDM (e.g. a power law): such a
        # spectrum has no physical BAO feature, and the correlation-
        # space method is ill-posed for UV-divergent shapes — use the
        # shape-agnostic log-log local regression (exact for power
        # laws) instead of an EH98-shaped reference
        w = _loess2_loglog(k_t, p_t) / p_t - 1.0
        return PowerTable(k_t.copy(), p_t * (1.0 + taper * w))
    p_ref = alpha * p_an

    # default trim keeps r in [1/k_max, 1/k_min]: the full range the
    # inverse transform needs for k inside the table (the round trip
    # closes to ~2e-4 there; a narrower r window silently starves the
    # k > 0.1/r_min output of support)
    r, xi = xi_from_power((k_t, p_t), ell=0, n=int(n))
    r_ref, xi_ref = xi_from_power((k_t, p_ref), ell=0, n=int(n))
    if r.shape != r_ref.shape or not np.allclose(r, r_ref):
        raise AssertionError("FFTLog grids diverged between input and reference")
    g = r * r * (xi - xi_ref)  # residual: peak + small smooth broadband

    core_lo, core_hi = 0.70 * s_h, 1.35 * s_h
    edge_lo, edge_hi = 0.55 * s_h, 1.60 * s_h
    band_lo, band_hi = 0.45 * s_h, 1.85 * s_h
    side = ((r >= band_lo) & (r <= edge_lo)) | ((r >= edge_hi) & (r <= band_hi))
    if side.sum() < 8:
        raise ValueError("xi(r) grid too coarse to bracket the BAO peak")
    # cubic in r through the sidebands (r^2 Delta-xi is smooth there)
    coef = np.polynomial.polynomial.polyfit(r[side] / s_h, g[side], 3)
    poly = np.polynomial.polynomial.polyval(r / s_h, coef)
    # bump: 1 across the peak core, -> 0 inside the fitted sidebands
    bump = _smoothstep(r, edge_lo, core_lo) * (1.0 - _smoothstep(r, core_hi, edge_hi))
    g_nw = g + bump * (poly - g)
    xi_nw = xi_ref + g_nw / (r * r)

    k_b, p_b = power_from_xi(r, xi_nw, ell=0)
    w = resample_loglog(k_b, p_b, k_t) / p_t - 1.0
    return PowerTable(k_t.copy(), p_t * (1.0 + taper * w))


def _bracket(x):
    """1 - j0(x) + 2 j2(x), series-switched for float64 stability."""
    x = np.asarray(x, np.float64)
    out = np.empty(x.shape, np.float64)
    small = x < 0.035
    xs = x[small]
    x2 = xs * xs
    out[small] = x2 * (0.3 + x2 * (-1.0 / 56.0 + x2 / 2160.0))
    xb = np.where(small, 1.0, x)
    s, c = np.sin(xb), np.cos(xb)
    j0 = s / xb
    j2 = (3.0 / (xb * xb) - 1.0) * j0 - 3.0 * c / (xb * xb)
    out[~small] = (1.0 - j0 + 2.0 * j2)[~small]
    return out


def bao_damping_sigma2(power_nw, ks=0.2, r_bao=None, cosmology=None,
                       nq=2048):
    """BAO damping scale Sigma^2 [(Mpc/h)^2] (Blas et al. 2016, eq. 4.6).

    ``power_nw`` must be the SMOOTH spectrum (the wiggly part would
    contribute an oscillatory correction the resummation scheme
    excludes by construction).  ``ks`` separates long displacement
    modes (default 0.2 h/Mpc, the standard choice); ``r_bao`` defaults
    to the cosmology's sound horizon.  ``ks = 0`` returns exactly 0.
    """
    if ks < 0:
        raise ValueError("ks must be >= 0")
    if ks == 0.0:
        return 0.0
    k_t, p_t = validate_power(power_nw)
    r_s = sound_horizon(cosmology) if r_bao is None else float(r_bao)
    q = log_grid(min(1e-6, ks * 1e-4), float(ks), int(nq))
    pq = resample_loglog(np.asarray(k_t, np.float64),
                         np.asarray(p_t, np.float64), q)
    integrand = pq * _bracket(q * r_s) * q  # * q: log-measure
    return float(np.trapezoid(integrand, np.log(q)) / (6.0 * np.pi**2))


class IRResult(typing.NamedTuple):
    """IR-resummed decomposition at wavenumbers ``k`` [h/Mpc]."""

    k: np.ndarray
    p_nw: np.ndarray
    p_w: np.ndarray
    sigma2: float
    p_lo: np.ndarray      # leading order: P_nw + E P_w
    p_w_extra: np.ndarray  # NLO wiggle correction E k^2 Sigma^2 P_w (0 at LO)
    p22: np.ndarray       # loop terms of P_1loop[P_LO] (zero at order='lo')
    p13: np.ndarray
    p_ctr: np.ndarray     # -2 c_s^2 k^2 P_LO

    @property
    def total(self) -> np.ndarray:
        return self.p_lo + self.p_w_extra + self.p22 + self.p13 + self.p_ctr


def ir_resummed_terms(power, k=None, z=0.0, cosmology=None, order="oneloop",
                      ks=0.2, cs2=0.0, nq=2048, nx=128) -> IRResult:
    """IR-resummed P(k) decomposition (see module docstring).

    ``order='lo'`` gives tree level (no loops, counterterm still
    applied if ``cs2`` is set); ``order='oneloop'`` adds
    P22 + P13 evaluated on the damped leading-order input.  With ``z``
    and a ``cosmology`` the input table is scaled by D(z)^2 first, so
    every derived piece carries its standard growth weight.
    """
    if order not in ("lo", "oneloop"):
        raise ValueError("order must be 'lo' or 'oneloop'")
    k_t, p_t = validate_power(power)
    k_t = np.asarray(k_t, np.float64)
    p_t = np.asarray(p_t, np.float64)
    if z != 0.0:
        if cosmology is None:
            raise ValueError("scaling to z != 0 requires a cosmology")
        d = float(create_cosmology(cosmology).growth_function(float(z)))
        p_t = d * d * p_t

    nw = nowiggle_power((k_t, p_t), cosmology=cosmology)
    sigma2 = bao_damping_sigma2(nw, ks=ks, cosmology=cosmology, nq=nq)
    p_w_t = p_t - nw.Pk
    p_lo_t = nw.Pk + np.exp(-k_t**2 * sigma2) * p_w_t

    if k is None:
        lo_k = k_t[0] * 10.0**0.5
        hi_k = k_t[-1] * 10.0**-0.5
        k = log_grid(lo_k, hi_k, 128)
    k = np.atleast_1d(np.asarray(k, np.float64))
    if np.any(k <= 0):
        raise ValueError("k must be positive")

    p_nw = resample_loglog(k_t, nw.Pk, k)
    p_w = resample_loglog(k_t, p_t, k) - p_nw
    p_lo = p_nw + np.exp(-k * k * sigma2) * p_w

    if order == "oneloop":
        from randomfield_tpu_torch.models.spt import oneloop_terms

        if np.any(p_lo_t <= 0):
            raise ValueError("damped leading-order table is non-positive")
        loops = oneloop_terms((k_t, p_lo_t), k=k, nq=nq, nx=nx)
        p22, p13 = loops.p22, loops.p13
        p_w_extra = np.exp(-k * k * sigma2) * (k * k * sigma2) * p_w
    else:
        p22 = np.zeros_like(k)
        p13 = np.zeros_like(k)
        p_w_extra = np.zeros_like(k)
    p_ctr = -2.0 * float(cs2) * k * k * p_lo
    return IRResult(k, p_nw, p_w, sigma2, p_lo, p_w_extra, p22, p13, p_ctr)


def ir_resummed_power(power, k=None, **kw) -> PowerTable:
    """IR-resummed total P(k) as a :class:`PowerTable` (feedable back
    into ``Generator(power=...)`` like :func:`spt.oneloop_power`)."""
    res = ir_resummed_terms(power, k=k, **kw)
    total = res.total
    if np.any(total <= 0):
        bad = res.k[total <= 0]
        raise ValueError(
            "IR-resummed P(k) is non-positive at k >= %.3g h/Mpc; restrict "
            "the requested k range" % bad.min()
        )
    return PowerTable(res.k, total)
