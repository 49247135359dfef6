"""FFTLog: continuum Hankel transforms between P(k) and xi_ell(r).

A copy of ``randomfield_tpu/ops/fftlog.py`` for the PyTorch port: host
float64 numpy and scipy, as in the JAX package, with this package's own
power-table validation.  The notes below are the JAX package's.

The reference package predicts configuration-space statistics only
through its gridded estimators (SURVEY.md section 3.5's validation
loop); this module adds the standard CONTINUUM transforms of large-
scale-structure theory (Hamilton 2000, MNRAS 312, 257 — the FFTLog
algorithm) so model-level predictions exist independently of any grid:

    xi_ell(r)  =  i^ell / (2 pi^2)  Integral dk k^2 P(k) j_ell(kr)
    P_ell(k)   =  4 pi (-i)^ell     Integral dr r^2 xi(r) j_ell(kr)
    w(theta)   =  Integral dl l C(l) J_0(l theta) / (2 pi)

Algorithm: on a log-uniform grid k_j = k_0 e^{j Delta} the Hankel
integral is a convolution in ln k, so it diagonalizes under a DFT with
the kernel's Mellin transform evaluated on the vertical line
Re s = q (the "tilt", which re-balances the integrand's decay between
the two ends of the grid):

    Integral_0^inf t^{s-1} j_ell(t) dt
        = sqrt(pi)/4 * 2^s * Gamma((ell+s)/2) / Gamma((ell+3-s)/2)
    Integral_0^inf t^{s-1} J_mu(t)  dt
        = 2^{s-1} * Gamma((mu+s)/2) / Gamma((mu+2-s)/2)

The output grid is reciprocal-log-uniform, r_n = (kr)_c / k_{N-1-n},
with the product (kr)_c nudged to Hamilton's low-ringing condition
(the m = N/2 kernel coefficient made real, so the periodized kernel is
continuous across the wrap point).

Design notes (TPU framework context): these transforms feed
PREDICTIONS (theory curves, covariance models), not the render hot
path, so they follow the validate/ convention of host-side float64
numpy (like `Generator.constraint_matrix`); each call is one O(N log N)
FFT over a ~2^10-point log grid — microseconds.  The gridded,
device-side estimators in validate/stats.py remain the fidelity gates;
tests pin this module against analytic transform pairs and direct
quadrature instead.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.ops.power import validate_power

__all__ = [
    "fftlog_bessel",
    "fftlog_bessel_2d",
    "xi_from_power",
    "power_from_xi",
    "angular_correlation",
    "log_grid",
    "resample_loglog",
]


def _loggamma(z):
    from scipy.special import loggamma

    return loggamma(z)


def _mellin_jl(ell, s):
    """log of U_ell(s) = Int t^{s-1} j_ell(t) dt, complex s (vectorized)."""
    return (
        0.5 * np.log(np.pi)
        - 2.0 * np.log(2.0)
        + s * np.log(2.0)
        + _loggamma(0.5 * (ell + s))
        - _loggamma(0.5 * (ell + 3.0 - s))
    )


def _mellin_Jmu(mu, s):
    """log of U_mu(s) = Int t^{s-1} J_mu(t) dt, complex s (vectorized)."""
    return (
        (s - 1.0) * np.log(2.0)
        + _loggamma(0.5 * (mu + s))
        - _loggamma(0.5 * (mu + 2.0 - s))
    )


def _fftlog_core(x, fx, logu, q, kr, lowring):
    """Shared FFTLog engine: G(y) = Integral dx/x F(x) K(xy) on the
    reciprocal grid, for a kernel given by its log-Mellin transform
    ``logu(s)``.  Returns (y, G) with y ascending."""
    x = np.asarray(x, np.float64)
    fx = np.asarray(fx, np.float64)
    if x.ndim != 1 or x.shape != fx.shape or x.size < 4:
        raise ValueError("fftlog needs matching 1-D arrays, >= 4 points")
    lnx = np.log(x)
    d = np.diff(lnx)
    delta = d.mean()
    if delta <= 0 or not np.allclose(d, delta, rtol=1e-4, atol=1e-12):
        raise ValueError("fftlog needs a log-uniform ascending grid "
                         "(use log_grid/resample_loglog)")
    n = x.size
    L = n * delta

    m = np.arange(n // 2 + 1)
    s = q + 2j * np.pi * m / L
    u = np.exp(logu(s))

    # Low-ringing product: rotate ln(kr) so u_{N/2} is real.
    lnkr = np.log(kr)
    if lowring:
        arg = np.angle(u[-1])
        lnkr_low = delta / np.pi * (arg + np.pi *
                                    np.round((np.pi / delta * lnkr - arg)
                                             / np.pi))
        lnkr = lnkr_low
    # Output grid: y_n = kr / x_{N-1-n}  (reciprocal, ascending).
    y = np.exp(lnkr) / x[::-1]

    # Kernel phases: u_m * exp(-i 2 pi m ln(x_0 y_0) / L).
    ln_x0y0 = lnx[0] + np.log(y[0])
    u = u * np.exp(-2j * np.pi * m / L * ln_x0y0)

    # c_m = (1/N) sum_j f_j x_j^{-q} e^{-2 pi i j m / N}  (half spectrum)
    c = np.fft.rfft(fx * x ** (-q)) / n
    dhalf = c * u
    # G(y_n) = y^{-q} * sum_m d_m e^{-2 pi i m n / N} over the full
    # Hermitian spectrum = y^{-q} * N * irfft(conj(d)).
    g = n * np.fft.irfft(np.conj(dhalf), n)
    return y, g * y ** (-q)


def fftlog_bessel(k, fk, ell=0, q=1.0, kr=1.0, lowring=True):
    """G(r) = Integral_0^inf dk/k F(k) j_ell(kr) by FFTLog.

    ``k`` must be log-uniform ascending; ``q`` tilts the integrand
    (F k^{-q} should decay toward both grid ends) and must lie inside
    the kernel Mellin strip ``-ell < q < 2`` — outside it the
    convolution theorem no longer holds (the gamma formula continues
    analytically but the transform it diagonalizes is a different,
    divergent integral).  Returns ``(r, G)`` on the reciprocal log grid
    r_n ~ kr / k_{N-1-n}.
    """
    if not (-ell < q < 2):
        raise ValueError(f"tilt q={q} outside the j_{ell} Mellin strip "
                         f"(-{ell}, 2)")
    return _fftlog_core(k, fk, lambda s: _mellin_jl(ell, s), q, kr, lowring)


def fftlog_bessel_2d(k, fk, mu=0, q=1.0, kr=1.0, lowring=True):
    """G(r) = Integral_0^inf dk/k F(k) J_mu(kr) by FFTLog (2-D kernel).

    Valid tilt strip: ``-mu < q < 1.5``.
    """
    if not (-mu < q < 1.5):
        raise ValueError(f"tilt q={q} outside the J_{mu} Mellin strip "
                         f"(-{mu}, 1.5)")
    return _fftlog_core(k, fk, lambda s: _mellin_Jmu(mu, s), q, kr, lowring)


def log_grid(xmin, xmax, n=1024):
    """Log-uniform ascending grid; endpoints included."""
    if not (0 < xmin < xmax):
        raise ValueError("need 0 < xmin < xmax")
    return np.geomspace(float(xmin), float(xmax), int(n))


def resample_loglog(x, fx, xnew, extrap_decades=None):
    """Interpolate f onto ``xnew`` as a power law between samples
    (linear in log-log; signed values interpolate linearly in log x).
    Outside the table the END-SLOPE power law extrapolates, optionally
    tapered to zero beyond ``extrap_decades`` to bound the periodized
    FFTLog input."""
    x = np.asarray(x, np.float64)
    fx = np.asarray(fx, np.float64)
    lx, lxn = np.log(x), np.log(np.asarray(xnew, np.float64))
    if np.all(fx > 0):
        out = np.exp(np.interp(lxn, lx, np.log(fx)))
        # np.interp clamps; redo the tails with the end slopes
        lo = lxn < lx[0]
        hi = lxn > lx[-1]
        if lo.any():
            slope = (np.log(fx[1]) - np.log(fx[0])) / (lx[1] - lx[0])
            out[lo] = fx[0] * np.exp(slope * (lxn[lo] - lx[0]))
        if hi.any():
            slope = (np.log(fx[-1]) - np.log(fx[-2])) / (lx[-1] - lx[-2])
            out[hi] = fx[-1] * np.exp(slope * (lxn[hi] - lx[-1]))
    else:
        out = np.interp(lxn, lx, fx)  # signed: linear in ln x, clamped
    if extrap_decades is not None:
        w = float(extrap_decades) * np.log(10.0)
        taper = np.ones_like(out)
        lo = lxn < lx[0]
        hi = lxn > lx[-1]
        taper[lo] = np.cos(
            0.5 * np.pi * np.minimum((lx[0] - lxn[lo]) / w, 1.0)) ** 2
        taper[hi] = np.cos(
            0.5 * np.pi * np.minimum((lxn[hi] - lx[-1]) / w, 1.0)) ** 2
        out = out * taper
    return out


def _prep_power(power, n, pad_decades):
    k_t, p_t = validate_power(power)
    kg = log_grid(k_t[0] * 10.0 ** (-pad_decades),
                  k_t[-1] * 10.0 ** (pad_decades), n)
    pg = resample_loglog(k_t, p_t, kg, extrap_decades=0.75 * pad_decades)
    return kg, pg


def xi_from_power(power, ell=0, n=2048, pad_decades=3.0, q=1.5,
                  rmin=None, rmax=None):
    """Continuum correlation multipole from a tabulated P(k).

    Evaluates ``i^ell / (2 pi^2) Integral dk k^2 P(k) j_ell(kr)`` (the
    standard xi_ell; for ell=0 this is xi(r)) with the table power-law
    extended ``pad_decades`` each side and tapered.  Returns ``(r,
    xi)``; pass ``rmin``/``rmax`` to trim to the trustworthy interior
    (defaults to the reciprocal of the tabulated k range).
    """
    if ell % 2:
        raise ValueError("xi multipoles are defined for even ell")
    kg, pg = _prep_power(power, n, pad_decades)
    r, g = fftlog_bessel(kg, kg ** 3 * pg / (2.0 * np.pi ** 2), ell=ell, q=q)
    sign = (-1.0) ** (ell // 2)  # i^ell, even ell
    k_t, _ = validate_power(power)
    lo = 1.0 / k_t[-1] if rmin is None else float(rmin)
    hi = 1.0 / k_t[0] if rmax is None else float(rmax)
    keep = (r >= lo) & (r <= hi)
    return r[keep], sign * g[keep]


def power_from_xi(r, xi, ell=0, q=1.0, kmin=None, kmax=None):
    """Inverse transform: ``P_ell(k) = 4 pi (-i)^ell Integral dr r^2
    xi(r) j_ell(kr)`` from a log-uniform (r, xi) sampling (e.g. the
    output of :func:`xi_from_power`).  Returns ``(k, P)`` trimmed to
    the reciprocal interior of the input range.
    """
    if ell % 2:
        raise ValueError("xi multipoles are defined for even ell")
    r = np.asarray(r, np.float64)
    xi = np.asarray(xi, np.float64)
    k, g = fftlog_bessel(r, 4.0 * np.pi * r ** 3 * xi, ell=ell, q=q)
    sign = (-1.0) ** (ell // 2)  # (-i)^ell, even ell
    lo = 10.0 / r[-1] if kmin is None else float(kmin)
    hi = 0.1 / r[0] if kmax is None else float(kmax)
    keep = (k >= lo) & (k <= hi)
    return k[keep], sign * g[keep]


def angular_correlation(ells, cl, n=2048, pad_decades=2.0, q=1.0,
                        theta_min=None, theta_max=None):
    """Flat-sky angular correlation ``w(theta) = Integral dl l C(l)
    J_0(l theta) / (2 pi)`` from a tabulated C(l) (e.g. the output grid
    of the JAX package's ``models.lensing.convergence_power``).
    Returns ``(theta, w)`` with theta in radians.
    """
    table = np.stack([np.asarray(ells, np.float64),
                      np.asarray(cl, np.float64)], axis=1)
    lg, cg = _prep_power(table, n, pad_decades)
    th, g = fftlog_bessel_2d(lg, lg ** 2 * cg / (2.0 * np.pi), mu=0, q=q)
    lo = 1.0 / table[-1, 0] if theta_min is None else float(theta_min)
    hi = 1.0 / table[0, 0] if theta_max is None else float(theta_max)
    keep = (th >= lo) & (th <= hi)
    return th[keep], g[keep]
