"""Stacked radial profiles around selected points, with exact gates.

Port of ``randomfield_tpu/validate/profiles.py`` (one device).  The stack
of a field around the positions a weight field selects is one FFT
cross-correlation: Re[conj(W) D] / V per mode (DC zeroed), one inverse
transform, and the minimum-image radial binning of xi(r)
(:func:`.correlation._grid_xi` and :func:`.correlation._xi_bins`: K3, K3,
K4 and float64 bin sums on CUDA).  For a Gaussian field the
angle-averaged expectation is closed-form (BBKS 1986 section 7): around
value-selected points E[delta(x + r) | u(x)] = u sigma0 psi(r), psi =
xi / sigma0^2; around peaks of height nu and scaled curvature x,

    E[delta(r)] = [ (nu - gamma x) sigma0 psi(r)
                  + (x - gamma nu) (sigma0^2/sigma2) (-lap psi)(r) ]
                  / (1 - gamma^2),

which :func:`predicted_peak_profile` bins through the same transform and
shells on the smoothed power grid.  :func:`peak_profile` selects the peaks
with KX's mask (:func:`..ops.extrema.peak_counts`).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import extrema as _extrema
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate import correlation as _corr
from randomfield_tpu_torch.validate.stats import mesh_not_ported

__all__ = [
    "stacked_profile",
    "peak_profile",
    "predicted_peak_profile",
    "mean_height_in_band",
]

# x planes a step of the grid sums (bounds their float64 temporaries)
_X_CHUNK = 16


def _binned_cross_corr(w, d, shape, spacing, nbins):
    """(r_mean, <w(x) d(x + r)> (nbins,), n_cells): the cross power
    Re[conj(W) D] / V (DC zeroed) through :func:`.correlation._grid_xi`
    and the xi shells."""
    a3 = float(np.float32(float(spacing) ** 3))
    wr, wi = _transform.rfftn(w)
    dr, di = _transform.rfftn(d)
    volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
    # c = a^3 rfftn (field_to_spectrum); p = (cw.re cd.re + cw.im cd.im) / V
    wr.mul_(a3)
    wi.mul_(a3)
    dr.mul_(a3)
    di.mul_(a3)
    p = wr.mul_(dr).add_(wi.mul_(di))
    del wi, dr, di
    p.div_(torch.full((), volume, dtype=torch.float32, device=p.device))
    p[0, 0, 0] = 0.0
    r, xi, n = _corr._xi_bins(_corr._grid_xi(p, shape, spacing), shape,
                              float(spacing), int(nbins))
    return r, xi[0], n


def _grid_sum(x, mult):
    """float64 sum of ``mult`` x (a kz multiplicity, or 1), a chunk of x
    planes a step."""
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for chunk in x.split(_X_CHUNK):
        total += (chunk.to(torch.float64) * mult).sum()
    return float(total)


def stacked_profile(delta, weight, spacing, nbins=24, mesh=None):
    """Mean field value in radial shells around weighted positions.

    ``weight``: any non-negative selection field on the grid (a 0/1 mask,
    a peak indicator, tracer counts).  Returns ``(r_mean, profile,
    n_cells)``, profile(r) = sum_x w(x) delta(x + r) / sum_x w(x) averaged
    over each periodic minimum-image shell (the bins of
    ``calculate_correlation``; the zero lag excluded).  The realized mean
    is dropped (DC zeroed).  Runs on ``delta``'s device; ``mesh`` raises
    NotImplementedError.
    """
    if mesh is not None:
        raise mesh_not_ported("stacked_profile", mesh)
    d = torch.as_tensor(delta)
    w = torch.as_tensor(weight).to(device=d.device, dtype=d.dtype)
    if d.shape != w.shape:
        raise ValueError(f"field and weight must share a grid, got "
                         f"{tuple(d.shape)} vs {tuple(w.shape)}")
    shape = tuple(int(s) for s in d.shape[-3:])
    r, xi_wd, n = _binned_cross_corr(w, d, shape, float(spacing), int(nbins))
    w_mean = _grid_sum(w, 1.0) / w.numel()
    if w_mean <= 0:
        raise ValueError("weight field sums to zero: nothing selected")
    return r, xi_wd / w_mean, n


def _laplacian(d, shape, spacing):
    """lap d by a spectral multiply: -|k|^2 (full vectors) on rfftn(d) / N,
    then the inverse transform."""
    re, im = _transform.rfftn(d)
    k2 = _grid.ksq(shape, float(spacing), torch.float32, d.device)
    k2 = k2.mul_(-1.0 / (shape[0] * shape[1] * shape[2]))
    return _transform.irfftn_reim(re.mul_(k2), im.mul_(k2), shape)


def peak_profile(delta, spacing, moments, nu_min=1.0, nu_max=None,
                 nbins=24):
    """Stacked profile around lattice peaks in a height band.

    ``moments``: (sigma0_sq, sigma1_sq, sigma2_sq) of the render's
    spectrum (:func:`.peaks.bbks_moments`); heights u = delta / sigma0,
    curvatures x = -lap(delta) / sigma2 (spectral, full |k|^2).  Peaks are
    27-cube maxima with nu_min <= u (and u < nu_max if given), KX's mask.
    Returns ``(r_mean, profile, n_peaks, nu_bar, x_bar)``; feed nu_bar and
    x_bar to :func:`predicted_peak_profile`.
    """
    d = torch.as_tensor(delta)
    shape = tuple(int(s) for s in d.shape[-3:])
    s0 = float(np.sqrt(moments[0]))
    s2 = float(np.sqrt(moments[2]))
    edges = np.array([-np.inf, np.inf])
    _, _, mask = _extrema.peak_counts(d, s0, edges, band=(nu_min, nu_max))
    sel = mask.bool()
    n_peaks = int(sel.sum())
    if n_peaks == 0:
        raise ValueError(
            f"no peaks with nu >= {nu_min} — lower nu_min or smooth less")
    d_sel = d[sel]
    u_sel = _extrema.unit_field(d_sel, s0)
    lap_sel = _laplacian(d, shape, float(spacing))[sel]
    nu_bar = float(u_sel.to(torch.float64).sum()) / n_peaks
    x_bar = float(-lap_sel.to(torch.float64).sum()) / n_peaks / s2
    del d_sel, u_sel, lap_sel, sel
    r, prof, _ = stacked_profile(d, mask, spacing, nbins=nbins)
    return r, prof, n_peaks, nu_bar, x_bar


def predicted_peak_profile(power, shape, spacing, nu_bar, x_bar=None,
                           smoothing_length=0.0, nbins=24,
                           interpolation="log10k", device="cuda"):
    """Exact Gaussian expectation of a stacked profile.

    ``x_bar=None``: the value-selected conditional mean nu_bar sigma0
    psi(r), exact for any height-band mask.  With ``x_bar``: the BBKS
    angle-averaged peak profile, conditioned on height and mean
    curvature.  psi and -lap psi go through the estimator's inverse
    transform and shells on the smoothed power grid P exp(-k^2 s^2) on
    ``device``; the moments are its float64 grid sums.  Returns
    ``(r_mean, profile)``.
    """
    shape = tuple(int(s) for s in shape)
    kmag, pgrid = _power.grid_power(power, shape, float(spacing),
                                    interpolation, device)
    k2 = kmag * kmag
    sm = float(smoothing_length)
    pgrid = pgrid * torch.exp(-k2 * sm * sm)
    pgrid = torch.where(kmag > 0, pgrid, 0.0)
    del kmag
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    mult = _grid.kz_multiplicity(nz, device)
    s0sq = _grid_sum(pgrid, mult) / volume
    s1sq = _grid_sum(k2 * pgrid, mult) / volume
    s2sq = _grid_sum(k2 * k2 * pgrid, mult) / volume
    r, xi_b, _ = _corr._xi_bins(_corr._grid_xi(pgrid, shape, spacing), shape,
                                float(spacing), int(nbins))
    psi = xi_b[0] / s0sq
    s0 = np.sqrt(s0sq)
    if x_bar is None:
        return r, float(nu_bar) * s0 * psi
    _, neg_lap_xi, _ = _corr._xi_bins(
        _corr._grid_xi(k2 * pgrid, shape, spacing), shape, float(spacing),
        int(nbins))
    neg_lap_psi = neg_lap_xi[0] / s0sq
    s2 = np.sqrt(s2sq)
    gamma = s1sq / (s0 * s2)
    a = (float(nu_bar) - gamma * float(x_bar)) / (1.0 - gamma**2)
    b = (float(x_bar) - gamma * float(nu_bar)) / (1.0 - gamma**2)
    return r, a * s0 * psi + b * (s0sq / s2) * neg_lap_psi


def mean_height_in_band(nu_min, nu_max=None):
    """E[u | nu_min <= u < nu_max] of a unit normal (the truncated-normal
    mean): the a-priori counterpart of the measured nu_bar."""
    def phi(x):
        return math.exp(-0.5 * x * x) / math.sqrt(2.0 * math.pi)

    def cdf(x):
        return 0.5 * (1.0 + math.erf(x / math.sqrt(2.0)))

    lo = float(nu_min)
    if nu_max is None:
        return phi(lo) / (1.0 - cdf(lo))
    hi = float(nu_max)
    return (phi(lo) - phi(hi)) / (cdf(hi) - cdf(lo))
