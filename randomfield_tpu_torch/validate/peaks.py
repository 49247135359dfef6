"""BBKS peak statistics with exact Gaussian expectations.

Port of ``randomfield_tpu/validate/peaks.py`` (one device).  Counts of
lattice maxima binned by height nu = u / sigma0 against the closed-form
differential peak density of Bardeen, Bond, Kaiser & Szalay (1986, eqs.
4.3-4.5, A15),

    n_pk(nu) dnu = exp(-nu^2/2) / ((2 pi)^2 R*^3) G(gamma, gamma nu) dnu,

gamma = sigma1^2 / (sigma0 sigma2), R* = sqrt(3) sigma1 / sigma2, with the
spectral moments sigma_j^2 = sum_k |k|^{2j} sigma_eff(k)^2 of the render's
band-limited spectrum (full |k|, not the Nyquist-zeroed gradient vectors:
peak finding compares values, it does not differentiate).

The measurement is KX's peak mode (:func:`..ops.extrema.peak_counts`): a
voxel is a peak iff u = delta / sigma0 (a float32 division) equals the
maximum of its periodic 27-cube; heights by the float32 edges' search;
int64 counts.  :func:`bbks_moments` sums the moments on the device in
float64, a chunk of x planes at a time, where the JAX package sums float32
over every mode at once.  The BBKS functions run on the host in float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import extrema as _extrema
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.validate.onepoint import field_moments
from randomfield_tpu_torch.validate.stats import mesh_not_ported

__all__ = [
    "peak_statistics",
    "bbks_moments",
    "bbks_peak_density",
    "bbks_total_density",
    "bbks_expected_counts",
    "mode_moments",
]

# x planes a step of the moment sums (bounds their float64 temporaries)
_X_CHUNK = 16


def mode_moments(power, shape, spacing, smoothing_length=0.0,
                 interpolation="log10k", device="cuda", gradient=False):
    """(sum m se2, sum m k2 se2, sum m k2^2 se2) over the packed modes, in
    float64 on ``device``: se2 = P(|k|) / V exp(-|k|^2 s^2) (0 at DC), m the
    Hermitian multiplicity of the kz column, P the table's interpolant in
    float64 (as :func:`..ops.power.tabulate_sigmas` evaluates it), k2 = |k|^2
    or, with ``gradient``, the squared Nyquist-zeroed gradient vectors'
    |k_grad|^2 (the third sum keeps |k|^4).  A chunk of x planes at a
    time."""
    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    kx, ky, kz = _grid.kvectors(shape, float(spacing), torch.float64, device)
    gvec = [k.clone() for k in (kx, ky, kz)]
    for k, n in zip(gvec, shape):
        if n % 2 == 0:
            k[n // 2] = 0.0
    lk_tab, val_tab, log_values = _power.table_arrays_host(
        table, interpolation, np.float64)
    lk_tab = torch.as_tensor(lk_tab, device=device)
    val_tab = torch.as_tensor(val_tab, device=device)
    mult = _grid.kz_multiplicity(nz, device).to(torch.float64)
    s2 = float(smoothing_length) ** 2
    out = torch.zeros(3, dtype=torch.float64, device=device)
    kyz = (ky * ky)[:, None] + (kz * kz)[None, :]
    gyz = (gvec[1] * gvec[1])[:, None] + (gvec[2] * gvec[2])[None, :]
    for x0 in range(0, nx, _X_CHUNK):
        x1 = min(nx, x0 + _X_CHUNK)
        k2 = (kx[x0:x1] * kx[x0:x1])[:, None, None] + kyz
        k = torch.sqrt(k2)
        pk = _power._np_interp(torch.log10(torch.clamp(k, min=1e-30)), lk_tab,
                               val_tab)
        if log_values:
            pk = 10.0 ** pk
        se2 = torch.where(k > 0, pk / volume, 0.0) * torch.exp(-k2 * s2) * mult
        kg2 = ((gvec[0][x0:x1] ** 2)[:, None, None] + gyz) if gradient else k2
        out[0] += se2.sum()
        out[1] += (kg2 * se2).sum()
        out[2] += (k2 * k2 * se2).sum()
    return tuple(float(v) for v in out.cpu())


def bbks_moments(power, shape, spacing, smoothing_length=0.0,
                 interpolation="log10k", device="cuda"):
    """(sigma0^2, sigma1^2, sigma2^2) of the band-limited field: sums of
    |k|^{2j} sigma_eff(k)^2 over the packed modes with Hermitian
    multiplicity, with the render's interpolation and smoothing and the
    full |k| (:func:`mode_moments`), in float64 on ``device``."""
    return mode_moments(power, shape, spacing, smoothing_length,
                        interpolation, device)


def _f_curvature(x):
    """BBKS eq. A15 closed form for f(x) (numpy, float64)."""
    x = np.asarray(x, np.float64)
    erf = np.vectorize(math.erf)
    a = 0.5 * (x**3 - 3.0 * x) * (
        erf(math.sqrt(2.5) * x) + erf(math.sqrt(2.5) * 0.5 * x)
    )
    b = np.sqrt(0.4 / np.pi) * (
        (7.75 * x * x + 1.6) * np.exp(-0.625 * x * x)
        + (0.5 * x * x - 1.6) * np.exp(-2.5 * x * x)
    )
    return a + b


def _G(gamma, xstar, n_grid=4001):
    """BBKS eq. 4.5: G(gamma, x*) = <f(x)> over N(x*, 1 - gamma^2)."""
    gamma = float(gamma)
    xstar = np.atleast_1d(np.asarray(xstar, np.float64))
    var = max(1.0 - gamma * gamma, 1e-12)
    hi = max(10.0, float(xstar.max()) + 8.0 * np.sqrt(var))
    x = np.linspace(0.0, hi, n_grid)
    w = _f_curvature(x)
    kern = np.exp(
        -0.5 * (x[None, :] - xstar[:, None]) ** 2 / var
    ) / np.sqrt(2.0 * np.pi * var)
    return np.trapezoid(w[None, :] * kern, x, axis=1)


def bbks_peak_density(nu, sigma0_sq, sigma1_sq, sigma2_sq):
    """Differential comoving peak density n_pk(nu) (per volume per nu):
    BBKS eq. 4.3 with gamma and R* from the spectral moments; ``nu`` in
    units of sigma0."""
    nu = np.asarray(nu, np.float64)
    s0 = np.sqrt(float(sigma0_sq))
    s1 = np.sqrt(float(sigma1_sq))
    s2 = np.sqrt(float(sigma2_sq))
    gamma = s1 * s1 / (s0 * s2)
    rstar = np.sqrt(3.0) * s1 / s2
    g = _G(gamma, gamma * nu)
    return np.exp(-0.5 * nu * nu) * g / ((2.0 * np.pi) ** 2 * rstar**3)


def bbks_total_density(sigma0_sq, sigma1_sq, sigma2_sq):
    """Exact total maximum density (29 - 6 sqrt 6) (sigma2 / sqrt(3)
    sigma1)^3 / (2 5^{3/2} (2 pi)^2), BBKS eq. 4.11b."""
    s1 = np.sqrt(float(sigma1_sq))
    s2 = np.sqrt(float(sigma2_sq))
    rstar = np.sqrt(3.0) * s1 / s2
    const = (29.0 - 6.0 * np.sqrt(6.0)) / (
        2.0 * 5.0**1.5 * (2.0 * np.pi) ** 2
    )
    return const / rstar**3


def bbks_expected_counts(edges, volume, sigma0_sq, sigma1_sq, sigma2_sq,
                         n_sub=64):
    """Expected peak counts per nu bin (V times a fixed-grid quadrature of
    n_pk over each bin) and the expected total (closed form, all
    heights)."""
    edges = np.asarray(edges, np.float64)
    counts = np.empty(len(edges) - 1)
    for i in range(len(edges) - 1):
        x = np.linspace(edges[i], edges[i + 1], n_sub)
        counts[i] = np.trapezoid(
            bbks_peak_density(x, sigma0_sq, sigma1_sq, sigma2_sq), x
        )
    total = bbks_total_density(sigma0_sq, sigma1_sq, sigma2_sq)
    return counts * float(volume), total * float(volume)


def resolve_sigma0(delta, sigma0):
    """``sigma0``, or the field's own standard deviation when None
    (:func:`.onepoint.field_moments`)."""
    if sigma0 is not None:
        return float(sigma0)
    _, var = field_moments(delta)
    return float(np.sqrt(var))


def extrema_statistics(delta, nbins, nu_min, nu_max, sigma0, sign):
    """(centers, int64 counts, total) of the peaks of ``sign`` delta in
    nbins uniform height bins over [nu_min, nu_max] (KX)."""
    delta = torch.as_tensor(delta)
    sigma0 = resolve_sigma0(delta, sigma0)
    edges = np.linspace(float(nu_min), float(nu_max), int(nbins) + 1)
    counts, total, _ = _extrema.peak_counts(delta, sigma0, edges, sign)
    return (0.5 * (edges[:-1] + edges[1:]), counts.cpu().numpy(),
            int(total))


def peak_statistics(delta, spacing, nbins=14, nu_min=-2.0, nu_max=5.0,
                    sigma0=None, mesh=None):
    """Lattice peak counts of a 3-D field, binned by height.

    A voxel is a peak iff it is the maximum of its periodic 27-cube;
    heights nu = delta / sigma0 in ``nbins`` uniform bins over [nu_min,
    nu_max] (peaks outside count in ``total`` only).  ``sigma0`` defaults
    to the field's own standard deviation; pass the predicted one to gate
    against :func:`bbks_expected_counts`.  One device: ``mesh`` raises
    NotImplementedError.  Returns ``(nu_centers, counts, total)``, counts
    int64 numpy.
    """
    if mesh is not None:
        raise mesh_not_ported("peak_statistics", mesh)
    return extrema_statistics(delta, nbins, nu_min, nu_max, sigma0, 1.0)
