"""Marked power spectra, with an exact Wick prediction for linear marks.

Port of ``randomfield_tpu/validate/marked.py`` with its names, arguments
and returns.  The marked power spectrum (White 2016; Massara et al. 2021)
reweights the density by a local function of its smoothed environment,

    m(x) = ((1 + delta_s) / (1 + delta_s + delta_R(x)))**p,

and measures P(k) of m(x) delta(x) with the ordinary estimator.  For the
linear mark m = 1 + eps delta_R the marked field is quadratic in the
Gaussian field, and Wick's theorem on the discrete lattice gives its exact
expectation, xi_g = xi + eps^2 (xi_RR xi + xi_X^2) (the odd term vanishes),
transformed back to per-mode power and binned with the estimator's own
bins (:func:`predicted_linear_marked_power`).

On the card the smoothing is the hand transforms: :func:`..ops.transform.rfftn`
(K6, then forward K3 along y and x), the window multiplied into the
spectrum in place a slab of x planes at a time, then
:func:`..ops.transform.irfftn_reim` (K3, K3, K4); no ``torch.fft``.  The
measurement is the port's ``calculate_power`` (KB).  Tensor fields run on
their device, numpy fields and the prediction on ``device=`` ("cuda" by
default).  ``mesh=`` raises NotImplementedError (ROADMAP.md, Queue 1 item
8).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate import fourier as _fourier
from randomfield_tpu_torch.validate import stats as _stats

__all__ = [
    "smooth_field",
    "white_mark",
    "marked_field",
    "linear_marked_field",
    "calculate_marked_power",
    "predicted_linear_marked_power",
]

# x planes a step of the window multiply (bounds its temporaries)
_X_CHUNK = 64


def _window_grid(shape, spacing, R, window, device, x_off=0, nx_loc=None):
    """The float32 window W(|k| R) over x rows [x_off, x_off + nx_loc) of
    the half grid, in the JAX package's order of operations."""
    km = _grid.kmag(shape, float(spacing), torch.float32, device, x_off,
                    nx_loc)
    R = float(R)
    if window == "gaussian":
        t = km * R
        return torch.exp(-0.5 * (t * t))
    if window == "tophat":
        x = km * R
        xs = torch.where(x > 1e-4, x, 1.0)
        w = 3.0 * (torch.sin(xs) - xs * torch.cos(xs)) / (xs * xs * xs)
        return torch.where(x > 1e-4, w, 1.0 - x * x / 10.0)
    raise ValueError(f"unknown window {window!r}: 'gaussian' or 'tophat'")


def _check_window(window):
    if window not in ("gaussian", "tophat"):
        raise ValueError(f"unknown window {window!r}: 'gaussian' or 'tophat'")


def _on_device(delta, device):
    """``delta`` as a float32 field on its device (a tensor's own, numpy's
    ``device``, "cuda" by default)."""
    return _fourier._field(torch.as_tensor(
        delta, device=_stats.device_of(delta, device)))


def smooth_field(delta, spacing, R, window="gaussian", mesh=None,
                 device=None):
    """Smooth a field on scale ``R`` (Mpc/h) by a spectrum multiply:
    ``'gaussian'`` exp(-(kR)^2 / 2), ``'tophat'`` the spherical top-hat
    3 (sin x - x cos x) / x^3, x = kR.  A new float32 field on ``delta``'s
    device (the hand transforms on CUDA)."""
    if mesh is not None:
        raise _stats.mesh_not_ported("smooth_field", mesh)
    _check_window(window)
    delta = _on_device(delta, device)
    shape = tuple(int(s) for s in delta.shape)
    re, im = _transform.rfftn(delta)
    # a^3 of the analysis and 1/V of the synthesis: 1/N on the raw sums
    inv_n = float(np.float32(1.0 / (shape[0] * shape[1] * shape[2])))
    for x0 in range(0, shape[0], _X_CHUNK):
        n = min(_X_CHUNK, shape[0] - x0)
        w = _window_grid(shape, spacing, R, window, delta.device, x0, n)
        w.mul_(inv_n)
        re[x0:x0 + n].mul_(w)
        im[x0:x0 + n].mul_(w)
    return _transform.irfftn_reim(re, im, shape)


def white_mark(delta_R, p=2.0, delta_s=0.25):
    """The White (2016) mark ((1 + delta_s) / (1 + delta_s + delta_R))**p,
    ``delta_R`` clamped at -0.9 (1 + delta_s); ``p = 0`` is the constant
    mark."""
    base = 1.0 + float(delta_s)
    dr = torch.clamp_min(torch.as_tensor(delta_R), -0.9 * base)
    return (base / (base + dr)) ** float(p)


def marked_field(delta, spacing, R=10.0, p=2.0, delta_s=0.25,
                 window="gaussian", mesh=None, device=None):
    """``m(x) delta(x)`` with the White mark of the R-smoothed field."""
    delta = _on_device(delta, device)
    dr = smooth_field(delta, spacing, R, window, mesh=mesh)
    return white_mark(dr, p, delta_s) * delta


def linear_marked_field(delta, spacing, eps, R=10.0, window="gaussian",
                        mesh=None, device=None):
    """``(1 + eps delta_R) delta``: the exactly predictable mark."""
    delta = _on_device(delta, device)
    dr = smooth_field(delta, spacing, R, window, mesh=mesh)
    return (1.0 + float(eps) * dr) * delta


def calculate_marked_power(delta, spacing, nbins=32, R=10.0, p=2.0,
                           delta_s=0.25, window="gaussian", mark=None,
                           mesh=None, device=None):
    """Marked power spectrum: P(k) of ``m delta``, ``m`` the White mark of
    the R-smoothed field (or ``mark(delta_R)``).  Returns ``(k_mean,
    p_marked, n_modes)`` as ``calculate_power`` does."""
    if mesh is not None:
        raise _stats.mesh_not_ported("calculate_marked_power", mesh)
    delta = _on_device(delta, device)
    dr = smooth_field(delta, spacing, R, window)
    m = white_mark(dr, p, delta_s) if mark is None else mark(dr)
    del dr
    m.mul_(delta)
    return _fourier.calculate_power(m, spacing, nbins=nbins)


def _to_field(re, shape, spacing):
    """spectrum_to_field of a real per-mode half grid (a new field)."""
    return _transform.spectrum_to_field((re, torch.zeros_like(re)), spacing,
                                        shape)


def predicted_linear_marked_power(power, shape, spacing, eps, R=10.0,
                                  nbins=32, window="gaussian",
                                  interpolation="log10k", device="cuda"):
    """Exact expectation of the linear-mark marked power spectrum,
    E[P_g(k)] = P(k) + eps^2 FT[xi_RR xi + xi_X^2](k) on this grid's modes,
    binned with ``calculate_power``'s bins (``bin_power_grid``); residuals
    against ``calculate_power(linear_marked_field(...))`` are pure sample
    noise.  Runs on ``device``."""
    _check_window(window)
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    _, pgrid = _power.grid_power(table, shape, spacing, interpolation,
                                 device)
    w = _window_grid(shape, spacing, R, window, pgrid.device)
    xi = _to_field(pgrid, shape, spacing)
    pw = pgrid * w
    xi_x = _to_field(pw, shape, spacing)
    pw.mul_(w)
    del w
    xi_tau = _to_field(pw, shape, spacing)
    del pw
    xi_tau.mul_(xi).addcmul_(xi_x, xi_x)
    del xi, xi_x
    re, _ = _transform.rfftn(xi_tau)
    del xi_tau
    re.mul_(float(np.float32(spacing**3)))
    e_pgrid = pgrid + float(eps) * float(eps) * re
    e_pgrid[0, 0, 0] = 0.0
    return _stats.bin_power_grid(e_pgrid, shape, spacing, nbins)
