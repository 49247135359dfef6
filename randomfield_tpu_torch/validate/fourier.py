"""Fourier-space estimators: P(k), its multipoles and wedges, cross and
masked spectra, and the 1-D line-of-sight spectrum.

Port of the single-device estimators of ``randomfield_tpu/validate/stats.py``
(``calculate_power :277``, ``calculate_power_multipoles :362``,
``calculate_power_wedges :514``, ``calculate_cross_power :1380``,
``calculate_masked_power :1408``, ``predicted_masked_power :1434``,
``calculate_power_1d :2396``, ``predicted_power_1d :2415``), with their
names, arguments, bins and returns.  Each runs on the field's device: the
forward transform is :func:`..ops.transform.rfftn` (K6, then forward K3
along y and x, on CUDA grids the kernels take), and the spectrum, never
scaled in place, goes straight to KB (:func:`..ops.binning.bin_spectrum`),
which forms each mode's power (with the cell volume folded into one
float32 factor a^6 / V), the interlaced combination, the window
deconvolution and the Legendre or wedge weights in one pass.

With a slab ``mesh=`` (the JAX package's ``_make_sharded_binned``,
``_make_mesh_interlaced``, ``_make_sharded_multipoles``,
``_make_sharded_wedges`` and ``_make_mesh_cross``) each field is this
rank's (nx/P, ny, nz) x slab: the distributed forward transform
(:func:`..parallel.dfft.rfftn_slab`) gives the rank's ky rows of the
spectrum, KB bins them at their ky offset (the window and the interlacing
phase are built from the global indices in the kernel), and one all-reduce
of the float64 sums gives every rank the whole field's result.  Interlaced
wedges refuse a mesh with ValueError, as in the JAX package; a pencil mesh
raises NotImplementedError (ROADMAP.md, Queue 1 item 5).  The JAX
package's ``_staged_field_power`` is not ported: it chunks the transform
for a 16 GB chip, and a 1024^3 field is 4.3 GB on an 80 GB card.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import binning as _binning
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["calculate_power", "calculate_power_multipoles",
           "calculate_power_wedges", "calculate_cross_power",
           "calculate_masked_power", "predicted_masked_power",
           "calculate_power_1d", "predicted_power_1d"]

_CHUNK = 64  # leading planes a step of calculate_power_1d


def _window_order(window):
    if window not in _binning.WINDOW_ORDERS:
        raise ValueError(
            f"unknown window {window!r}: expected None, 'ngp', 'cic' or 'tsc'")
    return _binning.WINDOW_ORDERS[window]


def _field(delta, name="delta"):
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"{name} must be one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    return delta


def _factor(shape, spacing):
    """float32 a^6 / V: |c|^2 / V of c = a^3 rfftn(delta), on the raw
    transform."""
    a3 = float(spacing) ** 3
    return float(np.float32(a3 * a3 / (shape[0] * shape[1] * shape[2] * a3)))


def _spectra(delta, interlaced_with, mesh=None):
    """('auto', (re, im)) of the field, or ('interlaced', (re, im, re2,
    im2)) with the half-cell-shifted painting."""
    local = tuple(int(s) for s in delta.shape)
    if interlaced_with is None:
        return "auto", _dfft.forward(delta, mesh)
    d2 = _field(interlaced_with, "interlaced_with")
    if tuple(d2.shape) != local or d2.device != delta.device:
        raise ValueError(f"interlaced_with must be a field of {local} on "
                         f"{delta.device}")
    return "interlaced", (*_dfft.forward(delta, mesh),
                          *_dfft.forward(d2, mesh))


def _sums(delta, spacing, nbins, window, interlaced_with, mesh=None, **out):
    """KB's float64 sums of the field's spectrum (on a mesh, of the rank's
    ky rows, then summed over the ranks)."""
    shape = _stats.mesh_shape(delta, mesh)
    order = _window_order(window)
    kind, arrays = _spectra(delta, interlaced_with, mesh)
    edges, _ = _stats.bin_setup(shape, float(spacing), int(nbins))
    acc = _binning.bin_spectrum(kind, arrays, shape, float(spacing), edges,
                                y_off=_stats.ky_offset(shape, mesh),
                                factor=_factor(shape, spacing), order=order,
                                **out)
    return _stats.mesh_sum(acc, mesh)


def calculate_power(delta, spacing, nbins=32, mesh=None, window=None,
                    interlaced_with=None):
    """Realized isotropic P(k) of a field, binned in log |k|.

    Returns host float64 ``(k_mean, p_hat, n_modes)``: per bin the
    mode-weighted mean |k|, the mean <|c_k|^2> / V with c_k = a^3 rfftn(delta),
    and the number of full-spectrum modes; empty bins give NaN.  Runs on
    ``delta``'s device.  ``window`` ('ngp', 'cic', 'tsc') deconvolves that
    mass-assignment window before binning; ``interlaced_with`` is the same
    catalog painted half a cell over in every axis, phase-aligned and
    averaged with ``delta``'s spectrum (alias cancellation).  With ``mesh``
    (a :class:`..parallel.mesh.SlabMesh`) ``delta`` (and ``interlaced_with``)
    is this rank's (nx/P, ny, nz) x slab: the distributed forward transform
    runs on the hand kernels, each rank bins its ky rows and one all-reduce
    sums them, so every rank returns the whole field's result.
    """
    mesh = _stats.slab_mesh("calculate_power", mesh)
    delta = _field(delta)
    nbins = int(nbins)
    acc = _sums(delta, float(spacing), nbins, window, interlaced_with, mesh)
    return _stats.bins_to_host(acc[0], nbins)


def calculate_power_multipoles(delta, spacing, nbins=32, ells=(0, 2, 4),
                               los_axis=2, window=None, interlaced_with=None,
                               mesh=None):
    """Power-spectrum multipoles P_ell(k) = (2 ell + 1) <L_ell(mu) |c_k|^2 /
    V> along a plane-parallel line of sight, mu = k_los / |k| (even ell
    only).  Returns ``(k_mean, p_ell, n_modes)``, ``p_ell`` shaped
    ``(len(ells), nbins)``; ``window``, ``interlaced_with`` and ``mesh``
    as in :func:`calculate_power`."""
    ells = _stats.check_ells(ells, "under Hermitian symmetry")
    mesh = _stats.slab_mesh("calculate_power_multipoles", mesh)
    delta = _field(delta)
    acc = _sums(delta, spacing, nbins, window, interlaced_with, mesh,
                ells=ells, los_axis=int(los_axis))
    return _stats.poles_to_host(acc, int(nbins))


def calculate_power_wedges(delta, spacing, nbins=32, nmu=4, los_axis=2,
                           window=None, interlaced_with=None, mesh=None):
    """Anisotropic P(k, mu) in joint bins of |k| (the estimator's shells)
    and ``nmu`` uniform |mu| wedges on [0, 1].  Returns ``(k_mean, p,
    n_modes)`` with ``p`` and ``n_modes`` shaped ``(nbins, nmu)`` and
    ``k_mean`` the shells' mean |k|; the count-weighted wedge average is
    :func:`calculate_power` bin for bin.  ``window`` and ``mesh`` as in
    :func:`calculate_power`; interlaced wedges run on one device (ValueError
    with a mesh, as in the JAX package)."""
    mesh = _stats.slab_mesh("calculate_power_wedges", mesh)
    if mesh is not None and interlaced_with is not None:
        raise ValueError("interlaced wedges are single-device; drop mesh=")
    delta = _field(delta)
    acc = _sums(delta, spacing, nbins, window, interlaced_with, mesh,
                nmu=int(nmu), los_axis=int(los_axis))
    return _stats.wedges_to_host(acc, int(nbins), int(nmu))


def calculate_cross_power(delta1, delta2, spacing, nbins=32, mesh=None):
    """Binned cross-spectrum Re<c1 c2*> / V of two fields on one grid, with
    the bins and conventions of :func:`calculate_power` (the cross power
    of a field with itself is its power).  Returns ``(k_mean, p_cross,
    n_modes)``.  ``mesh`` as in :func:`calculate_power`: both fields are
    this rank's x slabs."""
    mesh = _stats.slab_mesh("calculate_cross_power", mesh)
    d1, d2 = _field(delta1, "delta1"), _field(delta2, "delta2")
    if d1.shape != d2.shape or d1.device != d2.device:
        raise ValueError(f"fields must share a grid and a device, got "
                         f"{tuple(d1.shape)} vs {tuple(d2.shape)}")
    shape = _stats.mesh_shape(d1, mesh)
    edges, _ = _stats.bin_setup(shape, float(spacing), int(nbins))
    acc = _binning.bin_spectrum(
        "cross", (*_dfft.forward(d1, mesh), *_dfft.forward(d2, mesh)), shape,
        float(spacing), edges, y_off=_stats.ky_offset(shape, mesh),
        factor=_factor(shape, spacing))
    return _stats.bins_to_host(_stats.mesh_sum(acc, mesh)[0], int(nbins))


def calculate_masked_power(delta, mask, spacing, nbins=32, mesh=None):
    """Pseudo-P(k) of a survey-masked field: :func:`calculate_power` of
    ``mask * delta`` over <mask^2>; its expectation is
    :func:`predicted_masked_power`.  ``mask = 1`` is ``calculate_power``.
    With ``mesh`` the field and the mask are this rank's x slabs and
    <mask^2> is the whole field's (float64 sums, all-reduced)."""
    mesh = _stats.slab_mesh("calculate_masked_power", mesh)
    d = _field(delta)
    w = torch.as_tensor(mask).to(device=d.device, dtype=d.dtype)
    if tuple(w.shape) != tuple(d.shape):
        raise ValueError(f"mask shape {tuple(w.shape)} != field shape "
                         f"{tuple(d.shape)}")
    w2 = (torch.as_tensor(mask).to(d.device, torch.float64) ** 2).sum()
    w2 = float(_stats.mesh_sum(w2, mesh)) / float(
        np.prod(_stats.mesh_shape(d, mesh)))
    if w2 <= 0:
        raise ValueError("mask is identically zero")
    k, p, nm = calculate_power(w * d, spacing, nbins=nbins, mesh=mesh)
    return k, p / w2, nm


def predicted_masked_power(power, mask, spacing, nbins=32,
                           interpolation="log10k", device=None):
    """The exact expectation of :func:`calculate_masked_power`: the grid
    spectrum convolved with the window's power, E[P_m(k)] = sum_k' P(k')
    |W_hat(k - k')|^2 / (N sum W^2), by one host float64 FFT cycle, then
    binned on ``device`` (the mask's device if it is a tensor, else
    "cuda") with the estimator's own bins."""
    if device is None:
        device = mask.device if isinstance(mask, torch.Tensor) else "cuda"
    w = np.asarray(torch.as_tensor(mask).cpu().numpy(), np.float64)
    shape = w.shape
    if len(shape) != 3:
        raise ValueError("mask must be a 3-D grid")
    spacing = float(spacing)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    ks = [2.0 * np.pi * np.fft.fftfreq(n, d=spacing) for n in shape]
    kmag = np.sqrt(ks[0][:, None, None] ** 2 + ks[1][None, :, None] ** 2
                   + ks[2][None, None, :] ** 2)
    pg = _power.interpolate_power(
        table, torch.as_tensor(kmag, dtype=torch.float32),
        interpolation).numpy().astype(np.float64)
    pg[kmag == 0] = 0.0
    sum_w2 = (w * w).sum()
    if sum_w2 <= 0:
        raise ValueError("mask is identically zero")
    w_hat2 = np.abs(np.fft.fftn(w)) ** 2
    n3 = w.size
    conv = np.fft.fftn(np.fft.ifftn(pg) * np.fft.ifftn(w_hat2)).real * n3
    pm = conv / (n3 * sum_w2)
    nzh = shape[2] // 2 + 1
    half = torch.as_tensor(np.ascontiguousarray(pm[:, :, :nzh]),
                           dtype=torch.float32, device=device)
    return _stats.bin_power_grid(half, shape, spacing, nbins=nbins)


def calculate_power_1d(delta, spacing, los_axis=2):
    """Mean 1-D line-of-sight power of every skewer of a field: host float64
    ``(k_par, p1d)`` over the non-negative rfft frequencies of the LOS
    axis, per mode (no binning); its expectation is
    :func:`predicted_power_1d`.  The r2c along the line of sight is K6 on
    CUDA lengths it takes (the field moved so the LOS is minor), the skewer
    mean is summed in float64 x-slab by x-slab."""
    delta = torch.as_tensor(delta)
    if delta.ndim != 3:
        raise ValueError("calculate_power_1d expects one (nx, ny, nz) field")
    los_axis = int(los_axis)
    n_par = int(delta.shape[los_axis])
    k_par = 2.0 * np.pi * np.fft.rfftfreq(n_par, d=float(spacing))
    d = torch.movedim(delta.to(torch.float32), los_axis, -1)
    total = torch.zeros(n_par // 2 + 1, dtype=torch.float64,
                        device=delta.device)
    for chunk in d.split(_CHUNK):
        re, im = _transform.rfft_last(chunk.contiguous())
        total += (re * re + im * im).to(torch.float64).sum(dim=(0, 1))
    skewers = d.shape[0] * d.shape[1]
    p1d = total.cpu().numpy() / skewers * (float(spacing) / n_par)
    return k_par, p1d


def predicted_power_1d(power, shape, spacing, los_axis=2,
                       smoothing_length=0.0, interpolation="log10k",
                       pgrid=None, device="cuda"):
    """The exact per-mode expectation of :func:`calculate_power_1d`: the
    transverse-plane sum of the per-mode power over A_perp (for an x or y
    line of sight the kz multiplicities restore the unstored half).  P is
    interpolated on ``device`` as the render does (optionally smoothed),
    or ``pgrid`` (a per-mode expectation half-grid) is used as it is.
    Returns ``(k_par, e1d)`` float64."""
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    los_axis = int(los_axis)
    if pgrid is None:
        _, pg = _power.grid_power(power, shape, spacing, interpolation, device,
                                  smoothing_length)
    else:
        pg = torch.as_tensor(pgrid)
    pg = pg.to(torch.float64)
    nx, ny, nz = shape
    a_perp = ({0: ny * nz, 1: nx * nz, 2: nx * ny}[los_axis]
              * spacing * spacing)
    if los_axis == 2:
        e1d = pg.sum(dim=(0, 1)) / a_perp
        n_par = nz
    else:
        mult = torch.full((nz // 2 + 1,), 2.0, dtype=torch.float64,
                          device=pg.device)
        mult[0] = 1.0
        if nz % 2 == 0:
            mult[-1] = 1.0
        full = (pg * mult).sum(dim=2).sum(dim=1 if los_axis == 0 else 0)
        n_par = shape[los_axis]
        e1d = full[: n_par // 2 + 1] / a_perp
    k_par = 2.0 * np.pi * np.fft.rfftfreq(n_par, d=spacing)
    return k_par, e1d.cpu().numpy()
