"""Correlation functions: xi(r), its multipoles xi_ell(s) and the projected
w_p(r_p), measured and predicted.

Port of the single-device correlation estimators of
``randomfield_tpu/validate/stats.py`` (``calculate_correlation :2130``,
``predicted_correlation :2178``, ``calculate_correlation_multipoles
:1793``, ``predicted_correlation_multipoles :1839``,
``calculate_projected_correlation :1948``,
``predicted_projected_correlation :1974``).  The estimate is one inverse
transform of the per-mode power, xi_hat(r) = (1/V) sum_k P_hat(k)
exp(ik.r): the field's spectrum (:func:`..ops.transform.rfftn`: K6 and
forward K3 on CUDA) is squared in place into P_hat / V with the DC mode
zeroed, and :func:`..ops.transform.irfftn_reim` (K3, K3, K4) turns it into
the xi grid, which is binned by the periodic minimum-image separation in
linear bins from 0 to half the shortest side (the zero lag excluded).  The
predictions run the same transform and binning on the table's power
interpolated onto the grid's modes (optionally Kaiser-distorted), so
measured-vs-predicted residuals are pure sample noise.  The binning is
:func:`.stats.masked_bins` (float64 sums, a slot a line of the grid and
bin, so no float64 atomics collide) x-slab by x-slab, the
separations built in float64 on the device and rounded to float32 as the
JAX package rounds them.  Functions that take a field run on its device;
the predictions take ``device=`` ("cuda" by default).

With a slab ``mesh=`` (``_make_sharded_xi`` and ``_make_mesh_xi_multipoles``
of the JAX package) the field is this rank's (nx/P, ny, nz) x slab: the
distributed forward transform gives its ky rows of the spectrum, squared
in place with DC zeroed on the rank that holds it, the distributed inverse
gives its x rows of the xi grid, which it bins at its x offset, and one
all-reduce of the float64 sums gives every rank the whole grid's result.
The binning stays plain PyTorch on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import binning as _binning
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["calculate_correlation", "predicted_correlation",
           "calculate_correlation_multipoles",
           "predicted_correlation_multipoles",
           "calculate_projected_correlation",
           "predicted_projected_correlation"]

# x planes a step of the r binning (bounds its temporaries)
_X_CHUNK = 16


def _r_edges(shape, spacing, nbins):
    """Linear r bins over (0, half the shortest box side]."""
    return np.linspace(0.0, 0.5 * min(shape) * spacing, nbins + 1)


def _min_image_axes(shape, spacing, device):
    """Per-axis periodic minimum-image distances, float64 on ``device``."""
    return [torch.as_tensor(np.minimum(np.arange(n), n - np.arange(n))
                            * float(spacing), dtype=torch.float64,
                            device=device) for n in shape]


def _field_xi(delta, spacing, mesh=None):
    """The xi grid of a field: |c|^2 / V^2 of its spectrum (DC zeroed)
    through the inverse transform; float32 (nx, ny, nz) on its device (on
    a mesh, this rank's x slab of it), and the whole grid's shape."""
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"delta must be one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    shape = _stats.mesh_shape(delta, mesh)
    re, im = _dfft.forward(delta, mesh)
    a3 = float(spacing) ** 3
    volume = shape[0] * shape[1] * shape[2] * a3
    factor = float(np.float32(a3 * a3 / (volume * volume)))
    re.mul_(re).addcmul_(im, im).mul_(factor)
    if _stats.ky_offset(shape, mesh) == 0:
        re[0, 0, 0] = 0.0
    im.zero_()
    return _dfft.inverse(re, im, shape, mesh), shape


def _grid_xi(pgrid, shape, spacing):
    """The xi grid of a per-mode power half-grid: irfftn of P / V."""
    volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
    re = (pgrid.to(torch.float32) / volume).contiguous()
    return _transform.irfftn_reim(re, torch.zeros_like(re), shape)


def _xi_bins(xi, shape, spacing, nbins, ells=(0,), los_axis=2, mesh=None):
    """(r_mean, xi_ell (len(ells), nbins), n_cells) of a xi grid binned by
    minimum-image |r| with (2l + 1) L_l(mu^2) weights, mu = r_los / |r|; on
    a mesh ``xi`` is this rank's x slab, binned at its x offset, and the
    sums are all-reduced."""
    dev = xi.device
    ax = _min_image_axes(shape, spacing, dev)
    if mesh is not None:
        x0, nx_loc = mesh.rows(shape[0])
        ax[0] = ax[0][x0:x0 + nx_loc]
    edges = torch.as_tensor(_r_edges(shape, spacing, nbins),
                            dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    out = torch.zeros((len(ells), 3, nbins + 1), dtype=torch.float64,
                      device=dev)
    for x0 in range(0, xi.shape[0], _X_CHUNK):
        x1 = min(xi.shape[0], x0 + _X_CHUNK)
        d2 = [(ax[0][x0:x1] ** 2)[:, None, None], (ax[1] ** 2)[None, :, None],
              (ax[2] ** 2)[None, None, :]]
        r2 = d2[0] + d2[1] + d2[2]
        rmag = torch.sqrt(r2).to(torch.float32)
        mu2 = None
        if ells != (0,):
            mu2 = torch.where(r2 > 0, d2[los_axis] / torch.where(r2 > 0, r2, 1.0),
                              0.0).to(torch.float32)
        for i, ell in enumerate(ells):
            val = _binning.legendre_weighted(ell, mu2, xi[x0:x1])
            _stats.masked_bins(rmag, one, val, edges, nbins, out[i])
    a = _stats.mesh_sum(out, mesh)[:, :, :nbins].cpu().numpy()
    counts, rsum = a[0, 0], a[0, 2]
    with np.errstate(invalid="ignore", divide="ignore"):
        return rsum / counts, a[:, 1] / counts, counts


def _table_pgrid(power, shape, spacing, interpolation, device, f=0.0,
                 los_axis=2):
    """The table's P interpolated onto the grid's modes (0 at DC), times
    the Kaiser factor (1 + f mu_k^2)^2 when ``f``; float32 on ``device``."""
    kmag, pgrid = _power.grid_power(power, shape, spacing, interpolation,
                                    device)
    if f:
        klos = _grid.kvectors(shape, float(spacing), torch.float32,
                              device)[int(los_axis)]
        kshp = [1, 1, 1]
        kshp[int(los_axis)] = klos.shape[0]
        t = klos.reshape(kshp) / torch.where(kmag > 0, kmag, 1.0)
        mu2k = torch.where(kmag > 0, t * t, 0.0)
        g = 1.0 + float(f) * mu2k
        pgrid = pgrid * (g * g)
    return pgrid


def calculate_correlation(delta, spacing, nbins=24, mesh=None):
    """Measured isotropic two-point correlation xi(r) of a field.

    Returns host float64 ``(r_mean, xi_hat, n_cells)``: per bin the
    cell-weighted mean separation, the mean correlation and the number of
    cells; bins are linear in r from 0 to half the shortest side, the zero
    lag excluded, empty bins NaN.  Runs on ``delta``'s device; with a slab
    ``mesh`` ``delta`` is this rank's x slab and every rank gets the whole
    field's result (module docstring).  Its expectation on the same modes
    and bins is :func:`predicted_correlation`.
    """
    mesh = _stats.slab_mesh("calculate_correlation", mesh)
    xi, shape = _field_xi(delta, spacing, mesh)
    r, x, n = _xi_bins(xi, shape, float(spacing), int(nbins), mesh=mesh)
    return r, x[0], n


def predicted_correlation(power, shape, spacing, nbins=24,
                          interpolation="log10k", device="cuda"):
    """The exact expectation of :func:`calculate_correlation` for a power
    table: P on the grid's modes through the same transform and bins, on
    ``device``.  Returns ``(r_mean, xi, n_cells)``."""
    shape = tuple(int(s) for s in shape)
    pgrid = _table_pgrid(power, shape, spacing, interpolation, device)
    r, x, n = _xi_bins(_grid_xi(pgrid, shape, spacing), shape,
                       float(spacing), int(nbins))
    return r, x[0], n


def calculate_correlation_multipoles(delta, spacing, nbins=24,
                                     ells=(0, 2, 4), los_axis=2, mesh=None):
    """Correlation multipoles xi_ell(s) = (2 ell + 1) <L_ell(mu) xi(s, mu)>
    along a plane-parallel line of sight, mu = s_los / |s| (even ell).
    Returns ``(r_mean, xi_ell, n_cells)``, ``xi_ell`` shaped
    ``(len(ells), nbins)``; ``ells=(0,)`` is :func:`calculate_correlation`.
    ``mesh`` as in :func:`calculate_correlation`."""
    ells = _stats.check_ells(ells)
    mesh = _stats.slab_mesh("calculate_correlation_multipoles", mesh)
    xi, shape = _field_xi(delta, spacing, mesh)
    return _xi_bins(xi, shape, float(spacing), int(nbins), ells,
                    int(los_axis), mesh)


def predicted_correlation_multipoles(power, shape, spacing, f=0.0, nbins=24,
                                     ells=(0, 2, 4), los_axis=2,
                                     interpolation="log10k", device="cuda"):
    """The expectation of :func:`calculate_correlation_multipoles` for a
    power table, optionally Kaiser-distorted ((1 + f mu_k^2)^2, ``f`` the
    growth rate), through the same transform and binning on ``device``."""
    shape = tuple(int(s) for s in shape)
    ells = _stats.check_ells(ells)
    pgrid = _table_pgrid(power, shape, spacing, interpolation, device, f,
                         los_axis)
    return _xi_bins(_grid_xi(pgrid, shape, spacing), shape, float(spacing),
                    int(nbins), ells, int(los_axis))


def _resolve_pi_max(pi_max, shape, spacing, los_axis):
    if pi_max is None:
        return 0.5 * shape[int(los_axis)] * spacing
    return float(pi_max)


def _wp_bins(xi, shape, spacing, nbins, pi_max, los_axis):
    """(rp_mean, w_p, n_cells): the masked LOS lag sum Delta sum_{|pi| <=
    pi_max} xi(r_p, pi) of the xi grid, binned in r_p over (0, half the
    shortest transverse side]."""
    dev = xi.device
    ax = _min_image_axes(shape, spacing, dev)
    w_pi = torch.where(ax[los_axis] <= pi_max * (1.0 + 1e-9), float(spacing),
                       0.0)
    shp = [1, 1, 1]
    shp[los_axis] = shape[los_axis]
    wmap = (xi.to(torch.float64) * w_pi.reshape(shp)).sum(dim=los_axis)
    tr = [a for a in range(3) if a != los_axis]
    rp = torch.sqrt((ax[tr[0]] ** 2)[:, None] + (ax[tr[1]] ** 2)[None, :])
    edges = np.linspace(0.0, 0.5 * min(shape[tr[0]], shape[tr[1]]) * spacing,
                        nbins + 1)
    out = torch.zeros((3, nbins + 1), dtype=torch.float64, device=dev)
    _stats.masked_bins(rp.to(torch.float32),
                       torch.ones((), dtype=torch.float32, device=dev),
                       wmap.to(torch.float32),
                       torch.as_tensor(edges, dtype=torch.float32, device=dev),
                       nbins, out)
    return _stats.bins_to_host(out, nbins)


def calculate_projected_correlation(delta, spacing, nbins=24, pi_max=None,
                                    los_axis=2):
    """Projected correlation w_p(r_p) = 2 int_0^pi_max xi(r_p, pi) dpi along
    a plane-parallel line of sight, as a minimum-image LOS lag sum of the
    xi grid; ``pi_max`` defaults to half the LOS side.  Returns
    ``(rp_mean, wp, n_cells)``; w_p in units of length.  Its expectation is
    :func:`predicted_projected_correlation`."""
    xi, shape = _field_xi(delta, spacing)
    los_axis = int(los_axis)
    pi_max = _resolve_pi_max(pi_max, shape, float(spacing), los_axis)
    return _wp_bins(xi, shape, float(spacing), int(nbins), pi_max, los_axis)


def predicted_projected_correlation(power, shape, spacing, f=0.0, nbins=24,
                                    pi_max=None, los_axis=2,
                                    interpolation="log10k", device="cuda"):
    """The expectation of :func:`calculate_projected_correlation` for a
    power table, optionally Kaiser-distorted, through the same transform,
    LOS sum and binning on ``device``."""
    shape = tuple(int(s) for s in shape)
    los_axis = int(los_axis)
    pgrid = _table_pgrid(power, shape, spacing, interpolation, device, f,
                         los_axis)
    pi_max = _resolve_pi_max(pi_max, shape, float(spacing), los_axis)
    return _wp_bins(_grid_xi(pgrid, shape, spacing), shape, float(spacing),
                    int(nbins), pi_max, los_axis)
