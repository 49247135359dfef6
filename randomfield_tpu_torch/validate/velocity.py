"""Pairwise-velocity statistics: measured and exactly predicted.

Port of ``randomfield_tpu/validate/velocity.py`` with its names, arguments
and returns.  The mean pairwise velocity v12(r) is, to linear order,

    v12(r) = 2 <delta(x) v_r(x + r)> / (1 + xi(r)),

with v_r the velocity along the separation (r points from the density
point to the velocity point; infall is negative).  MEASURE: per velocity
component the cross spectrum conj(delta_k) v_k of the two fields'
forward transforms (:func:`..ops.transform.rfftn`: K6 and forward K3 on
CUDA), an inverse transform (:func:`..ops.transform.irfftn_reim`: K3, K3,
K4), the projection onto the signed minimum-image direction and the
|r|-shell binning of ``validate/correlation.py``.  PREDICT: the same
projection and binning of the expected cross spectrum i pref (k_j / k^2)
P(k) on the grid's modes (pref = a H f / h), so residuals are sample
noise; with the realized |c_k|^2 / V for P the prediction reproduces the
measurement.  The continuum psi_r(r) = -(pref / 2 pi^2) int dk k P(k)
j_1(kr) is FFTLog's (host float64).

The JAX package builds |r| and the three unit vectors as host float64
grids (34 GB at 1024^3); here each x slab builds them on the device in
float64 from the axes and rounds them to float32 as the JAX package does,
and the projection accumulates component by component in the JAX order
((psi_x e_x + psi_y e_y) + psi_z e_z), so one inverse-transformed
component is held at a time.  Tensor fields run on their device, numpy
fields and predictions on ``device`` ("cuda" by default); ``mesh=`` raises
NotImplementedError (ROADMAP.md, Queue 1 item 8).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.models.cosmology import create_cosmology
from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate import correlation as _corr
from randomfield_tpu_torch.validate import stats as _stats

__all__ = [
    "density_velocity_correlation",
    "predicted_density_velocity_correlation",
    "pairwise_velocity",
    "predicted_pairwise_velocity",
    "continuum_pairwise_velocity",
]

# x planes a step of the projection and binning (bounds its temporaries)
_X_CHUNK = 16


def _velocity_prefactor(cosmology, z):
    """a H f / h in km/s per Mpc/h (:func:`..ops.derived.velocity_prefactor`)."""
    return _derived.velocity_prefactor(create_cosmology(cosmology), z)


def _signed_axes(shape, spacing, device):
    """Per-axis SIGNED minimum-image displacements, float64 on ``device``:
    index i -> i for i <= n/2, i - n above (the i = n/2 plane keeps +)."""
    out = []
    for n in shape:
        i = np.arange(n)
        out.append(torch.as_tensor(np.where(i <= n // 2, i, i - n)
                                   * float(spacing), dtype=torch.float64,
                                   device=device))
    return out


def _unit_slab(ax, x0, x1, j=None):
    """|r| (``j`` None) or the unit vector's component e_j of x rows
    [x0, x1), float32: built in float64 from the signed axes and rounded
    once, as the JAX package's ``_signed_unit_r`` rounds its host grids."""
    s = (ax[0][x0:x1][:, None, None], ax[1][None, :, None],
         ax[2][None, None, :])
    r = torch.sqrt((s[0] * s[0] + s[1] * s[1]) + s[2] * s[2])
    if j is None:
        return r.to(torch.float32)
    r = torch.where(r > 0, 1.0 / torch.where(r > 0, r, 1.0), 0.0)
    return r.mul_(s[j]).to(torch.float32)


def _psi_bins(crosses, shape, spacing, nbins, device):
    """(r_mean, psi_r, counts) of the per-component cross spectra:
    ``crosses(j)`` gives the (re, im) half-grid whose raw inverse transform
    is psi_j(r); projected on r-hat and binned by |r|."""
    ax = _signed_axes(shape, spacing, device)
    psi_r = None
    for j in range(3):
        psi_j = _transform.irfftn_reim(*crosses(j), shape)
        for x0 in range(0, shape[0], _X_CHUNK):
            x1 = min(shape[0], x0 + _X_CHUNK)
            term = psi_j[x0:x1] * _unit_slab(ax, x0, x1, j)
            if psi_r is None:
                psi_j[x0:x1] = term
            else:
                psi_r[x0:x1] += term
        if psi_r is None:
            psi_r = psi_j
        del psi_j
    edges = torch.as_tensor(_corr._r_edges(shape, spacing, nbins),
                            dtype=torch.float32, device=device)
    one = torch.ones((), dtype=torch.float32, device=device)
    out = torch.zeros((3, nbins + 1), dtype=torch.float64, device=device)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        _stats.masked_bins(_unit_slab(ax, x0, x1), one, psi_r[x0:x1], edges,
                           nbins, out)
    return _stats.bins_to_host(out, nbins)


def density_velocity_correlation(delta, velocity, spacing, nbins=24,
                                 mesh=None, device=None):
    """Measured psi_r(r) = <delta(x) v_r(x + r)> in |r| shells.

    ``velocity``: (3, nx, ny, nz) km/s (``Generator.generate_velocity`` of
    the seed of ``delta``).  Returns host float64 ``(r_mean, psi_r,
    counts)``, psi_r in km/s, negative for infall; on ``delta``'s device
    (``device`` for a numpy field, "cuda" by default).
    """
    if mesh is not None:
        raise _stats.mesh_not_ported("density_velocity_correlation", mesh)
    dev = _stats.device_of(delta, device)
    delta = torch.as_tensor(delta, device=dev)
    velocity = torch.as_tensor(velocity, device=dev)
    shape = tuple(int(s) for s in delta.shape[-3:])
    if tuple(velocity.shape) != (3, *shape):
        raise ValueError(
            f"velocity must have shape (3, *{shape}), got "
            f"{tuple(velocity.shape)}")
    spacing = float(spacing)
    volume = shape[0] * shape[1] * shape[2] * spacing**3
    # conj(a^3 F_d) (a^3 F_v) / V / V on the raw transforms
    fac = float(np.float32(spacing**6 / (volume * volume)))
    dre, dim = _transform.rfftn(delta)

    def crosses(j):
        vre, vim = _transform.rfftn(velocity[j].contiguous())
        re = dre * vre
        re.addcmul_(dim, vim).mul_(fac)
        vre.mul_(dim)
        vim.mul_(dre).sub_(vre).mul_(fac)
        del vre
        return re, vim

    return _psi_bins(crosses, shape, spacing, int(nbins), delta.device)


def _pgrid_from_table(power, shape, spacing, interpolation,
                      smoothing_length, device):
    """float64 per-mode P on ``device``: the table at the float32 |k|, the
    render's filter exp(-(k L)^2) in float64, 0 at DC."""
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    km = _grid.kmag(shape, spacing, torch.float32, device)
    pg = _power.interpolate_power(table, km, interpolation).to(torch.float64)
    km = km.to(torch.float64)
    if smoothing_length:
        pg = pg * torch.exp(-((km * float(smoothing_length)) ** 2))
    return torch.where(km == 0, 0.0, pg)


def _expected_crosses(pgrid, shape, spacing, pref):
    """crosses(j) of :func:`_psi_bins` for the expected cross spectrum
    i pref (k_j / k^2) P / V, float32 as the JAX package rounds it."""
    dev = pgrid.device
    kv = _grid.kvectors(shape, spacing, torch.float32, dev)
    k2 = _grid.ksq(shape, spacing, torch.float32, dev).to(torch.float64)
    pg = torch.as_tensor(pgrid, device=dev).to(torch.float64)
    base = torch.where(k2 > 0, pg / torch.where(k2 > 0, k2, 1.0), 0.0)
    del k2
    pref32 = float(np.float32(pref))
    volume = float(np.float32(shape[0] * shape[1] * shape[2] * spacing**3))
    view = ((slice(None), None, None), (None, slice(None), None),
            (None, None, slice(None)))

    def crosses(j):
        im = (kv[j].to(torch.float64)[view[j]] * base).to(torch.float32)
        im = (pref32 * im) / volume
        return torch.zeros_like(im), im

    return crosses


def predicted_density_velocity_correlation(power, shape, spacing,
                                           cosmology=None, z=0.0, nbins=24,
                                           interpolation="log10k",
                                           smoothing_length=0.0,
                                           pgrid=None, device="cuda"):
    """EXACT binned expectation of :func:`density_velocity_correlation`:
    i pref (k_j / k^2) P(k) through the same inverse transform, projection
    and binning (P damped by exp(-(k L)^2) when ``smoothing_length``).
    ``pgrid`` (a per-mode half grid, e.g. the realized |c_k|^2 / V)
    overrides the table and reproduces the measurement.  Returns
    ``(r_mean, psi_r, counts)``; runs on ``device`` (``pgrid``'s when it is
    a tensor)."""
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    if isinstance(pgrid, torch.Tensor):
        device = pgrid.device
    if pgrid is None:
        pgrid = _pgrid_from_table(power, shape, spacing, interpolation,
                                  smoothing_length, device)
    pgrid = torch.as_tensor(pgrid, device=device)
    pref = _velocity_prefactor(cosmology, z)
    return _psi_bins(_expected_crosses(pgrid, shape, spacing, pref), shape,
                     spacing, int(nbins), pgrid.device)


def pairwise_velocity(delta, velocity, spacing, nbins=24, mesh=None,
                      device=None):
    """Measured linear-order mean pairwise velocity v12 = 2 psi_r / (1 +
    xi) [km/s] from the same fields in the same |r| shells.  Returns
    ``(r_mean, v12, counts)``; negative = infall."""
    if mesh is not None:
        raise _stats.mesh_not_ported("pairwise_velocity", mesh)
    delta = torch.as_tensor(delta, device=_stats.device_of(delta, device))
    r, psi, counts = density_velocity_correlation(delta, velocity, spacing,
                                                  nbins)
    xi = _corr.calculate_correlation(delta, spacing, nbins)[1]
    with np.errstate(invalid="ignore", divide="ignore"):
        return r, 2.0 * psi / (1.0 + xi), counts


def predicted_pairwise_velocity(power, shape, spacing, cosmology=None,
                                z=0.0, nbins=24, interpolation="log10k",
                                smoothing_length=0.0, device="cuda"):
    """Exact binned expectation of :func:`pairwise_velocity` at leading
    order: 2 E[psi_r] / (1 + E[xi]) bin by bin.  Returns ``(r_mean, v12,
    counts)``."""
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    pgrid = _pgrid_from_table(power, shape, spacing, interpolation,
                              smoothing_length, device)
    r, psi, counts = predicted_density_velocity_correlation(
        power, shape, spacing, cosmology, z, nbins, interpolation,
        smoothing_length, pgrid=pgrid)
    xi_grid = _corr._grid_xi(pgrid.to(torch.float32), shape, spacing)
    xi = _corr._xi_bins(xi_grid, shape, spacing, int(nbins))[1][0]
    with np.errstate(invalid="ignore", divide="ignore"):
        return r, 2.0 * psi / (1.0 + xi), counts


def continuum_pairwise_velocity(power, r, cosmology=None, z=0.0, n=2048,
                                pad_decades=3.0):
    """Continuum linear-theory psi_r and v12 at separations ``r`` by FFTLog
    (host float64): psi_r = -(pref / 2 pi^2) int dk k P(k) j_1(kr), v12 =
    2 psi_r / (1 + xi(r)).  Returns ``(psi_r, v12)``."""
    from randomfield_tpu_torch.ops.fftlog import (
        _prep_power, fftlog_bessel, xi_from_power,
    )

    r = np.asarray(r, np.float64)
    pref = _velocity_prefactor(cosmology, z)
    kg, pg = _prep_power(power, n, pad_decades)
    rg, g = fftlog_bessel(kg, kg**2 * pg / (2.0 * np.pi**2), ell=1, q=1.0)
    psi = -pref * np.interp(r, rg, g)
    rx, xi = xi_from_power(power, ell=0, n=n, pad_decades=pad_decades,
                           rmin=rg[0], rmax=rg[-1])
    xi_r = np.interp(r, rx, xi)
    return psi, 2.0 * psi / (1.0 + xi_r)
