"""One-point statistics: moments, the value PDF, counts-in-cells variance.

Port of ``randomfield_tpu/validate/stats.py``'s ``field_moments :2355``,
``field_pdf :2220``, ``cell_variance :2259`` and ``predicted_cell_variance
:2280``.  Each runs on the field's device and sums in float64, x-slab by
x-slab, so no float32 running sum saturates at any grid size (the reason
of the JAX package's axiswise reductions); the prediction takes
``device=`` ("cuda" by default).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import binning as _binning
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["field_moments", "field_pdf", "cell_variance",
           "predicted_cell_variance"]

# leading planes a step (bounds the float64 temporaries)
_CHUNK = 16


def field_moments(delta, mesh=None):
    """(mean, variance) of a field as host floats.

    Two passes over x slabs of ``delta`` on its device, each slab summed in
    float64.  With a slab ``mesh`` ``delta`` is this rank's x slab: each
    rank sums its count, its sum and its squared deviations from its own
    mean in float64, one all-reduce adds (sum, squares + n mean^2) over the
    ranks, and every rank returns the whole field's moments.
    """
    mesh = _stats.slab_mesh("field_moments", mesh)
    delta = torch.as_tensor(delta)
    if mesh is not None:
        return _mesh_moments(delta, mesh)
    n = delta.numel()
    total = torch.zeros((), dtype=torch.float64, device=delta.device)
    for chunk in delta.split(_CHUNK):
        total += chunk.to(torch.float64).sum()
    mean = total / n
    total.zero_()
    for chunk in delta.split(_CHUNK):
        total += ((chunk.to(torch.float64) - mean) ** 2).sum()
    return float(mean), float(total / n)


def _mesh_moments(delta, mesh):
    """:func:`field_moments` of the whole field from this rank's slab."""
    n_loc = delta.numel()
    mean_loc, var_loc = field_moments(delta)
    acc = torch.tensor([mean_loc * n_loc,
                        (var_loc + mean_loc * mean_loc) * n_loc],
                       dtype=torch.float64, device=delta.device)
    total, squares = mesh.all_reduce_sum(acc).tolist()
    n = n_loc * mesh.size
    mean = total / n
    return mean, squares / n - mean * mean


def field_pdf(delta, nbins=64, vmin=None, vmax=None):
    """One-point PDF of field values: linear bins over [vmin, vmax]
    (default: the field's min and max stretched by 1e-3 of the span),
    np.histogram's edge rules.  Returns ``(centers, density, counts)``:
    the per-bin mean value (NaN when empty), the density normalized so
    sum(density * width) is the in-range fraction, and the counts."""
    d = torch.as_tensor(delta)
    if vmin is None or vmax is None:
        lo, hi = float(d.min()), float(d.max())
        span = (hi - lo) or 1.0
        vmin = lo - 1e-3 * span if vmin is None else float(vmin)
        vmax = hi + 1e-3 * span if vmax is None else float(vmax)
    if not vmax > vmin:
        raise ValueError(f"need vmax > vmin, got [{vmin}, {vmax}]")
    nbins = int(nbins)
    edges = np.linspace(float(vmin), float(vmax), nbins + 1)
    edges_t = torch.as_tensor(edges, dtype=d.dtype, device=d.device)
    acc = torch.zeros((2, nbins + 1), dtype=torch.float64, device=d.device)
    flat = d.reshape(d.shape[0], -1) if d.ndim >= 2 else d.reshape(1, -1)
    for chunk in flat.split(_CHUNK):
        x = chunk.contiguous()
        idx = torch.searchsorted(edges_t, x, right=True) - 1
        idx = torch.where(x == edges_t[-1], nbins - 1, idx)
        valid = (idx >= 0) & (idx < nbins)
        idx = torch.where(valid, idx, nbins)
        acc[0] += _binning.line_sums(idx, valid, nbins + 1)
        acc[1] += _binning.line_sums(idx, torch.where(valid, x, 0.0),
                                     nbins + 1)
    counts, vsum = acc[:, :nbins].cpu().numpy()
    width = edges[1] - edges[0]
    with np.errstate(invalid="ignore", divide="ignore"):
        centers = vsum / counts
    return centers, counts / (float(d.numel()) * width), counts


def cell_variance(delta, m):
    """(mean, variance) of the m^3-cell block averages of a field (every
    axis divisible by m), host floats; ``m=1`` is :func:`field_moments`.
    Its expectation is :func:`predicted_cell_variance`."""
    d = torch.as_tensor(delta)
    nx, ny, nz = (int(s) for s in d.shape[-3:])
    m = int(m)
    if m < 1 or nx % m or ny % m or nz % m:
        raise ValueError(
            f"block size {m} must divide every grid axis {(nx, ny, nz)}")
    blocks = d.reshape(nx // m, m, ny // m, m, nz // m, m).mean(dim=(1, 3, 5))
    return field_moments(blocks)


def predicted_cell_variance(power, shape, spacing, m, interpolation="log10k",
                            device="cuda"):
    """The exact expectation of :func:`cell_variance`'s variance: sum_k P(k)
    |W(k)|^2 / V over the grid's modes, W the product of the m-cell
    Dirichlet kernels sin(m k_a a / 2) / (m sin(k_a a / 2)); float64 on
    ``device``.  ``m=1`` is the render's predicted variance."""
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    m = int(m)
    if m < 1 or any(s % m for s in shape):
        raise ValueError(f"block size {m} must divide every axis {shape}")
    _, pgrid = _power.grid_power(power, shape, spacing, interpolation, device)
    pgrid = pgrid.to(torch.float64)

    def dirichlet(k):
        x = k.to(torch.float64) * spacing / 2.0
        s = torch.sin(x)
        nonzero = s.abs() > 0
        return torch.where(nonzero, torch.sin(m * x)
                           / (m * torch.where(nonzero, s, 1.0)), 1.0)

    kx, ky, kz = _grid.kvectors(shape, spacing, torch.float32, device)
    w2 = ((dirichlet(kx) ** 2)[:, None, None]
          * (dirichlet(ky) ** 2)[None, :, None]
          * (dirichlet(kz) ** 2)[None, None, :])
    _, mult = _stats.bin_setup(shape, spacing, 1)
    mult = torch.as_tensor(mult, dtype=torch.float64, device=device)
    volume = shape[0] * shape[1] * shape[2] * spacing ** 3
    return float((pgrid * w2 * mult).sum() / volume)
