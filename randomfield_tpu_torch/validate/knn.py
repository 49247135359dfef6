"""k-nearest-neighbour CDFs of tracer catalogs, with exact random gates.

Port of ``randomfield_tpu/validate/knn.py`` (one device).  The kNN-CDF
(Banerjee & Abel 2021) is the CDF of the distance from volume-filling
query points to their k-th nearest tracer; by the counting identity

    P(d_k <= r) = P(N(< r) >= k)

it is the fraction of lattice cells whose periodic lattice ball of radius
r holds at least k tracers.  N(< r) at every cell is one FFT convolution
of the NGP count grid with the exact ball indicator (float64 r^2 against
r^2 + 1e-9 a^2, built on the device), rounded to integers, so the CDF is
exact; the cells are counted in int64, where the JAX package sums float32
(exact only below 2^24 cells).  The transforms are
:func:`..ops.transform.rfftn` and :func:`..ops.transform.irfftn_reim` (K6,
K3, K4 on CUDA); a ball's spectrum is real (the ball is symmetric), and
its real part is kept per grid, spacing, radius and device, so a ladder of
radii costs one forward transform of the counts and one inverse a radius
on every later call.  :func:`knn_cdf_positions` paints the catalog with
KP's NGP deposit (:func:`..ops.paint.deposit`: exact int64 counts).  For a
uniform random catalog of n tracers on M cells, N(< r) is Binomial(n,
m(r)/M) at every cell (:func:`random_knn_cdf`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from randomfield_tpu_torch.ops import paint as _paint
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate.stats import mesh_not_ported

__all__ = [
    "lattice_ball_sizes",
    "count_in_spheres",
    "knn_cdf",
    "knn_cdf_positions",
    "random_knn_cdf",
]

# ball spectra kept (each nx ny (nz/2 + 1) float32: 2 GiB at 1024^3)
_BALL_CACHE = 8
# x planes a step of the ball's indicator (bounds its float64 temporary)
_X_CHUNK = 16


def _min_image_ax(n, spacing, device):
    return torch.as_tensor(np.minimum(np.arange(n), n - np.arange(n))
                           * float(spacing), dtype=torch.float64,
                           device=device)


def _ball_indicator(shape, spacing, radius, device="cpu"):
    """The periodic lattice ball's float32 0/1 indicator on ``device``:
    minimum-image r^2 in float64 against radius^2 + 1e-9 spacing^2."""
    ax = [_min_image_ax(n, spacing, device) for n in shape]
    lim = float(radius) ** 2 + 1e-9 * float(spacing) ** 2
    out = torch.empty(tuple(shape), dtype=torch.float32, device=device)
    ay2, az2 = (ax[1] ** 2)[None, :, None], (ax[2] ** 2)[None, None, :]
    for x0 in range(0, shape[0], _X_CHUNK):
        ax2 = (ax[0][x0:x0 + _X_CHUNK] ** 2)[:, None, None]
        torch.le((ax2 + ay2) + az2, lim, out=out[x0:x0 + _X_CHUNK])
    return out


def lattice_ball_sizes(shape, spacing, radii):
    """Number of lattice cells in the periodic ball of each radius (host
    float64 r^2, a plane at a time)."""
    shape = tuple(int(s) for s in shape)
    ax = [np.minimum(np.arange(n), n - np.arange(n)) * float(spacing)
          for n in shape]
    out = []
    for r in radii:
        lim = float(r) ** 2 + 1e-9 * float(spacing) ** 2
        out.append(int(sum(
            np.count_nonzero((a**2 + ax[1][:, None] ** 2)
                             + ax[2][None, :] ** 2 <= lim) for a in ax[0])))
    return np.array(out)


@functools.lru_cache(maxsize=_BALL_CACHE)
def _ball_spectrum(shape, spacing, radius, device):
    """The ball's physical spectrum times 1 / a^3 (the convolution's
    scale), which is rfftn of the indicator: its real part, float32 (nx,
    ny, nz/2 + 1) on ``device`` (the imaginary part of a symmetric ball's
    is rounding)."""
    return _transform.rfftn(_ball_indicator(shape, spacing, radius,
                                            device))[0]


def _count_spectrum(counts, spacing):
    counts = torch.as_tensor(counts).to(torch.float32)
    if counts.ndim != 3:
        raise ValueError(f"counts must be one (nx, ny, nz) grid, got "
                         f"{tuple(counts.shape)}")
    re, im = _transform.rfftn(counts)
    a3 = float(np.float32(float(spacing) ** 3))
    return tuple(int(s) for s in counts.shape), re.mul_(a3), im.mul_(a3)


def _n_in_ball(shape, re, im, spacing, radius, device):
    """N(< radius) at every cell, rounded: the count spectrum times the
    ball's through the synthesis."""
    kk = _ball_spectrum(shape, float(spacing), float(radius), str(device))
    field = _transform.spectrum_to_field((re * kk, im * kk), spacing, shape)
    return torch.round(field)


def count_in_spheres(counts, spacing, radius):
    """Integer tracer count within ``radius`` of every cell (periodic
    lattice ball, one FFT convolution, rounded), float32 on the counts'
    device."""
    shape, re, im = _count_spectrum(counts, spacing)
    return _n_in_ball(shape, re, im, float(spacing), radius, re.device)


def knn_cdf(counts, spacing, radii, ks=(1, 2, 3), mesh=None):
    """kNN-CDFs from an NGP tracer count grid: CDF_k(r) = P(N(< r) >= k)
    over every lattice cell, shaped ``(len(ks), len(radii))`` (host
    float64; the cells counted in int64).  One forward transform, and an
    inverse a radius.  ``mesh`` raises NotImplementedError."""
    ks = tuple(int(k) for k in ks)
    if any(k < 1 for k in ks):
        raise ValueError(f"ks must be >= 1, got {ks}")
    if mesh is not None:
        raise mesh_not_ported("knn_cdf", mesh)
    shape, re, im = _count_spectrum(counts, spacing)
    ncells = shape[0] * shape[1] * shape[2]
    out = np.empty((len(ks), len(radii)), np.float64)
    for j, r in enumerate(radii):
        n_r = _n_in_ball(shape, re, im, float(spacing), float(r), re.device)
        hits = torch.stack([(n_r >= k).sum() for k in ks]).cpu().numpy()
        out[:, j] = hits / ncells
    return out


def knn_cdf_positions(positions, shape, spacing, radii, ks=(1, 2, 3),
                      mesh=None):
    """kNN-CDFs of tracer positions ((3, ...), rounded to float32; periodic
    box), painted with KP's NGP deposit (exact int64 counts)."""
    if mesh is not None:
        raise mesh_not_ported("knn_cdf_positions", mesh)
    positions = torch.as_tensor(positions)
    positions = positions.to(torch.float32)  # as the JAX package holds them
    if positions.shape[0] != 3:
        raise ValueError(f"positions must be (3, ...), got "
                         f"{tuple(positions.shape)}")
    counts = _paint.deposit(positions, tuple(int(s) for s in shape),
                            float(spacing), order=1)
    return knn_cdf(counts.to(torch.float32), spacing, radii, ks)


def _log_binom_cdf_tail(kmax, n, p):
    """log-stable Binomial P(N <= kmax) for small kmax (host float64)."""
    if p >= 1.0:
        return 0.0 if kmax < n else 1.0
    if p <= 0.0:
        return 1.0
    total = 0.0
    log1mp = np.log1p(-p)
    logp = np.log(p)
    for j in range(int(kmax) + 1):
        logc = (
            np.sum(np.log(np.arange(n - j + 1, n + 1)))
            - np.sum(np.log(np.arange(1, j + 1)))
        )
        total += np.exp(logc + j * logp + (n - j) * log1mp)
    return min(total, 1.0)


def random_knn_cdf(n_tracers, shape, spacing, radii, ks=(1, 2, 3)):
    """The exact expected kNN-CDFs of a uniform random lattice catalog:
    1 - BinomCDF(k - 1; n, m(r) / M) on the estimator's lattice balls.
    Shaped like :func:`knn_cdf`."""
    shape = tuple(int(s) for s in shape)
    m = lattice_ball_sizes(shape, spacing, radii)
    M = shape[0] * shape[1] * shape[2]
    n = int(n_tracers)
    ks = tuple(int(k) for k in ks)
    out = np.empty((len(ks), len(radii)), np.float64)
    for j, mj in enumerate(m):
        p = mj / M
        for i, k in enumerate(ks):
            out[i, j] = 1.0 - _log_binom_cdf_tail(k - 1, n, p)
    return out
