"""k-space geometry of packed real-to-complex (rfft) spectra.

Port of ``randomfield_tpu/ops/grid.py``; the same conventions:

* fields are ``(nx, ny, nz)`` with uniform ``spacing``; the packed
  half-spectrum is ``(nx, ny, nz // 2 + 1)``, rfft-packed along the last
  axis;
* wavenumbers are angular, ``k = 2 pi f`` with ``f`` numpy's fft
  frequencies: the fundamental of a box of side L is ``2 pi / L``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = [
    "half_shape",
    "kvectors",
    "ksq",
    "kmag",
    "fill_with_log10k",
    "get_k_bounds",
    "conjugate_plane",
    "hermitian_plane_masks",
    "self_conjugate_kz_planes",
    "kz_multiplicity",
]

TWO_PI = 2.0 * np.pi


def half_shape(shape) -> tuple[int, int, int]:
    """Shape of the packed rfft half-spectrum of a real field of ``shape``."""
    nx, ny, nz = shape
    return (nx, ny, nz // 2 + 1)


def kvectors(shape, spacing, dtype=torch.float32, device="cpu"):
    """Angular wavenumber 1-D tensors ``(kx, ky, kz)`` of the half-spectrum.

    ``kx`` and ``ky`` follow full fft ordering, ``kz`` rfft ordering.
    """
    nx, ny, nz = shape
    return tuple(
        torch.as_tensor(TWO_PI * f, dtype=dtype, device=device)
        for f in (np.fft.fftfreq(nx, d=spacing), np.fft.fftfreq(ny, d=spacing),
                  np.fft.rfftfreq(nz, d=spacing))
    )


def ksq(shape, spacing, dtype=torch.float32, device="cpu", x_off=0,
        nx_loc=None, y_off=0, ny_loc=None):
    """|k|^2 on the packed half-spectrum, ``(kx^2 + ky^2) + kz^2`` in
    ``dtype`` as the JAX package sums it; x rows [x_off, x_off + nx_loc)
    and ky rows [y_off, y_off + ny_loc) (all rows by default)."""
    kx, ky, kz = kvectors(shape, spacing, dtype, device)
    nx_loc = shape[0] - x_off if nx_loc is None else nx_loc
    ny_loc = shape[1] - y_off if ny_loc is None else ny_loc
    kx = kx[x_off:x_off + nx_loc]
    ky = ky[y_off:y_off + ny_loc]
    return ((kx * kx)[:, None, None] + (ky * ky)[None, :, None]
            + (kz * kz)[None, None, :])


def kmag(shape, spacing, dtype=torch.float32, device="cpu", x_off=0,
         nx_loc=None, y_off=0, ny_loc=None):
    """|k| on the packed half-spectrum (rows as :func:`ksq`)."""
    return torch.sqrt(ksq(shape, spacing, dtype, device, x_off, nx_loc,
                          y_off, ny_loc))


def fill_with_log10k(shape, spacing, dtype=torch.float32, dc_value=None,
                     device="cpu"):
    """log10|k| per packed mode, on ``device``.

    |k|^2 in float32 (float64 for ``dtype=torch.float64``), 0.5 log10 of
    it; the DC mode gets ``dc_value`` (default: log10 of the fundamental
    minus 20 decades, a finite sentinel below any tabulated k), as the JAX
    package's ``fill_with_log10k``.
    """
    k2 = ksq(shape, spacing,
             torch.float64 if dtype == torch.float64 else torch.float32,
             device)
    if dc_value is None:
        dc_value = np.log10(get_k_bounds(shape, spacing)[0]) - 20.0
    out = 0.5 * torch.log10(torch.where(k2 > 0, k2, 1.0))
    return torch.where(k2 > 0, out, float(dc_value)).to(dtype)


def get_k_bounds(shape, spacing) -> tuple[float, float]:
    """(kmin, kmax) over the non-DC modes: the fundamental of the longest
    side and the corner-mode magnitude."""
    nx, ny, nz = shape
    kmin = TWO_PI / (max(nx, ny, nz) * spacing)
    kmax2 = 0.0
    for n in (nx, ny):
        kmax2 += float(np.max(np.abs(TWO_PI * np.fft.fftfreq(n, d=spacing)))) ** 2
    kmax2 += float(np.max(TWO_PI * np.fft.rfftfreq(nz, d=spacing))) ** 2
    return float(kmin), float(np.sqrt(kmax2))


def conjugate_plane(a: torch.Tensor) -> torch.Tensor:
    """Map the last two axes ``(i, j) -> ((-i) mod nx, (-j) mod ny)``.

    Applied to the real and the imaginary lattice (the latter negated by
    the caller) this is ``c(kx, ky) -> conj(c(-kx, -ky))``.
    """
    a = torch.roll(torch.flip(a, dims=(-2,)), 1, dims=-2)
    return torch.roll(torch.flip(a, dims=(-1,)), 1, dims=-1)


@functools.lru_cache(maxsize=None)
def hermitian_plane_masks(nx: int, ny: int):
    """``(self_conj, canonical)`` numpy bool masks of a self-conjugate plane.

    ``self_conj`` marks the modes that are their own partner (kx in {0,
    nx/2}, ky in {0, ny/2}); ``canonical`` marks exactly one member of each
    conjugate pair, chosen lexicographically.
    """
    i = np.arange(nx)[:, None]
    j = np.arange(ny)[None, :]
    ni = (-i) % nx
    nj = (-j) % ny
    self_conj = (i == ni) & (j == nj)
    canonical = (i < ni) | ((i == ni) & (j <= nj))
    return self_conj, canonical


def self_conjugate_kz_planes(nz: int) -> tuple[int, ...]:
    """kz planes that must be internally Hermitian: 0, and nz/2 if nz is even."""
    if nz % 2 == 0:
        return (0, nz // 2)
    return (0,)


def kz_multiplicity(nz: int, device="cpu") -> torch.Tensor:
    """float64 (nz//2 + 1,) count of the modes a packed kz column stands
    for: 1 on the self-conjugate planes (:func:`self_conjugate_kz_planes`),
    2 elsewhere."""
    mult = torch.full((nz // 2 + 1,), 2.0, dtype=torch.float64, device=device)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    return mult
