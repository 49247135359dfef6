"""Binned bispectrum estimator (FFT shell method).

Port of ``randomfield_tpu/validate/bispectrum.py`` (``bispectrum_bins :50``,
``_triple_sums :79``, ``_triangle_counts :111``, ``calculate_bispectrum
:199``, ``reduced_bispectrum :252``) with its bins, triples and
conventions (Scoccimarro's estimator):

    c_k     = a^3 sum_x delta(x) exp(-ik.x)
    D_i(x)  = sum_{k in S_i} c_k exp(ik.x)        (a shell, unnormalized)
    u_i(x)  = sum_{k in S_i} exp(ik.x)            (a unit shell)
    B_hat(i, j, l) = sum_x D_i D_j D_l / (V sum_x u_i u_j u_l),

an exact per-triad average over the closed triads k1 + k2 + k3 = 0 with
|k_i| in the bins.  On the field's device: the forward transform is
:func:`..ops.transform.rfftn` (K6, forward K3 twice on CUDA), each shell
the masked spectrum through :func:`..ops.transform.irfftn_reim` (K3, K3,
K4).  Memory: the JAX package keeps every pair product d_i d_j in a cache
(36 at nbins = 8, 155 GB at 1024^3); here the triples, ordered by (i, j),
form each pair product once and hold one at a time, so the peak is the
nbins shells, one product, the field and, while the shells are made, the
spectrum and |k|: about 52 GB at 1024^3 with nbins = 8.  Each triple sum is
taken in float64, x-slab by x-slab.  The geometry denominator (unit shells)
is cached per (shape, spacing, edges, triples), as ``lru_cache`` does in
the JAX package.

With a slab ``mesh=`` (the JAX package's ``_make_mesh_triple_sums``) the
field is this rank's (nx/P, ny, nz) x slab: the distributed forward
transform gives its ky rows of the spectrum, the shells are masked there
and synthesized by the distributed inverse into x slabs, each rank sums
its cells' triple products in float64, and one all-reduce of the sums
gives every rank the whole field's result; the geometry denominator is
made the same way from unit shells and cached per mesh.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["bispectrum_bins", "calculate_bispectrum", "reduced_bispectrum",
           "shells", "triple_sums"]

# x planes a step of a triple sum (bounds the float64 temporaries)
_X_CHUNK = 16


def bispectrum_bins(shape, spacing, nbins=8, kmin=None, kmax=None):
    """Linear |k| shell edges and the closure-compatible bin triples.

    Returns ``(edges, triples)``: ``nbins + 1`` edges from ``kmin``
    (default: 0.999 of the fundamental) to ``kmax`` (default: 1.001 of the
    corner mode), and the (T, 3) int32 triples i <= j <= l whose shells can
    close a triangle (edges[l] < edges[i + 1] + edges[j + 1]).
    """
    kf, kny = _grid.get_k_bounds(shape, spacing)
    lo = kf * 0.999 if kmin is None else float(kmin)
    hi = kny * 1.001 if kmax is None else float(kmax)
    edges = np.linspace(lo, hi, int(nbins) + 1)
    triples = [
        (i, j, l)
        for i in range(nbins)
        for j in range(i, nbins)
        for l in range(j, nbins)
        if edges[l] < edges[i + 1] + edges[j + 1]
    ]
    return edges, np.asarray(triples, np.int32)


def shells(re, im, shape, edges, kmag, mesh=None):
    """The |k| shells of a packed spectrum (re, im) as real fields: for bin
    b the spectrum masked to edges[b] <= |k| < edges[b + 1] (DC out)
    through :func:`..ops.transform.irfftn_reim` (a masked copy is
    consumed, the spectrum is not).  ``im=None`` takes a real weight grid
    (imaginary part 0).  The edges are compared in float32 with the
    float32 |k| ``kmag`` of :func:`..ops.grid.kmag`, as the JAX package
    compares them.  Returns a list of float32 (nx, ny, nz) tensors; on a
    slab ``mesh`` the arrays are this rank's ky rows and the shells its
    (nx/P, ny, nz) x slabs, through the distributed inverse."""
    dev = re.device
    out = []
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(len(edges) - 1):
        lo, hi = (float(np.float32(e)) for e in edges[b:b + 2])
        mask = (kmag >= lo) & (kmag < hi) & (kmag > 0)
        sre = torch.where(mask, re, zero)
        sim = (torch.zeros_like(sre) if im is None
               else torch.where(mask, im, zero))
        del mask
        out.append(_dfft.inverse(sre, sim, shape, mesh))
        del sre, sim
    return out


def _dot64(fields):
    """sum_x of the product of float32 fields, in float64, x-slab by
    x-slab."""
    total = torch.zeros((), dtype=torch.float64, device=fields[0].device)
    for x0 in range(0, fields[0].shape[0], _X_CHUNK):
        prod = fields[0][x0:x0 + _X_CHUNK]
        for f in fields[1:]:
            prod = prod * f[x0:x0 + _X_CHUNK]
        total += prod.sum(dtype=torch.float64)
    return total


def triple_sums(sh, triples, mesh=None):
    """sum_x d_i d_j d_l for every triple, float64 on the shells' device:
    the triples in (i, j) order, each pair product formed once and one
    held at a time; on a slab ``mesh`` over this rank's cells, then summed
    over the ranks with one all-reduce.  Host float64 (T,)."""
    out = torch.zeros(len(triples), dtype=torch.float64, device=sh[0].device)
    pair, prod = None, None
    for t, (i, j, l) in enumerate(triples):
        if (i, j) != pair:
            prod = None  # freed before the next one is made
            prod = sh[i] * sh[j]
            pair = (i, j)
        out[t] = _dot64((prod, sh[l]))
    return _stats.mesh_sum(out, mesh).cpu().numpy()


def _ordered(triples):
    """The triples sorted by (i, j, l), and the permutation back."""
    t = np.asarray(triples).reshape(-1, 3)
    order = np.lexsort((t[:, 2], t[:, 1], t[:, 0]))
    return [tuple(int(v) for v in row) for row in t[order]], order


def _sorted_sums(sh, triples, mesh=None):
    tri, order = _ordered(triples)
    sums = np.empty(len(tri))
    sums[order] = triple_sums(sh, tri, mesh)
    return sums


def _kmag(shape, spacing, device, mesh):
    """float32 |k| of the packed spectrum, or of this rank's ky rows."""
    y_off, ny_loc = (0, shape[1]) if mesh is None else mesh.rows(shape[1])
    return _grid.kmag(shape, spacing, torch.float32, device, y_off=y_off,
                      ny_loc=ny_loc)


@functools.lru_cache(maxsize=8)
def _triangle_counts(shape, spacing, edges, triples, device, mesh=None):
    """The cached geometry denominator: sum_x u_i u_j u_l per triple."""
    kmag = _kmag(shape, spacing, device, mesh)
    ones = torch.ones_like(kmag)
    sh = shells(ones, None, shape, edges, kmag, mesh)
    del kmag, ones
    return _sorted_sums(sh, triples, mesh)


def triangle_counts(shape, spacing, edges, triples, device, mesh=None):
    """sum_x u_i u_j u_l per triple (host float64), cached per (shape,
    spacing, edges, triples, device, mesh); on a slab ``mesh`` from this
    rank's unit shells, summed over the ranks."""
    return _triangle_counts(tuple(int(n) for n in shape), float(spacing),
                            tuple(float(e) for e in edges),
                            tuple(map(tuple, np.asarray(triples).tolist())),
                            str(torch.device(device)), mesh)


def calculate_bispectrum(delta, spacing, nbins=8, kmin=None, kmax=None,
                         mesh=None):
    """Binned bispectrum of a real-space field.

    Returns ``(k_centers, triples, bispec, ntri)``: the (nbins,) shell
    centers (linear bins), the (T, 3) bin triples i <= j <= l, the (T,)
    estimated B in length^6 and the (T,) number of closed Fourier triads
    per triple; triples with no closed triad are dropped.  A Gaussian
    field's expectation is 0; :func:`reduced_bispectrum` gives Q.  Runs on
    ``delta``'s device; with a slab ``mesh`` ``delta`` is this rank's x
    slab and every rank gets the whole field's result.
    """
    mesh = _stats.slab_mesh("calculate_bispectrum", mesh)
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"delta must be one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    shape = _stats.mesh_shape(delta, mesh)
    spacing = float(spacing)
    edges, triples = bispectrum_bins(shape, spacing, nbins, kmin, kmax)
    volume = shape[0] * shape[1] * shape[2] * spacing ** 3
    ncells = shape[0] * shape[1] * shape[2]
    re, im = _dfft.forward(delta, mesh)
    a3 = float(np.float32(spacing ** 3))
    re.mul_(a3)
    im.mul_(a3)
    kmag = _kmag(shape, spacing, delta.device, mesh)
    sh = shells(re, im, shape, edges, kmag, mesh)
    del re, im, kmag
    num = _sorted_sums(sh, triples, mesh)
    del sh
    den = triangle_counts(shape, spacing, edges, triples, delta.device, mesh)
    ntri = den / ncells
    keep = ntri > 0.5  # shells with no closed triad
    with np.errstate(invalid="ignore", divide="ignore"):
        bispec = num / (volume * den)
    centers = 0.5 * (edges[:-1] + edges[1:])
    return centers, triples[keep], bispec[keep], ntri[keep]


def reduced_bispectrum(k_centers, triples, bispec, k_power, p_power):
    """Dimensionless Q = B / (P1 P2 + P2 P3 + P3 P1), P interpolated from a
    binned (k_power, p_power) table at the shell centers."""
    pk = np.interp(np.asarray(k_centers)[np.asarray(triples)],
                   np.asarray(k_power), np.asarray(p_power))
    denom = pk[:, 0] * pk[:, 1] + pk[:, 1] * pk[:, 2] + pk[:, 2] * pk[:, 0]
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.asarray(bispec) / denom
