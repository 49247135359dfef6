"""KM: the Minkowski curvature invariants and their threshold bins.

The pointwise stage of ``randomfield_tpu/validate/minkowski.py``
(``_field_invariants``' invariants and ``_threshold_bins``), which the JAX
package leaves to XLA.  :func:`threshold_sums` takes u and its nine
spectral derivatives (g0, g1, g2 and the Hessian's a00, a11, a22, a01,
a02, a12, the order of :data:`.derived.TIDAL_PAIRS`); on CUDA tensors it
launches ``csrc/minkowski.cu`` (counter ``KM_LAUNCHES``, one a call), on
CPU tensors it runs :func:`threshold_sums_plain`.  Both compute per voxel,
in float32 and in the JAX expression's order (:func:`invariants_plain`),

    w1 = |g|,  w2 = (g.A.g - |g|^2 tr A) / |g|^2,  w3 = g.cof(A).g / |g|^3

(0 where |g|^2 = 0), bin u by the count of float32 edges <= u, less 1
(``searchsorted(side='right') - 1``), and return int64 counts and float64
sums of w1, w2, w3 per bin, plus the count at or above the last edge.
The kernel never writes w1, w2 or w3 out; its sums are float64 partials
in an order fixed by the shapes, so two calls give the same bits.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import binning as _binning

__all__ = ["KM_LAUNCHES", "invariants_plain", "threshold_sums",
           "threshold_sums_plain", "launch_plan"]

# kernel launches by threshold_sums (the CPU path does not count)
KM_LAUNCHES = 0

# x planes a step of the plain version (bounds its temporaries)
_X_CHUNK = 16


def invariants_plain(g, a):
    """(w1, w2, w3) float32 of derivative blocks ``g`` = (g0, g1, g2) and
    ``a`` = (a00, a11, a22, a01, a02, a12), each operation rounded as the
    JAX package's ``_field_invariants`` writes it."""
    g0, g1, g2 = g
    a00, a11, a22, a01, a02, a12 = a
    gg = g0 * g0 + g1 * g1 + g2 * g2
    tr = a00 + a11 + a22
    gag = (g0 * g0 * a00 + g1 * g1 * a11 + g2 * g2 * a22
           + 2.0 * (g0 * g1 * a01 + g0 * g2 * a02 + g1 * g2 * a12))
    cof = (g0 * g0 * (a11 * a22 - a12 * a12)
           + g1 * g1 * (a00 * a22 - a02 * a02)
           + g2 * g2 * (a00 * a11 - a01 * a01)
           + 2.0 * g0 * g1 * (a02 * a12 - a01 * a22)
           + 2.0 * g0 * g2 * (a01 * a12 - a02 * a11)
           + 2.0 * g1 * g2 * (a01 * a02 - a12 * a00))
    live = gg > 0
    safe = torch.where(live, gg, 1.0)
    w1 = torch.sqrt(gg)
    w2 = torch.where(live, (gag - gg * tr) / safe, 0.0)
    w3 = torch.where(live, cof / (safe * torch.sqrt(safe)), 0.0)
    return w1, w2, w3


def _check(u, derivs, edges):
    u = torch.as_tensor(u)
    if len(derivs) != 9:
        raise ValueError(f"threshold_sums takes nine derivative fields, got "
                         f"{len(derivs)}")
    for t in (u, *derivs):
        if (t.dtype != torch.float32 or t.shape != u.shape
                or t.device != u.device):
            raise ValueError("u and its derivatives must be float32 fields of "
                             "one shape on one device")
    edges_t = torch.as_tensor(np.asarray(edges, np.float32), device=u.device)
    if edges_t.numel() < 2:
        raise ValueError("threshold_sums needs at least two edges")
    return u, edges_t, edges_t.numel() - 1


def threshold_sums_plain(u, derivs, edges):
    """:func:`threshold_sums` in plain PyTorch on ``u``'s device, a chunk of
    x planes at a time: :func:`invariants_plain`, ``torch.bucketize`` and
    float64 sums (:func:`.binning.line_sums`)."""
    u, edges_t, nbins = _check(u, derivs, edges)
    n = nbins + 2  # the bins, the tail, the masked
    acc = torch.zeros((4, n), dtype=torch.float64, device=u.device)
    for x0 in range(0, u.shape[0], _X_CHUNK):
        sl = slice(x0, x0 + _X_CHUNK)
        w = invariants_plain([d[sl] for d in derivs[:3]],
                             [d[sl] for d in derivs[3:]])
        uc = u[sl].contiguous()
        idx = torch.bucketize(uc, edges_t, right=True) - 1
        idx = torch.where(idx < 0, nbins + 1, idx)
        live = idx < nbins
        acc[0] += _binning.line_sums(idx, torch.ones_like(uc), n)
        for q in range(3):
            acc[q + 1] += _binning.line_sums(
                idx, torch.where(live, w[q], 0.0), n)
    counts = torch.round(acc[0, :nbins + 1]).to(torch.int64)
    return counts, acc[1:, :nbins]


def launch_plan(nbins, n):
    """(threads a block, blocks, shared bytes a block) of KM's launch for
    ``nbins`` bins over ``n`` voxels (threads 0: too many bins)."""
    out = (ctypes.c_int * 3)()
    _build.library().rf_minkowski_plan(int(nbins), int(n), out)
    return tuple(out)


def threshold_sums(u, derivs, edges):
    """KM: (int64 counts (nbins + 1,), float64 sums (3, nbins)) on ``u``'s
    device: per threshold bin the voxels and the sums of w1, w2, w3, the
    last count the voxels at or above the last edge.

    ``u``: float32 (nx, ny, nz); ``derivs``: its nine float32 derivative
    fields (g0, g1, g2, a00, a11, a22, a01, a02, a12); ``edges``: nbins + 1
    ascending thresholds, rounded to float32.  On CUDA this launches
    ``csrc/minkowski.cu`` (its partial sums in float64 scratch of a row a
    block); on the CPU it runs :func:`threshold_sums_plain`.
    """
    global KM_LAUNCHES
    u, edges_t, nbins = _check(u, derivs, edges)
    if u.device.type == "cpu":
        return threshold_sums_plain(u, derivs, edges)
    if u.device.type != "cuda":
        raise ValueError(f"threshold_sums runs on cpu or cuda, not {u.device}")
    for t in (u, *derivs):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("threshold_sums' CUDA kernel needs contiguous, "
                             "16-byte aligned fields")
    threads, blocks, _ = launch_plan(nbins, u.numel())
    if threads == 0:
        raise ValueError(f"threshold_sums' CUDA kernel takes at most 259 "
                         f"bins, not {nbins}")
    dev = u.device
    psums = torch.empty((blocks, 3 * nbins), dtype=torch.float64, device=dev)
    pcounts = torch.empty((blocks, nbins + 1), dtype=torch.int64, device=dev)
    sums = torch.empty((3, nbins), dtype=torch.float64, device=dev)
    counts = torch.empty(nbins + 1, dtype=torch.int64, device=dev)
    status = _build.library().rf_minkowski_bins(
        u.data_ptr(), *(d.data_ptr() for d in derivs), edges_t.data_ptr(),
        nbins, u.numel(), psums.data_ptr(), pcounts.data_ptr(),
        sums.data_ptr(), counts.data_ptr(), _build.current_stream(u))
    _build.check(status, "threshold_sums")
    KM_LAUNCHES += 1
    return counts, sums
