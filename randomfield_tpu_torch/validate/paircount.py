"""Direct pair-count two-point statistics of catalogs, on KQ.

Port of ``randomfield_tpu/validate/paircount.py`` with its names,
arguments and returns: weighted pair counts DD(r) (DD(r, mu) in |mu|
wedges, or Legendre-weighted DD_ell(r)) over periodic minimum-image
separations, and xi = DD / RR - 1 with the exact analytic RR of a uniform
periodic box (no random catalog).  The pairs go through KQ
(``csrc/pair_counts.cu`` via :func:`..ops.paircount.pair_sums`: on the
card the pairs in neighbouring cells of a cell list, every pair by its
plain version on CPU tensors), which runs the JAX package's float32 chain
per pair (minimum image with round half to even, r^2, the ``searchsorted``
bin on the float32 squared edges, mu^2, the wedge, (2l + 1) L_l) and sums
each term as an int64 count of 2^-s units; on the card it also holds its
count of pairs examined to the cell walk's own.  So a pair exactly on an
edge falls in the lower bin, as in the JAX package, and the sums are exact
where the JAX package adds float32 (inexact beyond 2^24 pairs a bin); the
weight totals are float64 on the catalog's device.

Positions are (N, 3) or (3, ...) (the grid layout of
``models/zeldovich.py``), rounded to float32.  A tensor's device runs the
count; numpy catalogs go to ``device`` ("cuda" by default).  ``chunk`` is
accepted for the JAX signature and not used: the kernel's cells and
tiles replace it.  ``mesh=`` raises NotImplementedError (ROADMAP.md,
Queue 1 item 8).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import paircount as _pc
from randomfield_tpu_torch.validate.stats import (check_ells, device_of,
                                                  mesh_not_ported)

__all__ = [
    "pair_counts",
    "catalog_correlation",
    "catalog_correlation_multipoles",
]


def _canonical_positions(positions, device):
    """(N, 3) float32 on ``device`` from (N, 3) or (3, ...) positions."""
    p = torch.as_tensor(np.asarray(positions) if not isinstance(
        positions, torch.Tensor) else positions)
    if p.ndim == 2 and p.shape[1] == 3:
        out = p
    elif p.ndim >= 2 and p.shape[0] == 3:
        out = p.reshape(3, -1).T
    else:
        raise ValueError(
            f"positions must be (N, 3) or (3, ...); got shape "
            f"{tuple(p.shape)}")
    return out.to(device=device, dtype=torch.float32)


def _weights(weights, n, device, what):
    """float32 (n,) weights on ``device`` (ones for None)."""
    if weights is None:
        return torch.ones(n, dtype=torch.float32, device=device)
    w = torch.as_tensor(np.asarray(weights) if not isinstance(
        weights, torch.Tensor) else weights)
    w = w.to(device=device, dtype=torch.float32).reshape(-1)
    if w.shape[0] != n:
        raise ValueError(f"{what} length must match its positions")
    return w


def pair_counts(positions, box, r_edges, weights=None, positions2=None,
                weights2=None, nmu=1, ells=(), los_axis=2, chunk=512,
                mesh=None, device=None):
    """Weighted periodic pair counts DD(r[, mu]) and DD_ell(r).

    Counts ordered pairs between ``positions`` and ``positions2``
    (auto-counts with zero separations excluded when ``positions2`` is
    None) binned by minimum-image separation into ``r_edges`` (and, when
    ``nmu > 1``, into uniform |mu| wedges along ``los_axis``).  Returns a
    dict with ``dd`` ((nbins,) or (nbins, nmu) sums of w_i w_j),
    ``r_mean`` (the pair-weighted mean separation a bin), ``dd_ell``
    ((len(ells), nbins) sums of w_i w_j (2l+1) L_l(mu)) and the totals the
    normalization needs, as host float64.  ``r_edges[-1]`` must be at most
    min(box) / 2.  One KQ launch on CUDA (after the cell sort), whose count
    of pairs examined must equal the cell walk's own; ``mesh`` raises.
    """
    if mesh is not None:
        raise mesh_not_ported("pair_counts", mesh)
    dev = device_of(positions, device)
    p1 = _canonical_positions(positions, dev)
    n1 = p1.shape[0]
    box3 = tuple(
        float(b) for b in (box if np.ndim(box) else (box, box, box))
    )
    r_edges = np.asarray(r_edges, np.float64)
    if r_edges.ndim != 1 or len(r_edges) < 2 or (np.diff(r_edges) <= 0).any():
        raise ValueError("r_edges must be increasing with >= 2 entries")
    if r_edges[0] < 0:
        raise ValueError("r_edges must be non-negative")
    if r_edges[-1] > min(box3) / 2 * (1 + 1e-9):
        raise ValueError(
            f"r_edges[-1]={r_edges[-1]:g} exceeds the minimum-image bound "
            f"min(box)/2 = {min(box3) / 2:g}"
        )
    ells = check_ells(ells, "for unoriented pairs")
    if ells and int(nmu) > 1:
        raise ValueError("pass either nmu wedges or ells, not both")
    w1 = _weights(weights, n1, dev, "weights")
    rows1 = _pc.pack(p1, w1)
    cross = positions2 is not None
    if cross:
        p2 = _canonical_positions(positions2, dev)
        w2 = _weights(weights2, p2.shape[0], dev, "weights2")
        rows2 = _pc.pack(p2, w2)
    else:
        w2, rows2 = w1, rows1
    nbins, nmu = len(r_edges) - 1, int(nmu)
    mu_mode = nmu > 1
    mode = (_pc.MODES["wedges"] if mu_mode else
            _pc.MODES["ells"] if ells else _pc.MODES["isotropic"])
    n2 = rows2.shape[0]
    wmax1 = float(w1.abs().max()) if n1 else 0.0
    wmax2 = float(w2.abs().max()) if n2 else 0.0
    s = _pc.fixed_point_exponent(n1, n2, wmax1, wmax2, r_edges[-1], ells)
    edges2 = torch.as_tensor((r_edges**2).astype(np.float32))
    sums, _ = _pc.pair_sums(rows1, rows2, box3, edges2, s, mode, nmu, ells,
                            int(los_axis))
    acc = sums.to(torch.float64).cpu().numpy() * math.ldexp(1.0, -s)
    dd = acc[0].reshape(nbins, nmu) if mu_mode else acc[0]
    rsum = acc[1].reshape(nbins, nmu).sum(axis=1) if mu_mode else acc[1]
    ddr = dd.sum(axis=1) if mu_mode else dd
    with np.errstate(invalid="ignore", divide="ignore"):
        r_mean = np.where(ddr > 0, rsum / np.where(ddr > 0, ddr, 1.0),
                          np.nan)
    w1d = w1.to(torch.float64)
    out = {
        "dd": dd,
        "r_mean": r_mean,
        "r_edges": r_edges,
        "sum_w1": float(w1d.sum()),
        "sum_w2": float(w2.to(torch.float64).sum()),
        "sum_w1_sq": float((w1d * w1d).sum()),
        "cross": cross,
        "box": box3,
    }
    if ells:
        out["dd_ell"] = acc[2:2 + len(ells)]
        out["ells"] = ells
    return out


def _rr_analytic(counts):
    """Exact expected ordered pair counts of uniform points in the
    periodic box: RR(bin) = norm V_shell(bin) / V_box with norm = W1 W2
    (cross) or W^2 - sum(w^2) (auto, self-pairs excluded); exact for r <=
    min(box) / 2, where minimum-image shells are whole spheres."""
    e = counts["r_edges"]
    vshell = 4.0 * np.pi / 3.0 * (e[1:] ** 3 - e[:-1] ** 3)
    bx = counts["box"]
    vbox = bx[0] * bx[1] * bx[2]
    if counts["cross"]:
        norm = counts["sum_w1"] * counts["sum_w2"]
    else:
        norm = counts["sum_w1"] ** 2 - counts["sum_w1_sq"]
    return norm * vshell / vbox


def catalog_correlation(positions, box, r_edges, weights=None,
                        positions2=None, weights2=None, nmu=1,
                        los_axis=2, chunk=512, device=None):
    """xi(r) (or xi(r, mu) wedges) of a catalog by direct pair counts: the
    periodic-box natural estimator DD / RR - 1 with the exact analytic RR.
    Auto by default; ``positions2`` for a cross-correlation; ``nmu > 1``
    for uniform |mu| wedges along ``los_axis``.  Returns ``(r_mean, xi,
    dd)``, ``xi`` and ``dd`` shaped (nbins,) or (nbins, nmu)."""
    c = pair_counts(
        positions, box, r_edges, weights=weights, positions2=positions2,
        weights2=weights2, nmu=nmu, los_axis=los_axis, chunk=chunk,
        device=device,
    )
    rr = _rr_analytic(c)
    if int(nmu) > 1:
        rr = rr[:, None] / float(nmu)
    with np.errstate(invalid="ignore", divide="ignore"):
        xi = c["dd"] / rr - 1.0
    return c["r_mean"], xi, c["dd"]


def catalog_correlation_multipoles(positions, box, r_edges, weights=None,
                                   positions2=None, weights2=None,
                                   ells=(0, 2, 4), los_axis=2, chunk=512,
                                   device=None):
    """Correlation multipoles xi_ell(s) by direct pair counts, each pair
    weighted by (2l + 1) L_l(mu) (exact in mu; even ells only):
    xi_ell = DD_ell / RR - delta_l0.  Returns ``(r_mean, xi_ell, dd)`` with
    ``xi_ell`` shaped (len(ells), nbins)."""
    ells = tuple(int(e) for e in ells)
    c = pair_counts(
        positions, box, r_edges, weights=weights, positions2=positions2,
        weights2=weights2, ells=ells, los_axis=los_axis, chunk=chunk,
        device=device,
    )
    rr = _rr_analytic(c)
    with np.errstate(invalid="ignore", divide="ignore"):
        xi_ell = c["dd_ell"] / rr[None, :]
    for i, e in enumerate(ells):
        if e == 0:
            xi_ell[i] -= 1.0
    return c["r_mean"], xi_ell, c["dd"]
