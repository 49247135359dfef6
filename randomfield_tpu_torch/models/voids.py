"""Spherical-underdensity void finding and void statistics.

Port of ``randomfield_tpu/models/voids.py`` (one device).  The mean
enclosed density contrast at every voxel for a ladder of radii comes from
top-hat convolutions: one forward transform of the field, then a window
multiply and an inverse transform a rung (:func:`..ops.transform.rfftn`,
:func:`..ops.transform.irfftn_reim`: K6, K3 and K4 on CUDA), and the void
radius field is the running ladder maximum

    R_v(x) = largest R with delta_bar(<R'; x) < threshold
             for every ladder radius R' <= R.

Candidates are the voxels whose float64 key R_v - 1e-9 delta is a strict
maximum of their periodic 27-cube with R_v > 0 (deeper delta wins inside
plateaus), found and compacted on the device by KX's void mode
(:func:`..ops.extrema.void_candidates`): only the candidate list reaches
the host, where :func:`_greedy_accept` keeps the non-overlapping catalog
in descending R_v.  The JAX package builds float64 host copies of both
fields and 26 rolled copies of the key instead.  :func:`_discrete_sigma_r`
sums on the device in float64, a chunk of x planes at a time, and
:func:`underdense_fraction` counts the underdense voxels exactly (int64).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import extrema as _extrema
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate.stats import mesh_not_ported

__all__ = [
    "tophat_smooth",
    "void_radius_grid",
    "find_voids",
    "void_size_function",
    "predicted_underdense_fraction",
    "underdense_fraction",
    "minima_statistics",
]

# x planes a step of the window and sigma sums (bounds their temporaries)
_X_CHUNK = 16


def _tophat_w(x):
    """Spherical top-hat window W(x) = 3 (sin x - x cos x) / x^3, W(0) = 1,
    in ``x``'s dtype (the series 1 - x^2 / 10 below x = 1e-3)."""
    safe = torch.where(x > 1e-3, x, 1.0)
    w = 3.0 * (torch.sin(safe) - safe * torch.cos(safe)) / safe**3
    return torch.where(x > 1e-3, w, 1.0 - x * x / 10.0)


def _field(delta):
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"delta must be one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    return delta


class _Ladder:
    """The field's physical spectrum c = a^3 rfftn(delta) and |k| (float32),
    smoothed by a top-hat of any radius on request."""

    def __init__(self, delta, spacing):
        self.shape = tuple(int(s) for s in delta.shape)
        self.spacing = float(spacing)
        a3 = float(np.float32(self.spacing ** 3))
        self.re, self.im = _transform.rfftn(delta)
        self.re.mul_(a3)
        self.im.mul_(a3)
        self.km = _grid.kmag(self.shape, self.spacing, torch.float32,
                             delta.device)

    def smooth(self, radius):
        """delta_bar(< radius) at every voxel: c W(|k| R) through the
        synthesis (1/V) irfftn."""
        r32 = torch.full((), float(radius), dtype=torch.float32,
                         device=self.re.device)
        re, im = torch.empty_like(self.re), torch.empty_like(self.im)
        for x0 in range(0, self.shape[0], _X_CHUNK):
            sl = slice(x0, x0 + _X_CHUNK)
            w = _tophat_w(self.km[sl] * r32)
            torch.mul(self.re[sl], w, out=re[sl])
            torch.mul(self.im[sl], w, out=im[sl])
        nx, ny, nz = self.shape
        inv_v = float(np.float32(1.0 / (nx * ny * nz * self.spacing ** 3)))
        return _transform.irfftn_reim(re.mul_(inv_v), im.mul_(inv_v),
                                      self.shape)


def tophat_smooth(delta, spacing, radius):
    """Mean enclosed density contrast delta_bar(< radius) at every voxel:
    the FFT convolution with the spherical top-hat of that radius."""
    return _Ladder(_field(delta), spacing).smooth(radius)


def void_radius_grid(delta, spacing, radii, threshold=-0.4, mesh=None):
    """SO void radius at every voxel: the largest ladder radius R such that
    the enclosed mean contrast stays below ``threshold`` for every rung up
    to R (0 where even the smallest rung fails).  ``radii``: an ascending
    ladder in the units of ``spacing``; one inverse transform a rung, no
    float64 copy of the field.  ``mesh`` raises NotImplementedError."""
    radii = tuple(float(r) for r in radii)
    if any(b <= a for a, b in zip(radii, radii[1:])) or not radii:
        raise ValueError("radii must be a non-empty ascending ladder")
    if threshold >= 0:
        raise ValueError("void threshold must be negative")
    if mesh is not None:
        raise mesh_not_ported("void_radius_grid", mesh)
    delta = _field(delta)
    ladder = _Ladder(delta, spacing)
    t = float(np.float32(threshold))
    rv = torch.zeros_like(delta)
    alive = torch.ones(delta.shape, dtype=torch.bool, device=delta.device)
    for r in radii:
        alive &= ladder.smooth(r) < t
        rv.masked_fill_(alive, float(np.float32(r)))
    return rv


def _greedy_accept(cand, rv_c, shape, spacing):
    """Greedy non-overlap acceptance in descending R_v (host).

    ``cand``: (n, 3) voxel indices; ties in R_v break by lexicographic
    voxel order, as the JAX package's argwhere and stable sort give.  The
    accepted voids fill preallocated arrays (the JAX package concatenates
    one array a void)."""
    order = np.lexsort((cand[:, 2], cand[:, 1], cand[:, 0], -rv_c))
    cand = cand[order]
    rv_c = rv_c[order]
    pos = (cand + 0.5) * spacing
    box = np.asarray(shape, np.float64) * spacing
    acc_pos = np.empty((pos.shape[0], 3))
    acc_r = np.empty(pos.shape[0])
    n = 0
    for i in range(pos.shape[0]):
        if n:
            dvec = np.abs(acc_pos[:n] - pos[i])
            dvec = np.minimum(dvec, box - dvec)
            dist = np.sqrt((dvec**2).sum(axis=1))
            if np.any(dist < acc_r[:n]):  # center inside an accepted void
                continue
        acc_pos[n] = pos[i]
        acc_r[n] = rv_c[i]
        n += 1
    return acc_pos[:n].copy(), acc_r[:n].copy()


def find_voids(delta, spacing, radii, threshold=-0.4, mesh=None,
               candidate_budget=8192):
    """Non-overlapping SO void catalog.

    Candidates are voxels whose R_v is a 27-cube maximum with R_v > 0
    (strict on the key R_v - 1e-9 delta: deeper delta wins inside
    plateaus), KX on the device; they are accepted greedily in descending
    R_v, rejecting any center inside an accepted void (periodic minimum
    image).  Returns ``(positions, radii_v)``: (n, 3) voxel-center
    coordinates and radii, host float64.  ``candidate_budget`` bounds the
    mesh version's per-shard list; one device keeps every candidate, and
    ``mesh`` raises NotImplementedError.
    """
    if mesh is not None:
        raise mesh_not_ported("find_voids", mesh)
    delta = _field(delta)
    rv = void_radius_grid(delta, spacing, radii, threshold)
    return voids_from_radius(rv, delta, spacing)


def voids_from_radius(rv, delta, spacing):
    """The catalog of an R_v grid and its field: KX's candidates, then
    :func:`_greedy_accept` on the host."""
    shape = tuple(int(s) for s in rv.shape)
    flat = _extrema.void_candidates(rv, delta)
    if flat.size == 0:
        return np.zeros((0, 3)), np.zeros(0)
    cand = np.stack(np.unravel_index(flat, shape), axis=1)
    rv_c = rv.reshape(-1)[torch.as_tensor(flat, device=rv.device)]
    return _greedy_accept(cand.astype(np.float64),
                          rv_c.cpu().numpy().astype(np.float64), shape,
                          float(spacing))


def void_size_function(radii_v, box_volume, edges):
    """dn/dlnR of a void catalog: counts in ``edges`` (radius bins) over
    the box volume and dlnR.  Returns ``(r_centers, dndlnr, counts)``."""
    edges = np.asarray(edges, np.float64)
    counts, _ = np.histogram(np.asarray(radii_v, np.float64), bins=edges)
    dlnr = np.diff(np.log(edges))
    centers = np.sqrt(edges[:-1] * edges[1:])
    return centers, counts / (float(box_volume) * dlnr), counts


def _discrete_sigma_r(power, shape, spacing, radius, interpolation,
                      device="cuda"):
    """The top-hat-filtered rms on the grid's discrete modes: sum m W(|k|
    R)^2 P(|k|) / V in float64 on ``device`` (|k| and P(|k|) in float32 as
    the JAX package's grid holds them, W in float64), a chunk of x planes
    at a time."""
    shape = tuple(int(s) for s in shape)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, float(spacing))
    mult = _grid.kz_multiplicity(shape[2], device)
    total = torch.zeros((), dtype=torch.float64, device=device)
    for x0 in range(0, shape[0], _X_CHUNK):
        nx_loc = min(_X_CHUNK, shape[0] - x0)
        km32 = _grid.kmag(shape, float(spacing), torch.float32, device, x0,
                          nx_loc)
        pg = _power.interpolate_power(table, km32, interpolation).to(
            torch.float64)
        km = km32.to(torch.float64)
        pg = torch.where(km == 0, 0.0, pg)
        x = km * float(radius)
        w = torch.where(x > 1e-3, 3.0 * (torch.sin(x) - x * torch.cos(x))
                        / torch.clamp(x, min=1e-3) ** 3, 1.0 - x * x / 10.0)
        total += (mult * w * w * pg).sum()
    volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
    return float(np.sqrt(float(total) / volume))


def predicted_underdense_fraction(power, shape, spacing, radius, threshold,
                                  interpolation="log10k", device="cuda"):
    """The exact expected volume fraction with delta_bar(< radius) <
    threshold of a Gaussian field: Phi(threshold / sigma_R), sigma_R the
    discrete top-hat rms on the grid's modes (:func:`_discrete_sigma_r`,
    on ``device``)."""
    s = _discrete_sigma_r(power, shape, float(spacing), float(radius),
                          interpolation, device)
    return 0.5 * (1.0 + math.erf(float(threshold) / s / math.sqrt(2.0)))


def underdense_fraction(delta, spacing, radius, threshold):
    """Measured volume fraction with delta_bar(< radius) < threshold: the
    underdense voxels counted exactly in int64, over the voxels."""
    sm = tophat_smooth(delta, spacing, radius)
    n = int((sm < float(np.float32(threshold))).sum())
    return n / sm.numel()


def minima_statistics(delta, spacing, nbins=14, nu_min=-5.0, nu_max=2.0,
                      sigma0=None, mesh=None):
    """Lattice minima counts binned by depth nu = delta / sigma0: the peaks
    of -delta with reflected bins (KX's peak mode with sign -1), BBKS
    expectations with nu -> -nu.  Returns ``(nu_centers, counts, total)``
    with the centers ascending."""
    if mesh is not None:
        raise mesh_not_ported("minima_statistics", mesh)
    from randomfield_tpu_torch.validate.peaks import extrema_statistics

    centers, counts, total = extrema_statistics(
        delta, nbins, -float(nu_max), -float(nu_min), sigma0, -1.0)
    return -centers[::-1], counts[::-1], total
