"""Zel'dovich mock catalogs: displaced particles, painting, catalog P(k).

Port of the single-device surface of ``randomfield_tpu/models/zeldovich.py``
with its names, arguments and returns.  The catalog is grid-shaped, one
particle a cell: positions ``(3, nx, ny, nz)`` and per-particle weights.

1. :func:`zeldovich_positions`: x = q + psi (plus f psi_los along the line
   of sight for redshift space), wrapped into the box, float32 in the
   reference's order, on the displacement's device;
2. :func:`poisson_sample`: per-cell tracer counts of intensity
   nbar a^3 (1 + delta), the JAX package's ``jax.random.poisson`` draws
   replayed by KH (:mod:`..ops.poisson`);
3. :func:`paint`: mass assignment, KP (:mod:`..ops.paint`): int64 fixed
   point, so the painted field does not depend on the order the atomics
   land in; an interlaced copy is the same kernel with a shift argument,
   with no shifted copy of the positions;
4. :func:`catalog_power` and :func:`catalog_power_multipoles`: the
   estimators of :mod:`..validate.fourier` (K6, K3, KB) with the window
   deconvolved and the shot noise subtracted.

:func:`zeldovich_power` (the exact Zel'dovich spectrum, the theory curve of
these mocks) is host float64 numpy, a copy of the reference's.  ``mesh=``
raises NotImplementedError: the sharded painting (the JAX package's
``parallel/paint.py:paint_sharded``) is ROADMAP.md, Queue 1 item 8.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import paint as _paint
from randomfield_tpu_torch.ops import poisson as _poisson
from randomfield_tpu_torch.ops import threefry as _threefry

__all__ = [
    "lagrangian_positions",
    "zeldovich_positions",
    "poisson_sample",
    "paint",
    "paint_cic",
    "catalog_power",
    "catalog_power_multipoles",
    "shot_noise",
    "zeldovich_power",
]



def _as_positions(positions):
    """Positions as a float32 tensor (numpy arrays are taken as they are
    when float32, as the JAX package's zeldovich_positions returns them)."""
    if isinstance(positions, np.ndarray) and not positions.flags.writeable:
        positions = positions.copy()
    positions = torch.as_tensor(positions)
    return positions if positions.dtype == torch.float32 else \
        positions.to(torch.float32)


def _mesh_refusal(what):
    return NotImplementedError(
        f"{what} with mesh= is not ported to randomfield_tpu_torch yet: the "
        f"sharded painting, paint_sharded (ROADMAP.md, Queue 1 item 8)")


def _q_axis(n, spacing, device):
    """float32 cell centres (i + 0.5) a of one axis."""
    return (torch.arange(n, dtype=torch.float32, device=device) + 0.5) * float(
        np.float32(spacing))


def lagrangian_positions(shape, spacing, dtype=torch.float32, device=None):
    """Unperturbed particle grid q [Mpc/h]: one particle a cell centre at
    ``(i + 0.5) * spacing``, shaped ``(3, nx, ny, nz)``, on ``device``
    (CUDA by default)."""
    device = torch.device("cuda" if device is None else device)
    nx, ny, nz = (int(s) for s in shape)
    out = torch.empty((3, nx, ny, nz), dtype=dtype, device=device)
    q = [_q_axis(n, spacing, device).to(dtype) for n in (nx, ny, nz)]
    out[0] = q[0][:, None, None]
    out[1] = q[1][None, :, None]
    out[2] = q[2][None, None, :]
    return out


def zeldovich_positions(psi, spacing, f=0.0, los_axis=2):
    """Particle positions ``x = q + psi`` (periodic wrap), grid layout.

    ``psi`` is a ``(3, nx, ny, nz)`` float32 displacement in Mpc/h (e.g.
    ``Generator.generate_displacement``).  ``f`` adds the plane-parallel
    Zel'dovich redshift-space mapping ``s = x + f psi_los`` along
    ``los_axis`` (``f = cosmology.growth_rate(z)``).  Every operation is the
    reference's float32 one in its order, the wrap Python's modulo (a
    non-negative remainder); a new tensor on ``psi``'s device, built a
    component at a time.
    """
    psi = torch.as_tensor(psi)
    if psi.ndim != 4 or psi.shape[0] != 3:
        raise ValueError(f"psi must be (3, nx, ny, nz), got {tuple(psi.shape)}")
    if psi.dtype != torch.float32:
        raise ValueError(f"psi must be float32, got {psi.dtype}")
    shape = tuple(int(s) for s in psi.shape[1:])
    spacing = float(spacing)
    f32 = float(np.float32(f))
    out = torch.empty_like(psi)
    view = ((slice(None), None, None), (None, slice(None), None),
            (None, None, slice(None)))
    for a in range(3):
        q = _q_axis(shape[a], spacing, psi.device)[view[a]]
        torch.add(q, psi[a], out=out[a])
        if f and a == int(los_axis):
            out[a] += f32 * psi[a]
        box = float(np.float32(shape[a] * spacing))
        torch.remainder(out[a], box, out=out[a])
    return out


def poisson_sample(delta, nbar, spacing, seed=0):
    """Per-cell Poisson tracer counts with intensity nbar*Vcell*(1+delta).

    ``nbar`` is the mean tracer density [(Mpc/h)^-3]; negative intensities
    (a Gaussian delta below -1) are clipped to zero.  Returns a grid of
    counts of ``delta``'s dtype, on its device (a weight array for
    :func:`paint` / :func:`catalog_power`).

    The counts are the JAX package's: ``jax.random.poisson`` under
    ``key(seed ^ 0x5EEDC0DE)`` replayed cell by cell by KH's linear form
    (:func:`..ops.poisson.poisson_counts`: the kernel on CUDA, its plain
    version on the CPU), lambda = max((1 + delta) s, 0) in float32 with s
    the float32 nbar a^3.
    """
    delta = torch.as_tensor(delta)
    field = delta if delta.dtype == torch.float32 else delta.to(torch.float32)
    key = _threefry.key_from_seed(int(seed) ^ 0x5EEDC0DE)
    counts = _poisson.poisson_counts(
        field, [key], "linear", scale=float(nbar) * float(spacing) ** 3)[0]
    return counts.to(delta.dtype)


def paint(positions, shape, spacing, weights=1.0, window="cic"):
    """Mass-assign particles onto a grid -> density contrast delta.

    ``positions``: ``(3, ...)`` float32 in Mpc/h (any trailing shape; numpy
    or torch).  ``weights``: scalar or per-particle array broadcastable to
    the trailing shape.  ``window``: ``'ngp'``, ``'cic'`` or ``'tsc'``
    (cell-centred: a uniform cell-centre grid paints to zero contrast).
    Returns ``(delta, w_mean)``: the float32 contrast grid on the positions'
    device and the mean painted mass a cell (a float).  KP on CUDA.
    """
    if window not in _paint.ORDERS:
        raise ValueError(
            f"window must be 'ngp', 'cic' or 'tsc', got {window!r}"
        )
    positions = _as_positions(positions)
    if positions.shape[0] != 3:
        raise ValueError(f"positions must be (3, ...), got "
                         f"{tuple(positions.shape)}")
    return _paint.paint(positions, tuple(int(s) for s in shape),
                        float(spacing), _as_weights(weights, positions),
                        _paint.ORDERS[window])


def paint_cic(positions, shape, spacing, weights=1.0):
    """CIC-paint particles -> density contrast (see :func:`paint`)."""
    return paint(positions, shape, spacing, weights, window="cic")[0]


def _as_weights(weights, positions):
    """A scalar as a float, an array as a tensor on the positions' device."""
    if isinstance(weights, torch.Tensor):
        return weights.to(positions.device) if weights.ndim else float(weights)
    if np.ndim(weights) == 0:
        return float(weights)
    return torch.as_tensor(np.asarray(weights, np.float32),
                           device=positions.device)


def shot_noise(weights, volume, counts=True):
    """Poisson shot-noise power of a painted catalog [(Mpc/h)^3].

    ``counts=True``: ``weights`` are per-cell Poisson tracer COUNTS and the
    white-noise floor is ``V sum(w) / (sum w)^2``; ``counts=False``: the
    weighted-point formula ``V sum(w^2) / (sum w)^2``.  Sums in float64 (on
    the weights' device for a tensor).
    """
    if isinstance(weights, torch.Tensor):
        w = weights.reshape(-1).to(torch.float64)
        sw = float(w.sum())
        num = sw if counts else float((w * w).sum())
    else:
        w = np.asarray(weights, np.float64).ravel()
        sw = w.sum()
        num = w.sum() if counts else (w * w).sum()
    return float(volume) * float(num) / (sw * sw)


def _catalog_fields(positions, spacing, shape, weights, window, interlaced,
                    what, mesh):
    """(delta, delta2 or None, shape, weights) of a catalog."""
    if mesh is not None:
        raise _mesh_refusal(what)
    positions = _as_positions(positions)
    if shape is None:
        if positions.ndim != 4:
            raise ValueError(
                "pass shape= explicitly for non-grid-layout positions"
            )
        shape = positions.shape[1:]
    shape = tuple(int(s) for s in shape)
    if window not in _paint.ORDERS:
        raise ValueError(
            f"window must be 'ngp', 'cic' or 'tsc', got {window!r}"
        )
    w = _as_weights(weights, positions)
    order = _paint.ORDERS[window]
    delta, _ = _paint.paint(positions, shape, float(spacing), w, order)
    delta2 = None
    if interlaced:
        delta2, _ = _paint.paint(positions, shape, float(spacing), w, order,
                                 shift=float(spacing) / 2.0)
    return delta, delta2, shape, w


def _shot(w, positions, shape, spacing):
    """The counts' shot noise of a catalog's weights (a scalar: every
    particle weighs w, so V sum(w) / (sum w)^2 = V / (n w))."""
    volume = shape[0] * shape[1] * shape[2] * float(spacing) ** 3
    trailing = tuple(positions.shape[1:])
    if isinstance(w, torch.Tensor):
        return shot_noise(torch.broadcast_to(w, trailing), volume)
    sw = float(np.float32(w)) * math.prod(trailing)
    return float(volume) * sw / (sw * sw)


def catalog_power(positions, spacing, shape=None, weights=1.0, nbins=32,
                  window="cic", subtract_shot_noise=None, interlaced=False,
                  mesh=None):
    """P(k) of a particle catalog: paint, deconvolve, bin, de-noise.

    Paints with ``window`` (KP), estimates P(k) with that window
    deconvolved (``validate.fourier.calculate_power(window=...)``) and
    subtracts the shot noise when the catalog is discrete
    (``subtract_shot_noise`` defaults to True for non-scalar weights and
    False for the equal-weight displaced grid).  ``interlaced=True`` paints
    the catalog again half a cell over (the kernel's shift argument) and
    alias-cancels the two spectra.  Returns host float64 ``(k_mean, p_hat,
    n_modes)``.  ``mesh`` raises NotImplementedError (Queue 1 item 8).
    """
    from randomfield_tpu_torch.validate import fourier as _fourier

    if subtract_shot_noise is None:
        subtract_shot_noise = np.ndim(weights) > 0
    delta, delta2, shape, w = _catalog_fields(
        positions, spacing, shape, weights, window, interlaced,
        "catalog_power", mesh)
    k, p, n = _fourier.calculate_power(
        delta, float(spacing), nbins=int(nbins), window=window,
        interlaced_with=delta2,
    )
    if subtract_shot_noise:
        p = p - _shot(w, _as_positions(positions), shape, spacing)
    return k, p, n


def catalog_power_multipoles(positions, spacing, shape=None, weights=1.0,
                             nbins=32, ells=(0, 2, 4), los_axis=2,
                             window="cic", subtract_shot_noise=None,
                             interlaced=False, mesh=None):
    """Redshift-space multipoles P_ell(k) of a particle catalog.

    Paints with ``window``, runs ``calculate_power_multipoles`` with that
    window deconvolved (``interlaced=True`` as in :func:`catalog_power`),
    and subtracts the (flat, monopole-only) shot noise under the same
    default.  Returns ``(k_mean, p_ell, n_modes)``.  ``mesh`` raises
    NotImplementedError (Queue 1 item 8).
    """
    from randomfield_tpu_torch.validate import fourier as _fourier

    if subtract_shot_noise is None:
        subtract_shot_noise = np.ndim(weights) > 0
    delta, delta2, shape, w = _catalog_fields(
        positions, spacing, shape, weights, window, interlaced,
        "catalog_power_multipoles", mesh)
    k, p_ell, n = _fourier.calculate_power_multipoles(
        delta, float(spacing), nbins=int(nbins), ells=ells,
        los_axis=int(los_axis), window=window, interlaced_with=delta2,
    )
    if subtract_shot_noise and 0 in tuple(ells):
        p_ell[tuple(ells).index(0)] -= _shot(w, _as_positions(positions),
                                             shape, spacing)
    return k, p_ell, n


# ---------------------------------------------------------------------------
# Exact (resummed) Zel'dovich power spectrum: host float64, a copy of the
# JAX package's
# ---------------------------------------------------------------------------

def _filon_cos_batch(mu, f, x):
    """Batched Filon: ``Int_0^1 f_b(mu) cos(x_b mu) dmu`` per row.

    ``mu``: (m,) shared increasing nodes on [0, 1]; ``f``: (B, m) smooth
    prefactor rows; ``x``: (B,) oscillation frequencies (the cosine is
    integrated analytically against the piecewise-linear interpolant of
    f).  Rows with |x| ~ 0 fall back to the trapezoid limit.
    """
    x = np.asarray(x, np.float64)
    small = np.abs(x) < 1e-6
    xs = np.where(small, 1.0, x)[:, None]
    s = np.sin(mu[None, :] * xs)
    c = np.cos(mu[None, :] * xs)
    b = np.diff(f, axis=1) / np.diff(mu)[None, :]
    w = np.empty_like(f)
    w[:, 0] = -b[:, 0]
    w[:, -1] = b[:, -1]
    w[:, 1:-1] = b[:, :-1] - b[:, 1:]
    out = (f[:, -1] * s[:, -1] - f[:, 0] * s[:, 0]) / xs[:, 0] \
        + (c * w).sum(axis=1) / (xs[:, 0] * xs[:, 0])
    if small.any():
        trap = np.trapezoid(f[small], mu, axis=1)
        out[small] = trap
    return out


def zeldovich_power(power, k=None, z=0.0, cosmology=None, n_q=12288,
                    q_max=700.0, n_mu=96, n_psi=4096):
    """EXACT Zel'dovich (1LPT-resummed) power spectrum (Taylor & Hamilton
    1996), the reference's algorithm:

        P_ZA(k) = e^{-k^2 sigma_v^2} P_lin(k)
                  + Int d^3q e^{-i k.q} [ e^{-(1/2) k k C}
                    - e^{-k^2 sigma_v^2} (1 + k_i k_j Psi_ij) ],

    C_ij = X delta_ij + Y qhat_i qhat_j from the displacement correlators
    (:func:`..models.streaming.velocity_correlations` at f = 1); the angular
    integral by batched Filon quadrature in mu, the subtraction's mu moments
    closed form, the radial integral trapezoid on a linear q grid.  With
    ``z``/``cosmology`` the table is growth-scaled by D(z)^2 first.  Host
    float64; returns ``(k, p_za)``.
    """
    from randomfield_tpu_torch.models.cosmology import create_cosmology
    from randomfield_tpu_torch.models.streaming import velocity_correlations
    from randomfield_tpu_torch.ops.fftlog import resample_loglog
    from randomfield_tpu_torch.ops.power import validate_power

    k_t, p_t = validate_power(power)
    z = float(z)
    if z != 0.0:
        cosmo = create_cosmology(cosmology)
        d = float(cosmo.growth_function(z))
        p_t = p_t * d * d
    if k is None:
        k = np.geomspace(max(1e-3, k_t[0]), min(2.0, k_t[-1]), 64)
    k = np.atleast_1d(np.asarray(k, np.float64))
    if np.any(k <= 0):
        raise ValueError("k must be positive")

    q = np.linspace(0.0, float(q_max), int(n_q))
    q[0] = 0.5 * q[1]
    psi_par, psi_perp, sv2 = velocity_correlations(
        (k_t, p_t), q, f=1.0, n=int(n_psi))
    x_corr = 2.0 * (sv2 - psi_perp)       # X(q)
    y_corr = 2.0 * (psi_perp - psi_par)   # Y(q)
    alpha = psi_perp                      # k k Psi = k^2 (alpha + beta mu^2)
    beta = psi_par - psi_perp
    mu = np.linspace(0.0, 1.0, int(n_mu))
    mu2 = mu * mu
    p_lin = resample_loglog(np.asarray(k_t, np.float64),
                            np.asarray(p_t, np.float64), k)

    out = np.empty_like(k)
    dq = np.gradient(q)
    for i, kk in enumerate(k):
        kq = kk * q
        damp = np.exp(-kk * kk * sv2)
        g = np.exp(-0.5 * kk * kk
                   * (x_corr[:, None] + y_corr[:, None] * mu2[None, :]))
        ang = _filon_cos_batch(mu, g, kq)          # (n_q,)
        # closed-form mu moments of the subtraction:
        # Int_0^1 cos(x mu) dmu = j0(x);  Int_0^1 mu^2 cos(x mu) dmu
        small = kq < 1e-3
        xs = np.where(small, 1.0, kq)
        j0 = np.where(small, 1.0 - kq * kq / 6.0, np.sin(xs) / xs)
        m2 = np.where(
            small, 1.0 / 3.0 - kq * kq / 10.0,
            ((xs * xs - 2.0) * np.sin(xs) + 2.0 * xs * np.cos(xs))
            / xs**3)
        sub = damp * ((1.0 + kk * kk * alpha) * j0 + kk * kk * beta * m2)
        out[i] = (damp * p_lin[i]
                  + 4.0 * np.pi * np.sum(q * q * (ang - sub) * dq))
    return k, out
