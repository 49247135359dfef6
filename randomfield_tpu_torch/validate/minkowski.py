"""Minkowski functionals V0..V3 with exact Gaussian expectations.

Port of ``randomfield_tpu/validate/minkowski.py`` (one device).  The four
3-D Minkowski functional densities of the excursion set {u >= nu}

    v0 = volume fraction,  v1 = surface area / 6,
    v2 = integrated mean curvature / (6 pi),
    v3 = integrated Gaussian curvature / (4 pi)   (Euler characteristic)

have the Tomita (1986) / Schmalzing & Buchert (1997) Gaussian expectations
in sigma0^2 = <u^2> and sigma1^2 = <|grad u|^2> alone
(:func:`gaussian_minkowski`).  The measurement differentiates spectrally:
one forward transform of u (:func:`..ops.transform.rfftn`: K6 and forward
K3 on CUDA), then nine inverse transforms (:func:`..ops.transform.
irfftn_reim`: K3, K3, K4) of i k_a u_k and -k_a k_b u_k on the
Nyquist-zeroed gradient vectors (:func:`..ops.derived.grad_kvectors`), and
KM (:func:`..ops.minkowski.threshold_sums`) forms the curvature invariants
of each voxel and sums them into the threshold bins without writing them
out.  :func:`spectral_moments` sums the matching moments on the device in
float64, a chunk of x planes at a time, where the JAX package sums float32
over every mode at once.

At 1024^3 the measurement holds u, the spectrum and the nine float32
derivative fields (about 48 GiB at its peak, besides the caller's field).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import extrema as _extrema
from randomfield_tpu_torch.ops import minkowski as _km
from randomfield_tpu_torch.ops import transform as _transform
from randomfield_tpu_torch.validate import peaks as _peaks
from randomfield_tpu_torch.validate.stats import mesh_not_ported

__all__ = [
    "minkowski_functionals",
    "gaussian_minkowski",
    "spectral_moments",
    "derivative_fields",
]

_BCAST = ((slice(None), None, None), (None, slice(None), None),
          (None, None, slice(None)))


def derivative_fields(u, spacing):
    """The nine float32 spectral derivatives of a field u: (g0, g1, g2) =
    grad u and the Hessian's (a00, a11, a22, a01, a02, a12), as the JAX
    package's ``_field_invariants`` builds them: the ``norm='forward'``
    spectrum a = rfftn(u) / N times i k_a (g) or -(k_a k_b) (the Hessian) on
    the Nyquist-zeroed vectors, each through the inverse transform.  The
    spectrum is consumed by the last one."""
    u = torch.as_tensor(u)
    shape = tuple(int(s) for s in u.shape)
    re, im = _transform.rfftn(u)
    inv_n = 1.0 / (shape[0] * shape[1] * shape[2])
    re.mul_(inv_n)
    im.mul_(inv_n)
    kv = [k[b] for k, b in zip(_derived.grad_kvectors(
        shape, float(spacing), torch.float32, u.device), _BCAST)]
    out = []
    jobs = [("g", i, None) for i in range(3)] + [("a", a, b) for a, b in
                                                 _derived.TIDAL_PAIRS]
    for kind, a, b in jobs[:-1]:
        r, i = torch.empty_like(re), torch.empty_like(im)
        if kind == "g":
            torch.mul(im, kv[a], out=r).neg_()
            torch.mul(re, kv[a], out=i)
        else:
            f = -(kv[a] * kv[b])
            torch.mul(re, f, out=r)
            torch.mul(im, f, out=i)
        out.append(_transform.irfftn_reim(r, i, shape))
        del r, i
    _, a, b = jobs[-1]  # a Hessian term, in place on the spectrum
    f = -(kv[a] * kv[b])
    out.append(_transform.irfftn_reim(re.mul_(f), im.mul_(f), shape))
    return out


def minkowski_functionals(delta, spacing, nbins=24, nu_max=3.0,
                          sigma0=None, mesh=None):
    """Measured Minkowski functional densities of a 3-D field.

    Thresholds are ``nbins`` uniform nu over [-nu_max, nu_max] in units of
    ``sigma0`` (the field's own standard deviation by default; pass the
    predicted one to gate against theory).  Returns ``(nu, v0, v1, v2,
    v3)``: v0 exact at each nu (the voxels above the bin's lower edge less
    half the bin), v1..v3 the <w delta(u - nu)> of the threshold bins of
    width dnu (bias O(dnu^2)), lengths in the units of ``spacing``.  Runs
    on ``delta``'s device; ``mesh`` raises NotImplementedError.
    """
    if mesh is not None:
        raise mesh_not_ported("minkowski_functionals", mesh)
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"delta must be one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    shape = tuple(int(s) for s in delta.shape)
    sigma0 = _peaks.resolve_sigma0(delta, sigma0)
    nu = np.linspace(-float(nu_max), float(nu_max), int(nbins))
    dnu = nu[1] - nu[0]
    edges = np.concatenate([nu - 0.5 * dnu, [nu[-1] + 0.5 * dnu]])
    u = _extrema.unit_field(delta, sigma0)
    derivs = derivative_fields(u, spacing)
    counts, sums = _km.threshold_sums(u, derivs, edges)
    del derivs, u
    counts = counts.cpu().numpy().astype(np.float64)
    out = sums.cpu().numpy()
    n = float(np.prod(shape))
    tail = counts[-1]
    counts = counts[:-1]
    above_edge = np.cumsum(counts[::-1])[::-1] + tail
    v0 = (above_edge - 0.5 * counts) / n
    scale = 1.0 / (n * dnu)
    v1 = out[0] * scale / 6.0
    v2 = out[1] * scale / (6.0 * np.pi)
    v3 = out[2] * scale / (4.0 * np.pi)
    return nu, v0, v1, v2, v3


def spectral_moments(power, shape, spacing, smoothing_length=0.0,
                     interpolation="log10k", device="cuda"):
    """(sigma0^2, sigma1^2) of the band-limited field: sigma_eff(k)^2 and
    |k_grad|^2 sigma_eff(k)^2 summed over the packed modes with Hermitian
    multiplicity, with the render's interpolation and smoothing and the
    estimator's Nyquist-zeroed gradient vectors, in float64 on ``device``
    (:func:`.peaks.mode_moments`)."""
    s0, s1, _ = _peaks.mode_moments(power, shape, spacing, smoothing_length,
                                    interpolation, device, gradient=True)
    return s0, s1


def gaussian_minkowski(nu, sigma0_sq, sigma1_sq):
    """Exact Gaussian-field Minkowski densities at thresholds ``nu`` (host
    float64), given the :func:`spectral_moments`.  Returns ``(v0, v1, v2,
    v3)``."""
    nu = np.asarray(nu, np.float64)
    lam = np.sqrt(float(sigma1_sq) / (3.0 * float(sigma0_sq)))
    e = np.exp(-0.5 * nu * nu)
    v0 = 0.5 * np.vectorize(math.erfc)(nu / np.sqrt(2.0))
    v1 = lam * e / (3.0 * np.pi)
    v2 = (2.0 / 3.0) * lam**2 * nu * e / (2.0 * np.pi) ** 1.5
    v3 = lam**3 * (nu * nu - 1.0) * e / (2.0 * np.pi) ** 2
    return v0, v1, v2, v3
