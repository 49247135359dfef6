"""Constrained Gaussian realizations (Hoffman-Ribak) and Wiener filtering.

Port of the single-device part of ``randomfield_tpu/models/constrained.py``
with its names, arguments and conventions.  The engine's packed spectrum
c_k satisfies delta(x) = sum_k c_k exp(ik.x), independent packed modes of
variance <|c_k|^2> = sigma(k)^2 and Hermitian multiplicity m_k (2 for
interior kz, 1 on the self-conjugate kz planes).  A linear functional with
Hermitian kernel K_i(k) has

    Gamma_i[c]  = sum m_k Re(c_k K_i(k))
    xi_ij       = <Gamma_i Gamma_j> = sum m_k sigma_k^2 Re(K_i K_j*)

and the Hoffman-Ribak constrained realization of seed s is

    c_c = c_s + sigma_eff^2 * sum_i alpha_i K_i*,
    alpha = xi^{-1} (values - Gamma[c_s]),

which meets every constraint exactly per realization.  K_i(k) =
exp(-k^2 R_i^2 / 2) exp(+i k.x_i), its imaginary part zeroed at the truly
self-conjugate modes.

On one device a constrained render is the unit Hermitian draw (K2F's
spectrum mode with a unit sigma table: the canonical normals, / sqrt(2)
and the plane fix; KN's for ``nested``), KC MEASURE (scaling the draws in
place by the per-mode sigma grid and the filter, then Gamma), the M x M
solve in float64 on the host, KC CORRECT, the Hermitian part of the two
self-conjugate planes (what the reference's c2r keeps of them), then K3 x2
and K4 with the weights (:mod:`..ops.constraint`).  The Gram matrix is float64 matmuls over
the same float32 kernels.  The Wiener filter and the posterior sample run
the hand transforms (K6, K3; K3, K4) around plain elementwise stages, as
the reference leaves those to XLA.  The mesh programs (the reference's
``make_sharded_*``) are ROADMAP.md, Queue 1 item 8.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import constraint as _kc
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.ops import threefry as _threefry
from randomfield_tpu_torch.ops import transform as _transform

__all__ = [
    "pack_constraints",
    "constraint_gram",
    "constrained_render",
    "constrained_mean",
    "measure_constraints",
    "wiener_filter",
    "posterior_render",
    "predicted_posterior_mse",
]

# x planes a step of the elementwise stages (bounds their temporaries)
_X_CHUNK = 64


def pack_constraints(constraints, shape, spacing, dtype=np.float32):
    """Normalize a constraint list to (positions, scales, values) arrays.

    Each constraint is a mapping or tuple ``(position, value, scale)``:
    ``position`` — 3 comoving coordinates in length units; ``value`` — the
    target smoothed overdensity; ``scale`` — Gaussian smoothing radius R
    (``W(k) = exp(-k^2 R^2 / 2)``; 0 pins the raw band-limited value).  An
    already packed ``(positions (M, 3), scales (M,), values (M,))`` triple,
    as the JAX package's ``pack_constraints`` returns it, is taken as it
    is.  Returns host numpy arrays of ``dtype`` (float32, as the JAX
    package rounds them).
    """
    if (isinstance(constraints, tuple) and len(constraints) == 3
            and np.ndim(constraints[0]) == 2):
        pos, scl, val = (np.asarray(a, np.float64) for a in constraints)
        if (pos.shape[1:] != (3,) or scl.shape != (len(pos),)
                or val.shape != (len(pos),)):
            raise ValueError("packed constraints must be (positions (M, 3), "
                             "scales (M,), values (M,))")
    else:
        pos, val, scl = [], [], []
        for c in constraints:
            if isinstance(c, dict):
                p = c["position"]
                v = c["value"]
                s = c.get("scale", 0.0)
            else:
                p, v, s = (*c, 0.0)[:3] if len(c) == 2 else c
            p = np.asarray(p, np.float64)
            if p.shape != (3,):
                raise ValueError(
                    f"constraint position must be 3 coords, got {p.shape}")
            pos.append(p)
            val.append(float(v))
            scl.append(float(s))
        if not pos:
            raise ValueError("need at least one constraint")
        pos, scl, val = np.stack(pos), np.asarray(scl), np.asarray(val)
    if len(pos) == 0:
        raise ValueError("need at least one constraint")
    dt = np.dtype(dtype)
    return pos.astype(dt), scl.astype(dt), val.astype(dt)


def _tables(pos, scales, shape, spacing, device):
    return _kc.axis_tables(np.asarray(pos, np.float32),
                           np.asarray(scales, np.float32), shape, spacing,
                           device)


def constraint_gram(sigmas, pos, scales, smoothing_length, shape, spacing):
    """The M x M constraint covariance matrix xi: a float64 tensor on the
    sigma grid's device (:func:`..ops.constraint.gram`).  Coincident or
    window-degenerate constraints make it singular."""
    tables = _tables(pos, scales, shape, spacing, sigmas.device)
    return _kc.gram(tables, sigmas, smoothing_length)


def _solve(gram, rhs):
    """float32 alpha = xi^{-1} rhs, solved in float64 on the host."""
    g = torch.as_tensor(gram).detach().cpu().numpy().astype(np.float64)
    return np.linalg.solve(g, np.asarray(rhs, np.float64)).astype(np.float32)


_UNIT_TABLES = {}


def _unit_table(device):
    """A sigma table of two unit knots: K2F's and KN's amplitude is then
    exactly 1 (times their gain 1/sqrt(2)) at every mode but DC (0)."""
    key = str(device)
    if key not in _UNIT_TABLES:
        _UNIT_TABLES[key] = _sampler.SigmaTable(
            0.0, 1.0, torch.ones(2, dtype=torch.float32, device=device))
    return _UNIT_TABLES[key]


def unit_hermitian(key, shape, spacing, device, nested=False):
    """The reference's ``sample_unit_hermitian`` (or its nested twin) of a
    Threefry key pair: (re, im) float32, (x + i y) / sqrt(2) of the unit
    normals with the kz = 0 / Nyquist planes made Hermitian, DC zero (every
    use multiplies it by sigma(0) = 0).  K2F's spectrum mode (KN's) with a
    unit sigma table."""
    table = _unit_table(device)
    draw = _sampler.sample_nested if nested else _sampler.draw_scale
    spec = draw(_threefry.as_key(key), table, shape, spacing, 0.0)
    return spec[0], spec[1]


def constrained_render(key, sigmas, weights, gram, pos, scales, values,
                       smoothing_length, shape, spacing, nested=False):
    """Hoffman-Ribak constrained realization for one key (module core):
    the unit draw, KC MEASURE (scaling it by sigma and the filter), the
    float64 solve, KC CORRECT, then K3, K3 and K4 times ``weights``."""
    shape = tuple(int(s) for s in shape)
    tables = _tables(pos, scales, shape, spacing, sigmas.device)
    re, im = unit_hermitian(key, shape, spacing, sigmas.device, nested)
    gamma = _kc.measure(re, im, tables, sigmas, smoothing_length)
    alpha = _solve(gram, np.asarray(values, np.float64)
                   - gamma.cpu().numpy())
    _kc.correct(re, im, tables, alpha, sigmas, smoothing_length)
    return _to_field(re, im, shape, weights)


def _to_field(re, im, shape, weights):
    """K3, K3, K4 of a corrected spectrum.  A kernel at an off-grid position
    is not Hermitian on the kz = 0 / Nyquist planes along an even axis's
    Nyquist row (e_x(-k_N) is not conj e_x(k_N)); the reference's c2r keeps
    those planes' Hermitian part, so they are projected onto it first."""
    _transform.hermitian_part_reim(re, im, shape[2])
    return _transform.irfftn_reim(re, im, shape, weights)


def constrained_mean(sigmas, weights, gram, pos, scales, values,
                     smoothing_length, shape, spacing):
    """The conditional mean field given the constraints (no randomness):
    KC CORRECT on a zero spectrum, then K3, K3, K4."""
    shape = tuple(int(s) for s in shape)
    tables = _tables(pos, scales, shape, spacing, sigmas.device)
    alpha = _solve(gram, values)
    re = torch.zeros_like(sigmas)
    im = torch.zeros_like(sigmas)
    _kc.correct(re, im, tables, alpha, sigmas, smoothing_length)
    return _to_field(re, im, shape, weights)


def measure_constraints(delta, pos, scales, shape, spacing):
    """Evaluate the constraint functionals on a real-space field: float64
    (M,) on the field's device.  The forward transform (K6, K3 x2) then KC
    MEASURE on the raw spectrum, over the cell count (the reference's
    ``norm='forward'``): independent of a render's own Gamma."""
    shape = tuple(int(s) for s in shape)
    delta = torch.as_tensor(delta)
    re, im = _transform.rfftn(delta.to(torch.float32))
    tables = _tables(pos, scales, shape, spacing, delta.device)
    return _kc.measure(re, im, tables) / float(np.prod(shape))


def _noise_var_grid(noise_power, shape, spacing, dtype=torch.float32,
                    device="cpu"):
    """Per-packed-mode noise variance P_n(|k|) / V in engine units: a
    float32 scalar tensor for white noise (per-voxel std s <=> noise_power
    = s^2 spacing^3), else the (k, P_n) table interpolated like the signal
    spectrum, a grid on ``device``."""
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    if np.isscalar(noise_power) or getattr(noise_power, "ndim", 1) == 0:
        return torch.tensor(float(noise_power) / volume, dtype=dtype,
                            device=device)
    table = _power.validate_power(noise_power)
    kmag = _grid.kmag(shape, spacing, dtype, device)
    pn = _power.interpolate_power(table, kmag, "log10k", dtype)
    return pn / float(np.float32(volume))


def _wiener_weight(sigmas, nvar):
    """sigma^2 / (sigma^2 + P_n/V), 0 at degenerate (both-zero) modes —
    the DC mode has sigma = 0, so it is always zeroed."""
    s2 = sigmas * sigmas
    denom = s2 + nvar
    return torch.where(denom > 0, s2 / torch.where(denom > 0, denom, 1.0),
                       0.0)


def _rows(t, x0, x1):
    return t[x0:x1] if t.ndim == 3 else t


def _forward(data, shape):
    """(re, im) = rfftn(data, norm='forward') in float32: the hand forward
    transform, then 1/N."""
    data = torch.as_tensor(data).to(torch.float32)
    re, im = _transform.rfftn(data)
    inv = float(np.float32(1.0 / np.prod(shape)))
    return re.mul_(inv), im.mul_(inv)


def wiener_filter(data, sigmas, noise_power, shape, spacing):
    """Wiener-filtered (minimum-variance) field reconstruction.

    ``data = field + noise`` on the full grid; per mode the filter is
    ``sigma^2 / (sigma^2 + P_n/V)``.  The forward transform (K6, K3 x2),
    the filter x-slab by x-slab, the inverse (K3 x2, K4), on the sigma
    grid's device.
    """
    shape = tuple(int(s) for s in shape)
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype,
                           sigmas.device)
    re, im = _forward(torch.as_tensor(data).to(sigmas.device), shape)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        w = _wiener_weight(sigmas[x0:x1], _rows(nvar, x0, x1))
        re[x0:x1] *= w
        im[x0:x1] *= w
    return _transform.irfftn_reim(re, im, shape)


def posterior_render(key, data, sigmas, noise_power, shape, spacing):
    """One exact posterior sample of the field given full-grid noisy data:
    ``delta_r + WF(data - delta_r - n_r)`` with the prior draw at the first
    key of ``split(key)`` and the noise draw at the second (the reference's
    ``jax.random.split``), each a unit Hermitian draw (K2F) times its
    sigma; the combination x-slab by x-slab, then K3 x2 and K4."""
    shape = tuple(int(s) for s in shape)
    dev = sigmas.device
    k_s, k_n = _threefry.split(_threefry.as_key(key))
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype, dev)
    rr, ri = unit_hermitian(k_s, shape, spacing, dev)
    nr, ni = unit_hermitian(k_n, shape, spacing, dev)
    dr, di = _forward(torch.as_tensor(data).to(dev), shape)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        sig = sigmas[x0:x1]
        nv = _rows(nvar, x0, x1)
        nsig = torch.sqrt(nv)
        w = _wiener_weight(sig, nv)
        for r, n, d in ((rr, nr, dr), (ri, ni, di)):
            cr = r[x0:x1] * sig
            cn = n[x0:x1] * nsig
            d[x0:x1] = cr + w * ((d[x0:x1] - cr) - cn)
    del rr, ri, nr, ni
    return _transform.irfftn_reim(dr, di, shape)


def predicted_posterior_mse(sigmas, noise_power, shape, spacing, nz=None):
    """Exact expected field-mean square error of the Wiener reconstruction:
    sum_packed m_k sigma_k^2 (P_n/V) / (sigma_k^2 + P_n/V), in float64 on
    the sigma grid's device.  A posterior SAMPLE doubles this."""
    shape = tuple(int(s) for s in shape)
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype,
                           sigmas.device)
    mult = _grid.kz_multiplicity(shape[2], sigmas.device)
    total = torch.zeros((), dtype=torch.float64, device=sigmas.device)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        s2 = sigmas[x0:x1].to(torch.float64) ** 2
        nv = torch.broadcast_to(_rows(nvar, x0, x1).to(torch.float64),
                                s2.shape)
        cond = s2 * nv / torch.where(s2 + nv > 0, s2 + nv, 1.0)
        total += (mult * cond).sum()
    return float(total)
