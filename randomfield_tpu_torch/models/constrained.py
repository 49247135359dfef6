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
the reference leaves those to XLA.

On a slab mesh (``mesh=``; the reference's ``make_sharded_*`` programs)
every function takes the rank's (nx, ny/P, nzh) ky slab of the sigma grid
and its (nx/P, ny, nz) x slabs of fields, and returns its x slab of a
field or the whole grid's numbers on every rank: the unit draws are K7 (or
KN's shard) on the rank's ky rows, KC runs on its ky block
(:func:`..ops.constraint.ky_block`), MEASURE's and the Gram's float64 sums
and the posterior MSE's are all-reduced, the M x M solve stays on the
host, the Hermitian part of the kz = 0 / Nyquist planes is taken from the
two planes gathered whole (:func:`_hermitian_part`), and the transforms
are the distributed ones (:mod:`..parallel.dfft`).
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
from randomfield_tpu_torch.parallel import dfft as _dfft
from randomfield_tpu_torch.validate import stats as _stats

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


def _tables(pos, scales, shape, spacing, device, mesh=None):
    """The constraints' tables on the whole grid, or on a slab mesh's ky
    block of the rank."""
    tables = _kc.axis_tables(np.asarray(pos, np.float32),
                             np.asarray(scales, np.float32), shape, spacing,
                             device)
    return tables if mesh is None else _kc.ky_block(
        tables, *mesh.rows(shape[1]))


def constraint_gram(sigmas, pos, scales, smoothing_length, shape, spacing,
                    mesh=None):
    """The M x M constraint covariance matrix xi: a float64 tensor on the
    sigma grid's device (:func:`..ops.constraint.gram`; on a mesh the ranks'
    ky blocks' sums all-reduced).  Coincident or window-degenerate
    constraints make it singular."""
    tables = _tables(pos, scales, shape, spacing, sigmas.device, mesh)
    return _stats.mesh_sum(_kc.gram(tables, sigmas, smoothing_length),
                           mesh)


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


def unit_hermitian(key, shape, spacing, device, nested=False, mesh=None):
    """The reference's ``sample_unit_hermitian`` (or its nested twin) of a
    Threefry key pair: (re, im) float32, (x + i y) / sqrt(2) of the unit
    normals with the kz = 0 / Nyquist planes made Hermitian, DC zero (every
    use multiplies it by sigma(0) = 0).  K2F's spectrum mode (KN's) with a
    unit sigma table; on a slab mesh the rank's ky rows, K7 (KN's shard)."""
    table = _unit_table(device)
    key = _threefry.as_key(key)
    if mesh is None:
        draw = _sampler.sample_nested if nested else _sampler.draw_scale
        spec = draw(key, table, shape, spacing, 0.0)
    else:
        y_off, ny_loc = mesh.rows(shape[1])
        if nested:
            spec = _sampler.sample_nested(key, table, shape, spacing, 0.0,
                                          y_off=y_off, ny_loc=ny_loc)
        else:
            spec = _sampler.draw_scale_shard(key, table, shape, spacing, 0.0,
                                             y_off, ny_loc)
    return spec[0], spec[1]


def constrained_render(key, sigmas, weights, gram, pos, scales, values,
                       smoothing_length, shape, spacing, nested=False,
                       mesh=None):
    """Hoffman-Ribak constrained realization for one key (module core):
    the unit draw, KC MEASURE (scaling it by sigma and the filter), the
    float64 solve, KC CORRECT, then K3, K3 and K4 times ``weights``."""
    shape = tuple(int(s) for s in shape)
    tables = _tables(pos, scales, shape, spacing, sigmas.device, mesh)
    re, im = unit_hermitian(key, shape, spacing, sigmas.device, nested, mesh)
    gamma = _stats.mesh_sum(
        _kc.measure(re, im, tables, sigmas, smoothing_length), mesh)
    alpha = _solve(gram, np.asarray(values, np.float64)
                   - gamma.cpu().numpy())
    _kc.correct(re, im, tables, alpha, sigmas, smoothing_length)
    return _to_field(re, im, shape, weights, mesh)


def _hermitian_part(re, im, shape, mesh):
    """:func:`..ops.transform.hermitian_part_reim` of a spectrum, or of a
    slab mesh's ky slab: the kz = 0 and Nyquist planes gathered whole (one
    ``all_gather`` of 2 nx ny float32 pairs), projected as on one device
    and cut back to the rank's rows, so the rows are the whole grid's bit
    for bit."""
    if mesh is None:
        return _transform.hermitian_part_reim(re, im, shape[2])
    planes = _grid.self_conjugate_kz_planes(shape[2])
    y_off, ny_loc = mesh.rows(shape[1])
    full = mesh.all_gather(torch.stack([t[..., p] for p in planes
                                        for t in (re, im)]), dim=-1)
    for i, p in enumerate(planes):
        fre, fim = full[2 * i][..., None], full[2 * i + 1][..., None]
        _transform.hermitian_part_reim(fre, fim, 1)
        re[..., p] = fre[:, y_off:y_off + ny_loc, 0]
        im[..., p] = fim[:, y_off:y_off + ny_loc, 0]
    return re, im


def _to_field(re, im, shape, weights, mesh=None):
    """K3, K3, K4 of a corrected spectrum (the distributed inverse on a
    mesh).  A kernel at an off-grid position is not Hermitian on the kz = 0
    / Nyquist planes along an even axis's Nyquist row (e_x(-k_N) is not
    conj e_x(k_N)); the reference's c2r keeps those planes' Hermitian part,
    so they are projected onto it first."""
    _hermitian_part(re, im, shape, mesh)
    if mesh is not None:
        return _dfft.irfftn_slab_reim(re, im, shape, mesh, weights)
    return _transform.irfftn_reim(re, im, shape, weights)


def constrained_mean(sigmas, weights, gram, pos, scales, values,
                     smoothing_length, shape, spacing, mesh=None):
    """The conditional mean field given the constraints (no randomness):
    KC CORRECT on a zero spectrum, then K3, K3, K4."""
    shape = tuple(int(s) for s in shape)
    tables = _tables(pos, scales, shape, spacing, sigmas.device, mesh)
    alpha = _solve(gram, values)
    re = torch.zeros_like(sigmas)
    im = torch.zeros_like(sigmas)
    _kc.correct(re, im, tables, alpha, sigmas, smoothing_length)
    return _to_field(re, im, shape, weights, mesh)


def measure_constraints(delta, pos, scales, shape, spacing, mesh=None):
    """Evaluate the constraint functionals on a real-space field: float64
    (M,) on the field's device.  The forward transform (K6, K3 x2) then KC
    MEASURE on the raw spectrum, over the cell count (the reference's
    ``norm='forward'``): independent of a render's own Gamma.  On a slab
    mesh ``delta`` is the rank's x slab and every rank gets the whole
    field's values."""
    shape = tuple(int(s) for s in shape)
    delta = torch.as_tensor(delta)
    re, im = _dfft.forward(delta.to(torch.float32), mesh)
    tables = _tables(pos, scales, shape, spacing, delta.device, mesh)
    return (_stats.mesh_sum(_kc.measure(re, im, tables), mesh)
            / float(np.prod(shape)))


def _noise_var_grid(noise_power, shape, spacing, dtype=torch.float32,
                    device="cpu", mesh=None):
    """Per-packed-mode noise variance P_n(|k|) / V in engine units: a
    float32 scalar tensor for white noise (per-voxel std s <=> noise_power
    = s^2 spacing^3), else the (k, P_n) table interpolated like the signal
    spectrum, a grid on ``device`` (a slab mesh rank's ky rows)."""
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    if np.isscalar(noise_power) or getattr(noise_power, "ndim", 1) == 0:
        return torch.tensor(float(noise_power) / volume, dtype=dtype,
                            device=device)
    table = _power.validate_power(noise_power)
    y_off, ny_loc = (0, ny) if mesh is None else mesh.rows(ny)
    kmag = _grid.kmag(shape, spacing, dtype, device, y_off=y_off,
                      ny_loc=ny_loc)
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


def _forward(data, shape, mesh=None):
    """(re, im) = rfftn(data, norm='forward') in float32: the hand forward
    transform (the distributed one of a mesh's x slab), then 1/N."""
    data = torch.as_tensor(data).to(torch.float32)
    re, im = _dfft.forward(data, mesh)
    inv = float(np.float32(1.0 / np.prod(shape)))
    return re.mul_(inv), im.mul_(inv)


def wiener_filter(data, sigmas, noise_power, shape, spacing, mesh=None):
    """Wiener-filtered (minimum-variance) field reconstruction.

    ``data = field + noise`` on the full grid (a slab mesh rank's x slab);
    per mode the filter is ``sigma^2 / (sigma^2 + P_n/V)``.  The forward
    transform (K6, K3 x2), the filter x-slab by x-slab, the inverse (K3 x2,
    K4), on the sigma grid's device.
    """
    shape = tuple(int(s) for s in shape)
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype,
                           sigmas.device, mesh)
    re, im = _forward(torch.as_tensor(data).to(sigmas.device), shape, mesh)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        w = _wiener_weight(sigmas[x0:x1], _rows(nvar, x0, x1))
        re[x0:x1] *= w
        im[x0:x1] *= w
    return _dfft.inverse(re, im, shape, mesh)


def posterior_render(key, data, sigmas, noise_power, shape, spacing,
                     mesh=None):
    """One exact posterior sample of the field given full-grid noisy data:
    ``delta_r + WF(data - delta_r - n_r)`` with the prior draw at the first
    key of ``split(key)`` and the noise draw at the second (the reference's
    ``jax.random.split``), each a unit Hermitian draw (K2F; K7 on a mesh's
    ky rows) times its sigma; the combination x-slab by x-slab, then K3 x2
    and K4."""
    shape = tuple(int(s) for s in shape)
    dev = sigmas.device
    k_s, k_n = _threefry.split(_threefry.as_key(key))
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype, dev,
                           mesh)
    rr, ri = unit_hermitian(k_s, shape, spacing, dev, mesh=mesh)
    nr, ni = unit_hermitian(k_n, shape, spacing, dev, mesh=mesh)
    dr, di = _forward(torch.as_tensor(data).to(dev), shape, mesh)
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
    return _dfft.inverse(dr, di, shape, mesh)


def predicted_posterior_mse(sigmas, noise_power, shape, spacing, nz=None,
                            mesh=None):
    """Exact expected field-mean square error of the Wiener reconstruction:
    sum_packed m_k sigma_k^2 (P_n/V) / (sigma_k^2 + P_n/V), in float64 on
    the sigma grid's device (on a mesh, each rank's ky rows all-reduced).
    A posterior SAMPLE doubles this."""
    shape = tuple(int(s) for s in shape)
    nvar = _noise_var_grid(noise_power, shape, spacing, sigmas.dtype,
                           sigmas.device, mesh)
    mult = _grid.kz_multiplicity(shape[2], sigmas.device)
    total = torch.zeros((), dtype=torch.float64, device=sigmas.device)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        s2 = sigmas[x0:x1].to(torch.float64) ** 2
        nv = torch.broadcast_to(_rows(nvar, x0, x1).to(torch.float64),
                                s2.shape)
        cond = s2 * nv / torch.where(s2 + nv > 0, s2 + nv, 1.0)
        total += (mult * cond).sum()
    return float(_stats.mesh_sum(total, mesh))
