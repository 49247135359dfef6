"""Power-spectrum tables: coercion, validation, coverage, filtering.

Port of the scene-setup subset of ``randomfield_tpu/ops/power.py`` with the
same conventions: P(k) is interpolated against log10 k (linear in P by
default, log-log on request), and the render folds the box volume into the
mode amplitude,

    sigma(k) = sqrt(P(|k|) / V),   sigma(0) = 0,

so the inverse transform is a raw ``norm='forward'`` c2r.  The per-seed
render reads sigma from the uniform log10-k table of
:mod:`randomfield_tpu_torch.ops.sampler`; :func:`tabulate_sigmas` here is
the direct per-mode evaluation, kept as the reference the tests hold that
table to.  :func:`interpolate_power` evaluates the table at a tensor of
|k| on its device (the predictions' grids); :func:`sigma_r`,
:func:`sigma8`, :func:`normalize_power` and the theory transforms
:func:`power_to_correlation`, :func:`power_to_correlation_multipoles` and
:func:`power_to_projected_correlation` run in host float64 numpy, as in
the JAX package.
"""

from __future__ import annotations

import pathlib
import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid

__all__ = [
    "PowerTable",
    "as_power_table",
    "validate_power",
    "load_default_power",
    "require_coverage",
    "table_arrays_host",
    "tabulate_sigmas",
    "filter_modes",
    "get_k_bounds",
    "fill_with_log10k",
    "interpolate_power",
    "grid_power",
    "sigma_r",
    "sigma8",
    "normalize_power",
    "power_to_correlation",
    "power_to_correlation_multipoles",
    "power_to_projected_correlation",
]

get_k_bounds = _grid.get_k_bounds
fill_with_log10k = _grid.fill_with_log10k

# the port's own copy of the default table (EH98 at Planck13), byte for
# byte the JAX package's
_DEFAULT_POWER = (
    pathlib.Path(__file__).resolve().parents[1] / "data" / "default_power.dat"
)


class PowerTable(typing.NamedTuple):
    """Tabulated isotropic power spectrum: k [h/Mpc], Pk [(Mpc/h)^3]."""

    k: np.ndarray
    Pk: np.ndarray


def as_power_table(power) -> PowerTable:
    """Coerce (N,2) arrays, (k, Pk) pairs, dicts or structured arrays."""
    if isinstance(power, PowerTable):
        return power
    if isinstance(power, dict):
        return PowerTable(
            np.asarray(power["k"], np.float64), np.asarray(power["Pk"], np.float64)
        )
    arr = np.asarray(power)
    if arr.dtype.names:  # structured array with k/Pk fields
        return PowerTable(
            np.asarray(arr["k"], np.float64), np.asarray(arr["Pk"], np.float64)
        )
    if isinstance(power, (tuple, list)) and len(power) == 2:
        return PowerTable(
            np.asarray(power[0], np.float64), np.asarray(power[1], np.float64)
        )
    arr = np.asarray(arr, np.float64)
    if arr.ndim == 2 and arr.shape[1] == 2:
        return PowerTable(arr[:, 0].copy(), arr[:, 1].copy())
    raise ValueError(
        "power must be a PowerTable, (k, Pk) pair, {'k':..,'Pk':..} dict, "
        "structured array with k/Pk fields, or (N, 2) array"
    )


def validate_power(power) -> PowerTable:
    """Require 1-D equal-length arrays, strictly increasing k > 0 and finite
    P(k) >= 0; return the coerced :class:`PowerTable`."""
    table = as_power_table(power)
    k, pk = table
    if k.ndim != 1 or pk.ndim != 1 or k.shape != pk.shape or k.size < 2:
        raise ValueError("power table must be two 1-D arrays of equal length >= 2")
    if not np.all(np.isfinite(k)) or not np.all(np.isfinite(pk)):
        raise ValueError("power table contains non-finite values")
    if k[0] <= 0 or np.any(np.diff(k) <= 0):
        raise ValueError("power table k values must be positive and strictly increasing")
    if np.any(pk < 0):
        raise ValueError("power table P(k) values must be non-negative")
    return table


def load_default_power() -> PowerTable:
    """The default linear P(k) table: the package's
    ``data/default_power.dat`` (EH98 at Planck13), regenerated from the
    model if the file is missing."""
    if _DEFAULT_POWER.exists():
        arr = np.loadtxt(_DEFAULT_POWER)
        return PowerTable(arr[:, 0], arr[:, 1])
    from randomfield_tpu_torch.models.powerspec import make_power_table

    return PowerTable(*make_power_table())


def require_coverage(power: PowerTable, shape, spacing):
    """Raise unless the table covers the grid's [k_min, k_max]."""
    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    if power.k[0] > kmin or power.k[-1] < kmax:
        raise ValueError(
            f"power table covers k in [{power.k[0]:.3g}, {power.k[-1]:.3g}] h/Mpc "
            f"but the grid needs [{kmin:.3g}, {kmax:.3g}]"
        )


def table_arrays_host(power, interpolation, dtype=np.float32):
    """(log10 k, P or log10 P, log_values flag) as host numpy arrays."""
    if interpolation == "log10k":
        return (
            np.log10(power.k).astype(dtype),
            np.asarray(power.Pk, dtype),
            False,
        )
    if interpolation == "loglog":
        if np.any(power.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        return (
            np.log10(power.k).astype(dtype),
            np.log10(power.Pk).astype(dtype),
            True,
        )
    raise ValueError(f"unknown interpolation {interpolation!r}")


def tabulate_sigmas(shape, spacing, power, interpolation="log10k",
                    device="cpu", y_off=0, ny_loc=None) -> torch.Tensor:
    """Per-mode sigma(k) = sqrt(P(|k|)/V) over the packed half-spectrum.

    The table's own interpolant evaluated in float64 on ``device``, x-slab
    by x-slab (numpy's ``interp`` arithmetic), returned as a float32 (nx,
    ny_loc, nz//2+1) tensor of the ky rows [y_off, y_off + ny_loc) (all by
    default: a slab mesh's shard is those rows of the whole grid, value for
    value) with sigma(0) = 0.  The grid the constrained renders read; the
    other renders use the uniform table.
    """
    power = validate_power(power)
    require_coverage(power, shape, spacing)
    nx, ny, nz = shape
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    volume = nx * ny * nz * float(spacing) ** 3
    kx, ky, kz = _grid.kvectors(shape, spacing, torch.float64, device)
    ky = ky[y_off:y_off + ny_loc]
    lk_tab, val_tab, log_values = table_arrays_host(power, interpolation,
                                                    np.float64)
    lk_tab = torch.as_tensor(lk_tab, device=device)
    val_tab = torch.as_tensor(val_tab, device=device)
    out = torch.empty((nx, ny_loc, nz // 2 + 1), dtype=torch.float32,
                      device=device)
    for x0 in range(0, nx, _SIGMA_X_CHUNK):
        x1 = min(nx, x0 + _SIGMA_X_CHUNK)
        k = torch.sqrt((kx[x0:x1] * kx[x0:x1])[:, None, None]
                       + (ky * ky)[None, :, None] + (kz * kz)[None, None, :])
        pk = _np_interp(torch.log10(torch.clamp(k, min=1e-30)), lk_tab,
                        val_tab)
        if log_values:
            pk = 10.0 ** pk
        out[x0:x1] = torch.where(k > 0, torch.sqrt(pk / volume), 0.0)
    return out


_SIGMA_X_CHUNK = 32


def _np_interp(x, xp, fp):
    """numpy's ``interp`` (float64): slope (x - xp[j]) + fp[j] between the
    nodes, the end values outside."""
    j = torch.searchsorted(xp, x.contiguous(), right=True).clamp(
        1, xp.numel() - 1) - 1
    slope = (fp[j + 1] - fp[j]) / (xp[j + 1] - xp[j])
    out = slope * (x - xp[j]) + fp[j]
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def filter_modes(c, shape, spacing, smoothing_length):
    """Gaussian smoothing in k-space: ``c * exp(-k^2 s^2 / 2)``.

    ``c`` is a packed (nx, ny, nz//2+1) tensor (real or complex); the
    result is a new tensor.  ``smoothing_length`` 0 is the identity.
    """
    dtype = c.real.dtype if c.is_complex() else c.dtype
    kx, ky, kz = _grid.kvectors(shape, spacing, dtype, c.device)
    k2 = (kx * kx)[:, None, None] + (ky * ky)[None, :, None] + (kz * kz)[None, None, :]
    s = float(smoothing_length)
    return c * torch.exp(-0.5 * k2 * s * s)


def _interp(x, xp, fp):
    """numpy's ``interp`` on tensors (``jnp.interp``'s arithmetic): linear
    between the nodes, the end values outside."""
    i = torch.searchsorted(xp, x.contiguous(), right=True).clamp(1, xp.numel() - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    out = torch.where(dx == 0, f1, f0 + ((x - x0) / dx) * (f1 - f0))
    out = torch.where(x < xp[0], fp[0], out)
    return torch.where(x > xp[-1], fp[-1], out)


def interpolate_power(power, k, interpolation="log10k", dtype=torch.float32):
    """P at |k| (a tensor, on its device) by interpolation against log10 k.

    ``'log10k'``: P linear in log10 k; ``'loglog'``: log10 P linear in
    log10 k (P > 0).  Out-of-range k clamp to the table's ends (coverage is
    checked elsewhere, so only the DC sentinel clamps), in ``dtype`` as the
    JAX package's ``interpolate_power`` computes it.
    """
    table = as_power_table(power)
    k = torch.as_tensor(k).to(dtype)
    dev = k.device
    lk_tab = torch.as_tensor(np.log10(table.k), dtype=dtype, device=dev)
    floor = float(np.asarray(10.0 ** (np.log10(table.k[0]) - 40),
                             _NUMPY[dtype]))
    lk = torch.log10(torch.clamp(k, min=floor))
    if interpolation == "log10k":
        return _interp(lk, lk_tab, torch.as_tensor(table.Pk, dtype=dtype,
                                                   device=dev))
    if interpolation == "loglog":
        if np.any(table.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        lpk = torch.as_tensor(np.log10(table.Pk), dtype=dtype, device=dev)
        return 10.0 ** _interp(lk, lk_tab, lpk)
    raise ValueError(f"unknown interpolation {interpolation!r}")


_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def grid_power(power, shape, spacing, interpolation="log10k", device="cpu",
               smoothing_length=0.0):
    """(|k|, P(|k|)) on the packed half-spectrum of a grid, float32 on
    ``device``: the table checked to cover the grid, interpolated at
    :func:`.grid.kmag`, times the render's filter exp(-(k s)^2) when
    ``smoothing_length``, 0 at DC.  The per-mode expectation the
    predictions bin."""
    table = validate_power(power)
    require_coverage(table, shape, float(spacing))
    kmag = _grid.kmag(shape, float(spacing), torch.float32, device)
    pgrid = interpolate_power(table, kmag, interpolation)
    if smoothing_length:
        pgrid = pgrid * torch.exp(-(kmag * float(smoothing_length)) ** 2)
    return kmag, torch.where(kmag > 0, pgrid, 0.0)


def sigma_r(power, r, z_weight=1.0):
    """Top-hat rms fluctuation sigma(R) of the table (host float64):
    sigma^2(R) = 1/(2 pi^2) int k^3 P(k) W(kR)^2 dln k, W(x) = 3 (sin x -
    x cos x) / x^3."""
    table = validate_power(power)
    k, pk = table.k, table.Pk
    x = k * r
    w = np.where(x > 1e-4, 3.0 * (np.sin(x) - x * np.cos(x)) / x**3,
                 1.0 - x**2 / 10.0)
    integrand = k**3 * pk * w**2 / (2.0 * np.pi**2)
    return float(z_weight) * float(np.sqrt(np.trapezoid(integrand, np.log(k))))


def sigma8(power):
    """sigma(R = 8 Mpc/h) of a tabulated power spectrum."""
    return sigma_r(power, 8.0)


def normalize_power(power, sigma8_target):
    """The table rescaled so its sigma8 equals ``sigma8_target``."""
    table = validate_power(power)
    s8 = sigma8(table)
    if s8 == 0:
        raise ValueError("cannot normalize a zero power spectrum")
    return PowerTable(table.k, table.Pk * (float(sigma8_target) / s8) ** 2)


def _filon_sincos(k, f, r):
    """Exact (int f sin(kr) dk, int f cos(kr) dk) of the piecewise-linear
    interpolant of ``f`` over the nodes ``k`` (scalar r > 0): the
    oscillation integrated analytically, so any number of periods may lie
    between two nodes."""
    s = np.sin(k * r)
    c = np.cos(k * r)
    b = np.diff(f) / np.diff(k)
    w = np.empty_like(f)
    w[0] = -b[0]
    w[-1] = b[-1]
    w[1:-1] = b[:-1] - b[1:]
    i_sin = (f[0] * c[0] - f[-1] * c[-1]) / r + (s @ w) / (r * r)
    i_cos = (f[-1] * s[-1] - f[0] * s[0]) / r + (c @ w) / (r * r)
    return i_sin, i_cos


# k r boundary between the trapezoid (smooth) and Filon (oscillatory) parts
_FILON_SPLIT = 1.0


def _k_grid(power, n, kmax):
    table = validate_power(power)
    k_lo = float(table.k[0])
    k_hi = float(table.k[-1]) if kmax is None else min(float(kmax),
                                                       float(table.k[-1]))
    if k_hi <= k_lo:
        raise ValueError(f"kmax={kmax} is at or below the table floor {k_lo}")
    k = np.logspace(np.log10(k_lo), np.log10(k_hi), int(n))
    pk = np.interp(np.log10(k), np.log10(table.k), table.Pk)
    return k, pk


def _j0(x):
    return np.where(x > 1e-6, np.sin(x) / np.where(x > 0, x, 1.0),
                    1.0 - x**2 / 6.0)


def _j2(x):
    """Spherical Bessel j2 with a series guard against cancellation."""
    xs = np.where(x > 0.1, x, 1.0)
    direct = (3.0 / xs**2 - 1.0) * np.sin(xs) / xs - 3.0 * np.cos(xs) / xs**2
    series = x**2 / 15.0 * (1.0 - x**2 / 14.0 + x**4 / 504.0)
    return np.where(x > 0.1, direct, series)


def _j4(x):
    """Spherical Bessel j4 with a series guard against cancellation."""
    xs = np.where(x > 0.5, x, 1.0)
    direct = (
        (105.0 / xs**4 - 45.0 / xs**2 + 1.0) * np.sin(xs) / xs
        + (10.0 / xs**2 - 105.0 / xs**4) * np.cos(xs)
    )
    series = x**4 / 945.0 * (1.0 - x**2 / 22.0 + x**4 / 1144.0)
    return np.where(x > 0.5, direct, series)


_BESSELS = {0: _j0, 2: _j2, 4: _j4}
_KAISER_COEFFS = {
    0: lambda f: 1.0 + 2.0 * f / 3.0 + f * f / 5.0,
    2: lambda f: 4.0 * f / 3.0 + 4.0 * f * f / 7.0,
    4: lambda f: 8.0 * f * f / 35.0,
}


def _filon_tail(ell, k, pk, i0, r):
    """The Filon part of int k^2 P j_ell(k r) dk over k[i0:] (the j_ell
    sin/cos decompositions reduce it to integrals of smooth prefactors)."""
    ks, ps = k[i0:], pk[i0:]
    if ell == 0:
        return _filon_sincos(ks, ks * ps, r)[0] / r
    if ell == 2:
        s_pok = _filon_sincos(ks, ps / ks, r)[0]
        s_kp = _filon_sincos(ks, ks * ps, r)[0]
        c_p = _filon_sincos(ks, ps, r)[1]
        return 3.0 * s_pok / r**3 - s_kp / r - 3.0 * c_p / r**2
    s_pok3 = _filon_sincos(ks, ps / ks**3, r)[0]
    s_pok = _filon_sincos(ks, ps / ks, r)[0]
    s_kp = _filon_sincos(ks, ks * ps, r)[0]
    c_p = _filon_sincos(ks, ps, r)[1]
    c_pok2 = _filon_sincos(ks, ps / ks**2, r)[1]
    return (105.0 * s_pok3 / r**5 - 45.0 * s_pok / r**3 + s_kp / r
            + 10.0 * c_p / r**2 - 105.0 * c_pok2 / r**4)


def _hankel(ell, k, pk, r):
    """1/(2 pi^2) int k^2 P j_ell(k r) dk: trapezoid in ln k where k r < 1,
    Filon beyond."""
    i0 = min(int(np.searchsorted(k, _FILON_SPLIT / max(r, 1e-300))),
             k.size - 1)
    acc = 0.0
    if i0 > 0:
        x = k[: i0 + 1] * r
        acc += np.trapezoid(k[: i0 + 1] ** 3 * pk[: i0 + 1] * _BESSELS[ell](x),
                            np.log(k[: i0 + 1]))
    if i0 < k.size - 1:
        acc += _filon_tail(ell, k, pk, i0, r)
    return acc / (2.0 * np.pi**2)


def power_to_correlation(power, r, n=8192, kmax=None):
    """Theory xi(r) = 1/(2 pi^2) int k^2 P(k) j0(kr) dk of the table (host
    float64) over a log resampling of ``n`` points (P linear in log10 k),
    trapezoid where k r < 1 and Filon beyond; ``kmax`` truncates the band
    (pass a grid's Nyquist to compare with it).  ``r`` scalar or array."""
    k, pk = _k_grid(power, n, kmax)
    r_arr = np.atleast_1d(np.asarray(r, np.float64))
    xi = np.array([_hankel(0, k, pk, rj) for rj in r_arr.ravel()])
    xi = xi.reshape(r_arr.shape)
    return xi if np.ndim(r) else float(xi[0])


def power_to_correlation_multipoles(power, r, f=0.0, ells=(0, 2, 4),
                                    n=8192, kmax=None):
    """Theory xi_ell(s) = (-1)^(ell/2) / (2 pi^2) int k^2 P_ell(k) j_ell(ks)
    dk under linear Kaiser distortion (P_0 = (1 + 2f/3 + f^2/5) P, P_2 =
    (4f/3 + 4f^2/7) P, P_4 = 8f^2/35 P), host float64, the scheme of
    :func:`power_to_correlation`; shape ``(len(ells),) + shape(r)``."""
    for e in ells:
        if int(e) not in _KAISER_COEFFS:
            raise ValueError(f"ell={e} unsupported: even 0/2/4 only")
    k, pk = _k_grid(power, n, kmax)
    r_arr = np.atleast_1d(np.asarray(r, np.float64))
    raw = {e: np.array([_hankel(e, k, pk, rj) for rj in r_arr.ravel()])
           for e in {int(e) for e in ells}}
    out = np.stack([(-1.0) ** (int(e) // 2) * _KAISER_COEFFS[int(e)](float(f))
                    * raw[int(e)].reshape(r_arr.shape) for e in ells])
    return out if np.ndim(r) else out[:, 0]


_LEGENDRE_EVEN_MU = {
    0: lambda mu: np.ones_like(mu),
    2: lambda mu: 0.5 * (3.0 * mu**2 - 1.0),
    4: lambda mu: 0.125 * (35.0 * mu**4 - 30.0 * mu**2 + 3.0),
}


def power_to_projected_correlation(power, rp, pi_max, f=0.0, ells=(0, 2, 4),
                                   n=8192, kmax=None, npi=257):
    """Theory w_p(r_p) = 2 int_0^pi_max xi(s, mu) dpi of the table (host
    float64), s = sqrt(r_p^2 + pi^2), mu = pi / s; xi(s, mu) = sum_ell
    xi_ell(s) L_ell(mu) under Kaiser distortion with growth rate ``f``
    (``f=0``: :func:`power_to_correlation`); a trapezoid over ``npi``
    points in pi."""
    rp_arr = np.atleast_1d(np.asarray(rp, np.float64))
    pi_grid = np.linspace(0.0, float(pi_max), int(npi))
    s = np.sqrt(rp_arr.reshape(-1, 1) ** 2 + pi_grid[None, :] ** 2)
    f = float(f)
    if f:
        xil = power_to_correlation_multipoles(power, s.ravel(), f=f,
                                              ells=ells, n=n, kmax=kmax)
        mu = np.where(s > 0, pi_grid[None, :] / np.where(s > 0, s, 1.0), 0.0)
        xi_smu = np.zeros_like(s)
        for i, e in enumerate(ells):
            xi_smu += xil[i].reshape(s.shape) * _LEGENDRE_EVEN_MU[int(e)](mu)
    else:
        xi_smu = power_to_correlation(power, s.ravel(), n=n,
                                      kmax=kmax).reshape(s.shape)
    wp = (2.0 * np.trapezoid(xi_smu, pi_grid, axis=1)).reshape(rp_arr.shape)
    return wp if np.ndim(rp) else float(wp[0])
