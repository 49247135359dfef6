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
table to.
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
]

# the JAX package's shipped table, read by path so its __init__ (which
# imports jax) never runs
_DEFAULT_POWER = (
    pathlib.Path(__file__).resolve().parents[2]
    / "randomfield_tpu" / "data" / "default_power.dat"
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
    """The default linear P(k) table: ``randomfield_tpu/data/default_power.dat``
    (EH98 at Planck13), regenerated from the model if the file is missing."""
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
                    device="cpu") -> torch.Tensor:
    """Per-mode sigma(k) = sqrt(P(|k|)/V) over the packed half-spectrum.

    Host float64 evaluation of the table's own interpolant, returned as a
    float32 (nx, ny, nz//2+1) tensor with sigma(0) = 0.  A plain reference
    for tests and small scenes; renders use the uniform table.
    """
    power = validate_power(power)
    require_coverage(power, shape, spacing)
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    kx, ky, kz = _grid.kvectors(shape, spacing, torch.float64)
    k2 = (kx * kx)[:, None, None] + (ky * ky)[None, :, None] + (kz * kz)[None, None, :]
    k = np.sqrt(k2.numpy())
    lk = np.log10(np.maximum(k, 1e-30))
    lk_tab, val_tab, log_values = table_arrays_host(power, interpolation, np.float64)
    pk = np.interp(lk, lk_tab, val_tab)
    if log_values:
        pk = 10.0 ** pk
    sig = np.where(k > 0, np.sqrt(pk / volume), 0.0)
    return torch.as_tensor(sig, dtype=torch.float32, device=device)


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
