"""The sigma(k) table and the sigma-scale kernel (K2).

Counterpart of ``randomfield_tpu/ops/pallas_sampler.py``.  Scene setup
resamples sigma(k) = sqrt(P(k)/V) onto a uniform log10-k grid
(:func:`make_sigma_table`); each render multiplies the unit draws in place
by sigma(|k|) * exp(-k^2 s^2 / 2) * gain, with sigma interpolated linearly
in log10 k over that table (:func:`scale_sigma`, the CUDA kernel
``csrc/scale_sigma.cu`` on the card, :func:`scale_sigma_plain` on the
CPU).

The JAX package stores the table as overlapping 128-wide segment rows for
Mosaic's one-vreg lane gather.  The port keeps one flat knot vector with
the same knot count as the JAX 'xzy' table, ``m (w - 1) + 1`` with
``w = min(ny, 128)``, and the same padding, so its default table equals
the JAX one value for value with the shared knots de-duplicated.

The launch count of the kernel is ``K2_LAUNCHES``.
"""

from __future__ import annotations

import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power

__all__ = [
    "SigmaTable",
    "make_sigma_table",
    "flat_knots",
    "scale_sigma",
    "scale_sigma_plain",
    "sigma_amplitude",
    "load_reference_state",
    "K2_LAUNCHES",
]

# kernel launches by scale_sigma (the CPU path does not count)
K2_LAUNCHES = 0

_MIN_KNOTS = 513  # >= the default table's information content
_HALF_INV_LN10 = np.float32(0.5 / np.log(10.0))
# x planes per step of the plain version (bounds its temporaries)
_PLAIN_X_CHUNK = 64


class SigmaTable(typing.NamedTuple):
    """Uniform log10-k sigma table: knot i sits at log10 k = lk0 + i dlk."""

    lk0: float
    dlk: float
    knots: torch.Tensor  # float32 (n_knots,)


def table_knot_count(shape) -> int:
    """Knots of the JAX 'xzy' segment table: m (w - 1) + 1, w = min(ny, 128)."""
    w = min(shape[1], 128)
    m = max(1, -(-(_MIN_KNOTS - 1) // (w - 1)))
    return m * (w - 1) + 1


def make_sigma_table(power, shape, spacing, interpolation="log10k",
                     device="cpu") -> SigmaTable:
    """Resample sigma(k) = sqrt(P(k)/V) onto a uniform log10-k grid.

    Host float64 evaluation of the scene's interpolant over the grid's
    [k_min, k_max], padded by 1e-4 decades at both ends, as
    ``pallas_sampler.make_sigma_table`` does; the knots are float32.
    """
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    n_knots = table_knot_count(shape)
    nx, ny, nz = shape
    volume = nx * ny * nz * float(spacing) ** 3
    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    lk = np.linspace(np.log10(kmin) - 1e-4, np.log10(kmax) + 1e-4, n_knots)
    lk_tab = np.log10(table.k)
    if interpolation == "log10k":
        pk = np.interp(lk, lk_tab, table.Pk)
    elif interpolation == "loglog":
        if np.any(table.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        pk = 10.0 ** np.interp(lk, lk_tab, np.log10(table.Pk))
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    sig = np.sqrt(pk / volume).astype(np.float32)
    return SigmaTable(float(lk[0]), float(lk[1] - lk[0]),
                      torch.as_tensor(sig, device=device))


def flat_knots(rows) -> np.ndarray:
    """De-duplicate JAX segment rows (row k+1 starts on row k's last knot)."""
    rows = np.asarray(rows, np.float32)
    return np.concatenate([rows[0]] + [r[1:] for r in rows[1:]])


def _constants(table, shape, spacing):
    """The float32 scalars both versions of K2 use, rounded as JAX rounds them."""
    nx, ny, nz = shape
    dk = 2.0 * np.pi / float(spacing)
    return dict(
        kx_scale=np.float32(dk / nx), ky_scale=np.float32(dk / ny),
        kz_scale=np.float32(dk / nz), lk0=np.float32(table.lk0),
        inv_dlk=np.float32(1.0 / table.dlk),
    )


def _signed(idx, n):
    return torch.where(idx <= n // 2, idx, idx - n)


def sigma_amplitude(table, shape, spacing, smoothing_length=0.0, x_off=0,
                    nx_loc=None, y_off=0, ny_loc=None, gain=1.0):
    """sigma(|k|) * exp(-k^2 s^2 / 2) * gain over an 'xyz' block, float32.

    The plain PyTorch form of K2's per-mode arithmetic, in the same order
    of float32 operations; returns a (nx_loc, ny_loc, nzh) tensor on the
    table's device for x rows [x_off, x_off + nx_loc), y rows [y_off,
    y_off + ny_loc).
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    nx_loc = nx if nx_loc is None else nx_loc
    ny_loc = ny if ny_loc is None else ny_loc
    c = _constants(table, shape, spacing)
    dev = table.knots.device
    knots = table.knots
    n_knots = knots.numel()
    ix = torch.arange(x_off, x_off + nx_loc, device=dev)
    iy = torch.arange(y_off, y_off + ny_loc, device=dev)
    iz = torch.arange(nzh, device=dev)
    kx = _signed(ix, nx).to(torch.float32) * float(c["kx_scale"])
    ky = _signed(iy, ny).to(torch.float32) * float(c["ky_scale"])
    kz = iz.to(torch.float32) * float(c["kz_scale"])
    ksq = (kx * kx)[:, None, None] + (ky * ky)[None, :, None]
    ksq = ksq + (kz * kz)[None, None, :]
    pos = ksq > 0
    lk = torch.log(torch.where(pos, ksq, 1.0)) * float(_HALF_INV_LN10)
    t = ((lk - float(c["lk0"])) * float(c["inv_dlk"])).clamp(0.0, n_knots - 1)
    i0 = t.to(torch.int64).clamp_max(n_knots - 2)
    frac = t - i0.to(torch.float32)
    sig = knots[i0] * (1.0 - frac) + knots[i0 + 1] * frac
    amp = torch.where(pos, sig, 0.0)
    s = float(np.float32(smoothing_length))
    if s != 0.0:
        amp = amp * torch.exp(-0.5 * ksq * s * s)
    return amp * float(np.float32(gain))


def scale_sigma_plain(re, im, table, shape, spacing, smoothing_length=0.0,
                      x_off=0, y_off=0, gain=1.0):
    """K2 in plain PyTorch on any device: re, im *= amplitude, in place."""
    nx_loc, ny_loc, _ = re.shape
    for x0 in range(0, nx_loc, _PLAIN_X_CHUNK):
        x1 = min(nx_loc, x0 + _PLAIN_X_CHUNK)
        amp = sigma_amplitude(table, shape, spacing, smoothing_length,
                              x_off + x0, x1 - x0, y_off, ny_loc, gain)
        re[x0:x1].mul_(amp)
        im[x0:x1].mul_(amp)
    return re, im


def _check_block(re, im, table, shape, x_off, y_off):
    nx, ny, nz = shape
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError("re and im must be float32")
    if re.shape != im.shape or re.ndim != 3 or re.shape[2] != nz // 2 + 1:
        raise ValueError(
            f"re/im must be equal (nx_loc, ny_loc, {nz // 2 + 1}) blocks, "
            f"got {tuple(re.shape)} and {tuple(im.shape)}"
        )
    if not (0 <= x_off and x_off + re.shape[0] <= nx
            and 0 <= y_off and y_off + re.shape[1] <= ny):
        raise ValueError(f"block at ({x_off}, {y_off}) of shape "
                         f"{tuple(re.shape)} lies outside the grid {shape}")
    if re.device != im.device or table.knots.device != re.device:
        raise ValueError("re, im and the table's knots must share a device")
    if table.knots.numel() < 2:
        raise ValueError("the sigma table needs at least two knots")


def scale_sigma(re, im, table, shape, spacing, smoothing_length=0.0,
                x_off=0, y_off=0, gain=1.0):
    """K2: re, im *= sigma(|k|) * exp(-k^2 s^2 / 2) * gain, IN PLACE.

    ``re``/``im``: float32 (nx_loc, ny_loc, nz//2+1) 'xyz' blocks covering
    global rows [x_off, x_off + nx_loc) x [y_off, y_off + ny_loc) of an
    ``shape`` scene (the whole spectrum by default).  ``gain`` is a float32
    constant folded into the per-mode amplitude (a render passes 1/sqrt(2)
    for its unit draws).  On CUDA tensors this
    launches ``csrc/scale_sigma.cu``; on CPU tensors it runs
    :func:`scale_sigma_plain`.  Returns (re, im).
    """
    global K2_LAUNCHES
    _check_block(re, im, table, shape, x_off, y_off)
    if re.device.type == "cpu":
        return scale_sigma_plain(re, im, table, shape, spacing,
                                 smoothing_length, x_off, y_off, gain)
    if re.device.type != "cuda":
        raise ValueError(f"scale_sigma runs on cpu or cuda, not {re.device}")
    if not (re.is_contiguous() and im.is_contiguous()
            and table.knots.is_contiguous()):
        raise ValueError("scale_sigma's CUDA kernel needs contiguous tensors")
    _launch_scale_sigma(re, im, table, shape, spacing, smoothing_length,
                        x_off, y_off, gain)
    K2_LAUNCHES += 1
    return re, im


def _launch_scale_sigma(re, im, table, shape, spacing, smoothing_length,
                        x_off, y_off, gain):
    nx, ny, nz = shape
    c = _constants(table, shape, spacing)
    status = _build.library().rf_scale_sigma(
        re.data_ptr(), im.data_ptr(), table.knots.data_ptr(),
        table.knots.numel(), re.shape[0], re.shape[1], re.shape[2],
        nx, ny, int(x_off), int(y_off),
        float(c["kx_scale"]), float(c["ky_scale"]), float(c["kz_scale"]),
        float(_HALF_INV_LN10), float(c["lk0"]), float(c["inv_dlk"]),
        float(np.float32(smoothing_length)), float(np.float32(gain)),
        _build.current_stream(re),
    )
    _build.check(status, "scale_sigma")


def load_reference_state(stab_rows, lk0, dlk, lightcone_weights, power_k,
                         power_pk, device="cpu"):
    """The port's scene State from the JAX package's numpy arrays.

    ``stab_rows``/``lk0``/``dlk``: a JAX ``make_sigma_table`` result (any
    layout; its segment rows are de-duplicated into flat knots);
    ``lightcone_weights``: the JAX State's per-plane weights;
    ``power_k``/``power_pk``: its validated power table.  Used to put both
    packages on identical state.
    """
    from randomfield_tpu_torch.engine.scene import State

    table = SigmaTable(float(lk0), float(dlk),
                       torch.as_tensor(flat_knots(stab_rows), device=device))
    weights = torch.as_tensor(np.array(lightcone_weights, np.float32),
                              device=device)
    power = _power.validate_power((np.asarray(power_k, np.float64),
                                   np.asarray(power_pk, np.float64)))
    return State(table=table, lightcone_weights=weights, power=power)
