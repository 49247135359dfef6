"""The sigma(k) table and the sampler kernels: K2 draw + scale, K1 sample, K5 bin.

Counterpart of ``randomfield_tpu/ops/pallas_sampler.py``.  Scene setup
resamples sigma(k) = sqrt(P(k)/V) onto a uniform log10-k grid
(:func:`make_sigma_table`), which every kernel here (and K10,
:mod:`.genfft`) interpolates linearly in log10 k
(``csrc/sigma_common.cuh``):

* K2, fused with its draws, :func:`draw_scale` (``csrc/draw_scale.cu``):
  the default sampler's spectrum in one pass, JAX's canonical Threefry
  stream (:mod:`.sample`) drawn in the kernel, the kz = 0 / Nyquist planes
  made Hermitian in the thread, times sigma(|k|) * exp(-k^2 s^2 / 2) /
  sqrt(2); ``unit=True`` writes the raw unit draws (``generate_noise``);
* K2 :func:`scale_sigma` (``csrc/scale_sigma.cu``): the same amplitude
  times draws the caller supplies, in place (``generate_from_noise``);
* K1 :func:`sample_modes` (``csrc/sample_modes.cu``): ``sampler='pallas'``
  draws each mode from its own counter-based stream
  (:mod:`~randomfield_tpu_torch.ops.modestream`), Box-Muller, and scales it,
  the kz = 0 / Nyquist planes made Hermitian in the thread, writing the
  spectrum in one pass;
* K5 :func:`sample_power_bins_batch` (``csrc/sample_power_bins.cu``): the
  same draws, planes fixed as K1 fixes them, binned in log10 |k| as (sum w,
  sum w |c|^2 V, sum w |k|) with no spectrum written, for a batch of seeds
  into one device block;
* K2F's fixed mode :func:`draw_fixed`: the same draws and plane fix, each
  mode then z / |z| times the amplitude with gain 1 (or -1, the paired
  field): ``generate_fixed_field``;
* KN :func:`sample_nested` (``csrc/sample_modes.cu``'s nested kernel, a
  thread on the quad of rows (+-x, +-y), on the resolution-nested stream
  of ``sampler='nested'``): the spectrum, the raw unit normals, the fixed
  field, or the bits;
* K7 :func:`draw_scale_shard` and K8 :func:`sample_shard`: the fused K2 and
  K1 on the ky rows [y_off, y_off + ny_loc) of a slab mesh's shard, at the
  global counters and indices (the same sources; the union over the shards
  is the whole-grid result bit for bit, and neither needs an exchange for
  the Hermitian fix: a plane mode draws its partner's counter itself).

On CUDA tensors each wrapper launches its kernel or raises; on CPU tensors
it runs the plain PyTorch version beside it (``*_plain``), which repeats
the kernel's float32 operations in the same order.

The JAX package stores the table as overlapping 128-wide segment rows for
Mosaic's one-vreg lane gather.  The port keeps one flat knot vector with
the same knot count as the JAX 'xzy' table, ``m (w - 1) + 1`` with
``w = min(ny, 128)``, and the same padding, so its default table equals
the JAX one value for value with the shared knots de-duplicated.

The launch counts are ``K1_LAUNCHES``, ``K2_LAUNCHES`` (:func:`scale_sigma`),
``K2F_LAUNCHES`` (:func:`draw_scale` and :func:`draw_bits`),
``K2FX_LAUNCHES`` (:func:`draw_fixed`), ``K5_LAUNCHES``, ``K7_LAUNCHES``,
``K8_LAUNCHES`` and ``KN_LAUNCHES`` (:func:`sample_nested`).
"""

from __future__ import annotations

import ctypes
import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import modestream as _modestream
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.ops import sample as _canon
from randomfield_tpu_torch.ops import threefry as _threefry
from randomfield_tpu_torch.ops import transform as _transform

__all__ = [
    "SigmaTable",
    "make_sigma_table",
    "make_box_sigma_table",
    "flat_knots",
    "scale_sigma",
    "scale_sigma_plain",
    "sigma_steps",
    "sigma_steps_plain",
    "draw_scale",
    "draw_scale_shard",
    "draw_scale_plain",
    "draw_bits",
    "draw_fixed",
    "draw_fixed_plain",
    "draw_normals",
    "unit_phases",
    "sample_nested",
    "sample_nested_plain",
    "sigma_amplitude",
    "load_reference_state",
    "plane_partner",
    "sample_modes",
    "sample_modes_plain",
    "sample_spectrum",
    "seeded_modes_plain",
    "seeded_spectrum_plain",
    "BinPlan",
    "bin_plan",
    "sample_power_bins",
    "sample_power_bins_batch",
    "power_bins_plain",
    "seeded_power_bins_plain",
    "sample_shard",
    "K1_LAUNCHES",
    "K2_LAUNCHES",
    "K2F_LAUNCHES",
    "K5_LAUNCHES",
    "K7_LAUNCHES",
    "K8_LAUNCHES",
    "K2FX_LAUNCHES",
    "KN_LAUNCHES",
    "MAX_KERNEL_BINS",
]

# kernel launches by sample_modes, scale_sigma, draw_scale (and draw_bits),
# sample_power_bins, draw_scale_shard, sample_shard, draw_fixed and
# sample_nested (the CPU paths do not count)
K1_LAUNCHES = 0
K2_LAUNCHES = 0
K2F_LAUNCHES = 0
K5_LAUNCHES = 0
K7_LAUNCHES = 0
K8_LAUNCHES = 0
K2FX_LAUNCHES = 0
KN_LAUNCHES = 0

# K5 bins at most this many (the TPU kernel's lane count); callers fall back
# to K1 and binning the spectrum above it
MAX_KERNEL_BINS = 128

_MIN_KNOTS = 513  # >= the default table's information content
_HALF_INV_LN10 = np.float32(0.5 / np.log(10.0))
# Box-Muller constants of the TPU sampler, rounded to float32 as JAX rounds
# them; 1/sqrt(2) is also the Threefry draws' complex normalization, the gain
# of the fused K2
_TWO_PI32 = np.float32(6.283185307179586)
_INV_SQRT2 = np.float32(0.7071067811865476)
_INV_2_24 = np.float32(2.0 ** -24)
_HALF_INV_2_24 = np.float32(2.0 ** -25)
# csrc/draw_scale.cu's modes
_SPECTRUM, _UNIT, _BITS, _FIXED = 0, 1, 2, 3
# csrc/sample_modes.cu's KN modes, by name
NESTED_MODES = {"spectrum": 0, "unit": 1, "fixed": 2, "bits": 3}
# ky rows of one K5 block (csrc/sample_power_bins.cu kThreads); the seeds a
# launch takes: its grid's z limit, and as many as keep the float64 block
# partials within 256 MiB (85 seeds at 1024^3 and 32 bins)
_K5_ROWS = 128
_K5_MAX_GRID_Z = 65535
_K5_PARTIAL_VALUES = 2 ** 25
_SQRT2 = float(np.sqrt(2.0))  # a self-conjugate mode's factor, as symmetrized
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
    pk = _interp_table(table, lk, interpolation)
    sig = np.sqrt(pk / volume).astype(np.float32)
    return SigmaTable(float(lk[0]), float(lk[1] - lk[0]),
                      torch.as_tensor(sig, device=device))


# the knot step of a box-anchored table (decades of k): finer than the
# default table's at every grid the nested stream takes (2.2e-3 at 16^3,
# 4.6e-3 at 1024^3), so it keeps the same 2e-3 bar against tabulate_sigmas
BOX_TABLE_DLK = 1.0 / 400.0


def make_box_sigma_table(power, shape, spacing, interpolation="log10k",
                         device="cpu") -> SigmaTable:
    """The sigma table of a nested scene: knots that depend on the box, not
    on the grid.

    Knot i sits at log10 k = lk0 + i dlk with lk0 = log10(2 pi / L) - 1e-4
    (L the box's longest side, so 2 pi / L is its fundamental) and dlk =
    :data:`BOX_TABLE_DLK` for every grid; the table runs up to the grid's
    k_max (padded by 1e-4 decades).  Two grids over one box then hold the
    same knots where their k ranges overlap (the finer grid simply has
    more), and a mode both grids hold, whose |k|^2 both kernels compute
    from the same float32 steps 2 pi / L, takes its sigma from the same two
    knots bit for bit: the zoom match of the JAX package, which multiplies
    by the per-mode sigma grid (``ops/sample.py:sample_spectrum_nested``).
    sigma = sqrt(P / V) with V the product of the box's sides.
    """
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    spacing = float(spacing)
    sides = [n * spacing for n in shape]
    _, kmax = _grid.get_k_bounds(shape, spacing)
    lk0 = np.log10(2.0 * np.pi / max(sides)) - 1e-4
    n_knots = int(np.ceil((np.log10(kmax) + 1e-4 - lk0) / BOX_TABLE_DLK)) + 1
    lk = lk0 + np.arange(n_knots) * BOX_TABLE_DLK
    pk = _interp_table(table, lk, interpolation)
    volume = sides[0] * sides[1] * sides[2]
    sig = np.sqrt(pk / volume).astype(np.float32)
    return SigmaTable(float(lk0), BOX_TABLE_DLK,
                      torch.as_tensor(sig, device=device))


def _interp_table(table, lk, interpolation):
    """P at log10 k = lk (host float64) by the scene's interpolant."""
    lk_tab = np.log10(table.k)
    if interpolation == "log10k":
        return np.interp(lk, lk_tab, table.Pk)
    if interpolation == "loglog":
        if np.any(table.Pk <= 0):
            raise ValueError("loglog interpolation requires strictly positive P(k)")
        return 10.0 ** np.interp(lk, lk_tab, np.log10(table.Pk))
    raise ValueError(f"unknown interpolation {interpolation!r}")


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


def _axis_k(c, shape, x_off, nx_loc, y_off, ny_loc, dev):
    """float32 (kx, ky, kz) of x rows [x_off, +nx_loc), y rows [y_off, +ny_loc)."""
    nx, ny, nz = shape
    ix = torch.arange(x_off, x_off + nx_loc, device=dev)
    iy = torch.arange(y_off, y_off + ny_loc, device=dev)
    iz = torch.arange(nz // 2 + 1, device=dev)
    kx = _signed(ix, nx).to(torch.float32) * float(c["kx_scale"])
    ky = _signed(iy, ny).to(torch.float32) * float(c["ky_scale"])
    kz = iz.to(torch.float32) * float(c["kz_scale"])
    return kx, ky, kz


def _sigma_steps(knots, ksq, c):
    """(log10|k| with DC at 0, t, i0, frac, sigma(|k|) with sigma(0) = 0) of
    ``ksq``: csrc/sigma_common.cuh's float32 operations, in its order, each
    rounded apart."""
    n_knots = knots.numel()
    pos = ksq > 0
    lk = torch.log(torch.where(pos, ksq, 1.0)) * float(_HALF_INV_LN10)
    t = ((lk - float(c["lk0"])) * float(c["inv_dlk"])).clamp(0.0, n_knots - 1)
    i0 = t.to(torch.int64).clamp_max(n_knots - 2)
    frac = t - i0.to(torch.float32)
    sig = knots[i0] * (1.0 - frac) + knots[i0 + 1] * frac
    return lk, t, i0, frac, torch.where(pos, sig, 0.0)


def _interp_sigma(knots, ksq, c):
    """(log10|k| with DC at 0, sigma(|k|) with sigma(0) = 0) of ``ksq``:
    csrc/sigma_common.cuh's float32 operations, in its order."""
    steps = _sigma_steps(knots, ksq, c)
    return steps[0], steps[4]


def _filtered(amp, ksq, smoothing_length, gain):
    """K2's amplitude from sigma: times exp(-k^2 s^2 / 2) when s != 0, then
    times the gain, each in float32 as the kernels round it."""
    s = float(np.float32(smoothing_length))
    if s != 0.0:
        amp = amp * torch.exp(-0.5 * ksq * s * s)
    return amp * float(np.float32(gain))


def sigma_steps_plain(table, ksq, smoothing_length=0.0, gain=1.0):
    """Each step of K2's amplitude at float32 ``ksq`` (any shape, on the
    table's device) in plain PyTorch: a dict of log10|k| (0 at DC), t, i0
    (int32), frac and the amplitude sigma(|k|) exp(-k^2 s^2 / 2) gain."""
    c = dict(lk0=np.float32(table.lk0), inv_dlk=np.float32(1.0 / table.dlk))
    lk, t, i0, frac, sig = _sigma_steps(table.knots, ksq, c)
    return dict(lk=torch.where(ksq > 0, lk, 0.0), t=t,
                i0=i0.to(torch.int32), frac=frac,
                amp=_filtered(sig, ksq, smoothing_length, gain))


def sigma_steps(table, ksq, smoothing_length=0.0, gain=1.0):
    """:func:`sigma_steps_plain` on the card: ``csrc/scale_sigma.cu``'s
    ``rf_sigma_steps`` runs the kernels' device functions
    (``sigma_common.cuh``) on each value and writes every step (a check of
    K2's amplitude, on no render's path, counted nowhere).  CPU tensors run
    :func:`sigma_steps_plain`."""
    ksq = torch.as_tensor(ksq)
    if ksq.dtype != torch.float32 or ksq.device != table.knots.device:
        raise ValueError("sigma_steps takes float32 |k|^2 on the table's "
                         "device")
    if ksq.device.type == "cpu":
        return sigma_steps_plain(table, ksq, smoothing_length, gain)
    flat = ksq.contiguous().reshape(-1)
    out = {k: torch.empty(flat.shape, dtype=torch.int32 if k == "i0"
                          else torch.float32, device=flat.device)
           for k in ("lk", "t", "i0", "frac", "amp")}
    status = _build.library().rf_sigma_steps(
        flat.data_ptr(), table.knots.data_ptr(), table.knots.numel(),
        flat.numel(), float(_HALF_INV_LN10), float(np.float32(table.lk0)),
        float(np.float32(1.0 / table.dlk)),
        float(np.float32(smoothing_length)), float(np.float32(gain)),
        out["lk"].data_ptr(), out["t"].data_ptr(), out["i0"].data_ptr(),
        out["frac"].data_ptr(), out["amp"].data_ptr(),
        _build.current_stream(flat))
    _build.check(status, "sigma_steps")
    return {k: v.view(ksq.shape) for k, v in out.items()}


def sigma_amplitude(table, shape, spacing, smoothing_length=0.0, x_off=0,
                    nx_loc=None, y_off=0, ny_loc=None, gain=1.0):
    """sigma(|k|) * exp(-k^2 s^2 / 2) * gain over an 'xyz' block, float32.

    The plain PyTorch form of K2's per-mode arithmetic, in the same order
    of float32 operations; returns a (nx_loc, ny_loc, nzh) tensor on the
    table's device for x rows [x_off, x_off + nx_loc), y rows [y_off,
    y_off + ny_loc).
    """
    nx, ny, nz = shape
    nx_loc = nx if nx_loc is None else nx_loc
    ny_loc = ny if ny_loc is None else ny_loc
    c = _constants(table, shape, spacing)
    kx, ky, kz = _axis_k(c, shape, x_off, nx_loc, y_off, ny_loc,
                         table.knots.device)
    ksq = (kx * kx)[:, None, None] + (ky * ky)[None, :, None]
    ksq = ksq + (kz * kz)[None, None, :]
    _, amp = _interp_sigma(table.knots, ksq, c)
    return _filtered(amp, ksq, smoothing_length, gain)


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
    constant folded into the per-mode amplitude (``generate_from_noise``
    passes 1/sqrt(2) for its unit draws; a seeded render draws and scales
    in :func:`draw_scale`).  On CUDA tensors this launches
    ``csrc/scale_sigma.cu``; on CPU tensors it runs
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
    K2_LAUNCHES += 1
    return re, im


# ---- K2 fused with its draws: the default sampler's spectrum in one pass ------------

def draw_scale_plain(seed, table, shape, spacing, smoothing_length=0.0,
                     x_off=0, y_off=0, nx_loc=None, ny_loc=None, unit=False):
    """:func:`draw_scale` in plain PyTorch on the table's device.

    The chain a render ran before the fused kernel: the canonical unit
    draws (:func:`.sample.unit_draws_reim`) -> the Hermitian fix of the
    kz = 0 / Nyquist planes (:func:`.transform.symmetrize_plane_reim`) ->
    :func:`scale_sigma_plain` with gain 1/sqrt(2).  A block of fewer ky rows
    than the grid's is fixed from its whole planes, drawn at their own
    counters (:func:`.sample.plane_draws_reim`), so it needs no mesh.
    Returns float32 (2, nx_loc, ny_loc, nzh): re and im.
    """
    nx, ny, nz = shape
    nx_loc, ny_loc = _block_rows(shape, x_off, y_off, nx_loc, ny_loc)
    dev = table.knots.device
    key = _threefry.as_key(seed)
    re, im = _canon.unit_draws_reim(key, shape, dev, y_off, ny_loc)
    if not unit:
        rows = slice(y_off, y_off + ny_loc)
        for p in _grid.self_conjugate_kz_planes(nz):
            whole = ((re[..., p], im[..., p]) if ny_loc == ny
                     else _canon.plane_draws_reim(key, shape, p, dev))
            fre, fim = _transform.symmetrize_plane_reim(*whole)
            re[..., p] = fre[:, rows]
            im[..., p] = fim[:, rows]
    out = torch.stack([re[x_off:x_off + nx_loc], im[x_off:x_off + nx_loc]])
    if not unit:
        scale_sigma_plain(out[0], out[1], table, shape, spacing,
                          smoothing_length, x_off, y_off, float(_INV_SQRT2))
    return out


def draw_scale(seed, table, shape, spacing, smoothing_length=0.0, x_off=0,
               y_off=0, nx_loc=None, ny_loc=None, unit=False):
    """K2, fused with its draws: the seed's ``sampler='threefry'`` spectrum.

    Returns float32 (2, nx_loc, ny_loc, nz//2+1), re and im, on the table's
    device for x rows [x_off, x_off + nx_loc) and ky rows [y_off, y_off +
    ny_loc) (the whole grid by default): JAX's canonical Threefry normals
    of the seed (:mod:`.sample`), Hermitian on the kz = 0 / Nyquist planes,
    times sigma(|k|) * exp(-k^2 s^2 / 2) / sqrt(2).  ``unit=True`` returns
    the raw unit draws instead (no fix, no scale).  On CUDA this launches
    ``csrc/draw_scale.cu``, which draws every mode (and a plane mode's
    partner) at its counter in the thread; on the CPU it runs
    :func:`draw_scale_plain`.  ``seed`` is an int or a Threefry key pair
    (:func:`.threefry.split`), whose chunk keys are folded in as a seed's.
    """
    global K2F_LAUNCHES
    out, launched = _draw(seed, table, shape, spacing, smoothing_length,
                          x_off, y_off, nx_loc, ny_loc,
                          _UNIT if unit else _SPECTRUM, "draw_scale")
    K2F_LAUNCHES += launched
    return out


def draw_fixed_plain(seed, table, shape, spacing, smoothing_length=0.0,
                     flip=False, y_off=0, ny_loc=None):
    """:func:`draw_fixed` in plain PyTorch on the table's device: the
    canonical unit draws -> the Hermitian fix (a block of ky rows from its
    whole planes) -> z / |z| -> K2's amplitude with gain 1, or -1 with
    ``flip`` (:func:`.sample.sample_fixed_spectrum`).  Returns float32 (2,
    nx, ny_loc, nzh) for the ky rows [y_off, y_off + ny_loc)."""
    return torch.stack(_canon.sample_fixed_spectrum(
        _threefry.as_key(seed), table, shape, spacing,
        smoothing_length, flip, y_off=y_off, ny_loc=ny_loc))


def draw_fixed(seed, table, shape, spacing, smoothing_length=0.0,
               flip=False, y_off=0, ny_loc=None):
    """K2F's fixed mode: the seed's 'fixed' spectrum (Angulo & Pontzen
    2016), ``sampler='threefry'``'s stream.

    Returns float32 (2, nx, ny_loc, nz//2+1), re and im, on the table's
    device for the ky rows [y_off, y_off + ny_loc) (the whole grid by
    default; a slab mesh's shard, drawn with no exchange as K7 draws it):
    :func:`draw_scale`'s draws after the Hermitian fix, each mode replaced by
    z / |z| (1 where |z| = 0; a self-conjugate mode by its sign), times
    sigma(|k|) * exp(-k^2 s^2 / 2), so |c| is exactly the target amplitude;
    ``flip`` negates it (the paired field, every phase shifted by pi).  On
    CUDA this launches ``csrc/draw_scale.cu`` in its fixed mode with gain
    -1 for ``flip`` (counted in ``K2FX_LAUNCHES``); on the CPU it runs
    :func:`draw_fixed_plain`.
    """
    global K2FX_LAUNCHES
    out, launched = _draw(seed, table, shape, spacing, smoothing_length, 0,
                          y_off, None, ny_loc, _FIXED, "draw_fixed",
                          gain=-1.0 if flip else 1.0)
    K2FX_LAUNCHES += launched
    return out


def draw_scale_shard(seed, table, shape, spacing, smoothing_length=0.0,
                     y_off=0, ny_loc=None):
    """K7: :func:`draw_scale` for a slab mesh's shard, ky rows [y_off,
    y_off + ny_loc), all x rows.

    Every mode is drawn at its global counter and scaled at its global |k|,
    and a plane mode whose conjugate partner lies on another rank draws the
    partner's counter itself, so the union of the shards equals
    :func:`draw_scale` on the whole grid bit for bit with no exchange.  The
    counterpart of ``pallas_sampler.scale_shard_pallas_reim`` and of the
    sharded draw and fix in front of it; on CUDA it launches
    ``csrc/draw_scale.cu`` over the shard's rows.
    """
    global K7_LAUNCHES
    out, launched = _draw(seed, table, shape, spacing, smoothing_length, 0,
                          y_off, None, ny_loc, _SPECTRUM, "draw_scale_shard")
    K7_LAUNCHES += launched
    return out


def draw_bits(seed, table, shape, x_off=0, y_off=0, nx_loc=None,
              ny_loc=None):
    """The bits under :func:`draw_scale`'s unit draws: int64 (2, nx_loc,
    ny_loc, nz//2+1) uint32 values, ``jax.random.bits`` of the canonical
    stream, on the table's device.  On CUDA the fused kernel writes them
    (a check of its hash alone, counted in ``K2F_LAUNCHES``); on the CPU
    :func:`.sample.canonical_bits_reim`."""
    global K2F_LAUNCHES
    out, launched = _draw(seed, table, shape, 1.0, 0.0, x_off, y_off, nx_loc,
                          ny_loc, _BITS, "draw_bits")
    K2F_LAUNCHES += launched
    return out


def draw_normals(bits):
    """The fused kernel's normal of each 32-bit word: ``jax.random.normal``'s
    float32 value of those bits.

    ``bits``: int64 tensor of uint32 values.  Returns float32 of its shape.
    On CUDA this launches ``csrc/draw_scale.cu``'s ``rf_jax_normal``, the
    device function ``threefry.cuh:jax_normal`` alone over the words (a
    check of that function, on no render's path, counted nowhere); on the
    CPU it runs its plain version, :mod:`.threefry`'s.
    """
    if bits.dtype != torch.int64:
        raise ValueError(f"draw_normals: bits must be int64, got {bits.dtype}")
    if bits.device.type == "cpu":
        return _threefry._normal_from_bits(bits)
    words = torch.where(bits >= 2**31, bits - 2**32, bits).to(torch.int32)
    words = words.contiguous()
    out = torch.empty(words.shape, dtype=torch.float32, device=bits.device)
    status = _build.library().rf_jax_normal(
        words.data_ptr(), out.data_ptr(), words.numel(),
        _build.current_stream(out))
    _build.check(status, "draw_normals")
    return out


def unit_phases(re, im):
    """The fixed modes' z / |z| of each pair: (re / |z|, im / |z|), and
    (1, 0) where |z| = 0.

    ``re``, ``im``: float32 tensors of one shape.  Returns two new float32
    tensors of that shape.  On CUDA this launches ``csrc/draw_scale.cu``'s
    ``rf_unit_phase``, the device function ``phase.cuh:unit_phase`` alone
    over the pairs (a check of that function, on no render's path, counted
    nowhere); on the CPU it runs its plain version,
    :func:`.sample.unit_phase`.
    """
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError(f"unit_phases: re and im must be float32, got "
                         f"{re.dtype} and {im.dtype}")
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("unit_phases: re and im must share shape and device")
    if re.device.type == "cpu":
        return _canon.unit_phase(re.clone(), im.clone())
    re, im = re.contiguous(), im.contiguous()
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    status = _build.library().rf_unit_phase(
        re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        re.numel(), _build.current_stream(out_re))
    _build.check(status, "unit_phases")
    return out_re, out_im


def _block_rows(shape, x_off, y_off, nx_loc, ny_loc):
    """(nx_loc, ny_loc) of a block, the rest of the grid by default; raises
    ValueError unless the block lies inside the grid."""
    nx, ny, _ = shape
    nx_loc = nx - x_off if nx_loc is None else int(nx_loc)
    ny_loc = ny - y_off if ny_loc is None else int(ny_loc)
    if not (0 <= x_off and 0 < nx_loc and x_off + nx_loc <= nx
            and 0 <= y_off and 0 < ny_loc and y_off + ny_loc <= ny):
        raise ValueError(f"block of x rows [{x_off}, {x_off + nx_loc}) and ky "
                         f"rows [{y_off}, {y_off + ny_loc}) lies outside the "
                         f"grid {tuple(shape)}")
    return nx_loc, ny_loc


def _draw(seed, table, shape, spacing, smoothing_length, x_off, y_off,
          nx_loc, ny_loc, mode, name, gain=float(_INV_SQRT2)):
    """The fused kernel's body: (output, launches) with the plain version
    on the CPU (0 launches) or one launch of ``mode`` on CUDA; ``gain`` is
    folded into the amplitude (the spectrum's 1/sqrt(2), the fixed field's
    1 or -1; the fixed mode takes every x row)."""
    dev = _check_table(table, name)
    nx, ny, nz = shape
    nx_loc, ny_loc = _block_rows(shape, x_off, y_off, nx_loc, ny_loc)
    if dev.type == "cpu":
        if mode == _FIXED:
            return draw_fixed_plain(seed, table, shape, spacing,
                                    smoothing_length, gain < 0, y_off,
                                    ny_loc), 0
        if mode == _BITS:
            bits = _canon.canonical_bits_reim(_threefry.as_key(seed),
                                               shape, dev, y_off, ny_loc)
            return torch.stack([b[x_off:x_off + nx_loc] for b in bits]), 0
        return draw_scale_plain(seed, table, shape, spacing, smoothing_length,
                                x_off, y_off, nx_loc, ny_loc,
                                unit=mode == _UNIT), 0
    key = _threefry.as_key(seed)
    chunks = _canon.canonical_chunks(nx)
    keys = [_threefry.fold_in(key, i) for i in range(chunks)]
    words = (ctypes.c_uint32 * (2 * chunks))(*(k[0] for k in keys),
                                             *(k[1] for k in keys))
    out = torch.empty((2, nx_loc, ny_loc, nz // 2 + 1),
                      dtype=torch.int32 if mode == _BITS else torch.float32,
                      device=dev)
    c = _constants(table, shape, spacing)
    status = _build.library().rf_draw_scale(
        out[0].data_ptr(), out[1].data_ptr(), table.knots.data_ptr(),
        table.knots.numel(), ctypes.addressof(words), chunks, nx, ny, nz,
        int(x_off), nx_loc, int(y_off), ny_loc,
        float(c["kx_scale"]), float(c["ky_scale"]), float(c["kz_scale"]),
        float(_HALF_INV_LN10), float(c["lk0"]), float(c["inv_dlk"]),
        float(np.float32(smoothing_length)), float(np.float32(gain)), mode,
        _build.current_stream(out),
    )
    _build.check(status, name)
    if mode == _BITS:
        out = out.to(torch.int64) & 0xFFFFFFFF
    return out, 1


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


# ---- K1 and K5: the sampler='pallas' kernels -------------------------------------

def _sampler_ksq(c, shape, x_off, nx_loc, dev, y_off=0, ny_loc=None):
    """|k|^2 of x rows [x_off, x_off + nx_loc) and ky rows [y_off, y_off +
    ny_loc) in the TPU sampler's float32 order, (kx^2 + kz^2) + ky^2
    (csrc/threefry.cuh:sampler_ksq)."""
    ny_loc = shape[1] - y_off if ny_loc is None else ny_loc
    kx, ky, kz = _axis_k(c, shape, x_off, nx_loc, y_off, ny_loc, dev)
    ksq = (kx * kx)[:, None, None] + (kz * kz)[None, None, :]
    return ksq + (ky * ky)[None, :, None]


def _mode_amplitude(table, c, shape, x_off, nx_loc, smoothing_length,
                    always_filter, y_off=0, ny_loc=None):
    """(|k|^2, log10|k|, amp) of a block: amp = sigma / sqrt(2) times the
    filter, which K1 applies only when s != 0 and K5 always (exp(0) = 1, so
    the two agree)."""
    ksq = _sampler_ksq(c, shape, x_off, nx_loc, table.knots.device, y_off,
                       ny_loc)
    lk, sig = _interp_sigma(table.knots, ksq, c)
    amp = sig * float(_INV_SQRT2)
    s = float(np.float32(smoothing_length))
    if always_filter or s != 0.0:
        amp = amp * torch.exp(-0.5 * ksq * s * s)
    return ksq, lk, amp


def _uniforms(b1, b2):
    """Box-Muller uniforms from the top 24 bits: u1 in (0, 1], u2 in [0, 1)."""
    u1 = (b1 >> 8).to(torch.float32) * float(_INV_2_24) + float(_HALF_INV_2_24)
    u2 = (b2 >> 8).to(torch.float32) * float(_INV_2_24)
    return u1, u2


def _check_bits(b1, b2, table, shape, x_off, y_off=0, ny_loc=None):
    nx, ny, nz = shape
    ny_loc = ny if ny_loc is None else ny_loc
    want = (ny_loc, nz // 2 + 1)
    if (b1.shape != b2.shape or b1.ndim != 3 or tuple(b1.shape[1:]) != want
            or b1.dtype != torch.int64 or b2.dtype != torch.int64):
        raise ValueError(f"b1/b2 must be equal int64 (nx_loc, {want[0]}, "
                         f"{want[1]}) blocks, got {tuple(b1.shape)} "
                         f"{b1.dtype} and {tuple(b2.shape)} {b2.dtype}")
    if not 0 <= x_off <= nx - b1.shape[0]:
        raise ValueError(f"x rows [{x_off}, {x_off + b1.shape[0]}) lie "
                         f"outside the grid {shape}")
    if not 0 <= y_off <= ny - ny_loc:
        raise ValueError(f"ky rows [{y_off}, {y_off + ny_loc}) lie "
                         f"outside the grid {shape}")
    if b1.device != b2.device or table.knots.device != b1.device:
        raise ValueError("b1, b2 and the table's knots must share a device")


def _check_table(table, name):
    if table.knots.numel() < 2:
        raise ValueError("the sigma table needs at least two knots")
    dev = table.knots.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {dev}")
    if table.knots.dtype != torch.float32 or not table.knots.is_contiguous():
        raise ValueError(f"{name} needs contiguous float32 knots")
    return dev


def sample_modes_plain(b1, b2, table, shape, spacing, smoothing_length=0.0,
                       x_off=0, y_off=0):
    """K1 (and K8) in plain PyTorch on given bits, any device.

    ``b1``/``b2``: int64 tensors of uint32 values, the bits of the modes of
    x rows [x_off, x_off + nx_loc) and ky rows [y_off, y_off + ny_loc),
    shaped (nx_loc, ny_loc, nz//2+1).  Returns float32 (re, im) of the same
    shape, before the Hermitian fix: the float32 operations of
    ``csrc/sample_modes.cu`` (and of the TPU kernel) in their order, x-slab
    by x-slab.
    """
    ny_loc = b1.shape[1]
    _check_bits(b1, b2, table, shape, x_off, y_off, ny_loc)
    c = _constants(table, shape, spacing)
    re = torch.empty(b1.shape, dtype=torch.float32, device=b1.device)
    im = torch.empty_like(re)
    for x0 in range(0, b1.shape[0], _PLAIN_X_CHUNK):
        x1 = min(b1.shape[0], x0 + _PLAIN_X_CHUNK)
        _, _, amp = _mode_amplitude(table, c, shape, x_off + x0, x1 - x0,
                                    smoothing_length, always_filter=False,
                                    y_off=y_off, ny_loc=ny_loc)
        u1, u2 = _uniforms(b1[x0:x1], b2[x0:x1])
        r = torch.sqrt(-2.0 * torch.log(u1))
        theta = float(_TWO_PI32) * u2
        re[x0:x1] = amp * (r * torch.cos(theta))
        im[x0:x1] = amp * (r * torch.sin(theta))
    return re, im


def seeded_modes_plain(seed, table, shape, spacing, smoothing_length=0.0,
                       y_off=0, ny_loc=None):
    """K1's (and K8's) function in plain PyTorch: :func:`sample_modes_plain`
    on the seed's stream (:mod:`.modestream`) over ky rows [y_off, y_off +
    ny_loc) (all by default), drawn x-slab by x-slab on the table's
    device."""
    nx, ny, nz = shape
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    key = _modestream.mode_key(seed)
    dev = table.knots.device
    re = torch.empty((nx, ny_loc, nz // 2 + 1), dtype=torch.float32,
                     device=dev)
    im = torch.empty_like(re)
    for x0 in range(0, nx, _PLAIN_X_CHUNK):
        n = min(_PLAIN_X_CHUNK, nx - x0)
        b1, b2 = _modestream.mode_bits(key, shape, x0, n, dev, y_off, ny_loc)
        re[x0:x0 + n], im[x0:x0 + n] = sample_modes_plain(
            b1, b2, table, shape, spacing, smoothing_length, x0, y_off)
    return re, im


def plane_partner(x, y, nx, ny):
    """The Hermitian fix's selection on a self-conjugate kz plane, as the
    kernels make it per mode (``csrc/hermitian.cuh``): for integer tensors
    of rows ``x`` and columns ``y`` (broadcast together), ``(px, py,
    not_canonical, self_conj)``: the partner ((-x) mod nx, (-y) mod ny),
    whether (x, y) comes after it in (x, then y) order (the mode that takes
    its partner's draw, im negated) and whether it is its own partner."""
    px = torch.where(x == 0, 0, nx - x)
    py = torch.where(y == 0, 0, ny - y)
    not_canonical = (x > px) | ((x == px) & (y > py))
    return px, py, not_canonical, (x == px) & (y == py)


def seeded_spectrum_plain(seed, table, shape, spacing, smoothing_length=0.0,
                          y_off=0, ny_loc=None):
    """K1's and K8's function in plain PyTorch: the seed's spectrum over ky
    rows [y_off, y_off + ny_loc) (all by default), Hermitian on the kz = 0
    and Nyquist planes, x-slab by x-slab on the table's device.

    :func:`sample_modes_plain` of the seed's bits, where on a plane a mode
    that is not canonical (:func:`plane_partner`) takes the bits of its
    partner's counter, whose draw then lands at the mode's own |k| (the
    same |k|^2 bit for bit); then im negated there, and a self-conjugate
    mode's re times sqrt(2) with im = 0.  The whole grid's result equals
    :func:`.transform.symmetrize_with_shape_reim` of
    :func:`seeded_modes_plain` bit for bit, and a block of fewer ky rows
    needs no other rows (no mesh).  Returns float32 (re, im), (nx, ny_loc,
    nz//2+1).
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    key = _modestream.mode_key(seed)
    dev = table.knots.device
    re = torch.empty((nx, ny_loc, nzh), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    ys = torch.arange(y_off, y_off + ny_loc, device=dev)
    for x0 in range(0, nx, _PLAIN_X_CHUNK):
        n = min(_PLAIN_X_CHUNK, nx - x0)
        b1, b2 = _modestream.mode_bits(key, shape, x0, n, dev, y_off, ny_loc)
        xs = torch.arange(x0, x0 + n, device=dev)
        px, py, moved, self_conj = plane_partner(xs[:, None], ys[None, :],
                                                 nx, ny)
        planes = _grid.self_conjugate_kz_planes(nz)
        for p in planes:
            idx = (px * ny + py) * nzh + p
            pb1, pb2 = _threefry.threefry2x32(key, idx >> 32, idx & 0xFFFFFFFF)
            b1[..., p] = torch.where(moved, pb1, b1[..., p])
            b2[..., p] = torch.where(moved, pb2, b2[..., p])
        r, i = sample_modes_plain(b1, b2, table, shape, spacing,
                                  smoothing_length, x0, y_off)
        for p in planes:
            i[..., p] = torch.where(moved, -i[..., p], i[..., p])
            r[..., p] = torch.where(self_conj, r[..., p] * _SQRT2, r[..., p])
            i[..., p] = torch.where(self_conj, 0.0, i[..., p])
        re[x0:x0 + n], im[x0:x0 + n] = r, i
    return re, im


def sample_modes(seed, table, shape, spacing, smoothing_length=0.0):
    """K1: the ``sampler='pallas'`` spectrum of ``seed``, in one pass.

    Returns float32 (nx, ny, nz//2+1) 'xyz' (re, im) lattices on the
    table's device: each mode's Box-Muller draw from the seed's
    counter-based stream times sigma(|k|) / sqrt(2) times the filter, DC
    zero, the kz = 0 / Nyquist planes Hermitian (self-conjugate modes times
    sqrt(2)).  On CUDA this launches ``csrc/sample_modes.cu``, which fixes
    the planes in the thread; on the CPU it runs
    :func:`seeded_spectrum_plain`.
    """
    global K1_LAUNCHES
    out, launched = _sample(seed, table, shape, spacing, smoothing_length, 0,
                            shape[1], "sample_modes")
    K1_LAUNCHES += launched
    return out


def sample_shard(seed, table, shape, spacing, smoothing_length=0.0, y_off=0,
                 ny_loc=None):
    """K8: :func:`sample_modes` for a slab mesh's shard, ky rows [y_off,
    y_off + ny_loc).

    Returns float32 (nx, ny_loc, nz//2+1) (re, im): every mode drawn at its
    global counter and scaled at its global |k|, and a plane mode whose
    partner row lies on another rank drawn at the partner's counter, so the
    union of the shards equals K1 on the whole grid bit for bit with no
    exchange.  The counterpart of ``pallas_sampler.sample_shard_pallas_reim``
    and of the sharded fix after it; on CUDA it launches
    ``csrc/sample_modes.cu`` over the shard's rows.
    """
    global K8_LAUNCHES
    ny_loc = shape[1] - y_off if ny_loc is None else ny_loc
    out, launched = _sample(seed, table, shape, spacing, smoothing_length,
                            y_off, ny_loc, "sample_shard")
    K8_LAUNCHES += launched
    return out


def _sample(seed, table, shape, spacing, smoothing_length, y_off, ny_loc,
            name):
    """K1's body: ((re, im), launches) with the plain version on the CPU
    (0 launches) or one launch on CUDA."""
    dev = _check_table(table, name)
    nx, ny, nz = shape
    if not 0 <= y_off <= ny - ny_loc:
        raise ValueError(f"{name}: ky rows [{y_off}, {y_off + ny_loc}) lie "
                         f"outside the grid {shape}")
    if dev.type == "cpu":
        return seeded_spectrum_plain(seed, table, shape, spacing,
                                     smoothing_length, y_off, ny_loc), 0
    re = torch.empty((nx, ny_loc, nz // 2 + 1), dtype=torch.float32,
                     device=dev)
    im = torch.empty_like(re)
    c = _constants(table, shape, spacing)
    k0, k1 = _modestream.mode_key(seed)
    status = _build.library().rf_sample_modes(
        re.data_ptr(), im.data_ptr(), table.knots.data_ptr(),
        table.knots.numel(), nx, ny, nz, int(y_off), int(ny_loc),
        k0, k1, float(c["kx_scale"]), float(c["ky_scale"]),
        float(c["kz_scale"]), float(_HALF_INV_LN10), float(c["lk0"]),
        float(c["inv_dlk"]), float(np.float32(smoothing_length)),
        _build.current_stream(re),
    )
    _build.check(status, name)
    return (re, im), 1


def sample_nested_plain(seed, table, shape, spacing, smoothing_length=0.0,
                        mode="spectrum", flip=False, y_off=0, ny_loc=None):
    """:func:`sample_nested` in plain PyTorch on the table's device
    (:mod:`.sample`'s nested stream, x-slab by x-slab): float32 (2, nx,
    ny_loc, nzh), or for ``mode='bits'`` int64 uint32 words, of the ky rows
    [y_off, y_off + ny_loc) (all by default)."""
    key = _threefry.as_key(seed)
    dev = table.knots.device
    rows = dict(y_off=y_off, ny_loc=ny_loc)
    if mode == "spectrum":
        out = _canon.sample_spectrum_nested(key, table, shape, spacing,
                                            smoothing_length, **rows)
    elif mode == "unit":
        out = _canon.nested_unit_draws(key, shape, dev, **rows)
    elif mode == "fixed":
        out = _canon.sample_fixed_spectrum(key, table, shape, spacing,
                                           smoothing_length, flip,
                                           nested=True, **rows)
    else:
        out = _canon.nested_bits(key, _canon.lattice_codes(shape, dev,
                                                           **rows))
    return torch.stack(out)


def sample_nested(seed, table, shape, spacing, smoothing_length=0.0,
                  mode="spectrum", flip=False, y_off=0, ny_loc=None):
    """KN: the ``sampler='nested'`` draws of ``seed`` in one pass.

    Returns float32 (2, nx, ny_loc, nz//2+1), re and im, on the table's
    device, for the ky rows [y_off, y_off + ny_loc) (the whole grid by
    default; a slab mesh's shard, whose union over the shards is the
    whole-grid result bit for bit with no exchange).

    Each mode's Threefry-2x32 words are the hash of (its lattice code, 0)
    under ``key_from_seed(seed)`` (:func:`.sample.lattice_codes`), its unit
    normals their Box-Muller pair (:func:`.sample.nested_unit_draws`).
    ``mode``: 'spectrum', the kz = 0 / Nyquist planes made Hermitian (a
    non-canonical mode at its partner's code) times sigma(|k|) *
    exp(-k^2 s^2 / 2) / sqrt(2), K2's amplitude; 'unit', the raw normals
    (``generate_noise``); 'fixed', after the fix z / |z| times the
    amplitude with gain 1, or -1 with ``flip``; 'bits', the two words as
    int64 uint32 values (a check of the hash).  Every axis at most
    :data:`.sample.NESTED_MAX_DIM`.  On CUDA this launches
    ``csrc/sample_modes.cu``'s nested instance; on the CPU it runs
    :func:`sample_nested_plain`.  ``seed`` may also be a key pair, used raw.
    """
    global KN_LAUNCHES
    dev = _check_table(table, "sample_nested")
    if mode not in NESTED_MODES:
        raise ValueError(f"sample_nested: unknown mode {mode!r}")
    if max(shape) > _canon.NESTED_MAX_DIM:
        raise ValueError(f"nested sampling packs signed indices into 10 bits "
                         f"per axis: max dim is {_canon.NESTED_MAX_DIM}, got "
                         f"{tuple(shape)}")
    nx, ny, nz = shape
    _, ny_loc = _block_rows(shape, 0, y_off, None, ny_loc)
    if dev.type == "cpu":
        return sample_nested_plain(seed, table, shape, spacing,
                                   smoothing_length, mode, flip, y_off, ny_loc)
    out = torch.empty((2, nx, ny_loc, nz // 2 + 1),
                      dtype=torch.int32 if mode == "bits" else torch.float32,
                      device=dev)
    gain = {"spectrum": float(_INV_SQRT2), "fixed": -1.0 if flip else 1.0}
    c = _constants(table, shape, spacing)
    k0, k1 = _threefry.as_key(seed)
    status = _build.library().rf_sample_nested(
        out[0].data_ptr(), out[1].data_ptr(), table.knots.data_ptr(),
        table.knots.numel(), nx, ny, nz, int(y_off), ny_loc, k0, k1,
        float(c["kx_scale"]),
        float(c["ky_scale"]), float(c["kz_scale"]), float(_HALF_INV_LN10),
        float(c["lk0"]), float(c["inv_dlk"]),
        float(np.float32(smoothing_length)), gain.get(mode, 1.0),
        NESTED_MODES[mode], _build.current_stream(out),
    )
    _build.check(status, "sample_nested")
    KN_LAUNCHES += 1
    if mode == "bits":
        out = out.to(torch.int64) & 0xFFFFFFFF
    return out


def sample_spectrum(seed, table, shape, spacing, smoothing_length=0.0):
    """The ``sampler='pallas'`` spectrum of ``seed`` as (re, im) float32
    'xyz' lattices: K1 alone, which makes the planes Hermitian itself.  The
    counterpart of ``pallas_sampler.sample_spectrum_pallas_reim``."""
    return sample_modes(seed, table, shape, spacing, smoothing_length)


def _bin_edges(edges, dev):
    """(nbins, float32 edges on ``dev``) of ascending |k| edges."""
    edges = np.asarray(edges, np.float64)
    nbins = edges.size - 1
    if not 1 <= nbins <= MAX_KERNEL_BINS or np.any(np.diff(edges) <= 0):
        raise ValueError(f"the binned sampler takes 2 to {MAX_KERNEL_BINS + 1} "
                         f"ascending edges, got {edges.size}")
    return nbins, torch.as_tensor(edges, dtype=torch.float32, device=dev)


def _volume32(shape, spacing):
    nx, ny, nz = shape
    return np.float32(nx * ny * nz * float(spacing) ** 3)


def power_bins_plain(b1, b2, table, shape, spacing, smoothing_length, edges,
                     x_off=0):
    """K5 in plain PyTorch on given bits, any device.

    ``b1``/``b2`` as for :func:`sample_modes_plain`; ``edges``: the nbins + 1
    ascending |k| bin edges.  Returns ``(acc, plane_re, plane_im)``:
    ``acc`` float64 (3, nbins), the interior modes' per-bin (sum w, sum w
    |c|^2 V, sum w |k|) with w = 2, each mode in the bin the estimator's
    edge search gives its |k| (:func:`.grid.kmag`);
    ``plane_re``/``plane_im`` float32 (nx_loc, n_planes, ny), the raw draws
    of the kz = 0 (and, for even nz, Nyquist) planes, K1's values there.
    """
    _check_bits(b1, b2, table, shape, x_off)
    dev = b1.device
    nbins, edges_t = _bin_edges(edges, dev)
    vol = float(_volume32(shape, spacing))
    c = _constants(table, shape, spacing)
    nx, ny, nz = shape
    planes = _grid.self_conjugate_kz_planes(nz)
    interior = torch.ones(nz // 2 + 1, dtype=torch.bool, device=dev)
    interior[list(planes)] = False
    acc = torch.zeros((3, nbins + 1), dtype=torch.float64, device=dev)
    pre = torch.empty((b1.shape[0], len(planes), ny), dtype=torch.float32,
                      device=dev)
    pim = torch.empty_like(pre)
    for x0 in range(0, b1.shape[0], _PLAIN_X_CHUNK):
        x1 = min(b1.shape[0], x0 + _PLAIN_X_CHUNK)
        _, _, amp = _mode_amplitude(table, c, shape, x_off + x0, x1 - x0,
                                    smoothing_length, always_filter=True)
        u1, u2 = _uniforms(b1[x0:x1], b2[x0:x1])
        pv = amp * amp * (-2.0 * torch.log(u1)) * vol
        km = _grid.kmag(shape, spacing, torch.float32, dev, x_off + x0,
                        x1 - x0)
        idx = torch.searchsorted(edges_t, km) - 1
        valid = (idx >= 0) & (idx < nbins) & (km > 0) & interior
        idx = torch.where(valid, idx, nbins).flatten()
        w = torch.where(valid, 2.0, 0.0)
        for row, val in enumerate((w, w * pv, w * km)):
            acc[row].index_add_(0, idx, val.flatten().to(torch.float64))
        for i, p in enumerate(planes):
            r = torch.sqrt(-2.0 * torch.log(u1[..., p]))
            theta = float(_TWO_PI32) * u2[..., p]
            pre[x0:x1, i] = amp[..., p] * (r * torch.cos(theta))
            pim[x0:x1, i] = amp[..., p] * (r * torch.sin(theta))
    return acc[:, :nbins].contiguous(), pre, pim


def seeded_power_bins_plain(seed, table, shape, spacing, smoothing_length,
                            edges):
    """K5's function in plain PyTorch for one seed: :func:`power_bins_plain`
    on the seed's stream, x-slab by x-slab on the table's device, plus its
    raw planes made Hermitian and binned with multiplicity 1
    (:func:`..validate.stats.plane_bins`), as
    ``engine/staged.py:_sample_power_v3`` assembles them on the TPU.
    Returns float64 (3, nbins): (sum w, sum w |c|^2 V, sum w |k|) over
    every mode of the half-spectrum."""
    from randomfield_tpu_torch.validate import stats as _stats

    nx = shape[0]
    key = _modestream.mode_key(seed)
    dev = table.knots.device
    acc, pres, pims = None, [], []
    for x0 in range(0, nx, _PLAIN_X_CHUNK):
        n = min(_PLAIN_X_CHUNK, nx - x0)
        b1, b2 = _modestream.mode_bits(key, shape, x0, n, dev)
        a, pre, pim = power_bins_plain(b1, b2, table, shape, spacing,
                                       smoothing_length, edges, x0)
        acc = a if acc is None else acc + a
        pres.append(pre)
        pims.append(pim)
    nbins = acc.shape[1]
    return acc + _stats.plane_bins(torch.cat(pres), torch.cat(pims), shape,
                                   spacing, nbins, edges)


class BinPlan(typing.NamedTuple):
    """What K5 needs per (scene, bins), made once on the device."""

    edges: np.ndarray       # float64 (nbins + 1,), ascending
    edges_t: torch.Tensor   # float32 (nbins + 1,) on the device
    kvec: torch.Tensor      # float32 (nx + ny + nz//2+1,), the estimator's k


def bin_plan(shape, spacing, edges, device) -> BinPlan:
    """K5's :class:`BinPlan` of the |k| ``edges`` (nbins + 1 ascending,
    nbins <= ``MAX_KERNEL_BINS``) on ``device``; raises ValueError on
    other edges."""
    _, edges_t = _bin_edges(edges, device)
    kvec = torch.cat(_grid.kvectors(shape, spacing, torch.float32, device))
    return BinPlan(np.asarray(edges, np.float64), edges_t, kvec)


def sample_power_bins(seed, table, shape, spacing, smoothing_length, edges):
    """K5 for one seed: float64 (3, nbins), as :func:`seeded_power_bins_plain`
    returns it, on the table's device (:func:`sample_power_bins_batch` of
    one seed)."""
    plan = bin_plan(shape, spacing, edges, table.knots.device)
    return sample_power_bins_batch([seed], table, shape, spacing,
                                   smoothing_length, plan)[0]


def sample_power_bins_batch(seeds, table, shape, spacing, smoothing_length,
                            plan):
    """K5: the binned power of each seed's ``sampler='pallas'`` spectrum.

    The draws are K1's (the same stream, amplitude and plane fix); no
    spectrum is written.  ``plan``: the :class:`BinPlan` of the bins on the
    table's device.  Returns float64 (len(seeds), 3, nbins) on the table's
    device, row i the sums of ``seeds[i]`` (every mode of the half-spectrum
    in the bin of the estimator's edge search on its |k|, interior modes
    with weight 2, the kz = 0 / Nyquist plane modes 1).  On CUDA this
    launches ``csrc/sample_power_bins.cu`` over the whole batch at once (a
    grid column per seed), in as few launches as keep its block partials
    within 256 MiB; the sums run in float64 in an order fixed by the shapes
    (two calls agree bit for bit, and a seed's row does not depend on the
    batch around it).  On the CPU it stacks :func:`seeded_power_bins_plain`.
    """
    global K5_LAUNCHES
    dev = _check_table(table, "sample_power_bins")
    seeds = [int(s) for s in np.asarray(seeds).ravel()]
    nbins = plan.edges.size - 1
    if dev.type == "cpu":
        return torch.stack([
            seeded_power_bins_plain(s, table, shape, spacing,
                                    smoothing_length, plan.edges)
            for s in seeds])
    nx, ny, nz = shape
    n_blocks = (nx // 2 + 1) * -(-ny // _K5_ROWS)
    per_seed = n_blocks * 3 * nbins
    chunk = max(1, min(len(seeds), _K5_MAX_GRID_Z,
                       _K5_PARTIAL_VALUES // per_seed))
    keys = torch.tensor([_modestream.mode_key(s) for s in seeds],
                        dtype=torch.int64).to(torch.int32).to(dev)
    acc = torch.empty((len(seeds), 3, nbins), dtype=torch.float64, device=dev)
    partials = torch.empty(chunk * per_seed, dtype=torch.float64, device=dev)
    c = _constants(table, shape, spacing)
    lib = _build.library()
    for i in range(0, len(seeds), chunk):
        status = lib.rf_sample_power_bins(
            acc[i].data_ptr(), partials.data_ptr(), n_blocks,
            keys[i].data_ptr(), min(chunk, len(seeds) - i),
            table.knots.data_ptr(), table.knots.numel(),
            plan.kvec.data_ptr(), plan.edges_t.data_ptr(), nx, ny, nz,
            float(c["kx_scale"]), float(c["ky_scale"]), float(c["kz_scale"]),
            float(_HALF_INV_LN10), float(c["lk0"]), float(c["inv_dlk"]),
            float(np.float32(smoothing_length)),
            float(_volume32(shape, spacing)), nbins,
            _build.current_stream(acc),
        )
        _build.check(status, "sample_power_bins")
        K5_LAUNCHES += 1
    return acc
