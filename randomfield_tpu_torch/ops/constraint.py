"""KC: the constraint functionals of constrained (Hoffman-Ribak) renders.

The port of ``randomfield_tpu/models/constrained.py:_measure_chunked`` and
``_correction_chunked``.  The smoothed-value kernel of constraint i,
K_i(k) = exp(-k^2 R_i^2 / 2) exp(i k.x_i), is separable by axis, so
:func:`axis_tables` builds e_{a,i}(k_a) = exp(-k_a^2 R_i^2 / 2) (cos, sin)
(k_a x_{i,a}) in float64 on the host, rounded to float32 once, and every
version forms K_i = (e_x e_y) e_z in float32 in that order, its imaginary
part zeroed at the truly self-conjugate modes.  On a packed 'xyz' spectrum
(float32 re, im lattices):

* :func:`measure`: Gamma_i = sum m_k Re(c_k K_i) (m_k the Hermitian
  multiplicity), float64; with ``sigmas`` it first scales the unit draws
  in place by sigma f, f = exp(-k^2 s^2 / 2) (the reference's
  ``sample_spectrum`` then ``filter_modes``);
* :func:`correct`: c += (sigma f)^2 sum_i alpha_i conj(K_i), in place;
* :func:`gram`: xi_ij = sum m_k (sigma f)^2 Re(K_i K_j*), float64 matmuls
  over x-slabs of the same float32 K (not a kernel: the reference's Gram
  is a plain product too), so Gram, correction and draw read one sigma_eff^2
  and a constrained render meets its constraints to rounding.

On CUDA tensors :func:`measure` and :func:`correct` launch
``csrc/constraint_kernel.cu`` (counter ``KC_LAUNCHES``: one a pass, for any
M; a measurement's pass is the kernel and the fixed-order sum of its
partials) or raise; on CPU tensors they run the plain versions, which
repeat the kernel's float32 operations in its order: the correction equals
the kernel bit for bit and the measurement agrees to float64 summation
order.  The kernel streams the lattices through shared memory
(``csrc/line_ring.cuh``) and holds the z tables of the constraints there:
all M when they fit, else it takes them in passes of as many as fit
(:func:`launch_plan`), within the one launch.  MEASURE streams the
lattices once a pass; CORRECT keeps each mode's alpha sums between its
passes in a grid of float32 pairs and streams the lattices in its last.

On a slab mesh a rank holds the ky rows [y_off, y_off + ny/P) of the
spectrum: :func:`ky_block` cuts the tables to them (e_y and the ky
vector), and every version runs on the (nx, ny/P, nzh) block as on a grid
but for the self-conjugate test, taken at the global ky.  CORRECT gives the
whole grid's rows bit for bit; MEASURE and :func:`gram` give the block's
partial sums, which the caller all-reduces in float64 (the whole grid's
within float64 reordering).  The kernel's block instances are counted in
``KCS_LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools
import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import grid as _grid

__all__ = ["ConstraintTables", "axis_tables", "ky_block", "kernel_block",
           "measure", "measure_plain", "correct", "correct_plain", "gram",
           "sigma_eff2", "launch_plan", "KC_LAUNCHES", "KCS_LAUNCHES"]

# kernel launches by measure and correct, one a call, on a whole grid and on
# a ky block (the CPU paths do not count)
KC_LAUNCHES = 0
KCS_LAUNCHES = 0

_KERNEL_WARPS = 8  # a block's warps, each with its own measure partials
# the most constraints a pass of the kernels takes (0: as many as fit in
# shared memory); the tests lower it to drive the passes on small grids
_PASS_CAP = 0
# x planes a step of the plain versions and of the Gram (bounds temporaries)
_X_CHUNK = 8


class ConstraintTables(typing.NamedTuple):
    """The per-axis tables of M constraints on one grid, or on a ky block
    of it (``shape`` the block's (nx, ny_loc, nz), its rows [y_off, y_off +
    ny_loc) of ``ny_full``)."""

    tab: torch.Tensor    # float32 (M, nx + ny + nzh, 2): e_x, e_y, e_z
    kvec: torch.Tensor   # float32 (nx + ny + nzh,): kx, ky, kz
    shape: tuple
    y_off: int = 0
    ny_full: int = 0     # the grid's ky rows (0: shape[1], a whole grid)

    @property
    def rows(self):
        """(y_off, the grid's ky rows)."""
        return self.y_off, self.ny_full or self.shape[1]


def axis_tables(positions, scales, shape, spacing, device="cpu"):
    """:class:`ConstraintTables` of constraints at ``positions`` (M, 3) with
    smoothing radii ``scales`` (M,): e_{a,i}(k_a) = exp(-k_a^2 R_i^2 / 2)
    (cos, sin)(k_a x_{i,a}) in float64 (k as numpy's fftfreq times 2 pi),
    rounded to float32 once; and the float32 k vectors."""
    nx, ny, nz = (int(s) for s in shape)
    pos = np.asarray(positions, np.float64).reshape(-1, 3)
    r = np.asarray(scales, np.float64).reshape(-1)
    k = [2.0 * np.pi * np.fft.fftfreq(nx, d=spacing),
         2.0 * np.pi * np.fft.fftfreq(ny, d=spacing),
         2.0 * np.pi * np.fft.rfftfreq(nz, d=spacing)]
    parts = []
    for a in range(3):
        win = np.exp(-0.5 * (k[a][None, :] * r[:, None]) ** 2)
        ph = k[a][None, :] * pos[:, a, None]
        parts.append(np.stack([win * np.cos(ph), win * np.sin(ph)], -1))
    tab = np.concatenate(parts, axis=1).astype(np.float32)
    kvec = torch.cat([t.to(torch.float32) for t in _grid.kvectors(
        (nx, ny, nz), spacing, torch.float64)])
    return ConstraintTables(torch.as_tensor(tab, device=device),
                            kvec.to(device), (nx, ny, nz))


def ky_block(tables, y_off, ny_loc):
    """The :class:`ConstraintTables` of a whole grid's tables cut to its ky
    rows [y_off, y_off + ny_loc): a slab mesh rank's block."""
    nx, ny, nz = tables.shape
    keep = torch.cat([torch.arange(nx), nx + y_off + torch.arange(ny_loc),
                      torch.arange(nx + ny, nx + ny + nz // 2 + 1)]).to(
                          tables.tab.device)
    return ConstraintTables(tables.tab[:, keep].contiguous(),
                            tables.kvec[keep].contiguous(),
                            (nx, int(ny_loc), nz), int(y_off), ny)


def _self_conjugate(shape, x0, x1, device, y_off=0, ny_full=0):
    """bool (x1 - x0, ny, nzh): every axis index its own partner (on a ky
    block of a grid of ``ny_full`` rows, ky at its index there)."""
    nx, ny, nz = shape
    ny_full = ny_full or ny

    def own(idx, n):
        return (idx == 0) | ((n % 2 == 0) & (idx == n // 2))

    sx = own(torch.arange(x0, x1, device=device), nx)
    sy = own(torch.arange(y_off, y_off + ny, device=device), ny_full)
    iz = torch.arange(nz // 2 + 1, device=device)
    sz = (iz == 0) | ((nz % 2 == 0) & (iz == nz // 2))
    return sx[:, None, None] & sy[None, :, None] & sz[None, None, :]


def kernel_block(tables, x0, x1):
    """float32 (kr, ki), each (M, x1 - x0, ny, nzh): K_i of x rows [x0, x1),
    the kernels' complex products rounded in their order."""
    nx, ny, _ = tables.shape
    t = tables.tab
    ex, ey, ez = t[:, x0:x1], t[:, nx:nx + ny], t[:, nx + ny:]
    exr, exi = ex[..., 0][:, :, None], ex[..., 1][:, :, None]
    eyr, eyi = ey[..., 0][:, None, :], ey[..., 1][:, None, :]
    xyr = exr * eyr - exi * eyi
    xyi = exr * eyi + exi * eyr
    ezr, ezi = ez[..., 0][:, None, None, :], ez[..., 1][:, None, None, :]
    kr = xyr[..., None] * ezr - xyi[..., None] * ezi
    ki = xyr[..., None] * ezi + xyi[..., None] * ezr
    sc = _self_conjugate(tables.shape, x0, x1, t.device, *tables.rows)
    return kr, torch.where(sc, 0.0, ki)


def _filter(tables, x0, x1, smoothing_length):
    """float32 exp(((-0.5 k^2) s) s) of x rows [x0, x1), or None at s = 0."""
    s = float(np.float32(smoothing_length))
    if s == 0.0:
        return None
    nx, ny, _ = tables.shape
    kv = tables.kvec
    kx, ky, kz = kv[x0:x1], kv[nx:nx + ny], kv[nx + ny:]
    k2 = ((kx * kx)[:, None, None] + (ky * ky)[None, :, None]
          + (kz * kz)[None, None, :])
    return torch.exp(((-0.5 * k2) * s) * s)


def sigma_eff2(sigmas, tables, x0, x1, smoothing_length):
    """float32 (sigma f)^2 of x rows [x0, x1), rounded as the kernel does."""
    se = sigmas[x0:x1]
    f = _filter(tables, x0, x1, smoothing_length)
    if f is not None:
        se = se * f
    return se * se


def measure_plain(re, im, tables, sigmas=None, smoothing_length=0.0):
    """:func:`measure` in plain PyTorch on the lattices' device."""
    nx, ny, nz = tables.shape
    m = tables.tab.shape[0]
    mult = _grid.kz_multiplicity(nz, re.device)
    out = torch.zeros(m, dtype=torch.float64, device=re.device)
    for x0 in range(0, nx, _X_CHUNK):
        x1 = min(nx, x0 + _X_CHUNK)
        cr, ci = re[x0:x1], im[x0:x1]
        if sigmas is not None:
            s = sigmas[x0:x1]
            f = _filter(tables, x0, x1, smoothing_length)
            cr, ci = cr * s, ci * s
            if f is not None:
                cr, ci = cr * f, ci * f
            re[x0:x1], im[x0:x1] = cr, ci
        kr, ki = kernel_block(tables, x0, x1)
        t = (cr.to(torch.float64) * kr.to(torch.float64)
             - ci.to(torch.float64) * ki.to(torch.float64)) * mult
        out += t.reshape(m, -1).sum(dim=1)
    return out


def launch_plan(correct, scale, nx, ny, nz, m):
    """(constraints a pass of the kernel takes, stages, blocks,
    shared-memory bytes) of a CORRECT (``correct``) or MEASURE call (with
    the scale when ``scale``) on (nx, ny, nz//2+1) lattices with ``m``
    constraints: all of them when their tables fit in shared memory, else
    the most that fit."""
    return _plan(bool(correct), bool(scale), int(nx), int(ny), int(nz),
                 int(m), _PASS_CAP)


@functools.lru_cache(maxsize=64)
def _plan(correct, scale, nx, ny, nz, m, cap):
    plan = (ctypes.c_int * 4)()
    status = _build.library().rf_constraint_plan(
        int(bool(correct)), int(bool(scale)), int(nx), int(ny), int(nz),
        int(m), int(cap), plan)
    _build.check(status, "constraint")
    return tuple(plan)


def _check(re, im, tables, name):
    nx, ny, nz = tables.shape
    want = (nx, ny, nz // 2 + 1)
    for t in (re, im):
        if t.dtype != torch.float32 or tuple(t.shape) != want:
            raise ValueError(f"{name}: re and im must be float32 {want}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    if tables.tab.device != re.device or im.device != re.device:
        raise ValueError(f"{name}: the lattices and tables share a device")
    if re.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cpu or cuda, not {re.device}")


def _sigmas(sigmas, re, name):
    if sigmas is None:
        return None
    if (sigmas.dtype != torch.float32 or sigmas.shape != re.shape
            or sigmas.device != re.device):
        raise ValueError(f"{name}: sigmas must be a float32 grid of the "
                         f"lattices' shape on their device")
    sigmas = sigmas.contiguous()
    # the kernel's bulk copies read 16-byte-aligned lattices
    return sigmas if sigmas.data_ptr() % 16 == 0 else sigmas.clone()


def _kernel_lattices(re, im, name):
    """Raise unless ``re`` and ``im`` are what the kernel updates in place:
    contiguous and 16-byte aligned."""
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{name}'s CUDA kernel needs contiguous lattices")
    if re.data_ptr() % 16 or im.data_ptr() % 16:
        raise ValueError(f"{name}'s CUDA kernel needs 16-byte-aligned "
                         f"lattices")


def measure(re, im, tables, sigmas=None, smoothing_length=0.0):
    """KC MEASURE: float64 (M,) Gamma_i = sum m_k Re(c_k K_i).

    ``re``/``im``: float32 (nx, ny, nz//2+1) lattices; with ``sigmas`` (the
    per-mode sigma grid) they are unit draws, first scaled IN PLACE by
    sigma f (f the filter of ``smoothing_length``), and Gamma is of the
    scaled spectrum.  On CUDA: one launch for any M; on the CPU
    :func:`measure_plain`.
    """
    global KC_LAUNCHES, KCS_LAUNCHES
    _check(re, im, tables, "measure")
    sigmas = _sigmas(sigmas, re, "measure")
    if re.device.type == "cpu":
        return measure_plain(re, im, tables, sigmas, smoothing_length)
    _kernel_lattices(re, im, "measure")
    nx, ny, nz = tables.shape
    m = tables.tab.shape[0]
    scale = sigmas is not None
    cb, _, blocks, _ = launch_plan(False, scale, nx, ny, nz, m)
    out = torch.empty(m, dtype=torch.float64, device=re.device)
    partials = torch.empty(blocks * _KERNEL_WARPS * m, dtype=torch.float64,
                           device=re.device)
    status = _build.library().rf_constraint_measure(
        re.data_ptr(), im.data_ptr(), sigmas.data_ptr() if scale else 0,
        tables.kvec.data_ptr(), tables.tab.data_ptr(), out.data_ptr(),
        partials.data_ptr(), nx, ny, nz, m, cb, blocks,
        float(np.float32(smoothing_length)), int(scale), *tables.rows,
        _build.current_stream(re))
    _build.check(status, "measure")
    if tables.ny_full:
        KCS_LAUNCHES += 1
    else:
        KC_LAUNCHES += 1
    return out


def correct_plain(re, im, tables, alpha, sigmas, smoothing_length=0.0):
    """:func:`correct` in plain PyTorch on the lattices' device, the
    kernel's float32 operations in its order."""
    nx = tables.shape[0]
    a = [float(v) for v in np.asarray(alpha, np.float32)]
    for x0 in range(0, nx, _X_CHUNK):
        x1 = min(nx, x0 + _X_CHUNK)
        kr, ki = kernel_block(tables, x0, x1)
        ar = torch.zeros_like(kr[0])
        ai = torch.zeros_like(ki[0])
        for i, v in enumerate(a):
            ar = ar + v * kr[i]
            ai = ai + v * ki[i]
        se2 = sigma_eff2(sigmas, tables, x0, x1, smoothing_length)
        re[x0:x1] = re[x0:x1] + se2 * ar
        im[x0:x1] = im[x0:x1] - se2 * ai
    return re, im


def correct(re, im, tables, alpha, sigmas, smoothing_length=0.0):
    """KC CORRECT: c += (sigma f)^2 sum_i alpha_i conj(K_i), IN PLACE.

    ``alpha``: the M coefficients (rounded to float32); ``sigmas``: the
    per-mode sigma grid.  On CUDA one launch for any M; on the CPU
    :func:`correct_plain`.  Returns (re, im).
    """
    global KC_LAUNCHES, KCS_LAUNCHES
    _check(re, im, tables, "correct")
    sigmas = _sigmas(sigmas, re, "correct")
    if sigmas is None:
        raise ValueError("correct: needs the sigma grid")
    alpha = np.asarray(alpha, np.float32).reshape(-1)
    if alpha.size != tables.tab.shape[0]:
        raise ValueError(f"correct: {alpha.size} coefficients for "
                         f"{tables.tab.shape[0]} constraints")
    if re.device.type == "cpu":
        return correct_plain(re, im, tables, alpha, sigmas, smoothing_length)
    _kernel_lattices(re, im, "correct")
    nx, ny, nz = tables.shape
    cb, _, blocks, _ = launch_plan(True, True, nx, ny, nz, alpha.size)
    a = torch.as_tensor(alpha, device=re.device)
    # the alpha sums of every mode between the kernel's passes
    carry = (torch.empty(re.shape + (2,), dtype=torch.float32,
                         device=re.device) if cb < alpha.size else None)
    status = _build.library().rf_constraint_correct(
        re.data_ptr(), im.data_ptr(), sigmas.data_ptr(),
        tables.kvec.data_ptr(), tables.tab.data_ptr(), a.data_ptr(),
        carry.data_ptr() if carry is not None else 0, nx, ny, nz, alpha.size,
        cb, blocks, float(np.float32(smoothing_length)), *tables.rows,
        _build.current_stream(re))
    _build.check(status, "correct")
    if tables.ny_full:
        KCS_LAUNCHES += 1
    else:
        KC_LAUNCHES += 1
    return re, im


def gram(tables, sigmas, smoothing_length=0.0):
    """float64 (M, M) xi_ij = sum m_k (sigma f)^2 Re(K_i K_j*): float64
    matmuls over x-slabs of :func:`kernel_block`'s float32 K on the sigma
    grid's device, with the kernels' float32 (sigma f)^2."""
    nx, ny, nz = tables.shape
    m = tables.tab.shape[0]
    mult = _grid.kz_multiplicity(nz, sigmas.device)
    out = torch.zeros((m, m), dtype=torch.float64, device=sigmas.device)
    for x0 in range(0, nx, _X_CHUNK):
        x1 = min(nx, x0 + _X_CHUNK)
        kr, ki = kernel_block(tables, x0, x1)
        w = (sigma_eff2(sigmas, tables, x0, x1, smoothing_length)
             .to(torch.float64) * mult).reshape(-1)
        for k in (kr, ki):
            k = k.reshape(m, -1).to(torch.float64)
            out += (k * w) @ k.T
    return out
