"""K10: sampling fused into the x transform, the staged v6 render's entry.

Counterpart of ``randomfield_tpu/ops/pallas_genfft.py``.  :func:`sample_fftx`
returns the seed's sampled half-spectrum with the x axis ALREADY inverse
transformed, as two float32 lattices (nzh * ny, nx): row ``kz * ny + y``
holds the unnormalized inverse x-FFT of that x-line, in natural order.  The
sampler's spectrum write, the x pass's read and the x pass's write of the
default render become one write.

* Bulk rows (0 < kz < nz/2) are drawn inside the kernel
  (``csrc/sample_fftx.cu``): per mode two 32-bit words -> 24-bit uniforms ->
  Box-Muller -> sigma(|k|) / sqrt(2) and the Gaussian filter, the fused
  sampler's arithmetic (:mod:`.sampler`).
* The kz = 0 and Nyquist planes, whose Hermitian pairing spans the whole
  plane, are prepared by :func:`plane_spectra` in plain PyTorch (an O(nx ny)
  job) and pass through the kernel's transform as an input.

The stream.  The TPU kernel seeds its hardware PRNG per row block; no other
device can replay it (its interpreter yields zero bits).  The port's v6
stream is counter-based, like :mod:`.modestream`'s: the bulk draws are
Threefry-2x32 under ``fold_in(key_from_seed(seed & 0x7FFFFFFF), GENFFT_TAG)``
of the 64-bit flat index ``i = (kz ny + y) nx + x`` as the words
``(i >> 32, i & 0xFFFFFFFF)``; the two output words are the mode's
Box-Muller bits.  The planes are, as in the JAX package,
``normal(fold_in(key_from_seed(seed & 0x7FFFFFFF), PLANE_TAG), (2, 2, ny,
nx))``, the same numbers as JAX's at the same seed.  A v6 render is
therefore its own deterministic realization family (:data:`STREAM`),
different from the default render's at the same seed, as in the JAX
package.

On CUDA tensors :func:`sample_fftx` launches the kernel or raises; on CPU
tensors it runs :func:`seeded_fftx_plain`.  The launch count is
``K10_LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import fft as _fft
from randomfield_tpu_torch.ops import modestream as _modestream
from randomfield_tpu_torch.ops import sampler as _sampler
from randomfield_tpu_torch.ops import threefry as _threefry
from randomfield_tpu_torch.ops import transform as _transform

__all__ = [
    "STREAM",
    "GENFFT_TAG",
    "PLANE_TAG",
    "can_genfft",
    "genfft_key",
    "genfft_bits",
    "plane_spectra",
    "sample_fftx",
    "sample_fftx_plain",
    "sample_fftx_emulated",
    "kernel_attributes",
    "seeded_fftx_plain",
    "K10_LAUNCHES",
]

# the v6 stream's name, as pallas_genfft.STREAM names the TPU's
STREAM = "zyx-genfft-threefry2x32-v1"
# fold_in tags of the bulk stream and of the planes' normals (the JAX
# package's plane tag); both differ from modestream.STREAM_TAG and, being
# at least 2^31, from every canonical-stream chunk index
GENFFT_TAG = 0xD1B54A33
PLANE_TAG = 0x9E3779B9
_MASK = 0xFFFFFFFF

# kernel launches by sample_fftx (the CPU path does not count)
K10_LAUNCHES = 0

# kz rows per step of the plain version (bounds its temporaries)
_PLAIN_KZ_CHUNK = 16


def can_genfft(shape) -> bool:
    """True when the CUDA kernel takes this grid: nx a power of two in
    [16, 2048] (:func:`.fft.kernel_length_ok`) and nz even.

    The port's kernel's rule, not the TPU kernel's (nx = A * 128, ny a
    multiple of 128).  On CPU tensors :func:`sample_fftx` takes any grid
    with even nz.
    """
    nx, ny, nz = shape
    return _fft.kernel_length_ok(nx) and nz % 2 == 0


def genfft_key(seed: int) -> tuple[int, int]:
    """The Threefry key of ``seed``'s bulk stream, as two uint32 ints."""
    base = _threefry.key_from_seed(int(seed) & _modestream.SEED_MASK)
    return _threefry.fold_in(base, GENFFT_TAG)


def genfft_bits(key, shape, kz_off=0, nkz=None, device="cpu"):
    """``(b1, b2)`` of the modes of kz rows [kz_off, kz_off + nkz).

    Int64 tensors of uint32 values, shaped (nkz, ny, nx): the Threefry-2x32
    hash under ``key`` of each mode's flat index ``(kz ny + y) nx + x`` in
    the (nzh, ny, nx) output.  Plane rows get bits too; nothing uses them.
    """
    nx, ny, nz = shape
    nkz = nz // 2 + 1 - kz_off if nkz is None else nkz
    first, count = kz_off * ny * nx, nkz * ny * nx
    idx = torch.arange(first, first + count, dtype=torch.int64, device=device)
    b1, b2 = _threefry.threefry2x32(key, idx >> 32, idx & _MASK)
    return b1.view(nkz, ny, nx), b2.view(nkz, ny, nx)


def _check_shape(shape, name):
    nx, ny, nz = shape
    if nz % 2:
        raise ValueError(f"{name}: nz={nz} must be even (the Nyquist plane "
                         f"is one of the two loaded planes)")


def plane_spectra(seed, table, shape, spacing, smoothing_length=0.0):
    """Symmetrized (2 ny, nx) re/im spectra of the kz = 0 / Nyquist planes.

    Rows [0, ny) are the kz = 0 plane and rows [ny, 2 ny) the kz = nz/2
    plane, row-major (y, x) as K10's (kz, y) rows.  Threefry normals of the
    seed (the JAX package's, bit for bit in the bits and to a few ulps in
    the normals) times sigma(|k|) by the table's interpolation, the
    Gaussian filter and 1/sqrt(2), then the Hermitian plane fix
    (:func:`.transform.symmetrize_plane_reim`), in the float32 order of
    ``pallas_genfft.plane_spectra``.  On the table's device.
    """
    _check_shape(shape, "plane_spectra")
    nx, ny, nz = shape
    dev = table.knots.device
    key = _threefry.fold_in(
        _threefry.key_from_seed(int(seed) & _modestream.SEED_MASK), PLANE_TAG)
    draws = _threefry.normal(key, (2, 2, ny, nx), dev)
    c = _sampler._constants(table, shape, spacing)
    ky = _sampler._signed(torch.arange(ny, device=dev), ny).to(torch.float32)
    ky = ky * float(c["ky_scale"])
    kx = _sampler._signed(torch.arange(nx, device=dev), nx).to(torch.float32)
    kx = kx * float(c["kx_scale"])
    # the Nyquist kz in float64, rounded once, as the JAX package rounds it
    kzv = torch.tensor([0.0, (2.0 * np.pi / float(spacing) / nz) * (nz // 2)],
                       dtype=torch.float32, device=dev)
    ksq = ((kzv * kzv)[:, None, None] + (ky * ky)[None, :, None]
           + (kx * kx)[None, None, :])
    _, sig = _sampler._interp_sigma(table.knots, ksq, c)
    s = float(np.float32(smoothing_length))
    amp = sig * torch.exp(-0.5 * ksq * s * s) * float(_sampler._INV_SQRT2)
    planes = [_transform.symmetrize_plane_reim(amp[p] * draws[0, p],
                                               amp[p] * draws[1, p], True)
              for p in range(2)]
    return (torch.cat([planes[0][0], planes[1][0]]),
            torch.cat([planes[0][1], planes[1][1]]))


def _check_planes(pre, pim, shape, dev):
    nx, ny, nz = shape
    for t in (pre, pim):
        if (tuple(t.shape) != (2 * ny, nx) or t.dtype != torch.float32
                or t.device != dev or not t.is_contiguous()):
            raise ValueError(f"pre/pim must be contiguous float32 "
                             f"({2 * ny}, {nx}) planes on {dev}")


def _check_bits(b1, b2, shape, kz_off, name):
    nx, ny, nz = shape
    if (b1.shape != b2.shape or tuple(b1.shape[1:]) != (ny, nx)
            or b1.dtype != torch.int64 or b2.dtype != torch.int64
            or not 0 <= kz_off <= nz // 2 + 1 - b1.shape[0]):
        raise ValueError(f"{name}: b1/b2 must be equal int64 (nkz, {ny}, {nx}) "
                         f"blocks of kz rows inside the grid {shape}, got "
                         f"{tuple(b1.shape)} {b1.dtype} at kz {kz_off}")


def _drawn_lines(b1, b2, pre, pim, table, shape, spacing, smoothing_length,
                 kz_off, xs):
    """The sampled spectrum of kz rows [kz_off, kz_off + nkz) at the x
    indices ``xs`` (any int64 tensor of them): float32 (re, im) shaped
    (nkz, ny, *xs.shape), bulk rows drawn from the bits in
    ``csrc/sample_fftx.cu``'s order of float32 operations, plane rows
    taken from ``pre``/``pim``."""
    nx, ny, nz = shape
    dev = b1.device
    nkz = b1.shape[0]
    c = _sampler._constants(table, shape, spacing)
    kx = _sampler._signed(xs.to(dev), nx).to(torch.float32)
    kx = kx * float(c["kx_scale"])
    ky = _sampler._signed(torch.arange(ny, device=dev), ny).to(torch.float32)
    ky = ky * float(c["ky_scale"])
    kz = torch.arange(kz_off, kz_off + nkz, device=dev).to(torch.float32)
    kz = kz * float(c["kz_scale"])
    lead = (1,) * xs.dim()
    ksq = (kx * kx)[None, None] + (ky * ky).view(1, ny, *lead)
    ksq = ksq + (kz * kz).view(nkz, 1, *lead)
    _, sig = _sampler._interp_sigma(table.knots, ksq, c)
    flat = xs.to(dev).reshape(-1)
    u1, u2 = _sampler._uniforms(b1[..., flat].view(nkz, ny, *xs.shape),
                                b2[..., flat].view(nkz, ny, *xs.shape))
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = float(_sampler._TWO_PI32) * u2
    amp = sig * float(_sampler._INV_SQRT2)
    re = amp * (r * torch.cos(theta))
    im = amp * (r * torch.sin(theta))
    s = float(np.float32(smoothing_length))
    if s != 0.0:
        filt = torch.exp(-0.5 * ksq * s * s)
        re, im = re * filt, im * filt
    for kzi, rows in ((0, slice(0, ny)), (nz // 2, slice(ny, 2 * ny))):
        if kz_off <= kzi < kz_off + nkz:
            re[kzi - kz_off] = pre[rows][:, flat].view(ny, *xs.shape)
            im[kzi - kz_off] = pim[rows][:, flat].view(ny, *xs.shape)
    return re, im


def sample_fftx_plain(b1, b2, pre, pim, table, shape, spacing,
                      smoothing_length=0.0, kz_off=0):
    """K10 in plain PyTorch on given bits, any device.

    ``b1``/``b2``: int64 tensors of uint32 values shaped (nkz, ny, nx), the
    bits of the modes of kz rows [kz_off, kz_off + nkz); ``pre``/``pim``:
    :func:`plane_spectra`'s (2 ny, nx) planes, which replace the kz = 0 and
    kz = nz/2 rows.  Returns float32 (re, im) shaped (nkz * ny, nx): the
    float32 operations of ``csrc/sample_fftx.cu`` (and of the TPU kernel)
    in their order, then ``torch.fft.ifft(norm='forward')`` along x.
    """
    _check_shape(shape, "sample_fftx_plain")
    nx, ny, nz = shape
    _check_bits(b1, b2, shape, kz_off, "sample_fftx_plain")
    _check_planes(pre, pim, shape, b1.device)
    re, im = _drawn_lines(b1, b2, pre, pim, table, shape, spacing,
                          smoothing_length, kz_off, torch.arange(nx))
    out = torch.fft.ifft(torch.complex(re, im), dim=-1, norm="forward")
    return (out.real.reshape(-1, nx).contiguous(),
            out.imag.reshape(-1, nx).contiguous())


def sample_fftx_emulated(b1, b2, pre, pim, table, shape, spacing,
                         smoothing_length=0.0, kz_off=0):
    """K10's data flow on the kernel core, in plain PyTorch (for the
    tests, like :func:`.fft.stockham_emulated`; no entry point calls it).

    Takes and returns what :func:`sample_fftx_plain` does.  As
    ``csrc/sample_fftx.cu``: of the T = nx / E threads of a line (E the
    first radix of :func:`.fft.radix_plan`), thread t draws the elements
    x = t + k T, k < E, into its registers v[k]; the register-radix passes
    (:func:`.fft.stockham_emulated`, the same plan and tables) leave
    X[t + k T] in v[k], which is stored at column t + k T of the line's row.
    """
    _check_shape(shape, "sample_fftx_emulated")
    nx, ny, nz = shape
    _check_bits(b1, b2, shape, kz_off, "sample_fftx_emulated")
    _check_planes(pre, pim, shape, b1.device)
    e = _fft.radix_plan(nx)[0]
    t = nx // e
    xs = torch.arange(t)[:, None] + t * torch.arange(e)[None, :]  # [t, k]
    re, im = _drawn_lines(b1, b2, pre, pim, table, shape, spacing,
                          smoothing_length, kz_off, xs)
    v = torch.complex(re, im)  # (nkz, ny, T, E): each thread's registers
    # the first pass reads v[k] of thread t as element t + k T of the line
    line = v.transpose(-1, -2).reshape(*v.shape[:2], nx)
    out = _fft.stockham_emulated(line, +1)
    v = out.reshape(*v.shape[:2], e, t).transpose(-1, -2)  # v[k] = X[t + k T]
    store = torch.empty_like(out)
    store[..., xs.reshape(-1).to(out.device)] = v.reshape(*v.shape[:2], nx)
    return (store.real.reshape(-1, nx).contiguous(),
            store.imag.reshape(-1, nx).contiguous())


def kernel_attributes(nx: int, n_knots: int):
    """(registers a thread, blocks an SM holds, threads a block, dynamic
    shared-memory bytes) of K10's instance for an nx-point line and a
    table of ``n_knots`` knots, as :func:`.fft.kernel_attributes` reports
    the FFT kernels'; builds the library."""
    out = [ctypes.c_int() for _ in range(4)]
    status = _build.library().rf_sample_fftx_attributes(
        int(nx), *_fft._plan3(nx), int(n_knots),
        *[ctypes.byref(v) for v in out])
    _build.check(status, "sample_fftx attributes")
    return tuple(v.value for v in out)


def seeded_fftx_plain(seed, table, shape, spacing, smoothing_length=0.0,
                      planes=None):
    """K10's function in plain PyTorch: :func:`sample_fftx_plain` on the
    seed's stream (:func:`genfft_bits`) and planes (:func:`plane_spectra`,
    unless given), a few kz rows at a time on the table's device."""
    _check_shape(shape, "seeded_fftx_plain")
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    dev = table.knots.device
    pre, pim = planes if planes is not None else plane_spectra(
        seed, table, shape, spacing, smoothing_length)
    key = genfft_key(seed)
    re = torch.empty((nzh * ny, nx), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    for z0 in range(0, nzh, _PLAIN_KZ_CHUNK):
        n = min(_PLAIN_KZ_CHUNK, nzh - z0)
        b1, b2 = genfft_bits(key, shape, z0, n, dev)
        rows = slice(z0 * ny, (z0 + n) * ny)
        re[rows], im[rows] = sample_fftx_plain(
            b1, b2, pre, pim, table, shape, spacing, smoothing_length, z0)
    return re, im


def sample_fftx(seed, table, shape, spacing, smoothing_length=0.0,
                planes=None):
    """K10: the seed's v6 spectrum with the x axis already inverse
    transformed.

    Returns float32 (re, im) lattices (nzh * ny, nx) on the table's device:
    rows are (kz, y) pairs, and each holds the unnormalized inverse FFT
    along x, in natural order, of that line of the sampled spectrum (bulk
    rows drawn from the stream :data:`STREAM`, plane rows from
    :func:`plane_spectra`; ``planes`` passes that function's result in when
    the caller has it).  The same as sampling, then an x pass of
    :func:`.fft.ifft_axis`, in one write of device memory.  On CUDA this
    launches ``csrc/sample_fftx.cu`` and needs :func:`can_genfft`; on the
    CPU it runs :func:`seeded_fftx_plain`.
    """
    global K10_LAUNCHES
    dev = _sampler._check_table(table, "sample_fftx")
    shape = tuple(int(n) for n in shape)
    _check_shape(shape, "sample_fftx")
    if dev.type == "cpu":
        return seeded_fftx_plain(seed, table, shape, spacing,
                                 smoothing_length, planes)
    if not can_genfft(shape):
        raise ValueError(f"sample_fftx: grid {shape} unsupported on CUDA "
                         f"(need nx a power of two in [{_fft.MIN_LENGTH}, "
                         f"{_fft.MAX_LENGTH}] and even nz)")
    nx, ny, nz = shape
    pre, pim = planes if planes is not None else plane_spectra(
        seed, table, shape, spacing, smoothing_length)
    _check_planes(pre, pim, shape, dev)
    re = torch.empty(((nz // 2 + 1) * ny, nx), dtype=torch.float32, device=dev)
    im = torch.empty_like(re)
    c = _sampler._constants(table, shape, spacing)
    k0, k1 = genfft_key(seed)
    status = _build.library().rf_sample_fftx(
        re.data_ptr(), im.data_ptr(), pre.data_ptr(), pim.data_ptr(),
        table.knots.data_ptr(), table.knots.numel(),
        _fft.pass_twiddles(nx, +1, str(dev)).data_ptr(), nx, ny, nz,
        *_fft._plan3(nx), k0, k1,
        float(c["kx_scale"]), float(c["ky_scale"]), float(c["kz_scale"]),
        float(_sampler._HALF_INV_LN10), float(c["lk0"]), float(c["inv_dlk"]),
        float(np.float32(smoothing_length)), _build.current_stream(re),
    )
    _build.check(status, "sample_fftx")
    K10_LAUNCHES += 1
    return re, im
