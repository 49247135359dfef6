"""The hand FFT kernels: axis FFT (K3), c2r tail (K4), r2c head (K6) and
the rotating axis FFT (K9).

Counterpart of ``randomfield_tpu/ops/pallas_fft.py``.  A render's inverse
3-D c2r runs as two passes of :func:`ifft_axis` (x, then y) over the packed
(nx, ny, nzh) re/im spectrum, in place, and one :func:`c2r_tail` along kz
that also applies the per-plane lightcone weights and writes the field.
The distributed forward transform (:mod:`..parallel.dfft`) is the reverse:
:func:`r2c_head` along z, then :func:`fft_axis` along y and x.  The staged
v4 render (:mod:`..engine.staged`) runs its x and y passes as two
:func:`ifft_rotate` calls instead, each of which writes its output with the
transformed axis minor.

On CUDA tensors the wrappers launch the hand kernels built from
``csrc/fft_axis.cu`` (both directions), ``csrc/c2r_tail.cu``,
``csrc/r2c_head.cu`` and ``csrc/fft_rotate.cu``; on CPU tensors they run the
plain PyTorch versions beside them (``torch.fft``).  Launch counts are
``K3_LAUNCHES``, ``K4_LAUNCHES``, ``K6_LAUNCHES`` and ``K9_LAUNCHES``.
:func:`c2r_tail_exp` (K4L, counter ``K4L_LAUNCHES``) is K4's kernel with
the lognormal exp map as its last step.

The kernels take power-of-two transform lengths from 16 to 2048
(:func:`kernel_length_ok`); a mixed-radix version is a later step.

All four run on the register-radix Stockham core of ``csrc/fft_radix.cuh``:
:func:`radix_plan` is the one place where a length is split into passes,
:func:`pass_twiddles` builds the per-pass tables the launchers hand the
kernels, and :func:`stockham_emulated` replays the kernel's passes on plain
tensors from the same plan and tables; :func:`axis_emulated`,
:func:`c2r_tail_emulated`, :func:`r2c_head_emulated` and
:func:`ifft_rotate_emulated` compose it with each kernel's own algebra (for
the CPU tests; no entry point calls them).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build

__all__ = [
    "ifft_axis",
    "ifft_axis_plain",
    "fft_axis",
    "fft_axis_plain",
    "c2r_tail",
    "c2r_tail_plain",
    "c2r_tail_exp",
    "c2r_tail_exp_plain",
    "r2c_head",
    "r2c_head_plain",
    "ifft_rotate",
    "ifft_rotate_plain",
    "kernel_length_ok",
    "radix_plan",
    "pass_twiddles",
    "rotate_panel",
    "kernel_attributes",
    "stockham_emulated",
    "axis_emulated",
    "c2r_tail_emulated",
    "r2c_head_emulated",
    "ifft_rotate_emulated",
    "K3_LAUNCHES",
    "K4_LAUNCHES",
    "K6_LAUNCHES",
    "K9_LAUNCHES",
    "K4L_LAUNCHES",
]

# kernel launches by ifft_axis and fft_axis / c2r_tail / r2c_head /
# ifft_rotate (the CPU paths do not count)
K3_LAUNCHES = 0
K4_LAUNCHES = 0
K6_LAUNCHES = 0
K9_LAUNCHES = 0
K4L_LAUNCHES = 0  # c2r_tail_exp

MIN_LENGTH, MAX_LENGTH = 16, 2048
_MAX_OUTER = 65535  # the kernels' grid.y


def kernel_length_ok(n: int) -> bool:
    """True for the transform lengths the kernels take: 2^k, 16..2048."""
    return MIN_LENGTH <= n <= MAX_LENGTH and n & (n - 1) == 0


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, count: int, device: str) -> torch.Tensor:
    """float32 pairs (cos, sin)(2 pi k / n), k < count, built in float64."""
    theta = 2.0 * np.pi * np.arange(count) / n
    tw = np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)
    return torch.as_tensor(tw, device=device)


# ---- the register-radix Stockham core (K3, K4, K6, K9) -----------------------

def radix_plan(n: int) -> tuple[int, ...]:
    """The radices of the passes of an n-point transform, first pass first.

    n = 2^k, 16..2048.  Two or three passes of radix 4, 8 or 16, so that a
    thread's butterfly fits its registers: the first pass takes radix 16
    whenever the rest still fills a pass (n >= 128), which makes every
    later exchange write runs of at least 16 consecutive elements (no
    shared-memory bank conflict); the remaining bits are split as evenly as
    they go, the larger radix first.  16 = 4*4, 32 = 8*4, 64 = 8*8, 128 =
    16*8, 256 = 16*16, 512 = 16*8*4, 1024 = 16*8*8, 2048 = 16*16*8.  A
    thread holds E = plan[0] elements (every radix divides it) and n / E
    threads share a line.
    """
    if not kernel_length_ok(n):
        raise ValueError(f"radix_plan: n={n} is not a power of two in "
                         f"[{MIN_LENGTH}, {MAX_LENGTH}]")
    bits = n.bit_length() - 1
    first = []
    if bits >= 7:
        first, bits = [4], bits - 4
    passes = max(1 if first else 2, -(-bits // 4))
    q, r = divmod(bits, passes)
    return tuple(1 << b for b in first + [q + 1] * r + [q] * (passes - r))


def _plan3(n: int) -> tuple[int, int, int]:
    """radix_plan(n) as the three integers the C entries take (1 = no pass)."""
    plan = radix_plan(n)
    return (*plan, 1)[:3]


def rotate_panel(n: int) -> int:
    """The columns a K9 or K3 block owns: 256 threads' worth of lines and
    at least 8 (32-byte segments of the strided load); 16 at n = 1024,
    where one 1024-thread block an SM measured faster on an H100 than two of
    8 columns (K9: 3.4 against 3.9 ms a 1024^3 pass; at 512 points, where
    both fit twice, 8 and 16 columns measured alike).  The library holds
    this one instance a length (K3: one a length and sign), and K3 the
    same rule: at 1024 points 8 columns measured 5.45 against 3.48 ms a
    1024^3 x pass."""
    if n == 1024:
        return 16
    return max(8, 256 * radix_plan(n)[0] // n)


def kernel_attributes(kernel: str, n: int, sign: int = +1):
    """(registers a thread, blocks an SM holds, threads a block, dynamic
    shared-memory bytes) of the ``'fft_axis'`` (of ``sign``), ``'c2r_tail'``,
    ``'c2r_tail_exp'``, ``'r2c_head'`` or ``'ifft_rotate'`` instance for an n-point plan (K4 and
    K6: m = nz / 2 points), as ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` report them; builds
    the library."""
    out = [ctypes.c_int() for _ in range(4)]
    refs = [ctypes.byref(v) for v in out]
    lib = _build.library()
    if kernel == "fft_axis":
        status = lib.rf_fft_axis_attributes(
            int(sign), int(n), *_plan3(n), rotate_panel(n), *refs)
    elif kernel in ("c2r_tail", "c2r_tail_exp"):
        status = lib.rf_c2r_tail_attributes(
            int(kernel == "c2r_tail_exp"), int(n), *_plan3(n), *refs)
    elif kernel == "r2c_head":
        status = lib.rf_r2c_head_attributes(int(n), *_plan3(n), *refs)
    elif kernel == "ifft_rotate":
        status = lib.rf_fft_rotate_attributes(
            int(n), *_plan3(n), rotate_panel(n), *refs)
    else:
        raise ValueError(f"kernel_attributes: no kernel {kernel!r}")
    _build.check(status, f"{kernel} attributes")
    return tuple(v.value for v in out)


@functools.lru_cache(maxsize=None)
def pass_twiddles(n: int, sign: int, device: str) -> torch.Tensor:
    """The twiddle tables of the passes after the first, back to back.

    The pass of radix R that follows Ns = (product of the earlier radices)
    points multiplies input r of the butterfly at j by exp(sign 2 pi i r
    (j mod Ns) / (Ns R)); its table holds that at [(r - 1) Ns + (j mod
    Ns)], r = 1..R-1, so the threads of a warp (consecutive j) read
    consecutive entries for each r.  float32 (cos, sin) pairs built in
    float64; the first pass (Ns = 1) has none.
    """
    plan = radix_plan(n)
    tables, ns = [], plan[0]
    for radix in plan[1:]:
        r = np.arange(1, radix)[:, None]
        k = np.arange(ns)[None, :]
        theta = sign * 2.0 * np.pi * (r * k) / (ns * radix)
        tables.append(np.stack([np.cos(theta), np.sin(theta)], axis=-1)
                      .reshape(-1, 2))
        ns *= radix
    return torch.as_tensor(np.concatenate(tables).astype(np.float32),
                           device=device)


def _root16(k: int, sign: int) -> complex:
    return complex(np.float32(np.cos(np.pi * k / 8)),
                   sign * np.float32(np.sin(np.pi * k / 8)))


def _dft_registers(a, sign):
    """The kernel's R-point butterfly (R = 4, 8, 16) along axis -2 of a
    complex64 tensor, step by step as ``rf::dft`` does it: A = R / 4
    four-point transforms, the constant twiddles, four A-point transforms,
    natural order out."""
    radix = a.shape[-2]
    A = radix // 4
    w = 1j * sign

    def dft4(v0, v1, v2, v3):
        a0, a1, b0, b1 = v0 + v2, v0 - v2, v1 + v3, (v1 - v3) * w
        return a0 + b0, a1 + b1, a0 - b0, a1 - b1

    a = list(a.unbind(-2))
    for n1 in range(A):
        a[n1::A] = dft4(*a[n1::A])
    if A == 1:
        return torch.stack(a, -2)
    for n1 in range(1, A):
        for k2 in range(1, 4):
            a[n1 + A * k2] = a[n1 + A * k2] * _root16(n1 * k2 * (16 // radix), sign)
    out = [None] * radix
    for k2 in range(4):
        part = a[A * k2:A * k2 + A]
        part = (part[0] + part[1], part[0] - part[1]) if A == 2 else dft4(*part)
        for k1 in range(A):
            out[4 * k1 + k2] = part[k1]
    return torch.stack(out, -2)


def stockham_emulated(x: torch.Tensor, sign: int) -> torch.Tensor:
    """The kernel core's passes on a plain complex64 tensor (..., n).

    The Stockham self-sorting transform of ``csrc/fft_radix.cuh`` from the
    same :func:`radix_plan` and the same :func:`pass_twiddles` tables: the
    pass of radix R after Ns points reads element j + r n/R as input r of
    butterfly j < n/R, multiplies by the table, transforms R points and
    writes output r to (j - j mod Ns) R + j mod Ns + r Ns.  Natural order
    in and out, no bit reversal; X[j] = sum_k x[k] exp(sign 2 pi i jk/n).
    Used by the tests of the algebra, by no entry point.
    """
    n = x.shape[-1]
    plan = radix_plan(n)
    table = pass_twiddles(n, int(sign), "cpu")
    table = torch.complex(table[:, 0], table[:, 1]).to(x.device)
    x = x.to(torch.complex64)
    ns, offset = 1, 0
    for radix in plan:
        j = torch.arange(n // radix, device=x.device)
        k = j % ns
        a = x.reshape(*x.shape[:-1], radix, n // radix)  # [r, j] = x[j + r n/R]
        if ns > 1:
            tw = table[offset:offset + (radix - 1) * ns].view(radix - 1, ns)
            a = torch.cat([a[..., :1, :], a[..., 1:, :] * tw[:, k]], dim=-2)
            offset += (radix - 1) * ns
        a = _dft_registers(a, sign)
        dest = ((j - k) * radix + k)[None, :] + ns * torch.arange(
            radix, device=x.device)[:, None]
        out = torch.empty_like(x)
        out[..., dest.reshape(-1)] = a.reshape(*x.shape[:-1], n)
        x, ns = out, ns * radix
    return x


def _check_pair(re, im, name):
    if re.dtype != torch.float32 or im.dtype != torch.float32:
        raise ValueError(f"{name}: re and im must be float32")
    if re.shape != im.shape or re.device != im.device:
        raise ValueError(f"{name}: re and im must share shape and device")


def _view3(re, outer, n, inner, name):
    if re.numel() != outer * n * inner:
        raise ValueError(f"{name}: {tuple(re.shape)} is not an "
                         f"({outer}, {n}, {inner}) view")
    return re.view(outer, n, inner)


# ---- K3 --------------------------------------------------------------------

def _axis_plain(re, im, outer, n, inner, transform, name):
    c = torch.complex(_view3(re, outer, n, inner, name),
                      _view3(im, outer, n, inner, name))
    out = transform(c, dim=1)
    re.view(outer, n, inner).copy_(out.real)
    im.view(outer, n, inner).copy_(out.imag)
    return re, im


def ifft_axis_plain(re, im, outer, n, inner):
    """K3 in plain PyTorch: ``torch.fft.ifft(norm='forward')`` along the
    middle axis of the (outer, n, inner) view, written back in place."""
    return _axis_plain(re, im, outer, n, inner,
                       lambda c, dim: torch.fft.ifft(c, dim=dim, norm="forward"),
                       "ifft_axis")


def fft_axis_plain(re, im, outer, n, inner):
    """Forward K3 in plain PyTorch: ``torch.fft.fft`` (no scaling) along
    the middle axis of the (outer, n, inner) view, written back in place."""
    return _axis_plain(re, im, outer, n, inner, torch.fft.fft, "fft_axis")


def axis_emulated(re, im, outer, n, inner, sign):
    """K3's function with the kernel core's passes
    (:func:`stockham_emulated`) as the transform, written back in place;
    for the tests, like it."""
    c = torch.complex(_view3(re, outer, n, inner, "axis_emulated"),
                      _view3(im, outer, n, inner, "axis_emulated"))
    out = stockham_emulated(c.transpose(1, 2), sign).transpose(1, 2)
    re.view(outer, n, inner).copy_(out.real)
    im.view(outer, n, inner).copy_(out.imag)
    return re, im


def ifft_axis(re, im, outer, n, inner):
    """K3: unnormalized inverse complex FFT along the middle axis, IN PLACE.

    ``re``/``im``: contiguous float32 tensors viewed as (outer, n, inner);
    X[j] = sum_k x[k] exp(+2 pi i jk/n), natural order.  A render's x pass
    is (1, nx, ny*nzh) and its y pass (nx, ny, nzh).  CUDA tensors need
    ``kernel_length_ok(n)`` and outer <= 65535; CPU tensors run
    :func:`ifft_axis_plain`.  Returns (re, im).
    """
    return _axis(re, im, outer, n, inner, +1)


def fft_axis(re, im, outer, n, inner):
    """K3 forward: X[j] = sum_k x[k] exp(-2 pi i jk/n), IN PLACE.

    :func:`ifft_axis` with the other sign (the kernel's instance for it,
    with the forward tables); CPU tensors run :func:`fft_axis_plain`.
    Returns (re, im).
    """
    return _axis(re, im, outer, n, inner, -1)


def _axis(re, im, outer, n, inner, sign):
    global K3_LAUNCHES
    name = "ifft_axis" if sign > 0 else "fft_axis"
    _check_pair(re, im, name)
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError(f"{name} transforms contiguous tensors in place")
    _view3(re, outer, n, inner, name)
    if re.device.type == "cpu":
        plain = ifft_axis_plain if sign > 0 else fft_axis_plain
        return plain(re, im, outer, n, inner)
    if re.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {re.device}")
    if not kernel_length_ok(n):
        raise ValueError(f"{name}: n={n} unsupported on CUDA (need a "
                         f"power of two in [{MIN_LENGTH}, {MAX_LENGTH}])")
    if outer > _MAX_OUTER:
        raise ValueError(f"{name}: outer={outer} > {_MAX_OUTER}")
    status = _build.library().rf_fft_axis(
        re.data_ptr(), im.data_ptr(),
        pass_twiddles(n, sign, str(re.device)).data_ptr(), int(sign),
        int(outer), int(n), int(inner), *_plan3(n), rotate_panel(n),
        _build.current_stream(re),
    )
    _build.check(status, name)
    K3_LAUNCHES += 1
    return re, im


# ---- K4 --------------------------------------------------------------------

def c2r_tail_plain(re, im, nz, weights):
    """K4 in plain PyTorch: ``torch.fft.irfft(norm='forward') * weights``."""
    c = torch.complex(re, im)
    return torch.fft.irfft(c, n=nz, dim=-1, norm="forward") * weights


def c2r_tail_emulated(re, im, nz, weights):
    """K4's algebra with the kernel core's passes (:func:`stockham_emulated`)
    as the m-point transform: the fold G[j] = E[j] + i W^j O[j] in float32
    as the kernel computes it, z = IFFT_m(G), the pairs (Re z[j], Im z[j])
    times the weights; for the tests, like it."""
    m = nz // 2
    c_re, c_im = re[..., :m], im[..., :m]
    rev = torch.arange(m, 0, -1, device=re.device)  # m - j
    r_re, r_im = re[..., rev], im[..., rev]
    er, ei = c_re + r_re, c_im - r_im
    orr, oi = c_re - r_re, c_im + r_im
    tw = _twiddles(nz, m, str(re.device))
    wre, wim = tw[:, 0], tw[:, 1]  # W^j = exp(+2 pi i j / nz)
    g = torch.complex(er - (wre * oi + wim * orr), ei + (wre * orr - wim * oi))
    z = stockham_emulated(g, +1)
    pairs = torch.stack([z.real, z.imag], dim=-1)
    return pairs.reshape(*re.shape[:-1], nz) * weights


def c2r_tail(re, im, nz, weights, out=None, offsets=None):
    """K4: c2r along the minor axis plus per-plane weights, one pass.

    ``re``/``im``: float32 (..., nz//2+1) packed spectra, natural order on
    every axis; ``weights``: float32 (nz,).  Returns a float32 (..., nz)
    tensor, the unnormalized inverse real transform along the last axis
    times ``weights``: a new one, or ``out`` (contiguous, of that shape, on
    the same device), which the kernel then writes directly (a row of a
    seed batch's stack; on CUDA it must be 8-byte aligned, as every
    allocation and every row of a float32 stack of even nz is).  On CUDA,
    nz must be even with
    ``kernel_length_ok(nz // 2)``; the half-pack it uses is exact for
    Hermitian input (real kz = 0 and Nyquist terms), as a symmetrized
    spectrum is after its x and y passes.

    ``offsets`` (float32 (nz,), K4L): write ``expm1(weights[z] x -
    offsets[z])`` instead, the same kernel's exp instance, counted in
    ``K4L_LAUNCHES`` and not in ``K4_LAUNCHES``; see :func:`c2r_tail_exp`.
    """
    global K4_LAUNCHES, K4L_LAUNCHES
    _check_pair(re, im, "c2r_tail")
    if re.shape[-1] != nz // 2 + 1:
        raise ValueError(f"c2r_tail: minor axis {re.shape[-1]} != "
                         f"nz//2 + 1 = {nz // 2 + 1}")
    for name, v in (("weights", weights), ("offsets", offsets)):
        if v is not None and (v.shape != (nz,) or v.device != re.device):
            raise ValueError(f"c2r_tail: {name} must be ({nz},) on "
                             f"{re.device}")
    if out is not None and not (
            out.shape == (*re.shape[:-1], nz) and out.dtype == torch.float32
            and out.device == re.device and out.is_contiguous()):
        raise ValueError(f"c2r_tail: out must be a contiguous float32 "
                         f"{(*re.shape[:-1], nz)} tensor on {re.device}")
    if re.device.type == "cpu":
        field = (c2r_tail_plain(re, im, nz, weights) if offsets is None
                 else c2r_tail_exp_plain(re, im, nz, weights, offsets))
        return field if out is None else out.copy_(field)
    if re.device.type != "cuda":
        raise ValueError(f"c2r_tail runs on cpu or cuda, not {re.device}")
    m = nz // 2
    if nz % 2 or not kernel_length_ok(m):
        raise ValueError(f"c2r_tail: nz={nz} unsupported on CUDA (need even "
                         f"nz with nz/2 a power of two in "
                         f"[{MIN_LENGTH}, {MAX_LENGTH}])")
    if weights.dtype != torch.float32 or (
            offsets is not None and offsets.dtype != torch.float32):
        raise ValueError("c2r_tail: weights and offsets must be float32")
    if not (re.is_contiguous() and im.is_contiguous()
            and weights.is_contiguous()
            and (offsets is None or offsets.is_contiguous())):
        raise ValueError("c2r_tail's CUDA kernel needs contiguous tensors")
    out = _launch_c2r_tail(re, im, nz, weights, out, offsets)
    if offsets is None:
        K4_LAUNCHES += 1
    else:
        K4L_LAUNCHES += 1
    return out


def _launch_c2r_tail(re, im, nz, weights, out=None, offsets=None):
    m = nz // 2
    if out is None:
        out = torch.empty((*re.shape[:-1], nz), dtype=torch.float32,
                          device=re.device)
    elif out.data_ptr() % 8:
        raise ValueError("c2r_tail: out must be 8-byte aligned (the kernel "
                         "stores float pairs)")
    if weights.data_ptr() % 8:
        weights = weights.clone()  # read as float pairs too
    if offsets is not None and offsets.data_ptr() % 8:
        offsets = offsets.clone()
    device = str(re.device)
    status = _build.library().rf_c2r_tail(
        re.data_ptr(), im.data_ptr(), weights.data_ptr(),
        0 if offsets is None else offsets.data_ptr(),
        pass_twiddles(m, +1, device).data_ptr(),
        _twiddles(nz, m, device).data_ptr(), out.data_ptr(),
        re.numel() // (m + 1), int(m), *_plan3(m), _build.current_stream(re),
    )
    _build.check(status, "c2r_tail")
    return out


def c2r_tail_exp_plain(re, im, nz, a, c):
    """K4L in plain PyTorch: :func:`c2r_tail_plain` with weights ``a``,
    then ``expm1(y - c)``."""
    return torch.expm1(c2r_tail_plain(re, im, nz, a) - c)


def c2r_tail_exp(re, im, nz, a, c, out=None):
    """K4L: :func:`c2r_tail` with the lognormal exp map fused in, one pass.

    Writes ``expm1(a[z] x - c[z])`` for the unweighted c2r output x, where
    K4 writes ``x w[z]``: with ``a = b w`` and ``c = b^2 w^2 sigma_G^2 / 2``
    this is ``models/lognormal.py``'s exp map of a rendered Gaussian field.
    ``a``, ``c``: float32 (nz,) on the spectra's device; the rest as
    :func:`c2r_tail`, which this is with ``offsets=c``.
    """
    return c2r_tail(re, im, nz, a, out, offsets=c)


# ---- K6 --------------------------------------------------------------------

def r2c_head_plain(x):
    """K6 in plain PyTorch: the half-length pack of
    ``pallas_fft.rfft_minor_half_reim`` in its order of float32 operations.

    ``x``: float32 (..., nz), nz even.  z[j] = x[2j] + i x[2j+1] goes
    through ``torch.fft.fft`` of length m = nz/2 and unfolds as X[k] = A[k]
    + W^-k B[k]; returns (re, im) float32 (..., nz//2 + 1), the
    unnormalized forward real transform along the last axis
    (``torch.fft.rfft``).
    """
    return _half_pack(x, lambda z: torch.fft.fft(z, dim=-1))


def r2c_head_emulated(x):
    """K6's algebra with the kernel core's passes (:func:`stockham_emulated`)
    as the half-length transform; for the tests, like it."""
    return _half_pack(x, lambda z: stockham_emulated(z, -1))


def _half_pack(x, transform):
    nz = x.shape[-1]
    m = nz // 2
    pair = x.reshape(*x.shape[:-1], m, 2)
    z = transform(torch.complex(pair[..., 0], pair[..., 1]))
    zre, zim = z.real, z.imag
    # Z*[m-k]: index-reversed with wraparound (k = 0 -> Z[0])
    rev = torch.cat([torch.zeros(1, dtype=torch.int64),
                     torch.arange(m - 1, 0, -1)]).to(x.device)
    zre_r, zim_r = zre[..., rev], zim[..., rev]
    a_re = 0.5 * (zre + zre_r)
    a_im = 0.5 * (zim - zim_r)
    b_re = 0.5 * (zim + zim_r)
    b_im = -0.5 * (zre - zre_r)
    tw = _twiddles(nz, m, str(x.device))
    wre, wim = tw[:, 0], -tw[:, 1]  # W^-k = exp(-2 pi i k / nz)
    out_re = a_re + (wre * b_re - wim * b_im)
    out_im = a_im + (wre * b_im + wim * b_re)
    tail_re = zre[..., :1] - zim[..., :1]
    return (torch.cat([out_re, tail_re], dim=-1),
            torch.cat([out_im, torch.zeros_like(tail_re)], dim=-1))


def r2c_head(x):
    """K6: r2c along the minor axis by the half-length complex pack.

    ``x``: contiguous float32 (..., nz).  Returns new float32 (re, im)
    tensors (..., nz//2 + 1), the unnormalized forward real transform along
    the last axis: the head of the distributed forward transform,
    reading the field once and writing the spectrum once.  On CUDA, nz must
    be even with ``kernel_length_ok(nz // 2)``; CPU tensors run
    :func:`r2c_head_plain`.
    """
    global K6_LAUNCHES
    if x.dtype != torch.float32:
        raise ValueError("r2c_head: x must be float32")
    nz = x.shape[-1]
    m = nz // 2
    if x.device.type == "cpu":
        if nz % 2:
            raise ValueError(f"r2c_head: nz={nz} must be even")
        return r2c_head_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"r2c_head runs on cpu or cuda, not {x.device}")
    if nz % 2 or not kernel_length_ok(m):
        raise ValueError(f"r2c_head: nz={nz} unsupported on CUDA (need even "
                         f"nz with nz/2 a power of two in "
                         f"[{MIN_LENGTH}, {MAX_LENGTH}])")
    if not x.is_contiguous():
        raise ValueError("r2c_head's CUDA kernel needs a contiguous tensor")
    re = torch.empty((*x.shape[:-1], m + 1), dtype=torch.float32,
                     device=x.device)
    im = torch.empty_like(re)
    status = _build.library().rf_r2c_head(
        x.data_ptr(), pass_twiddles(m, -1, str(x.device)).data_ptr(),
        _twiddles(nz, m, str(x.device)).data_ptr(), re.data_ptr(),
        im.data_ptr(), x.numel() // nz, int(m), *_plan3(m),
        _build.current_stream(x),
    )
    _build.check(status, "r2c_head")
    K6_LAUNCHES += 1
    return re, im


# ---- K9 --------------------------------------------------------------------

def _view_groups(re, groups, n, cols, name):
    if re.numel() != groups * n * cols:
        raise ValueError(f"{name}: {tuple(re.shape)} is not a "
                         f"({groups} * {n}, {cols}) lattice")
    return re.view(groups, n, cols)


def ifft_rotate_plain(re, im, groups, n, cols):
    """K9 in plain PyTorch: ``torch.fft.ifft(norm='forward')`` down the n
    rows of each group of the (groups, n, cols) view, then the rotation:
    new (re, im) tensors (groups * cols, n)."""
    c = torch.complex(_view_groups(re, groups, n, cols, "ifft_rotate"),
                      _view_groups(im, groups, n, cols, "ifft_rotate"))
    out = torch.fft.ifft(c, dim=1, norm="forward").transpose(1, 2)
    return (out.real.reshape(groups * cols, n).contiguous(),
            out.imag.reshape(groups * cols, n).contiguous())


def ifft_rotate_emulated(re, im, groups, n, cols):
    """K9's function with the kernel core's passes
    (:func:`stockham_emulated`) as the transform; for the tests, like it."""
    c = torch.complex(_view_groups(re, groups, n, cols, "ifft_rotate"),
                      _view_groups(im, groups, n, cols, "ifft_rotate"))
    out = stockham_emulated(c.transpose(1, 2).contiguous(), +1)
    return (out.real.reshape(groups * cols, n).contiguous(),
            out.imag.reshape(groups * cols, n).contiguous())


def ifft_rotate(re, im, groups, n, cols):
    """K9: unnormalized inverse FFT down the rows of each group, output
    rotated.

    ``re``/``im``: contiguous float32 lattices viewed as (groups * n, cols);
    each run of n rows is one group, a batch of length-n signals down its
    columns.  Returns new float32 (re, im) tensors (groups * cols, n): row
    ``g * cols + col`` holds X[j] = sum_k x[g, k, col] exp(+2 pi i jk/n) in
    natural order.  A transform of a non-minor axis and the transpose that
    brings it minor, as one pass over device memory; the inputs are left
    as they were.  The staged v4 render's x pass is (1, nx, ny * nzh) and
    its y pass (1, ny, nzh * nx).  CUDA tensors need
    ``kernel_length_ok(n)`` and groups <= 65535; CPU tensors run
    :func:`ifft_rotate_plain`.
    """
    global K9_LAUNCHES
    _check_pair(re, im, "ifft_rotate")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("ifft_rotate reads contiguous tensors")
    _view_groups(re, groups, n, cols, "ifft_rotate")
    if re.device.type == "cpu":
        return ifft_rotate_plain(re, im, groups, n, cols)
    if re.device.type != "cuda":
        raise ValueError(f"ifft_rotate runs on cpu or cuda, not {re.device}")
    if not kernel_length_ok(n):
        raise ValueError(f"ifft_rotate: n={n} unsupported on CUDA (need a "
                         f"power of two in [{MIN_LENGTH}, {MAX_LENGTH}])")
    if groups > _MAX_OUTER:
        raise ValueError(f"ifft_rotate: groups={groups} > {_MAX_OUTER}")
    out_re = torch.empty((groups * cols, n), dtype=torch.float32,
                         device=re.device)
    out_im = torch.empty_like(out_re)
    status = _build.library().rf_fft_rotate(
        re.data_ptr(), im.data_ptr(), out_re.data_ptr(), out_im.data_ptr(),
        pass_twiddles(n, +1, str(re.device)).data_ptr(), int(groups), int(n),
        int(cols), *_plan3(n), rotate_panel(n), _build.current_stream(re),
    )
    _build.check(status, "ifft_rotate")
    K9_LAUNCHES += 1
    return out_re, out_im
