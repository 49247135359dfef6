"""The render's inverse transforms: axis FFT (K3) and c2r tail (K4).

Counterpart of ``randomfield_tpu/ops/pallas_fft.py``.  A render's inverse
3-D c2r runs as two passes of :func:`ifft_axis` (x, then y) over the packed
(nx, ny, nzh) re/im spectrum, in place, and one :func:`c2r_tail` along kz
that also applies the per-plane lightcone weights and writes the field.

On CUDA tensors the wrappers launch the hand kernels built from
``csrc/fft_axis.cu`` and ``csrc/c2r_tail.cu``; on CPU tensors they run the
plain PyTorch versions beside them (``torch.fft``).  Launch counts are
``K3_LAUNCHES`` and ``K4_LAUNCHES``.

Both kernels take power-of-two transform lengths from 16 to 2048
(:func:`kernel_length_ok`); a mixed-radix version is a later step.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build

__all__ = [
    "ifft_axis",
    "ifft_axis_plain",
    "c2r_tail",
    "c2r_tail_plain",
    "kernel_length_ok",
    "K3_LAUNCHES",
    "K4_LAUNCHES",
]

# kernel launches by ifft_axis / c2r_tail (the CPU paths do not count)
K3_LAUNCHES = 0
K4_LAUNCHES = 0

MIN_LENGTH, MAX_LENGTH = 16, 2048
_MAX_OUTER = 65535  # the kernel's grid.y
# complex elements one K3 block transforms (sets the panel width) and one
# K4 block holds: 32-64 KB of shared memory, several blocks per SM
_K3_PANEL_ELEMS = 4096
_K4_BLOCK_ELEMS = 2048


def kernel_length_ok(n: int) -> bool:
    """True for the transform lengths the kernels take: 2^k, 16..2048."""
    return MIN_LENGTH <= n <= MAX_LENGTH and n & (n - 1) == 0


@functools.lru_cache(maxsize=None)
def _twiddles(n: int, count: int, device: str) -> torch.Tensor:
    """float32 pairs (cos, sin)(2 pi k / n), k < count, built in float64."""
    theta = 2.0 * np.pi * np.arange(count) / n
    tw = np.stack([np.cos(theta), np.sin(theta)], axis=-1).astype(np.float32)
    return torch.as_tensor(tw, device=device)


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

def ifft_axis_plain(re, im, outer, n, inner):
    """K3 in plain PyTorch: ``torch.fft.ifft(norm='forward')`` along the
    middle axis of the (outer, n, inner) view, written back in place."""
    c = torch.complex(_view3(re, outer, n, inner, "ifft_axis"),
                      _view3(im, outer, n, inner, "ifft_axis"))
    out = torch.fft.ifft(c, dim=1, norm="forward")
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
    global K3_LAUNCHES
    _check_pair(re, im, "ifft_axis")
    if not (re.is_contiguous() and im.is_contiguous()):
        raise ValueError("ifft_axis transforms contiguous tensors in place")
    _view3(re, outer, n, inner, "ifft_axis")
    if re.device.type == "cpu":
        return ifft_axis_plain(re, im, outer, n, inner)
    if re.device.type != "cuda":
        raise ValueError(f"ifft_axis runs on cpu or cuda, not {re.device}")
    if not kernel_length_ok(n):
        raise ValueError(f"ifft_axis: n={n} unsupported on CUDA (need a "
                         f"power of two in [{MIN_LENGTH}, {MAX_LENGTH}])")
    if outer > _MAX_OUTER:
        raise ValueError(f"ifft_axis: outer={outer} > {_MAX_OUTER}")
    _launch_ifft_axis(re, im, outer, n, inner)
    K3_LAUNCHES += 1
    return re, im


def _launch_ifft_axis(re, im, outer, n, inner):
    status = _build.library().rf_fft_axis(
        re.data_ptr(), im.data_ptr(),
        _twiddles(n, n // 2, str(re.device)).data_ptr(),
        int(outer), int(n), int(inner), max(8, _K3_PANEL_ELEMS // n),
        _build.current_stream(re),
    )
    _build.check(status, "ifft_axis")


# ---- K4 --------------------------------------------------------------------

def c2r_tail_plain(re, im, nz, weights):
    """K4 in plain PyTorch: ``torch.fft.irfft(norm='forward') * weights``."""
    c = torch.complex(re, im)
    return torch.fft.irfft(c, n=nz, dim=-1, norm="forward") * weights


def c2r_tail(re, im, nz, weights):
    """K4: c2r along the minor axis plus per-plane weights, one pass.

    ``re``/``im``: float32 (..., nz//2+1) packed spectra, natural order on
    every axis; ``weights``: float32 (nz,).  Returns a new float32
    (..., nz) tensor, the unnormalized inverse real transform along the
    last axis times ``weights``.  On CUDA, nz must be even with
    ``kernel_length_ok(nz // 2)``; the half-pack it uses is exact for
    Hermitian input (real kz = 0 and Nyquist terms), as a symmetrized
    spectrum is after its x and y passes.
    """
    global K4_LAUNCHES
    _check_pair(re, im, "c2r_tail")
    if re.shape[-1] != nz // 2 + 1:
        raise ValueError(f"c2r_tail: minor axis {re.shape[-1]} != "
                         f"nz//2 + 1 = {nz // 2 + 1}")
    if weights.shape != (nz,) or weights.device != re.device:
        raise ValueError(f"c2r_tail: weights must be ({nz},) on {re.device}")
    if re.device.type == "cpu":
        return c2r_tail_plain(re, im, nz, weights)
    if re.device.type != "cuda":
        raise ValueError(f"c2r_tail runs on cpu or cuda, not {re.device}")
    m = nz // 2
    if nz % 2 or not kernel_length_ok(m):
        raise ValueError(f"c2r_tail: nz={nz} unsupported on CUDA (need even "
                         f"nz with nz/2 a power of two in "
                         f"[{MIN_LENGTH}, {MAX_LENGTH}])")
    if weights.dtype != torch.float32:
        raise ValueError("c2r_tail: weights must be float32")
    if not (re.is_contiguous() and im.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("c2r_tail's CUDA kernel needs contiguous tensors")
    out = _launch_c2r_tail(re, im, nz, weights)
    K4_LAUNCHES += 1
    return out


def _launch_c2r_tail(re, im, nz, weights):
    m = nz // 2
    out = torch.empty((*re.shape[:-1], nz), dtype=torch.float32,
                      device=re.device)
    status = _build.library().rf_c2r_tail(
        re.data_ptr(), im.data_ptr(), weights.data_ptr(),
        _twiddles(nz, m, str(re.device)).data_ptr(), out.data_ptr(),
        re.numel() // (m + 1), int(m), max(1, _K4_BLOCK_ELEMS // m),
        _build.current_stream(re),
    )
    _build.check(status, "c2r_tail")
    return out
