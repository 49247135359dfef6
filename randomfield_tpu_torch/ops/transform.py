"""Hermitian symmetrization of packed re/im spectra, and the 3-D transforms.

Port of the render's subset of ``randomfield_tpu/ops/transform.py`` with
its physical conventions: a real field on an (nx, ny, nz) grid of spacing
a, box volume V, has the packed spectrum c_k with

    delta(x) = (1 / V) sum_k c_k exp(+i k.x).

The render folds 1/V into sigma(k), so its inverse transform is the raw
sum, ``norm='forward'``.  Spectra travel as separate float32 re/im
lattices, never as complex tensors: the kernels read and write them that
way.  The TPU package's ``'safe'``/``'ct'`` FFT backends work around a
defect of one TPU runtime and are not ported.

On CUDA tensors the 3-D transforms run the hand kernels of
:mod:`.fft`: :func:`irfftn_reim` K3 along x, K3 along y and K4 (a render's
tail), :func:`rfftn` K6 along z and forward K3 along y and x (the kernels
of the one-rank mesh's forward transform, ``parallel/dfft.py``).  The
kernels take the grids of :func:`kernel_shape_ok` (nx, ny and nz/2 powers
of two from 16 to 2048); for any other grid on a CUDA tensor the two
transforms call ``torch.fft`` on the card instead, a rule of the shape
decided before any launch, and count the call in ``TORCH_FFT_CALLS`` (so
a run can show that its paths launched the kernels).  CPU tensors run the
kernels' plain versions (``torch.fft``).  :func:`spectrum_to_field`,
:func:`field_to_spectrum` and the complex :func:`symmetrize` are the JAX
package's functions of the same names on these transforms.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import fft as _fft
from randomfield_tpu_torch.ops import grid as _grid

__all__ = ["symmetrize_plane_reim", "symmetrize_with_shape_reim",
           "symmetrize_slab_reim", "symmetrize", "symmetrize_with_shape",
           "hermitian_part_reim",
           "irfftn", "irfftn_reim", "irfftn_reim_exp", "rfftn", "rfft_last", "kernel_shape_ok",
           "spectrum_to_field", "field_to_spectrum", "is_hermitian",
           "TORCH_FFT_CALLS"]

# transforms of CUDA tensors that went to torch.fft because the grid (or
# line) is not one the kernels take; the CPU paths do not count
TORCH_FFT_CALLS = 0

_SQRT2 = float(np.sqrt(2.0))


def symmetrize_plane_reim(re2, im2, scale_self_conjugate=True):
    """Hermitian projection of one self-conjugate (nx, ny) kz plane.

    For each conjugate pair the canonical member is kept and its partner
    overwritten with the conjugate; self-conjugate modes keep their real
    part, times sqrt(2) with ``scale_self_conjugate`` (the sampling
    convention: a unit complex draw keeps unit total variance).  Returns
    new (re, im) planes.
    """
    nx, ny = re2.shape[-2], re2.shape[-1]
    self_conj, canonical = (
        torch.as_tensor(m, device=re2.device)
        for m in _grid.hermitian_plane_masks(nx, ny)
    )
    pre = _grid.conjugate_plane(re2)
    pim = -_grid.conjugate_plane(im2)
    out_re = torch.where(canonical, re2, pre)
    out_im = torch.where(canonical, im2, pim)
    scale = _SQRT2 if scale_self_conjugate else 1.0
    out_re = torch.where(self_conj, re2 * scale, out_re)
    out_im = torch.where(self_conj, torch.zeros((), dtype=im2.dtype,
                                                device=im2.device), out_im)
    return out_re, out_im


def symmetrize_with_shape_reim(re, im, nz, scale_self_conjugate=True):
    """Enforce the Hermitian constraint on (..., nx, ny, nzh) re/im lattices.

    Only the kz = 0 plane and, for even nz, the Nyquist plane are
    constrained.  Updates ``re`` and ``im`` IN PLACE (an O(nx ny) write per
    plane) and returns them.
    """
    for p in _grid.self_conjugate_kz_planes(nz):
        fre, fim = symmetrize_plane_reim(re[..., p], im[..., p],
                                          scale_self_conjugate)
        re[..., p] = fre
        im[..., p] = fim
    return re, im


def hermitian_part_reim(re, im, nz):
    """Replace the kz = 0 and (even nz) Nyquist planes of a packed spectrum
    by their Hermitian parts, (c(k) + conj c(-k)) / 2, IN PLACE: what a
    c2r transform keeps of them (``torch.fft`` and numpy drop the rest; K4's
    half-pack reads those planes as Hermitian, so a spectrum whose planes
    are not goes through this first).  Returns (re, im)."""
    for p in _grid.self_conjugate_kz_planes(nz):
        r, i = re[..., p], im[..., p]
        pr = _grid.conjugate_plane(r)
        pi = _grid.conjugate_plane(i)
        re[..., p] = 0.5 * (r + pr)
        im[..., p] = 0.5 * (i - pi)
    return re, im


def symmetrize_slab_reim(re, im, nz, mesh, scale_self_conjugate=True):
    """:func:`symmetrize_with_shape_reim` on a slab mesh's ky rows.

    ``re``/``im``: this rank's (nx, ny/P, nzh) block of a spectrum sharded
    along ky (:class:`..parallel.mesh.SlabMesh`).  The conjugate partner
    (-kx, -ky) of a mode lies on another rank, so the kz = 0 and Nyquist
    planes are gathered whole (one ``all_gather`` of 2 nx ny float32 pairs,
    16 MB at 1024^3), fixed exactly as on one device and cut back to the
    local rows: the result equals the single-device fix bit for bit.  The
    TPU lowers the same fix to collective permutes
    (``parallel/render.py``).  Updates ``re`` and ``im`` IN PLACE.
    """
    planes = _grid.self_conjugate_kz_planes(nz)
    y_off, ny_loc = mesh.rows(re.shape[-2] * mesh.size)
    local = torch.stack([t[..., p] for p in planes for t in (re, im)])
    full = mesh.all_gather(local, dim=-1)
    for i, p in enumerate(planes):
        fre, fim = symmetrize_plane_reim(full[2 * i], full[2 * i + 1],
                                         scale_self_conjugate)
        re[..., p] = fre[..., y_off:y_off + ny_loc]
        im[..., p] = fim[..., y_off:y_off + ny_loc]
    return re, im


def symmetrize_with_shape(c, nz, scale_self_conjugate=True):
    """The Hermitian projection of a complex packed (..., nx, ny, nzh)
    spectrum with the real-space nz given: a new complex tensor
    (:func:`symmetrize_with_shape_reim` on copies of its parts)."""
    re = c.real.clone(memory_format=torch.contiguous_format)
    im = c.imag.clone(memory_format=torch.contiguous_format)
    symmetrize_with_shape_reim(re, im, nz, scale_self_conjugate)
    return torch.complex(re, im)


def symmetrize(c, scale_self_conjugate=True):
    """Enforce the Hermitian constraint on a complex packed half-spectrum,
    taking nz = 2 (nzh - 1) (the last plane as Nyquist), as the JAX
    package's ``symmetrize`` does; a new complex tensor."""
    return symmetrize_with_shape(c, 2 * (c.shape[-1] - 1),
                                 scale_self_conjugate)


def kernel_shape_ok(shape) -> bool:
    """Whether the hand kernels transform an (nx, ny, nz) grid: nx, ny and
    nz/2 powers of two in [16, 2048] (nz even)."""
    nx, ny, nz = (int(n) for n in shape)
    return (_fft.kernel_length_ok(nx) and _fft.kernel_length_ok(ny)
            and nz % 2 == 0 and _fft.kernel_length_ok(nz // 2))


def _library_route(t, shape):
    """True (and counted) when a CUDA tensor's grid goes to torch.fft."""
    global TORCH_FFT_CALLS
    if t.device.type != "cuda" or kernel_shape_ok(shape):
        return False
    TORCH_FFT_CALLS += 1
    return True


def irfftn(re, im, shape):
    """Plain packed c2r, ``norm='forward'`` (no 1/N), through ``torch.fft``."""
    return torch.fft.irfftn(torch.complex(re, im), s=tuple(shape),
                            dim=(-3, -2, -1), norm="forward")


def irfftn_reim(re, im, shape, weights=None, out=None):
    """Hermitian packed c2r, ``norm='forward'``, times per-plane ``weights``
    (float32 (nz,); ones by default): K3 along x, then along y (both in
    place: the (nx, ny, nzh) lattices are consumed), then K4, which writes
    the float32 (nx, ny, nz) field (``out`` when given).  CPU tensors run
    each kernel's plain version; a CUDA grid the kernels do not take
    (:func:`kernel_shape_ok`) runs ``torch.fft.irfftn`` on the card.  The
    input must be Hermitian, as a symmetrized spectrum, a power grid and a
    masked shell of a real field's spectrum are: K4's half-pack reads the
    kz = 0 and Nyquist terms as real."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    if weights is None:
        weights = torch.ones(nz, dtype=torch.float32, device=re.device)
    if _library_route(re, shape):
        field = irfftn(re, im, shape) * weights
        return field if out is None else out.copy_(field)
    _fft.ifft_axis(re, im, 1, nx, ny * nzh)
    _fft.ifft_axis(re, im, nx, ny, nzh)
    return _fft.c2r_tail(re, im, nz, weights, out=out)


def irfftn_reim_exp(re, im, shape, a, c):
    """:func:`irfftn_reim` ending in the lognormal exp map: K3 along x and
    y (in place), then K4L (:func:`.fft.c2r_tail_exp`), which writes
    ``expm1(a[z] x - c[z])`` of the c2r output x.  ``a``, ``c``: float32
    (nz,).  A CUDA grid the kernels do not take runs ``torch.fft`` and the
    map on the card (counted)."""
    nx, ny, nz = shape
    if _library_route(re, shape):
        return torch.expm1(irfftn(re, im, shape) * a - c)
    _fft.ifft_axis(re, im, 1, nx, ny * (nz // 2 + 1))
    _fft.ifft_axis(re, im, nx, ny, nz // 2 + 1)
    return _fft.c2r_tail_exp(re, im, nz, a, c)


def rfftn(delta):
    """Packed r2c of a float32 (nx, ny, nz) field, unnormalized
    (``norm='backward'``): new float32 (re, im) (nx, ny, nz//2+1) lattices.

    On CUDA: K6 along z, then forward K3 along y and along x, in place (a
    grid :func:`kernel_shape_ok` refuses: ``torch.fft.rfftn`` on the card,
    counted).  On the CPU: ``torch.fft.rfftn``.  The JAX package's
    ``norm='forward'`` result is this over nx ny nz.
    """
    delta = torch.as_tensor(delta)
    if delta.dtype != torch.float32 or delta.ndim != 3:
        raise ValueError(f"rfftn takes one float32 (nx, ny, nz) field, got "
                         f"{delta.dtype} {tuple(delta.shape)}")
    if delta.device.type == "cpu" or _library_route(delta, delta.shape):
        c = torch.fft.rfftn(delta)
        return c.real.contiguous(), c.imag.contiguous()
    nx, ny, nz = delta.shape
    re, im = _fft.r2c_head(delta.contiguous())
    _fft.fft_axis(re, im, nx, ny, nz // 2 + 1)
    _fft.fft_axis(re, im, 1, nx, ny * (nz // 2 + 1))
    return re, im


def rfft_last(x):
    """Unnormalized r2c along the last axis of a float32 tensor: new
    (re, im) tensors (..., n//2+1).  K6 on CUDA when n is even with
    ``kernel_length_ok(n // 2)``, else ``torch.fft.rfft`` on the card
    (counted in ``TORCH_FFT_CALLS``); ``torch.fft.rfft`` on the CPU."""
    global TORCH_FFT_CALLS
    n = x.shape[-1]
    if x.device.type == "cuda":
        if n % 2 == 0 and _fft.kernel_length_ok(n // 2):
            return _fft.r2c_head(x.contiguous())
        TORCH_FFT_CALLS += 1
    c = torch.fft.rfft(x, dim=-1)
    return c.real.contiguous(), c.imag.contiguous()


def spectrum_to_field(c, spacing, shape):
    """Synthesis delta(x) = (1/V) sum_k c_k exp(ik.x) of a Hermitian packed
    spectrum: ``c`` complex or an (re, im) pair (not consumed); a float32
    (nx, ny, nz) field through :func:`irfftn_reim` on ``c``'s device."""
    nx, ny, nz = (int(n) for n in shape)
    re, im = (c.real, c.imag) if isinstance(c, torch.Tensor) else c
    inv_v = float(np.float32(1.0 / (nx * ny * nz * float(spacing) ** 3)))
    return irfftn_reim((re * inv_v).contiguous(), (im * inv_v).contiguous(),
                       (nx, ny, nz))


def field_to_spectrum(delta, spacing):
    """Analysis c_k = a^3 sum_x delta(x) exp(-ik.x): a complex64 (nx, ny,
    nz//2+1) tensor through :func:`rfftn` on ``delta``'s device."""
    re, im = rfftn(delta)
    a3 = float(np.float32(float(spacing) ** 3))
    return torch.complex(re.mul_(a3), im.mul_(a3))


def is_hermitian(re, im, nz=None, rtol=1e-5, atol=1e-6):
    """Whether a packed (..., nx, ny, nzh) spectrum is that of a real
    field: its kz = 0 and (even nz) Nyquist planes unchanged, within the
    tolerances, by the Hermitian projection (no sqrt(2) scale)."""
    if nz is None:
        nz = 2 * (re.shape[-1] - 1)
    for p in _grid.self_conjugate_kz_planes(nz):
        fre, fim = symmetrize_plane_reim(re[..., p], im[..., p], False)
        if not (torch.allclose(re[..., p], fre, rtol=rtol, atol=atol)
                and torch.allclose(im[..., p], fim, rtol=rtol, atol=atol)):
            return False
    return True
