"""Distributed packed FFTs on a slab mesh: one all-to-all per direction.

Port of ``randomfield_tpu/parallel/dfft.py`` (``irfftn_slab_reim`` and
``rfftn_slab``).  Inverse (k -> x), the spectrum sharded along ky:

    1. K3 along x on the (1, nx, ny/P * nzh) view   (x is local in k-space)
    2. all-to-all: x split into P blocks, ky gathered -> (nx/P, ny, nzh)
    3. K3 along y on (nx/P, ny, nzh)
    4. K4 along kz, times the per-plane weights      (z is never sharded)

and forward (x -> k) the reverse: K6 along z, forward K3 along y, the
all-to-all back to ky slabs, forward K3 along x.  The exchange moves the
packed half-spectrum, half the bytes of a full complex cube.

The TPU schedule keeps its kernel's lane-major digit order through the
all-to-all and pins transposes with ``optimization_barrier``; the port's
K3 transforms the middle axis of any view in natural order, so neither
exists here.  Each step is a function of its own, so a caller can time
them one by one.  :func:`forward` and :func:`inverse` take a field or a
spectrum on one device (mesh None) or on a slab mesh, for the callers that
run on either.
"""

from __future__ import annotations

import torch

from randomfield_tpu_torch.ops import fft as _fft
from randomfield_tpu_torch.parallel.mesh import check_divisible

__all__ = ["irfftn_slab_reim", "rfftn_slab", "to_x_slabs", "to_ky_slabs",
           "forward", "inverse"]


def _check_spectrum(re, im, shape, mesh):
    nx, ny, nz = shape
    want = (nx, ny // mesh.size, nz // 2 + 1)
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise ValueError(f"this rank's spectrum must be {want} re/im "
                         f"blocks, got {tuple(re.shape)} and "
                         f"{tuple(im.shape)}")


def to_x_slabs(t, shape, mesh):
    """(nx, ny/P, nzh) ky slab -> (nx/P, ny, nzh) x slab: the all-to-all
    of the inverse transform, after its x pass."""
    nx, ny, nz = shape
    if mesh.size == 1:
        return t
    p = mesh.size
    got = mesh.all_to_all(t)  # block s: rank s's ky rows of my x rows
    nzh = t.shape[-1]
    return (got.view(p, nx // p, ny // p, nzh).transpose(0, 1)
            .reshape(nx // p, ny, nzh))


def to_ky_slabs(t, shape, mesh):
    """(nx/P, ny, nzh) x slab -> (nx, ny/P, nzh) ky slab: the all-to-all
    of the forward transform, after its y pass."""
    nx, ny, nz = shape
    if mesh.size == 1:
        return t
    p = mesh.size
    nzh = t.shape[-1]
    send = t.view(nx // p, p, ny // p, nzh).transpose(0, 1).contiguous()
    return mesh.all_to_all(send).view(nx, ny // p, nzh)


def irfftn_slab_reim(re, im, shape, mesh, weights, offsets=None):
    """Distributed Hermitian c2r, ``norm='forward'``, times ``weights``.

    ``re``/``im``: this rank's float32 (nx, ny/P, nz/2+1) ky slab of a
    Hermitian spectrum, consumed (transformed in place, then released);
    ``weights``: float32 (nz,) per-plane multipliers, fused into K4.
    Returns this rank's float32 (nx/P, ny, nz) x slab of the field.  With
    ``offsets`` (float32 (nz,)) the last step is K4L on the x slab
    (:func:`..ops.fft.c2r_tail_exp`, whose per-plane tables need no offset
    since z is never sharded): ``expm1(weights[z] x - offsets[z])``, the
    lognormal map.
    """
    nx, ny, nz = shape
    check_divisible(shape, mesh.size)
    _check_spectrum(re, im, shape, mesh)
    nyl, nzh = ny // mesh.size, nz // 2 + 1
    _fft.ifft_axis(re, im, 1, nx, nyl * nzh)
    re = to_x_slabs(re, shape, mesh)
    im = to_x_slabs(im, shape, mesh)
    _fft.ifft_axis(re, im, nx // mesh.size, ny, nzh)
    if offsets is not None:
        return _fft.c2r_tail_exp(re, im, nz, weights, offsets)
    return _fft.c2r_tail(re, im, nz, weights)


def rfftn_slab(x, shape, mesh):
    """Distributed r2c, ``norm='backward'`` (the plain sum, no scaling).

    ``x``: this rank's float32 (nx/P, ny, nz) x slab of a real field.
    Returns this rank's (re, im) float32 (nx, ny/P, nz/2+1) ky slab of its
    packed spectrum, the layout :func:`irfftn_slab_reim` takes.
    """
    nx, ny, nz = shape
    check_divisible(shape, mesh.size)
    nxl = nx // mesh.size
    if tuple(x.shape) != (nxl, ny, nz):
        raise ValueError(f"this rank's field must be ({nxl}, {ny}, {nz}), "
                         f"got {tuple(x.shape)}")
    nzh = nz // 2 + 1
    re, im = _fft.r2c_head(x.contiguous())
    _fft.fft_axis(re, im, nxl, ny, nzh)
    re = to_ky_slabs(re, shape, mesh)
    im = to_ky_slabs(im, shape, mesh)
    _fft.fft_axis(re, im, 1, nx, (ny // mesh.size) * nzh)
    return re, im


def forward(x, mesh=None):
    """The unnormalized packed spectrum (re, im) of a real field: one
    device's :func:`..ops.transform.rfftn` of the whole field, or on a
    slab mesh :func:`rfftn_slab` of this rank's x slab (its ky slab of the
    whole field's spectrum)."""
    if mesh is None:
        from randomfield_tpu_torch.ops import transform as _transform

        return _transform.rfftn(x)
    nx, ny, nz = (int(n) for n in x.shape[-3:])
    return rfftn_slab(x, (nx * mesh.size, ny, nz), mesh)


def inverse(re, im, shape, mesh=None):
    """The Hermitian c2r of a packed spectrum (``norm='forward'``, unit
    weights): one device's :func:`..ops.transform.irfftn_reim`, or on a
    slab mesh :func:`irfftn_slab_reim` of this rank's ky slab (its x slab
    of the field).  ``re``/``im`` are consumed."""
    if mesh is None:
        from randomfield_tpu_torch.ops import transform as _transform

        return _transform.irfftn_reim(re, im, shape)
    ones = torch.ones(shape[2], dtype=torch.float32, device=re.device)
    return irfftn_slab_reim(re, im, shape, mesh, ones)
