"""The canonical Threefry unit-normal draws of a packed half-spectrum.

Port of ``canonical_chunks`` and ``unit_draws_reim`` of
``randomfield_tpu/ops/sample.py``.  The JAX package pins one realization
family for every Threefry pipeline: chunk i of ``canonical_chunks(nx)``
x-slabs draws

    normal(fold_in(key, i), (2, cx, nzh, ny))      (x, kz, y) order

and each chunk is swapped to the packed (x, y, kz) order.  The port draws
the same numbers (:mod:`randomfield_tpu_torch.ops.threefry`), so a seed
renders the same field in both packages.

A slab mesh draws only its ky rows: each element is drawn at the counter
it has in the full chunk, never at a counter of a slab-shaped array of its
own, so the union of the slabs is the single-device draw bit for bit.

This is the plain int64 PyTorch form of the stream.  On the card the
default render draws it inside K2's fused kernel
(:func:`..ops.sampler.draw_scale`, ``csrc/draw_scale.cu``); the functions
here are its plain version and the CPU path.

The resolution-nested stream of ``sampler='nested'`` (port of the JAX
package's ``nested_unit_draws`` and its callers) draws each mode from its
signed lattice indices instead of its array position: the two Threefry
words of mode (sx, sy, kz) are ``threefry2x32(key(seed), (code, 0))`` with
``code = (sx & 1023) << 20 | (sy & 1023) << 10 | kz``, so grids of
different size over one box share every common mode's draw (zoom
matching).  The fixed fields (Angulo & Pontzen 2016) keep each Hermitian
draw's phase and pin its modulus.  On the card the nested draws are K1's
kernel on that stream (``csrc/sample_modes.cu``, ``sampler.sample_nested``)
and the canonical fixed draws a mode of K2's fused kernel
(``sampler.draw_fixed``); the functions below are their plain versions.
Each applies K2's amplitude (sigma from the scene's uniform table, the
filter, a gain) to the draws after the plane fix, in the kernels' order;
the JAX package multiplies by a per-mode sigma grid instead.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import threefry as _threefry
from randomfield_tpu_torch.ops import transform as _transform

__all__ = ["canonical_chunks", "unit_draws_reim", "canonical_bits_reim",
           "plane_draws_reim", "CANONICAL_CHUNK_TARGET", "NESTED_MAX_DIM",
           "lattice_codes", "nested_bits", "nested_unit_draws",
           "nested_hermitian_draws", "sample_unit_hermitian",
           "sample_unit_hermitian_nested", "sample_spectrum_nested",
           "unit_phase", "sample_fixed_spectrum"]

# x-slab chunk target of the canonical stream (randomfield_tpu/ops/sample.py)
CANONICAL_CHUNK_TARGET = 16
# Per-axis size bound of the nested stream: signed lattice indices are
# packed into 10-bit two's-complement fields of a 30-bit counter word, so
# each axis must satisfy |index| < 512, i.e. n <= 1024.
NESTED_MAX_DIM = 1024
# the nested stream's Box-Muller constants, rounded to float32 as JAX rounds
# them: 24-bit uniforms with a half-ulp offset on both, and 2 pi
_INV_2_24 = float(np.float32(2.0 ** -24))
_HALF_INV_2_24 = float(np.float32(2.0 ** -25))
_TWO_PI32 = float(np.float32(2.0 * np.pi))
_INV_SQRT2 = float(np.float32(0.7071067811865476))
_SQRT2 = float(np.float32(np.sqrt(2.0)))
# x planes per step of the nested plain draws (bounds the int64 temporaries)
_X_CHUNK = 64


def canonical_chunks(nx: int) -> int:
    """Chunk count of the canonical stream: the largest divisor of nx <= 16."""
    for c in range(min(CANONICAL_CHUNK_TARGET, nx), 0, -1):
        if nx % c == 0:
            return c
    return 1


def unit_draws_reim(key, shape, device="cpu", y_off=0, ny_loc=None):
    """Unit normal draws as float32 (nx, ny_loc, nzh) re and im lattices.

    ``key`` is a Threefry key pair (:func:`threefry.key_from_seed`); ky
    rows [y_off, y_off + ny_loc) of the canonical stream, all of them by
    default.  Only one chunk's Threefry temporaries exist at a time; at
    1024^3 that is about 0.5 GB per int64 word lattice of a 64-plane chunk.
    """
    return _canonical(key, shape, _threefry.normal_at, torch.float32, device,
                      y_off, ny_loc)


def canonical_bits_reim(key, shape, device="cpu", y_off=0, ny_loc=None):
    """The bits under :func:`unit_draws_reim`: int64 (nx, ny_loc, nzh) re
    and im lattices of uint32 values, ``jax.random.bits`` at the same
    counters."""
    return _canonical(key, shape, _threefry.bits_at, torch.int64, device,
                      y_off, ny_loc)


def plane_draws_reim(key, shape, kz, device="cpu"):
    """The unit draws of the whole kz plane ``kz``: float32 (nx, ny) re and
    im, the values :func:`unit_draws_reim` has there."""
    re, im = _canonical(key, shape, _threefry.normal_at, torch.float32,
                        device, 0, None, kz)
    return re[..., 0], im[..., 0]


def _canonical(key, shape, draw, dtype, device, y_off, ny_loc, kz=None):
    """``draw(fold_in(key, i), idx)`` at the canonical counters of ky rows
    [y_off, y_off + ny_loc) and every kz (or the one plane ``kz``), as
    (nx, ny_loc, nzh or 1) re and im lattices of ``dtype``."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    if not 0 <= y_off <= ny - ny_loc:
        raise ValueError(f"ky rows [{y_off}, {y_off + ny_loc}) lie outside "
                         f"the grid {tuple(shape)}")
    chunks = canonical_chunks(nx)
    cx = nx // chunks
    zs = (torch.arange(nzh, dtype=torch.int64, device=device) if kz is None
          else torch.tensor([kz], dtype=torch.int64, device=device))
    re = torch.empty((nx, ny_loc, zs.numel()), dtype=dtype, device=device)
    im = torch.empty_like(re)
    # flat index of element (c, x, kz, y) in the (2, cx, nzh, ny) chunk
    rows = torch.arange(2 * cx, dtype=torch.int64, device=device)
    rows = (rows[:, None] * nzh + zs[None, :]).flatten()
    ys = torch.arange(y_off, y_off + ny_loc, dtype=torch.int64, device=device)
    idx = (rows[:, None] * ny + ys[None, :]).view(2, cx, zs.numel(), ny_loc)
    for i in range(chunks):
        d = draw(_threefry.fold_in(key, i), idx)
        re[i * cx:(i + 1) * cx] = d[0].transpose(1, 2)
        im[i * cx:(i + 1) * cx] = d[1].transpose(1, 2)
    return re, im


# ---- the resolution-nested stream ----------------------------------------------

def _check_nested(shape):
    if max(shape) > NESTED_MAX_DIM:
        raise ValueError(
            f"nested sampling packs signed indices into 10 bits per axis: "
            f"max dim is {NESTED_MAX_DIM}, got {tuple(shape)}")


def _code_fields(idx, n):
    """The signed index of each array index along an axis of length n
    (numpy's fft order: the Nyquist row is -n/2), as a 10-bit field."""
    return torch.where(idx < (n + 1) // 2, idx, idx - n) & 1023


def lattice_codes(shape, device="cpu", x_off=0, nx_loc=None, y_off=0,
                  ny_loc=None):
    """The 30-bit code of every packed mode of x rows [x_off, x_off + nx_loc)
    and ky rows [y_off, y_off + ny_loc) (all by default): int64 (nx_loc,
    ny_loc, nz//2+1) tensors of
    ``(sx & 1023) << 20 | (sy & 1023) << 10 | kz``, the signed integer
    lattice indices (the wavenumbers in units of each axis' fundamental), so
    grids of different size over one box give every shared mode one code.
    Raises ValueError for an axis above :data:`NESTED_MAX_DIM`."""
    nx, ny, nz = shape
    _check_nested(shape)
    nx_loc = nx - x_off if nx_loc is None else nx_loc
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    ix = torch.arange(x_off, x_off + nx_loc, dtype=torch.int64, device=device)
    iy = torch.arange(y_off, y_off + ny_loc, dtype=torch.int64, device=device)
    iz = torch.arange(nz // 2 + 1, dtype=torch.int64, device=device)
    return ((_code_fields(ix, nx) << 20)[:, None, None]
            | (_code_fields(iy, ny) << 10)[None, :, None] | iz[None, None, :])


def nested_bits(key, codes):
    """``(b1, b2)``, the two Threefry-2x32 words of each code under ``key``:
    the hash of the counter words (code, 0), as the JAX package's raw
    ``threefry_2x32`` call over ``concat([codes, zeros])`` pairs them.
    Int64 tensors of uint32 values, shaped as ``codes``."""
    return _threefry.threefry2x32(key, codes, torch.zeros_like(codes))


def _box_muller(b1, b2):
    """The nested stream's unit normals (re, im) of its bits: 24-bit
    uniforms u = (b >> 8) 2^-24 + 2^-25 in (0, 1), then r = sqrt(-2 ln u1),
    theta = 2 pi u2, (r cos theta, r sin theta), in float32."""
    u1 = (b1 >> 8).to(torch.float32) * _INV_2_24 + _HALF_INV_2_24
    u2 = (b2 >> 8).to(torch.float32) * _INV_2_24 + _HALF_INV_2_24
    r = torch.sqrt(-2.0 * torch.log(u1))
    theta = _TWO_PI32 * u2
    return r * torch.cos(theta), r * torch.sin(theta)


def _nested_chunks(key, shape, device, fix, y_off=0, ny_loc=None):
    """(re, im) float32 (nx, ny_loc, nzh) of the nested stream on the ky
    rows [y_off, y_off + ny_loc) (all by default), drawn x-slab by x-slab;
    with ``fix`` the kz = 0 / Nyquist planes are made Hermitian as the
    kernel makes them: a mode that is not canonical draws its partner's
    code, im negated; a self-conjugate mode keeps re sqrt(2), im = 0."""
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    re = torch.empty((nx, ny_loc, nzh), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    planes = _grid.self_conjugate_kz_planes(nz) if fix else ()
    ys = torch.arange(y_off, y_off + ny_loc, dtype=torch.int64, device=device)
    for x0 in range(0, nx, _X_CHUNK):
        n = min(_X_CHUNK, nx - x0)
        codes = lattice_codes(shape, device, x0, n, y_off, ny_loc)
        xs = torch.arange(x0, x0 + n, dtype=torch.int64, device=device)
        px = torch.where(xs == 0, 0, nx - xs)[:, None]
        py = torch.where(ys == 0, 0, ny - ys)[None, :]
        x, y = xs[:, None], ys[None, :]
        moved = (x > px) | ((x == px) & (y > py))
        self_conj = (x == px) & (y == py)
        partner = ((_code_fields(px, nx) << 20) | (_code_fields(py, ny) << 10))
        for p in planes:
            codes[..., p] = torch.where(moved, partner + p, codes[..., p])
        r, i = _box_muller(*nested_bits(key, codes))
        for p in planes:
            i[..., p] = torch.where(moved, -i[..., p], i[..., p])
            r[..., p] = torch.where(self_conj, r[..., p] * _SQRT2, r[..., p])
            i[..., p] = torch.where(self_conj, 0.0, i[..., p])
        re[x0:x0 + n], im[x0:x0 + n] = r, i
    return re, im


def nested_unit_draws(key, shape, device="cpu", y_off=0, ny_loc=None):
    """The nested stream's raw unit normals, float32 (nx, ny, nz//2+1) re
    and im: the state before the Hermitian fix and the scale, the contract
    of ``generate_noise`` for a nested scene (``generate_from_noise`` of
    them reproduces the nested render).  ``key``: a Threefry key pair
    (:func:`threefry.key_from_seed`), used raw, with no fold; ky rows
    [y_off, y_off + ny_loc), all by default."""
    _check_nested(shape)
    return _nested_chunks(key, shape, device, False, y_off, ny_loc)


def nested_hermitian_draws(key, shape, device="cpu", y_off=0, ny_loc=None):
    """:func:`nested_unit_draws` with the kz = 0 / Nyquist planes made
    Hermitian, each non-canonical mode at its partner's code: equal to
    :func:`.transform.symmetrize_with_shape_reim` of the raw draws bit for
    bit, and what the kernel draws before its scale (ky rows [y_off, y_off
    + ny_loc), all by default)."""
    _check_nested(shape)
    return _nested_chunks(key, shape, device, True, y_off, ny_loc)


def _hermitian_draws(key, shape, device, nested, y_off=0, ny_loc=None):
    """The unit draws of the canonical or the nested stream with the kz = 0
    / Nyquist planes made Hermitian (a self-conjugate mode re sqrt(2)), on
    the ky rows [y_off, y_off + ny_loc) (all by default).  A canonical
    block of fewer rows than the grid's is fixed from its whole planes,
    drawn at their own counters, so it needs no mesh."""
    nx, ny, nz = shape
    ny_loc = ny - y_off if ny_loc is None else ny_loc
    if nested:
        return nested_hermitian_draws(key, shape, device, y_off, ny_loc)
    re, im = unit_draws_reim(key, shape, device, y_off, ny_loc)
    if ny_loc == ny:
        return _transform.symmetrize_with_shape_reim(re, im, nz)
    rows = slice(y_off, y_off + ny_loc)
    for p in _grid.self_conjugate_kz_planes(nz):
        fre, fim = _transform.symmetrize_plane_reim(
            *plane_draws_reim(key, shape, p, device))
        re[..., p] = fre[:, rows]
        im[..., p] = fim[:, rows]
    return re, im


def sample_unit_hermitian(key, shape, device="cpu", nested=False):
    """Unit-variance Hermitian noise on the packed half-spectrum, (re, im)
    float32: each mode (x + i y)/sqrt(2) of its unit normals x, y, the
    self-conjugate planes made Hermitian (a self-conjugate mode real at
    unit variance), so <|z|^2> = 1.  The canonical stream, or with
    ``nested`` the nested one."""
    re, im = _hermitian_draws(key, shape, device, nested)
    return re.mul_(_INV_SQRT2), im.mul_(_INV_SQRT2)


def sample_unit_hermitian_nested(key, shape, device="cpu"):
    """:func:`sample_unit_hermitian` on the nested stream: each mode's draw
    a pure function of the seed and its signed lattice indices, so grids
    of different size over one box share every common mode below the
    coarse grid's Nyquist (its Nyquist plane is self-conjugate there and
    regular at twice the size, so it cannot be shared)."""
    return sample_unit_hermitian(key, shape, device, nested=True)


def sample_spectrum_nested(key, table, shape, spacing, smoothing_length=0.0,
                           y_off=0, ny_loc=None):
    """The nested spectrum (re, im): :func:`nested_hermitian_draws` times
    K2's amplitude with the draws' 1/sqrt(2) as its gain
    (``sampler.scale_sigma_plain``), the kernel's order of float32
    operations.  ``table``: the scene's ``sampler.SigmaTable``, whose
    device the draws are made on; ky rows [y_off, y_off + ny_loc), all by
    default."""
    from randomfield_tpu_torch.ops import sampler as _sampler

    re, im = nested_hermitian_draws(key, shape, table.knots.device, y_off,
                                    ny_loc)
    return _sampler.scale_sigma_plain(re, im, table, shape, spacing,
                                      smoothing_length, y_off=y_off,
                                      gain=_INV_SQRT2)


def unit_phase(re, im):
    """z -> z / |z| IN PLACE over (re, im), |z| = sqrt(re^2 + im^2) in
    float32, and 1 where |z| = 0: a self-conjugate mode (im = 0) becomes
    its sign exactly.  Returns (re, im)."""
    for x0 in range(0, re.shape[0], _X_CHUNK):
        r, i = re[x0:x0 + _X_CHUNK], im[x0:x0 + _X_CHUNK]
        mag = torch.sqrt(r * r + i * i)
        live = mag > 0
        safe = torch.where(live, mag, 1.0)
        r.copy_(torch.where(live, r / safe, 1.0))
        i.copy_(torch.where(live, i / safe, 0.0))
    return re, im


def sample_fixed_spectrum(key, table, shape, spacing, smoothing_length=0.0,
                          flip=False, nested=False, y_off=0, ny_loc=None):
    """A 'fixed' spectrum (re, im) (Angulo & Pontzen 2016): |c_k| =
    sigma(k) times the filter EXACTLY, the phase of the seed's Hermitian
    draw kept.  The draw after the plane fix -> :func:`unit_phase` (a
    self-conjugate mode becomes its sign) -> K2's amplitude with gain 1,
    or -1 with ``flip`` (the paired realization, every phase shifted by
    pi: the exact negation).  The canonical stream, or with ``nested`` the
    nested one; ky rows [y_off, y_off + ny_loc), all by default."""
    from randomfield_tpu_torch.ops import sampler as _sampler

    re, im = _hermitian_draws(key, shape, table.knots.device, nested, y_off,
                              ny_loc)
    unit_phase(re, im)
    return _sampler.scale_sigma_plain(re, im, table, shape, spacing,
                                      smoothing_length, y_off=y_off,
                                      gain=-1.0 if flip else 1.0)
