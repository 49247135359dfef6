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
"""

from __future__ import annotations

import torch

from randomfield_tpu_torch.ops import threefry as _threefry

__all__ = ["canonical_chunks", "unit_draws_reim", "canonical_bits_reim",
           "plane_draws_reim", "CANONICAL_CHUNK_TARGET"]

# x-slab chunk target of the canonical stream (randomfield_tpu/ops/sample.py)
CANONICAL_CHUNK_TARGET = 16


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
