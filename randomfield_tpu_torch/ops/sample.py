"""The canonical Threefry unit-normal draws of a packed half-spectrum.

Port of ``canonical_chunks`` and ``unit_draws_reim`` of
``randomfield_tpu/ops/sample.py``.  The JAX package pins one realization
family for every Threefry pipeline: chunk i of ``canonical_chunks(nx)``
x-slabs draws

    normal(fold_in(key, i), (2, cx, nzh, ny))      (x, kz, y) order

and each chunk is swapped to the packed (x, y, kz) order.  The port draws
the same numbers (:mod:`randomfield_tpu_torch.ops.threefry`), so a seed
renders the same field in both packages.
"""

from __future__ import annotations

import torch

from randomfield_tpu_torch.ops import threefry as _threefry

__all__ = ["canonical_chunks", "unit_draws_reim", "CANONICAL_CHUNK_TARGET"]

# x-slab chunk target of the canonical stream (randomfield_tpu/ops/sample.py)
CANONICAL_CHUNK_TARGET = 16


def canonical_chunks(nx: int) -> int:
    """Chunk count of the canonical stream: the largest divisor of nx <= 16."""
    for c in range(min(CANONICAL_CHUNK_TARGET, nx), 0, -1):
        if nx % c == 0:
            return c
    return 1


def unit_draws_reim(key, shape, device="cpu"):
    """Unit normal draws as float32 (nx, ny, nzh) re and im lattices.

    ``key`` is a Threefry key pair (:func:`threefry.key_from_seed`).  Only
    one chunk's Threefry temporaries exist at a time; at 1024^3 that is
    about 0.5 GB per int64 word lattice of a 64-plane chunk.
    """
    nx, ny, nz = shape
    nzh = nz // 2 + 1
    chunks = canonical_chunks(nx)
    cx = nx // chunks
    re = torch.empty((nx, ny, nzh), dtype=torch.float32, device=device)
    im = torch.empty_like(re)
    for i in range(chunks):
        d = _threefry.normal(_threefry.fold_in(key, i), (2, cx, nzh, ny), device)
        re[i * cx:(i + 1) * cx] = d[0].transpose(1, 2)
        im[i * cx:(i + 1) * cx] = d[1].transpose(1, 2)
    return re, im
