"""Catalog painting onto a slab mesh: each rank's x slab of the contrast.

Port of the slab branch of ``randomfield_tpu/parallel/paint.py``
(``paint_sharded``, ``:178 _make_paint``, ``:221 _axis_owner``).  Every
rank takes the whole catalog, as the JAX function does, and paints the
particles it owns:

* the fixed-point exponent comes from the whole catalog's total |w|
  (:func:`..ops.paint.fixed_point_exponent`), the one a single-device
  ``paint`` picks, with no collective (every rank holds the catalog);
* KP deposits onto the rank's x window, its nx/P planes and a margin of
  m planes a side (0 for NGP, 1 for CIC and TSC): the owner of a particle
  is the rank whose planes hold its reference cell, selected in the kernel
  (:func:`..ops.paint.deposit` with ``x_rows``; the plain version selects
  with :func:`..ops.paint.axis_owner`, the port's copy of ``_axis_owner``);
* the margins fold into the neighbours as int64 through one ring exchange
  (:meth:`..parallel.mesh.SlabMesh.ring_exchange`), onto the rank itself on
  one rank;
* the int64 total is all-reduced, exactly, and KPC forms the contrast with
  the whole grid's mean.

Integer sums do not depend on their order, so a rank's int64 rows equal the
single-device deposit's rows bit for bit, and its contrast equals the
single-device ``paint``'s rows bit for bit (the JAX package sums in float32
scatter-adds and holds its mesh painter within 1e-7).
"""

from __future__ import annotations

import torch

from randomfield_tpu_torch.ops import paint as _paint
from randomfield_tpu_torch.parallel import mesh as _mesh

__all__ = ["paint_sharded", "deposit_sharded", "fold_margins"]


def fold_margins(window, order, mesh):
    """A rank's (nx/P, ny, nz) int64 rows of a deposit from its x window
    (nx/P + 2m, ny, nz): the left margin added to the last planes of rank
    - 1 and the right one to the first planes of rank + 1 (periodic; one
    rank adds them to itself)."""
    m = _paint.margin(order)
    if m == 0:
        return window
    from_next, from_prev = mesh.ring_exchange(window[:m].contiguous(),
                                              window[-m:].contiguous())
    core = window[m:-m]
    core[-m:] += from_next
    core[:m] += from_prev
    return core


def deposit_sharded(positions, shape, spacing, mesh, weights=1.0, order=2,
                    shift=0.0, scale_exp=0):
    """(this rank's int64 (nx/P, ny, nz) rows of :func:`..ops.paint.deposit`
    of the whole catalog, the whole grid's int64 total as an int): KP on the
    rank's x window, the margins folded, the total all-reduced."""
    shape = tuple(int(s) for s in shape)
    x0, nx_loc = mesh.rows(shape[0])
    window, total = _paint._deposit(positions, shape, spacing, weights,
                                    order, shift, scale_exp, (x0, nx_loc))
    total = window.sum().reshape(1) if total is None else total
    rows = fold_margins(window, order, mesh)
    return rows, int(mesh.all_reduce_sum(total))


def paint_sharded(positions, shape, spacing, mesh, weights=1.0,
                  window="cic", shift=0.0):
    """Mass-assign a particle catalog onto a slab mesh -> ``(delta, w_mean)``.

    ``positions``: (3, ...) float32 comoving Mpc/h, the whole catalog on
    every rank (numpy or torch; it moves to the mesh's device);
    ``weights``: a scalar or one a particle; ``window``: 'ngp', 'cic' or
    'tsc'; ``shift``: added to every coordinate before the division by the
    spacing (the interlacing offset, as :func:`..ops.paint.paint` takes it).
    Returns this rank's float32 (nx/P, ny, nz) x slab of the contrast and
    the whole grid's mean mass a cell (a float), as
    :func:`..models.zeldovich.paint` returns the whole grid.  A pencil mesh
    raises NotImplementedError (ROADMAP.md, Queue 1 item 5).
    """
    from randomfield_tpu_torch.models import zeldovich as _zel

    mesh = _mesh.require_slab(mesh)
    if window not in _paint.ORDERS:
        raise ValueError(
            f"window must be 'ngp', 'cic' or 'tsc', got {window!r}")
    shape = tuple(int(s) for s in shape)
    nx, ny, nz = shape
    if nx % mesh.size:
        raise ValueError(f"nx={nx} not divisible by space={mesh.size}")
    pos = _zel._as_positions(positions).to(mesh.device)
    w = _zel._as_weights(weights, pos)
    order = _paint.ORDERS[window]
    s = _paint.fixed_point_exponent(_paint.total_abs_weight(pos, w))
    rows, total = deposit_sharded(pos, shape, float(spacing), mesh, w, order,
                                  float(shift), s)
    return _paint._contrast(rows, s, total, nx * ny * nz)
