"""KP: mass assignment (NGP, CIC, TSC) of particles onto a periodic grid.

The port of ``randomfield_tpu/models/zeldovich.py:_paint``, where the JAX
package scatter-adds float32 window weights in XLA.  Here the weights are
rounded once to int64 counts of 2^-s units and added as integers:

* :func:`deposit` (``csrc/paint.cu``, counter ``KP_LAUNCHES``): the int64
  (nx, ny, nz) sums of every particle's 1, 8 or 27 window weights, with
  ``shift`` (the interlacing offset a/2) added to the positions in the
  kernel and a scalar weight passed as one value;
* :func:`contrast` (the last kernel of ``csrc/paint.cu``, counter
  ``KPC_LAUNCHES``): float32 ``(acc 2^-s) (1 / mean) - 1`` and the mean
  mass;
* :func:`paint`: both, with s from :func:`fixed_point_exponent`; on CUDA
  the mean's exact int64 total comes from the deposit's own blocks, so the
  grid is not read again for it.

Integer adds are associative, so a deposit does not depend on the order
of its additions: the kernel equals its plain version
(:func:`deposit_plain`, ``index_add_`` of the same int64 terms) bit for
bit, and two calls give the same bits.  Every float32 operation of a
particle is rounded in the reference's order (:func:`window_terms`):
u = (x + shift) / a, divided and not multiplied by 1/a, the cell-centred
u - 1/2 of CIC and TSC, TSC's round half to even, Python's non-negative
modulo for the wrap, NGP's floor before it.  On CUDA tensors each wrapper
launches its kernels or raises; on CPU tensors it runs the plain version.

On a slab mesh a rank deposits onto its x window (``x_rows=(x0,
nx_loc)``): its nx_loc owned planes of the whole grid and a margin of
:func:`margin` planes a side (:func:`window_shape`), with every operation
of a particle as on the whole grid.  A particle belongs to the rank whose
planes hold its reference cell (:func:`axis_owner`, the JAX package's
``parallel/paint.py:221 _axis_owner`` rule), so the kernel skips the
others where it counts them (counted in ``KPS_LAUNCHES``); the plain
version selects them with :func:`axis_owner` in numpy.  Folding the margins
into the neighbours' planes (``parallel/paint.py:paint_sharded``) gives the
whole grid's rows bit for bit.

The kernel bins the particles by the tile of TILE^3 cells that holds the
lowest cell of their window (the anchor), sums each tile in shared memory
over the tile and its shell (the r = order - 1 layers past its far
faces), writes its own cells once and its shell to a scratch slot, and
lets each cell gather the shell slots that land on it
(``csrc/paint.cu``).  :func:`tile_plan_plain` replays that plan in plain
PyTorch, step by step, for the tests; nothing on the CUDA path calls it.
"""

from __future__ import annotations

import math
import typing

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build

__all__ = ["deposit", "deposit_plain", "contrast", "contrast_plain",
           "paint", "window_terms", "fixed_point_exponent", "total_abs_weight",
           "tile_plan_plain", "TilePlan", "tile_grid", "shell_slots",
           "axis_owner", "margin", "window_shape",
           "ORDERS", "TILE", "KP_LAUNCHES", "KPS_LAUNCHES", "KPC_LAUNCHES"]

# kernel launches by deposit on the whole grid and on an x window, and by
# contrast (the CPU path does not count)
KP_LAUNCHES = 0
KPS_LAUNCHES = 0
KPC_LAUNCHES = 0

ORDERS = {"ngp": 1, "cic": 2, "tsc": 3}
# particles a step of the plain version (bounds its temporaries)
_CHUNK = 1 << 22
# the side of the kernel's tiles (csrc/paint.cu:kTile)
TILE = 16
# a shell slot no tile writes, in the plan's replay: no sum reaches it
_POISON = 1 << 62


def fixed_point_exponent(total_abs_weight):
    """s with total_abs_weight 2^s <= 2^61: no cell's sum and no total of
    the int64 counts can overflow (each term adds at most half a unit of
    rounding, far below the 2^61 of headroom)."""
    total = float(total_abs_weight)
    if not total > 0 or not math.isfinite(total):
        return 0
    return 61 - math.ceil(math.log2(total))


def _positions(positions):
    """(float32 (3, n) view, the trailing shape) of (3, ...) positions."""
    positions = torch.as_tensor(positions)
    if positions.ndim < 2 or positions.shape[0] != 3:
        raise ValueError(f"positions must be (3, ...), got "
                         f"{tuple(positions.shape)}")
    if positions.dtype != torch.float32:
        raise ValueError(f"positions must be float32, got {positions.dtype}")
    return positions.reshape(3, -1), tuple(positions.shape[1:])


def _weights(weights, trailing, device):
    """(scalar weight, None) or (None, float32 (n,) tensor of the weights
    broadcast to the positions' trailing shape)."""
    w = torch.as_tensor(weights)
    if w.ndim == 0:
        return float(w.to(torch.float32)), None
    w = torch.broadcast_to(w.to(device=device, dtype=torch.float32), trailing)
    return None, w.reshape(-1).contiguous()


def window_terms(u, order):
    """The window of particles at grid coordinates ``u`` (float32 (3, n),
    already (x + shift) / a): a list of (per-axis cell index int64 (3, n),
    per-axis float32 factor (3, n)) corners, 1, 8 or 27 of them, in the
    kernel's corner order; the weight of a corner is w times the factors of
    x, y and z, in that order."""
    if order == 1:
        return [(torch.floor(u).to(torch.int64), None)]
    uc = u - 0.5
    if order == 2:
        i0 = torch.floor(uc).to(torch.int32)
        f = uc - i0.to(torch.float32)
        side = (1.0 - f, f)
        return [(i0.to(torch.int64) + torch.tensor(
                    [(c >> a) & 1 for a in range(3)], device=u.device)[:, None],
                 torch.stack([side[(c >> a) & 1][a] for a in range(3)]))
                for c in range(8)]
    i0 = torch.round(uc).to(torch.int32)
    s = uc - i0.to(torch.float32)
    lo, hi = 0.5 - s, 0.5 + s
    w3 = (0.5 * (lo * lo), 0.75 - s * s, 0.5 * (hi * hi))
    out = []
    for c in range(27):
        off = [(c // 3 ** a) % 3 for a in range(3)]
        out.append((i0.to(torch.int64) + torch.tensor(
            [o - 1 for o in off], device=u.device)[:, None],
            torch.stack([w3[off[a]][a] for a in range(3)])))
    return out


def _flat(idx, dims):
    flat = torch.zeros_like(idx[0])
    for a in range(3):
        flat = flat * dims[a] + torch.remainder(idx[a], dims[a])
    return flat


def margin(order):
    """The planes an x window holds past each side of its own: the window's
    reach past the reference cell (0 for NGP, 1 for CIC and TSC)."""
    return 0 if int(order) == 1 else 1


def window_shape(shape, order, x_rows=None):
    """The grid a deposit writes: ``shape``, or with ``x_rows=(x0,
    nx_loc)`` the x window (nx_loc + 2 margin, ny, nz)."""
    dims = tuple(int(d) for d in shape)
    if x_rows is None:
        return dims
    return (int(x_rows[1]) + 2 * margin(order), dims[1], dims[2])


def axis_owner(u_axis, n_axis, n_loc, order):
    """(owner, reference cell) of particles at grid coordinates ``u_axis``
    (float32 numpy) along a sharded axis of ``n_axis`` cells in blocks of
    ``n_loc``: the port's copy of ``randomfield_tpu/parallel/paint.py:221
    _axis_owner``, whose reference cell is NGP's floor(u), CIC's floor(u -
    1/2) and TSC's round(u - 1/2) (half to even), its owner the block that
    holds it wrapped.  The JAX function also returns the coordinates
    shifted into its painter's frame; here the reference cell places the
    particle (:func:`deposit_plain`)."""
    u = np.asarray(u_axis, np.float32)
    if order == 1:
        ref = np.floor(u)
    elif order == 2:
        ref = np.floor(u - np.float32(0.5))
    else:
        ref = np.round(u - np.float32(0.5))
    ref = ref.astype(np.int64)
    return (ref % n_axis) // n_loc, ref


def _check_rows(x_rows, shape):
    x0, nx_loc = (int(v) for v in x_rows)
    if nx_loc < 1 or x0 < 0 or x0 + nx_loc > int(shape[0]):
        raise ValueError(f"x_rows {tuple(x_rows)} must be a block of the "
                         f"grid's {int(shape[0])} x planes")
    return x0, nx_loc


def deposit_plain(positions, shape, spacing, weights=1.0, order=2,
                  shift=0.0, scale_exp=0, x_rows=None):
    """:func:`deposit` in plain PyTorch on the positions' device: per chunk
    of particles and window corner, the float32 weight rounded to int64
    units of 2^-scale_exp and ``index_add_`` into the grid.  With
    ``x_rows`` the particles the window owns (:func:`axis_owner`, in numpy
    on the host) onto the x window, each at its reference cell's plane."""
    pos, trailing = _positions(positions)
    n = pos.shape[1]
    w0, w = _weights(weights, trailing, pos.device)
    dims = tuple(int(d) for d in shape)
    out = window_shape(dims, order, x_rows)
    if x_rows is not None:
        x0, nx_loc = _check_rows(x_rows, dims)
    grid = torch.zeros(math.prod(out), dtype=torch.int64, device=pos.device)
    scale = math.ldexp(1.0, int(scale_exp))
    spacing32 = torch.tensor(float(spacing), dtype=torch.float32)
    shift32 = torch.tensor(float(shift), dtype=torch.float32)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        u = (pos[:, lo:hi] + shift32.to(pos.device)) / spacing32.to(pos.device)
        wt = (w[lo:hi] if w is not None
              else torch.full((hi - lo,), w0, dtype=torch.float32,
                              device=pos.device))
        for idx, fac, wt_c in _terms(u, wt, order, dims[0], x_rows):
            wc = wt_c
            if fac is not None:
                for a in range(3):
                    wc = wc * fac[a]
            q = torch.round(wc.to(torch.float64) * scale).to(torch.int64)
            grid.index_add_(0, _flat(idx, out), q)
    return grid.view(out)


def _terms(u, wt, order, nx, x_rows):
    """:func:`window_terms` of particles at ``u`` with weights ``wt``, as
    (cell indices, factors, weights) corners: on the whole grid, or of the
    particles the x window ``x_rows`` owns (:func:`axis_owner`, on the
    host), their x index moved to the window's plane, the reference cell at
    its owned place plus the margin."""
    if x_rows is None:
        return [(idx, fac, wt) for idx, fac in window_terms(u, order)]
    x0, nx_loc = (int(v) for v in x_rows)
    owner, ref = axis_owner(u[0].cpu().numpy(), nx, nx_loc, order)
    mine = torch.as_tensor(owner == x0 // nx_loc, device=u.device)
    ref = torch.as_tensor(ref, device=u.device)[mine]
    move = torch.remainder(ref, nx) - x0 + margin(order) - ref
    return [(torch.cat([(idx[0] + move)[None], idx[1:]]), fac, wt[mine])
            for idx, fac in window_terms(u[:, mine], order)]


def tile_grid(shape, tile=TILE):
    """Tiles along each axis: ceil(n / tile)."""
    return tuple(-(-int(d) // tile) for d in shape)


def shell_slots(shape, order, tile=TILE):
    """A tile's scratch slots for its shell, the r = order - 1 layers past
    its far faces: three slabs (x, then y, then z) laid out with the
    largest tile's strides (``csrc/paint.cu:Shell``); 0 for NGP."""
    r = int(order) - 1
    bx, by, bz = (min(int(d), tile) for d in shape)
    return r * (by + r) * (bz + r) + bx * r * (bz + r) + bx * by * r


def _deposit(positions, shape, spacing, weights, order, shift, scale_exp,
             x_rows=None):
    """(:func:`deposit`'s grid, the int64 total of every term as a (1,)
    tensor on the card, or None on the CPU)."""
    global KP_LAUNCHES, KPS_LAUNCHES
    pos, trailing = _positions(positions)
    if int(order) not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order!r}")
    window = (0, 0) if x_rows is None else _check_rows(x_rows, shape)
    if pos.device.type == "cpu":
        return deposit_plain(positions, shape, spacing, weights, order, shift,
                             scale_exp, x_rows), None
    if pos.device.type != "cuda":
        raise ValueError(f"deposit runs on cpu or cuda, not {pos.device}")
    n, order = pos.shape[1], int(order)
    w0, w = _weights(weights, trailing, pos.device)
    pos = pos.contiguous()
    gnx = int(shape[0])
    dims = window_shape(shape, order, x_rows)
    tiles = math.prod(tile_grid(dims))
    if tiles >= 2 ** 31:
        raise ValueError(f"deposit takes fewer than 2^31 tiles of {TILE}^3 "
                         f"cells, not {tiles} ({dims})")
    dev, lib = pos.device, _build.library()
    stream = _build.current_stream(pos)
    counts = torch.zeros(tiles, dtype=torch.int64, device=dev)
    _build.check(lib.rf_paint_count(
        pos.data_ptr(), n, *dims, float(spacing), float(shift), order, TILE,
        *window, gnx, counts.data_ptr(), stream), "deposit")
    cursor = torch.cumsum(counts, 0)
    index = torch.empty(n, dtype=torch.int32 if n < 2 ** 31 else torch.int64,
                        device=dev)
    shell = torch.empty(tiles * shell_slots(dims, order), dtype=torch.int64,
                        device=dev)
    grid = torch.empty(dims, dtype=torch.int64, device=dev)
    total = torch.zeros(1, dtype=torch.int64, device=dev)
    status = lib.rf_paint_deposit(
        pos.data_ptr(), 0 if w is None else w.data_ptr(),
        0.0 if w0 is None else w0, n, *dims, float(spacing), float(shift),
        math.ldexp(1.0, int(scale_exp)), order, TILE, *window, gnx,
        counts.data_ptr(), cursor.data_ptr(), index.data_ptr(),
        index.element_size(), shell.data_ptr(), grid.data_ptr(),
        total.data_ptr(), stream)
    _build.check(status, "deposit")
    if x_rows is None:
        KP_LAUNCHES += 1
    else:
        KPS_LAUNCHES += 1
    return grid, total


def deposit(positions, shape, spacing, weights=1.0, order=2, shift=0.0,
            scale_exp=0, x_rows=None):
    """KP: int64 (nx, ny, nz) window sums of the particles, in units of
    2^-scale_exp; with ``x_rows=(x0, nx_loc)`` those of the particles the
    x window owns, on the window (:func:`window_shape`).

    ``positions``: float32 (3, ...) in length units (any trailing shape);
    ``weights``: a scalar, or a float32 tensor of one weight a particle;
    ``order``: 1, 2 or 3 (NGP, CIC, TSC); ``shift``: added to every
    coordinate (in float32, before the division by ``spacing``).  On CUDA
    this launches ``csrc/paint.cu``'s passes (count, scatter, deposit and,
    for CIC and TSC, the shell gather), with int64 temporaries of a count
    and a cursor a tile, :func:`shell_slots` a tile, and an index of 4
    bytes a particle (8 from 2^31 particles); on the CPU it runs
    :func:`deposit_plain`.
    """
    return _deposit(positions, shape, spacing, weights, order, shift,
                    scale_exp, x_rows)[0]


class TilePlan(typing.NamedTuple):
    """The kernel's plan of a deposit, replayed by :func:`tile_plan_plain`."""

    tiles: torch.Tensor   # int64 (n,): the tile of each particle's anchor
    counts: torch.Tensor  # int64 (T,): particles a tile
    starts: torch.Tensor  # int64 (T,): each tile's first slot in ``index``
    index: torch.Tensor   # int64 (n,): the particles, tile by tile
    local: torch.Tensor   # int64 (T, E, E, E): each tile's shared sums
    shell: torch.Tensor   # int64 (T, shell_slots): the shells' scratch
    grid: torch.Tensor    # int64 (nx, ny, nz): own cells + gathered shells
    total: int            # the sum of every term


def tile_plan_plain(positions, shape, spacing, weights=1.0, order=2,
                    shift=0.0, scale_exp=0, tile=TILE, x_rows=None):
    """``csrc/paint.cu``'s deposit replayed step by step in plain PyTorch
    on the positions' device, with tiles of ``tile``^3 cells (the kernel's
    are TILE^3): the anchors and their tiles, the counts and starts, the
    index grouped by tile, each tile's sums over its extended box of
    E = tile + r cells a side (its particles read through the index), its
    own cells written once, its shell written to its scratch slots (the
    unused ones hold a poison value no sum reaches, so a read of one
    shows), and each cell at a local place below r on some axis adding the
    shell slots that land on it.  With ``x_rows`` the plan of the x window
    (the owned particles, the window's grid).  Tests hold ``grid`` to
    :func:`deposit_plain` bit for bit; the CUDA path never calls this."""
    pos, trailing = _positions(positions)
    dev, n, order = pos.device, pos.shape[1], int(order)
    w0, w = _weights(weights, trailing, dev)
    dims = window_shape(shape, order, x_rows)
    ntile = tile_grid(dims, tile)
    count = math.prod(ntile)
    r, side = order - 1, tile + order - 1
    u = ((pos + torch.tensor(float(shift), dtype=torch.float32).to(dev))
         / torch.tensor(float(spacing), dtype=torch.float32).to(dev))
    wt = (w if w is not None
          else torch.full((n,), w0, dtype=torch.float32, device=dev))
    terms = _terms(u, wt, order, int(shape[0]), x_rows)
    corners = [(idx, fac) for idx, fac, _ in terms]
    wt = terms[0][2]
    anchor = torch.remainder(corners[0][0],
                             torch.tensor(dims, device=dev)[:, None])
    tid = ((anchor[0] // tile * ntile[1] + anchor[1] // tile) * ntile[2]
           + anchor[2] // tile)
    counts = torch.bincount(tid, minlength=count)
    starts = torch.cumsum(counts, 0) - counts
    index = torch.argsort(tid, stable=True)

    scale = math.ldexp(1.0, int(scale_exp))
    wt = wt[index]
    place = (anchor % tile)[:, index]
    local = torch.zeros(count * side ** 3, dtype=torch.int64, device=dev)
    for idx, fac in corners:
        cell = place + (idx - corners[0][0])[:, index]
        wc = wt
        if fac is not None:
            for a in range(3):
                wc = wc * fac[a][index]
        q = torch.round(wc.to(torch.float64) * scale).to(torch.int64)
        local.index_add_(0, tid[index] * side ** 3
                         + (cell[0] * side + cell[1]) * side + cell[2], q)
    local = local.view(count, side, side, side)

    coord = [torch.arange(d, device=dev) for d in dims]
    own = [(c // tile, c % tile) for c in coord]
    flat = ((own[0][0][_AXIS[0]] * ntile[1] + own[1][0][_AXIS[1]])
            * ntile[2] + own[2][0][_AXIS[2]])
    grid = local[flat, own[0][1][_AXIS[0]], own[1][1][_AXIS[1]],
                 own[2][1][_AXIS[2]]].clone()
    shell = torch.zeros((count, shell_slots(dims, order, tile)),
                        dtype=torch.int64, device=dev)
    if r:
        _write_shells(local, shell, dims, ntile, tile, r)
        _gather_shells(grid, shell, dims, ntile, tile, r, own)
    return TilePlan(tid, counts, starts, index, local, shell, grid,
                    int(local.sum()))


# an axis's coordinates broadcast along x, y or z of a grid
_AXIS = ((slice(None), None, None), (None, slice(None), None),
         (None, None, slice(None)))


def _write_shells(local, shell, dims, ntile, tile, r):
    """The deposit's shell stores: every tile's slots decoded as the kernel
    decodes them (the x slab, the y slab, the z slab; the kernel's
    ``Shell``), the unused ones poisoned."""
    dev = local.device
    bx, by, bz = (min(d, tile) for d in dims)
    ey, ez = by + r, bz + r
    t = torch.arange(shell.shape[0], device=dev)
    at = (t // (ntile[1] * ntile[2]), t // ntile[2] % ntile[1], t % ntile[2])
    ext = [torch.clamp(dims[a] - at[a] * tile, max=tile)[:, None]
           for a in range(3)]
    c = torch.arange(shell.shape[1], device=dev)
    slab_x, slab_y = r * ey * ez, bx * r * ez
    in_x, in_y = c < slab_x, (c >= slab_x) & (c < slab_x + slab_y)
    dy, dz = c - slab_x, c - slab_x - slab_y
    lx = torch.where(in_x, ext[0] + c // (ey * ez),
                     torch.where(in_y, dy // (r * ez), dz // (by * r)))
    ly = torch.where(in_x, c // ez % ey,
                     torch.where(in_y, ext[1] + dy // ez % r, dz // r % by))
    lz = torch.where(in_x, c % ez,
                     torch.where(in_y, dy % ez, ext[2] + dz % r))
    valid = torch.where(
        in_x, (ly < ext[1] + r) & (lz < ext[2] + r),
        torch.where(in_y, (lx < ext[0]) & (lz < ext[2] + r),
                    (lx < ext[0]) & (ly < ext[1])))
    top = local.shape[1] - 1
    value = local[t[:, None], lx.clamp(max=top), ly.clamp(max=top),
                  lz.clamp(max=top)]
    shell.copy_(torch.where(valid, value, torch.full_like(shell, _POISON)))


def _gather_shells(grid, shell, dims, ntile, tile, r, own):
    """The gather: for every cell and axis, the cell's own (tile, place) or
    a shell source (the tile whose far face lies j layers below it, when
    the cell's place is below r, as in the kernel); every combination but
    all-own adds its slot."""
    dev = grid.device
    bx, by, bz = (min(d, tile) for d in dims)
    ey, ez = by + r, bz + r
    choices = []  # per axis: [(valid, tile, place, depth)], the own first
    for a in range(3):
        x = torch.arange(dims[a], device=dev)
        axis = [(torch.ones_like(x, dtype=torch.bool), own[a][0], own[a][1],
                 None)]
        for j in range(r):
            y = torch.remainder(x - j, dims[a])
            src = torch.where(y == 0, ntile[a] - 1, y // tile - 1)
            has = (y % tile == 0) & (own[a][1] < r)
            place = torch.clamp(dims[a] - src * tile, max=tile) + j
            axis.append((has, src, place, j))
        choices.append(axis)
    for kx, cx in enumerate(choices[0]):
        for ky, cy in enumerate(choices[1]):
            for kz, cz in enumerate(choices[2]):
                if kx + ky + kz == 0:
                    continue
                (mx, tx, px, dx), (my, ty, py, dy), (mz, tz, pz, dz) = (
                    (m[v], t[v], p[v], d) for (m, t, p, d), v
                    in zip((cx, cy, cz), _AXIS))
                if kx:
                    slot = (dx * ey + py) * ez + pz
                elif ky:
                    slot = r * ey * ez + (px * r + dy) * ez + pz
                else:
                    slot = r * ey * ez + bx * r * ez + (px * by + py) * r + dz
                src = (tx * ntile[1] + ty) * ntile[2] + tz
                src, slot = torch.broadcast_tensors(src, slot)
                value = shell[src.clamp(0, shell.shape[0] - 1),
                              slot.clamp(0, shell.shape[1] - 1)]
                grid += torch.where(mx & my & mz, value,
                                    torch.zeros_like(value))


def _mean(acc, scale_exp, total=None, cells=None):
    """The mean mass a cell: the exact int64 total (``total``, else the
    sums' own) times 2^-s over the cells (``cells``, else the sums'), in
    float64 on the host."""
    total = int(acc.sum() if total is None else total)
    return (math.ldexp(float(total), -int(scale_exp))
            / (acc.numel() if cells is None else int(cells)))


def contrast_plain(acc, scale_exp, total=None, cells=None):
    """:func:`contrast` in plain PyTorch on the sums' device; ``total`` and
    ``cells`` as :func:`_contrast` takes them."""
    mean = _mean(acc, scale_exp, total, cells)
    m = acc.to(torch.float64) * math.ldexp(1.0, -int(scale_exp))
    return (m * (1.0 / mean) - 1.0).to(torch.float32), mean


def contrast(acc, scale_exp):
    """(float32 delta = (acc 2^-s) (1 / mean) - 1, mean) of int64 sums, the
    mean mass a cell a host float.  On CUDA the last kernel of
    ``csrc/paint.cu`` (counted in ``KPC_LAUNCHES``), each float64 operation
    rounded as :func:`contrast_plain` rounds it; the mean's total is
    ``acc.sum()``."""
    return _contrast(acc, scale_exp)


def _contrast(acc, scale_exp, total=None, cells=None):
    """:func:`contrast` with the sums' exact total given (an int64 tensor
    or an int; None sums ``acc``) over ``cells`` cells (None: ``acc``'s;
    a slab mesh's rank gives the whole grid's total and cells)."""
    global KPC_LAUNCHES
    if acc.dtype != torch.int64:
        raise ValueError(f"contrast takes int64 sums, got {acc.dtype}")
    if acc.device.type == "cpu":
        return contrast_plain(acc, scale_exp, total, cells)
    if acc.device.type != "cuda":
        raise ValueError(f"contrast runs on cpu or cuda, not {acc.device}")
    acc = acc.contiguous()
    mean = _mean(acc, scale_exp, total, cells)
    out = torch.empty(acc.shape, dtype=torch.float32, device=acc.device)
    status = _build.library().rf_paint_contrast(
        acc.data_ptr(), out.data_ptr(), acc.numel(),
        math.ldexp(1.0, -int(scale_exp)), 1.0 / mean,
        _build.current_stream(acc))
    _build.check(status, "contrast")
    KPC_LAUNCHES += 1
    return out, mean


def total_abs_weight(positions, weights=1.0):
    """sum |w| over the particles, in float64 (a scalar weight times n)."""
    pos, trailing = _positions(positions)
    w0, w = _weights(weights, trailing, pos.device)
    if w is None:
        return abs(w0) * pos.shape[1]
    return float(w.abs().sum(dtype=torch.float64))


def paint(positions, shape, spacing, weights=1.0, order=2, shift=0.0):
    """(float32 delta, mean mass a cell) of particles painted with the
    window of ``order``: :func:`deposit` at the exponent
    :func:`fixed_point_exponent` of their total |weight|, then
    :func:`contrast` with the total the deposit summed (on CUDA)."""
    s = fixed_point_exponent(total_abs_weight(positions, weights))
    acc, total = _deposit(positions, shape, spacing, weights, order, shift, s)
    return _contrast(acc, s, total)
