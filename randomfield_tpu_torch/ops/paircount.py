"""KQ: weighted periodic pair counts of catalogs on the card.

The pair loop of ``randomfield_tpu/validate/paircount.py``
(``_pair_count_loop`` and its one-hot contraction ``_dot_rows``), which
the JAX package leaves to XLA.  :func:`pair_sums` takes two catalogs as
float32 (n, 4) rows (x, y, z, w) and returns int64 sums in units of
2^-scale_exp, one row of bins a quantity: w_i w_j, w_i w_j r and, in the
Legendre mode, w_i w_j (2l + 1) L_l(mu^2) for each ell.  On CUDA tensors it
sorts the catalogs into a cell list and launches ``csrc/pair_counts.cu``'s
pair kernel over the pairs in neighbouring cells (counters
``KQ_SORT_LAUNCHES``, one a catalog sorted, and ``KQ_LAUNCHES``, one a
call); on CPU tensors it runs :func:`pair_sums_plain`, every pair by brute
force.

Both run the JAX chain per ordered pair in float32, each operation rounded
once in its order (:func:`pair_terms`): the minimum image d - box
round(d / box) with round half to even, r^2 = (dx^2 + dy^2) + dz^2, the bin
of the JAX package's ``searchsorted(edges^2, r^2, side='left') - 1``
against the float32 squared edges (a pair exactly on an edge falls in the
lower bin), pairs with r^2 = 0 left out, mu^2 = d_los^2 / r^2, the wedge
``min(int(sqrt(mu^2) nmu), nmu - 1)``.  The plain version divides and takes
square roots in float64 and rounds to float32, which is the correctly
rounded float32 result on every device (a float32 quotient or root is
exact after one rounding of the float64 one), as the kernel's ``__fdiv_rn``
and ``__fsqrt_rn`` are.  Each term is rounded once to an int64 count of
2^-s units (round half to even) and added as an integer: the sums do not
depend on the order of the additions, so the kernel equals the plain
version bit for bit and two calls give the same bits.  s comes from
:func:`fixed_point_exponent`, so that no bin can overflow.

The kernel's walk: :func:`cell_grid` cuts the box into cells of side at
least the largest edge plus a margin, the catalogs are sorted by cell on
the card (a count pass, ``torch.cumsum``, a scatter pass), and a work item
of at most ROWS catalog-1 rows of one cell meets catalog 2's objects of the
cell's distinct neighbour cells (:func:`axis_offsets`).
:func:`expected_pairs` is the count of pairs that walk examines, from the
cells' counts; :func:`walk_plain` replays which pairs each item examines,
and :func:`pair_sums_walk_plain` sums over those pairs alone, for the
tests.
"""

from __future__ import annotations

import bisect
import ctypes
import math
import typing

import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import binning as _binning

__all__ = ["KQ_LAUNCHES", "KQ_SORT_LAUNCHES", "THREADS", "ROWS", "TILE",
           "LEGENDRE_ELLS", "MODES", "SORT_PASSES", "PairPlan", "cell_grid",
           "launch_plan", "axis_offsets", "neighbour_cells", "cell_index",
           "cell_counts", "expected_pairs", "item_ends",
           "item_rows", "walk_plain", "pair_sums_walk_plain",
           "fixed_point_exponent", "pack", "pair_terms", "pair_sums",
           "pair_sums_plain", "kernel_attributes", "row_count"]

# pair-kernel launches by pair_sums, and catalogs sorted by cell (the CPU
# path counts neither)
KQ_LAUNCHES = 0
KQ_SORT_LAUNCHES = 0

# threads a block, catalog-1 rows a work item (a warp's lanes) and
# catalog-2 objects a stage (csrc/pair_counts.cu: kThreads, kRows, kTile)
THREADS = 256
ROWS = 32
TILE = 256
WARPS = THREADS // 32
LEGENDRE_ELLS = (0, 2, 4)
MODES = {"isotropic": 0, "wedges": 1, "ells": 2}
# the sort's passes, as kernel_attributes names them
SORT_PASSES = {"count": 3, "scatter": 4, "items": 5}
# cells at most: the catalog's size, or this many for small catalogs; and
# never past what an int32 cell index holds
MIN_CELL_CAP = 4096
MAX_CELLS = 1 << 30
# the cell side's margin past the reach, relative to the reach and to the
# largest coordinate magnitude or side (cell_grid)
MARGIN = 2.0 ** -20
# shared memory of the per-warp histograms, and of one histogram at most
_WARP_HIST_BYTES = 48 * 1024
_BLOCK_HIST_BYTES = 160 * 1024
# pairs a step of the plain version (bounds its temporaries)
_PLAIN_PAIRS = 1 << 24


class PairPlan(typing.NamedTuple):
    """A launch of KQ: the cell grid (``cells`` per axis, the float32
    ``sides`` as float64, ``inv`` = cells / side), ``rows`` catalog-1 rows
    a work item, at most ``max_items`` items, and ``copies`` histograms of
    ``slots`` int64 sums a block."""

    cells: tuple
    sides: tuple
    inv: tuple
    rows: int
    max_items: int
    slots: int
    copies: int


def row_count(mode, n_ells=0):
    """Rows of sums: w w and w w r, plus one a Legendre multipole."""
    return 2 + (n_ells if mode == MODES["ells"] else 0)


def _histograms(nbins, mode, nmu, n_ells):
    """(slots, copies) of a block's histograms; raises ValueError when one
    histogram does not fit in shared memory."""
    total = int(nbins) * (int(nmu) if mode == MODES["wedges"] else 1)
    slots = row_count(mode, n_ells) * total
    if WARPS * slots * 8 <= _WARP_HIST_BYTES:
        return slots, WARPS
    if slots * 8 <= _BLOCK_HIST_BYTES:
        return slots, 1
    raise ValueError(
        f"pair counts keep {slots} int64 sums a block in shared memory, "
        f"at most {_BLOCK_HIST_BYTES // 8}: fewer bins or wedges")


def cell_grid(box, e_hi, coord_max, n2):
    """(cells per axis, float64 sides, cells / side) of the cell list for
    pairs with float32 r^2 <= ``e_hi`` in a periodic ``box`` (the float32
    sides), catalogs whose coordinates reach ``coord_max`` in magnitude and
    ``n2`` objects in catalog 2.

    Each side is at least reach = sqrt(e_hi) (1 + MARGIN) + MARGIN M, where
    M is the largest of ``coord_max`` and the sides.  Why the margin: a pair
    the chain counts has float32 fl(d_a^2) <= r^2 <= e_hi on each axis, so
    its computed component |d_a| <= sqrt(e_hi) (1 + 2^-24).  That component
    is a periodic image of the exact difference up to three roundings: the
    difference of the coordinates (at most 2^-24 of |x_p - x_q| <= 2M), the
    product box rint(d / box) (2^-24 of at most 2.5M) and the last subtract
    (2^-24 of about box / 2), under 6 2^-24 M in all; the cells' float64
    arithmetic moves a boundary by about 2^-52 of the box.  So the exact
    periodic distance on each axis is below sqrt(e_hi) (1 + 2^-24) +
    6 2^-24 M < reach, a cell's side is at least that, and the two
    objects' cells are the same or neighbours on every axis.  (The ulp of a
    coordinate near 2048 is 2.44e-4; MARGIN M is 1.95e-3 there.  With a
    MARGIN of 2^-26 the narrowest grid of the "margin" case of
    tests/test_torch_paircount.py misses pairs.)

    The cells are capped at max(n2, MIN_CELL_CAP) (and MAX_CELLS), so that
    a small reach in a large box does not ask for more cells than objects:
    larger cells stay correct."""
    sides = tuple(float(torch.tensor(float(b), dtype=torch.float32))
                  for b in box)
    big = max([float(coord_max)] + list(sides))
    reach = math.sqrt(max(float(e_hi), 0.0)) * (1.0 + MARGIN) + MARGIN * big
    if math.isfinite(reach):
        cells = [max(1, int(s // reach)) for s in sides]
    else:
        cells = [1, 1, 1]
    cap = min(max(int(n2), MIN_CELL_CAP), MAX_CELLS)
    if math.prod(cells) > cap:
        shrink = (cap / math.prod(cells)) ** (1.0 / 3.0)
        cells = [max(1, int(c * shrink)) for c in cells]
        while math.prod(cells) > cap:
            a = cells.index(max(cells))
            cells[a] = max(1, cells[a] * cap // math.prod(cells))
    cells = tuple(cells)
    return cells, sides, tuple(c / s for c, s in zip(cells, sides))


def launch_plan(n1, n2, box, e_hi, coord_max, nbins, mode=0, nmu=1,
                n_ells=0):
    """The :class:`PairPlan` of catalogs of ``n1`` and ``n2`` objects whose
    coordinates reach ``coord_max`` in magnitude, in ``box``, with pairs up
    to float32 r^2 ``e_hi`` in ``nbins`` bins (times ``nmu`` wedges in the
    wedge mode).  Raises ValueError when one block's histogram does not fit
    in shared memory."""
    slots, copies = _histograms(nbins, mode, nmu, n_ells)
    cells, sides, inv = cell_grid(box, e_hi, coord_max, n2)
    n1 = int(n1)
    # an item holds 1 to ROWS rows, so its cell's items are at most
    # n1(c) / ROWS + 1
    max_items = min(n1, math.prod(cells) + -(-n1 // ROWS))
    return PairPlan(cells, sides, inv, ROWS, max_items, slots, copies)


def axis_offsets(n):
    """The distinct neighbour offsets of an axis of ``n`` cells: -1, 0, +1
    (three cells or more), 0 and 1 (two: -1 is +1 there) or 0 (one)."""
    return (-1, 0, 1) if n >= 3 else ((0, 1) if n == 2 else (0,))


def neighbour_cells(c, cells):
    """Flat indices of cell ``c``'s distinct neighbour cells, in the order
    the kernel's lanes list them (x offsets outermost)."""
    nx, ny, nz = cells
    cx, cy, cz = c // (ny * nz), (c // nz) % ny, c % nz
    return [((cx + ox) % nx * ny + (cy + oy) % ny) * nz + (cz + oz) % nz
            for ox in axis_offsets(nx) for oy in axis_offsets(ny)
            for oz in axis_offsets(nz)]


def cell_index(rows, plan):
    """int64 (n,) flat cell of each row, as the kernel's count pass
    computes it: floor(remainder(x, side) cells / side) a coordinate in
    float64 (fmod, plus the side where negative), clamped to [0, cells - 1]
    (NaN to 0); x major, z minor.  Python scalars, no host-to-device
    copy."""
    flat = 0
    for a, (n, side, inv) in enumerate(zip(plan.cells, plan.sides,
                                           plan.inv)):
        u = torch.fmod(rows[:, a].to(torch.float64), side)
        u = torch.where(u < 0, u + side, u)
        t = torch.nan_to_num(torch.floor(u * inv).clamp(max=n - 1), nan=0.0)
        flat = flat * n + t.to(torch.int64)
    return flat


def cell_counts(rows, plan):
    """int64 (cells,) objects a cell, from :func:`cell_index`."""
    idx = cell_index(rows, plan)
    return torch.zeros(math.prod(plan.cells), dtype=torch.int64,
                       device=rows.device).index_add_(
        0, idx, torch.ones_like(idx))


def _expected(counts1, counts2, cells):
    """:func:`expected_pairs` as a 0-d int64 tensor on the counts' device."""
    near = counts2.reshape(cells)
    for axis, n in enumerate(cells):
        near = sum([torch.roll(near, o, axis) for o in axis_offsets(n) if o],
                   near)
    return (counts1.reshape(cells) * near).sum()


def expected_pairs(counts1, counts2, cells):
    """The ordered pairs the cell walk examines: sum over cells c of
    n1(c) times the sum of n2 over c's distinct neighbour cells."""
    return int(_expected(counts1, counts2, cells))


def _plan_of(rows1, rows2, box, edges2, mode, nmu, n_ells):
    """:func:`launch_plan` for these catalogs, the float32 ``box`` and
    squared edges on their device: the sides, the last edge and the largest
    coordinate magnitude come to the host in one read."""
    nbins = edges2.numel() - 1
    vals = [box, edges2[nbins:]]
    for r in (rows1,) if rows2 is rows1 else (rows1, rows2):
        if r.shape[0]:
            vals.append(r[:, :3].abs().amax().reshape(1))
    vals = torch.cat(vals).cpu().tolist()
    return launch_plan(rows1.shape[0], rows2.shape[0], vals[:3], vals[3],
                       max(vals[4:], default=0.0), nbins, mode, nmu, n_ells)


def item_ends(counts1, rows=ROWS):
    """The inclusive scan of each cell's work items, ceil(n1(c) / rows)."""
    return torch.cumsum(torch.div(counts1 + (rows - 1), rows,
                                  rounding_mode="floor"), 0)


def item_rows(item, ends, starts1, counts1, rows=ROWS):
    """(cell, first sorted row, rows) of work item ``item``, as the kernel
    decodes it: the first cell whose inclusive item end exceeds ``item``,
    then its place among the cell's items; ``ends``, ``starts1`` and
    ``counts1`` are sequences of Python ints (64-bit values and more)."""
    c = bisect.bisect_right(ends, item)
    n_c = counts1[c]
    k = item - (ends[c] - -(-n_c // rows))
    return c, starts1[c] + k * rows, min(rows, n_c - k * rows)


def _grouped(cell, ncells):
    """The objects grouped by cell (a counting sort; the kernel's order
    inside a cell is free, this one keeps the catalog's), the cells' starts
    and counts, as lists."""
    counts = torch.bincount(cell, minlength=ncells).tolist()
    starts = [0] * ncells
    for c in range(1, ncells):
        starts[c] = starts[c - 1] + counts[c - 1]
    cursor, order = list(starts), [0] * cell.numel()
    for i, c in enumerate(cell.tolist()):
        order[cursor[c]] = i
        cursor[c] += 1
    return order, starts, counts


def _walk(rows1, rows2, plan):
    """(catalog-1 rows, catalog-2 objects) of each work item in item
    order, as original indices: the kernel's cells, counts, scan, items and
    neighbour lists replayed in Python."""
    ncells = math.prod(plan.cells)
    order1, starts1, counts1 = _grouped(cell_index(rows1, plan), ncells)
    order2, starts2, counts2 = _grouped(cell_index(rows2, plan), ncells)
    ends = item_ends(torch.tensor(counts1), plan.rows).tolist()
    for item in range(ends[-1]):
        c, row0, nrows = item_rows(item, ends, starts1, counts1, plan.rows)
        cols = [j for nb in neighbour_cells(c, plan.cells)
                for j in order2[starts2[nb]:starts2[nb] + counts2[nb]]]
        yield order1[row0:row0 + nrows], cols


def walk_plain(rows1, rows2, plan):
    """The ordered pairs the kernel's work items examine: an int64 (n1, n2)
    count of visits (each pair in range exactly once when the grid is
    right) and the pairs each item examined, in item order.  A replay for
    the tests, at small sizes."""
    visits = torch.zeros((rows1.shape[0], rows2.shape[0]), dtype=torch.int64)
    per_item = []
    for r, cols in _walk(rows1, rows2, plan):
        i, j = torch.meshgrid(torch.tensor(r, dtype=torch.int64),
                              torch.tensor(cols, dtype=torch.int64),
                              indexing="ij")
        visits.index_put_((i, j), torch.ones_like(i), accumulate=True)
        per_item.append(len(r) * len(cols))
    return visits, per_item


def fixed_point_exponent(n1, n2, wmax1, wmax2, r_max, ells=()):
    """s with a bin's largest possible sum below 2^61 in units of 2^-s: n1
    n2 pairs, each term at most |w1| |w2| times the largest row factor (1,
    the largest r, or 2 ell + 1 for the Legendre rows, with room for
    rounding).  Each term adds at most half a unit of rounding, far below
    the 2^62 left."""
    factor = max([1.0, float(r_max)] + [2.0 * e + 1.0 for e in ells])
    total = float(n1) * float(n2) * float(wmax1) * float(wmax2) * factor
    total *= 1.0 + 1e-6
    if not total > 0 or not math.isfinite(total):
        return 0
    return 61 - math.ceil(math.log2(total))


def pack(positions, weights):
    """float32 (n, 4) rows (x, y, z, w) on the positions' device from (n, 3)
    positions and (n,) weights."""
    return torch.cat([positions.to(torch.float32),
                      weights.to(torch.float32).reshape(-1, 1)], dim=1
                     ).contiguous()


def _div32(a, b):
    """a / b correctly rounded to float32 (through float64)."""
    return (a.to(torch.float64) / b.to(torch.float64)).to(torch.float32)


def _sqrt32(a):
    """sqrt(a) correctly rounded to float32 (through float64)."""
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)


def pair_terms(a, b, box, edges2, nbins, mode=0, nmu=1, ells=(), los_axis=2):
    """The float32 terms of the ordered pairs of rows ``a`` (m, 4) and ``b``
    (k, 4): (flat bin index of each valid pair, [w w, w w r, the Legendre
    rows...] float32 terms of those pairs), in the kernel's order of
    operations.  ``box``: float32 (3,); ``edges2``: float32 (nbins + 1,)."""
    d = [a[:, None, c] - b[None, :, c] for c in range(3)]
    d = [dc - box[c] * torch.round(_div32(dc, box[c])) for c, dc in
         enumerate(d)]
    r2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
    valid = (r2 > edges2[0]) & (r2 <= edges2[nbins])
    i, j = torch.nonzero(valid, as_tuple=True)
    r2v = r2[i, j]
    idx = torch.searchsorted(edges2, r2v) - 1
    wij = a[i, 3] * b[j, 3]
    terms = [wij, wij * _sqrt32(r2v)]
    if mode != MODES["isotropic"]:
        dl = d[int(los_axis)][i, j]
        mu2 = _div32(dl * dl, r2v)
        if mode == MODES["wedges"]:
            m = (_sqrt32(mu2) * float(nmu)).to(torch.int64)
            idx = idx * int(nmu) + m.clamp(0, int(nmu) - 1)
        else:
            terms += [_binning.legendre_weighted(e, mu2, wij) for e in ells]
    return idx, terms


def _check(rows1, rows2, box, edges2, mode, nmu, ells, los_axis):
    for r in (rows1, rows2):
        if r.dtype != torch.float32 or r.ndim != 2 or r.shape[1] != 4:
            raise ValueError("pair sums take float32 (n, 4) rows (x, y, z, w)")
    if rows1.device != rows2.device:
        raise ValueError("the two catalogs must share a device")
    box = torch.as_tensor(box, dtype=torch.float32).to(rows1.device)
    edges2 = torch.as_tensor(edges2, dtype=torch.float32).to(rows1.device)
    nbins = edges2.numel() - 1
    if nbins < 1 or box.shape != (3,):
        raise ValueError("pair sums take 3 box sides and >= 2 edges")
    if mode not in MODES.values() or int(los_axis) not in (0, 1, 2):
        raise ValueError(f"unknown mode {mode} or line of sight {los_axis}")
    ells = tuple(int(e) for e in ells) if mode == MODES["ells"] else ()
    if mode == MODES["ells"] and not (
            1 <= len(ells) <= 3 and all(e in LEGENDRE_ELLS for e in ells)):
        raise ValueError(f"ells must be 1-3 of {LEGENDRE_ELLS}, got {ells}")
    nmu = int(nmu) if mode == MODES["wedges"] else 1
    return box, edges2.contiguous(), nbins, nmu, ells


def _add_terms(out, idx, terms, total, scale):
    for k, t in enumerate(terms):
        q = torch.round(t.to(torch.float64) * scale).to(torch.int64)
        out.index_add_(0, idx + k * total, q)


def pair_sums_plain(rows1, rows2, box, edges2, scale_exp, mode=0, nmu=1,
                    ells=(), los_axis=2):
    """:func:`pair_sums` in plain PyTorch on the rows' device, by brute
    force: blocks of catalog-1 rows against all of catalog 2,
    :func:`pair_terms`, each term rounded to int64 units of 2^-scale_exp
    and ``index_add_``-ed."""
    box, edges2, nbins, nmu, ells = _check(rows1, rows2, box, edges2, mode,
                                           nmu, ells, los_axis)
    total = nbins * nmu
    nrows = row_count(mode, len(ells))
    out = torch.zeros(nrows * total, dtype=torch.int64, device=rows1.device)
    scale = math.ldexp(1.0, int(scale_exp))
    n2 = rows2.shape[0]
    step = max(1, _PLAIN_PAIRS // max(n2, 1))
    for lo in range(0, rows1.shape[0], step):
        idx, terms = pair_terms(rows1[lo:lo + step], rows2, box, edges2,
                                nbins, mode, nmu, ells, los_axis)
        _add_terms(out, idx, terms, total, scale)
    visited = rows1.shape[0] * n2
    return out.view(nrows, total), visited


def pair_sums_walk_plain(rows1, rows2, box, edges2, scale_exp, mode=0, nmu=1,
                         ells=(), los_axis=2):
    """:func:`pair_sums_plain` over the pairs the cell walk examines alone
    (:func:`walk_plain`'s items, :func:`pair_terms` a item): equal to the
    brute version bit for bit exactly when the walk reaches every pair in
    range once.  Returns (sums, pairs examined).  For the tests, at small
    sizes, on CPU rows."""
    box, edges2, nbins, nmu, ells = _check(rows1, rows2, box, edges2, mode,
                                           nmu, ells, los_axis)
    plan = _plan_of(rows1, rows2, box, edges2, mode, nmu, len(ells))
    total = nbins * nmu
    nrows = row_count(mode, len(ells))
    out = torch.zeros(nrows * total, dtype=torch.int64)
    scale = math.ldexp(1.0, int(scale_exp))
    examined = 0
    for r, cols in _walk(rows1, rows2, plan):
        examined += len(r) * len(cols)
        if cols:
            idx, terms = pair_terms(rows1[r], rows2[cols], box, edges2, nbins,
                                    mode, nmu, ells, los_axis)
            _add_terms(out, idx, terms, total, scale)
    return out.view(nrows, total), examined


def kernel_attributes(mode, nbins=30, nmu=1, n_ells=0):
    """(registers a thread, blocks an SM, threads a block, shared memory
    bytes) of KQ's pair kernel of ``mode`` at its histograms for ``nbins``
    bins, or of a sort pass (``mode`` a key of :data:`SORT_PASSES`), as
    ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` report them; builds
    the library."""
    if mode in SORT_PASSES:
        which, slots, copies = SORT_PASSES[mode], 0, 1
    else:
        which = int(mode)
        slots, copies = _histograms(nbins, which, nmu, n_ells)
    out = [ctypes.c_int() for _ in range(4)]
    status = _build.library().rf_pair_counts_attributes(
        which, int(nbins), slots, copies, *[ctypes.byref(v) for v in out])
    _build.check(status, "pair counts attributes")
    return tuple(v.value for v in out)


def _count(rows, plan, lib, stream):
    """KQ's count pass on the card: (int32 cell of each row, int64 objects
    a cell), the cells as :func:`cell_index` computes them."""
    n, dev = rows.shape[0], rows.device
    cell = torch.empty(n, dtype=torch.int32, device=dev)
    counts = torch.zeros(math.prod(plan.cells), dtype=torch.int64,
                         device=dev)
    _build.check(lib.rf_pair_cells(
        rows.data_ptr(), n, *plan.cells, *plan.sides, *plan.inv,
        cell.data_ptr(), counts.data_ptr(), stream), "pair_sums cells")
    return cell, counts


def _sort(rows, plan, lib, stream):
    """The rows grouped by cell on the card (count pass, cumsum, scatter
    pass): (sorted rows, each cell's first sorted row, its count)."""
    global KQ_SORT_LAUNCHES
    cell, counts = _count(rows, plan, lib, stream)
    cursor = torch.cumsum(counts, 0)
    out = torch.empty_like(rows)
    _build.check(lib.rf_pair_scatter(
        rows.data_ptr(), rows.shape[0], cell.data_ptr(), cursor.data_ptr(),
        out.data_ptr(), stream), "pair_sums scatter")
    KQ_SORT_LAUNCHES += 1
    return out, cursor, counts


def _pairs(one, two, plan, edges2, scale_exp, mode, nmu, ells, los_axis,
           scratch, lib, stream):
    """The item cells and the pair kernel on two :func:`_sort` outputs:
    the sums into ``scratch[:slots]``, the pairs examined into
    ``scratch[slots]`` (``scratch``: int64, slots + 2, zeroed)."""
    (p1, start1, count1), (p2, start2, count2) = one, two
    nbins = edges2.numel() - 1
    ends = item_ends(count1, plan.rows)
    item_cell = torch.empty(plan.max_items, dtype=torch.int32,
                            device=p1.device)
    e = list(ells) + [0] * (3 - len(ells))
    slots = plan.slots
    _build.check(lib.rf_pair_counts(
        p1.data_ptr(), start1.data_ptr(), count1.data_ptr(), ends.data_ptr(),
        p2.data_ptr(), start2.data_ptr(), count2.data_ptr(), *plan.cells,
        plan.max_items, item_cell.data_ptr(), edges2.data_ptr(), nbins,
        *plan.sides, int(mode), int(nmu), len(ells), *e, int(los_axis),
        math.ldexp(1.0, int(scale_exp)), plan.copies, scratch.data_ptr(),
        scratch[slots:].data_ptr(), scratch[slots + 1:].data_ptr(), stream),
        "pair_sums")


def pair_sums(rows1, rows2, box, edges2, scale_exp, mode=0, nmu=1, ells=(),
              los_axis=2):
    """KQ: int64 (rows, nbins [x nmu]) sums over the ordered pairs of
    ``rows1`` x ``rows2`` in range, in units of 2^-scale_exp, and the count
    of pairs examined.

    ``rows1``, ``rows2``: float32 (n, 4) (x, y, z, w) on one device (pass
    one tensor twice for an auto count; pairs at r^2 = 0 are left out);
    ``box``: the three sides; ``edges2``: nbins + 1 ascending squared
    edges, rounded to float32; ``mode``: :data:`MODES` (``nmu`` wedges
    along ``los_axis``, or the Legendre rows of ``ells``).  On CUDA this
    sorts each catalog by cell (once for an auto count) and launches the
    pair kernel once, over the pairs in neighbouring cells, and raises
    RuntimeError when the kernel's count of pairs examined is not the
    walk's own, :func:`expected_pairs` of the sort's cell counts; on the
    CPU it runs :func:`pair_sums_plain` over every pair.
    """
    global KQ_LAUNCHES
    box, edges2, nbins, nmu, ells = _check(rows1, rows2, box, edges2, mode,
                                           nmu, ells, los_axis)
    if rows1.device.type == "cpu":
        return pair_sums_plain(rows1, rows2, box, edges2, scale_exp, mode,
                               nmu, ells, los_axis)
    if rows1.device.type != "cuda":
        raise ValueError(f"pair_sums runs on cpu or cuda, not {rows1.device}")
    n1, n2 = rows1.shape[0], rows2.shape[0]
    nrows, total = row_count(mode, len(ells)), nbins * nmu
    slots = nrows * total
    scratch = torch.zeros(slots + 2, dtype=torch.int64, device=rows1.device)
    out, visited = scratch[:slots], scratch[slots:slots + 1]
    if n1 == 0 or n2 == 0:
        return out.view(nrows, total), visited
    auto = rows2 is rows1
    rows1 = rows1.contiguous()
    rows2 = rows1 if auto else rows2.contiguous()
    plan = _plan_of(rows1, rows2, box, edges2, mode, nmu, len(ells))
    lib, stream = _build.library(), _build.current_stream(rows1)
    one = _sort(rows1, plan, lib, stream)
    two = one if auto else _sort(rows2, plan, lib, stream)
    _pairs(one, two, plan, edges2, scale_exp, mode, nmu, ells, los_axis,
           scratch, lib, stream)
    KQ_LAUNCHES += 1
    miss = _expected(one[2], two[2], plan.cells) - visited[0]
    if miss.item():
        raise RuntimeError(f"pair counts examined {int(visited)} pairs, not "
                           f"the walk's {int(visited) + int(miss)}")
    return out.view(nrows, total), visited
