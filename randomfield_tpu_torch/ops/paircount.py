"""KQ: weighted periodic pair counts of catalogs on the card.

The pair loop of ``randomfield_tpu/validate/paircount.py``
(``_pair_count_loop`` and its one-hot contraction ``_dot_rows``), which
the JAX package leaves to XLA.  :func:`pair_sums` takes two catalogs as
float32 (n, 4) rows (x, y, z, w) and returns int64 sums in units of
2^-scale_exp, one row of bins a quantity: w_i w_j, w_i w_j r and, in the
Legendre mode, w_i w_j (2l + 1) L_l(mu^2) for each ell.  On CUDA tensors it
launches ``csrc/pair_counts.cu`` (counter ``KQ_LAUNCHES``, one a call); on
CPU tensors it runs :func:`pair_sums_plain`.

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

The kernel's walk: a block of ROWS threads holds ROWS catalog-1 rows, one
a thread, and streams a range of catalog 2 through shared memory in tiles
of TILE objects, with 64-bit column and pair counters; :func:`launch_plan`
picks the column ranges, and :func:`walk_plain` replays which pairs each block examines, for the tests.
"""

from __future__ import annotations

import ctypes
import math
import typing

import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import binning as _binning

__all__ = ["KQ_LAUNCHES", "ROWS", "TILE", "LEGENDRE_ELLS", "PairPlan",
           "launch_plan", "walk_plain", "fixed_point_exponent", "pack",
           "pair_terms", "pair_sums", "pair_sums_plain", "kernel_attributes",
           "row_count", "MODES"]

# kernel launches by pair_sums (the CPU path does not count)
KQ_LAUNCHES = 0

# catalog-1 rows a block (one a thread) and catalog-2 objects a stage
# (csrc/pair_counts.cu: kThreads, kTile)
ROWS = 256
TILE = 256
WARPS = ROWS // 32
LEGENDRE_ELLS = (0, 2, 4)
MODES = {"isotropic": 0, "wedges": 1, "ells": 2}
# blocks the column split aims at (a few waves of 132 SMs)
_TARGET_BLOCKS = 2048
# shared memory of the per-warp histograms, and of one histogram at most
_WARP_HIST_BYTES = 48 * 1024
_BLOCK_HIST_BYTES = 160 * 1024
# pairs a step of the plain version (bounds its temporaries)
_PLAIN_PAIRS = 1 << 24


class PairPlan(typing.NamedTuple):
    """A launch of KQ: a grid of (row_blocks, col_blocks) blocks, each over
    ROWS rows and ``cols`` catalog-2 objects (a multiple of TILE), with
    ``copies`` histograms of ``slots`` int64 sums a block."""

    row_blocks: int
    col_blocks: int
    cols: int
    slots: int
    copies: int


def row_count(mode, n_ells=0):
    """Rows of sums: w w and w w r, plus one a Legendre multipole."""
    return 2 + (n_ells if mode == MODES["ells"] else 0)


def launch_plan(n1, n2, nbins, mode=0, nmu=1, n_ells=0):
    """The :class:`PairPlan` of ``n1`` x ``n2`` pairs into ``nbins`` bins
    (times ``nmu`` wedges in the wedge mode).  Raises ValueError when one
    block's histogram does not fit in shared memory."""
    n1, n2 = int(n1), int(n2)
    total = int(nbins) * (int(nmu) if mode == MODES["wedges"] else 1)
    slots = row_count(mode, n_ells) * total
    if WARPS * slots * 8 <= _WARP_HIST_BYTES:
        copies = WARPS
    elif slots * 8 <= _BLOCK_HIST_BYTES:
        copies = 1
    else:
        raise ValueError(
            f"pair counts keep {slots} int64 sums a block in shared memory, "
            f"at most {_BLOCK_HIST_BYTES // 8}: fewer bins or wedges")
    row_blocks = -(-n1 // ROWS)
    tiles = -(-n2 // TILE)
    col_blocks = max(1, min(tiles, -(-_TARGET_BLOCKS // max(row_blocks, 1))))
    cols = -(-tiles // col_blocks) * TILE
    col_blocks = -(-n2 // cols)
    return PairPlan(row_blocks, col_blocks, cols, slots, copies)


def walk_plain(n1, n2, plan):
    """The ordered pairs the kernel's blocks examine, as its index
    arithmetic walks them: a (n1, n2) int64 count of visits (each pair once
    when the plan is right) and the pairs each block counted, in block
    order.  A replay for the tests, at small sizes."""
    visits = torch.zeros((n1, n2), dtype=torch.int64)
    per_block = []
    for bx in range(plan.row_blocks):
        rows = torch.arange(bx * ROWS, bx * ROWS + ROWS)
        rows = rows[rows < n1]
        for by in range(plan.col_blocks):
            col_lo = by * plan.cols
            col_hi = min(col_lo + plan.cols, n2)
            examined = 0
            for c0 in range(col_lo, col_hi, TILE):
                count = min(TILE, col_hi - c0)
                cols = torch.arange(c0, c0 + count)
                visits[rows[:, None], cols[None, :]] += 1
                examined += rows.numel() * count
            per_block.append(examined)
    return visits, per_block


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


def pair_sums_plain(rows1, rows2, box, edges2, scale_exp, mode=0, nmu=1,
                    ells=(), los_axis=2):
    """:func:`pair_sums` in plain PyTorch on the rows' device: blocks of
    catalog-1 rows against all of catalog 2, :func:`pair_terms`, each term
    rounded to int64 units of 2^-scale_exp and ``index_add_``-ed."""
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
        for k, t in enumerate(terms):
            q = torch.round(t.to(torch.float64) * scale).to(torch.int64)
            out.index_add_(0, idx + k * total, q)
    visited = rows1.shape[0] * n2
    return out.view(nrows, total), visited


def kernel_attributes(mode, nbins=30, nmu=1, n_ells=0):
    """(registers a thread, blocks an SM, threads a block, dynamic shared
    memory bytes) of KQ's instance of ``mode`` at its plan for ``nbins``
    bins, as ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` report them; builds
    the library."""
    plan = launch_plan(1, 1, nbins, mode, nmu, n_ells)
    out = [ctypes.c_int() for _ in range(4)]
    status = _build.library().rf_pair_counts_attributes(
        int(mode), int(nbins), plan.slots, plan.copies,
        *[ctypes.byref(v) for v in out])
    _build.check(status, "pair counts attributes")
    return tuple(v.value for v in out)


def pair_sums(rows1, rows2, box, edges2, scale_exp, mode=0, nmu=1, ells=(),
              los_axis=2):
    """KQ: int64 (rows, nbins [x nmu]) sums over every ordered pair of
    ``rows1`` x ``rows2`` in units of 2^-scale_exp, and the count of pairs
    examined.

    ``rows1``, ``rows2``: float32 (n, 4) (x, y, z, w) on one device (pass
    one tensor twice for an auto count; pairs at r^2 = 0 are left out);
    ``box``: the three sides; ``edges2``: nbins + 1 ascending squared
    edges, rounded to float32; ``mode``: :data:`MODES` (``nmu`` wedges
    along ``los_axis``, or the Legendre rows of ``ells``).  On CUDA this
    launches ``csrc/pair_counts.cu`` once; on the CPU it runs
    :func:`pair_sums_plain`.
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
    if n1 >= 2**31:
        raise ValueError(f"pair_sums takes fewer than 2^31 rows in its first "
                         f"catalog, not {n1}")
    plan = launch_plan(n1, n2, nbins, mode, nmu, len(ells))
    rows1, rows2 = rows1.contiguous(), rows2.contiguous()
    out = torch.zeros(plan.slots, dtype=torch.int64, device=rows1.device)
    visited = torch.zeros(1, dtype=torch.int64, device=rows1.device)
    e = list(ells) + [0] * (3 - len(ells))
    status = _build.library().rf_pair_counts(
        rows1.data_ptr(), n1, rows2.data_ptr(), n2, edges2.data_ptr(), nbins,
        *(float(b) for b in box.cpu()), int(mode), nmu, len(ells), *e,
        int(los_axis), math.ldexp(1.0, int(scale_exp)), plan.cols,
        plan.col_blocks, plan.copies, out.data_ptr(),
        visited.data_ptr(), _build.current_stream(rows1))
    _build.check(status, "pair_sums")
    KQ_LAUNCHES += 1
    return out.view(row_count(mode, len(ells)), nbins * nmu), visited
