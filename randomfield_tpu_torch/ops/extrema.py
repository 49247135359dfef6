"""KX: lattice extrema over each voxel's periodic 27-cube (peaks, minima,
void candidates).

The neighbourhood tests of ``randomfield_tpu/validate/peaks.py``
(``_cube_max``, ``_peak_bins``) and of the candidate step of
``randomfield_tpu/models/voids.py:find_voids``, which the JAX package
leaves to XLA.  On CUDA tensors :func:`peak_counts` and
:func:`void_candidates` launch ``csrc/extrema.cu`` (counter
``KX_LAUNCHES``, one a call; the void mode a second when its candidates
overflow the first call's list); on CPU tensors they run their plain
versions, :func:`peak_counts_plain` (the JAX package's six rolled maxima)
and :func:`void_candidates_plain` (its 26 neighbours, a chunk of x planes
at a time).

The kernel's walk: a block owns a (y, z) tile (``WALK_TILES``) and walks
a run of :func:`run_length` x planes with a halo plane at each end, each
thread reducing a (y, z) slice of its columns (``WALK_SLICES``);
:func:`read_factor` is the cells it loads over the cells of the field.

* Peaks: u = (sign delta) / sigma0, a float32 division as the JAX package
  forms u; a voxel is a peak iff u equals the maximum of its 27-cube
  (non-strict).  Counts by height bin (the count of float32 edges <= u,
  less 1, as ``searchsorted(side='right') - 1``) and the total, int64;
  optionally a uint8 mask of the peaks with lo <= u < hi.
* Voids: a candidate has rv > 0 and the float64 key rv - 1e-9 delta above
  each of its 26 neighbours' (strict).  Returned as sorted flat indices.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build

__all__ = ["KX_LAUNCHES", "peak_counts", "peak_counts_plain", "cube_max",
           "void_candidates", "void_candidates_plain", "unit_field",
           "WALK_TILES", "WALK_SLICES", "run_length", "read_factor",
           "kernel_attributes"]

# kernel launches by peak_counts and void_candidates (the CPU path does not
# count)
KX_LAUNCHES = 0

# x planes a step of the void plain version (bounds its float64 temporaries)
_X_CHUNK = 16
# the void mode's first list of candidates (a second launch takes the rest)
_VOID_CAP = 1 << 16
# the kernel's (y, z) tile of each mode and the (y, z) voxels a thread
# reduces (csrc/extrema.cu PeakWalk, VoidWalk, kCols)
WALK_TILES = {"peaks": (32, 64), "voids": (16, 64)}
WALK_SLICES = {"peaks": (4, 2), "voids": (2, 2)}
# the longest run of x planes a block walks, and the blocks a launch
# should have before runs are shortened (four on each of the H100's 132
# SMs)
_MAX_RUN = 64
_FILL = 4 * 132
# True: the kernel takes its 64-bit plane offsets, which it otherwise
# keeps for x planes of 2^32 cells or more (a check of that instance)
_WIDE = False


def _tiles(ny, nz, mode):
    ty, tz = WALK_TILES[mode]
    return -(-ny // ty) * -(-nz // tz)


def run_length(nx, ny, nz, mode="peaks"):
    """The x planes a block of the kernel's ``mode`` ('peaks' or 'voids')
    walks: 64 (all of nx when it is smaller), halved down to 8 while the
    launch would have fewer than ``_FILL`` blocks."""
    rx = _MAX_RUN
    while rx > 8 and _tiles(ny, nz, mode) * -(-nx // rx) < _FILL:
        rx //= 2
    return min(rx, nx)


def read_factor(shape, mode="peaks"):
    """The cells the kernel's ``mode`` loads from device memory (every
    block's halo planes, its tile and a cell around it, for its run and
    one plane at each end) over the cells of the field."""
    nx, ny, nz = shape
    rx = run_length(nx, ny, nz, mode)
    runs, tail = divmod(nx, rx)
    planes = runs * (rx + 2) + (tail + 2 if tail else 0)
    ty, tz = WALK_TILES[mode]
    return _tiles(ny, nz, mode) * planes * (ty + 2) * (tz + 2) / (nx * ny * nz)


def kernel_attributes(voids=False, nbins=1, mask=False):
    """(registers a thread, blocks an SM, threads a block, dynamic shared
    memory bytes) of the peak instance at ``nbins`` (with the band mask
    when ``mask``) or of the void instance, the ones a grid whose x planes
    hold fewer than 2^32 cells runs, as ``cudaFuncGetAttributes`` and
    ``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` report them; builds
    the library."""
    out = [ctypes.c_int() for _ in range(4)]
    status = _build.library().rf_extrema_attributes(
        int(bool(voids)), int(bool(mask)), int(nbins),
        *[ctypes.byref(v) for v in out])
    _build.check(status, "extrema attributes")
    return tuple(v.value for v in out)


def _field(t, what):
    t = torch.as_tensor(t)
    if t.dtype != torch.float32 or t.ndim != 3:
        raise ValueError(f"{what} must be one float32 (nx, ny, nz) field, got "
                         f"{t.dtype} {tuple(t.shape)}")
    return t


def unit_field(delta, sigma0, sign=1.0):
    """u = (sign delta) / sigma0 as float32 on ``delta``'s device: the
    divisor a float32 tensor, so the division is rounded once, as the JAX
    package divides (a CUDA tensor divided by a Python number would be
    multiplied by its reciprocal)."""
    d = -delta if sign < 0 else delta
    return d / torch.full((), float(sigma0), dtype=torch.float32,
                          device=delta.device)


def cube_max(u):
    """The maximum over each voxel's periodic 27-cube: three separable
    rolled-maximum passes."""
    m = u
    for ax in range(3):
        m = torch.maximum(m, torch.maximum(torch.roll(m, 1, ax),
                                           torch.roll(m, -1, ax)))
    return m


def _band(band):
    lo, hi = band
    return (float(np.float32(lo)) if lo is not None else -math.inf,
            float(np.float32(hi)) if hi is not None else math.inf)


def peak_counts_plain(delta, sigma0, edges, sign=1.0, band=None):
    """:func:`peak_counts` in plain PyTorch: the JAX package's rolled
    maxima and edge search on ``delta``'s device."""
    delta = _field(delta, "delta")
    edges_t = torch.as_tensor(np.asarray(edges, np.float32),
                              device=delta.device)
    nbins = edges_t.numel() - 1
    u = unit_field(delta, sigma0, sign)
    peak = u == cube_max(u)
    idx = torch.bucketize(u, edges_t, right=True) - 1
    sel = idx[peak & (idx >= 0) & (idx < nbins)]
    counts = torch.bincount(sel, minlength=nbins).to(torch.int64)
    total = peak.sum()
    mask = None
    if band is not None:
        lo, hi = _band(band)
        mask = (peak & (u >= lo) & (u < hi)).to(torch.uint8)
    return counts, total, mask


def peak_counts(delta, sigma0, edges, sign=1.0, band=None):
    """KX peaks: (int64 counts (nbins,), int64 total (0-dim), uint8 mask or
    None), all on ``delta``'s device.

    ``delta``: float32 (nx, ny, nz); ``sigma0``: heights are u = (sign
    delta) / float32(sigma0) (``sign`` -1: the minima); ``edges``: nbins + 1
    ascending heights, rounded to float32; ``band``: (lo, hi) to get the
    mask of the peaks with lo <= u < hi (either None: unbounded).  On CUDA
    this launches ``csrc/extrema.cu`` once; on the CPU it runs
    :func:`peak_counts_plain`."""
    global KX_LAUNCHES
    delta = _field(delta, "delta")
    if delta.device.type == "cpu":
        return peak_counts_plain(delta, sigma0, edges, sign, band)
    if delta.device.type != "cuda":
        raise ValueError(f"peak_counts runs on cpu or cuda, not {delta.device}")
    if not delta.is_contiguous():
        raise ValueError("peak_counts' CUDA kernel needs a contiguous field")
    edges_t = torch.as_tensor(np.asarray(edges, np.float32),
                              device=delta.device)
    nbins = edges_t.numel() - 1
    if nbins < 1:
        raise ValueError("peak_counts needs at least two edges")
    counts = torch.zeros(nbins + 1, dtype=torch.int64, device=delta.device)
    mask = (None if band is None
            else torch.empty(delta.shape, dtype=torch.uint8,
                             device=delta.device))
    lo, hi = _band(band if band is not None else (None, None))
    status = _build.library().rf_extrema_peaks(
        delta.data_ptr(), edges_t.data_ptr(), nbins, counts.data_ptr(),
        0 if mask is None else mask.data_ptr(), *delta.shape,
        float(np.float32(sigma0)), -1.0 if sign < 0 else 1.0, lo, hi,
        run_length(*delta.shape), int(_WIDE), _build.current_stream(delta))
    _build.check(status, "peak_counts")
    KX_LAUNCHES += 1
    return counts[:nbins], counts[nbins], mask


def void_candidates_plain(rv, delta):
    """:func:`void_candidates` in plain PyTorch on the fields' device: the
    float64 key of a chunk of x planes and its halo, its 26 rolled
    neighbours' maximum, the strict test."""
    rv, delta = _field(rv, "rv"), _field(delta, "delta")
    nx = rv.shape[0]
    found = []
    for x0 in range(0, nx, _X_CHUNK):
        x1 = min(nx, x0 + _X_CHUNK)
        planes = torch.arange(x0 - 1, x1 + 1, device=rv.device) % nx
        key = rv[planes].to(torch.float64) - 1e-9 * delta[planes].to(
            torch.float64)
        neigh = torch.full_like(key[1:-1], -math.inf)
        for sx in (-1, 0, 1):
            shifted = key[1 + sx:1 + sx + (x1 - x0)]
            for sy in (-1, 0, 1):
                for sz in (-1, 0, 1):
                    if sx == sy == sz == 0:
                        continue
                    torch.maximum(neigh, torch.roll(shifted, (sy, sz), (1, 2)),
                                  out=neigh)
        cand = (key[1:-1] > neigh) & (rv[x0:x1] > 0)
        found.append(torch.nonzero(cand.flatten()).flatten()
                     + x0 * rv.shape[1] * rv.shape[2])
    return torch.cat(found).cpu().numpy()


def void_candidates(rv, delta):
    """KX voids: sorted host int64 flat indices of the voxels with rv > 0
    whose float64 key rv - 1e-9 delta is above each of their 26 periodic
    neighbours' (strict).

    ``rv``, ``delta``: float32 (nx, ny, nz) on one device.  On CUDA the
    kernel writes the candidates through one atomic counter into a list of
    2^16 (launched again with a list of the count when more were found)
    and only the list reaches the host; on the CPU this runs
    :func:`void_candidates_plain`."""
    global KX_LAUNCHES
    rv, delta = _field(rv, "rv"), _field(delta, "delta")
    if rv.shape != delta.shape or rv.device != delta.device:
        raise ValueError("rv and delta must share a grid and a device")
    if rv.device.type == "cpu":
        return void_candidates_plain(rv, delta)
    if rv.device.type != "cuda":
        raise ValueError(f"void_candidates runs on cpu or cuda, not {rv.device}")
    if not (rv.is_contiguous() and delta.is_contiguous()):
        raise ValueError("void_candidates' CUDA kernel needs contiguous fields")
    cap = _VOID_CAP
    while True:
        found = torch.zeros(1, dtype=torch.int64, device=rv.device)
        index = torch.empty(cap, dtype=torch.int64, device=rv.device)
        status = _build.library().rf_extrema_voids(
            rv.data_ptr(), delta.data_ptr(), found.data_ptr(),
            index.data_ptr(), cap, *rv.shape, run_length(*rv.shape, "voids"),
            int(_WIDE), _build.current_stream(rv))
        _build.check(status, "void_candidates")
        KX_LAUNCHES += 1
        n = int(found.item())
        if n <= cap:
            return np.sort(index[:n].cpu().numpy())
        cap = n
