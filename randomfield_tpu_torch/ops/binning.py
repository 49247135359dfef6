"""KB: the spectrum binning of every Fourier-space estimator.

:func:`bin_spectrum` bins one packed 'xyz' half-spectrum pass (or a slab
mesh's ky rows of one) in the estimator's log |k| bins: per mode the
Hermitian multiplicity w (1 on the kz = 0 and, for even nz, Nyquist planes,
2 elsewhere) and its value p,

* ``'auto'``: (re, im), p = (re^2 + im^2) factor;
* ``'cross'``: (re1, im1, re2, im2), p = (re1 re2 + im1 im2) factor;
* ``'interlaced'``: the same four, c = (c1 + c2 e^{i phi}) / 2 with phi =
  (kx + ky + kz) a / 2 (the JAX package's ``_interlaced_mode_power``),
  p = |c|^2 factor;
* ``'grid'``: (p,), a float32 power grid (the predictions);

divided by W^(2 order) for a mass-assignment window (``order`` 1, 2, 3 for
ngp, cic, tsc; W = prod_i sinc(k_i a / 2)), and summed as (w, w p, w |k|)
per bin: isotropic, weighted by (2l + 1) L_l(mu^2) for up to three even
multipoles (``ells``), or in ``nmu`` |mu| wedges (the bin index k_bin nmu
+ mu_bin), mu = k_los / |k|.  The result is float64 (n_out, 3, nb + 1)
on the spectrum's device (n_out = len(ells) or 1, nb = nbins or nbins
nmu), the last column for the masked modes (always zero here: a masked
mode adds nothing).

The bin is the estimator's edge search on the float32 |k| of
:func:`.grid.kmag`, and every float32 operation of a mode is rounded in
the order :func:`bin_spectrum_plain` writes it, so on the card the kernel
(``csrc/bin_spectrum.cu``) and its plain version count the same modes in
every bin and add the same float32 terms, in float64 in another order.
On CUDA tensors :func:`bin_spectrum` launches the kernel (counter
``KB_LAUNCHES``) or raises; on CPU tensors it runs the plain version.  The
per-axis tables (k vectors, sinc, the phase's cos and sin) are built in
float64 on the host and rounded to float32 once, for both versions.

The kernel works in two passes.  The counts and |k| sums of the bins
depend on the grid alone: its geometry pass adds (w, w |k|) by key without
reading a spectrum, once for each geometry (shape, spacing, edges, rows,
wedges), and :func:`bin_spectrum` keeps the result on the device (counter
``KB_GEOMETRY_LAUNCHES``); the data pass adds w p alone.  The geometry
pass walks the lines x in [0, nx/2] (and y in [0, ny/2] when it holds every
ky row), each weighted by the rows of equal k^2 it stands for; its
isotropic counts are closed-form, the first kz whose k^2 reaches each
threshold found by a binary search.  The bin is the
float32 k^2 against :func:`edge_thresholds`, the edge search on |k|
exactly.  The data pass streams tiles of four whole kz lines through shared
memory (``csrc/line_ring.cuh``) on a persistent grid whose plan (warps a
block, stages, blocks) :func:`launch_plan` reads from the library.
:func:`read_probe` streams the same tiles and only sums them: the read
rate of the staging alone, a measurement that no estimator calls.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from randomfield_tpu_torch.ops import _build
from randomfield_tpu_torch.ops import grid as _grid

__all__ = ["bin_spectrum", "bin_spectrum_plain", "mode_terms", "line_sums",
           "axis_tables", "edge_thresholds", "launch_plan", "read_probe",
           "legendre_weighted", "WINDOW_ORDERS", "KINDS", "MAX_BINS",
           "KB_LAUNCHES", "KB_GEOMETRY_LAUNCHES"]

# kernel launches by bin_spectrum, one a call (the CPU path does not count);
# and of its geometry pass, one a geometry
KB_LAUNCHES = 0
KB_GEOMETRY_LAUNCHES = 0

KINDS = {"auto": (0, 2), "cross": (1, 4), "interlaced": (2, 4),
         "grid": (3, 1)}  # name: (the kernel's code, lattices taken)
WINDOW_ORDERS = {None: 0, "ngp": 1, "cic": 2, "tsc": 3}
_ISO, _POLES, _WEDGES = 0, 1, 2
# bins (nbins, or nbins nmu) the kernel's per-warp float64 accumulators
# hold in shared memory
MAX_BINS = 1024
# x planes a step of the plain version (bounds its temporaries)
_X_CHUNK = 16
# the kernel's read-rate probe (csrc/bin_spectrum.cu kProbe) and its
# geometry pass (kGeo)
_PROBE = 3
_PROBE_KINDS = {1: "grid", 2: "auto", 4: "cross"}
_CODES = {**{k: v[0] for k, v in KINDS.items()}, "geometry": 4}


@functools.lru_cache(maxsize=16)
def _host_tables(shape, spacing):
    """float32 (kvec, sinc, cos, sin), each nx + ny + nz//2+1 long: the
    estimator's k vectors, sinc(k a / 2), cos and sin of k a / 2."""
    nx, ny, nz = shape
    k = np.concatenate([2.0 * np.pi * np.fft.fftfreq(nx, d=spacing),
                        2.0 * np.pi * np.fft.fftfreq(ny, d=spacing),
                        2.0 * np.pi * np.fft.rfftfreq(nz, d=spacing)])
    half = k * (spacing / 2.0)
    safe = np.where(half != 0, half, 1.0)
    sinc = np.where(half != 0, np.sin(half) / safe, 1.0)
    return tuple(a.astype(np.float32) for a in
                 (k, sinc, np.cos(half), np.sin(half)))


@functools.lru_cache(maxsize=32)
def axis_tables(shape, spacing, device):
    """(kvec, sinc, phase) float32 tensors on ``device``: the per-axis k
    vectors (equal to :func:`.grid.kvectors`), sinc tables and the cos then
    sin tables of the interlacing phase, each axis after the other."""
    k, sinc, cos, sin = _host_tables(tuple(int(n) for n in shape),
                                     float(spacing))
    dev = torch.device(device)
    return (torch.as_tensor(k, device=dev), torch.as_tensor(sinc, device=dev),
            torch.as_tensor(np.concatenate([cos, sin]), device=dev))


@functools.lru_cache(maxsize=64)
def launch_plan(kind, mode, nx, ny_loc, nz, nbins, nmu, ny=None):
    """(warps a block, stages, blocks, shared-memory bytes, tiles a chunk,
    chunks) of the kernel
    of ``kind`` (or 'geometry', its geometry pass) and output ``mode`` (0
    isotropic, 1 multipoles, 2 wedges, 3 the read probe) on (nx, ny_loc,
    nz//2+1) lattices of an (nx, ny, nz) grid (ny = ny_loc if None): of
    the warps and stages that fit, the most warps an SM; a block per chunk
    at most.  The chunks (consecutive tiles of four lines) depend on the
    shapes alone: the kernel sums each chunk apart and the chunks in
    order, so the grid never moves a result."""
    plan = (ctypes.c_int * 6)()
    status = _build.library().rf_bin_spectrum_plan(
        _CODES[kind], int(mode), int(nx), int(ny if ny else ny_loc),
        int(ny_loc), int(nz), int(nbins), int(nmu), plan)
    _build.check(status, "bin_spectrum")
    return tuple(plan)


def edge_thresholds(edges):
    """float32 (nbins + 1,): for each float32 edge e the least float32 k^2
    whose float32 square root exceeds e, so that sqrtf(k^2) > e exactly when
    k^2 >= T (the square root is correctly rounded, hence monotone): the
    kernel's edge search on |k| = sqrtf(k^2) without the square root."""
    e = np.asarray(edges, np.float64).astype(np.float32)
    t = (e.astype(np.float64) ** 2).astype(np.float32)
    while True:  # down while the float32 below still passes the edge
        below = np.nextafter(t, np.float32(0))
        lower = np.sqrt(below) > e
        if not lower.any():
            break
        t = np.where(lower, below, t)
    while True:  # up while t does not pass it
        short = ~(np.sqrt(t) > e)
        if not short.any():
            break
        t = np.where(short, np.nextafter(t, np.float32(np.inf)), t)
    return t


def _aligned(a):
    """``a`` contiguous and 16-byte aligned (the bulk copy's rule): a copy
    where it is not."""
    a = a.contiguous()
    return a if a.data_ptr() % 16 == 0 else a.clone()


def _layout(ells, nmu, nbins):
    """(output mode, nb, n_out, ells as a tuple)."""
    if ells is not None and nmu is not None:
        raise ValueError("bin_spectrum takes ells or nmu, not both")
    if ells is not None:
        ells = tuple(int(e) for e in ells)
        if not 1 <= len(ells) <= 3 or any(e not in (0, 2, 4) for e in ells):
            raise ValueError(f"ells must be one to three of 0, 2, 4; got {ells}")
        return _POLES, nbins, len(ells), ells
    if nmu is not None:
        if int(nmu) < 1:
            raise ValueError(f"nmu must be >= 1, got {nmu}")
        return _WEDGES, nbins * int(nmu), 1, None
    return _ISO, nbins, 1, None


def _check(kind, arrays, shape, y_off):
    if kind not in KINDS:
        raise ValueError(f"bin_spectrum: unknown kind {kind!r}")
    if len(arrays) != KINDS[kind][1]:
        raise ValueError(f"bin_spectrum: {kind!r} takes {KINDS[kind][1]} "
                         f"lattices, got {len(arrays)}")
    nx, ny, nz = shape
    a0 = arrays[0]
    ny_loc = a0.shape[1] if a0.ndim == 3 else -1
    want = (nx, ny_loc, nz // 2 + 1)
    for a in arrays:
        if (a.dtype != torch.float32 or tuple(a.shape) != want
                or a.device != a0.device):
            raise ValueError(f"bin_spectrum: every lattice must be float32 "
                             f"{want} on one device, got {a.dtype} "
                             f"{tuple(a.shape)} on {a.device}")
    if not (0 <= y_off and y_off + ny_loc <= ny):
        raise ValueError(f"bin_spectrum: rows [{y_off}, {y_off + ny_loc}) "
                         f"outside ny = {ny}")
    return ny_loc


def legendre_weighted(ell, mu2, v):
    """v (2l + 1) L_l(mu^2) in float32, rounded as the kernel rounds it."""
    if ell == 0:
        return v
    if ell == 2:
        return v * (5.0 * (0.5 * (3.0 * mu2 - 1.0)))
    return v * (9.0 * (0.125 * (((35.0 * mu2) * mu2 - 30.0 * mu2) + 3.0)))


def _values(kind, arrays, sl, factor, tabs, x0, x1, y0, y1, nxy):
    """The float32 value of each mode of x rows [x0, x1) (before the
    window)."""
    if kind == "grid":
        return arrays[0][sl]
    if kind == "auto":
        re, im = arrays[0][sl], arrays[1][sl]
        return (re * re + im * im) * factor
    r1, i1, r2, i2 = (a[sl] for a in arrays)
    if kind == "cross":
        return (r1 * r2 + i1 * i2) * factor
    _, _, phase = tabs
    n = phase.numel() // 2
    cos, sin = phase[:n], phase[n:]
    nx, ny = nxy
    cx, sx = cos[x0:x1, None], sin[x0:x1, None]
    cy, sy = cos[nx + y0:nx + y1][None, :], sin[nx + y0:nx + y1][None, :]
    cz, sz = cos[nx + ny:], sin[nx + ny:]
    exy_re = (cx * cy - sx * sy)[:, :, None]
    exy_im = (cx * sy + sx * cy)[:, :, None]
    e_re = exy_re * cz - exy_im * sz
    e_im = exy_re * sz + exy_im * cz
    t_re = r2 * e_re - i2 * e_im
    t_im = r2 * e_im + i2 * e_re
    c_re = 0.5 * (r1 + t_re)
    c_im = 0.5 * (i1 + t_im)
    return (c_re * c_re + c_im * c_im) * factor


def line_sums(idx, values, n):
    """float64 (n,) sums of ``values`` by the index ``idx`` (in [0, n)),
    each line of the last axis first into slots of its own, then the lines
    summed: ``index_add_`` with a few modes an address, where one slot a
    bin for a whole block would take millions of colliding float64 atomics
    on the card."""
    lines = max(1, idx.numel() // max(1, idx.shape[-1]))
    offsets = torch.arange(lines, device=idx.device) * n
    flat = (idx.reshape(lines, -1) + offsets[:, None]).flatten()
    acc = torch.zeros(lines * n, dtype=torch.float64, device=idx.device)
    acc.index_add_(0, flat, values.reshape(-1).to(torch.float64))
    return acc.view(lines, n).sum(dim=0)


def mode_terms(kind, arrays, shape, spacing, edges, x0, x1, y_off=0,
               factor=1.0, order=0, ells=None, nmu=None, los_axis=2):
    """The terms of each mode of x rows [x0, x1), the kernel's float32
    operations in its order: (|k|, bin index (nb where masked), weight w
    (the multiplicity, 0 where masked), [float32 value of each output])."""
    nx, ny, nz = shape
    ny_loc = arrays[0].shape[1]
    nbins = len(edges) - 1
    mode, nb, _, ells = _layout(ells, nmu, nbins)
    dev = arrays[0].device
    tabs = axis_tables(shape, float(spacing), str(dev))
    kvec, sinc, _ = tabs
    kx, ky, kz = kvec[:nx], kvec[nx + y_off:nx + y_off + ny_loc], kvec[nx + ny:]
    bx, by, bz = kx[x0:x1, None, None], ky[None, :, None], kz[None, None, :]
    km = torch.sqrt((bx * bx + by * by) + bz * bz)
    v = _values(kind, arrays, slice(x0, x1), float(np.float32(factor)), tabs,
                x0, x1, y_off, y_off + ny_loc, (nx, ny))
    if order:
        wxy = sinc[x0:x1, None] * sinc[nx + y_off:nx + y_off + ny_loc][None, :]
        w = wxy[:, :, None] * sinc[nx + ny:]
        w2 = w * w
        wp = w2
        for _ in range(order - 1):
            wp = wp * w2
        v = v / wp
    edges_t = torch.as_tensor(np.asarray(edges, np.float64),
                              dtype=torch.float32, device=dev)
    idx = torch.searchsorted(edges_t, km.contiguous()) - 1
    valid = (idx >= 0) & (idx < nbins) & (km > 0)
    pos = km > 0
    safe = torch.where(pos, km, 1.0)
    klos = torch.broadcast_to((bx, by, bz)[int(los_axis)], km.shape)
    if mode == _POLES:
        t = klos / safe
        mu2 = torch.where(pos, t * t, 0.0)
        vals = [legendre_weighted(e, mu2, v) for e in ells]
    else:
        vals = [v]
    if mode == _WEDGES:
        mu = torch.where(pos, klos.abs() / safe, 0.0)
        mi = (mu * float(nmu)).to(torch.int32).clamp(0, int(nmu) - 1)
        idx = idx * int(nmu) + mi
    mult = _grid.kz_multiplicity(nz, dev)
    w = torch.where(valid, mult, 0.0)
    vals = [torch.where(valid, val, 0.0) for val in vals]
    return km, torch.where(valid, idx, nb), w, vals


def bin_spectrum_plain(kind, arrays, shape, spacing, edges, y_off=0,
                       factor=1.0, order=0, ells=None, nmu=None, los_axis=2):
    """:func:`bin_spectrum` in plain PyTorch on the arrays' device: the
    terms of :func:`mode_terms`, x-slab by x-slab, summed in float64 by
    :func:`line_sums`."""
    shape = tuple(int(n) for n in shape)
    _check(kind, arrays, shape, y_off)
    edges = np.asarray(edges, np.float64)
    _, nb, n_out, _ = _layout(ells, nmu, edges.size - 1)
    dev = arrays[0].device
    out = torch.zeros((n_out, 3, nb + 1), dtype=torch.float64, device=dev)
    for x0 in range(0, shape[0], _X_CHUNK):
        x1 = min(shape[0], x0 + _X_CHUNK)
        km, idx, w, vals = mode_terms(kind, arrays, shape, spacing, edges, x0,
                                      x1, y_off, factor, order, ells, nmu,
                                      los_axis)
        w = torch.broadcast_to(w, idx.shape)
        counts = line_sums(idx, w, nb + 1)
        ksum = line_sums(idx, w * km.to(torch.float64), nb + 1)
        for o, val in enumerate(vals):
            out[o, 0] += counts
            out[o, 1] += line_sums(idx, w * val.to(torch.float64), nb + 1)
            out[o, 2] += ksum
    return out


def bin_spectrum(kind, arrays, shape, spacing, edges, y_off=0, factor=1.0,
                 order=0, ells=None, nmu=None, los_axis=2):
    """KB: float64 (n_out, 3, nb + 1) bin sums of a packed spectrum.

    ``kind``: 'auto', 'cross', 'interlaced' or 'grid' (the module
    docstring); ``arrays``: its float32 (nx, ny_loc, nz//2+1) lattices, the
    ky rows [y_off, y_off + ny_loc) of an (nx, ny, nz) grid; ``edges``: the
    nbins + 1 ascending |k| edges (host float64, searched in float32);
    ``factor``: the float32 scale of auto, cross and interlaced values;
    ``order``: the window's (0 none); ``ells`` (multipoles) or ``nmu``
    (wedges) or neither (isotropic); ``los_axis``: mu's axis.  On CUDA
    tensors this launches ``csrc/bin_spectrum.cu`` (at most
    :data:`MAX_BINS` bins); CPU tensors run :func:`bin_spectrum_plain`.
    """
    global KB_LAUNCHES
    shape = tuple(int(n) for n in shape)
    _check(kind, arrays, shape, y_off)
    dev = arrays[0].device
    if dev.type == "cpu":
        return bin_spectrum_plain(kind, arrays, shape, spacing, edges, y_off,
                                  factor, order, ells, nmu, los_axis)
    if dev.type != "cuda":
        raise ValueError(f"bin_spectrum runs on cpu or cuda, not {dev}")
    edges = np.asarray(edges, np.float64)
    nbins = edges.size - 1
    if nbins < 1 or np.any(np.diff(edges) <= 0):
        raise ValueError("bin_spectrum needs ascending edges")
    mode, nb, n_out, ells = _layout(ells, nmu, nbins)
    if nb > MAX_BINS:
        raise ValueError(f"bin_spectrum: {nb} bins on CUDA, the kernel holds "
                         f"at most {MAX_BINS}")
    if int(order) not in (0, 1, 2, 3) or int(los_axis) not in (0, 1, 2):
        raise ValueError(f"bin_spectrum: order {order}, los_axis {los_axis}")
    np_ = 3 if mode == _POLES else 1
    arrays = [_aligned(a) for a in arrays]
    ny_loc = arrays[0].shape[1]
    wedges = mode == _WEDGES
    geo = _geometry(shape, float(spacing), edges.tobytes(), int(y_off),
                    ny_loc, int(nmu) if wedges else 0,
                    int(los_axis) if wedges else 2, str(dev))
    acc = _launch(_CODES[kind], mode, arrays, shape, spacing, edges,
                  np_ * nb, y_off, ny_loc, dev, factor, order, ells, nmu,
                  los_axis)
    KB_LAUNCHES += 1
    out = torch.zeros((n_out, 3, nb + 1), dtype=torch.float64, device=dev)
    out[:, 0, :nb] = geo[0]
    out[:, 1, :nb] = acc.view(np_, nb)[:n_out]
    out[:, 2, :nb] = geo[1]
    return out


@functools.lru_cache(maxsize=32)
def _geometry(shape, spacing, edge_bytes, y_off, ny_loc, nmu, los_axis,
              device):
    """float64 (2, nb) on ``device``: by key (bin, or bin nmu + mu bin when
    ``nmu``), sum w and sum w |k| over the modes of the ky rows [y_off,
    y_off + ny_loc): the kernel's geometry pass, which reads no spectrum,
    kept for the geometry."""
    global KB_GEOMETRY_LAUNCHES
    edges = np.frombuffer(edge_bytes, np.float64)
    nb = (edges.size - 1) * max(1, nmu)
    mode = _WEDGES if nmu else _ISO
    acc = _launch(_CODES["geometry"], mode, [], shape, spacing, edges, 2 * nb,
                  y_off, ny_loc, torch.device(device), nmu=nmu or None,
                  los_axis=los_axis)
    KB_GEOMETRY_LAUNCHES += 1
    return acc.view(2, nb)


def _launch(code, mode, arrays, shape, spacing, edges, n_vals, y_off,
            ny_loc, dev, factor=1.0, order=0, ells=None, nmu=None,
            los_axis=2):
    """One launch of the kernel ``code`` (and its block sum) on ``arrays``
    (16-byte aligned; none for the geometry pass): float64 (n_vals,)."""
    nx, ny, nz = shape
    nbins = edges.size - 1
    kind = next(k for k, c in _CODES.items() if c == code)
    warps, stages, n_blocks, _, chunk, chunks = launch_plan(
        kind, mode, nx, ny_loc, nz, nbins, int(nmu or 1), ny)
    kvec, sinc, phase = axis_tables(shape, float(spacing), str(dev))
    thr = torch.as_tensor(edge_thresholds(edges), device=dev)
    acc = torch.empty(n_vals, dtype=torch.float64, device=dev)
    partials = torch.empty(chunks * n_vals, dtype=torch.float64, device=dev)
    ptrs = [a.data_ptr() for a in arrays] + [0] * (4 - len(arrays))
    ell_codes = list(ells or ()) + [-1] * (3 - len(ells or ()))
    status = _build.library().rf_bin_spectrum(
        code, mode, *ptrs, kvec.data_ptr(), sinc.data_ptr(),
        phase.data_ptr(), thr.data_ptr(), acc.data_ptr(),
        partials.data_ptr(), warps, stages, n_blocks, chunk, nx, ny, nz,
        int(y_off),
        ny_loc, nbins, int(nmu or 1), int(los_axis), int(order), *ell_codes,
        float(np.float32(factor)), _build.current_stream(kvec))
    _build.check(status, "bin_spectrum")
    return acc


def read_probe(arrays):
    """The sum of the floats of 1, 2 or 4 float32 (nx, ny_loc, nzh) CUDA
    lattices, streamed through the kernel's staging as :func:`bin_spectrum`
    streams them (the same tiles, stages and grid) with no binning: a
    yardstick of the staging's read rate, which no estimator calls and no
    counter counts.  float64 scalar tensor."""
    kind = _PROBE_KINDS.get(len(arrays))
    a0 = arrays[0]
    if kind is None or a0.device.type != "cuda" or a0.ndim != 3:
        raise ValueError("read_probe takes 1, 2 or 4 CUDA (nx, ny, nzh) "
                         "lattices")
    nx, ny_loc, nzh = a0.shape
    shape = (nx, ny_loc, 2 * (nzh - 1))
    _check(kind, arrays, shape, 0)
    return _launch(_CODES[kind], _PROBE, [_aligned(a) for a in arrays], shape,
                   1.0, np.array([0.0, 1.0]), 1, 0, ny_loc, a0.device)[0]
