"""KP: mass assignment (NGP, CIC, TSC) of particles onto a periodic grid.

The port of ``randomfield_tpu/models/zeldovich.py:_paint``, where the JAX
package scatter-adds float32 window weights in XLA.  Here the weights are
rounded once to int64 counts of 2^-s units and added as integers:

* :func:`deposit` (``csrc/paint.cu``, counter ``KP_LAUNCHES``): the int64
  (nx, ny, nz) sums of every particle's 1, 8 or 27 window weights, with
  ``shift`` (the interlacing offset a/2) added to the positions in the
  kernel and a scalar weight passed as one value;
* :func:`contrast` (the second kernel of ``csrc/paint.cu``, counter
  ``KPC_LAUNCHES``): float32 ``(acc 2^-s) (1 / mean) - 1`` and the mean
  mass;
* :func:`paint`: both, with s from :func:`fixed_point_exponent`.

Integer adds are associative, so a deposit does not depend on the order
its atomics land in: the kernel equals its plain version
(:func:`deposit_plain`, ``index_add_`` of the same int64 terms) bit for
bit, and two calls give the same bits.  Every float32 operation of a
particle is rounded in the reference's order (:func:`window_terms`):
u = (x + shift) / a, divided and not multiplied by 1/a, the cell-centred
u - 1/2 of CIC and TSC, TSC's round half to even, Python's non-negative
modulo for the wrap, NGP's floor before it.  On CUDA tensors each wrapper
launches its kernel or raises; on CPU tensors it runs the plain version.
"""

from __future__ import annotations

import math

import torch

from randomfield_tpu_torch.ops import _build

__all__ = ["deposit", "deposit_plain", "contrast", "contrast_plain",
           "paint", "window_terms", "fixed_point_exponent", "total_abs_weight",
           "ORDERS", "KP_LAUNCHES", "KPC_LAUNCHES"]

# kernel launches by deposit and by contrast (the CPU path does not count)
KP_LAUNCHES = 0
KPC_LAUNCHES = 0

ORDERS = {"ngp": 1, "cic": 2, "tsc": 3}
# particles a step of the plain version (bounds its temporaries)
_CHUNK = 1 << 22


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


def deposit_plain(positions, shape, spacing, weights=1.0, order=2,
                  shift=0.0, scale_exp=0):
    """:func:`deposit` in plain PyTorch on the positions' device: per chunk
    of particles and window corner, the float32 weight rounded to int64
    units of 2^-scale_exp and ``index_add_`` into the grid."""
    pos, trailing = _positions(positions)
    n = pos.shape[1]
    w0, w = _weights(weights, trailing, pos.device)
    dims = tuple(int(d) for d in shape)
    grid = torch.zeros(dims[0] * dims[1] * dims[2], dtype=torch.int64,
                       device=pos.device)
    scale = math.ldexp(1.0, int(scale_exp))
    spacing32 = torch.tensor(float(spacing), dtype=torch.float32)
    shift32 = torch.tensor(float(shift), dtype=torch.float32)
    for lo in range(0, n, _CHUNK):
        hi = min(n, lo + _CHUNK)
        u = (pos[:, lo:hi] + shift32.to(pos.device)) / spacing32.to(pos.device)
        wt = (w[lo:hi] if w is not None
              else torch.full((hi - lo,), w0, dtype=torch.float32,
                              device=pos.device))
        for idx, fac in window_terms(u, order):
            wc = wt
            if fac is not None:
                for a in range(3):
                    wc = wc * fac[a]
            q = torch.round(wc.to(torch.float64) * scale).to(torch.int64)
            grid.index_add_(0, _flat(idx, dims), q)
    return grid.view(dims)


def deposit(positions, shape, spacing, weights=1.0, order=2, shift=0.0,
            scale_exp=0):
    """KP: int64 (nx, ny, nz) window sums of the particles, in units of
    2^-scale_exp.

    ``positions``: float32 (3, ...) in length units (any trailing shape);
    ``weights``: a scalar, or a float32 tensor of one weight a particle;
    ``order``: 1, 2 or 3 (NGP, CIC, TSC); ``shift``: added to every
    coordinate (in float32, before the division by ``spacing``).  On CUDA
    this launches ``csrc/paint.cu`` into a zeroed grid; on the CPU it runs
    :func:`deposit_plain`.
    """
    global KP_LAUNCHES
    pos, trailing = _positions(positions)
    if int(order) not in (1, 2, 3):
        raise ValueError(f"order must be 1, 2 or 3, got {order!r}")
    if pos.device.type == "cpu":
        return deposit_plain(positions, shape, spacing, weights, order, shift,
                             scale_exp)
    if pos.device.type != "cuda":
        raise ValueError(f"deposit runs on cpu or cuda, not {pos.device}")
    n = pos.shape[1]
    w0, w = _weights(weights, trailing, pos.device)
    pos = pos.contiguous()
    nx, ny, nz = (int(d) for d in shape)
    grid = torch.zeros((nx, ny, nz), dtype=torch.int64, device=pos.device)
    status = _build.library().rf_paint(
        pos.data_ptr(), 0 if w is None else w.data_ptr(),
        0.0 if w0 is None else w0, n, nx, ny, nz, float(spacing),
        float(shift), math.ldexp(1.0, int(scale_exp)), int(order),
        grid.data_ptr(), _build.current_stream(pos))
    _build.check(status, "deposit")
    KP_LAUNCHES += 1
    return grid


def _mean(acc, scale_exp):
    """The mean mass a cell: the exact int64 total times 2^-s over the
    cells, in float64 on the host."""
    total = int(acc.sum())
    return math.ldexp(float(total), -int(scale_exp)) / acc.numel()


def contrast_plain(acc, scale_exp):
    """:func:`contrast` in plain PyTorch on the sums' device."""
    mean = _mean(acc, scale_exp)
    m = acc.to(torch.float64) * math.ldexp(1.0, -int(scale_exp))
    return (m * (1.0 / mean) - 1.0).to(torch.float32), mean


def contrast(acc, scale_exp):
    """(float32 delta = (acc 2^-s) (1 / mean) - 1, mean) of int64 sums, the
    mean mass a cell a host float.  On CUDA the second kernel of
    ``csrc/paint.cu`` (counted in ``KPC_LAUNCHES``), each float64 operation
    rounded as :func:`contrast_plain` rounds it."""
    global KPC_LAUNCHES
    if acc.dtype != torch.int64:
        raise ValueError(f"contrast takes int64 sums, got {acc.dtype}")
    if acc.device.type == "cpu":
        return contrast_plain(acc, scale_exp)
    if acc.device.type != "cuda":
        raise ValueError(f"contrast runs on cpu or cuda, not {acc.device}")
    acc = acc.contiguous()
    mean = _mean(acc, scale_exp)
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
    :func:`contrast`."""
    s = fixed_point_exponent(total_abs_weight(positions, weights))
    acc = deposit(positions, shape, spacing, weights, order, shift, s)
    return contrast(acc, s)
