"""Standard (Zel'dovich) BAO reconstruction.

Port of ``randomfield_tpu/models/reconstruction.py`` with its names,
arguments and returns (Eisenstein et al. 2007):

    psi_hat(k) = i k / k^2 S(k) delta_g(k) / [b (1 + beta mu^2)]
    delta_d    = the field's mass moved back by -psi_hat ("displaced")
    delta_s    = a uniform grid moved back by -psi_hat  ("shifted")
    delta_rec  = delta_d - delta_s

with S(k) = exp(-k^2 Sigma^2 / 2), b the linear bias and beta = f/b.  On
the field's device: one forward transform (K6, K3 x2), and for each
component KD's 'recon' kind (:func:`..ops.derived.apply_kernel`: the
smoothing, the Kaiser division and i k_a / k^2 in one pass over the
spectrum) and an inverse transform (K3 x2, K4); the two paintings are KP
(:func:`.zeldovich.paint`); :func:`displacement_at_positions` gathers on
the displacement's device.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import transform as _transform

__all__ = [
    "estimate_displacement",
    "displacement_at_positions",
    "reconstruct_field",
]


def estimate_displacement(delta, spacing, smoothing=10.0, bias=1.0, f=0.0,
                          los_axis=2):
    """Estimated Zel'dovich displacement psi_hat [Mpc/h], (3, nx, ny, nz)
    float32 on ``delta``'s device.

    ``smoothing`` is the Gaussian Sigma in Mpc/h (typically 10-15);
    ``bias``/``f`` divide out the linear tracer model b (1 + beta mu^2)
    along ``los_axis``.
    """
    delta = torch.as_tensor(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    re, im = _transform.rfftn(delta)
    pref = (1.0 / (shape[0] * shape[1] * shape[2]), float(bias), float(f),
            float(smoothing))
    comps = []
    for a in range(3):
        r, i = (re, im) if a == 2 else (re.clone(), im.clone())
        _derived.apply_kernel(r, i, shape, float(spacing), "recon", a, pref,
                              los_axis=int(los_axis))
        comps.append(_transform.irfftn_reim(r, i, shape))
    return torch.stack(comps)


def displacement_at_positions(psi, positions, spacing):
    """NGP-read a displacement grid at comoving positions: ``psi`` (3, nx,
    ny, nz), ``positions`` (N, 3) Mpc/h in the periodic box; the cells on
    the host, the values gathered on ``psi``'s device.  Returns (N, 3)
    host values."""
    psi = torch.as_tensor(psi)
    shape = np.array(psi.shape[-3:])
    cells = np.floor(np.asarray(positions, np.float64)
                     / float(spacing)).astype(np.int64) % shape
    flat = (cells[:, 0] * shape[1] + cells[:, 1]) * shape[2] + cells[:, 2]
    idx = torch.as_tensor(flat, device=psi.device)
    vals = psi.reshape(3, -1)[:, idx]
    return vals.T.cpu().numpy()


def reconstruct_field(delta, spacing, smoothing=10.0, bias=1.0, f=0.0,
                      los_axis=2, window="cic"):
    """Grid-level reconstruction: returns ``(delta_rec, psi_hat)``.

    Mass elements at the cell centers weighted ``1 + delta`` move back by
    ``-psi_hat`` and are painted (``delta_d``); an unweighted uniform grid
    moves the same way (``delta_s``); one window for both, so its
    systematics cancel in the difference.
    """
    from randomfield_tpu_torch.models import zeldovich as _zl

    delta = torch.as_tensor(delta)
    shape = tuple(int(s) for s in delta.shape[-3:])
    psi = estimate_displacement(delta, spacing, smoothing=smoothing,
                                bias=bias, f=f, los_axis=los_axis)
    moved = _zl.lagrangian_positions(shape, float(spacing), delta.dtype,
                                     device=delta.device)
    moved.sub_(psi)
    delta_d, _ = _zl.paint(moved, shape, float(spacing),
                           weights=1.0 + delta, window=window)
    delta_s, _ = _zl.paint(moved, shape, float(spacing), window=window)
    return delta_d - delta_s, psi
