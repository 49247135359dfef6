"""Cosmic-web classification from the tidal (T-web) tensor.

Port of ``randomfield_tpu/models/web.py`` (``eigenvalues_sym3``,
``classify_web``, ``web_fractions``): every voxel is classified by the
signature of the tidal tensor ``T_ij = d_i d_j phi`` (``grad^2 phi =
delta``), the T-web scheme of Hahn et al. (2007): the count of eigenvalues
above a threshold maps to void (0), sheet (1), filament (2), knot (3).

The eigenvalues of each symmetric 3x3 come from the closed-form
trigonometric solution (Smith 1961), elementwise in plain PyTorch as the
JAX package leaves it to XLA; :func:`classify_web` works x-slab by x-slab
so its temporaries stay a few slabs at any grid size.  The six components
come from ``Generator.generate_tidal_field`` or
``ops.derived.delta_to_tidal``.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops.derived import TIDAL_PAIRS

__all__ = ["eigenvalues_sym3", "classify_web", "web_fractions", "WEB_TYPES",
           "TIDAL_PAIRS"]

WEB_TYPES = ("void", "sheet", "filament", "knot")

# x slabs per step of classify_web
_X_CHUNK = 16


def eigenvalues_sym3(t):
    """Eigenvalues of symmetric 3x3 tensors, descending: (3, ...) <- (6, ...).

    ``t`` packs (xx, yy, zz, xy, xz, yz) in :data:`TIDAL_PAIRS` order with
    any trailing shape.  Closed form: exact for distinct eigenvalues,
    graceful (clamped acos) at degeneracies, in ``t``'s dtype.
    """
    a00, a11, a22, a01, a02, a12 = (t[i] for i in range(6))
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(p2 / 6.0)
    live = p > 0
    safe_p = torch.where(live, p, 1.0)
    # r = det(B/p) / 2 for B = A - q I
    det_b = (b00 * (b11 * b22 - a12 * a12)
             - a01 * (a01 * b22 - a12 * a02)
             + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(det_b / (2.0 * safe_p * safe_p * safe_p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    two_pi_3 = float(np.float32(2.0 * np.pi / 3.0))
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + two_pi_3)
    lam2 = 3.0 * q - lam1 - lam3
    return torch.stack([torch.where(live, lam, q)
                        for lam in (lam1, lam2, lam3)])


def classify_web(tidal, threshold=0.0):
    """Per-voxel eigenvalue-signature class of a packed tidal tensor.

    ``tidal``: (6, nx, ...) components in :data:`TIDAL_PAIRS` order.
    Returns int8 classes 0..3, the count of eigenvalues above
    ``threshold``: void / sheet / filament / knot (:data:`WEB_TYPES`), on
    ``tidal``'s device.
    """
    tidal = torch.as_tensor(tidal)
    out = torch.empty(tidal.shape[1:], dtype=torch.int8, device=tidal.device)
    for x0 in range(0, tidal.shape[1], _X_CHUNK):
        lam = eigenvalues_sym3(tidal[:, x0:x0 + _X_CHUNK])
        out[x0:x0 + _X_CHUNK] = (lam > threshold).sum(dim=0).to(torch.int8)
    return out


def web_fractions(classes):
    """Volume fractions of (void, sheet, filament, knot), host float64."""
    c = torch.as_tensor(classes).reshape(-1).to(torch.int64)
    counts = torch.bincount(c, minlength=4).cpu().numpy()
    return counts.astype(np.float64) / c.numel()
