"""Linear velocity correlations of the Gaussian streaming model.

Holds only :func:`velocity_correlations`, copied from
``randomfield_tpu/models/streaming.py``, which the exact Zel'dovich power
spectrum (:func:`..models.zeldovich.zeldovich_power`) needs.  The rest of
that module (pairwise dispersions, the streaming integral, its
multipoles) is ROADMAP.md, Queue 1 item 9.  Host float64 numpy, as in the
JAX package.  In displacement units (Mpc/h), with potential flow
u_k = i f delta_k k / k^2:

    Psi_perp(r) = (f^2 / 6 pi^2) Int dk P(k) [j0(kr) + j2(kr)]
    Psi_par(r)  = (f^2 / 6 pi^2) Int dk P(k) [j0(kr) - 2 j2(kr)]
    sigma_v^2   = (f^2 / 6 pi^2) Int dk P(k)          (1-D dispersion)
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.ops.fftlog import _prep_power, fftlog_bessel

__all__ = ["velocity_correlations"]


def velocity_correlations(power, r, f=1.0, n=2048, pad_decades=3.0):
    """Linear velocity correlation functions in displacement units.

    Returns ``(psi_par, psi_perp, sigma_v2)`` at separations ``r``
    [Mpc/h]: the parallel/transverse velocity autocorrelations and the
    1-D dispersion, each in (Mpc/h)^2 and carrying the f^2 factor.
    ``power`` is the linear P(k) at the epoch of interest.
    """
    r = np.atleast_1d(np.asarray(r, np.float64))
    if np.any(r <= 0):
        raise ValueError("separations must be positive")
    kg, pg = _prep_power(power, n, pad_decades)
    # Int dk P j_ell(kr) = Int dk/k (k P) j_ell(kr)
    r0, g0 = fftlog_bessel(kg, kg * pg, ell=0, q=1.0)
    r2, g2 = fftlog_bessel(kg, kg * pg, ell=2, q=1.0)
    i0 = np.interp(r, r0, g0)
    i2 = np.interp(r, r2, g2)
    pref = float(f) ** 2 / (6.0 * np.pi**2)
    psi_par = pref * (i0 - 2.0 * i2)
    psi_perp = pref * (i0 + i2)
    sigma_v2 = pref * np.trapezoid(kg * pg, np.log(kg))
    return psi_par, psi_perp, float(sigma_v2)
