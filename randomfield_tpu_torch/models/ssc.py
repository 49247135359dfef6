"""Super-sample covariance: power-spectrum response to a background mode.

A survey footprint (or any windowed sub-volume) samples density modes
longer than itself only through their effect on the mean density inside
the window.  A background overdensity delta_b modulates the measured
small-scale power through the tree-level response (Takada & Hu 2013,
arXiv:1302.6994, eq. 32; the separate-universe decomposition of growth,
dilation, and mean-density terms):

    d ln P(k) / d delta_b = 68/21 - (1/3) d ln [k^3 P(k)] / d ln k,

which adds a rank-one "super-sample" block to the Gaussian covariance
of binned P(k) estimates:

    C^SSC_ij = sigma_b^2 R(k_i) R(k_j),      R(k) = dP(k)/d delta_b,

with sigma_b^2 the variance of the linear density field averaged over
the footprint window.  For a periodic simulation box delta_b is frozen
to zero, so SSC vanishes for full-box estimates — it enters exactly
when a mask/window selects part of the volume, the same regime as
validate/fkp.py and the masked pseudo-spectra in models/lensing.py.

The 2015 reference package is linear-theory only with no covariance
machinery (SURVEY.md section 0) — capability expansion.  Complements
the EXACT Gaussian block (validate/ensemble.py:predicted_power_covariance)
which this matrix simply adds to.  Host-side float64 numpy (1-D table
calculus; no device work).

A host float64 copy of ``randomfield_tpu/models/ssc.py`` that reads the
port's own modules (power table, cosmology, FFTLog); it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.ops.power import sigma_r, validate_power

__all__ = [
    "power_response",
    "sigma_b_from_mask",
    "sigma_b_tophat",
    "ssc_covariance",
]


def power_response(power, k=None):
    """Tree-level SSC response R(k) = dP(k)/d delta_b.

    ``power``: anything :func:`~randomfield_tpu_torch.ops.power.validate_power`
    accepts.  ``k``: evaluation wavenumbers (default: the table's own
    knots).  Returns host float64 ``(k, R)``.

    The logarithmic slope d ln(k^3 P)/d ln k is evaluated by central
    differences on the table's log-log samples, which is EXACT for any
    pure power law P = A k^n (log P is linear in log k), giving
    R = (68/21 - (3 + n)/3) P — the gate in tests/test_ssc.py.
    """
    table = validate_power(power)
    lk = np.log(np.asarray(table.k, np.float64))
    ptab = np.asarray(table.Pk, np.float64)
    if np.any(ptab <= 0):
        raise ValueError("power_response needs strictly positive P(k) "
                         "(log-derivative of the table)")
    lp = np.log(ptab)
    # d ln(k^3 P)/d ln k = 3 + d ln P/d ln k
    slope_tab = 3.0 + np.gradient(lp, lk)
    if k is None:
        kk = np.asarray(table.k, np.float64)
        p = np.asarray(table.Pk, np.float64)
        slope = slope_tab
    else:
        kk = np.atleast_1d(np.asarray(k, np.float64))
        # np.interp extrapolates flat: outside the table it would return
        # the edge P and slope silently — wrong response values.  The
        # covariance path (predicted_power_covariance) guards its k range
        # the same way (ADVICE r3).
        if np.any(kk < table.k[0]) or np.any(kk > table.k[-1]):
            raise ValueError(
                f"power_response: requested k in "
                f"[{kk.min():.4g}, {kk.max():.4g}] outside the table's "
                f"coverage [{table.k[0]:.4g}, {table.k[-1]:.4g}] h/Mpc"
            )
        p = np.exp(np.interp(np.log(kk), lk, lp))
        slope = np.interp(np.log(kk), lk, slope_tab)
    resp = (68.0 / 21.0 - slope / 3.0) * p
    return kk, resp


def sigma_b_tophat(power, r):
    """RMS background-mode amplitude sigma_b for a spherical top-hat
    footprint of comoving radius ``r`` — identically sigma(R) of the
    linear spectrum (ops/power.py:sigma_r), exposed under the SSC name
    so the covariance call site reads like the literature."""
    return float(sigma_r(validate_power(power), float(r)))


def sigma_b_from_mask(mask, spacing, power, interpolation="log10k"):
    """EXACT lattice sigma_b for an arbitrary footprint weight mask.

    ``mask``: real 3-D weights m(x) on this package's grid (1 inside
    the footprint, 0 outside; arbitrary apodization allowed);
    ``spacing``: grid spacing.  The window-averaged density is
    delta_b = sum m delta / sum m, and with this package's conventions
    (delta(x) = sum_k c(k) e^{ikx}, <|c(k)|^2> = P(|k|)/V — the same
    normalization pinned by validate/oracle.py:oracle_sigmas) its
    variance over realizations is the exact mode sum

        sigma_b^2 = sum_{k != 0} |M(k)|^2 / M(0)^2 * P(|k|) / V,

    with M(k) the unnormalized DFT of the mask.  A unit mask has
    M(k != 0) = 0 identically — sigma_b = 0 for full periodic boxes,
    the statement that SSC vanishes without a window.  P is
    interpolated in log10(k) like the render path.  Host float64,
    O(N^3) memory — validation-scale.
    """
    m = np.asarray(mask, np.float64)
    if m.ndim != 3:
        raise ValueError("mask must be a 3-D weight array")
    if not np.any(m):
        raise ValueError("mask is identically zero")
    table = validate_power(power)
    spacing = float(spacing)
    nx, ny, nz = m.shape
    volume = nx * ny * nz * spacing**3
    mk2 = np.abs(np.fft.fftn(m)) ** 2
    kx = 2 * np.pi * np.fft.fftfreq(nx, d=spacing)
    ky = 2 * np.pi * np.fft.fftfreq(ny, d=spacing)
    kz = 2 * np.pi * np.fft.fftfreq(nz, d=spacing)
    kmag = np.sqrt(kx[:, None, None] ** 2 + ky[None, :, None] ** 2
                   + kz[None, None, :] ** 2)
    ktab = np.asarray(table.k, np.float64)
    ptab = np.asarray(table.Pk, np.float64)
    lk = np.log10(np.where(kmag > 0, kmag, ktab[0]))
    if interpolation == "log10k":
        pk = np.interp(lk, np.log10(ktab), ptab)
    elif interpolation == "loglog":
        pk = 10.0 ** np.interp(lk, np.log10(ktab), np.log10(ptab))
    else:
        raise ValueError(interpolation)
    pk[kmag == 0] = 0.0
    var = float(np.sum(mk2 * pk)) / (float(m.sum()) ** 2 * volume)
    return float(np.sqrt(var))


def ssc_covariance(power, k, sigma_b):
    """Rank-one SSC covariance block C_ij = sigma_b^2 R(k_i) R(k_j).

    ``k``: bin-center wavenumbers of the P(k) estimate (e.g. the
    ``k_mean`` returned by validate/stats.py:calculate_power);
    ``sigma_b``: background-mode RMS over the footprint window
    (:func:`sigma_b_tophat` for spherical footprints, or the user's own
    window integral).  NaN bin centers (empty bins) propagate to NaN
    rows/columns, matching predicted_power_covariance.  Add the result
    to the Gaussian block for the total covariance.
    """
    k = np.asarray(k, np.float64)
    resp = np.full(k.shape, np.nan)
    good = np.isfinite(k)
    _, resp[good] = power_response(power, k[good])
    return float(sigma_b) ** 2 * np.outer(resp, resp)
