"""BAO scale fitting: the standard template fit for alpha.

The analysis step downstream of every mock pipeline in this package
(render -> estimate P(k) -> fit the acoustic scale): fits the isotropic
dilation parameter alpha in

    P_model(k) = B^2 P_template(k / alpha) + sum_i a_i k^{p_i}

to a measured spectrum — the Eisenstein/Anderson-style fit used in BOSS/
eBOSS-class BAO analyses (smooth broadband polynomial absorbs bias,
shot noise and mild nonlinearity; alpha carries the acoustic-scale
information; alpha = r_s,fid D_V / (r_s D_V,fid) in the isotropic
convention).  chi^2 is linear in (B^2, a_i) at fixed alpha, so the fit
is an exact linear solve per alpha on a grid plus a parabolic
refinement; the 1-sigma error comes from Delta chi^2 = 1.

Reference parity: none — the reference (SURVEY.md section 2) stops at
field generation; this is part of the analysis layer its users would
pair it with.  Host float64 numpy by design (dozens of bins x a few
hundred alpha values — an analysis utility, not a device hot path, same
stance as ops/fftlog.py).

A host float64 copy of ``randomfield_tpu/models/baofit.py`` that reads the
port's own modules (power table, cosmology, FFTLog); it imports no JAX.
"""

from __future__ import annotations

import numpy as np

from randomfield_tpu_torch.ops import power as _power

__all__ = ["fit_bao_scale", "fit_bao_scale_ap"]


def _template_at(table, k):
    """Template P at k, linear in log10(k) (the engine's 'log10k'
    interpolation convention, float64)."""
    return np.interp(
        np.log10(np.maximum(k, table.k[0] * 1e-12)),
        np.log10(table.k), table.Pk,
    )


def fit_bao_scale(k, pk, template=None, sigma=None, n_modes=None,
                  alpha_range=(0.85, 1.15), n_alpha=301,
                  broadband=(-1, 0, 1), kmin=None, kmax=None):
    """Fit the BAO dilation parameter alpha to a measured P(k).

    Parameters: ``k``/``pk`` — the measured spectrum (e.g. from
    ``validate.stats.calculate_power`` or an ensemble mean; NaN bins are
    dropped); ``template`` — tabulated template spectrum (anything
    ``as_power_table`` accepts; defaults to the package's default P(k));
    ``sigma`` — per-bin Gaussian errors, or ``n_modes`` to use the
    Gaussian P(k) variance ``sigma = pk sqrt(2 / n_modes)`` (divide
    n_modes by the realization count for ensemble means); unweighted if
    neither is given; ``broadband`` — powers p_i of the additive terms
    ``a_i k^{p_i}`` ((-1, 0, 1) is the standard three-term polynomial;
    () disables the broadband); ``kmin``/``kmax`` — fit range cuts.

    Returns a dict: ``alpha`` (best fit, parabola-refined),
    ``alpha_err`` (Delta chi^2 = 1), ``b2`` (template amplitude),
    ``broadband`` (coefficients a_i), ``chi2_min``, ``dof``,
    ``alpha_grid`` and ``chi2`` (the full profile for plotting /
    posterior checks).  ``alpha_err`` is NaN when the minimum touches
    the edge of ``alpha_range`` (widen the range).
    """
    k = np.asarray(k, np.float64).ravel()
    pk = np.asarray(pk, np.float64).ravel()
    if k.shape != pk.shape:
        raise ValueError("k and pk must have the same length")
    table = (
        _power.load_default_power()
        if template is None
        else _power.validate_power(template)
    )
    keep = np.isfinite(k) & np.isfinite(pk) & (k > 0)
    if kmin is not None:
        keep &= k >= float(kmin)
    if kmax is not None:
        keep &= k <= float(kmax)
    if sigma is not None and n_modes is not None:
        raise ValueError("pass sigma or n_modes, not both")
    if n_modes is not None:
        n_modes = np.asarray(n_modes, np.float64).ravel()
        if n_modes.shape != pk.shape:
            raise ValueError("n_modes must match pk")
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma_full = np.abs(pk) * np.sqrt(
                2.0 / np.where(n_modes > 0, n_modes, np.nan)
            )
    elif sigma is not None:
        sigma_full = np.asarray(sigma, np.float64).ravel()
        if sigma_full.shape != pk.shape:
            raise ValueError("sigma must match pk")
    else:
        sigma_full = np.ones_like(pk)
    keep &= np.isfinite(sigma_full) & (sigma_full > 0)
    k, pk, sig = k[keep], pk[keep], sigma_full[keep]
    broadband = tuple(float(p) for p in broadband)
    npar = 1 + len(broadband)
    if k.size <= npar + 1:
        raise ValueError(
            f"only {k.size} usable bins for {npar} linear parameters — "
            "widen the fit range"
        )
    lo, hi = float(alpha_range[0]), float(alpha_range[1])
    if not (0 < lo < hi):
        raise ValueError("alpha_range must be increasing and positive")
    alphas = np.linspace(lo, hi, int(n_alpha))
    bb_cols = np.stack([k**p for p in broadband], axis=1) if broadband \
        else np.zeros((k.size, 0))
    w = 1.0 / sig
    y = pk * w
    chi2 = np.empty_like(alphas)
    params = np.empty((alphas.size, npar))
    for i, a in enumerate(alphas):
        X = np.concatenate(
            [_template_at(table, k / a)[:, None], bb_cols], axis=1
        ) * w[:, None]
        coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
        r = y - X @ coef
        chi2[i] = r @ r
        params[i] = coef
    i0 = int(np.argmin(chi2))
    alpha, chi2_min = alphas[i0], chi2[i0]
    alpha_err = np.nan
    if 0 < i0 < alphas.size - 1:
        # parabolic refinement through the three bracketing points
        x0, x1, x2 = alphas[i0 - 1:i0 + 2]
        c0, c1, c2 = chi2[i0 - 1:i0 + 2]
        denom = (c0 - 2 * c1 + c2)
        if denom > 0:
            h = x1 - x0
            alpha = x1 + 0.5 * h * (c0 - c2) / denom
            chi2_min = c1 - 0.125 * (c0 - c2) ** 2 / denom
            # Delta chi^2 = 1 on the parabola: curvature denom / h^2
            alpha_err = h * np.sqrt(2.0 / denom)
    return {
        "alpha": float(alpha),
        "alpha_err": float(alpha_err),
        "b2": float(params[i0, 0]),
        "broadband": params[i0, 1:].copy(),
        "chi2_min": float(chi2_min),
        "dof": int(k.size - npar - 1),
        "alpha_grid": alphas,
        "chi2": chi2,
        "n_bins": int(k.size),
    }


_LEGENDRE = {
    0: lambda mu: np.ones_like(mu),
    2: lambda mu: 0.5 * (3.0 * mu**2 - 1.0),
    4: lambda mu: 0.125 * (35.0 * mu**4 - 30.0 * mu**2 + 3.0),
}


def _ap_model_multipoles(table, k, apar, aperp, beta, ells, nodes, wts):
    """Template multipoles under Alcock-Paczynski dilation.

    Observed (k, mu) map to true (k', mu') via ``k' = (k/aperp)
    sqrt(1 + mu^2 (F^-2 - 1))``, ``mu' = (mu/F)/sqrt(1 + mu^2
    (F^-2 - 1))`` with ``F = apar/aperp`` (Ballinger, Peacock & Heavens
    1996), the template is the Kaiser form ``(1 + beta mu'^2)^2
    P(k')``, and the volume dilation divides by ``apar aperp^2``.
    ``P_ell(k) = (2 ell + 1) int_0^1 L_ell(mu) P_t(k', mu') dmu`` (even
    integrand) by Gauss-Legendre over ``nodes``/``wts`` on [0, 1].
    Returns shape ``(len(ells), len(k))``.
    """
    F = apar / aperp
    denom = np.sqrt(1.0 + nodes**2 * (1.0 / F**2 - 1.0))
    kprime = (k[:, None] / aperp) * denom[None, :]
    muprime = (nodes / F) / denom
    pt = (1.0 + beta * muprime[None, :] ** 2) ** 2 * _template_at(
        table, kprime
    )
    pt /= apar * aperp**2
    return np.stack([
        (2.0 * e + 1.0) * (pt * (_LEGENDRE[int(e)](nodes) * wts)[None, :])
        .sum(axis=1)
        for e in ells
    ])


def fit_bao_scale_ap(k, p_ell, ells=(0, 2), template=None, beta=0.4,
                     sigma=None, n_modes=None, cov=None,
                     alpha_par_range=(0.85, 1.15),
                     alpha_perp_range=(0.85, 1.15), n_alpha=61,
                     broadband=(-1, 0, 1), kmin=None, kmax=None, nmu=40):
    """Anisotropic (Alcock-Paczynski) BAO fit to P(k) multipoles.

    Fits the parallel/transverse dilation parameters in

        P_ell,model(k) = B^2 * AP[P_template](k; alpha_par, alpha_perp)
                         + sum_i a_i^(ell) k^{p_i}

    — the BOSS/eBOSS-style anisotropic template fit: the template is
    Kaiser-distorted with fixed ``beta = f/b``, remapped by the AP
    dilation (Ballinger+96 coordinate mapping plus the ``1/(alpha_par
    alpha_perp^2)`` volume factor), multipole-projected by
    Gauss-Legendre, and each multipole carries its own additive
    broadband polynomial.  chi^2 is linear in (B^2, a_i) at fixed
    (alpha_par, alpha_perp), so the fit is an exact linear solve on a
    2-D alpha grid plus a quadratic (paraboloid) refinement; 1-sigma
    errors and the correlation coefficient come from the Delta chi^2 = 1
    ellipse of the refined quadratic.

    Parameters: ``p_ell`` shaped ``(len(ells), len(k))`` (e.g. from
    ``validate.stats.calculate_power_multipoles``); ``sigma`` the same
    shape, or ``n_modes`` shaped ``(len(k),)`` for the leading-order
    Gaussian budget ``sigma_ell = |P_0| sqrt(2 (2 ell + 1) / n_modes)``
    (exact for the monopole of an isotropic spectrum; divide n_modes by
    the realization count for ensemble means), or ``cov`` shaped
    ``(len(k), len(ells), len(ells))`` — per-bin cross-multipole
    covariance blocks (e.g.
    ``Generator.predicted_kaiser_multipole_covariance`` /
    ``validate.ensemble.predicted_multipole_covariance``, divided by
    the realization count for ensemble means): the chi^2 becomes the
    exact block GLS via per-bin Cholesky whitening, reducing to the
    ``sigma`` path exactly when the blocks are diagonal (gated).
    ``alpha_par = r_s,fid H_fid / (r_s H)``, ``alpha_perp = r_s,fid
    D_A / (r_s D_A,fid)`` in the standard convention.

    Returns a dict with ``alpha_par``, ``alpha_perp``, their errors and
    correlation, ``alpha_iso`` (= apar^(1/3) aperp^(2/3), the D_V
    combination), ``b2``, ``chi2_min``, ``dof``, and the full
    ``chi2`` surface over ``alpha_par_grid`` x ``alpha_perp_grid``.
    Errors are NaN when the minimum touches the grid edge.
    """
    k = np.asarray(k, np.float64).ravel()
    p_ell = np.asarray(p_ell, np.float64)
    ells = tuple(int(e) for e in ells)
    if p_ell.shape != (len(ells), k.size):
        raise ValueError(
            f"p_ell must be shaped (len(ells), len(k)) = "
            f"({len(ells)}, {k.size}), got {p_ell.shape}"
        )
    for e in ells:
        if e not in _LEGENDRE:
            raise ValueError(f"ell={e} unsupported: even 0/2/4 only")
    table = (
        _power.load_default_power()
        if template is None
        else _power.validate_power(template)
    )
    if sum(x is not None for x in (sigma, n_modes, cov)) > 1:
        raise ValueError("pass exactly one of sigma, n_modes, cov")
    if cov is not None:
        cov = np.asarray(cov, np.float64)
        if cov.shape != (k.size, len(ells), len(ells)):
            raise ValueError(
                f"cov must be shaped (len(k), nell, nell) = "
                f"({k.size}, {len(ells)}, {len(ells)}), got {cov.shape}")
        sigma_full = None
    elif n_modes is not None:
        n_modes = np.asarray(n_modes, np.float64).ravel()
        if n_modes.shape != k.shape:
            raise ValueError("n_modes must match k")
        with np.errstate(invalid="ignore", divide="ignore"):
            sigma_full = np.stack([
                np.abs(p_ell[0]) * np.sqrt(
                    2.0 * (2 * e + 1) / np.where(n_modes > 0, n_modes,
                                                 np.nan)
                )
                for e in ells
            ])
    elif sigma is not None:
        sigma_full = np.asarray(sigma, np.float64)
        if sigma_full.shape != p_ell.shape:
            raise ValueError("sigma must match p_ell")
    else:
        sigma_full = np.ones_like(p_ell)
    keep = np.isfinite(k) & (k > 0)
    if kmin is not None:
        keep &= k >= float(kmin)
    if kmax is not None:
        keep &= k <= float(kmax)
    keep &= np.isfinite(p_ell).all(axis=0)
    if cov is not None:
        keep &= np.isfinite(cov).all(axis=(1, 2))
        keep &= np.array([np.all(np.diag(c) > 0) for c in cov])
    else:
        keep &= (np.isfinite(sigma_full) & (sigma_full > 0)).all(axis=0)
    k = k[keep]
    p_use = p_ell[:, keep]
    sig = sigma_full[:, keep] if cov is None else None
    broadband = tuple(float(p) for p in broadband)
    nell, nk = len(ells), k.size
    npar = 1 + nell * len(broadband)
    if nell * nk <= npar + 2:
        raise ValueError(
            f"only {nell * nk} usable points for {npar} linear "
            "parameters — widen the fit range"
        )
    # block-diagonal broadband: each multipole gets its own a_i set
    bb_cols = np.zeros((nell * nk, nell * len(broadband)))
    for i_e in range(nell):
        for i_p, p in enumerate(broadband):
            bb_cols[i_e * nk:(i_e + 1) * nk,
                    i_e * len(broadband) + i_p] = k**p
    if cov is not None:
        # per-bin Cholesky whitening: C_a = L_a L_a^T, residuals
        # r -> L_a^{-1} r make the block GLS an ordinary least squares
        blocks = cov[keep]
        try:
            l_inv = np.stack([
                np.linalg.inv(np.linalg.cholesky(c)) for c in blocks
            ])  # (nk, nell, nell)
        except np.linalg.LinAlgError as exc:
            raise ValueError(
                "cov blocks must be positive definite on the kept bins"
            ) from exc

        def _wapply(flat):
            v = flat.reshape(nell, nk)
            return np.einsum("aij,ja->ia", l_inv, v).ravel()
    else:
        w = 1.0 / sig.ravel()

        def _wapply(flat):
            return flat * w

    y = _wapply(p_use.ravel())
    bb_w = np.stack([_wapply(bb_cols[:, c])
                     for c in range(bb_cols.shape[1])], axis=1) \
        if bb_cols.shape[1] else bb_cols
    nodes, wts = np.polynomial.legendre.leggauss(int(nmu))
    # map [-1, 1] -> [0, 1]
    nodes = 0.5 * (nodes + 1.0)
    wts = 0.5 * wts
    apars = np.linspace(*map(float, alpha_par_range), int(n_alpha))
    aperps = np.linspace(*map(float, alpha_perp_range), int(n_alpha))
    chi2 = np.empty((apars.size, aperps.size))
    params = np.empty((apars.size, aperps.size, npar))
    beta = float(beta)
    for i, ap in enumerate(apars):
        for j, at in enumerate(aperps):
            tmpl = _ap_model_multipoles(
                table, k, ap, at, beta, ells, nodes, wts
            ).ravel()
            X = np.concatenate([_wapply(tmpl)[:, None], bb_w], axis=1)
            coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
            r = y - X @ coef
            chi2[i, j] = r @ r
            params[i, j] = coef
    def _solve_at(ap, at):
        tmpl = _ap_model_multipoles(
            table, k, ap, at, beta, ells, nodes, wts
        ).ravel()
        X = np.concatenate([_wapply(tmpl)[:, None], bb_w], axis=1)
        coef, _, _, _ = np.linalg.lstsq(X, y, rcond=None)
        r = y - X @ coef
        return coef, float(r @ r)

    i0, j0 = np.unravel_index(int(np.argmin(chi2)), chi2.shape)
    apar_best, aperp_best = apars[i0], aperps[j0]
    chi2_min = chi2[i0, j0]
    apar_err = aperp_err = corr = np.nan
    interior = 0 < i0 < apars.size - 1 and 0 < j0 < aperps.size - 1
    if interior:
        hx = apars[1] - apars[0]
        hy = aperps[1] - aperps[0]
        c = chi2[i0 - 1:i0 + 2, j0 - 1:j0 + 2]
        gx = (c[2, 1] - c[0, 1]) / (2 * hx)
        gy = (c[1, 2] - c[1, 0]) / (2 * hy)
        axx = (c[2, 1] - 2 * c[1, 1] + c[0, 1]) / hx**2
        ayy = (c[1, 2] - 2 * c[1, 1] + c[1, 0]) / hy**2
        axy = (c[2, 2] - c[2, 0] - c[0, 2] + c[0, 0]) / (4 * hx * hy)
        hess = np.array([[axx, axy], [axy, ayy]])
        # chi2 = chi2_min + d^T A d with A = hess/2; Delta chi2 = 1
        # ellipse => cov = A^{-1}
        if np.all(np.linalg.eigvalsh(hess) > 0):
            step = np.linalg.solve(hess, [gx, gy])
            if np.abs(step[0]) <= hx and np.abs(step[1]) <= hy:
                apar_best = apars[i0] - step[0]
                aperp_best = aperps[j0] - step[1]
            cov = np.linalg.inv(hess / 2.0)
            apar_err = float(np.sqrt(cov[0, 0]))
            aperp_err = float(np.sqrt(cov[1, 1]))
            corr = float(cov[0, 1] / (apar_err * aperp_err))
    # one final linear solve at the refined minimum so the reported
    # amplitude/broadband/chi2 belong to the returned alphas, not the
    # nearest grid node (the broadband terms are degenerate enough with
    # a sub-grid dilation for the difference to matter)
    best_coef, chi2_min = _solve_at(apar_best, aperp_best)
    return {
        "alpha_par": float(apar_best),
        "alpha_perp": float(aperp_best),
        "alpha_par_err": float(apar_err),
        "alpha_perp_err": float(aperp_err),
        "alpha_corr": float(corr),
        "alpha_iso": float(apar_best ** (1.0 / 3.0)
                           * aperp_best ** (2.0 / 3.0)),
        "b2": float(best_coef[0]),
        "broadband": best_coef[1:].reshape(nell, len(broadband))
        if broadband else np.zeros((nell, 0)),
        "chi2_min": float(chi2_min),
        "dof": int(nell * nk - npar - 2),
        "alpha_par_grid": apars,
        "alpha_perp_grid": aperps,
        "chi2": chi2,
        "n_bins": int(nk),
    }
