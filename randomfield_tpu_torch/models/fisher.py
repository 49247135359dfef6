"""Fisher-matrix forecasting by autodiff through the discrete theory.

Port of ``randomfield_tpu/models/fisher.py`` with its names, arguments and
returns: the per-mode theory P(k; theta) on the exact discrete
half-spectrum is a differentiable float32 torch function (the JAX model's
operations in their order), its parameter derivatives come from
``torch.func.jacfwd`` where the JAX package calls ``jax.jacfwd``, and the
Fisher information is an exact mode sum over this grid,

    F_ij = sum_k (mult_k / 2) dlnP_i(k) dlnP_j(k),

with the estimator's multiplicity convention (interior-kz entries stand
for their unstored conjugate, mult = 2; kz-plane entries mult = 1).  The
model and its Jacobian run on ``device`` (default "cuda"); the weighted
sums, binning and covariances are host float64 numpy, as in the JAX
package.  Full width is the module's stated range: forecasting grids up to
256^3.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power

__all__ = [
    "PARAM_DEFAULTS",
    "make_kaiser_model",
    "fisher_matrix",
    "fisher_matrix_binned",
    "fisher_matrix_multipoles",
    "binned_covariance_from_pgrid",
    "forecast_errors",
]

#: Fiducial values used for parameters not varied (and not overridden via
#: ``fixed=``): ``ln_amp`` scales exp(ln_amp) P; ``alpha`` is an isotropic
#: Alcock-Paczynski dilation P(alpha k) / alpha^3; ``sigma_s`` the render's
#: Gaussian smoothing exp(-(k sigma_s)^2); ``sigma_fog`` a Gaussian
#: Fingers-of-God damping exp(-(k mu sigma_fog)^2).
PARAM_DEFAULTS = {
    "ln_amp": 0.0,
    "bias": 1.0,
    "f": 0.0,
    "alpha": 1.0,
    "sigma_s": 0.0,
    "sigma_fog": 0.0,
}


def _host(t):
    return t.cpu().numpy().astype(np.float64)


def make_kaiser_model(power, shape, spacing, params=("ln_amp", "bias", "f"),
                      los_axis=2, interpolation="log10k", fixed=None,
                      dtype=torch.float32, device=None):
    """Differentiable per-mode Kaiser theory on this grid's half-spectrum.

    Returns ``(model_fn, theta0)``: ``model_fn(theta) -> pgrid`` maps the
    active-parameter vector (ordered as ``params``) to

        exp(ln_amp) (b + f mu^2)^2 P_lin(alpha |k|) / alpha^3
        exp(-(|k| sigma_s)^2) exp(-(|k| mu sigma_fog)^2)

    on the packed half-grid (DC = 0) of ``device`` (default "cuda"), with
    the render path's log10(k) interpolation; ``theta0`` holds the
    fiducial values (PARAM_DEFAULTS overridden by ``fixed``).  As in the
    JAX package, sigma derivatives vanish at a fiducial of exactly 0, and
    (ln_amp, bias, f) together are exactly degenerate
    (:func:`forecast_errors` refuses the singular matrix).
    """
    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    dev = torch.device("cuda" if device is None else device)
    table = _power.validate_power(power)
    _power.require_coverage(table, shape, spacing)
    params = tuple(params)
    for name in params:
        if name not in PARAM_DEFAULTS:
            raise ValueError(
                f"unknown parameter {name!r}; known: {sorted(PARAM_DEFAULTS)}")
    fid = dict(PARAM_DEFAULTS)
    fid.update(fixed or {})

    kmag = _grid.kmag(shape, spacing, dtype, dev)
    k_los = _grid.kvectors(shape, spacing, dtype, dev)[int(los_axis)]
    bcast = [1, 1, 1]
    bcast[int(los_axis)] = -1
    k2 = kmag * kmag
    inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
    mu2 = (k_los * k_los).reshape(bcast) * inv

    lk_tab = torch.as_tensor(np.log10(table.k), dtype=dtype, device=dev)
    if interpolation == "log10k":
        val_tab = torch.as_tensor(table.Pk, dtype=dtype, device=dev)
        log_values = False
    elif interpolation == "loglog":
        if np.any(table.Pk <= 0):
            raise ValueError("loglog interpolation requires P(k) > 0")
        val_tab = torch.as_tensor(np.log10(table.Pk), dtype=dtype,
                                  device=dev)
        log_values = True
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")
    floor = float(np.asarray(1e-30, _power._NUMPY[dtype]))

    def model(theta):
        theta = torch.as_tensor(theta, dtype=dtype, device=dev)
        d = {k: torch.tensor(v, dtype=dtype, device=dev)
             for k, v in fid.items()}
        for i, name in enumerate(params):
            d[name] = theta[i]
        kq = d["alpha"] * kmag
        p = _power._interp(torch.log10(torch.clamp(kq, min=floor)), lk_tab,
                           val_tab)
        if log_values:
            p = 10.0**p
        p = p / d["alpha"] ** 3
        p = torch.exp(d["ln_amp"]) * p * (d["bias"] + d["f"] * mu2) ** 2
        p = p * torch.exp(-(kmag * d["sigma_s"]) ** 2)
        p = p * torch.exp(-(k2 * mu2) * d["sigma_fog"] ** 2)
        return torch.where(kmag > 0, p, 0.0)

    theta0 = torch.tensor([fid[name] for name in params], dtype=dtype,
                          device=dev)
    return model, theta0


def _model_and_jacobian(model_fn, theta0):
    """(P, dP/dtheta) at ``theta0`` as host float64 arrays, the Jacobian
    (..., nparam) by forward-mode autodiff."""
    p0 = model_fn(theta0)
    jac = torch.func.jacfwd(model_fn)(theta0)
    return _host(p0), _host(jac)


def _mode_weights(shape):
    """Half-grid estimator multiplicities (mult in {1, 2}), numpy f64."""
    nx, ny, nz = (int(s) for s in shape)
    nzh = nz // 2 + 1
    mult = np.full(nzh, 2.0)
    mult[0] = 1.0
    if nz % 2 == 0:
        mult[-1] = 1.0
    return np.broadcast_to(mult[None, None, :], (nx, ny, nzh))


def fisher_matrix(model_fn, theta0, shape):
    """Exact per-mode Fisher matrix F_ij = sum (mult/2) dlnP_i dlnP_j.

    ``model_fn`` from :func:`make_kaiser_model` (or any function of a
    parameter vector to a per-mode half-grid power tensor); ``shape`` the
    FULL grid shape (an even nz has a Nyquist plane).  Derivatives by
    ``torch.func.jacfwd``; the weighted sums on the host in float64;
    modes with P = 0 are skipped.  Returns (nparam, nparam) numpy float64.
    """
    theta0 = torch.as_tensor(theta0)
    p0, jac = _model_and_jacobian(model_fn, theta0)
    w = _mode_weights(shape) / 2.0
    good = p0 > 0
    dlnp = np.zeros_like(jac)
    dlnp[good] = jac[good] / p0[good][..., None]
    wd = (w * good)[..., None] * dlnp
    n = int(theta0.shape[0])
    return np.einsum("xyzi,xyzj->ij", wd, dlnp, optimize=True).reshape(n, n)


def binned_covariance_from_pgrid(pgrid, shape, spacing, nbins=32):
    """Exact Gaussian covariance of binned P(k) for an arbitrary per-mode
    power expectation half-grid.

    The generalization of validate/ensemble.py:predicted_power_covariance
    (which assumes an isotropic interpolated table) to any ``pgrid`` —
    e.g. an anisotropic Kaiser expectation from
    :func:`make_kaiser_model`.  Same bin edges, masks and multiplicity
    convention as validate/stats.py:calculate_power.  Returns
    ``(edges, counts, cov)`` with cov diagonal (nbins, nbins), NaN in
    empty bins.
    """
    shape = tuple(int(s) for s in shape)
    pg = (_host(pgrid) if isinstance(pgrid, torch.Tensor)
          else np.asarray(pgrid, np.float64))
    km = _host(_grid.kmag(shape, float(spacing), torch.float32))
    mult = _mode_weights(shape)
    var_k = np.where(mult == 2.0, 4.0 * pg**2, 2.0 * pg**2)
    kmin, kmax = _grid.get_k_bounds(shape, float(spacing))
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001),
                        int(nbins) + 1)
    idx = np.searchsorted(edges, km) - 1
    valid = (idx >= 0) & (idx < int(nbins)) & (km > 0)
    counts = np.bincount(idx[valid], weights=mult[valid],
                         minlength=int(nbins))
    vsum = np.bincount(idx[valid], weights=var_k[valid],
                       minlength=int(nbins))
    with np.errstate(invalid="ignore", divide="ignore"):
        var = np.where(counts > 0, vsum / counts**2, np.nan)
    return edges, counts, np.diag(var)


def fisher_matrix_binned(model_fn, theta0, shape, spacing, nbins=32):
    """Fisher matrix of the *binned* P(k) estimator, F = J^T C^-1 J.

    ``J`` is the jacobian of the exact per-bin expectation (mult-weighted
    bin means of the per-mode model, the same reduction as
    validate/stats.py:bin_power_grid) and ``C`` the exact Gaussian
    covariance from :func:`binned_covariance_from_pgrid`.  Information
    inequality: binned F <= per-mode :func:`fisher_matrix`, with
    equality when dlnP is constant within every bin (e.g. a pure
    amplitude parameter on any spectrum — binning is lossless for it
    only when P is bin-constant).  Returns
    (nparam, nparam) numpy f64.
    """
    shape = tuple(int(s) for s in shape)
    theta0 = torch.as_tensor(theta0)
    p0, jac = _model_and_jacobian(model_fn, theta0)
    km = _host(_grid.kmag(shape, float(spacing), torch.float32))
    mult = _mode_weights(shape)
    edges, counts, cov = binned_covariance_from_pgrid(
        p0, shape, spacing, nbins=nbins)
    idx = np.searchsorted(edges, km) - 1
    valid = (idx >= 0) & (idx < int(nbins)) & (km > 0)
    nparam = int(theta0.shape[0])
    J = np.zeros((int(nbins), nparam))
    wj = mult[valid][:, None] * jac[valid]
    for i in range(nparam):
        J[:, i] = np.bincount(idx[valid], weights=wj[:, i],
                              minlength=int(nbins))
    nonempty = counts > 0
    J[nonempty] /= counts[nonempty][:, None]
    var = np.diag(cov)
    use = nonempty & np.isfinite(var) & (var > 0)
    return (J[use].T / var[use]) @ J[use]


def fisher_matrix_multipoles(model_fn, theta0, shape, spacing, nbins=32,
                             ells=(0, 2, 4), los_axis=2):
    """Fisher matrix of the binned P_ell(k) data vector.

    The redshift-space forecasting workhorse: F = sum_a J_a^T C_a^-1
    J_a over |k| bins, where ``J_a`` is the jacobian of the exact
    per-bin multipole expectations (the
    validate/stats.py:bin_power_multipoles_grid reduction of the
    per-mode model) and ``C_a`` the exact within-bin covariance block
    across ells (validate/ensemble.py:predicted_multipole_covariance).
    Information chain (PSD ordering):

        fisher_matrix  >=  fisher_matrix_multipoles  >=
        fisher_matrix_binned  ==  this with ells=(0,)   (exactly).

    Multipoles recover the mu-structure information (bias/f splits)
    that monopole binning destroys; ell <= 4 captures nearly all of it
    for Kaiser-type models.  Bins with singular covariance blocks
    (empty or mu-degenerate) are skipped.  Returns (nparam, nparam)
    numpy f64.
    """
    from randomfield_tpu_torch.validate import ensemble as _ensemble

    shape = tuple(int(s) for s in shape)
    spacing = float(spacing)
    ells = tuple(int(e) for e in ells)
    theta0 = torch.as_tensor(theta0)
    p0, jac = _model_and_jacobian(model_fn, theta0)
    cov = _ensemble.predicted_multipole_covariance(
        p0, shape, spacing, nbins=nbins, ells=ells, los_axis=los_axis)

    km = _host(_grid.kmag(shape, spacing, torch.float32))
    k_los = _host(_grid.kvectors(shape, spacing)[int(los_axis)])
    bcast = [None, None, None]
    bcast[int(los_axis)] = slice(None)
    with np.errstate(invalid="ignore", divide="ignore"):
        mu2 = np.where(km > 0, (k_los[tuple(bcast)] / np.where(
            km > 0, km, 1.0)) ** 2, 0.0)
    mu2 = np.broadcast_to(mu2, p0.shape)
    mult = _mode_weights(shape)
    kmin, kmax = _grid.get_k_bounds(shape, spacing)
    edges = np.logspace(np.log10(kmin * 0.999), np.log10(kmax * 1.001),
                        int(nbins) + 1)
    idx = np.searchsorted(edges, km) - 1
    valid = (idx >= 0) & (idx < int(nbins)) & (km > 0)
    counts = np.bincount(idx[valid], weights=mult[valid],
                         minlength=int(nbins))

    # Legendre weights on mu^2 (plain numpy)
    leg = {0: lambda m2: np.ones_like(m2),
           2: lambda m2: 0.5 * (3.0 * m2 - 1.0),
           4: lambda m2: 0.125 * (35.0 * m2 * m2 - 30.0 * m2 + 3.0)}
    for e in ells:
        if e not in leg:
            raise ValueError(f"unsupported multipole ell={e}")

    nparam = int(theta0.shape[0])
    ne = len(ells)
    J = np.zeros((int(nbins), ne, nparam))
    mv = mult[valid]
    jv = jac[valid]
    iv = idx[valid]
    for e_i, ell in enumerate(ells):
        w = (2.0 * ell + 1.0) * leg[ell](mu2[valid])
        for p_i in range(nparam):
            J[:, e_i, p_i] = np.bincount(
                iv, weights=mv * w * jv[:, p_i], minlength=int(nbins))
    nonempty = counts > 0
    J[nonempty] /= counts[nonempty][:, None, None]

    F = np.zeros((nparam, nparam))
    for a in range(int(nbins)):
        if not nonempty[a] or not np.all(np.isfinite(cov[a])):
            continue
        c = cov[a]
        if np.linalg.cond(c) > 1e12:
            continue
        F += J[a].T @ np.linalg.solve(c, J[a])
    return F


def forecast_errors(fisher, names=None):
    """Marginalized and conditional 1-sigma errors from a Fisher matrix.

    Returns a dict ``name -> (marginalized, conditional)`` where
    marginalized = sqrt((F^-1)_ii) (all other parameters free) and
    conditional = 1/sqrt(F_ii) (all others fixed).  ``names`` defaults
    to ``p0..pN``.  Raises on a singular Fisher matrix (exactly
    degenerate parameter pair — e.g. ln_amp with bias at f = 0).
    """
    F = np.asarray(fisher, np.float64)
    n = F.shape[0]
    if names is None:
        names = [f"p{i}" for i in range(n)]
    cond = np.linalg.cond(F)
    if not np.isfinite(cond) or cond > 1e12:
        raise np.linalg.LinAlgError(
            f"Fisher matrix is singular/degenerate (cond={cond:.3g}); "
            "remove one of the degenerate parameters")
    inv = np.linalg.inv(F)
    return {
        str(name): (float(np.sqrt(inv[i, i])), float(1.0 / np.sqrt(F[i, i])))
        for i, name in enumerate(names)
    }
