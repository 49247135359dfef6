"""Redshift-space survey forecasting on the grid's exact mode content.

Port of ``examples/forecast_rsd.py``: a differentiable Kaiser theory on
this box's discrete half-spectrum (``torch.func.jacfwd`` of
``models/fisher.py``) -> the exact Gaussian covariance of the binned
P_0/P_2/P_4 data vector -> Fisher errors on (bias, f), then a Monte-Carlo
check that maximum-likelihood amplitude refits on rendered Kaiser mocks
scatter as the forecast says.

    python -m randomfield_tpu_torch.examples.forecast_rsd
"""

import numpy as np
import torch

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models import fisher as mf
from randomfield_tpu_torch.validate.ensemble import (
    predicted_multipole_covariance)
from randomfield_tpu_torch.validate.stats import (
    bin_power_multipoles_grid, calculate_power_multipoles)


def main(device=None, n=None):
    n = n or 64
    spacing = 8.0  # 64^3: a (512 Mpc/h)^3 box
    shape = (n, n, n)
    bias, f, nbins = 1.8, 0.55, 12
    g = rft.Generator(n, n, n, grid_spacing=spacing, device=device)
    table = g.power
    out = {}

    # 1. differentiable per-mode Kaiser model and its exact Fisher matrices
    model, theta0 = mf.make_kaiser_model(
        table, shape, spacing, params=("bias", "f"),
        fixed={"bias": bias, "f": f}, device=g.device)
    f_mode = mf.fisher_matrix(model, theta0, shape)
    f_mult = mf.fisher_matrix_multipoles(model, theta0, shape, spacing,
                                         nbins=nbins, ells=(0, 2, 4))
    f_mono = mf.fisher_matrix_binned(model, theta0, shape, spacing,
                                     nbins=nbins)

    print("marginalized 1-sigma errors on (bias, f):")
    for name, fm in [("per-mode", f_mode), ("P_0+P_2+P_4", f_mult)]:
        err = mf.forecast_errors(fm, names=("bias", "f"))
        print(f"  {name:12s}: sigma_b = {err['bias'][0]:.4f}, "
              f"sigma_f = {err['f'][0]:.4f}")
        out[f"sigma_b {name}"] = float(err["bias"][0])
        out[f"sigma_f {name}"] = float(err["f"][0])
    try:
        err = mf.forecast_errors(f_mono, names=("bias", "f"))
        print(f"  {'P_0 only':12s}: sigma_b = {err['bias'][0]:.4f}, "
              f"sigma_f = {err['f'][0]:.4f}   <- monopole cannot split b/f")
        out["sigma_b P_0"] = float(err["bias"][0])
        out["sigma_f P_0"] = float(err["f"][0])
    except np.linalg.LinAlgError:
        print("  P_0 only    : singular (monopole cannot split b from f)")

    # 2. exact covariance blocks of the multipole estimator (same bins)
    cov = g.predicted_kaiser_multipole_covariance(
        bias=bias, f=f, nbins=nbins, ells=(0, 2))
    a = next(i for i in range(nbins) if np.all(np.isfinite(cov[i])))
    r02 = float(cov[a, 0, 1] / np.sqrt(cov[a, 0, 0] * cov[a, 1, 1]))
    print(f"\nfirst populated bin: corr(P_0, P_2) = {r02:+.3f} "
          "(exact, from this grid's mu coverage)")
    out["corr_p0_p2"] = r02

    # 3. Monte-Carlo: ML amplitude refits on rendered mocks vs the forecast
    model_a, theta_a = mf.make_kaiser_model(
        table, shape, spacing, params=("ln_amp",),
        fixed={"bias": bias, "f": f}, device=g.device)
    f_a = mf.fisher_matrix_multipoles(model_a, theta_a, shape, spacing,
                                      nbins=nbins, ells=(0, 2))
    sigma_fore = float(mf.forecast_errors(f_a, names=("ln_amp",))
                       ["ln_amp"][0])

    pgrid = model_a(theta_a).to(torch.float64)
    covm = predicted_multipole_covariance(pgrid, shape, spacing, nbins=nbins,
                                          ells=(0, 2))
    _, t_ell, _ = bin_power_multipoles_grid(pgrid, shape, spacing,
                                            nbins=nbins, ells=(0, 2))
    t_ell = np.asarray(t_ell, np.float64)

    nseeds = 24
    a_hats = []
    for s in range(nseeds):
        d = np.asarray(calculate_power_multipoles(
            g.generate_kaiser_field(s, bias=bias, f=f), spacing,
            nbins=nbins, ells=(0, 2))[1], np.float64)
        num = den = 0.0
        for i in range(nbins):
            if np.all(np.isfinite(covm[i])) and np.all(np.isfinite(d[:, i])):
                ci = np.linalg.inv(covm[i])
                num += t_ell[:, i] @ ci @ d[:, i]
                den += t_ell[:, i] @ ci @ t_ell[:, i]
        a_hats.append(num / den)
    scatter = float(np.std(np.log(a_hats), ddof=1))
    print(f"\nln-amplitude: forecast sigma = {sigma_fore:.4f}, "
          f"measured refit scatter over {nseeds} mocks = {scatter:.4f}")
    out.update(sigma_ln_amp=sigma_fore, refit_scatter=scatter)
    return out


if __name__ == "__main__":
    cli(main)
