"""Ensemble P(k)/sigma(R) covariance (config 4 workload, scaled down).

Port of ``examples/ensemble_covariance.py``: 64 seeded realizations in
one batch (``generate_delta_fields``), their P(k) covariance and sigma(8),
the FFT-free ensemble of sampled spectra (``sample_power_ensemble`` over
``Generator.sample_power_batch``, the port's batch where the JAX script
vmaps), and the super-sample covariance of a windowed footprint.

    python -m randomfield_tpu_torch.examples.ensemble_covariance
"""

import numpy as np

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models import ssc
from randomfield_tpu_torch.ops.power import load_default_power
from randomfield_tpu_torch.validate import ensemble


def main(device=None, n=None):
    n = n or 64
    nbins = 12
    gen = rft.Generator(n, n, n, grid_spacing=4.0, device=device)
    seeds = np.arange(64)
    fields = gen.generate_delta_fields(seeds, apply_lightcone=False)

    k, p_hat, n_modes = ensemble.ensemble_power(fields, gen.grid_spacing,
                                                nbins=nbins)
    cov = ensemble.power_covariance(p_hat)

    print("bin  k        <P^>        rel.err   (expected ~ sqrt(2/(n_modes*n_seeds)))")
    rel_err = np.full(len(k), np.nan)
    expected = np.full(len(k), np.nan)
    for i in range(len(k)):
        if np.isfinite(p_hat[:, i]).all() and n_modes[i] > 0:
            rel_err[i] = (np.sqrt(cov[i, i]) / p_hat[:, i].mean()
                          / np.sqrt(len(seeds)))
            expected[i] = np.sqrt(2.0 / (n_modes[i] * len(seeds)))
            print(f"{i:3d}  {k[i]:.4f}  {p_hat[:, i].mean():10.1f}  "
                  f"{rel_err[i]:.4f}  ({expected[i]:.4f})")

    s8 = [ensemble.sigma_r_from_field(fields[i], gen.grid_spacing, 8.0)
          for i in range(8)]
    print(f"\nsigma(8 Mpc/h) realized: {np.mean(s8):.4f} +- {np.std(s8):.4f}")

    # for grids near the memory ceiling, skip fields entirely: the sampled
    # spectrum already determines P-hat (no FFT at all)
    k2, p2, n2 = ensemble.sample_power_ensemble(gen, seeds[:16], nbins=nbins)
    ratio = float(np.nanmean(p2.mean(axis=0) / p_hat.mean(axis=0)))
    print("\nFFT-free spectrum-space ensemble (16 seeds): "
          f"mean P ratio to field-space = {ratio:.4f}")

    # windowed footprints add super-sample covariance on top of the exact
    # Gaussian block (rank one, fully correlated); the Gaussian block is
    # the full-box estimator's, so the boost shows the SSC term's size
    table = load_default_power()
    mask = np.zeros(tuple(fields.shape[1:]))
    mask[:n // 2, :n // 2, :] = 1.0  # a quarter-box survey footprint
    sigma_b = ssc.sigma_b_from_mask(mask, gen.grid_spacing, table)
    gauss = ensemble.predicted_power_covariance(
        table, tuple(fields.shape[1:]), gen.grid_spacing, nbins=nbins,
        device=gen.device)
    total = gauss + ssc.ssc_covariance(table, k, sigma_b)
    good = np.isfinite(np.diag(total)) & (np.diag(gauss) > 0)
    boost = np.diag(total)[good] / np.diag(gauss)[good]
    print(f"\nSSC (quarter-box footprint, sigma_b={sigma_b:.4f}): "
          f"diagonal boost x{boost.min():.3f}-x{boost.max():.3f}")
    return dict(k=k, p_mean=p_hat.mean(axis=0), rel_err=rel_err,
                expected=expected, sigma8_mean=float(np.mean(s8)),
                sigma8_std=float(np.std(s8)), sampled_ratio=ratio,
                sigma_b=float(sigma_b), boost_min=float(boost.min()),
                boost_max=float(boost.max()))


if __name__ == "__main__":
    cli(main)
