"""Morphology, peaks and abundance: beyond two-point statistics.

Port of ``examples/morphology.py``.

Part A, Minkowski functionals (KM): V0..V3 of a rendered field against
the exact Tomita Gaussian forms with this grid's spectral moments.

Part B, peak statistics (KX): lattice maxima by height against the exact
BBKS peak density, then the stacked peak profile against BBKS's
conditional mean.

Part C, the halo mass function: dn/dlnM (Press-Schechter, Sheth-Tormen,
Tinker08), with the PS branch's mass conservation shown numerically.

    python -m randomfield_tpu_torch.examples.morphology
"""

import math

import numpy as np

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models import massfunction as mf


def main(device=None, n=None):
    n = n or 64
    spacing, smooth = 4.0, 12.0  # 64^3: a 256 Mpc/h box

    g = rft.Generator(n, n, n, grid_spacing=spacing, device=device)
    delta = g.generate_delta_field(1, smoothing_length=smooth,
                                   apply_lightcone=False)

    # --- Part A: Minkowski functionals -----------------------------------
    s0 = float(np.sqrt(g.predicted_variance(smoothing_length=smooth)))
    nu, v0, v1, v2, v3 = g.calculate_minkowski(delta, nbins=13, sigma0=s0)
    t0, t1, t2, t3 = g.predicted_minkowski(nu, smoothing_length=smooth)
    print("Minkowski functionals (measured / exact Gaussian):")
    for i in range(0, len(nu), 3):
        print(f"  nu = {nu[i]:+5.2f}  v1 = {v1[i]:.3e} / {t1[i]:.3e}"
              f"   v3 = {v3[i]:+.3e} / {t3[i]:+.3e}")

    # --- Part B: peaks and stacked peak profiles --------------------------
    nu_c, counts, total = g.calculate_peaks(delta, sigma0=s0)
    _, exp_counts, exp_total = g.predicted_peaks(smoothing_length=smooth)
    print(f"\npeaks: {total} lattice maxima; BBKS expects {exp_total:.1f}")

    r, prof, n_pk, nu_bar, x_bar = g.calculate_peak_profile(
        delta, nu_min=1.0, smoothing_length=smooth, nbins=12)
    _, pred = g.predicted_peak_profile(nu_bar, x_bar,
                                       smoothing_length=smooth, nbins=12)
    print(f"stacked profile of {n_pk} peaks with nu >= 1 "
          f"(nu_bar = {nu_bar:.2f}, curvature x_bar = {x_bar:.2f}):")
    for i in range(0, 8):
        print(f"  r = {r[i]:6.1f}  <delta> = {prof[i]:+.4f}  "
              f"(BBKS {pred[i]:+.4f})")

    # --- Part C: halo mass function ----------------------------------------
    m = np.logspace(12, 15, 7)
    print("\nhalo mass function dn/dlnM [(Mpc/h)^-3], z = 0:")
    print(f"  {'M [Msun/h]':>12} {'sigma(M)':>9} {'PS':>10} {'ST':>10} "
          f"{'Tinker08':>10}")
    s, dn_ps = mf.mass_function(g.power, m, fit="ps")
    _, dn_st = mf.mass_function(g.power, m, fit="st")
    _, dn_tk = mf.mass_function(g.power, m, fit="tinker08")
    for i in range(len(m)):
        print(f"  {m[i]:12.2e} {s[i]:9.3f} {dn_ps[i]:10.2e} "
              f"{dn_st[i]:10.2e} {dn_tk[i]:10.2e}")

    # PS mass conservation over the covered range (the factor of 2)
    rho = mf._rho_m_comoving("Planck13")
    lnm = np.linspace(np.log(1e9), np.log(3e15), 300)
    _, dn = mf.mass_function(g.power, np.exp(lnm), fit="ps")
    frac = float(np.trapezoid(np.exp(lnm) * dn / rho, lnm))
    s_ends = mf.sigma_m(g.power, np.exp(lnm[[0, -1]]))
    exact = (math.erf(mf.DELTA_C / s_ends[1] / np.sqrt(2))
             - math.erf(mf.DELTA_C / s_ends[0] / np.sqrt(2)))
    print(f"\nPS mass fraction in [1e9, 3e15] Msun/h: {frac:.4f} "
          f"(exact {exact:.4f})")
    return dict(nu=nu, v1=v1, v3=v3, t1=t1, t3=t3, peaks=int(total),
                peaks_expected=float(exp_total), profile_peaks=int(n_pk),
                nu_bar=float(nu_bar), x_bar=float(x_bar), profile=prof[:8],
                profile_bbks=pred[:8], sigma_m=s, dn_ps=dn_ps, dn_st=dn_st,
                dn_tinker08=dn_tk, ps_fraction=frac, ps_exact=exact)


if __name__ == "__main__":
    cli(main)
