"""The galaxy-survey mock chain, end to end.

Port of ``examples/galaxy_survey.py``:

    linear P(k) -> lognormal matter field -> biased halo catalog (mass
    function + PBS bias, KH) -> HOD galaxies (centrals + NFW satellites)
    -> redshift space (Kaiser + Fingers of God) -> measured P_0/P_2 vs
    Kaiser x linear theory; BAO reconstruction of an evolved mock; the
    halo-model nonlinear P(k) and the FFTLog xi(r).

    python -m randomfield_tpu_torch.examples.galaxy_survey
"""

import numpy as np
import torch

import randomfield_tpu_torch as rft
from randomfield_tpu_torch.examples import cli
from randomfield_tpu_torch.models import massfunction as mf
from randomfield_tpu_torch.models import reconstruction as rc
from randomfield_tpu_torch.models import zeldovich as zl
from randomfield_tpu_torch.models.halomodel import halo_model_power
from randomfield_tpu_torch.models.halos import HaloGenerator
from randomfield_tpu_torch.models.hod import HODGenerator
from randomfield_tpu_torch.ops import fftlog
from randomfield_tpu_torch.ops.power import load_default_power
from randomfield_tpu_torch.validate import stats


def _p_lin(power, k):
    return np.interp(np.log10(k), np.log10(np.asarray(power.k)),
                     np.asarray(power.Pk))


def main(device=None, n=None):
    n = n or 64
    spacing = 8.0  # 64^3: a 512 Mpc/h box
    shape = (n, n, n)
    power = load_default_power()
    out = {}

    # --- halo abundance & bias (theory) ----------------------------------
    m = np.geomspace(1e13, 1e15, 5)
    _, dn = mf.mass_function(power, m, fit="st")
    _, b = mf.halo_bias(power, m, fit="st")
    print("M [Msun/h]   dn/dlnM [(Mpc/h)^-3]   b(M)")
    for mi, di, bi in zip(m, dn, b):
        print(f"  {mi:9.2e}  {di:18.3e}  {bi:6.2f}")
    out.update(dn_dlnm=dn, halo_bias=b)

    # --- halo mock: abundance check --------------------------------------
    halos = HaloGenerator(n, n, n, grid_spacing=spacing, mmin=1e13,
                          mmax=1e15, nbins_mass=3, fit="st", device=device)
    pos, mass = halos.generate_halo_catalog(seed=7)
    expected = float(halos.expected_counts().sum())
    print(f"\nhalos drawn: {pos.shape[0]} (expected {expected:.0f}); "
          f"bin biases {np.round(halos.bias, 2)}")
    out.update(halos=int(pos.shape[0]), halos_expected=expected)

    # --- HOD galaxies in redshift space -----------------------------------
    gals = HODGenerator(n, n, n, grid_spacing=spacing,
                        hod=dict(logmmin=13.0, sigma_logm=0.25,
                                 logm0=13.0, logm1=14.0, alpha=1.0),
                        device=device)
    p_s, is_cen = gals.generate_galaxy_catalog(seed=7, rsd=True)
    print(f"galaxies: {p_s.shape[0]} ({int(is_cen.sum())} centrals, "
          f"{int((~is_cen).sum())} satellites); "
          f"n_g = {gals.galaxy_density:.2e} (Mpc/h)^-3, b_g = "
          f"{gals.galaxy_bias:.2f}")
    out.update(galaxies=int(p_s.shape[0]), centrals=int(is_cen.sum()))

    positions = torch.as_tensor(np.asarray(p_s, np.float32).T,
                                device=halos.device)
    k, p_ell, nm = zl.catalog_power_multipoles(
        positions, spacing, shape=shape, nbins=10, ells=(0, 2))
    f = float(gals.cosmology.growth_rate(0.0))
    beta = f / gals.galaxy_bias
    kaiser0 = 1 + 2 * beta / 3 + beta**2 / 5
    expect = (kaiser0 * gals.galaxy_bias**2 * _p_lin(power, k)
              + 1.0 / gals.galaxy_density)
    print("\n  k       P0^s meas   Kaiser b^2 P_lin + shot")
    rows = np.where(nm > 8)[0][:4]
    for i in rows:
        print(f"  {k[i]:.4f}  {p_ell[0][i]:10.0f}  {expect[i]:10.0f}")
    out.update(p0_measured=np.asarray(p_ell[0])[rows], p0_expected=expect[rows])

    # --- BAO reconstruction on an evolved mock ----------------------------
    g = rft.Generator(n, n, n, grid_spacing=spacing, device=device)
    seed = 11
    delta_lin = g.generate_delta_field(seed, apply_lightcone=False)
    psi = g.generate_displacement(seed)
    q = zl.lagrangian_positions(shape, spacing, device=g.device)
    evolved, _ = zl.paint(q + psi, shape, spacing, window="cic")
    rec, _ = rc.reconstruct_field(evolved, spacing, smoothing=10.0)

    def cross_r(a, b_, nbins=8):
        kk, pab, cc = stats.calculate_cross_power(a, b_, spacing,
                                                  nbins=nbins)
        _, paa, _ = stats.calculate_power(a, spacing, nbins=nbins)
        _, pbb, _ = stats.calculate_power(b_, spacing, nbins=nbins)
        return kk, pab / np.sqrt(np.maximum(paa * pbb, 1e-30)), cc

    kk, r_ev, cc = cross_r(evolved, delta_lin)
    _, r_rec, _ = cross_r(rec, delta_lin)
    print("\nBAO reconstruction (cross-correlation with the initial field):")
    rows = np.where(cc > 20)[0][2:6]
    for i in rows:
        print(f"  k = {kk[i]:.3f}  r_evolved = {r_ev[i]:+.3f}  "
              f"r_reconstructed = {r_rec[i]:+.3f}")
    out.update(r_evolved=r_ev[rows], r_reconstructed=r_rec[rows])

    # --- theory: halo-model nonlinear P(k), FFTLog xi(r) -------------------
    kk, pt, p1h, p2h = halo_model_power(power, fit="st")
    i = np.searchsorted(kk, 0.25)
    ratio = float(pt[i] / _p_lin(power, 0.25))
    print(f"\nhalo model at k=0.25 h/Mpc: P_tot/P_lin = {ratio:.2f} "
          f"(1h fraction {p1h[i] / pt[i]:.2f})")
    r, xi = fftlog.xi_from_power(power)
    xis = [float(np.interp(x, r, xi)) for x in (10.0, 50.0, 105.0)]
    print(f"FFTLog xi(r): xi(10) = {xis[0]:.3f}, xi(50) = {xis[1]:.4f} "
          f"(BAO bump near r ~ 100: xi(105) = {xis[2]:.5f})")
    out.update(halo_model_ratio=ratio, one_halo_fraction=float(p1h[i] / pt[i]),
               xi_10=xis[0], xi_50=xis[1], xi_105=xis[2])
    return out


if __name__ == "__main__":
    cli(main)
