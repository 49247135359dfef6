"""The port's examples (randomfield_tpu_torch.examples) against the JAX
package's scripts (examples/*.py) on the CPU at a small grid.

Each ``main(device="cpu", n=...)`` runs the script's workflow, prints its
comparisons and returns finite numbers.  The JAX scripts fix their sizes
at module level, so each is replayed here as a function of the grid, the
same calls and the same printed lines at the port's size; the two
outputs must have the same lines, each number within
``tests/test_torch_cli.py``'s bar (the largest of 1e-4 relative, one unit
in its last printed place and 1e-6 absolute).  16^3 for all but
``forecast_rsd``, whose Kaiser covariance blocks are singular in a bin at
16^3 (its smallest valid size is 32^3).

The same inputs: the JAX CPU path scales each mode by its per-mode sigma
grid, the port by a uniform log10-k table, which differ by up to 3e-4 a
mode (the public-API bar of tests/test_torch_generator.py).  Here the
port's tables are made 16 times finer, so both packages render the same
fields to float32 rounding and the lines test the examples' own
arithmetic.  ``mock_catalog``'s lognormal field still differs by 1e-4 of
its peak after the exp, enough to move one Poisson count of 4096 at
16^3 across a tie (KH on the JAX field gives the JAX count), so its JAX
replay draws the galaxies from the port's field.
"""

import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

# xdist runs six workers on the host: two threads each keep them off one
# another's cores
torch.set_num_threads(2)

from randomfield_tpu_torch.ops import sampler  # noqa: E402
from test_torch_cli import _assert_same_lines  # noqa: E402

FINER = 16  # the port's sigma-table knot steps, divided


@pytest.fixture(autouse=True)
def fine_sigma_tables(monkeypatch):
    """The port's grid and box sigma tables FINER times finer (the
    table's interpolation error falls as the step squared)."""
    count = sampler.table_knot_count
    monkeypatch.setattr(sampler, "table_knot_count",
                        lambda shape: FINER * (count(shape) - 1) + 1)
    monkeypatch.setattr(sampler, "BOX_TABLE_DLK",
                        sampler.BOX_TABLE_DLK / FINER)


def _jax_quickstart(n):
    import jax.numpy as jnp

    import randomfield_tpu as rf
    from randomfield_tpu.ops.power import interpolate_power
    from randomfield_tpu.validate.stats import field_moments

    gen = rf.Generator(n, n, n, grid_spacing=4.0)
    delta = gen.generate_delta_field(seed=42)
    mean, var = field_moments(delta)
    print(f"field: {delta.shape} {delta.dtype}")
    print(f"mean = {mean:.2e}  (exactly 0 in expectation)")
    print(f"var  = {var:.4f}  vs predicted {gen.predicted_variance():.4f}"
          f" (x <D^2> = {np.mean(gen.growth_function**2):.3f} for the "
          "lightcone)")
    k, p_hat, n_modes = gen.calculate_power(delta, nbins=10)
    print("\nrealized P(k) vs input table:")
    for i in range(len(k)):
        if n_modes[i] > 0:
            p_true = float(interpolate_power(gen.power, jnp.float32(k[i])))
            print(f"  k={k[i]:.4f}  P^={p_hat[i]:10.1f}  P={p_true:10.1f} "
                  f" ({n_modes[i]:5.0f} modes)")


def _jax_ensemble_covariance(n):
    import randomfield_tpu as rf
    from randomfield_tpu.models import ssc
    from randomfield_tpu.ops.power import load_default_power
    from randomfield_tpu.validate import ensemble
    from randomfield_tpu.validate.ensemble import predicted_power_covariance

    gen = rf.Generator(n, n, n, grid_spacing=4.0)
    seeds = np.arange(64)
    fields = gen.generate_delta_fields(seeds, apply_lightcone=False)
    k, p_hat, n_modes = ensemble.ensemble_power(fields, gen.grid_spacing,
                                                nbins=12)
    cov = ensemble.power_covariance(p_hat)
    print("bin  k        <P^>        rel.err   (expected ~ "
          "sqrt(2/(n_modes*n_seeds)))")
    for i in range(len(k)):
        if np.isfinite(p_hat[:, i]).all() and n_modes[i] > 0:
            rel = np.sqrt(cov[i, i]) / p_hat[:, i].mean() / np.sqrt(len(seeds))
            exp = np.sqrt(2.0 / (n_modes[i] * len(seeds)))
            print(f"{i:3d}  {k[i]:.4f}  {p_hat[:, i].mean():10.1f}  "
                  f"{rel:.4f}  ({exp:.4f})")
    s8 = [ensemble.sigma_r_from_field(fields[i], gen.grid_spacing, 8.0)
          for i in range(8)]
    print(f"\nsigma(8 Mpc/h) realized: {np.mean(s8):.4f} +- {np.std(s8):.4f}")
    k2, p2, n2 = ensemble.sample_power_ensemble(gen, seeds[:16], nbins=12)
    print("\nFFT-free spectrum-space ensemble (16 seeds): "
          f"mean P ratio to field-space = "
          f"{np.nanmean(p2.mean(axis=0) / p_hat.mean(axis=0)):.4f}")
    table = load_default_power()
    mask = np.zeros(fields.shape[1:])
    mask[:n // 2, :n // 2, :] = 1.0
    sigma_b = ssc.sigma_b_from_mask(mask, gen.grid_spacing, table)
    gauss = predicted_power_covariance(table, fields.shape[1:],
                                       gen.grid_spacing, nbins=12)
    total = gauss + ssc.ssc_covariance(table, k, sigma_b)
    good = np.isfinite(np.diag(total)) & (np.diag(gauss) > 0)
    boost = np.diag(total)[good] / np.diag(gauss)[good]
    print(f"\nSSC (quarter-box footprint, sigma_b={sigma_b:.4f}): "
          f"diagonal boost x{boost.min():.3f}-x{boost.max():.3f}")


def _jax_lensing_map(n):
    import randomfield_tpu as rf
    from randomfield_tpu.models import lensing

    g = rf.Generator(n, n, n, grid_spacing=10.0)
    delta = g.generate_delta_field(seed=42)
    for z_source in (0.5, 1.0, 2.0):
        kappa = lensing.convergence_map(
            delta, g.cosmology, g.scene.grid_spacing, z_source=z_source)
        k = np.asarray(kappa)
        print(f"z_s = {z_source}: sigma_kappa = {k.std():.5f} "
              f"(mean {k.mean():+.2e})")
    g1, g2 = lensing.convergence_to_shear(kappa, g.scene.grid_spacing)
    g1, g2 = np.asarray(g1), np.asarray(g2)
    print(f"shear: sigma_gamma1 = {g1.std():.5f}, "
          f"sigma_gamma2 = {g2.std():.5f}")
    print("E-mode consistency <|gamma|^2>/<kappa^2> =",
          round(float((g1.var() + g2.var()) / np.asarray(kappa).var()), 3))


def _jax_variance_reduction(n):
    from randomfield_tpu import Generator
    from randomfield_tpu.models.lognormal import LognormalGenerator

    spacing = 8.0
    g = Generator(n, n, n, grid_spacing=spacing)
    _, _, nm = g.sample_power(0, nbins=10)
    p_rand = np.stack([
        g.calculate_power(g.generate_delta_field(s, apply_lightcone=False),
                          nbins=10)[1]
        for s in range(4)])
    p_fixed = np.stack([
        g.calculate_power(g.generate_fixed_field(s, apply_lightcone=False),
                          nbins=10)[1]
        for s in range(4)])
    m = nm > 8
    print("per-bin scatter across 4 seeds (relative):")
    print(f"  random : "
          f"{np.nanmean(np.std(p_rand, 0)[m] / np.mean(p_rand, 0)[m]):.4f}")
    print(f"  fixed  : "
          f"{np.nanmean(np.std(p_fixed, 0)[m] / np.mean(p_fixed, 0)[m]):.2e}")
    ln = LognormalGenerator(n, n, n, grid_spacing=spacing)
    d_plus = np.asarray(ln.generate_fixed_field(7, apply_lightcone=False))
    d_minus = np.asarray(ln.generate_fixed_field(7, apply_lightcone=False,
                                                 flip=True))
    print(f"lognormal pair means: {d_plus.mean():+.5f} / "
          f"{d_minus.mean():+.5f} -> pair average "
          f"{(d_plus.mean() + d_minus.mean()) / 2:+.6f}")
    box, lo, hi = n * spacing, n // 2, n
    g_lo = Generator(lo, lo, lo, grid_spacing=box / lo, sampler="nested")
    g_hi = Generator(hi, hi, hi, grid_spacing=box / hi, sampler="nested")
    d_lo = np.asarray(g_lo.generate_delta_field(5, apply_lightcone=False),
                      np.float64)
    d_hi = np.asarray(g_hi.generate_delta_field(5, apply_lightcone=False),
                      np.float64)
    c_lo = np.fft.rfftn(d_lo, norm="forward")
    c_hi = np.fft.rfftn(d_hi, norm="forward")
    reach = lo // 2 - 1
    diffs = [
        abs(c_lo[sx % lo, sy % lo, kz] - c_hi[sx % hi, sy % hi, kz])
        for sx in range(-reach, reach + 1) for sy in range(-reach, reach + 1)
        for kz in range(lo // 2)]
    print(f"zoom: max shared-mode |c_lo - c_hi| = {max(diffs):.2e} "
          f"(of scale {np.abs(c_lo).max():.2e}) over {len(diffs)} modes")


def _port_lognormal_field(n, spacing):
    """The port's lognormal field of mock_catalog's Part A, as an array."""
    from randomfield_tpu_torch.models.lognormal import LognormalGenerator

    ln = LognormalGenerator(n, n, n, grid_spacing=spacing, device="cpu")
    return ln.generate_delta_field(seed=42, apply_lightcone=False).numpy()


def _jax_mock_catalog(n):
    from randomfield_tpu import Generator
    from randomfield_tpu.models import zeldovich as zl
    from randomfield_tpu.models.lognormal import LognormalGenerator
    from randomfield_tpu.ops.power import PowerTable, interpolate_power

    spacing, nbar = 8.0, 2e-3
    volume = (n * spacing) ** 3
    ln = LognormalGenerator(n, n, n, grid_spacing=spacing)
    delta = _port_lognormal_field(n, spacing)  # not a tie apart: see top
    counts = zl.poisson_sample(delta, nbar, spacing, seed=42)
    print(f"galaxies: {float(np.asarray(counts).sum()):.0f} "
          f"(target {nbar * volume:.0f})")
    q = zl.lagrangian_positions((n, n, n), spacing)
    k, p, nm = zl.catalog_power(q, spacing, weights=counts, nbins=14,
                                window="ngp")
    print(f"shot noise subtracted: "
          f"{zl.shot_noise(np.asarray(counts), volume):.1f} (Mpc/h)^3")
    print("lognormal tracer P(k) vs target:")
    for i in range(len(k)):
        if nm[i] > 200:
            plin = float(interpolate_power(ln.power, np.float32(k[i])))
            print(f"  k = {k[i]:7.4f}  P^ = {p[i]:10.1f}  "
                  f"target = {plin:10.1f}  ({nm[i]:7.0f} modes)")
    base = ln.power
    table = PowerTable(base.k, 0.05 * base.Pk)
    g = Generator(n, n, n, grid_spacing=spacing, power=table)
    f = float(g.cosmology.growth_rate(0.5))
    psi = g.generate_displacement(seed=7)
    pos = zl.zeldovich_positions(psi, spacing, f=f)
    k, ps, nm = zl.catalog_power(pos, spacing, nbins=14, window="cic")
    kaiser = 1.0 + 2.0 * f / 3.0 + f * f / 5.0
    print(f"\nZel'dovich RSD monopole vs Kaiser x linear (f = {f:.3f}, "
          f"boost = {kaiser:.3f}):")
    for i in range(len(k)):
        if nm[i] > 200 and k[i] < 0.5 * np.pi / spacing:
            plin = float(interpolate_power(table, np.float32(k[i])))
            print(f"  k = {k[i]:7.4f}  P^_s = {ps[i]:9.2f}  "
                  f"Kaiser*P_lin = {kaiser * plin:9.2f}  "
                  f"({nm[i]:7.0f} modes)")


def _jax_constrained_field(n):
    from randomfield_tpu import Generator

    spacing = 256.0 / n
    g = Generator(n, n, n, grid_spacing=spacing)
    constraints = [
        ((128.0, 128.0, 128.0), +3.0, 16.0),
        ((48.0, 208.0, 64.0), -1.5, 24.0),
    ]
    print("constraint Gram matrix (inspect conditioning):")
    print(np.array_str(g.constraint_matrix(constraints), precision=4))
    for seed in (0, 1, 2):
        d = g.generate_constrained_field(seed, constraints)
        got = g.measure_constraints(d, constraints)
        print(f"  seed {seed}: measured constraints = {np.round(got, 4)} "
              f"(targets +3.0 / -1.5), field var "
              f"{float(np.var(np.asarray(d))):.3f}")
    mean = g.constrained_mean_field(constraints)
    print(f"conditional mean field: constraints "
          f"{np.round(g.measure_constraints(mean, constraints), 4)}, "
          f"|mean| max {float(np.abs(np.asarray(mean)).max()):.3f}")
    probe = (192.0, 64.0, 192.0)
    xi = g.constraint_matrix(constraints + [(probe, 0.0, 0.0)])
    cc, cf = xi[:2, :2], xi[2, :2]
    cond_var = xi[2, 2] - cf @ np.linalg.solve(cc, cf)
    print(f"probe-point variance: unconditional {xi[2, 2]:.3f} -> "
          f"conditional {cond_var:.3f} (exact Gaussian formula)")
    truth = np.asarray(g.generate_delta_field(42, apply_lightcone=False))
    noise_std = 0.6 * truth.std()
    data = truth + np.random.RandomState(0).normal(scale=noise_std,
                                                   size=truth.shape)
    noise_power = noise_std**2 * spacing**3
    rec = np.asarray(g.wiener_filter(data, noise_power))
    mse_data = float(np.mean((data - truth) ** 2))
    mse_rec = float(np.mean((rec - truth) ** 2))
    print(f"wiener: data MSE {mse_data:.4f} -> reconstruction MSE "
          f"{mse_rec:.4f} (exact expectation "
          f"{g.predicted_posterior_mse(noise_power):.4f})")
    post = np.stack([
        np.asarray(g.generate_posterior_field(s, data, noise_power))
        for s in range(8)])
    print(f"posterior samples: mean-field residual rms "
          f"{float(np.sqrt(np.mean((post.mean(0) - rec) ** 2))):.4f}, "
          f"per-sample scatter rms {float(post.std(0).mean()):.4f}")


def _jax_morphology(n):
    from randomfield_tpu import Generator
    from randomfield_tpu.models import massfunction as mf

    spacing, smooth = 4.0, 12.0
    g = Generator(n, n, n, grid_spacing=spacing)
    delta = np.asarray(g.generate_delta_field(1, smoothing_length=smooth,
                                              apply_lightcone=False))
    s0 = np.sqrt(g.predicted_variance(smoothing_length=smooth))
    nu, v0, v1, v2, v3 = g.calculate_minkowski(delta, nbins=13, sigma0=s0)
    t0, t1, t2, t3 = g.predicted_minkowski(nu, smoothing_length=smooth)
    print("Minkowski functionals (measured / exact Gaussian):")
    for i in range(0, len(nu), 3):
        print(f"  nu = {nu[i]:+5.2f}  v1 = {v1[i]:.3e} / {t1[i]:.3e}"
              f"   v3 = {v3[i]:+.3e} / {t3[i]:+.3e}")
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
    rho = mf._rho_m_comoving("Planck13")
    lnm = np.linspace(np.log(1e9), np.log(3e15), 300)
    _, dn = mf.mass_function(g.power, np.exp(lnm), fit="ps")
    frac = np.trapezoid(np.exp(lnm) * dn / rho, lnm)
    s_ends = mf.sigma_m(g.power, np.exp(lnm[[0, -1]]))
    exact = (math.erf(mf.DELTA_C / s_ends[1] / np.sqrt(2))
             - math.erf(mf.DELTA_C / s_ends[0] / np.sqrt(2)))
    print(f"\nPS mass fraction in [1e9, 3e15] Msun/h: {frac:.4f} "
          f"(exact {exact:.4f})")


def _jax_forecast_rsd(n):
    import randomfield_tpu as rf
    from randomfield_tpu.models import fisher as mf
    from randomfield_tpu.validate.ensemble import (
        predicted_multipole_covariance)
    from randomfield_tpu.validate.stats import (
        bin_power_multipoles_grid, calculate_power_multipoles)

    spacing, shape = 8.0, (n, n, n)
    bias, f = 1.8, 0.55
    table = rf.load_default_power()
    model, theta0 = mf.make_kaiser_model(
        table, shape, spacing, params=("bias", "f"),
        fixed={"bias": bias, "f": f})
    f_mode = mf.fisher_matrix(model, theta0, shape)
    f_mult = mf.fisher_matrix_multipoles(model, theta0, shape, spacing,
                                         nbins=12, ells=(0, 2, 4))
    f_mono = mf.fisher_matrix_binned(model, theta0, shape, spacing, nbins=12)
    print("marginalized 1-sigma errors on (bias, f):")
    for name, fm in [("per-mode", f_mode), ("P_0+P_2+P_4", f_mult)]:
        err = mf.forecast_errors(fm, names=("bias", "f"))
        print(f"  {name:12s}: sigma_b = {err['bias'][0]:.4f}, "
              f"sigma_f = {err['f'][0]:.4f}")
    try:
        err = mf.forecast_errors(f_mono, names=("bias", "f"))
        print(f"  {'P_0 only':12s}: sigma_b = {err['bias'][0]:.4f}, "
              f"sigma_f = {err['f'][0]:.4f}   <- monopole cannot split b/f")
    except np.linalg.LinAlgError:
        print("  P_0 only    : singular (monopole cannot split b from f)")
    g = rf.Generator(n, n, n, grid_spacing=spacing)
    cov = g.predicted_kaiser_multipole_covariance(
        bias=bias, f=f, nbins=12, ells=(0, 2))
    a = next(i for i in range(12) if np.all(np.isfinite(cov[i])))
    r02 = cov[a, 0, 1] / np.sqrt(cov[a, 0, 0] * cov[a, 1, 1])
    print(f"\nfirst populated bin: corr(P_0, P_2) = {r02:+.3f} "
          "(exact, from this grid's mu coverage)")
    model_a, theta_a = mf.make_kaiser_model(
        table, shape, spacing, params=("ln_amp",),
        fixed={"bias": bias, "f": f})
    f_a = mf.fisher_matrix_multipoles(model_a, theta_a, shape, spacing,
                                      nbins=12, ells=(0, 2))
    sigma_fore = mf.forecast_errors(f_a, names=("ln_amp",))["ln_amp"][0]
    pgrid = np.asarray(model_a(theta_a), np.float64)
    covm = predicted_multipole_covariance(pgrid, shape, spacing, nbins=12,
                                          ells=(0, 2))
    _, t_ell, _ = bin_power_multipoles_grid(pgrid, shape, spacing, nbins=12,
                                            ells=(0, 2))
    t_ell = np.asarray(t_ell, np.float64)
    nseeds = 24
    a_hats = []
    for s in range(nseeds):
        d = np.asarray(calculate_power_multipoles(
            g.generate_kaiser_field(s, bias=bias, f=f), spacing,
            nbins=12, ells=(0, 2))[1], np.float64)
        num = den = 0.0
        for i in range(12):
            if np.all(np.isfinite(covm[i])) and np.all(np.isfinite(d[:, i])):
                ci = np.linalg.inv(covm[i])
                num += t_ell[:, i] @ ci @ d[:, i]
                den += t_ell[:, i] @ ci @ t_ell[:, i]
        a_hats.append(num / den)
    scatter = np.std(np.log(a_hats), ddof=1)
    print(f"\nln-amplitude: forecast sigma = {sigma_fore:.4f}, "
          f"measured refit scatter over {nseeds} mocks = {scatter:.4f}")


def _jax_galaxy_survey(n):
    import jax.numpy as jnp

    from randomfield_tpu import Generator
    from randomfield_tpu.models import massfunction as mf
    from randomfield_tpu.models import reconstruction as rc
    from randomfield_tpu.models import zeldovich as zl
    from randomfield_tpu.models.halomodel import halo_model_power
    from randomfield_tpu.models.halos import HaloGenerator
    from randomfield_tpu.models.hod import HODGenerator
    from randomfield_tpu.ops import fftlog
    from randomfield_tpu.ops.power import load_default_power
    from randomfield_tpu.validate import stats

    spacing, shape = 8.0, (n, n, n)
    power = load_default_power()
    m = np.geomspace(1e13, 1e15, 5)
    _, dn = mf.mass_function(power, m, fit="st")
    _, b = mf.halo_bias(power, m, fit="st")
    print("M [Msun/h]   dn/dlnM [(Mpc/h)^-3]   b(M)")
    for mi, di, bi in zip(m, dn, b):
        print(f"  {mi:9.2e}  {di:18.3e}  {bi:6.2f}")
    halos = HaloGenerator(n, n, n, grid_spacing=spacing, mmin=1e13,
                          mmax=1e15, nbins_mass=3, fit="st")
    pos, mass = halos.generate_halo_catalog(seed=7)
    print(f"\nhalos drawn: {pos.shape[0]} "
          f"(expected {halos.expected_counts().sum():.0f}); "
          f"bin biases {np.round(halos.bias, 2)}")
    gals = HODGenerator(n, n, n, grid_spacing=spacing,
                        hod=dict(logmmin=13.0, sigma_logm=0.25,
                                 logm0=13.0, logm1=14.0, alpha=1.0))
    p_s, is_cen = gals.generate_galaxy_catalog(seed=7, rsd=True)
    print(f"galaxies: {p_s.shape[0]} ({int(is_cen.sum())} centrals, "
          f"{int((~is_cen).sum())} satellites); "
          f"n_g = {gals.galaxy_density:.2e} (Mpc/h)^-3, b_g = "
          f"{gals.galaxy_bias:.2f}")
    k, p_ell, nm = zl.catalog_power_multipoles(
        np.asarray(p_s, np.float32).T, spacing, shape=shape, nbins=10,
        ells=(0, 2))
    f = float(gals.cosmology.growth_rate(0.0))
    beta = f / gals.galaxy_bias
    kaiser0 = 1 + 2 * beta / 3 + beta**2 / 5
    plin = np.interp(np.log10(k), np.log10(np.asarray(power.k)),
                     np.asarray(power.Pk))
    print("\n  k       P0^s meas   Kaiser b^2 P_lin + shot")
    expect = kaiser0 * gals.galaxy_bias**2 * plin + 1.0 / gals.galaxy_density
    for i in np.where(nm > 8)[0][:4]:
        print(f"  {k[i]:.4f}  {p_ell[0][i]:10.0f}  {expect[i]:10.0f}")
    g = Generator(n, n, n, grid_spacing=spacing)
    seed = 11
    delta_lin = np.asarray(g.generate_delta_field(seed,
                                                  apply_lightcone=False))
    psi = jnp.stack([g.generate_displacement(seed, component=c)
                     for c in range(3)])
    q = zl.lagrangian_positions(shape, spacing)
    evolved, _ = zl.paint(q + psi, shape, spacing, window="cic")
    rec, _ = rc.reconstruct_field(evolved, spacing, smoothing=10.0)

    def cross_r(a, b_, nbins=8):
        a, b_ = np.asarray(a, np.float32), np.asarray(b_, np.float32)
        kk, pab, cc = stats.calculate_cross_power(a, b_, spacing,
                                                  nbins=nbins)
        _, paa, _ = stats.calculate_power(a, spacing, nbins=nbins)
        _, pbb, _ = stats.calculate_power(b_, spacing, nbins=nbins)
        return kk, pab / np.sqrt(np.maximum(paa * pbb, 1e-30)), cc

    kk, r_ev, cc = cross_r(evolved, delta_lin)
    _, r_rec, _ = cross_r(rec, delta_lin)
    print("\nBAO reconstruction (cross-correlation with the initial field):")
    for i in np.where(cc > 20)[0][2:6]:
        print(f"  k = {kk[i]:.3f}  r_evolved = {r_ev[i]:+.3f}  "
              f"r_reconstructed = {r_rec[i]:+.3f}")
    kk, pt, p1h, p2h = halo_model_power(power, fit="st")
    i = np.searchsorted(kk, 0.25)
    p_lin = np.interp(np.log10(0.25), np.log10(np.asarray(power.k)),
                      np.asarray(power.Pk))
    print(f"\nhalo model at k=0.25 h/Mpc: P_tot/P_lin = {pt[i] / p_lin:.2f} "
          f"(1h fraction {p1h[i] / pt[i]:.2f})")
    r, xi = fftlog.xi_from_power(power)
    print(f"FFTLog xi(r): xi(10) = {np.interp(10.0, r, xi):.3f}, "
          f"xi(50) = {np.interp(50.0, r, xi):.4f} "
          f"(BAO bump near r ~ 100: xi(105) = "
          f"{np.interp(105.0, r, xi):.5f})")


EXAMPLES = [
    ("quickstart", 16, "realized P(k) vs input table"),
    ("ensemble_covariance", 16, "FFT-free spectrum-space ensemble"),
    ("lensing_map", 16, "E-mode consistency"),
    ("variance_reduction", 16, "zoom: max shared-mode"),
    ("mock_catalog", 16, "lognormal tracer P(k) vs target"),
    ("constrained_field", 16, "posterior samples"),
    ("morphology", 16, "PS mass fraction"),
    ("forecast_rsd", 32, "ln-amplitude: forecast sigma"),
    ("galaxy_survey", 16, "FFTLog xi(r)"),
]


@pytest.mark.parametrize("name, n, last", EXAMPLES,
                         ids=[e[0] for e in EXAMPLES])
def test_example_runs_on_the_cpu(capsys, name, n, last):
    """The port's example returns finite numbers and prints the JAX
    script's lines at the same size."""
    module = importlib.import_module(f"randomfield_tpu_torch.examples.{name}")
    out = module.main(device="cpu", n=n)
    printed = capsys.readouterr().out
    assert last in printed
    assert out
    for key, value in out.items():
        value = np.asarray(value, np.float64)
        assert np.isfinite(value[~np.isnan(value)]).all(), key
    globals()[f"_jax_{name}"](n)
    _assert_same_lines(printed, capsys.readouterr().out)


def test_variance_reduction_names_its_card_size():
    """On the card the zoom's coarse grid needs n >= 64; below that the
    example says so before it touches the card."""
    from randomfield_tpu_torch.examples import variance_reduction

    with pytest.raises(ValueError, match="--n 64"):
        variance_reduction.main(device="cuda", n=32)
