"""HOD galaxy mocks: occupy halo catalogs with central and satellite
galaxies.

Port of ``randomfield_tpu/models/hod.py`` with its names, arguments and
returns: a Zheng et al. (2005) halo occupation distribution places

    N_cen | M ~ Bernoulli(0.5 [1 + erf((logM - logMmin) / sigma)])
    N_sat | M ~ Poisson(N_cen_mean ((M - M0) / M1)^alpha),  M > M0

centrals at the halo position and satellites NFW-distributed inside
r_200m.  The halo count cubes render on the card (:mod:`.halos`: the
lognormal render and KH); occupation and satellite placement are host
numpy on the compacted catalog, drawn from the JAX package's
``default_rng`` stream in its order, so an equal halo catalog gives the
JAX package's galaxies bit for bit.  With ``rsd=True`` the Zel'dovich
displacement renders on the card and only its values at the halos' cells
go to the host (the JAX package brings the whole component there).
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.models import massfunction as _mf
from randomfield_tpu_torch.models.halomodel import concentration
from randomfield_tpu_torch.models.halos import HaloGenerator

__all__ = [
    "zheng05_occupation",
    "sample_nfw_radii",
    "virial_dispersion",
    "HODGenerator",
]

#: Newton's constant in (km/s)^2 Mpc / Msun (h cancels in h-units).
G_KMS = 4.30091e-9

# the tag of the occupation draws' numpy stream (ASCII "HOD")
HOD_TAG = 0x484F44


def virial_dispersion(m, cosmology="Planck13", delta=200.0):
    """1-D virial velocity dispersion sigma_v(M) [km/s]: sigma_v^2 = G
    M_Delta / (2 r_Delta) with the mean-density Delta definition."""
    from randomfield_tpu_torch.models.cosmology import create_cosmology

    c = create_cosmology(cosmology)
    rho_m = c.Om0 * c.critical_density0 / c.h**2
    m = np.asarray(m, np.float64)
    r = (3.0 * m / (4.0 * np.pi * float(delta) * rho_m)) ** (1.0 / 3.0)
    return np.sqrt(G_KMS * m / (2.0 * r))


def zheng05_occupation(m, logmmin=13.0, sigma_logm=0.25, logm0=13.0,
                       logm1=14.0, alpha=1.0):
    """Zheng et al. 2005 five-parameter HOD: ``(n_cen, n_sat)`` mean
    occupations at halo masses ``m`` [Msun/h]; ``n_sat`` includes the
    central modulation."""
    from scipy.special import erf

    m = np.asarray(m, np.float64)
    n_cen = 0.5 * (1.0 + erf(
        (np.log10(m) - float(logmmin)) / float(sigma_logm)))
    dm = np.maximum(m - 10.0 ** float(logm0), 0.0)
    n_sat = n_cen * (dm / 10.0 ** float(logm1)) ** float(alpha)
    return n_cen, n_sat


def sample_nfw_radii(c, r_delta, rng):
    """Radii from the truncated NFW mass profile, one per halo entry:
    inverse-CDF sampling of M(<r) / M(<r_delta), M(<r) ~ ln(1 + c x) -
    c x / (1 + c x), x = r / r_delta, on a 512-point table."""
    c = np.atleast_1d(np.asarray(c, np.float64))
    x = np.linspace(0.0, 1.0, 512)[None, :]
    cx = c[:, None] * x
    cdf = np.log1p(cx) - cx / (1.0 + cx)
    cdf /= cdf[:, -1:]
    u = rng.random(c.shape[0])
    idx = np.arange(c.shape[0])
    hi = np.minimum((cdf < u[:, None]).sum(axis=1), 511)
    lo = np.maximum(hi - 1, 0)
    c_lo, c_hi = cdf[idx, lo], cdf[idx, hi]
    frac = np.where(c_hi > c_lo, (u - c_lo) / np.maximum(c_hi - c_lo, 1e-30),
                    0.0)
    return (x[0, lo] + frac * (x[0, hi] - x[0, lo])) * np.asarray(
        r_delta, np.float64)


def _values_at_cells(field, cells):
    """float64 values of a (nx, ny, nz) field at integer ``cells`` (N, 3):
    gathered on the field's device, only the N values to the host."""
    nx, ny, nz = field.shape
    flat = (cells[:, 0] * ny + cells[:, 1]) * nz + cells[:, 2]
    idx = torch.as_tensor(flat, dtype=torch.int64, device=field.device)
    return field.reshape(-1)[idx].cpu().numpy().astype(np.float64)


class HODGenerator:
    """Generate galaxy mock catalogs: lognormal halos and a Zheng05 HOD.

    ``hod`` is a dict of Zheng05 parameters (:func:`zheng05_occupation`);
    the halo mass range defaults to ``logmmin - 3 sigma`` up to 1e16.
    Engine kwargs pass through to the halo and Gaussian scenes.
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 hod=None, mmin=None, mmax=1e16, nbins_mass=6, fit="st",
                 z=0.0, **kwargs):
        self.hod = dict(logmmin=13.0, sigma_logm=0.25, logm0=13.0,
                        logm1=14.0, alpha=1.0)
        self.hod.update(hod or {})
        if mmin is None:
            mmin = 10.0 ** (self.hod["logmmin"]
                            - 3.0 * self.hod["sigma_logm"])
        self.halos = HaloGenerator(
            nx, ny, nz, grid_spacing, cosmology=cosmology, power=power,
            mmin=mmin, mmax=mmax, nbins_mass=nbins_mass, fit=fit, z=z,
            **kwargs)
        self.z = float(z)

        # n_g and the galaxy-weighted effective bias, bin by bin so they
        # match the mock's bin-level lognormal bias
        edges = self.halos.mass_edges
        n_gi = []
        for lo, hi in zip(edges[:-1], edges[1:]):
            msub = np.geomspace(lo, hi, 64)
            lnm = np.log(msub)
            _, dn = _mf.mass_function(self.halos._power, msub,
                                      self.halos.cosmology, z=0.0,
                                      fit=self.halos.fit)
            ncen, nsat = zheng05_occupation(msub, **self.hod)
            n_gi.append(np.trapezoid(dn * (ncen + nsat), lnm))
        #: expected galaxy density per halo mass bin [(Mpc/h)^-3]
        self.galaxy_density_bins = np.asarray(n_gi)
        n_g = float(self.galaxy_density_bins.sum())
        if n_g <= 0:
            raise ValueError("HOD occupies no halos in the mass range")
        #: expected comoving galaxy density [(Mpc/h)^-3]
        self.galaxy_density = n_g
        #: galaxy-number-weighted effective linear bias
        self.galaxy_bias = float(
            (self.galaxy_density_bins * self.halos.bias).sum() / n_g)

    @property
    def scene(self):
        return self.halos.scene

    @property
    def cosmology(self):
        return self.halos.cosmology

    def expected_galaxies(self):
        """Expected total galaxy count in the box."""
        shape = self.scene.shape
        vol = shape[0] * shape[1] * shape[2] * self.scene.grid_spacing**3
        return self.galaxy_density * vol

    def generate_galaxy_catalog(self, seed=0, smoothing_length=0.0,
                                rsd=False, los_axis=2):
        """One galaxy mock: host ``(positions, is_central)``, (N, 3)
        comoving Mpc/h in the periodic box and (N,) bool.

        With ``rsd=True`` positions move to redshift space along
        ``los_axis``: every galaxy takes its halo's linear Kaiser shift
        ``f(z) psi_los`` (the seed's Zel'dovich displacement read at the
        halo's cell) and satellites a Gaussian Finger-of-God scatter
        ``sigma_v(M) / (a H)``.
        """
        halo_pos, halo_mass = self.halos.generate_halo_catalog(
            seed, smoothing_length=smoothing_length)
        rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, HOD_TAG])
        ncen_p, nsat_mean = zheng05_occupation(halo_mass, **self.hod)
        spacing = self.scene.grid_spacing
        box = np.array(self.scene.shape, np.float64) * spacing
        los = int(los_axis)

        if rsd:
            f = float(self.cosmology.growth_rate(self.z))
            psi = self.halos.lognormal.gaussian.generate_displacement(
                seed, component=los)
            cells = np.minimum(
                np.floor(halo_pos / spacing).astype(np.int64),
                np.asarray(self.scene.shape) - 1)
            halo_shift = f * _values_at_cells(psi, cells)
            del psi
            # sigma_v [km/s] -> comoving Mpc/h: over a H(z) = 100 a E(z)
            a = 1.0 / (1.0 + self.z)
            ah = 100.0 * a * float(self.cosmology.efunc(self.z))
            fog_scale = virial_dispersion(halo_mass, self.cosmology) / ah
        else:
            halo_shift = np.zeros(halo_mass.shape[0])
            fog_scale = None

        has_cen = rng.random(halo_mass.shape[0]) < ncen_p
        cen_pos = halo_pos[has_cen].copy()
        cen_pos[:, los] += halo_shift[has_cen]

        nsat = rng.poisson(nsat_mean)
        tot = int(nsat.sum())
        if tot:
            parents = np.repeat(np.arange(halo_mass.shape[0]), nsat)
            pm = halo_mass[parents]
            cosmo = self.cosmology
            rho_m = cosmo.Om0 * cosmo.critical_density0 / cosmo.h**2
            r200 = (3.0 * pm / (4.0 * np.pi * 200.0 * rho_m)) ** (1.0 / 3.0)
            conc = concentration(pm, z=self.z)
            radii = sample_nfw_radii(conc, r200, rng)
            v = rng.normal(size=(tot, 3))
            v /= np.linalg.norm(v, axis=1, keepdims=True)
            sat_pos = halo_pos[parents] + radii[:, None] * v
            sat_pos[:, los] += halo_shift[parents]
            if rsd:
                sat_pos[:, los] += fog_scale[parents] * rng.normal(size=tot)
        else:
            sat_pos = np.zeros((0, 3))

        positions = np.concatenate([cen_pos, sat_pos]) % box
        is_central = np.zeros(positions.shape[0], bool)
        is_central[: cen_pos.shape[0]] = True
        return positions, is_central

    def predicted_galaxy_power(self, nbins=32, shot_noise=True,
                               mixture=False):
        """Large-scale (2-halo) expectation of the galaxy spectrum: the
        lognormal tracer spectrum at the effective galaxy bias plus
        ``1/n_g``; ``mixture=True`` the galaxy-weighted bin-pair mixture
        ``sum_ij wg_i wg_j (exp(b_i b_j xi_G) - 1)`` instead."""
        if mixture:
            xi_g = self.halos.lognormal._xi_gaussian_grid(0.0)
            w = self.galaxy_density_bins / self.galaxy_density
            b = self.halos.bias
            xi_t = torch.zeros_like(xi_g)
            for i in range(w.size):
                for j in range(w.size):
                    xi_t += float(w[i] * w[j]) * torch.expm1(
                        float(b[i] * b[j]) * xi_g)
            k, p, c = self.halos.lognormal._xi_to_binned_power(xi_t, nbins)
        else:
            k, p, c = self.halos.lognormal.predicted_biased_power(
                bias=self.galaxy_bias, nbins=nbins)
        if shot_noise:
            p = p + 1.0 / self.galaxy_density
        return k, p, c
