"""Halo mock catalogs: abundance- and clustering-consistent tracers.

Port of ``randomfield_tpu/models/halos.py`` with its names, arguments and
returns.  Per mass bin i, on one shared Gaussian realization g (a
lognormal scene's Gaussian render):

    lam_i(x) = n_i V_cell exp(b_i g - b_i^2 sigma_G^2 / 2)
    N_i(x)  ~ Poisson(lam_i(x))

The counts are KH (:func:`..ops.poisson.poisson_counts`), one launch for
every bin: it replays ``jax.random.poisson`` cell by cell on the keys the
JAX package's scan derives (``key(seed)``, ``fold_in`` 'HALO', one
``split`` a bin), so a seed gives the JAX package's count cube wherever the
two renders' float32 g rounds lambda alike.  The catalog is compacted on
the card (``torch.nonzero`` in C order, as ``np.argwhere``, then
``repeat_interleave``): only the halos' cells go to the host, where jitter
and masses are drawn from the same ``default_rng`` with the same calls in
the same order.  The expectations are host float64 and the lognormal
scene's grid predictions (:class:`.lognormal.LognormalGenerator`).

With ``mesh=`` (a slab mesh) the Gaussian render is the rank's x slab and
KH draws its cells at their whole-grid indices, the loop's count the
whole grid's (:func:`..ops.poisson.poisson_counts` with ``offset`` and
``mesh``): the counts are the rank's x slab of the single-device cube, as
``jax.random.poisson`` is partitionable.  ``generate_halo_catalog``
gathers the counts and compacts them on every rank, as the JAX package's
``np.asarray(counts)`` brings the cube to the host.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.models import massfunction as _mf
from randomfield_tpu_torch.models.lognormal import LognormalGenerator
from randomfield_tpu_torch.ops import poisson as _poisson
from randomfield_tpu_torch.ops import threefry as _threefry

__all__ = ["HaloGenerator", "counts_to_catalog", "halo_keys", "HALO_TAG"]

# the tag folded into the count stream's key (ASCII "HALO")
HALO_TAG = 0x48414C4F


def halo_keys(seed, nbins):
    """The key of each mass bin's ``jax.random.poisson`` call: ``key(seed &
    0xFFFFFFFF)`` folded with :data:`HALO_TAG`, then one ``split`` a bin in
    scan order (the second key of each split)."""
    key = _threefry.fold_in(_threefry.key_from_seed(int(seed) & 0xFFFFFFFF),
                            HALO_TAG)
    subs = []
    for _ in range(int(nbins)):
        key, sub = _threefry.split(key)
        subs.append(sub)
    return subs


class HaloGenerator:
    """Generate Poisson halo-count cubes with consistent n(M) and b(M).

    Parameters: grid as the port's ``Generator``; ``mmin``/``mmax``
    [Msun/h] bound the halo masses, split into ``nbins_mass`` log-uniform
    bins; ``fit`` selects the mass function ('ps' / 'st' / 'tinker08')
    with its companion bias ('ps' / 'st' / 'tinker10'); ``z`` is the
    snapshot redshift (the table scaled by D(z)^2).  Engine kwargs
    (``sampler=``, ``device=``, ``mesh=``...) pass to the lognormal scene.

    Per-bin number densities ``n_i`` integrate dn/dlnM over each bin (host
    float64, 64-point sub-grid); per-bin biases ``b_i`` are the
    number-weighted bin means of b(M).
    """

    def __init__(self, nx, ny, nz, grid_spacing, cosmology=None, power=None,
                 mmin=1e13, mmax=1e15, nbins_mass=4, fit="st", z=0.0,
                 **kwargs):
        from randomfield_tpu_torch.models.cosmology import create_cosmology
        from randomfield_tpu_torch.models.powerspec import (
            power_at_redshift, resolve_power)

        if not (0 < float(mmin) < float(mmax)):
            raise ValueError("need 0 < mmin < mmax")
        self.fit = str(fit)
        bias_fit = {"ps": "ps", "st": "st", "tinker08": "tinker10"}.get(
            self.fit)
        if bias_fit is None:
            raise ValueError(f"unknown fit {self.fit!r}; "
                             "use 'ps', 'st' or 'tinker08'")
        self.z = float(z)
        cosmology = create_cosmology(cosmology)
        power = resolve_power(power, cosmology)
        if self.z:
            power = power_at_redshift(power, cosmology, self.z)

        # mass binning: n_i and number-weighted b_i (host float64)
        self.mass_edges = np.geomspace(float(mmin), float(mmax),
                                       int(nbins_mass) + 1)
        n_i, b_i, m_c = [], [], []
        for lo, hi in zip(self.mass_edges[:-1], self.mass_edges[1:]):
            msub = np.geomspace(lo, hi, 64)
            lnm = np.log(msub)
            # z entered through the table rescale; sigma at z = 0 of it
            _, dn = _mf.mass_function(power, msub, cosmology, z=0.0,
                                      fit=self.fit)
            _, b = _mf.halo_bias(power, msub, cosmology, z=0.0,
                                 fit=bias_fit)
            ni = np.trapezoid(dn, lnm)
            if ni <= 0:
                raise ValueError(
                    f"mass bin [{lo:.3g}, {hi:.3g}] Msun/h has zero "
                    "abundance for this power spectrum")
            n_i.append(ni)
            b_i.append(np.trapezoid(dn * b, lnm) / ni)
            m_c.append(np.trapezoid(dn * msub, lnm) / ni)
        #: comoving number density per bin [(Mpc/h)^-3]
        self.nbar = np.asarray(n_i)
        #: number-weighted linear bias per bin
        self.bias = np.asarray(b_i)
        #: number-weighted mean mass per bin [Msun/h]
        self.mass_centers = np.asarray(m_c)

        self.lognormal = LognormalGenerator(
            nx, ny, nz, grid_spacing, cosmology=cosmology, power=power,
            **kwargs)
        self._power = power
        self._cell_volume = float(grid_spacing) ** 3

    # -- introspection ------------------------------------------------
    @property
    def scene(self):
        return self.lognormal.scene

    @property
    def cosmology(self):
        return self.lognormal.cosmology

    @property
    def device(self):
        return self.lognormal.device

    @property
    def mesh(self):
        return self.lognormal.gaussian.mesh

    def halo_abundance(self):
        """(mean mass, nbar) per bin: the exact Poisson intensity."""
        return self.mass_centers, self.nbar

    def expected_counts(self):
        """Expected TOTAL halo count per bin in the box."""
        shape = self.scene.shape
        return self.nbar * self._cell_volume * (shape[0] * shape[1]
                                                * shape[2])

    def shot_noise(self):
        """Poisson shot-noise power 1/nbar per bin [(Mpc/h)^3]."""
        return 1.0 / self.nbar

    # -- rendering ----------------------------------------------------
    def generate_halo_counts(self, seed=0, smoothing_length=0.0):
        """One catalog realization as an (nm, nx, ny, nz) int32 tensor on
        the scene's device (on a mesh, this rank's (nm, nx/P, ny, nz) x
        slab): the seed's Gaussian render (no lightcone) and KH's counts
        for every mass bin (the same seed drives both, on independent
        Threefry streams)."""
        g = self.lognormal.gaussian.generate_delta_field(
            seed, smoothing_length=smoothing_length, apply_lightcone=False)
        offset = 0
        if self.mesh is not None:
            nx, ny, nz = self.scene.shape
            offset = self.mesh.rows(nx)[0] * ny * nz
        return _poisson.poisson_counts(
            g, halo_keys(seed, self.nbar.size), "lognormal",
            lam0=self.nbar * self._cell_volume, bias=self.bias,
            sigma_g2=self.lognormal.sigma_g2, offset=offset, mesh=self.mesh)

    def generate_halo_catalog(self, seed=0, smoothing_length=0.0):
        """One realization compacted to ``(positions, masses)`` on the host:
        (N, 3) float64 comoving Mpc/h (cell centers jittered within the
        cell) and (N,) Msun/h drawn from dn/dlnM within each halo's bin."""
        counts = self.generate_halo_counts(
            seed, smoothing_length=smoothing_length)
        if self.mesh is not None:
            counts = self.mesh.all_gather(counts, dim=1)
        return counts_to_catalog(
            counts, self.mass_edges, self.scene.grid_spacing, seed=seed,
            power=self._power, cosmology=self.cosmology, fit=self.fit)

    # -- expectations -------------------------------------------------
    def predicted_halo_power(self, bin_index=0, bin_index2=None, nbins=32,
                             smoothing_length=0.0, shot_noise=True):
        """Exact per-bin expectation of the halo count-overdensity
        spectrum: the lognormal biased-tracer expectation for ``b_i``
        (cross: ``b_i b_j``) plus, auto only, the ``1/n_i`` shot noise."""
        i = int(bin_index)
        j = i if bin_index2 is None else int(bin_index2)
        k, p, c = self.lognormal.predicted_biased_power(
            bias=float(self.bias[i]), bias2=float(self.bias[j]),
            nbins=nbins, smoothing_length=smoothing_length)
        if shot_noise and i == j:
            p = p + 1.0 / float(self.nbar[i])
        return k, p, c

    def predicted_combined_power(self, nbins=32, smoothing_length=0.0,
                                 shot_noise=True):
        """Exact expectation of the pooled catalog's spectrum: the
        number-weighted bin-pair mixture ``sum_ij w_i w_j (exp(b_i b_j
        xi_G) - 1)`` plus the pooled ``1/sum n_i`` shot noise."""
        xi_g = self.lognormal._xi_gaussian_grid(smoothing_length)
        w = self.nbar / self.nbar.sum()
        xi_t = torch.zeros_like(xi_g)
        for i in range(w.size):
            for j in range(w.size):
                xi_t += float(w[i] * w[j]) * torch.expm1(
                    float(self.bias[i] * self.bias[j]) * xi_g)
        k, p, c = self.lognormal._xi_to_binned_power(xi_t, nbins)
        if shot_noise:
            p = p + 1.0 / float(self.nbar.sum())
        return k, p, c

    def calculate_power(self, delta, nbins=32):
        return self.lognormal.calculate_power(delta, nbins=nbins)


def _occupied_cells(ci):
    """(cells of the occupied entries in C order, repeated by their counts)
    of one count grid, as a host int64 (N, 3) array: on the grid's device
    for a tensor, so only the halos' cells move to the host."""
    if isinstance(ci, torch.Tensor):
        occupied = ci > 0
        idx = torch.nonzero(occupied)
        return torch.repeat_interleave(idx, ci[occupied].to(torch.int64),
                                       dim=0).cpu().numpy()
    idx = np.argwhere(ci > 0)
    return np.repeat(idx, ci[ci > 0], axis=0)


def counts_to_catalog(counts, mass_edges, spacing, seed=0, power=None,
                      cosmology="Planck13", fit="st"):
    """Compact an (nm, nx, ny, nz) count cube (a tensor, compacted on its
    device, or a numpy array) into host ``(positions, masses)``: positions
    jitter uniformly within each cell; masses are inverse-CDF draws from
    dn/dlnM within the halo's bin (given ``power``; without it log-uniform
    within the bin); the draws in the JAX package's order."""
    if counts.ndim != 4 or counts.shape[0] != len(mass_edges) - 1:
        raise ValueError("counts must be (nbins_mass, nx, ny, nz)")
    if not isinstance(counts, torch.Tensor):
        counts = np.asarray(counts)
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, HALO_TAG])
    spacing = float(spacing)
    pos_list, mass_list = [], []
    for i in range(counts.shape[0]):
        cells = _occupied_cells(counts[i])
        if cells.size == 0:
            continue
        cells = cells.astype(np.float64)
        n = cells.shape[0]
        pos_list.append((cells + rng.random((n, 3))) * spacing)
        lo, hi = mass_edges[i], mass_edges[i + 1]
        if power is not None:
            msub = np.geomspace(lo, hi, 64)
            _, dn = _mf.mass_function(power, msub, cosmology, fit=fit)
            cdf = np.concatenate([[0.0], np.cumsum(
                0.5 * (dn[1:] + dn[:-1]) * np.diff(np.log(msub)))])
            cdf /= cdf[-1]
            mass_list.append(np.interp(rng.random(n), cdf, msub))
        else:
            mass_list.append(lo * (hi / lo) ** rng.random(n))
    if not pos_list:
        return (np.zeros((0, 3)), np.zeros((0,)))
    return np.concatenate(pos_list), np.concatenate(mass_list)
