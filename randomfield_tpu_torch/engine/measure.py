"""Measurement and exact-prediction methods of the Generator (a mixin).

Port of ``randomfield_tpu/engine/measure.py``'s ``MeasurementMixin``: thin
delegations to the estimators of :mod:`..validate` and
:mod:`..models.nongaussian` with the scene's spacing, table,
interpolation and device, so the Generator stays the one user-facing
object.  The predictions build their per-mode grids on the scene's device:
the Kaiser expectation (b + f mu^2)^2 P(k) (:meth:`_kaiser_pgrid`) binned
with the estimator's multipole or wedge bins, its Gaussian covariance, a
derived field's expected spectrum and the local-f_NL bispectrum.  The
morphology methods delegate to :mod:`..validate.minkowski` (KM),
:mod:`..validate.peaks` and :mod:`..validate.profiles` (KX's peaks),
:mod:`..models.voids` (KX's void candidates) and :mod:`..validate.knn`.
"""

from __future__ import annotations

import numpy as np
import torch

from randomfield_tpu_torch.ops import derived as _derived
from randomfield_tpu_torch.ops import grid as _grid
from randomfield_tpu_torch.ops import power as _power
from randomfield_tpu_torch.validate import stats as _stats

__all__ = ["MeasurementMixin"]

class MeasurementMixin:
    """calculate_* / predicted_* statistics of rendered fields."""

    def calculate_power(self, delta, nbins=32):
        """Realized binned P(k) of a rendered field: host float64
        ``(k_mean, p_hat, n_modes)`` (:func:`..validate.stats.calculate_power`;
        on a mesh ``delta`` is this rank's x slab, and every rank gets the
        whole field's result)."""
        return _stats.calculate_power(delta, self.grid_spacing, nbins,
                                      mesh=self.mesh)

    def calculate_bispectrum(self, delta, nbins=8, kmin=None, kmax=None):
        """Binned bispectrum of a rendered field (the third-order gate): 0
        in expectation for the Gaussian fields this Generator renders
        (:func:`..validate.bispectrum.calculate_bispectrum`)."""
        from randomfield_tpu_torch.validate import bispectrum

        return bispectrum.calculate_bispectrum(
            delta, self.grid_spacing, nbins, kmin=kmin, kmax=kmax,
            mesh=self.mesh)

    def predicted_ng_bispectrum(self, fnl, kind="field", smoothing_length=0.0,
                                nbins=8, kmin=None, kmax=None):
        """The exact binned tree-level bispectrum of a local-f_NL render,
        with the bins and triads of :meth:`calculate_bispectrum`; returns
        ``(k_centers, triples, B_pred, ntri)``."""
        from randomfield_tpu_torch.models import nongaussian as _ng

        return _ng.predicted_ng_bispectrum(
            self.power, self.shape, self.grid_spacing, fnl, kind=kind,
            cosmology=self.cosmology, smoothing_length=smoothing_length,
            nbins=nbins, kmin=kmin, kmax=kmax,
            interpolation=self.scene.interpolation, device=self.device)

    def _kaiser_bf(self, z, bias, f):
        b = float(bias)
        if b == 0.0:
            raise ValueError("bias must be nonzero for a Kaiser field")
        if f is None:
            f = self.cosmology.growth_rate(float(z))
        return b, float(f)

    def _table_pgrid(self, smoothing_length):
        """(|k|, P(|k|) with the render's interpolation and smoothing, 0 at
        DC), float32 on the scene's device."""
        return _power.grid_power(self.power, self.shape, self.grid_spacing,
                                 self.scene.interpolation, self.device,
                                 smoothing_length)

    def _kaiser_pgrid(self, z, bias, f, los_axis, smoothing_length):
        """The per-mode (b + f mu^2)^2 P(k) expectation half-grid, with the
        render's interpolation and smoothing."""
        b, fv = self._kaiser_bf(z, bias, f)
        kmag, pgrid = self._table_pgrid(smoothing_length)
        k_los = _grid.kvectors(self.shape, self.grid_spacing, torch.float32,
                               self.device)[int(los_axis)]
        bcast = [1, 1, 1]
        bcast[int(los_axis)] = -1
        k2 = kmag * kmag
        inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
        mu2 = (k_los * k_los).reshape(bcast) * inv
        g = b + fv * mu2
        return pgrid * (g * g)

    def predicted_kaiser_multipoles(self, z=0.0, bias=1.0, f=None, los_axis=2,
                                    nbins=32, ells=(0, 2, 4),
                                    smoothing_length=0.0):
        """The exact per-bin expectation of a Kaiser render's P_ell(k): the
        per-mode (b + f mu^2)^2 P(k) binned with the Legendre weights,
        bins and masks of ``calculate_power_multipoles``.  Returns
        ``(k_mean, p_ell, n_modes)``."""
        pgrid = self._kaiser_pgrid(z, bias, f, los_axis, smoothing_length)
        return _stats.bin_power_multipoles_grid(
            pgrid, self.shape, self.grid_spacing, nbins=nbins, ells=ells,
            los_axis=int(los_axis))

    def predicted_kaiser_multipole_covariance(self, z=0.0, bias=1.0, f=None,
                                              los_axis=2, nbins=32,
                                              ells=(0, 2, 4),
                                              smoothing_length=0.0):
        """The exact Gaussian (nbins, nells, nells) within-bin covariance of
        a Kaiser render's P_ell estimates
        (:func:`..validate.ensemble.predicted_multipole_covariance` of
        :meth:`_kaiser_pgrid`)."""
        from randomfield_tpu_torch.validate import ensemble as _ensemble

        pgrid = self._kaiser_pgrid(z, bias, f, los_axis, smoothing_length)
        return _ensemble.predicted_multipole_covariance(
            pgrid, self.shape, self.grid_spacing, nbins=nbins, ells=ells,
            los_axis=int(los_axis))

    def predicted_kaiser_wedges(self, z=0.0, bias=1.0, f=None, los_axis=2,
                                nbins=32, nmu=4, smoothing_length=0.0):
        """The exact per-bin expectation of a Kaiser render's P(k, mu)
        wedges, binned as ``calculate_power_wedges`` bins.  Returns
        ``(k_mean, p, n_modes)`` shaped ``(nbins, nmu)``."""
        pgrid = self._kaiser_pgrid(z, bias, f, los_axis, smoothing_length)
        return _stats.bin_power_wedges_grid(
            pgrid, self.shape, self.grid_spacing, nbins=nbins, nmu=nmu,
            los_axis=int(los_axis))

    def predicted_derived_power(self, kind="delta", component=2, z=0.0,
                                nbins=32, smoothing_length=0.0):
        """The exact per-bin expectation of a derived field's auto-spectrum:
        'delta' (P on the grid's modes), 'potential' (pref^2 / k^4 P, the
        Poisson prefactor of ``generate_potential``), 'displacement' (k_i^2
        / k^4 P for ``component`` i, Nyquist-zeroed gradient vectors) or
        'velocity' (that times (a H f / h)^2), binned with the estimator's
        bins.  Returns ``(k_mean, p, n_modes)``."""
        kinds = ("delta", "potential", "displacement", "velocity")
        if kind not in kinds:
            raise ValueError(f"kind must be one of {kinds}, got {kind!r}")
        kmag, pgrid = self._table_pgrid(smoothing_length)
        if kind != "delta":
            k2 = kmag * kmag
            inv = torch.where(k2 > 0, 1.0 / torch.where(k2 > 0, k2, 1.0), 0.0)
            if kind == "potential":
                t = _derived.potential_prefactor(self.cosmology, z) * inv
            else:
                kvec = _derived.grad_kvectors(self.shape, self.grid_spacing,
                                              torch.float32,
                                              self.device)[int(component)]
                bcast = [1, 1, 1]
                bcast[int(component)] = -1
                pref = (1.0 if kind == "displacement"
                        else _derived.velocity_prefactor(self.cosmology, z))
                t = pref * kvec.reshape(bcast) * inv
            pgrid = pgrid * (t * t)
        return _stats.bin_power_grid(pgrid, self.shape, self.grid_spacing,
                                     nbins=nbins)

    def calculate_minkowski(self, delta, nbins=24, nu_max=3.0, sigma0=None):
        """Minkowski functional densities (v0..v3) of a rendered field at
        ``nbins`` thresholds in [-nu_max, nu_max] (units of ``sigma0``:
        pass the predicted one to gate against :meth:`predicted_minkowski`)
        (:func:`..validate.minkowski.minkowski_functionals`).  Returns
        ``(nu, v0, v1, v2, v3)``."""
        from randomfield_tpu_torch.validate import minkowski as _mk

        return _mk.minkowski_functionals(delta, self.grid_spacing,
                                         nbins=nbins, nu_max=nu_max,
                                         sigma0=sigma0, mesh=self.mesh)

    def predicted_minkowski(self, nu, smoothing_length=0.0):
        """The exact Gaussian expectations of :meth:`calculate_minkowski`
        at thresholds ``nu``: the Tomita forms with the scene's spectral
        moments (its modes, interpolation, smoothing and Nyquist-zeroed
        gradient vectors).  Returns ``(v0, v1, v2, v3)``."""
        from randomfield_tpu_torch.validate import minkowski as _mk

        s0sq, s1sq = _mk.spectral_moments(
            self.power, self.shape, self.grid_spacing,
            smoothing_length=smoothing_length,
            interpolation=self.scene.interpolation, device=self.device)
        return _mk.gaussian_minkowski(nu, s0sq, s1sq)

    def calculate_peaks(self, delta, nbins=14, nu_min=-2.0, nu_max=5.0,
                        sigma0=None):
        """Lattice peak counts of a rendered field, binned by height in
        units of ``sigma0`` (:func:`..validate.peaks.peak_statistics`).
        Returns ``(nu_centers, counts, total)``."""
        from randomfield_tpu_torch.validate import peaks as _pk

        return _pk.peak_statistics(delta, self.grid_spacing, nbins=nbins,
                                   nu_min=nu_min, nu_max=nu_max,
                                   sigma0=sigma0, mesh=self.mesh)

    def _bbks_moments(self, smoothing_length):
        from randomfield_tpu_torch.validate import peaks as _pk

        return _pk.bbks_moments(self.power, self.shape, self.grid_spacing,
                                smoothing_length=smoothing_length,
                                interpolation=self.scene.interpolation,
                                device=self.device)

    def predicted_peaks(self, nbins=14, nu_min=-2.0, nu_max=5.0,
                        smoothing_length=0.0):
        """BBKS expectations of :meth:`calculate_peaks` with the scene's
        spectral moments (full |k|).  Returns ``(nu_centers,
        expected_counts, expected_total)``; the total integrates over all
        heights."""
        from randomfield_tpu_torch.validate import peaks as _pk

        moments = self._bbks_moments(smoothing_length)
        edges = np.linspace(float(nu_min), float(nu_max), int(nbins) + 1)
        volume = float(np.prod(self.shape)) * float(self.grid_spacing) ** 3
        counts, total = _pk.bbks_expected_counts(edges, volume, *moments)
        return 0.5 * (edges[:-1] + edges[1:]), counts, total

    def calculate_stacked_profile(self, delta, weight, nbins=24):
        """Mean field value in radial shells around weighted positions
        (:func:`..validate.profiles.stacked_profile`).  Returns
        ``(r_mean, profile, n_cells)``."""
        from randomfield_tpu_torch.validate import profiles as _pf

        return _pf.stacked_profile(delta, weight, self.grid_spacing,
                                   nbins=nbins, mesh=self.mesh)

    def calculate_peak_profile(self, delta, nu_min=1.0, nu_max=None,
                               nbins=24, smoothing_length=0.0):
        """Stacked profile around lattice peaks in a height band, heights
        and curvatures normalized by the scene's moments (``smoothing_length``
        that of the render).  Returns ``(r_mean, profile, n_peaks, nu_bar,
        x_bar)``."""
        from randomfield_tpu_torch.validate import profiles as _pf

        return _pf.peak_profile(delta, self.grid_spacing,
                                self._bbks_moments(smoothing_length),
                                nu_min=nu_min, nu_max=nu_max, nbins=nbins)

    def predicted_peak_profile(self, nu_bar, x_bar=None, nbins=24,
                               smoothing_length=0.0):
        """The exact Gaussian expectation of a stacked profile: nu_bar
        sigma0 psi(r), or with ``x_bar`` the BBKS peak profile, binned as
        the estimator bins (:func:`..validate.profiles.
        predicted_peak_profile`).  Returns ``(r_mean, profile)``."""
        from randomfield_tpu_torch.validate import profiles as _pf

        return _pf.predicted_peak_profile(
            self.power, self.shape, self.grid_spacing, nu_bar, x_bar=x_bar,
            smoothing_length=smoothing_length, nbins=nbins,
            interpolation=self.scene.interpolation, device=self.device)

    def find_voids(self, delta, radii, threshold=-0.4, candidate_budget=8192):
        """Non-overlapping SO void catalog of a rendered field
        (:func:`..models.voids.find_voids`).  Returns ``(positions,
        radii_v)``."""
        from randomfield_tpu_torch.models import voids as _voids

        return _voids.find_voids(delta, self.grid_spacing, radii,
                                 threshold=threshold, mesh=self.mesh,
                                 candidate_budget=candidate_budget)

    def calculate_knn_cdf(self, counts, radii, ks=(1, 2, 3)):
        """kNN-CDFs of an NGP tracer count grid on the scene's lattice
        (:func:`..validate.knn.knn_cdf`), shaped ``(len(ks),
        len(radii))``."""
        from randomfield_tpu_torch.validate import knn as _knn

        return _knn.knn_cdf(counts, self.grid_spacing, radii, ks=ks,
                            mesh=self.mesh)
